"""The program's kernel launch counters over the traced window, per
call of the bucket executable."""


def read(run):
    if run.trace is None or not run.calls or not run.launches:
        return None
    return sum(run.launches.values()) / run.calls

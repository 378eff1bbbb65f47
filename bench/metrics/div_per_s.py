"""Divisions answered over the window's whole time, which ends in a
synchronise after the last call sent in it."""


def read(run):
    return run.done / run.window_s if run.window_s > 0 else None

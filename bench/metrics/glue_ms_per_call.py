"""Device time per call of kernels that ATen launches (ms): every
kernel in the traced window whose name is not one of the program's own
(`<counter>_kernel`, from its launch counters)."""


def read(run):
    tr = run.trace
    if tr is None or not run.calls or not run.port_kernels:
        return None
    glue = sum(s for name, s in tr.by_name().items()
               if name not in run.port_kernels)
    return 1e3 * glue / run.calls

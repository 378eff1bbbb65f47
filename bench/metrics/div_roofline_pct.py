"""The least time the card could take for the operations answered in
the traced window (bench/yardstick: the work each needs at its own
operand lengths, against the data sheet's peaks at 700 W), over the
device's kernel time in that window (%)."""

from bench.yardstick import roofline as RL


def read(run):
    tr = run.trace
    if tr is None or run.work is None:
        return None
    kernel_s = tr.busy_s(kinds=("kernel",))
    if kernel_s <= 0:
        return None
    return 100.0 * RL.bound(*run.work)[0] / kernel_s

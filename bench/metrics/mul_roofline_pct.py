"""The least time the card could take for the squares answered in the
traced window (bench/yardstick/squares.py, against the data sheet's
peaks at 700 W), over the device time of `mul_batch_kernel` in that
window (%).  None where the run counted no squares or the trace holds
no such kernel."""

from bench.yardstick import roofline as RL


def read(run):
    tr, work = run.trace, getattr(run, "square_work", None)
    if tr is None or work is None:
        return None
    kernel_s = tr.by_name().get("mul_batch_kernel", 0.0)
    if kernel_s <= 0:
        return None
    return 100.0 * RL.bound(*work)[0] / kernel_s

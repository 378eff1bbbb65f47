"""Device time per call of the Refine loop's own torch glue (ms): the
self time of the `refine_iter_*` spans of the program's span log (each
less its `fused_step` child) inside the traced window, over the
`divmod` spans there.  None where the log has none."""

from bench.harness import spans as SP


def read(run):
    got = SP.in_window(run)
    if got is None:
        return None
    spans, calls = got
    iters = {s.id: s for s in spans if s.name.startswith("refine_iter_")}
    steps = [s for s in spans if s.name == "fused_step" and s.parent in iters]
    return (SP.ms(iters.values()) - SP.ms(steps)) / calls

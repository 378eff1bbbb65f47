"""Device time per call of the division's finalization (ms): the
`divmod/epilogue` and `fused_correct` spans of the program's span log
(device marks that replay with the bucket executable's graph) inside
the traced window, over the `divmod` spans there.  None where the log
has none."""

from bench.harness import spans as SP


def read(run):
    got = SP.in_window(run)
    if got is None:
        return None
    spans, calls = got
    return SP.ms(s for s in spans
                 if s.name in ("divmod/epilogue", "fused_correct")) / calls

"""Device time per call of the remainder tree's squares (ms): the
`remtree/square` spans of the program's span log (device marks that
replay with the bucket executable's graph) inside the traced window,
over the `remtree` spans there, one a descent.  None where the log has
none."""

from bench.harness import spans as SP


def read(run):
    got = SP.in_window(run)
    if got is None:
        return None
    spans, _ = got
    calls = sum(s.name == "remtree" for s in spans)
    if not calls:
        return None
    return SP.ms(s for s in spans if s.name == "remtree/square") / calls

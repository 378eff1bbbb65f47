"""Device time per call of the remainder tree's hand-offs (ms): the
`remtree/handoff` spans of the program's span log (each level's parent
remainders narrowed to its width, one copy per child) inside the traced
window, over the `remtree` spans there, one a descent.  None where the
log has none."""

from bench.harness import spans as SP


def read(run):
    got = SP.in_window(run)
    if got is None:
        return None
    spans, _ = got
    calls = sum(s.name == "remtree" for s in spans)
    if not calls:
        return None
    return SP.ms(s for s in spans if s.name == "remtree/handoff") / calls

"""The control of a cell's comparison: a whole run of the cell at its
own size and load, with the runner's control in the program's place in
what is checked (the reference with one stated guarantee broken), judged
by the run's own comparison.  It must come out not correct.

    python bench/control.py --workload <cell> --seeds 1 2 3 --seconds 10

Prints each seed's result line, as `bench/run.py` does.  The
benchmark's own runs never run this."""

from __future__ import annotations

import sys
import time

T_START = time.perf_counter()


def main(argv, root) -> int:
    import argparse
    import torch
    from bench.harness import main as M
    from bench.harness import spec as SP
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = SP.cell(root, args.workload)
    if not torch.cuda.is_available():
        print("bench: the control runs on the card", file=sys.stderr)
        return M.EXIT_NO_CARD
    t_start = T_START
    for seed in args.seeds:
        M.report(M.run_cell(cell, seed, args.seconds, False,
                            torch.device("cuda", 0), t_start, control=True))
        torch.cuda.empty_cache()
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    from pathlib import Path
    ROOT = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main(sys.argv[1:], ROOT))

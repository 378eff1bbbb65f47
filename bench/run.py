"""Run one benchmark cell once:

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It exits non-zero, with no result, where
the cell's CUDA devices are missing.  See bench/README.md."""

import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import sys
    from pathlib import Path

    ROOT = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.harness.main import main
    sys.exit(main(sys.argv[1:], ROOT, T_START))

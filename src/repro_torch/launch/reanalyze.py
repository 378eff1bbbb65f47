"""Re-derive the dry run's roofline terms from its saved costs (no second
walk): the port of `repro/launch/reanalyze.py`.

  python -m repro_torch.launch.reanalyze --dir results/dryrun

JAX re-parses the saved HLO; the port's dry run saves the walk's costs
beside each record (`<cell>.costs.json.gz`), and this recomputes the
record's `roofline`, `trip_counts` and `useful_ratio` from them with
the current constants (`utils/op_costs.py`).
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os

from repro_torch.launch.dryrun import roofline_record
from repro_torch.utils import op_costs as OC


def reanalyze_record(json_path: str) -> bool:
    costs_path = json_path[:-5] + ".costs.json.gz"
    if not os.path.exists(costs_path):
        return False
    with open(json_path) as f:
        rec = json.load(f)
    if rec.get("status") != "ok":
        return False
    with gzip.open(costs_path, "rt") as f:
        costs = OC.Costs.from_json(json.load(f))
    roofline_record(rec, costs)
    with open(json_path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default="results/dryrun")
    args = ap.parse_args(argv)
    n = 0
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        if reanalyze_record(path):
            n += 1
            print("reanalyzed", os.path.basename(path))
    print(f"{n} records updated")


if __name__ == "__main__":
    main()

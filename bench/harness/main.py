"""One run of one cell: set-up, one window (traced or not), the check
of its answers against `bench/ref`, and the result line.

The result's last line on standard output is one JSON object with
`correct`, `attempted`, `failed`, `metrics`, `device` (and, traced,
`breakdown`), and last in it `checks`: each number compared with its
limit, which are also the last lines on standard error."""

from __future__ import annotations

import json
import subprocess
import sys
import time

from bench.harness import spec as SP
from bench.harness import trace as TR

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
EXIT_NO_CARD, EXIT_FORBIDDEN = 2, 3


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that the benchmark may not load,
    compared whole (`repro_torch` is not `repro`)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit from nvidia-smi ("" where it
    cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def run_cell(cell: SP.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, control: bool = False) -> dict:
    """Set up, run one window and check it: the result object.  With
    `control`, the runner's control takes the program's place in what
    is checked (`bench/control.py`); the benchmark's runs never ask
    for it."""
    import torch
    cuda = device.type == "cuda"
    runner = SP.runner(cell.traffic["entry"])(cell, seed, device)
    run = runner.run

    def mark_setup():
        run.setup_s = time.perf_counter() - t_start

    runner._t = t_start
    runner.lap("imports")
    runner.setup(mark_setup)
    print(f"bench: set-up laps {runner.laps}", file=sys.stderr)
    window = min(seconds, cell.traffic.get("trace_seconds", seconds)) \
        if trace else seconds
    runner.window(window, profiled=trace and cuda)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    runner.release()
    if cuda:
        torch.cuda.empty_cache()
    if control:
        runner.control()
    checks = runner.check()
    checked = {k[1:]: v for k, v in checks.items() if k.startswith("_")}
    compared = {k: {"value": v[0], "limit": v[1]}
                for k, v in checks.items() if not k.startswith("_")}
    correct = (all(c["value"] <= c["limit"] for c in compared.values())
               and all(v > 0 for v in checked.values()))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = SP.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = TR.breakdown(run.trace)
    out["card"] = card_line() if cuda else ""
    out["checked"] = checked
    out["checks"] = compared
    return out


def main(argv, root, t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = SP.cell(root, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}: nothing "
              "measured", file=sys.stderr)
        return EXIT_NO_CARD
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start)
    found = forbidden_modules()
    if found:
        print(f"bench: the run loaded {found}; no result", file=sys.stderr)
        return EXIT_FORBIDDEN
    report(out)
    return 0


def report(out: dict) -> None:
    """The checks as the last lines on standard error, then the result
    as the last line on standard output."""
    sys.stdout.flush()
    for k, v in out["checked"].items():
        print(f"bench: checked {k} {v}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)

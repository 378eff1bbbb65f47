"""Measured-vs-model reporting and the shared benchmark row schema: the
port of `repro/obs/report.py`, stdlib-only like it.

  * `measured_vs_model` / `render_measured_vs_model`: a service
    `snapshot()` (serving/bigint_service.py, modexp_service.py) as one
    row per (bucket, op), with the launches MEASURED when the bucket's
    executable was built (`utils/launch_stats.py:trace_profile`) beside
    the cost model's prediction (`obs/costmodel.py`) and a match
    verdict.  The port's rows also carry the device and the set-up's
    launch of a divmod or precompute (`prologue_launches`, which the
    match adds to the model's); on the CPU nothing launches, so the
    model is None there and the row never fails the match.  modexp
    rows have a model (16 * e_limbs exponent bits at the service's
    window), where the JAX package's have None, and the modular
    service's precompute has a row of its own.
  * `merge_json` + `BENCH_KEY`: the deterministic keyed merge of the
    repo's BENCH_*.json rows, copied as it is.  `BENCH_REQUIRED` waits
    for the port's own benchmark files.
  * `render_table`, `render_health`: plain-text views, copied as they
    are.
"""

from __future__ import annotations

import json
import os

from . import costmodel as CM

# The merge key: exactly one row per (bits, batch, impl) cell.
BENCH_KEY = ("bits", "batch", "impl")


def merge_json(path: str, rows: list[dict], key=BENCH_KEY) -> list[dict]:
    """Deterministic keyed merge into a JSON list file.

    Existing rows are matched by `key` and UPDATED field-wise, so
    partial refreshes (structural-only sweeps, timing-only reruns)
    compose instead of clobbering; unknown keys are appended; the file
    is rewritten sorted by key with stable layout."""
    old = []
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
    by_key = {tuple(r[k] for k in key): dict(r) for r in old}
    for r in rows:
        by_key.setdefault(tuple(r[k] for k in key), {}).update(r)
    merged = [by_key[k] for k in sorted(by_key)]
    with open(path, "w") as f:
        json.dump(merged, f, indent=2, sort_keys=True)
        f.write("\n")
    return merged


# ---------------------------------------------------------------------------
# plain-text tables
# ---------------------------------------------------------------------------

def render_table(rows: list[dict], columns: list[str] | None = None,
                 title: str | None = None) -> str:
    """Right-aligned plain-text table from a list of row dicts."""
    if not rows:
        return (title + "\n" if title else "") + "(no rows)"
    columns = columns or list(rows[0])

    def fmt(v):
        if isinstance(v, float):
            return f"{v:.2f}"
        return "-" if v is None else str(v)

    cells = [[fmt(r.get(c)) for c in columns] for r in rows]
    widths = [max(len(c), *(len(row[i]) for row in cells))
              for i, c in enumerate(columns)]
    def line(vals):
        return "  ".join(v.rjust(w) for v, w in zip(vals, widths))
    out = ([title] if title else []) + [line(columns)]
    out.append("  ".join("-" * w for w in widths))
    out += [line(row) for row in cells]
    return "\n".join(out)


# ---------------------------------------------------------------------------
# measured vs model
# ---------------------------------------------------------------------------

def _row(snapshot: dict, bucket: int, op: str, st: dict) -> dict:
    m, impl = snapshot["m_limbs"], snapshot["impl"]
    device = snapshot.get("device", "cuda")
    model = prologue = None
    if device == "cuda":
        e_limbs = snapshot.get("e_limbs")
        model = CM.model_launches(
            op, m, impl, e_bits=16 * e_limbs if e_limbs else None,
            window_bits=snapshot.get("window_bits", 4))
        # the set-up's launch, which the JAX package's model has not
        prologue = CM.prologue_launches(impl) \
            if op in ("divmod", "precompute") else 0
    measured = st["kernel_launches"]
    iters = {"divmod": CM.refine_iters,
             "precompute": CM.precompute_iters}.get(op)
    return {
        "bucket": bucket, "op": op, "impl": impl, "device": device,
        "m_limbs": m,
        # the Refine trip count drives the 2i+1 (divmod) and 2i
        # (precompute) contracts; the other ops run against a cached
        # inverse
        "iters": iters(m) if iters else None,
        # a sharded bucket's profile is one shard's: the model is per
        # shard, and each of `shards` replays counts it at run time
        "shards": st.get("shards", 1),
        "measured_launches": measured,
        "model_launches": model,
        "prologue_launches": prologue,
        "glue_ops": st["glue_ops"],
        "total_ops": st["total_ops"],
        "match": (model is None) or (measured == model + prologue),
    }


def measured_vs_model(snapshot: dict) -> list[dict]:
    """Comparison rows from a service snapshot: for every (bucket, op)
    static profile (and the modular service's precompute, as bucket 1)
    the measured launches and aten glue ops next to the cost model's
    launches for that op at the service's precision and impl on its
    device."""
    rows = []
    for bucket in sorted(snapshot.get("buckets", {})):
        info = snapshot["buckets"][bucket]
        for op in sorted(info.get("static", {})):
            rows.append(_row(snapshot, bucket, op, info["static"][op]))
    pre = snapshot.get("precompute")
    if pre is not None:
        rows.append(_row(snapshot, 1, "precompute", pre["static"]))
    return rows


def render_measured_vs_model(snapshot: dict) -> str:
    """The measured-vs-model table for one service snapshot."""
    rows = measured_vs_model(snapshot)
    name = snapshot.get("service", "service")
    title = (f"{name} (m_limbs={snapshot['m_limbs']}, "
             f"impl={snapshot['impl']}, "
             f"device={snapshot.get('device', 'cuda')}) -- measured vs "
             f"cost model")
    return render_table(rows, columns=[
        "bucket", "op", "device", "shards", "iters", "measured_launches",
        "model_launches", "prologue_launches", "glue_ops", "match"],
        title=title)


# ---------------------------------------------------------------------------
# serving health surface
# ---------------------------------------------------------------------------

def render_health(health: dict) -> str:
    """Human-readable one-screen view of a serving frontend's
    `healthz()` dict: status line, queue/failure gauges, and the
    quarantine set with breaker states."""
    lines = [f"status: {health.get('status', '?')}  "
             f"(accepting={health.get('accepting')}, "
             f"ready={health.get('ready')})"]
    for key in ("queue_depth", "queued_items", "inflight",
                "deadline_exceeded", "retries", "dropped"):
        if key in health:
            lines.append(f"  {key:18s} {health[key]}")
    quarantine = health.get("quarantine", [])
    lines.append(f"  quarantine         "
                 f"{', '.join(quarantine) if quarantine else '(empty)'}")
    breakers = health.get("breakers", {})
    open_ish = {k: v for k, v in breakers.items() if v != "closed"}
    for key, state in sorted(open_ish.items()):
        lines.append(f"    breaker {key:24s} {state}")
    return "\n".join(lines)

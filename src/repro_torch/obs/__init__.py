"""Observability for the port: metrics, cost model and reporting.

  telemetry   counters, gauges and histograms with labeled series
  costmodel   the paper's launch counts per op and impl
  report      measured-vs-model tables from service snapshots, and the
              keyed-merge JSON schema
"""

from . import costmodel, report, telemetry  # noqa: F401

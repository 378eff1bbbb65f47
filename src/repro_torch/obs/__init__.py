"""Observability for the port: metrics, cost model and reporting.

  telemetry   counters, gauges and histograms with labeled series
  costmodel   the paper's multiplication and launch counts per op and
              impl, and the work of each launch
  roofline    the H100's peaks and the roofline terms of that work
  report      measured-vs-model tables from service snapshots, and the
              keyed-merge JSON schema
"""

from . import costmodel, report, roofline, telemetry  # noqa: F401

"""Per-layer metric readers, one file per metric of BENCHMARK.json's
per_layer list, named as the metric: `read(ctx)` takes the traced run's
context (portbench/harness/cell.py `_trace_context`) and returns the
number, or None where it finds nothing to read (the harness then leaves
the metric out)."""

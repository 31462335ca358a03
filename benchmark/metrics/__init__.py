"""Per-layer metric readers, one file a metric, found by the metric's
name in BENCHMARK.json: `metrics/<name>.py` holds `read(trace)`, which
takes a `trace.Trace` of the traced window and returns the metric's
value, or None where the window holds nothing it reads (the harness then
leaves the metric out of the result line)."""

"""End-to-end metric readers, one file a metric, found by the metric's
name in BENCHMARK.json: `end_to_end/<name>.py` holds `read(run)`, which
takes the run's `run.Window` (the streams' records, the window's bounds,
the set-up time and the device's peak) and returns the value."""

"""Per-layer metric readers, one file each, named as the metric: read(run)
returns the number, or None where the run holds nothing to read. The
harness loads the file by the metric's name in BENCHMARK.json."""

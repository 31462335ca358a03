"""The benchmark of arrow_tpu_torch: TPC-H SF10 on one H100, queried in
process.  See README.md; run.py runs one cell once."""

"""The 95th percentile (numpy's linear rule) of the latency of every
query in the window, from the caller's side: from the call until its
answer is complete."""

import numpy as np


def read(w):
    lat = [t1 - t0 for rec in w.records for _, t0, t1, _ in rec.latencies]
    return float(np.percentile(lat, 95)) * 1e3

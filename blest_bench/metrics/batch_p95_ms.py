"""95th percentile of the latency of every batch in the window, from its
send to the return of its last answer (linear interpolation)."""
import numpy as np


def read(rec: dict):
    lat = [done - sent for sent, done, _, _ in rec["window"]["batches"]]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None

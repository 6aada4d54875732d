"""Host wait in each `next()` of the prefetcher (io/prefetch.py), mean a
chunk over the window: the staging threads' packing of the scans (drawn in
set-up, so nothing of the harness's) and the pinned copy that the closed
loop waits for."""
import numpy as np

from slambench.metrics import window_chunks

UNIT, SOURCE, LAYER, MOVES = "ms", "host_clock", "staging (io/prefetch.py)", "scans_per_s"


def read(ctx):
    w = [c["wait_s"] for c in window_chunks(ctx)]
    return 1e3 * float(np.mean(w)) if w else None

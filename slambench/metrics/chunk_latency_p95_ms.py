"""95th percentile, over every chunk that came back inside the window, of
the time from the chunk's hand-off to `process_chunk` to that call's return
(numpy's linear percentile)."""
import numpy as np

from slambench.metrics import window_chunks

UNIT, SOURCE, LAYER, MOVES = "ms", "host_clock", None, None


def read(ctx):
    lat = [c["latency_s"] for c in window_chunks(ctx)]
    return 1e3 * float(np.percentile(lat, 95)) if len(lat) >= 20 else None

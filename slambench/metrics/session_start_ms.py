"""A session's start: from the host's call that makes the session's new
`DeviceSlamPipeline` (and its prefetcher) to the return of the session's
first chunk, mean over the window's sessions whose first chunk came back
inside it. A steady chunk takes ~110 ms; what a new session pays beyond
that (its state allocated, the graphs of its first chunk) shows here."""
import numpy as np

UNIT, SOURCE = "ms", "host_clock"
LAYER, MOVES = "device engine (models/device_pipeline.py)", "scans_per_s"


def read(ctx):
    t = [s.start_s + s.chunks[0]["wait_s"] + s.chunks[0]["latency_s"]
         for s in ctx["sessions"] if s.chunks and not s.chunks[0]["late"]]
    return 1e3 * float(np.mean(t)) if t else None

"""Host clock around `finalize` (the full-strength pose-graph solve and the
compact readback) with the keyframe trajectory's readback, mean a
session."""
import numpy as np

UNIT, SOURCE = "ms", "host_clock"
LAYER, MOVES = "pose graph (models/pose_graph.py)", "scans_per_s"


def read(ctx):
    f = [s.finalize_s for s in ctx["sessions"] if s.finalize_s is not None]
    return 1e3 * float(np.mean(f)) if f else None

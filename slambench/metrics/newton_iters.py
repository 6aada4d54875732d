"""Newton iterations of the NDT align a scan, the mean of the iterations
column of session 0's odometry log (the seed scan, which aligns nothing,
left out)."""
import numpy as np

UNIT, SOURCE = "iter/scan", "program_counter"
LAYER, MOVES = "odometry (models/odometry.py, ops/ndt.py)", "scans_per_s"


def read(ctx):
    rows = ctx["sessions"][0].record["rows"]
    return float(np.mean(rows[1:, 6])) if len(rows) > 1 else None

"""The device engine's own `stage_seconds["part_b"]` (the host enqueueing
Part B, the keyframe branch: descriptor, retrieval, masked ICP replay,
masked loop-table writes, in-loop solve), summed over the window's sessions,
per scan fed."""
UNIT, SOURCE = "ms/scan", "program_span"
LAYER, MOVES = "device engine (models/device_pipeline.py)", "scans_per_s"
KEY = "part_b"


def read(ctx):
    secs = sum(s.stage_seconds[KEY] for s in ctx["sessions"] if s.stage_seconds)
    scans = sum(c["n"] for s in ctx["sessions"] for c in s.chunks)
    return 1e3 * secs / scans if scans else None

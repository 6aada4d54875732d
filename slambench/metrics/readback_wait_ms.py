"""The device engine's own `stage_seconds["readback_wait"]` (the host
waiting in each chunk's one readback for the card to finish Part A), summed
over the window's sessions, per scan fed."""
UNIT, SOURCE = "ms/scan", "program_span"
LAYER, MOVES = "device engine (models/device_pipeline.py)", "scans_per_s"
KEY = "readback_wait"


def read(ctx):
    secs = sum(s.stage_seconds[KEY] for s in ctx["sessions"] if s.stage_seconds)
    scans = sum(c["n"] for s in ctx["sessions"] for c in s.chunks)
    return 1e3 * secs / scans if scans else None

"""Scans whose odometry rows the host holds by the window's end, over the
window's seconds: every session's start, hand-offs, staging and finalize
fall inside."""
from slambench.metrics import window_chunks

UNIT, SOURCE, LAYER, MOVES = "scans/s", "host_clock", None, None


def read(ctx):
    return sum(c["n"] for c in window_chunks(ctx)) / ctx["seconds"]

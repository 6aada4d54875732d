"""Time a scan in which the card works, over the traced slice: the union of
the intervals of its kernels, copies and fills (torch.profiler) over the
slice's scans. The profiler slows the host's launches, not the card's
work, so the slice's idle share reads mostly the profiler; this reads the
work."""
UNIT, SOURCE, LAYER, MOVES = "ms/scan", "device_trace", "device (H100)", "scans_per_s"


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["kernel_count"]:
        return None
    lo, hi = tr["scans"]
    return 1e3 * tr["busy_s"] / (hi - lo) if hi > lo else None

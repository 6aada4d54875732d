"""What the readers of the program's spans share: a key of the device
engine's `stage_seconds` (`DeviceSlamPipeline.spans`' totals by span name),
summed over the window's sessions. A program without that span has no such
key: the readers then read None."""
LAYER, MOVES = "device engine (models/device_pipeline.py)", "scans_per_s"


def total(ctx, key: str):
    """The key summed over the sessions that have it; None where none has."""
    vals = [s.stage_seconds[key] for s in ctx["sessions"]
            if s.stage_seconds and key in s.stage_seconds]
    return sum(vals) if vals else None


def per_scan_ms(ctx, key: str):
    """Host ms of span `key` per scan fed in the window, as `part_b_host_ms`
    reads `part_b`."""
    secs = total(ctx, key)
    scans = sum(c["n"] for s in ctx["sessions"] for c in s.chunks)
    return 1e3 * secs / scans if secs is not None and scans else None


def per_sample_ms(ctx, key: str):
    """Device ms of Part A phase `key` per sampled scan (`device.samples`:
    one replay a chunk, timed by the events in Part A's graph)."""
    secs, n = total(ctx, key), total(ctx, "device.samples")
    return 1e3 * secs / n if secs is not None and n else None

"""The NDT align kernel's share of its roofline over the traced slice, in %:
the least time of each align the slice ran (peaks.ndt_align_bound_s, from
the scan's Newton iterations in the log and the mean filtered point count
the check measured) over the profiler's `ndt_align_kernel` time."""
import re

from slambench import peaks

UNIT, SOURCE = "%", "device_trace"
LAYER, MOVES = "kernels (csrc)", "scans_per_s"
KERNEL = re.compile(r"\bndt_align_kernel\b")


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    t = sum(s for name, s in tr["kernels"].items() if KERNEL.search(name))
    lo, hi = tr["scans"]
    rows = ctx["sessions"][0].record["rows"][lo:hi]
    rows = rows[rows[:, 6] > 0]
    n_valid = ctx["verdict"]["filtered_points_mean"]
    if not t or not len(rows) or not n_valid:
        return None
    slots = ctx["config"]["program"]["filter.max_points"]
    bound = sum(peaks.ndt_align_bound_s(slots, n_valid, it) for it in rows[:, 6])
    return 100.0 * bound / t

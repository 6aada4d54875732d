"""The NN kernel's share of its roofline over the traced slice, in %: the
least time of the searches that did work (the slice's live ICP trips, from
the program's counter, and one fitness pass a verification that ran) at
keyframe cloud by submap size, over the profiler's time in `nn_kernel` and
`nn_merge_kernel`, dead trips included."""
import re

from slambench import peaks

UNIT, SOURCE = "%", "device_trace"
LAYER, MOVES = "kernels (csrc)", "chunk_latency_p95_ms"
KERNELS = re.compile(r"\b(nn_kernel|nn_merge_kernel)\b")


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    t = sum(s for name, s in tr["kernels"].items() if KERNELS.search(name))
    lo, hi = tr["scans"]
    ran = int(ctx["sessions"][0].record["rows"][lo:hi, 15].sum())
    live = tr["counters"]["icp_live_trips"] + ran
    if not t or not live:
        return None
    n = ctx["config"]["engine"]["kf_points"]
    m = ctx["config"]["program"]["loop.submap_points"]
    return 100.0 * live * peaks.nn_search_bound_s(n, m) / t

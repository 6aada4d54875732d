"""The reduction of a torch.profiler trace of a slice of chunks to what the
per-layer metrics and the result's `breakdown` read: device time by kernel
name, the busy time (the union of the kernels' intervals), the slice's wall
time, and the idle gaps between kernels labelled by the host call in
progress at their midpoint (the innermost host event: on the card, with the
device's activity recorded alone, the CUDA runtime's call)."""

from __future__ import annotations

import bisect

def _is_device(ev) -> bool:
    """A kernel, copy or fill on the card; the device-side copy of a host
    annotation (a record_function range) is not."""
    return (str(getattr(ev, "device_type", "")).endswith("CUDA")
            and not getattr(ev, "is_user_annotation", False))


def reduce(prof, window_s: float) -> dict:
    """Sums of a profiler's events over the slice (seconds)."""
    events = prof.events()
    kern, cpu = [], []
    for ev in events:
        tr = ev.time_range
        if _is_device(ev):
            kern.append((tr.start, tr.end, ev.name))
        else:
            cpu.append((tr.start, tr.end, ev.name))
    by_name: dict = {}
    for a, b, name in kern:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    # the union of the kernels' intervals, and the gaps between them
    kern.sort()
    busy, gaps = 0.0, []
    cur_a = cur_b = None
    for a, b, _ in kern:
        if cur_b is None:
            cur_a, cur_b = a, b
        elif a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    cpu.sort()
    starts = [c[0] for c in cpu]

    def label(t: float) -> str:
        inner = None
        for a, b, name in cpu[:bisect.bisect_right(starts, t)]:
            if a <= t <= b and (inner is None or a >= inner[0]):
                inner = (a, name)
        return inner[1] if inner else "host idle"

    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[label(0.5 * (a + b)), (b - a) * 1e-6] for a, b in gaps[:10]]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy * 1e-6, "window_s": window_s, "kernels": by_name,
            "kernel_count": len(kern), "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": idle}

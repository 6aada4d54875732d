"""Stage timers and device traces (port of `xchu_slam_tpu.utils.profiling`).

`StageTimers` are host wall-clock meters. PyTorch returns before the device
finishes, so a timer made for a CUDA device synchronizes it before a stage's
clock starts and before it stops: the stage is then charged its own device
work and none of the stage before it. `device_trace` is a torch.profiler
scope that writes a Chrome trace (chrome://tracing, Perfetto), where the
reference writes a `jax.profiler` trace; `block_on` waits for the device
work behind a nested structure of tensors. `count_host_syncs` counts the
host synchronisations PyTorch makes on the card inside a block (the port's
own; the mesh engine's readbacks are counted with it).
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from collections import defaultdict

import torch


class StageTimers:
    """Named accumulating wall-clock meters."""

    def __init__(self, device: torch.device | str | None = None):
        device = torch.device(device) if device is not None else None
        self._cuda = device if device is not None and device.type == "cuda" else None
        self.total = defaultdict(float)
        self.count = defaultdict(int)
        self.last = {}

    def _sync(self):
        if self._cuda is not None:
            torch.cuda.synchronize(self._cuda)

    @contextlib.contextmanager
    def time(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1
            self.last[name] = dt

    def mean_ms(self, name: str) -> float:
        c = self.count[name]
        return 1000.0 * self.total[name] / c if c else 0.0

    def report(self) -> str:
        lines = []
        for name in sorted(self.total):
            lines.append(
                f"{name:24s} n={self.count[name]:6d} "
                f"mean={self.mean_ms(name):8.2f} ms "
                f"total={self.total[name]:8.2f} s")
        return "\n".join(lines)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: str, device: torch.device | str = "cuda"):
    """torch.profiler scope: host activity, and the card's kernels and copies
    where `device` is CUDA. On exit it waits for the device and writes
    `<log_dir>/trace.json` (a later trace into the same directory replaces
    it). Yields the profiler (its `key_averages()` etc.)."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_trace: no CUDA device is available")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def block_on(tree):
    """Wait for the device work behind every tensor in a nested structure
    (tuples, named tuples, lists, dicts), once per CUDA device; returns the
    structure (for honest stage timings)."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree


_SYNC_WARNING = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def count_host_syncs(enabled: bool = True):
    """Count the host synchronisations PyTorch makes on CUDA tensors inside
    the block (a readback, `.item()`, a stream or device synchronise): the
    block runs under `torch.cuda.set_sync_debug_mode("warn")` and its
    warnings are counted, not shown. A synchronise made through `ctypes` is
    not seen. Yields a dict whose `"syncs"` is set on exit (None where not
    `enabled`); the block's other warnings are shown on exit. The mode and
    the warnings filter are the process's: threads beside the block are
    counted too."""
    out = {"syncs": None}
    if not enabled:
        yield out
        return
    prev = torch.cuda.get_sync_debug_mode()
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield out
            finally:
                torch.cuda.set_sync_debug_mode(prev)
    finally:
        others = [w for w in seen if _SYNC_WARNING not in str(w.message)]
        out["syncs"] = len(seen) - len(others)
        for w in others:
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)

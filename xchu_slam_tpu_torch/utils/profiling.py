"""Named stage timers (port of `xchu_slam_tpu.utils.profiling.StageTimers`).

Host wall-clock meters. PyTorch returns before the device finishes, so a
timer made for a CUDA device synchronizes it before a stage's clock starts
and before it stops: the stage is then charged its own device work and none
of the stage before it. A device-level trace (torch.profiler) is not ported.
"""

from __future__ import annotations

import contextlib
import time
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

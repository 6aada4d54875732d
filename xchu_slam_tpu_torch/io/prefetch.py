"""Host→device scan staging: packed transfers and threaded prefetch (port of
`xchu_slam_tpu.io.prefetch`).

1. Packed staging (`ScanStager`, `ChunkStager`): one [capacity,4] float32
   array (xyz + intensity) and a valid count per scan, or one
   [chunk,capacity,4] array and [chunk] counts per chunk: a single
   host→device copy, with the mask and the split done on the device. On a
   CUDA device the host buffers are a reusable pinned ring, the copy and the
   unpack run on the stager's own side stream, and the staged item carries
   the event that marks them done; a buffer is refilled only after its last
   copy's event has passed. On the CPU the staged tensors own a copy of the
   buffer.
2. Threaded prefetch (`DeviceScanPrefetcher`, `DeviceChunkPrefetcher`):
   worker threads stage items k+1..k+depth while the consumer computes item
   k; items are delivered strictly in order. Any indexable sequence works as
   the source, including a lazy one (`LazyScans`, `sim.RenderedScans`) whose
   `__getitem__` reads or renders: that work then happens in the staging
   threads. The consumer's stream is made to wait for an item's event as the
   item is handed over, so what the consumer enqueues next is ordered after
   the copy. An exception in a worker is re-raised in the consumer.

Inside `utils/profiling.recording()` the staging is kept as timeline spans
(no totals): `stage.ring_alloc` (a ring's pinned buffers), in the workers
`stage.job` (chunk id: the job's index) holding `stage.read` (the source's
reads or renders), `stage.slot_wait` (a slot's last copy), `stage.fill` and
`stage.upload`, and in the consumer `stage.wait`.

Not ported: the reference's int16 `quantize` staging and its transfer-size
cap, which answer a slow host link.
"""

from __future__ import annotations

import threading
from typing import Iterator

import numpy as np
import torch

from xchu_slam_tpu_torch.types import Cloud
from xchu_slam_tpu_torch.utils.profiling import timeline


def _unpack(packed: torch.Tensor, n_valid) -> Cloud:
    """[..., C, 4] packed scans + counts [...] → Cloud (split + mask on the
    device). `n_valid` is an int for one scan or a tensor [chunk]."""
    cap = packed.shape[-2]
    ar = torch.arange(cap, device=packed.device)
    mask = ar < (n_valid if isinstance(n_valid, int) else n_valid[:, None])
    return Cloud(xyz=torch.where(mask[..., None], packed[..., :3], 0.0),
                 intensity=torch.where(mask, packed[..., 3], 0.0), mask=mask)


class Staged:
    """What a stager hands over: the staged value and, on a CUDA device, the
    event after which its tensors are valid."""

    def __init__(self, value, tensors, event):
        self.value = value
        self._tensors = tensors
        self._event = event

    def acquire(self):
        """Order the caller's current stream after the staging copy and return
        the value (no host synchronisation)."""
        if self._event is not None:
            stream = torch.cuda.current_stream(self._tensors[0].device)
            stream.wait_event(self._event)
            for t in self._tensors:   # allocated on the side stream
                t.record_stream(stream)
            self._event = None
        return self.value


class _PinnedRing:
    """Reusable host buffers (pinned for a CUDA device) and the side stream
    their copies go to."""

    def __init__(self, shapes_dtypes, n_buffers: int, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        with timeline("stage.ring_alloc"):
            self._bufs = [[torch.zeros(shape, dtype=dtype, pin_memory=self.cuda)
                           for shape, dtype in shapes_dtypes] for _ in range(n_buffers)]
        self._events = [None] * n_buffers
        self._next = 0
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None

    def take(self):
        """(slot, its host tensors), once the slot's last copy is done."""
        slot = self._next
        self._next = (self._next + 1) % len(self._bufs)
        if self._events[slot] is not None:
            with timeline("stage.slot_wait"):
                self._events[slot].synchronize()
        return slot, self._bufs[slot]

    def upload(self, slot: int, unpack) -> Staged:
        """Copy the slot's buffers to the device and run `unpack(*device
        tensors)` there; on a CUDA device both on the side stream."""
        bufs = self._bufs[slot]
        with timeline("stage.upload"):
            if not self.cuda:
                cloud = unpack(*(b.clone() for b in bufs))
                return Staged(cloud, tuple(cloud), None)
            with torch.cuda.stream(self.stream):
                cloud = unpack(*(b.to(self.device, non_blocking=True) for b in bufs))
                event = torch.cuda.Event()
                event.record(self.stream)
        self._events[slot] = event
        return Staged(cloud, tuple(cloud), event)


def _fill(dst: torch.Tensor, xyz, intensity) -> int:
    """Write one scan into a [capacity,4] host buffer; returns its count."""
    view = dst.numpy()
    n = min(len(xyz), view.shape[0])
    view[:n, :3] = xyz[:n]
    view[:n, 3] = 0.0 if intensity is None else intensity[:n]
    view[n:] = 0.0
    return n


def _split(scan):
    return scan if isinstance(scan, tuple) else (scan, None)


class ScanStager:
    """Reusable host buffer → one packed host→device copy per scan."""

    def __init__(self, capacity: int, n_buffers: int = 2, device="cuda"):
        self.capacity = capacity
        self._ring = _PinnedRing([((capacity, 4), torch.float32)], n_buffers, device)

    def stage_async(self, xyz: np.ndarray, intensity: np.ndarray | None) -> Staged:
        slot, (buf,) = self._ring.take()
        with timeline("stage.fill"):
            n = _fill(buf, xyz, intensity)
        return self._ring.upload(slot, lambda packed: _unpack(packed, n))

    def stage(self, xyz: np.ndarray, intensity: np.ndarray | None) -> Cloud:
        """The staged Cloud, ordered before whatever the caller's current
        stream runs next."""
        return self.stage_async(xyz, intensity).acquire()


class ChunkStager:
    """Stage `chunk` scans as one [chunk,capacity,4] copy (plus the counts),
    the input of the chunked device step (`models/odometry.chunk_step`,
    `DeviceSlamPipeline.process_chunk`)."""

    def __init__(self, capacity: int, chunk: int, n_buffers: int = 2, device="cuda"):
        self.capacity = capacity
        self.chunk = chunk
        self._ring = _PinnedRing([((chunk, capacity, 4), torch.float32),
                                  ((chunk,), torch.int64)], n_buffers, device)

    def stage_async(self, scans: list) -> Staged:
        slot, (buf, counts) = self._ring.take()
        scans = scans[:self.chunk]
        with timeline("stage.fill"):
            for s in range(self.chunk):
                if s < len(scans):
                    counts[s] = _fill(buf[s], *_split(scans[s]))
                else:   # empty trailing slot of a short final chunk
                    buf[s].zero_()
                    counts[s] = 0
        staged = self._ring.upload(slot, _unpack)
        staged.value = (staged.value, len(scans))
        return staged

    def stage(self, scans: list) -> tuple[Cloud, int]:
        """scans: at most `chunk` (xyz[, intensity]) tuples or arrays. Returns
        a Cloud batch [chunk,...] and the number of real scans in it."""
        return self.stage_async(scans).acquire()


class _Prefetcher:
    """`threads` staging threads running `depth` jobs ahead of consumption;
    results are delivered in job order."""

    def __init__(self, n_jobs: int, depth: int, stagers: list):
        self.n_jobs = n_jobs
        self.depth = depth
        self._results: dict[int, Staged] = {}
        self._cv = threading.Condition()
        self._next_job = 0
        self._consumed = 0
        self._error: BaseException | None = None
        self._closed = False
        self._threads = [threading.Thread(target=self._work, args=(st,), daemon=True)
                         for st in stagers]
        for t in self._threads:
            t.start()

    def _stage(self, k: int, stager) -> Staged:
        raise NotImplementedError

    def _work(self, stager) -> None:
        try:
            while True:
                with self._cv:
                    while (not self._closed and self._next_job < self.n_jobs
                           and self._next_job >= self._consumed + self.depth):
                        self._cv.wait()
                    if self._closed or self._next_job >= self.n_jobs:
                        return
                    k = self._next_job
                    self._next_job += 1
                with timeline("stage.job", chunk=k):
                    staged = self._stage(k, stager)
                with self._cv:
                    self._results[k] = staged
                    self._cv.notify_all()
        except BaseException as exc:  # noqa: BLE001 - handed to the consumer, which re-raises
            with self._cv:
                self._error = exc
                self._cv.notify_all()

    def close(self) -> None:
        """Stop the workers (after the job each is on) and drop what is staged."""
        with self._cv:
            self._closed = True
            self._results.clear()
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=60.0)

    def __iter__(self) -> Iterator:
        for k in range(self.n_jobs):
            with timeline("stage.wait", chunk=k), self._cv:
                while k not in self._results:
                    if self._error is not None:
                        raise self._error
                    if self._closed:
                        raise RuntimeError("the prefetcher was closed")
                    self._cv.wait(timeout=1.0)
                staged = self._results.pop(k)
                self._consumed += 1
                self._cv.notify_all()
            yield staged.acquire()

    def __len__(self) -> int:
        return self.n_jobs

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _indexable(scans):
    if hasattr(scans, "__getitem__") and hasattr(scans, "__len__"):
        return scans
    return list(scans)


class DeviceScanPrefetcher(_Prefetcher):
    """Iterate device-staged Clouds for a sequence of host scans."""

    def __init__(self, scans, capacity: int, depth: int = 4, threads: int = 2,
                 device="cuda"):
        self.scans = _indexable(scans)
        self.capacity = capacity
        super().__init__(len(self.scans), depth,
                         [ScanStager(capacity, n_buffers=2, device=device)
                          for _ in range(max(1, threads))])

    def _stage(self, k: int, stager: ScanStager) -> Staged:
        with timeline("stage.read"):
            scan = self.scans[k]
        return stager.stage_async(*_split(scan))


class DeviceChunkPrefetcher(_Prefetcher):
    """Iterate (Cloud batch [chunk,...], n_real) pairs with threaded staging,
    the chunked counterpart of DeviceScanPrefetcher."""

    def __init__(self, scans, capacity: int, chunk: int = 16, depth: int = 2,
                 threads: int = 2, device="cuda"):
        self.scans = _indexable(scans)
        self.chunk = chunk
        self.n_chunks = -(-len(self.scans) // chunk) if len(self.scans) else 0
        super().__init__(self.n_chunks, depth,
                         [ChunkStager(capacity, chunk, n_buffers=2, device=device)
                          for _ in range(max(1, threads))])

    def _stage(self, k: int, stager: ChunkStager) -> Staged:
        lo = k * self.chunk
        with timeline("stage.read"):
            scans = [self.scans[i] for i in range(lo, min(lo + self.chunk, len(self.scans)))]
        return stager.stage_async(scans)


class LazyScans:
    """Indexable lazy scan sequence: `read(files[k])` on demand, so that the
    prefetcher's staging threads do the disk reads too."""

    def __init__(self, files: list, read):
        self.files = files
        self.read = read

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, k: int):
        return self.read(self.files[k])

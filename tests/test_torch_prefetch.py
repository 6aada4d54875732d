"""The port's scan staging (`io/prefetch.py`) on the CPU: the stagers
against the reference's, delivery in order from threaded prefetch, the padded
short final chunk and its `n_real`, lazy sources, a worker's exception
re-raised in the consumer, shutdown, and a stress run with more threads than
cores. (The pinned ring, the side stream and the events run only on a card:
`tests/test_torch_cuda.py`.)"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from xchu_slam_tpu.io import prefetch as jprefetch
from xchu_slam_tpu.utils import sim as jsim
from xchu_slam_tpu_torch.io import prefetch as tprefetch
from xchu_slam_tpu_torch.types import Cloud
from xchu_slam_tpu_torch.utils import sim as tsim

CAP = 512


def _scans(n, seed=0, with_intensity=True):
    """n ragged scans; scan k's first x coordinate is k (its identity)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        m = int(rng.integers(50, CAP + 100))      # some exceed the capacity
        xyz = rng.normal(size=(m, 3)).astype(np.float32)
        xyz[0, 0] = k
        out.append((xyz, rng.random(m).astype(np.float32)) if with_intensity else xyz)
    return out


def _same(cloud: Cloud, ref) -> None:
    np.testing.assert_array_equal(cloud.xyz.numpy(), np.asarray(ref.xyz))
    np.testing.assert_array_equal(cloud.intensity.numpy(), np.asarray(ref.intensity))
    np.testing.assert_array_equal(cloud.mask.numpy(), np.asarray(ref.mask))


@pytest.mark.parametrize("with_intensity", [True, False])
def test_scan_stager_matches_reference(with_intensity):
    scans = _scans(5, 1, with_intensity)
    ts = tprefetch.ScanStager(CAP, n_buffers=2, device="cpu")
    js = jprefetch.ScanStager(CAP, n_buffers=2)
    staged = []
    for scan in scans:
        xyz, inten = scan if with_intensity else (scan, None)
        cloud = ts.stage(xyz, inten)
        _same(cloud, js.stage(xyz, inten))
        staged.append((cloud, cloud.xyz.clone()))
    # a staged cloud owns its memory: later stages reuse the ring, not it
    for cloud, copy in staged:
        assert torch.equal(cloud.xyz, copy)
    assert staged[0][0].mask.sum() == min(len(scans[0][0] if with_intensity
                                              else scans[0]), CAP)


@pytest.mark.parametrize("n", [8, 3, 0])
def test_chunk_stager_matches_reference_and_pads(n):
    """A short chunk is padded with empty slots (mask all False) and reports
    how many scans are real."""
    scans = _scans(n, 2)
    clouds, n_real = tprefetch.ChunkStager(CAP, 8, device="cpu").stage(scans)
    ref, ref_n = jprefetch.ChunkStager(CAP, 8).stage(scans)
    assert n_real == ref_n == n
    assert clouds.xyz.shape == (8, CAP, 3) and clouds.mask.dtype == torch.bool
    _same(clouds, ref)
    assert not clouds.mask[n:].any() and not clouds.xyz[n:].any()


def test_scan_prefetcher_keeps_order():
    scans = _scans(23, 3)
    with tprefetch.DeviceScanPrefetcher(scans, capacity=CAP, depth=3, threads=3,
                                        device="cpu") as pf:
        assert len(pf) == 23
        got = [float(cloud.xyz[0, 0]) for cloud in pf]
    assert got == list(range(23))


@pytest.mark.parametrize("n,chunk", [(21, 8), (16, 8), (5, 8), (0, 8)])
def test_chunk_prefetcher_keeps_order_pads_and_reports_n_real(n, chunk):
    scans = _scans(n, 4)
    want = jprefetch.DeviceChunkPrefetcher(scans, capacity=CAP, chunk=chunk,
                                           depth=2, threads=2)
    seen, reals = [], []
    with tprefetch.DeviceChunkPrefetcher(scans, capacity=CAP, chunk=chunk, depth=2,
                                         threads=3, device="cpu") as pf:
        assert len(pf) == len(want) == -(-n // chunk)
        for (clouds, n_real), (ref, ref_n) in zip(pf, want):
            assert n_real == ref_n
            _same(clouds, ref)
            reals.append(n_real)
            seen += clouds.xyz[:n_real, 0, 0].tolist()
    assert seen == list(range(n))
    assert sum(reals) == n and all(r == chunk for r in reals[:-1])


class _Failing:
    """An indexable source whose item `bad` cannot be read."""

    def __init__(self, scans, bad):
        self.scans, self.bad = scans, bad

    def __len__(self):
        return len(self.scans)

    def __getitem__(self, k):
        if k == self.bad:
            raise OSError(f"scan {k} is unreadable")
        return self.scans[k]


@pytest.mark.parametrize("kind", ["scan", "chunk"])
def test_worker_exception_is_reraised_in_the_consumer(kind):
    """A worker that fails hands its exception to the consumer: the loop
    ends with it, it does not hang."""
    src = _Failing(_scans(20, 5), bad=13)
    if kind == "scan":
        pf = tprefetch.DeviceScanPrefetcher(src, capacity=CAP, depth=2, threads=2,
                                            device="cpu")
    else:
        pf = tprefetch.DeviceChunkPrefetcher(src, capacity=CAP, chunk=4, depth=2,
                                             threads=2, device="cpu")
    done = []

    def consume():
        try:
            for item in pf:
                done.append(item)
        except OSError as exc:
            done.append(exc)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=60.0)
    assert not t.is_alive()
    assert isinstance(done[-1], OSError) and "13" in str(done[-1])
    assert len(done) - 1 <= (13 if kind == "scan" else 3)
    pf.close()
    assert not any(w.is_alive() for w in pf._threads)


def test_lazy_sources_are_read_in_the_staging_threads():
    scans = _scans(12, 6)
    readers = set()

    def read(k):
        readers.add(threading.get_ident())
        return scans[k]

    lazy = tprefetch.LazyScans(list(range(12)), read)
    assert len(lazy) == 12 and lazy[3][0] is scans[3][0]
    readers.clear()
    with tprefetch.DeviceScanPrefetcher(lazy, capacity=CAP, depth=2, threads=2,
                                        device="cpu") as pf:
        got = [float(c.xyz[0, 0]) for c in pf]
    assert got == list(range(12))
    assert readers and threading.get_ident() not in readers
    # a plain iterable is taken too
    with tprefetch.DeviceScanPrefetcher(iter(scans), capacity=CAP, device="cpu") as pf:
        assert len(list(pf)) == 12


def test_rendered_scans_match_reference_bit_for_bit():
    """The lazy simulator source renders scan k from a generator of its own,
    as the reference's does."""
    world = tsim.make_world(3, extent=40.0, ground_pts=20_000)
    gt = tsim.loop_trajectory(6, radius=10.0, speed=1.0)
    mine = tsim.RenderedScans(world, gt, seed=7, n_points=2000)
    ref = jsim.RenderedScans(jsim.make_world(3, extent=40.0, ground_pts=20_000), gt,
                             seed=7, n_points=2000)
    assert len(mine) == len(ref) == 6
    for k in (4, 0, 4):
        np.testing.assert_array_equal(mine[k][0], ref[k][0])
        np.testing.assert_array_equal(mine[k][1], ref[k][1])


def test_close_stops_the_workers_early():
    pf = tprefetch.DeviceChunkPrefetcher(_scans(64, 8), capacity=CAP, chunk=4, depth=1,
                                         threads=2, device="cpu")
    it = iter(pf)
    next(it)
    pf.close()
    assert not any(w.is_alive() for w in pf._threads)
    with pytest.raises(RuntimeError, match="closed"):
        next(it)


def test_prefetch_under_thread_pressure_loses_and_reorders_nothing():
    """More staging threads than cores, a short switch interval, a slow
    consumer: every scan arrives once, in order, and no more than `depth`
    ahead of the consumer."""
    n, depth = 120, 3
    scans = _scans(n, 9)
    in_flight = []

    class Counting:
        def __len__(self):
            return n

        def __getitem__(self, k):
            in_flight.append(k)
            return scans[k]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t0 = time.monotonic()
    try:
        got, ahead = [], 0
        with tprefetch.DeviceScanPrefetcher(Counting(), capacity=CAP, depth=depth,
                                            threads=16, device="cpu") as pf:
            for i, cloud in enumerate(pf):
                got.append(float(cloud.xyz[0, 0]))
                ahead = max(ahead, max(in_flight) - i)
                assert time.monotonic() - t0 < 120.0
    finally:
        sys.setswitchinterval(old)
    assert got == list(range(n))
    assert sorted(in_flight) == list(range(n))
    assert ahead <= depth

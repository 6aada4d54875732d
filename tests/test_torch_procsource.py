"""io/procsource.ProcessScanSource: scans rendered by forked worker
processes, against the reference's in-thread `RenderedScans`.

The reference's four properties (`tests/test_procsource.py`): items
bit-identical to direct indexing, any access order the chunked prefetcher
makes, repeats and reads after `close()` rendered inline, and the staged
stream equal to the in-thread one. Then what the port does unlike the
reference: a worker killed while it holds scans neither hangs the stream
nor changes it (its scans are rendered in the parent and counted), the
inline path returns float32, and the source refuses to fork once CUDA is
initialized. Last, `run-sim --engine device --render-procs 2` gives the
poses of the run without workers.

Every test that forks bounds its waits (`bounded.within`) and fails rather than
hangs."""

import hashlib
import os
import signal
import time

import numpy as np
import pytest
import torch

from bounded import within
from xchu_slam_tpu.utils import sim as jsim
from xchu_slam_tpu_torch import cli
from xchu_slam_tpu_torch.io.prefetch import DeviceChunkPrefetcher
from xchu_slam_tpu_torch.io.procsource import ProcessScanSource
from xchu_slam_tpu_torch.utils import sim

torch.set_num_threads(2)

WAIT_S = 60.0


@pytest.fixture(scope="module")
def world_and_poses():
    return (sim.make_world(1, extent=30.0, ground_pts=4000),
            sim.loop_trajectory(n_scans=24, radius=8.0, speed=1.0))


@pytest.fixture(scope="module")
def scans(world_and_poses):
    world, gt = world_and_poses
    return sim.RenderedScans(world, gt, seed=5, n_points=2000)


def _same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


def test_items_bit_identical_to_the_reference(world_and_poses, scans):
    world, gt = world_and_poses
    ref = jsim.RenderedScans(world, gt, seed=5, n_points=2000)

    def read_all():
        with ProcessScanSource(scans, workers=2, readahead=8) as src:
            assert len(src) == len(scans)
            return [src[k] for k in range(len(src))], src.inline_renders

    items, inline = within(WAIT_S, read_all)
    assert inline == 0
    for k, item in enumerate(items):
        _same(item, ref[k])


def test_out_of_order_and_repeat_access(scans):
    order = [3, 0, 1, 2, 7, 5, 4, 6]

    def read():
        with ProcessScanSource(scans, workers=2, readahead=16) as src:
            got = {k: src[k] for k in order}
            # an index already served is rendered inline, still right
            return got, src[3], src.inline_renders

    got, again, inline = within(WAIT_S, read)
    for k in order:
        _same(got[k], scans[k])
    _same(again, scans[3])
    assert inline == 1


class _Float64Scans:
    """A source that gives float64 arrays."""

    def __init__(self, scans):
        self.scans = scans

    def __len__(self):
        return len(self.scans)

    def __getitem__(self, k):
        xyz, inten = self.scans[k]
        return xyz.astype(np.float64), inten.astype(np.float64)


def test_post_close_reads_are_inline_and_float32(scans):
    """Unlike the reference's, the inline path returns float32 too."""
    src = ProcessScanSource(_Float64Scans(scans), workers=1, readahead=4)
    first = within(WAIT_S, lambda: src[0])
    src.close()
    later = src[10]
    _same(first, scans[0])
    _same(later, scans[10])
    assert src.inline_renders == 1


def test_stream_equals_the_in_thread_stream(scans):
    """DeviceChunkPrefetcher over the process source stages the chunks it
    stages over the sequence itself."""
    ref = list(DeviceChunkPrefetcher(scans, capacity=2048, chunk=8, depth=2, threads=2,
                                     device="cpu"))

    def stream():
        with ProcessScanSource(scans, workers=2, readahead=(2 + 2 + 2) * 8) as src:
            return [(c.xyz.clone(), c.mask.clone(), n) for c, n in
                    DeviceChunkPrefetcher(src, capacity=2048, chunk=8, depth=2, threads=2,
                                          device="cpu")]

    got = within(WAIT_S, stream)
    assert len(got) == len(ref) == 3
    for (ca, na), (xyz, mask, nb) in zip(ref, got):
        assert na == nb
        assert torch.equal(ca.xyz, xyz) and torch.equal(ca.mask, mask)


class _StallsInWorkers:
    """scans[k], but a worker process stalls on scan `stall` (the parent
    renders it at once)."""

    def __init__(self, scans, stall: int):
        self.scans, self.stall, self.parent = scans, stall, os.getpid()

    def __len__(self):
        return len(self.scans)

    def __getitem__(self, k):
        if k == self.stall and os.getpid() != self.parent:
            time.sleep(300)
        return self.scans[k]


def test_killed_worker_neither_hangs_nor_changes_the_stream(scans, capfd):
    """SIGKILL the worker that holds scan 3 (it stalls there): the stream
    completes at once, every item is the scan's, and the summary counts
    what the parent rendered in its place."""
    src = ProcessScanSource(_StallsInWorkers(scans, stall=3), workers=2, readahead=8)
    try:
        deadline = time.monotonic() + WAIT_S
        while 3 not in src._owner:
            assert time.monotonic() < deadline, "scan 3 was never handed out"
            time.sleep(0.01)
        victim = src._owner[3]
        os.kill(victim.proc.pid, signal.SIGKILL)
        t0 = time.monotonic()
        items = within(WAIT_S, lambda: [src[k] for k in range(len(scans))])
        took = time.monotonic() - t0
        inline = src.inline_renders
    finally:
        src.close()
    for k, item in enumerate(items):
        _same(item, scans[k])
    assert inline >= 1 and took < 30.0
    assert not victim.proc.is_alive()
    assert "exited with code -9" in capfd.readouterr().err


def test_refuses_to_fork_once_cuda_is_initialized(scans, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="CUDA is initialized"):
        ProcessScanSource(scans, workers=1)


SMALL = ("filter.max_points=2048", "pgo.max_keyframes=32", "loop.submap_points=2048",
         "ndt.grid_x=48", "ndt.grid_y=48", "ndt.grid_z=16")


def _pose_hash(pipe) -> str:
    _stamps, kf_odo, kf_opt = pipe.keyframe_trajectory()
    return hashlib.sha256(pipe.odometry_trajectory().tobytes() + kf_odo.tobytes()
                          + kf_opt.tobytes()).hexdigest()


def test_run_sim_with_render_procs_gives_the_same_poses():
    kw = dict(scans=12, radius=15.0, seed=3, device="cpu", overrides=SMALL,
              engine="device", chunk=4, out=None)
    plain, s0 = cli.run_sim(**kw)
    procs, s1 = within(4 * WAIT_S, lambda: cli.run_sim(**kw, render_procs=2))
    assert _pose_hash(procs) == _pose_hash(plain)
    assert s1["render_procs"] == 2 and s1["inline_renders"] == 0
    assert s1["keyframes"] == s0["keyframes"] >= 2

"""The port's asynchronous loop worker (`models/async_worker.py`,
`loop.async_detect` in the host engine).

A free-running worker collapses its backlog to the newest job, so which
keyframes it verifies depends on timing and such a run has no rerun
bit-identity: it is held to the bounds of the synchronous lap (loops ≥ 1,
aligned ATE < 1.0 m). With `submit` made to wait for each job before the
next scan, the worker verifies every keyframe the synchronous engine does,
at the same scan boundary, so that run must equal the synchronous one bit for
bit. A failure inside the worker is raised on the pipeline's thread. Every
wait on the worker is bounded (tests/bounded.py)."""

import numpy as np
import pytest
import torch

from tests import bounded
from xchu_slam_tpu_torch import config as tconfig
from xchu_slam_tpu_torch.models import async_worker, pipeline as tpipe
from xchu_slam_tpu_torch.utils import metrics, se3, sim

torch.set_num_threads(2)

JOB_WAIT_S = 120


def _lap_cfg(async_detect: bool):
    """tests/test_torch_session.py's 12 m lap, with Scan Context loops."""
    return tconfig.SlamConfig(
        filter=tconfig.FilterConfig(max_raw_points=8192, max_points=4096,
                                    outlier_method="none"),
        ndt=tconfig.NdtConfig(grid_x=56, grid_y=56, grid_z=12, max_iterations=20),
        loop=tconfig.LoopConfig(method="sc", detect_period=2, submap_half_width=6,
                                submap_points=4096, icp_fitness_thresh=1.0,
                                async_detect=async_detect),
        pgo=tconfig.PgoConfig(max_keyframes=128, max_loops=16, odom_noise_trans=1e-3,
                              odom_noise_rot=1e-3, gn_iterations=6, cg_iterations=60))


@pytest.fixture(scope="module")
def lap():
    radius = 12.0
    world = sim.make_world(21, extent=radius * 2.8, ground_pts=60_000)
    gt = sim.loop_trajectory(n_scans=int(7.02 * radius) + 30, radius=radius, speed=1.0)
    rng = np.random.default_rng(21)
    return gt, [sim.render_scan(world, p, rng, n_points=6000, max_range=45.0) for p in gt]


def _waiting(pipe):
    """Make the worker's `submit` return only once the job is done."""
    submit = pipe._worker.submit

    def submit_and_wait(k, stamp):
        submit(k, stamp)
        bounded.within(JOB_WAIT_S, pipe._worker.jobs.join)

    pipe._worker.submit = submit_and_wait


def _run(scans, async_detect: bool, wait: bool = False):
    pipe = tpipe.SlamPipeline(_lap_cfg(async_detect), kf_points=1024)
    if wait:
        _waiting(pipe)
    results = [pipe.process_scan(xyz, inten, stamp=0.1 * i)
               for i, (xyz, inten) in enumerate(scans)]
    pipe.finalize()
    return pipe, results


def _ate(pipe, gt):
    gtT = se3.pose_to_matrix(torch.from_numpy(gt)).numpy()
    gt_xyz = np.einsum("ab,nbc->nac", np.linalg.inv(gtT[0]), gtT)[:, :3, 3]
    stamps, _, kf_opt = pipe.keyframe_trajectory()
    idx = np.round(stamps / 0.1).astype(int)
    return metrics.ape_rmse(kf_opt[:, :3], gt_xyz[idx], align=True)


def test_waiting_worker_equals_the_synchronous_engine(lap):
    """Odometry, both keyframe trajectories, the loops (with the scan each
    was reported at) and the loop transforms: bit-identical."""
    _gt, scans = lap
    sync, rs = _run(scans, async_detect=False)
    wait, rw = _run(scans, async_detect=True, wait=True)
    assert sync.loop_count >= 1
    assert np.array_equal(sync.odometry_trajectory(), wait.odometry_trajectory())
    for a, b in zip(sync.keyframe_trajectory(), wait.keyframe_trajectory()):
        assert np.array_equal(a, b)
    assert sync.loops == wait.loops
    assert [r["loop"] for r in rs] == [r["loop"] for r in rw]
    assert sync.icp_verifications == wait.icp_verifications
    n = sync.loop_count
    assert torch.equal(sync.graph.loop_T[:n], wait.graph.loop_T[:n])


def test_free_running_worker_closes_the_lap(lap):
    gt, scans = lap
    pipe, _ = _run(scans, async_detect=True)
    assert pipe._worker is None                  # stopped by finalize
    assert pipe.loop_count >= 1 and pipe.icp_verifications >= pipe.loop_count
    for rec in pipe.loops:
        assert rec.j - rec.i > 10 and rec.fitness <= pipe.cfg.loop.icp_fitness_thresh
    assert _ate(pipe, gt) < 1.0


class InjectedFailure(RuntimeError):
    pass


def _fail(*_args, **_kw):
    raise InjectedFailure("verification failed inside the worker")


@pytest.mark.parametrize("where", ["finalize", "next_scan"])
def test_worker_failure_surfaces_on_the_pipeline_thread(lap, where):
    """An exception in the worker is not swallowed: it is raised by
    `finalize`, or by the next scan's drain once the job has run."""
    _gt, scans = lap
    pipe = tpipe.SlamPipeline(_lap_cfg(True), kf_points=1024)
    for i, (xyz, inten) in enumerate(scans[:3]):
        pipe.process_scan(xyz, inten, stamp=0.1 * i)
    pipe.detect_and_verify_snapshot = _fail
    worker = pipe._worker
    worker.submit(pipe.kf_count - 1, 0.2)
    if where == "finalize":
        with pytest.raises(InjectedFailure):
            pipe.finalize()
        assert not worker.thread.is_alive()
    else:
        bounded.within(JOB_WAIT_S, worker.jobs.join)
        with pytest.raises(InjectedFailure):
            pipe.process_scan(*scans[3], stamp=0.3)
        worker.stop()


def test_verified_loop_keeps_its_old_home():
    """`VerifiedLoop` moved to the worker's module; the pipeline's name is
    the same class."""
    assert tpipe.VerifiedLoop is async_worker.VerifiedLoop
    assert async_worker.VerifiedLoop._fields == ("i", "j", "T", "fitness", "method")


class _StubPipe:
    """What the worker reads of a pipeline: its device, the published
    snapshot and the verification, here a stub that records each job."""

    device = torch.device("cpu")

    def __init__(self):
        self._snapshot = (None, None)
        self.seen = []

    def detect_and_verify_snapshot(self, k, stamp, db):
        self.seen.append(k)
        return async_worker.VerifiedLoop(i=0, j=k, T=torch.eye(4), fitness=0.1, method="stub")


def test_worker_under_a_short_switch_interval_loses_no_job():
    """Jobs submitted from 8 threads while the interpreter switches threads
    every microsecond: every job is accounted for (`join` returns), each
    verified result reaches `drain` exactly once, and a job submitted after
    all the others have run is verified."""
    import sys
    import threading

    pipe = _StubPipe()
    worker = async_worker.AsyncLoopWorker(pipe)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        feeders = [threading.Thread(target=lambda b=b: [worker.submit(b * 1000 + n, 0.0)
                                                        for n in range(200)])
                   for b in range(8)]
        for t in feeders:
            t.start()
        for t in feeders:
            t.join(JOB_WAIT_S)
        assert not any(t.is_alive() for t in feeders)
        bounded.within(JOB_WAIT_S, worker.jobs.join)
        got = [v.j for v in worker.drain()]
        worker.submit(99_999, 0.0)
        bounded.within(JOB_WAIT_S, worker.jobs.join)
        got += [v.j for v in worker.drain()]
    finally:
        sys.setswitchinterval(old)
        worker.stop()
    assert not worker.thread.is_alive()
    assert got == pipe.seen and got[-1] == 99_999
    assert 1 <= len(got) <= 8 * 200 + 1 and len(set(got)) == len(got)


def test_worker_starts_with_its_first_job_and_a_restore_publishes(lap, tmp_path):
    """No thread before the first submitted job, so a pipeline that never
    submits (a restored localizer) leaks none; a host checkpoint restored
    with `loop.async_detect` publishes the restored database as the worker's
    snapshot."""
    from xchu_slam_tpu_torch.utils import checkpoint as tckpt

    _gt, scans = lap
    pipe = tpipe.SlamPipeline(_lap_cfg(True), kf_points=1024)
    assert pipe._worker.thread is None
    pipe._worker.stop()                          # a worker never started stops at once
    for i, (xyz, inten) in enumerate(scans[:3]):
        pipe.process_scan(xyz, inten, stamp=0.1 * i)
    pipe.finalize()
    path = str(tmp_path / "ckpt.npz")
    tckpt.save_checkpoint(pipe, path)
    back = tckpt.load_checkpoint(path, device="cpu")
    assert back._worker.thread is None
    assert back._snapshot[0] is back.db and int(back.db.count) == pipe.kf_count >= 1

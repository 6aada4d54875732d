"""The device engine's Part B on CUDA graphs, on the CPU: the tensor-index
forms that its chains run (the keyframe index, the stamp and the store's
count as tensors on the device) against the host-int forms the eager route
runs, and a whole session through the graph route's chains, run eagerly
with the ICP and Gauss-Newton graphs stood in for by their plain versions,
against the eager route, bit for bit. The captures and replays themselves
are the card's (`test_torch_cuda.py`)."""

import numpy as np
import pytest
import torch

import part_b_cases as cases
from xchu_slam_tpu_torch import config as tconfig
from xchu_slam_tpu_torch.models import device_pipeline as tdp, pose_graph as tpg
from xchu_slam_tpu_torch.models.pipeline import build_submap, empty_db
from xchu_slam_tpu_torch.ops import icp
from xchu_slam_tpu_torch.types import Cloud

torch.set_num_threads(2)

K = 64


class _PlainIcpGraph:
    """`icp.align_ref` in the ICP graph's load / replay / result form: what
    `icp.align` runs on CPU tensors."""

    def __init__(self, spec):
        self.spec = spec

    def load(self, *args):
        self.args = [a.clone() for a in args]

    def replay(self):
        src, src_mask, tgt, tgt_mask, init_T, live = self.args
        self.res = icp.align_ref(src, src_mask, tgt, tgt_mask, init_T, self.spec, live)

    def result(self):
        return self.res


class _PlainGnGraph:
    """`pose_graph.solve_ref` in the Gauss-Newton graph's load / iterate /
    result form: what `pose_graph.solve` runs on CPU tensors."""

    def __init__(self, spec):
        self.spec = spec

    def load(self, poses6, graph, run):
        self.args = (poses6.clone(), tpg.GraphData(*(t.clone() for t in graph)), run.clone())

    def iterate(self, n):
        poses6, graph, run = self.args
        self.out = tpg.solve_ref(poses6, graph, self.spec._replace(gn_iterations=n), run)

    def result(self, poses6, graph, run):
        return self.out


@pytest.fixture
def plain_graphs(monkeypatch):
    """The graph route on the CPU: its chains run eagerly (never captured),
    the ICP and Gauss-Newton graphs are their plain versions."""
    monkeypatch.setattr(icp, "align_graph", lambda n, m, spec, dev: _PlainIcpGraph(spec))
    monkeypatch.setattr(tpg, "gn_graph", lambda graph, spec, dev: _PlainGnGraph(spec))
    monkeypatch.setattr(tdp._PartBGraphs, "capture", lambda self, chain: None)


def _planted(method: str, k: int, **over):
    """A device-engine state whose store holds keyframes 0..k-1 (random
    poses 1-2 m apart, clouds, descriptors; row k//2's descriptors and pose
    near row k's to come), and keyframe k's filtered cloud and log row."""
    rng = np.random.default_rng(k)
    cfg = tconfig.default_config().override(
        {**cases.BASE, "loop.method": method, "sc.num_exclude_recent": 3,
         "loop.min_time_diff": 0.3, "loop.radius_search": 2.5, "pgo.use_gps": True, **over})
    spec = tdp.spec_from_config(cfg, kf_points=256, log_capacity=64)
    n = 1024
    xyz = torch.from_numpy(rng.uniform(-30, 30, (n, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.random(n) < 0.9)
    filt = Cloud(xyz, torch.from_numpy(rng.random(n).astype(np.float32)), mask)
    z = torch.zeros
    db = empty_db(cfg, spec.kf_points)
    state = tdp.DevState(odom=None, db=db, graph=tpg.empty_graph(spec.gspec), kf_accum=z(()),
                         travel=z(()), last_kf_odom=z(6),
                         loop_count=z((), dtype=torch.int64),
                         scan_count=z((), dtype=torch.int64), kf_count=z((), dtype=torch.int64),
                         imu_vel=z(3), last_stamp=z(()), log=z(64, tdp.LOG_COLS),
                         diag=tdp._diag_reset())
    steps = rng.uniform(1.0, 2.0, (K, 6)).astype(np.float32) * [1, 0.2, 0.01, 0, 0, 0.05]
    poses = torch.from_numpy(np.cumsum(steps, 0, dtype=np.float32))
    db.poses.copy_(poses)
    db.opt_poses.copy_(poses + 0.01)
    db.stamps.copy_(0.1 * torch.arange(K, dtype=torch.float32))
    db.travel.copy_(torch.arange(K, dtype=torch.float32))
    db.clouds.copy_(torch.from_numpy(rng.uniform(-20, 20, db.clouds.shape).astype(np.float32)))
    db.cloud_mask.copy_(torch.from_numpy(rng.random(db.cloud_mask.shape) < 0.8))
    db.sc_db.copy_(torch.from_numpy(rng.uniform(0, 4, db.sc_db.shape).astype(np.float32)))
    db.isc_db.copy_(torch.from_numpy(rng.uniform(0, 1, db.isc_db.shape).astype(np.float32)))
    db.sc_db[k].copy_(db.sc_db[k // 2] + 0.01)
    db.opt_poses[k].copy_(db.opt_poses[k // 2] + 0.5)
    for t in (db.poses, db.opt_poses, db.stamps, db.travel, db.clouds, db.cloud_mask,
              db.sc_db, db.isc_db):
        t[k + 1:].zero_()
    state.graph.kf_mask[:k].fill_(True)
    state = state._replace(db=db._replace(count=k))
    row = torch.cat([db.poses[k - 1] + 1.0, torch.tensor([3.0, 0.5, 0.9, 1.0]),
                     db.stamps[k:k + 1].clone(), tdp._diag_reset(), db.travel[k:k + 1]])
    return spec, state, filt, row


def _tensors(state) -> list:
    return [t.clone() for t in tdp._state_tensors(state)]


FORMS = ("store", "sc", "radius", "submap")


@pytest.mark.parametrize("k", [1, K // 2, K - 1])
@pytest.mark.parametrize("form", FORMS)
def test_tensor_index_forms_equal_host_forms(plain_graphs, form, k):
    """At k = 1, a middle keyframe and the store's last row: the store
    chain's writes against the eager route's store, and the Scan Context
    and radius retrievals' eligibility, the submap and the verification's
    inputs with `k`, the stamp and the count as tensors, against their host
    forms."""
    kt = torch.tensor(k)
    if form == "store":
        spec, state, filt, row = _planted("none", k)
        host = tdp._add_keyframe_branch(state, filt, row[:6], float(row[10]),
                                        float(row[tdp.LOG_COLS]), 7.5, True, spec)
        spec, state, filt, row = _planted("none", k)
        b = tdp._PartBGraphs(state, spec, filt, tdp._diag_reset(), torch.zeros(()))
        b.load(k, filt, row, 7.5, True)
        assert not b.step("store")
        assert host.db.count == k + 1 and bool(state.graph.gps_mask[k])
        cases.assert_equal(_tensors(host), _tensors(state))
        return
    if form in ("sc", "radius"):
        spec, state, _filt, row = _planted(form, k)
        state = state._replace(db=state.db._replace(count=k + 1))
        stamp = row[10]
        got = tdp._detect_candidate(state, kt, stamp, spec)
        want = tdp._detect_candidate(state, k, float(stamp), spec)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        if form == "radius":
            older = state.db.stamps < tdp._older_than(float(stamp), spec.min_time_diff)
            assert torch.equal(older, state.db.stamps < tdp._older_than(stamp,
                                                                        spec.min_time_diff))
        return
    spec, state, _filt, _row = _planted("sc", k)
    db = state.db._replace(count=k + 1)
    c = torch.tensor([k // 2])
    got = build_submap(db._replace(count=kt + 1), c, c, spec.submap_half_width,
                       spec.submap_points)
    want = build_submap(db, k // 2, k // 2, spec.submap_half_width, spec.submap_points)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for cand in (k // 2, -1):
        got = tdp._verify_gate(db, kt, torch.tensor(cand), torch.tensor(0.25), spec)
        want = tdp._verify_gate(db, k, torch.tensor(cand), torch.tensor(0.25), spec)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("case", sorted(cases.CASES))
def test_graph_route_equals_eager_route_on_the_cpu(plain_graphs, case):
    """A session of 24 scans through the graph route's chains against the
    eager route: the keyframe store, the factor graph, `loop_count`, the
    diagnostics and the log ring before `finalize`, and the finalized
    session, bit for bit; then the graph route restored to its first
    chunk's state runs the rest again to the same results."""
    cfg = cases.config(case)
    chunks = cases.stage(cases.scans(), "cpu")
    runs = {}
    for graphed in (False, True):
        pipe = tdp.DeviceSlamPipeline(cfg, kf_points=cases.KF_POINTS, log_capacity=64,
                                      device="cpu")
        pipe._graph_part_b = graphed
        cases.feed(pipe, chunks[:1])
        saved = (cases.clone(pipe.state), pipe._scans_fed)
        cases.feed(pipe, chunks, first_chunk=1)
        state = cases.part_b_state(pipe)
        pipe.finalize()
        runs[graphed] = (pipe, state, cases.results(pipe), saved)
    (eager, e_state, e_res, _), (graph, g_state, g_res, saved) = runs[False], runs[True]
    assert eager.loop_count >= 1 and eager.icp_verifications >= eager.loop_count
    assert graph.part_b_replays == eager.part_b_replays == 0
    cases.assert_equal(e_state, g_state)
    cases.assert_equal(e_res, g_res)
    assert graph.icp_verifications == eager.icp_verifications

    graph.restore(*saved)
    assert graph._part_b is None
    cases.feed(graph, chunks, first_chunk=1)
    graph.finalize()
    cases.assert_equal(e_res, cases.results(graph))

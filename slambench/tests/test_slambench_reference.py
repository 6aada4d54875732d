"""The reference and the metric arithmetic at a tiny size on the CPU: the
reference's copies compute what the port's plain versions compute, the
pose-graph solve recovers a loop-closed chain, TF32 rounding is TF32's, and
the bounds are chip_smoke.py's."""

from __future__ import annotations

import types

import numpy as np
import torch

from slambench import peaks, tracing
from slambench.reference import check, filt, lowp, pgo, se3


def _scan(n=6000, seed=0):
    rng = np.random.default_rng(seed)
    xyz = np.c_[rng.uniform(-20, 20, (n, 2)), rng.normal(-1.7, 0.3, n)].astype(np.float32)
    return xyz, rng.uniform(0, 1, n).astype(np.float32)


def test_filter_copy_matches_the_port():
    from xchu_slam_tpu_torch.config import default_config
    from xchu_slam_tpu_torch.ops.filter import filter_scan
    from xchu_slam_tpu_torch.types import make_cloud

    for method in ("statistical", "radius"):
        cfg = default_config().override({"filter.outlier_method": method,
                                         "filter.max_points": 2048,
                                         "filter.max_raw_points": 8192})
        prog = {f"filter.{k}": v for k, v in vars(cfg.filter).items()}
        xyz, inten = _scan()
        a = filter_scan(make_cloud(xyz, inten, capacity=8192), cfg.filter)
        b = filt.filter_scan(filt.make_cloud(xyz, inten, 8192, "cpu"), prog)
        assert torch.equal(a.mask, b.mask) and torch.equal(a.xyz, b.xyz)


def test_dense_solve_recovers_a_closed_chain():
    n = 24
    P = torch.zeros(n, 6, dtype=torch.float64)
    th = torch.linspace(0, 2 * np.pi * (n - 1) / n, n, dtype=torch.float64)
    P[:, 0], P[:, 1], P[:, 5] = 10 * torch.cos(th), 10 * torch.sin(th), th + np.pi / 2
    T = se3.pose_to_matrix(P)
    Z = torch.cat([torch.eye(4, dtype=torch.float64)[None],
                   torch.matmul(se3.inverse(T[:-1]), T[1:])])
    drift = T.clone()
    drift[1:, 0, 3] += 0.05 * torch.arange(1, n)
    loopZ = (se3.inverse(T[0]) @ T[n - 1]).numpy()
    out = pgo.solve(drift, [(0, n - 1, loopZ, 10.0)], torch.tensor([1e3] * 6), 1.0, 8, Z)
    assert float((out - T).abs().max()) < 1e-3 < float((drift - T).abs().max())


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 3 * 2 ** -12, -2.0 - 2 ** -11], dtype=torch.float32)
    assert lowp.round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, -2.0]
    a, b = torch.randn(64, 3), torch.randn(3, 3)
    with lowp.tf32():
        lo = a @ b
    assert 0 < float((lo - a @ b).abs().max()) < 1e-2
    assert torch.equal(a @ b, torch.matmul(a, b))


def test_aligned_ate_ignores_a_rigid_motion():
    rng = np.random.default_rng(0)
    gt = rng.normal(size=(50, 3))
    R = se3.euler_to_matrix(torch.tensor([0.1, -0.2, 0.7], dtype=torch.float64)).numpy()
    assert check.aligned_ate(gt @ R.T + [3, -1, 2], gt) < 1e-9
    off = np.zeros_like(gt)
    off[:25, 2], off[25:, 2] = 0.1, -0.1
    assert abs(check.aligned_ate(gt + off, gt) - 0.1) < 0.02


def test_bounds_are_chip_smokes():
    assert abs(peaks.nn_search_bound_s(4096, 16384) * 1e3 - 0.01002) < 1e-5
    assert abs(peaks.ndt_align_bound_s(8192, 8192, 2.0) * 1e3 - 0.00072) < 1e-5


def test_trace_reduction():
    def ev(name, a, b, dev):
        return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=a, end=b),
                                     device_type="DeviceType.CUDA" if dev else "DeviceType.CPU")

    events = [ev("k1", 0, 10, True), ev("k2", 5, 20, True), ev("k1", 50, 60, True),
              ev("cudaGraphLaunch", 0, 100, False), ev("aten::copy_", 25, 45, False)]
    prof = types.SimpleNamespace(events=lambda: events)
    out = tracing.reduce(prof, 100e-6)
    assert abs(out["busy_s"] - 30e-6) < 1e-12
    assert abs(out["kernels"]["k1"] - 20e-6) < 1e-12
    assert out["idle_gaps"][0][0] == "aten::copy_"
    assert abs(out["idle_gaps"][0][1] - 30e-6) < 1e-12


def test_gps_factor_pulls_z_by_its_information():
    # node 1 one metre ahead of the fixed node 0, its altitude fixed 1 m up:
    # at equal information on the chain's z and the fix, z settles half-way
    T = torch.eye(4, dtype=torch.float64).repeat(2, 1, 1)
    T[1, 0, 3] = 1.0
    Z = torch.cat([torch.eye(4, dtype=torch.float64)[None], T[1:]])
    info = torch.tensor([1e3] * 6, dtype=torch.float64)
    gps = (torch.tensor([0.0, 1.0]), torch.tensor([0.0, 1e3]))
    out = pgo.solve(T, [], info, 1.0, 8, Z, gps=gps)
    assert abs(float(out[1, 2, 3]) - 0.5) < 1e-9 and abs(float(out[1, 0, 3]) - 1.0) < 1e-9
    assert torch.equal(pgo.solve(T, [], info, 1.0, 8, Z, gps=(gps[0], 0 * gps[1])), T)


def test_isc_copy_scores_as_the_port():
    from xchu_slam_tpu_torch.config import default_config
    from xchu_slam_tpu_torch.ops import isc as port

    from slambench.reference import isc

    cfg = default_config()
    spec = isc.isc_spec({f"isc.{k}": v for k, v in vars(cfg.isc).items()})
    pspec = port.spec_from_config(cfg.isc)
    descs = []
    for s in range(12):
        xyz, inten = _scan(4000, s % 4)          # revisits of four places
        xyz, inten = torch.as_tensor(xyz), torch.as_tensor(inten)
        mask = torch.ones(len(xyz), dtype=torch.bool)
        a = isc.make_descriptor(xyz, inten, mask, spec)
        assert torch.equal(a, port.make_descriptor(xyz, inten, mask, pspec))
        descs.append(a)
    db = torch.stack(descs)
    positions = torch.tensor([[float(s % 4), 0.0, 0.0] for s in range(12)])
    travel = 30.0 * torch.arange(12, dtype=torch.float32)
    cur = 11
    sc = isc.score_all(db[cur], db, positions, travel, cur, spec)
    total, shift = port._gated_scores(db[cur], db, 0, cur, positions, travel, cur, pspec)
    ok = (sc.margin_m > 0) & (sc.margin_score > 0)
    assert ok.any() and not ok.all()
    assert torch.equal(torch.where(ok, sc.total, -torch.inf), total)
    assert torch.equal(sc.shift, shift)


def test_ext_guess_copy_is_the_ports_chain():
    from xchu_slam_tpu_torch.ops import imu as port

    from slambench.reference import imu

    g = torch.Generator().manual_seed(3)
    stamps = torch.linspace(0.0, 0.1, 16)
    mask = torch.ones(16, dtype=torch.bool)
    mask[-2:] = False
    w_imu = (stamps, 0.3 * torch.randn(16, 3, generator=g),
             torch.randn(16, 3, generator=g) + torch.tensor([0.0, 0.0, 9.8]), mask)
    w_wheel = (stamps, torch.randn(16, 3, generator=g), 0.3 * torch.randn(16, 3, generator=g),
               mask)
    pose0 = torch.tensor([1.0, -2.0, 0.1, 0.01, -0.02, 3.0])
    vel = torch.tensor([9.0, 1.0, 0.0])
    for use_imu, use_odom in ((True, False), (False, True), (True, True)):
        d, use = imu.ext_guess(pose0, w_imu if use_imu else None,
                               w_wheel if use_odom else None, vel)
        pd, puse, _v = port.ext_guess_ref(pose0, port.ImuWindow(*w_imu),
                                          port.OdomWindow(*w_wheel), vel, use_imu, use_odom)
        assert torch.equal(d, pd) and bool(use) == bool(puse)

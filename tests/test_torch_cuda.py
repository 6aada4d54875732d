"""The port's CUDA kernels on the card: built from csrc/ with nvcc and held to
their plain PyTorch versions (the NN kernel also, bit for bit, to its first
version, the oracle entry `nn_launch_simple`; the NDT align kernel to
`ndt.align_ref`); the host engine's one launch a scan; the card-side code of the mapping session (ISC
scoring, the map export's batched transform, a checkpoint loaded onto the
card) against the same functions on the CPU; the device engine's Part A
(CUDA-graph replay against eager, no synchronisation, staging through the
pinned ring) and its Part B (the chains' graph replays against eager, bit
for bit, a restore captured again); the loop back end: the PGO kernel's
solve and the ICP graph route (NN kernel with its `live` flag +
`icp_step`) against their plain versions, and Part B decided on the card
against the CPU; the guess
kernel against its plain version, Part A with sensor windows under
`set_sync_debug_mode("error")`, a device-engine checkpoint resumed on the
card and batched odometry against single steps; the NDT kernel in each
mode (ls_mode × neighbor_mode) against `align_ref` in that mode, the
block-Jacobi PGO kernel against `solve_ref`, and the device engine in a
non-default mode under `set_sync_debug_mode("error")`; the mesh's entry
points: the NDT shard pass against `ndt_deriv`'s pass in each neighbour
mode, `icp_partial` + `icp_solve` against `icp_step` bit for bit, and a
mesh of one rank against the single-device routes. Marked `cuda`;
without a card the tests skip (the check runs inside the fixture, never at
import). On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:xdist -o addopts=''
"""

import numpy as np
import pytest
import torch

import icp_cases
import nn_cases
import part_b_cases
import pgo_cases
from xchu_slam_tpu_torch import config as tconfig
from xchu_slam_tpu_torch.models import pipeline as tpipe
from xchu_slam_tpu_torch.io import prefetch as tprefetch
from xchu_slam_tpu_torch.models import device_pipeline as tdp, odometry as todom
from xchu_slam_tpu_torch.models import batch_odometry as tbatch
from xchu_slam_tpu_torch.ops import icp, imu as timu, isc, ndt, ndt_deriv, voxel_map as tvm
from xchu_slam_tpu_torch.ops.filter import filter_scan
from xchu_slam_tpu_torch.types import make_cloud
from xchu_slam_tpu_torch.utils import checkpoint as tckpt, sim
from xchu_slam_tpu_torch.models import pose_graph as tpg
from xchu_slam_tpu_torch.ops.cuda import (guess_kernel, icp_kernel, ndt_kernel, nn_kernel,
                                         pgo_kernel)

pytestmark = pytest.mark.cuda

EDGE_CASES = {name: arrays for name, *arrays
              in nn_cases.edge_cases(np.random.default_rng(7))}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,m,masked", [(4096, 16384, "none"), (1000, 3000, "none"),
                                        (1024, 4096, "stretch"), (1024, 2048, "one"),
                                        (1024, 2048, "all")])
def test_nn_kernel_matches_plain_version(cuda, n, m, masked):
    rng = np.random.default_rng(n + m)
    src = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32) * 30).to(cuda)
    tgt = torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32) * 30).to(cuda)
    mask = torch.ones(m, dtype=torch.bool, device=cuda)
    if masked == "stretch":
        mask[m // 3:m // 2] = False
    elif masked == "one":
        mask[:] = False
        mask[5] = True
    elif masked == "all":
        mask[:] = False
    before = nn_kernel.launches
    idx, d2 = nn_kernel.nearest_neighbor(src, tgt, mask)
    assert nn_kernel.launches == before + 1
    _, ref = nn_kernel.nearest_neighbor_ref(src, tgt, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(d2, ref, rtol=1e-4, atol=1e-4)
    if masked == "all":
        assert bool((idx == 0).all()) and bool((d2 == 1e30).all())
    else:
        assert bool(mask[idx.long()].all())


@pytest.mark.parametrize("name", [
    "4096x16384", "ragged 1000x3000", "masked stretch", "all but one masked",
    "all masked", "duplicates across slices", "duplicates, first slice masked",
    "duplicates across sub-slices", "ragged 4100x16001",
    "N below one tile 50x16384", "M below one round 4096x20",
    "M below slices x round 4096x100", "M 700", "16 slices 1024x16384",
    "one slice left", "slices emptied"])
def test_nn_kernel_is_bit_equal_to_its_first_version(cuda, name):
    """idx and d² of the kernel equal the one-scan-per-thread kernel's
    exactly: same arithmetic, ties at the lowest index across slices."""
    src, tgt, mask = (torch.from_numpy(a).to(cuda) for a in EDGE_CASES[name])
    before = nn_kernel.launches
    idx, d2 = nn_kernel.nearest_neighbor(src, tgt, mask)
    assert nn_kernel.launches == before + 1
    want_idx, want_d2 = nn_kernel._nearest_neighbor_simple(src, tgt, mask)
    assert nn_kernel.launches == before + 1  # the oracle is not counted
    _, ref = nn_kernel.nearest_neighbor_ref(src, tgt, mask)
    torch.cuda.synchronize()
    assert torch.equal(idx, want_idx) and torch.equal(d2, want_d2)
    torch.testing.assert_close(d2, ref, rtol=1e-4, atol=1e-4)
    if bool(mask.any()):
        assert bool(mask[idx.long()].all())
        # a tie keeps the lowest valid index among identical targets
        for i in range(0, src.shape[0], max(1, src.shape[0] // 16)):
            same = mask & (tgt == tgt[idx[i].long()]).all(-1)
            assert int(torch.nonzero(same)[0]) == int(idx[i])
    else:
        assert bool((idx == 0).all()) and bool((d2 == 1e30).all())


def test_nn_kernel_takes_only_what_it_checks(cuda):
    src = torch.zeros(8, 3, device=cuda)
    tgt = torch.zeros(64, 3, device=cuda)
    mask = torch.ones(64, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        nn_kernel.nearest_neighbor(src, tgt.T.contiguous().T, mask)
    with pytest.raises(ValueError):
        nn_kernel.nearest_neighbor(src, tgt.cpu(), mask)
    with pytest.raises(TypeError):
        nn_kernel.nearest_neighbor(src.double(), tgt, mask)


def test_icp_runs_the_kernel(cuda):
    """A verification replays its CUDA graph: max_iterations + 1 NN launches
    and max_iterations step launches, of which `iterations` were live."""
    rng = np.random.default_rng(0)
    tgt = torch.from_numpy(rng.uniform(-20, 20, (4096, 3)).astype(np.float32)).to(cuda)
    src = tgt[::4].contiguous() + 0.05
    spec = icp.IcpSpec()
    nn0, step0 = nn_kernel.launches, icp_kernel.launches
    trips0 = icp.live_trip_count()
    res = icp.align(src, torch.ones(1024, dtype=torch.bool, device=cuda), tgt,
                    torch.ones(4096, dtype=torch.bool, device=cuda),
                    torch.eye(4, device=cuda), spec)
    assert nn_kernel.launches - nn0 == spec.max_iterations + 1
    assert icp_kernel.launches - step0 == spec.max_iterations
    assert icp.live_trip_count() - trips0 == int(res.iterations)
    assert bool(res.converged) and float(res.fitness) < 1e-3


def test_nn_kernel_with_live_flag_is_bit_equal(cuda):
    """The `live` flag true changes nothing: idx and d² bit-equal to the
    launch without it; false launches and returns at once."""
    src, tgt, mask = (torch.from_numpy(a).to(cuda) for a in EDGE_CASES["4096x16384"])
    idx, d2 = nn_kernel.nearest_neighbor(src, tgt, mask)
    on = torch.ones(1, device=cuda)
    idx_l, d2_l = nn_kernel.nearest_neighbor(src, tgt, mask, live=on)
    nn_kernel.nearest_neighbor(src, tgt, mask, live=torch.zeros(1, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(idx, idx_l) and torch.equal(d2, d2_l)
    with pytest.raises(ValueError):
        nn_kernel.nearest_neighbor(src, tgt, mask, live=torch.ones(2, device=cuda))


@pytest.mark.parametrize("scene,cap", [("circuit", 100), ("circuit", 3), ("planar", 3),
                                       ("reflection", 100)])
def test_icp_kernel_matches_plain_version(cuda, scene, cap):
    """The graph route (NN kernel + icp_step) against `align_ref` on the same
    card inputs: T to 1e-5, the same iteration count and converged flag,
    fitness to 1e-5 relative; a rerun bit-identical; no synchronisation.
    Scenes: the circuit's verification, a flat lot (a nearly rank-2
    cross-covariance) and a mirrored submap (a reflecting one)."""
    make = {"circuit": icp_cases.scene, "planar": icp_cases.planar_scene,
            "reflection": icp_cases.reflection_scene}[scene]
    args = make(cuda)
    spec = icp.IcpSpec(max_iterations=cap)
    want = icp.align_ref(*args, spec)
    got = icp.align(*args, spec)          # captures the graph
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = icp.align(*args, spec)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    assert int(got.iterations) == int(want.iterations)
    assert bool(got.converged) == bool(want.converged)
    if scene == "circuit":
        assert bool(got.converged) == (cap == 100)
    torch.testing.assert_close(got.T, want.T, atol=1e-5, rtol=0)
    torch.testing.assert_close(got.fitness, want.fitness, rtol=1e-5, atol=0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    off = icp.align(*args, spec, live=torch.zeros((), dtype=torch.bool, device=cuda))
    assert torch.equal(off.T, args[4]) and int(off.iterations) == 0
    assert float(off.fitness) == 0.0


# the circuit, the capacity, a short chain; 63 and 64 coupled keyframes
# cross the sequential / segmented switch (kSegmentedMin), and 64 and 2047
# end on a one-link last segment
@pytest.mark.parametrize("n_live,L,n_loops", [(163, 256, 9), (2048, 256, 40), (40, 8, 0),
                                              (63, 8, 4), (64, 8, 4), (2047, 256, 40)])
def test_pgo_kernel_solve_matches_plain_version(cuda, n_live, L, n_loops):
    """`solve` on the card (one pgo_kernel launch a Gauss-Newton iteration,
    no synchronisation) against `solve_ref` on the same card tensors at
    K = 2048 with the circuit's in-loop spec (2 Gauss-Newton iterations,
    odometry information 1e3, `cli.sim_config`): poses to 1e-4; a rerun
    bit-identical; run false returns the input. (At the library's default
    information of 1e6 the float32 PCG's result depends on the order of the
    substitution's roundings at the 3e-4 level: a CPU emulation of the
    kernel's sequential sweeps differs from the plain version's doubling
    scans by as much.)"""
    poses, graph = pgo_cases.chain_graph(K=2048, L=L, n_live=n_live, n_loops=n_loops,
                                         gps=True)
    spec = tpg.GraphSpec(gn_iterations=2, odom_info_t=1e3, odom_info_r=1e3)
    p_d, g_d = torch.from_numpy(poses).to(cuda), pgo_cases.to_device(graph, cuda)
    want = tpg.solve_ref(p_d, g_d, spec)
    before = pgo_kernel.launches
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tpg.solve(p_d, g_d, spec)
        again = tpg.solve(p_d, g_d, spec)
        off = tpg.solve(p_d, g_d, spec, run=torch.zeros((), dtype=torch.bool, device=cuda))
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    assert pgo_kernel.launches - before == 3 * spec.gn_iterations
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert torch.equal(got, again) and torch.equal(off, p_d)
    assert float((want - p_d).abs().max()) > 1e-3


@pytest.mark.parametrize("n_live,L,n_loops", [(163, 256, 9), (2048, 256, 40), (40, 8, 0)])
def test_pgo_kernel_jacobi_solve_matches_plain_version(cuda, n_live, L, n_loops):
    """`solve` with the block-Jacobi preconditioner on the card (its kernel
    instantiation, no synchronisation) against `solve_ref` with it on the
    same card tensors: poses to 1e-4, a rerun bit-identical."""
    poses, graph = pgo_cases.chain_graph(K=2048, L=L, n_live=n_live, n_loops=n_loops,
                                         gps=True)
    spec = tpg.GraphSpec(gn_iterations=2, odom_info_t=1e3, odom_info_r=1e3,
                         precond="jacobi")
    p_d, g_d = torch.from_numpy(poses).to(cuda), pgo_cases.to_device(graph, cuda)
    want = tpg.solve_ref(p_d, g_d, spec)
    before = pgo_kernel.launches
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tpg.solve(p_d, g_d, spec)
        again = tpg.solve(p_d, g_d, spec)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    assert pgo_kernel.launches - before == 2 * spec.gn_iterations
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert torch.equal(got, again)
    assert float((want - p_d).abs().max()) > 1e-3


@pytest.mark.parametrize("n_live,L,n_loops", [(40, 8, 0), (163, 256, 9)])
def test_pgo_kernel_sweeps_against_its_first_version(cuda, n_live, L, n_loops):
    """The kernel with its substitutions forced sequential is bit for bit its
    first version (`csrc/pgo_kernel_first.cu`: the same factor, sweeps,
    products and dot-product order, only in shared memory); forced
    segmented, its update is within 1e-5 of max |x|, with the same CG trip
    count."""
    from xchu_slam_tpu_torch.models import pose_graph as pg
    from xchu_slam_tpu_torch.utils import se3

    poses, graph = pgo_cases.chain_graph(K=2048, L=L, n_live=n_live, n_loops=n_loops, gps=True)
    spec = tpg.GraphSpec(gn_iterations=2, odom_info_t=1e3, odom_info_r=1e3)
    g_d = pgo_cases.to_device(graph, cuda)
    s = pg._gn_system(se3.pose_to_matrix(torch.from_numpy(poses).to(cuda)), g_d, spec)
    args = (s.blocks.contiguous(), s.U.contiguous(), s.g.contiguous(), s.Ji.contiguous(),
            s.Jj.contiguous(), s.odom_info, s.wp, s.Jli.contiguous(), s.Jlj.contiguous(),
            g_d.loop_i, g_d.loop_j, s.wl.contiguous(), s.A.contiguous(), s.gz.contiguous(),
            g_d.kf_mask, torch.ones((), dtype=torch.bool, device=cuda),
            spec.cg_tol, spec.cg_iterations)
    x0, it0 = pgo_kernel._cg_first(*args)
    xs, its = pgo_kernel._cg_sweep(*args, 1 << 30)
    xg, itg = pgo_kernel._cg_sweep(*args, 0)
    torch.cuda.synchronize()
    assert torch.equal(xs, x0) and torch.equal(its, it0)
    assert torch.equal(itg, it0)
    torch.testing.assert_close(xg, x0, atol=1e-5 * float(x0.abs().max()), rtol=0)


def _isc_store(rng, K=300, live=260):
    """A store of sparse polar images (about a tenth of the cells lit), with
    rows 200.. near-copies of rows 0.. shifted by a few sectors."""
    db = (rng.random((K, 60, 60)) < 0.1) * rng.random((K, 60, 60))
    db[200:live] = np.roll(db[:live - 200], 7, axis=2) * (rng.random((live - 200, 60, 60)) < 0.97)
    db[live:] = 0.0
    return db.astype(np.float32)


def test_isc_scores_on_the_card_match_the_cpu(cuda):
    """Geometry scores and shifts equal bit for bit (0/1 sums), intensity
    scores within 1e-6, the detected loop the same, at a store larger than
    one scoring chunk."""
    rng = np.random.default_rng(5)
    db = torch.from_numpy(_isc_store(rng))
    spec = isc.IscSpec()
    q = db[259]
    geo_c, sh_c = isc.geometry_scores(q, db, spec)
    geo_g, sh_g = isc.geometry_scores(q.to(cuda), db.to(cuda), spec)
    assert torch.equal(geo_g.cpu(), geo_c) and torch.equal(sh_g.cpu(), sh_c)
    in_c = isc.intensity_scores(q, db, sh_c, spec)
    in_g = isc.intensity_scores(q.to(cuda), db.to(cuda), sh_g, spec)
    torch.testing.assert_close(in_g.cpu(), in_c, rtol=0, atol=1e-6)
    pos = torch.zeros(300, 3)
    travel = torch.arange(300, dtype=torch.float32) * 2.0
    loop_c = isc.detect_loop(q, db, 260, pos, travel, spec)
    loop_g = isc.detect_loop(q.to(cuda), db.to(cuda), 260, pos.to(cuda), travel.to(cuda), spec)
    assert loop_c.found and loop_c.idx == 59
    assert (loop_g.idx, loop_g.found, loop_g.yaw) == (loop_c.idx, loop_c.found, loop_c.yaw)
    assert abs(loop_g.score - loop_c.score) <= 1e-5
    xyz = torch.from_numpy(rng.normal(size=(8192, 3)).astype(np.float32) * [15, 15, 2])
    inten = torch.from_numpy(rng.random(8192).astype(np.float32))
    mask = torch.from_numpy(rng.random(8192) > 0.2)
    assert torch.equal(isc.make_descriptor(xyz.to(cuda), inten.to(cuda), mask.to(cuda), spec).cpu(),
                       isc.make_descriptor(xyz, inten, mask, spec))


def _filled_pipeline(rng, device):
    cfg = tconfig.SlamConfig(pgo=tconfig.PgoConfig(max_keyframes=64, max_loops=8))
    pipe = tpipe.SlamPipeline(cfg, kf_points=1024, device=device)
    n = 40
    pipe.db.opt_poses[:n] = torch.from_numpy(
        (rng.normal(size=(n, 6)) * [40, 40, 1, 0.02, 0.02, 2]).astype(np.float32))
    pipe.db.clouds[:n] = torch.from_numpy(
        (rng.normal(size=(n, 1024, 3)) * [20, 20, 2]).astype(np.float32))
    pipe.db.cloud_mask[:n] = torch.from_numpy(rng.random((n, 1024)) > 0.3)
    pipe.db = pipe.db._replace(count=n)
    pipe.kf_count = n
    return pipe


def test_map_export_transform_on_the_card_matches_the_cpu(cuda):
    """`assemble_map`'s batched transform and masked readback: every point
    within 1e-4 of the CPU's, the same count."""
    on_cpu = _filled_pipeline(np.random.default_rng(6), "cpu").assemble_map(voxel=0.0)
    on_card = _filled_pipeline(np.random.default_rng(6), cuda).assemble_map(voxel=0.0)
    assert on_card.shape == on_cpu.shape and len(on_cpu) > 20_000
    np.testing.assert_allclose(on_card, on_cpu, rtol=0, atol=1e-4)


def test_checkpoint_loads_onto_the_card(cuda, tmp_path):
    pipe = _filled_pipeline(np.random.default_rng(7), cuda)
    path = str(tmp_path / "ckpt.npz")
    tckpt.save_checkpoint(pipe, path)
    back = tckpt.load_checkpoint(path)          # the default device is the card
    assert back.device.type == "cuda" and back.db.clouds.is_cuda and back.kf_count == 40
    for a, b in zip(back.db[:-1] + back.graph, pipe.db[:-1] + pipe.graph):
        assert torch.equal(a, b)


# ------------------------------------------------ the NDT align kernel -- #
def _ndt_scene(rng, n, cuda, masked="none"):
    """A finalized grid of a structured scene (ground and two walls) and a
    source cloud of the same scene, displaced: tensors on the card."""
    spec = tvm.GridSpec(gx=40, gy=40, gz=12, resolution=2.0, min_points=6,
                        eig_inflation=0.01)
    m = 30_000
    ground = np.c_[rng.uniform(-30, 30, (m // 2, 2)), rng.normal(0, 0.05, m // 2)]
    wall1 = np.c_[rng.uniform(-30, 30, m // 4), np.full(m // 4, 12.0) +
                  rng.normal(0, 0.05, m // 4), rng.uniform(0, 6, m // 4)]
    wall2 = np.c_[np.full(m // 4, -15.0) + rng.normal(0, 0.05, m // 4),
                  rng.uniform(-30, 30, m // 4), rng.uniform(0, 6, m // 4)]
    world = np.vstack([ground, wall1, wall2]).astype(np.float32)
    pts = torch.from_numpy(world).to(cuda)
    grid = tvm.make_grid(spec, tvm.centered_origin(spec, torch.zeros(3, device=cuda)))
    grid = tvm.finalize(tvm.insert_points(grid, pts, torch.ones(len(world), dtype=torch.bool,
                                                                device=cuda), spec), spec)
    src = torch.from_numpy(world[rng.choice(len(world), n, replace=False)]).to(cuda)
    mask = torch.ones(n, dtype=torch.bool, device=cuda)
    if masked == "some":
        mask[::3] = False
    elif masked == "all":
        mask[:] = False
    guess = torch.tensor([0.25, -0.2, 0.05, 0.004, -0.003, 0.02], device=cuda)
    return spec, grid, src.contiguous(), mask, guess


@pytest.mark.parametrize("n,masked", [(8192, "none"), (1000, "none"), (4096, "some"),
                                      (37, "none"), (20_000, "some")])
def test_ndt_kernel_pass_matches_plain_version(cuda, n, masked):
    """(L, g, H) of one kernel pass within 1e-5 of the largest entry of the
    plain pass (the sums run in another order)."""
    spec, grid, src, mask, guess = _ndt_scene(np.random.default_rng(n), n, cuda, masked)
    nspec = ndt.NdtSpec()
    d1, d2 = ndt.gauss_constants(nspec.outlier_ratio, nspec.resolution)
    before = ndt_kernel.launches
    L, g, H = ndt_kernel.hessian_pass(grid.fin, grid.origin, src, mask, guess, spec,
                                      nspec, d1, d2)
    assert ndt_kernel.launches == before    # the single-pass mode is not counted
    Lp, gp, Hp = ndt_deriv.ndt_value_grad_hess(guess, src, mask, grid, spec, d1, d2)
    torch.cuda.synchronize()
    got = torch.cat([L.reshape(1), g, H.reshape(36)])
    want = torch.cat([Lp.reshape(1), gp, Hp.reshape(36)])
    assert bool(torch.isfinite(got).all()) and float(want.abs().max()) > 0
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    assert torch.equal(H, H.T)


@pytest.mark.parametrize("n,masked", [(8192, "none"), (1000, "some"), (37, "none"),
                                      (20_000, "none")])
def test_ndt_kernel_align_matches_plain_route(cuda, n, masked):
    """A whole align on the card against the plain version from the same
    state and guess: pose within 1e-4, the same trip count, a bit-identical
    rerun, and no value read back on the way."""
    spec, grid, src, mask, guess = _ndt_scene(np.random.default_rng(n + 1), n, cuda, masked)
    nspec = ndt.NdtSpec()
    before = ndt_kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = ndt.align(grid, src, mask, guess, spec, nspec)
        again = ndt.align(grid, src, mask, guess, spec, nspec)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ndt_kernel.launches == before + 2
    want = ndt.align_ref(grid, src, mask, guess, spec, nspec)
    assert ndt_kernel.launches == before + 2    # the plain version launches nothing
    assert all(isinstance(v, torch.Tensor) and v.is_cuda for v in res)
    assert torch.equal(res.pose, again.pose) and torch.equal(res.score, again.score)
    torch.testing.assert_close(res.pose, want.pose, rtol=0, atol=1e-4)
    assert int(res.iterations) == int(want.iterations) >= 1
    assert bool(res.converged) == bool(want.converged)
    assert float(res.score) == pytest.approx(float(want.score), rel=1e-4)
    torch.testing.assert_close(res.matched_frac, want.matched_frac.float(), rtol=0, atol=1e-6)
    # fitness is a mean of d² ≈ 0.6 m² at poses up to 1e-4 m apart: 2·d·Δ ≈ 3e-4 of it
    torch.testing.assert_close(res.fitness, want.fitness, rtol=1e-3, atol=1e-6)
    # it moved towards the scene's true pose (the identity)
    assert float(res.pose[:3].norm()) < float(guess[:3].norm())


# the five modes other than the default, and two together
NDT_MODES = [("backtrack", "direct1"), ("backtrack", "direct26"), ("backtrack", "kdtree"),
             ("mt_exact", "direct7"), ("ref_clamped", "direct7"), ("mt_exact", "kdtree")]


@pytest.mark.parametrize("n", [8192, 1000, 20_000])
@pytest.mark.parametrize("ls_mode,neighbor_mode", NDT_MODES)
def test_ndt_kernel_modes_match_plain_route(cuda, ls_mode, neighbor_mode, n):
    """Each mode's kernel instantiation against `align_ref` in the same mode
    from the same state and guess: pose within 1e-4, the same iteration and
    trial counts, a bit-identical rerun, no value read back. At 20,000
    points the 27-cube's lanes outrun the trips whose rows the kernel keeps,
    so its passes gather again."""
    spec, grid, src, mask, guess = _ndt_scene(np.random.default_rng(n + 7), n, cuda, "some")
    nspec = ndt.NdtSpec(ls_mode=ls_mode, neighbor_mode=neighbor_mode)
    before = ndt_kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = ndt.align(grid, src, mask, guess, spec, nspec)
        again = ndt.align(grid, src, mask, guess, spec, nspec)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ndt_kernel.launches == before + 2
    rec = ndt_kernel.align_record(grid.fin, grid.origin, src, mask, guess, spec, nspec,
                                  *ndt.gauss_constants(nspec.outlier_ratio, nspec.resolution))
    stats = {}
    want = ndt.align_ref(grid, src, mask, guess, spec, nspec, stats=stats)
    assert torch.equal(res.pose, again.pose) and torch.equal(res.score, again.score)
    torch.testing.assert_close(res.pose, want.pose, rtol=0, atol=1e-4)
    assert int(res.iterations) == int(want.iterations) >= 1
    assert int(rec[ndt_kernel.RECORD["trials"]]) == stats["trials"]
    assert int(rec[ndt_kernel.RECORD["passes"]]) == stats["passes"]
    assert bool(res.converged) == bool(want.converged)
    assert float(res.score) == pytest.approx(float(want.score), rel=1e-4)
    torch.testing.assert_close(res.matched_frac, want.matched_frac.float(), rtol=0, atol=1e-6)
    torch.testing.assert_close(res.fitness, want.fitness, rtol=1e-3, atol=1e-6)
    assert float(res.pose[:3].norm()) < float(guess[:3].norm())


def test_ndt_kernel_all_masked_scan_is_a_no_op(cuda):
    spec, grid, src, mask, guess = _ndt_scene(np.random.default_rng(3), 2048, cuda, "all")
    res = ndt.align(grid, src, mask, guess, spec, ndt.NdtSpec())
    assert torch.equal(res.pose, guess) and int(res.iterations) == 1
    assert bool(res.converged) and float(res.score) == 0.0
    assert float(res.matched_frac) == 0.0 and float(res.fitness) == 0.0


def test_ndt_kernel_takes_only_what_it_checks(cuda):
    spec, grid, src, mask, guess = _ndt_scene(np.random.default_rng(4), 512, cuda)
    nspec = ndt.NdtSpec()
    ok = (grid.fin, grid.origin, src, mask, guess, spec, nspec, -1.0, 1.0)
    for i, bad in ((2, src.cpu()), (0, grid.fin[:-1]), (2, src.T.contiguous().T),
                   (4, guess[:5])):
        args = list(ok)
        args[i] = bad
        with pytest.raises(ValueError):
            ndt_kernel.align_record(*args)
    with pytest.raises(TypeError):
        ndt_kernel.align_record(grid.fin, grid.origin, src.double(), mask, guess, spec,
                                nspec, -1.0, 1.0)
    # the modes that stay refused, by name
    for bad, what in ((dict(neighbor_mode="direct9"), "direct9"),
                      (dict(ls_mode="golden"), "golden")):
        with pytest.raises(ValueError, match=what):
            ndt_kernel.align_record(grid.fin, grid.origin, src, mask, guess, spec,
                                    nspec._replace(**bad), -1.0, 1.0)


def _edge_case(name, cuda):
    """(spec, grid, src, mask, guess, nspec) of one edge of the align kernel."""
    rng = np.random.default_rng(11)
    nspec = ndt.NdtSpec()
    n, masked = {"ragged": (8193, "some"), "below one warp": (5, "none"),
                 "all masked": (2048, "all")}.get(name, (4096, "none"))
    spec, grid, src, mask, guess = _ndt_scene(rng, n, cuda, masked)
    if name == "outside the grid":
        # a third of the points far outside, one of them millions of voxels away
        src = src.clone()
        src[::3] += torch.tensor([500.0, -800.0, 90.0], device=cuda)
        src[5] = torch.tensor([3e6, -3e6, 1e6], device=cuda)
    elif name == "one iteration":
        nspec = nspec._replace(max_iterations=1)
    elif name == "line search exhausted":
        # a guess half a voxel and 17 degrees off, two trials allowed
        guess = torch.tensor([1.1, -0.9, 0.4, 0.05, -0.04, 0.3], device=cuda)
        nspec = nspec._replace(ls_max_trials=2, max_iterations=4)
    return spec, grid, src.contiguous(), mask, guess, nspec


@pytest.mark.parametrize("name", ["ragged", "below one warp", "all masked",
                                  "outside the grid", "one iteration",
                                  "line search exhausted"])
def test_ndt_kernel_edge_cases_match_align_ref(cuda, name):
    """The kernel against `align_ref` where its loops and its geometry end:
    a ragged N over one trip, fewer points than a warp, an all-masked scan
    (zero step), points outside the grid, `max_iterations` reached, a
    far-off guess that uses up its line-search trials. Finite, pose within
    1e-4, the same trip count and flag, a bit-identical rerun."""
    spec, grid, src, mask, guess, nspec = _edge_case(name, cuda)
    res = ndt.align(grid, src, mask, guess, spec, nspec)
    again = ndt.align(grid, src, mask, guess, spec, nspec)
    want = ndt.align_ref(grid, src, mask, guess, spec, nspec)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(v.float()).all()) for v in res)
    for a, b in zip(res, again):
        assert torch.equal(a, b)
    torch.testing.assert_close(res.pose, want.pose, rtol=0, atol=1e-4)
    assert int(res.iterations) == int(want.iterations)
    assert bool(res.converged) == bool(want.converged)
    torch.testing.assert_close(res.matched_frac, want.matched_frac.float(), rtol=0, atol=1e-6)
    if name == "one iteration":
        assert int(res.iterations) == 1
    if name == "all masked":
        assert torch.equal(res.pose, guess) and float(res.score) == 0.0


def test_ndt_kernel_is_captured_in_a_cuda_graph_and_replayed(cuda):
    """The cooperative launch is recorded into a CUDA graph on a side stream
    and each replay gives the eager record, bit for bit, on new inputs too."""
    spec, grid, src, mask, guess = _ndt_scene(np.random.default_rng(12), 8192, cuda)
    nspec = ndt.NdtSpec()
    d1, d2 = ndt.gauss_constants(nspec.outlier_ratio, nspec.resolution)
    args = (grid.fin, grid.origin, src, mask, guess, spec, nspec, d1, d2)
    eager = ndt_kernel.align_record(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rec = ndt_kernel.align_record(*args)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(rec, eager)
    guess.copy_(torch.tensor([-0.2, 0.15, 0.0, 0.0, 0.002, -0.015], device=cuda))
    graph.replay()
    eager2 = ndt_kernel.align_record(*args)
    torch.cuda.synchronize()
    assert torch.equal(rec, eager2) and not torch.equal(eager2, eager)


def test_host_engine_scan_launches_the_ndt_kernel_once_and_reads_back_after(cuda, monkeypatch):
    """`SlamPipeline.process_scan` on the card: one NDT kernel launch a scan,
    no synchronisation inside the align (it runs under
    `set_sync_debug_mode("error")`), and the step's scalars arrive as host
    values."""
    cfg = tconfig.default_config().override(_SMALL)
    scans = _small_scans(6)
    real_align = ndt.align
    calls = []

    def checked_align(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real_align(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        calls.append(out)
        return out

    monkeypatch.setattr(ndt, "align", checked_align)
    pipe = tpipe.SlamPipeline(cfg, kf_points=1024, device=cuda)
    pipe.process_scan(*scans[0], stamp=0.0)
    for i, (xyz, inten) in enumerate(scans[1:], start=1):
        before = ndt_kernel.launches
        pipe.process_scan(xyz, inten, stamp=0.1 * i)
        assert ndt_kernel.launches == before + 1
    assert len(calls) == 5 and all(v.is_cuda for out in calls for v in out)
    assert all(type(r["iterations"]) is int and r["iterations"] >= 1 for r in pipe.odom_log)


# ------------------------------------------------- the device engine -- #
_SMALL = {"filter.max_raw_points": 8192, "filter.max_points": 4096,
          "filter.outlier_method": "statistical", "ndt.grid_x": 48, "ndt.grid_y": 48,
          "ndt.grid_z": 16, "pgo.max_keyframes": 64, "pgo.max_loops": 8,
          "loop.submap_points": 2048, "loop.submap_half_width": 4}


def _small_scans(n=24):
    world = sim.make_world(4, extent=50.0, ground_pts=40_000)
    gt = sim.loop_trajectory(n, radius=15.0, speed=1.0)
    rng = np.random.default_rng(4)
    return [sim.render_scan(world, p, rng, n_points=6000) for p in gt]


def test_odometry_step_on_the_card_matches_the_host_branches(cuda):
    """The on-device step (flagged map updates) against the host-branch step
    from the same state, scan by scan, both through the kernel: the same
    poses and trip counts bit for bit, the same insert / swap decisions, the
    same grid origin and map travel."""
    cfg = tconfig.default_config().override(_SMALL)
    ospec = todom.spec_from_config(cfg)
    scans = _small_scans(14)
    f0 = filter_scan(make_cloud(*scans[0], capacity=8192, device=cuda), cfg.filter)
    state = todom.init_state(ospec, torch.zeros(6, device=cuda), f0.xyz, f0.mask)
    for xyz, inten in scans[1:]:
        f = filter_scan(make_cloud(xyz, inten, capacity=8192, device=cuda), cfg.filter)
        dev_state, dev_out = todom.step(state, f.xyz, f.mask, ospec, on_device=True)
        state, out = todom.step(state, f.xyz, f.mask, ospec)
        assert torch.equal(dev_out.pose, out.pose)
        assert (bool(dev_out.inserted), bool(dev_out.swapped)) == (out.inserted, out.swapped)
        assert int(dev_out.iterations) == out.iterations
        torch.testing.assert_close(dev_state.grid_a.origin, state.grid_a.origin)
        torch.testing.assert_close(dev_state.localmap_travel, state.localmap_travel,
                                   rtol=0, atol=1e-4)


def test_part_a_graph_replay_equals_eager_and_does_not_synchronise(cuda):
    """Part A as CUDA-graph replays gives the poses of Part A run eagerly,
    bit for bit, and neither makes a host synchronisation."""
    cfg = tconfig.default_config().override(_SMALL)
    scans = _small_scans(24)
    stager = tprefetch.ChunkStager(8192, 8, n_buffers=3, device=cuda)
    chunks = [stager.stage(scans[lo:lo + 8]) for lo in (0, 8, 16)]
    runs = []
    for use_graph in (True, False):
        pipe = tdp.DeviceSlamPipeline(cfg, kf_points=1024, log_capacity=64, device=cuda,
                                      use_graph=use_graph, check_sync=True)
        before = ndt_kernel.launches
        for c, (clouds, n_real) in enumerate(chunks):
            pipe.process_chunk(clouds, 0.1 * (8 * c + np.arange(8)), n_real)
        assert ndt_kernel.launches - before == 23
        assert pipe.part_a_replays == (22 if use_graph else 0)
        assert pipe.chunk_readbacks == 3
        pipe.finalize()
        runs.append((pipe.odometry_trajectory(), pipe.kf_count,
                     [r["keyframe"] for r in pipe.odom_log]))
    assert np.array_equal(runs[0][0], runs[1][0])
    assert runs[0][1:] == runs[1][1:] and runs[0][1] > 3


@pytest.mark.parametrize("case", ["sc", "radius_gps", "isc"])
def test_part_b_graph_replay_equals_eager_and_does_not_synchronise(cuda, case):
    """Part B as replays of its chains' CUDA graphs, the ICP and Gauss-Newton
    graphs replayed between them, gives the eager route's session bit for
    bit: the keyframe store, the factor graph, `loop_count`, the
    diagnostics and the log ring before `finalize`, the odometry log, loop
    table and optimized poses after it. Neither run synchronises
    (`check_sync`). Only the graph route replays: one replay a store, four a
    detection (three with ISC, whose retrieval stays eager) after each
    chain's first, eager, use; two captures. A
    `restore()` captures again, and the session it continues ends as the
    eager one."""
    cfg = part_b_cases.config(case)
    chunks = part_b_cases.stage(part_b_cases.scans(), cuda)
    runs = {}
    for use_graph in (True, False):
        pipe = tdp.DeviceSlamPipeline(cfg, kf_points=part_b_cases.KF_POINTS, log_capacity=64,
                                      device=cuda, use_graph=use_graph, check_sync=True)
        pgo0 = pgo_kernel.launches
        part_b_cases.feed(pipe, chunks[:1])
        saved = (part_b_cases.clone(pipe.state), pipe._scans_fed)
        part_b_cases.feed(pipe, chunks, first_chunk=1)
        state = part_b_cases.part_b_state(pipe)
        pipe.finalize()
        runs[use_graph] = (pipe, state, part_b_cases.results(pipe), saved,
                           pgo_kernel.launches - pgo0)
    (eager, e_state, e_res, _, e_pgo), (graph, g_state, g_res, saved, g_pgo) = \
        runs[False], runs[True]
    assert eager.loop_count >= 1 and e_pgo == g_pgo > 0
    assert eager.part_b_replays == eager.part_b_captures == 0
    assert graph.part_b_replays == part_b_cases.expected_replays(graph, graph.kf_count) > 0
    assert graph.part_b_captures == 2
    part_b_cases.assert_equal(e_state, g_state)
    part_b_cases.assert_equal(e_res, g_res)
    assert graph.icp_verifications == eager.icp_verifications >= 1

    graph.restore(*saved)
    part_b_cases.feed(graph, chunks, first_chunk=1)
    graph.finalize()
    assert graph.part_b_captures == 4
    part_b_cases.assert_equal(e_res, part_b_cases.results(graph))


def test_part_a_phase_events_read_without_synchronising(cuda):
    """Part A's graph carries its four phase events: under
    `set_sync_debug_mode("error")` (`check_sync`) each chunk's readback adds
    the last replay's filter, align and map intervals (one sample a chunk),
    and a replay timed by events around it takes no less than its phases;
    Part B's stages carry timing events only while spans are recorded."""
    from xchu_slam_tpu_torch.utils import profiling

    cfg = tconfig.default_config().override(_SMALL)
    scans = _small_scans(24)
    stager = tprefetch.ChunkStager(8192, 8, n_buffers=3, device=cuda)
    chunks = [stager.stage(scans[lo:lo + 8]) for lo in (0, 8, 16)]
    pipe = tdp.DeviceSlamPipeline(cfg, kf_points=1024, log_capacity=64, device=cuda,
                                  check_sync=True)
    for c, (clouds, n_real) in enumerate(chunks[:2]):
        pipe.process_chunk(clouds, 0.1 * (8 * c + np.arange(8)), n_real)
    with profiling.recording() as rec:
        pipe.process_chunk(chunks[2][0], 0.1 * (16 + np.arange(8)), chunks[2][1])
        pipe.finalize()
    st = pipe.stage_seconds
    assert st["device.samples"] == 3 and pipe.part_a_replays == 22
    for key, _a, _b in tdp.PART_A_PHASES:
        assert 0.0 < st[key] < 1.0, (key, st[key])
    stages = [r for r in rec.records if r.name.startswith("part_b.")]
    assert stages and all(r.device_ms is not None and r.device_ms >= 0 for r in stages)
    assert all(r.device_ms is None for r in rec.records if not r.name.startswith("part_b."))
    before, after = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    before.record()
    pipe._graph.replay()
    after.record()
    after.synchronize()
    ev = pipe._phase_events
    phases = sum(ev[a].elapsed_time(ev[b]) for _k, a, b in tdp.PART_A_PHASES)
    assert 0.0 < phases <= before.elapsed_time(after)


def test_part_a_in_other_modes_replays_without_synchronising(cuda):
    """The device engine in mt_exact + kdtree with the jacobi solve: chunks
    under `set_sync_debug_mode("error")` (`check_sync`), Part A's graph
    capturing that instantiation (replays equal to eager, bit for bit), the
    NDT launch counter counting each scan."""
    cfg = tconfig.default_config().override({**_SMALL, "ndt.ls_mode": "mt_exact",
                                             "ndt.neighbor_mode": "kdtree",
                                             "pgo.precond": "jacobi"})
    scans = _small_scans(24)
    stager = tprefetch.ChunkStager(8192, 8, n_buffers=3, device=cuda)
    chunks = [stager.stage(scans[lo:lo + 8]) for lo in (0, 8, 16)]
    runs = []
    for use_graph in (True, False):
        pipe = tdp.DeviceSlamPipeline(cfg, kf_points=1024, log_capacity=64, device=cuda,
                                      use_graph=use_graph, check_sync=True)
        before = ndt_kernel.launches
        for c, (clouds, n_real) in enumerate(chunks):
            pipe.process_chunk(clouds, 0.1 * (8 * c + np.arange(8)), n_real)
        assert ndt_kernel.launches - before == 23
        assert pipe.part_a_replays == (22 if use_graph else 0)
        pipe.finalize()
        runs.append((pipe.odometry_trajectory(), pipe.kf_count))
    assert np.array_equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1] > 3


def test_chunk_prefetcher_on_the_card_matches_the_cpu(cuda):
    """Staging through the pinned ring and the side stream: the same clouds
    as on the CPU, in order, across more chunks than the ring has buffers."""
    scans = _small_scans(24)[:21]
    on_cpu = list(tprefetch.DeviceChunkPrefetcher(scans, capacity=8192, chunk=4, depth=2,
                                                  threads=2, device="cpu"))
    with tprefetch.DeviceChunkPrefetcher(scans, capacity=8192, chunk=4, depth=2,
                                         threads=2, device=cuda) as pf:
        on_card = [(type(c)(*(t.cpu() for t in c)), n) for c, n in pf]
    assert [n for _c, n in on_card] == [n for _c, n in on_cpu] == [4, 4, 4, 4, 4, 1]
    for (a, _), (b, _) in zip(on_card, on_cpu):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_device_engine_part_b_on_the_card_matches_the_cpu(cuda):
    """Chunks with loop verifications, Part B included, under
    `set_sync_debug_mode("error")` with one readback a chunk: keyframes,
    loops and the loop diagnostics as on the CPU, optimised poses to 1e-3;
    the ICP and PGO kernels ran where a loop was verified and accepted."""
    over = {**_SMALL, "loop.method": "radius", "loop.radius_search": 12.0,
            "loop.min_time_diff": 0.5, "loop.detect_period": 1,
            "loop.icp_fitness_thresh": 1.5, "loop.max_correction": 5.0,
            "pgo.odom_noise_trans": 1e-3, "pgo.odom_noise_rot": 1e-3}
    cfg = tconfig.default_config().override(over)
    scans = _small_scans(24)
    runs = {}
    for dev in ("cpu", cuda):
        pipe = tdp.DeviceSlamPipeline(cfg, kf_points=1024, log_capacity=64, device=dev,
                                      check_sync=True)
        stager = tprefetch.ChunkStager(8192, 8, n_buffers=3, device=dev)
        icp0, pgo0 = icp_kernel.launches, pgo_kernel.launches
        for c in range(3):
            clouds, n_real = stager.stage(scans[8 * c:8 * c + 8])
            pipe.process_chunk(clouds, 0.1 * (8 * c + np.arange(8)), n_real)
        assert pipe.chunk_readbacks == 3
        pipe.finalize()
        runs[str(dev)] = (pipe, icp_kernel.launches - icp0, pgo_kernel.launches - pgo0)
    (cpu, _, _), (card, icp_n, pgo_n) = runs["cpu"], runs[str(cuda)]
    assert card.kf_count == cpu.kf_count and card.loop_count == cpu.loop_count
    assert card.icp_verifications == cpu.icp_verifications >= 1
    assert icp_n >= card.icp_verifications and (pgo_n >= 1 or card.loop_count == 0)
    for key in ("loop_cand", "loop_found", "loop_verify_ran"):
        assert [r[key] for r in card.odom_log] == [r[key] for r in cpu.odom_log]
    np.testing.assert_allclose(card.keyframe_trajectory()[2], cpu.keyframe_trajectory()[2],
                               atol=1e-3)


def _sensor_windows(n, seed=2):
    """IMU and wheel windows of the simulator along `_small_scans`' path."""
    gt = sim.loop_trajectory(n, radius=15.0, speed=1.0)
    stamps = 0.1 * np.arange(n)
    rng = np.random.default_rng(seed)
    imu = sim.imu_windows(gt, stamps, samples=16, rng=rng, gyro_noise=0.002, accel_noise=0.05)
    whl = sim.wheel_windows(gt, stamps, samples=16, rng=rng, vel_noise=0.03, gyro_noise=0.002)
    return gt, imu, whl


@pytest.mark.parametrize("use_imu,use_odom", [(True, False), (False, True), (True, True)])
def test_guess_kernel_matches_plain_version(cuda, use_imu, use_odom):
    """The guess kernel against `ext_guess_ref` on the same CUDA tensors,
    over 40 windows (the first fully masked): delta and velocity within
    1e-5, `use_ext` equal; reruns bit-identical; one launch a call."""
    gt, imu, whl = _sensor_windows(40)
    for i in range(len(gt)):
        pose0 = torch.from_numpy(gt[max(i - 1, 0)].astype(np.float32)).to(cuda)
        vel = torch.tensor([3.0, -1.0, 0.1], device=cuda)
        iw = timu.ImuWindow(*(torch.from_numpy(a[i]).to(cuda) for a in imu))
        ww = timu.OdomWindow(*(torch.from_numpy(a[i]).to(cuda) for a in whl))
        before = guess_kernel.launches
        got = timu.ext_guess(pose0, iw, ww, vel, use_imu, use_odom)
        again = timu.ext_guess(pose0, iw, ww, vel, use_imu, use_odom)
        assert guess_kernel.launches - before == 2
        want = timu.ext_guess_ref(pose0, iw, ww, vel, use_imu, use_odom)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
        torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-5)
        assert bool(got[1]) == bool(want[1]) == (i > 0)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_guess_kernel_takes_only_what_it_checks(cuda):
    _, imu, _ = _sensor_windows(4)
    iw = timu.ImuWindow(*(torch.from_numpy(a[2]).to(cuda) for a in imu))
    with pytest.raises(ValueError, match="CUDA"):
        guess_kernel.ext_guess(torch.zeros(6), iw, None, torch.zeros(3), True, False)
    with pytest.raises(ValueError, match="window is None"):
        guess_kernel.ext_guess(torch.zeros(6, device=cuda), iw, None,
                               torch.zeros(3, device=cuda), True, True)
    with pytest.raises(ValueError, match="imu window"):
        bad = iw._replace(gyro=iw.gyro[:, :2].contiguous())
        guess_kernel.ext_guess(torch.zeros(6, device=cuda), bad, None,
                               torch.zeros(3, device=cuda), True, False)


def test_part_a_with_windows_replays_without_synchronising(cuda):
    """Part A with IMU + wheel windows as CUDA-graph replays, under
    `set_sync_debug_mode("error")` (`check_sync`), gives the poses of Part A
    run eagerly, bit for bit; the guess kernel launches once a scan after
    the seed; the CPU run agrees to 1e-3."""
    over = {**_SMALL, "odom.use_imu": True, "odom.use_odom": True}
    cfg = tconfig.default_config().override(over)
    scans = _small_scans(24)
    _, imu, whl = _sensor_windows(24)
    runs = []
    for dev, use_graph in ((cuda, True), (cuda, False), ("cpu", False)):
        pipe = tdp.DeviceSlamPipeline(cfg, kf_points=1024, log_capacity=64, device=dev,
                                      use_graph=use_graph, check_sync=True)
        stager = tprefetch.ChunkStager(8192, 8, n_buffers=3, device=dev)
        before = guess_kernel.launches
        for c in range(3):
            clouds, n_real = stager.stage(scans[8 * c:8 * c + 8])
            idx = 8 * c + np.arange(8)
            wins = tdp.GuessWindows(timu.ImuWindow(*(a[idx] for a in imu)),
                                    timu.OdomWindow(*(a[idx] for a in whl)))
            pipe.process_chunk(clouds, 0.1 * idx, n_real, wins=wins)
        assert guess_kernel.launches - before == (23 if dev == cuda else 0)
        assert pipe.chunk_readbacks == 3
        pipe.finalize()
        runs.append((pipe.odometry_trajectory(), pipe.state.imu_vel.cpu()))
    assert np.array_equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    np.testing.assert_allclose(runs[0][0], runs[2][0], atol=1e-3)


def test_device_checkpoint_resumes_on_the_card(cuda, tmp_path):
    """A device-engine checkpoint written at a chunk boundary and loaded
    onto the card continues to the uninterrupted run's poses, bit for bit
    (the loaded pipeline runs its first scan eagerly, then replays)."""
    cfg = tconfig.default_config().override(_SMALL)
    scans = _small_scans(24)
    stager = tprefetch.ChunkStager(8192, 8, n_buffers=3, device=cuda)
    chunks = [stager.stage(scans[lo:lo + 8]) for lo in (0, 8, 16)]
    pipe = tdp.DeviceSlamPipeline(cfg, kf_points=1024, log_capacity=64, device=cuda)
    path = str(tmp_path / "dev.npz")
    for c, (clouds, n_real) in enumerate(chunks):
        pipe.process_chunk(clouds, 0.1 * (8 * c + np.arange(8)), n_real)
        if c == 0:
            tckpt.save_checkpoint(pipe, path)
    pipe.finalize()
    again = tckpt.load_checkpoint(path, device=cuda)
    for c, (clouds, n_real) in enumerate(chunks[1:], start=1):
        again.process_chunk(clouds, 0.1 * (8 * c + np.arange(8)), n_real)
    again.finalize()
    assert np.array_equal(again.odometry_trajectory(), pipe.odometry_trajectory())
    assert again.kf_count == pipe.kf_count


def test_batch_step_members_equal_single_steps(cuda):
    """`batch_step` of B = 3 sequences (one stream, one NDT launch a member)
    equals each member's single-sequence on-device step, bit for bit."""
    cfg = tconfig.default_config().override(_SMALL)
    ospec = todom.spec_from_config(cfg)
    scans = _small_scans(24)
    starts = (0, 6, 12)

    def filt(i):
        return filter_scan(make_cloud(*scans[i], capacity=8192, device=cuda), cfg.filter)

    first = [filt(s) for s in starts]
    states = tbatch.batch_init(ospec, torch.zeros(3, 6, device=cuda),
                               torch.stack([f.xyz for f in first]),
                               torch.stack([f.mask for f in first]))
    singles = [todom.init_state(ospec, torch.zeros(6, device=cuda), f.xyz, f.mask)
               for f in first]
    for k in range(1, 6):
        fs = [filt(s + k) for s in starts]
        states, out = tbatch.batch_step(states, torch.stack([f.xyz for f in fs]),
                                        torch.stack([f.mask for f in fs]), ospec)
        for b, f in enumerate(fs):
            singles[b], one = todom.step(singles[b], f.xyz, f.mask, ospec, on_device=True)
            assert torch.equal(out.pose[b], one.pose)
            assert int(out.iterations[b]) == int(one.iterations)


# --------------------------------------------- the mesh's entry points -- #

@pytest.mark.parametrize("neighbor_mode", ["direct1", "direct7", "direct26", "kdtree"])
@pytest.mark.parametrize("n", [4096, 1000])
def test_ndt_shard_pass_matches_plain_version(cuda, neighbor_mode, n):
    """The NDT kernel's shard pass against `ndt_deriv`'s pass on the same
    shard, at two pose pairs (the pass evaluated where its neighbourhood was
    gathered, and a line-search trial away from it), in each kind: (L, g, H)
    and (L, g) within 1e-5 of the largest entry, the fitness counts exact and
    Σ min d² within 1e-5 relative (the sums run in another order)."""
    spec, grid, src, mask, guess = _ndt_scene(np.random.default_rng(n + 7), n, cuda, "some")
    nspec = ndt.NdtSpec(neighbor_mode=neighbor_mode)
    d1, d2 = ndt.gauss_constants(nspec.outlier_ratio, nspec.resolution)
    step = torch.tensor([0.03, -0.02, 0.01, 0.002, 0.001, -0.004], device=cuda)
    before = ndt_kernel.launches
    for ctx, pose in ((guess, guess), (guess, guess + step)):
        nb = ndt_deriv.neighborhood(ctx, src, grid, spec, neighbor_mode)
        Lp, gp, Hp = ndt_deriv.ndt_value_grad_hess(pose, src, mask, grid, spec, d1, d2, nb=nb)
        fit_p = torch.stack([t.to(torch.float32) for t in ndt._fitness_sums(pose, src, mask,
                                                                            nb)])
        passes = ndt_kernel.pass_launches
        tot = {kind: ndt_kernel.shard_pass(grid.fin, grid.origin, src, mask, pose, ctx, spec,
                                           nspec, d1, d2, kind)
               for kind in ("hessian", "gradient", "fitness")}
        torch.cuda.synchronize()
        assert ndt_kernel.pass_launches == passes + 3
        h = tot["hessian"]
        got = torch.cat([h[:1], -d2 * h[1:7], ndt._upper6(h[7:28]).reshape(36)])
        want = torch.cat([Lp.reshape(1), gp, Hp.reshape(36)])
        assert float(want.abs().max()) > 0
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
        gr = tot["gradient"]
        assert float((gr[:1] - Lp).abs().max()) <= 1e-5 * float(want.abs().max())
        assert float((-d2 * gr[1:7] - gp).abs().max()) <= 1e-5 * float(want.abs().max())
        for kind in ("gradient", "fitness"):
            fit = tot[kind][28:31]
            assert float(fit[0]) == float(fit_p[0]) and float(fit[2]) == float(fit_p[2])
            torch.testing.assert_close(fit[1], fit_p[1], rtol=1e-5, atol=0)
    assert ndt_kernel.launches == before        # the shard pass is counted apart


@pytest.mark.parametrize("n", [4096, 2048, 1000, 5000])
def test_icp_split_reproduces_icp_step_bit_for_bit(cuda, n):
    """`icp_kernel.partial` (stage 0, stage 1 about its own sums) and
    `icp_kernel.solve`, which a mesh of one rank runs, against `icp_kernel.step`
    on the same state: the state and the transformed source equal bit for
    bit after every trip (5000 points run the step's loop past the points it
    keeps in registers)."""
    src, smask, tgt, tmask, init = icp_cases.scene(cuda, n=n)
    spec = icp.IcpSpec()
    max_d2 = spec.max_corr_dist ** 2
    live = torch.ones((), dtype=torch.bool, device=cuda)
    st_a, st_b = (torch.zeros(icp_kernel.STATE_FLOATS, device=cuda) for _ in range(2))
    cur_a, cur_b = torch.empty_like(src), torch.empty_like(src)
    icp_kernel.init(src, init, live, st_a, cur_a)
    icp_kernel.init(src, init, live, st_b, cur_b)
    trips = 0
    while float(st_a[icp_kernel.STATE["live"]]) > 0.5:
        idx, d2 = nn_kernel.nearest_neighbor(cur_a, tgt, tmask)
        icp_kernel.step(src, smask, tgt, idx, d2, cur_a, st_a, max_d2, spec.trans_eps,
                        spec.max_iterations)
        s8 = icp_kernel.partial(src, smask, tgt, idx, d2, st_b, max_d2, 0)
        s9 = icp_kernel.partial(src, smask, tgt, idx, d2, st_b, max_d2, 1, s8)
        icp_kernel.solve(src, torch.cat([s8, s9]), st_b, cur_b, spec.trans_eps,
                         spec.max_iterations)
        torch.cuda.synchronize()
        assert torch.equal(st_a, st_b) and torch.equal(cur_a, cur_b), trips
        trips += 1
    assert trips >= 2


@pytest.fixture
def mesh1(cuda, tmp_path):
    """A group of one rank on the card (gloo), formed in this process."""
    from xchu_slam_tpu_torch.parallel import distributed

    mesh = distributed.initialize("gloo", "file://" + str(tmp_path / "store"), 1, 0, cuda)
    try:
        yield mesh
    finally:
        torch.distributed.destroy_process_group()


def test_mesh_of_one_rank_matches_the_single_device_route(cuda, mesh1):
    """A mesh of one rank on the card against the single-device routes on
    the same inputs: ICP's transform, trip count and converged flag bit for
    bit (its split step is icp_step's arithmetic and a one-rank sum adds
    nothing), the fitness to 1e-5 relative (another block sum); NDT's pose
    within 1e-4 with the same iteration count (the shard pass's sums and
    the host's control against the kernel's own); the pose graph within
    1e-4; Scan Context retrieval equal."""
    from xchu_slam_tpu_torch.ops import scancontext as sc
    from xchu_slam_tpu_torch.utils import collectives

    args = icp_cases.scene(cuda)
    spec = icp.IcpSpec()
    staged = collectives.host_staged
    one = icp.align(*args, spec)
    got = icp.align(*args, spec, mesh=mesh1)
    assert torch.equal(got.T, one.T) and int(got.iterations) == int(one.iterations)
    assert bool(got.converged) == bool(one.converged)
    torch.testing.assert_close(got.fitness, one.fitness, rtol=1e-5, atol=0)
    assert collectives.host_staged > staged          # gloo carried the card's tensors

    nspec = ndt.NdtSpec()
    gspec, grid, src, mask, guess = _ndt_scene(np.random.default_rng(11), 8192, cuda)
    a = ndt.align(grid, src, mask, guess, gspec, nspec)
    b = ndt.align(grid, src, mask, guess, gspec, nspec, mesh=mesh1)
    assert int(a.iterations) == int(b.iterations)
    torch.testing.assert_close(b.pose, a.pose, rtol=0, atol=1e-4)

    poses, graph = pgo_cases.chain_graph(K=2048, L=256, n_live=163, n_loops=9, gps=True)
    p_d, g_d = torch.from_numpy(poses).to(cuda), pgo_cases.to_device(graph, cuda)
    gs = tpg.inloop_spec(tpg.spec_from_config(tconfig.default_config().pgo))._replace(
        odom_info_t=1e3, odom_info_r=1e3)
    torch.testing.assert_close(tpg.solve(p_d, g_d, gs, mesh=mesh1), tpg.solve(p_d, g_d, gs),
                               rtol=0, atol=1e-4)

    spec_sc = sc.ScSpec()
    rng = np.random.default_rng(5)
    db = torch.from_numpy(rng.uniform(0, 2, (64, 20, 60)).astype(np.float32)).to(cuda)
    q = torch.roll(db[9], 4, dims=1)
    w = sc.detect_loop_on_device(q, db, 60, spec_sc)
    g = sc.detect_loop_on_device(q, db, 60, spec_sc, mesh=mesh1)
    assert int(g.idx) == int(w.idx) == 9 and bool(g.found) == bool(w.found)

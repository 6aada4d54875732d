"""The port's loop-closure stack against the JAX reference: the NN search
(plain version vs the Pallas kernel in interpret mode), ICP, Scan Context
and the pose-graph solve."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xchu_slam_tpu.models import pose_graph as jpg
from xchu_slam_tpu.ops import icp as jicp, scancontext as jsc
from xchu_slam_tpu.ops.pallas import nn_kernel as jnn
from xchu_slam_tpu.utils import se3 as jse3
from xchu_slam_tpu_torch import convert
from xchu_slam_tpu_torch.models import pose_graph as tpg
from xchu_slam_tpu_torch.ops import icp as ticp, scancontext as tsc
from xchu_slam_tpu_torch.ops.cuda import nn_kernel as tnn
from xchu_slam_tpu_torch.utils import sim

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ NN search -- #

def _nn_case(name, rng):
    N, M = jnn.SRC_TILE, 2 * jnn.TGT_TILE
    src = rng.normal(size=(N, 3)).astype(np.float32) * 30.0
    tgt = rng.normal(size=(M, 3)).astype(np.float32) * 30.0
    mask = np.ones(M, bool)
    if name == "masked_stretch":
        mask[M // 3:M // 2] = False
    elif name == "all_but_one":
        mask[:] = False
        mask[5] = True
    elif name == "all_masked":
        mask[:] = False
    return src, tgt, mask


@pytest.mark.parametrize("name", ["dense", "masked_stretch", "all_but_one", "all_masked"])
def test_nearest_neighbor_ref_matches_pallas_kernel(name):
    """Distances to 1e-4 and indices at valid targets (near-ties may pick
    another index, so distances are compared, not indices)."""
    src, tgt, mask = _nn_case(name, np.random.default_rng(7))
    jidx, jd2 = (np.asarray(a) for a in jnn.nearest_neighbor(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask)))
    tidx, td2 = tnn.nearest_neighbor(_t(src), _t(tgt), _t(mask))
    tidx, td2 = tidx.numpy(), td2.numpy()
    assert tidx.dtype == np.int32 and td2.dtype == np.float32
    np.testing.assert_allclose(td2, jd2, rtol=1e-4, atol=1e-4)
    if mask.any():
        assert mask[tidx].all()
    else:
        assert (tidx == 0).all() and (td2 == 1e30).all()


def test_nearest_neighbor_wrapper_checks_and_ragged_shapes():
    rng = np.random.default_rng(8)
    src = rng.normal(size=(1000, 3)).astype(np.float32)
    tgt = rng.normal(size=(3000, 3)).astype(np.float32)
    mask = rng.random(3000) > 0.2
    idx, d2 = tnn.nearest_neighbor(_t(src), _t(tgt), _t(mask))
    dist = ((src[:, None] - tgt[None]) ** 2).sum(-1)
    dist[:, ~mask] = np.inf
    np.testing.assert_allclose(d2.numpy(), dist.min(1), rtol=1e-4, atol=1e-4)
    with pytest.raises(TypeError):
        tnn.nearest_neighbor(_t(src).double(), _t(tgt), _t(mask))
    with pytest.raises(ValueError):
        tnn.nearest_neighbor(_t(src), _t(tgt), _t(mask[:10]))
    with pytest.raises(ValueError):
        tnn.nearest_neighbor(_t(src).to("meta"), _t(tgt).to("meta"), _t(mask).to("meta"))


# ------------------------------------------------------------------ ICP -- #

@pytest.fixture(scope="module")
def icp_pair():
    """A keyframe cloud and a submap of its neighbourhood from a sim world,
    with an initial guess 0.4 m / 0.05 rad off the true relative pose."""
    world = sim.make_world(12, extent=60.0)
    rng = np.random.default_rng(12)
    gt = sim.loop_trajectory(12, radius=15.0, speed=1.0)
    T = np.asarray(jse3.pose_to_matrix(jnp.asarray(gt)))
    sub = []
    for k in range(2, 10):
        xyz = sim.render_scan(world, gt[k], rng, n_points=2000)[0]
        rel = np.linalg.inv(T[6]) @ T[k]
        sub.append(xyz @ rel[:3, :3].T + rel[:3, 3])
    tgt = np.vstack(sub).astype(np.float32)
    sel = rng.choice(len(tgt), 4096, replace=False)
    tgt = tgt[sel]
    src = sim.render_scan(world, gt[7], rng, n_points=1024)[0][:1024].astype(np.float32)
    src = np.pad(src, ((0, 1024 - len(src)), (0, 0)))
    true = np.linalg.inv(T[6]) @ T[7]
    off = np.asarray(jse3.pose_to_matrix(jnp.asarray([0.3, -0.25, 0.0, 0.0, 0.0, 0.05],
                                                     jnp.float32)))
    init = (true @ off).astype(np.float32)
    return src, np.ones(1024, bool), tgt, np.ones(4096, bool), init, true


def test_icp_align_matches_reference(icp_pair):
    """T within 1e-3 m / 1e-4 rad, fitness within 1e-4 relative."""
    src, smask, tgt, tmask, init, true = icp_pair
    spec = jicp.IcpSpec()
    j = jicp.align(jnp.asarray(src), jnp.asarray(smask), jnp.asarray(tgt),
                   jnp.asarray(tmask), jnp.asarray(init), spec)
    t = ticp.align(_t(src), _t(smask), _t(tgt), _t(tmask), _t(init), ticp.IcpSpec())
    Tj, Tt = np.asarray(j.T), t.T.numpy()
    assert t.converged == bool(j.converged) and t.iterations == int(j.iterations)
    assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() <= 1e-3
    assert np.abs(Tt[:3, :3] - Tj[:3, :3]).max() <= 1e-4
    assert abs(t.fitness - float(j.fitness)) <= 1e-4 * float(j.fitness)
    # and the registration is right
    assert np.linalg.norm(Tt[:3, 3] - true[:3, 3]) < 0.2


def test_icp_spec_from_config():
    from xchu_slam_tpu.config import LoopConfig as JL
    from xchu_slam_tpu_torch.config import LoopConfig as TL
    assert tuple(ticp.spec_from_config(TL())) == tuple(jicp.spec_from_config(JL()))[:3]


# ---------------------------------------------------------- Scan Context -- #

def test_scan_context_descriptor_and_retrieval_match_reference():
    world = sim.make_world(13, extent=60.0)
    rng = np.random.default_rng(13)
    spec_j = jsc.ScSpec(num_exclude_recent=3, dist_thresh=0.35)
    spec_t = tsc.ScSpec(num_exclude_recent=3, dist_thresh=0.35)
    gt = sim.loop_trajectory(10, radius=8.0, speed=1.0)
    gt = np.vstack([gt, gt[1:3] + np.array([0.2, 0.1, 0, 0, 0, 0.7], np.float32)])
    descs_j, descs_t = [], []
    for p in gt:
        xyz = sim.render_scan(world, p, rng, n_points=6000)[0]
        mask = np.ones(len(xyz), bool)
        mask[::11] = False
        dj = np.asarray(jsc.make_descriptor(jnp.asarray(xyz), jnp.asarray(mask), spec_j))
        dt = tsc.make_descriptor(_t(xyz), _t(mask), spec_t).numpy()
        assert np.array_equal(dt, dj)
        descs_j.append(dj)
        descs_t.append(dt)
    K = 16
    db = np.zeros((K, 20, 60), np.float32)
    db[:len(gt)] = np.stack(descs_j)
    db_mask = np.arange(K) < len(gt)
    dj, sj = (np.asarray(a) for a in jsc.distance_all_rotations(
        jnp.asarray(db[len(gt) - 1]), jnp.asarray(db), jnp.asarray(db_mask), spec_j))
    dt, st = tsc.distance_all_rotations(_t(db[len(gt) - 1]), _t(db), _t(db_mask), spec_t)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-5, atol=1e-6)
    assert np.array_equal(st.numpy(), sj)
    for cur in (len(gt) - 2, len(gt) - 1):
        cj = jsc.detect_loop(jnp.asarray(db[cur]), jnp.asarray(db), jnp.int32(len(gt)),
                             spec_j, cur=jnp.int32(cur))
        ct = tsc.detect_loop(_t(db[cur]), _t(db), len(gt), spec_t, cur=cur)
        assert ct.found == bool(cj.found) and ct.idx == int(cj.idx)
        assert abs(ct.dist - float(cj.dist)) <= 1e-5
        assert abs(ct.yaw - float(cj.yaw)) <= 1e-6
    assert ct.found


# ----------------------------------------------------------- pose graph -- #

def _graph(K=48, L=6, n_live=40, seed=0, gps=False):
    """A drifting chain of n_live keyframes in capacity K plus loop factors
    that pull it back to the truth (numpy, reference layout)."""
    rng = np.random.default_rng(seed)
    truth = np.zeros((K, 6), np.float32)
    truth[:, 0] = 10 * np.cos(np.linspace(0, 2 * np.pi, K))
    truth[:, 1] = 10 * np.sin(np.linspace(0, 2 * np.pi, K))
    truth[:, 5] = np.linspace(0, 2 * np.pi, K) + np.pi / 2
    T = np.asarray(jse3.pose_to_matrix(jnp.asarray(truth)))
    Z = np.einsum("kab,kbc->kac", np.linalg.inv(T[:-1]), T[1:])
    noise = np.asarray(jse3.pose_to_matrix(jnp.asarray(
        rng.normal(size=(K - 1, 6)).astype(np.float32) * [0.02, 0.02, 0.01, 0.002, 0.002, 0.01])))
    Zn = np.einsum("kab,kbc->kac", Z, noise)
    est = [T[0]]
    for k in range(K - 1):
        est.append(est[-1] @ Zn[k])
    poses = np.asarray(jse3.matrix_to_pose(jnp.asarray(np.stack(est)))).astype(np.float32)
    g = jpg.empty_graph(jpg.GraphSpec(max_keyframes=K, max_loops=L))
    between = np.array(g.between_T)
    between[1:n_live] = Zn[:n_live - 1]
    kf_mask = np.arange(K) < n_live
    li = rng.integers(0, 5, L).astype(np.int32)
    lj = rng.integers(n_live - 6, n_live, L).astype(np.int32)
    lT = np.einsum("kab,kbc->kac", np.linalg.inv(T[li]), T[lj]).astype(np.float32)
    lmask = np.arange(L) < L - 1
    gps_mask = (rng.random(K) < 0.3) if gps else np.zeros(K, bool)
    graph = jpg.GraphData(
        between_T=between.astype(np.float32), kf_mask=kf_mask, loop_i=li, loop_j=lj,
        loop_T=lT, loop_info=rng.uniform(1.0, 5.0, L).astype(np.float32), loop_mask=lmask,
        gps_alt=truth[:, 2] + 0.1, gps_mask=gps_mask)
    return poses, graph


@pytest.mark.parametrize("gps", [False, True])
def test_pose_graph_solve_matches_reference(gps):
    """Chain + loops (+ altitude factors), dead keyframes past the live
    prefix: optimized poses within 1e-4 of the reference."""
    poses, graph = _graph(gps=gps)
    spec = jpg.GraphSpec(max_keyframes=48, max_loops=6, gn_iterations=4,
                         cg_iterations=60, odom_info_t=1e3, odom_info_r=1e3)
    oj = np.asarray(jpg.solve(jnp.asarray(poses), jpg.GraphData(*map(jnp.asarray, graph)),
                              spec))
    ot = tpg.solve(_t(poses), convert.graph_from_ref(graph), tpg.GraphSpec(*spec)).numpy()
    assert np.abs(oj - poses).max() > 1e-2          # the solve moved the chain
    np.testing.assert_allclose(ot, oj, atol=1e-4)
    assert np.array_equal(ot[40:], poses[40:])       # dead keyframes untouched


def test_block_tridiag_factor_and_solve_match_reference():
    rng = np.random.default_rng(3)
    K = 33
    J = rng.normal(size=(K, 6, 6)).astype(np.float32)
    D = (np.einsum("kab,kcb->kac", J, J) + 6 * np.eye(6)).astype(np.float32)
    U = (rng.normal(size=(K, 6, 6)) * 0.3).astype(np.float32)
    U[25:] = 0.0                      # a decoupled tail, batched in the port
    r = rng.normal(size=(K, 6)).astype(np.float32)
    dj, cj, Aj = jpg.block_tridiag_factor(jnp.asarray(D), jnp.asarray(U))
    zj = np.asarray(jpg.block_tridiag_solve(dj, cj, Aj, jnp.asarray(r)))
    dt, ct, At = tpg.block_tridiag_factor(_t(D), _t(U))
    zt = tpg.block_tridiag_solve(dt, ct, At, _t(r)).numpy()
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(At.numpy(), np.asarray(Aj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(zt, zj, rtol=1e-4, atol=1e-4 * np.abs(zj).max())


def test_pose_graph_helpers_match_reference():
    poses, graph = _graph(K=16, L=4, n_live=16)
    T = np.asarray(jse3.pose_to_matrix(jnp.asarray(poses)))
    ki, kj = np.arange(15), np.arange(1, 16)
    rj = np.asarray(jax_vmap_residual(T[ki], T[kj], graph.between_T[1:]))
    rt = tpg._between_residual(_t(T[ki]), _t(T[kj]), _t(graph.between_T[1:])).numpy()
    np.testing.assert_allclose(rt, rj, atol=1e-5)
    Jij, Jjj = (np.asarray(a) for a in jpg._edge_jacobians(
        jnp.asarray(T), jnp.asarray(ki), jnp.asarray(kj), jnp.asarray(graph.between_T[1:])))
    Jit, Jjt = (a.numpy() for a in tpg._edge_jacobians(
        _t(T), torch.from_numpy(ki), torch.from_numpy(kj), _t(graph.between_T[1:])))
    np.testing.assert_allclose(Jit, Jij, atol=1e-4)
    np.testing.assert_allclose(Jjt, Jjj, atol=1e-4)
    w = np.random.default_rng(1).normal(size=(5, 6)).astype(np.float32)
    np.testing.assert_allclose(tpg._cauchy_weights(_t(w), 1.0).numpy(),
                               np.asarray(jpg._cauchy_weights(jnp.asarray(w), 1.0)),
                               rtol=1e-6)
    spec = jpg.GraphSpec(gn_iterations=8, inloop_gn_iterations=2)
    assert tuple(tpg.inloop_spec(tpg.GraphSpec(*spec))) == tuple(jpg.inloop_spec(spec))


def jax_vmap_residual(Ti, Tj, Z):
    import jax
    return jax.vmap(jpg._between_residual)(jnp.asarray(Ti), jnp.asarray(Tj), jnp.asarray(Z))


def test_convert_graph_roundtrip():
    _, graph = _graph()
    back = convert.graph_to_ref(convert.graph_from_ref(graph))
    for f in graph._fields:
        got, want = back[f], np.asarray(getattr(graph, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f

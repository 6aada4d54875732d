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


# the chain's preconditioner keeps its ids ([False], [True])
@pytest.mark.parametrize("gps,precond", [(False, "tridiag"), (True, "tridiag"),
                                         (False, "jacobi"), (True, "jacobi")],
                         ids=["False", "True", "False-jacobi", "True-jacobi"])
def test_pose_graph_solve_matches_reference(gps, precond):
    """Chain + loops (+ altitude factors), dead keyframes past the live
    prefix, with either preconditioner: optimized poses within 1e-4 of the
    reference. The block-Jacobi CG needs some 200-400 iterations on this
    chain where the chain's needs 3-4: cut at 60 or 200 it is an unconverged
    Krylov iterate, whose float32 value depends on the rounding order (the
    reference's differs from a float64 run of the same iterations by more
    than this tolerance), so jacobi is held at a budget in which both
    converge."""
    poses, graph = _graph(gps=gps)
    spec = jpg.GraphSpec(max_keyframes=48, max_loops=6, gn_iterations=4,
                         cg_iterations=60 if precond == "tridiag" else 400,
                         odom_info_t=1e3, odom_info_r=1e3, precond=precond)
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


def _segment_links(n_seq):
    """csrc/pgo_kernel.cu's cut: the fewest links a segment with 2·L² ≥ n_seq
    and at most 64 segments."""
    lseg = 1
    while 2 * lseg * lseg < n_seq or 64 * lseg < n_seq:
        lseg += 1
    return lseg


def _segmented_solve(d, chols, A, r, n_seq):
    """`block_tridiag_solve` as csrc/pgo_kernel.cu's segmented substitutions
    compute it (a plain float32 emulation for this test): each sweep cuts
    [0, n_seq) into segments of `_segment_links` links, runs every segment
    from zero with its 6×6 transfer product, carries the boundaries in
    order, then runs every segment again from its incoming value."""
    lseg = _segment_links(n_seq)
    segs = [(lo, min(lo + lseg, n_seq)) for lo in range(0, n_seq, lseg)]
    Az = torch.cat([A, torch.zeros_like(A[:1])])   # A[K] = 0 past the last block
    w = r / d

    def sweep(back):
        def links(lo, hi):   # (keyframe, link matrix) in the sweep's order
            ks = range(hi - 1, lo - 1, -1) if back else range(lo, hi)
            return [(k, -Az[k + 1] if back else -Az[k].T) for k in ks]

        ends, trans = [], []
        for lo, hi in segs:
            y, P = torch.zeros(6), torch.eye(6)
            for k, M in links(lo, hi):
                y, P = w[k] + M @ y, M @ P
            ends.append(y)
            trans.append(P)
        y, start = torch.zeros(6), [None] * len(segs)
        for t in (reversed(range(len(segs))) if back else range(len(segs))):
            start[t] = y
            y = ends[t] + trans[t] @ y
        for t, (lo, hi) in enumerate(segs):
            y = start[t]
            for k, M in links(lo, hi):
                y = w[k] + M @ y
                w[k] = y

    sweep(False)
    w = torch.cholesky_solve(w[..., None], chols)[..., 0]
    sweep(True)
    return w / d


# coupled keyframes: a chain with no coupling (the gauge-fixed U[1] = 0), one
# link, segment counts 4 → 3, segments of 9 and 10 links ending on a boundary
# and past one, 64 segments of 32 and 63 of 33
@pytest.mark.parametrize("n", [2, 3, 8, 9, 162, 163, 2047, 2048, 2049])
@pytest.mark.parametrize("info", [1e3, 1e6])
def test_segmented_substitution_matches_reference(n, info):
    """The kernel's segmented substitutions, emulated, against the JAX
    reference's associative-scan solve, both on the reference's factor of a
    chain's preconditioner at information 1e3 and 1e6: within 1e-5 of max |z|
    (measured: 1.5e-6 at 2048 links; the port's plain doubling scans 8.8e-7).
    The factor is shared because two float32 factors of the 2048-link chain
    already differ by 6e-4 of max |z|, which would hide the substitution's
    own rounding."""
    import pgo_cases

    _, graph = pgo_cases.chain_graph(K=n, L=2, n_live=n, n_loops=0)
    spec = tpg.GraphSpec(max_keyframes=n, max_loops=2, odom_info_t=info, odom_info_r=info)
    s = tpg._gn_system(se3_t().pose_to_matrix(torch.zeros(n, 6)), graph, spec)
    r = torch.from_numpy(np.random.default_rng(n).normal(size=(n, 6)).astype(np.float32))
    factor = jpg.block_tridiag_factor(jnp.asarray(s.blocks.numpy()), jnp.asarray(s.U.numpy()))
    zj = np.asarray(jpg.block_tridiag_solve(*factor, jnp.asarray(r.numpy())))
    d, chols, A = (torch.from_numpy(np.asarray(f)) for f in factor)
    n_seq = int(tpg.live_prefix(s.U, torch.zeros(n, dtype=torch.bool))[0])
    zs = _segmented_solve(d, chols, A, r, n_seq).numpy()
    np.testing.assert_allclose(zs, zj, rtol=0, atol=1e-5 * np.abs(zj).max())


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


# ------------------------------------- the loop back end on the card's terms -- #

def _kabsch_reference(M):
    """The reference's rotation step (xchu_slam_tpu/ops/icp.py:132-135)."""
    U, _s, Vt = jnp.linalg.svd(jnp.asarray(M))
    det = jnp.linalg.det(jnp.matmul(U, Vt, precision=jax_highest()))
    S = jnp.diag(jnp.array([1.0, 1.0, 1.0])).at[2, 2].set(det)
    return np.asarray(jnp.matmul(jnp.matmul(U, S, precision=jax_highest()), Vt,
                                 precision=jax_highest()))


def jax_highest():
    import jax
    return jax.lax.Precision.HIGHEST


def _cross_cov(kind, rng):
    """3×3 cross-covariances M = Σ (t − μt)(s − μs)ᵀ / n of the kinds ICP
    meets: random, planar (rank 2), reflecting (det < 0), near identity."""
    if kind == "random":
        return rng.normal(size=(3, 3)).astype(np.float32)
    if kind == "reflection":
        M = rng.normal(size=(3, 3))
        return (M if np.linalg.det(M) < 0 else -M).astype(np.float32)
    scale = [10.0, 10.0, 0.0] if kind == "planar" else [20.0, 15.0, 3.0]
    rot = 0.3 if kind == "planar" else 1e-4
    s = rng.normal(size=(200, 3)) * scale
    R = np.asarray(jse3.pose_to_matrix(jnp.asarray(
        np.r_[0, 0, 0, rng.normal(size=3) * rot].astype(np.float32))))[:3, :3]
    t = s @ R.T + rng.normal(size=(200, 3)) * (0.01 if kind == "planar" else 0.0)
    return ((t - t.mean(0)).T @ (s - s.mean(0)) / 200).astype(np.float32)


def _horn_jacobi(M):
    """csrc/icp_kernel.cu's rotation step (horn_quaternion) emulated in
    float32: Horn's 4×4 N, Jacobi sweeps in parallel order (three rounds of
    the disjoint pairs (k, k ^ r) a sweep; t = sgn θ·r/(|θ|·r + 1) with
    r = 1/√(θ² + 1), θ held to ±1e18), each rotated pair set to 0, until
    off-diagonal² ≤ 1e-14·Frobenius² or 8 sweeps; the unit quaternion of the
    largest diagonal entry's column of V, then R. The kernel's reciprocals
    and roots are fast (a few ulp); these are exact."""
    f32 = np.float32
    S = np.asarray(M, f32).T
    (Sxx, Sxy, Sxz), (Syx, Syy, Syz), (Szx, Szy, Szz) = S
    N = np.array([[Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
                  [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
                  [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
                  [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz]], f32)
    V = np.eye(4, dtype=f32)
    frob2 = np.sum(N * N, dtype=f32)
    for _ in range(8):
        if np.sum((N - np.diag(np.diag(N))) ** 2, dtype=f32) <= f32(1e-14) * frob2:
            break
        for r in (1, 2, 3):
            J = np.zeros((4, 4), f32)
            for k in range(4):
                p, q = min(k, k ^ r), max(k, k ^ r)
                c, s = f32(1), f32(0)
                if N[p, q] != 0:
                    theta = np.clip(f32(0.5) * (N[q, q] - N[p, p]) / N[p, q], f32(-1e18),
                                    f32(1e18))
                    rt = f32(1) / np.sqrt(theta * theta + f32(1))
                    t = np.copysign(rt / (abs(theta) * rt + f32(1)), theta)
                    c = f32(1) / np.sqrt(t * t + f32(1))
                    s = t * c
                J[k, k] = c
                J[k ^ r, k] = -s if k == p else s
            N = (J.T @ N @ J).astype(f32)
            for k in range(4):
                N[k, k ^ r] = 0
            V = (V @ J).astype(f32)
    best = 0
    for k in range(1, 4):
        if N[k, k] > N[best, best]:
            best = k
    w, x, y, z = V[:, best] / np.sqrt(np.sum(V[:, best] ** 2))
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]], f32)


@pytest.mark.parametrize("route", ["kabsch_ref", "horn_jacobi"])
@pytest.mark.parametrize("kind", ["random", "planar", "reflection", "near_identity"])
def test_kabsch_step_matches_reference_svd_route(kind, route):
    """The plain Kabsch step (the kernel's plain version) and the kernel's
    eigen-solve, emulated, against the reference's SVD route: R to 1e-5, a
    proper rotation in every case."""
    rng = np.random.default_rng(["random", "planar", "reflection",
                                 "near_identity"].index(kind))
    for _ in range(8):
        M = _cross_cov(kind, rng)
        R = ticp.kabsch_ref(_t(M)).numpy() if route == "kabsch_ref" else _horn_jacobi(M)
        np.testing.assert_allclose(R, _kabsch_reference(M), atol=1e-5)
        assert abs(np.linalg.det(R) - 1.0) < 1e-5


@pytest.mark.parametrize("cap", [100, 16], ids=["converges", "hits-the-cap"])
def test_fixed_trip_icp_matches_reference(icp_pair, cap):
    """`align_ref`, the fixed-trip loop masked on `live`, against the
    reference's while loop: the same iteration count and converged flag
    (also where the cap ends it), T to 1e-5; with `live` false a no-op."""
    src, smask, tgt, tmask, init, _true = icp_pair
    jspec, tspec = jicp.IcpSpec(max_iterations=cap), ticp.IcpSpec(max_iterations=cap)
    j = jicp.align(jnp.asarray(src), jnp.asarray(smask), jnp.asarray(tgt),
                   jnp.asarray(tmask), jnp.asarray(init), jspec)
    args = (_t(src), _t(smask), _t(tgt), _t(tmask), _t(init), tspec)
    t = ticp.align(*args, live=torch.tensor(True))
    assert int(t.iterations) == int(j.iterations) and bool(t.converged) == bool(j.converged)
    assert (int(t.iterations), bool(t.converged)) == ((cap, False) if cap == 16
                                                      else (int(j.iterations), True))
    np.testing.assert_allclose(t.T.numpy(), np.asarray(j.T), atol=1e-5)
    off = ticp.align(*args, live=torch.tensor(False))
    assert torch.equal(off.T, _t(init)) and int(off.iterations) == 0
    assert not bool(off.converged) and float(off.fitness) == 0.0


def test_pose_graph_solve_at_capacity_matches_reference():
    """K = 2048 slots with 160 live keyframes, 9 live loops of 256 slots and
    altitude factors (the circuit's shape), the in-loop spec: poses within
    1e-4 of the reference's `solve`; the live prefix found without a
    readback equals the one the plain factor reads back."""
    import pgo_cases

    poses, graph = pgo_cases.chain_graph(K=2048, L=256, n_live=160, n_loops=9, gps=True)
    spec = jpg.GraphSpec(gn_iterations=2, odom_info_t=1e3, odom_info_r=1e3)
    ref = convert.graph_to_ref(graph)
    oj = np.asarray(jpg.solve(jnp.asarray(poses),
                              jpg.GraphData(**{k: jnp.asarray(v) for k, v in ref.items()}),
                              spec))
    ot = tpg.solve(_t(poses), graph, tpg.GraphSpec(*spec)).numpy()
    assert np.abs(oj - poses).max() > 1e-2
    np.testing.assert_allclose(ot, oj, atol=1e-4)
    assert np.array_equal(ot[160:], poses[160:])
    # the prefix: today's readback form against the device form
    Ts = se3_t().pose_to_matrix(_t(poses))
    s = tpg._gn_system(Ts, graph, tpg.GraphSpec(*spec))
    coupled = (s.U[1:] != 0).flatten(1).any(1).nonzero()
    n_seq_readback = int(coupled.max()) + 2 if coupled.numel() else 1
    n_seq, n_act = tpg.live_prefix(s.U, graph.kf_mask)
    assert int(n_seq) == n_seq_readback == 160 and int(n_act) == 160
    ran = tpg.solve(_t(poses), graph, tpg.GraphSpec(*spec), run=torch.tensor(False))
    assert torch.equal(ran, _t(poses))


def se3_t():
    from xchu_slam_tpu_torch.utils import se3
    return se3


def _descriptor_store(rng, K=40, R=20, S=60, sparse=0.0):
    """A store of nonnegative polar images whose entry 4, rolled by 7
    columns and perturbed, is the query."""
    db = rng.uniform(0.1, 3.0, (K, R, S)).astype(np.float32)
    if sparse:
        db *= rng.random((K, R, S)) < sparse
    query = np.roll(db[4], -7, axis=1) * rng.uniform(0.98, 1.02, (R, S)).astype(np.float32)
    return db, query.astype(np.float32)


@pytest.mark.parametrize("found", [True, False], ids=["found", "not-found"])
@pytest.mark.parametrize("method", ["sc", "isc", "radius"])
def test_detect_loop_tensor_forms_equal_host_forms(method, found):
    """The retrievals' device forms (0-d tensors, nothing read back) equal
    their host forms and the reference's traced forms: index (-1 where none),
    found, yaw."""
    from xchu_slam_tpu.ops import isc as jisc
    from xchu_slam_tpu.models import device_pipeline as jdp
    from xchu_slam_tpu_torch.models import pipeline as tpipe
    from xchu_slam_tpu_torch.ops import isc as tisc

    rng = np.random.default_rng(5)
    K, cur = 40, 30
    if method == "sc":
        db, q = _descriptor_store(rng)
        spec = tsc.ScSpec(num_exclude_recent=3, dist_thresh=0.2 if found else 1e-6)
        dev = tsc.detect_loop_on_device(_t(q), _t(db), cur + 1, spec, cur=cur)
        host = tsc.detect_loop(_t(q), _t(db), cur + 1, spec, cur=cur)
        ref = jsc.detect_loop(jnp.asarray(q), jnp.asarray(db), jnp.int32(cur + 1),
                              jsc.ScSpec(*spec), cur=jnp.int32(cur))
    elif method == "isc":
        db, q = _descriptor_store(rng, R=60, sparse=0.3)
        travel = (3.0 * np.arange(K)).astype(np.float32)
        pos = np.zeros((K, 3), np.float32)
        pos[:, 0] = travel * 0.01
        pos[4, 0] = pos[cur, 0] - 0.5
        spec = tisc.IscSpec(geometry_thresh=0.3, intensity_thresh=0.3 if found else 0.999)
        args = (_t(q), _t(db), cur + 1, _t(pos), _t(travel), spec)
        dev = tisc.detect_loop_on_device(*args, cur=cur)
        host = tisc.detect_loop(*args, cur=cur)
        ref = jisc.detect_loop(jnp.asarray(q), jnp.asarray(db), jnp.int32(cur + 1),
                               jnp.asarray(pos), jnp.asarray(travel), jisc.IscSpec(*spec),
                               cur=jnp.int32(cur))
    else:
        from types import SimpleNamespace as NS

        from xchu_slam_tpu_torch import config as tconfig
        from xchu_slam_tpu_torch.models import device_pipeline as tdp

        opt = np.zeros((64, 6), np.float32)
        opt[:cur + 1, 0] = 4.0 * np.arange(cur + 1)
        opt[4, 0] = opt[cur, 0] - 1.0
        stamps = (2.0 * np.arange(64)).astype(np.float32)
        spec = NS(radius_search=5.0 if found else 0.1, min_time_diff=30.0)
        db = tpipe.empty_db(tconfig.default_config().override({"pgo.max_keyframes": 64}), 16)
        db = db._replace(opt_poses=_t(opt), poses=_t(opt), stamps=_t(stamps), count=cur + 1)
        d_idx, d_found = tdp._sc_radius_candidate(NS(db=db), cur, float(stamps[cur]), spec)
        h_idx = tpipe._radius_candidate(db, cur, float(stamps[cur]), spec.radius_search,
                                        spec.min_time_diff)
        jdb = NS(poses=jnp.asarray(opt), opt_poses=jnp.asarray(opt), stamps=jnp.asarray(stamps))
        r_idx, r_found = jdp._sc_radius_candidate(NS(db=jdb), jnp.int32(cur),
                                                  jnp.float32(stamps[cur]), spec)
        assert d_idx.dim() == 0 and d_found.dim() == 0
        assert int(d_idx) == h_idx == int(r_idx) == (4 if found else -1)
        assert bool(d_found) == bool(r_found) == found
        return
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in dev)
    assert int(dev.idx) == host.idx == int(ref.idx) == (4 if found else -1)
    assert bool(dev.found) == host.found == bool(ref.found) == found
    assert abs(float(dev.yaw) - host.yaw) == 0.0
    assert abs(float(dev.yaw) - float(ref.yaw)) <= 1e-6

"""Pose-graph optimization: Gauss-Newton with preconditioned CG (port of
`xchu_slam_tpu.models.pose_graph`, single device).

Node 0 is gauge-fixed; sequential odometry between factors carry diagonal
information, loop factors a Cauchy-robust (IRLS) weight scaled by ICP
fitness, GPS factors constrain altitude only. Each GN iteration
materializes the per-factor 6×6 Jacobian blocks once and assembles the
gradient, the Hessian-vector product and the preconditioner from them. The
default preconditioner (`precond="tridiag"`) solves the chain part of the
Hessian exactly: a block-LDLᵀ (Thomas) factorization plus two affine prefix
scans for the substitutions. `precond="jacobi"` is the reference's
block-Jacobi one: a Cholesky factor of each 6×6 diagonal block.

Two routes, picked by where the tensors live (as `ndt.align` picks its
own). On the card (`solve`) each Gauss-Newton iteration's system is
assembled in PyTorch, a fixed number of launches, and solved by one launch
of `csrc/pgo_kernel.cu` (`ops/cuda/pgo_kernel.py`): the factor recursion,
both substitutions and the PCG loop with its stop test, in one block, with
no host synchronisation; the iteration is captured once as a CUDA graph and
replayed. On the CPU `solve_ref`, the plain version, does the
same arithmetic paced from the host: the Thomas recursion is a Python loop
over the live prefix of the chain (dead keyframes have zero coupling, so
their blocks factor as one batch; one readback finds the prefix), the
prefix scans are Hillis-Steele doubling scans (log₂K batched steps) where
the reference uses `associative_scan`, and the CG loop reads its stopping
test back once per iteration. Neither changes the result beyond float
rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from xchu_slam_tpu_torch.ops.cuda import pgo_kernel
from xchu_slam_tpu_torch.utils import collectives, se3
from xchu_slam_tpu_torch.utils.scatter import index_add


class GraphSpec(NamedTuple):
    max_keyframes: int = 2048
    max_loops: int = 256
    odom_info_t: float = 1e6     # 1/variance
    odom_info_r: float = 1e4     # 1/variance
    cauchy_k: float = 1.0
    gn_iterations: int = 8
    cg_iterations: int = 100
    cg_tol: float = 1e-6         # relative PCG stop on the preconditioned norm
    gps_info_z: float = 1.0 / 250.0
    inloop_gn_iterations: int = 2
    solve_every: int = 1
    precond: str = "tridiag"


def spec_from_config(pgo_cfg) -> GraphSpec:
    """The config's spec; an unknown preconditioner is refused here."""
    spec = GraphSpec(
        max_keyframes=pgo_cfg.max_keyframes,
        max_loops=pgo_cfg.max_loops,
        odom_info_t=1.0 / pgo_cfg.odom_noise_trans,
        odom_info_r=1.0 / pgo_cfg.odom_noise_rot,
        cauchy_k=pgo_cfg.cauchy_k,
        gn_iterations=pgo_cfg.gn_iterations,
        cg_iterations=pgo_cfg.cg_iterations,
        cg_tol=pgo_cfg.cg_tol,
        inloop_gn_iterations=pgo_cfg.inloop_gn_iterations,
        solve_every=pgo_cfg.solve_every,
        precond=pgo_cfg.precond,
        gps_info_z=1.0 / pgo_cfg.gps_noise_alt,
    )
    _check_spec(spec)
    return spec


class GraphData(NamedTuple):
    """Fixed-capacity factor storage (tensors on one device)."""

    between_T: torch.Tensor   # [K,4,4]: Z_{k-1,k}; valid for 1 ≤ k < count
    kf_mask: torch.Tensor     # [K] bool: live keyframes
    loop_i: torch.Tensor      # [L] int64
    loop_j: torch.Tensor      # [L] int64
    loop_T: torch.Tensor      # [L,4,4]: Z_ij (pose of j in i's frame)
    loop_info: torch.Tensor   # [L]: scalar information (≈ 1/fitness)
    loop_mask: torch.Tensor   # [L] bool
    gps_alt: torch.Tensor     # [K]: measured altitude
    gps_mask: torch.Tensor    # [K] bool


def inloop_spec(spec: GraphSpec) -> GraphSpec:
    """Spec for per-accepted-loop solves (warm-started, so fewer GN
    iterations); finalize uses the full spec."""
    if spec.inloop_gn_iterations and \
            spec.inloop_gn_iterations < spec.gn_iterations:
        return spec._replace(gn_iterations=spec.inloop_gn_iterations)
    return spec


def empty_graph(spec: GraphSpec, device="cpu") -> GraphData:
    K, L = spec.max_keyframes, spec.max_loops
    eye4 = torch.eye(4, dtype=torch.float32, device=device)
    return GraphData(
        between_T=eye4.repeat(K, 1, 1),
        kf_mask=torch.zeros(K, dtype=torch.bool, device=device),
        loop_i=torch.zeros(L, dtype=torch.int64, device=device),
        loop_j=torch.zeros(L, dtype=torch.int64, device=device),
        loop_T=eye4.repeat(L, 1, 1),
        loop_info=torch.zeros(L, dtype=torch.float32, device=device),
        loop_mask=torch.zeros(L, dtype=torch.bool, device=device),
        gps_alt=torch.zeros(K, dtype=torch.float32, device=device),
        gps_mask=torch.zeros(K, dtype=torch.bool, device=device),
    )


def _between_residual(Ti, Tj, Z):
    """log(Z⁻¹ · Ti⁻¹ · Tj) ∈ R⁶ (batched over leading dims)."""
    pred = torch.matmul(se3.inverse(Ti), Tj)
    return se3.se3_log(torch.matmul(se3.inverse(Z), pred))


def _cauchy_weights(r_loop_whitened, k: float):
    """IRLS weights for the Cauchy robust kernel on loop factors."""
    s = torch.sum(r_loop_whitened ** 2, dim=-1)
    return 1.0 / (1.0 + s / (k * k))


def _damp(S):
    # damping tracks the block's own scale (the anchored chain's Schur
    # complements decay like 1/k; a fixed eps compounds into O(1) error)
    tr = torch.diagonal(S, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(6, dtype=S.dtype, device=S.device)
    return S + (1e-6 * tr / 6.0 + 1e-12)[..., None, None] * eye


def _chol(S):
    # cholesky_ex: no host sync for an error check (the damping keeps the
    # blocks PD)
    return torch.linalg.cholesky_ex(S).L


def live_prefix(U, kf_mask):
    """(n_seq, n_act) as 0-d int64 tensors on U's device, with no readback:
    n_seq is one past the last keyframe with a non-zero chain coupling U[k]
    (k ≥ 1), 1 if none; n_act the larger of n_seq and one past the last
    live keyframe. The factor recursion runs over [0, n_seq); past n_act
    every vector of the solve is 0. `csrc/pgo_kernel.cu` finds the same two
    on the card."""
    K = U.shape[0]
    idx = torch.arange(K, device=U.device)
    coupled = (U != 0).flatten(1).any(1) & (idx >= 1)
    n_seq = torch.max(torch.where(coupled, idx, 0)) + 1
    n_act = torch.maximum(n_seq, torch.max(torch.where(kf_mask, idx, 0)) + 1)
    return n_seq, n_act


def block_tridiag_factor(D, U):
    """Block-LDLᵀ factorization of the symmetric block-tridiagonal matrix
    with diagonal blocks D [K,6,6] and couplings U [K,6,6] (U[k] couples
    k-1 and k; U[0] is ignored), after a symmetric Jacobi scaling by
    d = √diag D. Returns (d [K,6], chols [K,6,6], A [K,6,6]) over the scaled
    system: S_k = D'_k − U'_kᵀ S_{k-1}⁻¹ U'_k, chols[k] = chol(S_k),
    A[k] = S_{k-1}⁻¹ U'_k (A[0] = 0).

    The recursion runs in order up to the last nonzero coupling (one
    readback finds it); past it every A is 0 and S_k = D'_k, so those blocks
    factor as one batch."""
    K = D.shape[0]
    d = torch.sqrt(torch.abs(torch.diagonal(D, dim1=-2, dim2=-1)) + 1e-12)
    Dn = D / (d[:, :, None] * d[:, None, :])
    dprev = torch.cat([d[:1], d[:-1]], 0)
    Un = U / (dprev[:, :, None] * d[:, None, :])

    n_seq = int(live_prefix(U, torch.zeros(K, dtype=torch.bool, device=U.device))[0])
    chols = torch.empty_like(D)
    A = torch.zeros_like(D)
    chols[0] = _chol(_damp(Dn[0]))
    for k in range(1, n_seq):
        Ak = torch.cholesky_solve(Un[k], chols[k - 1])
        Sk = Dn[k] - Un[k].T @ Ak
        chols[k] = _chol(_damp(0.5 * (Sk + Sk.T)))
        A[k] = Ak
    if n_seq < K:
        Dk = Dn[n_seq:]
        chols[n_seq:] = _chol(_damp(0.5 * (Dk + Dk.transpose(1, 2))))
    return d, chols, A


def _affine_scan(M, c):
    """Inclusive scan of affine maps x ↦ M_k x + c_k (M [K,6,6], c [K,6],
    M[0] = 0): returns y with y_k = M_k y_{k-1} + c_k, y_0 = c_0, in log₂K
    doubling steps."""
    K = c.shape[0]
    off = 1
    while off < K:
        Mk, ck = M[off:], c[off:]
        c = torch.cat([c[:off], torch.einsum("kab,kb->ka", Mk, c[:-off]) + ck])
        M = torch.cat([M[:off], Mk @ M[:-off]])
        off *= 2
    return c


def block_tridiag_solve(d, chols, A, r):
    """Solve M z = r given `block_tridiag_factor`'s output:
      forward   y_k = r_k − A_kᵀ y_{k-1}
      backward  z_k = S_k⁻¹ y_k − A_{k+1} z_{k+1}
    as affine prefix scans; with C = diag(d), z = C⁻¹ solve'(C⁻¹ r)."""
    r = r / d
    Mf = -A.transpose(1, 2)
    Mf[0] = 0.0
    y = _affine_scan(Mf, r)
    b = torch.cholesky_solve(y[..., None], chols)[..., 0]
    Mb = -torch.cat([A[1:], torch.zeros_like(A[:1])], 0)
    z = _affine_scan(Mb.flip(0), b.flip(0)).flip(0)
    return z / d


def _edge_jacobians(Ts, ki, kj, Z):
    """Per-factor 6×6 Jacobians of `_between_residual` w.r.t. the tangent
    updates of nodes i and j at xi = 0 (forward mode, batched)."""

    def blk(Ti, Tj, Zf):
        z6 = torch.zeros(6, dtype=Ti.dtype, device=Ti.device)
        J_i = jacfwd(lambda x: _between_residual(Ti @ se3.se3_exp(x), Tj, Zf))(z6)
        J_j = jacfwd(lambda x: _between_residual(Ti, Tj @ se3.se3_exp(x), Zf))(z6)
        return J_i, J_j

    return vmap(blk)(Ts[ki], Ts[kj], Z)


def _bmv(J, v):   # [F,6,6]·[F,6]
    return torch.einsum("fab,fb->fa", J, v)


def _bmtv(J, v):  # [F,6,6]ᵀ·[F,6]
    return torch.einsum("fab,fa->fb", J, v)


def _jtwj(Ja, W, Jb):  # Jaᵀ·diag(W)·Jb per factor, W [F,6]
    return torch.einsum("fba,fbc->fac", Ja, W[..., None] * Jb)


class _System(NamedTuple):
    """One Gauss-Newton iteration's linear system, assembled from the
    per-factor 6×6 Jacobian blocks: what the PCG (plain loop or kernel)
    needs."""

    g: torch.Tensor        # [K,6] gradient JᵀW r, node 0 zeroed
    blocks: torch.Tensor   # [K,6,6] diagonal blocks, node 0 = I, + 1e-6·I
    U: torch.Tensor        # [K,6,6] chain couplings (U[0] = U[1] = 0)
    Ji: torch.Tensor       # [K,6,6] chain Jacobians w.r.t. node ke-1
    Jj: torch.Tensor       # [K,6,6] chain Jacobians w.r.t. node ke
    Jli: torch.Tensor      # [L,6,6]
    Jlj: torch.Tensor      # [L,6,6]
    wl: torch.Tensor       # [L] robust loop weights
    A: torch.Tensor        # [K,3] GPS altitude rows
    odom_info: torch.Tensor
    wp: torch.Tensor       # [K] chain factor weights
    gz: torch.Tensor       # [K] altitude information


def _to_rows(x, rows: slice, K: int):
    """x [E,...] for rows `rows` of a [K,...] array, as the [K,...] array
    that is 0 elsewhere (x itself when the rows are all K)."""
    if rows.stop - rows.start == K:
        return x
    out = x.new_zeros((K, *x.shape[1:]))
    out[rows] = x
    return out


def _gn_partial(Ts, graph: GraphData, spec: GraphSpec, rows: slice, loops: slice) -> _System:
    """The part of a Gauss-Newton system that the factors of between / GPS
    rows `rows` and loop slots `loops` give: (g, blocks, U) summed over
    those factors alone (node 0, the damping and U[1] not yet set), and the
    factors' own blocks. Between row k is the edge (k−1, k) for k =
    clip(k, 1, K−1), and row 0's duplicate of edge (0, 1) has pair weight 0,
    so every factor counts once over any split of the rows
    (`xchu_slam_tpu/models/pose_graph.py::sharded_gn_solve`)."""
    K = Ts.shape[0]
    dev = Ts.device
    odom_info = torch.cat([torch.full((3,), spec.odom_info_t, device=dev),
                           torch.full((3,), spec.odom_info_r, device=dev)])
    kf = graph.kf_mask
    pairmask = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                          kf[:-1] & kf[1:]])[rows]
    ke = torch.clamp(torch.arange(rows.start, rows.stop, device=dev), 1, K - 1)
    kg = torch.arange(rows.start, rows.stop, device=dev)
    li, lj, lT = graph.loop_i[loops], graph.loop_j[loops], graph.loop_T[loops]
    gz = torch.where(graph.gps_mask[rows] & kf[rows], spec.gps_info_z, 0.0)   # [E]
    wp = pairmask.to(torch.float32)                                            # [E]

    def gps6(x3):
        return torch.cat([x3, torch.zeros_like(x3)], -1)

    r_o = _between_residual(Ts[ke - 1], Ts[ke], graph.between_T[rows])
    r_l = _between_residual(Ts[li], Ts[lj], lT)
    loop_mask, loop_info = graph.loop_mask[loops], graph.loop_info[loops]
    w_lin = torch.where(loop_mask, torch.clamp(loop_info, min=0.0), 0.0)
    wl = w_lin * _cauchy_weights(r_l * torch.sqrt(w_lin)[:, None], spec.cauchy_k)

    Ji, Jj = _edge_jacobians(Ts, ke - 1, ke, graph.between_T[rows])
    Jli, Jlj = _edge_jacobians(Ts, li, lj, lT)
    A = Ts[kg, 2, :3]         # GPS altitude row: dz/dρ = R[2,:]
    r_g = Ts[kg, 2, 3] - graph.gps_alt[rows]

    # gradient g = JᵀW r
    wro = r_o * odom_info[None, :] * wp[:, None]
    wrl = r_l * wl[:, None]
    g = torch.zeros((K, 6), device=dev)
    index_add(g, ke - 1, _bmtv(Ji, wro))
    index_add(g, ke, _bmtv(Jj, wro))
    index_add(g, li, _bmtv(Jli, wrl))
    index_add(g, lj, _bmtv(Jlj, wrl))
    g = g + _to_rows(gps6((gz * r_g)[:, None] * A), rows, K)

    # 6×6 diagonal blocks and chain couplings from the same Jacobians
    Wo = odom_info.expand(ke.shape[0], 6)
    blocks = torch.zeros((K, 6, 6), device=dev)
    index_add(blocks, ke - 1, _jtwj(Ji, Wo, Ji) * wp[:, None, None])
    index_add(blocks, ke, _jtwj(Jj, Wo, Jj) * wp[:, None, None])
    index_add(blocks, li, Jli.transpose(1, 2) @ Jli * wl[:, None, None])
    index_add(blocks, lj, Jlj.transpose(1, 2) @ Jlj * wl[:, None, None])
    blocks = blocks + _to_rows(gz[:, None, None] * torch.nn.functional.pad(
        A[:, :, None] * A[:, None, :], (0, 3, 0, 3)), rows, K)
    # chain-exact preconditioner M = H_chain + diag(loop/GPS/damping)
    U = torch.zeros((K, 6, 6), device=dev)
    index_add(U, ke, _jtwj(Ji, Wo, Jj) * wp[:, None, None])
    return _System(g, blocks, U, Ji, Jj, Jli, Jlj, wl, A, odom_info, wp, gz)


def _gn_finish(s: _System) -> _System:
    """The whole system from the factors' summed (g, blocks, U): node 0
    zeroed in g and set to I in blocks, the 1e-6·I damping, U[1] = 0 (which
    keeps the gauge-fixed node 0 isolated)."""
    g, blocks, U = s.g, s.blocks, s.U
    K = g.shape[0]
    mask0 = torch.ones((K, 1), device=g.device)
    mask0[0].fill_(0.0)
    eye6 = torch.eye(6, device=g.device)
    g = g * mask0
    blocks[0] = eye6
    blocks = blocks + 1e-6 * eye6
    U[1].fill_(0.0)
    return s._replace(g=g, blocks=blocks, U=U)


def _gn_system(Ts, graph: GraphData, spec: GraphSpec) -> _System:
    K, L = Ts.shape[0], graph.loop_i.shape[0]
    return _gn_finish(_gn_partial(Ts, graph, spec, slice(0, K), slice(0, L)))


def _hvp(sys_: _System, graph: GraphData, v):
    """H v from the system's factor blocks (node 0 masked)."""
    K = v.shape[0]
    ke = torch.clamp(torch.arange(K, device=v.device), 1, K - 1)
    li, lj = graph.loop_i, graph.loop_j
    mask0 = torch.ones((K, 1), device=v.device)
    mask0[0].fill_(0.0)
    Ji, Jj, Jli, Jlj, A = sys_.Ji, sys_.Jj, sys_.Jli, sys_.Jlj, sys_.A
    v = v * mask0
    wjv = (_bmv(Ji, v[ke - 1]) + _bmv(Jj, v[ke])) * sys_.odom_info[None, :] \
        * sys_.wp[:, None]
    wjvl = (_bmv(Jli, v[li]) + _bmv(Jlj, v[lj])) * sys_.wl[:, None]
    y = torch.zeros((K, 6), device=v.device)
    index_add(y, ke - 1, _bmtv(Ji, wjv))
    index_add(y, ke, _bmtv(Jj, wjv))
    index_add(y, li, _bmtv(Jli, wjvl))
    index_add(y, lj, _bmtv(Jlj, wjvl))
    s = torch.sum(A * v[:, :3], -1)
    y = y + torch.cat([(sys_.gz * s)[:, None] * A, torch.zeros_like(A)], -1)
    return y * mask0


def _pcg_ref(sys_: _System, graph: GraphData, spec: GraphSpec) -> torch.Tensor:
    """The plain PCG with a relative stop on the preconditioned norm; its
    stop test is read back once per iteration."""
    if spec.precond == "jacobi":
        # the reference's block-Jacobi preconditioner: each diagonal block
        # (node 0 = I, + 1e-6·I) factored on its own
        chol = _chol(sys_.blocks)

        def precond(v):
            return torch.cholesky_solve(v[..., None], chol)[..., 0]
    else:
        dsc, chols, Af = block_tridiag_factor(sys_.blocks, sys_.U)

        def precond(v):
            return block_tridiag_solve(dsc, chols, Af, v)

    b = -sys_.g
    x = torch.zeros_like(b)
    r, z = b, precond(b)
    p, rz = z, torch.sum(b * z)
    rz0 = rz
    for _ in range(spec.cg_iterations):
        if not bool(rz > spec.cg_tol * rz0):
            break
        Hp = _hvp(sys_, graph, p)
        alpha = rz / torch.clamp(torch.sum(p * Hp), min=1e-20)
        x = x + alpha * p
        r = r - alpha * Hp
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp(rz, min=1e-20)
        p, rz = z + beta * p, rz_new
    return x


def _check_spec(spec: GraphSpec):
    """Both routes run the preconditioners the kernel has an instantiation
    for."""
    pgo_kernel.precond_code(spec.precond)


def solve_ref(poses6: torch.Tensor, graph: GraphData, spec: GraphSpec,
              run: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of `solve`: the factor recursion, the substitutions
    and the CG loop paced from the host. `run` (a bool tensor) false returns
    the input poses, as the kernel route does; it is read here."""
    _check_spec(spec)
    if run is not None and not bool(run):
        return poses6
    K = poses6.shape[0]
    mask0 = torch.ones((K, 1), device=poses6.device)
    mask0[0].fill_(0.0)
    Ts = se3.pose_to_matrix(poses6)
    for _ in range(spec.gn_iterations):
        x = _pcg_ref(_gn_system(Ts, graph, spec), graph, spec)
        Ts = torch.matmul(Ts, se3.se3_exp(x * mask0))
    return torch.where(graph.kf_mask[:, None], se3.matrix_to_pose(Ts), poses6)


def _gn_step_cuda(Ts, graph: GraphData, spec: GraphSpec, run) -> torch.Tensor:
    """One Gauss-Newton iteration on the card: the system assembled in
    PyTorch, solved by one launch of the PGO kernel."""
    K = Ts.shape[0]
    mask0 = torch.ones((K, 1), device=Ts.device)
    mask0[0].fill_(0.0)
    s = _gn_system(Ts, graph, spec)
    x, _iters = pgo_kernel.cg(
        s.blocks.contiguous(), s.U.contiguous(), s.g.contiguous(), s.Ji.contiguous(),
        s.Jj.contiguous(), s.odom_info, s.wp, s.Jli.contiguous(), s.Jlj.contiguous(),
        graph.loop_i, graph.loop_j, s.wl.contiguous(), s.A.contiguous(),
        s.gz.contiguous(), graph.kf_mask, run, spec.cg_tol, spec.cg_iterations,
        precond=spec.precond)
    return torch.matmul(Ts, se3.se3_exp(x * mask0))


class _GnGraph:
    """One Gauss-Newton iteration on the card, captured once per store shape
    and spec (its Gauss-Newton count aside) as a CUDA graph over static
    buffers: the transforms, `run` and a copy of the factor store. The
    assembly is some 1,500 small launches an iteration, which the host would
    otherwise enqueue one by one; a replay is one."""

    def __init__(self, graph: GraphData, spec: GraphSpec, dev: torch.device):
        K = graph.kf_mask.shape[0]
        self.graph = GraphData(*(torch.zeros_like(t) for t in graph))
        self.Ts = torch.eye(4, device=dev).repeat(K, 1, 1)
        self.run = torch.zeros((), dtype=torch.bool, device=dev)
        counts = pgo_kernel.launches
        _gn_step_cuda(self.Ts, self.graph, spec, self.run)   # warm-up, run false
        warm = pgo_kernel.launches
        self.cuda_graph = torch.cuda.CUDAGraph()
        # entering a capture synchronises the device, once per shape and spec
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        try:
            with torch.cuda.graph(self.cuda_graph, capture_error_mode="thread_local"):
                self.out = _gn_step_cuda(self.Ts, self.graph, spec, self.run)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        # a capture records launches, it makes none: each replay makes them
        self.launches = pgo_kernel.launches - warm
        pgo_kernel.launches = counts

    def load(self, poses6, graph: GraphData, run) -> None:
        """Copy a solve's inputs into the static buffers."""
        for dst, src in zip(self.graph, graph):
            dst.copy_(src)
        self.run.copy_(run)
        self.Ts.copy_(se3.pose_to_matrix(poses6))

    def iterate(self, gn_iterations: int) -> None:
        """Replay `gn_iterations` Gauss-Newton iterations from the loaded
        transforms, each replay's result copied back into them."""
        for _ in range(gn_iterations):
            self.cuda_graph.replay()
            pgo_kernel.launches += self.launches
            self.Ts.copy_(self.out)

    def result(self, poses6, graph: GraphData, run) -> torch.Tensor:
        return torch.where((graph.kf_mask & run)[:, None], se3.matrix_to_pose(self.Ts),
                           poses6)

    def solve(self, poses6, graph: GraphData, gn_iterations: int, run) -> torch.Tensor:
        self.load(poses6, graph, run)
        self.iterate(gn_iterations)
        return self.result(poses6, graph, run)


_gn_graphs: dict = {}


def gn_graph(graph: GraphData, spec: GraphSpec, dev: torch.device) -> _GnGraph:
    """The Gauss-Newton iteration's graph of the store's shapes and `spec`
    on `dev`, captured at its first use."""
    key = (tuple(t.shape for t in graph), spec._replace(gn_iterations=0), str(dev))
    g = _gn_graphs.get(key)
    if g is None:
        g = _gn_graphs[key] = _GnGraph(graph, spec, dev)
    return g


def sharded_gn_solve(poses6: torch.Tensor, graph: GraphData, spec: GraphSpec,
                     mesh) -> torch.Tensor:
    """The Gauss-Newton solve with the factors sharded over `mesh` (poses
    and factor store replicated): rank r assembles the system of between /
    GPS rows [r·K/D, (r+1)·K/D) and loop slots [r·L/D, (r+1)·L/D)
    (`_gn_partial`). Each Gauss-Newton iteration is one collective pair:
    (g, blocks, U) summed by one packed `shard_allsum`, and the factors' own
    blocks, which the Hessian-vector product reads (the chain's Ji, Jj, wp,
    the loops' Jli, Jlj, wl, GPS's A, gz: each factor on one rank), gathered
    and concatenated by one `shard_allgather`. Every rank then solves the
    same whole system: `_pcg_ref` on the CPU, one launch of the unchanged
    PGO kernel on the card. (The reference reduces the Hessian-vector
    product once per CG iteration instead: the same mathematics summed in
    another order.) Returns the optimized [K,6], keyframes outside kf_mask
    at their input poses."""
    _check_spec(spec)
    K, L = poses6.shape[0], graph.loop_i.shape[0]
    rows = mesh.shard(K, "keyframe slots (max_keyframes)")
    loops = mesh.shard(L, "loop slots (max_loops)")
    dev = poses6.device
    mask0 = torch.ones((K, 1), device=dev)
    mask0[0].fill_(0.0)
    run = torch.ones((), dtype=torch.bool, device=dev)
    Ts = se3.pose_to_matrix(poses6)
    for _ in range(spec.gn_iterations):
        part = _gn_partial(Ts, graph, spec, rows, loops)
        g, blocks, U = collectives.shard_allsum((part.g, part.blocks, part.U), mesh)
        Ji, Jj, wp, Jli, Jlj, wl, A, gz = collectives.shard_allgather(
            (part.Ji, part.Jj, part.wp, part.Jli, part.Jlj, part.wl, part.A, part.gz), mesh)
        s = _gn_finish(_System(g, blocks, U, Ji, Jj, Jli, Jlj, wl, A, part.odom_info, wp, gz))
        if dev.type == "cpu":
            x = _pcg_ref(s, graph, spec)
        else:
            x, _iters = pgo_kernel.cg(
                s.blocks.contiguous(), s.U.contiguous(), s.g.contiguous(),
                s.Ji.contiguous(), s.Jj.contiguous(), s.odom_info, s.wp.contiguous(),
                s.Jli.contiguous(), s.Jlj.contiguous(), graph.loop_i, graph.loop_j,
                s.wl.contiguous(), s.A.contiguous(), s.gz.contiguous(), graph.kf_mask, run,
                spec.cg_tol, spec.cg_iterations, precond=spec.precond)
        Ts = torch.matmul(Ts, se3.se3_exp(x * mask0))
    return torch.where(graph.kf_mask[:, None], se3.matrix_to_pose(Ts), poses6)


def solve(poses6: torch.Tensor, graph: GraphData, spec: GraphSpec,
          run: torch.Tensor | None = None, mesh=None) -> torch.Tensor:
    """Optimize all keyframe poses. poses6 [K,6] → optimized [K,6];
    keyframes outside kf_mask keep their input poses, and so do all when
    `run` (a 0-d bool tensor on the poses' device) is false.

    CPU tensors take `solve_ref`. CUDA tensors replay one Gauss-Newton
    iteration's CUDA graph (`_GnGraph`, captured at the first solve of a
    store shape and spec) `gn_iterations` times: the system assembled in
    PyTorch, a fixed number of launches, and solved by one launch of
    `csrc/pgo_kernel.cu` (the spec's preconditioner's factor and the PCG,
    the stop test on the card). No host synchronisation. With a `mesh`
    (`parallel/distributed.py`) the factors are sharded over its ranks
    (`sharded_gn_solve`; `run` is read back) and every rank returns the same
    poses."""
    if mesh is not None:
        if run is not None and not bool(run):
            return poses6
        return sharded_gn_solve(poses6, graph, spec, mesh)
    if poses6.device.type == "cpu":
        return solve_ref(poses6, graph, spec, run)
    _check_spec(spec)
    dev = poses6.device
    if run is None:
        run = torch.ones((), dtype=torch.bool, device=dev)
    return gn_graph(graph, spec, dev).solve(poses6, graph, spec.gn_iterations, run)

"""Pose-graph optimization: Gauss-Newton with preconditioned CG (port of
`xchu_slam_tpu.models.pose_graph`, single device).

Node 0 is gauge-fixed; sequential odometry between factors carry diagonal
information, loop factors a Cauchy-robust (IRLS) weight scaled by ICP
fitness, GPS factors constrain altitude only. Each GN iteration
materializes the per-factor 6×6 Jacobian blocks once and assembles the
gradient, the Hessian-vector product and the preconditioner from them. The
preconditioner solves the chain part of the Hessian exactly: a block-LDLᵀ
(Thomas) factorization plus two affine prefix scans for the substitutions.

Differences from the reference, none of which changes the result beyond
float rounding: the Thomas recursion is a Python loop over the live prefix
of the chain (dead keyframes have zero coupling, so their blocks factor as
one batch); the prefix scans are Hillis-Steele doubling scans (log₂K
batched steps) where the reference uses `associative_scan`; the CG loop
reads its stopping test back once per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from xchu_slam_tpu_torch.utils import se3
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
    return GraphSpec(
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

    coupled = (U[1:] != 0).flatten(1).any(1).nonzero()
    n_seq = int(coupled.max()) + 2 if coupled.numel() else 1
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


def solve(poses6: torch.Tensor, graph: GraphData, spec: GraphSpec) -> torch.Tensor:
    """Optimize all keyframe poses. poses6 [K,6] → optimized [K,6];
    keyframes outside kf_mask keep their input poses."""
    if spec.precond != "tridiag":
        raise ValueError(f"precond {spec.precond!r} is not ported")
    K = poses6.shape[0]
    dev = poses6.device
    odom_info = torch.cat([torch.full((3,), spec.odom_info_t, device=dev),
                           torch.full((3,), spec.odom_info_r, device=dev)])
    kf = graph.kf_mask
    pairmask = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                          kf[:-1] & kf[1:]])
    ke = torch.clamp(torch.arange(K, device=dev), 1, K - 1)
    li, lj, lT = graph.loop_i, graph.loop_j, graph.loop_T
    gz = torch.where(graph.gps_mask & kf, spec.gps_info_z, 0.0)      # [K]
    wp = pairmask.to(torch.float32)                                   # [K]
    mask0 = torch.ones((K, 1), device=dev)
    mask0[0] = 0.0
    eye6 = torch.eye(6, device=dev)

    def gps6(x3):
        return torch.cat([x3, torch.zeros_like(x3)], -1)

    def gn_iter(Ts):
        r_o = _between_residual(Ts[ke - 1], Ts[ke], graph.between_T)
        r_l = _between_residual(Ts[li], Ts[lj], lT)
        w_lin = torch.where(graph.loop_mask, torch.clamp(graph.loop_info, min=0.0), 0.0)
        wl = w_lin * _cauchy_weights(r_l * torch.sqrt(w_lin)[:, None], spec.cauchy_k)

        Ji, Jj = _edge_jacobians(Ts, ke - 1, ke, graph.between_T)
        Jli, Jlj = _edge_jacobians(Ts, li, lj, lT)
        A = Ts[:, 2, :3]          # GPS altitude row: dz/dρ = R[2,:]
        r_g = Ts[:, 2, 3] - graph.gps_alt

        # gradient g = JᵀW r
        wro = r_o * odom_info[None, :] * wp[:, None]
        wrl = r_l * wl[:, None]
        g = torch.zeros((K, 6), device=dev)
        index_add(g, ke - 1, _bmtv(Ji, wro))
        index_add(g, ke, _bmtv(Jj, wro))
        index_add(g, li, _bmtv(Jli, wrl))
        index_add(g, lj, _bmtv(Jlj, wrl))
        g = g + gps6((gz * r_g)[:, None] * A)

        def hvp(v):
            v = v * mask0
            wjv = (_bmv(Ji, v[ke - 1]) + _bmv(Jj, v[ke])) * odom_info[None, :] * wp[:, None]
            wjvl = (_bmv(Jli, v[li]) + _bmv(Jlj, v[lj])) * wl[:, None]
            y = torch.zeros((K, 6), device=dev)
            index_add(y, ke - 1, _bmtv(Ji, wjv))
            index_add(y, ke, _bmtv(Jj, wjv))
            index_add(y, li, _bmtv(Jli, wjvl))
            index_add(y, lj, _bmtv(Jlj, wjvl))
            s = torch.sum(A * v[:, :3], -1)
            y = y + gps6((gz * s)[:, None] * A)
            return y * mask0

        # 6×6 diagonal blocks and chain couplings from the same Jacobians
        Wo = odom_info.expand(K, 6)
        blocks = torch.zeros((K, 6, 6), device=dev)
        index_add(blocks, ke - 1, _jtwj(Ji, Wo, Ji) * wp[:, None, None])
        index_add(blocks, ke, _jtwj(Jj, Wo, Jj) * wp[:, None, None])
        index_add(blocks, li, Jli.transpose(1, 2) @ Jli * wl[:, None, None])
        index_add(blocks, lj, Jlj.transpose(1, 2) @ Jlj * wl[:, None, None])
        blocks = blocks + gz[:, None, None] * torch.nn.functional.pad(
            A[:, :, None] * A[:, None, :], (0, 3, 0, 3))
        # chain-exact preconditioner M = H_chain + diag(loop/GPS/damping);
        # U[1] = 0 keeps the gauge-fixed node 0 isolated
        U = torch.zeros((K, 6, 6), device=dev)
        index_add(U, ke, _jtwj(Ji, Wo, Jj) * wp[:, None, None])
        g = g * mask0
        blocks[0] = eye6
        blocks = blocks + 1e-6 * eye6
        U[1] = 0.0
        dsc, chols, Af = block_tridiag_factor(blocks, U)

        def precond(v):
            return block_tridiag_solve(dsc, chols, Af, v)

        # PCG with a relative stop on the preconditioned norm
        b = -g
        x = torch.zeros_like(b)
        r, z = b, precond(b)
        p, rz = z, torch.sum(b * z)
        rz0 = rz
        for _ in range(spec.cg_iterations):
            if not bool(rz > spec.cg_tol * rz0):
                break
            Hp = hvp(p)
            alpha = rz / torch.clamp(torch.sum(p * Hp), min=1e-20)
            x = x + alpha * p
            r = r - alpha * Hp
            z = precond(r)
            rz_new = torch.sum(r * z)
            beta = rz_new / torch.clamp(rz, min=1e-20)
            p, rz = z + beta * p, rz_new
        return torch.matmul(Ts, se3.se3_exp(x * mask0))

    Ts = se3.pose_to_matrix(poses6)
    for _ in range(spec.gn_iterations):
        Ts = gn_iter(Ts)
    return torch.where(kf[:, None], se3.matrix_to_pose(Ts), poses6)

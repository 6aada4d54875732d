"""The NDT align of the reference: a frozen copy of the port's plain
version (`ops/ndt_deriv.py`'s fused score / gradient / Hessian pass and
`ops/ndt.py::align_ref`, Newton with the backtracking line search, the
6-vector arithmetic on host float32), for the one mode the cells run
(backtrack, regather_dist 0)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from slambench.reference import linalg, se3, voxel as vm


class NdtSpec(NamedTuple):
    step_size: float
    trans_eps: float
    max_iterations: int
    outlier_ratio: float
    resolution: float
    ls_max_trials: int
    neighbor_mode: str
    ls_mode: str
    regather_dist: float


def spec_from_config(cfg: dict) -> NdtSpec:
    return NdtSpec(step_size=cfg["ndt.step_size"], trans_eps=cfg["ndt.trans_eps"],
                   max_iterations=cfg["ndt.max_iterations"],
                   outlier_ratio=cfg["ndt.outlier_ratio"], resolution=cfg["ndt.resolution"],
                   ls_max_trials=cfg["ndt.line_search_max_trials"],
                   neighbor_mode=cfg["ndt.neighbor_mode"], ls_mode=cfg["ndt.ls_mode"],
                   regather_dist=cfg["ndt.regather_dist"])

def _mat3(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r) for r in rows])


def _rot_and_derivs(rpy: torch.Tensor):
    """R, dR/dθ [3,3,3] (k=r,p,y), d²R/dθdθ [6,3,3] (rr,rp,ry,pp,py,yy)."""
    r, p, y = rpy[0], rpy[1], rpy[2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    o, z = torch.ones_like(r), torch.zeros_like(r)
    Rx = _mat3([[o, z, z], [z, cr, -sr], [z, sr, cr]])
    Ry = _mat3([[cp, z, sp], [z, o, z], [-sp, z, cp]])
    Rz = _mat3([[cy, -sy, z], [sy, cy, z], [z, z, o]])
    dRx = _mat3([[z, z, z], [z, -sr, -cr], [z, cr, -sr]])
    dRy = _mat3([[-sp, z, cp], [z, z, z], [-cp, z, -sp]])
    dRz = _mat3([[-sy, -cy, z], [cy, -sy, z], [z, z, z]])
    d2Rx = _mat3([[z, z, z], [z, -cr, sr], [z, -sr, -cr]])
    d2Ry = _mat3([[-cp, z, -sp], [z, z, z], [sp, z, -cp]])
    d2Rz = _mat3([[-cy, sy, z], [-sy, -cy, z], [z, z, z]])

    R = Rz @ Ry @ Rx
    dR = torch.stack([Rz @ Ry @ dRx, Rz @ dRy @ Rx, dRz @ Ry @ Rx])
    d2R = torch.stack([
        Rz @ Ry @ d2Rx,   # rr
        Rz @ dRy @ dRx,   # rp
        dRz @ Ry @ dRx,   # ry
        Rz @ d2Ry @ Rx,   # pp
        dRz @ dRy @ Rx,   # py
        d2Rz @ Ry @ Rx,   # yy
    ])
    return R, dR, d2R


def neighborhood(pose, src_xyz, grid, gspec: vm.GridSpec, mode: str = "direct7"):
    """The `mode` neighbourhood of the transformed source (mean_w, icov6,
    valid); gathered once per Newton iteration and reused by that
    iteration's line-search trials (KDTREE's distance mask included)."""
    pts = se3.rotate_translate(pose, src_xyz)
    return vm.lookup_neighbors(grid, gspec, pts, mode)


def ndt_value_grad_hess(pose, src_xyz, src_mask, grid, gspec: vm.GridSpec,
                        d1: float, d2: float, want_hess: bool = True,
                        nb=None, mode: str = "direct7"):
    """(L, g [6], H [6,6]) in one pass over point×voxel pairs.

    With want_hess=False, H is returned as zeros. With `nb`, a precomputed
    `neighborhood(...)` is reused instead of re-gathering."""
    s = -0.5 * d2
    R, dR, d2R = _rot_and_derivs(pose[3:6])
    q = src_xyz
    pts = torch.matmul(q, R.T) + pose[:3]

    if nb is None:
        nb = vm.lookup_neighbors(grid, gspec, pts, mode)
    mean_w, icov6, vvalid = nb                                 # [N,M,·]
    delta = pts[:, None, :] - mean_w                           # [N,M,3]
    Bd = linalg.sym6_matvec(icov6, delta)                      # [N,M,3]
    x = torch.sum(delta * Bd, -1)                              # [N,M]
    use = vvalid & src_mask[:, None]
    e = torch.exp(s * torch.clamp(x, min=0.0))
    c = torch.where(use, d1 * e, 0.0)                          # [N,M]

    L = torch.sum(c)

    # J = [I | D], D[:, :, k] = dR_k · q  → D as [N,3(a),3(k)]
    D = torch.einsum("kab,nb->nak", dR, q)
    # a6 = δᵀB·J: translation part = Bδ; rotation part = Bδ·D_k
    a_rot = torch.einsum("nva,nak->nvk", Bd, D)                # [N,M,3]
    a6 = torch.cat([Bd, a_rot], -1)                            # [N,M,6]

    g = 2.0 * s * torch.einsum("nv,nvi->i", c, a6)

    if not want_hess:
        return L, g, torch.zeros((6, 6), dtype=pose.dtype, device=pose.device)

    # H = Σ c·(4s²·a⊗a + 2s·(JᵀBJ + δᵀB·∂²δ))
    H1 = 4.0 * s * s * torch.einsum("nv,nvi,nvj->ij", c, a6, a6)

    M = icov6.shape[1]
    BD = torch.stack([linalg.sym6_matvec(icov6, D[:, None, :, k].expand(-1, M, -1))
                      for k in range(3)], -1)                  # [N,M,3,3]
    Bmat = linalg.sym6_to_mat(icov6)                           # [N,M,3,3]
    BJ = torch.cat([Bmat, BD], -1)                             # [N,M,3,6]
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(q.shape[0], 3, 3)
    Jfull = torch.cat([eye, D], -1)                            # [N,3,6]
    JtBJ = torch.einsum("nv,nxi,nvxj->ij", c, Jfull, BJ)

    # second-order angle term: bb_kl = Bδ · (d²R_kl · q)
    E = torch.einsum("mab,nb->nam", d2R, q)                    # [N,3,6(m)]
    bb = torch.einsum("nv,nva,nam->m", c, Bd, E)               # [6]
    # bb is packed (rr,rp,ry,pp,py,yy): the symmetric angle block
    Hgeom = torch.zeros((6, 6), dtype=pose.dtype, device=pose.device)
    Hgeom[3:, 3:] = linalg.sym6_to_mat(bb)

    H = H1 + 2.0 * s * (JtBJ + Hgeom)
    H = 0.5 * (H + H.T)
    return L, g, H


def gauss_constants(outlier_ratio: float, resolution: float) -> tuple[float, float]:
    """d1, d2 from the outlier-ratio mixture (ndt_omp_impl.hpp:80-87)."""
    c1 = 10.0 * (1.0 - outlier_ratio)
    c2 = outlier_ratio / (resolution ** 3)
    d3 = -math.log(c2)
    d1 = -math.log(c1 + c2) - d3
    d2 = -2.0 * math.log((-math.log(c1 * math.exp(-0.5) + c2) - d3) / d1)
    return d1, d2


class AlignResult(NamedTuple):
    pose: torch.Tensor          # float32[6], on the grid's device, as every field
    iterations: torch.Tensor    # int32, Newton iterations taken
    converged: torch.Tensor     # bool
    score: torch.Tensor         # float32, final NDT loss (lower = better fit)
    matched_frac: torch.Tensor  # fraction of source pts hitting ≥1 voxel
    fitness: torch.Tensor       # mean sq dist to matched voxel means


def _fitness_sums(pose, src_xyz, src_mask, nb):
    """(matched points, Σ squared distance to the nearest valid voxel mean of
    the neighbourhood over them, points): the sums `_fitness` divides, which
    a sharded align reduces over its mesh first."""
    pts = se3.rotate_translate(pose, src_xyz)
    mean_w, _, vvalid = nb
    d2_ = torch.sum((pts[:, None, :] - mean_w) ** 2, -1)
    d2_ = torch.where(vvalid, d2_, torch.inf)
    dmin = torch.min(d2_, dim=1).values
    matched = src_mask & torch.isfinite(dmin)
    return matched.sum(), torch.sum(torch.where(matched, dmin, 0.0)), src_mask.sum()


def _fitness_of(n_match, sum_d, n_mask):
    fitness = sum_d / torch.clamp(n_match, min=1)
    frac = n_match / torch.clamp(n_mask, min=1)
    return frac, fitness


def _fitness(pose, src_xyz, src_mask, nb):
    """Matched fraction + mean squared distance to the nearest valid voxel
    mean of the neighbourhood (a min over its M voxels), gathered ≤ one
    line-search step from `pose`."""
    return _fitness_of(*_fitness_sums(pose, src_xyz, src_mask, nb))


def _chol_solve6(A, b):
    """Unrolled branch-free 6×6 Cholesky solve. Returns (x, ok) where `ok`
    is False if any pivot was non-positive (A not PD; x is then garbage)."""
    n = 6
    ok = torch.ones((), dtype=torch.bool, device=A.device)
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                ok = ok & (s > 1e-10)
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-12))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x), ok


def newton_direction(g, H):
    """Jacobi-scaled, Gershgorin-shifted Newton direction: a guaranteed
    descent direction that reduces to ~pure Newton when H is PD."""
    d = torch.sqrt(torch.abs(torch.diagonal(H)) + 1e-8)
    S = 1.0 / d
    Hs = H * S[:, None] * S[None, :]
    I6 = torch.eye(6, dtype=H.dtype, device=H.device)
    # tier 1: near-Newton (light damping), valid whenever H is PD
    x1, ok1 = _chol_solve6(Hs + 1e-3 * I6, S * g)
    # tier 2: Gershgorin-shifted (PD by diagonal dominance)
    radii = torch.sum(torch.abs(Hs), dim=1) - torch.abs(torch.diagonal(Hs))
    lower = torch.min(torch.diagonal(Hs) - radii)
    upper = torch.max(torch.diagonal(Hs) + radii)
    shift = torch.clamp(-lower, min=0.0) * 1.05 + 1e-3 * (torch.abs(upper) + 1e-3)
    x2, _ok2 = _chol_solve6(Hs + shift * I6, S * g)
    dp = -(S * torch.where(ok1, x1, x2))
    # fall back to scaled steepest descent if numerics betray us
    descent = torch.dot(dp, g) < 0.0
    return torch.where(descent, dp, -(S * S) * g)


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _backtrack(phi_dphi, phi0, dphi0, alpha0, nspec: NdtSpec):
    """Armijo + curvature backtracking with quadratic interpolation (the
    reference's `ls_mode="backtrack"`), on host scalars. Returns (α, φ(α))."""
    mu, nu = 1e-4, 0.9
    a = alpha0
    done = False
    best_a, best_phi, phi_acc = _f32(0.0), _f32(math.inf), _f32(math.inf)
    for _ in range(nspec.ls_max_trials):
        phi_a, dphi_a = phi_dphi(a)
        suff = bool(phi_a <= phi0 + mu * a * dphi0)
        curv = bool(torch.abs(dphi_a) <= nu * torch.abs(dphi0))
        accept = suff and curv
        if phi_a < best_phi:
            best_a, best_phi = a, phi_a
        # quadratic interpolation backtrack, guarded to [0.1a, 0.5a]
        denom = 2.0 * (phi_a - phi0 - dphi0 * a)
        a_q = -dphi0 * a * a / denom if torch.abs(denom) > 1e-12 else 0.5 * a
        a_next = torch.minimum(torch.maximum(a_q, 0.1 * a), 0.5 * a)
        # sufficient decrease but curvature fails with dφ<0: the step is too
        # short, expand toward alpha0 instead
        if suff and not curv and dphi_a < 0.0:
            a_next = torch.minimum(2.0 * a, alpha0)
        stuck = bool(torch.abs(a_next - a) < 1e-12 * torch.clamp(a, min=1e-12))
        if accept or stuck:
            phi_acc = phi_a
            done = True
        if not accept:
            a = a_next
        if done:
            break
    if done:
        return a, phi_acc
    if best_phi < phi0:
        return best_a, best_phi
    return _f32(0.0), phi0     # nothing improved over φ(0): take no step


def _moved(pose: torch.Tensor, ctx_pose: torch.Tensor) -> torch.Tensor:
    """‖Δt‖ + 60·‖Δr‖ between two host float32 poses, summed in the order
    the kernel sums it (`regather_dist` is compared with it)."""
    d = pose - ctx_pose
    t = torch.sqrt((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])
    r = torch.sqrt((d[3] * d[3] + d[4] * d[4]) + d[5] * d[5])
    return t + _f32(60.0) * r


def newton_align(vgh, vg, prepare, init_pose: torch.Tensor, nspec: NdtSpec,
                 stats: dict | None = None):
    """Newton + the spec's line search. `prepare(pose)` gathers the
    neighbourhood context on the device; `vgh(pose, ctx)` and
    `vg(pose, ctx)` return (L, g, H) and (L, g) there. The pose and all
    6-vector arithmetic live on the host; each device pass costs one
    readback.

    Returns (pose [6] host, iterations, converged, ctx_final, phi_final).
    With `stats` (a dict), it also receives the φ/∇ passes of the line
    searches ("trials") and all passes ("passes"), as the kernel's record
    counts them, and the convergences refused on a stale neighbourhood
    ("stale_refusals", 0 at `regather_dist` 0).

    The neighbourhood is gathered again where the pose has moved more than
    `regather_dist` from its gather pose (`_moved`); convergence counts only
    on an iteration that gathered, or whose pose had not moved since the
    gather, and a convergence refused otherwise pushes the gather pose by
    1e6, so the next iteration gathers (the reference's rule). At
    `regather_dist` 0 every iteration that moved gathers, so none is
    refused."""
    if nspec.ls_mode != "backtrack" or nspec.regather_dist != 0.0:
        raise ValueError("the reference runs the backtracking line search at regather_dist 0")
    dev = init_pose.device

    def on_dev(p):
        return p.to(dev)

    pose = init_pose.detach().to("cpu", torch.float32)
    ctx = prepare(init_pose)
    ctx_pose = pose
    it, trials, refused, converged, phi_fin = 0, 0, 0, False, _f32(math.inf)
    while not converged and it < nspec.max_iterations:
        pose_d = on_dev(pose)
        moved0 = _moved(pose, ctx_pose)
        regather = bool(moved0 > nspec.regather_dist)
        if regather:
            ctx, ctx_pose = prepare(pose_d), pose
        # the iteration's gradient is at a freshly gathered neighbourhood
        fresh = regather or bool(moved0 <= 1e-9)
        L, g, H = _packed(vgh(pose_d, ctx), want_hess=True)
        dp = newton_direction(g, H)
        dpn = torch.linalg.norm(dp) + 1e-12
        direction = dp / dpn
        dphi0 = torch.dot(g, direction)
        alpha0 = torch.clamp(dpn, max=nspec.step_size)

        def phi_dphi(a):
            nonlocal trials
            trials += 1
            La, ga, _ = _packed(vg(on_dev(pose + a * direction), ctx),
                                want_hess=False)
            return La, torch.dot(ga, direction)

        alpha, phi_fin = _backtrack(phi_dphi, L, dphi0, alpha0, nspec)
        pose = pose + alpha * direction
        it += 1
        conv_raw = bool(alpha < nspec.trans_eps)
        converged = conv_raw and fresh
        if conv_raw and not fresh:
            # a convergence on a stale neighbourhood: push the gather pose
            # away so that the next iteration gathers afresh
            ctx_pose = ctx_pose + _f32(1e6)
            refused += 1
    if stats is not None:
        stats.update(trials=trials, passes=it + trials, stale_refusals=refused)
    return pose, it, converged, ctx, phi_fin


def _packed(res, want_hess: bool):
    """Copy (L, g[, H]) to the host in ONE transfer; returns (L, g, H|None)
    as views into the packed copy."""
    L, g = res[0], res[1]
    parts = [L.reshape(1), g]
    if want_hess:
        parts.append(res[2].reshape(36))
    flat = torch.cat(parts).cpu()
    H = flat[7:43].reshape(6, 6) if want_hess else None
    return flat[0], flat[1:7], H


def align_ref(grid, src_xyz, src_mask, init_pose, gspec: vm.GridSpec,
              nspec: NdtSpec, stats: dict | None = None) -> AlignResult:
    """The plain version of the align kernel, on tensors of any one device:
    `newton_align` over `ops/ndt_deriv.py`'s passes, then `_fitness` on the
    last neighbourhood. Every pass costs a readback on CUDA tensors. With
    `stats`, the pass counts (`newton_align`)."""
    d1, d2 = gauss_constants(nspec.outlier_ratio, nspec.resolution)

    def prepare(p):
        return neighborhood(p, src_xyz, grid, gspec, nspec.neighbor_mode)

    def vgh(p, nb):
        return ndt_value_grad_hess(p, src_xyz, src_mask, grid, gspec,
                                             d1, d2, nb=nb)

    def vg(p, nb):
        return ndt_value_grad_hess(p, src_xyz, src_mask, grid, gspec,
                                             d1, d2, want_hess=False, nb=nb)

    pose, iters, converged, nb_fin, phi_fin = newton_align(
        vgh, vg, prepare, init_pose, nspec, stats)
    dev = init_pose.device
    pose = pose.to(dev)
    frac, fitness = _fitness(pose, src_xyz, src_mask, nb_fin)
    return AlignResult(pose=pose,
                       iterations=torch.tensor(iters, dtype=torch.int32, device=dev),
                       converged=torch.tensor(converged, device=dev),
                       score=phi_fin.to(dev), matched_frac=frac, fitness=fitness)


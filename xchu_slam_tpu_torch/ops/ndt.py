"""NDT scan-to-map alignment, the odometry hot loop (port of
`xchu_slam_tpu.ops.ndt`).

Newton iterations with a backtracking (Armijo + curvature) line search, as
the reference's default `ls_mode="backtrack"`, with a fresh DIRECT7 gather
per Newton iteration (`regather_dist=0`).

The reference runs both loops on the device under `lax.while_loop`. Here
they are Python loops: the device does the data passes (the neighbourhood
gather and the fused score/∇/H reduction over all point×voxel pairs) and
each pass reads its 1 + 6 (+ 36) floats back in one copy; the 6-vector and
6×6 arithmetic that decides the next step runs on those host copies in
float32, in the reference's order of operations. One readback per pass is
what any host loop needs to decide whether to go on; a later PR can replace
the loop with a CUDA graph.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from xchu_slam_tpu_torch.ops import ndt_deriv, voxel_map as vm
from xchu_slam_tpu_torch.utils import se3


class NdtSpec(NamedTuple):
    """Static alignment hyper-parameters."""

    step_size: float = 0.1
    trans_eps: float = 0.01
    max_iterations: int = 30
    outlier_ratio: float = 0.55
    resolution: float = 2.0
    ls_max_trials: int = 10
    neighbor_mode: str = "direct7"
    ls_mode: str = "backtrack"
    regather_dist: float = 0.0


def spec_from_config(ndt_cfg) -> NdtSpec:
    return NdtSpec(
        step_size=ndt_cfg.step_size,
        trans_eps=ndt_cfg.trans_eps,
        max_iterations=ndt_cfg.max_iterations,
        outlier_ratio=ndt_cfg.outlier_ratio,
        resolution=ndt_cfg.resolution,
        ls_max_trials=ndt_cfg.line_search_max_trials,
        neighbor_mode=ndt_cfg.neighbor_mode,
        ls_mode=ndt_cfg.ls_mode,
        regather_dist=ndt_cfg.regather_dist,
    )


def gauss_constants(outlier_ratio: float, resolution: float) -> tuple[float, float]:
    """d1, d2 from the outlier-ratio mixture (ndt_omp_impl.hpp:80-87)."""
    c1 = 10.0 * (1.0 - outlier_ratio)
    c2 = outlier_ratio / (resolution ** 3)
    d3 = -math.log(c2)
    d1 = -math.log(c1 + c2) - d3
    d2 = -2.0 * math.log((-math.log(c1 * math.exp(-0.5) + c2) - d3) / d1)
    return d1, d2


class AlignResult(NamedTuple):
    pose: torch.Tensor          # float32[6], on the grid's device
    iterations: int
    converged: bool
    score: float                # final NDT loss (lower = better fit)
    matched_frac: torch.Tensor  # fraction of source pts hitting ≥1 voxel
    fitness: torch.Tensor       # mean sq dist to matched voxel means
    # score/matched_frac/fitness are diagnostics: score is the line-search φ
    # at the accepted pose, matched/fitness reuse the last-gathered DIRECT7
    # neighbourhood (as in the reference)


def _fitness(pose, src_xyz, src_mask, nb):
    """Matched fraction + mean squared distance to the nearest DIRECT7 voxel
    mean, on a neighbourhood gathered ≤ one line-search step from `pose`."""
    pts = se3.rotate_translate(pose, src_xyz)
    mean_w, _, vvalid = nb
    d2_ = torch.sum((pts[:, None, :] - mean_w) ** 2, -1)
    d2_ = torch.where(vvalid, d2_, torch.inf)
    dmin = torch.min(d2_, dim=1).values
    matched = src_mask & torch.isfinite(dmin)
    n_match = matched.sum()
    sum_d = torch.sum(torch.where(matched, dmin, 0.0))
    fitness = sum_d / torch.clamp(n_match, min=1)
    frac = n_match / torch.clamp(src_mask.sum(), min=1)
    return frac, fitness


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


def newton_align(vgh, vg, prepare, init_pose: torch.Tensor, nspec: NdtSpec):
    """Newton + backtracking line search. `prepare(pose)` gathers the
    neighbourhood context on the device; `vgh(pose, ctx)` and
    `vg(pose, ctx)` return (L, g, H) and (L, g) there. The pose and all
    6-vector arithmetic live on the host; each device pass costs one
    readback.

    Returns (pose [6] host, iterations, converged, ctx_final, phi_final)."""
    if nspec.max_iterations < 1:
        raise ValueError("NdtSpec.max_iterations must be >= 1")
    if nspec.ls_mode != "backtrack" or nspec.regather_dist != 0.0:
        raise ValueError("only ls_mode='backtrack' with regather_dist=0 is ported")
    dev = init_pose.device

    def on_dev(p):
        return p.to(dev)

    pose = init_pose.detach().to("cpu", torch.float32)
    ctx = prepare(init_pose)
    ctx_pose = pose
    it, converged, phi_fin = 0, False, _f32(math.inf)
    while not converged and it < nspec.max_iterations:
        pose_d = on_dev(pose)
        if not torch.equal(pose, ctx_pose):
            ctx, ctx_pose = prepare(pose_d), pose
        L, g, H = _packed(vgh(pose_d, ctx), want_hess=True)
        dp = newton_direction(g, H)
        dpn = torch.linalg.norm(dp) + 1e-12
        direction = dp / dpn
        dphi0 = torch.dot(g, direction)
        alpha0 = torch.clamp(dpn, max=nspec.step_size)

        def phi_dphi(a):
            La, ga, _ = _packed(vg(on_dev(pose + a * direction), ctx),
                                want_hess=False)
            return La, torch.dot(ga, direction)

        alpha, phi_fin = _backtrack(phi_dphi, L, dphi0, alpha0, nspec)
        pose = pose + alpha * direction
        it += 1
        converged = bool(alpha < nspec.trans_eps)
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


def align(grid, src_xyz, src_mask, init_pose, gspec: vm.GridSpec,
          nspec: NdtSpec) -> AlignResult:
    """NDT alignment of `src_xyz` [N,3] (mask [N]) onto `grid`, starting at
    `init_pose` [6]; all tensors on the grid's device."""
    d1, d2 = gauss_constants(nspec.outlier_ratio, nspec.resolution)

    def prepare(p):
        return ndt_deriv.neighborhood(p, src_xyz, grid, gspec, nspec.neighbor_mode)

    def vgh(p, nb):
        return ndt_deriv.ndt_value_grad_hess(p, src_xyz, src_mask, grid, gspec,
                                             d1, d2, nb=nb)

    def vg(p, nb):
        return ndt_deriv.ndt_value_grad_hess(p, src_xyz, src_mask, grid, gspec,
                                             d1, d2, want_hess=False, nb=nb)

    pose, iters, converged, nb_fin, phi_fin = newton_align(
        vgh, vg, prepare, init_pose, nspec)
    pose = pose.to(init_pose.device)
    frac, fitness = _fitness(pose, src_xyz, src_mask, nb_fin)
    return AlignResult(pose=pose, iterations=iters, converged=converged,
                       score=float(phi_fin), matched_frac=frac, fitness=fitness)

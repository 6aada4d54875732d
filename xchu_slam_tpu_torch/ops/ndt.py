"""NDT scan-to-map alignment, the odometry hot loop (port of
`xchu_slam_tpu.ops.ndt`).

Newton iterations with the reference's three line searches (`ls_mode`):
"backtrack" (the default: Armijo + curvature backtracking), "mt_exact" (the
More-Thuente search with its loop live) and "ref_clamped" (what the
reference's binary executes: its More-Thuente loop is dead code, so the step
is the clamped first trial), over any of its neighbourhoods
(`neighbor_mode`: direct1, direct7 or its alias direct7_rows, direct26,
kdtree). The neighbourhood is gathered again at an iteration's pose when
the pose has moved more than `regather_dist` (‖Δt‖ + 60·‖Δr‖) from where it
was last gathered: every moving iteration at the default 0, a frozen
neighbourhood above it, where a convergence on a stale neighbourhood is
refused and forces a fresh gather first (the reference's rule, `_moved`).

The reference runs both loops on the device under `lax.while_loop`, for
both of its engines. So does the port: `align` has one route per device,
chosen by where its tensors live. On CUDA tensors it is one launch of the
hand-written kernel `csrc/ndt_kernel.cu`, which keeps both loops and their
trip counts on the card and reads nothing back; a build or launch that fails
raises, there is no fallback. On CPU tensors it is `align_ref`, the kernel's
plain version (`newton_align`): Python loops in which the data passes (the
neighbourhood gather and the fused score/∇/H reduction over all point×voxel
pairs) are tensor operations and each pass hands its 1 + 6 (+ 36) floats to
the host in one copy; the 6-vector and 6×6 arithmetic that decides the next
step runs on those host copies in float32, in the reference's order of
operations. `align_ref` also takes CUDA tensors (a readback per pass), so
that the kernel can be held against it on the card; nothing else calls it
there. Either way every field of the result is a tensor on the inputs'
device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from xchu_slam_tpu_torch.ops import ndt_deriv, voxel_map as vm
from xchu_slam_tpu_torch.ops.cuda import ndt_kernel
from xchu_slam_tpu_torch.utils import collectives, se3


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
    """The config's spec, checked (`check_spec`): a mode the port does not
    run is refused here, before any scan."""
    spec = NdtSpec(
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
    check_spec(spec)
    return spec


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
    # score/matched_frac/fitness are diagnostics: score is the line-search φ
    # at the accepted pose, matched/fitness reuse the last-gathered
    # neighbourhood (as in the reference)


def check_spec(nspec: NdtSpec) -> None:
    """Raise on a spec the port does not run, naming what is refused: both
    routes run the modes the kernel has an instantiation for
    (`ndt_kernel.check_modes`)."""
    ndt_kernel.check_modes(nspec)


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


_TINY = 1e-30


def _safe_div(num, den):
    """num/den with a sign-preserving floor of 1e-30 on |den| (every branch
    of the trial selection is computed, as the reference's selects do)."""
    floor = torch.where(den >= 0.0, _f32(_TINY), _f32(-_TINY))
    return num / torch.where(torch.abs(den) > _TINY, den, floor)


def mt_trial_value(a_l, f_l, g_l, a_u, f_u, g_u, a_t, f_t, g_t):
    """`trialValueSelectionMT` (ndt_omp_impl.hpp:682-757) on float32 host
    scalars, as the reference's branch-free form computes it: the four
    More-Thuente cases with the cubic, quadratic and secant minimisers, every
    case evaluated, square roots clamped at 0 and divisions floored."""
    z1 = 3.0 * _safe_div(f_t - f_l, a_t - a_l) - g_t - g_l
    w1 = torch.sqrt(torch.clamp(z1 * z1 - g_t * g_l, min=0.0))
    a_c1 = a_l + (a_t - a_l) * _safe_div(w1 - g_l - z1, g_t - g_l + 2.0 * w1)
    a_q = a_l - 0.5 * (a_l - a_t) * _safe_div(
        g_l, g_l - _safe_div(f_l - f_t, a_l - a_t))
    case1 = torch.where(torch.abs(a_c1 - a_l) < torch.abs(a_q - a_l),
                        a_c1, 0.5 * (a_q + a_c1))
    a_s = a_l - _safe_div(a_l - a_t, g_l - g_t) * g_l
    case2 = torch.where(torch.abs(a_c1 - a_t) >= torch.abs(a_s - a_t), a_c1, a_s)
    a_t3 = torch.where(torch.abs(a_c1 - a_t) < torch.abs(a_s - a_t), a_c1, a_s)
    case3 = torch.where(a_t > a_l,
                        torch.minimum(a_t + 0.66 * (a_u - a_t), a_t3),
                        torch.maximum(a_t + 0.66 * (a_u - a_t), a_t3))
    z4 = 3.0 * _safe_div(f_t - f_u, a_t - a_u) - g_t - g_u
    w4 = torch.sqrt(torch.clamp(z4 * z4 - g_t * g_u, min=0.0))
    case4 = a_u + (a_t - a_u) * _safe_div(w4 - g_u - z4, g_t - g_u + 2.0 * w4)
    if f_t > f_l:
        return case1
    if g_t * g_l < 0.0:
        return case2
    return case3 if torch.abs(g_t) <= torch.abs(g_l) else case4


def mt_update_interval(a_l, f_l, g_l, a_u, f_u, g_u, a_t, f_t, g_t):
    """`updateIntervalMT` (ndt_omp_impl.hpp:646-677): the updated endpoints
    and whether the interval converged (none of the U1-U3 cases applies)."""
    if f_t > f_l:
        return a_l, f_l, g_l, a_t, f_t, g_t, False
    side = g_t * (a_l - a_t)
    if side > 0.0:
        return a_t, f_t, g_t, a_u, f_u, g_u, False
    if side < 0.0:
        return a_t, f_t, g_t, a_l, f_l, g_l, False
    return a_l, f_l, g_l, a_u, f_u, g_u, True


def mt_exact_search(phi_dphi, phi0, dphi0, alpha0, nspec: NdtSpec):
    """`computeStepLengthMT` (ndt_omp_impl.hpp:762-916) with its loop live,
    on float32 host scalars. Returns (a, φ(a), trials after the first): the
    last trial evaluated.

    The reference's quirks are kept: psi(a) = φ(a) − φ(0) − μ·a·φ'(0) drives
    the open interval; when it closes the endpoints switch to φ with the
    reference's conversion f + φ(0) − μ·φ'(0)·a (its sign differs from the
    algebraic inverse); step_min = trans_eps / 2; the Wolfe test is part of
    the loop condition, so a first trial that meets it makes no loop trip."""
    mu, nu = _f32(1e-4), _f32(0.9)
    step_min, step_max = _f32(0.5 * nspec.trans_eps), _f32(nspec.step_size)
    a_t = torch.minimum(torch.maximum(alpha0, step_min), step_max)
    phi_t, dphi_t = phi_dphi(a_t)
    g0 = (1.0 - mu) * dphi0                   # dpsi at a = 0
    a_l = f_l = a_u = f_u = _f32(0.0)
    g_l = g_u = g0
    open_, done, t = True, False, 0

    def wolfe(a, phi, dphi):
        return bool(phi - phi0 - mu * a * dphi0 <= 0.0) and bool(dphi <= -nu * dphi0)

    while not done and t < nspec.ls_max_trials and not wolfe(a_t, phi_t, dphi_t):
        psi_t = phi_t - phi0 - mu * a_t * dphi0
        dpsi_t = dphi_t - mu * dphi0
        f_t, g_t = (psi_t, dpsi_t) if open_ else (phi_t, dphi_t)
        a_new = torch.minimum(torch.maximum(
            mt_trial_value(a_l, f_l, g_l, a_u, f_u, g_u, a_t, f_t, g_t), step_min), step_max)
        phi_n, dphi_n = phi_dphi(a_new)
        psi_n = phi_n - phi0 - mu * a_new * dphi0
        dpsi_n = dphi_n - mu * dphi0
        if open_ and bool(psi_n <= 0.0) and bool(dpsi_n >= 0.0):
            # the endpoints' psi → phi conversion (reference :888-896)
            f_l = f_l + phi0 - mu * dphi0 * a_l
            g_l = g_l + mu * dphi0
            f_u = f_u + phi0 - mu * dphi0 * a_u
            g_u = g_u + mu * dphi0
            open_ = False
        ft, gt = (psi_n, dpsi_n) if open_ else (phi_n, dphi_n)
        a_l, f_l, g_l, a_u, f_u, g_u, done = mt_update_interval(
            a_l, f_l, g_l, a_u, f_u, g_u, a_new, ft, gt)
        a_t, phi_t, dphi_t = a_new, phi_n, dphi_n
        t += 1
    return a_t, phi_t, t


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
    check_spec(nspec)
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

        if nspec.ls_mode == "mt_exact":
            alpha, phi_fin, _trials = mt_exact_search(phi_dphi, L, dphi0, alpha0, nspec)
        elif nspec.ls_mode == "ref_clamped":
            # the reference's executed step: its dead MT loop leaves the
            # clamped first trial, whose φ is evaluated for the diagnostics
            alpha = torch.minimum(torch.maximum(alpha0, _f32(0.5 * nspec.trans_eps)),
                                  _f32(nspec.step_size))
            phi_fin, _ = phi_dphi(alpha)
        else:
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
        return ndt_deriv.neighborhood(p, src_xyz, grid, gspec, nspec.neighbor_mode)

    def vgh(p, nb):
        return ndt_deriv.ndt_value_grad_hess(p, src_xyz, src_mask, grid, gspec,
                                             d1, d2, nb=nb)

    def vg(p, nb):
        return ndt_deriv.ndt_value_grad_hess(p, src_xyz, src_mask, grid, gspec,
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


def _upper6(tot):
    """The symmetric 6×6 from its row-major upper triangle [21]."""
    iu = torch.triu_indices(6, 6, device=tot.device)
    H = torch.zeros((6, 6), dtype=tot.dtype, device=tot.device)
    H[iu[0], iu[1]] = tot
    H[iu[1], iu[0]] = tot
    return H


def _align_sharded(grid, src_xyz, src_mask, init_pose, gspec, nspec, mesh) -> AlignResult:
    """`align` with the source points sharded over `mesh`: each rank runs the
    passes on its rows, the pass's sums meet in one packed `shard_allsum`, and
    every rank takes the same Newton and line-search decisions from the same
    bits (`newton_align`, on the host). A CPU rank runs `ops/ndt_deriv.py`'s
    pass on its shard; a CUDA rank the kernel's shard pass
    (`ndt_kernel.shard_pass`), which sums in its own fixed order."""
    sl = mesh.shard(src_xyz.shape[0], "source points")
    xyz, mask = src_xyz[sl], src_mask[sl]
    d1, d2 = gauss_constants(nspec.outlier_ratio, nspec.resolution)
    reduce_ = lambda x: collectives.shard_allsum(x, mesh)  # noqa: E731
    if xyz.device.type == "cpu":
        def prepare(p):
            return ndt_deriv.neighborhood(p, xyz, grid, gspec, nspec.neighbor_mode)

        def vgh(p, nb):
            return reduce_(ndt_deriv.ndt_value_grad_hess(p, xyz, mask, grid, gspec, d1, d2,
                                                         nb=nb))

        def vg(p, nb):
            L, g, _ = ndt_deriv.ndt_value_grad_hess(p, xyz, mask, grid, gspec, d1, d2,
                                                    want_hess=False, nb=nb)
            return reduce_((L, g))

        def fit(p, nb):
            return _fitness_sums(p, xyz, mask, nb)
    else:
        two_s = -d2

        def kernel_pass(p, ctx, kind):
            return ndt_kernel.shard_pass(grid.fin, grid.origin, xyz, mask, p, ctx, gspec,
                                         nspec, d1, d2, kind)

        def prepare(p):
            return p.clone()            # the pose the pass gathers at

        def vgh(p, ctx):
            tot = reduce_(kernel_pass(p, ctx, "hessian")[:ndt_kernel.ACC])
            return tot[0], two_s * tot[1:7], _upper6(tot[7:])

        def vg(p, ctx):
            tot = reduce_(kernel_pass(p, ctx, "gradient")[:7])
            return tot[0], two_s * tot[1:7]

        def fit(p, ctx):
            return kernel_pass(p, ctx, "fitness")[28:31]

    pose, iters, converged, ctx_fin, phi_fin = newton_align(vgh, vg, prepare, init_pose, nspec)
    dev = init_pose.device
    pose = pose.to(dev)
    frac, fitness = _fitness_of(*reduce_(fit(pose, ctx_fin)))
    return AlignResult(pose=pose,
                       iterations=torch.tensor(iters, dtype=torch.int32, device=dev),
                       converged=torch.tensor(converged, device=dev),
                       score=phi_fin.to(dev), matched_frac=frac, fitness=fitness)


def align(grid, src_xyz, src_mask, init_pose, gspec: vm.GridSpec,
          nspec: NdtSpec, mesh=None) -> AlignResult:
    """NDT alignment of `src_xyz` [N,3] (mask [N]) onto `grid`, starting at
    `init_pose` [6]; all tensors on the grid's device, which picks the route:
    CUDA tensors launch the kernel (it decides the trip counts, nothing is
    read back, and it raises where it cannot launch), CPU tensors take
    `align_ref`. With a `mesh` (`parallel/distributed.py`; the tensors
    replicated on every rank) the points are sharded over its ranks
    (`_align_sharded`) and every rank returns the same result."""
    if mesh is not None:
        return _align_sharded(grid, src_xyz, src_mask, init_pose, gspec, nspec, mesh)
    if src_xyz.device.type == "cpu":
        return align_ref(grid, src_xyz, src_mask, init_pose, gspec, nspec)
    d1, d2 = gauss_constants(nspec.outlier_ratio, nspec.resolution)
    rec = ndt_kernel.align_record(
        grid.fin, grid.origin, src_xyz, src_mask, init_pose, gspec, nspec, d1, d2)
    slot = ndt_kernel.RECORD
    return AlignResult(pose=rec[slot["pose"]],
                       iterations=rec[slot["iterations"]].to(torch.int32),
                       converged=rec[slot["converged"]] > 0.5,
                       score=rec[slot["score"]],
                       matched_frac=rec[slot["matched_frac"]],
                       fitness=rec[slot["fitness"]])

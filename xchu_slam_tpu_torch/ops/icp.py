"""Point-to-point ICP for loop verification (port of `xchu_slam_tpu.ops.icp`).

Brute-force nearest-neighbour correspondences (the CUDA kernel in
`ops/cuda/nn_kernel.py` on the card), a weighted Procrustes (Umeyama)
update, PCL's transformation-epsilon convergence test plus the reference's
error-plateau exit. Fitness is PCL's: the mean squared distance of source
points to their nearest target within `max_corr_dist`.

The reference iterates under `lax.while_loop`; here each iteration's
correspondence pass and moment sums run on the device and one readback of
17 floats feeds the 3×3 SVD, the transform update and the convergence test
on the host (float32, as the reference computes them).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from xchu_slam_tpu_torch.ops.cuda import nn_kernel
from xchu_slam_tpu_torch.utils import se3


class IcpSpec(NamedTuple):
    max_corr_dist: float = 150.0
    max_iterations: int = 100
    trans_eps: float = 1e-6


def spec_from_config(loop_cfg) -> IcpSpec:
    return IcpSpec(
        max_corr_dist=loop_cfg.icp_max_corr_dist,
        max_iterations=loop_cfg.icp_max_iterations,
        trans_eps=loop_cfg.icp_trans_eps,
    )


class IcpResult(NamedTuple):
    T: torch.Tensor      # float32[4,4] source→target, on the input device
    fitness: float       # mean sq corr distance (PCL semantics)
    iterations: int
    converged: bool      # ended on the transform-delta epsilon or the error
    # plateau, not on the iteration cap (a verification still moving at the
    # cap is rejected by the loop gate)


def _nearest(src, tgt, tgt_mask):
    """For each source point: (nearest target point [N,3], sq dist [N]).
    Every CUDA tensor goes to the kernel, whatever its size."""
    idx, d2 = nn_kernel.nearest_neighbor(src, tgt, tgt_mask)
    return tgt[idx], d2


def _moments(cur, src_mask, tgt, tgt_mask, max_d2):
    """Device pass of one iteration: correspondences, then (wsum, μ_s, μ_t,
    M = Σ w·(t−μ_t)(s−μ_s)ᵀ, Σ w·d²) packed into 17 floats."""
    nn, d2 = _nearest(cur, tgt, tgt_mask)
    w = (src_mask & (d2 < max_d2)).to(torch.float32)
    wsum = torch.clamp(torch.sum(w), min=1.0)
    mu_s = torch.sum(cur * w[:, None], 0) / wsum
    mu_t = torch.sum(nn * w[:, None], 0) / wsum
    xs = (cur - mu_s) * w[:, None]
    xt = nn - mu_t
    M = torch.matmul(xt.T, xs)
    return torch.cat([wsum[None], mu_s, mu_t, M.reshape(9),
                      torch.sum(d2 * w)[None]])


def align(src, src_mask, tgt, tgt_mask, init_T, spec: IcpSpec) -> IcpResult:
    """ICP aligning `src` [N,3] onto `tgt` [M,3]; init_T is a [4,4] guess.
    All tensors on one device."""
    dev = src.device
    max_d2 = spec.max_corr_dist ** 2
    T = init_T.detach().to("cpu", torch.float32)
    it, conv, prev_err = 0, False, torch.tensor(math.inf)
    while not conv and it < spec.max_iterations:
        cur = se3.transform_points(T.to(dev), src)
        m = _moments(cur, src_mask, tgt, tgt_mask, max_d2).cpu()
        wsum, mu_s, mu_t = m[0], m[1:4], m[4:7]
        M = m[7:16].reshape(3, 3) / wsum  # 3×3 cross-covariance
        U, _s, Vt = torch.linalg.svd(M)
        det = torch.linalg.det(U @ Vt)
        S = torch.diag(torch.stack([torch.ones(()), torch.ones(()), det]))
        R = U @ S @ Vt
        t = mu_t - R @ mu_s
        dT = torch.eye(4)
        dT[:3, :3], dT[:3, 3] = R, t
        T = dT @ T
        err = m[16] / wsum
        # PCL transformation-epsilon criterion on the per-iteration delta,
        # plus the error-plateau exit once the transform has settled to
        # within 1 cm² / ~0.57°
        trans_delta2 = torch.sum(t * t)
        cos_theta = 0.5 * (torch.trace(R) - 1.0)
        rot_delta2 = 2.0 * (1.0 - torch.clamp(cos_theta, -1.0, 1.0))
        conv_transform = bool((trans_delta2 < spec.trans_eps)
                              & (rot_delta2 < spec.trans_eps))
        conv_plateau = bool(torch.abs(prev_err - err) < spec.trans_eps)
        settled = bool((trans_delta2 < 1e-4) & (rot_delta2 < 1e-4))
        conv = conv_transform or (conv_plateau and settled)
        prev_err, it = err, it + 1
    # final fitness at the converged transform
    T_dev = T.to(dev)
    cur = se3.transform_points(T_dev, src)
    _nn, d2 = _nearest(cur, tgt, tgt_mask)
    w = (src_mask & (d2 < max_d2)).to(torch.float32)
    num_den = torch.stack([torch.sum(d2 * w), torch.sum(w)]).cpu()
    fitness = num_den[0] / torch.clamp(num_den[1], min=1.0)
    return IcpResult(T=T_dev, fitness=float(fitness), iterations=it,
                     converged=conv)

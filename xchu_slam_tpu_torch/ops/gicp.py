"""Generalized-ICP, distribution to distribution (port of
`xchu_slam_tpu.ops.gicp`).

The reference's equivalent of `pclomp::GeneralizedIterativeClosestPoint`,
which its nodes compile but never instantiate: per-point covariances come
from voxel statistics of the source scan, correspondences are DIRECT7 voxel
lookups in the target grid, and the Mahalanobis objective

    Σ δᵀ (C_tgt + R·C_src·Rᵀ + εI)⁻¹ δ,   δ = R·q + t − μ_tgt

is minimised by the shared Newton / line-search engine
(`ops.ndt.newton_align`) with derivatives from automatic differentiation
(`torch.func`), as the reference takes them from JAX. No pipeline calls it.
On CUDA tensors the passes run on the card as PyTorch operations; the
Newton loop is paced from the host, one readback a pass, as in
`ndt.align_ref`. No kernel of the port is involved.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from xchu_slam_tpu_torch.ops import ndt, voxel_map as vm
from xchu_slam_tpu_torch.utils import linalg, se3


class GicpSpec(NamedTuple):
    max_iterations: int = 30
    trans_eps: float = 1e-3
    step_size: float = 0.2
    ls_max_trials: int = 10
    cov_epsilon: float = 1e-3   # pcl GICP's (1,1,ε) surface regularization


def source_covariances(src_xyz: torch.Tensor, src_mask: torch.Tensor, spec: vm.GridSpec):
    """Per-point covariance [N,3,3] from the source scan's own voxel
    statistics (the inverse of its voxel's regularised inverse covariance),
    0.01·I where the point's voxel is not valid; and that validity [N]."""
    grid = vm.make_grid(spec, vm.centered_origin(spec, src_xyz.new_zeros(3)))
    grid = vm.insert_points(grid, src_xyz, src_mask, spec)
    grid = vm.finalize(grid, spec)
    _mean_w, icov6, valid = vm.lookup_neighbors(grid, spec, src_xyz, "direct7")
    cov = linalg.inv3(linalg.sym6_to_mat(icov6[:, 0]))
    ok = valid[:, 0]
    eye = torch.eye(3, dtype=src_xyz.dtype, device=src_xyz.device)
    return torch.where(ok[:, None, None], cov, eye * 0.01), ok


def gicp_loss(pose, src_xyz, src_mask, src_cov, grid, gspec: vm.GridSpec,
              eps: float) -> torch.Tensor:
    """The objective at `pose` [6] over every (point, DIRECT7 voxel) pair
    with a valid voxel."""
    R = se3.euler_to_matrix(pose[3:6])
    pts = src_xyz @ R.T + pose[:3]
    mean_w, icov6, vvalid = vm.lookup_neighbors(grid, gspec, pts, "direct7")
    C_tgt = linalg.inv3(linalg.sym6_to_mat(icov6))                # [N,7,3,3]
    C_src_rot = torch.einsum("ab,nbc,dc->nad", R, src_cov, R)     # [N,3,3]
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    Minv = linalg.inv3(C_tgt + C_src_rot[:, None] + eps * eye)
    delta = pts[:, None, :] - mean_w
    m = torch.einsum("nvab,nvb->nva", Minv, delta)
    d2 = torch.sum(delta * m, -1)
    use = vvalid & src_mask[:, None]
    return torch.sum(torch.where(use, d2, 0.0))


class GicpResult(NamedTuple):
    """Tensors on the inputs' device."""

    pose: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    loss: torch.Tensor


def align(src_xyz: torch.Tensor, src_mask: torch.Tensor, grid, init_pose: torch.Tensor,
          gspec: vm.GridSpec, spec: GicpSpec = GicpSpec()) -> GicpResult:
    """GICP alignment of a source scan [N,3] (mask [N]) onto a voxel-
    statistics target `grid`, from `init_pose` [6]."""
    src_cov, _ok = source_covariances(src_xyz, src_mask, gspec)

    def loss(p):
        return gicp_loss(p, src_xyz, src_mask, src_cov, grid, gspec, spec.cov_epsilon)

    grad_and_value = torch.func.grad_and_value(loss)
    hessian = torch.func.hessian(loss)

    def vgh(p, _ctx):
        g, L = grad_and_value(p)
        return L, g, hessian(p)

    def vg(p, _ctx):
        g, L = grad_and_value(p)
        return L, g

    nspec = ndt.NdtSpec(step_size=spec.step_size, trans_eps=spec.trans_eps,
                        max_iterations=spec.max_iterations,
                        ls_max_trials=spec.ls_max_trials)
    pose, iters, conv, _ctx, _phi = ndt.newton_align(vgh, vg, lambda p: None,
                                                     init_pose, nspec)
    dev = init_pose.device
    pose = pose.to(dev)
    return GicpResult(pose=pose, iterations=torch.tensor(iters, dtype=torch.int32, device=dev),
                      converged=torch.tensor(conv, device=dev), loss=loss(pose))

"""Closed-form NDT score / gradient / Hessian in one fused pass (port of
`xchu_slam_tpu.ops.ndt_deriv`).

Parameterization: p = [t; r,p,y], x' = Rz(y)Ry(p)Rx(r)·q + t,
loss = Σ d1·exp(−d2/2·δᵀBδ), δ = x'−μ, summed over every (point × DIRECT7
voxel) pair, with the exact gradient and Hessian (including the
second-order angle terms) as batched contractions.
"""

from __future__ import annotations

import torch

from xchu_slam_tpu_torch.ops import voxel_map as vm
from xchu_slam_tpu_torch.utils import linalg, se3


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
    """DIRECT-mode neighbourhood of the transformed source
    (mean_w, icov6, valid); gathered once per Newton iteration and reused by
    that iteration's line-search trials."""
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
    delta = pts[:, None, :] - mean_w                           # [N,7,3]
    Bd = linalg.sym6_matvec(icov6, delta)                      # [N,7,3]
    x = torch.sum(delta * Bd, -1)                              # [N,7]
    use = vvalid & src_mask[:, None]
    e = torch.exp(s * torch.clamp(x, min=0.0))
    c = torch.where(use, d1 * e, 0.0)                          # [N,7]

    L = torch.sum(c)

    # J = [I | D], D[:, :, k] = dR_k · q  → D as [N,3(a),3(k)]
    D = torch.einsum("kab,nb->nak", dR, q)
    # a6 = δᵀB·J: translation part = Bδ; rotation part = Bδ·D_k
    a_rot = torch.einsum("nva,nak->nvk", Bd, D)                # [N,7,3]
    a6 = torch.cat([Bd, a_rot], -1)                            # [N,7,6]

    g = 2.0 * s * torch.einsum("nv,nvi->i", c, a6)

    if not want_hess:
        return L, g, torch.zeros((6, 6), dtype=pose.dtype, device=pose.device)

    # H = Σ c·(4s²·a⊗a + 2s·(JᵀBJ + δᵀB·∂²δ))
    H1 = 4.0 * s * s * torch.einsum("nv,nvi,nvj->ij", c, a6, a6)

    M = icov6.shape[1]
    BD = torch.stack([linalg.sym6_matvec(icov6, D[:, None, :, k].expand(-1, M, -1))
                      for k in range(3)], -1)                  # [N,M,3,3]
    Bmat = linalg.sym6_to_mat(icov6)                           # [N,7,3,3]
    BJ = torch.cat([Bmat, BD], -1)                             # [N,7,3,6]
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

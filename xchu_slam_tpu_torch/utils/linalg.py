"""Small-matrix linear algebra on packed symmetric 3×3 storage
(port of `xchu_slam_tpu.utils.linalg`).

Packed order is (xx, xy, xz, yy, yz, zz). All functions broadcast over
leading dimensions and are branch-free, so one call covers every voxel.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def sym6_to_mat(s: torch.Tensor) -> torch.Tensor:
    """packed [..., 6] (xx,xy,xz,yy,yz,zz) → [..., 3, 3]."""
    xx, xy, xz, yy, yz, zz = (s[..., i] for i in range(6))
    return torch.stack(
        [
            torch.stack([xx, xy, xz], -1),
            torch.stack([xy, yy, yz], -1),
            torch.stack([xz, yz, zz], -1),
        ],
        -2,
    )


def mat_to_sym6(M: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [M[..., 0, 0], M[..., 0, 1], M[..., 0, 2],
         M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]],
        -1,
    )


def sym6_matvec(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Packed symmetric [.,6] times vector [.,3] without materializing 3×3."""
    xx, xy, xz, yy, yz, zz = (s[..., i] for i in range(6))
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [xx * x + xy * y + xz * z,
         xy * x + yy * y + yz * z,
         xz * x + yz * y + zz * z],
        -1,
    )


def sym_eigvals3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric [..., 3, 3], ascending. Trigonometric method
    (Smith 1961), branch-free. The acos argument is clamped to [-1, 1], which
    decides the result at near-repeated eigenvalues."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    A_q = A - q[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    p2 = torch.sum(A_q * A_q, dim=(-1, -2)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=_EPS))
    B = A_q / p[..., None, None]
    detB = (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
        - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
        + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0])
    )
    r = torch.clamp(detB * 0.5, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam2 = q + 2.0 * p * torch.cos(phi)                        # largest
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    lam1 = 3.0 * q - lam0 - lam2
    # degenerate (p≈0): all eigenvalues = q
    iso = p2 < _EPS
    lam0 = torch.where(iso, q, lam0)
    lam1 = torch.where(iso, q, lam1)
    lam2 = torch.where(iso, q, lam2)
    return torch.stack([lam0, lam1, lam2], -1)


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [..., 3, 3] via adjugate (singular → 0)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) < _EPS,
                                torch.full_like(det, math.inf), det)
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], -1),
            torch.stack([A21, A22, A23], -1),
            torch.stack([A31, A32, A33], -1),
        ],
        -2,
    )
    return adj * inv_det[..., None, None]


def inflate_and_invert_cov(cov: torch.Tensor, inflation: float) -> torch.Tensor:
    """NDT covariance conditioning: raise the smallest eigenvalue to at least
    `inflation`·λ_max by adding max(0, floor − λ_min)·I (eigenvectors kept),
    then invert."""
    lam = sym_eigvals3(cov)
    floor = inflation * lam[..., 2]
    bump = torch.clamp(floor - lam[..., 0], min=0.0)
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    return inv3(cov + bump[..., None, None] * eye)

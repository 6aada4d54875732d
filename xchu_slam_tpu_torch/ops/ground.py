"""Ground-plane segmentation (port of `xchu_slam_tpu.ops.ground`).

The reference's ground pipeline (`src/filter_node.cpp:72-216`): tilt
compensation, a height clip to sensor_height ± height_clip (PlaneClip), a
normal filter that keeps points whose k-NN neighbourhood normal lies within
`normal_angle_deg` of +Z, a RANSAC plane fit, a verticality check and an
upward flip of the normal. The result is `ax+by+cz+d=0` with a validity flag.

Normals come from the covariance of each point's k nearest neighbours, found
by a chunked pairwise distance pass and a top-k (no kd-tree); RANSAC scores
every hypothesis against every point at once. Everything is tensor work on
the inputs' device: on CUDA tensors it runs on the card and reads nothing
back. No kernel of the port is involved; the reference leaves this work to
XLA too.

RANSAC draws its triples from a generator seeded 0 on every call, on the
inputs' device (`draw_triples`, the inverse-CDF draw the reference's
`jax.random.choice` makes), so a rerun is bit-identical. The draws are not
the reference's: `fit_plane` takes the triples as an input, so that the
scoring and the refinement can be held to the reference given its own.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from xchu_slam_tpu_torch.utils import linalg


class GroundSpec(NamedTuple):
    sensor_height: float = 1.73
    height_clip: float = 2.5
    tilt_deg: float = 0.0
    normal_knn: int = 10
    normal_angle_deg: float = 20.0
    ransac_iters: int = 128
    ransac_thresh: float = 0.1
    plane_angle_deg: float = 10.0


def spec_from_config(cfg) -> GroundSpec:
    return GroundSpec(
        sensor_height=cfg.sensor_height,
        height_clip=cfg.height_clip,
        normal_knn=cfg.normal_knn,
        normal_angle_deg=cfg.normal_angle_deg,
        ransac_iters=cfg.ransac_iters,
        ransac_thresh=cfg.ransac_thresh,
        plane_angle_deg=cfg.plane_angle_deg,
    )


class GroundResult(NamedTuple):
    """Tensors on the inputs' device."""

    coeffs: torch.Tensor          # float32[4]: (a, b, c, d), ‖(a,b,c)‖ = 1, c > 0
    valid: torch.Tensor           # bool: a plane was found and it is near-horizontal
    ground_mask: torch.Tensor     # bool[N]: inliers of the refined plane
    candidate_mask: torch.Tensor  # bool[N]: survived the clip and the normal filter


def _cos_deg(deg: float, like: torch.Tensor) -> torch.Tensor:
    """cos of an angle in degrees, in float32 on `like`'s device (the
    reference's `jnp.cos(jnp.deg2rad(deg))`)."""
    return torch.cos(torch.deg2rad(torch.full((), deg, dtype=torch.float32,
                                              device=like.device)))


# Query rows per step of the k-NN pass: a [CHUNK, N] distance block.
CHUNK = 512


def knn_indices(xyz: torch.Tensor, mask: torch.Tensor, k: int):
    """The k nearest valid points of every point (itself included) [N,k],
    nearest first, gcd(N, CHUNK) query rows at a time (the reference's
    `chunk = gcd(n, 512)` rule). The distance is the reference's expanded
    |a|² + |b|² − 2a·b (TF32 is off), so where two neighbours are nearly
    equidistant its rounding picks between them."""
    n = xyz.shape[0]
    chunk = min(CHUNK, n)
    if n % chunk != 0:
        chunk = math.gcd(n, chunk)
    sq = torch.sum(xyz * xyz, -1)
    out = []
    for i0 in range(0, n, chunk):
        rows = xyz[i0:i0 + chunk]
        d2 = torch.sum(rows * rows, -1)[:, None] + sq[None, :] - 2.0 * rows @ xyz.T
        d2 = torch.where(mask[None, :], d2, 1e30)
        out.append(torch.topk(d2, k, dim=1, largest=False).indices)
    return torch.cat(out)


def _knn_normals(xyz: torch.Tensor, mask: torch.Tensor, k: int):
    """Per-point neighbourhood normal: the smallest eigenvector of the
    covariance of its k nearest valid points."""
    nbrs = xyz[knn_indices(xyz, mask, k)]                  # [N,k,3]
    c = nbrs - torch.mean(nbrs, dim=1, keepdim=True)
    return linalg.smallest_eigvec3(torch.einsum("nki,nkj->nij", c, c) / k)


def candidates(xyz: torch.Tensor, mask: torch.Tensor, spec: GroundSpec):
    """The tilt-compensated points, the height band, the normals and the
    candidate mask (band and a normal within `normal_angle_deg` of ±Z):
    (xyz [N,3], band [N], normals [N,3], cand [N])."""
    if spec.tilt_deg != 0.0:
        t = math.radians(spec.tilt_deg)
        R = torch.tensor([[math.cos(t), 0.0, math.sin(t)],
                          [0.0, 1.0, 0.0],
                          [-math.sin(t), 0.0, math.cos(t)]], dtype=torch.float32,
                         device=xyz.device)
        xyz = xyz @ R.T
    band = mask & (torch.abs(xyz[:, 2] + spec.sensor_height) <= spec.height_clip)
    normals = _knn_normals(xyz, band, spec.normal_knn)
    cand = band & (torch.abs(normals[:, 2]) >= _cos_deg(spec.normal_angle_deg, xyz))
    return xyz, band, normals, cand


def draw_triples(cand: torch.Tensor, iters: int) -> torch.Tensor:
    """`iters` triples of point indices [iters, 3] (int64), each drawn with
    replacement in proportion to `cand`, from a generator seeded 0 on
    `cand`'s device: u ~ U[0,1), r = total·(1 − u), the first index whose
    running sum reaches r. With no candidate every index is 0."""
    p = cand.to(torch.float32)
    p = p / torch.clamp(torch.sum(p), min=1.0)
    cuml = torch.cumsum(p, 0)
    g = torch.Generator(device=cand.device)
    g.manual_seed(0)
    u = torch.rand((iters, 3), generator=g, device=cand.device)
    r = cuml[-1] * (1.0 - u)
    return torch.clamp(torch.searchsorted(cuml, r), max=cand.shape[0] - 1)


def fit_plane(xyz: torch.Tensor, cand: torch.Tensor, triples: torch.Tensor,
              spec: GroundSpec) -> GroundResult:
    """RANSAC over the given triples (one hypothesis each, scored by its
    candidate inliers within `ransac_thresh`), then the refinement: the
    centroid and smallest-eigenvector normal of the best hypothesis'
    inliers, flipped upward, and the verticality check."""
    a, b, c = xyz[triples[:, 0]], xyz[triples[:, 1]], xyz[triples[:, 2]]   # [H,3]
    nrm = torch.linalg.cross(b - a, c - a)
    ln = torch.linalg.norm(nrm, dim=-1)
    nrm = nrm / torch.clamp(ln, min=1e-9)[:, None]
    d = -torch.sum(nrm * a, -1)
    dist = torch.abs(torch.sum(xyz[None, :, :] * nrm[:, None, :], -1) + d[:, None])  # [H,N]
    score = torch.sum(cand[None, :] & (dist < spec.ransac_thresh), -1)
    scores = torch.where(ln > 1e-9, score, -1)
    best = torch.argmax(scores).reshape(1)     # the first best, as jnp.argmax
    coeffs = torch.cat([nrm, d[:, None]], -1).index_select(0, best)[0]

    dist = torch.abs(torch.sum(xyz * coeffs[:3], -1) + coeffs[3])
    w = (cand & (dist < spec.ransac_thresh)).to(torch.float32)
    wsum = torch.clamp(torch.sum(w), min=1.0)
    mu = torch.sum(xyz * w[:, None], 0) / wsum
    cw = (xyz - mu) * w[:, None]
    nrm = linalg.smallest_eigvec3((cw.T @ cw) / wsum)
    nrm = torch.where(nrm[2] < 0.0, -nrm, nrm)     # flip upward
    coeffs = torch.cat([nrm, -torch.dot(nrm, mu).reshape(1)])

    vert_ok = nrm[2] >= _cos_deg(spec.plane_angle_deg, xyz)
    enough = (torch.sum(cand) >= 3) & (scores.gather(0, best)[0] > 0)
    valid = vert_ok & enough
    dist = torch.abs(torch.sum(xyz * coeffs[:3], -1) + coeffs[3])
    ground = cand & (dist < spec.ransac_thresh) & valid
    return GroundResult(coeffs=coeffs, valid=valid, ground_mask=ground, candidate_mask=cand)


def detect_plane(xyz: torch.Tensor, mask: torch.Tensor, spec: GroundSpec) -> GroundResult:
    """Ground detection on a (filtered) cloud in the sensor frame: xyz
    [N,3], mask [N]: `candidates`, `draw_triples`, `fit_plane`."""
    xyz, _band, _normals, cand = candidates(xyz, mask, spec)
    return fit_plane(xyz, cand, draw_triples(cand, spec.ransac_iters), spec)

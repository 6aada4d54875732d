"""The loop back end of the reference, frozen copies of the port's plain
versions: Scan Context descriptors and their distance over all column
shifts (`ops/scancontext.py`), the nearest-neighbour search
(`ops/cuda/nn_kernel.py::nearest_neighbor_ref`), point-to-point ICP with the
Kabsch update on the host (`ops/icp.py::align_ref`) and the keyframe
cloud's even-stride subsample (`models/pipeline.py::subsample_cloud`)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from slambench.reference import se3

class ScSpec(NamedTuple):
    num_ring: int
    num_sector: int
    max_radius: float
    lidar_height: float
    num_exclude_recent: int
    dist_thresh: float


def sc_spec(cfg: dict) -> ScSpec:
    return ScSpec(num_ring=cfg["sc.num_ring"], num_sector=cfg["sc.num_sector"],
                  max_radius=cfg["sc.max_radius"], lidar_height=cfg["sc.lidar_height"],
                  num_exclude_recent=cfg["sc.num_exclude_recent"],
                  dist_thresh=cfg["sc.dist_thresh"])


def descriptor_partial(xyz: torch.Tensor, mask: torch.Tensor, spec: ScSpec) -> torch.Tensor:
    """Scatter-max polar height image [R, S] with empty bins at -inf. The
    partial form composes across shards: bin each rank's points, take the
    elementwise max over the mesh (`utils/collectives.py::shard_allmax`),
    then clean with `finalize_descriptor` (`parallel/sharded.py::
    slam_superstep`)."""
    r = torch.linalg.norm(xyz[:, :2], dim=-1)
    theta = torch.atan2(xyz[:, 1], xyz[:, 0]) + math.pi  # [0, 2π)
    ring = torch.floor(r / spec.max_radius * spec.num_ring).to(torch.int32)
    sector = torch.floor(theta / (2.0 * math.pi) * spec.num_sector).to(torch.int32)
    sector = torch.clamp(sector, 0, spec.num_sector - 1)
    ok = mask & (ring >= 0) & (ring < spec.num_ring)
    nbin = spec.num_ring * spec.num_sector
    flat = torch.where(ok, (ring * spec.num_sector + sector).long(), nbin)
    z = torch.where(ok, xyz[:, 2] + spec.lidar_height, -torch.inf)
    img = torch.full((nbin + 1,), -torch.inf, dtype=torch.float32, device=xyz.device)
    img = img.scatter_reduce(0, flat, z, reduce="amax", include_self=True)
    return img[:-1].reshape(spec.num_ring, spec.num_sector)


def finalize_descriptor(img: torch.Tensor) -> torch.Tensor:
    """Empty bins (-inf) to 0."""
    return torch.where(torch.isfinite(img), img, 0.0)


def make_descriptor(xyz: torch.Tensor, mask: torch.Tensor, spec: ScSpec) -> torch.Tensor:
    """Polar max-height image [R, S]; empty bins are 0."""
    return finalize_descriptor(descriptor_partial(xyz, mask, spec))


def _normalize_cols(desc: torch.Tensor):
    """Unit-normalize columns; zero columns stay zero. desc [..., R, S]."""
    n = torch.linalg.norm(desc, dim=-2, keepdim=True)
    nonzero = n > 0.0
    return (torch.where(nonzero, desc / torch.where(nonzero, n, 1.0), 0.0),
            nonzero[..., 0, :])


def _shift_index(S: int, device) -> torch.Tensor:
    """[S,S] gather index: row s is the column order of roll(x, -s)."""
    ar = torch.arange(S, device=device)
    return (ar[None, :] + ar[:, None]) % S


def distance_all_rotations(query, db, db_mask, spec: ScSpec):
    """SC distance of `query` [R,S] against every DB entry [K,R,S] over all S
    column shifts. Returns (dist [K], best_shift [K])."""
    S = spec.num_sector
    qn, qvalid = _normalize_cols(query)          # [R,S], [S]
    cn, cvalid = _normalize_cols(db)             # [K,R,S], [K,S]
    idx = _shift_index(S, query.device)          # [S(shift), S(col)]
    # compare query vs roll(c, s) ≡ roll(query, -s) vs c
    qn_roll = qn[:, idx].permute(1, 0, 2)        # [S,R,S]
    qv_roll = qvalid[idx]                        # [S,S]
    cos = torch.einsum("srj,krj->ksj", qn_roll, cn)                      # [K,S,S]
    pair_ok = qv_roll[None, :, :] & cvalid[:, None, :]
    num = torch.sum(torch.where(pair_ok, cos, 0.0), dim=-1)
    den = pair_ok.sum(dim=-1)
    sim = torch.where(den > 0, num / torch.clamp(den, min=1), -1.0)
    dist = torch.where(db_mask[:, None], 1.0 - sim, torch.inf)           # [K,S]
    best = torch.min(dist, dim=1)
    return best.values, best.indices


def shift_yaw(shift: torch.Tensor, num_sector: int) -> torch.Tensor:
    """The relative yaw of a column shift, wrapped to (-pi, pi]."""
    yaw = shift.to(torch.float32) * (2.0 * math.pi / num_sector)
    return torch.atan2(torch.sin(yaw), torch.cos(yaw))



def nearest_neighbor_ref(src: torch.Tensor, tgt: torch.Tensor,
                         tgt_mask: torch.Tensor, chunk: int = 1024):
    """Plain PyTorch version: the expanded form |s|²+|t|²−2s·t for the
    argmin (as the reference's XLA branch, ops/icp.py:69-90), then the exact
    d² = |s − t[idx]|²; rows of `chunk` sources bound the [chunk, M] block."""
    big = 1e30
    tsq = torch.sum(tgt * tgt, dim=-1)
    idx_out, d2_out = [], []
    for i0 in range(0, src.shape[0], chunk):
        rows = src[i0:i0 + chunk]
        d2 = (torch.sum(rows * rows, -1)[:, None] + tsq[None, :]
              - 2.0 * rows @ tgt.T)
        d2 = torch.where(tgt_mask[None, :], d2, big)
        j = torch.argmin(d2, dim=1)
        d2_exact = torch.sum((rows - tgt[j]) ** 2, -1)
        d2_out.append(torch.where(tgt_mask[j], d2_exact, big))
        idx_out.append(j.to(torch.int32))
    return torch.cat(idx_out), torch.cat(d2_out)



class IcpSpec(NamedTuple):
    max_corr_dist: float
    max_iterations: int
    trans_eps: float


def icp_spec(cfg: dict) -> IcpSpec:
    return IcpSpec(max_corr_dist=cfg["loop.icp_max_corr_dist"],
                   max_iterations=cfg["loop.icp_max_iterations"],
                   trans_eps=cfg["loop.icp_trans_eps"])


class IcpResult(NamedTuple):
    """Tensors on the inputs' device."""

    T: torch.Tensor           # float32[4,4] source→target
    fitness: torch.Tensor     # float32: mean sq corr distance (PCL semantics)
    iterations: torch.Tensor  # int32
    converged: torch.Tensor   # bool: ended on the transform-delta epsilon or


def _moments(cur, src_mask, tgt, tgt_mask, max_d2):
    """Device pass of one iteration: correspondences, then (wsum, μ_s, μ_t,
    M = Σ w·(t−μ_t)(s−μ_s)ᵀ, Σ w·d²) packed into 17 floats."""
    idx, d2 = nearest_neighbor_ref(cur, tgt, tgt_mask)
    nn = tgt[idx.long()]
    w = (src_mask & (d2 < max_d2)).to(torch.float32)
    wsum = torch.clamp(torch.sum(w), min=1.0)
    mu_s = torch.sum(cur * w[:, None], 0) / wsum
    mu_t = torch.sum(nn * w[:, None], 0) / wsum
    xs = (cur - mu_s) * w[:, None]
    xt = nn - mu_t
    M = torch.matmul(xt.T, xs)
    return torch.cat([wsum[None], mu_s, mu_t, M.reshape(9),
                      torch.sum(d2 * w)[None]])


def kabsch_ref(M: torch.Tensor) -> torch.Tensor:
    """The proper rotation R maximising tr(Rᵀ M) for the 3×3 cross-covariance
    M: U·diag(1, 1, det(UVᵀ))·Vᵀ from the SVD, as the reference computes it
    (the plain version of the kernel's quaternion form)."""
    U, _s, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones((), dtype=M.dtype, device=M.device)
    S = torch.diag(torch.stack([one, one, det]))
    return U @ S @ Vt


def _host_loop(moments, fitness_sums, src, init_T, spec: IcpSpec, run: bool) -> IcpResult:
    """The plain loop: `moments(cur)` gives an iteration's 17 floats (wsum,
    μ_s, μ_t, M, Σ w·d²), the update and the tests run on the host in
    float32, as the reference computes them; `fitness_sums(cur)` gives
    (Σ w·d², Σ w) at the final transform."""
    dev = src.device
    T = init_T.detach().to("cpu", torch.float32)
    it, conv, prev_err = 0, False, torch.tensor(math.inf)
    while run and not conv and it < spec.max_iterations:
        m = moments(se3.transform_points(T.to(dev), src)).cpu()
        wsum, mu_s, mu_t = m[0], m[1:4], m[4:7]
        R = kabsch_ref(m[7:16].reshape(3, 3) / wsum)
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
    T_dev = T.to(dev)
    fitness = torch.zeros((), dtype=torch.float32)
    if run:
        # final fitness at the converged transform
        num_den = fitness_sums(se3.transform_points(T_dev, src)).cpu()
        fitness = num_den[0] / torch.clamp(num_den[1], min=1.0)
    return IcpResult(T=T_dev, fitness=fitness.to(dev),
                     iterations=torch.tensor(it, dtype=torch.int32, device=dev),
                     converged=torch.tensor(conv, device=dev))


def _fitness_num_den(cur, src_mask, tgt, tgt_mask, max_d2):
    _idx, d2 = nearest_neighbor_ref(cur, tgt, tgt_mask)
    w = (src_mask & (d2 < max_d2)).to(torch.float32)
    return torch.stack([torch.sum(d2 * w), torch.sum(w)])


def align_ref(src, src_mask, tgt, tgt_mask, init_T, spec: IcpSpec,
              live: torch.Tensor | None = None) -> IcpResult:
    """The plain version of `align`: the moments on the inputs' device, the
    update and the tests on the host, one readback an iteration."""
    max_d2 = spec.max_corr_dist ** 2
    return _host_loop(lambda cur: _moments(cur, src_mask, tgt, tgt_mask, max_d2),
                      lambda cur: _fitness_num_den(cur, src_mask, tgt, tgt_mask, max_d2),
                      src, init_T, spec, True if live is None else bool(live))



def subsample_cloud(xyz: torch.Tensor, mask: torch.Tensor, n_out: int):
    """Spatially unbiased fixed-size subsample: compact valid points then
    take an even stride. Returns (xyz [n_out,3], mask [n_out],
    src_idx [n_out])."""
    N = xyz.shape[0]
    dev = xyz.device
    pos = torch.cumsum(mask.long(), 0) - 1
    dest = torch.where(mask, pos, N)
    xyz_c = torch.zeros((N + 1, 3), dtype=xyz.dtype, device=dev)
    src_c = torch.zeros((N + 1,), dtype=torch.int64, device=dev)
    xyz_c[dest] = xyz            # slot N is the dropped slot
    src_c[dest] = torch.arange(N, device=dev)
    n_valid = mask.sum()
    ar = torch.arange(n_out, device=dev)
    idx = torch.clamp((ar * torch.clamp(n_valid, min=1)) // n_out, 0, N - 1)
    take = ar < torch.clamp(n_valid, max=n_out)
    return torch.where(take[:, None], xyz_c[idx], 0.0), take, src_c[idx]


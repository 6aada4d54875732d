"""The pose-graph solve of the reference: Gauss-Newton over the live
keyframes with a dense Cholesky solve of each iteration's normal equations
(float64 by default), the port's model (`models/pose_graph.py`): between
factors of the odometric increments with diagonal information, loop factors
with their information under the Cauchy IRLS weight, GPS altitude factors
on the z of the keyframes with a fix, node 0 held fixed, right-multiplied
tangent updates. The port solves each iteration by a preconditioned CG to a
relative tolerance; this solves it exactly."""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from slambench.reference import se3


def _residual(Ti, Tj, Z):
    """log(Z⁻¹ · Ti⁻¹ · Tj)."""
    return se3.se3_log(torch.matmul(se3.inverse(Z), torch.matmul(se3.inverse(Ti), Tj)))


def _jacobians(Ti, Tj, Z):
    def blk(a, b, z):
        x0 = torch.zeros(6, dtype=a.dtype, device=a.device)
        Ja = jacfwd(lambda x: _residual(a @ se3.se3_exp(x), b, z))(x0)
        Jb = jacfwd(lambda x: _residual(a, b @ se3.se3_exp(x), z))(x0)
        return Ja, Jb

    return vmap(blk)(Ti, Tj, Z)


def solve(T: torch.Tensor, loops: list, odom_info: torch.Tensor, cauchy_k: float,
          iterations: int, between: torch.Tensor, round_state=None, gps=None) -> torch.Tensor:
    """T [n,4,4] (the live keyframes' transforms), `between` [n,4,4] (row k:
    Z of edge (k−1, k); row 0 unused), `loops` [(i, j, Z [4,4], info)]:
    `iterations` Gauss-Newton steps; returns the new [n,4,4].
    `round_state` (the control's) rounds the transforms after each step.
    `gps` (altitudes [≥n], information [≥n], 0 where a keyframe has no fix)
    adds the factor z_k − altitude_k, whose Jacobian under the update
    T·exp(v, w) is (R[2,:], 0)."""
    n = T.shape[0]
    if n < 2:
        return T
    dt, dev = T.dtype, T.device
    ke = torch.arange(1, n, device=dev)
    W = odom_info.to(dev, dt)
    if loops:
        li = torch.tensor([lp[0] for lp in loops], device=dev)
        lj = torch.tensor([lp[1] for lp in loops], device=dev)
        lZ = torch.stack([torch.as_tensor(lp[2]) for lp in loops]).to(dev, dt)
        linfo = torch.tensor([max(float(lp[3]), 0.0) for lp in loops], dtype=dt, device=dev)
    for _ in range(iterations):
        Ji, Jj = _jacobians(T[ke - 1], T[ke], between[1:n])
        r = _residual(T[ke - 1], T[ke], between[1:n])
        H = torch.zeros((n, 6, n, 6), dtype=dt, device=dev)
        g = torch.zeros((n, 6), dtype=dt, device=dev)

        def add(ia, ib, Ja, Jb, w, res):
            wJb = w[..., None] * Jb if w.dim() == 2 else w[:, None, None] * Jb
            wJa = w[..., None] * Ja if w.dim() == 2 else w[:, None, None] * Ja
            wr = w * res if w.dim() == 2 else w[:, None] * res
            g.index_add_(0, ia, torch.einsum("fba,fb->fa", Ja, wr))
            g.index_add_(0, ib, torch.einsum("fba,fb->fa", Jb, wr))
            for (x, Jx), (y, wJy) in (((ia, Ja), (ia, wJa)), ((ia, Ja), (ib, wJb)),
                                      ((ib, Jb), (ia, wJa)), ((ib, Jb), (ib, wJb))):
                blocks = torch.einsum("fba,fbc->fac", Jx, wJy)
                H.index_put_((x[:, None, None], torch.arange(6, device=dev)[None, :, None],
                              y[:, None, None], torch.arange(6, device=dev)[None, None, :]),
                             blocks, accumulate=True)

        add(ke - 1, ke, Ji, Jj, W.expand(n - 1, 6), r)
        if loops:
            Ti, Tj = T[li], T[lj]
            rl = _residual(Ti, Tj, lZ)
            s = torch.sum((rl * torch.sqrt(linfo)[:, None]) ** 2, -1)
            wl = linfo / (1.0 + s / (cauchy_k * cauchy_k))
            Jli, Jlj = _jacobians(Ti, Tj, lZ)
            add(li, lj, Jli, Jlj, wl, rl)
        if gps is not None:
            alt, gw = (x[:n].to(dev, dt) for x in gps)
            A = T[:, 2, :3]
            g[:, :3] += (gw * (T[:, 2, 3] - alt))[:, None] * A
            nodes = torch.arange(n, device=dev)
            H[nodes, :3, nodes, :3] += gw[:, None, None] * A[:, :, None] * A[:, None, :]
        Hm = H.reshape(6 * n, 6 * n)[6:, 6:]
        L = torch.linalg.cholesky(0.5 * (Hm + Hm.T))
        x = torch.cholesky_solve(-g.reshape(-1)[6:, None], L)[:, 0].reshape(n - 1, 6)
        T = torch.cat([T[:1], torch.matmul(T[1:], se3.se3_exp(x))])
        if round_state is not None:
            T = round_state(T)
    return T

"""Point-to-point ICP for loop verification (port of `xchu_slam_tpu.ops.icp`).

Brute-force nearest-neighbour correspondences (the CUDA kernel in
`ops/cuda/nn_kernel.py` on the card), a weighted Procrustes (Kabsch) update,
PCL's transformation-epsilon convergence test plus the reference's
error-plateau exit. Fitness is PCL's: the mean squared distance of source
points to their nearest target within `max_corr_dist`.

The reference iterates under `lax.while_loop`. Here `align` picks its route
by where the tensors live:
- CUDA tensors: the loop is a CUDA graph, captured once per (N, M, spec) and
  replayed per verification: `max_iterations` trips of (NN kernel,
  `csrc/icp_kernel.cu`'s step: moment sums, the Kabsch rotation, the
  update, the stop tests) and a final fitness pass. The stop tests clear a
  `live` flag on the card and every kernel of a later trip returns at once,
  so nothing is read back; the result's fields are tensors on the card.
- CPU tensors: `align_ref`, the plain version: each iteration's moment sums
  (17 floats) go to the host, which does the 3×3 SVD, the update and the
  tests in float32, as the reference computes them. It is the fixed-trip
  loop masked on `live`, leaving the loop where the mask turns false (the
  trips after it change nothing).
Both take an optional `live` (0-d bool tensor): false makes the whole
verification a no-op that returns init_T, 0 iterations, not converged and
fitness 0.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from xchu_slam_tpu_torch.ops.cuda import icp_kernel, nn_kernel
from xchu_slam_tpu_torch.utils import collectives, se3


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
    """Tensors on the inputs' device."""

    T: torch.Tensor           # float32[4,4] source→target
    fitness: torch.Tensor     # float32: mean sq corr distance (PCL semantics)
    iterations: torch.Tensor  # int32
    converged: torch.Tensor   # bool: ended on the transform-delta epsilon or
    # the error plateau, not on the iteration cap (a verification still
    # moving at the cap is rejected by the loop gate)


# ICP iterations the card's routes ran, per device (a tensor there: the graph
# route adds to it after each replay without a readback, the sharded route
# the trips its host loop ran); `live_trip_count` reads them
live_trips: dict = {}


def live_counter(dev: torch.device) -> torch.Tensor:
    """The live-trip counter of `dev`, made at its first use (before any
    capture that adds to it: made inside one, a replay would zero it)."""
    if dev not in live_trips:
        live_trips[dev] = torch.zeros((), dtype=torch.int64, device=dev)
    return live_trips[dev]


def live_trip_count() -> int:
    """The live ICP iterations of every replay so far, on all devices (one
    readback each)."""
    return sum(int(t) for t in live_trips.values())


def _nearest(src, tgt, tgt_mask):
    """For each source point: (nearest target point [N,3], sq dist [N])."""
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


def kabsch_ref(M: torch.Tensor) -> torch.Tensor:
    """The proper rotation R maximising tr(Rᵀ M) for the 3×3 cross-covariance
    M: U·diag(1, 1, det(UVᵀ))·Vᵀ from the SVD, as the reference computes it
    (the plain version of the kernel's quaternion form)."""
    U, _s, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones((), dtype=M.dtype, device=M.device)
    S = torch.diag(torch.stack([one, one, det]))
    return U @ S @ Vt


def _shard_moments(cur, src_mask, tgt, tgt_mask, max_d2, mesh):
    """`_moments` with the source sharded over `mesh`: the shard's first-pass
    sums (Σw, Σw·s, Σw·t, Σw·d², in icp_step's order) reduced, then its
    centred cross-covariance about those means reduced: two packed
    collectives. The same 17 floats on every rank (wsum is clamped at 1)."""
    nn, d2 = _nearest(cur, tgt, tgt_mask)
    w = (src_mask & (d2 < max_d2)).to(torch.float32)
    s8 = collectives.shard_allsum(
        torch.cat([torch.sum(w)[None], torch.sum(cur * w[:, None], 0),
                   torch.sum(nn * w[:, None], 0), torch.sum(d2 * w)[None]]), mesh)
    wsum = torch.clamp(s8[0], min=1.0)
    mu_s, mu_t = s8[1:4] / wsum, s8[4:7] / wsum
    M = collectives.shard_allsum(torch.matmul((nn - mu_t).T, (cur - mu_s) * w[:, None]), mesh)
    return torch.cat([wsum[None], mu_s, mu_t, M.reshape(9), s8[7:8]])


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
    _nn, d2 = _nearest(cur, tgt, tgt_mask)
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


def _align_sharded_cuda(src, src_mask, tgt, tgt_mask, init_T, spec: IcpSpec, run, mesh):
    """The sharded verification on the card, a host loop of trips (a gloo
    collective cannot sit inside a CUDA graph): the NN kernel on the shard,
    `icp_kernel.partial` stage 0, a reduction, stage 1, a reduction,
    `icp_kernel.solve`; the live flag, identical on every rank, read once a
    trip. The fitness sums are stage 0's at the final transform."""
    dev = src.device
    max_d2 = spec.max_corr_dist ** 2
    slot = icp_kernel.STATE
    st = torch.empty(icp_kernel.STATE_FLOATS, dtype=torch.float32, device=dev)
    cur = torch.empty_like(src)
    icp_kernel.init(src, init_T.to(torch.float32).contiguous(), run, st, cur)
    trips = 0
    for _ in range(spec.max_iterations):
        if not bool(st[slot["live"]] > 0.5):
            break
        trips += 1
        idx, d2 = nn_kernel.nearest_neighbor(cur, tgt, tgt_mask)
        s8 = collectives.shard_allsum(
            icp_kernel.partial(src, src_mask, tgt, idx, d2, st, max_d2, 0), mesh)
        s9 = collectives.shard_allsum(
            icp_kernel.partial(src, src_mask, tgt, idx, d2, st, max_d2, 1, s8), mesh)
        icp_kernel.solve(src, torch.cat([s8, s9]), st, cur, spec.trans_eps,
                         spec.max_iterations)
    live_counter(dev).add_(trips)
    fitness = torch.zeros((), dtype=torch.float32, device=dev)
    if bool(st[slot["live0"]] > 0.5):
        idx, d2 = nn_kernel.nearest_neighbor(cur, tgt, tgt_mask)
        s8 = collectives.shard_allsum(
            icp_kernel.partial(src, src_mask, tgt, idx, d2, st, max_d2, 0), mesh)
        fitness = s8[7] / torch.clamp(s8[0], min=1.0)
    return IcpResult(T=st[slot["T"]].reshape(4, 4).clone(), fitness=fitness,
                     iterations=st[slot["iterations"]].to(torch.int32),
                     converged=st[slot["converged"]] > 0.5)


def _align_sharded(src, src_mask, tgt, tgt_mask, init_T, spec: IcpSpec, live, mesh):
    """`align` with the source sharded over `mesh` and the target replicated:
    each rank searches its shard's correspondences, the moment sums meet in
    two packed collectives a trip (the means, then the cross-covariance
    centred on them, as icp_step centres), and every rank takes the same
    update and stop decisions from the same bits."""
    sl = mesh.shard(src.shape[0], "source points")
    src_l, mask_l = src[sl].contiguous(), src_mask[sl].contiguous()
    dev = src.device
    if dev.type != "cpu":
        run = torch.ones((), dtype=torch.bool, device=dev) if live is None else live
        return _align_sharded_cuda(src_l, mask_l, tgt, tgt_mask, init_T, spec, run, mesh)
    max_d2 = spec.max_corr_dist ** 2
    return _host_loop(
        lambda cur: _shard_moments(cur, mask_l, tgt, tgt_mask, max_d2, mesh),
        lambda cur: collectives.shard_allsum(
            _fitness_num_den(cur, mask_l, tgt, tgt_mask, max_d2), mesh),
        src_l, init_T, spec, True if live is None else bool(live))


class _IcpGraph:
    """One verification as a CUDA graph over static buffers: the set-up,
    `max_iterations` trips of (NN kernel, step kernel) and the fitness pass."""

    def __init__(self, n: int, m: int, spec: IcpSpec, dev: torch.device):
        f32 = torch.float32
        self.spec = spec
        self.src = torch.zeros((n, 3), dtype=f32, device=dev)
        self.src_mask = torch.zeros(n, dtype=torch.bool, device=dev)
        self.tgt = torch.zeros((m, 3), dtype=f32, device=dev)
        self.tgt_mask = torch.zeros(m, dtype=torch.bool, device=dev)
        self.init_T = torch.eye(4, dtype=f32, device=dev)
        self.live = torch.zeros((), dtype=torch.bool, device=dev)
        self.st = torch.zeros(icp_kernel.STATE_FLOATS, dtype=f32, device=dev)
        self.cur = torch.zeros((n, 3), dtype=f32, device=dev)
        counts = (nn_kernel.launches, icp_kernel.launches)
        self._body()       # loads both libraries before the capture
        warm = (nn_kernel.launches, icp_kernel.launches)
        self.graph = torch.cuda.CUDAGraph()
        # entering a capture synchronises the device, once per shape
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        try:
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self._body()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        # a capture records launches, it makes none: each replay makes them.
        # The warm-up's trips were no-ops (live false), not counted either
        self.nn_launches = nn_kernel.launches - warm[0]
        self.step_launches = icp_kernel.launches - warm[1]
        nn_kernel.launches, icp_kernel.launches = counts

    def _body(self) -> None:
        spec = self.spec
        max_d2 = spec.max_corr_dist ** 2
        slot = icp_kernel.STATE
        icp_kernel.init(self.src, self.init_T, self.live, self.st, self.cur)
        live = self.st[slot["live"]:slot["live"] + 1]
        for _ in range(spec.max_iterations):
            idx, d2 = nn_kernel.nearest_neighbor(self.cur, self.tgt, self.tgt_mask, live=live)
            icp_kernel.step(self.src, self.src_mask, self.tgt, idx, d2, self.cur, self.st,
                            max_d2, spec.trans_eps, spec.max_iterations)
        live0 = self.st[slot["live0"]:slot["live0"] + 1]
        _idx, d2 = nn_kernel.nearest_neighbor(self.cur, self.tgt, self.tgt_mask, live=live0)
        icp_kernel.fitness(self.src_mask, d2, self.st, max_d2)

    def load(self, src, src_mask, tgt, tgt_mask, init_T, live) -> None:
        """Copy a verification's inputs into the static buffers."""
        for dst, s in ((self.src, src), (self.src_mask, src_mask), (self.tgt, tgt),
                       (self.tgt_mask, tgt_mask), (self.init_T, init_T), (self.live, live)):
            dst.copy_(s)

    def replay(self) -> None:
        self.graph.replay()
        nn_kernel.launches += self.nn_launches
        icp_kernel.launches += self.step_launches

    def result(self) -> IcpResult:
        """The last replay's result, its live trips added to `live_trips`
        (on the card: capture-safe once the counter exists)."""
        slot = icp_kernel.STATE
        st = self.st
        iters = st[slot["iterations"]].to(torch.int32)
        live_counter(st.device).add_(iters)
        return IcpResult(T=st[slot["T"]].reshape(4, 4).clone(),
                         fitness=st[slot["fitness"]].clone(), iterations=iters,
                         converged=st[slot["converged"]] > 0.5)

    def run(self, src, src_mask, tgt, tgt_mask, init_T, live) -> IcpResult:
        self.load(src, src_mask, tgt, tgt_mask, init_T, live)
        self.replay()
        return self.result()


@functools.lru_cache(maxsize=8)
def align_graph(n: int, m: int, spec: IcpSpec, dev: torch.device) -> _IcpGraph:
    """The verification's graph of (N, M, spec) on `dev`, captured at its
    first use."""
    return _IcpGraph(n, m, spec, dev)


def align(src, src_mask, tgt, tgt_mask, init_T, spec: IcpSpec,
          live: torch.Tensor | None = None, mesh=None) -> IcpResult:
    """ICP aligning `src` [N,3] onto `tgt` [M,3]; init_T is a [4,4] guess.
    All tensors on one device; `live` (0-d bool) false makes it a no-op.
    CUDA tensors replay the verification's CUDA graph and read nothing
    back; CPU tensors take `align_ref`. With a `mesh`
    (`parallel/distributed.py`; the tensors replicated on every rank) the
    source is sharded over its ranks (`_align_sharded`) and every rank
    returns the same result."""
    if mesh is not None:
        return _align_sharded(src, src_mask, tgt, tgt_mask, init_T, spec, live, mesh)
    dev = src.device
    if dev.type == "cpu":
        return align_ref(src, src_mask, tgt, tgt_mask, init_T, spec, live)
    if live is None:
        live = torch.ones((), dtype=torch.bool, device=dev)
    g = align_graph(src.shape[0], tgt.shape[0], spec, dev)
    return g.run(src, src_mask, tgt, tgt_mask, init_T.to(torch.float32), live)

"""The card's published peaks and the kernels' least times (the yardstick of
the roofline metrics; the arithmetic of chip_smoke.py's bounds, copied).

NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit: 67 TFLOP/s
FP32 outside the tensor cores (an FMA counts 2, so 33.5 T instructions/s)
and 3.35 TB/s of HBM3. A share is stated against these with the card's
power limit beside it (PERF.md)."""

from __future__ import annotations

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
NN_INSTR_PER_PAIR = 5      # the least FP32 instructions a point pair needs (chip_smoke.py)


def ndt_flop(m: int) -> tuple[int, int, int]:
    """(Hessian pass, gradient pass, fitness pass) FP32 operations a point
    with m voxels a point."""
    return 2 * (m * 75 + 150), 2 * (m * 30 + 40), 2 * (m * 6 + 10)


def ndt_align_bound_s(n_slots: int, n_valid: float, iterations: float, m: int = 7) -> float:
    """The least time one align could take: every source slot's point and
    mask read once, the m voxel rows (40 B each) of every valid point read
    once and the record written once, at the HBM rate; against the passes'
    FP32 operations (an iteration's Hessian pass, at least one line-search
    trial's gradient pass an iteration, the fitness pass) at the FP32 peak."""
    hess, grad, fit = ndt_flop(m)
    nbytes = n_slots * 12 + n_slots + n_valid * m * 40 + 64 * 4
    flop = n_valid * (iterations * hess + iterations * grad + fit)
    return max(nbytes / HBM_BYTES_PER_S, flop / FP32_FLOPS)


def nn_search_bound_s(n: int, m: int) -> float:
    """The least time one nearest-neighbour search of n source points over m
    targets could take: its inputs read and its outputs written once at the
    HBM rate, against NN_INSTR_PER_PAIR FP32 instructions a pair at the
    issue rate behind the FP32 peak."""
    nbytes = 12 * n + 13 * m + 8 * n
    return max(nbytes / HBM_BYTES_PER_S, NN_INSTR_PER_PAIR * n * m / (FP32_FLOPS / 2))

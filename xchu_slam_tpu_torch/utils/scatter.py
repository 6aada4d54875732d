"""Scatter-add in a fixed order.

CUDA's `index_add_` sums with float atomics, so the order of the sum, and
with it the last bits of the result, changes from run to run. These sums
feed control flow downstream (voxel statistics → Newton and line-search trip
counts, centroids → kept masks), so the port takes the deterministic path of
`index_put_(accumulate=True)`: on the card it sorts the indices stably and
sums each segment in input order. On the CPU the same call is a sequential
loop in input order, as the reference's scatter is.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)


def index_add(dst: torch.Tensor, index: torch.Tensor,
              src: torch.Tensor) -> torch.Tensor:
    """dst[index[i]] += src[i] along dim 0, in place, in a fixed order.
    Returns `dst`."""
    with _deterministic():
        dst.index_put_((index,), src, accumulate=True)
    return dst

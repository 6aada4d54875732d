"""Packed deterministic cross-rank reductions (port of
`xchu_slam_tpu.utils.collectives`) on `torch.distributed`.

One call is ONE executed collective, however many tensors it carries: the
leaves are flattened, cast to float32 and concatenated into one vector,
all-gathered once into a [D, n] buffer, and then combined over the ranks on
each rank: summed in rank order (`shard_allsum`: acc = row 0, then + row 1,
+ row 2, ...), taken from rank 0 (`shard_bcast0`), maxed (`shard_allmax`)
or concatenated (`shard_allgather`); then unpacked, integer leaves cast
back (exact below 2^24: they are point and match counts). Each result is
a tensor of its own, not a view of the gathered buffer.

Why an all-gather and an ordered sum, not `all_reduce`: the order in which
`all_reduce` adds is the backend's. Every rank must hold bit-identical
totals, or the Newton, line-search and ICP trip counts taken from them
diverge across ranks and the next collective deadlocks.

The transport is the group's (`parallel.distributed.Mesh`): NCCL gathers on
the card; gloo gathers host tensors, so a CUDA tensor under gloo is staged
through pinned host memory and copied back (several ranks that share one
card can only talk so). That staging is an explicit branch on the group's
backend, counted in `host_staged`; `collectives` counts every collective
executed. Both are plain counters, read and reset by callers.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# collectives executed, and those of them staged through host memory (gloo
# carrying a CUDA tensor), since the last reset
collectives = 0
host_staged = 0


def _flatten(tree, leaves: list):
    """The tensors of `tree` (a tensor, or tuples / lists / NamedTuples /
    dicts of them) in order, and a function that rebuilds the tree from a
    list of that length."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return lambda it: next(it)
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k], leaves) for k in keys]
        return lambda it: {k: p(it) for k, p in zip(keys, parts)}
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(x, leaves) for x in tree]
        if hasattr(tree, "_fields"):
            return lambda it: type(tree)(*(p(it) for p in parts))
        return lambda it: type(tree)(p(it) for p in parts)
    raise TypeError(f"a collective takes tensors, got {type(tree).__name__}")


def _gather_rows(flat: torch.Tensor, mesh) -> torch.Tensor:
    """[D, n] on `flat`'s device: row r is rank r's `flat` (one collective)."""
    global collectives, host_staged
    if flat.device != mesh.device:
        raise ValueError(f"the mesh's rank works on {mesh.device}, got a tensor on "
                         f"{flat.device}")
    flat = flat.contiguous()
    staged = mesh.backend == "gloo" and flat.device.type == "cuda"
    if staged:
        # gloo moves host memory only: through pinned buffers and back
        src = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        src.copy_(flat)
        rows = torch.empty((mesh.size, flat.numel()), dtype=flat.dtype, pin_memory=True)
    else:
        src = flat
        rows = torch.empty((mesh.size, flat.numel()), dtype=flat.dtype, device=flat.device)
    dist.all_gather(list(rows.unbind(0)), src, group=mesh.group)
    collectives += 1
    if staged:
        host_staged += 1
        rows = rows.to(flat.device, non_blocking=True)
    return rows


def _packed_rows(tree, mesh):
    """(leaves, rebuild, [D, n] rows of the packed float32 leaves, or of the
    one leaf in its own dtype)."""
    leaves: list = []
    rebuild = _flatten(tree, leaves)
    if not leaves:
        return leaves, rebuild, None
    if len(leaves) == 1:
        return leaves, rebuild, _gather_rows(leaves[0].reshape(-1), mesh)
    flat = torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in leaves])
    return leaves, rebuild, _gather_rows(flat, mesh)


def _unpack(vec: torch.Tensor, leaves, rebuild):
    out, off = [], 0
    for leaf in leaves:
        n = leaf.numel()
        out.append(vec[off:off + n].reshape(leaf.shape).to(leaf.dtype, copy=True))
        off += n
    return rebuild(iter(out))


def shard_allsum(tree, mesh):
    """Every rank's `tree` summed over the mesh by ONE packed all-gather, in
    rank order, so that every rank holds the same bits. Bit-identical to a
    per-leaf form: each element is the sum of the same D values in the same
    order."""
    leaves, rebuild, rows = _packed_rows(tree, mesh)
    if rows is None:
        return tree
    acc = rows[0]
    for r in range(1, mesh.size):
        acc = acc + rows[r]
    return _unpack(acc, leaves, rebuild)


def shard_bcast0(tree, mesh):
    """Rank 0's `tree` on every rank, by ONE packed all-gather."""
    leaves, rebuild, rows = _packed_rows(tree, mesh)
    if rows is None:
        return tree
    return _unpack(rows[0], leaves, rebuild)


def shard_allmax(tree, mesh):
    """The elementwise maximum of every rank's `tree`, by ONE packed
    all-gather (max is exact, so its order does not matter)."""
    leaves, rebuild, rows = _packed_rows(tree, mesh)
    if rows is None:
        return tree
    return _unpack(torch.amax(rows, dim=0), leaves, rebuild)


def shard_allgather(tree, mesh):
    """Every rank's leaves concatenated along their leading axis, rank 0's
    rows first, by ONE packed all-gather: a leaf [n, ...] on each rank
    becomes [D·n, ...] on every rank."""
    leaves, rebuild, rows = _packed_rows(tree, mesh)
    if rows is None:
        return tree
    out, off = [], 0
    for leaf in leaves:
        n = leaf.numel()
        part = rows[:, off:off + n].reshape((mesh.size * leaf.shape[0], *leaf.shape[1:]))
        out.append(part.to(leaf.dtype, copy=True))
        off += n
    return rebuild(iter(out))

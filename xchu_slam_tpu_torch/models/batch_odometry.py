"""Batched multi-sequence odometry (port of
`xchu_slam_tpu.models.batch_odometry`): B independent odometry states
stepped together, for fleet and offline-mapping work that maps several
sequences on one card.

The reference `vmap`s its jitted step over a leading sequence axis. Here a
batched `OdomState` carries a leading B axis on every leaf, and `batch_step`
runs the on-device step (`odometry.step(..., on_device=True)`, one NDT
kernel launch an align) for each member in turn on one stream: each
member's result is its single-sequence step's, bit for bit. The members do
not run concurrently: the NDT kernel is a cooperative launch of 128 blocks ×
512 threads at 8192 points with 128 registers a thread, so one block fills
an SM's registers and two members' launches cannot be resident at once.
"""

from __future__ import annotations

import torch

from xchu_slam_tpu_torch.models import odometry


def _stack(trees):
    """NamedTuples of tensors (nested) → one with a leading axis on every
    leaf."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    return type(first)(*(_stack(list(leaves)) for leaves in zip(*trees)))


def _member(tree, b: int):
    """Member b of a batched NamedTuple (views)."""
    if isinstance(tree, torch.Tensor):
        return tree[b]
    return type(tree)(*(_member(leaf, b) for leaf in tree))


def batch_init(spec: odometry.OdomSpec, init_poses, xyz, mask) -> odometry.OdomState:
    """init_poses [B,6], xyz [B,N,3], mask [B,N] → batched OdomState."""
    return _stack([odometry.init_state(spec, init_poses[b], xyz[b], mask[b])
                   for b in range(init_poses.shape[0])])


def batch_step(states: odometry.OdomState, xyz, mask, spec: odometry.OdomSpec):
    """One odometry step for every sequence in the batch, with nothing read
    back. states: batched OdomState (leading axis B on every leaf); xyz
    [B,N,3]; mask [B,N]. Returns (new_states, batched OdomOutput of
    tensors)."""
    outs = [odometry.step(_member(states, b), xyz[b], mask[b], spec, on_device=True)
            for b in range(xyz.shape[0])]
    return _stack([s for s, _ in outs]), _stack([o for _, o in outs])

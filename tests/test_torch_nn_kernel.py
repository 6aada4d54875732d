"""The nearest-neighbour kernel's host side on the CPU: the split of the work
that `nn_kernel.plan` chooses, and the plain version against the JAX
reference's XLA branch on the inputs that walk the split's edges (ties across
slices, ragged shapes, emptied slices)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nn_cases
from xchu_slam_tpu.ops import icp as jicp
from xchu_slam_tpu_torch.ops.cuda import nn_kernel as tnn

torch.set_num_threads(2)

SMS = 132
CASES = {name: (src[:384], tgt, mask) for name, src, tgt, mask
         in nn_cases.edge_cases(np.random.default_rng(7))}
EDGE_NAMES = ["duplicates across slices", "duplicates, first slice masked",
              "duplicates across sub-slices", "ragged 4100x16001",
              "N below one tile 50x16384", "M below one round 4096x20",
              "M below slices x round 4096x100", "M 700",
              "16 slices 1024x16384", "one slice left", "slices emptied",
              "all masked"]


@pytest.mark.parametrize("n,m,want", [
    (4096, 16384, (32, 4, 256)),     # the ICP shape: one block per SM
    (1024, 16384, (8, 16, 64)),      # few tiles: more slices
    (8192, 16384, (64, 2, 512)),
    (20000, 16384, (157, 1, 1024)),  # more tiles than SMs: no split
    (1000, 3000, (8, 2, 96)),        # M caps the slices; ragged both ways
    (4100, 16001, (33, 4, 256)),
    (50, 16384, (1, 16, 64)),        # N below one tile
    (4096, 20, (32, 1, 32)),         # M below one staging round
    (4096, 100, (32, 1, 32)),
    (4096, 700, (32, 1, 64)),
    (1, 1, (1, 1, 32)),
])
def test_plan_covers_the_targets(n, m, want):
    tiles, slices, sub_len = tnn.plan(n, m, SMS)
    assert (tiles, slices, sub_len) == want
    assert tiles * tnn.SRC_TILE >= n > (tiles - 1) * tnn.SRC_TILE
    assert slices * tnn.SUB_SLICES * sub_len >= m
    assert sub_len % tnn.ROUND == 0
    assert 1 <= slices <= tnn.MAX_SLICES
    if slices > 1:
        assert tiles * slices <= SMS
        assert m >= slices * tnn.SUB_SLICES * tnn.MIN_SUB_LEN


def test_plan_over_a_sweep_of_shapes():
    for n in (1, 127, 128, 129, 1000, 4096, 17000, 100000):
        for m in (1, 31, 33, 1023, 1024, 1025, 16384, 50000):
            for sms in (1, 16, 132):
                tiles, slices, sub_len = tnn.plan(n, m, sms)
                assert slices >= 1 and sub_len >= tnn.ROUND
                assert slices * tnn.SUB_SLICES * sub_len >= m
                # no slice is wholly past the end of the targets
                assert (slices - 1) * tnn.SUB_SLICES * sub_len < m


def test_plan_cuts_the_targets_in_index_order():
    """The sub-slices (slice by slice, warp by warp, as the kernel reads
    them) are consecutive ranges that cover [0, M) once: merging them in
    that order with a strict `<` is then one sequential scan."""
    for _name, (_src, tgt, _mask) in CASES.items():
        m = len(tgt)
        _tiles, slices, sub_len = tnn.plan(4096, m, SMS)
        at = 0
        for sub in range(slices * tnn.SUB_SLICES):
            lo, hi = min(m, sub * sub_len), min(m, (sub + 1) * sub_len)
            assert lo == at and hi >= lo
            at = hi
        assert at == m


@pytest.mark.parametrize("name", EDGE_NAMES)
def test_nearest_neighbor_ref_matches_xla_branch(name):
    """The plain version against the reference's XLA branch: d² to
    rtol = atol = 1e-4, and the picked d² equal to the brute-force minimum
    in float64 to 1e-4 (near-ties may pick another index, so distances are
    compared, not indices)."""
    src, tgt, mask = CASES[name]
    _nn, jd2 = jicp._nearest(jnp.asarray(src), jnp.ones(len(src), bool),
                             jnp.asarray(tgt), jnp.asarray(mask), 128)
    tidx, td2 = tnn.nearest_neighbor(torch.from_numpy(src), torch.from_numpy(tgt),
                                     torch.from_numpy(mask))
    tidx, td2 = tidx.numpy(), td2.numpy()
    np.testing.assert_allclose(td2, np.asarray(jd2), rtol=1e-4, atol=1e-4)
    if mask.any():
        assert mask[tidx].all()
        diff = src[:, None, :].astype(np.float64) - tgt[None, mask, :]
        np.testing.assert_allclose(td2, (diff * diff).sum(-1).min(1),
                                   rtol=1e-4, atol=1e-4)
    else:
        assert (tidx == 0).all() and (td2 == 1e30).all()

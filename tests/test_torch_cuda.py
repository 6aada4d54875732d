"""The port's CUDA kernel on the card: built from csrc/ with nvcc and held to
its plain PyTorch version and, bit for bit, to its first version (the
oracle entry `nn_launch_simple`). Marked `cuda`; without a card the tests skip
(the check runs inside the fixture, never at import). On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:xdist -o addopts=''
"""

import numpy as np
import pytest
import torch

import nn_cases
from xchu_slam_tpu_torch.ops import icp
from xchu_slam_tpu_torch.ops.cuda import nn_kernel

pytestmark = pytest.mark.cuda

EDGE_CASES = {name: arrays for name, *arrays
              in nn_cases.edge_cases(np.random.default_rng(7))}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,m,masked", [(4096, 16384, "none"), (1000, 3000, "none"),
                                        (1024, 4096, "stretch"), (1024, 2048, "one"),
                                        (1024, 2048, "all")])
def test_nn_kernel_matches_plain_version(cuda, n, m, masked):
    rng = np.random.default_rng(n + m)
    src = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32) * 30).to(cuda)
    tgt = torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32) * 30).to(cuda)
    mask = torch.ones(m, dtype=torch.bool, device=cuda)
    if masked == "stretch":
        mask[m // 3:m // 2] = False
    elif masked == "one":
        mask[:] = False
        mask[5] = True
    elif masked == "all":
        mask[:] = False
    before = nn_kernel.launches
    idx, d2 = nn_kernel.nearest_neighbor(src, tgt, mask)
    assert nn_kernel.launches == before + 1
    _, ref = nn_kernel.nearest_neighbor_ref(src, tgt, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(d2, ref, rtol=1e-4, atol=1e-4)
    if masked == "all":
        assert bool((idx == 0).all()) and bool((d2 == 1e30).all())
    else:
        assert bool(mask[idx.long()].all())


@pytest.mark.parametrize("name", [
    "4096x16384", "ragged 1000x3000", "masked stretch", "all but one masked",
    "all masked", "duplicates across slices", "duplicates, first slice masked",
    "duplicates across sub-slices", "ragged 4100x16001",
    "N below one tile 50x16384", "M below one round 4096x20",
    "M below slices x round 4096x100", "M 700", "16 slices 1024x16384",
    "one slice left", "slices emptied"])
def test_nn_kernel_is_bit_equal_to_its_first_version(cuda, name):
    """idx and d² of the kernel equal the one-scan-per-thread kernel's
    exactly: same arithmetic, ties at the lowest index across slices."""
    src, tgt, mask = (torch.from_numpy(a).to(cuda) for a in EDGE_CASES[name])
    before = nn_kernel.launches
    idx, d2 = nn_kernel.nearest_neighbor(src, tgt, mask)
    assert nn_kernel.launches == before + 1
    want_idx, want_d2 = nn_kernel._nearest_neighbor_simple(src, tgt, mask)
    assert nn_kernel.launches == before + 1  # the oracle is not counted
    _, ref = nn_kernel.nearest_neighbor_ref(src, tgt, mask)
    torch.cuda.synchronize()
    assert torch.equal(idx, want_idx) and torch.equal(d2, want_d2)
    torch.testing.assert_close(d2, ref, rtol=1e-4, atol=1e-4)
    if bool(mask.any()):
        assert bool(mask[idx.long()].all())
        # a tie keeps the lowest valid index among identical targets
        for i in range(0, src.shape[0], max(1, src.shape[0] // 16)):
            same = mask & (tgt == tgt[idx[i].long()]).all(-1)
            assert int(torch.nonzero(same)[0]) == int(idx[i])
    else:
        assert bool((idx == 0).all()) and bool((d2 == 1e30).all())


def test_nn_kernel_takes_only_what_it_checks(cuda):
    src = torch.zeros(8, 3, device=cuda)
    tgt = torch.zeros(64, 3, device=cuda)
    mask = torch.ones(64, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        nn_kernel.nearest_neighbor(src, tgt.T.contiguous().T, mask)
    with pytest.raises(ValueError):
        nn_kernel.nearest_neighbor(src, tgt.cpu(), mask)
    with pytest.raises(TypeError):
        nn_kernel.nearest_neighbor(src.double(), tgt, mask)


def test_icp_runs_the_kernel(cuda):
    rng = np.random.default_rng(0)
    tgt = torch.from_numpy(rng.uniform(-20, 20, (4096, 3)).astype(np.float32)).to(cuda)
    src = tgt[::4].contiguous() + 0.05
    before = nn_kernel.launches
    res = icp.align(src, torch.ones(1024, dtype=torch.bool, device=cuda), tgt,
                    torch.ones(4096, dtype=torch.bool, device=cuda),
                    torch.eye(4, device=cuda), icp.IcpSpec())
    assert nn_kernel.launches - before == res.iterations + 1
    assert res.converged and res.fitness < 1e-3

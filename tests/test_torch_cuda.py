"""The port's CUDA kernel on the card: built from csrc/ with nvcc and held to
its plain PyTorch version. Marked `cuda`; without a card the tests skip
(the check runs inside the fixture, never at import). On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:xdist
"""

import numpy as np
import pytest
import torch

from xchu_slam_tpu_torch.ops import icp
from xchu_slam_tpu_torch.ops.cuda import nn_kernel

pytestmark = pytest.mark.cuda


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

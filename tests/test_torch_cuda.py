"""The port's CUDA kernel on the card: built from csrc/ with nvcc and held to
its plain PyTorch version and, bit for bit, to its first version (the
oracle entry `nn_launch_simple`); and the card-side code of the mapping
session (ISC scoring, the map export's batched transform, a checkpoint
loaded onto the card) against the same functions on the CPU. Marked `cuda`;
without a card the tests skip (the check runs inside the fixture, never at
import). On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:xdist -o addopts=''
"""

import numpy as np
import pytest
import torch

import nn_cases
from xchu_slam_tpu_torch import config as tconfig
from xchu_slam_tpu_torch.models import pipeline as tpipe
from xchu_slam_tpu_torch.ops import icp, isc
from xchu_slam_tpu_torch.utils import checkpoint as tckpt
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


def _isc_store(rng, K=300, live=260):
    """A store of sparse polar images (about a tenth of the cells lit), with
    rows 200.. near-copies of rows 0.. shifted by a few sectors."""
    db = (rng.random((K, 60, 60)) < 0.1) * rng.random((K, 60, 60))
    db[200:live] = np.roll(db[:live - 200], 7, axis=2) * (rng.random((live - 200, 60, 60)) < 0.97)
    db[live:] = 0.0
    return db.astype(np.float32)


def test_isc_scores_on_the_card_match_the_cpu(cuda):
    """Geometry scores and shifts equal bit for bit (0/1 sums), intensity
    scores within 1e-6, the detected loop the same, at a store larger than
    one scoring chunk."""
    rng = np.random.default_rng(5)
    db = torch.from_numpy(_isc_store(rng))
    spec = isc.IscSpec()
    q = db[259]
    geo_c, sh_c = isc.geometry_scores(q, db, spec)
    geo_g, sh_g = isc.geometry_scores(q.to(cuda), db.to(cuda), spec)
    assert torch.equal(geo_g.cpu(), geo_c) and torch.equal(sh_g.cpu(), sh_c)
    in_c = isc.intensity_scores(q, db, sh_c, spec)
    in_g = isc.intensity_scores(q.to(cuda), db.to(cuda), sh_g, spec)
    torch.testing.assert_close(in_g.cpu(), in_c, rtol=0, atol=1e-6)
    pos = torch.zeros(300, 3)
    travel = torch.arange(300, dtype=torch.float32) * 2.0
    loop_c = isc.detect_loop(q, db, 260, pos, travel, spec)
    loop_g = isc.detect_loop(q.to(cuda), db.to(cuda), 260, pos.to(cuda), travel.to(cuda), spec)
    assert loop_c.found and loop_c.idx == 59
    assert (loop_g.idx, loop_g.found, loop_g.yaw) == (loop_c.idx, loop_c.found, loop_c.yaw)
    assert abs(loop_g.score - loop_c.score) <= 1e-5
    xyz = torch.from_numpy(rng.normal(size=(8192, 3)).astype(np.float32) * [15, 15, 2])
    inten = torch.from_numpy(rng.random(8192).astype(np.float32))
    mask = torch.from_numpy(rng.random(8192) > 0.2)
    assert torch.equal(isc.make_descriptor(xyz.to(cuda), inten.to(cuda), mask.to(cuda), spec).cpu(),
                       isc.make_descriptor(xyz, inten, mask, spec))


def _filled_pipeline(rng, device):
    cfg = tconfig.SlamConfig(pgo=tconfig.PgoConfig(max_keyframes=64, max_loops=8))
    pipe = tpipe.SlamPipeline(cfg, kf_points=1024, device=device)
    n = 40
    pipe.db.opt_poses[:n] = torch.from_numpy(
        (rng.normal(size=(n, 6)) * [40, 40, 1, 0.02, 0.02, 2]).astype(np.float32))
    pipe.db.clouds[:n] = torch.from_numpy(
        (rng.normal(size=(n, 1024, 3)) * [20, 20, 2]).astype(np.float32))
    pipe.db.cloud_mask[:n] = torch.from_numpy(rng.random((n, 1024)) > 0.3)
    pipe.db = pipe.db._replace(count=n)
    pipe.kf_count = n
    return pipe


def test_map_export_transform_on_the_card_matches_the_cpu(cuda):
    """`assemble_map`'s batched transform and masked readback: every point
    within 1e-4 of the CPU's, the same count."""
    on_cpu = _filled_pipeline(np.random.default_rng(6), "cpu").assemble_map(voxel=0.0)
    on_card = _filled_pipeline(np.random.default_rng(6), cuda).assemble_map(voxel=0.0)
    assert on_card.shape == on_cpu.shape and len(on_cpu) > 20_000
    np.testing.assert_allclose(on_card, on_cpu, rtol=0, atol=1e-4)


def test_checkpoint_loads_onto_the_card(cuda, tmp_path):
    pipe = _filled_pipeline(np.random.default_rng(7), cuda)
    path = str(tmp_path / "ckpt.npz")
    tckpt.save_checkpoint(pipe, path)
    back = tckpt.load_checkpoint(path)          # the default device is the card
    assert back.device.type == "cuda" and back.db.clouds.is_cuda and back.kf_count == 40
    for a, b in zip(back.db[:-1] + back.graph, pipe.db[:-1] + pipe.graph):
        assert torch.equal(a, b)

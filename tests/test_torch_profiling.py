"""The port's device traces (`utils/profiling.py::device_trace`,
`block_on`), on the CPU: a torch.profiler scope around host-engine scans
writes a Chrome trace that names the scans' operations. On the card the same
scope also records the kernels (`chip_smoke.py` phase 12 checks that the
trace names the NDT and NN kernels)."""

import json
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from xchu_slam_tpu_torch import config as tconfig
from xchu_slam_tpu_torch.models import pipeline as tpipe
from xchu_slam_tpu_torch.utils import profiling, sim

torch.set_num_threads(2)


def _scans(n):
    world = sim.make_world(5, extent=40.0, ground_pts=30_000)
    rng = np.random.default_rng(5)
    return [sim.render_scan(world, p, rng, n_points=4000)
            for p in sim.loop_trajectory(n, radius=10.0, speed=1.0)]


def _names(path):
    with open(path) as f:
        return [e.get("name", "") for e in json.load(f)["traceEvents"]]


def test_device_trace_of_host_engine_scans(tmp_path):
    """Two traced scans after two untraced ones: the trace is written to
    `trace.json`, names the NDT passes' and the filter's operations, and a
    second trace into the same directory replaces the first."""
    pipe = tpipe.SlamPipeline(tconfig.tiny_config(), kf_points=512, device="cpu")
    scans = _scans(5)
    for i, (xyz, inten) in enumerate(scans[:2]):
        pipe.process_scan(xyz, inten, stamp=0.1 * i)
    with profiling.device_trace(str(tmp_path), device="cpu") as prof:
        for i, (xyz, inten) in enumerate(scans[2:4], start=2):
            pipe.process_scan(xyz, inten, stamp=0.1 * i)
    path = tmp_path / profiling.TRACE_FILE
    names = _names(path)
    assert sum(n.startswith("aten::") for n in names) > 100
    assert "aten::index_put_" in names and "aten::matmul" in names
    assert any(e.key.startswith("aten::") for e in prof.key_averages())
    first = os.path.getsize(path)
    with profiling.device_trace(str(tmp_path), device="cpu"):
        torch.ones(3).sum()
    assert os.path.getsize(path) < first
    assert sorted(os.listdir(tmp_path)) == [profiling.TRACE_FILE]


class _Pair(NamedTuple):
    a: torch.Tensor
    b: list


def test_block_on_returns_its_structure():
    tree = {"x": torch.ones(2), "y": [_Pair(torch.zeros(3), [torch.arange(4), 5]), None]}
    assert profiling.block_on(tree) is tree


def test_device_trace_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.device_trace(str(tmp_path)):
            pass

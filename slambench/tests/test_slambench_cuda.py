"""A short run of every cell on the card: the command's last line, correct;
and a short run of the sensor-fusion deployment through the harness. Marked
`cuda`; each decides inside the test whether there is a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from slambench import harness

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs on the card")
    out = subprocess.run([sys.executable, "slambench/run.py", "--workload", name, "--seed",
                          "2147483659", "--seconds", "10", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_fusion_deployment_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs on the card")
    out = subprocess.run([sys.executable, "slambench/fusion_run.py", "--seed", "2147483661",
                          "--seconds", "10"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["numbers"]
    assert res["counters"]["guess"] > 0 and res["gps_keyframes"] > 0
    assert res["counts"]["retrievals_found"] > 0 and res["counts"]["verifications"] > 0

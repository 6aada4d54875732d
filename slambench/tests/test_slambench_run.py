"""The command's contract on a machine without a card, and the last line's
keys from a run at the tests' size on the CPU."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from slambench import harness
from slambench.tests import tiny

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


def _command(cwd, *args):
    return subprocess.run([sys.executable, "slambench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _command(harness.ROOT, "--workload", "sim_circuit_sc.segments", "--seed",
                   "4294967297", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.SB, tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path, "--workload", "sim_circuit_sc.laps", "--seed", "1",
                   "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""


# session 0 runs whole and the window closes with it, so a loaded CPU,
# on which a tiny chunk can outlast a short window, still counts its scans
@pytest.fixture(scope="module")
def traced():
    return tiny.run(tiny.cell(), seconds=3.0, trace=True, whole=True)


@pytest.fixture(scope="module")
def untraced():
    return tiny.run(tiny.cell(), seconds=3.0, whole=True)


def test_last_line_keys(untraced, traced):
    for out, extra in ((untraced, []), (traced, ["breakdown"])):
        res = out["result"]
        keys = list(res)
        assert keys[-1] == "check", "the compared numbers come last"
        assert sorted(keys) == sorted(RESULT_KEYS + extra)
        json.loads(json.dumps(res))
        for item in res["check"].values():
            assert set(item) >= {"value", "limit"}
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])


def test_end_to_end_metrics_are_the_cells(untraced):
    res = untraced["result"]
    assert set(res["metrics"]) <= {"scans_per_s", "chunk_latency_p95_ms", "setup_s"}
    assert res["metrics"]["setup_s"]["value"] > 0 and res["metrics"]["scans_per_s"]["value"] > 0
    assert res["correct"], res["check"]


def test_traced_run_reads_per_layer_metrics(traced):
    res = traced["result"]
    assert {"stage_wait_ms", "readback_wait_ms", "newton_iters",
            "session_start_ms"} <= set(res["metrics"])
    assert "device_busy_ms" not in res["metrics"], "the CPU gives no device time"
    assert "scans_per_s" not in res["metrics"]
    assert res["correct"], res["check"]

"""The sensor-fusion deployment (ISC loops, the IMU and wheel guess, GPS
altitudes) through the harness at the tests' size on the CPU: the feeds
reach the program, the check passes the sound program, and it fails it
where a feed or an answer is broken: IMU windows a scan late, altitudes a
metre high, an ISC candidate altered; and the tool that runs it on the
card, which prints no result where a JAX module was loaded."""

from __future__ import annotations

import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from slambench import fusion_run, harness
from slambench.tests import tiny


@pytest.mark.parametrize("loaded", [[], ["jax"], ["xchu_slam_tpu.models"]])
def test_the_tool_prints_no_result_after_jax(loaded, monkeypatch, capsys):
    import torch

    for name in [m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    for name in loaded:
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(fusion_run, "fusion_run", lambda *a, **k: {"correct": True})
    rc = fusion_run.main(["--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    if loaded:
        assert rc == 3 and out.out.strip() == ""
        assert loaded[0].split(".")[0] in out.err
    else:
        assert rc == 0 and out.out.strip() == '{"correct": true}'


def test_the_tool_alone_prints_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.SB, tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "slambench/fusion_run.py", "--seed", "1",
                          "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""



@pytest.fixture(scope="module")
def cell():
    return tiny.cell("sim_circuit_sc.laps", fusion=True)


@pytest.fixture(scope="module")
def lap(cell):
    from slambench.gen import drive

    return drive.render_lap_inline(cell.config, 20261018)


@pytest.fixture(scope="module")
def sound(cell, lap):
    """A sound run, every `process_chunk` call's keyword arguments kept."""
    from xchu_slam_tpu_torch.models.device_pipeline import DeviceSlamPipeline

    real = DeviceSlamPipeline.process_chunk
    calls = []

    def kept(self, clouds, stamps, n_real, **kw):
        calls.append(kw)
        return real(self, clouds, stamps, n_real, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DeviceSlamPipeline, "process_chunk", kept)
        out = tiny.run(cell, lap=lap, whole=True)
    return out, calls


def _feeds_altered(monkeypatch, change):
    real = harness.Driver.feed_args

    def altered(self, idx):
        return change(self, idx, real(self, idx))

    monkeypatch.setattr(harness.Driver, "feed_args", altered)


def test_all_modes_run_is_correct(sound):
    out, _calls = sound
    assert out["result"]["correct"], out["result"]["check"]
    assert out["verdict"]["counts"]["scans"] == 168, "session 0 is two laps of 84 scans"


def test_the_program_received_the_feeds(sound):
    out, calls = sound
    rec = out["ctx"]["sessions"][0].record
    assert int(np.sum(rec["gps_mask"])) > 0, "no keyframe stored a GPS fix"
    assert out["verdict"]["info"]["gps_keyframes"] == int(np.sum(rec["gps_mask"]))
    assert calls and all(set(kw) == {"gps_alts", "wins"} and kw["wins"].imu is not None
                         and kw["wins"].wheel is not None for kw in calls)
    assert all(kw["wins"].imu.mask.shape == (16, 16) for kw in calls)


def test_isc_detects_on_the_second_lap(sound):
    out, _calls = sound
    v = out["verdict"]
    assert v["counts"]["retrievals_found"] >= 1 and v["counts"]["verifications"] >= 1
    assert v["info"]["detections"] > 0 and v["info"]["icp_runs"] > 0


def test_imu_windows_a_scan_late(cell, lap, monkeypatch):
    from xchu_slam_tpu_torch.models.device_pipeline import GuessWindows
    from xchu_slam_tpu_torch.ops.imu import ImuWindow

    def late(drv, idx, kw):
        prev = np.maximum(idx - 1, 0)
        return dict(kw, wins=GuessWindows(imu=ImuWindow(*(a[prev] for a in drv.feeds.imu)),
                                          wheel=kw["wins"].wheel))

    _feeds_altered(monkeypatch, late)
    out = tiny.run(cell, lap=lap, whole=True)
    check = out["result"]["check"]
    assert not out["result"]["correct"]
    assert not (check["ndt_pose_gap_m"]["ok"] and check["ndt_iter_mismatch"]["ok"]), check


def test_altitudes_a_metre_high(cell, lap, monkeypatch):
    _feeds_altered(monkeypatch, lambda drv, idx, kw: dict(kw, gps_alts=kw["gps_alts"] + 1.0))
    out = tiny.run(cell, lap=lap, whole=True)
    assert not out["result"]["correct"]
    assert not out["result"]["check"]["gps_mismatch"]["ok"]


def test_isc_candidate_altered(cell, lap, monkeypatch):
    real = harness._session_record

    def altered(s, samples_kf=None):
        rec = real(s, samples_kf)
        rows = rec["rows"]
        kf = np.nonzero(rows[:, 9] > 0.5)[0]
        for k, i in enumerate(kf):
            if rows[i, 12] > 0.5:            # a found retrieval: another older keyframe
                rows[i, 11] = (rows[i, 11] + 3) % k
        return rec

    monkeypatch.setattr(harness, "_session_record", altered)
    out = tiny.run(cell, lap=lap, whole=True)
    assert not out["result"]["correct"]
    assert not out["result"]["check"]["sc_mismatch"]["ok"], out["result"]["check"]

"""The check, driven end to end at the tests' size on the CPU (the look for a
card skipped), passes the sound program and fails it with the timed path
broken underneath: a step that returns its state unchanged, half of every
chunk left out, an answer altered where it is produced. (A cell on one card
has no exchange between cards to leave out.) And the control, the reference
in TF32 in the program's place, fails the limits."""

from __future__ import annotations

import pytest
import torch

from slambench.tests import tiny


@pytest.fixture(scope="module")
def cell():
    return tiny.cell()


@pytest.fixture(scope="module")
def lap(cell):
    from slambench.gen import drive

    return drive.render_lap_inline(cell.config, 20261018)


def test_sound_run_is_correct(cell, lap):
    out = tiny.run(cell, lap=lap)
    assert out["result"]["correct"], out["result"]["check"]


def test_state_left_unchanged(cell, lap, monkeypatch):
    from xchu_slam_tpu_torch.models import odometry

    real = odometry.step

    def frozen(state, *a, **k):
        _new, out = real(state, *a, **k)
        return state, out._replace(pose=state.pose)

    monkeypatch.setattr(odometry, "step", frozen)
    out = tiny.run(cell, lap=lap)
    assert not out["result"]["correct"]


def test_half_of_each_chunk_left_out(cell, lap, monkeypatch):
    from xchu_slam_tpu_torch.models.device_pipeline import DeviceSlamPipeline

    real = DeviceSlamPipeline.process_chunk

    def half(self, clouds, stamps, n_real, *a, **k):
        return real(self, clouds, stamps, max(1, n_real // 2), *a, **k)

    monkeypatch.setattr(DeviceSlamPipeline, "process_chunk", half)
    out = tiny.run(cell, lap=lap)
    assert not out["result"]["correct"]
    assert out["result"]["check"]["scans_missing"]["value"] > 0


def test_pose_altered_where_it_is_produced(cell, lap, monkeypatch):
    from xchu_slam_tpu_torch.ops import ndt

    real = ndt.align

    def shifted(*a, **k):
        res = real(*a, **k)
        return res._replace(pose=res.pose + torch.tensor([0.02, 0, 0, 0, 0, 0],
                                                          dtype=res.pose.dtype))

    monkeypatch.setattr(ndt, "align", shifted)
    out = tiny.run(cell, lap=lap)
    assert not out["result"]["correct"]
    assert not out["result"]["check"]["ndt_pose_gap_m"]["ok"]


def test_control_fails_the_limits(cell, lap):
    out = tiny.run(cell, lap=lap, mode="control")
    assert out["result"]["correct"], out["result"]["check"]
    assert out["verdict"]["control"]["fails"], out["verdict"]["control"]["numbers"]

"""The device engine's spans on the CPU (`DeviceSlamPipeline.spans`,
`stage_seconds`): the keys by span name, Part B's stages inside `part_b`,
the three keys the benchmark's first readers read equal to the sums of
their spans' records, results bit-identical with and without a recording, and
`run-sim --engine device --trace-chunks A:B`."""

import json

import numpy as np
import pytest
import torch

from xchu_slam_tpu_torch import cli, config as tconfig
from xchu_slam_tpu_torch.io import prefetch as tprefetch
from xchu_slam_tpu_torch.models import device_pipeline as tdp
from xchu_slam_tpu_torch.utils import profiling, sim

torch.set_num_threads(2)

OVERRIDES = {
    "filter.max_raw_points": 8192, "filter.max_points": 4096,
    "filter.outlier_method": "statistical",
    "ndt.grid_x": 48, "ndt.grid_y": 48, "ndt.grid_z": 16,
    "pgo.max_keyframes": 64, "pgo.max_loops": 8,
    "loop.method": "radius", "loop.radius_search": 12.0, "loop.min_time_diff": 0.5,
    "loop.detect_period": 1, "loop.submap_points": 2048, "loop.submap_half_width": 4,
    "loop.icp_fitness_thresh": 1.5, "loop.max_correction": 5.0,
}
CAP = OVERRIDES["filter.max_raw_points"]
HOST_SPANS = {"chunk", "session.seed", "part_a_enqueue", "part_a.eager", "readback_wait",
              "part_b", "part_b.store", "part_b.retrieve", "part_b.verify", "part_b.solve",
              "finalize", "finalize.solve", "finalize.readback"}


def _run(scans, record: bool):
    pipe = tdp.DeviceSlamPipeline(tconfig.default_config().override(OVERRIDES),
                                  kf_points=512, log_capacity=64, device="cpu")
    rec = None
    with tprefetch.DeviceChunkPrefetcher(scans, capacity=CAP, chunk=8, depth=2, threads=2,
                                         device="cpu") as pf:
        if record:
            with profiling.recording() as rec:
                base = 0
                for clouds, n_real in pf:
                    pipe.process_chunk(clouds, 0.1 * (base + np.arange(8)), n_real)
                    base += n_real
                pipe.finalize()
        else:
            base = 0
            for clouds, n_real in pf:
                pipe.process_chunk(clouds, 0.1 * (base + np.arange(8)), n_real)
                base += n_real
            pipe.finalize()
    return pipe, rec


@pytest.fixture(scope="module")
def runs():
    """24 scans along a 15 m circuit in chunks of 8, detecting at every
    keyframe: without and with a recording."""
    world = sim.make_world(4, extent=50.0, ground_pts=40_000)
    gt = sim.loop_trajectory(24, radius=15.0, speed=1.0)
    rng = np.random.default_rng(4)
    scans = [sim.render_scan(world, p, rng, n_points=6000) for p in gt]
    return _run(scans, False), _run(scans, True)


def test_stage_seconds_hold_every_span_by_name(runs):
    (pipe, _), _ = runs
    st = pipe.stage_seconds
    assert HOST_SPANS <= set(st), HOST_SPANS - set(st)
    assert {f"self.{k}" for k in HOST_SPANS} <= set(st)
    assert not any(k.startswith("device.") for k in st), "the CPU samples no device phase"
    assert all(np.isfinite(v) and v >= 0 for v in st.values())
    c = pipe.spans.counts
    assert c["chunk"] == 3 and c["session.seed"] == 1 and c["readback_wait"] == 3
    assert c["part_a.eager"] == 23, "the CPU engine runs Part A eagerly, a scan each"
    assert c["part_b.store"] == pipe.kf_count - 1, "keyframe 0 is the seed's"
    assert c["part_b.retrieve"] == c["part_b.verify"] == c["part_b.solve"] >= 1
    assert pipe.icp_verifications >= 1
    assert c["finalize"] == c["finalize.solve"] == c["finalize.readback"] == 1


def test_part_b_stages_lie_inside_part_b(runs):
    (pipe, _), _ = runs
    st = pipe.stage_seconds
    stages = st["part_b.store"] + st["part_b.retrieve"] + st["part_b.verify"]
    assert stages <= st["part_b"]
    assert st["part_b.solve"] <= st["part_b.verify"]
    assert st["self.part_b.verify"] == pytest.approx(st["part_b.verify"] - st["part_b.solve"],
                                                    abs=1e-9)
    assert st["self.part_b"] == pytest.approx(st["part_b"] - stages, abs=1e-9)
    assert st["part_a.eager"] <= st["part_a_enqueue"]
    assert st["part_a_enqueue"] + st["readback_wait"] + st["part_b"] + st["session.seed"] \
        <= st["chunk"]


def test_old_keys_are_the_sums_of_their_spans(runs):
    """`part_a_enqueue`, `readback_wait` and `part_b`, which the benchmark's
    readers read, are the sums of their spans' durations in a recording,
    and every record of a chunk carries that chunk's id."""
    _, (pipe, rec) = runs
    st = pipe.stage_seconds
    assert rec.dropped == 0
    for key in tdp.OLD_STAGES + ("chunk", "part_b.verify"):
        spans = [r for r in rec.records if r.name == key]
        assert len(spans) == pipe.spans.counts[key]
        assert st[key] == pytest.approx(1e-9 * sum(r.end_ns - r.start_ns for r in spans),
                                        rel=1e-9, abs=1e-9)
    chunks = [r for r in rec.records if r.name == "chunk"]
    assert [r.chunk for r in chunks] == [(pipe.serial, i) for i in range(3)]
    by_id = {r.id: r for r in rec.records}
    for r in rec.records:
        if r.name in ("part_b.store", "part_b.retrieve", "part_b.verify"):
            assert by_id[r.parent].name == "part_b" and r.chunk == by_id[r.parent].chunk
        if r.name == "part_b.solve":
            assert by_id[r.parent].name == "part_b.verify"
    stage = [r for r in rec.records if r.name.startswith("stage.")]
    assert {r.name for r in stage} >= {"stage.job", "stage.read", "stage.fill",
                                       "stage.upload", "stage.wait"}
    assert all(r.name not in pipe.spans.counts for r in stage), "timeline only"
    assert all(r.device_ms is None for r in rec.records), "no timing events on the CPU"


def _log_rows(pipe) -> np.ndarray:
    return np.array([[*r["pose"], *(float(v) for k, v in r.items() if k != "pose")]
                     for r in pipe.odom_log])


def test_recording_leaves_results_bit_identical(runs):
    (plain, _), (recorded, _) = runs
    assert np.array_equal(plain.odometry_trajectory(), recorded.odometry_trajectory())
    for a, b in zip(plain.keyframe_trajectory(), recorded.keyframe_trajectory()):
        assert np.array_equal(a, b)
    assert np.array_equal(_log_rows(plain), _log_rows(recorded))
    assert (plain.kf_count, plain.loop_count, plain.icp_verifications) == \
        (recorded.kf_count, recorded.loop_count, recorded.icp_verifications)


SMALL = ["--set", "filter.max_points=4096", "--set", "pgo.max_keyframes=64",
         "--set", "loop.submap_points=4096"]


def test_cli_traces_chunks_with_the_program_tracks(tmp_path, capsys):
    cli.main(["run-sim", "--scans", "16", "--radius", "20", "--device", "cpu",
              "--engine", "device", "--chunk", "4", "--loop-method", "radius",
              "--trace-chunks", "1:3", "--out", str(tmp_path), *SMALL])
    summary = json.loads(capsys.readouterr().out)
    att = summary["chunk_attribution"]
    assert att["chunks"] == 4 and set(att) == {"chunks", "p50_ms", "mean_wait_ms",
                                              "mean_dispatch_ms"}
    assert set(summary["part_b_stages"]) <= set(cli.PART_B_STAGES)
    assert summary["part_b_stages"]["part_b.store"]["count"] == summary["keyframes"] - 1
    tr = summary["trace"]
    assert tr["chunks"] == [1, 3] and tr["dropped"] == 0 and tr["spans"] > 10
    assert tr["idle_s"] == 0.0 and tr["idle_by_span"] == {}, "the CPU has no device activity"
    doc = json.loads((tmp_path / "trace.json").read_text())
    ours = [e for e in doc["traceEvents"] if e.get("cat") == "program_span"]
    chunks = sorted(tuple(e["args"]["chunk"]) for e in ours if e["name"] == "chunk")
    assert [c[1] for c in chunks] == [1, 2]
    assert {"part_a_enqueue", "readback_wait", "part_b", "stage.wait"} <= \
        {e["name"] for e in ours}
    assert any(e["name"].startswith("aten::") for e in doc["traceEvents"])


@pytest.mark.parametrize("flags", [["--trace-chunks", "2:2"], ["--trace-chunks", "x"],
                                   ["--trace-chunks", "0:1", "--engine", "host"]])
def test_cli_refuses_trace_chunks_it_cannot_trace(flags, capsys):
    argv = ["run-sim", "--scans", "4", "--device", "cpu", *flags]
    if "--engine" not in flags:
        argv += ["--engine", "device"]
    with pytest.raises(SystemExit) as err:
        cli.main(argv)
    assert err.value.code == 2
    assert "--trace-chunks" in capsys.readouterr().err

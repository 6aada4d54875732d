"""The port's device traces and program spans (`utils/profiling.py`), on
the CPU: a torch.profiler scope around host-engine scans writes a Chrome
trace that names the scans' operations (on the card the same scope also
records the kernels: `chip_smoke.py` phase 12 checks that the trace names
the NDT and NN kernels); an owner's spans nest, keep self time and counts;
a recording's ring keeps the newest records and counts the dropped; outside
a recording nothing is kept; a span lands on the profiler's clock; the
card's idle time is split exactly among the feeding thread's spans."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import record_function

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
    with profiling.device_trace(str(tmp_path), device="cpu") as tr:
        for i, (xyz, inten) in enumerate(scans[2:4], start=2):
            pipe.process_scan(xyz, inten, stamp=0.1 * i)
    path = tmp_path / profiling.TRACE_FILE
    names = _names(path)
    assert sum(n.startswith("aten::") for n in names) > 100
    assert "aten::index_put_" in names and "aten::matmul" in names
    assert any(e.key.startswith("aten::") for e in tr.prof.key_averages())
    first = os.path.getsize(path)
    with profiling.device_trace(str(tmp_path), device="cpu"):
        torch.ones(3).sum()
    assert os.path.getsize(path) < first
    assert sorted(os.listdir(tmp_path)) == [profiling.TRACE_FILE]


def test_device_trace_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.device_trace(str(tmp_path)):
            pass


# ------------------------------------------------------------------ spans -- #
def _busy(seconds: float) -> None:
    t = time.perf_counter() + seconds
    while time.perf_counter() < t:
        pass


def test_spans_nest_and_keep_self_time():
    """A span's self time is its duration less what its children cover; a
    child's time counts in its own name and in its parent's inclusive time."""
    sp = profiling.Spans()
    with sp.span("outer"):
        _busy(0.002)
        with sp.span("a"):
            _busy(0.003)
        with sp.span("b"):
            with sp.span("a"):
                _busy(0.001)
    t = sp.totals()
    assert t["outer"] >= t["a"] + t["self.b"] + 0.002
    assert t["self.outer"] == pytest.approx(t["outer"] - t["a"] - t["self.b"], abs=1e-9)
    assert t["self.a"] == t["a"] >= 0.004
    assert t["b"] > 0.001 and t["self.b"] < t["b"]


def test_span_counts_count_each_block():
    sp = profiling.Spans()
    for _ in range(3):
        with sp.span("x"):
            with sp.span("y"):
                pass
            with sp.span("y"):
                pass
    assert dict(sp.counts) == {"x": 3, "y": 6}
    with pytest.raises(ValueError):
        with sp.span("z"):
            raise ValueError("a span closes on an exception")
    assert sp.counts["z"] == 1 and "self.z" in sp.totals()


def test_recording_ring_keeps_the_newest_and_counts_the_dropped():
    sp = profiling.Spans()
    sp.chunk = (7, 2)
    with profiling.recording(capacity=5) as rec:
        with sp.span("parent"):
            for i in range(11):
                with sp.span(f"c{i}"):
                    pass
    assert rec.added == 12 and rec.dropped == 7 and len(rec.records) == 5
    names = [r.name for r in rec.records]
    assert names == ["c7", "c8", "c9", "c10", "parent"]
    parent = rec.records[-1]
    assert all(r.parent == parent.id and r.chunk == (7, 2) for r in list(rec.records)[:-1])
    assert parent.parent is None
    assert all(r.start_ns <= r.end_ns and r.thread == threading.get_native_id()
               for r in rec.records)
    assert rec.records[0].start_ns >= parent.start_ns and parent.end_ns >= rec.records[-2].end_ns


def test_without_a_recording_only_totals_are_kept():
    """Outside `recording()` no record is kept and a device span makes no
    CUDA call (on this machine one would raise); a recording sees only its
    own spans, and a second one at a time is refused."""
    sp = profiling.Spans(cuda=True)
    with sp.span("before", device=True):
        pass
    assert profiling.active_recording() is None
    assert sp.counts["before"] == 1
    with profiling.recording() as rec:
        assert profiling.active_recording() is rec
        with pytest.raises(RuntimeError, match="already"):
            with profiling.recording():
                pass
        with profiling.timeline("inside"):
            pass
    with sp.span("after", device=True), profiling.timeline("after.timeline"):
        pass
    assert [r.name for r in rec.records] == ["inside"] and rec.dropped == 0
    assert profiling.active_recording() is None
    assert sp.counts == {"before": 1, "after": 1}
    assert "inside" not in sp.totals()


def test_timeline_spans_take_the_chunk_of_their_parent():
    with profiling.recording() as rec:
        with profiling.timeline("job", chunk=3):
            with profiling.timeline("fill"):
                pass
        with profiling.timeline("alone"):
            pass
    chunks = {r.name: r.chunk for r in rec.records}
    assert chunks == {"fill": 3, "job": 3, "alone": None}


def test_a_span_lands_on_its_record_function_marker(tmp_path):
    """The clock: a span around a `record_function` marker, converted through
    the recording's (perf_counter, epoch) pair and the trace's start, lands
    on the marker's interval within 0.2 ms, and the trace file holds it."""
    sp = profiling.Spans()
    with profiling.device_trace(str(tmp_path), device="cpu") as tr:
        with record_function("warm"):
            torch.ones(4).sum()
        with sp.span("around"):
            with record_function("marker"):
                _busy(0.005)
    marker = next(e for e in tr.prof.events() if e.name == "marker")
    a, b, _, rec = next(s for s in tr.spans if s[2] == "around")
    assert abs(a - marker.time_range.start) <= 200.0
    assert abs(b - marker.time_range.end) <= 200.0
    assert rec.end_ns - rec.start_ns >= 5_000_000
    doc = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    ours = [e for e in doc["traceEvents"] if e.get("cat") == "program_span"]
    assert [e["name"] for e in ours] == ["around"]
    mark = next(e for e in doc["traceEvents"] if e.get("name") == "marker"
                and e.get("ph") == "X")
    assert abs(ours[0]["ts"] - mark["ts"]) <= 200.0
    assert tr.idle_s == 0.0 and tr.idle_by_span == {}


IDLE_CASES = {
    # device intervals, one thread's spans, the split
    "exact": ([(0, 1), (3, 4), (6, 7)],
              [(0, 10, "chunk"), (0.5, 2.5, "part_a"), (3.5, 5.0, "readback")],
              {"part_a": 1.5, "chunk": 1.5, "readback": 1.0, "outside": 0.0}),
    "outside": ([(0, 1), (3, 4), (6, 7)], [(1.5, 2.0, "part_b")],
                {"part_b": 0.5, "outside": 3.5}),
    "overlapping": ([(0, 2), (1, 3), (5, 6), (5.5, 5.8)], [(2.5, 4.0, "a"), (4.0, 9.0, "b")],
                    {"a": 1.0, "b": 1.0, "outside": 0.0}),
}


@pytest.mark.parametrize("case", sorted(IDLE_CASES))
def test_idle_by_span_splits_each_gap_exactly(case):
    intervals, spans, want = IDLE_CASES[case]
    got = profiling.idle_by_span(intervals, spans)
    assert got == pytest.approx(want)
    total = sum(b - a for a, b in profiling.idle_gaps(intervals))
    assert sum(got.values()) == pytest.approx(total)


def test_innermost_segments_of_nested_spans():
    segs = profiling.innermost([(0, 10, "c"), (1, 4, "a"), (2, 3, "r"), (4, 6, "b"),
                                (7, 8, "d")])
    assert segs == [(0, 1, "c"), (1, 2, "a"), (2, 3, "r"), (3, 4, "a"), (4, 6, "b"),
                    (6, 7, "c"), (7, 8, "d"), (8, 10, "c")]

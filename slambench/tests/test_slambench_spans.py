"""The readers of the program's spans (`metrics/part_b_*`, `part_a_*`):
after a run at the tests' size on the CPU the host readers read finite
values and the device readers None (the CPU samples no device phase); on
sessions whose `stage_seconds` lack the spans' keys, as a program before
the spans has them, every one reads None and none raises."""

from __future__ import annotations

import math

import pytest

from slambench import harness
from slambench.tests import tiny

HOST = ["part_b_store_ms", "part_b_retrieve_ms", "part_b_verify_ms", "part_b_solve_ms",
        "part_a_start_ms"]
DEVICE = ["part_a_filter_dev_ms", "part_a_align_dev_ms", "part_a_map_dev_ms"]


@pytest.fixture(scope="module")
def ctx():
    return tiny.run(tiny.cell(), seconds=8.0)["ctx"]


def test_the_span_metrics_are_the_benchmarks():
    names = {m["name"] for m in harness.load_benchmark()["per_layer"]}
    assert set(HOST + DEVICE) <= names


@pytest.mark.parametrize("name", HOST)
def test_host_span_readers_read_finite_values(ctx, name):
    v = harness.metric_module(name).read(ctx)
    assert v is not None and math.isfinite(v) and v >= 0


@pytest.mark.parametrize("name", DEVICE)
def test_device_span_readers_read_none_on_the_cpu(ctx, name):
    assert harness.metric_module(name).read(ctx) is None


def test_the_part_b_stages_lie_within_part_b(ctx):
    read = {n: harness.metric_module(n).read(ctx) for n in HOST[:4] + ["part_b_host_ms"]}
    assert sum(read[n] for n in HOST[:4]) <= read["part_b_host_ms"]


@pytest.mark.parametrize("name", HOST + DEVICE)
def test_span_readers_read_none_without_their_keys(name):
    s = harness.Session(0, 16)
    s.chunks = [{"first": 0, "n": 16, "wait_s": 0.001, "latency_s": 0.1, "returned": 1.0,
                 "late": False}]
    s.start_s = 0.01
    s.stage_seconds = {"part_a_enqueue": 0.01, "readback_wait": 0.05, "part_b": 0.04}
    assert harness.metric_module(name).read({"sessions": [s, harness.Session(1, 16)]}) is None

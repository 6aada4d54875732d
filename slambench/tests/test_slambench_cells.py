"""The harness builds every cell from its files, found by name, and a cell,
a configuration, a mix and a metric added as new files and entries are
found without an edit of any file already there."""

from __future__ import annotations

import json
import shutil

import pytest

from slambench import harness

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_from_its_files(name):
    c = harness.load_cell(name)
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert c.mix["kind"] in ("laps", "segments")
    assert {"setup_s", "scans_per_s"} <= {m["name"] for m in c.end_to_end}
    assert c.per_layer, "every cell reports a per-layer metric"
    assert c.limits["numbers"], "every cell has its limits of correctness"


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_is_a_reader_of_its_own(m):
    mod = harness.metric_module(m["name"])
    assert callable(mod.read)
    assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
    if "layer" in m:
        assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
    else:
        assert mod.LAYER is None and mod.MOVES is None


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files_state_their_cut(c):
    conf = json.loads((harness.ROOT / c["file"]).read_text())
    assert conf["name"] == c["name"] and conf["source"] == c["source"]
    assert conf["reduced"] == c["reduced"]
    assert all(k in conf for k in conf["reduced"]), "a cut names a group of the file"
    assert not conf["reduced"] or conf["reduced_why"], "every cut says why"
    harness.program_config(conf)      # every key is a setting of the program


def test_a_new_cell_is_found_without_an_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.SB, root / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    sb = root / "slambench"
    conf = json.loads((sb / "configs" / "sim_circuit_sc.json").read_text())
    conf["name"] = "sim_wide"
    conf["mixes"]["slow_laps"] = {"laps_per_session": 2}
    (sb / "configs" / "sim_wide.json").write_text(json.dumps(conf))
    mix = json.loads((sb / "traffic" / "laps.json").read_text())
    mix["name"] = "slow_laps"
    (sb / "traffic" / "slow_laps.json").write_text(json.dumps(mix))
    (sb / "limits" / "sim_wide.slow_laps.json").write_text(json.dumps(
        {"cell": "sim_wide.slow_laps", "numbers": {"ate_m": {"limit": 1.0}}}))
    (sb / "metrics" / "keyframes_per_scan.py").write_text(
        'UNIT, SOURCE, LAYER, MOVES = "kf/scan", "program_counter", "device engine", '
        '"scans_per_s"\n\n\ndef read(ctx):\n    return 0.5\n')
    bench["configs"].append({"name": "sim_wide", "source": conf["source"],
                             "file": "slambench/configs/sim_wide.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "sim_wide.slow_laps", "config": "sim_wide",
                               "traffic": "slow_laps", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "keyframes_per_scan", "unit": "kf/scan",
                               "better": "lower", "source": "program_counter",
                               "layer": "device engine", "moves": "scans_per_s",
                               "workloads": ["sim_wide.slow_laps"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = harness.load_cell("sim_wide.slow_laps", root=root)
    assert c.mix["laps_per_session"] == 2 and c.mix["kind"] == "laps"
    assert [m["name"] for m in c.per_layer] == ["keyframes_per_scan"]
    assert harness.metric_module("keyframes_per_scan", root=root).read({}) == 0.5
    # the cells that were there are untouched by the addition
    old = harness.load_cell(CELLS[0], root=root)
    assert "keyframes_per_scan" not in [m["name"] for m in old.per_layer]


NAME = r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$"
UNIT = r"^[A-Za-z0-9_/%.\-]{1,16}$"


def test_benchmark_json_keeps_to_its_shape():
    import re

    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "slambench/run.py"]
    assert BENCH["paths"] == ["slambench"] and 1 <= BENCH["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert re.match(NAME, c["name"]) and c["file"].startswith("slambench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert re.match(NAME, w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert re.match(UNIT, m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert re.match(NAME, m["name"]) and re.match(UNIT, m["unit"])
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in moved.get("workloads", cells), (m["name"], cell)
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    for cell in cells:             # every cell: setup_s, another end-to-end metric, a per-layer
        c = harness.load_cell(cell)
        assert len(c.end_to_end) >= 2 and c.per_layer

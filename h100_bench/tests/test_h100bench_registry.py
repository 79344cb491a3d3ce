"""The harness finds every configuration, cell and per-layer metric by the
name BENCHMARK.json gives, and BENCHMARK.json keeps to the benchmark's
contract."""

from __future__ import annotations

import importlib.util
import json
import re

import pytest

from conftest import BENCH, ROOT

import run

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"m_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_cell_found_by_name(cell):
    c = run.load_cell(cell)
    assert c["cell"]["entry"] in ("batched", "img2img", "serve")
    assert c["config"]["name"] == c["entry"]["config"]
    assert c["cell"]["why"] == c["entry"]["why"]
    assert c["cell"]["check"]["image_err_limit"] is not None


@pytest.mark.parametrize("metric", [m["name"] for m in BENCHMARK["per_layer"]])
def test_per_layer_reader_found_by_name(metric):
    entry = next(m for m in BENCHMARK["per_layer"] if m["name"] == metric)
    mod = _reader(metric)
    assert (mod.UNIT, mod.LAYER, mod.MOVES) == (entry["unit"], entry["layer"], entry["moves"])
    assert mod.read({"config": {}, "cell": {}, "spans": None, "trace": None, "server": None,
                     "peak_bytes": 0, "e2e": {}}) is None  # nothing to read: no value


def test_contract_shapes():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["h100_bench"] and BENCHMARK["command"][1].startswith("h100_bench/")
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCHMARK["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [c["name"] for c in BENCHMARK["configs"]] + [w["name"] for w in BENCHMARK["workloads"]]
    names += [m["name"] for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCHMARK["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCHMARK["workloads"]}
    for w in cells:  # every cell: setup_s, another end-to-end metric, a per-layer metric
        reported = [m for m in BENCHMARK["end_to_end"] if w in m.get("workloads", [w])]
        assert len(reported) >= 2
        assert any(w in m.get("workloads", [w]) for m in BENCHMARK["per_layer"])
    for m in BENCHMARK["per_layer"]:  # each cell of a metric reports what it moves
        for w in m.get("workloads", cells):
            assert w in e2e[m["moves"]].get("workloads", [w])
    for w in BENCHMARK["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200


@pytest.mark.parametrize("cfg", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cuts(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["source"] == cfg["source"] and data["reduced"] == cfg["reduced"]
    for key in cfg["reduced"]:
        assert key in data
        assert not key.endswith(("_dim", "_rank", "_size"))

"""``BENCHMARK.json`` against the benchmark's contract: keys, names,
units, files, and every cell's configuration, traffic mix and limits."""

from __future__ import annotations

import json
import pathlib
import re

import pytest

from dialbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])


def test_paths_hold_the_command_and_nothing_else():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.endswith("_torch")
        assert (ROOT / p).is_dir()
    script = BENCH["command"][1]
    assert any(script.startswith(p + "/") for p in BENCH["paths"])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and _line(cfg["source"]) \
        and _line(cfg["why"])
    assert cfg["file"].startswith(BENCH["paths"][0] + "/configs/")
    body = json.loads((ROOT / cfg["file"]).read_text())
    assert len(body["source"]) <= 200 and body["assumed"]
    assert body["reduced"] == cfg["reduced"] and len(cfg["reduced"]) <= 16
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for k in ("name", "config", "traffic"):
        assert NAME.match(cell[k]), k
    assert cell["chips"] in (1, 4) and _line(cell["why"])
    c = harness.find_cell(ROOT, cell["name"])
    t = c.traffic
    assert t["driver"] in ("fleet", "lab") and t["tune_mask"] == "all"
    assert ("session_intervals" in t) or ("call_seconds" in t)
    assert "variants" in t
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric, and every limit is of a compared number
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and t["rate_metric"] in names
    assert len(names) >= 2 and c.per_layer
    assert set(c.limits) <= {"state_gap", "ring_gap", "prob_gap",
                             "decision_mismatch"}
    assert "state_gap" in c.limits


def test_cells_and_pairs_are_unique_and_four_chips_are_few():
    names = [w["name"] for w in BENCH["workloads"]]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(names)) == len(names) and len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(names) // 4)


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric(m):
    keys = {"name", "unit", "better", "source"}
    if m in BENCH["end_to_end"]:
        keys |= {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert (ROOT / BENCH["paths"][0] / "metrics" /
                f"{m['name']}.py").is_file()
        assert "mfu" not in m["name"]
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
    assert set(m) in (keys, keys | {"workloads"})
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    for w in m.get("workloads", []):
        assert w in {c["name"] for c in BENCH["workloads"]}


def test_metric_names_are_unique_and_layers_consistent():
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    assert "setup_s" in names
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_per_layer_cells_report_what_they_move():
    for m in BENCH["per_layer"]:
        e2e = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert w in e2e.get("workloads", [w]), (m["name"], w)

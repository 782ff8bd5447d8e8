"""A cell, a configuration, a traffic mix, a driver and a per-layer
metric are added by adding files and entries: a copy of the benchmark
with new ones finds, parses and runs them without an edit to any
existing file."""

from __future__ import annotations

import json
import pathlib
import shutil

from dialbench import harness
from dialbench.conftest import shrink

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_new_files_are_found_without_edits(tmp_path, card_pow):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "dialbench", tmp_path / "dialbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in tmp_path.rglob("*") if p.is_file()}
    base = tmp_path / "dialbench"

    # a fleet configuration (here the test data's, cut small) with its
    # own mix, limits, end-to-end metric and reader, on the fleet driver
    cfg = json.loads((base / "testdata" / "fleet-roles.json").read_text())
    cfg.update(name="fleet-h5dlio-12x3", n_clients=12, n_osts=3,
               interfaces=36)
    (base / "configs" / "fleet-h5dlio-12x3.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((base / "traffic" / "sessions20.tuned.json")
                         .read_text())
    traffic.update(session_intervals=5, interval_s=0.1,
                   why="five 0.1 s intervals a session")
    (base / "traffic" / "sessions5.tuned.json").write_text(
        json.dumps(traffic))
    (base / "limits" / "fleet-36.tuned.json").write_text(json.dumps(
        {"state_gap": 1e-9, "ring_gap": 1e-9, "prob_gap": 1e-9,
         "decision_mismatch": 0.001}))
    (base / "metrics" / "sessions.fleet.py").write_text(
        "def read(ctx):\n    return float(len(ctx['calls']))\n")
    # a driver of its own, found by the name its mix gives
    (base / "drivers" / "lab_again.py").write_text(
        "import pathlib\n"
        "from dialbench import harness\n"
        "Driver = harness.driver_class(pathlib.Path(__file__).parents[1],"
        " 'lab')\n")
    traffic = json.loads((base / "traffic" / "sweep5s.b4096.json")
                         .read_text())
    traffic.update(driver="lab_again", variants=5, call_seconds=0.3,
                   interval_s=0.1, why="five variants, 0.3 s a call")
    (base / "traffic" / "sweep03s.b5.json").write_text(json.dumps(traffic))
    (base / "limits" / "lab-noisy.b5.json").write_text(
        (base / "limits" / "lab-noisy.b4096.json").read_text())

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "fleet-h5dlio-12x3",
                             "source": "https://arxiv.org/abs/2602.22392",
                             "file": "dialbench/configs/fleet-h5dlio-12x3"
                                     ".json",
                             "reduced": ["n_clients", "n_osts"],
                             "why": "a small fleet"})
    bench["workloads"] += [{"name": "fleet-36.tuned",
                            "config": "fleet-h5dlio-12x3",
                            "traffic": "sessions5.tuned", "chips": 1,
                            "why": "a small fleet's sessions"},
                           {"name": "lab-noisy.b5",
                            "config": "lab-noisy-neighbor",
                            "traffic": "sweep03s.b5", "chips": 1,
                            "why": "a small sweep on a driver of its own"}]
    bench["end_to_end"].append({"name": "fleet_ifc_intervals_per_s",
                                "unit": "ifc-int/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["fleet-36.tuned"]})
    for m in bench["end_to_end"]:
        if m["name"] == "lab_scenario_s_per_s":
            m["workloads"].append("lab-noisy.b5")
    bench["per_layer"].append({"name": "sessions.fleet", "unit": "count",
                               "better": "higher",
                               "source": "host_clock", "layer": "driver",
                               "moves": "fleet_ifc_intervals_per_s",
                               "workloads": ["fleet-36.tuned"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.find_cell(tmp_path, "fleet-36.tuned")
    assert cell.config["n_clients"] == 12 and cell.base == base
    assert [m["name"] for m in cell.per_layer] == ["sessions.fleet"]
    result, lines = harness.run(cell, 17, 0.1, True, "cpu")
    assert result["correct"], lines
    assert result["metrics"]["sessions.fleet"]["value"] >= 1
    result, lines = harness.run(cell, 17, 0.1, False, "cpu")
    assert set(result["metrics"]) == {"fleet_ifc_intervals_per_s",
                                      "setup_s"}

    cell = harness.find_cell(tmp_path, "lab-noisy.b5")
    assert cell.traffic["driver"] == "lab_again"
    result, lines = harness.run(cell, 19, 0.1, False, "cpu")
    assert result["correct"], lines
    assert set(result["metrics"]) == {"lab_scenario_s_per_s", "setup_s"}

    # every file that was there is as it was
    for rel, data in before.items():
        if rel.name != "BENCHMARK.json":
            assert (tmp_path / rel).read_bytes() == data, rel
    # and the existing cells still parse beside the new ones
    for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]:
        assert shrink(harness.find_cell(tmp_path, w["name"]))

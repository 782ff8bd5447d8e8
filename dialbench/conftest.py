"""Fixtures of the benchmark's own tests: the cells at a size the CPU
holds, and the card marker."""

from __future__ import annotations

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skip unless a CUDA card is visible (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's card test runs on the "
                    "H100 (python -m pytest dialbench -m card)")
    return torch.device("cuda")


@pytest.fixture
def card_pow(monkeypatch):
    """The engine's congestion power as the card computes it (correctly
    rounded), where the CPU path would take numpy's ``power``: the
    reference computes the correctly rounded one."""
    import repro_torch.pfs.state as state
    from repro_torch.kernels.pow_cr.ref import pow_cr_ref

    monkeypatch.setattr(state, "_pow", lambda x, e: pow_cr_ref(x, e))


# fleet cells held out of BENCHMARK.json until a public source defines a
# fleet's size and mix: their driver, mixes and readers stay tested here
# on the test data's fleet
HELD = ("fleet.tuned", "fleet.static")
BENCH_CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
ALL_CELLS = BENCH_CELLS + list(HELD)


def held_cell(name: str):
    """A held fleet cell (``fleet.tuned`` or ``fleet.static``) on the
    test data's fleet, built as :func:`dialbench.harness.find_cell`
    builds a cell of ``BENCHMARK.json``."""
    from dialbench import harness

    kind = name.split(".")[1]
    base = ROOT / "dialbench"
    skip = () if kind == "tuned" else ("tune_us", "forest")
    readers = sorted(p.name[:-len(".py")]
                     for p in (base / "metrics").glob("*.fleet.py")
                     if not p.name.startswith(skip))
    return harness.Cell(
        name=name, entry={"name": name, "chips": 1},
        config=harness.load_json(base / "testdata" / "fleet-roles.json"),
        traffic=harness.load_json(base / "traffic"
                                  / f"sessions20.{kind}.json"),
        limits=harness.load_json(base / "testdata"
                                 / f"fleet.{kind}.limits.json"),
        end_to_end=[{"name": "fleet_ifc_intervals_per_s",
                     "unit": "ifc-int/s"}, {"name": "setup_s", "unit": "s"}],
        per_layer=[{"name": r, "unit": "1"} for r in readers], base=base)


def find(name: str):
    """A cell of ``BENCHMARK.json``, or a held one."""
    from dialbench import harness

    return held_cell(name) if name in HELD else harness.find_cell(ROOT, name)


def shrink(cell):
    """A cell cut to a size the CPU runs in seconds: 0.1 s intervals (20
    ticks), the fleet to 8 clients x 4 OSTs and 6-interval sessions, the
    lab to 6 variants and 0.6 s calls (2 devices for a sharded mix)."""
    if cell.traffic["driver"] == "fleet":
        cell.config = {**cell.config, "n_clients": 8, "n_osts": 4}
        cell.traffic = {**cell.traffic, "session_intervals": 6,
                        "interval_s": 0.1}
    else:
        cell.traffic = {**cell.traffic, "variants": 6, "call_seconds": 0.6,
                        "interval_s": 0.1,
                        "devices": min(2, int(cell.traffic["devices"]))}
    return cell


@pytest.fixture
def tiny_cell(card_pow):
    """``tiny_cell(name)``: the cell (of ``BENCHMARK.json``, or held) cut
    by :func:`shrink`, run on one torch thread (restored after)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield lambda name: shrink(find(name))
    torch.set_num_threads(threads)

"""On the card: each cell of ``BENCHMARK.json`` at a cut size, through
the whole run, correct (``python -m pytest dialbench -m card``)."""

from __future__ import annotations

import json
import pathlib

import pytest

from dialbench import harness
from dialbench.conftest import shrink

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    import torch

    cell = shrink(harness.find_cell(ROOT, name))
    if torch.cuda.device_count() < int(cell.traffic.get("devices", 1)):
        pytest.skip(f"{name} wants {cell.traffic['devices']} cards")
    result, lines = harness.run(cell, 2**31 + 41, 1.0, True, "cuda")
    assert result["correct"], lines
    assert result["device"]["platform"] == "gpu"
    assert result["metrics"], result

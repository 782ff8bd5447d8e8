"""The comparison fails what it has to fail: the control (the
reference in the program's place, its engine in float32, the precision
below the configuration's), an answer altered where it is produced, and
a shard whose results are not brought back from its device.  Each
drives a whole run on the CPU with the program broken underneath and
sees ``correct`` come out false."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from dialbench import control, harness
from dialbench.conftest import ALL_CELLS

CELLS = ALL_CELLS
TUNED = [c for c in CELLS if not c.endswith(".static")]


def _run(cell) -> dict:
    result, _ = harness.run(cell, 2**31 + 29, 0.1, False, "cpu")
    return result


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(tiny_cell, name):
    out = control.readings(tiny_cell(name), 2**31 + 21, "cpu")
    assert not out["passes_limits"], out
    assert out["readings"]["state_gap"] > 3 * 1e-9


@pytest.mark.parametrize("name", TUNED)
def test_altered_answer_fails(tiny_cell, monkeypatch, name):
    """Algorithm 1's window choices are changed where they are made."""
    import repro_torch.pfs.loop_torch as lt

    cell = tiny_cell(name)
    greedy = lt.conditional_score_greedy_batch

    def altered(probs, ops, current, *a, **kw):
        dec = greedy(probs, ops, current, *a, **kw)
        theta = dec.theta.clone()
        theta[:, 0] = torch.where(theta[:, 0] == 16, 1024, 16)
        return dataclasses.replace(dec, theta=theta)

    monkeypatch.setattr(lt, "conditional_score_greedy_batch", altered)
    assert not _run(cell)["correct"]


def _sharded(tiny_cell):
    """The lab cell's mix over two devices (the CPU twice): the path a
    sharded lab mix (``devices`` > 1) drives."""
    cell = tiny_cell("lab-noisy.b4096")
    cell.traffic = {**cell.traffic, "devices": 2}
    return cell


def test_sharded_lab_mix_is_correct(tiny_cell):
    result, lines = harness.run(_sharded(tiny_cell), 2**31 + 31, 0.1, False,
                                "cpu")
    assert result["correct"], lines
    assert result["device"]["count"] == 2


def test_shard_not_brought_back_fails(tiny_cell, monkeypatch):
    """Every shard but the first is never read back from its device:
    the gather of the shards' results leaves zeros in their place."""
    import repro_torch.lab.batch as lb

    cell = _sharded(tiny_cell)
    head = lb._head
    calls = []

    def dropped(x, n_real, n_elems, axis):
        out = head(x, n_real, n_elems, axis)
        calls.append(1)
        return out if len(calls) % cell.traffic["devices"] == 1 else out * 0

    monkeypatch.setattr(lb, "_head", dropped)
    assert not _run(cell)["correct"]

"""The comparison fails a run whose state is wrong: a step that
returns its state unchanged, half of the batch left out, a snapshot
history cut short.  Each drives a whole run on the CPU with the program
broken underneath and sees ``correct`` come out false."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from dialbench import harness
from dialbench.conftest import ALL_CELLS

CELLS = ALL_CELLS


def _run(cell) -> dict:
    result, _ = harness.run(cell, 2**31 + 23, 0.1, False, "cpu")
    return result


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged_fails(tiny_cell, monkeypatch, name):
    import repro_torch.pfs.loop_torch as lt

    cell = tiny_cell(name)
    monkeypatch.setattr(lt, "engine_step",
                        lambda params, topo, st, demand, disturbance=None: st)
    assert not _run(cell)["correct"]


def _half(state, before):
    """``state`` with the second half of the interfaces as ``before``."""
    n = state.window_pages.shape[0]
    fields = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if torch.is_tensor(v) and v.dim() and v.shape[-1] == n:
            v = v.clone()
            v[..., n // 2:] = getattr(before, f.name)[..., n // 2:]
        fields[f.name] = v
    return dataclasses.replace(state, **fields)


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out_fails(tiny_cell, monkeypatch, name):
    """Half of the interfaces (half the lab's elements) keep the state
    they started from."""
    import repro_torch.pfs.loop_torch as lt

    cell = tiny_cell(name)
    run = lt.FusedLoop.run

    def half_run(self, table, state, wstate, n_intervals, *a, **kw):
        res = run(self, table, state, wstate, n_intervals, *a, **kw)
        res.state = _half(res.state, state)
        return res

    monkeypatch.setattr(lt.FusedLoop, "run", half_run)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("name", [c for c in CELLS if c.startswith("lab")])
def test_history_cut_short_fails(tiny_cell, monkeypatch, name):
    """The program hands back a snapshot history without its last entry:
    the history is compared entry for entry, so a shorter one fails
    instead of reading 0.  (On the fleet's path the program itself
    unpacks the history, in ``run_fleet``, and would raise.)"""
    import repro_torch.pfs.loop_torch as lt

    cell = tiny_cell(name)
    run = lt.FusedLoop.run

    def short_run(self, *a, **kw):
        res = run(self, *a, **kw)
        res.hist = res.hist[:-1]
        return res

    monkeypatch.setattr(lt.FusedLoop, "run", short_run)
    assert not _run(cell)["correct"]


def test_ring_gap_of_a_shorter_history_is_infinite():
    from dialbench import compare

    ref = [torch.ones(3, 2), torch.ones(3, 2)]
    assert compare.ring_gap([torch.ones(3, 2)], ref) == float("inf")
    assert compare.ring_gap([], ref) == float("inf")
    assert compare.ring_gap([torch.ones(3, 2)] * 2, ref) == 0.0

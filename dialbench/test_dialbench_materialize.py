"""The reader of the program's ``lab.materialize`` spans
(``metrics/materialize_ms_per_interval.lab.py``): on a hand-made window,
without the program's span, and on the program's own run, where a
sweep's untouched variants are laid out from their arrays (0)."""

from __future__ import annotations

import pathlib
import sys

import pytest

from dialbench import harness, spans
from dialbench.program import Call

BASE = pathlib.Path(__file__).resolve().parent
NAME = "materialize_ms_per_interval.lab"
MS = 1_000_000


def _ctx(monkeypatch, log):
    """Two calls of 10 intervals each, at 1 s and 2 s, over ``log``."""
    monkeypatch.setattr(spans, "_ring", lambda: log)
    calls = [(1.0, 1.5, Call(10, 40960.0, 90.0)),
             (2.0, 2.5, Call(10, 40960.0, 90.0))]
    return {"calls": calls, "n_osc": 8, "cache": (None, None),
            "profile": None, "launches": None, "ab": None}


def _span(name, lo_ms, hi_ms, i, parent=None):
    return (name, lo_ms * MS, hi_ms * MS, i, parent, parent or i)


@pytest.fixture
def program():
    """The program's scenarios module, loaded as the lab cell loads it."""
    from repro_torch.lab import scenarios

    return scenarios


def test_reads_the_spans_an_interval(monkeypatch, program):
    log = [_span("lab.stack", 1000, 1010, 1),
           _span("lab.materialize", 1001, 1004, 2, 1),
           _span("lab.materialize", 1004, 1005, 3, 1),
           _span("lab.stack", 2000, 2010, 4),
           _span("lab.materialize", 2001, 2003, 5, 4),
           _span("lab.materialize", 9000, 9500, 6)]   # after the window
    got = harness.reader(BASE, NAME)(_ctx(monkeypatch, log))
    assert got == pytest.approx((3 + 1 + 2) / 20)


def test_reads_zero_where_no_element_was_made(monkeypatch, program):
    log = [_span("lab.build", 1000, 1003, 1),
           _span("lab.stack", 1003, 1005, 2),
           _span("lab.build", 2000, 2003, 3),
           _span("lab.stack", 2003, 2005, 4)]
    assert harness.reader(BASE, NAME)(_ctx(monkeypatch, log)) == 0.0


def test_reads_nothing_without_the_programs_span(monkeypatch, program):
    """A program that makes every element's pieces in its build (no
    such span), or no program loaded, or no spans: ``None``."""
    log = [_span("lab.build", 1000, 1003, 1),
           _span("lab.stack", 1003, 1005, 2)]
    ctx = _ctx(monkeypatch, log)
    read = harness.reader(BASE, NAME)
    monkeypatch.delattr(program, "MATERIALIZE_SPAN")
    assert read(ctx) is None
    monkeypatch.undo()
    ctx = _ctx(monkeypatch, log)
    monkeypatch.delitem(sys.modules, "repro_torch.lab.scenarios")
    assert read(ctx) is None
    monkeypatch.undo()
    assert read(_ctx(monkeypatch, [])) is None


def test_reads_zero_on_the_programs_own_sweep(tiny_cell):
    """The cell at a CPU size, traced: every call's variants stack from
    their arrays, so the line carries the metric at 0."""
    cell = tiny_cell("lab-noisy.b4096")
    result, _ = harness.run(cell, 2**33 + 19, 0.2, True, "cpu")
    assert result["metrics"][NAME]["value"] == 0.0
    assert result["metrics"]["scenario_build_ms_per_interval.lab"][
        "value"] > 0
    assert result["correct"]

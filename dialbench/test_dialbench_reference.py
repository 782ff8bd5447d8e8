"""The benchmark's plain reference against the program on the CPU, at
a size the CPU holds: bit for bit, tick by tick and call by call."""

from __future__ import annotations

import pathlib

import pytest
import torch

from dialbench import generate, harness
from dialbench.conftest import ALL_CELLS
from dialbench.program import Sample
from dialbench.reference import engine as E

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _port_sim(cfg, scen):
    from dialbench.program import _workload
    from repro_torch.pfs.engine import PFSSim
    from repro_torch.pfs.state import SimParams

    sim = PFSSim(scen.n_clients, scen.n_osts,
                 SimParams(**cfg["sim_params"]), device="cpu")
    for w in scen.workloads:
        sim.attach(_workload(w))
    return sim


@pytest.mark.parametrize("n_clients,n_osts", [(8, 4), (12, 3)])
def test_engine_ticks_bit_equal_to_the_port(tiny_cell, n_clients, n_osts):
    """200 ticks of demand + engine: every state field equal."""
    from repro_torch.pfs.state import engine_step
    from repro_torch.pfs.workloads import table_from_sim

    cell = tiny_cell("fleet.tuned")
    cfg = {**cell.config, "n_clients": n_clients, "n_osts": n_osts}
    scen = generate.fleet_scenario(cfg)
    sim = _port_sim(cfg, scen)
    table, ws = table_from_sim(sim)
    st = sim.state
    eng = E.Engine(generate.params(cfg), generate.flat_fleet([scen]))
    ref = eng.init_state(*scen.initial_theta)
    for _ in range(200):
        demand, ws = table.demand_step(sim.params, ws, st)
        st = engine_step(sim.params, sim.topo, st, demand)
        ref = eng.step(ref)
    for f in E.FIELDS:
        assert torch.equal(getattr(st, f), ref[f]), f
    assert torch.equal(ws.issued, ref["issued"])
    assert float(st.now) == ref["now"]


def test_lab_schedule_equals_the_port(tiny_cell):
    """The generator's background bursts, per tick and OST, against the
    port's ``make_schedule`` of the same variants."""
    cell = tiny_cell("lab-noisy.b4096")
    seed = 2**31 + 7
    d = harness.driver_class(cell.base, "lab")(cell.config, cell.traffic,
                                               seed, "cpu")
    d.setup()                       # its last batch is the second set drawn
    port = d.batch.schedule(0, 1000)
    scens = generate.lab_scenarios(cell.config, 6, seed, 1)
    mine = generate.schedule(scens, generate.params(cell.config), 0, 1000)
    assert (port.bg_bytes == mine["bg_bytes"]).all()
    assert (port.bw_scale == 1.0).all() and (port.nic_scale == 1.0).all()
    assert mine["bg_bytes"].any()


@pytest.mark.parametrize("name", ALL_CELLS)
def test_cell_bit_equal_to_the_reference(tiny_cell, name):
    """A whole run on the CPU: every compared number reads 0, and the
    tuned cells decide and change θ."""
    cell = tiny_cell(name)
    result, lines = harness.run(cell, 2**31 + 3, 0.1, False, "cpu")
    assert result["correct"], lines
    assert all(v["value"] == 0.0 for v in result["check"].values()), lines
    assert list(result)[-1] == "check"
    if cell.traffic.get("tuned", True):
        assert result["decisions"]["decided"] > 0
        assert result["decisions"]["changed"] > 0


def test_seed_makes_the_same_inputs(tiny_cell):
    cell = tiny_cell("lab-noisy.b4096")
    a = generate.lab_scenarios(cell.config, 4, 2**31 + 11, 3)
    b = generate.lab_scenarios(cell.config, 4, 2**31 + 11, 3)
    c = generate.lab_scenarios(cell.config, 4, 2**31 + 12, 3)
    d = generate.lab_scenarios(cell.config, 4, 2**31 + 11, 4)
    assert a == b and a != c and a != d
    assert [s.workloads[0]["name"] for s in d] == [
        s.workloads[0]["name"] for s in a]
    fa = generate.forests(cell.config, a, 5, "cpu")
    fb = generate.forests(cell.config, a, 5, "cpu")
    assert all(torch.equal(fa[k], fb[k])
               for k in ("feature", "threshold", "leaf", "base"))


def test_forest_features_stay_in_each_forests_width(tiny_cell):
    cell = tiny_cell("fleet.tuned")
    scen = generate.fleet_scenario(cell.config)
    f = generate.forests(cell.config, [scen], 9, "cpu")
    read_w, write_w = f["widths"]
    assert int(f["feature"][0].max()) < read_w
    assert int(f["feature"][1].max()) < write_w
    assert f["n_features"] == write_w == 36 and read_w == 32


def _later(seed: int) -> bool:
    """Whether the seed's draw keeps the second call it is offered (then
    every later draw is later still)."""
    s = Sample(seed)
    s.offer(0)
    s.offer(1)
    return s.kept == 1


def test_later_session_is_checked_from_the_programs_state(tiny_cell):
    """A session drawn past the first starts the reference from the
    state the program carried to it; the window's start is checked by
    itself."""
    cell = tiny_cell("fleet.tuned")
    seed = next(s for s in range(2**31, 2**31 + 100) if _later(s))
    result, lines = harness.run(cell, seed, 1.5, False, "cpu")
    assert result["attempted"] >= 2
    assert result["decisions"]["checked"] == 2
    assert result["correct"], lines


def test_later_lab_call_is_checked(tiny_cell):
    """A lab call drawn past the first, on its own new batch, is checked
    from the reference's own start."""
    cell = tiny_cell("lab-noisy.b4096")
    seed = next(s for s in range(2**31 + 200, 2**31 + 300) if _later(s))
    d = harness.driver_class(cell.base, "lab")(cell.config, cell.traffic,
                                               seed, "cpu")
    d.setup()
    d.call()
    d.call()
    checked = d.checked()
    assert [c[0] for c in checked] == [1]
    assert d.ref_scens == generate.lab_scenarios(cell.config, 6, seed, 3)
    values, verdicts = harness.check(cell, harness._Frozen(d), "cpu",
                                     checked)
    assert verdicts == [True] and set(values.values()) == {0.0}, values
    assert harness.decision_counts(checked)["changed"] > 0


@pytest.mark.parametrize("calls", [7, 40, 200])
def test_the_checked_call_is_drawn_from_the_whole_window(calls):
    """Over seeds, the kept call is uniform over all the calls offered:
    each third of the window is drawn, the last third too."""
    kept = []
    for seed in range(2**32, 2**32 + 600):
        s = Sample(seed)
        for i in range(calls):
            s.offer(i)
        kept.append(s.kept)
    thirds = [sum(1 for k in kept if k * 3 // calls == j) for j in range(3)]
    assert min(thirds) > 600 / 3 * 0.7, thirds
    assert max(kept) == calls - 1


def test_profiled_lab_call_records_its_parts_not_their_host_ops(tiny_cell):
    """The traced call's marks are there, and the host operators of the
    build and the run inside them are not recorded."""
    cell = tiny_cell("lab-noisy.b4096")
    d = harness.driver_class(cell.base, "lab")(cell.config, cell.traffic,
                                               2**31 + 61, "cpu")
    d.setup()
    prof = harness._profile(d, False)
    assert {"call", "build", "run_batch"} <= set(prof["marks"])
    lo, hi = prof["marks"]["call"]
    inside = [n for n, s, e in prof["host"]
              if lo <= s and e <= hi and not n.startswith("dialbench.")]
    assert inside == [], inside[:5]
    assert prof["replays"] == d.n and prof["idle"] is None

"""The port's Scenario Lab batch layer on the CPU (plain versions).

Held against the reference (``repro/lab``):

- ``lab/scenarios.py`` (numpy host code, imported here in-process): the
  catalog, ``variants``, ``validate_events``' refusals, each scenario's
  built table and state, and ``make_schedule`` arrays over 40 ticks;
- the layout: ``bucket_scenarios`` on the 12-scenario catalog gives the
  reference's buckets in the reference's order (its ``pad_class``,
  copied here, on the reference's own built scenarios), and a ragged
  stack equals the reference's stacked arrays carried across by
  ``convert.py`` (the reference's ``repro.lab.batch`` needs the
  ``jax.experimental.enable_x64`` alias under jax 0.9.0, so it runs in a
  child process that sets it; this process never does);
- whole runs, in that child: ``evaluate`` over three scenarios in three
  buckets and ``collect_batch`` on the smoke grid, on the same forests:
  rows, ``best_static_theta``, ``changes`` and ``n_buckets`` equal,
  MB/s within 1e-6 relative; collected rows within 1e-6, labels equal;
  campaign artifacts saved by either package load in the other.

And on the port's own runs: padding neutrality (each registry scenario
padded to its catalog bucket gives θ bit-equal to the unpadded run,
counters within 1e-6), the batched engine equal to B runs of the
unbatched ``FusedEngine``, ``run_batch``'s host path equal to
``fused=True``, ``(B, n)`` interventions equal to per-element runs (a
pin holds on tuned elements only), the loop cache, the refusals, and the CLI in a subprocess.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.gbdt import GBDTClassifier, GBDTParams  # noqa: E402
from repro.core.metrics import feature_dim  # noqa: E402
from repro.lab import scenarios as RS  # noqa: E402
from repro.pfs.engine import READ, WRITE  # noqa: E402
from repro_torch.convert import (batch_state_from_numpy,  # noqa: E402
                                 batch_table_from_numpy,
                                 batch_wstate_from_numpy, model_from_numpy)
from repro_torch.core.model import DIALModel  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.lab import batch as B  # noqa: E402
from repro_torch.lab import campaign as C  # noqa: E402
from repro_torch.lab import scenarios as S  # noqa: E402
from repro_torch.lab.evaluate import evaluate  # noqa: E402
from repro_torch.pfs.engine_torch import FusedEngine  # noqa: E402
from repro_torch.pfs.loop_torch import Intervention  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOREST_FIELDS = ("feature", "threshold", "leaf", "base_score", "depth",
                 "n_features")
NAMES = ("noisy_neighbor", "dlio_bert", "vpic_checkpoint")
MIXED = ("dlio_bert", "vpic_checkpoint", "noisy_neighbor")
CAMPAIGN = dict(seconds=3.0, reps=1)        # on the smoke grid
PIN = (1024, 32)
TABLE_FIELDS = ("client", "op", "req_size", "randomness", "n_threads",
                "thread_rate", "duty_cycle", "period", "stripe_len", "wave",
                "entry_row", "entry_osc", "row_valid")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These sizes run fastest on one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def forest_pair():
    """Small forests fitted on seeded data (mostly positive labels, so
    the tuner moves θ), as reference field dicts."""
    rng = np.random.default_rng(0)

    def forest(dim):
        x = rng.normal(size=(400, dim)).astype(np.float32)
        y = (x[:, 0] + x[:, -1] > -1.0).astype(np.int64)
        f = GBDTClassifier(GBDTParams(n_trees=8, max_depth=3)).fit(
            x, y).forest
        return {k: getattr(f, k) for k in FOREST_FIELDS}

    return forest(feature_dim(READ, 1)), forest(feature_dim(WRITE, 1))


@pytest.fixture(scope="module")
def model(forest_pair):
    return model_from_numpy(*forest_pair, device="cpu")


# --------------------------------------------------------------------- #
# the copied scenarios.py against the reference's
# --------------------------------------------------------------------- #
def _spec_dict(spec):
    d = dataclasses.asdict(spec)
    d["workloads"] = [dataclasses.asdict(w) for w in spec.workloads]
    d["events"] = [dataclasses.asdict(e) for e in spec.events]
    return d


def test_catalog_equals_reference():
    assert S.scenario_names() == RS.scenario_names()
    assert len(S.SCENARIOS) == 12
    for name in RS.SCENARIOS:
        assert _spec_dict(S.get_scenario(name)) == _spec_dict(
            RS.get_scenario(name)), name
    with pytest.raises(KeyError, match="unknown scenario"):
        S.get_scenario("nope")


@pytest.mark.parametrize("name,seed", [("noisy_neighbor", 0),
                                       ("failover_ost", 3),
                                       ("bursty_arrivals", 7)])
def test_variants_equal_reference(name, seed):
    mine = S.variants(S.get_scenario(name), 6, seed=seed)
    ref = RS.variants(RS.get_scenario(name), 6, seed=seed)
    assert [_spec_dict(s) for s in mine] == [_spec_dict(s) for s in ref]


BAD_EVENTS = [
    dict(kind="nope", targets=(0,)),
    dict(kind="ost_slow", targets=()),
    dict(kind="ost_slow", targets=(-1,), magnitude=0.5),
    dict(kind="ost_slow", targets=(0,), magnitude=0.0),
    dict(kind="bg_burst", targets=(0,), magnitude=float("nan")),
    dict(kind="ost_fail", targets=(0,), magnitude=1.0),
    dict(kind="bg_burst", targets=(0,), magnitude=1e6, start=2.0, end=1.0),
    dict(kind="bg_burst", targets=(0,), magnitude=1e6, duty=0.0),
    dict(kind="ost_failover", targets=(0,), end=3.0),
    dict(kind="ost_failover", targets=(0,), recovery=1.0),
    dict(kind="ost_slow", targets=(0,), magnitude=0.5, recovery=1.0),
]


@pytest.mark.parametrize("kw", BAD_EVENTS, ids=range(len(BAD_EVENTS)))
def test_event_refusals_equal_reference(kw):
    with pytest.raises(ValueError) as ref:
        RS.DisturbanceEvent(**kw)
    with pytest.raises(ValueError) as mine:
        S.DisturbanceEvent(**kw)
    assert str(mine.value) == str(ref.value)


def test_validate_events_refusal_equals_reference():
    ev = dict(kind="nic_slow", targets=(1, 9), magnitude=0.5)
    with pytest.raises(ValueError) as ref:
        RS.validate_events([RS.DisturbanceEvent(**ev)],
                           RS.build(RS.get_scenario("noisy_neighbor")).topo)
    with pytest.raises(ValueError) as mine:
        S.validate_events([S.DisturbanceEvent(**ev)],
                          S.build(S.get_scenario("noisy_neighbor")).topo)
    assert str(mine.value) == str(ref.value)
    assert "[9]" in str(mine.value)


@pytest.mark.parametrize("name", RS.scenario_names())
def test_build_and_schedule_equal_reference(name):
    """Each scenario's built table and state, and its schedule over 40
    ticks at three offsets (inside and across its event windows)."""
    mine, ref = S.build(S.get_scenario(name)), RS.build(RS.get_scenario(name))
    got = mine.table.arrays()
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(got[f], getattr(ref.table, f),
                                      err_msg=f)
    assert mine.table.n_waves == ref.table.n_waves
    for f in dataclasses.fields(mine.state):
        a = getattr(mine.state, f.name)
        a = a.numpy() if torch.is_tensor(a) else a
        np.testing.assert_array_equal(a, getattr(ref.state, f.name),
                                      err_msg=f.name)
    np.testing.assert_array_equal(mine.wstate.done_base.numpy(),
                                  ref.wstate.done_base)
    for t0 in (0, 190, 580):
        a, b = mine.schedule(t0, 40), ref.schedule(t0, 40)
        for f in ("bw_scale", "iops_scale", "bg_bytes", "nic_scale"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"{f}@{t0}")


# --------------------------------------------------------------------- #
# the layout
# --------------------------------------------------------------------- #
def _ref_p2(x):
    return 1 << max(int(x) - 1, 0).bit_length()


def _ref_pad_class(b):
    """The reference's ``repro.lab.batch.pad_class``, copied (that module
    does not import here)."""
    return (b.params, _ref_p2(b.topo.n_clients), _ref_p2(b.topo.n_osts),
            _ref_p2(len(b.table) + 1), _ref_p2(len(b.table.entry_row) + 1),
            _ref_p2(b.table.n_waves))


def test_catalog_buckets_in_reference_order():
    ref_built = [RS.build(s) for s in RS.SCENARIOS.values()]
    groups = {}
    for i, b in enumerate(ref_built):
        groups.setdefault(_ref_pad_class(b)[1:], []).append(i)
    want = [groups[k] for k in sorted(groups)]
    built = [S.build(s) for s in S.SCENARIOS.values()]
    buckets = B.bucket_scenarios(built, device="cpu")
    assert [idxs for idxs, _ in buckets] == want
    assert len(buckets) == 4
    for idxs, batch in buckets:
        assert len(batch) == len(idxs)
        assert batch.fleet.n_osc == len(idxs) * batch.n_osc
        assert [B.pad_class(built[i])[1:] for i in idxs] == \
            [_ref_pad_class(ref_built[i])[1:] for i in idxs]


def test_strict_refusal_names_field_and_values():
    a, b = (S.build(S.get_scenario(n)) for n in ("noisy_neighbor",
                                                 "dlio_bert"))
    with pytest.raises(ValueError) as ei:
        B.stack_scenarios([a, b], ragged=False, device="cpu")
    assert str(ei.value) == (
        "batch elements must share workload-table structure to stack "
        "with ragged=False: element 1 has n_clients=6 but element 0 has "
        "n_clients=4 (drop ragged=False to pad-and-mask mismatched "
        "structures into one bucket)")
    batch = B.stack_scenarios([a, b], device="cpu")
    assert len(batch) == 2 and batch.osc_cols


def test_params_mismatch_refused():
    a = S.build(S.get_scenario("noisy_neighbor"))
    b = S.build(S.get_scenario("noisy_neighbor"))
    b = dataclasses.replace(b, params=dataclasses.replace(
        b.params, tick=b.params.tick * 2))
    with pytest.raises(ValueError, match="SimParams"):
        B.stack_scenarios([a, b], device="cpu")
    with pytest.raises(ValueError, match="params mismatch"):
        B.pad_scenario(b, B.pad_class(a))


def test_ragged_stack_equals_reference_layout(reference):
    """The port's fleet from a ragged stack of three mixed scenarios
    equals the reference's stacked arrays carried across."""
    ref = reference()
    batch = B.stack_scenarios([S.build(S.get_scenario(n)) for n in MIXED],
                              device="cpu")
    n, nc = batch.n_osc, batch.topo.n_clients
    assert (len(batch), n, nc) == tuple(ref["layout/shape"])
    table = batch_table_from_numpy(
        {f: ref[f"layout/table/{f}"] for f in TABLE_FIELDS}, n_osc=n,
        n_waves=int(ref["layout/n_waves"]), n_clients=nc, device="cpu")
    assert table.key == batch.table.key
    state = batch_state_from_numpy(
        {f.name: ref[f"layout/state/{f.name}"]
         for f in dataclasses.fields(batch.state)}, device="cpu")
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(batch.state, f.name)
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), f.name
    ws = batch_wstate_from_numpy({f: ref[f"layout/wstate/{f}"]
                                  for f in ("issued", "done_base")},
                                 device="cpu")
    assert torch.equal(ws.done_base, batch.wstate.done_base)
    for b in range(len(batch)):
        np.testing.assert_array_equal(batch.element_cols(b),
                                      ref[f"layout/osc_cols/{b}"])
    np.testing.assert_array_equal(
        batch.fleet.ost_valid_mask().numpy(),
        ref["layout/state/ost_valid"].reshape(-1))
    np.testing.assert_array_equal(
        batch.fleet.client_valid_mask().numpy(),
        ref["layout/state/client_valid"].reshape(-1))
    assert batch.pad_stats() == json.loads(str(ref["layout/pad_stats"]))


def _touch(built):
    """Make each element's engine pieces, as a caller reading them does."""
    for b in built:
        b.state
    return built


def _mutate_one(built):
    """Element 3's pieces read and changed before stacking."""
    built[3].state.window_pages[:] = 1024
    built[3].wstate.issued[:] = 7.0
    return built


# (specs, ragged, what happens to the elements before stacking)
STAGED_CASES = {
    "variants64": (lambda: S.variants(S.get_scenario("noisy_neighbor"), 64,
                                      seed=5), False, None),
    "evaluate_arms": (lambda: [dataclasses.replace(
        S.get_scenario("filebench_mix"), initial_theta=th)
        for th in ((64, 2), (256, 8), (1024, 32), (16, 1), (256, 8))],
        True, None),
    "mutated": (lambda: S.variants(S.get_scenario("noisy_neighbor"), 6,
                                   seed=2), False, _mutate_one),
    "ragged_catalog": (lambda: [S.get_scenario(n) for n in MIXED], True,
                       None),
}


@pytest.mark.parametrize("case", list(STAGED_CASES))
def test_staged_stack_equals_materialized(case, monkeypatch):
    """A batch stacked from the elements as built (untouched ones laid
    out from their arrays in one pass) equals the batch of the same
    elements with every engine piece made first (each element's tensors
    concatenated), bit for bit: the table's key and arrays, every state
    field, the workload state, the fleet's wiring and masks, each
    element's table.  A touched and changed element stacks with its
    change; ragged stacks make every element's pieces either way.  The
    one-pass assembly reduces nothing (no engine kernel outside a run's
    intervals)."""
    from repro_torch.pfs import workloads

    make, ragged, before = STAGED_CASES[case]
    prep = before or (lambda built: built)
    got_built = prep([S.build(s) for s in make()])
    want_built = prep(_touch([S.build(s) for s in make()]))
    touched = [i for i, b in enumerate(got_built) if b.parts is not None]
    assert touched == ([3] if before is _mutate_one else [])
    sums, real_sum = [], workloads.segment_sum
    monkeypatch.setattr(workloads, "segment_sum",
                        lambda v, m: sums.append(m) or real_sum(v, m))
    got = B.stack_scenarios(got_built, ragged=ragged, device="cpu")
    monkeypatch.undo()
    want = B.stack_scenarios(want_built, ragged=ragged, device="cpu")
    staged = case in ("variants64", "evaluate_arms")
    assert all((b.parts is None) == staged for b in got_built), case
    assert not sums if staged else len(sums) == len(got) - len(touched)
    assert got.table.key == want.table.key
    assert got.table.n_waves == want.table.n_waves
    ga, wa = got.table.arrays(), want.table.arrays()
    for f in TABLE_FIELDS:
        assert ga[f].dtype == wa[f].dtype, f
        np.testing.assert_array_equal(ga[f], wa[f], err_msg=f)
    for f in dataclasses.fields(want.state):
        a, b = getattr(got.state, f.name), getattr(want.state, f.name)
        if torch.is_tensor(b):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert type(a) is type(b) and a == b, f.name
    assert torch.equal(got.wstate.issued, want.wstate.issued)
    assert torch.equal(got.wstate.done_base, want.wstate.done_base)
    for t in (got.fleet, want.fleet):
        assert t.n_clients == want.fleet.n_clients
        assert t.n_osts == want.fleet.n_osts
    for f in ("osc_client", "osc_ost"):
        assert torch.equal(getattr(got.fleet, f), getattr(want.fleet, f)), f
    for f in ("ost_valid_mask", "client_valid_mask", "osc_valid"):
        assert torch.equal(getattr(got.fleet, f)(),
                           getattr(want.fleet, f)()), f
    assert (got.topo.n_clients, got.topo.n_osts) == \
        (want.topo.n_clients, want.topo.n_osts)
    assert len(got.tables) == len(want.tables) == len(got)
    for b in range(len(got)):
        ga, wa = got.tables[b].arrays(), want.tables[b].arrays()
        for f in TABLE_FIELDS:
            np.testing.assert_array_equal(ga[f], wa[f], err_msg=f"{b} {f}")
        assert got.tables[b].key == want.tables[b].key
        np.testing.assert_array_equal(got.element_cols(b),
                                      want.element_cols(b))
    # the mesh path's table, blocked from the elements' tables
    assert B.WorkloadTable.block(list(got.tables), got.topo.n_clients,
                                 "cpu").key == got.table.key
    if before is _mutate_one:
        assert (got.stacked("window_pages")[3] == 1024).all()
        assert (got.stacked("window_pages")[2] == 256).all()
        n_rows = len(got.tables[0])
        issued = got.wstate.issued.reshape(len(got), n_rows)
        assert (issued[3] == 7.0).all() and not issued[2].any()


# --------------------------------------------------------------------- #
# the port's own runs
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def bucket_classes():
    """Each catalog scenario's bucket class (the max over its bucket)."""
    built = [S.build(s) for s in S.SCENARIOS.values()]
    by = {}
    for b in built:
        by.setdefault(B.pad_class(b), []).append(b.spec.name)
    out = {}
    for cls, names in by.items():
        for name in names:
            out[name] = cls
    return out


@pytest.mark.parametrize("name", RS.scenario_names())
def test_padding_neutral_registry(name, bucket_classes, model):
    """Padded to its bucket, a scenario's fused tuned run gives θ and
    decision records bit-equal to the unpadded run, every counter
    within 1e-6 (bit-equal here), phantom rows idle."""
    built = S.build(S.get_scenario(name))
    padded = B.pad_scenario(built, bucket_classes[name])
    o_old, o_new = built.topo.n_osts, padded.topo.n_osts
    osc = np.arange(built.topo.n_osc)
    remap = (osc // o_old) * o_new + osc % o_old
    solo = B.stack_scenarios([built], device="cpu")
    pad = B.stack_scenarios([padded], device="cpu")
    assert pad.fleet.n_osc > solo.fleet.n_osc or \
        len(pad.table) > len(solo.table)
    kw = dict(seconds=2.0, interval=0.25, fused=True)
    r_solo = B.run_batch(solo, model, **kw)
    r_pad = B.run_batch(pad, model, tune_cols=remap, **kw)
    for f in dataclasses.fields(solo.state):
        u = solo.stacked(f.name)[0] if f.name not in ("now", "tick_index") \
            else getattr(solo.state, f.name)
        v = pad.stacked(f.name)[0][..., remap] \
            if f.name not in ("now", "tick_index") \
            else getattr(pad.state, f.name)
        np.testing.assert_allclose(v, u, rtol=1e-6, atol=1e-9,
                                   err_msg=f.name)
    for f in ("window_pages", "rpcs_in_flight"):
        np.testing.assert_array_equal(pad.stacked(f)[0][remap],
                                      solo.stacked(f)[0])
    back = {int(r): i for i, r in enumerate(remap)}
    for a, b in zip(r_solo.decisions, r_pad.decisions):
        assert a.oscs.tolist() == [back[int(o)] for o in b.oscs]
        assert torch.equal(a.decisions.theta, b.decisions.theta)
        assert torch.equal(a.decisions.probs, b.decisions.probs)
    r = len(built.table)
    assert not pad.wstate.issued[r:].any()
    assert float(pad.throughput(2.0)["total_mbs"][0]) == float(
        solo.throughput(2.0)["total_mbs"][0])


def _mixed_batch():
    return B.stack_scenarios([S.build(S.get_scenario(n)) for n in MIXED],
                             device="cpu")


def _padded_like(batch, name):
    """Scenario ``name`` padded alone to ``batch``'s shape class."""
    t = batch.tables[0]
    return B.pad_scenario(S.build(S.get_scenario(name)), (
        batch.params, batch.topo.n_clients, batch.topo.n_osts, len(t),
        t.entry_row.shape[0], t.n_waves))


def test_batched_engine_equals_independent_runs():
    """Two intervals of the ragged batch's engine against each padded
    element run alone through the unbatched FusedEngine: bit-equal."""
    batch = _mixed_batch()
    steps = 100
    engine = B.BatchEngine(batch.params, batch.fleet, steps)
    st, ws = batch.state, batch.wstate
    for i in range(2):
        sched = batch.schedule(i * steps, steps).to("cpu")
        st, ws = engine.run_interval(batch.table, st, ws, sched)
    batch.state, batch.wstate = st, ws
    r = len(batch.tables[0])
    for b, name in enumerate(MIXED):
        elem = _padded_like(batch, name)
        one = FusedEngine(batch.params, elem.topo, elem.table, steps)
        s1, w1 = elem.state, elem.wstate
        for i in range(2):
            s1, w1 = one.run_interval(s1, w1, elem.schedule(
                i * steps, steps).to("cpu"))
        for f in dataclasses.fields(s1):
            a = getattr(s1, f.name)
            if torch.is_tensor(a):
                np.testing.assert_array_equal(
                    batch.stacked(f.name)[b], a.numpy(), err_msg=f.name)
            else:
                assert a == getattr(batch.state, f.name)
        assert torch.equal(ws.issued[b * r:(b + 1) * r], w1.issued)


def _records(decisions):
    return [(r.oscs.tolist(), r.ops.tolist(), r.decisions.theta.tolist(),
             r.decisions.changed.tolist(), r.decisions.probs.tolist())
            for r in decisions]


def test_run_batch_host_equals_fused(model):
    """An evaluate-shaped run (one tuned element of three, ragged): the
    host path's decision records and θ equal the fused path's, every
    counter bit-equal."""
    runs = {}
    for fused in (False, True):
        batch = _mixed_batch()
        n = batch.n_osc
        cols = 1 * n + batch.element_cols(1)
        res = B.run_batch(batch, model, seconds=2.0, interval=0.25,
                          tune_cols=cols, fused=fused)
        runs[fused] = (batch, res)
    (bh, fleet), (bf, res) = runs[False], runs[True]
    assert _records(fleet.decisions) == _records(res.decisions)
    assert any(r.decisions.changed.any() for r in res.decisions)
    for f in dataclasses.fields(bh.state):
        a, b = getattr(bh.state, f.name), getattr(bf.state, f.name)
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), f.name
    assert torch.equal(bh.wstate.issued, bf.wstate.issued)


@pytest.mark.parametrize("arm", ["pin", "gates_open", "freeze"])
def test_batched_intervention_equals_per_element(model, arm):
    """A ``(B, n)`` intervention on the fused batch gives each element
    the decision records and θ of that element run alone under its own
    intervention row."""
    make = {"pin": lambda n: Intervention.pin(n, PIN),
            "gates_open": Intervention.gates_open,
            "freeze": Intervention.freeze_theta}[arm]
    batch = _mixed_batch()
    n = batch.n_osc
    per = [make(n) for _ in MIXED]
    iv = Intervention(*(np.stack(f) for f in zip(*per)))
    kw = dict(seconds=2.0, interval=0.25, fused=True)
    res = B.run_batch(batch, model, intervene=iv, **kw)
    for b, name in enumerate(MIXED):
        solo = B.stack_scenarios([_padded_like(batch, name)], device="cpu")
        one = B.run_batch(solo, model, tune_cols=batch.element_cols(b),
                          intervene=Intervention(*(f[None] for f in per[b])),
                          **kw)
        for r, r1 in zip(res.decisions, one.decisions):
            mine = r.oscs // n == b
            assert (r.oscs[mine] % n).tolist() == r1.oscs.tolist()
            assert torch.equal(r.decisions.theta[mine], r1.decisions.theta)
        for f in ("window_pages", "rpcs_in_flight"):
            np.testing.assert_array_equal(batch.stacked(f)[b],
                                          solo.stacked(f)[0])
    if arm == "pin":
        assert (batch.stacked("window_pages")[0] == PIN[0]).all()


def test_pin_holds_only_on_tuned_elements(model):
    """One tuned element of three under a pin on every element: the
    reference runs never-tuned elements apart, unintervened, so only the
    tuned element is pinned and the others keep the θ and counters of
    the run without the pin."""
    kw = dict(seconds=2.0, interval=0.25, fused=True)
    batch, free = _mixed_batch(), _mixed_batch()
    n = batch.n_osc
    cols = 1 * n + batch.element_cols(1)
    pin = Intervention(*(np.stack([f] * len(MIXED))
                         for f in Intervention.pin(n, PIN)))
    B.run_batch(batch, model, tune_cols=cols, intervene=pin, **kw)
    B.run_batch(free, model, tune_cols=cols, **kw)
    assert (batch.stacked("window_pages")[1] == PIN[0]).all()
    assert (batch.stacked("rpcs_in_flight")[1] == PIN[1]).all()
    for b in (0, 2):
        for f in ("window_pages", "rpcs_in_flight", "ctr_bytes_done"):
            np.testing.assert_array_equal(batch.stacked(f)[b],
                                          free.stacked(f)[b], err_msg=f)


def test_loop_cache_hits_misses_and_model_version(model):
    B.reset_loop_cache_stats()
    for _ in range(2):
        batch = B.stack_scenarios([S.build(S.get_scenario("noisy_neighbor"))],
                                  device="cpu")
        B.run_batch(batch, model, seconds=1.0, interval=0.5, fused=True)
    stats = B.loop_cache_stats()
    assert stats["hits"] >= 1 and stats["misses"] <= 1
    loop = next(v[0] for v in B._FUSED_LOOPS.values() if v[1] is model)
    assert loop.tuned
    model.update_forests()                     # a refit: a new version
    batch = B.stack_scenarios([S.build(S.get_scenario("noisy_neighbor"))],
                              device="cpu")
    B.run_batch(batch, model, seconds=1.0, interval=0.5, fused=True)
    assert B.loop_cache_stats()["misses"] == stats["misses"] + 1


def test_refusals():
    batch = _mixed_batch()
    # the mesh rides the fused path only, as in the reference
    with pytest.raises(ValueError, match="pass fused=True with mesh"):
        B.run_batch(batch, None, mesh=object())
    with pytest.raises(ValueError, match="untuned host batches"):
        B.run_batch(batch, None, trace=object())
    with pytest.raises(ValueError, match="requires a model"):
        B.run_batch(batch, None, fused=True)
    with pytest.raises(ValueError, match="fused=True"):
        B.run_batch(batch, None, intervene=Intervention.neutral(1))
    if torch.cuda.is_available():
        return
    built = [S.build(S.get_scenario("noisy_neighbor"))]
    for call in (lambda: B.stack_scenarios(built),
                 lambda: evaluate(names=list(NAMES)),
                 lambda: C.collect_batch(),
                 lambda: C.run_campaign(C.CampaignConfig())):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# --------------------------------------------------------------------- #
# against the reference in a child process
# --------------------------------------------------------------------- #
CHILD = r"""
import dataclasses, json, sys
import jax
import jax.experimental
# jax 0.9.0 moved enable_x64; the reference imports the old name
jax.experimental.enable_x64 = jax.enable_x64
import numpy as np
from repro.core.gbdt import DenseForest, GBDTParams
from repro.core.model import DIALModel
from repro.lab.batch import stack_scenarios
from repro.lab.campaign import (SMOKE_GRID, CampaignConfig, collect_batch,
                                load_versioned, run_campaign)
from repro.lab.evaluate import evaluate
from repro.lab.scenarios import SCENARIOS, build

src, out, port_root, ref_root = sys.argv[1:5]
names, mixed = sys.argv[5].split(","), sys.argv[6].split(",")
campaign = json.loads(sys.argv[7])
z = np.load(src)
fields = ("feature", "threshold", "leaf", "base_score", "depth", "n_features")
model = DIALModel(*(DenseForest(**{f: z[f"{op}_{f}"][()] for f in fields})
                    for op in ("read", "write")))
res = {}
rep = evaluate(names=names, model=model, seconds=3.0)
res["evaluate"] = json.dumps(rep)
data = collect_batch(CampaignConfig(grid=SMOKE_GRID, **campaign))
for op in ("read", "write"):
    res[f"collect/{op}/X"], res[f"collect/{op}/y"] = data[op]
batch = stack_scenarios([build(SCENARIOS[n]) for n in mixed])
res["layout/shape"] = np.array([len(batch), batch.n_osc,
                                batch.topo.n_clients])
res["layout/n_waves"] = np.array(batch.table.n_waves)
res["layout/pad_stats"] = json.dumps(batch.pad_stats())
for f in ("client", "op", "req_size", "randomness", "n_threads",
          "thread_rate", "duty_cycle", "period", "stripe_len", "wave",
          "entry_row", "entry_osc", "row_valid"):
    res[f"layout/table/{f}"] = np.asarray(getattr(batch.table, f))
for f in dataclasses.fields(batch.state):
    res[f"layout/state/{f.name}"] = np.asarray(getattr(batch.state, f.name))
for f in ("issued", "done_base"):
    res[f"layout/wstate/{f}"] = np.asarray(getattr(batch.wstate, f))
for b in range(len(batch)):
    res[f"layout/osc_cols/{b}"] = batch.element_cols(b)
# the port's artifact, strictly loaded here; one of the reference's
loaded = load_versioned(port_root)
for op in ("read", "write"):
    forest = loaded.read_forest if op == "read" else loaded.write_forest
    for f in fields:
        res[f"port_artifact/{op}/{f}"] = np.asarray(getattr(forest, f))
res["port_artifact/train_meta"] = json.dumps(loaded.train_meta)
run_campaign(CampaignConfig(grid=SMOKE_GRID, **campaign), out_root=ref_root,
             gbdt_params=GBDTParams(n_trees=4, max_depth=3))
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def port_campaign(tmp_path_factory):
    """A port campaign on the CPU (smoke grid, short, small forests),
    saved as a versioned artifact."""
    root = tmp_path_factory.mktemp("port_campaign") / "lab"
    d, model, info = C.run_campaign(
        C.CampaignConfig(grid=C.SMOKE_GRID, **CAMPAIGN), out_root=str(root),
        gbdt_params=C.GBDTParams(n_trees=4, max_depth=3), device="cpu")
    return root, model, info


@pytest.fixture(scope="module")
def reference(forest_pair, port_campaign, tmp_path_factory):
    """Start the reference's runs in a child process (it runs while the
    other tests do); the value waits for its results."""
    d = tmp_path_factory.mktemp("ref_lab")
    src, out = d / "forests.npz", d / "out.npz"
    np.savez(src, **{f"{op}_{f}": np.asarray(forest[f])
                     for op, forest in zip(("read", "write"), forest_pair)
                     for f in FOREST_FIELDS})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", CHILD, str(src), str(out),
         str(port_campaign[0]), str(d / "ref_lab"), ",".join(NAMES),
         ",".join(MIXED), json.dumps(CAMPAIGN)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def result():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-3000:]
        with np.load(out) as z:
            res = {k: z[k] for k in z.files}
        res["ref_root"] = d / "ref_lab"
        return res

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def start_reference_early(reference):
    """Start the child with the module's first test."""


@pytest.fixture(scope="module")
def port_report(model):
    return evaluate(names=list(NAMES), model=model, seconds=3.0,
                    device="cpu")


def test_evaluate_matches_reference(port_report, reference):
    want = json.loads(str(reference()["evaluate"]))
    got = port_report
    assert got["summary"]["n_buckets"] == want["summary"]["n_buckets"] == 3
    assert got["summary"]["n_dispatches"] == want["summary"]["n_dispatches"]
    assert len(got["scenarios"]) == len(want["scenarios"]) == len(NAMES)
    for g, w in zip(got["scenarios"], want["scenarios"]):
        for key in w:
            if key.endswith("_mbs") or key.startswith("dial_"):
                np.testing.assert_allclose(g[key], w[key], rtol=1e-6,
                                           err_msg=f"{w['scenario']}:{key}")
            else:
                assert g[key] == w[key], (w["scenario"], key)
    assert any(r["changes"] for r in got["scenarios"])


def test_evaluate_paths_give_identical_rows(model, port_report):
    """The host path, and one batch per scenario, give the ragged fused
    path's rows exactly."""
    host = evaluate(names=list(NAMES), model=model, seconds=3.0,
                    fused=False, device="cpu")
    assert host["scenarios"] == port_report["scenarios"]
    assert host["summary"]["n_buckets"] == 3
    single = evaluate(names=[NAMES[0]], model=model, seconds=3.0,
                      device="cpu")
    assert single["scenarios"] == port_report["scenarios"][:1]


def test_collect_batch_matches_reference(reference):
    ref = reference()
    LAUNCHES.clear()
    data = C.collect_batch(C.CampaignConfig(grid=C.SMOKE_GRID, **CAMPAIGN),
                           device="cpu")
    assert dict(LAUNCHES) == {}                 # the CPU launches nothing
    for op in ("read", "write"):
        X, y = data[op]
        assert X.dtype == np.float32 and len(X) > 0
        np.testing.assert_array_equal(y, ref[f"collect/{op}/y"])
        np.testing.assert_allclose(X, ref[f"collect/{op}/X"], rtol=1e-6,
                                   atol=1e-6)


def test_campaign_artifacts_load_both_ways(port_campaign, reference):
    ref = reference()
    root, model, info = port_campaign
    # the reference loaded the port's artifact strictly
    assert json.loads(str(ref["port_artifact/train_meta"])) == \
        model.train_meta == info["train_meta"]
    for op, forest in (("read", model.read_forest),
                       ("write", model.write_forest)):
        mine = dict(zip(("feature", "threshold", "leaf"),
                        forest.numpy_arrays()))
        for f, a in mine.items():
            np.testing.assert_array_equal(ref[f"port_artifact/{op}/{f}"], a)
    # and the port loads the reference's
    assert C.latest_version(str(ref["ref_root"])) == "v001"
    theirs = C.load_versioned(str(ref["ref_root"]), device="cpu")
    assert theirs.train_meta["trainer_backend"] == "numpy"
    with open(os.path.join(ref["ref_root"], "v001", "manifest.json")) as f:
        assert json.load(f)["train_meta"] == theirs.train_meta
    # a second save is v002 and LATEST follows it
    assert C.save_versioned(theirs, str(root)).endswith("v002")
    assert C.latest_version(str(root)) == "v002"


def test_load_versioned_refuses_mismatched_provenance(port_campaign,
                                                      tmp_path):
    _, model, info = port_campaign
    bad = dict(info, train_meta=dict(info["train_meta"], precision="fast"))
    C.save_versioned(model, str(tmp_path), meta=bad)
    with pytest.raises(ValueError, match="inconsistent"):
        C.load_versioned(str(tmp_path), device="cpu")
    assert isinstance(C.load_versioned(str(tmp_path), strict=False,
                                       device="cpu"), DIALModel)


# --------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------- #
def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.lab", *args],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_cli_list():
    proc = _cli("list")
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 12
    assert lines[0].startswith("vpic_checkpoint  4c x 4ost  [paper,write]")


def test_cli_evaluate_smoke_on_cpu(port_campaign, tmp_path):
    root = port_campaign[0]
    out = tmp_path / "report"
    proc = _cli("evaluate", "--smoke", "--model", str(root / "v001" / "dial"),
                "--device", "cpu", "--scenarios", "noisy_neighbor",
                "hetero_links", "--out", str(out))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "2 scenarios" in proc.stdout and "2 buckets" in proc.stdout
    report = json.loads((out / "report.json").read_text())
    assert report["seconds"] == 3.0
    assert [r["scenario"] for r in report["scenarios"]] == \
        ["noisy_neighbor", "hetero_links"]
    assert (out / "report.md").read_text().startswith("# Scenario Lab")
    if not torch.cuda.is_available():
        proc = _cli("evaluate", "--smoke", "--model",
                    str(root / "v001" / "dial"), "--out", str(out))
        assert proc.returncode != 0 and "CUDA" in proc.stderr

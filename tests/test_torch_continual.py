"""The port's continual retraining and hard-case curriculum on the CPU.

Held against the reference's ``repro/lab/continual.py``.  Under jax
0.9.0 ``repro.lab.continual`` imports only with the alias
``jax.experimental.enable_x64 = jax.enable_x64``, so the reference runs
in a child process that sets it (this process never does).  The child
runs the frozen arms twice: as it is (its XLA engine) and with its
module-level ``BatchEngine`` rebound, in that child only, to the
numpy-engine oracle of ``tests/test_torch_fuzz.py``; the online arm runs
on the oracle.  The port is held to the oracle bit for bit, and to the
XLA run wherever that run agrees with its oracle (the reference's XLA
engine drifts from its numpy engine on some scenarios, ROADMAP Queue 3):

- the frozen arm of ``run_continual`` on ``failing_ost`` and
  ``degraded_ost``: MB/s series, θ checksums, changes, pre/post means;
- the online arm through its first refit: the refit's interval, the
  replay-buffer rows and labels it trains on, and the series up to it.
  The port's refit forests equal its own ``fit_forest_batch(precision=
  "fast")`` on the reference's buffer rows; against the reference's
  jitted refit of those rows they are held statistically (AUC within
  0.05, ``tests/test_torch_learn.py::test_fast_mode_statistical_parity``);
- the curriculum over a small fuzz report: the reference's cases,
  weights and ``gate_evidence``; its "before" races equal the races
  through the reference's host path on the numpy oracle (and the
  reference's own where they agree), and the "after" races capture
  their loops anew for the refit model's version; after the refits both
  packages race the same cases at the same static θ (the static arm as
  before), and both print their after loss rate, delta and refits (the
  refit forests come from different trainers, so the rates are not
  compared).

On the port's own runs: ``run_comparison`` leaves the frozen model
untouched, reports are byte-identical across two runs, and the CLI's
``continual`` (with and without ``--hard-from``) runs with ``--device
cpu``.
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

from repro_torch.convert import model_from_numpy  # noqa: E402
from repro_torch.core.gbdt import GBDTParams  # noqa: E402
from repro_torch.lab import batch as B  # noqa: E402
from repro_torch.lab import continual as C  # noqa: E402
from repro_torch.lab import fuzz as F  # noqa: E402
from repro_torch.lab.scenarios import get_scenario  # noqa: E402
from repro_torch.learn import online as O  # noqa: E402
from repro_torch.learn.boost import fit_forest_batch  # noqa: E402
from repro_torch.pfs.state import READ, WRITE  # noqa: E402
from test_torch_fuzz import NUMPY_ENGINE, SMALL  # noqa: E402
from test_torch_learn import _auc  # noqa: E402
from test_torch_loop import FOREST_FIELDS, forests  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FROZEN = ("failing_ost", "degraded_ost")
SECONDS = 6.0                       # 12 intervals: onset at 2 s and 3 s
POLICY = dict(refit_every=10, min_samples=32, cooldown=6, explore_eps=0.10)
GBDT = dict(n_trees=10, max_depth=4)
# the curriculum: 3 s replays (6 intervals) refit with these settings
CURRICULUM = dict(seconds=3.0, max_cases=2,
                  policy=dict(refit_every=2, min_samples=8, cooldown=1,
                              explore_eps=0.15),
                  gbdt=dict(n_trees=10, max_depth=3))
SERIES = ("tput_mbs", "theta_trace")
SCALARS = ("changes", "pre_fail_mbs", "post_fail_mbs", "post_tail_mbs",
           "t_fail", "samples", "scenario", "online", "seconds", "interval")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These sizes run fastest on one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def forest_pair():
    return forests()


def fresh_model(forest_pair):
    return model_from_numpy(*forest_pair, device="cpu")


@pytest.fixture(scope="module")
def fuzz_report(forest_pair, tmp_path_factory):
    """The port's small sweep (``tests/test_torch_fuzz.py``'s), written
    once: the report both curricula replay."""
    out = tmp_path_factory.mktemp("cont_fuzz")
    report = F.run_sweep(F.FuzzConfig(**SMALL), fresh_model(forest_pair),
                         diagnose=True, device="cpu")
    jpath, _ = F.write_fuzz_report(report, str(out))
    return jpath


# --------------------------------------------------------------------- #
# the reference in a child process
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
from repro.lab import continual as C
from repro.lab.batch import run_batch, stack_scenarios
from repro.lab.scenarios import build, get_scenario
from repro.learn import boost, online
from repro.learn.online import OnlinePolicy
from repro.pfs.state import engine_step

src, out, report_path = sys.argv[1:4]
cfg = json.loads(sys.argv[4])
z = np.load(src)
fields = ("feature", "threshold", "leaf", "base_score", "depth", "n_features")


def model():
    return DIALModel(*(DenseForest(**{f: z[f"{op}_{f}"][()] for f in fields})
                       for op in ("read", "write")))


""" + NUMPY_ENGINE + r"""
res = {}
xla = C.BatchEngine
policy = OnlinePolicy(**cfg["policy"])
orig_refit, orig_fit = online.OnlineTrainer._refit, boost.fit_forest_batch
for engine_name, engine in (("xla", xla), ("oracle", NumpyBatchEngine)):
    C.BatchEngine = engine
    for name in cfg["frozen"]:
        r = C.run_continual(get_scenario(name), model(), online=False,
                            seconds=cfg["seconds"], policy=policy)
        res[f"{engine_name}/frozen/{name}"] = r.row()
    if engine_name == "xla":
        continue
    # the online arm (on the oracle), its first refit's inputs and
    # forests captured
    captured = {}

    def refit(self, ops, reason, tput):
        if "interval" not in captured:
            captured["interval"] = self._interval
            for op in ops:
                X, y = self.buffers[op].dataset()
                captured[f"X{op}"], captured[f"y{op}"] = X, y
        return orig_refit(self, ops, reason, tput)

    def fit(datasets, params, **kw):
        got = orig_fit(datasets, params, **kw)
        if "forest0_leaf" not in captured:
            for i, f in enumerate(got):
                for k in fields:
                    captured[f"forest{i}_{k}"] = np.asarray(getattr(f, k))
        return got

    online.OnlineTrainer._refit, boost.fit_forest_batch = refit, fit
    r = C.run_continual(get_scenario(cfg["online"]), model(), online=True,
                        seconds=cfg["seconds"], policy=policy,
                        gbdt_params=GBDTParams(**cfg["gbdt"]))
    online.OnlineTrainer._refit, boost.fit_forest_batch = orig_refit, orig_fit
    res[f"{engine_name}/online"] = r.row()
    np.savez(f"{out}/{engine_name}_refit.npz", **captured)
C.BatchEngine = xla

cur = cfg["curriculum"]
rep = C.run_hard_case_curriculum(
    report_path, model(), seconds=cur["seconds"],
    policy=OnlinePolicy(**cur["policy"]),
    gbdt_params=GBDTParams(**cur["gbdt"]), max_cases=cur["max_cases"])
C.write_curriculum_report(rep, out)
# the before races through the host path on the numpy oracle
from repro.lab.fuzz import spec_from_dict
losses = json.load(open(report_path))["triage"]["losses"][:cur["max_cases"]]
fz = json.load(open(report_path))["config"]
oracle = []
for r in losses:
    spec = spec_from_dict(r["spec"], name=r["name"])
    th = tuple(int(x) for x in r["best_static_theta"])
    batch = stack_scenarios([build(dataclasses.replace(spec, initial_theta=th)),
                             build(spec)])
    n = batch.n_osc
    steps = max(int(round(fz["interval"] / batch.params.tick)), 1)
    run_batch(batch, model(), seconds=fz["seconds"], interval=fz["interval"],
              tune_cols=n + np.arange(n),
              engine=NumpyBatchEngine(batch.params, batch.topo, steps))
    oracle.append(batch.throughput(fz["seconds"])["total_mbs"].tolist())
res["oracle_races"] = oracle
with open(out + "/child.json", "w") as f:
    json.dump(res, f)
"""


@pytest.fixture(scope="module")
def reference(forest_pair, fuzz_report, tmp_path_factory):
    """Start the reference's runs in a child process (it runs while the
    other tests do); the value waits for its results."""
    d = tmp_path_factory.mktemp("ref_continual")
    src = d / "forests.npz"
    np.savez(src, **{f"{op}_{f}": np.asarray(forest[f])
                     for op, forest in zip(("read", "write"), forest_pair)
                     for f in FOREST_FIELDS})
    cfg = {"frozen": FROZEN, "online": "failing_ost", "seconds": SECONDS,
           "policy": POLICY, "gbdt": GBDT, "curriculum": CURRICULUM}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", CHILD, str(src), str(d), fuzz_report,
         json.dumps(cfg)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def result():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-3000:]
        with open(d / "child.json") as f:
            res = json.load(f)
        with open(d / "curriculum.json") as f:
            res["curriculum"] = json.load(f)
        res["oracle/refit"] = dict(np.load(d / "oracle_refit.npz"))
        return res

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def start_reference_early(reference):
    """Start the child with the module's first test."""


# --------------------------------------------------------------------- #
# the port's runs
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def frozen_runs(forest_pair):
    return {name: C.run_continual(
        get_scenario(name), fresh_model(forest_pair), online=False,
        seconds=SECONDS, policy=O.OnlinePolicy(**POLICY), device="cpu")
        for name in FROZEN}


@pytest.fixture(scope="module")
def online_run(forest_pair):
    """The online arm on ``failing_ost`` with its first refit's buffers
    and forests captured (the trainer's ``_refit`` wrapped)."""
    captured = {}
    orig = O.OnlineTrainer._refit

    def refit(self, ops, reason, tput):
        first = "interval" not in captured
        if first:
            captured["interval"] = self._interval
            captured["data"] = {op: self.buffers[op].dataset() for op in ops}
        rec = orig(self, ops, reason, tput)
        if first:
            captured["forests"] = {op: self.model.forest(op) for op in ops}
        return rec

    O.OnlineTrainer._refit = refit
    try:
        res = C.run_continual(
            get_scenario("failing_ost"), fresh_model(forest_pair),
            online=True, seconds=SECONDS, policy=O.OnlinePolicy(**POLICY),
            gbdt_params=GBDTParams(**GBDT), device="cpu")
    finally:
        O.OnlineTrainer._refit = orig
    return res, captured


def test_comparison_leaves_frozen_model_untouched(forest_pair, frozen_runs):
    model = fresh_model(forest_pair)
    before = {op: {f: getattr(model.forest(op), f).clone()
                   for f in ("feature", "threshold", "leaf")}
              for op in (READ, WRITE)}
    forest_objs = (model.read_forest, model.write_forest)
    rep = C.run_comparison("failing_ost", model, seconds=SECONDS,
                           policy=O.OnlinePolicy(**POLICY),
                           gbdt_params=GBDTParams(**GBDT), device="cpu")
    assert rep["refits"] >= 1
    assert (model.read_forest, model.write_forest) == forest_objs
    assert model._version == 0
    for op in (READ, WRITE):
        for f, v in before[op].items():
            assert torch.equal(getattr(model.forest(op), f), v), f
    # its frozen arm is the plain frozen run
    assert rep["frozen"] == json.loads(json.dumps(
        frozen_runs["failing_ost"].row()))
    assert rep["t_fail"] == 3.0


def _curriculum(forest_pair, report_path):
    model = fresh_model(forest_pair)
    rep = C.run_hard_case_curriculum(
        report_path, model, seconds=CURRICULUM["seconds"],
        policy=O.OnlinePolicy(**CURRICULUM["policy"]),
        gbdt_params=GBDTParams(**CURRICULUM["gbdt"]),
        max_cases=CURRICULUM["max_cases"], device="cpu")
    return rep, model


@pytest.fixture(scope="module")
def curriculum(forest_pair, fuzz_report):
    B.reset_loop_cache_stats()
    misses0 = B.loop_cache_stats()["misses"]
    rep, model = _curriculum(forest_pair, fuzz_report)
    keys = [k for k in B._FUSED_LOOPS if k[0] == id(model)]
    return rep, model, keys, B.loop_cache_stats()["misses"] - misses0


def test_curriculum_after_races_recapture(curriculum):
    """The refits bump the model's version, so the after races run loops
    keyed on the new version: captured anew, never the old forests'."""
    rep, model, keys, misses = curriculum
    assert model._version == rep["n_refits"] >= 1
    versions = sorted({k[1] for k in keys})
    assert versions == [0, model._version]
    n_buckets = sum(1 for k in keys if k[1] == 0)
    assert n_buckets >= 1
    assert sum(1 for k in keys if k[1] == model._version) == n_buckets
    assert misses >= 2 * n_buckets
    assert len(B._FUSED_LOOPS) <= 32


def test_reports_are_deterministic(forest_pair, fuzz_report, curriculum,
                                   tmp_path):
    texts = []
    for i in range(2):
        rep = C.run_comparison("degraded_ost", fresh_model(forest_pair),
                               seconds=2.0,
                               policy=O.OnlinePolicy(**POLICY),
                               gbdt_params=GBDTParams(**GBDT), device="cpu")
        with open(C.write_report(rep, str(tmp_path / f"c{i}"))) as f:
            texts.append(f.read())
    assert texts[0] == texts[1]
    rep2, _ = _curriculum(forest_pair, fuzz_report)
    paths = [C.write_curriculum_report(r, str(tmp_path / f"h{i}"))
             for i, r in enumerate((curriculum[0], rep2))]
    a, b = (open(p).read() for p in paths)
    assert a == b and json.loads(a)["schema"] == C.CURRICULUM_SCHEMA


def test_refusals(forest_pair):
    model = fresh_model(forest_pair)
    with pytest.raises(ValueError, match="model on"):
        C.run_continual(get_scenario("failing_ost"), model, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            C.run_continual(get_scenario("failing_ost"), model)
    # explore_eps joins the policy at the reference's place and default
    from repro.learn.online import OnlinePolicy as RefPolicy
    assert dataclasses.asdict(O.OnlinePolicy()) == \
        dataclasses.asdict(RefPolicy())
    assert [f.name for f in dataclasses.fields(O.OnlinePolicy)] == \
        [f.name for f in dataclasses.fields(RefPolicy)]
    assert O.OnlinePolicy().explore_eps == 0.15


# --------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------- #
def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.lab", *args],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_cli_continual_on_cpu(forest_pair, fuzz_report, tmp_path):
    prefix = str(tmp_path / "dial")
    fresh_model(forest_pair).save(prefix)
    proc = _cli("continual", "--seconds", "2", "--refit-every", "2",
                "--model", prefix, "--device", "cpu",
                "--out", str(tmp_path / "c"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "failing_ost: failure at t=3.0s" in proc.stdout
    rep = json.loads((tmp_path / "c" / "continual.json").read_text())
    assert len(rep["frozen"]["tput_mbs"]) == 4
    proc = _cli("continual", "--hard-from", fuzz_report, "--max-cases", "1",
                "--seconds", "2", "--model", prefix, "--device", "cpu",
                "--out", str(tmp_path / "h"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "1 triaged loser(s)" in proc.stdout
    rep = json.loads((tmp_path / "h" / "curriculum.json").read_text())
    assert rep["n_losers"] == 1
    if not torch.cuda.is_available():
        proc = _cli("continual", "--seconds", "1", "--model", prefix,
                    "--out", str(tmp_path / "x"))
        assert proc.returncode != 0 and "CUDA" in proc.stderr


# --------------------------------------------------------------------- #
# against the reference (last: the child runs while the tests above do)
# --------------------------------------------------------------------- #
def _agrees(xla: dict, oracle: dict) -> bool:
    return all(xla[k] == oracle[k] for k in SERIES + SCALARS)


@pytest.mark.parametrize("name", FROZEN)
def test_frozen_arm_equals_reference(frozen_runs, reference, name):
    got = json.loads(json.dumps(frozen_runs[name].row()))
    ref = reference()
    oracle, xla = ref[f"oracle/frozen/{name}"], ref[f"xla/frozen/{name}"]
    assert got["refits"] == [] and got["online"] is False
    for k in SERIES + SCALARS:
        assert got[k] == oracle[k], k          # bit for bit
    if _agrees(xla, oracle):
        for k in SERIES + SCALARS:
            assert got[k] == xla[k], k
    assert got["changes"] > 0 and len(got["tput_mbs"]) == 12
    # both regimes are seen: intervals before and after the onset
    assert got["pre_fail_mbs"] > 0 and got["post_fail_mbs"] > 0


def test_online_arm_equals_reference_through_first_refit(online_run,
                                                         reference):
    res, cap = online_run
    got = json.loads(json.dumps(res.row()))
    ref = reference()
    oracle = ref["oracle/online"]
    i = cap["interval"]
    assert res.refits and res.refits[0]["interval"] == i
    assert oracle["refits"][0] == got["refits"][0]
    for k in SERIES:
        assert got[k][:i] == oracle[k][:i], k
    rcap = ref["oracle/refit"]
    assert int(rcap["interval"]) == i
    for op, (X, y) in cap["data"].items():
        np.testing.assert_array_equal(X, rcap[f"X{op}"])
        np.testing.assert_array_equal(y, rcap[f"y{op}"])


def test_refit_forests(online_run, reference):
    """The port's first refit is its own ``fit_forest_batch`` of the
    reference's buffer rows; the reference's jitted refit of those rows
    ranks them as well (AUC within 0.05)."""
    _, cap = online_run
    rcap = reference()["oracle/refit"]
    ops = sorted(cap["forests"])
    data = [(rcap[f"X{op}"], rcap[f"y{op}"]) for op in ops]
    again = fit_forest_batch(data, GBDTParams(**GBDT), precision="fast",
                             device="cpu")
    compared = 0
    for i, (op, mine) in enumerate(zip(ops, again)):
        got = cap["forests"][op]
        for f in ("feature", "threshold", "leaf"):
            assert torch.equal(getattr(got, f), getattr(mine, f)), f
        assert got.base_score == mine.base_score
        ref_forest = model_from_numpy(
            {k: rcap[f"forest{i}_{k}"][()] for k in FOREST_FIELDS},
            {k: rcap[f"forest{i}_{k}"][()] for k in FOREST_FIELDS},
            device="cpu").read_forest
        X, y = data[i]
        if 0 < y.sum() < len(y):
            x = torch.as_tensor(X)
            a_port = _auc(got.predict_margin(x).numpy(), y)
            a_ref = _auc(ref_forest.predict_margin(x).numpy(), y)
            assert abs(a_port - a_ref) < 0.05, (op, a_port, a_ref)
            compared += 1
    assert compared >= 1


def test_curriculum_matches_reference(curriculum, reference, fuzz_report):
    rep = curriculum[0]
    ref = reference()
    want = ref["curriculum"]
    for k in ("schema", "source", "n_losers", "n_replays", "replay_seconds",
              "replay_interval", "race_seconds", "loss_threshold",
              "cause_weights", "gate_evidence"):
        assert json.loads(json.dumps(rep[k])) == want[k], k
    assert [(c["name"], c["fingerprint"], c["cause"], c["weight"])
            for c in rep["cases"]] == \
        [(c["name"], c["fingerprint"], c["cause"], c["weight"])
         for c in want["cases"]]
    assert rep["n_losers"] == CURRICULUM["max_cases"]
    assert rep["n_refits"] >= 1
    with open(fuzz_report) as f:
        rows = json.load(f)["triage"]["losses"]
    agreed = 0
    for c, w, o, row in zip(rep["cases"], want["cases"],
                            ref["oracle_races"], rows):
        b = c["before"]
        # the numpy oracle, and the sweep's own race of the same case
        assert [b["best_static_mbs"], b["dial_mbs"]] == o
        assert (b["dial_mbs"], b["best_static_mbs"]) == \
            (row["dial_mbs"], row["best_static_mbs"])
        assert b["best_static_theta"] == row["best_static_theta"]
        if w["before"]["dial_mbs"] == o[1]:
            assert json.loads(json.dumps(b)) == w["before"]
            agreed += 1
    # the before races that the reference's XLA engine agrees on
    print(f"{agreed} of {len(rep['cases'])} before races compared with "
          f"the reference's own")
    # the after races.  The refit forests come from different trainers
    # (ROADMAP Queue 3, reference fault 4), so the rates are printed, not
    # compared; what holds whatever trainer refit: both refit, both race
    # the same cases after at the same static θ, and a static arm, which
    # no model steers, races as it did before
    assert want["n_refits"] >= 1
    for got, ref_case, row in zip(rep["cases"], want["cases"], rows):
        for c in (got, ref_case):
            assert c["after"]["best_static_theta"] == \
                row["best_static_theta"], c["name"]
            assert c["after"]["best_static_mbs"] == \
                c["before"]["best_static_mbs"], c["name"]
    for side, r in (("port", rep), ("reference", want)):
        o = r["overall"]
        print(f"curriculum, {side}: loss rate {o['before_loss_rate']} -> "
              f"{o['after_loss_rate']} (delta {o['delta']}), "
              f"{r['n_refits']} refits")

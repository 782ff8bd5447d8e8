"""The port's loss-finding pipeline on the CPU: fuzz, diagnose, trace.

Held against the reference (``repro/lab/fuzz.py``, ``repro/obs/
diagnose.py``, ``repro/lab/trace.py``).  Under jax 0.9.0
``repro.lab.fuzz`` and ``repro.lab.batch`` import only with the alias
``jax.experimental.enable_x64 = jax.enable_x64``, so the reference runs
in a child process that sets it (this process never does):

- generation: ``SMOKE``, a seed-0 default config (512 specs) and the
  small sweep's config give the reference's specs, ``spec_to_dict`` and
  fingerprints;
- a small sweep (8 scenarios, 2 s, 3 static θ arms, topologies (2, 1)
  and (4, 2), diagnosis on): the reference's ``run_sweep`` and, as the
  oracle for its figures, the same races through the reference's host
  path (``run_batch`` with its ``FleetAgent``) on its numpy engine
  (``repro.pfs.state.engine_step``, element by element).  The port's
  rows are held to the numpy oracle at 1e-9 relative (bit-equal is
  observed), and to the reference's sweep at 1e-9 wherever that sweep
  agrees with its own numpy oracle.  On some generated scenarios with
  an ``ost_failover`` recovery ramp the reference's XLA engine drifts
  from its numpy engine by an ULP, which a discrete formation step
  amplifies to ~1% of MB/s (ROADMAP Queue 3); there the port follows
  the numpy oracle.  The loss set equals the oracle's except at the
  triage threshold (knife-edge, within 1e-9), each diagnosis's cause
  and arms equal the reference's where its race agrees.

On the port's own runs: reports byte-identical across two runs (fuzz
and diagnosis), ``diagnose_many`` ragged == one case at a time,
``race_many`` == ``race_scenario``, a triaged loser's trace, reports
read by the other package, and the CLI's ``fuzz``, ``trace`` and
``diagnose`` with ``--device cpu``.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.convert import model_from_numpy  # noqa: E402
from repro_torch.lab import fuzz as F  # noqa: E402
from repro_torch.lab.diagnose import specs_from_report  # noqa: E402
from repro_torch.lab.trace import (load_spec_from_report,  # noqa: E402
                                   trace_scenario, write_trace)
from repro_torch.obs.schema import TraceConfig  # noqa: E402
from repro_torch.obs.sinks import read_jsonl, read_jsonl_diagnosis  # noqa: E402
from test_torch_loop import FOREST_FIELDS, forests  # noqa: E402

# the modules (both packages' ``obs`` export a function ``diagnose``)
RD = importlib.import_module("repro.obs.diagnose")
D = importlib.import_module("repro_torch.obs.diagnose")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_scenarios=8, seconds=2.0,
             thetas=((16, 1), (256, 8), (1024, 32)),
             topologies=((2, 1), (4, 2)))
MBS = ("dial_mbs", "best_static_mbs", "dial_frac_of_best_static")


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


@pytest.fixture(scope="module")
def model(forest_pair):
    return model_from_numpy(*forest_pair, device="cpu")


# --------------------------------------------------------------------- #
# the reference in a child process
# --------------------------------------------------------------------- #
# the reference's per-interval batch engine on its numpy engine, element
# by element: the oracle for the reference's XLA engine (a child's
# source; it needs ``jax``, ``np`` and ``repro.pfs.state.engine_step``)
NUMPY_ENGINE = r"""
class NumpyBatchEngine:
    # the reference's numpy engine, one element at a time
    def __init__(self, params, topo, n_ticks, **_):
        self.params, self.topo, self.n_ticks = params, topo, n_ticks

    def run_interval(self, table, state, wstate, sched):
        outs = []
        for e in range(np.asarray(state.window_pages).shape[0]):
            take = lambda t: jax.tree.map(lambda a: np.array(np.asarray(a)[e]), t)
            st, ws, tb, sc = take(state), take(wstate), take(table), take(sched)
            st.now, st.tick_index = float(st.now), int(st.tick_index)
            for i in range(self.n_ticks):
                dem, ws = tb.demand_step(self.params, ws, st)
                st = engine_step(self.params, self.topo, st, dem,
                                 disturbance=jax.tree.map(lambda a: a[i], sc))
            outs.append((st, ws))
        stack = lambda ts: jax.tree.map(
            lambda *a: np.stack([np.asarray(x) for x in a]), *ts)
        return stack([o[0] for o in outs]), stack([o[1] for o in outs])


"""

CHILD = r"""
import dataclasses, json, sys
import jax
import jax.experimental
# jax 0.9.0 moved enable_x64; the reference imports the old name
jax.experimental.enable_x64 = jax.enable_x64
import numpy as np
from repro.core.gbdt import DenseForest
from repro.core.model import DIALModel
from repro.lab import fuzz as F
from repro.lab.batch import run_batch, stack_scenarios
from repro.lab.scenarios import build
from repro.pfs.state import engine_step

src, out = sys.argv[1:3]
small = json.loads(sys.argv[3])
small["thetas"] = tuple(map(tuple, small["thetas"]))
small["topologies"] = tuple(map(tuple, small["topologies"]))
z = np.load(src)
fields = ("feature", "threshold", "leaf", "base_score", "depth", "n_features")
model = DIALModel(*(DenseForest(**{f: z[f"{op}_{f}"][()] for f in fields})
                    for op in ("read", "write")))
res = {"smoke_config": dataclasses.asdict(F.SMOKE),
       "default_config": dataclasses.asdict(F.FuzzConfig())}
cfg = F.FuzzConfig(**small)
for name, c in (("smoke", F.SMOKE), ("default", F.FuzzConfig(seed=0)),
                ("small", cfg)):
    res[name] = [{"dict": F.spec_to_dict(s), "fingerprint": F.fingerprint(s),
                  "name": s.name, "seed": s.seed, "tags": list(s.tags),
                  "description": s.description}
                 for s in F.generate_specs(c)]
F.write_fuzz_report(F.run_sweep(cfg, model, diagnose=True), out + "/fuzz")


""" + NUMPY_ENGINE + r"""oracle = []
for spec in F.generate_specs(cfg):
    built = [build(dataclasses.replace(spec, initial_theta=th))
             for th in cfg.thetas] + [build(spec)]
    batch = stack_scenarios(built)
    n, m = batch.n_osc, len(cfg.thetas)
    steps = max(int(round(cfg.interval / batch.params.tick)), 1)
    fleet = run_batch(batch, model, seconds=cfg.seconds,
                      interval=cfg.interval, tune_cols=m * n + np.arange(n),
                      engine=NumpyBatchEngine(batch.params, batch.topo, steps))
    oracle.append({"mbs": batch.throughput(cfg.seconds)["total_mbs"].tolist(),
                   "changes": int(sum(int(r.decisions.changed.sum())
                                      for r in fleet.decisions))})
res["oracle"] = oracle
with open(out + "/child.json", "w") as f:
    json.dump(res, f)
"""


@pytest.fixture(scope="module")
def reference(forest_pair, tmp_path_factory):
    """Start the reference's runs in a child process (it runs while the
    other tests do); the value waits for its results."""
    d = tmp_path_factory.mktemp("ref_fuzz")
    src = d / "forests.npz"
    np.savez(src, **{f"{op}_{f}": np.asarray(forest[f])
                     for op, forest in zip(("read", "write"), forest_pair)
                     for f in FOREST_FIELDS})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", CHILD, str(src), str(d), json.dumps(SMALL)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def result():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-3000:]
        with open(d / "child.json") as f:
            res = json.load(f)
        with open(d / "fuzz" / "report.json") as f:
            res["report"] = json.load(f)
        res["report_path"] = str(d / "fuzz" / "report.json")
        return res

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def start_reference_early(reference):
    """Start the child with the module's first test."""


@pytest.fixture(scope="module")
def sweep(model, tmp_path_factory):
    """The port's small sweep, run twice into the same directory:
    ``(report, report.json bytes, report.md bytes, second run's)``."""
    out = tmp_path_factory.mktemp("port_fuzz") / "fuzz"
    cfg = F.FuzzConfig(**SMALL)
    files = []
    for _ in range(2):
        report = F.run_sweep(cfg, model, diagnose=True, device="cpu")
        jpath, mpath = F.write_fuzz_report(report, str(out))
        files.append((open(jpath).read(), open(mpath).read()))
    return report, jpath, files


def _knife_edge(row, threshold=0.05):
    return abs(row["dial_frac_of_best_static"] - (1 - threshold)) <= 1e-9


# --------------------------------------------------------------------- #
# diagnosis and trace on the port's own runs
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def losers(sweep):
    """The sweep's triaged losers as ``(spec, race)`` pairs."""
    return specs_from_report(sweep[1], None, True)


def test_diagnose_many_ragged_equals_per_case(model, losers, sweep,
                                              tmp_path):
    """``diagnose_many`` (one traced intervened run per bucket) gives
    per-case ``diagnose``'s dicts and the sweep's stamped diagnoses; its
    report is byte-identical across two runs and renders as the
    reference's markdown."""
    cfg = D.DiagnoseConfig.from_fuzz(F.FuzzConfig(**SMALL))
    pairs = losers[:3]
    many = D.diagnose_many(pairs, model, cfg, device="cpu")
    one = D.diagnose_many(pairs, model, cfg, ragged=False, device="cpu")
    assert many == one
    stamped = {r["fingerprint"]: r["diagnosis"]
               for r in sweep[0]["triage"]["losses"]}
    for d in many:
        assert {k: v for k, v in d.items()
                if k not in ("name", "fingerprint")} == stamped[
                    d["fingerprint"]]
    texts = []
    for _ in range(2):
        jpath, mpath = D.write_diagnosis_report(
            D.diagnose_many(pairs, model, cfg, device="cpu"),
            str(tmp_path / "diag"))
        texts.append((open(jpath).read(), open(mpath).read()))
    assert texts[0] == texts[1]
    report = json.loads(texts[0][0])
    assert report["n_diagnoses"] == 3
    assert RD.render_diagnosis_markdown(report) == texts[0][1]
    assert RD.cause_counts(many) == D.cause_counts(many) == report["causes"]


def test_race_many_equals_race_scenario(model, losers):
    cfg = D.DiagnoseConfig.from_fuzz(F.FuzzConfig(**SMALL))
    cases = [(spec, race["best_static_theta"]) for spec, race in losers[:2]]
    many = D.race_many(cases, model, cfg, device="cpu")
    for (spec, theta), got in zip(cases, many):
        one = D.race_scenario(spec, model, dataclasses.replace(
            cfg, thetas=(tuple(theta),)), device="cpu")
        assert got == one
    # the sweep's full-grid race of the worst loser, replayed
    spec, race = losers[0]
    assert D.race_scenario(spec, model, cfg, device="cpu") == race


def test_trace_of_worst_loser(model, sweep, tmp_path):
    """The worst triaged loser, traced: its decisions replay the sweep's
    DIAL arm, and the three sinks read back."""
    report, jpath, _ = sweep
    worst = report["triage"]["losses"][0]
    spec = load_spec_from_report(jpath, worst["fingerprint"])
    trace = trace_scenario(spec, model, seconds=2.0,
                           config=TraceConfig(stride=20), device="cpu")
    n = spec.n_clients * spec.n_osts
    assert (trace.n_intervals, trace.n_interfaces) == (4, n)
    assert int(trace.decisions["changed"].sum()) == worst["changes"]
    assert trace.timeline["read_bytes"].shape == (20, spec.n_osts)
    diag = {k: v for k, v in worst["diagnosis"].items()}
    paths = write_trace(trace, str(tmp_path / "trace"), title=spec.name,
                        diagnosis=diag)
    back = read_jsonl(paths["jsonl"])
    back.validate()
    np.testing.assert_array_equal(back.decisions["theta"],
                                  trace.decisions["theta"])
    assert read_jsonl_diagnosis(paths["jsonl"]) == json.loads(
        json.dumps(diag, sort_keys=True))
    with open(paths["chrome"]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("verdict:") for e in events)
    with open(paths["md"]) as f:
        assert "## Diagnosis" in f.read()


def test_refusals(model):
    cfg = F.FuzzConfig(**SMALL)
    with pytest.raises(ValueError, match="model on"):
        F.run_sweep(cfg, model, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            F.run_sweep(cfg, model)
        with pytest.raises(RuntimeError, match="CUDA"):
            D.race_scenario(F.generate_spec(cfg, 0), model,
                            D.DiagnoseConfig())


# --------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------- #
def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.lab", *args],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_cli_fuzz_trace_diagnose_on_cpu(model, sweep, tmp_path):
    prefix = str(tmp_path / "dial")
    model.save(prefix)
    out = tmp_path / "fuzz"
    proc = _cli("fuzz", "--smoke", "--n", "4", "--seconds", "1",
                "--model", prefix, "--device", "cpu", "--out", str(out))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "4 scenarios" in proc.stdout
    rep = json.loads((out / "report.json").read_text())
    assert rep["config"]["n_scenarios"] == 4
    assert len(rep["config"]["thetas"]) == 6
    jpath = sweep[1]
    fp = sweep[0]["triage"]["losses"][0]["fingerprint"]
    proc = _cli("trace", "--from-report", jpath, "--fingerprint", fp,
                "--seconds", "1", "--model", prefix, "--device", "cpu",
                "--out", str(tmp_path / "trace"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "# Trace summary" in proc.stdout
    assert read_jsonl(str(tmp_path / "trace" / "trace.jsonl")).n_intervals \
        == 2
    proc = _cli("diagnose", "--from-report", jpath, "--fingerprint", fp,
                "--seconds", "2", "--model", prefix, "--device", "cpu",
                "--out", str(tmp_path / "diag"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    diag = json.loads((tmp_path / "diag" / "diagnosis.json").read_text())
    assert diag["n_diagnoses"] == 1
    assert diag["diagnoses"][0]["cause"] == \
        sweep[0]["triage"]["losses"][0]["diagnosis"]["cause"]
    if not torch.cuda.is_available():
        proc = _cli("fuzz", "--smoke", "--n", "2", "--model", prefix,
                    "--out", str(out))
        assert proc.returncode != 0 and "CUDA" in proc.stderr


# --------------------------------------------------------------------- #
# generation
# --------------------------------------------------------------------- #
def test_fuzz_config_equals_reference(reference):
    ref = reference()
    for name, mine in (("smoke_config", F.SMOKE),
                       ("default_config", F.FuzzConfig())):
        want = {k: v for k, v in ref[name].items() if k != "seg_backend"}
        got = json.loads(json.dumps(dataclasses.asdict(mine)))
        assert got == want, name
    assert "seg_backend" not in {f.name for f in
                                 dataclasses.fields(F.FuzzConfig)}


@pytest.mark.parametrize("which", ["smoke", "default", "small"])
def test_generated_specs_equal_reference(reference, which):
    cfg = {"smoke": F.SMOKE, "default": F.FuzzConfig(seed=0),
           "small": F.FuzzConfig(**SMALL)}[which]
    want = reference()[which]
    got = F.generate_specs(cfg)
    assert len(got) == len(want) == cfg.n_scenarios
    for s, w in zip(got, want):
        assert json.loads(json.dumps(F.spec_to_dict(s))) == w["dict"]
        assert F.fingerprint(s) == w["fingerprint"]
        assert (s.name, s.seed, list(s.tags), s.description) == \
            (w["name"], w["seed"], w["tags"], w["description"])
    # every generated spec replays from its dict to the same physics
    for s in got[:64]:
        back = F.spec_from_dict(json.loads(json.dumps(F.spec_to_dict(s))),
                                name=s.name)
        assert F.spec_to_dict(back) == F.spec_to_dict(s)
        assert F.fingerprint(back) == F.fingerprint(s)


# --------------------------------------------------------------------- #
# the sweep against the reference and its numpy oracle
# --------------------------------------------------------------------- #
def test_sweep_rows_match_reference(sweep, reference):
    report = sweep[0]
    ref = reference()
    want = ref["report"]
    assert [r["fingerprint"] for r in report["scenarios"]] == \
        [r["fingerprint"] for r in want["scenarios"]]
    assert {k: v for k, v in want["config"].items()
            if k != "seg_backend"} == report["config"]
    drifted = []
    for got, w, oracle in zip(report["scenarios"], want["scenarios"],
                              ref["oracle"]):
        assert got.keys() == w.keys()
        for k in ("index", "name", "n_clients", "n_osts", "initial_theta",
                  "event_kinds"):
            assert got[k] == w[k], k
        # the numpy oracle: every arm's MB/s, DIAL's changes
        mbs = oracle["mbs"]
        np.testing.assert_allclose(got["dial_mbs"], mbs[-1], rtol=1e-9)
        np.testing.assert_allclose(got["best_static_mbs"], max(mbs[:-1]),
                                   rtol=1e-9)
        assert got["best_static_theta"] == list(
            SMALL["thetas"][int(np.argmax(mbs[:-1]))])
        assert got["changes"] == oracle["changes"]
        # the reference's sweep, wherever it agrees with its oracle
        agrees = np.isclose(w["dial_mbs"], mbs[-1], rtol=1e-9, atol=0)
        np.testing.assert_allclose(w["best_static_mbs"], max(mbs[:-1]),
                                   rtol=1e-9)
        if agrees:
            for k in MBS:
                np.testing.assert_allclose(got[k], w[k], rtol=1e-9,
                                           err_msg=k)
            assert got["changes"] == w["changes"]
            assert got["best_static_theta"] == w["best_static_theta"]
        else:
            drifted.append(got["index"])
    # the comparison with the reference's sweep is not vacuous
    assert len(drifted) < len(report["scenarios"]), drifted


def test_sweep_losses_match_reference(sweep, reference):
    report = sweep[0]
    ref = reference()
    got = {r["fingerprint"] for r in report["triage"]["losses"]}
    assert report["summary"]["n_losses"] == len(got) > 0
    rows = {r["fingerprint"]: r for r in report["scenarios"]}
    # the oracle's loss set
    oracle = set()
    for r, o in zip(report["scenarios"], ref["oracle"]):
        best = max(o["mbs"][:-1])
        if best >= 1.0 and o["mbs"][-1] < 0.95 * best:
            oracle.add(r["fingerprint"])
    assert all(_knife_edge(rows[fp]) for fp in got ^ oracle)
    # the reference's, on the scenarios where its sweep agrees
    agree = {r["fingerprint"] for r, o in zip(ref["report"]["scenarios"],
                                              ref["oracle"])
             if np.isclose(r["dial_mbs"], o["mbs"][-1], rtol=1e-9, atol=0)}
    theirs = {r["fingerprint"] for r in ref["report"]["triage"]["losses"]}
    assert all(_knife_edge(rows[fp]) for fp in (got ^ theirs) & agree)
    order = [r["dial_frac_of_best_static"]
             for r in report["triage"]["losses"]]
    assert order == sorted(order)
    s, w = report["summary"], ref["report"]["summary"]
    for k in ("n_scenarios", "n_buckets", "n_dispatches", "n_unique_specs",
              "bucket_occupancy"):
        assert s[k] == w[k], k


def test_diagnoses_match_reference(sweep, reference):
    """Every loser carries a diagnosis; where the reference's race agrees
    with the port's, the cause, arms, signals and evidence are equal."""
    report = sweep[0]
    ref = reference()["report"]
    losses = report["triage"]["losses"]
    assert report["summary"]["n_diagnosed"] == len(losses)
    assert sum(report["summary"]["loss_causes"].values()) == len(losses)
    theirs = {r["fingerprint"]: r for r in ref["triage"]["losses"]}
    compared = 0
    for r in losses:
        d = r["diagnosis"]
        assert d["cause"] in D.CAUSES and d["schema"] == D.DIAGNOSIS_SCHEMA
        assert set(d["arms"]) == set(D.ARMS)
        assert d["n_intervals"] == 4
        assert "seg_backend" not in d["config"]
        w = theirs.get(r["fingerprint"])
        if w is None or not np.isclose(r["dial_mbs"], w["dial_mbs"],
                                       rtol=1e-9, atol=0):
            continue
        wd = w["diagnosis"]
        assert d["cause"] == wd["cause"]
        for arm, v in wd["arms"].items():
            np.testing.assert_allclose(d["arms"][arm], v, rtol=1e-9,
                                       err_msg=arm)
        assert d["signals"] == wd["signals"]
        assert d["evidence"] == wd["evidence"]
        assert d["n_evidence_total"] == wd["n_evidence_total"]
        assert {k: v for k, v in wd["config"].items()
                if k != "seg_backend"} == d["config"]
        compared += 1
    assert compared >= 1


def test_reports_are_deterministic(sweep):
    (j1, m1), (j2, m2) = sweep[2]
    assert j1 == j2 and m1 == m2
    assert m1.startswith("# Fuzz sweep triage")
    assert "python -m repro_torch.lab trace --from-report" in j1


def test_reports_read_both_ways(sweep, reference, tmp_path):
    """The port replays the reference's triaged losers, and the
    reference the port's (a second child)."""
    report, jpath, _ = sweep
    ref = reference()
    theirs = F.load_hard_specs(ref["report_path"])
    fps = [r["fingerprint"] for r in ref["report"]["triage"]["losses"]]
    assert [F.fingerprint(s) for s in theirs] == fps
    fp = fps[0]
    assert F.fingerprint(load_spec_from_report(ref["report_path"], fp)) == fp
    pairs = specs_from_report(ref["report_path"], None, True)
    assert [F.fingerprint(s) for s, _ in pairs] == fps
    assert pairs[0][1]["dial_mbs"] == ref["report"]["triage"]["losses"][0][
        "dial_mbs"]
    with pytest.raises(KeyError, match="not in"):
        load_spec_from_report(jpath, "no-such-fp")
    with pytest.raises(KeyError, match="not in"):
        specs_from_report(jpath, "no-such-fp", False)
    code = (
        "import json, sys\n"
        "import jax, jax.experimental\n"
        "jax.experimental.enable_x64 = jax.enable_x64\n"
        "from repro.lab import fuzz as F\n"
        "from repro.lab.trace import load_spec_from_report\n"
        "r = json.load(open(sys.argv[1]))\n"
        "specs = F.load_hard_specs(sys.argv[1])\n"
        "fp = r['triage']['losses'][0]['fingerprint']\n"
        "print(json.dumps({'fps': [F.fingerprint(s) for s in specs],\n"
        "  'one': F.fingerprint(load_spec_from_report(sys.argv[1], fp)),\n"
        "  'md': F.render_markdown(r)}))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code, jpath], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.splitlines()[-1])
    mine = [r["fingerprint"] for r in report["triage"]["losses"]]
    assert got["fps"] == mine and got["one"] == mine[0]
    with open(jpath[:-len("json")] + "md") as f:
        assert got["md"] == f.read()

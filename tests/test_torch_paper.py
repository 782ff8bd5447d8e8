"""The paper's experiments on the port, held against the reference on the
CPU: Table II (``benchmarks/torch_table2_h5bench.py``), Fig. 3
(``benchmarks/torch_fig3_dlio.py``), the collect + train CLI
(``python -m repro_torch.core.dataset``) and the multi-agent example
(``examples/torch_dial_vs_static.py``).

Both packages load one model: the session ``dial_model`` fixture's
forests, saved under ``tmp_path``.  The depth is cut (2 s runs, three of
Θ's configurations with Lustre's default among them, two Fig. 3 cases, a
3 s collect); the bar is the repo's: θ trajectories identical, MB/s
within 1e-6 relative (bit-equal is expected: the CPU port's engine is
the reference's numpy arithmetic), ``optimal_cfg`` equal.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import benchmarks.fig3_dlio as ref_fig3  # noqa: E402
import benchmarks.table2_h5bench as ref_t2  # noqa: E402
import benchmarks.torch_fig3_dlio as fig3  # noqa: E402
import benchmarks.torch_table2_h5bench as t2  # noqa: E402
from repro.core import dataset as ref_dataset  # noqa: E402
from repro.core.model import DIALModel as RefModel  # noqa: E402
from repro.pfs import PFSSim as RefSim  # noqa: E402
from repro.core.agent import run_with_agents as ref_run_with_agents  # noqa: E402
from repro_torch.core import dataset  # noqa: E402
from repro_torch.core.model import DIALModel  # noqa: E402

SECONDS = 2.0
CONFIGS = [(256, 8), (16, 1), (1024, 32)]      # Lustre's default first
FIG3_CASES = [("bert", 8, 1), ("megatron", 32, 4)]


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These sizes run fastest on one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models(dial_model, tmp_path_factory):
    """The fixture's forests saved once, loaded by both packages."""
    prefix = str(tmp_path_factory.mktemp("paper") / "models" / "dial")
    os.makedirs(os.path.dirname(prefix))
    dial_model.save(prefix)
    return prefix, RefModel.load(prefix), DIALModel.load(prefix,
                                                         device="cpu")


def _ref_arm(make_wl, window, inflight, model, seconds):
    """The reference's ``_run`` body, keeping its fleet for θ."""
    sim = RefSim(n_clients=1, n_osts=8, seed=11)
    wl = make_wl()
    sim.attach(wl)
    sim.set_knobs(sim.client_oscs(0), window_pages=window,
                  rpcs_in_flight=inflight)
    fleet = ref_run_with_agents(sim, model, [0], seconds)
    return wl.done_bytes(sim) / seconds / 1e6, fleet


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= 1e-6 * max(abs(b), 1.0)


@pytest.mark.parametrize("name", [name for name, _ in t2.WORKLOADS])
def test_table2_workload_matches_reference(models, name):
    """One Table II row at 2 s over three configurations: every static
    arm's MB/s, the optimal configuration, and the DIAL arm's θ
    trajectory and MB/s."""
    _, ref_model, model = models
    mk, ref_mk = dict(t2.WORKLOADS)[name], dict(ref_t2.WORKLOADS)[name]
    grid = [((w, f), t2._run(mk, w, f, seconds=SECONDS, device="cpu"))
            for w, f in CONFIGS]
    ref_grid = [((w, f), ref_t2._run(ref_mk, w, f, seconds=SECONDS))
                for w, f in CONFIGS]
    for (cfg, mbs), (_, ref) in zip(grid, ref_grid):
        assert _close(mbs, ref), (cfg, mbs, ref)
    best = max(ref_grid, key=lambda g: g[1])      # the first of a tie
    assert t2.optimal(grid)[1] == best[0]

    dial = t2.arm(mk, *t2.DEFAULT, tuned_model=model, seconds=SECONDS,
                  device="cpu")
    ref_mbs, ref_fleet = _ref_arm(ref_mk, *t2.DEFAULT, ref_model, SECONDS)
    assert t2.trajectory(dial.fleet) == t2.trajectory(ref_fleet)
    assert _close(dial.mbs, ref_mbs), (dial.mbs, ref_mbs)
    assert ref_t2._run(ref_mk, *t2.DEFAULT, tuned_model=ref_model,
                       seconds=SECONDS) == ref_mbs
    row = t2.row({"workload": name, "grid": [(c, dial) for c, _ in grid],
                  "dial": dial})
    assert set(row) == {"workload", "optimal_mbs", "optimal_cfg",
                        "dial_mbs", "dial_frac_of_optimal"}


@pytest.mark.parametrize("case", FIG3_CASES)
def test_fig3_case_matches_reference(models, case, monkeypatch):
    """One Fig. 3 case at 2 s (both modules' ``SECONDS`` set): the
    default and DIAL arms' MB/s and the DIAL arm's θ trajectory."""
    _, ref_model, model = models
    monkeypatch.setattr(fig3, "SECONDS", SECONDS)
    monkeypatch.setattr(ref_fig3, "SECONDS", SECONDS)
    assert _close(fig3._run(*case, device="cpu"), ref_fig3._run(*case))
    dial = fig3.arm(*case, dial_model=model, device="cpu")
    m, t, o = case
    ref_mbs, ref_fleet = _ref_arm(
        lambda: ref_fig3.dlio_reader(0, m, t, osts=tuple(range(o))), 256, 8,
        ref_model, SECONDS)
    assert t2.trajectory(dial.fleet) == t2.trajectory(ref_fleet)
    assert _close(dial.mbs, ref_mbs), (dial.mbs, ref_mbs)
    assert ref_fig3._run(*case, dial_model=ref_model) == ref_mbs
    assert set(fig3.row({"case": case, "default": dial, "dial": dial})) == {
        "kernel", "threads", "osts", "default_mbs", "dial_mbs", "speedup"}


def test_dataset_cli_matches_reference(tmp_path, capsys):
    """``python -m repro_torch.core.dataset --seconds 3 --reps 1 --device
    cpu`` against the reference's ``main`` with the same flags: the same
    printed lines and ``.npz`` files.  Every array is equal but the
    float32 leaves, which the two trainers sum in another order (held at
    the repo's forest bar, 1e-5)."""
    flags = ["--seconds", "3", "--reps", "1"]
    ref_dataset.main(["--out", str(tmp_path / "ref")] + flags)
    ref_out = capsys.readouterr().out
    data, model = dataset.main(["--out", str(tmp_path / "port")] + flags
                               + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.replace("port", "ref") == ref_out
    assert len(data["read"][0]) > 0 and model.device.type == "cpu"
    for op in ("read", "write"):
        a = np.load(tmp_path / f"port.{op}.npz")
        b = np.load(tmp_path / f"ref.{op}.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            if k == "leaf":
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    RefModel.load(str(tmp_path / "port"))
    DIALModel.load(str(tmp_path / "ref"), device="cpu")


def test_dial_vs_static_example_matches_reference(models, monkeypatch):
    """The four independent agents of ``examples/torch_dial_vs_static.py``
    at 2 s, run from a directory holding ``models/dial``: per-client MB/s
    against the reference example's."""
    prefix = models[0]
    monkeypatch.chdir(os.path.dirname(os.path.dirname(prefix)))
    port = _example("torch_dial_vs_static").scenario(True, seconds=SECONDS,
                                                     device="cpu")
    ref = _example("dial_vs_static").scenario(True, seconds=SECONDS)
    assert len(port) == len(ref) == 4
    for a, b in zip(port, ref):
        assert _close(a, b), (port, ref)


def test_run_engine_keeps_one_loop_per_shape_and_equals_sim_run():
    """``run_engine`` (a static arm's driver): two sims of one shape with
    other knobs share one engine-only loop, and each ends in the state
    ``PFSSim.run`` reaches over the same ticks, bit for bit."""
    from repro_torch.pfs import loop_torch

    loop_torch._ENGINE_LOOPS.clear()
    for knobs in ((256, 8), (16, 1)):
        sims = []
        for _ in range(2):
            wl = t2.WORKLOADS[4][1]()
            sims.append(t2.start(wl, *knobs, torch.device("cpu")))
        loop_torch.run_engine(sims[0], 1.0)
        sims[1].run(1.0)
        for f in ("ctr_bytes_done", "ctr_rpcs_sent", "ctr_latency_sum",
                  "dirty_bytes", "window_pages"):
            assert torch.equal(getattr(sims[0].state, f),
                               getattr(sims[1].state, f)), f
        assert sims[0].done_bytes() == sims[1].done_bytes()
    assert len(loop_torch._ENGINE_LOOPS) == 1

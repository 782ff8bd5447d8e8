"""The port's offline pipeline (collect -> train -> save/load) and online
refit against the reference.

* The exact trainer (float64) must reproduce the numpy trainer
  ``GBDTClassifier`` split for split under the criteria of
  ``tests/test_learn.py::_assert_forests_match``: features equal,
  thresholds and leaves within 1e-5, base score equal.  The reference's
  own jitted ``fit_forest`` cannot run here (``boost.py::_x64_ctx``
  imports ``jax.experimental.enable_x64``, gone in jax 0.9), so the numpy
  trainer is the oracle, as it is the jitted trainer's.
* The fast trainer (float32) must hold held-out AUC > 0.9 and within
  0.05 of the numpy trainer's (the reference's bar).
* ``collect`` must give the reference's labels exactly and its rows
  within 1e-5 relative.
* Artifacts cross-load both ways and score the same rows within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.dataset import CollectConfig as RefCollectConfig  # noqa: E402
from repro.core.dataset import collect as ref_collect  # noqa: E402
from repro.core.dataset import train_models as ref_train_models  # noqa: E402
from repro.core.gbdt import DenseForest as RefForest  # noqa: E402
from repro.core.gbdt import GBDTClassifier  # noqa: E402
from repro.core.gbdt import GBDTParams as RefParams  # noqa: E402
from repro.core.model import DIALModel as RefModel  # noqa: E402
from repro.core.model import dataset_fingerprint as ref_fingerprint  # noqa: E402
from repro_torch.convert import forest_to_numpy  # noqa: E402
from repro_torch.core.dataset import CollectConfig, collect, train_models  # noqa: E402
from repro_torch.core.fleet import FleetAgent, SimFleetPort  # noqa: E402
from repro_torch.core.gbdt import GBDTParams  # noqa: E402
from repro_torch.core.metrics import feature_dim  # noqa: E402
from repro_torch.core.model import DIALModel, dataset_fingerprint  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.learn.boost import training_index  # noqa: E402
from repro_torch.learn import (DriftDetector, OnlinePolicy,  # noqa: E402
                               OnlineTrainer, ReplayBuffer, fit_forest,
                               fit_forest_batch)
from repro_torch.pfs import workloads as W  # noqa: E402
from repro_torch.pfs.engine import PFSSim  # noqa: E402
from repro_torch.pfs.engine_torch import FusedEngine  # noqa: E402
from repro_torch.pfs.state import READ, WRITE  # noqa: E402
from repro_torch.pfs.workloads import table_from_sim  # noqa: E402

PARAM_FIELDS = ("n_trees", "max_depth", "learning_rate", "reg_lambda",
                "min_gain", "min_child_hess", "n_bins", "subsample", "seed")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU runs of these small shapes are fastest on one thread; many
    intra-op threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_params(p: GBDTParams) -> RefParams:
    return RefParams(**{f: getattr(p, f) for f in PARAM_FIELDS})


def as_ref(forest) -> RefForest:
    return RefForest(**forest_to_numpy(forest))


def assert_forests_match(f1, f2, tol: float = 1e-5) -> None:
    """``tests/test_learn.py::_assert_forests_match``."""
    np.testing.assert_array_equal(f1.feature, f2.feature)
    thr_ok = (np.isclose(f1.threshold, f2.threshold, atol=tol)
              | (np.isinf(f1.threshold) & np.isinf(f2.threshold)))
    assert thr_ok.all(), "thresholds diverge beyond tolerance"
    np.testing.assert_allclose(f1.leaf, f2.leaf, atol=tol)
    assert f1.base_score == pytest.approx(f2.base_score, abs=tol)
    assert (f1.depth, f1.n_features) == (f2.depth, f2.n_features)


def _toy(n=2500, d=10, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = ((X[:, 0] > 0.3) & (X[:, 1] < 0.5)
         | (X[:, 2] * X[:, 3] > 1.0)).astype(float)
    return X, y


def _auc(scores, labels):
    order = np.argsort(scores)
    r = np.empty(len(scores))
    r[order] = np.arange(1, len(scores) + 1)
    pos = labels == 1
    n_pos, n_neg = pos.sum(), (~pos).sum()
    return (r[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


# ---------------------------------------------------------------------- #
# trainer parity with the numpy trainer
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 3])
def test_fit_forest_reproduces_numpy_trainer(seed):
    X, y = _toy(seed=seed)
    p = GBDTParams(n_trees=25, max_depth=5, seed=seed)
    f_np = GBDTClassifier(ref_params(p)).fit(X, y).forest
    LAUNCHES.clear()
    f_pt = as_ref(fit_forest(X, y, p, device="cpu"))
    assert dict(LAUNCHES) == {}       # the CPU runs the plain versions
    assert_forests_match(f_np, f_pt)
    np.testing.assert_allclose(f_np.predict_margin(X[:256]),
                               f_pt.predict_margin(X[:256]), atol=1e-5)


def test_fit_forest_batch_pads_and_matches():
    """A read/write-shaped pair (different n and F) trained as one batch."""
    rng = np.random.default_rng(42)
    Xa = rng.normal(size=(900, 8))
    ya = (Xa[:, 0] > 0).astype(float)
    Xb = rng.normal(size=(1300, 12))
    yb = (Xb[:, 1] + Xb[:, 2] > 0.5).astype(float)
    p = GBDTParams(n_trees=15, max_depth=4)
    fa, fb = fit_forest_batch([(Xa, ya), (Xb, yb)], p, device="cpu")
    assert (fa.n_features, fb.n_features) == (8, 12)
    assert_forests_match(GBDTClassifier(ref_params(p)).fit(Xa, ya).forest,
                         as_ref(fa))
    assert_forests_match(GBDTClassifier(ref_params(p)).fit(Xb, yb).forest,
                         as_ref(fb))


def test_fit_forest_batch_sweeps_continuous_hyperparams():
    """Per-forest learning rates ride the batch axis; each forest matches
    its own sequential numpy fit."""
    X, y = _toy(n=1200, seed=5)
    plist = [GBDTParams(n_trees=10, max_depth=4, learning_rate=lr)
             for lr in (0.05, 0.2)]
    out = fit_forest_batch([(X, y), (X, y)], plist, device="cpu")
    for p, f in zip(plist, out):
        assert_forests_match(GBDTClassifier(ref_params(p)).fit(X, y).forest,
                             as_ref(f))
    with pytest.raises(ValueError, match="structural"):
        fit_forest_batch([(X, y), (X, y)],
                         [GBDTParams(n_trees=3), GBDTParams(n_trees=4)],
                         device="cpu")


def test_fit_forest_skips_features_that_cannot_split():
    """Constant columns are left out of the histograms (the trainer's
    bin index does not walk them); the trees still match the numpy
    trainer's, with the node totals read off the first splittable
    feature."""
    X, y = _toy(n=1500, seed=7)
    X = np.concatenate([np.full((len(X), 2), 3.0), X], axis=1)
    X[:, 5] = -1.0
    p = GBDTParams(n_trees=15, max_depth=5, seed=7)
    assert_forests_match(GBDTClassifier(ref_params(p)).fit(X, y).forest,
                         as_ref(fit_forest(X, y, p, device="cpu")))
    # forest 0: features 1 and 3 occupy two bins among the real rows
    # (feature 2 only through its padding row); forest 1: none does
    Xb = torch.tensor([[[0, 0, 1, 2], [0, 1, 1, 0], [0, 1, 0, 0]],
                       [[2, 2, 0, 1], [2, 2, 0, 1], [0, 0, 3, 0]]],
                      dtype=torch.int32)
    valid = torch.tensor([[True, True, False], [True, True, False]])
    index, f_tot = training_index(Xb, valid, torch.tensor([1.0, 1.0]), 4)
    assert index.walk.tolist() == [[False, True, False, True],
                                   [True, False, False, False]]
    assert f_tot.tolist() == [1, 0]
    index, _ = training_index(Xb, valid, torch.tensor([1.0, 0.0]), 4)
    assert index.walk[1].all()          # min_child_hess 0: any cut may pass


def test_fast_mode_statistical_parity():
    X, y = _toy(n=3000, seed=9)
    p = GBDTParams(n_trees=30, max_depth=5)
    f_np = GBDTClassifier(ref_params(p)).fit(X[:2000], y[:2000]).forest
    f_fast = fit_forest(X[:2000], y[:2000], p, precision="fast",
                        device="cpu")
    assert f_fast.leaf.dtype == torch.float32
    a_np = _auc(f_np.predict_margin(X[2000:]), y[2000:])
    a_fast = _auc(as_ref(f_fast).predict_margin(X[2000:]), y[2000:])
    assert a_fast > 0.9
    assert abs(a_np - a_fast) < 0.05
    with pytest.raises(ValueError, match="precision"):
        fit_forest(X[:50], y[:50], p, precision="half", device="cpu")


# ---------------------------------------------------------------------- #
# collect -> train -> save/load, the slice as a whole
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def collected():
    ref = ref_collect(RefCollectConfig(seconds=3.0, reps=1))
    port = collect(CollectConfig(seconds=3.0, reps=1), device="cpu")
    return ref, port


def test_collect_matches_reference(collected):
    ref, port = collected
    for op in ("read", "write"):
        (Xa, ya), (Xb, yb) = ref[op], port[op]
        assert len(Xa) > 0 and Xb.shape == Xa.shape
        assert Xb.dtype == np.float32 and yb.dtype == np.float64
        np.testing.assert_array_equal(yb, ya)
        np.testing.assert_allclose(Xb, Xa, rtol=1e-5)
    assert dataset_fingerprint(port)["rows"] == ref_fingerprint(ref)["rows"]


def test_collect_with_contention_matches_reference():
    """The optional noise clients (fresh client ids on shared OSTs)."""
    ref = ref_collect(RefCollectConfig(seconds=2.0, reps=1,
                                       include_contention=True, seed=1))
    port = collect(CollectConfig(seconds=2.0, reps=1,
                                 include_contention=True, seed=1),
                   device="cpu")
    for op in ("read", "write"):
        (Xa, ya), (Xb, yb) = ref[op], port[op]
        assert len(Xa) > 0 and Xb.shape == Xa.shape
        np.testing.assert_array_equal(yb, ya)
        np.testing.assert_allclose(Xb, Xa, rtol=1e-5)


def test_train_models_matches_reference_and_artifacts_cross_load(
        collected, tmp_path):
    ref, port = collected
    r_model = ref_train_models(ref)                     # numpy, defaults
    p_model = train_models(port, device="cpu")
    assert p_model.train_meta["dataset"]["rows"] == \
        r_model.train_meta["dataset"]["rows"]
    for op in (READ, WRITE):
        assert_forests_match(r_model.forest(op), as_ref(p_model.forest(op)))

    # the port's artifacts in the reference, and the other way round
    p_model.save(str(tmp_path / "port"))
    r_loaded = RefModel.load(str(tmp_path / "port"))
    assert r_loaded.train_meta["trainer_backend"] == "torch"
    r_model.save(str(tmp_path / "ref"))
    p_loaded = DIALModel.load(str(tmp_path / "ref"), device="cpu")
    for op, name in ((READ, "read"), (WRITE, "write")):
        X = ref[name][0]
        x = torch.as_tensor(X)
        np.testing.assert_allclose(r_loaded.predict_proba(op, X),
                                   p_model.predict_proba(op, x).numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(p_loaded.predict_proba(op, x).numpy(),
                                   r_model.predict_proba(op, X), atol=1e-5)


# ---------------------------------------------------------------------- #
# online machinery
# ---------------------------------------------------------------------- #
def test_replay_buffer_ring_semantics():
    buf = ReplayBuffer(capacity=8, dim=3)
    buf.add(np.ones((5, 3)), np.arange(5))
    assert len(buf) == 5
    buf.add(2 * np.ones((6, 3)), np.arange(5, 11))   # wraps
    assert len(buf) == 8
    X, y = buf.dataset()
    assert X.shape == (8, 3)
    assert set(y) == set(range(3, 11))               # oldest 3 evicted
    # oversized insert keeps only the newest capacity rows
    buf.add(np.arange(30).reshape(10, 3), np.arange(100, 110))
    X, y = buf.dataset()
    assert len(buf) == 8 and set(y) == set(range(102, 110))


def test_drift_detector_fires_on_collapse():
    det = DriftDetector(fast=0.5, slow=0.08, drop_frac=0.75, warmup=4)
    assert not any(det.update(100.0) for _ in range(10))
    fired = [det.update(10.0) for _ in range(4)]
    assert any(fired)
    det.reset(10.0)
    assert not any(det.update(10.0) for _ in range(10))


def _fleet_sim():
    sim = PFSSim(8, 4, device="cpu")
    for c in range(8):
        if c % 4 == 0:
            sim.attach(W.vpic_write(c, dims=1 + c % 3))
        elif c % 4 == 1:
            sim.attach(W.bdcats_read(c, "strided"))
        elif c % 4 == 2:
            sim.attach(W.dlio_reader(c, "bert", n_threads=4, osts=(c % 4,)))
        else:
            sim.attach(W.random_stream(c, WRITE, 256 * 1024, ost=c % 4,
                                       n_threads=2))
    sim.set_knobs(np.arange(sim.n_osc), window_pages=64, rpcs_in_flight=2)
    return sim


def test_online_refit_swaps_forests_into_a_live_fleet():
    """A refit swaps forests into the model a running FleetAgent holds,
    and the agent's next tick scores with them: forests refit on all-zero
    labels put every probability near 1e-6."""
    rng = np.random.default_rng(0)

    def forest(op):
        X = rng.normal(size=(300, feature_dim(op)))
        return fit_forest(X, (X[:, 0] > 0).astype(float),
                          GBDTParams(n_trees=5, max_depth=3), device="cpu")

    model = DIALModel(read_forest=forest(READ), write_forest=forest(WRITE))
    sim = _fleet_sim()
    fleet = FleetAgent(SimFleetPort(sim), model, device="cpu")
    table, wstate = table_from_sim(sim)
    engine = FusedEngine(sim.params, sim.topo, table, 100)

    def tick():
        nonlocal wstate
        sim.state, wstate = engine.run_interval(sim.state, wstate)
        return fleet.tick()

    before = [tick() for _ in range(6)]
    probs = np.concatenate([r.decisions.probs.numpy().ravel()
                            for r in before])
    assert probs.size and probs.max() > 1e-3
    assert model._fleet_predictor is not None

    trainer = OnlineTrainer(model, GBDTParams(n_trees=6, max_depth=3),
                            policy=OnlinePolicy(refit_every=3,
                                                min_samples=32, cooldown=1))
    old_read, old_write = model.read_forest, model.write_forest
    for op in (READ, WRITE):
        trainer.observe(op, rng.normal(size=(64, feature_dim(op))),
                        np.zeros(64))
    recs = [trainer.step(100.0) for _ in range(4)]
    fired = [r for r in recs if r]
    assert len(fired) == 1 and fired[0]["ops"] == ["read", "write"]
    assert model.read_forest is not old_read
    assert model.write_forest is not old_write
    assert model.read_forest.leaf.dtype == torch.float32
    assert model._fleet_predictor is None          # no stale scorer left

    after = [tick() for _ in range(3)]
    probs = np.concatenate([r.decisions.probs.numpy().ravel()
                            for r in after])
    assert probs.size and probs.max() < 1e-4

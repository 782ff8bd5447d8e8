"""The port's forest margins, pairing and artifacts against the reference.

Margins are float32 sums in another order than the Pallas kernel's
(interpret mode) and the jnp oracle, so they are held at 1e-5, the bar
of the reference's own kernel test.  Forest pairing is numpy on both
sides and must be bit-equal.  The CUDA kernel's checks are in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core.gbdt import GBDTClassifier, GBDTParams  # noqa: E402
from repro.core.model import DIALModel as RefModel  # noqa: E402
from repro.kernels.gbdt_forest import kernel as ref_kernel  # noqa: E402
from repro.kernels.gbdt_forest import ops as ref_ops  # noqa: E402
from repro.kernels.gbdt_forest import ref as ref_ref  # noqa: E402
from repro_torch.convert import forest_from_numpy, model_from_numpy  # noqa: E402
from repro_torch.core.gbdt import DenseForest  # noqa: E402
from repro_torch.core.model import DIALModel  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.gbdt_forest import ops  # noqa: E402
from repro_torch.kernels.gbdt_forest.kernel import forest_margin_cuda  # noqa: E402

FIELDS = ("feature", "threshold", "leaf", "base_score", "depth", "n_features")


def _fit(n_feat, n_trees, depth, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1500, n_feat)).astype(np.float32)
    y = ((x[:, 0] + x[:, 1] * x[:, 2]) > 0).astype(float)
    return GBDTClassifier(GBDTParams(n_trees=n_trees, max_depth=depth,
                                     seed=seed)).fit(x, y).forest


@pytest.fixture(scope="module")
def forests():
    """A read/write pair of unequal depth and size (pairing pads both)."""
    return _fit(32, 24, 5, 0), _fit(36, 17, 3, 1)


def _port(forest, device="cpu"):
    return forest_from_numpy(*(getattr(forest, f) for f in FIELDS),
                             device=device)


def test_pair_forests_bit_equal_to_reference(forests):
    fr, fw = forests
    want = ref_ops.pair_forests(fr, fw)
    got = ops.pair_forests(_port(fr), _port(fw))
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    for f in (fr, fw):
        for a, b in zip(ops._pad_forest(f.feature, f.threshold, f.leaf,
                                        f.depth, 6, 30),
                        ref_ops._pad_forest(f.feature, f.threshold, f.leaf,
                                            f.depth, 6, 30)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [24, 100, 513])
def test_paired_margin_matches_pallas_and_ref(forests, n):
    fr, fw = forests
    feature, threshold, leaf, base, depth, n_features = \
        ref_ops.pair_forests(fr, fw)
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, n_features)).astype(np.float32)
    op = rng.integers(0, 2, size=n).astype(np.int32)
    j = [jnp.asarray(a) for a in (x, op, feature, threshold, leaf, base)]
    pal = np.asarray(ref_kernel.paired_forest_margin(*j, depth, block_n=128,
                                                     interpret=True))
    oracle = np.asarray(ref_ref.paired_forest_margin_ref(*j, depth))
    t = [torch.as_tensor(a) for a in (x, op, feature, threshold, leaf, base)]
    got = ops.paired_forest_margin(*t, depth).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, pal, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


def test_single_margin_matches_pallas(forests):
    fr = forests[0]
    x = np.random.default_rng(5).normal(size=(200, fr.n_features)).astype(
        np.float32)
    j = (jnp.asarray(fr.feature), jnp.asarray(fr.threshold),
         jnp.asarray(fr.leaf), fr.base_score, fr.depth)
    pal = np.asarray(ref_kernel.forest_margin(jnp.asarray(x), *j,
                                              block_n=64, interpret=True))
    got = _port(fr).predict_margin(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, pal, rtol=1e-5, atol=1e-5)
    # and the reference's float64 numpy traversal
    np.testing.assert_allclose(got, fr.predict_margin(x), rtol=1e-5,
                               atol=1e-5)


def test_fleet_predictor_matches_reference(forests):
    fr, fw = forests
    rng = np.random.default_rng(9)
    xr = rng.normal(size=(48, fr.n_features)).astype(np.float32)
    xw = rng.normal(size=(72, fw.n_features)).astype(np.float32)
    want_r, want_w = ref_ops.make_fleet_predictor(fr, fw, use_pallas=True)(
        xr, xw)
    model = DIALModel(read_forest=_port(fr), write_forest=_port(fw))
    got_r, got_w = model.score_fleet(torch.as_tensor(xr), torch.as_tensor(xw))
    np.testing.assert_allclose(got_r.numpy(), want_r, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=1e-5, atol=1e-6)
    # exact rows (no power-of-two bucket): read rows, then write rows,
    # read rows' missing feature columns zero
    x, op = ops.pack_fleet_rows(torch.as_tensor(xr), torch.as_tensor(xw), 36)
    assert tuple(x.shape) == (120, 36) and op.dtype == torch.int32
    assert op[:48].sum() == 0 and (op[48:] == 1).all()
    assert (x[:48, 32:] == 0).all()
    np.testing.assert_array_equal(x[:48, :32].numpy(), xr)
    np.testing.assert_array_equal(x[48:].numpy(), xw)
    assert got_r.shape == (48,) and got_w.shape == (72,)
    empty = torch.zeros((0, 32))
    assert model.score_fleet(empty, torch.zeros((0, 36)))[0].shape == (0,)


def test_reference_artifacts_load_into_port(forests, tmp_path):
    fr, fw = forests
    prefix = str(tmp_path / "dial")
    RefModel(read_forest=fr, write_forest=fw,
             train_meta={"trainer": "numpy"}).save(prefix)
    model = DIALModel.load(prefix, device="cpu")
    assert model.train_meta == {"trainer": "numpy"}
    for mine, ref in ((model.read_forest, fr), (model.write_forest, fw)):
        for f in ("feature", "threshold", "leaf"):
            np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                          getattr(ref, f))
        assert (mine.base_score, mine.depth, mine.n_features) == \
            (ref.base_score, ref.depth, ref.n_features)
    # and the port's save is the same format
    model.save(str(tmp_path / "again"))
    again = RefModel.load(str(tmp_path / "again"))
    np.testing.assert_array_equal(again.write_forest.leaf, fw.leaf)
    x = np.random.default_rng(2).normal(size=(64, 32)).astype(np.float32)
    np.testing.assert_allclose(
        model.predict_proba(0, torch.as_tensor(x)).numpy(),
        RefModel(fr, fw, backend="jax").predict_proba(0, x),
        rtol=1e-5, atol=1e-6)


def test_model_from_numpy_and_forest_validation(forests):
    fr, fw = forests
    model = model_from_numpy({f: getattr(fr, f) for f in FIELDS},
                             {f: getattr(fw, f) for f in FIELDS},
                             device="cpu")
    assert model.read_forest.n_trees == 24 and model.write_forest.depth == 3
    bad = {f: getattr(fr, f) for f in FIELDS}
    bad["n_features"] = int(fr.feature.max())
    with pytest.raises(ValueError, match="out of range"):
        forest_from_numpy(**bad, device="cpu")
    with pytest.raises(ValueError, match="depth"):
        DenseForest(torch.zeros((2, 7), dtype=torch.int32),
                    torch.zeros((2, 7)), torch.zeros((2, 8)), 0.0, 2, 4)


def test_cpu_path_launches_nothing_and_kernel_refuses_cpu(forests):
    f = _port(forests[0])
    before = dict(LAUNCHES)
    f.predict_margin(torch.zeros((4, f.n_features)))
    assert dict(LAUNCHES) == before
    with pytest.raises(ValueError, match="x on cpu"):
        forest_margin_cuda(torch.zeros((4, f.n_features)), None,
                           f.feature[None], f.threshold[None], f.leaf[None],
                           torch.zeros(1), f.depth)

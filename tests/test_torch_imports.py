"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports JAX or the reference package, and its entry
points refuse to run without a card unless the CPU is asked for."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.argv = ["chip_smoke.py"]
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), str(ROOT)])
    return env


def test_port_imports_neither_jax_nor_reference():
    out = subprocess.run([sys.executable, "-c", _PROBE], env=_env(),
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert int(out[0]) >= 90      # every module of the eleven slices
    assert out[1:] == ["[]"]


def test_training_slice_modules_are_probed():
    """The walk above reaches the training slice's modules."""
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.core.dataset", "repro_torch.learn.boost",
            "repro_torch.learn.online",
            "repro_torch.kernels.tree_histogram.kernel",
            "repro_torch.kernels.tree_histogram.ops",
            "repro_torch.kernels.tree_histogram.ref"} <= names


def test_serving_slice_modules_are_probed():
    """The walk above reaches the serving slice's modules."""
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    kernels = [f"repro_torch.kernels.{k}.{m}"
               for k in ("flash_attention", "mamba_scan", "rglru_scan")
               for m in ("kernel", "ops", "ref")]
    assert {"repro_torch.configs", "repro_torch.configs.gemma2_2b",
            "repro_torch.configs.recurrentgemma_9b",
            "repro_torch.configs.falcon_mamba_7b",
            "repro_torch.models.config", "repro_torch.models.layers",
            "repro_torch.models.attention", "repro_torch.models.rglru",
            "repro_torch.models.mamba", "repro_torch.models.lm",
            "repro_torch.launch.serve", *kernels} <= names


def test_observability_slice_modules_are_probed():
    """The walk above reaches the observability and loss-finding
    modules."""
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.obs", "repro_torch.obs.schema",
            "repro_torch.obs.host", "repro_torch.obs.sinks",
            "repro_torch.obs.timers", "repro_torch.obs.diagnose",
            "repro_torch.lab.fuzz", "repro_torch.lab.trace",
            "repro_torch.lab.diagnose"} <= names


def test_dial_slice_modules_are_probed():
    """The walk above reaches the continual, overhead and mesh
    modules."""
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.lab.continual", "repro_torch.distributed",
            "repro_torch.distributed.sharding",
            "repro_torch.launch.mesh"} <= names


def test_lm_training_slice_modules_are_probed():
    """The walk above reaches the LM training slice's modules."""
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.train", "repro_torch.train.optimizer",
            "repro_torch.train.steps", "repro_torch.data",
            "repro_torch.data.pipeline", "repro_torch.ckpt",
            "repro_torch.ckpt.manager", "repro_torch.launch.train",
            "repro_torch.kernels.pow_cr.kernel",
            "repro_torch.kernels.pow_cr.ref"} <= names


def test_distributed_slice_modules_are_probed():
    """The walk above reaches the LM's distributed modules, and the LM
    half of the sharding module is there."""
    import pkgutil

    import repro_torch
    from repro_torch.distributed import sharding
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.distributed.compression",
            "repro_torch.distributed.constrain",
            "repro_torch.distributed.sharding",
            "repro_torch.launch.mesh", "repro_torch.ckpt.manager"} <= names
    for fn in ("dp_axes", "batch_pspec", "param_pspecs", "validate_pspecs",
               "zero1_pspecs", "cache_pspecs", "named", "distribute"):
        assert callable(getattr(sharding, fn)), fn


def test_lm_mesh_needs_a_process_group():
    """``make_test_mesh`` refuses to run before the process group is
    initialised, and never builds a smaller mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    if dist.is_initialized():
        pytest.skip("a process group is already initialised here")
    with pytest.raises(RuntimeError, match="process group"):
        make_test_mesh(1, 1, device_type="cpu")


def test_no_jax_or_reference_import_in_sources():
    files = list((SRC / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1]
                assert not mod.startswith(("jax", "repro.")), (path, line)
                assert mod not in ("repro", "jax"), (path, line)


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    from repro_torch.core.fleet import run_fleet
    from repro_torch.core.model import DIALModel
    from repro_torch.pfs.engine import PFSSim

    with pytest.raises(RuntimeError, match="CUDA"):
        PFSSim(2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        DIALModel.load(str(tmp_path / "missing"))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fleet(PFSSim(2, 2, device="cpu"), None)

    import numpy as np
    from repro_torch.core.dataset import collect, train_models
    from repro_torch.learn.boost import fit_forest
    x, y = np.zeros((4, 2)), np.array([0.0, 1.0, 0.0, 1.0])
    with pytest.raises(RuntimeError, match="CUDA"):
        collect()
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_forest(x, y)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_models({"read": (x, y), "write": (x, y)})


def test_serve_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    from repro_torch.launch.serve import serve

    with pytest.raises(RuntimeError, match="CUDA"):
        serve("gemma2-2b")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "falcon-mamba-7b"], env=_env(), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and "CUDA" in proc.stderr


def test_train_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    from repro_torch.launch.train import train

    with pytest.raises(RuntimeError, match="CUDA"):
        train("gemma2-2b", steps=1, dial_model_path=None)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gemma2-2b", "--steps", "1", "--no-dial"], env=_env(),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "CUDA" in proc.stderr


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for where in (ROOT, tmp_path):
        if where is tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=where,
                              capture_output=True, text=True, timeout=120,
                              env={k: v for k, v in os.environ.items()
                                   if k != "PYTHONPATH"})
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


# the paper's experiments and the examples: each script's ``main`` without
# ``--device`` must refuse to run (a RuntimeError naming CUDA) before it
# touches a model file, and importing all six pulls in neither JAX nor
# the reference
SCRIPTS = ("benchmarks/torch_table2_h5bench.py",
           "benchmarks/torch_fig3_dlio.py", "examples/torch_quickstart.py",
           "examples/torch_dial_vs_static.py",
           "examples/torch_serve_batch.py",
           "examples/torch_train_with_dial.py")

_SCRIPT_PROBE = r"""
import importlib.util, sys
from repro_torch.core import dataset
mains = [("repro_torch.core.dataset", dataset.main)]
for path in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location("probe_" + str(len(mains)),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mains.append((path, mod.main))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print("imports", bad)
for name, main in mains:
    try:
        main(["--model", "no/such/model"] if "benchmarks" in name else [])
        print("ran", name)
    except RuntimeError as e:
        print("raised", name, "CUDA" in str(e))
"""


def test_paper_scripts_stand_alone_and_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT_PROBE,
         *(str(ROOT / s) for s in SCRIPTS)], env=_env(), cwd=ROOT,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.splitlines()
    assert out[0] == "imports []"
    assert out[1:] == [f"raised {name} True" for name in
                       ["repro_torch.core.dataset",
                        *(str(ROOT / s) for s in SCRIPTS)]]


def test_paper_scripts_import_neither_jax_nor_reference():
    for rel in SCRIPTS:
        for line in (ROOT / rel).read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1]
                assert not mod.startswith(("jax", "repro.")), (rel, line)
                assert mod not in ("repro", "jax"), (rel, line)

"""Nothing the benchmark runs loads JAX or the JAX package ``repro``
(top-level module names compared whole: the port's ``repro_torch``
begins with ``repro``), and the reference loads nothing of the
program."""

from __future__ import annotations

import ast
import json
import os
import pathlib
import subprocess
import sys

from dialbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "dialbench"


def test_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.pfs.loop_torch", "jaxtyping", "flaxen",
         "reprox", "dialbench"]) == []
    assert harness.forbidden_modules(
        ["repro", "repro.core.fleet", "jax.numpy", "jaxlib", "flax.linen",
         "repro_torch"]) == ["flax.linen", "jax.numpy", "jaxlib", "repro",
                             "repro.core.fleet"]


def _imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def test_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "dataclasses", "itertools",
                                  "numpy", "torch"}, path


def test_only_the_driver_modules_import_the_program():
    for path in PKG.rglob("*.py"):
        tops = _imports(path)
        assert not tops & set(harness.FORBIDDEN), path
        if "repro_torch" in tops:
            assert (path.name == "program.py" or path.parent.name == "drivers"
                    or path.name.startswith(("test_", "conftest"))), path


def _child(code: str) -> list:
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT), str(ROOT / "src")])}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_of_the_program():
    loaded = _child(
        "import json, sys\n"
        "import dialbench.reference.loop, dialbench.compare, "
        "dialbench.generate, dialbench.roofline, dialbench.readings\n"
        "print(json.dumps(sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('repro_torch', 'repro', 'jax', 'flax', "
        "'jaxlib'))))\n")
    assert loaded == []


def test_a_whole_run_loads_no_jax():
    """A cell run end to end at a CPU size, in a process of its own."""
    loaded = _child(
        "import json, pathlib, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from dialbench import harness\n"
        "from dialbench.conftest import shrink\n"
        "cell = shrink(harness.find_cell(pathlib.Path("
        f"{str(ROOT)!r}), 'lab-noisy.b4096'))\n"
        "result, _ = harness.run(cell, 5, 0.1, True, 'cpu')\n"
        "assert result['metrics'] is not None\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    assert loaded == []

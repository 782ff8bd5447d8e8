"""Architecture registry of the port: the families whose serving path is
ported (the reference's ``repro.configs`` lists ten).

``get_config(arch_id)`` returns the full published config;
``get_smoke_config(arch_id)`` the reduced same-family config used by CPU
tests.  Each module is a copy of the reference's, ``CONFIG`` and
``SMOKE`` verbatim.
"""

from __future__ import annotations

import importlib

ARCHS = (
    "gemma2-2b",
    "recurrentgemma-9b",
    "falcon-mamba-7b",
)


def _module(arch_id: str):
    if arch_id not in ARCHS:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet (ROADMAP Queue 1 #12); the port "
            f"serves {', '.join(ARCHS)}")
    name = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str):
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    return _module(arch_id).SMOKE

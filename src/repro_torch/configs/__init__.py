"""Architecture registry: one module per assigned architecture.

``get_config(arch_id)`` returns the full published config;
``get_smoke_config(arch_id)`` the reduced same-family config used by CPU
tests (small widths and depths, tiny vocab, few experts).  Each module
is a copy of the reference's ``repro.configs`` module, ``CONFIG`` and
``SMOKE`` verbatim.
"""

from __future__ import annotations

import importlib

ARCHS = (
    "musicgen-large",
    "gemma2-2b",
    "stablelm-12b",
    "starcoder2-15b",
    "qwen1.5-32b",
    "recurrentgemma-9b",
    "olmoe-1b-7b",
    "qwen2-moe-a2.7b",
    "falcon-mamba-7b",
    "llava-next-34b",
)


def _module(arch_id: str):
    name = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str):
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    return _module(arch_id).SMOKE


def all_configs():
    return {a: get_config(a) for a in ARCHS}

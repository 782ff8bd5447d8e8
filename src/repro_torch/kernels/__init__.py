"""Hand-written CUDA kernels of the port, each beside its plain version.

``LAUNCHES`` counts kernel launches by name.  A wrapper adds one where
it launches its kernel and nowhere else (a CPU tensor runs the plain
version and counts nothing), so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import collections

import torch

LAUNCHES: collections.Counter = collections.Counter()


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would need a gradient through a kernel.

    The LM kernels write their outputs through raw pointers, out of
    autograd's sight, and have no backward: a loss through them would
    get no gradient there, silently.  Training runs the plain forms
    (``models/*.py``'s ``*_block``); serving runs under
    ``torch.inference_mode()``.
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires a gradient and the kernel has no "
            "backward; train through the plain training forms, or call it "
            "under torch.no_grad() / torch.inference_mode()")

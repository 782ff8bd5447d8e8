"""Lightweight host-phase timers and run provenance.

The counterpart of the reference's ``repro/obs/timers.py``.
:class:`PhaseTimers` gives the host its phase breakdown at near-zero
cost (``perf_counter`` pairs); a phase that times device work passes its
device and ends in ``torch.cuda.synchronize()``, where the reference
blocks on its result.  :func:`compile_execute_split` separates a
:class:`~repro_torch.pfs.loop_torch.FusedLoop` run's one-off cost (the
warm-up interval, the CUDA graph's capture and instantiate, the
counterpart of the reference's compile) from its replays (execute), the
number an operator wants when a "slow run" might just be a first
capture.  :func:`collect_provenance` stamps bench records with what
produced them (git SHA, platform, torch and CUDA versions, the device
and the loop cache's counters).
"""

from __future__ import annotations

import collections
import contextlib
import platform
import subprocess
import time

import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimers:
    """Accumulate named wall-clock phases; ~100 ns per measurement."""

    def __init__(self):
        self.seconds = collections.defaultdict(float)
        self.calls = collections.defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, device=None):
        """Time the block; with a CUDA ``device`` the phase ends when the
        work it queued there has finished."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(device)
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def add(self, name: str, seconds: float) -> None:
        self.seconds[name] += seconds
        self.calls[name] += 1

    def reset(self) -> None:
        self.seconds.clear()
        self.calls.clear()

    def summary(self) -> dict:
        """``{phase: {"seconds": total, "calls": n}}``, insertion order."""
        return {k: {"seconds": self.seconds[k], "calls": self.calls[k]}
                for k in self.seconds}


def compile_execute_split(fn, *args, **kwargs) -> dict:
    """Setup-vs-execute wall split of one call.

    ``fn`` is a :class:`~repro_torch.pfs.loop_torch.FusedLoop` (its
    :meth:`run` is called) or any callable.  For a loop, ``compile_s``
    is what the run spent warming up, capturing and instantiating a CUDA
    graph (0 when it replayed a graph it already held, or ran eagerly)
    and ``execute_s`` the rest of the run's wall time: the replays, the
    copies and the records' transfer.  Any other callable is timed as
    pure execute.  Returns ``{"compile_s", "execute_s", "out"}``; the
    keys are the reference's, so bench records compare.
    """
    run = getattr(fn, "run", None)
    call = fn if run is None else run
    device = getattr(fn, "device", None)
    _sync(device)
    t0 = time.perf_counter()
    out = call(*args, **kwargs)
    _sync(device)
    total = time.perf_counter() - t0
    compile_s = 0.0
    if run is not None and fn.last_run.get("captured_now"):
        compile_s = fn.last_run["setup_s"]
    return {"compile_s": compile_s, "execute_s": total - compile_s,
            "out": out}


def collect_provenance() -> dict:
    """Git, platform and device metadata for bench records (best effort:
    every field degrades to a placeholder rather than raising)."""
    try:
        sha = subprocess.run(["git", "rev-parse", "HEAD"],
                             capture_output=True, text=True,
                             timeout=10).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        sha = "unknown"
    try:
        dirty = bool(subprocess.run(
            ["git", "status", "--porcelain"], capture_output=True,
            text=True, timeout=10).stdout.strip())
    except (OSError, subprocess.SubprocessError):
        dirty = False
    prov = {
        "git_sha": sha,
        "git_dirty": dirty,
        "platform": platform.platform(),
        "python": platform.python_version(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
    if torch.cuda.is_available():
        prov["device_count"] = torch.cuda.device_count()
        prov["device_kind"] = torch.cuda.get_device_name(0)
    else:
        prov["device_count"] = 0
        prov["device_kind"] = "none"
    from repro_torch.lab.batch import loop_cache_stats
    prov["loop_cache"] = loop_cache_stats()
    return prov

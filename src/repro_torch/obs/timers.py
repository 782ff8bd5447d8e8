"""The port's host spans, host-phase timers and run provenance.

:class:`span` is the package's host-span recorder: a context manager
that stamps its block on ``time.perf_counter_ns()`` and, when the block
ends, appends ``(name, start_ns, end_ns, id, parent, root)`` to a
bounded process-wide ring (``parent`` the enclosing span's id, ``root``
the outermost one's, so the spans of one call share it).  Spans are
always on, at phase granularity: the Scenario Lab's build, stack and
schedule, and the fused loop's prepare, graph capture, intervals and
finish (``docs/OBSERVABILITY_TORCH.md`` lists them).  :func:`spans`
reads the finished ones inside a window; :func:`profiler_offset_ns` is
what puts a stamp on ``torch.profiler``'s clock (the wall clock,
``time.time_ns()``), so a trace's device idle gaps can be put down to
the program's spans.

The counterpart of the reference's ``repro/obs/timers.py``:
:class:`PhaseTimers` gives the host its phase breakdown through the same
spans; a phase that times device work passes its device and ends in
``torch.cuda.synchronize()``, where the reference blocks on its result.
:func:`compile_execute_split` separates a
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
import itertools
import platform
import statistics
import subprocess
import time

import torch

# finished spans, oldest first; a lab call makes ~4,110, so the ring
# holds a benchmark's warm calls, its window and its profiled call
RING_SPANS = 1 << 17
_RING: collections.deque = collections.deque(maxlen=RING_SPANS)
_OPEN: list = []                 # the open spans, innermost last
_IDS = itertools.count(1)


class span:
    """``with span(name):`` records the block as a span (see the module
    note).  The object keeps ``start_ns`` and ``end_ns``
    once the block has ended.  Spans nest by the order they open in:
    the port's host work runs on one thread."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.id = next(_IDS)
        if _OPEN:
            outer = _OPEN[-1]
            self.parent, self.root = outer.id, outer.root
        else:
            self.parent, self.root = None, self.id
        _OPEN.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        _OPEN.pop()
        # a tuple of numbers and strings, which the garbage collector
        # stops tracking: a full ring costs its collections nothing
        _RING.append((self.name, self.start_ns, self.end_ns, self.id,
                      self.parent, self.root))
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def spans(lo_ns: int | None = None, hi_ns: int | None = None) -> list:
    """The finished spans that start at or after ``lo_ns`` and end at or
    before ``hi_ns`` (``perf_counter_ns`` stamps; ``None``: unbounded),
    oldest finished first."""
    lo = -1 if lo_ns is None else lo_ns
    hi = float("inf") if hi_ns is None else hi_ns
    return [s for s in _RING if s[1] >= lo and s[2] <= hi]


def profiler_offset_ns() -> int:
    """What to add to a span's ``perf_counter_ns`` stamp to put it on
    ``torch.profiler``'s clock (``time.time_ns()``): the median offset
    of a few back-to-back paired reads of the two clocks."""
    return statistics.median_low(
        time.time_ns() - time.perf_counter_ns() for _ in range(5))


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimers:
    """Accumulate named wall-clock phases, each one :class:`span`."""

    def __init__(self):
        self.seconds = collections.defaultdict(float)
        self.calls = collections.defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, device=None):
        """Time the block; with a CUDA ``device`` the phase ends when the
        work it queued there has finished."""
        timed = span(name)
        try:
            with timed:
                try:
                    yield
                finally:
                    _sync(device)
        finally:
            self.add(name, timed.seconds)

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

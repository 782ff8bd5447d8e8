"""The program's entry points and types as the benchmark uses them.

With the drivers (``dialbench/drivers/<name>.py``, one a way of driving
the program, chosen by a traffic mix's ``driver``), the only modules of
the benchmark that import the program (``repro_torch``, the
PyTorch/CUDA package).  Here: the program's types made from the
benchmark's generated inputs, the shared shape of a call, and the
launch spy that reads the kernels' launch shapes.  A driver's
``setup`` builds, warms up and captures; ``call`` is one call of the
measured window; ``checked`` hands the calls that the comparison
judges.  Spans and counters come from the program's own ``last_run``
(CUDA events), ``loop_cache_stats`` and the names of its kernels.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np


def _to_host(state, wstate) -> dict:
    """A program state as the reference's dict of CPU tensors."""
    out = {f.name: getattr(state, f.name).detach().cpu()
           for f in dataclasses.fields(state)
           if f.name not in ("now", "tick_index")}
    out["now"] = float(state.now)
    out["issued"] = wstate.issued.detach().cpu()
    out["done_base"] = wstate.done_base.detach().cpu()
    return out


def make_model(forests: dict):
    """The program's read/write model from the generated pair."""
    from repro_torch.core.gbdt import DenseForest
    from repro_torch.core.model import DIALModel

    f = forests
    return DIALModel(*(DenseForest(
        f["feature"][i].contiguous(), f["threshold"][i].contiguous(),
        f["leaf"][i].contiguous(), float(f["base"][i]), f["depth"],
        f["widths"][i]) for i in range(2)))


def tuner_params(cfg: dict):
    """Algorithm 1's constants as the configuration states them."""
    from repro_torch.core.tuner import TunerParams

    t = cfg["tuner"]
    return TunerParams(tau=t["tau"], alpha=t["alpha"], beta=t["beta"])


def _workload(w: dict):
    from repro_torch.pfs.workloads import Workload

    return Workload(client=w["client"], op=w["op"], req_size=w["req_size"],
                    randomness=w["randomness"],
                    n_threads=int(w["n_threads"]), osts=tuple(w["osts"]),
                    thread_rate=w["thread_rate"],
                    duty_cycle=w["duty_cycle"], period=w["period"],
                    name=w["name"])


def _check_loop(loop, cfg: dict) -> None:
    """The tuned loop decides as the configuration states (the history
    length, the volume gate, the warm-up) or the run is refused."""
    t = cfg["tuner"]
    have = (loop.k, loop.min_volume, loop.warmup)
    want = (t["k"], float(t["min_volume_bytes"]), t["warmup_intervals"])
    if have != want:
        raise ValueError(f"the program's loop decides with (k, volume, "
                         f"warm-up) {have}, the configuration states {want}")


def _check_traffic(traffic: dict) -> None:
    if traffic["tune_mask"] != "all":
        raise ValueError(f"tune_mask {traffic['tune_mask']!r}: only 'all' "
                         "(every real interface tuned) is driven")


@dataclasses.dataclass
class Call:
    """One call of the window: its intervals, its units of work, its
    device span per interval (CUDA events; ``None`` off the card), per
    device for a sharded call, and the host-clock seconds of the
    program's scenario build and of the run itself (``None`` where the
    call has no such part)."""

    intervals: int
    work: float
    device_ms: float | None
    per_device_ms: tuple = ()
    build_s: float | None = None
    run_s: float | None = None


class Sample:
    """One call drawn uniformly from the whole window, whatever its
    length, by the seed (reservoir sampling): call ``i`` replaces the
    kept one with probability ``1 / (i + 1)``."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng([int(seed), 0x5A])
        self.seen = 0
        self.kept = None

    def offer(self, item) -> None:
        if self.rng.random() * (self.seen + 1) < 1.0:
            self.kept = item
        self.seen += 1


@contextlib.contextmanager
def launch_spy():
    """Record the shape of every launch of the ``segment_sum`` and
    forest kernels made inside the block, from the program's kernel
    wrappers (read-only: each call goes on to the wrapper)."""
    from repro_torch.kernels.gbdt_forest import ops as fops
    from repro_torch.kernels.segment_reduce import ops as sops

    seen = []
    seg, forest = sops.segment_sum_cuda, fops.forest_margin_cuda

    def seg_spy(values, smap):
        k = values.shape[0] if values.dim() == 2 else 1
        seen.append(("segment_sum", {"cols": k, "entries": smap.n_entries,
                                     "segments": smap.num_segments}))
        return seg(values, smap)

    def forest_spy(x, op, feature, threshold, leaf, base, depth):
        seen.append(("forest", {"rows": x.shape[0], "features": x.shape[1],
                                "forests": feature.shape[0],
                                "trees": feature.shape[1], "depth": depth,
                                "paired": op is not None}))
        return forest(x, op, feature, threshold, leaf, base, depth)

    sops.segment_sum_cuda, fops.forest_margin_cuda = seg_spy, forest_spy
    try:
        yield seen
    finally:
        sops.segment_sum_cuda, fops.forest_margin_cuda = seg, forest

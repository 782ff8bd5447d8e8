"""One run of one cell: set-up, the measured window, the traced
readings, the comparison with the reference, and the result line.

Everything a cell is made of is found by name: ``BENCHMARK.json``'s
workload entry names its configuration (``configs/<file>``) and its
traffic mix (``traffic/<traffic>.json``), whose ``driver`` names the
way the program is driven (``drivers/<driver>.py``); the cell's limits
are ``limits/<cell>.json``; a per-layer metric's reader is
``metrics/<metric>.py``.  Adding a cell, a mix or a metric adds
files and entries and edits none.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import pathlib
import sys
import time

import torch

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A workload entry with what it names."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    base: pathlib.Path = HERE


def find_cell(root: pathlib.Path, name: str) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, its files read."""
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[entry["config"]]
    base = root / bench["paths"][0]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name=name, entry=entry,
                config=load_json(root / cfg_entry["file"]),
                traffic=load_json(base / "traffic" / f"{entry['traffic']}.json"),
                limits=load_json(base / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer, base=base)


def _load(path: pathlib.Path, prefix: str):
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(base: pathlib.Path, metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    return _load(base / "metrics" / f"{metric}.py", "dialbench_metric_").read


def driver_class(base: pathlib.Path, name: str):
    """The ``Driver`` class of ``drivers/<name>.py``."""
    return _load(base / "drivers" / f"{name}.py", "dialbench_driver_").Driver


def _mark(name: str):
    return torch.profiler.record_function("dialbench." + name)


def _profile(driver, on_card: bool) -> dict:
    """One call of the cell under ``torch.profiler``, its parts marked;
    the device's idle share is read over the window the driver names
    (:func:`dialbench.trace.active_window`), less the idle time in which
    the host did the profiler's own work
    (:func:`dialbench.trace.profiler_idle_ns`).  A part marked with
    ``host_ops=False`` records no host operators, only its own range
    and the device's activity, so that the profiler's own cost on many
    small host operations stays out of the window."""
    from torch.profiler import ProfilerActivity, profile

    from dialbench import trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    for d in driver.devices:
        if on_card:
            torch.cuda.synchronize(d)
    with profile(activities=acts) as prof:

        @contextlib.contextmanager
        def mark(name: str, host_ops: bool = True):
            with _mark(name):
                if host_ops:
                    yield
                    return
                prof.toggle_collection_dynamic(False, [ProfilerActivity.CPU])
                try:
                    yield
                finally:
                    prof.toggle_collection_dynamic(True,
                                                   [ProfilerActivity.CPU])

        with _mark("profiled"):
            info = driver.profiled(mark)
            for d in driver.devices:
                if on_card:
                    torch.cuda.synchronize(d)
    device, host = trace.events(prof)
    lo, hi = trace.window(host, "dialbench.profiled")
    marks = {name[len("dialbench."):]: (s, e) for name, s, e in host
             if name.startswith("dialbench.")}
    idle, flush = None, 0
    if info["idle_mark"] in marks:
        idle = trace.active_window(device, *marks[info["idle_mark"]],
                                   info["from_first_op"])
        if idle is not None:
            flush = trace.profiler_idle_ns(device, host, *idle,
                                           skip=("dialbench.profiled",))
    return {"device": device, "host": host, "lo": lo, "hi": hi,
            "replays": info["replays"], "marks": marks, "idle": idle,
            "profiler_idle_ns": flush, "n_devices": len(driver.devices)}


def _breakdown(prof: dict) -> dict:
    """The device operations that took most time in the profiled call,
    and the idle gaps of its idle window by what the host was doing."""
    from dialbench import trace

    lo, hi = prof["idle"]
    return {"device_ops": trace.top_ops(prof["device"], prof["lo"],
                                        prof["hi"]),
            "idle_gaps": trace.idle_by_host(
                prof["device"], prof["host"], lo, hi,
                skip=("dialbench.profiled",))}


def reference_outputs(cell: Cell, driver, checked: list, dtype, device):
    """The reference's run of every checked call: ``[(index, output)]``.
    A call that starts from the benchmark's own start starts the
    reference from its own initial state; a later fleet session from
    the state the program handed it."""
    from dialbench import generate
    from dialbench.reference import engine as E
    from dialbench.reference import loop as L
    from dialbench.reference.tuning import Tuner

    cfg, traffic = cell.config, cell.traffic
    scens = driver.ref_scens
    fleet = generate.flat_fleet(scens)
    params = generate.params(cfg)
    eng = E.Engine(params, fleet, dtype, E.engine_device(fleet, device))
    steps = max(int(round(float(traffic["interval_s"]) / params.tick)), 1)
    sched = None
    if any(s.events for s in scens):
        n_ticks = driver.n * steps
        kw = {"dtype": dtype, "device": eng.device}
        bg = torch.as_tensor(generate.schedule(scens, params, 0, n_ticks)[
            "bg_bytes"], **kw)
        ones_o = torch.ones(fleet.n_osts, **kw)
        ones_c = torch.ones(fleet.n_clients, **kw)
        sched = lambda t: {"bw_scale": ones_o, "iops_scale": ones_o,  # noqa
                           "bg_bytes": bg[t], "nic_scale": ones_c}
    forests = tuner = mask = None
    if driver.forests is not None:
        f = driver.forests
        forests = {k: f[k].to(device) for k in ("feature", "threshold",
                                                "leaf", "base")}
        forests.update(depth=f["depth"], n_features=f["n_features"])
        tuner = Tuner(**cfg["tuner"])
        mask = torch.ones(fleet.n_osc, dtype=torch.bool)
    outs = []
    for index, start, _, n in checked:
        st = (eng.init_state(*scens[0].initial_theta) if start is None
              else eng.to_state(start))
        outs.append((index, L.run(eng, st, n, steps, sched,
                                  tuner if n else None,
                                  forests if n else None, mask, device)))
    return outs, fleet


def ref_as_output(ref: dict) -> dict:
    """A reference run in the form of a program call's output (for the
    control, which puts the reference in the program's place)."""
    out = {"state": ref["state"]}
    if "ring" in ref:
        n = ref["state"]["window_pages"].shape[0]
        recs = ref["records"]
        full = {k: [] for k in ("decided", "ops", "theta", "changed",
                                "n_candidates", "score", "probs")}
        for r in recs:
            rows = r["rows"]
            full["decided"].append(r["decided"])
            for k, shape, dt in (("ops", (n,), torch.int64),
                                 ("theta", (n, 2), torch.int64),
                                 ("changed", (n,), torch.bool),
                                 ("n_candidates", (n,), torch.int64),
                                 ("score", (n,), torch.float64),
                                 ("probs", (n, 24), torch.float64)):
                t = torch.zeros(shape, dtype=dt)
                if rows.numel():
                    t[rows] = r[k].to(dt)
                full[k].append(t)
        out["records"] = {k: torch.stack(v) for k, v in full.items()}
        out["ring"] = [h.cpu() for h in ref["ring"]]
    return out


def check(cell: Cell, driver, device, checked) -> tuple:
    """``(values, per-call verdicts)``: the worst of each compared number
    over the checked calls, and each call's verdict (a call checked
    over no interval is judged by the numbers it has)."""
    from dialbench import compare

    refs, fleet = reference_outputs(cell, driver, checked, torch.float64,
                                    device)
    osc_ost = torch.as_tensor(fleet.osc_ost)
    readings = [compare.numbers(out, ref, osc_ost, fleet.n_osts)
                for (_, _, out, _), (_, ref) in zip(checked, refs)]
    return (compare.worst(readings),
            [compare.verdict(r, {k: cell.limits[k] for k in r})
             for r in readings])


def run(cell: Cell, seed: int, seconds: float, traced: bool,
        device: str = "cuda", t_start: float | None = None) -> tuple:
    """One run.  Returns ``(result dict, check lines)``."""
    from dialbench import program

    t_start = time.perf_counter() if t_start is None else t_start
    on_card = torch.device(device).type == "cuda"
    seed = int(seed) % (2**63)
    driver = driver_class(cell.base, cell.traffic["driver"])(
        cell.config, cell.traffic, seed, device)
    driver.setup()
    for d in driver.devices:
        if on_card:
            torch.cuda.synchronize(d)
    setup_s = time.perf_counter() - t_start

    cache0 = driver.cache_stats()
    calls = []
    start = time.perf_counter()
    while not calls or time.perf_counter() - start < seconds:
        t0 = time.perf_counter()
        c = driver.call()
        calls.append((t0, time.perf_counter(), c))
    cache1 = driver.cache_stats()
    span = calls[-1][1] - calls[0][0]
    peak = max((torch.cuda.max_memory_allocated(d) for d in driver.devices),
               default=0) if on_card else 0

    ctx = {"calls": calls, "n_osc": driver.n_osc, "cache": (cache0, cache1),
           "profile": None, "launches": None, "ab": None}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(driver.devices[0])
                            if on_card else "cpu"),
                   "count": len(driver.devices),
                   "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced:
        ctx["profile"] = _profile(driver, on_card)
        if on_card:
            with program.launch_spy() as seen:
                driver.eager_interval()
                for d in driver.devices:
                    torch.cuda.synchronize(d)
            ctx["launches"] = seen
            ctx["ab"] = driver.tuning_ab()
            from dialbench import trace

            p = ctx["profile"]
            if p["idle"] is not None:
                lo, hi = p["idle"]
                busy = trace.busy_per_device_ns(p["device"], lo, hi)
                device_info["busy_s"] = busy / 1e9
                device_info["window_s"] = (hi - lo
                                           - p["profiler_idle_ns"]) / 1e9
                breakdown = _breakdown(p)

    metrics = {}
    if traced:
        for m in cell.per_layer:
            v = reader(cell.base, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        rate_name = cell.traffic["rate_metric"]
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                v = setup_s
            elif m["name"] == rate_name:
                v = sum(c.work for _, _, c in calls) / span
            else:
                continue
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    checked = driver.checked()
    ref_dev = str(driver.devices[0]) if on_card else "cpu"
    driver_ref = _Frozen(driver)
    del driver
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # the reference's small host operations
    try:
        values, verdicts = check(cell, driver_ref, ref_dev, checked)
    finally:
        torch.set_num_threads(threads)
    check_s = time.perf_counter() - t_check
    correct = bool(verdicts) and all(verdicts) and all(
        math.isfinite(m["value"]) for m in metrics.values())
    result = {"correct": correct, "attempted": len(calls),
              "failed": sum(1 for v in verdicts if not v),
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["decisions"] = decision_counts(checked)
    result["check"] = {k: {"value": values[k], "limit": cell.limits[k]}
                       for k in cell.limits if k in values}
    walls = [t1 - t0 for t0, t1, _ in calls]
    dev = [c.device_ms for _, _, c in calls if c.device_ms is not None]
    lines = [f"window: {len(calls)} calls in {span:.3f} s; a call's wall "
             f"{min(walls):.4f}-{max(walls):.4f} s; device ms an interval "
             + (f"{min(dev):.3f}-{max(dev):.3f}" if dev else "not measured")
             + f"; set-up {setup_s:.3f} s; check {check_s:.3f} s"]
    lines.append("calls (start s, wall s, build s, device ms an interval): "
                 + " ".join(
                     f"{t0 - start:.2f}/{t1 - t0:.3f}/"
                     + ("-" if c.build_s is None else f"{c.build_s:.3f}")
                     + "/" + ("-" if c.device_ms is None
                              else f"{c.device_ms:.2f}")
                     for t0, t1, c in calls))
    lines += [f"check {k} {values.get(k)} limit {cell.limits[k]}"
              for k in cell.limits]
    return result, lines


def decision_counts(checked: list) -> dict:
    """Over the checked calls: how many, their intervals, the decided
    (interface, interval) rows and those whose θ changed."""
    out = {"checked": len(checked), "intervals": 0, "decided": 0,
           "changed": 0}
    for _, _, o, _ in checked:
        rec = o.get("records")
        if rec is None:
            continue
        dec = rec["decided"].bool()
        out["intervals"] += dec.shape[0]
        out["decided"] += int(dec.sum())
        out["changed"] += int((dec & rec["changed"].bool()).sum())
    return out


class _Frozen:
    """What the reference needs of a driver once its program state is
    freed: the generated inputs of the checked call and its length."""

    def __init__(self, driver):
        self.ref_scens = driver.ref_scens
        self.forests = driver.forests
        self.n = driver.n


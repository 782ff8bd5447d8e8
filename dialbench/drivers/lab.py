"""Driver ``lab``: a Scenario Lab sweep, one new batch of variants a call.

Each call draws a new set of ``variants`` jittered variants of the
configuration's scenario from the seed and the call's index, as a
researcher's sweep draws a new set for every batch; the program builds
and stacks them (``lab.scenarios.build``, ``lab.batch.stack_scenarios``)
and runs ``run_batch(batch, model, seconds=call_seconds, fused=True)``
from the batch's initial state (``devices`` > 1: ``run_batch(...,
mesh=)``).  The model is drawn once, from the seed.  The call the
comparison judges is drawn by the seed from the whole window, and the
reference starts it from its own initial state.
"""

from __future__ import annotations

import time

import torch

from dialbench import generate
from dialbench.program import (Call, Sample, _check_loop, _check_traffic,
                               _to_host, _workload, make_model, tuner_params)

WARM_CALLS = 2          # set-up's calls: the capture, then a steady one


class Driver:
    """Calls of ``run_batch(fused=True)``, each on a new stacked batch."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        _check_traffic(traffic)
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.n_devices = int(traffic.get("devices", 1))
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # as the program's tensors report it (its loops are found by it)
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.call_s = float(traffic["call_seconds"])
        self.interval_s = float(traffic["interval_s"])
        self.n = int(round(self.call_s / self.interval_s))
        self.variants = int(traffic["variants"])
        self.drawn = 0          # sets of variants drawn so far
        self.calls = 0
        self.sample = Sample(seed)
        self.forests = None

    @property
    def n_osc(self) -> int:
        s = self.cfg["scenario"]
        return self.variants * s["n_clients"] * s["n_osts"]

    @property
    def devices(self) -> tuple:
        if self.n_devices == 1:
            return (self.device,)
        from repro_torch.distributed.sharding import fleet_mesh

        if self.device.type == "cuda":
            return fleet_mesh(self.n_devices)
        return fleet_mesh(devices=[self.device] * self.n_devices)

    @property
    def ref_scens(self) -> list:
        return self.sample.kept[1]

    def _draw(self) -> list:
        scens = generate.lab_scenarios(self.cfg, self.variants, self.seed,
                                       self.drawn)
        self.drawn += 1
        return scens

    def _specs(self, scens: list) -> list:
        """The drawn variants as the program's scenario specs."""
        from repro_torch.lab import scenarios as S

        return [S.ScenarioSpec(
            name=f"variant{i}", n_clients=s.n_clients, n_osts=s.n_osts,
            workloads=tuple(_workload(w) for w in s.workloads),
            events=tuple(S.DisturbanceEvent(
                e.kind, targets=e.targets, magnitude=e.magnitude,
                start=e.start, end=e.end, period=e.period, duty=e.duty)
                for e in s.events),
            initial_theta=s.initial_theta) for i, s in enumerate(scens)]

    def _build(self, specs: list):
        """The program's build and stack of one batch."""
        from repro_torch.lab import scenarios as S
        from repro_torch.lab.batch import stack_scenarios

        built = [S.build(sp, self.params) for sp in specs]
        return stack_scenarios(built, ragged=False, device=self.device)

    def setup(self) -> None:
        from repro_torch.pfs.state import SimParams

        self.params = SimParams(**self.cfg["sim_params"])
        self.mesh = None if self.n_devices == 1 else self.devices
        for i in range(WARM_CALLS):
            scens = self._draw()
            if self.forests is None:
                self.forests = generate.forests(self.cfg, scens, self.seed,
                                                self.device)
                self.model = make_model(self.forests)
            self.batch = self._build(self._specs(scens))
            self._run(self.batch, self.call_s)
        for loop in self._loops():
            _check_loop(loop, self.cfg)

    def _run(self, batch, seconds: float, graph=None):
        from repro_torch.lab.batch import run_batch

        return run_batch(batch, self.model, seconds=seconds,
                         interval=self.interval_s,
                         tuner_params=tuner_params(self.cfg), fused=True,
                         mesh=self.mesh, graph=graph)

    def cache_stats(self) -> dict:
        from repro_torch.lab.batch import loop_cache_stats

        return loop_cache_stats()

    def _loops(self) -> list:
        """The program's cached fused loops, one per device of the
        batch's mesh (or the batch's device)."""
        from repro_torch.lab import batch as B

        want = {str(d) for d in self.devices}
        return [lp for lp, _ in B._FUSED_LOOPS.values()
                if str(lp.device) in want and lp.last_run]

    def call(self) -> Call:
        from repro_torch.lab.batch import loop_cache_stats

        scens = self._draw()
        specs = self._specs(scens)
        t0 = time.perf_counter()
        self.batch = self._build(specs)
        t1 = time.perf_counter()
        before = loop_cache_stats()
        res = self._run(self.batch, self.call_s)
        t2 = time.perf_counter()
        after = loop_cache_stats()
        # the call's result stays referenced, not copied
        self.sample.offer((self.calls, scens, res))
        self.calls += 1
        replays = after["replays"] - before["replays"]
        dev_ms = None
        if replays and self.device.type == "cuda":
            dev_ms = (after["replay_device_ms"] - before["replay_device_ms"]
                      ) / replays
        per_dev = ()
        if self.mesh is not None and self.device.type == "cuda":
            per_dev = tuple(lp.last_run.get("device_ms_per_interval")
                            for lp in self._loops())
        return Call(self.n, float(self.variants * self.call_s), dev_ms,
                    per_dev, build_s=t1 - t0, run_s=t2 - t1)

    def checked(self) -> list:
        i, _, res = self.sample.kept
        return [(i, None, self._output(res), self.n)]

    def _output(self, res) -> dict:
        return {"state": _to_host(res.state, res.wstate),
                "records": {k: v for k, v in res.trace.items()
                            if k in ("decided", "ops", "theta", "changed",
                                     "n_candidates", "score", "probs")},
                "ring": [h.detach().cpu() for h in res.hist]}

    # --- the traced run's extra readings ------------------------------- #
    def profiled(self, mark) -> dict:
        """One call of the cell, its parts marked, their host operators
        not recorded (the build alone is some hundred thousand).  The
        device's idle share is read over the whole call, from its start
        to its last device operation: the host's build, schedule and
        capture are the lab's idle time."""
        specs = self._specs(self._draw())
        with mark("call"):
            with mark("build", host_ops=False):
                self.batch = self._build(specs)
            with mark("run_batch", host_ops=False):
                self._run(self.batch, self.call_s)
        return {"replays": self.n, "idle_mark": "call",
                "from_first_op": False}

    def eager_interval(self) -> None:
        self._run(self.batch, self.interval_s, graph=False)

    def tuning_ab(self) -> None:
        return None

"""Driver ``fleet``: sessions of a closed loop on one fleet.

Each session is one ``FusedLoop.run`` of ``session_intervals``
intervals on the loop that ``run_fleet(backend="torch-fused")`` builds
(``tuned``), or on ``FusedLoop(tuned=False)`` (static), the state
carried from session to session.  The session the comparison judges is
drawn by the seed from the whole window; it starts from the state the
program carried to it, so the window's start is checked by itself.
"""

from __future__ import annotations

import torch

from dialbench import generate
from dialbench.program import (Call, Sample, _check_loop, _check_traffic,
                               _to_host, _workload, make_model, tuner_params)


class Driver:
    """Sessions of the fused closed loop on one fleet."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        _check_traffic(traffic)
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.tuned = bool(traffic["tuned"])
        self.n = int(traffic["session_intervals"])
        self.interval_s = float(traffic["interval_s"])
        self.scen = generate.fleet_scenario(cfg)
        self.forests = None
        self.sample = Sample(seed)
        self.sessions = 0

    @property
    def n_osc(self) -> int:
        return self.scen.n_clients * self.scen.n_osts

    @property
    def devices(self) -> tuple:
        return (self.device,)

    @property
    def ref_scens(self) -> list:
        return [self.scen]

    def setup(self) -> None:
        from repro_torch.core.fleet import run_fleet
        from repro_torch.pfs.engine import PFSSim
        from repro_torch.pfs.loop_torch import FusedLoop
        from repro_torch.pfs.state import SimParams
        from repro_torch.pfs.workloads import table_from_sim

        s = self.scen
        sim = PFSSim(s.n_clients, s.n_osts,
                     SimParams(**self.cfg["sim_params"]), device=self.device)
        for w in s.workloads:
            sim.attach(_workload(w))
        sim.state.window_pages[:] = int(s.initial_theta[0])
        sim.state.rpcs_in_flight[:] = int(s.initial_theta[1])
        self.table, self.wstate0 = table_from_sim(sim)
        self.state0 = sim.state
        steps = max(int(round(self.interval_s / sim.params.tick)), 1)
        self.mask = torch.ones(self.n_osc, dtype=torch.bool,
                               device=self.device)
        if self.tuned:
            self.forests = generate.forests(self.cfg, [s], self.seed,
                                            self.device)
            self.model = make_model(self.forests)
            fleet = run_fleet(sim, self.model, seconds=self.interval_s,
                              interval=self.interval_s,
                              tuner_params=tuner_params(self.cfg),
                              backend="torch-fused", device=self.device)
            self.loop = fleet.loop
            _check_loop(self.loop, self.cfg)
        else:
            self.loop = FusedLoop(sim.params, sim.topo, steps, None,
                                  tuned=False)
        # every shape of a session: the captured interval and the
        # records' buffers
        for _ in range(2):
            self._run(self.state0, self.wstate0, self.n)
        self.state, self.wstate = self.state0, self.wstate0

    def cache_stats(self) -> None:
        return None

    def _run(self, state, wstate, n, loop=None, graph=None):
        loop = loop or self.loop
        if loop.tuned:
            return loop.run(self.table, state, wstate, n,
                            tune_mask=self.mask, graph=graph)
        return loop.run(self.table, state, wstate, n, graph=graph)

    def call(self) -> Call:
        res = self._run(self.state, self.wstate, self.n)
        # the session's input and result stay referenced, not copied
        self.sample.offer((self.sessions, (self.state, self.wstate), res))
        self.state, self.wstate = res.state, res.wstate
        self.sessions += 1
        return Call(self.n, float(self.n_osc * self.n),
                    self.loop.last_run.get("device_ms_per_interval"))

    def checked(self) -> list:
        """``[(session index, input state dict or None for the
        benchmark's own start, output, intervals)]``: the session drawn
        from the window.  A later session starts from the state the
        program carried to it; then its start is checked by itself: the
        session that begins the window, from the benchmark's own start,
        checked over 0 intervals."""
        i, (st, ws), res = self.sample.kept
        out = [(i, None if i == 0 else _to_host(st, ws), self._output(res),
                self.n)]
        if i:
            out.insert(0, (0, None, {"state": _to_host(self.state0,
                                                       self.wstate0)}, 0))
        return out

    def _output(self, res) -> dict:
        out = {"state": _to_host(res.state, res.wstate)}
        if res.trace is not None:
            out["records"] = {k: v for k, v in res.trace.items()
                              if k in ("decided", "ops", "theta", "changed",
                                       "n_candidates", "score", "probs")}
            out["ring"] = [h.detach().cpu() for h in res.hist]
        return out

    # --- the traced run's extra readings ------------------------------- #
    def profiled(self, mark) -> dict:
        """One session, its parts marked; the replays are waited for
        inside their mark, so the device's idle share is read over the
        steady run of replays alone, from its first operation to its
        last."""
        n = self.n
        with mark("prepare"):
            inputs = self.loop.prepare(
                self.state, self.wstate, n,
                tune_mask=self.mask if self.loop.tuned else None)
        with mark("replays"):
            carry, records = self.loop.advance(self.table, inputs, n)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        with mark("finish"):
            self.loop.finish(carry, records, n, self.loop.last_run)
        return {"replays": n, "idle_mark": "replays", "from_first_op": True}

    def eager_interval(self) -> None:
        """One interval run eagerly, off the graph (for the launch
        shapes)."""
        self._run(self.state, self.wstate, 1, graph=False)

    def tuning_ab(self) -> dict | None:
        """Device ms per interval of the tuned loop and of an untuned loop
        on the same table, alternated, ``ab_pairs`` runs of
        ``ab_intervals`` each (``None`` for an untuned cell)."""
        if not self.tuned or self.device.type != "cuda":
            return None
        n, pairs = int(self.traffic["ab_intervals"]), \
            int(self.traffic["ab_pairs"])
        from repro_torch.pfs.loop_torch import FusedLoop

        static = FusedLoop(self.loop.params, self.loop.topo, self.loop.steps,
                           None, tuned=False)
        self._run(self.state, self.wstate, n, loop=static)
        out = {"tuned": [], "static": []}
        for _ in range(pairs):
            for name, loop in (("tuned", self.loop), ("static", static)):
                self._run(self.state, self.wstate, n, loop=loop)
                out[name].append(loop.last_run["device_ms_per_interval"])
        return out


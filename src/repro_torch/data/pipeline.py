"""Sharded token pipeline reading through the PFS client -- DIAL's host.

Mirrors ``repro/data/pipeline.py``.  Every training host is one PFS
client pulling its shard slice of the global batch each step (and the
checkpoint manager pushes through the same client's write path).  The
pipeline:

  * issues closed-loop reads against the simulated Lustre client
    (striped over the host's OSTs) sized to the host's per-step quota;
  * runs a DIAL agent per host at the probe interval, tuning that
    client's (window, in-flight) knobs from purely local metrics;
  * synthesizes the token arrays deterministically (seeded numpy, the
    reference's code verbatim, so the batches are bit-equal to its) --
    the simulator accounts for the *bytes*, so training is bitwise
    deterministic under any tuning behaviour;
  * keeps a resumable cursor (step index) checkpointed with the model;
  * mitigates stragglers: a host whose shard read lags
    ``straggler_factor`` behind the fleet median is re-striped onto all
    OSTs (:meth:`~repro_torch.pfs.engine.PFSSim.bind`).

The sim advances through its kept workload table
(:meth:`~repro_torch.pfs.engine.PFSSim.run`), so a probe interval is the
100 engine ticks of the port's table path; the reference's pipeline
ticks its workloads object by object, which agrees with the table path
to 1e-9, not bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.agent import DIALAgent, SimClientPort
from repro_torch.pfs.engine import PFSSim
from repro_torch.pfs.state import READ
from repro_torch.pfs.workloads import Workload


@dataclasses.dataclass
class PipelineConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    n_hosts: int = 4
    bytes_per_token: float = 2.0     # uint16 token shards on disk
    osts_per_host: int = 2
    probe_interval: float = 0.5
    straggler_factor: float = 3.0
    seed: int = 0
    num_codebooks: int = 0


class DataPipeline:
    """Deterministic token source + PFS-accounted ingest with DIAL.

    ``sim`` defaults to a fresh ``n_hosts`` x ``n_hosts * osts_per_host``
    :class:`PFSSim` on ``device`` (``None``: the card); the agents run on
    the sim's device, where ``dial_model`` must live.
    """

    def __init__(self, cfg: PipelineConfig, sim: PFSSim | None = None,
                 dial_model=None, device=None):
        self.cfg = cfg
        n_osts = max(cfg.n_hosts * cfg.osts_per_host, 1)
        self.sim = sim or PFSSim(n_clients=cfg.n_hosts, n_osts=n_osts,
                                 device=device)
        self.step_index = 0
        self.agents = []
        if dial_model is not None:
            self.agents = [
                DIALAgent(SimClientPort(self.sim, h), dial_model,
                          device=self.sim.device)
                for h in range(cfg.n_hosts)
            ]
        # per-host ingest workloads: sequential shard streams
        self.workloads = []
        for h in range(cfg.n_hosts):
            osts = tuple(range(h * cfg.osts_per_host,
                               (h + 1) * cfg.osts_per_host))
            w = Workload(client=h, op=READ, req_size=1 * 2**20,
                         randomness=0.1, n_threads=4, osts=osts,
                         name=f"ingest_host{h}")
            self.sim.attach(w)
            self.workloads.append(w)
        self._done_base = self._done()

    # ------------------------------------------------------------------ #
    def _done(self) -> list:
        """Each host's delivered bytes (one read of the device)."""
        done = self.sim.done_bytes()
        return [done[self.sim.workload_index(w)] for w in self.workloads]

    def step_bytes_per_host(self) -> float:
        c = self.cfg
        tokens = c.global_batch * c.seq_len * max(c.num_codebooks, 1)
        return tokens * c.bytes_per_token / c.n_hosts

    def next_batch(self) -> dict:
        """Advance the simulator until every host has read its quota,
        running DIAL agents at the probe interval; return the batch
        (numpy ``tokens`` and ``labels``)."""
        c = self.cfg
        quota = self.step_bytes_per_host()
        target = [b + quota for b in self._done_base]
        stalled_redundant = set()
        max_sim_s = 120.0
        waited = 0.0
        while waited < max_sim_s:
            done = self._done()
            lag = [t - d for t, d in zip(target, done)]
            if max(lag) <= 0:
                break
            # straggler mitigation: re-stripe the laggard onto all OSTs
            med = float(np.median(lag))
            for h, l in enumerate(lag):
                if (l > c.straggler_factor * max(med, 1.0)
                        and h not in stalled_redundant and med >= 0):
                    w = self.workloads[h]
                    w.osts = tuple(range(self.sim.n_osts))
                    w.bind(self.sim)
                    self._done_base[h] = 0.0
                    target[h] = w.done_bytes(self.sim) + l
                    stalled_redundant.add(h)
            self.sim.run(c.probe_interval)
            waited += c.probe_interval
            for a in self.agents:
                a.tick()
        self._done_base = self._done()

        batch = self._materialize(self.step_index)
        self.step_index += 1
        return batch

    def ingest_throughput(self) -> float:
        """Aggregate delivered bytes/sec so far (sim time)."""
        total = sum(self._done())
        return total / max(self.sim.now, 1e-9)

    # ------------------------------------------------------------------ #
    def _materialize(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        shape = (c.global_batch, c.seq_len)
        if c.num_codebooks:
            shape = shape + (c.num_codebooks,)
        tokens = rng.integers(0, c.vocab_size, size=shape, dtype=np.int32)
        return {"tokens": tokens, "labels": tokens}

    # --- checkpointable cursor ---------------------------------------- #
    def state_dict(self) -> dict:
        return {"step_index": self.step_index}

    def load_state_dict(self, state: dict) -> None:
        self.step_index = int(state["step_index"])

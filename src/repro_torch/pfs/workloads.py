"""Workload presets and the vectorized workload table on tensors.

:class:`Workload` describes one application process group on one client
(closed-loop readers or grant-throttled writers).  The presets mirror
the paper's evaluation workloads: filebench single streams, H5bench
VPIC-IO / BDCATS-IO and the DLIO BERT / Megatron readers.

The port always steps workloads through :class:`WorkloadTable`: one row
per workload plus a flattened (row -> OSC) stripe scatter, so one
:meth:`WorkloadTable.demand_step` resolves the whole fleet's demand for
a tick.  Rows that can interact (same op, overlapping stripes) run in
conflict-free *waves* built at freeze time, in attach order, exactly as
the reference builds them.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.kernels.segment_reduce.ops import SegmentMap, segment_sum
from repro_torch.pfs.state import (F64, READ, WRITE, Demand, SimParams,
                                   SimState, SimTopo)


@dataclasses.dataclass
class Workload:
    """A closed/open-loop I/O stream bound to one (client, op) pair.

    ``osts`` are the OSTs the file stripes over; ``duty_cycle`` /
    ``period`` give on/off bursting (DLIO epochs).
    """

    client: int
    op: int
    req_size: float
    randomness: float
    n_threads: int = 1
    osts: tuple = (0,)
    thread_rate: float = 1.2e9
    duty_cycle: float = 1.0
    period: float = 10.0
    name: str = "workload"

    def bind(self, sim) -> None:
        """Re-bind to ``sim`` after a change of ``osts`` (issued bytes reset,
        the new stripe's delivered bytes as the base)."""
        sim.bind(self)

    def done_bytes(self, sim) -> float:
        """Bytes the stripe delivered since the workload was (re-)bound."""
        return sim.done_bytes()[sim.workload_index(self)]


# ---------------------------------------------------------------------- #
# paper workload presets
# ---------------------------------------------------------------------- #
def sequential_stream(client: int, op: int, req_size: float, ost: int = 0,
                      n_threads: int = 1) -> Workload:
    """Filebench single-stream sequential pattern (training distribution)."""
    return Workload(client=client, op=op, req_size=req_size, randomness=0.0,
                    n_threads=n_threads, osts=(ost,),
                    name=f"seq_{'r' if op == READ else 'w'}_{int(req_size)}")


def random_stream(client: int, op: int, req_size: float, ost: int = 0,
                  n_threads: int = 1) -> Workload:
    """Filebench single-stream random pattern (training distribution)."""
    return Workload(client=client, op=op, req_size=req_size, randomness=1.0,
                    n_threads=n_threads, osts=(ost,),
                    name=f"rand_{'r' if op == READ else 'w'}_{int(req_size)}")


def strided_stream(client: int, op: int, req_size: float, ost: int = 0,
                   n_threads: int = 1) -> Workload:
    return Workload(client=client, op=op, req_size=req_size, randomness=0.5,
                    n_threads=n_threads, osts=(ost,), name="strided")


def vpic_write(client: int, dims: int, osts=(0, 1, 2, 3)) -> Workload:
    """H5bench VPIC-IO: contiguous particle array writes (more dimensions
    fragment the runs slightly: mild randomness growth)."""
    req = {1: 16 * 2**20, 2: 8 * 2**20, 3: 4 * 2**20}[dims]
    rnd = {1: 0.0, 2: 0.06, 3: 0.12}[dims]
    return Workload(client=client, op=WRITE, req_size=req, randomness=rnd,
                    n_threads=4, osts=tuple(osts), name=f"vpic_{dims}d")


def bdcats_read(client: int, mode: str, osts=(0, 1, 2, 3)) -> Workload:
    """H5bench BDCATS-IO: reads the VPIC output back (partial/strided/full)."""
    cfg = {
        "partial": dict(req_size=1 * 2**20, randomness=0.55, n_threads=4),
        "strided": dict(req_size=2 * 2**20, randomness=0.35, n_threads=4),
        "full": dict(req_size=16 * 2**20, randomness=0.0, n_threads=4),
    }[mode]
    return Workload(client=client, op=READ, osts=tuple(osts),
                    name=f"bdcats_{mode}", **cfg)


def dlio_reader(client: int, model: str, n_threads: int, osts=(0,)) -> Workload:
    """DLIO deep-learning read kernels (Fig. 3), in epoch bursts."""
    if model == "bert":
        return Workload(client=client, op=READ, req_size=64 * 2**10,
                        randomness=0.9, n_threads=n_threads, osts=tuple(osts),
                        duty_cycle=0.85, period=4.0,
                        name=f"dlio_bert_t{n_threads}")
    if model == "megatron":
        return Workload(client=client, op=READ, req_size=2 * 2**20,
                        randomness=0.25, n_threads=n_threads, osts=tuple(osts),
                        duty_cycle=0.9, period=6.0,
                        name=f"dlio_megatron_t{n_threads}")
    raise ValueError(f"unknown DLIO model {model!r}")


# ---------------------------------------------------------------------- #
# vectorized workload layer
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class WorkloadState:
    """The per-row mutable workload state threaded through the ticks."""

    issued: torch.Tensor      # (R,) closed-loop bytes issued so far
    done_base: torch.Tensor   # (R,) ctr_bytes_done stripe-sum at attach


# per-row float fields of the table, in the reference's order
_ROW_FLOATS = ("req_size", "randomness", "n_threads", "thread_rate",
               "duty_cycle", "period", "stripe_len")
_ROW_INTS = ("client", "op", "wave", "entry_row", "entry_osc")
# every array field, in the reference's order
_TABLE_FIELDS = ("client", "op") + _ROW_FLOATS + (
    "wave", "entry_row", "entry_osc", "row_valid")


@dataclasses.dataclass
class WorkloadTable:
    """Struct-of-arrays over every attached workload row, on one device.

    ``entry_row[e] -> entry_osc[e]`` is the flattened stripe scatter;
    ``row_map`` / ``osc_map`` are its two segment maps (built once here),
    and ``read_waves`` / ``write_waves`` the static per-wave row masks.
    """

    client: torch.Tensor       # (R,) int64
    op: torch.Tensor           # (R,) int64, READ/WRITE
    req_size: torch.Tensor     # (R,) float64
    randomness: torch.Tensor
    n_threads: torch.Tensor
    thread_rate: torch.Tensor
    duty_cycle: torch.Tensor
    period: torch.Tensor
    stripe_len: torch.Tensor
    wave: torch.Tensor         # (R,) int64 conflict-free execution wave
    entry_row: torch.Tensor    # (E,) int64
    entry_osc: torch.Tensor    # (E,) int64
    row_valid: torch.Tensor    # (R,) bool
    n_osc: int
    n_waves: int
    row_map: SegmentMap        # entry -> row
    osc_map: SegmentMap        # entry -> interface
    read_waves: tuple          # n_waves x (R,) bool: row in wave k, op READ
    write_waves: tuple         # n_waves x (R,) bool: row in wave k, op WRITE
    names: tuple = ()
    key: str = ""              # digest of the arrays, n_osc and n_waves

    def __len__(self) -> int:
        return self.op.shape[0]

    @property
    def device(self) -> torch.device:
        return self.op.device

    @staticmethod
    def arrays_from_workloads(workloads, topo: SimTopo) -> dict:
        """The table's numpy arrays for a list of :class:`Workload`, with
        the reference's wave partition (attach order preserved)."""
        rows = list(workloads)
        r = len(rows)
        osc_sets, entry_row, entry_osc = [], [], []
        for i, w in enumerate(rows):
            oscs = [topo.osc_id(w.client, t) for t in w.osts]
            osc_sets.append((int(w.op), frozenset(oscs)))
            entry_row.extend([i] * len(oscs))
            entry_osc.extend(oscs)
        # a row lands one wave after the latest earlier row it conflicts
        # with (same op, stripe overlap)
        wave = np.zeros(r, dtype=np.int64)
        for i in range(r):
            for j in range(i):
                if (osc_sets[i][0] == osc_sets[j][0]
                        and osc_sets[i][1] & osc_sets[j][1]):
                    wave[i] = max(wave[i], wave[j] + 1)
        out = dict(
            client=np.array([w.client for w in rows], dtype=np.int64),
            op=np.array([w.op for w in rows], dtype=np.int64),
            wave=wave,
            entry_row=np.array(entry_row, dtype=np.int64),
            entry_osc=np.array(entry_osc, dtype=np.int64),
            row_valid=np.ones(r, dtype=bool))
        for f in _ROW_FLOATS:
            out[f] = np.array([len(w.osts) if f == "stripe_len"
                               else getattr(w, f) for w in rows], dtype=float)
        return out

    @staticmethod
    def n_waves_of(arrays: dict) -> int:
        """The number of waves of a table's arrays (1 for no rows)."""
        return int(arrays["wave"].max()) + 1 if len(arrays["wave"]) else 1

    @classmethod
    def from_workloads(cls, workloads, topo: SimTopo) -> "WorkloadTable":
        arrays = cls.arrays_from_workloads(workloads, topo)
        return cls.from_arrays(
            arrays, n_osc=topo.n_osc, n_waves=cls.n_waves_of(arrays),
            device=topo.device, names=tuple(w.name for w in workloads))

    @classmethod
    def from_arrays(cls, arrays: dict, n_osc: int, n_waves: int, device,
                    names: tuple = ()) -> "WorkloadTable":
        """Freeze numpy table arrays onto ``device`` with their maps.

        ``key`` digests the arrays, so two tables with the same key
        compute the same demand (the fused loop reuses a captured
        interval for either).
        """
        a = {f: np.ascontiguousarray(arrays[f], dtype=np.float64)
             for f in _ROW_FLOATS}
        a.update({f: np.ascontiguousarray(arrays[f], dtype=np.int64)
                  for f in _ROW_INTS})
        a["row_valid"] = np.ascontiguousarray(arrays["row_valid"], dtype=bool)
        digest = hashlib.blake2b(f"{n_osc},{n_waves}".encode(),
                                 digest_size=16)
        for f in _TABLE_FIELDS:
            digest.update(f"{f}{a[f].shape}".encode())
            digest.update(a[f].tobytes())
        t = {f: torch.as_tensor(v, device=device) for f, v in a.items()}
        r = t["op"].shape[0]
        in_wave = [t["wave"] == k for k in range(n_waves)]
        return cls(
            **t, n_osc=int(n_osc), n_waves=int(n_waves),
            row_map=SegmentMap.build(a["entry_row"], r, device),
            osc_map=SegmentMap.build(a["entry_osc"], n_osc, device),
            read_waves=tuple(w & (t["op"] == READ) for w in in_wave),
            write_waves=tuple(w & (t["op"] == WRITE) for w in in_wave),
            names=names, key=digest.hexdigest())

    def arrays(self) -> dict:
        """The table's arrays on the host (what :meth:`from_arrays` takes)."""
        return {f: getattr(self, f).cpu().numpy() for f in _TABLE_FIELDS}

    def padded(self, n_rows: int, n_entries: int, n_waves: int,
               new_n_osc: int, osc_remap=None) -> "WorkloadTable":
        """Pad to a ragged-batch bucket shape with inert phantom rows
        (the reference's ``WorkloadTable.padded``).

        Phantom rows carry exact arithmetic identities: ``duty_cycle=0``
        (never active), ``n_threads=0`` (zero issue cap), ``row_valid``
        off.  Phantom stripe entries point at the first phantom row, so
        their per-entry shares are exactly ``0.0`` and every segment sum
        they join is unchanged bit for bit.  ``osc_remap`` (old interface
        -> new) rewires the stripe scatter when the topology itself was
        padded; waves beyond ``self.n_waves`` run empty.
        """
        r, e = len(self), self.entry_row.shape[0]
        if n_rows < r or n_entries < e or n_waves < self.n_waves:
            raise ValueError("padded shape must cover the existing table")
        if n_entries > e and n_rows == r:
            raise ValueError("phantom entries need at least one phantom row")
        a = self.arrays()
        pr, pe = n_rows - r, n_entries - e
        fills = {"client": 0, "op": READ, "req_size": 1.0, "randomness": 0.0,
                 "n_threads": 0.0, "thread_rate": 0.0, "duty_cycle": 0.0,
                 "period": 1.0, "stripe_len": 1.0, "wave": 0,
                 "row_valid": False}
        out = {f: np.concatenate([a[f], np.full(pr, v, dtype=a[f].dtype)])
               for f, v in fills.items()}
        entry_osc = a["entry_osc"]
        if osc_remap is not None:
            entry_osc = np.asarray(osc_remap, dtype=np.int64)[entry_osc]
        out["entry_row"] = np.concatenate(
            [a["entry_row"], np.full(pe, r, dtype=np.int64)])
        out["entry_osc"] = np.concatenate(
            [entry_osc, np.zeros(pe, dtype=np.int64)])
        return WorkloadTable.from_arrays(out, n_osc=new_n_osc,
                                         n_waves=n_waves, device=self.device,
                                         names=self.names)

    @staticmethod
    def block_arrays(parts: list, n_osc: int, n_clients: int) -> dict:
        """B tables' host arrays (each what :meth:`arrays` gives), each
        table over ``n_osc`` interfaces and ``n_clients`` clients with
        one row count, as one table's arrays over the block-diagonal
        fleet: element b's rows become ``b * R + r``, its stripe entries
        ``b * E + e``, its interfaces ``b * n_osc + osc`` and its clients
        ``b * n_clients + c``."""
        r = len(parts[0]["op"])
        if any(len(p["op"]) != r for p in parts):
            raise ValueError("WorkloadTable.block: tables of different "
                             "shapes")
        out = {f: np.concatenate([p[f] for p in parts])
               for f in _TABLE_FIELDS}
        for f, step in (("client", n_clients), ("entry_row", r),
                        ("entry_osc", n_osc)):
            counts = [len(p[f]) for p in parts]
            out[f] = out[f] + np.repeat(np.arange(len(parts)) * step, counts)
        return out

    @classmethod
    def block(cls, tables: list, n_clients: int, device) -> "WorkloadTable":
        """B tables of one shape (``n_osc`` interfaces and ``n_clients``
        clients each) as one table over the block-diagonal fleet
        (:meth:`block_arrays`).  Waves stay per element: rows of
        different elements never share an interface, so wave k of the
        whole is the union of the elements' wave k."""
        n = tables[0].n_osc
        if any(t.n_osc != n for t in tables):
            raise ValueError("WorkloadTable.block: tables of different "
                             "shapes")
        return cls.from_arrays(
            cls.block_arrays([t.arrays() for t in tables], n, n_clients),
            n_osc=len(tables) * n, n_waves=max(t.n_waves for t in tables),
            device=device)

    def init_wstate(self, state: SimState) -> WorkloadState:
        """Bind the table to a state: zero issued bytes and each row's
        delivered stripe bytes so far as its base."""
        zero = torch.zeros(len(self), dtype=F64, device=self.device)
        return WorkloadState(issued=zero.clone(), done_base=self.done_bytes(
            state, WorkloadState(issued=zero, done_base=zero)))

    # ------------------------------------------------------------------ #
    def done_bytes(self, state: SimState, wstate: WorkloadState):
        """Per-row delivered bytes (stripe sum, net of the attach base)."""
        done_e = state.ctr_bytes_done[self.op[self.entry_row], self.entry_osc]
        return segment_sum(done_e, self.row_map) - wstate.done_base

    def demand_step(self, params: SimParams, wstate: WorkloadState,
                    state: SimState):
        """One tick of demand for the whole fleet.

        The closed-loop reader / grant-throttled writer semantics of the
        reference's ``WorkloadTable.demand_step``, wave by wave, with the
        same arithmetic.  Returns ``(demand, wstate')``.
        """
        n = self.n_osc
        dev = self.device
        dt = params.tick
        e_row, e_osc = self.entry_row, self.entry_osc
        osc_sum = lambda v: segment_sum(v, self.osc_map)
        row_sum = lambda v: segment_sum(v, self.row_map)
        slen_e = self.stripe_len[e_row]
        rand_row_e = self.randomness[e_row]
        req_floor_e = torch.clamp_min(self.req_size, 1.0)[e_row]

        rand_r = state.randomness[READ]
        rand_w = state.randomness[WRITE]
        blocked = state.write_blocked
        dirty = state.dirty_bytes
        grant = state.grant_used

        zero_n = torch.zeros(n, dtype=F64, device=dev)
        pend_read_add = dirty_add = cache_add = zero_n
        req_cnt_add = [zero_n, zero_n]
        req_bytes_add = [zero_n, zero_n]
        issued = wstate.issued

        # ``now`` is a float or a 0-dim float64 tensor on the device (the
        # fused loop's clock): the same value broadcast either way
        now = state.now
        now_row = (now.expand(self.period.shape) if torch.is_tensor(now)
                   else torch.full_like(self.period, now))
        phase = torch.fmod(now_row, self.period)
        active = ((self.duty_cycle >= 1.0)
                  | (phase < self.duty_cycle * self.period)) & self.row_valid
        cap_row = self.n_threads * self.thread_rate * dt
        # reads never observe intra-tick counter changes, so the
        # stripe-summed done_bytes uses the tick-start counters
        done_row = self.done_bytes(state, wstate)
        seq = 1.0 - self.randomness
        depth = (self.n_threads * self.req_size
                 + seq * params.readahead_bytes * self.stripe_len)

        for k in range(self.n_waves):
            # this wave's demand: closed-loop readers, then the writers
            # that are not blocked (reads leave ``blocked`` untouched)
            is_r = self.read_waves[k] & active
            want_r = torch.minimum(
                torch.clamp_min(depth - (issued - done_row), 0.0), cap_row)
            want_r = torch.where(is_r & (want_r > 0), want_r, 0.0)
            issued = issued + want_r
            per_e = want_r[e_row] / slen_e
            w_e = torch.clamp_max(per_e / (4 * 2**20), 1.0)
            inc_e = torch.where(want_r[e_row] > 0,
                                torch.clamp_min(per_e / req_floor_e, 1.0),
                                0.0)
            blocked_any = row_sum(blocked[e_osc].to(F64)) > 0
            goes = self.write_waves[k] & active & ~blocked_any
            want_w = torch.where(goes, cap_row, 0.0)
            per_we = want_w[e_row] / slen_e
            inc_we = torch.where(per_we > 0,
                                 torch.clamp_min(per_we / req_floor_e, 1.0),
                                 0.0)
            # the wave's eight per-interface sums in one launch
            (per_osc, w_osc_r, contrib, inc_osc, cache_osc, want_osc, rr_osc,
             inc_wosc) = osc_sum(torch.stack([
                 per_e, 0.2 * w_e, (0.2 * w_e) * rand_row_e, inc_e,
                 (1.0 - rand_row_e) * per_e, per_we,
                 torch.where(per_we > 0, rand_row_e, 0.0), inc_we]))

            # ---- closed-loop readers -------------------------------- #
            pend_read_add = pend_read_add + per_osc
            # randomness EMA: stripes within a wave are disjoint per op,
            # so the scatter has at most one contributor per interface
            factor = 1.0 - w_osc_r
            rand_r = factor * rand_r + contrib
            req_cnt_add[READ] = req_cnt_add[READ] + inc_osc
            req_bytes_add[READ] = req_bytes_add[READ] + per_osc
            cache_add = cache_add + cache_osc

            # ---- grant-throttled writers ---------------------------- #
            room = torch.minimum(params.max_dirty_bytes - dirty,
                                 params.grant_bytes - grant)
            accepted = torch.minimum(torch.clamp_min(want_osc, 0.0),
                                     torch.clamp_min(room, 0.0))
            dirty = dirty + accepted
            grant = grant + accepted
            dirty_add = dirty_add + accepted
            w_osc = torch.clamp_max(accepted / (4 * 2**20), 1.0)
            rand_w = (1.0 - 0.2 * w_osc) * rand_w + (0.2 * w_osc) * rr_osc
            req_cnt_add[WRITE] = req_cnt_add[WRITE] + inc_wosc
            req_bytes_add[WRITE] = req_bytes_add[WRITE] + accepted
            submitted = want_osc > 0
            blocked = torch.where(submitted, accepted < want_osc, blocked)
            # whole-stripe closed-loop settlement: only the accepted
            # bytes count as issued, in one correction
            issued = issued + row_sum(
                torch.where(per_we > 0, accepted[e_osc], 0.0))

        demand = Demand(
            pending_read_add=pend_read_add,
            dirty_add=dirty_add,
            req_count_add=torch.stack(req_cnt_add),
            req_bytes_add=torch.stack(req_bytes_add),
            cache_hit_add=cache_add,
            randomness_new=torch.stack([rand_r, rand_w]),
            write_blocked_new=blocked,
        )
        return demand, WorkloadState(issued=issued,
                                     done_base=wstate.done_base)


def table_from_sim(sim):
    """Freeze a sim's attached workloads into ``(table, wstate)``,
    continuing each workload's closed-loop state (issued bytes and the
    done-bytes base captured at attach); the sim's own kept table, if
    any, is synced back and dropped first."""
    sim.sync_workloads()
    table = WorkloadTable.from_workloads(sim.workloads, sim.topo)
    wstate = WorkloadState(
        issued=torch.tensor(sim.issued, dtype=F64, device=sim.device),
        done_base=torch.tensor(sim.done_base, dtype=F64, device=sim.device))
    return table, wstate


def sync_workloads_from_table(sim, wstate: WorkloadState) -> None:
    """Write the table's closed-loop state back into the sim."""
    sim.issued = [float(v) for v in wstate.issued.cpu()]

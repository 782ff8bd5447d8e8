"""The PFS engine tick and the workload demand, plain PyTorch.

One fleet of OSC interfaces: interface ``i`` belongs to client
``osc_client[i]`` and is backed by OST ``osc_ost[i]``.  Every per-OST,
per-client and stripe reduction is a :class:`SegMap` sum, which adds
each segment's entries in entry order.  The phases
and the order of every operation are those of DIAL's simulated Lustre
client (formation, dispatch, OST drain, bandwidth, completion,
accounting), so in float64 the result is the ordered float64 engine's
bit for bit.  ``now`` is a Python float, advanced by one ``+ tick`` a
tick.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PAGE_SIZE = 4096
READ, WRITE = 0, 1
MIB = 2**20

# the longest segment a sum on the card takes, one add a column
SHORT = 16

# every state field, in a fixed order; (2, n) per-op fields first
PER_OP = ("pending", "hold_age", "queue_rpcs", "queue_bytes", "active_rpcs",
          "setup_work", "unready_bytes", "ready_bytes", "active_avg_size",
          "dispatch_time_num", "randomness", "ctr_bytes_done",
          "ctr_rpcs_sent", "ctr_rpc_bytes", "ctr_partial_rpcs",
          "ctr_latency_sum", "ctr_rpcs_done", "ctr_req_count",
          "ctr_req_bytes", "ctr_pending_integral", "ctr_active_integral")
PER_OSC = ("dirty_bytes", "grant_used", "ctr_cache_hit_bytes",
           "ctr_block_time", "ctr_dirty_integral", "ctr_grant_integral")
KNOBS = ("window_pages", "rpcs_in_flight")
FIELDS = KNOBS + PER_OP + PER_OSC + ("write_blocked",)
COUNTERS = tuple(f for f in FIELDS if f.startswith("ctr_"))


@dataclasses.dataclass(frozen=True)
class Params:
    """The simulated cluster's physical constants (a configuration's
    ``sim_params``)."""

    tick: float
    ost_bandwidth: float
    ost_setup_parallel: float
    ost_iops: float
    setup_time_seq: float
    setup_time_rand: float
    rtt: float
    nic_bandwidth: float
    hold_time_read: float
    hold_time_write: float
    ost_buffer_bytes: float
    congestion_exp: float
    max_dirty_bytes: float
    grant_bytes: float
    readahead_bytes: float
    max_rpc_queue: int

    def setup_time(self, randomness):
        return self.setup_time_seq + randomness * self.setup_time_rand

    def hold_time(self, op: int) -> float:
        return self.hold_time_read if op == READ else self.hold_time_write


@dataclasses.dataclass(frozen=True)
class Fleet:
    """The wiring and the workload table, numpy arrays on the host.

    ``rows`` holds one float64 or int64 array per workload field
    (client, op, req_size, randomness, n_threads, thread_rate,
    duty_cycle, period, stripe_len); ``entry_row`` / ``entry_osc`` is the
    flattened stripe scatter, ``wave`` each row's conflict-free wave.
    """

    n_clients: int
    n_osts: int
    osc_client: np.ndarray
    osc_ost: np.ndarray
    rows: dict
    entry_row: np.ndarray
    entry_osc: np.ndarray
    wave: np.ndarray

    @property
    def n_osc(self) -> int:
        return self.osc_ost.shape[0]

    @property
    def n_waves(self) -> int:
        return int(self.wave.max()) + 1 if self.wave.size else 1


def waves(op: np.ndarray, entry_row: np.ndarray,
          entry_osc: np.ndarray) -> np.ndarray:
    """Each row one wave after the latest earlier row of the same op
    that shares an interface with it (rows in table order)."""
    r = op.shape[0]
    starts = np.searchsorted(entry_row, np.arange(r + 1))
    latest: dict = {}
    out = np.zeros(r, dtype=np.int64)
    for i in range(r):
        keys = [(int(op[i]), int(o))
                for o in entry_osc[starts[i]:starts[i + 1]]]
        out[i] = max((latest[k] + 1 for k in keys if k in latest), default=0)
        for k in keys:
            latest[k] = max(latest.get(k, -1), int(out[i]))
    return out


def longest(ids: np.ndarray) -> int:
    """The most entries any segment of a map has."""
    return int(np.bincount(np.asarray(ids, dtype=np.int64)).max(initial=0))


def engine_device(fleet: Fleet, card) -> torch.device:
    """The card where every sum of the fleet has short segments (a few
    adds a column), else the CPU: a long segment's ordered adds are one
    launch each on the card."""
    short = max(longest(ids) for ids in (fleet.osc_ost, fleet.osc_client,
                                         fleet.entry_row, fleet.entry_osc))
    card = torch.device(card)
    return card if card.type != "cpu" and short <= SHORT else \
        torch.device("cpu")


class SegMap:
    """An ``entry -> segment`` map whose sums add each segment's entries
    in entry order, starting from ``+0.0``: on the CPU by
    ``index_add_``, on the card (no segment longer than :data:`SHORT`)
    by a padded ``(segments, longest)`` gather and one add a column (a
    pad reads ``+0.0``, which changes no sum)."""

    def __init__(self, ids: np.ndarray, n: int, device):
        ids = np.asarray(ids, dtype=np.int64)
        self.n = int(n)
        self.device = torch.device(device)
        self.ids = torch.as_tensor(ids, device=self.device)
        self.pad = None
        if self.device.type == "cpu":
            return
        if longest(ids) > SHORT:
            raise ValueError(f"a segment of {longest(ids)} entries: sum it "
                             "on the CPU")
        counts = np.bincount(ids, minlength=n)
        order = np.argsort(ids, kind="stable")
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pad = np.full((n, int(counts.max(initial=1))), ids.shape[0],
                      dtype=np.int64)
        pad[ids[order], np.arange(ids.shape[0]) - starts[ids[order]]] = order
        self.pad = torch.as_tensor(pad, device=self.device)

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        if self.pad is None:
            out = torch.zeros((*values.shape[:-1], self.n),
                              dtype=values.dtype)
            return out.index_add_(-1, self.ids, values)
        zero = torch.zeros((*values.shape[:-1], 1), dtype=values.dtype,
                           device=values.device)
        cols = torch.cat([values, zero], dim=-1)[..., self.pad]
        acc = torch.zeros((*values.shape[:-1], self.n), dtype=values.dtype,
                          device=values.device)
        for j in range(cols.shape[-1]):
            acc = acc + cols[..., j]
        return acc


# --- the correctly rounded float64 power (double-double steps) -------- #
# Written on operators, so the same steps run on numpy arrays (the CPU)
# and on tensors (the card); every step is exact or correctly rounded
# in IEEE float64 on both.
_SPLIT = 134217729.0
_NEG_LN2 = (-0.6931471805599453, -2.3190468138462996e-17)
_SIXTH = (1.0 / 6.0, 9.25185853854297e-18)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _quick_two_sum(a, b):
    s = a + b
    return s, b - (s - a)


def _two_prod(a, b):
    p = a * b
    c = _SPLIT * a
    ah = c - (c - a)
    c = _SPLIT * b
    bh = c - (c - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _dd_add(a, b):
    sh, sl = _two_sum(a[0], b[0])
    th, tl = _two_sum(a[1], b[1])
    uh, ul = _quick_two_sum(sh, sl + th)
    return _quick_two_sum(uh, ul + tl)


def _dd_mul(a, b):
    ph, pl = _two_prod(a[0], b[0])
    return _quick_two_sum(ph, pl + (a[0] * b[1] + a[1] * b[0]))


def _dd_mul_d(a, d):
    ph, pl = _two_prod(a[0], d)
    return _quick_two_sum(ph, pl + a[1] * d)


def _dd_exp(z, xp):
    k = xp.round(z[0] / -_NEG_LN2[0])            # half to even
    r = _dd_add(z, _dd_mul_d(_NEG_LN2, k))
    r = (r[0] * 2.0 ** -10, r[1] * 2.0 ** -10)
    r2 = _dd_mul(r, r)
    r3, r4 = _dd_mul(r2, r), _dd_mul(r2, r2)
    h = r[0]
    tail = 1.0 / 24.0 + h * (1.0 / 120.0 + h * (1.0 / 720.0 + h * (
        1.0 / 5040.0 + h * (1.0 / 40320.0 + h / 362880.0))))
    em1 = _dd_add(r, _dd_mul_d(r2, 0.5))
    em1 = _dd_add(em1, _dd_mul(r3, _SIXTH))
    em1 = _dd_add(em1, _dd_mul_d(r4, tail))
    for _ in range(10):                          # (1 + m)^2 = 1 + 2m + m^2
        em1 = _dd_add(_dd_mul_d(em1, 2.0), _dd_mul(em1, em1))
    one = xp.ones_like(em1[0])
    hi, lo = _dd_add((one, xp.zeros_like(one)), em1)
    # 2^k built from its bits: exact on every device
    if xp is np:
        scale = ((k.astype(np.int64) + 1023) << 52).view(np.float64)
    else:
        scale = ((k.to(torch.int64) + 1023) << 52).view(torch.float64)
    return hi * scale, lo * scale


def power(x: torch.Tensor, e: float) -> torch.Tensor:
    """``x ** e`` for ``0 < x <= 1``: correctly rounded in float64 (on
    the CPU through numpy), ``torch.pow`` in any other type."""
    if x.dtype != torch.float64:
        return torch.pow(x, e)
    if x.numel() == 0:
        return x.clone()
    on_host = x.device.type == "cpu"
    xp = np if on_host else torch
    v = x.numpy() if on_host else x
    zero = xp.zeros_like(v)
    l0 = xp.log(v)
    ex = _dd_exp((-l0, zero), xp)
    t = _dd_add(_dd_mul_d(ex, v), (-xp.ones_like(v), zero))
    out = _dd_exp(_dd_mul_d(_dd_add((l0, zero), t), e), xp)[0]
    out = xp.where(v == 1.0, 1.0, out)
    return torch.from_numpy(out) if on_host else out


def _div_where(num, den, cond, fallback):
    return torch.where(cond, num / torch.where(cond, den, 1.0), fallback)


class Engine:
    """The engine tick and the demand of one fleet in ``dtype`` on
    ``device`` (the CPU by default; see :func:`engine_device`).
    Elementwise float64 operations round the same on the CPU and the
    card, and every sum is ordered, so the device changes no bit."""

    def __init__(self, params: Params, fleet: Fleet,
                 dtype: torch.dtype = torch.float64, device=None):
        self.p = params
        self.fleet = fleet
        self.dtype = dtype
        self.device = dev = torch.device(device or "cpu")
        as_i = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),
                                         device=dev)
        as_f = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                         dtype=dtype, device=dev)
        self.osc_ost = as_i(fleet.osc_ost)
        self.osc_client = as_i(fleet.osc_client)
        rows = fleet.rows
        self.op = as_i(rows["op"])
        for f in ("req_size", "randomness", "n_threads", "thread_rate",
                  "duty_cycle", "period", "stripe_len"):
            setattr(self, f, as_f(rows[f]))
        self.period64 = torch.as_tensor(
            np.asarray(rows["period"], dtype=np.float64), device=dev)
        self.duty64 = torch.as_tensor(
            np.asarray(rows["duty_cycle"], dtype=np.float64), device=dev)
        self.e_row = as_i(fleet.entry_row)
        self.e_osc = as_i(fleet.entry_osc)
        self.n_rows = self.op.shape[0]
        self.ost_sum = SegMap(fleet.osc_ost, fleet.n_osts, dev)
        self.client_sum = SegMap(fleet.osc_client, fleet.n_clients, dev)
        self.row_sum = SegMap(fleet.entry_row, self.n_rows, dev)
        self.osc_sum = SegMap(fleet.entry_osc, fleet.n_osc, dev)
        wave = torch.as_tensor(fleet.wave, device=dev)
        self.read_waves = [(wave == k) & (self.op == READ)
                           for k in range(fleet.n_waves)]
        self.write_waves = [(wave == k) & (self.op == WRITE)
                            for k in range(fleet.n_waves)]

    # ------------------------------------------------------------------ #
    def init_state(self, window_pages: int, rpcs_in_flight: int) -> dict:
        n, kw = self.fleet.n_osc, {"dtype": self.dtype, "device": self.device}
        st = {f: torch.zeros((2, n), **kw) for f in PER_OP}
        st.update({f: torch.zeros(n, **kw) for f in PER_OSC})
        st["active_avg_size"] = torch.full((2, n), float(PAGE_SIZE), **kw)
        st["window_pages"] = torch.full((n,), int(window_pages),
                                        dtype=torch.int64, device=self.device)
        st["rpcs_in_flight"] = torch.full((n,), int(rpcs_in_flight),
                                          dtype=torch.int64,
                                          device=self.device)
        st["write_blocked"] = torch.zeros(n, dtype=torch.bool,
                                          device=self.device)
        st["now"] = 0.0
        st["issued"] = torch.zeros(self.n_rows, **kw)
        st["done_base"] = torch.zeros(self.n_rows, **kw)
        return st

    def to_state(self, st: dict) -> dict:
        """A state from elsewhere (the program's) on this engine's
        device, its floats in this engine's type."""
        return {k: (v.to(self.device, self.dtype) if torch.is_tensor(v)
                    and v.is_floating_point() else
                    v.to(self.device) if torch.is_tensor(v) else v)
                for k, v in st.items()}

    def done_bytes(self, st: dict) -> torch.Tensor:
        done_e = st["ctr_bytes_done"][self.op[self.e_row], self.e_osc]
        return self.row_sum(done_e) - st["done_base"]

    def demand(self, st: dict) -> tuple:
        """One tick of every workload row's submissions, wave by wave:
        ``(pending_read_add, dirty_add, req_count_add, req_bytes_add,
        cache_hit_add, randomness_new, write_blocked_new, issued)``."""
        p = self.p
        n, dtp = self.fleet.n_osc, self.dtype
        dt = p.tick
        e_row, e_osc = self.e_row, self.e_osc
        osc_sum, row_sum = self.osc_sum, self.row_sum
        slen_e = self.stripe_len[e_row]
        rand_row_e = self.randomness[e_row]
        req_floor_e = torch.clamp_min(self.req_size, 1.0)[e_row]
        rand_r, rand_w = st["randomness"][READ], st["randomness"][WRITE]
        blocked = st["write_blocked"]
        dirty, grant = st["dirty_bytes"], st["grant_used"]
        zero_n = torch.zeros(n, dtype=dtp, device=self.device)
        pend_read_add = dirty_add = cache_add = zero_n
        req_cnt = [zero_n, zero_n]
        req_bytes = [zero_n, zero_n]
        issued = st["issued"]

        # the duty-cycle phase is taken on the float64 clock
        phase = torch.fmod(torch.full_like(self.period64, st["now"]),
                           self.period64)
        active = (self.duty64 >= 1.0) | (phase < self.duty64 * self.period64)
        cap_row = self.n_threads * self.thread_rate * dt
        done_row = self.done_bytes(st)
        seq = 1.0 - self.randomness
        depth = (self.n_threads * self.req_size
                 + seq * p.readahead_bytes * self.stripe_len)

        for k in range(self.fleet.n_waves):
            is_r = self.read_waves[k] & active
            want_r = torch.minimum(
                torch.clamp_min(depth - (issued - done_row), 0.0), cap_row)
            want_r = torch.where(is_r & (want_r > 0), want_r, 0.0)
            issued = issued + want_r
            per_e = want_r[e_row] / slen_e
            w_e = torch.clamp_max(per_e / (4 * MIB), 1.0)
            inc_e = torch.where(want_r[e_row] > 0,
                                torch.clamp_min(per_e / req_floor_e, 1.0),
                                0.0)
            blocked_any = row_sum(blocked[e_osc].to(dtp)) > 0
            goes = self.write_waves[k] & active & ~blocked_any
            want_w = torch.where(goes, cap_row, 0.0)
            per_we = want_w[e_row] / slen_e
            inc_we = torch.where(per_we > 0,
                                 torch.clamp_min(per_we / req_floor_e, 1.0),
                                 0.0)
            (per_osc, w_osc_r, contrib, inc_osc, cache_osc, want_osc, rr_osc,
             inc_wosc) = osc_sum(torch.stack([
                 per_e, 0.2 * w_e, (0.2 * w_e) * rand_row_e, inc_e,
                 (1.0 - rand_row_e) * per_e, per_we,
                 torch.where(per_we > 0, rand_row_e, 0.0), inc_we]))

            # closed-loop readers
            pend_read_add = pend_read_add + per_osc
            rand_r = (1.0 - w_osc_r) * rand_r + contrib
            req_cnt[READ] = req_cnt[READ] + inc_osc
            req_bytes[READ] = req_bytes[READ] + per_osc
            cache_add = cache_add + cache_osc

            # grant-throttled writers
            room = torch.minimum(p.max_dirty_bytes - dirty,
                                 p.grant_bytes - grant)
            accepted = torch.minimum(torch.clamp_min(want_osc, 0.0),
                                     torch.clamp_min(room, 0.0))
            dirty = dirty + accepted
            grant = grant + accepted
            dirty_add = dirty_add + accepted
            w_osc = torch.clamp_max(accepted / (4 * MIB), 1.0)
            rand_w = (1.0 - 0.2 * w_osc) * rand_w + (0.2 * w_osc) * rr_osc
            req_cnt[WRITE] = req_cnt[WRITE] + inc_wosc
            req_bytes[WRITE] = req_bytes[WRITE] + accepted
            blocked = torch.where(want_osc > 0, accepted < want_osc, blocked)
            issued = issued + row_sum(
                torch.where(per_we > 0, accepted[e_osc], 0.0))

        return (pend_read_add, dirty_add, torch.stack(req_cnt),
                torch.stack(req_bytes), cache_add,
                torch.stack([rand_r, rand_w]), blocked, issued)

    # ------------------------------------------------------------------ #
    def step(self, st: dict, dist: dict | None = None) -> dict:
        """One tick: the demand, then formation -> dispatch -> OST drain
        -> bandwidth -> completion -> accounting.  ``dist`` is the tick's
        ``bw_scale``, ``iops_scale``, ``bg_bytes`` (per OST) and
        ``nic_scale`` (per client), or ``None`` for none."""
        p, f = self.p, self.fleet
        dt = p.tick
        dtp = self.dtype
        osc_ost, osc_client = self.osc_ost, self.osc_client
        ost_sum = self.ost_sum
        if dist is None:
            kw = {"dtype": dtp, "device": self.device}
            ones_o = torch.ones(f.n_osts, **kw)
            dist = {"bw_scale": ones_o, "iops_scale": ones_o,
                    "bg_bytes": torch.zeros(f.n_osts, **kw),
                    "nic_scale": torch.ones(f.n_clients, **kw)}
        (pend_read_add, dirty_add, req_cnt_add, req_bytes_add, cache_hit_add,
         randomness_new, blocked_new, issued) = self.demand(st)

        rows = lambda name: [st[name][READ], st[name][WRITE]]
        pending, hold_age = rows("pending"), rows("hold_age")
        queue_rpcs, queue_bytes = rows("queue_rpcs"), rows("queue_bytes")
        active_rpcs, setup_work = rows("active_rpcs"), rows("setup_work")
        unready, ready_b = rows("unready_bytes"), rows("ready_bytes")
        avg_size = rows("active_avg_size")
        disp_num = rows("dispatch_time_num")
        ctr_bytes_done = rows("ctr_bytes_done")
        ctr_rpcs_sent, ctr_rpc_bytes = rows("ctr_rpcs_sent"), \
            rows("ctr_rpc_bytes")
        ctr_partial, ctr_lat = rows("ctr_partial_rpcs"), \
            rows("ctr_latency_sum")
        ctr_rpcs_done = rows("ctr_rpcs_done")
        ctr_pend_int = rows("ctr_pending_integral")
        ctr_act_int = rows("ctr_active_integral")
        dirty, grant = st["dirty_bytes"], st["grant_used"]
        now = st["now"]

        # (1) demand
        pending[READ] = pending[READ] + pend_read_add
        dirty = dirty + dirty_add
        grant = grant + dirty_add
        ctr_req_count = st["ctr_req_count"] + req_cnt_add
        ctr_req_bytes = st["ctr_req_bytes"] + req_bytes_add
        ctr_cache_hit = st["ctr_cache_hit_bytes"] + cache_hit_add
        ctr_bytes_done[WRITE] = ctr_bytes_done[WRITE] + dirty_add
        randomness = [randomness_new[READ], randomness_new[WRITE]]
        blocked = blocked_new

        in_pipe = (pending[WRITE] + queue_bytes[WRITE]
                   + unready[WRITE] + ready_b[WRITE])
        pending[WRITE] = pending[WRITE] + torch.clamp_min(dirty - in_pipe,
                                                          0.0)

        # (2) formation
        win_bytes = (st["window_pages"] * PAGE_SIZE).to(dtp)
        for op in (READ, WRITE):
            pend = pending[op]
            room = torch.clamp_min(p.max_rpc_queue - queue_rpcs[op], 0.0)
            n_full = torch.minimum(torch.floor(pend / win_bytes), room)
            full_bytes = n_full * win_bytes
            queue_rpcs[op] = queue_rpcs[op] + n_full
            queue_bytes[op] = queue_bytes[op] + full_bytes
            pend = pend - full_bytes
            hold_age[op] = torch.where(pend > 0, hold_age[op] + dt, 0.0)
            expire = ((pend > 0) & (hold_age[op] >= p.hold_time(op))
                      & (room > n_full))
            queue_rpcs[op] = queue_rpcs[op] + expire
            queue_bytes[op] = queue_bytes[op] + torch.where(expire, pend, 0.0)
            ctr_partial[op] = ctr_partial[op] + expire
            pending[op] = torch.where(expire, 0.0, pend)
            hold_age[op] = torch.where(expire, 0.0, hold_age[op])

        # (3) dispatch, reads first
        slots = torch.clamp_min(
            st["rpcs_in_flight"] - (active_rpcs[READ] + active_rpcs[WRITE]),
            0.0)
        for op in (READ, WRITE):
            take = torch.minimum(queue_rpcs[op], slots)
            frac = _div_where(take, queue_rpcs[op], queue_rpcs[op] > 0, 0.0)
            bytes_out = queue_bytes[op] * frac
            queue_rpcs[op] = queue_rpcs[op] - take
            queue_bytes[op] = queue_bytes[op] - bytes_out
            slots = slots - take
            active_rpcs[op] = active_rpcs[op] + take
            per_rpc = p.setup_time(randomness[op]) + p.rtt
            setup_work[op] = setup_work[op] + take * per_rpc
            unready[op] = unready[op] + bytes_out
            tot_bytes = unready[op] + ready_b[op]
            avg_size[op] = torch.where(
                active_rpcs[op] > 0,
                tot_bytes / torch.clamp_min(active_rpcs[op], 1e-9),
                avg_size[op])
            ctr_rpcs_sent[op] = ctr_rpcs_sent[op] + take
            ctr_rpc_bytes[op] = ctr_rpc_bytes[op] + bytes_out
            disp_num[op] = disp_num[op] + take * now

        # (4) OST setup service and IOPS ceiling
        ost_work = ost_sum(setup_work[READ] + setup_work[WRITE])
        cap = dt * p.ost_setup_parallel * dist["iops_scale"]
        drain_frac_ost = _div_where(cap, ost_work, ost_work > cap, 1.0)
        work = torch.stack(setup_work)
        drained = work * drain_frac_ost[osc_ost]
        per_rpc = p.setup_time(torch.stack(randomness)) + p.rtt
        setups_done = _div_where(drained, per_rpc, per_rpc > 0, 0.0)
        ost_setups = ost_sum(setups_done)
        iops_cap = p.ost_iops * dt * dist["iops_scale"]
        iops_frac = _div_where(iops_cap, ost_setups, ost_setups > iops_cap,
                               1.0)
        effective = drained * iops_frac[:, osc_ost]
        for op in (READ, WRITE):
            setup_work[op] = work[op] - effective[op]
            ready = torch.minimum(
                _div_where(effective[op], per_rpc[op], per_rpc[op] > 0, 0.0)
                * avg_size[op], unready[op])
            ready = torch.where(setup_work[op] <= 1e-12, unready[op], ready)
            unready[op] = unready[op] - ready
            ready_b[op] = ready_b[op] + ready

        # (5) bandwidth: OST fair share, congestion, background, NIC cap
        want = ready_b[READ] + ready_b[WRITE]
        queued = unready[READ] + unready[WRITE] + ready_b[READ] + \
            ready_b[WRITE]
        active_transfer = torch.where(
            want > 0, active_rpcs[READ] + active_rpcs[WRITE], 0.0)
        ost_queued, ost_active = ost_sum(torch.stack([queued,
                                                      active_transfer]))
        ost_queued = ost_queued + dist["bg_bytes"]
        # the congestion factor, worked out where it applies
        congested = ost_queued > p.ost_buffer_bytes
        eff = torch.ones_like(ost_queued)
        eff[congested] = power(p.ost_buffer_bytes / torch.clamp_min(
            ost_queued[congested], 1.0), p.congestion_exp)
        ost_shares = ost_active[osc_ost]
        share = _div_where(active_transfer, ost_shares, ost_shares > 0, 0.0)
        ost_bw_eff = p.ost_bandwidth * dist["bw_scale"] * eff
        bg_served = torch.minimum(dist["bg_bytes"], ost_bw_eff * dt)
        alloc = torch.minimum(
            share * ost_bw_eff[osc_ost] * dt - share * bg_served[osc_ost],
            want)
        hungry = want - alloc
        ost_alloc, ost_hungry = ost_sum(torch.stack([alloc, hungry]))
        leftover = (ost_bw_eff * dt - bg_served) - ost_alloc
        bonus_frac = _div_where(leftover, ost_hungry, ost_hungry > 0, 0.0)
        alloc = alloc + hungry * torch.clamp_max(bonus_frac[osc_ost], 1.0)
        nic_cap = p.nic_bandwidth * dist["nic_scale"] * dt
        client_alloc = self.client_sum(alloc)
        nic_frac = _div_where(nic_cap, client_alloc, client_alloc > nic_cap,
                              1.0)
        alloc = alloc * nic_frac[osc_client]

        # (6) completions
        for op in (READ, WRITE):
            frac = _div_where(ready_b[op], want, want > 0, 0.0)
            drained = alloc * frac
            ready_b[op] = ready_b[op] - drained
            avg = torch.clamp_min(avg_size[op], 1.0)
            done_rpcs = torch.minimum(drained / avg, active_rpcs[op])
            inflight_bytes = unready[op] + ready_b[op]
            done_rpcs = torch.where(inflight_bytes <= 1e-9, active_rpcs[op],
                                    done_rpcs)
            prev_active = active_rpcs[op]
            active_rpcs[op] = active_rpcs[op] - done_rpcs
            ctr_rpcs_done[op] = ctr_rpcs_done[op] + done_rpcs
            if op == READ:
                ctr_bytes_done[READ] = ctr_bytes_done[READ] + drained
            else:
                dirty = torch.clamp_min(dirty - drained, 0.0)
                grant = torch.clamp_min(grant - drained, 0.0)
            avg_disp = disp_num[op] / torch.clamp_min(prev_active, 1e-9)
            lat = torch.clamp_min(now + dt - avg_disp, dt)
            ctr_lat[op] = ctr_lat[op] + done_rpcs * lat
            keep = active_rpcs[op] / torch.clamp_min(prev_active, 1e-9)
            disp_num[op] = disp_num[op] * keep

        ctr_block_time = st["ctr_block_time"] + blocked.to(dtp) * dt
        room = torch.minimum(p.max_dirty_bytes - dirty, p.grant_bytes - grant)
        blocked = blocked & (room < PAGE_SIZE)
        for op in (READ, WRITE):
            ctr_pend_int[op] = ctr_pend_int[op] + (
                pending[op] + queue_bytes[op]) * dt
            ctr_act_int[op] = ctr_act_int[op] + active_rpcs[op] * dt

        return {
            "now": now + dt,
            "window_pages": st["window_pages"],
            "rpcs_in_flight": st["rpcs_in_flight"],
            "pending": torch.stack(pending),
            "hold_age": torch.stack(hold_age),
            "queue_rpcs": torch.stack(queue_rpcs),
            "queue_bytes": torch.stack(queue_bytes),
            "active_rpcs": torch.stack(active_rpcs),
            "setup_work": torch.stack(setup_work),
            "unready_bytes": torch.stack(unready),
            "ready_bytes": torch.stack(ready_b),
            "active_avg_size": torch.stack(avg_size),
            "dispatch_time_num": torch.stack(disp_num),
            "randomness": torch.stack(randomness),
            "dirty_bytes": dirty,
            "grant_used": grant,
            "write_blocked": blocked,
            "ctr_bytes_done": torch.stack(ctr_bytes_done),
            "ctr_rpcs_sent": torch.stack(ctr_rpcs_sent),
            "ctr_rpc_bytes": torch.stack(ctr_rpc_bytes),
            "ctr_partial_rpcs": torch.stack(ctr_partial),
            "ctr_latency_sum": torch.stack(ctr_lat),
            "ctr_rpcs_done": torch.stack(ctr_rpcs_done),
            "ctr_req_count": ctr_req_count,
            "ctr_req_bytes": ctr_req_bytes,
            "ctr_cache_hit_bytes": ctr_cache_hit,
            "ctr_block_time": ctr_block_time,
            "ctr_pending_integral": torch.stack(ctr_pend_int),
            "ctr_active_integral": torch.stack(ctr_act_int),
            "ctr_dirty_integral": st["ctr_dirty_integral"] + dirty * dt,
            "ctr_grant_integral": st["ctr_grant_integral"] + grant * dt,
            "issued": issued,
            "done_base": st["done_base"],
        }

"""The per-cohort StreamSim engine in PyTorch: the reference's batched
event loop, with every clock on the device.

This is the port of the reference's ``core/vectorized.py`` event loop
together with the device seams that ``core/jax_engine.py`` moves off
the host.  Whole message cohorts move through an architecture's hop
graph together; one pop of the host's event heap serves one hop of one
cohort batch, and every FIFO resource resolves its busy intervals with
the prefix-scan closed form ``e = H + cummax(a - (H - h))``,
``H = cumsum(h)``.  It runs every pattern (work sharing, feedback,
broadcast, broadcast+gather), with the broker's credit flow and
reject-publish overflow and the chaos schedules; ``run_many`` sends it
every cell but those that ask for the wave program (``engine="jax",
jax_device_loop=True``) and that the wave program's regime gate
accepts.

**Layout.**  A cohort's clocks are :class:`Times`: every seed-lane on
the device as a ``(lanes, n)`` float64 tensor, lanes first so each
recurrence scans along the last dim, and lane 0 mirrored on the host
bit for bit.  Lane 0 is the pilot: as in the reference, its clock
decides every order and branch (service order, the heap key, the event
horizon, the pump's window choice, the ack batching, which members
retry a rejected publish, when withheld confirms resume), so those
decisions read the host mirror.  The host repeats, in the same float64
arithmetic, every step the device takes elementwise (a latency, a
window gate, a lone member's FIFO step: one max and one add), and reads
lane 0 back only after a scan of more than one member, whose sums the
card may associate differently.  Jitter comes from
the reference's per-lane NumPy generators in the reference's event
order, drawn on the host and moved to the device.  ``host_reads``
counts the device-to-host reads.

**Flow control.**  A queue whose publishes could push its backlog past
its credit threshold or byte cap keeps its released depart times in
the reference's masked store (``jax_engine.py``): an ``(lanes,
entries)`` time tensor and a consumed mask, popped by masked
reductions for all lanes at once, with lane 0's store mirrored on the
host as the reference's heap.  Each lane admits a publish cohort on its
own clocks and its own backlog, as the reference's ``_enqueue_batch``
does: the fast path's zero-drain bound is checked on the device for
every lane, and a lane where it fails walks its members in arrival
order on the host, over one counted read of its clocks and sorted
departs (:class:`_Cursor`); the pops the walk makes go back to the
device store before it is next changed.  Rejected publishes retry after
``publish_retry_s`` (a retry cohort of what lane 0 rejected; the other
lanes resolve their own retry cadence against their own departs), and
confirms past a credit threshold are withheld until the queue drains to
half of it.

**Chaos.**  A chaos cell (``params.chaos``, work sharing only) runs solo,
so every clock it reads is lane 0's, on the host.  Each epoch boundary
is a sentinel entry of the event heap whose function changes the
topology between batches (the horizon keeps cohorts from being served
past it): a link outage raises the matched resources' carries to its
end; a broker outage makes its queues reject publishes and deliver
nothing until its end (departs inside it slide to its end), and at its
start every delivery the broker has not acked re-enters the queue's
front, ready at its end (at-least-once: the copy's completion is a
duplicate); a consumer crash drops the consumer from its queue's
rotation and requeues its unacked deliveries at once, and its respawn
rejoins it; the autoscale tick grows or shrinks the fleet from the work
queues' backlog.  A paused queue, and under autoscaling every work
queue, tracks its backlog whatever its volume.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.architectures import Architecture, ResourceSpec
from repro_torch.core.cell import (
    FLOW_CREDIT, WAVE_PATTERNS, Cell, _align_paths)
from repro_torch.core.ds2hpc import ClusterInventory
from repro_torch.core.simulator import ExperimentSpec, RunResult
from repro_torch.device import resolve_device

F64 = torch.float64


def _fifo_scan(a: torch.Tensor, h: torch.Tensor,
               carry: torch.Tensor) -> torch.Tensor:
    """End times of FIFO service, ``e_j = max(a_j, e_{j-1}) + h_j``,
    along the last dim, the server busy until ``carry`` (which
    broadcasts against ``a`` with a last dim of 1).  Leading dims are
    lanes (and servers): each row is its own recurrence."""
    a = torch.maximum(a, carry)
    if a.shape[-1] == 1:
        # one customer: H = h, so H + (a - (H - h)) is a + h exactly
        return a + h
    H = torch.cumsum(h, dim=-1)
    return H + torch.cummax(a - (H - h), dim=-1).values


_ONE = np.zeros(1, dtype=np.int64)


def _run(idx: np.ndarray) -> Optional[slice]:
    """``idx`` as a slice when it is one ascending run of consecutive
    positions, else None."""
    n = idx.size
    if n == 0 or idx[-1] - idx[0] != n - 1:
        return None
    if n > 2 and not (np.diff(idx) == 1).all():
        return None
    return slice(int(idx[0]), int(idx[0]) + n)


class Times:
    """A cohort's clocks: every lane on the device, ``d`` of shape
    ``(lanes, n)``, and lane 0 (the pilot) on the host, ``h`` of shape
    ``(n,)``, equal bit for bit.  Neither is ever changed in place."""

    __slots__ = ("d", "h")

    def __init__(self, d: torch.Tensor, h: np.ndarray) -> None:
        self.d, self.h = d, h

    @property
    def n(self) -> int:
        return self.h.size


class _Cursor:
    """One lane's depart cursor of a tracked queue, on the host: the
    lane's recorded, not yet popped depart times as a min-heap (the
    reference's per-lane heap), the releases popped so far, the last
    popped time, and how many of those pops the device store has taken
    (``synced``)."""

    __slots__ = ("heap", "departed", "last", "synced")

    def __init__(self, heap: list, departed: int, last: float) -> None:
        self.heap, self.departed, self.last = heap, departed, last
        self.synced = departed

    def pop(self, t: float) -> None:
        """Pop every release that left by ``t``."""
        h = self.heap
        while h and h[0] <= t:
            self.last = heapq.heappop(h)
            self.departed += 1

    def pop_to(self, target: int) -> None:
        """Pop, earliest first, until ``target`` releases have been
        popped (best effort: it stops when no recorded drain remains)."""
        h = self.heap
        while self.departed < target and h:
            self.last = heapq.heappop(h)
            self.departed += 1

    def next_drain(self) -> Optional[float]:
        """The earliest recorded, unpopped depart (None: no known
        future drain)."""
        return self.heap[0] if self.heap else None


class _VecResource:
    """Busy-interval state of one shared resource, served in batches:
    one carry per lane (pipe) or per server and lane (pool) on the
    device, and lane 0's carries mirrored on the host.  A pool's servers
    are kept in the pilot's order of free times; ``rows`` maps that order
    to the device's columns."""

    __slots__ = ("spec", "k", "free", "free0", "rows", "_last")

    def __init__(self, spec: ResourceSpec, lanes: int,
                 device: torch.device) -> None:
        self.spec = spec
        self.k = max(1, spec.servers) if spec.kind == "pool" else 1
        self.free = torch.zeros((lanes, self.k), dtype=F64, device=device)
        self.free0 = np.zeros(self.k)
        self.rows = np.arange(self.k)
        self._last: Optional[tuple] = None

    def hold_times(self, nbytes: np.ndarray | float) -> np.ndarray | float:
        s = self.spec
        if s.kind == "pipe":
            return s.service_s + (nbytes / s.rate_Bps if s.rate_Bps else 0.0)
        return s.service_s + nbytes * s.per_byte_s

    def serve(self, a: Times, hold: Times, up: Callable
              ) -> tuple[torch.Tensor, Optional[np.ndarray]]:
        """FIFO-serve a batch (any order) with holds ``hold``: per-member
        end times, on the device, in the batch's order, and their lane 0
        where the host can repeat it (a lone member: one max and one
        add), else None; then the caller reads lane 0 and passes it to
        :meth:`settle`.  The pilot's service order is the stable sort of
        lane 0's arrivals, and a pool's earliest-free server (on lane 0)
        takes the next arrival."""
        n = a.n
        hd = hold.d
        if self.spec.kind == "pool":
            co = np.argsort(self.free0, kind="stable")
            self.rows, self.free0 = self.rows[co], self.free0[co]
        if n == 1:
            if self.spec.kind == "pipe":
                end = torch.maximum(a.d, self.free) + hd
                self.free = end
            else:
                r = int(self.rows[0])
                end = torch.maximum(a.d, self.free[:, r:r + 1]) + hd
                self.free[:, r:r + 1] = end
            e0 = max(a.h[0], self.free0[0]) + hold.h[0]
            self.free0[0] = e0
            return end, np.array([e0])
        order = np.argsort(a.h, kind="stable")
        if (order == np.arange(n)).all():
            order, ad = None, a.d
        else:
            o = up(order)
            ad, hd = a.d.index_select(1, o), hd.index_select(1, o)
        if self.spec.kind == "pipe":
            end = _fifo_scan(ad, hd, self.free)
            self.free = end[:, -1:]
        else:
            # k interleaved chains, scanned at once over a (lanes, k,
            # ceil(n/k)) view padded with inert members (+inf arrivals,
            # zero holds) at the chains' ends
            L, k = ad.shape[0], self.k
            m = -(-n // k)
            rows = up(self.rows)
            carry = self.free.index_select(1, rows)
            if m * k > n:
                ad = torch.nn.functional.pad(ad, (0, m * k - n),
                                             value=float("inf"))
                hd = torch.nn.functional.pad(hd, (0, m * k - n))
            chains = _fifo_scan(ad.reshape(L, m, k).transpose(1, 2),
                                hd.reshape(L, m, k).transpose(1, 2),
                                carry[:, :, None])
            end = chains.transpose(1, 2).reshape(L, m * k)[:, :n]
            cs = np.arange(min(k, n))
            self.free.index_copy_(1, rows[:cs.size], end.index_select(
                1, up(cs + ((n - 1 - cs) // k) * k)))
        self._last = (order, n)
        if order is None:
            return end, None
        out = torch.empty_like(end)
        out.index_copy_(1, up(order), end)
        return out, None

    def hold_until(self, t1: float) -> None:
        """A link outage: no new service starts before ``t1`` (every
        carry raised to it; service already started completes).  The
        servers keep their places, so ties resolve as the reference's
        ``np.maximum`` of its carries leaves them."""
        self.free = torch.clamp_min(self.free, t1)
        self.free0 = np.maximum(self.free0, t1)

    def settle(self, e0: np.ndarray) -> None:
        """Mirror the new lane-0 carries from the lane-0 ends of the last
        :meth:`serve` (in the batch's order), read back by the caller."""
        order, n = self._last
        es = e0 if order is None else e0[order]
        if self.spec.kind == "pipe":
            self.free0[0] = es[-1]
            return
        cs = np.arange(min(self.k, n))
        self.free0[cs] = es[cs + ((n - 1 - cs) // self.k) * self.k]


class TorchStreamSim(Cell):
    """The per-cohort engine; the reference's constructor and
    ``run``/``run_stacked`` contract, plus the device to run on.

    ``stack_seeds[0]`` is the pilot lane; its results are a solo run's
    bit for bit.  ``rejected`` and ``blocked`` count each lane's
    rejected publishes and withheld confirms."""

    #: bound on the memoized (flow, combos) -> resolved-paths cache
    COMBO_CACHE_MAX = 8192
    #: finished runs of this engine in this process, their device-to-host
    #: reads, and the confirms they left withheld (none, once every
    #: resolver fired; the chip smoke resets and reads them)
    stats = {"runs": 0, "host_reads": 0, "withheld": 0}
    #: jitter draws per lane fetched from the generators at a time
    JIT_BLOCK = 1 << 15

    def __init__(self, spec: ExperimentSpec,
                 inventory: Optional[ClusterInventory] = None,
                 arch: Optional[Architecture] = None,
                 stack_seeds: Optional[list[int]] = None,
                 device: "torch.device | str" = "cuda") -> None:
        super().__init__(spec, inventory, arch, stack_seeds)
        self.device = resolve_device(device)
        L = self._lanes
        self.rejected = np.zeros(L, dtype=np.int64)
        self.blocked = np.zeros(L, dtype=np.int64)
        self.resources = {k: _VecResource(s, L, self.device)
                          for k, s in self.arch.resources.items()}
        #: device-to-host reads of this run
        self.host_reads = 0
        self._path_cache: dict = {}
        self._align_cache: dict = {}
        self._combo_cache: dict = {}
        self._channels: dict = {}
        self._queues: dict = {}
        self._chan_queue: dict = {}
        self._heap: list = []
        self._seq = itertools.count()
        # channel store: delivery tag j of channel c (consumers 0..nC-1,
        # then the producers' reply channels or the gather channel) at
        # [:, c, j]; NaN until seen / acked
        self._nch = spec.n_consumers + spec.n_producers
        self._cap = 64
        self._seen = torch.full((L, self._nch, self._cap), np.nan,
                                dtype=F64, device=self.device)
        self._ack = torch.full_like(self._seen, np.nan)
        self._seen0 = np.full((self._nch, self._cap), np.nan)
        self._ack0 = np.full((self._nch, self._cap), np.nan)
        self._jbuf = Times(torch.empty((L, 0), dtype=F64,
                                       device=self.device), np.zeros(0))
        self._joff = 0
        # chaos: boundaries are sentinel heap entries, outages static
        # admission windows, redeliveries front pending segments
        self._chaos = self.p.chaos
        self._redelivered = 0
        self._dup_times: list = []
        self._dup_mem: list = []
        self._as_extra: list = []
        self._as_next = 0
        if self._chaos is not None:
            self._chaos_check()

    def _chaos_check(self) -> None:
        """Validate the chaos schedule against this cell (the reference's
        construction-time checks)."""
        spec = self.spec
        if spec.pattern != "work_sharing":
            raise ValueError("chaos schedules support pattern="
                             f"'work_sharing' only, got {spec.pattern!r}")
        if self._lanes > 1:
            raise ValueError("chaos cells do not stack; run them solo")
        for inj in self._chaos.injections:
            if inj.kind == "link":
                if not any(k == inj.target
                           or k.startswith(inj.target + ":")
                           for k in self.resources):
                    raise ValueError(
                        f"link injection target {inj.target!r} matches no "
                        f"resource of architecture {self.arch.name!r}")
            elif inj.kind == "consumer":
                if spec.tenants > 1:
                    raise ValueError(
                        "consumer injections require tenants=1")
                tgt = inj.target
                if not (tgt.startswith("c") and tgt[1:].isdigit()
                        and int(tgt[1:]) < spec.n_consumers):
                    raise ValueError(
                        f"consumer injection target {tgt!r} must name a "
                        f"configured consumer (c0..c{spec.n_consumers - 1})")
        if self._chaos.autoscale is not None and spec.tenants > 1:
            raise ValueError("autoscale policies require tenants=1")

    def _chaos_flow_possible(self) -> bool:
        """Broker outages reject publishes, a flow event the static
        :meth:`flow_events_possible` probe cannot see: they force
        per-message publish rounds too."""
        return (self._chaos is not None
                and any(i.kind == "broker" for i in self._chaos.injections))

    # -- host <-> device -------------------------------------------------------
    def _up(self, x: np.ndarray) -> torch.Tensor:
        """A host array on the device (a copy)."""
        t = torch.from_numpy(np.array(x))
        return t if self.device.type == "cpu" else t.to(self.device,
                                                        non_blocking=True)

    def _read(self, x: torch.Tensor) -> np.ndarray:
        """A device tensor on the host: one counted read."""
        self.host_reads += 1
        return x.to("cpu", copy=True).numpy()

    def _cols(self, d: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
        """Members ``idx`` of a ``(lanes, n)`` tensor."""
        s = _run(idx)
        return d[:, s] if s is not None else d.index_select(1, self._up(idx))

    def _take(self, t: Times, idx: np.ndarray) -> Times:
        if idx.size == t.n and _run(idx) is not None:
            return t
        return Times(self._cols(t.d, idx), t.h[idx])

    def _put(self, dst: torch.Tensor, idx: np.ndarray,
             src: torch.Tensor) -> None:
        """``dst[:, idx] = src`` in place (``dst`` is a store)."""
        s = _run(idx)
        if s is not None:
            dst[:, s] = src
        else:
            dst.index_copy_(1, self._up(idx), src)

    # -- helpers ---------------------------------------------------------------
    def _hold(self, n: int, base: np.ndarray | float) -> Times:
        """Service holds ``base * (1 + jitter)`` for the next ``n``
        service times.  Each lane draws its jitter from its own generator
        in the (shared) event order, as the reference's ``_jit`` does, so
        the pilot's stream is a solo run's; the draws are fetched
        :data:`JIT_BLOCK` at a time (a generator's stream does not depend
        on how it is cut) and moved to the device once."""
        if self._joff + n > self._jbuf.h.size:
            j, B = self.p.jitter, max(self.JIT_BLOCK, n)
            new = 1.0 + (np.stack([g.uniform(-j, j, B) for g in self._rngs])
                         if j else np.zeros((self._lanes, B)))
            o = self._joff
            self._jbuf = Times(torch.cat([self._jbuf.d[:, o:],
                                          self._up(new)], 1),
                               np.concatenate([self._jbuf.h[o:], new[0]]))
            self._joff = 0
        a, self._joff = self._joff, self._joff + n
        base_d = self._up(base) if isinstance(base, np.ndarray) else base
        return Times(self._jbuf.d[:, a:a + n] * base_d,
                     self._jbuf.h[a:a + n] * base)

    def _chan(self, cid: int) -> dict:
        """Broker-channel state: the ack-multiple coverage cursor and the
        consumer's serial-processing carry (per lane on the device, lane
        0 on the host); its seen and ack clocks live in the channel
        store."""
        ch = self._channels.get(cid)
        if ch is None:
            if cid >= self._nch:
                self._chan_rows(cid + 1)
            ch = {"assigned": 0, "acked": 0, "since": 0, "last_tag": 0,
                  "free": torch.zeros((self._lanes, 1), dtype=F64,
                                      device=self.device), "free0": 0.0}
            self._channels[cid] = ch
        return ch

    def _chan_grow(self, ch: dict, extra: int) -> None:
        """Amortized growth of the channel store's tag axis."""
        need = ch["assigned"] + extra
        if need <= self._cap:
            return
        cap = max(need, 2 * self._cap)
        pad = cap - self._cap
        self._seen = torch.nn.functional.pad(self._seen, (0, pad),
                                             value=float("nan"))
        self._ack = torch.nn.functional.pad(self._ack, (0, pad),
                                            value=float("nan"))
        self._seen0 = np.pad(self._seen0, ((0, 0), (0, pad)),
                             constant_values=np.nan)
        self._ack0 = np.pad(self._ack0, ((0, 0), (0, pad)),
                            constant_values=np.nan)
        self._cap = cap

    def _chan_rows(self, n: int) -> None:
        """Grow the channel store's channel axis to ``n`` rows: autoscaled
        consumers take fresh ids past the configured fleet (chaos runs
        work sharing only, so the producers' reply rows are free)."""
        pad = n - self._nch
        self._seen = torch.nn.functional.pad(self._seen, (0, 0, 0, pad),
                                             value=float("nan"))
        self._ack = torch.nn.functional.pad(self._ack, (0, 0, 0, pad),
                                            value=float("nan"))
        self._seen0 = np.pad(self._seen0, ((0, pad), (0, 0)),
                             constant_values=np.nan)
        self._ack0 = np.pad(self._ack0, ((0, pad), (0, 0)),
                            constant_values=np.nan)
        self._nch = n

    def _flat(self, store: torch.Tensor) -> torch.Tensor:
        return store.view(self._lanes, -1)

    def _resolve_paths(self, flow: str, combos: np.ndarray) -> tuple:
        """Per-combo aligned paths + member indices for one cohort leg
        (memoized on ``(flow, combos)``)."""
        ckey = (flow, combos.shape[0], combos.tobytes())
        hit = self._combo_cache.get(ckey)
        if hit is not None:
            return hit
        ctor = getattr(self.arch, flow)
        uniq, inv = np.unique(combos, axis=0, return_inverse=True)
        inv = inv.ravel()
        raw = {}
        for u, key in enumerate(map(tuple, uniq)):
            ck = (flow, key)
            if ck not in self._path_cache:
                self._path_cache[ck] = ctor(*key)
            raw[u] = self._path_cache[ck]
        ak = (flow, tuple(map(tuple, uniq)))
        if ak not in self._align_cache:
            self._align_cache[ak] = _align_paths(raw)
        aligned, n_slots = self._align_cache[ak]
        idx_by = {u: np.nonzero(inv == u)[0] for u in aligned}
        if len(self._combo_cache) >= self.COMBO_CACHE_MAX:
            self._combo_cache.clear()
        self._combo_cache[ckey] = (aligned, idx_by, n_slots)
        return aligned, idx_by, n_slots

    # -- queue state and departs -----------------------------------------------
    def _queue_state(self, qkey: tuple, consumers: Iterable[int], size: int,
                     *, credit: Optional[int] = None,
                     cap_msgs: Optional[int] = None,
                     volume: int = 0, track: bool = False) -> dict:
        """Get/create one broker queue's batched state.

        A queue tracks its backlog (each lane's ``n_enq`` enqueues less
        its popped releases) only when its ``volume``, the messages it
        will ever take, exceeds its credit threshold or byte cap (a
        backlog below both never leaves the reference's admission fast
        path, so nothing reads its departs), or when ``track`` asks (a
        chaos run's paused or autoscaled queues).  A tracked queue keeps
        the masked depart store on the device, lane 0's cursor on the host
        (``c0``), the other lanes' cursors while a host walk holds them
        (``sess``), and per lane the backlog's high-water mark ``hwm``
        and the optimistic admissions ``forced``; ``deferred`` holds the
        resolvers of withheld confirms."""
        q = self._queues.get(qkey)
        if q is None:
            L = self._lanes
            limits = [x for x in (credit, cap_msgs) if x is not None]
            q = {"consumers": [int(c) for c in consumers], "pending": [],
                 "size": size, "credit": credit, "cap": cap_msgs,
                 "track": bool(limits) and (track
                                            or volume > min(limits)),
                 "n_enq": np.zeros(L, dtype=np.int64), "released": 0,
                 "hwm": np.zeros(L, dtype=np.int64),
                 "forced": np.zeros(L, dtype=np.int64), "deferred": []}
            if q["track"]:
                dev = self.device
                q["limit"] = min(limits)
                q["dep"] = torch.full((L, 64), np.inf, dtype=F64, device=dev)
                q["used"] = torch.ones((L, 64), dtype=torch.bool, device=dev)
                q["dep_n"] = 0
                q["departed"] = torch.zeros(L, dtype=torch.int64, device=dev)
                q["last_pop_t"] = torch.zeros(L, dtype=F64, device=dev)
                q["c0"] = _Cursor([], 0, 0.0)
                q["sess"] = None
            self._queues[qkey] = q
            for c in q["consumers"]:
                self._chan_queue[c] = qkey
        return q

    def _pop_lane(self, q: dict, t: torch.Tensor) -> None:
        """Advance every lane's depart cursor to that lane's clock
        ``t[lane]``: count the recorded, unconsumed releases at or
        before it (the reference's lazy heap pops, as one masked
        reduction)."""
        n = q["dep_n"]
        if n == 0:
            return
        d, used = q["dep"][:, :n], q["used"][:, :n]
        ready = ~used & (d <= t[:, None])
        q["departed"] += ready.sum(1)
        q["last_pop_t"] = torch.where(
            ready.any(1), torch.where(ready, d, -torch.inf).amax(1),
            q["last_pop_t"])
        used |= ready

    def _pop_to_target(self, q: dict, target: torch.Tensor) -> None:
        """Advance each lane's depart cursor until ``target[lane]``
        releases have been popped, earliest first (best effort: it stops
        when no recorded drain remains)."""
        n = q["dep_n"]
        if n == 0:
            return
        d, used = q["dep"][:, :n], q["used"][:, :n]
        srt, order = torch.sort(torch.where(used, torch.inf, d), dim=1,
                                stable=True)
        npop = torch.minimum((target - q["departed"]).clamp(min=0),
                             (~used).sum(1))
        sel = (torch.arange(n, device=d.device)[None, :] < npop[:, None])
        used |= torch.zeros_like(used).scatter_(1, order, sel)
        q["departed"] += npop
        q["last_pop_t"] = torch.where(
            npop > 0, torch.where(sel, srt, -torch.inf).amax(1),
            q["last_pop_t"])

    def _load(self, qs: list, extra: tuple = ()) -> list:
        """Host cursors of every non-pilot lane of the tracked queues
        ``qs``, from their stores sorted on the device, read together
        with the tensors ``extra`` in one counted read; returns
        ``extra`` on the host."""
        L1 = self._lanes - 1
        parts = []
        for q in qs:
            n = q["dep_n"]
            srt = torch.sort(torch.where(q["used"][1:, :n], torch.inf,
                                         q["dep"][1:, :n]), dim=1).values
            parts += [srt.reshape(-1), q["departed"][1:].to(F64),
                      q["last_pop_t"][1:]]
        flat = self._read(torch.cat(parts + [x.reshape(-1) for x in extra]))
        off = 0
        for q in qs:
            n = q["dep_n"]
            srt = flat[off:off + L1 * n].reshape(L1, n)
            dep = flat[off + L1 * n:off + L1 * (n + 1)].astype(np.int64)
            last = flat[off + L1 * (n + 1):off + L1 * (n + 2)]
            off += L1 * (n + 2)
            # a sorted list is a min-heap
            q["sess"] = {lane: _Cursor(srt[lane - 1, :n - dep[lane - 1]]
                                       .tolist(), int(dep[lane - 1]),
                                       float(last[lane - 1]))
                         for lane in range(1, L1 + 1)}
        out = []
        for x in extra:
            out.append(flat[off:off + x.numel()].reshape(tuple(x.shape)))
            off += x.numel()
        return out

    def _cursor(self, q: dict, lane: int) -> _Cursor:
        """Lane ``lane``'s host cursor of tracked queue ``q`` (lane 0's
        is always held; the others are read on first use)."""
        if lane == 0:
            return q["c0"]
        if q["sess"] is None:
            self._load([q])
        return q["sess"][lane]

    def _flush(self, q: dict) -> None:
        """Before the device store of ``q`` changes: write the host
        cursors' pops back to it (the same count of earliest departs in
        each lane) and drop the non-pilot cursors, which the change
        outdates."""
        curs = [(0, q["c0"])] + list((q["sess"] or {}).items())
        dirty = [(lane, c) for lane, c in curs if c.departed > c.synced]
        if dirty:
            target = np.zeros(self._lanes, dtype=np.int64)
            for lane, c in dirty:
                target[lane] = c.synced = c.departed
            self._pop_to_target(q, self._up(target))
        q["sess"] = None

    def _record_departs(self, q: dict, depart: Times) -> None:
        """Register released deliveries' depart times in a tracked
        queue's store, and resolve any withheld confirms the new drains
        now admit."""
        if not q["track"]:
            return
        self._flush(q)
        n0, m = q["dep_n"], depart.n
        if n0 + m > q["dep"].shape[1]:
            pad = max(n0 + m, 2 * q["dep"].shape[1]) - q["dep"].shape[1]
            q["dep"] = torch.nn.functional.pad(q["dep"], (0, pad),
                                               value=float("inf"))
            q["used"] = torch.nn.functional.pad(q["used"], (0, pad),
                                                value=True)
        q["dep"][:, n0:n0 + m] = depart.d
        q["used"][:, n0:n0 + m] = False
        q["dep_n"] = n0 + m
        h = q["c0"].heap
        for d in depart.h.tolist():
            heapq.heappush(h, d)
        q["released"] += m
        if q["deferred"]:
            self._try_resume(q)

    def _lane_resume_time(self, q: dict, lane: int) -> float:
        """One lane's ``flow_resume`` clock: pop that lane's departs
        until it has drained to half the credit threshold (best effort:
        with no further known drains the last release stands) and return
        the crossing depart time + control latency."""
        c = self._cursor(q, lane)
        c.pop_to(int(q["n_enq"][lane]) - q["credit"] // 2)
        return c.last + self.arch.control_latency_s()

    def _try_resume(self, q: dict, force: bool = False) -> bool:
        """Release the queue's withheld confirms once lane 0 has drained
        to half the credit threshold (the heap broker's ``flow_resume``),
        at the depart time that crossed the mark + control latency; each
        resolver computes the other blocked lanes' resume clocks from
        their own departs (:meth:`_lane_resume_time`) when it fires."""
        if not q["deferred"]:
            return False
        target = int(q["n_enq"][0]) - q["credit"] // 2
        if q["released"] < target and not force:
            return False
        c0 = q["c0"]
        c0.pop_to(target)
        t_resume = c0.last + self.arch.control_latency_s()
        resolvers, q["deferred"] = q["deferred"], []
        for fn in resolvers:
            fn(t_resume)
        return True

    def _force_resume(self) -> bool:
        """Last-resort deadlock breaker for the drained-out tail: resolve
        any still-withheld confirms at the release clock."""
        any_resolved = False
        for q in self._queues.values():
            if q["deferred"] and self._try_resume(q, force=True):
                any_resolved = True
        return any_resolved

    def _lane_admit(self, tracked: list, lane: int, t_rej: float
                    ) -> tuple[float, int, Optional[dict]]:
        """Resolve one non-pilot lane's reject-retry loop locally: the
        lane's producer re-publishes every ``publish_retry_s`` until the
        lane's own backlog admits the message (against the drains the
        lane has already computed); the re-publish transits are not
        re-served (the member's schedule is the pilot's).  Called after
        the lane's attempt at ``t_rej`` was rejected and counted.
        Returns ``(t_admit, extra_rejects, blocked_on)``; with no further
        known drain the next attempt is admitted optimistically, counted
        in ``forced``."""
        retry = self.p.publish_retry_s
        t = t_rej + retry
        extra = 0
        while True:
            full_q = outage_end = None
            for q in tracked:
                outage_end = self._outage_end(q, t)
                if outage_end is not None:
                    # a paused queue rejects every retry until the outage
                    # ends: jump the cadence straight past it
                    full_q = q
                    break
                c = self._cursor(q, lane)
                c.pop(t)
                if (q["cap"] is not None
                        and q["n_enq"][lane] - c.departed >= q["cap"]):
                    full_q = q
                    break
            if full_q is None:
                break
            nd = (outage_end if outage_end is not None
                  else self._cursor(full_q, lane).next_drain())
            if nd is None:
                extra += 1
                t += retry
                for q in tracked:
                    q["forced"][lane] += 1
                break
            # every retry until the next known drain fails too: jump the
            # retry cadence straight past it
            k = max(1, int(np.ceil((nd - t) / retry)))
            extra += k
            t += k * retry
        for q in tracked:
            q["n_enq"][lane] += 1
            q["hwm"][lane] = max(q["hwm"][lane], q["n_enq"][lane]
                                 - self._cursor(q, lane).departed)
        for q in tracked:
            if (q["credit"] is not None and q["n_enq"][lane]
                    - self._cursor(q, lane).departed > q["credit"]):
                return t, extra, q
        return t, extra, None

    def _enqueue_batch(self, qs: list, t: Times,
                       skip: Optional[np.ndarray] = None
                       ) -> tuple[np.ndarray, Optional[np.ndarray],
                                  Optional[np.ndarray]]:
        """Admit a publish cohort onto one queue (or atomically onto all
        fanout targets), independently per lane.  ``skip[k, l]`` marks
        members an earlier attempt already admitted in lane ``l``.
        Returns ``(accepted, blocked_on, t_host)``: ``accepted[k, l]``,
        admitted in lane ``l`` by this attempt; ``blocked_on``, None when
        no lane crossed a credit threshold, else an ``(n, lanes)`` object
        array naming the queue whose threshold the member crossed there;
        ``t_host``, the clocks the host read, ``(n, lanes)`` with NaN in
        the lanes it did not (None when no queue is tracked).

        Each lane runs the reference's solo admission on its own clocks
        and depart cursor: the fast path when even a zero-drain bound on
        every target's backlog stays within its limits at the lane's
        earliest arrival (checked for every lane on the device, a
        target popped only while the earlier ones passed, as the
        reference's loop breaks), else the arrival-order walk
        (:meth:`_admit_walk`), on the host over one counted read of the
        failing lanes' clocks and sorted departs."""
        L, n = self._lanes, t.n
        att = (np.ones((n, L), dtype=bool) if skip is None else ~skip)
        tracked = [q for q in qs if q["track"]]
        if not tracked:
            return att, None, None
        n_att = att.sum(0)
        live = n_att > 0
        for q in tracked:
            self._flush(q)
        if skip is None:
            t_min = t.d.amin(1)
        else:
            t_min = torch.where(self._up(att.T), t.d, torch.inf).amin(1)
        alive = None if live.all() else self._up(live)
        t0 = float(t.h[att[:, 0]].min()) if live[0] else None
        # a chaos outage (solo cells only, so lane 0 alone) over the
        # span of the arrivals fails the fast path like a full queue
        down = [live[0] and self._outages_overlap(
            q, t0, float(t.h[att[:, 0]].max())) for q in tracked]
        for i, q in enumerate(tracked):
            self._pop_lane(q, t_min if alive is None
                           else torch.where(alive, t_min, -torch.inf))
            c0 = q["c0"]
            if t0 is not None:
                c0.pop(t0)
                c0.synced = c0.departed
                if (q["n_enq"][0] + n_att[0] - c0.departed > q["limit"]
                        or down[i]):
                    t0 = None
            if i + 1 < len(tracked):
                ok = (self._up(q["n_enq"] + n_att) - q["departed"]
                      <= q["limit"]) & (not down[i])
                alive = ok if alive is None else alive & ok
        if L > 1:
            dep = self._read(torch.stack([q["departed"] for q in tracked]))
        else:
            dep = np.array([[q["c0"].departed] for q in tracked])
        nq = np.stack([q["n_enq"] for q in tracked])
        lim = np.array([q["limit"] for q in tracked])[:, None]
        fast = live & ~(nq + n_att - dep > lim).any(0)
        fast[0] &= not any(down)
        for q, d in zip(tracked, dep):
            q["n_enq"][fast] += n_att[fast]
            q["hwm"][fast] = np.maximum(q["hwm"][fast],
                                        q["n_enq"][fast] - d[fast])
        accept = att & fast
        blocked_on = None
        th = np.full((n, L), np.nan)
        th[:, 0] = t.h
        slow = np.nonzero(live & ~fast)[0]
        others = slow[slow > 0]
        if others.size:
            (tl,) = self._load(tracked, (t.d.index_select(
                0, self._up(others)),))
            th[:, others] = tl.T
        for lane in slow:
            ks = np.nonzero(att[:, lane])[0]
            ks = ks[np.argsort(th[ks, lane], kind="stable")]
            admitted, blocked = self._admit_walk(tracked, lane, ks, th)
            accept[admitted, lane] = True
            for k, q in blocked:
                if blocked_on is None:
                    blocked_on = np.full((n, L), None, dtype=object)
                blocked_on[k, lane] = q
        return accept, blocked_on, th

    def _admit_walk(self, tracked: list, lane: int, ks: np.ndarray,
                    th: np.ndarray) -> tuple[np.ndarray, list]:
        """One lane's arrival-order admission walk on the host (the heap
        engine's ``offer()``/``flow_blocked`` sequence): members ``ks``,
        sorted by this lane's clocks ``th[:, lane]``, are admitted
        unless a target's backlog sits at its byte cap at the member's
        arrival; each admission bumps every target's enqueue count and
        high-water mark, and the first credit threshold it crosses is
        recorded.  Returns ``(admitted_members, [(member, queue),
        ...])``."""
        curs = [self._cursor(q, lane) for q in tracked]
        admitted, blocked = [], []
        for k in ks.tolist():
            t = th[k, lane]
            full = False
            for q, c in zip(tracked, curs):
                # a paused queue rejects publishes like a full one
                if self._outage_end(q, t) is not None:
                    full = True
                    break
                c.pop(t)
                if (q["cap"] is not None
                        and q["n_enq"][lane] - c.departed >= q["cap"]):
                    full = True
                    break
            if full:
                continue
            admitted.append(k)
            for q, c in zip(tracked, curs):
                q["n_enq"][lane] += 1
                q["hwm"][lane] = max(q["hwm"][lane],
                                     q["n_enq"][lane] - c.departed)
            for q, c in zip(tracked, curs):
                if (q["credit"] is not None
                        and q["n_enq"][lane] - c.departed > q["credit"]):
                    blocked.append((k, q))
                    break
        return np.asarray(admitted, dtype=np.int64), blocked

    # -- batch event loop ------------------------------------------------------
    def _push_transit(self, t: Times, size: int, flow: str,
                      combos: np.ndarray,
                      on_part: Callable[[np.ndarray, Times], None]) -> None:
        """Queue a cohort to traverse ``flow``'s hop graph, one hop per
        event pop, interleaved with every other in-flight cohort;
        ``on_part(member_indices, times)`` fires per finishing
        sub-batch, in event order."""
        aligned, idx_by, n_slots = self._resolve_paths(flow, combos)
        n = t.n
        inv = np.empty(n, dtype=int)
        for u, idx in idx_by.items():
            inv[idx] = u
        cohort = {"on_part": on_part, "aligned": aligned, "size": size}
        self._push({"t": t, "members": np.arange(n), "inv": inv,
                    "slot": 0, "n_slots": n_slots, "cohort": cohort})

    def _push(self, batch: dict) -> None:
        heapq.heappush(self._heap, (float(batch["t"].h.min()),
                                    next(self._seq), batch))

    def _split_horizon(self, batch: dict) -> dict:
        """Split off the members past the event horizon (next event's key
        + slack) back into the heap; returns the head sub-batch."""
        t = batch["t"]
        if self._heap and t.n > 1:     # a lone member is always the head
            head = t.h <= self._heap[0][0] + self._slack
            if not head.all():
                if not head.any():
                    head[np.argmin(t.h)] = True
                parts = []
                for sel in (np.nonzero(~head)[0], np.nonzero(head)[0]):
                    parts.append({"t": self._take(t, sel),
                                  "members": batch["members"][sel],
                                  "inv": batch["inv"][sel],
                                  "slot": batch["slot"],
                                  "n_slots": batch["n_slots"],
                                  "cohort": batch["cohort"]})
                self._push(parts[0])
                batch = parts[1]
        return batch

    def _serve_slot(self, batch: dict) -> None:
        """Serve one hop for the head of one cohort batch: latency-only
        elements shift their members, and members at the same hop on the
        same resource instance (across path variants) are served as one
        FIFO part, with the jitter drawn per part in part order."""
        batch = self._split_horizon(batch)
        cohort = batch["cohort"]
        t = batch["t"]
        s = batch["slot"]
        aligned = cohort["aligned"]
        size = cohort["size"]
        n = t.n
        inv = batch["inv"]
        if len(aligned) == 1:
            groups = [(0, None)]          # None: every member
        else:
            order = np.argsort(inv, kind="stable")
            uniq, starts = np.unique(inv[order], return_index=True)
            bounds = np.append(starts, inv.size)
            groups = [(u, order[bounds[i]:bounds[i + 1]])
                      for i, u in enumerate(uniq)]
        by_instance: dict[str, list] = {}
        shift = None
        for u, idx in groups:
            el = aligned[u][s]
            if el is None:
                continue
            if el.resource is None:
                if idx is None:
                    shift = el.latency_s
                else:
                    if shift is None:
                        shift = np.zeros(n)
                    shift[idx] = el.latency_s
                continue
            by_instance.setdefault(el.resource, []).append((idx, el))
        if shift is not None:
            t = Times(t.d + (self._up(shift) if isinstance(shift, np.ndarray)
                             else shift), t.h + shift)
        parts = []
        for key, ps in by_instance.items():
            if len(ps) == 1:
                idx, el = ps[0]
                nbytes = size * el.byte_factor + el.extra_bytes
                lat = el.latency_s
            else:
                idx = np.concatenate([p[0] for p in ps])
                nbytes = np.concatenate([
                    np.full(p[0].size, size * p[1].byte_factor
                            + p[1].extra_bytes) for p in ps])
                lat = np.concatenate([
                    np.full(p[0].size, p[1].latency_s) for p in ps])
            m = n if idx is None else idx.size
            ht = self.resources[key].hold_times(nbytes)
            parts.append((key, idx, lat, self._hold(m, ht)))
        if parts:
            ends = []
            for key, idx, lat, hold in parts:
                sub = t if idx is None else self._take(t, idx)
                ends.append(self.resources[key].serve(sub, hold, self._up))
                self.n_events += sub.n
            # lane 0 of every scan the host cannot repeat, in one read
            scanned = [i for i, (_, e0) in enumerate(ends) if e0 is None]
            if scanned:
                e0 = self._read(torch.cat([ends[i][0][0] for i in scanned]))
                off = 0
                for i in scanned:
                    m = ends[i][0].shape[1]
                    ends[i] = (ends[i][0], e0[off:off + m])
                    off += m
                    self.resources[parts[i][0]].settle(ends[i][1])
            new_d, new_h = None, None
            for (key, idx, lat, _), (end, e0p) in zip(parts, ends):
                m = end.shape[1]
                if isinstance(lat, np.ndarray):
                    end = end + self._up(lat)
                elif lat:
                    end = end + lat     # (x + 0.0 is x: no pass for it)
                if idx is None or (m == n and _run(idx) is not None):
                    new_d, new_h = end, e0p + lat
                    continue
                if new_d is None:
                    new_d, new_h = t.d.clone(), t.h.copy()
                self._put(new_d, idx, end)
                new_h[idx] = e0p + lat
            t = Times(new_d, new_h)
        batch["t"] = t
        self._finish_slot(batch)

    def _finish_slot(self, batch: dict) -> None:
        """Advance a served batch: requeue the next hop, or hand the
        finished members to the cohort's ``on_part``."""
        batch["slot"] += 1
        if batch["slot"] < batch["n_slots"]:
            self._push(batch)
        else:
            batch["cohort"]["on_part"](batch["members"], batch["t"])

    def _pop_batch(self) -> Optional[dict]:
        """Pop the next cohort batch, honoring the safety caps; None when
        drained (or capped out)."""
        if not self._heap:
            return None
        key, _, batch = heapq.heappop(self._heap)
        if (self.n_events > self.p.max_events
                or key > self.p.max_sim_time):
            self._heap.clear()
            return None
        return batch

    def _drain(self) -> None:
        while True:
            batch = self._pop_batch()
            if batch is None:
                break
            fn = batch.get("chaos_fn")
            if fn is not None:
                # an epoch boundary: change the topology between batches
                fn(batch["t_evt"])
                continue
            self._serve_slot(batch)

    def _tail_step(self) -> bool:
        """One end-of-drain recovery step, called with the heap empty:
        force-flush unflushed batch acks that hold back window-waiting
        deliveries (the heap engine's expected-consumed flush), then
        force-resume withheld confirms.  True when new events
        appeared."""
        ctrl = self.arch.control_latency_s()
        flushed = []
        for c, ch in self._channels.items():
            a, b = ch["acked"], ch["last_tag"]
            if b > a:
                if not np.isfinite(self._seen0[c, a:b]).all():
                    continue
                self._ack[:, c, a:b] = self._seen[:, c, a:b] + ctrl
                self._ack0[c, a:b] = self._seen0[c, a:b] + ctrl
                ch["acked"] = b
                ch["since"] = 0
                if c in self._chan_queue:
                    flushed.append(self._chan_queue[c])
        if flushed:
            self._pump_queues(flushed)
            if self._heap:
                return True
        return self._force_resume() and bool(self._heap)

    def _drain_all(self) -> None:
        """Drain the event heap, then force-flush held-back batch acks
        (and force-resume withheld confirms) and keep draining until
        nothing is left."""
        while True:
            self._drain()
            if not self._tail_step():
                return

    # -- chaos runtime (epoch boundaries, outage admission, redelivery) --------
    def _push_chaos(self, t: float, fn: Callable[[float], None]) -> None:
        """Schedule one epoch boundary as a sentinel heap entry."""
        heapq.heappush(self._heap, (float(t), next(self._seq),
                                    {"chaos_fn": fn, "t_evt": float(t)}))

    def _chaos_down_queues(self, nq: int, q_home: np.ndarray) -> list:
        """Each broker injection with the work queues it pauses:
        ``[(injection, queue indices), ...]``."""
        spec = self.spec
        T = spec.tenants if (spec.tenants > 1
                             and spec.tenant_isolation == "vhost") else 1
        return [(inj, self._chaos_queue_indices(inj.target, nq, nq // T,
                                                q_home, self.inv.n_dsn))
                for inj in self._chaos.injections if inj.kind == "broker"]

    def _chaos_setup(self, nq: int, down: list) -> None:
        """Attach the broker injections' outages ``down`` (from
        :meth:`_chaos_down_queues`) to their queues, and schedule every
        epoch boundary (called from ``_setup_work``)."""
        sched = self._chaos
        broker = iter(down)
        for inj in sched.injections:
            if inj.kind == "link":
                keys = [k for k in self.resources
                        if k == inj.target or k.startswith(inj.target + ":")]
                self._push_chaos(inj.t0,
                                 lambda t, ks=keys, t1=inj.t1:
                                 self._chaos_link_down(ks, t1))
            elif inj.kind == "broker":
                _, qis = next(broker)
                for qi in qis:
                    q = self._queues[("work", qi)]
                    q.setdefault("outages", []).append((inj.t0, inj.t1))
                    q.setdefault("log", [])
                self._push_chaos(inj.t0,
                                 lambda t, qs=tuple(qis), t1=inj.t1:
                                 self._chaos_queues_down(qs, t, t1))
                self._push_chaos(inj.t1,
                                 lambda t, qs=tuple(qis):
                                 self._pump_queues([("work", qi)
                                                    for qi in qs]))
            else:                       # consumer
                cidx = int(inj.target[1:])
                self._queues[("work", cidx % nq)].setdefault("log", [])
                self._push_chaos(inj.t0,
                                 lambda t, c=cidx:
                                 self._chaos_consumer_down(c, t))
                self._push_chaos(inj.t1,
                                 lambda t, c=cidx:
                                 self._chaos_consumer_up(c))
        if sched.autoscale is not None:
            self._as_next = self.spec.n_consumers
            self._chaos_work_qkeys = [("work", qi) for qi in range(nq)]
            self._push_chaos(sched.autoscale.interval_s,
                             self._chaos_autoscale_tick)

    @staticmethod
    def _chaos_queue_indices(target: str, nq: int, nq_t: int,
                             q_home: np.ndarray, n_dsn: int) -> list[int]:
        """Map a broker-injection target to work-queue indices, in the
        heap broker's declare order and grammar: ``queue:<name>`` (name
        as the heap broker declares it, e.g. ``work:0`` or
        ``t1/work:0``), ``node:<k>`` (queues homed on DSN node ``k``) or
        ``vhost:t<t>`` (a tenant's queue block)."""
        kind, _, val = target.partition(":")
        if kind == "queue":
            try:
                if "/" in val:
                    vh, base = val.split("/", 1)
                    qis = [int(vh[1:]) * nq_t
                           + int(base.rsplit(":", 1)[1])]
                else:
                    qis = [int(val.rsplit(":", 1)[1])]
            except (IndexError, ValueError):
                raise ValueError(f"unknown queue in broker injection "
                                 f"target {target!r}") from None
            if not all(0 <= qi < nq for qi in qis):
                raise ValueError(f"unknown queue in broker injection "
                                 f"target {target!r}")
        elif kind == "node":
            node = int(val)
            if not 0 <= node < n_dsn:
                raise ValueError(
                    f"broker injection target {target!r} names no DSN "
                    f"node (cluster has {n_dsn})")
            # empty match allowed: a node homing no work queue is a
            # no-op fault (the redundancy the availability sweep probes)
            return [qi for qi in range(nq) if int(q_home[qi]) == node]
        elif kind == "vhost":
            t = int(val[1:])
            qis = list(range(t * nq_t, (t + 1) * nq_t))
        else:
            raise ValueError(f"broker injection target {target!r} must be "
                             "'queue:<name>', 'node:<k>' or 'vhost:<v>'")
        if not qis:
            raise ValueError(f"broker injection target {target!r} matches "
                             "no queue")
        return qis

    def _chaos_link_down(self, keys: list[str], t1: float) -> None:
        """A link outage at its t0 boundary: the matched resources start
        no new service until ``t1``."""
        for k in keys:
            self.resources[k].hold_until(t1)

    @staticmethod
    def _outage_end(q: dict, t: float) -> Optional[float]:
        """End of the outage window covering time ``t`` (None if up)."""
        for (o0, o1) in q.get("outages") or ():
            if o0 <= t < o1:
                return o1
        return None

    @staticmethod
    def _outages_overlap(q: dict, lo: float, hi: float) -> bool:
        """Any outage window intersecting arrival span ``[lo, hi]``."""
        return any(o0 <= hi and o1 > lo
                   for (o0, o1) in q.get("outages") or ())

    @staticmethod
    def _chaos_clamp(q: dict, depart: Times) -> Times:
        """A paused queue delivers nothing: departs landing inside an
        outage window slide to its end (the heap broker's unpause pump),
        on the device and on the host."""
        d, h = depart.d, depart.h
        for (o0, o1) in q["outages"]:
            d = d.masked_fill((d >= o0) & (d < o1), o1)
            h = np.where((h >= o0) & (h < o1), o1, h)
        return Times(d, h)

    @staticmethod
    def _chaos_log(q: dict, cohort: dict, m: np.ndarray, cons: np.ndarray,
                   j: np.ndarray, depart: Times) -> None:
        """Log released deliveries on a queue a boundary may requeue: the
        cohort, members, consumers, delivery tags, lane-0 departs and a
        requeued flag."""
        if "log" in q:
            q["log"].append((cohort, m.copy(), cons.copy(), j.copy(),
                             depart.h.copy(), np.zeros(m.size, dtype=bool)))

    def _chaos_queues_down(self, qis: tuple, t0: float, t1: float) -> None:
        """A broker/vhost outage at its t0 boundary: requeue the
        broker-unacked deliveries to the front of each paused queue,
        ready at ``t1``."""
        touched = [("work", qi) for qi in qis
                   if self._chaos_requeue(("work", qi), t0, t1)]
        if touched:
            self._pump_queues(touched)

    def _chaos_requeue(self, qkey: tuple, t_cut: float, t_ready: float,
                       cons_filter: Optional[int] = None) -> int:
        """Re-enter every delivery that departed by ``t_cut`` but was
        still unacked at the broker then (its ack, from the host's
        lane-0 ack clocks, after ``t_cut`` or not yet known) as a front
        pending segment ready at ``t_ready``: at-least-once redelivery,
        the original completion stands and the copy's is a duplicate.
        Returns the redelivery count."""
        q = self._queues[qkey]
        mem, cohort0 = [], None
        for cohort, m_sl, cons, j_all, dep, used in q.get("log") or ():
            sel = (dep <= t_cut) & ~used
            if cons_filter is not None:
                sel &= cons == cons_filter
            r = np.nonzero(sel)[0]
            if r.size == 0:
                continue
            # unacked: no ack yet (NaN) or one after the cut
            r = r[~(self._ack0[cons[r], j_all[r]] <= t_cut)]
            if r.size:
                used[r] = True
                mem.append(m_sl[r])
                cohort0 = cohort
        if not mem:
            return 0
        midx = np.concatenate(mem).astype(np.int64)
        n = midx.size
        q["pending"].insert(0, {
            "cohort": dict(cohort0, on_seen=self._chaos_dup_seen),
            "idx": midx, "pos": 0,
            "t": Times(torch.full((self._lanes, n), float(t_ready),
                                  dtype=F64, device=self.device),
                       np.full(n, float(t_ready)))})
        self._redelivered += n
        return n

    def _chaos_dup_seen(self, mem: np.ndarray, t_done: Times,
                        cons: np.ndarray) -> None:
        """``on_seen`` of redelivered copies: record duplicate completions
        without overwriting the original consume times."""
        self._dup_times.append(t_done.h.copy())
        self._dup_mem.append(np.asarray(mem, dtype=np.int64).copy())

    def _chaos_consumer_down(self, cidx: int, t_evt: float) -> None:
        """A consumer crash: leave the round-robin rotation and requeue
        the crashed channel's unacked deliveries, ready at once (the
        surviving consumers pick them up)."""
        qk = self._chan_queue.get(cidx)
        if qk is None:
            return
        q = self._queues[qk]
        if cidx in q["consumers"]:
            q["consumers"].remove(cidx)
        self._chaos_requeue(qk, t_evt, t_evt, cons_filter=cidx)
        self._pump_queues([qk])

    def _chaos_consumer_up(self, cidx: int) -> None:
        """A consumer respawn: rejoin the rotation and pump."""
        qk = self._chan_queue.get(cidx)
        if qk is None:
            return
        q = self._queues[qk]
        if cidx not in q["consumers"]:
            q["consumers"].append(cidx)
        self._pump_queues([qk])

    def _chaos_autoscale_tick(self, t_evt: float) -> None:
        """Backlog-reactive consumer elasticity: compare the work queues'
        undelivered backlog to the policy's thresholds, grow with fresh
        consumer ids (never reused) or retire the most recent extras,
        then re-schedule while the run still has events."""
        pol = self._chaos.autoscale
        # the ready backlog at the tick's clock, from lane 0's enqueue
        # count and depart cursor, which it leaves as they are:
        # enqueues less every release that departed by t_evt
        backlog = 0
        for qk in self._chaos_work_qkeys:
            q = self._queues[qk]
            c0 = q["c0"]
            left = c0.departed + sum(1 for d in c0.heap if d <= t_evt)
            backlog += int(q["n_enq"][0] - left)
        nq = len(self._chaos_work_qkeys)
        cur = self.spec.n_consumers + len(self._as_extra)
        pumped = []
        if backlog > pol.high_backlog and cur < pol.max_consumers:
            for _ in range(min(pol.step, pol.max_consumers - cur)):
                c = self._as_next
                self._as_next += 1
                self._as_extra.append(c)
                qk = ("work", c % nq)
                self._queues[qk]["consumers"].append(c)
                self._chan_queue[c] = qk
                pumped.append(qk)
        elif backlog < pol.low_backlog and self._as_extra:
            for _ in range(min(pol.step, len(self._as_extra))):
                c = self._as_extra.pop()
                q = self._queues[self._chan_queue[c]]
                if c in q["consumers"]:
                    q["consumers"].remove(c)
        if pumped:
            self._pump_queues(pumped)
        if self._heap:
            self._push_chaos(t_evt + pol.interval_s,
                             self._chaos_autoscale_tick)

    # -- prefetch-windowed delivery (the batched broker pump) ------------------
    def _deliver_queue(self, qkey: tuple, consumers: list, t_ready: Times,
                       member_idx: np.ndarray, combos_fn: Callable,
                       size: int, flow: str, consumer: bool, recv: float,
                       on_seen: Callable) -> None:
        """Enqueue a cohort on one broker queue and pump it through
        ``flow``.  ``combos_fn(member_idx, cons)`` builds the
        path-constructor arguments once consumers are known;
        ``on_seen(member_idx, seen, cons)`` fires per landed batch."""
        cohort = {"combos_fn": combos_fn, "size": size, "flow": flow,
                  "consumer": consumer, "recv": recv, "on_seen": on_seen}
        q = self._queue_state(qkey, consumers, size)
        o = np.argsort(t_ready.h, kind="stable")
        q["pending"].append({"cohort": cohort, "idx": member_idx[o],
                             "t": self._take(t_ready, o), "pos": 0})
        self._pump_queues([qkey])

    def _gates(self, cons: np.ndarray, tags: np.ndarray,
               t: Times) -> Times:
        """``max(t, gate)``, where a member's gate is the ack time of tag
        ``tags`` of channel ``cons`` (-inf where ``tags < 0``): the ack
        that freed the member's basic.qos window slot."""
        m = tags >= 0
        if not m.any():
            return t
        flat = cons * self._cap + np.maximum(tags, 0)
        g0 = np.where(m, self._ack0.ravel()[flat], -np.inf)
        g = self._flat(self._ack).index_select(1, self._up(flat))
        if not m.all():
            g = torch.where(self._up(m), g, -torch.inf)
        return Times(torch.maximum(t.d, g), np.maximum(t.h, g0))

    def _rr_assign(self, ids: list, t_sl: Times, P: int
                   ) -> tuple[np.ndarray, np.ndarray, Times]:
        """Strict round-robin split of one whole released segment across
        consumers with open windows (the pump fast path): message ``r``
        goes to ``ids[r % k]`` and its depart gates on the ack that
        freed its window slot.  Returns ``(consumer_ids, delivery_tags,
        departs)``."""
        n = t_sl.n
        k = len(ids)
        cons = np.array(ids)[np.arange(n) % k]
        j_all = np.empty(n, dtype=int)
        for r, c in enumerate(ids):
            pos = np.arange(r, n, k)
            ch = self._chan(c)
            self._chan_grow(ch, pos.size)
            j_all[pos] = ch["assigned"] + np.arange(pos.size)
            ch["assigned"] += pos.size
        return cons, j_all, self._gates(cons, j_all - P, t_sl)

    def _pump_queues(self, qkeys: Iterable[tuple]) -> None:
        """Release every window-admissible pending delivery on the given
        queues and push the released groups as transit batches."""
        P = max(1, self.p.prefetch)
        releases: dict[int, list] = {}
        for qk in dict.fromkeys(qkeys):
            q = self._queues[qk]
            ids = q["consumers"]
            while q["pending"]:
                if not ids:
                    # every consumer crashed off this queue (chaos): the
                    # backlog waits for a respawn or an autoscale pump
                    break
                seg = q["pending"][0]
                n_rem = seg["idx"].size - seg["pos"]
                k = len(ids)
                # fast path: every window stays open through a strict
                # round-robin split of the whole segment remainder
                if not self._fine_pump and \
                        all((P - (self._chan(c)["assigned"]
                                  - self._chan(c)["acked"]))
                            >= (n_rem - r + k - 1) // k
                            for r, c in enumerate(ids)):
                    lo = seg["pos"]
                    st = seg["t"]
                    t_sl = Times(st.d[:, lo:lo + n_rem], st.h[lo:lo + n_rem])
                    m_sl = seg["idx"][lo:lo + n_rem]
                    cons, j_all, depart = self._rr_assign(ids, t_sl, P)
                    if "outages" in q:
                        depart = self._chaos_clamp(q, depart)
                    q["consumers"] = ids = ids[n_rem % k:] + ids[:n_rem % k]
                    releases.setdefault(id(seg["cohort"]), []).append(
                        (seg["cohort"], m_sl, cons, j_all, depart))
                    self._record_departs(q, depart)
                    self._chaos_log(q, seg["cohort"], m_sl, cons, j_all,
                                    depart)
                    seg["pos"] += n_rem
                    q["pending"].pop(0)
                    continue
                # slow path: per message, the first consumer (rotated
                # round-robin) whose window is open at the message's ready
                # time takes it, else the earliest known re-opening;
                # released in small chunks so ack arrivals interleave
                rel, ids = self._assign_chunk(seg, ids, P)
                q["consumers"] = ids
                if rel is not None:
                    if "outages" in q:
                        rel = rel[:3] + (self._chaos_clamp(q, rel[3]),)
                    releases.setdefault(id(seg["cohort"]), []).append(
                        (seg["cohort"],) + rel)
                    self._record_departs(q, rel[3])
                    self._chaos_log(q, seg["cohort"], *rel)
                if seg["pos"] == seg["idx"].size:
                    q["pending"].pop(0)
                break
        for parts in releases.values():
            cohort = parts[0][0]
            if len(parts) == 1:
                _, idx, cons, j_all, depart = parts[0]
            else:
                idx = np.concatenate([p[1] for p in parts])
                cons = np.concatenate([p[2] for p in parts])
                j_all = np.concatenate([p[3] for p in parts])
                depart = Times(torch.cat([p[4].d for p in parts], 1),
                               np.concatenate([p[4].h for p in parts]))
            self._push_transit(
                depart, cohort["size"], cohort["flow"],
                cohort["combos_fn"](idx, cons),
                on_part=lambda members, t, cohort=cohort, idx=idx,
                cons=cons, j_all=j_all:
                    self._commit(cohort, idx[members], j_all[members],
                                 cons[members], t))

    def _assign_chunk(self, seg: dict, ids: list, P: int
                      ) -> tuple[Optional[tuple], list]:
        """One slow-path assignment chunk of up to ``ack_batch``
        messages: per message, the heap broker's ``next_delivery`` in
        virtual time, decided on the pilot's clocks.  Returns
        ``(released, rotated_ids)``; ``released`` is ``(member_idx,
        consumers, delivery_tags, departs)`` or None."""
        chunk = max(1, self.p.ack_batch)
        chans = [self._chan(c) for c in ids]
        take = min(chunk, seg["idx"].size - seg["pos"])
        for ch in chans:
            self._chan_grow(ch, take)
        ack0 = self._ack0
        # next-assignment window gate per consumer, on lane 0 (NaN = the
        # ack that would re-open it hasn't been computed yet), and the
        # tag it reads (-1: no gate)
        g = np.empty(len(ids))
        gtag = np.empty(len(ids), dtype=int)
        for x, (c, ch) in enumerate(zip(ids, chans)):
            j = ch["assigned"]
            gtag[x] = j - P if j >= P else -1
            g[x] = ack0[c, j - P] if j >= P else -np.inf
        order = np.arange(len(ids))     # rotated round-robin
        th = seg["t"].h
        p0 = seg["pos"]
        rel_c, rel_j, rel_g = [], [], []
        while seg["pos"] < seg["idx"].size and len(rel_c) < chunk:
            t = th[seg["pos"]]
            go = g[order]
            with np.errstate(invalid="ignore"):
                open_pos = np.nonzero(go <= t)[0]
            if open_pos.size:
                pos = int(open_pos[0])
            else:
                finite = np.isfinite(go)
                if not finite.any():
                    break   # re-openings unknown: wait for acks
                pos = int(np.argmin(np.where(finite, go, np.inf)))
            x = int(order[pos])
            order = np.append(np.delete(order, pos), x)
            ch = chans[x]
            j = ch["assigned"]
            ch["assigned"] += 1
            rel_c.append(ids[x])
            rel_j.append(j)
            rel_g.append(gtag[x])
            gtag[x] = j + 1 - P if j + 1 >= P else -1
            g[x] = ack0[ids[x], j + 1 - P] if j + 1 >= P else -np.inf
            seg["pos"] += 1
        rotated = [ids[x] for x in order]
        if not rel_c:
            return None, rotated
        sl = slice(p0, seg["pos"])
        cons = np.array(rel_c)
        depart = self._gates(cons, np.array(rel_g),
                             Times(seg["t"].d[:, sl], th[sl]))
        return (seg["idx"][sl], cons, np.array(rel_j), depart), rotated

    def _commit(self, cohort: dict, cidx: np.ndarray, j: np.ndarray,
                chan: np.ndarray, t_land: Times) -> None:
        """Some released deliveries landed: run the consumer processing
        chains (or stamp receive times), advance the channels' ack clocks
        (basic.ack multiple=True: a seen message acks every lower tag,
        every ``ack_batch`` deliveries or once the window is full), and
        pump deliveries the freed window slots now admit."""
        recv = cohort["recv"]
        ctrl = self.arch.control_latency_s()
        cs = np.unique(chan)
        members = ([np.arange(chan.size)] if cs.size == 1
                   else [np.nonzero(chan == c)[0] for c in cs])
        if cohort["consumer"]:
            # serial parse/handle chain on each consumer client
            ends, scanned = [], []
            seen0 = np.empty(chan.size)
            for c, m in zip(cs, members):
                o = m[np.argsort(t_land.h[m], kind="stable")]
                ch = self._chan(c)
                proc = self._hold(o.size, self._proc_s)
                e = _fifo_scan(self._cols(t_land.d, o) + recv, proc.d,
                               ch["free"])
                ch["free"] = e[:, -1:]
                if o.size == 1:     # one max and one add: repeated here
                    ch["free0"] = seen0[o[0]] = max(
                        t_land.h[o[0]] + recv, ch["free0"]) + proc.h[0]
                else:
                    scanned.append(len(ends))
                ends.append((o, e))
            if scanned:
                e0 = self._read(torch.cat([ends[i][1][0] for i in scanned]))
                off = 0
                for i in scanned:
                    o = ends[i][0]
                    seen0[o] = e0[off:off + o.size]
                    off += o.size
                    self._channels[cs[i]]["free0"] = seen0[o[-1]]
            if len(ends) == 1 and _run(ends[0][0]) is not None:
                seen_d = ends[0][1]
            else:
                seen_d = torch.empty_like(t_land.d)
                for o, e in ends:
                    self._put(seen_d, o, e)
            seen = Times(seen_d, seen0)
        else:
            seen = Times(t_land.d + recv, t_land.h + recv)
        flat = chan * self._cap + j
        self._put(self._flat(self._seen), flat, seen.d)
        self._seen0.ravel()[flat] = seen.h
        B = max(1, self.p.ack_batch)
        P = max(1, self.p.prefetch)
        dst, src = [], []
        for c, m in zip(cs, members):
            ch = self._chan(c)
            for mi in m[np.argsort(seen.h[m], kind="stable")]:
                ch["last_tag"] = max(ch["last_tag"], int(j[mi]) + 1)
                ch["since"] += 1
                if (ch["since"] >= B
                        or ch["assigned"] - ch["acked"] >= P):
                    a, b = ch["acked"], ch["last_tag"]
                    if b > a:
                        self._ack0[c, a:b] = seen.h[mi] + ctrl
                        dst.append(np.arange(c * self._cap + a,
                                             c * self._cap + b))
                        src.append(np.full(b - a, mi))
                        ch["acked"] = b
                    ch["since"] = 0
        if dst:
            d = np.concatenate(dst)
            self._put(self._flat(self._ack), d,
                      self._cols(seen.d, np.concatenate(src)) + ctrl)
        cohort["on_seen"](cidx, seen, chan)
        self._pump_queues([self._chan_queue[c] for c in cs])

    # -- the publish leg ---------------------------------------------------------
    def _publish_with_retry(self, members: np.ndarray, t0: Times, *,
                            flow: str, size: int,
                            combos_of: Callable[[np.ndarray], np.ndarray],
                            groups_of: Callable,
                            deliver: Callable,
                            set_confirms: Optional[Callable] = None,
                            mark_confirmed: Optional[Callable] = None
                            ) -> None:
        """Push a publish cohort through ``flow`` and admit it onto its
        target queues, for all four publish legs (work publish, feedback
        reply, broadcast fanout, gather reply), with the broker's full
        admission treatment:

        * **reject-publish overflow**: members rejected at a target's
          byte cap re-enter the publish path after ``publish_retry_s``,
          as a retry cohort;
        * **credit flow**: an admitted member that pushes a tracked
          queue past its credit threshold has its publisher confirm
          withheld on that queue's ``deferred`` list until the pump
          drains it to half the threshold (only where ``set_confirms``
          is given: reply legs never gate a producer's window).

        ``members`` is an opaque index array; ``groups_of(members)``
        yields ``(group_key, queue_states, positions)``, one admission
        group per target queue (several states: an atomic fanout);
        ``deliver(group_key, members, t_enq)`` hands admitted members to
        the pump; ``set_confirms(members, t_conf)`` /
        ``mark_confirmed(members)`` record publisher confirms.

        Admission runs per lane (:meth:`_enqueue_batch`), so lanes
        diverge here; scheduling stays the pilot's.  A member joins a
        retry cohort iff lane 0 rejected it (lanes that had admitted it
        keep their admission times); a lane that rejects a member lane 0
        admitted resolves its own retry cadence (:meth:`_lane_admit`).
        Confirm times, credit blocks and reject counts are per lane."""
        ctrl = self.arch.control_latency_s()
        retry = self.p.publish_retry_s
        L = self._lanes
        n_state = int(members.max()) + 1 if members.size else 0
        # per-member, per-lane admission state, by member value: the
        # admitted flag; the admission time (on the device, lane 0 also
        # on the host; made at the first attempt some lane did not
        # admit whole); and the queue whose credit threshold the
        # admission crossed
        st_in = np.zeros((n_state, L), dtype=bool)
        st_t: Optional[Times] = None
        st_blk: dict[int, list] = {}

        def attempt(mem: np.ndarray, t_arr: Times) -> None:
            self._push_transit(t_arr, size, flow, combos_of(mem),
                               on_part=lambda mb, t: land(mem[mb], t))

        def land(mem: np.ndarray, t_enq: Times) -> None:
            nonlocal st_t
            for gkey, queues, pos in groups_of(mem):
                sub = mem[pos]
                tp = self._take(t_enq, pos)
                already = st_in[sub]
                if already.any():
                    t_use = Times(torch.where(self._up(already.T),
                                              self._cols(st_t.d, sub), tp.d),
                                  np.where(already[:, 0], st_t.h[sub], tp.h))
                    acc, blocked_on, th = self._enqueue_batch(
                        queues, t_use, skip=already)
                else:
                    t_use = tp
                    acc, blocked_on, th = self._enqueue_batch(queues, tp)
                in_now = already | acc
                st_in[sub] = in_now
                self.rejected += (~in_now).sum(0)
                if blocked_on is not None:
                    blk_mask = np.not_equal(blocked_on, None)
                    for r, lane in zip(*np.nonzero(blk_mask)):
                        st_blk.setdefault(int(sub[r]), [None] * L)[lane] = \
                            blocked_on[r, lane]
                    self.blocked += blk_mask.sum(0)
                if blocked_on is None and acc.all():
                    # hot path (no reject, no credit event, in any
                    # lane): bulk confirms, one prefix advance
                    if set_confirms is not None:
                        set_confirms(sub, Times(tp.d + ctrl, tp.h + ctrl))
                    deliver(gkey, sub, tp)
                    if mark_confirmed is not None:
                        mark_confirmed(sub)
                    continue
                if st_t is None:
                    st_t = Times(torch.full((L, n_state), np.nan, dtype=F64,
                                            device=self.device),
                                 np.full(n_state, np.nan))
                t_new = Times(torch.where(self._up(acc.T), t_use.d,
                                          self._cols(st_t.d, sub)),
                              np.where(acc[:, 0], t_use.h, st_t.h[sub]))
                rej = np.nonzero(~in_now[:, 0])[0]
                if rej.size:
                    tr = self._take(t_use, rej)
                    attempt(sub[rej], Times(tr.d + retry, tr.h + retry))
                ok = np.nonzero(in_now[:, 0])[0]
                if ok.size and L > 1:
                    # lane 0 admitted: the member's schedule is fixed;
                    # lanes that still rejected it resolve their retry
                    # cadence against their own departs
                    tracked = [q for q in queues if q["track"]]
                    fix_k, fix_l, fix_t = [], [], []
                    for k in ok:
                        for lane in np.nonzero(~in_now[k, 1:])[0] + 1:
                            t_adm, extra, bq = self._lane_admit(
                                tracked, lane, float(th[k, lane]))
                            self.rejected[lane] += extra
                            fix_k.append(k)
                            fix_l.append(lane)
                            fix_t.append(t_adm)
                            st_in[sub[k], lane] = True
                            if bq is not None:
                                st_blk.setdefault(int(sub[k]),
                                                  [None] * L)[lane] = bq
                                self.blocked[lane] += 1
                    if fix_k:
                        t_new.d.index_put_(
                            (self._up(np.array(fix_l)),
                             self._up(np.array(fix_k))),
                            self._up(np.array(fix_t)))
                self._put(st_t.d, sub, t_new.d)
                st_t.h[sub] = t_new.h
                if ok.size == 0:
                    continue
                t_fin = self._take(t_new, ok)
                if set_confirms is None:
                    deliver(gkey, sub[ok], t_fin)
                    continue
                self._confirm(sub[ok], t_fin, st_blk, set_confirms,
                              mark_confirmed,
                              lambda: deliver(gkey, sub[ok], t_fin))

        attempt(members, t0)

    def _confirm(self, mem: np.ndarray, t_fin: Times, st_blk: dict,
                 set_confirms: Callable, mark_confirmed: Callable,
                 deliver: Callable) -> None:
        """Confirm members that lane 0 admitted with their admission
        times ``t_fin``: at once, each blocked non-pilot lane no earlier
        than its own resume clock, where lane 0 did not cross a credit
        threshold; else withheld on lane 0's blocking queue until
        :meth:`_try_resume` fires its resolver.  ``deliver`` hands the
        members to the pump in between, as the reference does."""
        L = self._lanes
        ctrl = self.arch.control_latency_s()
        tc = Times(t_fin.d + ctrl, t_fin.h + ctrl)
        now, adj, deferred_on = [], {}, None
        for k, mk in enumerate(mem.tolist()):
            blk = st_blk.get(mk)
            if blk is None or blk[0] is None:
                for lane in range(1, L):
                    if blk is not None and blk[lane] is not None:
                        adj[(lane, len(now))] = self._lane_resume_time(
                            blk[lane], lane)
                now.append(k)
                continue
            # credit flow: withhold this confirm until the pump drains
            # lane 0's queue to flow_resume
            deferred_on = blk[0]
            blk[0]["deferred"].append(self._resolver(
                mk, tc.d[:, k:k + 1], blk, set_confirms, mark_confirmed))
        if now:
            ck = np.array(now)
            d = tc.d.index_select(1, self._up(ck))
            if adj:
                a = np.full((L, ck.size), -np.inf)
                for (lane, i), v in adj.items():
                    a[lane, i] = v
                d = torch.maximum(d, self._up(a))
            set_confirms(mem[ck], Times(d, tc.h[ck]))
        deliver()
        if now:
            mark_confirmed(mem[np.array(now)])
        if deferred_on is not None:
            self._try_resume(deferred_on)

    def _resolver(self, mk: int, tc: torch.Tensor, blk: list,
                  set_confirms: Callable, mark_confirmed: Callable
                  ) -> Callable[[float], None]:
        """The resolver of member ``mk``'s withheld confirm: lane 0 at
        the resume clock it is given, each other blocked lane no earlier
        than its own resume clock then, the rest at ``tc``."""
        def fire(t_res: float) -> None:
            a = np.full((self._lanes, 1), -np.inf)
            for lane in range(1, self._lanes):
                if blk[lane] is not None:
                    a[lane, 0] = self._lane_resume_time(blk[lane], lane)
            d = torch.maximum(tc, self._up(a))
            d[0, 0] = t_res
            set_confirms(np.array([mk]), Times(d, np.array([t_res])))
            mark_confirmed(np.array([mk]))
        return fire

    # -- main ------------------------------------------------------------------
    def _setup(self) -> None:
        """Build the pattern topology and launch the initial publish
        rounds (everything up to draining the event heap)."""
        if self.spec.pattern in WAVE_PATTERNS:
            self._setup_work(feedback=(self.spec.pattern == "feedback"))
        else:
            self._setup_broadcast(gather=(self.spec.pattern
                                          == "broadcast_gather"))

    def run(self) -> RunResult:
        if self._lanes > 1:
            raise RuntimeError("this engine was built with stack_seeds; "
                               "use run_stacked()")
        return self.run_stacked()[0]

    def run_stacked(self) -> list[RunResult]:
        """Run all ``stack_seeds`` lanes in one batched event loop and
        return their per-lane results (in ``stack_seeds`` order).  The
        pilot lane drives every scheduling decision with its own clock;
        the other lanes run the same schedule with their own jitter,
        resources and carries."""
        self._setup()
        self._drain_all()
        out = self._finalize_stacked()
        TorchStreamSim.stats["runs"] += 1
        TorchStreamSim.stats["host_reads"] += self.host_reads
        TorchStreamSim.stats["withheld"] += sum(
            len(q["deferred"]) for q in self._queues.values())
        return out

    def _store(self, *shape: int, fill: float = 0.0) -> torch.Tensor:
        return torch.full((self._lanes,) + shape, fill, dtype=F64,
                          device=self.device)

    # -- work sharing (+ feedback) ---------------------------------------------
    def _setup_work(self, feedback: bool) -> None:
        spec, p, inv = self.spec, self.p, self.inv
        nP, nC = spec.n_producers, spec.n_consumers
        M = spec.total_messages // nP
        size = spec.workload.payload_bytes
        flush = self.arch.client_flush_s()
        W = max(2, min(p.confirm_window, p.window_bytes // size))

        # declare order matches the heap engine: work queues first, then
        # per-producer reply queues
        nq, q_consumers, prod_queues, q_pubs = self._work_topology()
        q_home = np.arange(nq) % inv.n_dsn
        reply_home = (nq + np.arange(nP)) % inv.n_dsn
        pr_node = np.arange(nP) % inv.n_producer_nodes
        pr_bnode = np.arange(nP) % inv.n_dsn
        c_node = np.arange(nC) % inv.n_consumer_nodes
        c_bnode = (np.arange(nC) + 1) % inv.n_dsn

        i_idx = np.broadcast_to(np.arange(M), (nP, M))
        pr_idx = np.broadcast_to(np.arange(nP)[:, None], (nP, M))
        # producer pr round-robins over its own queue list
        msg_q = np.empty((nP, M), dtype=int)
        for pr in range(nP):
            ql = np.asarray(prod_queues[pr])
            msg_q[pr] = ql[(pr + np.arange(M)) % ql.size]
        volume = np.bincount(msg_q.ravel(), minlength=nq)

        # every clock store is (lanes, ...); confirms also on the host,
        # since they gate the next publish round's start (the heap key)
        confirms = self._store(nP, M)
        confirms0 = np.zeros((nP, M))
        pub_start = self._store(nP * M)
        consume_t = self._store(nP * M, fill=np.nan)
        rtts = self._store(nP * M, fill=np.nan) if feedback else None
        recv_req = self._recv_latency(size)
        reply_size = max(1, int(size * p.reply_factor))
        recv_rep = self._recv_latency(reply_size)

        # work queues see all their producers' credit; reply queues are
        # exempt from credit flow but share the byte cap
        cap = (p.queue_max_bytes // size if p.queue_max_bytes else None)
        rcap = (p.queue_max_bytes // reply_size if p.queue_max_bytes
                else None)
        # chaos: a paused queue rejects publishes whatever its backlog,
        # and the autoscale tick reads every work queue's: those track
        down, track = [], set()
        if self._chaos is not None:
            down = self._chaos_down_queues(nq, q_home)
            track = (set(range(nq)) if self._chaos.autoscale is not None
                     else {qi for _, qis in down for qi in qis})
        work_q = [self._queue_state(("work", qi), q_consumers[qi], size,
                                    credit=FLOW_CREDIT * q_pubs[qi],
                                    cap_msgs=cap, volume=int(volume[qi]),
                                    track=qi in track)
                  for qi in range(nq)]
        if feedback:
            for pr in range(nP):
                self._queue_state(("reply", pr), [nC + pr], reply_size,
                                  cap_msgs=rcap, volume=M)

        R = max(1, min(W, self._round))
        # flow-control events reachable (a byte cap below the per-queue
        # volume, a publish surplus that can pile backlog past the
        # credit threshold, or a chaos broker outage that rejects
        # publishes): per-message rounds reproduce the heap engine's
        # burst-and-retry dynamics at the blocking boundary
        if self.p.vec_round is None and (self.flow_events_possible()
                                         or self._chaos_flow_possible()):
            R = 1
        n_rounds = -(-M // R)
        # per-producer resolved-confirm prefixes: round r may launch once
        # every confirm its send gates read (indices < hi - W) is resolved
        conf_ok = np.zeros((nP, M), dtype=bool)
        prefix = np.zeros(nP, dtype=np.int64)
        state = {"next_launch": 0}

        def mark_confirmed(pr_arr: np.ndarray, i_arr: np.ndarray) -> None:
            conf_ok[pr_arr, i_arr] = True
            for pr in np.unique(pr_arr):
                j = int(prefix[pr])
                while j < M and conf_ok[pr, j]:
                    j += 1
                prefix[pr] = j
            advance_pubs()

        def advance_pubs() -> None:
            while state["next_launch"] < n_rounds:
                r = state["next_launch"]
                need = min((r + 1) * R, M) - W
                if need > 0 and int(prefix.min()) < need:
                    return
                state["next_launch"] += 1
                launch_pub(r)

        # tenant-aware hop graphs: combos carry the client's tenant as a
        # trailing column (the path constructors' 4th argument)
        tcols = self._tenant_cols
        ppt, cpt = self._ppt, self._cpt

        def _tenant_col(base: np.ndarray, tenant: np.ndarray) -> np.ndarray:
            if not tcols:
                return base
            return np.concatenate([base, tenant[:, None]], axis=1)

        combos_del_by_q = {qi: (lambda mem, cons, qi=qi:
                                _tenant_col(
                                    np.stack([(cons + 1) % inv.n_dsn,
                                              np.full(cons.size, q_home[qi]),
                                              cons % inv.n_consumer_nodes],
                                             axis=1),
                                    np.minimum(cons // cpt,
                                               spec.tenants - 1)))
                           for qi in range(nq)}

        def on_seen_del(mem: np.ndarray, t_done: Times,
                        cons: np.ndarray) -> None:
            self._put(consume_t, mem, t_done.d)
            if feedback:
                launch_reply(mem, t_done, cons)

        def launch_pub(r: int) -> None:
            lo, hi = r * R, min((r + 1) * R, M)
            nb = hi - lo
            # the send gate of message i is the confirm of message i - W
            g_lo = max(lo, W)
            gate = self._store(nP, nb)
            gate0 = np.zeros((nP, nb))
            if g_lo < hi:
                gate[:, :, g_lo - lo:] = confirms[:, :, g_lo - W:hi - W]
                gate0[:, g_lo - lo:] = confirms0[:, g_lo - W:hi - W]
            s_blk = Times((gate + flush).reshape(self._lanes, nP * nb),
                          (gate0 + flush).ravel())
            pub_start.view(self._lanes, nP, M)[:, :, lo:hi] = \
                s_blk.d.view(self._lanes, nP, nb)
            flat_pr = pr_idx[:, lo:hi].ravel()
            flat_i = i_idx[:, lo:hi].ravel()
            flat_q = msg_q[:, lo:hi].ravel()

            def combos_of(mem: np.ndarray) -> np.ndarray:
                return _tenant_col(
                    np.stack([pr_node[flat_pr[mem]],
                              pr_bnode[flat_pr[mem]],
                              q_home[flat_q[mem]]], axis=1),
                    flat_pr[mem] // ppt)

            def groups_of(mem: np.ndarray) -> Iterator[tuple]:
                qs = flat_q[mem]
                for qi in np.unique(qs):
                    yield (int(qi), [work_q[int(qi)]],
                           np.nonzero(qs == qi)[0])

            def set_conf(mem: np.ndarray, t_conf: Times) -> None:
                flat = flat_pr[mem] * M + flat_i[mem]
                self._put(confirms.view(self._lanes, nP * M), flat, t_conf.d)
                confirms0.ravel()[flat] = t_conf.h

            def mark(mem: np.ndarray) -> None:
                mark_confirmed(flat_pr[mem], flat_i[mem])

            def deliver(qi: int, mem: np.ndarray, t_enq: Times) -> None:
                self._deliver_queue(
                    ("work", qi), q_consumers[qi], t_enq,
                    flat_pr[mem] * M + flat_i[mem],
                    combos_del_by_q[qi], size, "delivery_path",
                    consumer=True, recv=recv_req, on_seen=on_seen_del)

            self._publish_with_retry(
                np.arange(flat_pr.size), s_blk,
                flow="publish_path", size=size, combos_of=combos_of,
                groups_of=groups_of, deliver=deliver,
                set_confirms=set_conf, mark_confirmed=mark)

        def launch_reply(members: np.ndarray, t_done: Times,
                         cons: np.ndarray) -> None:
            # members are global message indices; producer = index // M
            def combos_of(pos: np.ndarray) -> np.ndarray:
                return _tenant_col(
                    np.stack([c_node[cons[pos]], c_bnode[cons[pos]],
                              reply_home[members[pos] // M]], axis=1),
                    cons[pos] // cpt)

            def groups_of(pos: np.ndarray) -> Iterator[tuple]:
                prs = members[pos] // M
                for pr in np.unique(prs):
                    yield (int(pr), [self._queues[("reply", int(pr))]],
                           np.nonzero(prs == pr)[0])

            def deliver(pr: int, pos_sel: np.ndarray, t_renq: Times) -> None:
                def combos_fn(sub_mem: np.ndarray, _cons: np.ndarray,
                              pr: int = pr) -> np.ndarray:
                    row = [reply_home[pr], pr_bnode[pr], pr_node[pr]]
                    if tcols:
                        row.append(pr // ppt)
                    return np.broadcast_to(row, (sub_mem.size, len(row)))

                def on_seen(sub_mem: np.ndarray, t_seen: Times,
                            _cons: np.ndarray) -> None:
                    self._put(rtts, sub_mem,
                              t_seen.d - self._cols(pub_start, sub_mem))

                self._deliver_queue(
                    ("reply", pr), [nC + pr], t_renq, members[pos_sel],
                    combos_fn, reply_size, "reply_delivery_path",
                    consumer=False, recv=recv_rep, on_seen=on_seen)

            self._publish_with_retry(
                np.arange(members.size), t_done,
                flow="reply_publish_path", size=reply_size,
                combos_of=combos_of, groups_of=groups_of, deliver=deliver)

        if self._chaos is not None:
            self._chaos_setup(nq, down)
        advance_pubs()
        self._fin = (consume_t, rtts, pub_start)

    # -- broadcast (+ gather) --------------------------------------------------
    def _setup_broadcast(self, gather: bool) -> None:
        spec, p, inv = self.spec, self.p, self.inv
        nC = spec.n_consumers
        if spec.n_producers != 1:
            raise ValueError("broadcast patterns use one producer")
        M = spec.total_messages
        size = spec.workload.payload_bytes
        flush = self.arch.client_flush_s()
        W = max(2, min(p.confirm_window, p.window_bytes // size))

        bq_home = np.arange(nC) % inv.n_dsn        # bq:c declared in order
        gather_home = nC % inv.n_dsn               # declared after the bqs
        pnode, pbnode = 0 % inv.n_producer_nodes, 0
        c_node = np.arange(nC) % inv.n_consumer_nodes
        c_bnode = (np.arange(nC) + 1) % inv.n_dsn

        confirms = self._store(M)
        confirms0 = np.zeros(M)
        pub_start = self._store(M)
        consume_t = self._store(M * nC, fill=np.nan)
        rtts = self._store(M * nC, fill=np.nan) if gather else None
        recv_req = self._recv_latency(size)
        reply_size = max(1, int(size * p.reply_factor))
        recv_rep = self._recv_latency(reply_size)

        # fanout targets: admission is atomic across all of them
        cap = (p.queue_max_bytes // size if p.queue_max_bytes else None)
        rcap = (p.queue_max_bytes // reply_size if p.queue_max_bytes
                else None)
        bqs = [self._queue_state(("bq", c), [c], size, credit=FLOW_CREDIT,
                                 cap_msgs=cap, volume=M)
               for c in range(nC)]
        if gather:
            self._queue_state(("gather",), [nC], reply_size, cap_msgs=rcap,
                              volume=M * nC)

        R = max(1, min(W, self._round))
        # flow-control events reachable on the fanout targets: see
        # _setup_work
        if self.p.vec_round is None and self.flow_events_possible():
            R = 1
        n_rounds = -(-M // R)
        conf_ok = np.zeros(M, dtype=bool)
        state = {"next_launch": 0, "prefix": 0}

        def mark_confirmed(i_arr: np.ndarray) -> None:
            conf_ok[i_arr] = True
            j = state["prefix"]
            while j < M and conf_ok[j]:
                j += 1
            state["prefix"] = j
            advance_pubs()

        def advance_pubs() -> None:
            while state["next_launch"] < n_rounds:
                r = state["next_launch"]
                need = min((r + 1) * R, M) - W
                if need > 0 and state["prefix"] < need:
                    return
                state["next_launch"] += 1
                launch_pub(r)

        def launch_pub(r: int) -> None:
            lo, hi = r * R, min((r + 1) * R, M)
            i_blk = np.arange(lo, hi)
            g_lo = max(lo, W)          # rounds can straddle the window edge
            gate = self._store(hi - lo)
            gate0 = np.zeros(hi - lo)
            if g_lo < hi:
                gate[:, g_lo - lo:] = confirms[:, g_lo - W:hi - W]
                gate0[g_lo - lo:] = confirms0[g_lo - W:hi - W]
            s_blk = Times(gate + flush, gate0 + flush)
            pub_start[:, lo:hi] = s_blk.d

            def combos_of(mem: np.ndarray) -> np.ndarray:
                # a fanout publish transits once, to the exchange's home
                return np.broadcast_to([pnode, pbnode, 0], (mem.size, 3))

            def groups_of(mem: np.ndarray) -> Iterator[tuple]:
                # one admission group: atomic across every fanout target
                yield None, bqs, np.arange(mem.size)

            def set_conf(mem: np.ndarray, t_conf: Times) -> None:
                self._put(confirms, i_blk[mem], t_conf.d)
                confirms0[i_blk[mem]] = t_conf.h

            def mark(mem: np.ndarray) -> None:
                mark_confirmed(i_blk[mem])

            def deliver(_g: object, mem: np.ndarray, t_enq: Times) -> None:
                launch_del(i_blk[mem], t_enq)

            self._publish_with_retry(
                np.arange(i_blk.size), s_blk, flow="publish_path",
                size=size, combos_of=combos_of, groups_of=groups_of,
                deliver=deliver, set_confirms=set_conf,
                mark_confirmed=mark)

        def launch_del(i_part: np.ndarray, t_enq: Times) -> None:
            # replicate to every per-consumer queue; deliver each copy.
            # Sorted once here, each queue's own stable sort keeps it.
            o = np.argsort(t_enq.h, kind="stable")
            i_part, t_enq = i_part[o], self._take(t_enq, o)
            for c in range(nC):
                def combos_fn(members: np.ndarray, cons: np.ndarray,
                              c: int = c) -> np.ndarray:
                    return np.broadcast_to(
                        [c_bnode[c], bq_home[c], c_node[c]],
                        (members.size, 3))

                def on_seen(members: np.ndarray, t_done: Times,
                            cons: np.ndarray, c: int = c) -> None:
                    self._put(consume_t, members, t_done.d)
                    if gather:
                        launch_reply(members, t_done, c)

                self._deliver_queue(
                    ("bq", c), [c], t_enq, c * M + i_part, combos_fn, size,
                    "delivery_path", consumer=True, recv=recv_req,
                    on_seen=on_seen)

        def launch_reply(members: np.ndarray, t_done: Times, c: int) -> None:
            # members are global copy indices (c * M + i)
            def combos_of(pos: np.ndarray) -> np.ndarray:
                return np.broadcast_to(
                    [c_node[c], c_bnode[c], gather_home], (pos.size, 3))

            def groups_of(pos: np.ndarray) -> Iterator[tuple]:
                yield None, [self._queues[("gather",)]], np.arange(pos.size)

            def deliver(_g: object, pos_sel: np.ndarray,
                        t_renq: Times) -> None:
                def combos_fn(sub_members: np.ndarray,
                              _cons: np.ndarray) -> np.ndarray:
                    return np.broadcast_to(
                        [gather_home, pbnode, pnode], (sub_members.size, 3))

                def on_seen(sub_members: np.ndarray, t_seen: Times,
                            _cons: np.ndarray) -> None:
                    self._put(rtts, sub_members, t_seen.d - self._cols(
                        pub_start, sub_members % M))

                self._deliver_queue(
                    ("gather",), [nC], t_renq, members[pos_sel],
                    combos_fn, reply_size, "reply_delivery_path",
                    consumer=False, recv=recv_rep, on_seen=on_seen)

            self._publish_with_retry(
                np.arange(members.size), t_done,
                flow="reply_publish_path", size=reply_size,
                combos_of=combos_of, groups_of=groups_of, deliver=deliver)

        advance_pubs()
        self._fin = (consume_t, rtts, pub_start)

    # -- shared result assembly ------------------------------------------------
    def _finalize_stacked(self) -> list[RunResult]:
        """Per-lane results: lane ``s`` is the cell run with
        ``stack_seeds[s]``, through the cell's ``_result`` contract, with
        the lane's own flow-control counters.  The host cursors' last
        pops go back to the device stores first."""
        for q in self._queues.values():
            if q["track"]:
                self._flush(q)
        consume_t, rtts, pub_start = (
            None if x is None else self._read(x) for x in self._fin)
        # a chaos run's duplicate completions (solo: lane 0's)
        dups = ((np.concatenate(self._dup_times),
                 np.concatenate(self._dup_mem)) if self._dup_times else None)
        out = []
        for s, seed in enumerate(self.stack_seeds):
            spec_s = dataclasses.replace(
                self.spec, params=dataclasses.replace(self.p, seed=seed))
            out.append(self._result(
                spec_s, consume_t[s], None if rtts is None else rtts[s],
                pub_start[s], rejected=int(self.rejected[s]),
                blocked=int(self.blocked[s]), redelivered=self._redelivered,
                dups=dups))
        return out

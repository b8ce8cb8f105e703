"""The StreamSim *wave* program in PyTorch: a whole run as one loop over
message generations, on the GPU.

This is the port of the reference's whole-run device program
(``core/jax_device_loop.py``).  It runs a work-sharing or feedback cell,
with its seed-lanes stacked on a trailing lane axis and structurally
identical cells batched on a leading cell axis, as a Python loop over
pipelined steps.  Step ``g`` publishes generation ``g`` through the
confirm-window admission ring, delivers generation ``g-1`` through the
pump window (the hand-written kernel in
:mod:`repro_torch.kernels.pump_assign`), and, with feedback,
reply-publishes and reply-delivers earlier generations; all legs of a
step are served by one segmented FIFO closed form over the combined
member axis.

**The wave contract** is the reference's: exact capacity and work
conservation at every shared resource, a phase order inside a
generation that differs from the cohort engines (hence the
``device_loop.*`` parity bands), and a regime gate
(:func:`_device_loop_ok`) that admits only cells where that schedule is
validated.

**Layout.**  The host builders (:func:`build_static`,
:func:`draw_jitter`) stay NumPy and are the reference's, so a static
schedule built by either package feeds either program;
:func:`static_to_torch` carries one over to tensors.  On the device,
member tensors are ``(C, Np)`` and clocks ``(C, Np, L)`` float64, with
``C`` cells and ``L`` seed-lanes; per-step inputs lead with the step
axis.  Every tensor is float64 or int64 with an explicit device.

**Pad-and-mask.**  Member axes pad to the next power of two with
invalid members carrying ``+inf`` clocks, zero holds and dummy carry
rows; the cell axis pads to a power of two by replicating cell 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.cell import WAVE_PATTERNS, WaveCell, _align_paths
from repro_torch.device import resolve_device
from repro_torch.kernels.pump_assign import pump_assign

_INF = np.inf
#: integer sentinel for "no next ack boundary" (never survives: the last
#: valid member of every consumer segment is always a boundary)
_IBIG = 2 ** 40


# ---------------------------------------------------------------------------
# Regime gate and static build (host, NumPy)
# ---------------------------------------------------------------------------


def _device_loop_ok(sim: WaveCell) -> tuple[bool, str]:
    """Can the wave program take this cell?  ``(ok, why)``."""
    spec, p = sim.spec, sim.p
    if spec.pattern not in WAVE_PATTERNS:
        return False, f"pattern {spec.pattern!r} is not wave-formulated"
    if p.chaos is not None:
        return False, ("chaos schedules change the topology mid-run; the "
                       "wave program's schedule is static")
    if spec.total_messages // max(1, spec.n_producers) < 1:
        return False, "fewer messages than producers"
    if sim.flow_events_possible():
        return False, ("flow-control events (credit blocking / overflow) "
                       "are reachable; the wave program models neither")
    G = _pick_generation(sim)
    if G is None:
        return False, ("no generation size keeps every consumer under "
                       "prefetch/2 deliveries per generation")
    # universal run-length clause: the lockstep generation barriers
    # drift against continuous pipelining past 256 msgs/producer
    if spec.total_messages // max(1, spec.n_producers) > 256:
        return False, (f"run length {spec.total_messages // max(1, spec.n_producers)}"
                       " msgs/producer > 256: generation-barrier drift "
                       "accumulates over long runs (throughput deviation "
                       "grows with nGen past the parity band)")
    if spec.pattern == "feedback":
        # the static reply-lag pipeline holds only in a calibrated
        # corridor: G >= 4, 2G < W < M <= 2W, and not on mss
        M = spec.total_messages // max(1, spec.n_producers)
        size = spec.workload.payload_bytes
        W = max(2, min(p.confirm_window, p.window_bytes // size))
        if spec.arch == "mss":
            return False, ("feedback on the single-broker mss arch is "
                           "outside the wave model's validated regime")
        if G < 4:
            return False, (f"feedback generations too fine (G={G} < 4): "
                           "the static reply-lag pipeline cannot track "
                           "the cohort loop at this granularity")
        if W <= 2 * G:
            return False, (f"confirm window W={W} <= 2G={2 * G}: "
                           "hard window-stall regime, outside the wave "
                           "model's validated feedback corridor")
        if W >= M:
            return False, (f"confirm window W={W} >= msgs/producer {M}: "
                           "the window never binds (burst regime), "
                           "outside the wave model's validated corridor")
        if M > 2 * W:
            return False, (f"run length {M} msgs/producer > 2W={2 * W}: "
                           "the static reply lag drifts over runs much "
                           "longer than the confirm window (measured "
                           "RTT deviation grows with nGen)")
    return True, ""


def _pick_generation(sim: WaveCell) -> Optional[int]:
    """Largest workable generation size G: at most the publish round,
    the confirm window, and a per-consumer load of prefetch//2 per
    generation, so prefetch gates always resolve against *earlier*
    generations' ack rings."""
    spec, p = sim.spec, sim.p
    nP = spec.n_producers
    size = spec.workload.payload_bytes
    W = max(2, min(p.confirm_window, p.window_bytes // size))
    nq, q_consumers, prod_queues, _ = sim._work_topology()
    budget = max(1, p.prefetch // 2)
    rnd = max(1, int(sim._round))
    for G in range(min(W, budget, rnd), 0, -1):
        load_ok = True
        for qi in range(nq):
            arrivals = sum(-(-G // len(prod_queues[pr]))
                           for pr in range(nP) if qi in prod_queues[pr])
            per_consumer = -(-arrivals // max(1, len(q_consumers[qi])))
            if per_consumer > budget:
                load_ok = False
                break
        if load_ok and G <= budget:
            return G
    return None


def _path_slots(paths: dict, res_index: dict, kinds: dict,
                size: int) -> tuple[dict, int]:
    """Resolve + align a {combo_key: [PathElement]} map into per-combo
    per-slot static tuples ``(kind, rid, hold_base, lat)`` where kind is
    0 latency-only / 1 pipe / 2 pool."""
    aligned, n_slots = _align_paths(paths)
    out = {}
    for key, els in aligned.items():
        rows = []
        for el in els:
            if el is None or el.resource is None:
                rows.append((0, 0, 0.0,
                             0.0 if el is None else el.latency_s))
                continue
            spec = res_index[el.resource]
            nbytes = size * el.byte_factor + el.extra_bytes
            if spec.kind == "pipe":
                hold = spec.service_s + (
                    nbytes / spec.rate_Bps if spec.rate_Bps else 0.0)
                rows.append((1, kinds[el.resource], hold, el.latency_s))
            else:
                hold = spec.service_s + nbytes * spec.per_byte_s
                rows.append((2, kinds[el.resource], hold, el.latency_s))
        out[key] = rows
    return out, n_slots


@dataclasses.dataclass
class WaveStatic:
    """Everything the program needs, as NumPy arrays + a hashable
    ``signature`` (the cell-batching bucket)."""

    meta: dict                 # hashable ints/flags/pool layout
    xs: dict                   # per-step arrays, leading axis nSteps
    inv: dict                  # loop-invariant arrays (tables, scalars)
    sizes: dict                # python ints used by the host wrapper

    def signature(self) -> tuple:
        return (tuple(sorted(self.meta.items())),
                tuple(sorted((k, v.shape, str(v.dtype))
                             for k, v in self.xs.items())),
                tuple(sorted((k, v.shape, str(v.dtype))
                             for k, v in self.inv.items())))


def build_static(sim: WaveCell) -> WaveStatic:
    """Extract the wave program's static schedule from a cell."""
    spec, p, inv = sim.spec, sim.p, sim.inv
    arch = sim.arch
    nP, nC = spec.n_producers, spec.n_consumers
    M = spec.total_messages // nP
    size = spec.workload.payload_bytes
    reply_size = max(1, int(size * p.reply_factor))
    feedback = spec.pattern == "feedback"
    W = max(2, min(p.confirm_window, p.window_bytes // size))
    G = _pick_generation(sim)
    if G is None:
        raise ValueError("no workable generation size; check "
                         "_device_loop_ok first")
    G = min(G, M)
    nGen = -(-M // G)
    L = sim._lanes

    nq, q_consumers, prod_queues, _ = sim._work_topology()
    q_home = np.arange(nq) % inv.n_dsn
    reply_home = (nq + np.arange(nP)) % inv.n_dsn
    pr_node = np.arange(nP) % inv.n_producer_nodes
    pr_bnode = np.arange(nP) % inv.n_dsn
    c_node = np.arange(nC) % inv.n_consumer_nodes
    c_bnode = (np.arange(nC) + 1) % inv.n_dsn
    tcols = sim._tenant_cols
    ppt, cpt = sim._ppt, sim._cpt

    # resource registry: flat chain ids (pipes 1 chain, pools k chains)
    res_index = sim.arch.resources
    res_keys = sorted(res_index)
    rid_of = {k: i for i, k in enumerate(res_keys)}
    NR = len(res_keys)
    k_arr = np.ones(NR, dtype=np.int64)
    chain_base = np.zeros(NR, dtype=np.int64)
    pools = []
    base = 0
    for k in res_keys:
        s = res_index[k]
        kk = max(1, s.servers) if s.kind == "pool" else 1
        chain_base[rid_of[k]] = base
        k_arr[rid_of[k]] = kk
        if s.kind == "pool":
            pools.append((base, kk))
        base += kk
    NCH = base

    def tkey(t: int) -> tuple:
        return (t,) if tcols else ()

    # -- publish paths: one combo per (pr, q), aligned together ----------
    pub_paths = {}
    for pr in range(nP):
        for qi in prod_queues[pr]:
            pub_paths[(pr, qi)] = arch.publish_path(
                int(pr_node[pr]), int(pr_bnode[pr]), int(q_home[qi]),
                *tkey(pr // ppt))
    pub_slots, S_pub = _path_slots(pub_paths, res_index, rid_of, size)
    pub_keys = sorted(pub_slots)
    pub_idx_of = {k: i for i, k in enumerate(pub_keys)}
    pub_tab = np.zeros((len(pub_keys), S_pub, 4))
    for k, rows in pub_slots.items():
        pub_tab[pub_idx_of[k]] = rows

    # -- delivery paths: aligned per queue, padded to the max slot count
    del_aligned = {}
    S_del = 0
    for qi in range(nq):
        dp = {int(c): arch.delivery_path(
            int(c_bnode[c]), int(q_home[qi]), int(c_node[c]),
            *tkey(int(c) // cpt)) for c in q_consumers[qi]}
        slots, ns = _path_slots(dp, res_index, rid_of, size)
        del_aligned[qi] = slots
        S_del = max(S_del, ns)
    kq = np.array([len(q_consumers[qi]) for qi in range(nq)],
                  dtype=np.int64)
    kq_max = int(kq.max())
    q_cons_tab = np.zeros((nq, kq_max), dtype=np.int64)
    del_tab = np.zeros((nq, kq_max, S_del, 4))
    for qi in range(nq):
        for j, c in enumerate(q_consumers[qi]):
            q_cons_tab[qi, j] = int(c)
            rows = del_aligned[qi][int(c)]
            del_tab[qi, j, :len(rows)] = rows

    # -- reply paths (feedback) -----------------------------------------
    if feedback:
        rp_paths = {(int(c), pr): arch.reply_publish_path(
            int(c_node[c]), int(c_bnode[c]), int(reply_home[pr]),
            *tkey(int(c) // cpt))
            for pr in range(nP)
            for c in sorted({int(x) for qi in prod_queues[pr]
                             for x in q_consumers[qi]})}
        rp_slots, S_rp = _path_slots(rp_paths, res_index, rid_of,
                                     reply_size)
        rp_tab = np.zeros((nC, nP, S_rp, 4))
        for (c, pr), rows in rp_slots.items():
            rp_tab[c, pr] = rows
        rd_aligned = {}
        S_rd = 0
        for pr in range(nP):
            slots, ns = _path_slots(
                {0: arch.reply_delivery_path(
                    int(reply_home[pr]), int(pr_bnode[pr]),
                    int(pr_node[pr]), *tkey(pr // ppt))},
                res_index, rid_of, reply_size)
            rd_aligned[pr] = slots[0]
            S_rd = max(S_rd, ns)
        rd_tab = np.zeros((nP, S_rd, 4))
        for pr in range(nP):
            rows = rd_aligned[pr]
            rd_tab[pr, :len(rows)] = rows
    else:
        S_rp = S_rd = 0
        rp_tab = np.zeros((nC, nP, 0, 4))
        rd_tab = np.zeros((nP, 0, 4))

    # combined-serve slot axis: all legs pad to one width so each step's
    # transits run as a SINGLE serve over the concatenated member axis
    S_max = max(S_pub, S_del, S_rp, S_rd)

    def pad_slots(tab: np.ndarray) -> np.ndarray:
        pad = ([(0, 0)] * (tab.ndim - 2)
               + [(0, S_max - tab.shape[-2]), (0, 0)])
        return np.pad(tab, pad)

    pub_tab, del_tab = pad_slots(pub_tab), pad_slots(del_tab)
    rp_tab, rd_tab = pad_slots(rp_tab), pad_slots(rd_tab)

    # -- per-generation member arrays ------------------------------------
    N = nP * G
    Np = 1 << max(0, N - 1).bit_length()       # pow2 pad-and-mask bucket
    pr_m = np.tile(np.repeat(np.arange(nP), G), (nGen, 1))
    loc = np.tile(np.arange(G), nP)
    valid = np.zeros((nGen, Np), dtype=bool)
    i_glob = np.zeros((nGen, Np), dtype=np.int64)
    q_m = np.zeros((nGen, Np), dtype=np.int64)
    pub_ci = np.zeros((nGen, Np), dtype=np.int64)
    mem_id = np.zeros((nGen, Np), dtype=np.int64)
    for g in range(nGen):
        ii = g * G + loc                        # per-producer msg index
        ok = ii < M
        valid[g, :N] = ok
        i_glob[g, :N] = np.minimum(ii, M - 1)
        for pr in range(nP):
            ql = np.asarray(prod_queues[pr])
            sl = slice(pr * G, (pr + 1) * G)
            qs = ql[(pr + ii[sl]) % ql.size]
            q_m[g, sl] = qs
            pub_ci[g, sl] = [pub_idx_of[(pr, int(q))] for q in qs]
        mem_id[g, :N] = pr_m[g] * M + np.minimum(ii, M - 1)
    pr_mat = np.zeros((nGen, Np), dtype=np.int64)
    pr_mat[:, :N] = pr_m
    has_gate = valid & (i_glob >= W)
    # invalid pad members write confirm slot W (a scratch column past
    # the ring) so masked writes can never collide with live slots
    conf_slot = np.where(valid, i_glob % W, W)

    # static round-robin bases: per-generation queue/consumer/producer
    # arrival counts are order-independent, so the RR cursors are
    # precomputed instead of carried
    cnt_q = np.zeros((nGen, nq), dtype=np.int64)
    cnt_c = np.zeros((nGen, nC), dtype=np.int64)
    cq = np.zeros(nq, dtype=np.int64)
    cc = np.zeros(nC, dtype=np.int64)
    for g in range(nGen):
        cnt_q[g], cnt_c[g] = cq.copy(), cc.copy()
        counts = np.bincount(q_m[g][valid[g]], minlength=nq)
        for qi in range(nq):
            n, k = int(counts[qi]), int(kq[qi])
            for pp in range(n):
                cc[q_cons_tab[qi, (cq[qi] + pp) % k]] += 1
            cq[qi] += n
    # producer reply counts: pr receives exactly its own valid msgs;
    # padded with a scratch column for the dummy reply chain
    per_gen_p = np.stack([np.bincount(pr_mat[g][valid[g]], minlength=nP)
                          for g in range(nGen)])
    cnt_p = np.concatenate([np.zeros((1, nP), dtype=np.int64),
                            np.cumsum(per_gen_p, axis=0)[:-1]])
    cnt_p = np.concatenate(
        [cnt_p, np.zeros((nGen, 1), dtype=np.int64)], axis=1)

    # software-pipelined inputs: step g publishes generation g and
    # delivers generation g-1; the reply legs trail by a lag (in
    # generations) estimated from the path latencies over the
    # per-generation cadence, so each step's combined serve holds flows
    # whose arrival clocks coexist.  Every leg's arrays are shifted by
    # its offset, with all-False validity masks in the prologue/drain.
    if feedback:
        work = np.zeros((2, NR))
        for m_i in range(N):
            if not valid[0, m_i]:
                continue
            pr_i, q_i = int(pr_m[0][m_i]), int(q_m[0, m_i])
            legs = [(0, pub_tab[pub_ci[0, m_i]]), (1, del_tab[q_i, 0]),
                    (0, rp_tab[int(q_cons_tab[q_i, 0]), pr_i]),
                    (1, rd_tab[pr_i])]
            for sd, rows in legs:
                for kk_, r_, h_, _l in rows:
                    if kk_ > 0:
                        work[sd, int(r_)] += (
                            h_ / max(1, int(k_arr[int(r_)])))
        tau = float(work.max())

        def combo_sum(tab: np.ndarray) -> float:
            t = tab.reshape(-1, tab.shape[-2], 4)
            live = (t[:, :, 0] > 0).any(axis=1)
            tot = (t[:, :, 2] + t[:, :, 3]).sum(axis=1)
            return float(tot[live].mean()) if live.any() else 0.0

        lag_pub = combo_sum(pub_tab)
        # window-bound cadence floor
        tau_gen = max(tau, lag_pub / max(1.0, W / G))
        # pub enqueue -> reply-publish enqueue path latency
        lag_rp = (lag_pub + combo_sum(del_tab)
                  + sim._recv_latency(size) + sim._proc_s)
        delay = (int(np.clip(round(lag_rp / tau_gen), 1, nGen))
                 if tau_gen > 0 else 1)
        # egress alignment: reply-deliveries contend with deliveries
        # d_egr generations later at the egress resources
        lag_e = (combo_sum(del_tab) + sim._recv_latency(size)
                 + combo_sum(rp_tab))
        d_egr = (int(np.clip(round(lag_e / tau_gen), 1,
                             max(1, delay - 1)))
                 if tau_gen > 0 else 1)
        dlag = delay - d_egr
    else:
        delay, d_egr, dlag = 1, 1, 0
    depth = (2 + delay) if feedback else 1
    nSteps = nGen + depth

    def shift(a: np.ndarray, by: int) -> np.ndarray:
        out = np.zeros((nSteps,) + a.shape[1:], dtype=a.dtype)
        out[by:by + nGen] = a
        return out

    meta = dict(
        Np=Np, L=L, S_pub=S_pub, S_del=S_del, S_rp=S_rp, S_rd=S_rd,
        S_max=S_max, feedback=feedback, NR=NR, NCH=NCH, nq=nq, nC=nC,
        nP=nP, kq_max=kq_max, P=int(p.prefetch), B=int(p.ack_batch),
        W=W, G=G, nGen=nGen, nSteps=nSteps, delay=delay, dlag=dlag,
        ring=d_egr, pools=tuple(pools))
    xs = dict(
        pub_valid=shift(valid, 0), pub_pr=shift(pr_mat, 0),
        pub_ci=shift(pub_ci, 0), pub_has_gate=shift(has_gate, 0),
        pub_conf_slot=shift(np.where(valid, conf_slot, W), 0),
        del_valid=shift(valid, 1 + dlag), del_q=shift(q_m, 1 + dlag),
        del_cnt_q=shift(cnt_q, 1 + dlag),
        del_cnt_c=shift(cnt_c, 1 + dlag),
        dly=np.arange(nSteps) % d_egr,
        dlyp=np.arange(nSteps) % (1 + dlag))
    xs["pub_conf_slot"][nGen:] = W      # drain steps hit the scratch slot
    if feedback:
        xs.update(rp_valid=shift(valid, 1 + delay),
                  rp_pr=shift(pr_mat, 1 + delay),
                  rp_cnt_p=shift(cnt_p, 1 + delay),
                  rd_valid=shift(valid, 2 + delay),
                  rd_pr=shift(pr_mat, 2 + delay))
    inv_arrays = dict(
        pub_tab=pub_tab, del_tab=del_tab, rp_tab=rp_tab, rd_tab=rd_tab,
        q_cons_tab=q_cons_tab, kq=kq, k_arr=k_arr, chain_base=chain_base,
        scal=np.array([arch.client_flush_s(),
                       arch.control_latency_s(),
                       sim._recv_latency(size),
                       sim._recv_latency(reply_size),
                       sim._proc_s]))
    sizes = dict(nP=nP, nC=nC, M=M, G=G, nGen=nGen, N=N, Np=Np, L=L,
                 n_jit=(4 if feedback else 2) * S_max + 1,
                 mem_id=mem_id, valid=valid)
    return WaveStatic(meta=meta, xs=xs, inv=inv_arrays, sizes=sizes)


def draw_jitter(sim: WaveCell, ws: WaveStatic) -> dict:
    """Per-lane jitter draws for every (generation, slot, member), from
    the cell's per-seed streams, in one flat draw per lane (so a lane's
    realization is independent of how many lanes are stacked), returned
    pre-shifted per pipeline leg."""
    s, m = ws.sizes, ws.meta
    j = sim.p.jitter
    raw = np.zeros((s["nGen"], s["n_jit"], s["Np"], s["L"]))
    if j:
        for lane, rng in enumerate(sim._rngs):
            raw[..., lane] = rng.uniform(
                -j, j, size=(s["nGen"], s["n_jit"], s["Np"]))
    nSteps = m["nSteps"]

    def shift(a: np.ndarray, by: int) -> np.ndarray:
        out = np.zeros((nSteps,) + a.shape[1:])
        out[by:by + s["nGen"]] = a
        return out

    S = m["S_max"]
    jit = dict(pub_jit=shift(raw[:, :S], 0),
               del_jit=shift(raw[:, S:2 * S], 1 + m["dlag"]),
               proc_jit=shift(raw[:, 2 * S], 1 + m["dlag"]))
    if m["feedback"]:
        jit["rp_jit"] = shift(raw[:, 2 * S + 1:3 * S + 1],
                              1 + m["delay"])
        jit["rd_jit"] = shift(raw[:, 3 * S + 1:], 2 + m["delay"])
    return jit


# ---------------------------------------------------------------------------
# Tensor ops over the member axis (dim 1; dim 0 is the cell axis)
# ---------------------------------------------------------------------------


def _take(x: torch.Tensor, *idx: torch.Tensor) -> torch.Tensor:
    """``x[c, idx[0][c], idx[1][c], ...]`` for every cell ``c``; trailing
    axes ride along."""
    ci = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[(ci,) + idx]


class _TorchOps:
    """The reference's backend ``ops`` namespace, in PyTorch, batched
    over a leading cell axis."""

    @staticmethod
    def lexsort(keys: tuple) -> torch.Tensor:
        """``np.lexsort`` along dim 1: stable sorts from the first key
        (least significant) to the last."""
        order = None
        for k in keys:
            kk = k.expand_as(keys[-1]) if order is None else _take(
                k.expand_as(keys[-1]), order)
            o = torch.argsort(kk, dim=1, stable=True)
            order = o if order is None else _take(order, o)
        return order

    @staticmethod
    def cummax(x: torch.Tensor) -> torch.Tensor:
        return torch.cummax(x, dim=1).values

    @staticmethod
    def seg_cummax(x: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
        """Running max along dim 1 that restarts where ``start`` is True:
        log-step doubling, each step guarded by the element's segment
        start index.  Max is exact, so no rounding enters."""
        n = x.shape[1]
        idx = torch.arange(n, device=x.device)
        seg = torch.cummax(torch.where(start, idx, 0), dim=1).values
        out = x
        d = 1
        while d < n:
            ok = (idx[d:] - d) >= seg[:, d:]
            if x.dim() > 2:
                ok = ok[..., None]
            tail = torch.where(ok, torch.maximum(out[:, d:], out[:, :-d]),
                               out[:, d:])
            out = torch.cat([out[:, :d], tail], dim=1)
            d *= 2
        return out

    @staticmethod
    def at_set(arr: torch.Tensor, idx: tuple, vals: torch.Tensor
               ) -> torch.Tensor:
        """``arr[c, *idx] = vals`` per cell, on a copy.  Duplicate
        indices occur only on dummy rows and slots no valid member
        reads."""
        out = arr.clone()
        ci = torch.arange(arr.shape[0], device=arr.device)[:, None]
        out[(ci,) + tuple(idx)] = vals
        return out

    @staticmethod
    def at_max(arr: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor
               ) -> torch.Tensor:
        """``np.maximum.at(arr[c], idx[c], vals[c])`` per cell."""
        index = idx[..., None].expand_as(vals)
        return arr.scatter_reduce(1, index, vals, "amax", include_self=True)


ops = _TorchOps


def _scatter(idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Zeros with ``out[c, idx[c]] = vals[c]``; ``idx`` a permutation."""
    shape = idx.shape + vals.shape[2:]
    return ops.at_set(torch.zeros(shape, dtype=vals.dtype,
                                  device=vals.device), (idx,), vals)


def _starts(key_sorted: torch.Tensor) -> torch.Tensor:
    first = torch.ones_like(key_sorted[:, :1], dtype=torch.bool)
    return torch.cat([first, key_sorted[:, 1:] != key_sorted[:, :-1]], 1)


def _ends(start: torch.Tensor) -> torch.Tensor:
    return torch.cat([start[:, 1:], torch.ones_like(start[:, :1])], 1)


# ---------------------------------------------------------------------------
# The wave program
# ---------------------------------------------------------------------------


def _serve_leg(free: torch.Tensor, a: torch.Tensor, hold: torch.Tensor,
               kind: torch.Tensor, rid: torch.Tensor, lat: torch.Tensor,
               valid: torch.Tensor, side: torch.Tensor, meta: dict,
               pool_rows: torch.Tensor, pool_id: torch.Tensor,
               chain_base: torch.Tensor, k_arr: torch.Tensor) -> tuple:
    """FIFO-serve one aligned path slot for all members: segmented
    closed-form scans over (resource chain)-grouped members, with
    earliest-free pool server interleaving and cross-generation carries.

    ``free``: ``(C, 2*NCH+1, L)`` per-chain busy-until carries, one copy
    per traffic direction (``side`` 0 ingress-bound, 1 egress-bound);
    the last row is the dummy chain of latency-only/invalid members.
    Returns ``(free', t_out)``."""
    NCH, NR = meta["NCH"], meta["NR"]
    dummy = 2 * NCH
    dev = a.device
    M = a.shape[1]
    idx = torch.arange(M, device=dev)
    is_res = (kind > 0) & valid
    pilot = torch.where(is_res, a[..., 0], _INF)
    # latency-only / invalid members get unique singleton chains past
    # the resource id space so the segmented scan leaves them alone
    rid_key = torch.where(is_res, rid + side * NR, 2 * NR + idx)
    # pool-carry ordering: each pool's carries sorted by the pilot lane
    # ascending (earliest-free server first), all pools in one sort
    if pool_rows.numel():
        sub = free[:, pool_rows]
        order = ops.lexsort((torch.arange(pool_rows.numel(), device=dev),
                             sub[..., 0], pool_id))
        free = free.clone()
        free[:, pool_rows] = _take(sub, order)
    # stage 1: group by (resource, direction), pilot-arrival order
    o1 = ops.lexsort((idx, pilot, rid_key))
    rk1 = _take(rid_key, o1)
    start1 = _starts(rk1)
    segfirst = ops.cummax(torch.where(start1, idx, -1))
    pos = idx - segfirst
    ridc = _take(rid, o1).clamp(0, NR - 1)
    res1 = _take(is_res, o1)
    k1 = _take(k_arr, ridc)
    server = torch.where(res1, pos % k1, 0)
    chain = torch.where(res1, _take(chain_base, ridc) + server
                        + _take(side.expand_as(o1), o1) * NCH, dummy)
    chain_key = torch.where(res1, chain, dummy + 1 + idx)
    # stage 2: make each chain contiguous, preserving pilot order
    o2 = ops.lexsort((idx, chain_key))
    perm = _take(o1, o2)
    a2, chain2, chkey2 = _take(a, perm), _take(chain, o2), _take(chain_key, o2)
    h2 = _take(hold, perm)
    res2 = _take(is_res, perm)
    start2 = _starts(chkey2)
    carry = _take(free, chain2)
    a_eff = torch.where(res2[..., None], torch.maximum(a2, carry), a2)
    # segmented FIFO closed form: e = H + segcummax(a - (H - h))
    c = torch.cumsum(h2, dim=1)
    basefill = ops.cummax(torch.where(start2[..., None], c - h2, -_INF))
    Hs = c - basefill
    e2 = Hs + ops.seg_cummax(a_eff - (Hs - h2), start2)
    free = ops.at_max(free, torch.where(res2, chain2, dummy), e2)
    t_out = _scatter(perm, e2 + _take(lat, perm)[..., None])
    return free, t_out


def _transit(free: torch.Tensor, t: torch.Tensor, slots: torch.Tensor,
             jit: torch.Tensor, valid: torch.Tensor, side: torch.Tensor,
             meta: dict, statics: dict) -> tuple:
    """Walk members through an aligned path: ``slots`` is
    ``(C, M, S, 4)`` rows of (kind, rid, hold_base, lat), ``jit`` is
    ``(C, S, M, L)``."""
    for s in range(slots.shape[2]):
        kind = slots[:, :, s, 0].long()
        rid = slots[:, :, s, 1].long()
        hold = torch.where((kind > 0) & valid, slots[:, :, s, 2],
                           0.0)[..., None] * (1.0 + jit[:, s])
        free, t = _serve_leg(free, t, hold, kind, rid, slots[:, :, s, 3],
                             valid, side, meta, statics["pool_rows"],
                             statics["pool_id"], statics["chain_base"],
                             statics["k_arr"])
    return free, t


def _next_boundary(boundary: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Index of the nearest boundary at or after each position within
    its segment (exists: segment ends are always boundaries)."""
    idx = torch.arange(boundary.shape[1], device=boundary.device)
    r = torch.flip(torch.where(boundary, idx, _IBIG), [1])
    nb_rev = -ops.seg_cummax(-r, torch.flip(_ends(start), [1]))
    return torch.flip(nb_rev, [1])


def _seg_pos(key_sorted: torch.Tensor) -> tuple:
    """(segment-start flags, position within segment) for a sorted
    integer key array."""
    idx = torch.arange(key_sorted.shape[1], device=key_sorted.device)
    start = _starts(key_sorted)
    return start, idx - ops.cummax(torch.where(start, idx, -1))


def _pump(ring: torch.Tensor, t: torch.Tensor, gid: torch.Tensor,
          idx_on: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The pump kernel over all cells at once: cells fold into the
    member axis, each cell's ring rows offset by ``c * R``."""
    C, R = ring.shape[:2]
    Np = t.shape[1]
    off = (torch.arange(C, device=gid.device) * R)[:, None]
    out = pump_assign(ring.reshape(C * R, *ring.shape[2:]),
                      t.reshape(C * Np, -1).contiguous(),
                      (gid + off).reshape(-1), idx_on.reshape(-1).contiguous(),
                      valid.reshape(-1).contiguous())
    return out.reshape(t.shape)


def _wave_step(meta: dict, inv: dict, statics: dict, carry: dict, x: dict,
               dly: int, dlyp: int) -> tuple[dict, dict]:
    """One *pipelined* step: publish generation ``g``, deliver ``g-1``
    and, with feedback, reply-publish ``g-1-delay`` and reply-deliver
    ``g-2-delay``.  All legs' arrivals are known at step entry, so their
    transits run as ONE combined serve over a concatenated member axis.
    ``dly``/``dlyp`` are the host-side delay-line slots of this step."""
    Np, P, B = meta["Np"], meta["P"], meta["B"]
    nC, nP, nq, fb = meta["nC"], meta["nP"], meta["nq"], meta["feedback"]
    sc = inv["scal"][:, :, None, None]           # (C, 5, 1, 1)
    flush, ctrl, recv_req, recv_rep = (sc[:, i] for i in range(4))
    proc_s = inv["scal"][:, 4:5]                 # (C, 1)
    dev = carry["free"].device
    idx = torch.arange(Np, device=dev)

    # ---- per-leg arrivals (all independent at step entry) -------------
    # publish(g): confirm-window admission gates + client flush
    v_pub, pr = x["pub_valid"], x["pub_pr"]
    gate = _take(carry["conf"], pr, x["pub_conf_slot"])
    gate = torch.where(x["pub_has_gate"][..., None], gate, 0.0)
    pub_start = torch.where(v_pub[..., None], gate + flush, _INF)

    # delivery(g-1): pump window assignment — per-queue arrival-order
    # round robin with prefetch-ring gates (the hand-written kernel)
    v_del, q = x["del_valid"], x["del_q"]
    t_enq_prev = carry["pend_pub"]["t_enq"][:, dlyp]
    pub_start_prev = carry["pend_pub"]["pub_start"][:, dlyp]
    oq = ops.lexsort((idx, torch.where(v_del, t_enq_prev[..., 0], _INF),
                      torch.where(v_del, q, nq)))
    q_s = _take(q, oq)
    _, posq = _seg_pos(torch.where(_take(v_del, oq), q_s, nq))
    qc = q_s.clamp(0, nq - 1)
    kqv = _take(inv["kq"], qc)
    slot_c = (_take(x["del_cnt_q"], qc) + posq) % kqv
    cons_s = _take(inv["q_cons_tab"], qc, slot_c)
    idx_on_c = _take(x["del_cnt_c"], cons_s) + posq // kqv
    depart_s = _pump(carry["ack"], _take(t_enq_prev, oq), cons_s, idx_on_c,
                     _take(v_del, oq))
    cons = _scatter(oq, cons_s)
    idxc = _scatter(oq, idx_on_c)
    slotc = _scatter(oq, slot_c)
    depart = torch.where(v_del[..., None], _scatter(oq, depart_s), _INF)

    # ---- combined transit: all legs, one serve per aligned slot -------
    blocks = [
        (pub_start, v_pub, _take(inv["pub_tab"], x["pub_ci"]), x["pub_jit"]),
        (depart, v_del, _take(inv["del_tab"], q, slotc), x["del_jit"]),
    ]
    if fb:
        # the delivery->reply delay line: slot ``dly`` holds the entry
        # written ``ring`` steps ago
        pend_b = {k: v[:, dly] for k, v in carry["pend_del"].items()}
        pend_c = carry["pend_rep"]
        v_rp, rp_pr = x["rp_valid"], x["rp_pr"]
        v_rd, rd_pr = x["rd_valid"], x["rd_pr"]
        blocks.append(
            (pend_b["seen"], v_rp,
             _take(inv["rp_tab"], pend_b["cons"].clamp(0, nC - 1), rp_pr),
             x["rp_jit"]))
        blocks.append(
            (pend_c["rdep"], v_rd, _take(inv["rd_tab"], rd_pr), x["rd_jit"]))
    a_c = torch.cat([b[0] for b in blocks], dim=1)
    v_c = torch.cat([b[1] for b in blocks], dim=1)
    slots_c = torch.cat([b[2] for b in blocks], dim=1)
    jit_c = torch.cat([b[3] for b in blocks], dim=2)
    free, t_c = _transit(carry["free"], a_c, slots_c, jit_c, v_c,
                         statics["side"], meta, statics)
    t_enq = t_c[:, :Np]
    t_land = t_c[:, Np:2 * Np]

    # ---- publish(g) epilogue: confirms feed the admission ring --------
    confirms = t_enq + ctrl
    conf = ops.at_set(carry["conf"], (pr, x["pub_conf_slot"]), confirms)

    # ---- delivery(g-1) epilogue: consumer processing + batched acks ---
    a = t_land + recv_req
    h = torch.where(v_del, proc_s, 0.0)[..., None] * (1.0 + x["proc_jit"])
    ch = torch.where(v_del, cons, nC)
    oc = ops.lexsort((idx, torch.where(v_del, a[..., 0], _INF), ch))
    ch_s = _take(ch, oc)
    start_c, posc = _seg_pos(ch_s)
    carry_pf = _take(carry["proc"], ch_s)
    a_s = _take(a, oc)
    a_eff = torch.where((ch_s < nC)[..., None],
                        torch.maximum(a_s, carry_pf), a_s)
    h_s = _take(h, oc)
    c = torch.cumsum(h_s, dim=1)
    basefill = ops.cummax(torch.where(start_c[..., None], c - h_s, -_INF))
    Hs = c - basefill
    seen_s = Hs + ops.seg_cummax(a_eff - (Hs - h_s), start_c)
    proc = ops.at_max(carry["proc"], ch_s, seen_s)
    seen = torch.where(v_del[..., None], _scatter(oc, seen_s), _INF)
    # acks: batch every B in processing order, force-flush at
    # generation end; invalid members route to the dummy ring row nC
    boundary = (((posc + 1) % B) == 0) | _ends(start_c)
    nb = _next_boundary(boundary | (ch_s >= nC), start_c)
    ack = ops.at_set(carry["ack"], (ch_s, _take(idxc, oc) % P),
                     _take(seen_s, nb) + ctrl)

    ys = dict(pub_start=pub_start, confirms=confirms, depart=depart,
              seen=seen)
    pend_pub = {k: v.clone() for k, v in carry["pend_pub"].items()}
    pend_pub["t_enq"][:, dlyp] = t_enq
    pend_pub["pub_start"][:, dlyp] = pub_start
    carry = dict(carry, free=free, conf=conf, proc=proc, ack=ack,
                 pend_pub=pend_pub)
    if not fb:
        ys["rtt"] = torch.full_like(seen, _INF)
        return carry, ys

    # ---- reply-publish epilogue: per-producer reply pump --------------
    t_renq = t_c[:, 2 * Np:3 * Np]
    pch = torch.where(v_rp, rp_pr, nP)
    opr = ops.lexsort((idx, torch.where(v_rp, t_renq[..., 0], _INF), pch))
    pr_s = _take(pch, opr)
    _, posp = _seg_pos(pr_s)
    idx_on_p = _take(x["rp_cnt_p"], pr_s) + posp
    rdep_s = _pump(carry["prep"], _take(t_renq, opr), pr_s, idx_on_p,
                   _take(v_rp, opr))
    rdep = torch.where(v_rp[..., None], _scatter(opr, rdep_s), _INF)
    idxp = _scatter(opr, idx_on_p)

    # ---- reply-delivery epilogue: RTTs + producer ack batching --------
    t_seen = t_c[:, 3 * Np:] + recv_rep
    rtt = torch.where(v_rd[..., None], t_seen - pend_c["pub_start"], _INF)
    pch_d = torch.where(v_rd, rd_pr, nP)
    opd = ops.lexsort((idx, torch.where(v_rd, t_seen[..., 0], _INF), pch_d))
    pd_s = _take(pch_d, opd)
    start_p, posd = _seg_pos(pd_s)
    boundary = (((posd + 1) % B) == 0) | _ends(start_p)
    nb = _next_boundary(boundary | (pd_s >= nP), start_p)
    prep = ops.at_set(carry["prep"],
                      (pd_s, _take(pend_c["idx_on_p"], opd) % P),
                      _take(_take(t_seen, opd), nb) + ctrl)

    ys["rtt"] = rtt
    new_b = dict(seen=seen, cons=cons, pub_start=pub_start_prev)
    pend_del = {k: v.clone() for k, v in carry["pend_del"].items()}
    for k, v in new_b.items():
        pend_del[k][:, dly] = v
    carry = dict(carry, prep=prep, pend_del=pend_del,
                 pend_rep=dict(rdep=rdep, idx_on_p=idxp,
                               pub_start=pend_b["pub_start"]))
    return carry, ys


def _init_carry(meta: dict, C: int, device: torch.device) -> dict:
    # trailing dummy rows/slots absorb the masked writes of invalid
    # pad members: conf slot W, ack row nC, proc row nC, prep row nP
    L, Np = meta["L"], meta["Np"]

    def z(*shape: int, dtype: torch.dtype = torch.float64) -> torch.Tensor:
        return torch.zeros((C,) + shape, dtype=dtype, device=device)

    return dict(
        free=z(2 * meta["NCH"] + 1, L),
        conf=z(meta["nP"], meta["W"] + 1, L),
        ack=z(meta["nC"] + 1, meta["P"], L),
        proc=z(meta["nC"] + 1, L),
        prep=z(meta["nP"] + 1, meta["P"], L),
        # delay-line rings: publish->delivery trails by 1+dlag steps,
        # delivery->reply-publish by ``ring`` steps; slot = step % len
        pend_pub=dict(t_enq=z(1 + meta["dlag"], Np, L),
                      pub_start=z(1 + meta["dlag"], Np, L)),
        pend_del=dict(seen=z(meta["ring"], Np, L),
                      cons=z(meta["ring"], Np, dtype=torch.int64),
                      pub_start=z(meta["ring"], Np, L)),
        pend_rep=dict(rdep=z(Np, L),
                      idx_on_p=z(Np, dtype=torch.int64),
                      pub_start=z(Np, L)))


# ---------------------------------------------------------------------------
# Carry-over and the run loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TorchStatic:
    """A static schedule on the device: ``xs`` tensors lead with the step
    axis then the cell axis, ``inv`` tensors with the cell axis; the
    delay-line slots ``dly``/``dlyp`` stay host integers."""

    meta: dict
    xs: dict
    inv: dict
    dly: np.ndarray
    dlyp: np.ndarray

    @property
    def n_cells(self) -> int:
        return int(next(iter(self.inv.values())).shape[0])


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.is_floating_point() and t.dtype != torch.float64:
        raise TypeError(f"expected float64 arrays, got {t.dtype}")
    return t.to(device)


def static_to_torch(meta: dict, xs: dict, inv: dict, jitter: dict,
                    device: "torch.device | str") -> TorchStatic:
    """Carry one cell's static schedule (the NumPy arrays of a
    :class:`WaveStatic`, built by this package or by the reference) and
    its jitter draws over to tensors on ``device``, with a cell axis of
    length 1."""
    device = torch.device(device)
    xs = dict(xs, **jitter)
    return TorchStatic(
        meta=dict(meta),
        xs={k: _tensor(v[:, None], device) for k, v in xs.items()
            if k not in ("dly", "dlyp")},
        inv={k: _tensor(v[None], device) for k, v in inv.items()},
        dly=np.asarray(xs["dly"]), dlyp=np.asarray(xs["dlyp"]))


def _cat_cells(cells: list) -> TorchStatic:
    t0 = cells[0]
    return TorchStatic(
        meta=t0.meta,
        xs={k: torch.cat([t.xs[k] for t in cells], dim=1) for k in t0.xs},
        inv={k: torch.cat([t.inv[k] for t in cells], dim=0) for k in t0.inv},
        dly=t0.dly, dlyp=t0.dlyp)


def _statics(meta: dict, C: int, device: torch.device) -> dict:
    """Step-invariant index tensors derived from ``meta``."""
    Np, NCH = meta["Np"], meta["NCH"]
    rows, pid = [], []
    for p_i, (b, kk) in enumerate(meta["pools"]):
        for d, off in enumerate((0, NCH)):
            rows.extend(range(b + off, b + off + kk))
            pid.extend([2 * p_i + d] * kk)
    sides = (0, 1, 0, 1) if meta["feedback"] else (0, 1)
    return dict(
        pool_rows=torch.tensor(rows, dtype=torch.int64, device=device),
        pool_id=torch.tensor(pid, dtype=torch.int64, device=device)[None]
        .expand(C, -1),
        side=torch.repeat_interleave(
            torch.tensor(sides, dtype=torch.int64, device=device), Np)[None])


def run_program(ts: TorchStatic) -> dict:
    """Run the wave program over all cells of ``ts``; returns the trace
    ``{pub_start, confirms, depart, seen, rtt}`` as tensors of shape
    ``(nSteps, C, Np, L)`` on the schedule's device."""
    meta = ts.meta
    device = ts.inv["scal"].device
    C = ts.n_cells
    statics = _statics(meta, C, device)
    statics.update(chain_base=ts.inv["chain_base"], k_arr=ts.inv["k_arr"])
    carry = _init_carry(meta, C, device)
    ys_all: dict = {}
    for g in range(meta["nSteps"]):
        x = {k: v[g] for k, v in ts.xs.items()}
        carry, ys = _wave_step(meta, ts.inv, statics, carry, x,
                               int(ts.dly[g]), int(ts.dlyp[g]))
        for k, v in ys.items():
            ys_all.setdefault(k, []).append(v)
    return {k: torch.stack(v) for k, v in ys_all.items()}


def run_wave_trace(ws: WaveStatic, jitter: dict,
                   device: "torch.device | str" = "cuda") -> dict:
    """Run one cell's wave program, returning the full per-step trace
    ``{pub_start, confirms, depart, seen, rtt}`` as NumPy arrays with
    leading axis ``nSteps`` — the step-for-step comparison surface
    against the reference's NumPy oracle."""
    ts = static_to_torch(ws.meta, ws.xs, ws.inv, jitter,
                         resolve_device(device))
    return {k: v[:, 0].cpu().numpy() for k, v in run_program(ts).items()}


# ---------------------------------------------------------------------------
# Result assembly + entry points
# ---------------------------------------------------------------------------


def _assemble(sim: WaveCell, ws: WaveStatic, ys: dict) -> list:
    """Per-lane RunResults from the generation trace, through the
    cell's ``_result`` contract."""
    s = ws.sizes
    nP, M, L, nGen = s["nP"], s["M"], s["L"], s["nGen"]
    mem = s["mem_id"].ravel()
    valid = s["valid"].ravel()
    lanes = () if L == 1 else (L,)
    consume_t = np.full((nP * M,) + lanes, np.nan)
    rtts = (np.full((nP * M,) + lanes, np.nan)
            if ws.meta["feedback"] else None)
    pub = np.zeros((nP * M,) + lanes)
    # de-stagger the pipelined trace
    a0 = 1 + ws.meta["dlag"]
    seen = ys["seen"][a0:nGen + a0].reshape(-1, L)[valid]
    consume_t[mem[valid]] = (seen if lanes else seen[:, 0])
    ps = ys["pub_start"][:nGen].reshape(-1, L)[valid]
    pub[mem[valid]] = (ps if lanes else ps[:, 0])
    if rtts is not None:
        d = 2 + ws.meta["delay"]
        rv = ys["rtt"][d:nGen + d].reshape(-1, L)[valid]
        rtts[mem[valid]] = (rv if lanes else rv[:, 0])
    sim.n_events = int(valid.sum()) * max(
        1, ws.meta["S_pub"] + ws.meta["S_del"]
        + ws.meta["S_rp"] + ws.meta["S_rd"])
    results = []
    for lane, seed in enumerate(sim.stack_seeds):
        lane_spec = dataclasses.replace(
            sim.spec, params=dataclasses.replace(sim.p, seed=seed))
        sel = (slice(None),) if L == 1 else (slice(None), lane)
        results.append(sim._result(
            lane_spec, consume_t[sel],
            rtts[sel] if rtts is not None else None, pub[sel]))
    return results


def run_wave_results(sim: WaveCell,
                     device: "torch.device | str" = "cuda") -> list:
    """Whole-run execution of one (possibly lane-stacked) cell; one
    RunResult per stacked seed-lane."""
    ws = build_static(sim)
    return _assemble(sim, ws, run_wave_trace(ws, draw_jitter(sim, ws),
                                             device))


def run_wave_cells(sims: list, device: "torch.device | str" = "cuda") -> list:
    """Batch structurally identical cells (same
    :meth:`WaveStatic.signature`) on the cell axis of one program, the
    cell axis padded to a power of two by replicating cell 0 (the pads'
    results are dropped).  Returns, per sim, its per-lane RunResults."""
    device = resolve_device(device)
    built = [(sim, build_static(sim)) for sim in sims]
    out: list = [None] * len(sims)
    groups: dict = {}
    for i, (sim, ws) in enumerate(built):
        groups.setdefault(ws.signature(), []).append(i)
    for idxs in groups.values():
        C = len(idxs)
        cells = idxs + [idxs[0]] * ((1 << max(0, C - 1).bit_length()) - C)
        ts = _cat_cells([
            static_to_torch(built[i][1].meta, built[i][1].xs,
                            built[i][1].inv,
                            draw_jitter(*built[i]), device)
            for i in cells])
        ys = {k: v.cpu().numpy() for k, v in run_program(ts).items()}
        for c, i in enumerate(idxs):
            sim, ws = built[i]
            out[i] = _assemble(sim, ws, {k: v[:, c] for k, v in ys.items()})
    return out

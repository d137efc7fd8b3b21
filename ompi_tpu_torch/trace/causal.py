"""Cross-rank causal tracing — "why was this collective slow".

Port of ``ompi_tpu/trace/causal.py``, unchanged in its wire context,
record layout and solver, so causal records of the two packages join
in one solve.  With ``--mca trace_causal 1`` every collective records a
per-rank **causal record** (arrival/exit, every schedule send/recv with
its hop index and measured wait, and the transport stall deltas inside
the op) and stamps a compact **wire context** on the frames it sends;
wherever records from every rank meet (the merged Chrome trace, the
finalize JSONL exports) the solver builds the per-collective causal
DAG, walks its critical path and splits the makespan into
``(rank, cause)`` segments.

Wire context (the propagated half)
----------------------------------

A compact versioned tuple stamped per frame, gated off by default
(zero wire bytes, zero hot-path work when disabled)::

    [v, comm, op, seq, hop]        # CTX_FIELDS — append-only, v1 frozen

* ``v`` — context version (:data:`CTX_VERSION`);
* ``comm``/``op``/``seq`` — the root span identity: the collective's
  cross-rank merge key (the per-(comm, op) issue counter);
* ``hop`` — the sender's per-op send index; together with the frame's
  ``src`` it names exactly one edge of the schedule DAG.

Vehicle per plane: the Python framed-TCP envelope carries it as the
``tc`` key; the native plane rides the frame's meta-JSON region under
the same key (``WireHdr`` stays frozen at 72 bytes, so a disabled run's
frames are byte-identical to a build without this module).  The field
table is mirrored in C (``TDCN_TRACE_CTX_FIELDS`` in ``csrc/dcn.cc``).

Causal DAG + critical path (the solver half)
--------------------------------------------

One collective instance across ranks normalizes to::

    {"op": .., "alg": .., "ranks": {rank: {
        "arrive": ns, "exit": ns,
        "sends": [[hop, ts_ns, dst], ...],
        "recvs": [[src, hop, ts_ns, wait_ns], ...],
        "stalls": {"ring": ns, "cts": ns, "dma": ns}}}}

Edges: a recv depends on its matched remote send ``(src, hop)``;
everything else chains locally in timestamp order.  The critical path
is the backward walk from the last exit: a recv that measurably
*waited* for a send issued after the receiver was ready jumps to the
sender; all other constraints are local.  Each on-path span is charged
to a ``(rank, cause)`` bucket:

* ``arrival-skew`` — the path bottomed out at a rank that entered the
  collective after the earliest rank (the straggler signal, placed on
  the path);
* ``transport`` — wire/delivery time between a matched send and its
  recv completion, charged to the receiving rank's link;
* ``dma-wait`` / ``ring-backpressure`` / ``cts-wait`` — the stall
  counters' deltas inside the op, carved out of the raw
  transport/compute buckets they occurred in (``dma`` stays 0 in the
  port: it has no device plane);
* ``compute`` — the local residual.

``dominant_of`` names the headline ``(rank, cause)``: the rank with
the most on-path time, then its largest bucket — with a near-tie
preference for the *upstream* cause (:data:`CAUSE_PRIORITY`, within
:data:`TIE_FACTOR`).

Everything below the recording hooks is stdlib-only.
"""

from __future__ import annotations

import collections
import threading
import time

from ompi_tpu_torch.trace import core as _trace

#: the in-path gate — hooks read this attribute directly (the SPC
#: pattern every gated subsystem here follows)
_enabled = False

#: wire-context version + field table — APPEND-ONLY, v1 prefix frozen
#: (mirrored by TDCN_TRACE_CTX_FIELDS in csrc/dcn.cc)
CTX_VERSION = 1
CTX_FIELDS = ("v", "comm", "op", "seq", "hop")

#: pvar tails: trace_causal_<name> (tool/mpit.py exposes them; the
#: finalize .prom renders ompi_tpu_trace_causal_<name>)
PVARS = ("records", "sends", "recvs", "dropped")

#: completed-record ring bound (the straggler _RECENT_CAP discipline:
#: a long job cannot grow it; evictions count as ``dropped``)
_RECENT_CAP = 256

#: cause taxonomy, ordered by *upstream-ness* — the near-tie
#: preference order of :func:`dominant_of`
CAUSE_PRIORITY = ("arrival-skew", "dma-wait", "ring-backpressure",
                  "cts-wait", "transport", "compute")

#: two buckets within this factor of each other count as a near-tie
#: and resolve by CAUSE_PRIORITY (see dominant_of)
TIE_FACTOR = 1.25

_lock = threading.Lock()
_counters: dict[str, int] = {k: 0 for k in PVARS}
#: completed records queued for the live publisher (drained per frame)
#: and the retained ring (the finalize export's view, never drained)
_records: collections.deque = collections.deque(maxlen=_RECENT_CAP)
_retained: collections.deque = collections.deque(maxlen=_RECENT_CAP)
_tls = threading.local()


class _OpCtx:
    """Thread-local state of the collective currently in flight."""

    __slots__ = ("comm", "op", "seq", "arrive", "hop", "sends", "recvs",
                 "base")

    def __init__(self, comm: str, op: str, seq: int, base: dict):
        self.comm = comm
        self.op = op
        self.seq = seq
        self.arrive = time.time_ns()
        self.hop = 0
        self.sends: list[list] = []
        self.recvs: list[list] = []
        self.base = base


def enabled() -> bool:
    return _enabled


def enable(flag: bool = True) -> None:
    global _enabled
    _enabled = flag


def sync_from_store(store) -> None:
    """Armed by ``--mca trace_causal 1``.  Implies the tracer: the
    offline critical-path report reads the causal events out of the
    Chrome trace files, so a causal run without the ring would leave
    the live endpoint as its only cross-rank surface."""
    on = bool(store.get("trace_causal", False))
    enable(on)
    if on and not _trace.enabled():
        _trace.enable(True)


def reset() -> None:
    """Test hook: drop all state (counters, records, thread context)."""
    global _enabled
    with _lock:
        for k in _counters:
            _counters[k] = 0
        _records.clear()
        _retained.clear()
        _seqs.clear()
        _enabled = False
    _tls.op = None


# -- pvar surface --------------------------------------------------------


def counter(name: str) -> int:
    return _counters.get(name, 0)


def counters_snapshot() -> dict[str, int]:
    return dict(_counters)


def zero_counters() -> None:
    """pvar_reset: zero the trace_causal_* counters in place (names
    survive — the fixed-segment index-stability contract)."""
    with _lock:
        for k in _counters:
            _counters[k] = 0


def reset_counter(name: str) -> None:
    with _lock:
        if name in _counters:
            _counters[name] = 0


# -- recording hooks (every caller gates on ``_enabled``) ----------------


def _stall_snapshot() -> dict:
    """Rank-local stall-cause counters at this instant — the
    decomposition sources, sampled per op only while causal tracing is
    armed (one provider sweep; the merge works with metrics disabled
    because transports register providers unconditionally)."""
    from ompi_tpu_torch.metrics import core as _mcore

    n = _mcore.native_counters()
    return {
        "ring": int(n.get("ring_stall_ns", 0)),
        "cts": int(n.get("cts_wait_ns", 0)),
        "dma": int(n.get("device_dma_wait_ns", 0)),
    }


def begin_op(comm: str, op: str, seq: int) -> None:
    """Collective entry (the api-dispatch wrap): open the thread-local
    op context every in-op send/recv hook attaches to."""
    _tls.op = _OpCtx(str(comm), str(op), int(seq), _stall_snapshot())


def end_op(alg: str = "") -> None:
    """Collective exit: close the context into one causal record."""
    ctx = getattr(_tls, "op", None)
    _tls.op = None
    if ctx is None:
        return
    exit_ns = time.time_ns()
    now = _stall_snapshot()
    stalls = {k: max(0, now[k] - ctx.base.get(k, 0)) for k in now}
    if not alg:
        # the coll dispatch's winning component, when the straggler
        # plane noted it (a plain dict read — no gating concern)
        from ompi_tpu_torch.metrics import straggler as _straggler

        alg = _straggler._providers.get(ctx.op, "")
    key = f"{ctx.comm}/{ctx.op}/{ctx.seq}"
    row = [key, int(ctx.arrive), int(exit_ns), str(alg),
           ctx.sends, ctx.recvs, stalls]
    with _lock:
        if len(_records) == _records.maxlen:
            _counters["dropped"] += 1
        _records.append(row)
        _retained.append(row)
        _counters["records"] += 1
    if _trace._enabled:
        # the offline leg: one complete event carrying the record's
        # scalar half (sends/recvs were emitted live as cx instants)
        _trace.complete(
            "causal", "cx_op",
            _trace.now() - max(0, exit_ns - ctx.arrive),
            comm=ctx.comm, op=ctx.op, seq=ctx.seq, alg=alg,
            ring_us=stalls["ring"] // 1000, cts_us=stalls["cts"] // 1000,
            dma_us=stalls["dma"] // 1000)


def current_key() -> str | None:
    """``comm/op/seq`` of the collective in flight on this thread (the
    device plane stamps it on staged windows so a leak reclaim can
    name the op that opened the window); None outside a collective."""
    ctx = getattr(_tls, "op", None)
    return f"{ctx.comm}/{ctx.op}/{ctx.seq}" if ctx is not None else None


def note_send(dst: int) -> list | None:
    """One schedule send to root proc ``dst``: allocate the hop index,
    record the edge tail, return the wire context to stamp on the
    frame — or None outside a collective (p2p / recovery streams stay
    unstamped by design)."""
    ctx = getattr(_tls, "op", None)
    if ctx is None:
        return None
    hop = ctx.hop
    ctx.hop = hop + 1
    t = time.time_ns()
    ctx.sends.append([hop, t, int(dst)])
    with _lock:
        _counters["sends"] += 1
    if _trace._enabled:
        _trace.instant("causal", "cx_send", comm=ctx.comm, op=ctx.op,
                       seq=ctx.seq, hop=hop, dst=int(dst))
    return [CTX_VERSION, ctx.comm, ctx.op, ctx.seq, hop]


def note_recv(src: int, tc, wait_ns: int) -> None:
    """One delivered frame carrying a wire context: record the edge
    head (the sender's hop names the matched send) with the measured
    recv-side wait."""
    if not isinstance(tc, (list, tuple)) or len(tc) < len(CTX_FIELDS):
        return
    if int(tc[0]) != CTX_VERSION:
        return  # unknown context version: never guess at field meaning
    ctx = getattr(_tls, "op", None)
    if ctx is None:
        return  # a frame consumed outside any collective (drain paths)
    t = time.time_ns()
    ctx.recvs.append([int(src), int(tc[4]), t, max(0, int(wait_ns))])
    with _lock:
        _counters["recvs"] += 1
    if _trace._enabled:
        _trace.instant("causal", "cx_recv", comm=str(tc[1]), op=str(tc[2]),
                       seq=int(tc[3]), hop=int(tc[4]), src=int(src),
                       wait_us=max(0, int(wait_ns)) // 1000)


def wrap_call(op: str, fn, comm: str = ""):
    """Closure opening/closing the op context around each call — the
    api dispatch hook (innermost of the trace/straggler wraps, so its
    arrival is the closest to first traffic)."""

    def causal_wrapped(*a, **k):
        begin_op(comm, op, _next_seq(comm, op))
        try:
            return fn(*a, **k)
        finally:
            end_op()

    causal_wrapped.__name__ = f"causal_{op}"
    causal_wrapped.__wrapped__ = fn
    return causal_wrapped


_seqs: dict[tuple[str, str], int] = {}


def _next_seq(comm: str, op: str) -> int:
    """Per-(comm, op) issue counter — identical on every rank (MPI
    same-issue-order), the cross-rank instance key.  Module-local by
    design, like the straggler profiler's: the causal join happens
    entirely among causal records/events, so only CROSS-RANK agreement
    matters, and that holds from issue order alone.  Numeric alignment
    with the trace-span seqs of the same collectives additionally
    holds on the MCA path (both planes armed together at init; causal
    implies trace) but is NOT guaranteed if one plane is toggled
    mid-run through the test/MPI_T surface — don't cross-reference
    seqs between the two event families after a mid-run toggle."""
    key = (comm, op)
    with _lock:
        s = _seqs.get(key, 0)
        _seqs[key] = s + 1
        return s


# -- record access (publisher / finalize export / tests) -----------------


def drain_recent() -> list[list]:
    """Pop every queued causal record — one consumer, the telemetry
    publisher (the live /critical feed)."""
    out = []
    with _lock:
        while _records:
            out.append(_records.popleft())
    return out


def recent() -> list[list]:
    """Non-destructive view of the retained ring (the finalize JSONL
    export: the offline cross-rank join's per-rank input)."""
    with _lock:
        return [list(r) for r in _retained]


# =======================================================================
# the solver — stdlib-only from here down
# =======================================================================


def _blank_rank() -> dict:
    return {"arrive": 0, "exit": 0, "sends": [], "recvs": [],
            "stalls": {}}


def instances_from_records(records_by_proc: dict,
                           offsets_ns: dict | None = None) -> dict:
    """Normalize per-rank causal records (``recent``
    rows, or the ``causal`` section of finalize JSONL snapshots) into
    instances keyed ``comm/op/seq``.  ``offsets_ns[proc]`` (peer_clock
    − reference_clock, the handshake estimate) aligns every timestamp
    before cross-rank comparison."""
    offsets_ns = offsets_ns or {}
    out: dict[str, dict] = {}
    for proc, rows in records_by_proc.items():
        off = int(offsets_ns.get(proc, 0))
        for row in rows or ():
            key = str(row[0])
            inst = out.setdefault(key, {
                "key": key,
                "op": key.split("/")[-2] if key.count("/") >= 2 else key,
                "alg": "", "ranks": {}})
            alg = str(row[3]) if len(row) > 3 else ""
            if alg and not inst["alg"]:
                inst["alg"] = alg
            st = _blank_rank()
            st["arrive"] = int(row[1]) - off
            st["exit"] = int(row[2]) - off
            st["sends"] = [[int(h), int(t) - off, int(d)]
                           for h, t, d in (row[4] if len(row) > 4 else ())]
            st["recvs"] = [[int(s), int(h), int(t) - off, int(w)]
                           for s, h, t, w in (row[5] if len(row) > 5 else ())]
            st["stalls"] = dict(row[6]) if len(row) > 6 and row[6] else {}
            inst["ranks"][int(proc)] = st
    return out


def instances_from_chrome(doc: dict) -> dict:
    """Normalize a (merged) Chrome trace's ``causal``-layer events into
    instances — the ``trace_report.py --critical-path`` input.  Event
    ``ts`` are the export's wall-anchored microseconds; ranks are the
    Chrome pids the merge preserved."""
    out: dict[str, dict] = {}

    def _rank_state(args: dict, pid: int) -> tuple[dict, dict]:
        key = f"{args.get('comm', '')}/{args.get('op', '')}/" \
              f"{int(args.get('seq', -1))}"
        inst = out.setdefault(key, {
            "key": key, "op": str(args.get("op", "")), "alg": "",
            "ranks": {}})
        return inst, inst["ranks"].setdefault(pid, _blank_rank())

    for ev in doc.get("traceEvents") or ():
        if ev.get("cat") != "causal":
            continue
        args = ev.get("args") or {}
        pid = int(ev.get("pid", 0))
        ts_ns = int(round(float(ev.get("ts", 0.0)) * 1000.0))
        name = ev.get("name")
        if name == "cx_op" and ev.get("ph") == "X":
            inst, st = _rank_state(args, pid)
            dur_ns = int(round(float(ev.get("dur", 0.0)) * 1000.0))
            st["arrive"] = ts_ns
            st["exit"] = ts_ns + dur_ns
            st["stalls"] = {
                "ring": int(args.get("ring_us", 0)) * 1000,
                "cts": int(args.get("cts_us", 0)) * 1000,
                "dma": int(args.get("dma_us", 0)) * 1000,
            }
            alg = str(args.get("alg", ""))
            if alg and not inst["alg"]:
                inst["alg"] = alg
        elif name == "cx_send":
            _, st = _rank_state(args, pid)
            st["sends"].append([int(args.get("hop", 0)), ts_ns,
                                int(args.get("dst", -1))])
        elif name == "cx_recv":
            _, st = _rank_state(args, pid)
            st["recvs"].append([int(args.get("src", -1)),
                                int(args.get("hop", 0)), ts_ns,
                                int(args.get("wait_us", 0)) * 1000])
    # an instance whose cx_op never landed on some rank (crash-partial
    # trace) keeps that rank's arrive/exit at 0 — drop those ranks so
    # the walk never anchors on a zero timestamp
    for inst in out.values():
        inst["ranks"] = {r: st for r, st in inst["ranks"].items()
                         if st["exit"] > 0}
    return {k: v for k, v in out.items() if v["ranks"]}


def critical_path(inst: dict) -> dict | None:
    """Solve one instance: backward walk from the last exit, charging
    ``(rank, cause)`` segments (module docstring has the model)."""
    ranks = inst.get("ranks") or {}
    if not ranks:
        return None
    arrive = {r: int(st["arrive"]) for r, st in ranks.items()}
    exit_ = {r: int(st["exit"]) for r, st in ranks.items()}
    min_arrive = min(arrive.values())
    end = max(ranks, key=lambda r: (exit_[r], r))
    makespan = max(0, exit_[end] - min_arrive)
    send_ts: dict[tuple[int, int], int] = {}
    events: dict[int, list[tuple]] = {}
    for r, st in ranks.items():
        evs: list[tuple] = []
        for hop, t, dst in st.get("sends") or ():
            evs.append((int(t), "send", int(hop), int(dst), 0))
            send_ts[(r, int(hop))] = int(t)
        for src, hop, t, wait in st.get("recvs") or ():
            evs.append((int(t), "recv", int(hop), int(src), int(wait)))
        evs.sort(key=lambda e: (-e[0], e[1]))
        events[r] = evs
    idx = {r: 0 for r in ranks}
    raw = {r: {"compute": 0, "transport": 0, "arrival-skew": 0}
           for r in ranks}
    path: list[list] = []

    def charge(r: int, cause: str, ns: int) -> None:
        ns = max(0, int(ns))
        if ns:
            raw[r][cause] = raw[r].get(cause, 0) + ns
            path.append([r, cause, ns])

    cur, t = end, exit_[end]
    budget = 2 * sum(len(v) for v in events.values()) + 8
    while budget > 0:
        budget -= 1
        evs = events.get(cur) or []
        i = idx[cur]
        while i < len(evs) and evs[i][0] > t:
            i += 1
        idx[cur] = i
        if i >= len(evs):
            # local head: compute back to this rank's arrival, then
            # its lateness behind the earliest rank IS the path's root
            a = arrive.get(cur, t)
            charge(cur, "compute", t - a)
            charge(cur, "arrival-skew", a - min_arrive)
            break
        ts, kind, hop, peer, wait = evs[i]
        idx[cur] = i + 1
        charge(cur, "compute", t - ts)
        if kind == "recv" and wait > 0:
            wait_start = ts - wait
            s_ts = send_ts.get((peer, hop)) if peer in ranks else None
            if s_ts is not None and s_ts > wait_start:
                # the remote send was the binding constraint: the
                # wire span is the receiver's link; continue upstream
                charge(cur, "transport", ts - s_ts)
                cur, t = peer, min(s_ts, ts)
                continue
            # the sender was ready first (or is unknown): the wait is
            # delivery latency on this receiver's side; resume locally
            # at the moment the receiver became ready
            charge(cur, "transport", ts - wait_start)
            t = min(t, wait_start)
            continue
        t = ts
    # carve the measured stall causes out of the raw buckets they
    # physically occurred in: dma waits happen inside the recv
    # materialization (transport), ring/cts stalls inside the send
    # call (compute)
    per_rank: dict[int, dict[str, int]] = {}
    for r, buckets in raw.items():
        st = ranks[r].get("stalls") or {}
        b = dict(buckets)
        for cause, src_bucket, key in (("dma-wait", "transport", "dma"),
                                       ("ring-backpressure", "compute",
                                        "ring"),
                                       ("cts-wait", "compute", "cts")):
            carve = min(b.get(src_bucket, 0), max(0, int(st.get(key, 0))))
            if carve:
                b[cause] = b.get(cause, 0) + carve
                b[src_bucket] -= carve
        per_rank[r] = {k: v for k, v in b.items() if v > 0}
    dom = dominant_of(per_rank)
    return {
        "key": inst.get("key", ""), "op": inst.get("op", ""),
        "alg": inst.get("alg", ""), "makespan_ns": makespan,
        "path": path, "per_rank": per_rank, "dominant": dom,
    }


def dominant_of(per_rank: dict) -> dict:
    """Headline ``(rank, cause)``: the rank with the most on-path
    time; its largest bucket, near-ties (within :data:`TIE_FACTOR`)
    resolved toward the upstream cause (:data:`CAUSE_PRIORITY`)."""
    if not per_rank:
        return {"rank": -1, "cause": "", "ns": 0}
    totals = {r: sum(b.values()) for r, b in per_rank.items()}
    rank = max(totals, key=lambda r: (totals[r], r))
    buckets = per_rank[rank] or {"compute": 0}
    best = max(buckets.values()) if buckets else 0
    eligible = [c for c, v in buckets.items()
                if best and v * TIE_FACTOR >= best]
    order = {c: i for i, c in enumerate(CAUSE_PRIORITY)}
    cause = min(eligible, key=lambda c: order.get(c, len(order))) \
        if eligible else "compute"
    return {"rank": int(rank), "cause": cause,
            "ns": int(buckets.get(cause, 0))}


def solve(instances: dict, nprocs: int | None = None) -> dict:
    """Solve every (complete) instance and aggregate: the shared
    summary behind ``/critical``, the offline report, and the finalize
    -export join.  ``nprocs`` filters to instances every rank
    reported; None accepts whatever ranks are present."""
    per_rank: dict[int, dict[str, int]] = {}
    profile: dict[str, dict] = {}
    solved: list[dict] = []
    for key in sorted(instances):
        inst = instances[key]
        if nprocs is not None and len(inst.get("ranks") or {}) < nprocs:
            continue
        cp = critical_path(inst)
        if cp is None:
            continue
        solved.append(cp)
        for r, buckets in cp["per_rank"].items():
            agg = per_rank.setdefault(int(r), {})
            for c, ns in buckets.items():
                agg[c] = agg.get(c, 0) + int(ns)
        pkey = f"{cp['op']}/{cp['alg'] or '?'}"
        prof = profile.setdefault(pkey, {"n": 0, "makespan_ns": 0,
                                         "causes": {}})
        prof["n"] += 1
        prof["makespan_ns"] += cp["makespan_ns"]
        dc = prof["causes"]
        for buckets in cp["per_rank"].values():
            for c, ns in buckets.items():
                dc[c] = dc.get(c, 0) + int(ns)
    solved.sort(key=lambda cp: -cp["makespan_ns"])
    return {
        "instances": len(solved),
        "per_rank": per_rank,
        "dominant": dominant_of(per_rank),
        "profile": profile,
        "top": solved,
    }


def profile_from_records(records_by_proc: dict,
                         offsets_ns: dict | None = None,
                         nprocs: int | None = None) -> dict:
    """One-call offline join: per-rank finalize-export causal sections
    → the aggregated blame summary."""
    if nprocs is None:
        nprocs = len(records_by_proc) or None
    return solve(instances_from_records(records_by_proc,
                                        offsets_ns=offsets_ns),
                 nprocs=nprocs)

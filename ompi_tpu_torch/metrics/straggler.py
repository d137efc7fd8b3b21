"""Collective straggler profiler — who showed up late, and why.

Port of ``ompi_tpu/metrics/straggler.py``.  This module records the
per-rank half of the answer; the cross-rank half (joining one
collective's records across all ranks, :func:`join_skew`) runs wherever
records from every rank meet — a bench worker's final allgather or a
post-mortem report, or the live telemetry aggregator
(:mod:`ompi_tpu_torch.metrics.live`), which drains the queued records
into each frame.

Per collective call (api dispatch, :meth:`MultiProcComm._lookup`),
gated on the module ``_enabled`` bool (one test per call when off):

* **arrival** — wall-clock ns at entry, BEFORE any traffic.  Keyed
  ``(comm, op, seq)`` with a per-(comm, op) issue counter — identical
  on every rank by MPI's same-issue-order rule, so one collective's
  records align across ranks (the trace subsystem's merge key, reused);
* **exit** — wall-clock ns at completion; ``exit - arrival`` is this
  rank's total wait+wire time inside the op.

The cross-rank join decomposes a rank's in-op wait into **arrival
skew** (``last_arrival - my_arrival``: how long the early ranks idled
for the stragglers — :func:`instance_skew` / :func:`join_skew`) vs
**transport stall** (the metrics plane's ``ring_stall_ns`` /
``cts_wait_ns`` deltas over the same window).

Aggregates follow the subsystem's grow-only pvar contract: per-op keys
appear in first-seen order and only ever append (reset zeroes in
place) — ``straggler_<op>_count`` / ``straggler_<op>_wait_ns`` MPI_T
pvars index into them.  The C collective fast path's per-op timing
rows (``tdcn_coll_optime``) merge in through :func:`register_native`.
"""

from __future__ import annotations

import collections
import threading
import time

#: the in-path gate — the api dispatch hook reads this directly
_enabled = False

#: recent completed-collective records: (key, arrive_wall_ns,
#: exit_wall_ns); bounded so a long job cannot grow it.
_RECENT_CAP = 512

_lock = threading.Lock()
_seqs: dict[tuple[str, str], int] = {}
#: per-op aggregates, insertion-ordered and grow-only while profiling
#: runs (reset zeroes in place — the pvar namespace must not shrink)
_ops: dict[str, dict] = {}
_recent: collections.deque = collections.deque(maxlen=_RECENT_CAP)
#: op → winning coll component (CollTable dispatch notes it; a report
#: shows which algorithm a slow op is running)
_providers: dict[str, str] = {}
#: native per-op timing sources (the C collective fast path's
#: observability edge): weakref → callable returning {op: {count,
#: wait_ns, max_wait_ns, lat_hist}} — C-served collectives never
#: cross Python, so without this merge the straggler_<op> pvar/prom
#: surfaces only see their merged SPC counts.  Same weakref-anchored
#: lifetime rules as metrics.core.register_provider.
_native_providers: list = []
#: MPI_T reset baselines for the native rows, keyed PER PROVIDER
#: (id(weakref) → {op: totals}): the C block is append-only so Python
#: owns reset semantics, and a per-op global baseline would let a
#: dead engine's lifetime totals suppress a respawned engine's fresh
#: counts after a pvar_reset — baselines must die with their source.
#: max_wait_ns stays raw, like the *_hwm counters in the metrics core.
_native_base: dict[int, dict[str, dict]] = {}
#: native op names ever observed, first-seen order — the grow-only
#: pvar-namespace contract holds even after the engine that produced
#: a row closes (its counts read 0; the NAME never disappears)
_native_ops_seen: list[str] = []


def enabled() -> bool:
    return _enabled


def enable(flag: bool = True) -> None:
    global _enabled
    _enabled = flag


def sync_from_store(store) -> None:
    """Armed by ``--mca metrics_enable 1`` OR ``--mca telemetry_enable
    1`` — the profiler is part of the metrics plane (the reference's
    live endpoint needs it even when nobody asked for a finalize
    export; the port reads the same var)."""
    enable(bool(store.get("metrics_enable", False))
           or bool(store.get("telemetry_enable", False)))


def reset() -> None:
    """Test hook: drop all state."""
    global _enabled
    with _lock:
        _seqs.clear()
        _ops.clear()
        _recent.clear()
        _providers.clear()
        _native_providers.clear()
        _native_base.clear()
        _native_ops_seen.clear()
        _enabled = False


# -- native per-op timing merge (the C collective fast path) ------------


def register_native(obj, fn) -> None:
    """Register a native per-op timing source (a live C engine).
    ``obj`` anchors the registration lifetime (weakref, like
    metrics.core.register_provider); closed engines drop out."""
    import weakref

    try:
        wfn = weakref.WeakMethod(fn)
    except TypeError:  # plain function/closure
        wfn = (lambda f=fn: f)
    with _lock:
        _native_providers.append((weakref.ref(obj), wfn))


def _provider_rows() -> list[tuple[int, dict[str, dict]]]:
    """(id(weakref), raw rows) per LIVE native source — the shared
    sweep the merge and the reset both run; prunes dead
    registrations (and their baselines — a respawned engine must not
    inherit its dead predecessor's reset baseline)."""
    with _lock:
        live = list(_native_providers)
    out: list[tuple[int, dict[str, dict]]] = []
    dead = False
    for ref, wfn in live:
        fn = wfn()
        if ref() is None or fn is None:
            dead = True
            continue
        try:
            rows = fn()
        except Exception:  # engine torn down mid-read
            continue
        if rows:
            out.append((id(ref), rows))
    if dead:
        with _lock:
            gone = [id(r) for r, f in _native_providers
                    if r() is None or f() is None]
            _native_providers[:] = [
                (r, f) for r, f in _native_providers
                if r() is not None and f() is not None]
            for k in gone:  # baselines die with their source
                _native_base.pop(k, None)
    return out


def _native_rows() -> dict[str, dict]:
    """Merged {op: {count, wait_ns, max_wait_ns, lat_hist}} across
    live native sources, baseline-adjusted PER PROVIDER (reset
    semantics live here; the C block only grows, and a per-op global
    baseline would let a dead engine's lifetime totals suppress a
    respawned engine's fresh counts after a pvar_reset)."""
    out: dict[str, dict] = {}
    with _lock:
        base = {k: {op: dict(v) for op, v in b.items()}
                for k, b in _native_base.items()}
    for key, rows in _provider_rows():
        pb = base.get(key, {})
        for op, st in rows.items():
            b = pb.get(op, {})
            count = max(0, int(st.get("count", 0))
                        - int(b.get("count", 0)))
            if not count:
                continue
            cur = out.setdefault(op, {"count": 0, "wait_ns": 0,
                                      "max_wait_ns": 0, "lat_hist": []})
            cur["count"] += count
            cur["wait_ns"] += max(0, int(st.get("wait_ns", 0))
                                  - int(b.get("wait_ns", 0)))
            cur["max_wait_ns"] = max(cur["max_wait_ns"],
                                     int(st.get("max_wait_ns", 0)))
            hist = [int(v) for v in st.get("lat_hist") or []]
            bh = b.get("lat_hist") or []
            for i, v in enumerate(hist):
                hist[i] = max(0, v - (bh[i] if i < len(bh) else 0))
            if len(hist) > len(cur["lat_hist"]):
                cur["lat_hist"] += [0] * (len(hist)
                                          - len(cur["lat_hist"]))
            for i, v in enumerate(hist):
                cur["lat_hist"][i] += v
    with _lock:
        for op in out:
            if op not in _native_ops_seen:
                _native_ops_seen.append(op)
    return out


def _next_seq(comm: str, op: str) -> int:
    key = (comm, op)
    with _lock:
        s = _seqs.get(key, 0)
        _seqs[key] = s + 1
        return s


def note_provider(op: str, provider: str) -> None:
    """Coll dispatch tells us which component serves the op (one dict
    store per lookup when enabled; callers gate on ``_enabled``)."""
    _providers[op] = provider


def record(comm: str, op: str, arrive_ns: int, exit_ns: int) -> None:
    """One completed collective: fold into the per-op aggregate and
    queue the instance record for the next telemetry frame."""
    wait = max(0, exit_ns - arrive_ns)
    key = f"{comm}/{op}/{_next_seq(comm, op)}"
    with _lock:
        st = _ops.get(op)
        if st is None:
            st = _ops[op] = {"count": 0, "wait_ns": 0, "max_wait_ns": 0}
        st["count"] += 1
        st["wait_ns"] += wait
        if wait > st["max_wait_ns"]:
            st["max_wait_ns"] = wait
        _recent.append((key, int(arrive_ns), int(exit_ns)))


def wrap_call(op: str, fn, comm: str = ""):
    """Closure recording one collective around each call — the api
    dispatch hook (sits INSIDE the trace wrap so trace spans cover
    the same interval).  Timestamps are wall-clock ns: records from
    different ranks must land on one comparable timeline (the clock-
    offset estimate in the merge corrects residual host skew)."""

    def profiled(*a, **k):
        t0 = time.time_ns()
        try:
            return fn(*a, **k)
        finally:
            record(comm, op, t0, time.time_ns())

    profiled.__name__ = f"straggler_{op}"
    profiled.__wrapped__ = fn
    return profiled


# -- introspection (pvars, snapshots, frames) ---------------------------


def ops(refresh: bool = True) -> list[str]:
    """Op names with ≥1 record, FIRST-SEEN order — the
    ``straggler_<op>_*`` pvar namespace (grow-only while profiling
    runs; reset zeroes in place).  C-fast-path ops append after the
    Python-recorded ones; once seen they never drop out (a closed
    engine's counts read 0, but cached pvar indices stay valid).

    ``refresh=False`` skips the native-provider sweep and lists only
    already-seen ops — the pvar READ path uses it (name→index lookup
    per read must not pay a ctypes sweep per live engine; discovery
    entry points like ``pvar_get_num`` refresh)."""
    if refresh:
        _native_rows()  # refresh the grow-only seen list
    out = list(_ops)
    for op in _native_ops_seen:
        if op not in out:
            out.append(op)
    return out


def native_rows() -> dict[str, dict]:
    """One merged native sweep — pass to the per-op accessors below
    to read many ops from a single snapshot."""
    return _native_rows()


def op_count(op: str, rows: dict | None = None) -> int:
    st = _ops.get(op)
    n = st["count"] if st else 0
    nat = (rows if rows is not None else _native_rows()).get(op)
    return n + (nat["count"] if nat else 0)


def op_wait_ns(op: str, rows: dict | None = None) -> int:
    st = _ops.get(op)
    n = st["wait_ns"] if st else 0
    nat = (rows if rows is not None else _native_rows()).get(op)
    return n + (nat["wait_ns"] if nat else 0)


def summary() -> dict[str, dict]:
    """Per-op aggregates (+ serving component when known) — the
    snapshot/frame section.  C-fast-path rows (per-op duration
    emitted from tdcn_coll_start) merge in under the same op keys,
    carrying their log2-µs latency histogram; a row served by BOTH
    planes sums counts/waits and keeps the max."""
    with _lock:
        out = {
            op: dict(st, provider=_providers.get(op, ""))
            for op, st in _ops.items()
        }
    for op, nat in _native_rows().items():
        st = out.get(op)
        if st is None:
            out[op] = dict(nat, provider="cfp")
            continue
        st["count"] += nat["count"]
        st["wait_ns"] += nat["wait_ns"]
        st["max_wait_ns"] = max(st["max_wait_ns"], nat["max_wait_ns"])
        st["lat_hist"] = list(nat.get("lat_hist") or [])
    return out


def drain_recent() -> list[list]:
    """Pop every queued instance record (JSON-able ``[key, arrive_ns,
    exit_ns]`` rows) — one consumer, the telemetry publisher."""
    out = []
    with _lock:
        while _recent:
            k, a, x = _recent.popleft()
            out.append([k, a, x])
    return out


def recent() -> list[list]:
    """Non-destructive view of the queued records (finalize export,
    bench workers that join skew themselves)."""
    with _lock:
        return [[k, a, x] for k, a, x in _recent]


def zero_stats() -> None:
    """Session-wide pvar_reset: zero aggregates IN PLACE (keys and seq
    counters survive — cross-rank keys must not desync mid-run).  The
    native C rows re-baseline (the C block only grows; max_wait_ns
    stays raw, the *_hwm convention)."""
    with _lock:
        for st in _ops.values():
            st["count"] = 0
            st["wait_ns"] = 0
            st["max_wait_ns"] = 0
    # native rows re-baseline PER PROVIDER: the baseline is a raw-
    # total snapshot keyed by the provider registration, so it dies
    # with its engine and can never suppress a respawned successor
    snaps = _provider_rows()
    with _lock:
        for key, rows in snaps:
            pb = _native_base.setdefault(key, {})
            for op, st in rows.items():
                pb[op] = {
                    "count": int(st.get("count", 0)),
                    "wait_ns": int(st.get("wait_ns", 0)),
                    "lat_hist": [int(v)
                                 for v in st.get("lat_hist") or []],
                }


def reset_op(op: str) -> None:
    """Per-handle pvar_reset: zero ONE op — including its native
    C-fast-path rows, which re-baseline per provider exactly like
    :func:`zero_stats` (the session-wide path), so a per-handle
    MPI_T_pvar_reset honors the same reset contract."""
    with _lock:
        st = _ops.get(op)
        if st is not None:
            st["count"] = 0
            st["wait_ns"] = 0
            st["max_wait_ns"] = 0
    snaps = _provider_rows()
    with _lock:
        for key, rows in snaps:
            row = rows.get(op)
            if row is None:
                continue
            pb = _native_base.setdefault(key, {})
            pb[op] = {
                "count": int(row.get("count", 0)),
                "wait_ns": int(row.get("wait_ns", 0)),
                "lat_hist": [int(v)
                             for v in row.get("lat_hist") or []],
            }


# -- cross-rank skew (pure helpers shared by aggregator/bench/report) ---


def instance_skew(arrivals: dict[int, int]) -> tuple[int, dict[int, int]]:
    """One collective instance across ranks: ``arrivals[proc] =
    arrive_ns`` (clock-aligned).  Returns ``(slowest_proc, {proc:
    lateness_ns})`` where lateness is the gap behind the FIRST
    arrival — the time every earlier rank spent waiting for that
    rank (0 for the first arrival)."""
    first = min(arrivals.values())
    skews = {p: a - first for p, a in arrivals.items()}
    slowest = max(skews, key=lambda p: (skews[p], p))
    return slowest, skews


def join_skew(records_by_proc: dict[int, list],
              offsets_ns: dict[int, int] | None = None) -> dict:
    """Post-hoc join of per-rank instance records (``[key, arrive_ns,
    exit_ns]`` rows, as :func:`recent` emits).
    ``offsets_ns[proc]`` (peer_clock − reference_clock, the handshake
    estimate) aligns arrivals before comparison.  Returns::

        {"instances": N,                      # keys seen on every rank
         "per_op":  {op: {"n", "skew_ns", "max_skew_ns", "slowest": {proc: count}}},
         "per_proc": {proc: {"skew_ns", "slowest", "n"}}}
    """
    offsets_ns = offsets_ns or {}
    by_key: dict[str, dict[int, int]] = {}
    for proc, rows in records_by_proc.items():
        off = int(offsets_ns.get(proc, 0))
        for key, a, _x in rows:
            by_key.setdefault(key, {})[int(proc)] = int(a) - off
    nprocs = len(records_by_proc)
    per_op: dict[str, dict] = {}
    per_proc: dict[int, dict] = {
        int(p): {"skew_ns": 0, "slowest": 0, "n": 0}
        for p in records_by_proc
    }
    instances = 0
    for key, arrivals in by_key.items():
        if len(arrivals) < nprocs:
            continue  # a rank's record rolled off — skip, never guess
        instances += 1
        op = key.split("/")[-2] if key.count("/") >= 2 else key
        slowest, skews = instance_skew(arrivals)
        st = per_op.setdefault(
            op, {"n": 0, "skew_ns": 0, "max_skew_ns": 0, "slowest": {}})
        st["n"] += 1
        worst = skews[slowest]
        st["skew_ns"] += worst
        if worst > st["max_skew_ns"]:
            st["max_skew_ns"] = worst
        st["slowest"][slowest] = st["slowest"].get(slowest, 0) + 1
        for p, s in skews.items():
            pp = per_proc[p]
            pp["skew_ns"] += s
            pp["n"] += 1
            if p == slowest:
                pp["slowest"] += 1
    return {"instances": instances, "per_op": per_op,
            "per_proc": per_proc}

"""Hang diagnosis — blocked-state introspection + the cross-rank
wait-for graph ("mesh doctor").

Port of ``ompi_tpu/trace/waitgraph.py``.  Snapshots hold the Python
wait sites and the C engine's blocked waits (CTS grants, ring
backpressure, parked coll slots), mirrored in through
:func:`register_native` (``tdcn_waitinfo``); a wait's op ``key`` is the
causal tracer's ``comm/op/seq`` when one is in flight.  The solver
below is the reference's, unchanged.

A collective that never completes leaves no span and no counter behind.
This module records who was stuck on whom (≈ ORTE's ``mpirun
--report-state-on-timeout --get-stack-traces``).

Blocked-state registry (the per-rank half)
------------------------------------------

Every Deadline-bounded wait site registers itself **lazily**: a wait
that completes inside its first slice never touches this module — the
hook only fires in the slice-expiry branch, which is already the cold
path.  Call shape::

    wtok = _waitgraph.begin("coll_recv", ...) if _waitgraph._enabled else 0
    ...
    if wtok:
        _waitgraph.end(wtok)

Each entry carries the wait's *identity*: canonical site name, plane
(``tcp``/``shm``/``native``/``host``), awaited peer (root proc index when
resolvable, else the composite address), the coll stream key
``(cid, seq)``, the causal op key (``causal.current_key()``), the
owning thread's name, and ``since_ns``.
:func:`snapshot` adds ``sys._current_frames()`` stacks tagged by
thread name.

Wait-graph solver (the cross-rank half — stdlib only)
-----------------------------------------------------

:func:`build_graph` assembles per-rank snapshots into a wait-for graph
whose edges are ``rank → awaited peer``; :func:`classify` names the
hang:

* **cycle** → ``deadlock`` (the exact edge set);
* **chain** → ``straggler`` root: the rank everyone transitively waits
  on, with the binding site and a cause bucket (:data:`SITE_CAUSE`);
* **edge into a failed/demoted peer** → ``failed-peer`` (names the
  corpse and the plane the waiter is parked on);
* **no MPI edges** → ``compute`` (the application, not the runtime).

Counters ``hang_snapshots``/``hang_reports`` reach the metrics snapshot
through a provider.  Knob: ``hang_diag_enable`` (default **on** —
snapshots stay on demand and the registry is lazy, so a healthy run
does no work).
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
import weakref

#: the in-path gate — hooks read this attribute directly (the SPC
#: pattern).  Default ON to match ``hang_diag_enable``: registration is
#: lazy (slice-expiry branches only), so the enabled-but-healthy cost
#: is zero; disabling drops even that.
_enabled = True

#: wait site → blame bucket (the reference's causal.CAUSE_PRIORITY names).
#: ``transport`` for the generic message waits: the *peer* holds the
#: real cause, which the chain walk goes and finds.
SITE_CAUSE = {
    "cts": "cts-wait",
    "ring": "ring-backpressure",
    "device_recv": "dma-wait",
    "coll_recv": "transport",
    "p2p_recv": "transport",
}

#: stack frames retained per thread in a snapshot (top of stack)
_STACK_DEPTH = 8

_lock = threading.Lock()
_waits: dict[int, dict] = {}
_next_token = 0
#: native wait-state providers (live engines): weakref → callable
#: returning a list of entry dicts (tdcn_waitinfo rows) — the same
#: weakref-anchored lifetime rules as metrics.core.register_provider
_native_providers: list = []
_counters = {"hang_snapshots": 0, "hang_reports": 0}


class _ProviderAnchor:
    """Module-lifetime anchor for the metrics counter provider."""


_anchor = _ProviderAnchor()


def enabled() -> bool:
    return _enabled


def enable(flag: bool = True) -> None:
    global _enabled
    _enabled = flag


def sync_from_store(store) -> None:
    """Armed by ``--mca hang_diag_enable`` (default on)."""
    enable(bool(store.get("hang_diag_enable", True)))
    _ensure_counter_provider()


def reset() -> None:
    """Test hook: drop all state and restore the default-on gate."""
    global _enabled, _next_token
    with _lock:
        _waits.clear()
        _native_providers.clear()
        for k in _counters:
            _counters[k] = 0
        _next_token = 0
        _enabled = True


def counters_snapshot() -> dict[str, int]:
    return dict(_counters)


def _ensure_counter_provider() -> None:
    """Idempotently register the hang_* counter source with the
    metrics provider merge (metrics.core.reset(full=True) clears the
    provider list between tests, so registration must be re-playable
    without double-counting)."""
    from ompi_tpu_torch.metrics import core as _mcore

    with _mcore._lock:
        for ref, _fn in _mcore._providers:
            if ref() is _anchor:
                return
    _mcore.register_provider(_anchor, counters_snapshot)


# -- blocked-state registry (the per-rank hooks) -------------------------


def begin(site: str, peer: int | None = None, addr: str | None = None,
          plane: str = "host", cid=None, seq=None) -> int:
    """Register one blocked wait; returns the token :func:`end` takes.

    Callers use the t0-latch idiom (module docstring) and call this
    LAZILY — only after a Deadline slice already expired — so the
    happy path never reaches here.  ``peer`` is the awaited ROOT proc
    index when the site knows it; ``addr`` the composite address when
    only that is known (resolved at solve time by whoever can)."""
    global _next_token
    if not _enabled:
        return 0
    from ompi_tpu_torch.trace import causal as _causal

    ent = {
        "site": str(site),
        "plane": str(plane),
        "peer": int(peer) if peer is not None and int(peer) >= 0 else None,
        "addr": str(addr) if addr else None,
        "cid": str(cid) if cid is not None else None,
        "seq": int(seq) if seq is not None else None,
        "key": _causal.current_key(),
        "thread": threading.current_thread().name,
        "since_ns": time.time_ns(),
    }
    with _lock:
        _next_token += 1
        tok = _next_token
        _waits[tok] = ent
    return tok


def end(token: int) -> None:
    """Unregister a wait.  Token 0 (``begin`` disabled, or the wait
    never passed its first slice) is a no-op; a mid-wait disable still
    unregisters — tokens outlive the ``_enabled`` flip."""
    if not token:
        return
    with _lock:
        _waits.pop(token, None)


def busy() -> bool:
    """Cheap peek: does this rank hold any registered blocked wait?
    (The reference's telemetry publisher gates on it.)"""
    return bool(_waits)


def register_native(obj, fn) -> None:
    """Register a native wait-state source (a live engine's
    ``tdcn_waitinfo`` reader).  ``obj`` anchors the lifetime exactly
    like metrics.core.register_provider."""
    try:
        wfn = weakref.WeakMethod(fn)
    except TypeError:
        wfn = (lambda f=fn: f)
    with _lock:
        _native_providers.append((weakref.ref(obj), wfn))


#: address resolvers (live engines): ``fn(addr) -> root proc | None``
#: — transport-level waits (CTS, shm-ring backpressure) know only the
#: peer's composite address; snapshots resolve it to the proc index
#: the solver keys edges on
_addr_resolvers: list = []


def register_resolver(obj, fn) -> None:
    """Register an address → root-proc resolver (weakref-anchored to
    ``obj``, like metrics.core.register_provider)."""
    try:
        wfn = weakref.WeakMethod(fn)
    except TypeError:
        wfn = (lambda f=fn: f)
    with _lock:
        _addr_resolvers.append((weakref.ref(obj), wfn))


def _resolve_addr(addr: str):
    with _lock:
        live = list(_addr_resolvers)
    for ref, wfn in live:
        fn = wfn()
        if ref() is None or fn is None:
            continue
        try:
            p = fn(addr)
        except Exception:
            continue
        if p is not None and int(p) >= 0:
            return int(p)
    return None


def _native_waits(now_ns: int) -> list[dict]:
    with _lock:
        live = list(_native_providers)
    out: list[dict] = []
    dead = False
    for ref, wfn in live:
        fn = wfn()
        if ref() is None or fn is None:
            dead = True
            continue
        try:
            rows = fn() or ()
        except Exception:  # engine torn down mid-read
            continue
        for r in rows:
            ent = dict(r)
            ent.setdefault("plane", "native")
            # C reports monotonic age; anchor it on this wall clock
            age = int(ent.pop("age_ns", 0))
            ent.setdefault("since_ns", now_ns - max(0, age))
            ent.setdefault("thread", "c-engine")
            ent.setdefault("key", None)
            out.append(ent)
    if dead:
        with _lock:
            _native_providers[:] = [
                (r, f) for r, f in _native_providers
                if r() is not None and f() is not None]
    return out


def _stack_summary() -> dict[str, list[str]]:
    """``sys._current_frames()`` condensed: thread name → top frames
    (``file:line:function``), innermost last."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: dict[str, list[str]] = {}
    for tid, frame in sys._current_frames().items():
        rows = [f"{fs.filename.rsplit('/', 1)[-1]}:{fs.lineno}:{fs.name}"
                for fs in traceback.extract_stack(frame, limit=_STACK_DEPTH)]
        out[names.get(tid, f"tid-{tid}")] = rows
    return out


def snapshot(stacks: bool = True) -> dict:
    """One rank's blocked-state snapshot, on demand: every registered
    wait (Python sites + mirrored native state), optionally the tagged
    thread stacks.  Bumps ``hang_snapshots``."""
    now = time.time_ns()
    with _lock:
        waits = [dict(e) for e in _waits.values()]
        _counters["hang_snapshots"] += 1
    waits += _native_waits(now)
    for w in waits:
        if w.get("peer") is None and w.get("addr"):
            w["peer"] = _resolve_addr(w["addr"])
    waits.sort(key=lambda w: w.get("since_ns") or 0)
    out: dict = {"ts_ns": now, "waits": waits}
    if stacks:
        out["stacks"] = _stack_summary()
    _ensure_counter_provider()
    return out


def wait_brief(waits) -> str:
    """Compact one-wait label for briefs: ``site→peer`` of the oldest
    registered wait (the binding one), '?' for an unresolved peer."""
    if not waits:
        return ""
    w = min(waits, key=lambda e: e.get("since_ns") or 0)
    peer = w.get("peer")
    return f"{w.get('site', '?')}→{'?' if peer is None else peer}"


# =======================================================================
# the solver — stdlib-only from here down (tools import this offline)
# =======================================================================


def build_graph(snaps_by_rank: dict, failed=()) -> dict:
    """Assemble per-rank snapshots (``{rank: snapshot_dict}``) into the
    cross-rank wait-for graph.  Edges keep the full wait identity so
    the classification can name the exact (rank, site, peer, plane,
    op-key) of every dependence."""
    edges: list[dict] = []
    ranks: list[int] = []
    for rank in sorted(int(r) for r in (snaps_by_rank or {})):
        snap = snaps_by_rank.get(rank) or snaps_by_rank.get(str(rank)) or {}
        ranks.append(rank)
        ts = int(snap.get("ts_ns") or 0)
        for w in snap.get("waits") or ():
            since = int(w.get("since_ns") or 0)
            edges.append({
                "src": rank,
                "dst": (int(w["peer"]) if w.get("peer") is not None
                        else None),
                "addr": w.get("addr"),
                "site": str(w.get("site", "")),
                "plane": str(w.get("plane", "")),
                "cid": w.get("cid"),
                "seq": w.get("seq"),
                "key": w.get("key"),
                "age_ns": max(0, ts - since) if (ts and since)
                else int(w.get("age_ns") or 0),
            })
    edges.sort(key=lambda e: (-e["age_ns"], e["src"]))
    return {"ranks": ranks, "edges": edges,
            "failed": sorted(int(f) for f in (failed or ()))}


def _find_cycle(adj: dict) -> list[int] | None:
    """One cycle in the rank→rank wait graph (iterative DFS), or None.
    ``adj``: rank → sorted list of awaited ranks."""
    color: dict[int, int] = {}  # 0/absent=white, 1=grey, 2=black
    parent: dict[int, int] = {}
    for start in sorted(adj):
        if color.get(start):
            continue
        stack = [(start, iter(adj.get(start, ())))]
        color[start] = 1
        while stack:
            node, it = stack[-1]
            nxt = next(it, None)
            if nxt is None:
                color[node] = 2
                stack.pop()
                continue
            c = color.get(nxt, 0)
            if c == 1:  # back edge: unwind the grey chain into a cycle
                cyc = [nxt]
                cur = node
                while cur != nxt:
                    cyc.append(cur)
                    cur = parent[cur]
                cyc.reverse()
                return cyc
            if c == 0:
                color[nxt] = 1
                parent[nxt] = node
                stack.append((nxt, iter(adj.get(nxt, ()))))
    return None


def _edge_between(edges: list, src: int, dst: int) -> dict | None:
    for e in edges:
        if e["src"] == src and e["dst"] == dst:
            return e  # edges are age-sorted: first hit is the binding one
    return None


def _root_cause(rank: int, edges: list) -> tuple[str, str]:
    """(cause bucket, site) of a chain root from its own non-peer
    waits; a root with no registered waits is computing."""
    own = [e for e in edges if e["src"] == rank]
    if not own:
        return "compute", ""
    e = own[0]  # oldest (age-sorted)
    return SITE_CAUSE.get(e["site"], "transport"), e["site"]


def classify(graph: dict) -> dict:
    """Name the hang (module docstring has the taxonomy).  Always
    returns a dict with ``kind`` ∈ {deadlock, straggler, failed-peer,
    compute} plus the evidence edges."""
    edges = graph.get("edges") or []
    failed = set(graph.get("failed") or ())
    # 1) an edge into a corpse explains everything downstream of it
    dead_edges = [e for e in edges if e["dst"] is not None
                  and e["dst"] in failed]
    if dead_edges:
        e = dead_edges[0]
        return {"kind": "failed-peer", "rank": e["dst"],
                "plane": e["plane"], "site": e["site"],
                "edges": dead_edges}
    peer_edges = [e for e in edges if e["dst"] is not None]
    if not peer_edges and not edges:
        return {"kind": "compute", "edges": []}
    # 2) cycle → deadlock, with the exact edge set around the cycle
    adj: dict[int, list[int]] = {}
    for e in peer_edges:
        adj.setdefault(e["src"], [])
        if e["dst"] not in adj[e["src"]]:
            adj[e["src"]].append(e["dst"])
    cyc = _find_cycle(adj)
    if cyc:
        cyc_edges = []
        for i, r in enumerate(cyc):
            nxt = cyc[(i + 1) % len(cyc)]
            e = _edge_between(peer_edges, r, nxt)
            if e is not None:
                cyc_edges.append(e)
        return {"kind": "deadlock", "cycle": cyc, "edges": cyc_edges}
    # 3) chain → straggler root: follow the oldest dependence until a
    #    rank that awaits nobody (it is the one everyone waits on)
    start = peer_edges[0]["src"] if peer_edges else edges[0]["src"]
    chain = [start]
    chain_edges: list[dict] = []
    cur = start
    while True:
        nxt_edge = next((e for e in peer_edges if e["src"] == cur), None)
        if nxt_edge is None or nxt_edge["dst"] in chain:
            break
        chain_edges.append(nxt_edge)
        cur = nxt_edge["dst"]
        chain.append(cur)
    binding = chain_edges[-1] if chain_edges else None
    cause, own_site = _root_cause(cur, edges)
    return {
        "kind": "straggler",
        "root": {
            "rank": cur,
            "cause": cause,
            # the binding dependence INTO the root names the site and
            # plane the mesh is parked on; the root's own wait (if
            # any) refines the cause above
            "site": (binding["site"] if binding is not None
                     else own_site),
            "plane": (binding["plane"] if binding is not None
                      else ""),
            "peer": cur,
        },
        "chain": chain,
        "edges": chain_edges,
    }


def report(snaps_by_rank: dict, failed=(), reason: str = "") -> dict:
    """One capture: graph + classification, counted and
    flight-recorded.  The shared body behind ``/waitgraph``, the tpud
    deadline hang report, and the offline CLI."""
    graph = build_graph(snaps_by_rank, failed=failed)
    verdict = classify(graph)
    with _lock:
        _counters["hang_reports"] += 1
    from ompi_tpu_torch.metrics import flight as _flight

    _flight.record("hang_report", kind=str(verdict.get("kind", "")),
                   cause=str(reason),
                   ranks=len(graph.get("ranks") or ()),
                   edges=len(graph.get("edges") or ()))
    out = {"ts_ns": time.time_ns(), "graph": graph, "verdict": verdict}
    if reason:
        out["reason"] = reason
    return out

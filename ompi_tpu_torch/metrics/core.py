"""Metrics core — counters and histograms behind the Prometheus/JSONL
exports and the MPI_T pvars.

Port of ``ompi_tpu/metrics/core.py``.  Every Python in-path hook is
guarded by the module-level ``_enabled`` boolean (``--mca
metrics_enable 1``), so a disabled run pays one attribute test per hook.

* **native counters** — monotone totals merged from every registered
  provider, under the reference's fixed counter schema
  (:data:`NATIVE_COUNTERS`, the ``dcn_*`` pvars): the native engine's C
  block (``TdcnStats``, read through one ctypes call), the Python
  transports' stats, the persistent-schedule cache, the device plane's
  counters (``dcn/device.py``) and, in a tpud daemon, the serving
  counters (``serve/daemon.py``);
* **per-op histograms** — log2 size (bytes) and latency (µs) buckets
  per operation, grow-only key order;
* **snapshots** — one JSON-able dict of both plus the SPC counters, the
  input of :mod:`.export`, :mod:`.flight` and
  ``tools/metrics_report.py``.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Callable

#: the in-path gate — hooks read this attribute directly
_enabled = False

#: log2-bytes size buckets: bucket i holds 2**(i-1) < nbytes <= 2**i
#: (bucket 0: zero/one byte), upper-inclusive like Prometheus's ``le``;
#: the last bucket is open-ended
SIZE_BUCKETS = 24
#: log2-µs latency buckets, upper-inclusive edges like the size buckets
LAT_BUCKETS = 16

#: the reference's native counter schema, index order of its C block
#: minus the version slot.  Fixed names (the ``dcn_<name>`` pvars and
#: the ``ompi_tpu_dcn_<name>`` Prometheus families) so that the port's
#: exports and the reference's read the same to the report tools.
NATIVE_COUNTERS = (
    "doorbells", "stall_ns", "ring_stall_ns", "ring_stalls", "ring_hwm",
    "cts_wait_ns", "cts_waits", "rndv_depth", "rndv_hwm", "slot_waits",
    "eager_msgs", "eager_bytes", "chunked_msgs", "chunked_bytes",
    "rndv_msgs", "rndv_bytes", "delivered", "unexpected_hwm",
    "reconnects", "retry_dials", "retry_sends", "deadline_expired",
    "injected_faults",
    "dedup_drops", "respawns",
    "doorbells_suppressed", "stream_msgs", "stream_bytes",
    "stream_depth", "stream_depth_hwm", "stream_inflight",
    "stream_inflight_hwm", "chunk_shrinks", "sender_yields",
    "enqueue_waits",
    "coll_fastpath_ops", "sched_cache_hits", "sched_cache_misses",
    "recv_into_placed",
    "addr_installs", "addr_lazy_resolved",
    "device_sends", "device_recvs", "device_bytes_placed",
    "device_dma_waits", "device_dma_wait_ns",
    "device_arb_device", "device_arb_host", "device_fallbacks",
    "device_window_reclaimed",
    "plane_demotions", "plane_promotions", "plane_heal_probes",
    "jobs_concurrent_hwm", "jobs_shed", "jobs_deadline_expired",
    "jobs_retried",
    "hang_snapshots", "hang_reports",
)

#: counters that are gauges (instantaneous), not monotone totals
GAUGES = frozenset({"rndv_depth", "stream_depth", "stream_inflight"})

_lock = threading.Lock()
#: per-op aggregates, insertion-ordered and grow-only (reset zeroes in
#: place — the pvar namespace must not shrink)
_ops: dict[str, dict] = {}
#: live counter providers: (weakref to the anchor, weak callable)
_providers: list = []
#: per-peer clock-offset providers (live engines): weakref → callable
#: returning {root_proc: (offset_ns, rtt_ns)} — the HELLO→SEQACK
#: handshake estimate the cross-rank merge aligns timelines with
_clock_providers: list = []
#: MPI_T reset baselines (reset = remember the current total)
_native_base: dict[str, int] = {}


def enabled() -> bool:
    return _enabled


def enable(flag: bool = True) -> None:
    """Turn the Python-side hooks on/off (``--mca metrics_enable 1``
    goes through :func:`sync_from_store`)."""
    global _enabled
    _enabled = flag


def size_bucket(nbytes: int) -> int:
    """log2 bucket of a payload size; ``n-1`` before bit_length makes
    the edge upper-inclusive (exactly 2**i counts under ``le="2**i"``)."""
    return min(max(0, int(nbytes) - 1).bit_length(), SIZE_BUCKETS - 1)


def lat_bucket(dur_ns: int) -> int:
    return min(max(0, int(dur_ns) // 1000 - 1).bit_length(),
               LAT_BUCKETS - 1)


def _new_op() -> dict:
    return {"count": 0, "bytes": 0, "total_ns": 0, "max_ns": 0,
            "size_hist": [0] * SIZE_BUCKETS, "lat_hist": [0] * LAT_BUCKETS}


def observe(op: str, nbytes: int, dur_ns: int | None = None) -> None:
    """Record one operation: size histogram always, latency histogram
    when a duration is given.  Callers gate on ``_enabled``."""
    if not _enabled:
        return
    with _lock:
        st = _ops.get(op)
        if st is None:
            st = _ops[op] = _new_op()
        st["count"] += 1
        st["bytes"] += int(nbytes)
        st["size_hist"][size_bucket(nbytes)] += 1
        if dur_ns is not None:
            st["total_ns"] += int(dur_ns)
            if dur_ns > st["max_ns"]:
                st["max_ns"] = int(dur_ns)
            st["lat_hist"][lat_bucket(dur_ns)] += 1


def observe_size(op: str, nbytes: int) -> None:
    """Size-only observation (the SPC payload-bytes routing)."""
    observe(op, nbytes, None)


# -- counter providers ---------------------------------------------------


def register_provider(obj, fn: Callable[[], dict | None]) -> None:
    """Register a counter source anchored to ``obj``: it drops out when
    ``obj`` is collected (bound methods are held weakly too)."""
    try:
        wfn: Callable = weakref.WeakMethod(fn)  # type: ignore[assignment]
    except TypeError:  # plain function/closure: no self to leak
        wfn = (lambda f=fn: f)
    with _lock:
        _providers.append((weakref.ref(obj), wfn))


def native_counters() -> dict[str, int]:
    """Merged raw totals from every live provider (no baseline): totals
    sum across providers, gauges and ``*_hwm`` take the max."""
    out: dict[str, int] = {k: 0 for k in NATIVE_COUNTERS}
    with _lock:
        live = list(_providers)
    dead = False
    for ref, wfn in live:
        fn = wfn()
        if ref() is None or fn is None:
            dead = True
            continue
        try:
            d = fn()
        except Exception:  # provider torn down mid-read
            continue
        for k, v in (d or {}).items():
            if k not in out:
                continue
            if k in GAUGES or k.endswith("_hwm"):
                out[k] = max(out[k], int(v))
            else:
                out[k] += int(v)
    if dead:
        with _lock:
            _providers[:] = [(r, f) for r, f in _providers
                             if r() is not None and f() is not None]
    return out


def register_clock_provider(obj, fn: Callable[[], dict | None]) -> None:
    """Register a clock-offset source (a live engine mapping peer
    addresses to root procs); same weakref-anchored lifetime rules as
    :func:`register_provider`."""
    try:
        wfn: Callable = weakref.WeakMethod(fn)  # type: ignore[assignment]
    except TypeError:
        wfn = (lambda f=fn: f)
    with _lock:
        _clock_providers.append((weakref.ref(obj), wfn))


def clock_offsets() -> dict[int, tuple[int, int]]:
    """Merged ``{root_proc: (offset_ns, rtt_ns)}`` across live engines
    — offset is (peer_clock − my_clock), the NTP-style single-sample
    estimate from the connection handshake; the smallest-RTT sample
    wins when several transports measured the same peer."""
    out: dict[int, tuple[int, int]] = {}
    with _lock:
        live = list(_clock_providers)
    dead = False
    for ref, wfn in live:
        fn = wfn()
        if ref() is None or fn is None:
            dead = True
            continue
        try:
            d = fn()
        except Exception:  # provider torn down mid-read
            continue
        for p, (off, rtt) in (d or {}).items():
            cur = out.get(int(p))
            if cur is None or rtt < cur[1]:
                out[int(p)] = (int(off), int(rtt))
    if dead:
        with _lock:
            _clock_providers[:] = [(r, f) for r, f in _clock_providers
                                   if r() is not None and f() is not None]
    return out


def native_value(name: str) -> int:
    """One counter, baseline-adjusted — the MPI_T pvar read."""
    raw = native_counters().get(name, 0)
    if name in GAUGES or name.endswith("_hwm"):
        return raw
    return max(0, raw - _native_base.get(name, 0))


def reset_native(name: str | None = None) -> None:
    """MPI_T pvar_reset: remember current totals as the baseline (gauges
    and high-water marks are exempt)."""
    cur = native_counters()
    with _lock:
        for k in ([name] if name else NATIVE_COUNTERS):
            if k in cur and k not in GAUGES and not k.endswith("_hwm"):
                _native_base[k] = cur[k]


# -- pvar namespace (grow-only) ------------------------------------------


def size_ops() -> list[str]:
    """Op names with ≥1 observation, first-seen order — the
    ``metrics_size_<op>_hist`` pvar namespace."""
    return list(_ops)


def size_histogram(op: str) -> list[int]:
    st = _ops.get(op)
    return list(st["size_hist"]) if st else [0] * SIZE_BUCKETS


def op_stats() -> dict[str, dict]:
    """Deep-copied per-op aggregates (report/export input)."""
    with _lock:
        return {
            k: dict(v, size_hist=list(v["size_hist"]),
                    lat_hist=list(v["lat_hist"]))
            for k, v in _ops.items()
        }


def zero_stats() -> None:
    """Zero every per-op aggregate in place and re-baseline the counters
    — the session-wide MPI_T pvar_reset."""
    with _lock:
        for k in _ops:
            _ops[k] = _new_op()
    reset_native()


def reset_op(op: str) -> None:
    """Zero one op aggregate in place (single-handle pvar_reset)."""
    with _lock:
        if op in _ops:
            _ops[op] = _new_op()


def reset(full: bool = True) -> None:
    """Test hook: drop all state (``full=False`` keeps providers)."""
    global _enabled
    with _lock:
        _ops.clear()
        _native_base.clear()
        if full:
            _providers.clear()
            _clock_providers.clear()
            _enabled = False
    from . import flight, straggler

    flight.reset()
    if full:
        straggler.reset()


# -- snapshots -------------------------------------------------------------


def snapshot(reason: str = "periodic", proc: int | None = None) -> dict:
    """One JSON-able view right now — the exporter, flight-recorder and
    report-tool input.  ``faultsim``, ``straggler``, ``clock`` and
    ``waits`` appear when their subsystem is on and has something."""
    from ompi_tpu_torch.tool import spc

    snap = {
        "ts_ns": time.time_ns(),
        "reason": reason,
        "proc": proc,
        "native": native_counters(),
        "ops": op_stats(),
        "spc": spc.snapshot(),
    }
    from ompi_tpu_torch.faultsim import core as _fsim

    if _fsim._enabled:
        snap["faultsim"] = _fsim.counters()
    from . import straggler as _straggler

    if _straggler._enabled:
        snap["straggler"] = _straggler.summary()
    clock = clock_offsets()
    if clock:
        # {proc: [offset_ns, rtt_ns]} — the merge tools align
        # cross-rank timelines against host clock skew with it
        snap["clock"] = {str(p): [o, r] for p, (o, r) in clock.items()}
    from ompi_tpu_torch.trace import waitgraph as _waitgraph

    if _waitgraph._enabled:
        w = _waitgraph.snapshot(stacks=False)
        if w.get("waits"):
            # blocked-wait sites at snapshot time: crash exports carry
            # them for a post-mortem hang diagnosis
            snap["waits"] = w["waits"]
    return snap


# -- MCA wiring ------------------------------------------------------------


def register_vars(store) -> None:
    """Register this subsystem's vars on ``store`` (idempotent; the
    default context already has them from the central table)."""
    from ompi_tpu_torch.core.var import register_observability_vars

    register_observability_vars(store)


def sync_from_store(store) -> None:
    enable(bool(store.get("metrics_enable", False)))
    from . import flight

    flight.configure(
        output=str(store.get("metrics_output", "") or ""),
        max_records=int(store.get("metrics_flight_records", 64)),
    )

"""SPC — software performance counters.

Port of ``ompi_tpu/tool/spc.py`` (≈ ``ompi/runtime/ompi_spc.c``).  The
coll table's ``lookup`` and the communicator's fast path call
:func:`inc` once per collective; the arena counts its staging.
Counters cost one dict update when attached and one boolean test when
not.  ``--mca runtime_spc_attach all`` (≈ the reference's
``mpi_spc_attach_all``) attaches them at init; :func:`attach` and
MPI_T's ``pvar_start`` do at any time.  Every counter is an MPI_T pvar
(:mod:`ompi_tpu_torch.tool.mpit`).

Reset zeroes counters in place: a key once touched stays in
:func:`snapshot`, so cached pvar handles keep naming the same variable.
``*_bytes`` increments also feed the metrics core's size histograms
when metrics are on.  The C collective fast path's per-op counts
(``tpumpi_coll_spc``, exported by a C-ABI shim that hosts the process)
merge in at read time; outside such a process the symbol probe fails
once and the merge is a no-op (the port's own C ABI is not built yet).
"""

from __future__ import annotations

import ctypes
import threading

from ompi_tpu_torch.metrics import core as _metrics

_lock = threading.Lock()
_counters: dict[str, int] = {}
_attached = False

#: non-collective counter names, the reference's set (the p2p, RMA and
#: I/O names count once those modules are ported); collective counters
#: are one per coll-table slot, prepended by :func:`known`
_BASE_KNOWN = (
    "send", "send_bytes", "irecv",
    "put", "put_bytes", "get", "get_bytes", "accumulate",
    "file_write_bytes", "file_read_bytes",
    "arena_stage_in", "arena_stage_bytes", "arena_donations",
    "arena_pool_alloc",
)

_known_cache: tuple[str, ...] | None = None


def known() -> tuple[str, ...]:
    """Every counter name this build can increment — the MPI_T pvar
    namespace (the coll-table slots, then the base set)."""
    global _known_cache
    if _known_cache is None:
        from ompi_tpu_torch.coll.module import all_slots  # lazy: import cycle

        _known_cache = tuple(all_slots()) + _BASE_KNOWN
    return _known_cache


def payload_nbytes(p) -> int:
    """Byte size of a collective payload (tensor, ndarray or sequence)."""
    nb = getattr(p, "nbytes", None)
    if nb is not None:
        return int(nb)
    try:
        import numpy as _np

        return int(_np.asarray(p).nbytes)
    except (TypeError, ValueError):  # ragged lists of blocks
        return 0


def attach(flag: bool = True) -> None:
    """Enable/disable counting (≈ mpi_spc_attach_all)."""
    global _attached
    _attached = flag


def attached() -> bool:
    return _attached


def inc(name: str, n: int = 1) -> None:
    """Hot-path increment: one flag test when detached."""
    if not _attached:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n
    if _metrics._enabled and name.endswith("_bytes"):
        _metrics.observe_size("spc_" + name[:-len("_bytes")], n)


# -- C fast-path merge ---------------------------------------------------
# A shim's C collective fast path never crosses Python, so its
# MPI_Allreduce/Bcast/... calls cannot tick inc(): they accrue in a
# C-side per-op array and merge here at READ time (zero hot-path cost).

_NATIVE_SLOTS = ("barrier", "bcast", "reduce", "allreduce", "allgather")
_native_fn = None
_native_probed = False
_native_base: dict[str, int] = {}


def _native_counts() -> dict[str, int]:
    global _native_fn, _native_probed
    if not _native_probed:
        _native_probed = True
        try:
            lib = ctypes.CDLL(None)
            fn = lib.tpumpi_coll_spc
            fn.argtypes = [ctypes.c_longlong * len(_NATIVE_SLOTS)]
            fn.restype = None
            _native_fn = fn
        except (OSError, AttributeError, TypeError):
            _native_fn = None
    if _native_fn is None:
        return {}
    buf = (ctypes.c_longlong * len(_NATIVE_SLOTS))()
    _native_fn(buf)
    return {n: int(buf[i]) for i, n in enumerate(_NATIVE_SLOTS)}


def get(name: str) -> int:
    nat = 0
    if name in _NATIVE_SLOTS:
        nc = _native_counts()
        if nc:
            nat = max(0, nc[name] - _native_base.get(name, 0))
    with _lock:
        return _counters.get(name, 0) + nat


def snapshot() -> dict[str, int]:
    with _lock:
        out = dict(_counters)
    for n, v in _native_counts().items():
        d = max(0, v - _native_base.get(n, 0))
        if d or n in out:
            out[n] = out.get(n, 0) + d
    return out


def reset() -> None:
    """Zero every counter in place — touched keys stay visible.  The
    monotone C-side counts are re-baselined (the C side is never
    written)."""
    with _lock:
        for k in _counters:
            _counters[k] = 0
    for n, v in _native_counts().items():
        _native_base[n] = v


def reset_one(name: str) -> None:
    """Zero one counter (MPI_T pvar_reset on one handle)."""
    with _lock:
        if name in _counters:
            _counters[name] = 0
    if name in _NATIVE_SLOTS:
        nc = _native_counts()
        if nc:
            _native_base[name] = nc[name]


def clear() -> None:
    """Drop all counter state including keys (tests only)."""
    with _lock:
        _counters.clear()


def register_vars(store) -> None:
    store.register(
        "runtime", "spc", "attach", "", type="string",
        help="Attach the software performance counters at init ('all'; "
        "≈ mpi_spc_attach_all); empty leaves them detached until "
        "MPI_T pvar_start",
    )


def sync_from_store(store) -> None:
    """Attach when the var asks for it; an unset var leaves an attach
    made by a tool before init in place."""
    if str(store.get("runtime_spc_attach", "")).strip().lower() in (
            "all", "1", "true", "yes", "on"):
        attach(True)

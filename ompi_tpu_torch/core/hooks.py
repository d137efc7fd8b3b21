"""Hook framework — callbacks around MPI lifecycle events.

Own copy of ``ompi_tpu/core/hooks.py`` (≈ ``ompi/mca/hook``): functions
registered for ``mpi_init_top/mpi_init_bottom/mpi_finalize_top/
mpi_finalize_bottom`` are fired by ``api.init``/``api.finalize``.  A
failing hook prints its traceback and does not stop the job, as in the
reference.
"""

from __future__ import annotations

import threading
import traceback
from typing import Callable

from .errors import MPIArgError

EVENTS = (
    "mpi_init_top",
    "mpi_init_bottom",
    "mpi_finalize_top",
    "mpi_finalize_bottom",
)

_lock = threading.Lock()
_hooks: dict[str, list[Callable]] = {e: [] for e in EVENTS}


def register(event: str, fn: Callable) -> None:
    if event not in _hooks:
        raise MPIArgError(f"unknown hook event {event!r} (know {EVENTS})")
    with _lock:
        _hooks[event].append(fn)


def unregister(event: str, fn: Callable) -> None:
    with _lock:
        try:
            _hooks[event].remove(fn)
        except (KeyError, ValueError):
            pass


def fire(event: str, **kw) -> None:
    with _lock:
        fns = list(_hooks.get(event, ()))
    for fn in fns:
        try:
            fn(**kw)
        except Exception:  # noqa: BLE001 — a tool hook must not kill the job
            traceback.print_exc()


def reset() -> None:
    """Test hook."""
    with _lock:
        for e in EVENTS:
            _hooks[e].clear()

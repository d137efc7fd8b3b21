"""Schedule cache for persistent collectives.

Port of ``ompi_tpu/coll/sched.py`` (≈ libnbc's schedule store): a
persistent collective's plan — tuned's algorithm choice baked into the
resolved callable — is built once at ``*_init`` and replayed by every
``start()``.  This module owns the process-wide store:

* keys are the communicator's shape (layout and every rank's device,
  which gives the rank count), never its identity, so a ``dup`` of the
  same shape hits and a comm over other devices does not;
* hit/miss counters register with the metrics core as a provider under
  the reference's names ``sched_cache_hits``/``sched_cache_misses``;
* capacity is bounded (``coll_sched_cache_max``) with FIFO eviction;
* ``--mca coll_sched_cache_enable 0`` turns the store into a
  pass-through (every lookup builds, nothing is kept or counted).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable


def _var(name: str, default):
    from ompi_tpu_torch.core import mca

    v = mca.default_context().store.get(name)
    return default if v is None else v


class ScheduleCache:
    """Keyed plan store with hit/miss accounting.  Thread-safe; the
    builder runs outside the lock, so two racing builders of one key both
    build, the first insert wins, and each counts a miss."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._plans: OrderedDict[tuple, Any] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def lookup(self, key: tuple, builder: Callable[[], Any]) -> Any:
        if not bool(_var("coll_sched_cache_enable", True)):
            return builder()
        with self._lock:
            if key in self._plans:
                self.hits += 1
                return self._plans[key]
            self.misses += 1
        plan = builder()
        cap = max(1, int(_var("coll_sched_cache_max", 256)))
        with self._lock:
            if key not in self._plans:
                self._plans[key] = plan
                while len(self._plans) > cap:
                    self._plans.popitem(last=False)
            return self._plans[key]

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"sched_cache_hits": self.hits,
                    "sched_cache_misses": self.misses,
                    "entries": len(self._plans)}

    def provider_stats(self) -> dict[str, int]:
        """The counter-schema subset for the metrics provider merge."""
        with self._lock:
            return {"sched_cache_hits": self.hits,
                    "sched_cache_misses": self.misses}


#: the process-wide store
CACHE = ScheduleCache()

_reg_lock = threading.Lock()


def register_metrics_provider() -> None:
    """Merge the cache's counters into the metrics core unless a live
    provider entry already anchors :data:`CACHE`: ``metrics.core.reset()``
    drops the provider list, so registration is re-playable without
    counting twice."""
    from ompi_tpu_torch.metrics import core as _mcore

    with _reg_lock:
        with _mcore._lock:
            if any(ref() is CACHE for ref, _fn in _mcore._providers):
                return
        _mcore.register_provider(CACHE, CACHE.provider_stats)


def lookup(key: tuple, builder: Callable[[], Any]) -> Any:
    """Module-level convenience over :data:`CACHE`."""
    register_metrics_provider()
    return CACHE.lookup(key, builder)

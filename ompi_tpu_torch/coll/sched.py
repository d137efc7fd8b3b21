"""Schedule cache for persistent collectives.

Port of ``ompi_tpu/coll/sched.py`` (≈ libnbc's schedule store): a
persistent collective's plan — tuned's algorithm choice baked into the
resolved callable — is built once at ``*_init`` and replayed by every
``start()``.  This module owns the process-wide store:

* keys are the communicator's shape (device, rank count), never its
  identity, so a ``dup`` of the same shape hits;
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

_registered = False
_reg_lock = threading.Lock()


def register_metrics_provider() -> None:
    """Merge the cache's counters into the metrics core, once."""
    global _registered
    with _reg_lock:
        if _registered:
            return
        from ompi_tpu_torch.metrics import core as _mcore

        _mcore.register_provider(CACHE, CACHE.provider_stats)
        _registered = True


def lookup(key: tuple, builder: Callable[[], Any]) -> Any:
    """Module-level convenience over :data:`CACHE`."""
    register_metrics_provider()
    return CACHE.lookup(key, builder)

"""``coll/sync`` — the collective-ordering debug component.

Port of ``ompi_tpu/coll/sync.py`` (≈ the reference's ``coll/sync``):
with ``--mca coll_sync_barrier_before N`` a barrier is injected before
every Nth collective on the communicator (0 = off, the default), so a
program whose ranks issue collectives in different orders stops at the
injected barrier instead of corrupting data downstream.  The injected
barrier goes through the table, so SPC and monitoring count it like any
other.  Like the reference's, the module has no resolver: with sync on,
every collective takes the table path, where the shim sees it.
"""

from __future__ import annotations

import threading
from typing import Any

from ompi_tpu_torch.core import output
from ompi_tpu_torch.core.registry import Component, register_component


class SyncCollModule:
    """Wraps every stacked slot with the barrier-injection shim."""

    def __init__(self, comm, table, every: int):
        self.comm = comm
        self._table = table
        self._every = max(1, int(every))
        self._count = 0
        self._lock = threading.Lock()

    def enable(self) -> None:
        pass

    def disable(self) -> None:
        pass

    def provided(self) -> dict[str, Any]:
        # the barrier is the probe itself: wrapping it would recurse
        return {slot: fn if slot.endswith(("barrier", "barrier_init"))
                else self._wrap(slot, fn)
                for slot, fn in self._table.slots.items()}

    def _wrap(self, slot: str, fn):
        def shim(*args, **kwargs):
            with self._lock:
                self._count += 1
                fire = self._count % self._every == 0
            if fire:
                output.verbose(10, "coll", "coll/sync: barrier before %s #%d on %s",
                               slot, self._count, self.comm.name)
                self._table.lookup("barrier")()
            return fn(*args, **kwargs)

        shim.__name__ = f"sync_{slot}"
        return shim


@register_component
class SyncCollComponent(Component):
    """coll/sync — interposes at the very top of the coll stack."""

    FRAMEWORK = "coll"
    NAME = "sync"
    PRIORITY = 100  # above monitoring (99): sync sees the user's call order

    def register_params(self, store) -> None:
        super().register_params(store)
        self._store = store
        store.register(
            "coll", "sync", "barrier_before", 0, type="int",
            help="Inject a barrier before every Nth collective (0 = off; "
            "≈ coll_sync_barrier_before) — localizes collective-order "
            "mismatches at the injection point",
        )

    def open(self, store) -> bool:
        self._store = store
        return int(store.get("coll_sync_barrier_before", 0)) > 0

    def query(self, comm, table=None):
        if table is None or not table.slots:
            return None
        return SyncCollModule(
            comm, table, int(self._store.get("coll_sync_barrier_before", 0)))

    query.wants_table = True

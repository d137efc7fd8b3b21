"""Collective module interface + per-communicator selection/stacking.

Port of ``ompi_tpu/coll/module.py`` (≈ ``mca_coll_base_module_t`` and
``coll_base_comm_select.c``): each coll component's ``query(comm)``
returns a module providing a subset of the collective slots; modules
are applied in ascending priority order, each overwriting the slots it
provides, so the highest-priority provider of each slot wins and
``coll/basic`` backfills what ``coll/cuda`` does not serve.  A
component whose ``query`` carries ``wants_table`` sees the partly built
table, so that it can wrap the modules below it: ``coll/tuned`` (95)
wraps ``coll/cuda`` (90), ``coll/monitoring`` (99) and ``coll/sync``
(100) wrap every slot.

Data convention (rank-major): every buffer is a tensor whose leading
axis is the communicator rank — ``allreduce: (n,*s)→(n,*s)`` (equal
rows), ``allgather: (n,*s)→(n,n,*s)``, ``reduce_scatter_block:
(n,n,*s)→(n,*s)``, ``alltoall: (n,n,*s)→(n,n,*s)``.

``CollTable.lookup`` is the table path's choke point: it counts the
slot in SPC, notes the serving component for the straggler profiler and,
with tracing on, hands out the callable wrapped in a ``coll`` span
naming the winning component.
"""

from __future__ import annotations

from typing import Any, Callable

from ompi_tpu_torch.core import output
from ompi_tpu_torch.core.errors import MPIInternalError
from ompi_tpu_torch.metrics import straggler as _straggler
from ompi_tpu_torch.tool import spc
from ompi_tpu_torch.trace import core as _trace

#: every collective operation slot (blocking form); i-variants and
#: persistent *_init variants are derived slots: "i"+name, name+"_init"
COLL_OPS = (
    "allreduce",
    "bcast",
    "reduce",
    "allgather",
    "allgatherv",
    "gather",
    "gatherv",
    "scatter",
    "scatterv",
    "reduce_scatter",
    "reduce_scatter_block",
    "alltoall",
    "alltoallv",
    "barrier",
    "scan",
    "exscan",
)


def all_slots() -> list[str]:
    slots = []
    for op in COLL_OPS:
        slots += [op, "i" + op, op + "_init"]
    return slots


class CollModule:
    """One component's per-communicator module."""

    def __init__(self, comm):
        self.comm = comm

    def enable(self) -> None:
        """Called once the module won at least one slot."""

    def disable(self) -> None:
        pass

    def provided(self) -> dict[str, Callable[..., Any]]:
        out = {}
        for slot in all_slots():
            fn = getattr(self, slot, None)
            if callable(fn):
                out[slot] = fn
        return out


class CollTable:
    """The per-communicator function table (≈ comm->c_coll)."""

    def __init__(self):
        self.slots: dict[str, Callable[..., Any]] = {}
        self.providers: dict[str, str] = {}  # slot -> component name
        self.owners: dict[str, Any] = {}  # slot -> winning CollModule
        self.modules: list[CollModule] = []

    def lookup(self, slot: str):
        fn = self.slots.get(slot)
        if fn is None:
            raise MPIInternalError(
                f"no coll component provides {slot!r} on this communicator")
        spc.inc(slot)
        if _straggler._enabled:
            # dispatch-time note: which component serves the op
            _straggler.note_provider(slot, self.providers.get(slot, "?"))
        if _trace._enabled:
            # the coll span nests inside the caller's api span
            return _trace.wrap_call("coll", slot, fn,
                                    provider=self.providers.get(slot, "?"))
        return fn


def select_coll_modules(comm, framework) -> CollTable:
    """Build the comm's coll table by stacking module slots (lowest
    priority first, so the highest priority wins each slot)."""
    table = CollTable()
    comps = sorted(framework.selectable(), key=lambda c: (c.priority, c.NAME))
    for comp in comps:
        if getattr(comp.query, "wants_table", False):
            module = comp.query(comm, table)
        else:
            module = comp.query(comm)
        if module is None:
            continue
        table.modules.append(module)
        provided = module.provided()
        output.verbose(1, "coll", "comm %s: component %s provides %d slots",
                       getattr(comm, "name", "?"), comp.NAME, len(provided))
        for slot, fn in provided.items():
            table.slots[slot] = fn
            table.providers[slot] = comp.NAME
            table.owners[slot] = module
    missing = [op for op in COLL_OPS if op not in table.slots]
    if missing:
        output.show_help(
            "coll-select", "no-collective-module",
            "No collective component provides %s for communicator %s.\n"
            "Components queried: %s.  Check --mca coll selection lists.",
            missing, getattr(comm, "name", "?"), [c.NAME for c in comps],
        )
        raise MPIInternalError(
            f"no coll component provides {missing} for this communicator "
            f"(components queried: {[c.NAME for c in comps]})")
    for m in table.modules:
        m.enable()
    return table

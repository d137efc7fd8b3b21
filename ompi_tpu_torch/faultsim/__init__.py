"""faultsim — deterministic fault injection for the DCN transports.

Port of ``ompi_tpu/faultsim``: the Python transports' hook sites
(send, recv, dial, the shm ring) and the native plane's (the C ring
writer, tcp send, wire duplicate and blocking receive, armed through
the ``native_*_args`` helpers) are all there.

The reference validates its fault-tolerance story (ULFM,
``--with-ft=ulfm``, SURVEY.md §5) by externally killing ranks; the
transport failure paths themselves — a peer socket dying mid-frame, a
CTS that never comes, a wedged shared-memory ring — are only ever
exercised by real production incidents.  This subsystem makes those
paths testable in CI: a seeded, MCA-gated plan of scripted faults
(drop / delay / duplicate / truncate frames, kill connections, stall
or fail native ring writes, fail dials) that both DCN transports
consult at their choke points.

Contract (the trace/metrics discipline):

* **default off, zero hot-path cost** — every hook is one module-bool
  test (``core._enabled``); a run without ``--mca faultsim_enable 1``
  never constructs a plan, draws a random number, or takes a lock;
* **deterministic by seed** — every decision is a pure function of
  ``(seed, proc, site, event-index, rule)`` via a splitmix64-style
  hash (no RNG stream, no ``PYTHONHASHSEED`` sensitivity), so the
  same seed over the same workload injects the same faults, run after
  run, rank after rank — the reproducibility the chaos soak asserts;
* **observable** — every Python-plane injection bumps
  ``faultsim_injected_<kind>`` (MPI_T pvars + the metrics snapshot)
  and flight-records the transport counter state at the moment of
  injection; C-plane ring injections (``stall``/``ringfail``, armed
  via ``tdcn_fault_set``) count in the merged ``dcn_injected_faults``
  aggregate instead — ring writes never cross back into Python.

Plan grammar (``--mca faultsim_plan``)::

    plan  := rule ("," rule)*
    rule  := kind (":" arg (";" arg)*)?
    arg   := key "=" value

e.g. ``drop:p=0.01,delay:ms=50,connkill:at=100,stall:ms=200`` — see
:data:`core.KINDS` for the kind catalog and :class:`core.Rule` for
the per-kind argument semantics.
"""

from .core import (  # noqa: F401
    KINDS,
    FaultPlanError,
    actions,
    check_dial,
    configure,
    counters,
    disable,
    enabled,
    injected,
    native_conn_args,
    native_dup_args,
    native_recv_args,
    native_ring_args,
    parse_plan,
    reset,
    sync_from_store,
)
from . import core  # noqa: F401

"""MPI API layer, single-process part (port of ``ompi_tpu/api``).

``init()`` ≈ MPI_Init: builds the MCA context from ``--mca``-style
params, syncs the observability stack from it (tracing, metrics, SPC,
the memory checker),
brings up the world mesh of virtual ranks on the chosen device (CUDA
unless the caller asks for the CPU), and constructs COMM_WORLD and
COMM_SELF.  ``finalize()`` ≈ MPI_Finalize: writes the configured
exports (monitoring dump, metrics ``.prom``/``.jsonl``, Chrome trace)
and frees the world.  Both fire the ``core.hooks`` lifecycle hooks.

Under ``tpurun`` (``python -m ompi_tpu_torch run``) ``init()`` builds
this process's :class:`~ompi_tpu_torch.boot.proc.ProcContext` (the KVS
modex and the DCN engine) and returns a
:class:`~ompi_tpu_torch.api.multiproc.MultiProcComm` spanning every
process; COMM_SELF is the process's first rank.  The per-process
exports then name the process (``<out>.<proc>.*``, ``pid=proc``), and
``finalize()`` fences every process before closing the ProcContext.
A launched worker runs on CUDA unless the launcher's ``--cpu`` switch
set ``OMPI_TPU_DEVICE=cpu``.  With ``--mca telemetry_enable 1`` and a
launcher that hosts the aggregator, ``init()`` starts this process's
live telemetry publisher and ``finalize()`` stops it.

Serve plane (tpud): :func:`push_world`/:func:`pop_world` scope a job's
communicator as COMM_WORLD inside a resident worker (the job script's
``init()`` returns it, its ``finalize()`` pops the scope and leaves the
warm mesh up), :func:`set_world` installs a repaired world, and
:func:`tpud_submit` submits a script to a running daemon.

Also exported: ``Info``/``INFO_NULL``/``info_env`` (MPI_Info),
``create_intercomm``/``Intercomm`` (single-controller intercomms), and
``spawn``/``get_parent`` (dynamic process management under tpurun;
``finalize()`` waits the spawned children out).
"""

from __future__ import annotations

from ompi_tpu_torch.core import hooks, mca, output
from ompi_tpu_torch.core.errors import MPICommError

from .comm import COLOR_UNDEFINED, Comm  # noqa: F401
from .group import UNDEFINED, Group  # noqa: F401
from .info import INFO_NULL, Info, info_env  # noqa: F401
from .intercomm import Intercomm, create_intercomm  # noqa: F401
from .spawn import get_parent, spawn  # noqa: F401

_world: Comm | None = None
_self_comm: Comm | None = None
#: serve plane (tpud): saved resident worlds while a job world is
#: pushed — ``init()`` inside a served job script returns the JOB's
#: communicator, and ``finalize()`` pops the job scope instead of
#: tearing the warm mesh down (job re-arm, not finalize-teardown)
_world_stack: list[Comm] = []


def init(mca_params: dict[str, str] | None = None, device=None,
         nranks: int | None = None) -> Comm:
    """MPI_Init: returns COMM_WORLD.

    ``device`` defaults to CUDA and raises when no CUDA device is
    present; ``init(device="cpu")`` runs the ranks on the CPU.
    ``nranks`` defaults to ``--mca accelerator_cuda_nranks`` (8).
    ``--mca accelerator_cuda_layout devices`` gives every rank a buffer
    of its own, rank r on card ``r * count // nranks`` (all on ``cuda:0``
    with one card; all on the CPU with ``device="cpu"``); ``rows`` (the
    default) makes them the rows of one tensor.
    Under the launcher, ``device=None`` takes the launcher's choice
    (``OMPI_TPU_DEVICE``, set by its ``--cpu`` switch), else CUDA.
    Idempotent once initialized: later calls return the same world."""
    global _world, _self_comm
    if _world is not None:
        return _world
    hooks.fire("mpi_init_top")
    if mca_params:
        mca.init(mca_params)
    ctx = mca.default_context()
    ctx.open_all()
    output.register_verbose_var(ctx.store, "runtime")
    from ompi_tpu_torch import metrics
    from ompi_tpu_torch.tool import memchecker, spc
    from ompi_tpu_torch.trace import core as trace_core

    memchecker.register_var(ctx.store)
    memchecker.sync_from_store(ctx.store)

    for subsystem in (trace_core, metrics, spc):
        subsystem.register_vars(ctx.store)
        subsystem.sync_from_store(ctx.store)
    # causal tracing (trace_causal, implies the tracer) and the
    # straggler profiler (armed with the metrics plane)
    from ompi_tpu_torch.metrics import straggler
    from ompi_tpu_torch.trace import causal

    causal.sync_from_store(ctx.store)
    straggler.sync_from_store(ctx.store)
    # hang diagnosis (default on) and fault injection (default off) are
    # armed before the ProcContext, so engine bring-up is under them
    from ompi_tpu_torch import faultsim
    from ompi_tpu_torch.trace import waitgraph

    waitgraph.sync_from_store(ctx.store)
    faultsim.sync_from_store(ctx.store)
    from ompi_tpu_torch.boot.proc import ENV_DEVICE, launched_by_tpurun
    from ompi_tpu_torch.mesh.mesh import world_mesh

    if device is None and launched_by_tpurun():
        import os

        device = os.environ.get(ENV_DEVICE) or None
    wm = world_mesh(device, nranks)
    if launched_by_tpurun() and wm.layout == "devices":
        from ompi_tpu_torch.coll.cuda import unsupported_on_devices

        unsupported_on_devices("a job of several processes (tpurun)")
    if launched_by_tpurun():
        from ompi_tpu_torch.boot.proc import ProcContext

        from .multiproc import MultiProcComm

        _world = MultiProcComm(ProcContext(local_size=wm.size), wm,
                               name="MPI_COMM_WORLD")
        _self_comm = Comm(Group([_world.local_offset]), wm.submesh([0]),
                          name="MPI_COMM_SELF")
    else:
        _world = Comm(Group(range(wm.size)), wm, name="MPI_COMM_WORLD")
        _self_comm = Comm(Group([0]), wm.submesh([0]), name="MPI_COMM_SELF")
    from ompi_tpu_torch.metrics import flight

    flight.set_proc(int(getattr(_world, "proc", 0)))
    # live telemetry: start this process's frame pump when the launcher
    # hosts an aggregator (it sets OMPI_TPU_TELEMETRY_ADDR); a disabled
    # run opens no socket and starts no thread
    from ompi_tpu_torch.metrics import live

    live.start_publisher(_world, ctx.store)
    # crash-path export: a process that dies or aborts without reaching
    # finalize still flushes its configured metrics/trace outputs
    # (marked partial) — atexit covers aborts; the transports'
    # escalation paths call export.crash_dump directly
    _register_crash_flush()
    output.verbose(1, "runtime", "MPI_Init complete: world size %d on %s",
                   _world.size, wm.device)
    hooks.fire("mpi_init_bottom", world=_world)
    return _world


_crash_flush_registered = False


def _register_crash_flush() -> None:
    """Register the atexit telemetry flush once per interpreter: a
    process that exits while still initialized (``sys.exit`` mid-job,
    an unhandled error) writes its configured metrics/trace outputs
    with ``partial: true``.  After a clean finalize the hook does
    nothing."""
    global _crash_flush_registered
    if _crash_flush_registered:
        return
    _crash_flush_registered = True
    import atexit

    def _flush():
        if _world is not None:
            from ompi_tpu_torch.metrics import export

            export.crash_dump("atexit")

    atexit.register(_flush)


def initialized() -> bool:
    return _world is not None


# -- serve plane (tpud attach path) -------------------------------------


def push_world(comm) -> None:
    """Enter a job scope: ``comm`` becomes COMM_WORLD for code that
    calls :func:`init`/:func:`comm_world` until :func:`pop_world` —
    how a tpud resident worker runs an unmodified worker script in a
    warm mesh (the script's ``init()`` finds the job's communicator,
    its ``finalize()`` ends the job, not the daemon)."""
    global _world
    if _world is None:
        raise MPICommError("push_world before init")
    _world_stack.append(_world)
    _world = comm


def pop_world():
    """Leave the innermost job scope; returns the job comm that was
    active (None when no scope is pushed)."""
    global _world
    if not _world_stack:
        return None
    job, _world = _world, _world_stack.pop()
    return job


def in_job_scope() -> bool:
    return bool(_world_stack)


def set_world(comm) -> None:
    """Replace the resident COMM_WORLD (the serve plane's repair path:
    after ``replace()`` restores a full-size communicator, future jobs
    derive from the healed world, not the poisoned one)."""
    global _world
    if _world_stack:
        _world_stack[0] = comm
    else:
        _world = comm


def tpud_submit(url: str, script: str, args=(), tenant: str | None = None,
                wait: bool = True, timeout: float = 600.0) -> dict:
    """Submit ``script`` to a running ``tpud`` at ``url`` and (by
    default) wait for its completion record — the warm-world sibling
    of launching a fresh job.  Thin wrapper over
    :mod:`ompi_tpu_torch.serve.client`."""
    from ompi_tpu_torch.serve import client

    job = client.submit(url, script, args=args, tenant=tenant)
    if wait:
        return client.wait(url, job["id"], timeout=timeout)
    return job


def comm_world() -> Comm:
    if _world is None:
        raise MPICommError("call ompi_tpu_torch.api.init() first")
    return _world


def world(device=None, nranks: int | None = None) -> Comm:
    """COMM_WORLD, initializing on first use (same defaults as init)."""
    return init(device=device, nranks=nranks)


def comm_self() -> Comm:
    if _self_comm is None:
        raise MPICommError("call ompi_tpu_torch.api.init() first")
    return _self_comm


def _export_at_finalize(store, proc: int) -> None:
    """The finalize-time files, each when its output var is set: the
    monitoring dump, the metrics ``<out>.<proc>.prom``/``.jsonl`` and
    the Chrome trace ``<out>.<proc>.json`` (``proc`` 0 outside tpurun,
    where one process drives every rank)."""
    from ompi_tpu_torch import metrics
    from ompi_tpu_torch.trace import chrome
    from ompi_tpu_torch.trace import core as trace_core

    mon = store.get("monitoring_base_output", "")
    if mon:
        from ompi_tpu_torch.tool import monitoring

        monitoring.dump(str(mon))
    mout = store.get("metrics_output", "")
    if mout and metrics.enabled():
        from ompi_tpu_torch.metrics import export

        export.write(str(mout), proc=proc)
    tout = store.get("trace_output", "")
    if tout and trace_core.enabled():
        chrome.dump(f"{tout}.{proc}.json", pid=proc)


def finalize() -> None:
    """MPI_Finalize: write the exports, free the world objects and drop
    the MCA context.

    Inside a tpud job scope (:func:`push_world`) this is the JOB's
    finalize: the scope pops and the resident plane stays warm for the
    next job; the worker loop frees the job communicator itself."""
    global _world, _self_comm
    if _world_stack:
        pop_world()
        return
    hooks.fire("mpi_finalize_top", world=_world)
    # live telemetry: stop the frame pump before teardown (it sends one
    # final frame, so the aggregator holds finalize-time counters)
    try:
        from ompi_tpu_torch.metrics import live

        live.stop_publisher()
    except Exception:  # noqa: BLE001 — telemetry must never break finalize
        pass
    # spawned children: wait them out and drain their output while the
    # interpreter is fully alive (the exit hook alone races thread
    # teardown)
    from .spawn import _reap

    _reap()
    if _world is not None:
        try:
            _export_at_finalize(mca.default_context().store,
                                int(getattr(_world, "proc", 0)))
        except OSError as e:  # an unwritable path must not break finalize
            output.show_help("finalize", "export", "could not write an export: %s", e)
        pc = getattr(_world, "procctx", None)
        if pc is not None:
            pc.fence("finalize")  # all procs reach finalize before teardown
            pc.close()
        _world.free()
        _world = None
    if _self_comm is not None:
        _self_comm.free()
        _self_comm = None
    # the clean exports are written: re-arm the crash-path latch so a
    # later init/death cycle can flush again
    from ompi_tpu_torch.metrics import export

    export.reset_crash_latch()
    mca.reset()
    hooks.fire("mpi_finalize_bottom")

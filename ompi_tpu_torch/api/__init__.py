"""MPI API layer, single-process part (port of ``ompi_tpu/api``).

``init()`` ≈ MPI_Init: builds the MCA context from ``--mca``-style
params, syncs the observability stack from it (tracing, metrics, SPC,
the memory checker),
brings up the world mesh of virtual ranks on the chosen device (CUDA
unless the caller asks for the CPU), and constructs COMM_WORLD and
COMM_SELF.  ``finalize()`` ≈ MPI_Finalize: writes the configured
exports (monitoring dump, metrics ``.prom``/``.jsonl``, Chrome trace)
and frees the world.  Both fire the ``core.hooks`` lifecycle hooks.
"""

from __future__ import annotations

from ompi_tpu_torch.core import hooks, mca, output
from ompi_tpu_torch.core.errors import MPICommError

from .comm import COLOR_UNDEFINED, Comm  # noqa: F401
from .group import UNDEFINED, Group  # noqa: F401

_world: Comm | None = None
_self_comm: Comm | None = None


def init(mca_params: dict[str, str] | None = None, device=None,
         nranks: int | None = None) -> Comm:
    """MPI_Init: returns COMM_WORLD.

    ``device`` defaults to CUDA and raises when no CUDA device is
    present; ``init(device="cpu")`` runs the ranks on the CPU.
    ``nranks`` defaults to ``--mca accelerator_cuda_nranks`` (8).
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
    from ompi_tpu_torch.mesh.mesh import world_mesh

    wm = world_mesh(device, nranks)
    _world = Comm(Group(range(wm.size)), wm, name="MPI_COMM_WORLD")
    _self_comm = Comm(Group([0]), wm.submesh([0]), name="MPI_COMM_SELF")
    output.verbose(1, "runtime", "MPI_Init complete: world size %d on %s",
                   _world.size, wm.device)
    hooks.fire("mpi_init_bottom", world=_world)
    return _world


def initialized() -> bool:
    return _world is not None


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


def _export_at_finalize(store) -> None:
    """The finalize-time files, each when its output var is set: the
    monitoring dump, the metrics ``<out>.0.prom``/``.jsonl`` and the
    Chrome trace ``<out>.0.json`` (one process drives every rank)."""
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

        export.write(str(mout), proc=0)
    tout = store.get("trace_output", "")
    if tout and trace_core.enabled():
        chrome.dump(f"{tout}.0.json", pid=0)


def finalize() -> None:
    """MPI_Finalize: write the exports, free the world objects and drop
    the MCA context."""
    global _world, _self_comm
    hooks.fire("mpi_finalize_top", world=_world)
    if _world is not None:
        try:
            _export_at_finalize(mca.default_context().store)
        except OSError as e:  # an unwritable path must not break finalize
            output.show_help("finalize", "export", "could not write an export: %s", e)
        _world.free()
        _world = None
    if _self_comm is not None:
        _self_comm.free()
        _self_comm = None
    mca.reset()
    hooks.fire("mpi_finalize_bottom")

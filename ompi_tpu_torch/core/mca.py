"""Process-global default MCA context (own copy of ``ompi_tpu/core/mca.py``)."""

from __future__ import annotations

from .registry import MCAContext, load_external_components

_default: MCAContext | None = None

#: modules whose import registers the in-tree components
_BUILTIN_COMPONENT_MODULES = (
    "ompi_tpu_torch.mesh.mesh",
    "ompi_tpu_torch.coll",
    "ompi_tpu_torch.tool.monitoring",
    "ompi_tpu_torch.p2p",
    "ompi_tpu_torch.osc",
    "ompi_tpu_torch.io",
    "ompi_tpu_torch.dcn.component",
    "ompi_tpu_torch.ft.detector",
)


def _load_builtin_components() -> None:
    import importlib

    for mod in _BUILTIN_COMPONENT_MODULES:
        importlib.import_module(mod)


def default_context() -> MCAContext:
    global _default
    if _default is None:
        _load_builtin_components()
        load_external_components()
        _default = MCAContext()
    _default.refresh_components()
    return _default


def init(cmdline: dict[str, str] | None = None) -> MCAContext:
    """(Re)create the default context with command-line ``--mca`` params."""
    global _default
    _load_builtin_components()
    load_external_components()
    _default = MCAContext(cmdline=cmdline)
    return _default


def reset() -> None:
    """Drop the default context."""
    global _default
    if _default is not None:
        _default.close_all()
    _default = None

"""MPI_T — the MPI tool information interface.

Port of ``ompi_tpu/tool/mpit.py`` (≈ ``ompi/mpi/tool/``): every MCA var
is a **control variable** (cvar) and every counter a **performance
variable** (pvar), addressed by index as the C API does:

* ``init_thread() / finalize()`` — refcounted tool sessions;
* cvars: ``cvar_get_num / cvar_get_info / cvar_index / cvar_read /
  cvar_write`` over the default context's VarStore;
* pvars: ``pvar_get_num / pvar_get_info / pvar_index / pvar_read /
  pvar_reset / pvar_reset_one / pvar_start / pvar_stop`` over the SPC
  counters, the metrics core's counter schema (``dcn_*``) and per-op
  size histograms, the fault plane's injection counts, the tracer's
  totals and per-(layer, op) spans, the causal tracer's counters and the
  straggler profiler's per-op totals — in the reference's index order;
* categories: one per framework.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ompi_tpu_torch import faultsim
from ompi_tpu_torch.core.errors import MPIArgError, MPIError
from ompi_tpu_torch.metrics import core as metrics
from ompi_tpu_torch.metrics import straggler
from ompi_tpu_torch.trace import causal
from ompi_tpu_torch.trace import core as trace

from . import spc

# MPI_T verbosity / scope / class constants (values: reference mpi.h)
VERBOSITY_USER_BASIC = 221
SCOPE_ALL_EQ = 60
PVAR_CLASS_COUNTER = 243
#: array-valued pvars (histograms): reads return a list of bucket counts
PVAR_CLASS_AGGREGATE = 246

_sessions = 0


class MPITNotInitialized(MPIError):
    pass


def init_thread() -> int:
    """MPI_T_init_thread: returns the session nesting level."""
    global _sessions
    _sessions += 1
    return _sessions


def finalize() -> int:
    global _sessions
    if _sessions == 0:
        raise MPITNotInitialized("MPI_T_finalize without init")
    _sessions -= 1
    return _sessions


def _check():
    if _sessions == 0:
        raise MPITNotInitialized("call MPI_T init_thread first")


def _store():
    from ompi_tpu_torch.core import mca

    return mca.default_context().store


def _at(names: list[str], index: int, kind: str) -> str:
    if not 0 <= index < len(names):
        raise MPIArgError(f"{kind} index {index} out of range")
    return names[index]


# -- control variables (cvars) -------------------------------------------


@dataclass
class CvarInfo:
    name: str
    type: str
    default: Any
    help: str
    scope: int = SCOPE_ALL_EQ
    verbosity: int = VERBOSITY_USER_BASIC


def _cvar_names() -> list[str]:
    return [v.full_name for v in _store().all_vars()]


def cvar_get_num() -> int:
    _check()
    return len(_cvar_names())


def cvar_get_info(index: int) -> CvarInfo:
    _check()
    v = _store().get_var(_at(_cvar_names(), index, "cvar"))
    return CvarInfo(v.full_name, v.type, v.default, v.help)


def cvar_index(name: str) -> int:
    """MPI_T_cvar_get_index: name → index."""
    _check()
    try:
        return _cvar_names().index(name)
    except ValueError:
        raise MPIArgError(f"no cvar named {name}") from None


def cvar_read(index: int) -> Any:
    _check()
    return _store().get(_at(_cvar_names(), index, "cvar"))


def cvar_write(index: int, value: Any) -> None:
    _check()
    _store().set(_at(_cvar_names(), index, "cvar"), value)


# -- performance variables (pvars) ---------------------------------------


@dataclass
class PvarInfo:
    name: str
    var_class: int
    help: str


def _pvar_names(refresh: bool = False) -> list[str]:
    """The fixed segments first (spc, dcn, faultsim, the tracer's and the
    causal tracer's totals), then the grow-only tails (trace spans,
    metrics sizes, straggler ops) in first-seen order, so an index cached
    in a pvar handle keeps naming the same variable.  ``refresh`` sweeps
    the native straggler providers for new C-fast-path ops (discovery
    entry points do; a pvar read does not)."""
    names = ["spc_" + k for k in spc.known()]
    names += ["dcn_" + k for k in metrics.NATIVE_COUNTERS]
    names += ["faultsim_injected_" + k for k in faultsim.KINDS]
    names += ["trace_events", "trace_dropped"]
    names += [f"trace_causal_{k}" for k in causal.PVARS]
    for layer, op in trace.span_ops():
        names.append(f"trace_span_{layer}_{op}_count")
        names.append(f"trace_span_{layer}_{op}_hist")
    for op in metrics.size_ops():
        names.append(f"metrics_size_{op}_hist")
    for op in straggler.ops(refresh=refresh):
        names.append(f"straggler_{op}_count")
        names.append(f"straggler_{op}_wait_ns")
    return names


def _trace_key(name: str) -> tuple[str, str]:
    """trace_span_<layer>_<op> → (layer, op); layers hold no underscore."""
    layer, _, op = name[len("trace_span_"):].partition("_")
    return layer, op


def pvar_get_num() -> int:
    _check()
    return len(_pvar_names(refresh=True))


def pvar_get_info(index: int) -> PvarInfo:
    _check()
    name = _at(_pvar_names(), index, "pvar")
    if name.startswith("dcn_"):
        return PvarInfo(name, PVAR_CLASS_COUNTER,
                        f"native DCN transport counter {name[4:]} "
                        "(libtpudcn telemetry block)")
    if name.startswith("faultsim_injected_"):
        return PvarInfo(name, PVAR_CLASS_COUNTER,
                        f"faults of kind {name[len('faultsim_injected_'):]}"
                        " injected by the seeded fault plane")
    if name.startswith("metrics_size_"):
        op = name[len("metrics_size_"):-len("_hist")]
        return PvarInfo(name, PVAR_CLASS_AGGREGATE,
                        f"payload size histogram (log2 byte buckets) {op}")
    if name.startswith("straggler_"):
        if name.endswith("_wait_ns"):
            op, what = name[len("straggler_"):-len("_wait_ns")], "wait_ns"
        else:
            op, what = name[len("straggler_"):-len("_count")], "count"
        return PvarInfo(name, PVAR_CLASS_COUNTER,
                        f"collective straggler profiler: {what} for {op} "
                        "(in-op wall time)")
    if name.startswith("trace_causal_"):
        return PvarInfo(name, PVAR_CLASS_COUNTER,
                        f"causal tracing {name[len('trace_causal_'):]} "
                        "(per-collective causal records / wire-context "
                        "edges; trace/causal.py)")
    if name.startswith("trace_"):
        if name.endswith("_hist"):
            layer, op = _trace_key(name)
            return PvarInfo(name, PVAR_CLASS_AGGREGATE,
                            f"trace span latency histogram (log2 µs "
                            f"buckets) {layer}/{op[:-len('_hist')]}")
        return PvarInfo(name, PVAR_CLASS_COUNTER, f"trace counter {name[6:]}")
    return PvarInfo(name, PVAR_CLASS_COUNTER, f"SPC counter {name[4:]}")


def pvar_index(name: str) -> int:
    _check()
    try:
        return _pvar_names(refresh=True).index(name)
    except ValueError:
        raise MPIArgError(f"no pvar named {name}") from None


def pvar_read(index: int):
    _check()
    name = _at(_pvar_names(), index, "pvar")
    if name.startswith("dcn_"):
        return metrics.native_value(name[4:])
    if name.startswith("faultsim_injected_"):
        return faultsim.injected(name[len("faultsim_injected_"):])
    if name.startswith("metrics_size_"):
        return metrics.size_histogram(name[len("metrics_size_"):-len("_hist")])
    if name.startswith("straggler_"):
        if name.endswith("_wait_ns"):
            return straggler.op_wait_ns(name[len("straggler_"):-len("_wait_ns")])
        return straggler.op_count(name[len("straggler_"):-len("_count")])
    if name.startswith("trace_causal_"):
        return causal.counter(name[len("trace_causal_"):])
    if name == "trace_events":
        return trace.event_count()
    if name == "trace_dropped":
        return trace.dropped()
    if name.startswith("trace_span_"):
        layer, op = _trace_key(name)
        if op.endswith("_count"):
            return trace.span_count(layer, op[: -len("_count")])
        return trace.latency_histogram(layer, op[: -len("_hist")])
    return spc.get(name[4:])


def pvar_reset() -> None:
    """Session-wide pvar reset: zero every counter.  The trace event
    ring, seq counters and pvar namespace survive."""
    _check()
    spc.reset()
    trace.zero_stats()
    causal.zero_counters()
    metrics.zero_stats()
    straggler.zero_stats()


def pvar_reset_one(index: int) -> None:
    """MPI_T_pvar_reset on one handle.  ``trace_events`` is a buffer
    watermark whose reset would discard the recorded timeline, so it
    refuses; a span's ``_count``/``_hist`` pair reset together."""
    _check()
    name = _at(_pvar_names(), index, "pvar")
    if name == "trace_events":
        raise MPIArgError(
            "trace_events is a buffer watermark; resetting it would "
            "discard the recorded timeline (use ompi_tpu_torch.trace.reset())")
    if name == "trace_dropped":
        trace.reset_dropped()
    elif name.startswith("trace_causal_"):
        causal.reset_counter(name[len("trace_causal_"):])
    elif name.startswith("faultsim_injected_"):
        raise MPIArgError(
            f"{name} is injection evidence for the active fault plan; "
            "it resets with the plan (faultsim.configure), not per pvar")
    elif name.startswith("trace_span_"):
        layer, op = _trace_key(name)
        trace.reset_span_stat(layer, op.rsplit("_", 1)[0])
    elif name.startswith("dcn_"):
        metrics.reset_native(name[4:])
    elif name.startswith("metrics_size_"):
        metrics.reset_op(name[len("metrics_size_"):-len("_hist")])
    elif name.startswith("straggler_"):
        # _count/_wait_ns are two views of ONE aggregate: reset together
        straggler.reset_op(name[len("straggler_"):-len("_wait_ns")]
                           if name.endswith("_wait_ns")
                           else name[len("straggler_"):-len("_count")])
    else:
        spc.reset_one(name[len("spc_"):])


def pvar_start() -> None:
    """MPI_T_pvar_start: attach the SPC counters."""
    _check()
    spc.attach(True)


def pvar_stop() -> None:
    _check()
    spc.attach(False)


# -- categories ------------------------------------------------------------


def _categories() -> list[tuple[str, int]]:
    counts: dict[str, int] = {}
    for name in _cvar_names():
        fw = name.split("_", 1)[0]
        counts[fw] = counts.get(fw, 0) + 1
    return sorted(counts.items())


def category_get_num() -> int:
    _check()
    return len(_categories())


def category_get_info(index: int) -> tuple[str, int]:
    """(framework name, number of cvars in it)."""
    _check()
    cats = _categories()
    if not 0 <= index < len(cats):
        raise MPIArgError(f"category index {index} out of range")
    return cats[index]

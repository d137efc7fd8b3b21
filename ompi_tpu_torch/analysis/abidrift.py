"""Pass 3 — C↔Python ABI drift checking, over the port's libraries.

The native planes and the Python control plane share contracts that
drift silently because no compiler sees both sides:

``stat-names-drift`` / ``stat-append-only``
    ``ompi_tpu_torch/csrc/dcn.cc:TDCN_STAT_NAMES`` (the self-describing
    counter name table the C block exports) must equal ``"version"`` +
    the Python schema ``ompi_tpu_torch/metrics/core.py:NATIVE_COUNTERS``
    — same names, same order.  The v1 prefix is FROZEN: those names are live MPI_T pvar names and cached pvar
    indices; new counters append at the tail only, and the C version
    slot stays 1 while the schema is append-only.

``abi-missing-symbol`` / ``abi-arity`` / ``abi-type``
    Every ctypes signature the port declares for an ``extern "C"``
    library it loads (:data:`LIBRARIES`: ``tdcn_*`` of ``dcn.cc`` in
    ``dcn/native.py``, the ring-hop kernels' ``ompi_ring_*`` of
    ``ring_hop.cu`` in ``coll/cuda_kernels.py``, the device windows'
    ``ompi_dw_*`` of ``device_window.cu`` in ``dcn/device.py``, the
    convertor's ``tpuconv_*`` of ``convertor.cc`` in ``native.py``) must
    match the definition: the symbol exists, the parameter count
    agrees, and each parameter/return slot agrees at machine-width
    granularity (ptr / int32 / int64 / uint64 / double).  A silent
    int-vs-int64 mismatch truncates on the call boundary — the
    classic ctypes failure mode (a 1 GiB hop's byte count cut to 32
    bits).

``abi-undeclared-call``
    A symbol of one of those libraries referenced from its binding
    module with NO ``argtypes`` declaration — ctypes falls back to
    int-width guessing, which breaks on 64-bit handles and doubles.

``abi-shim-decl``
    The C ABI's shims (``csrc/capi/shim.c``, ``csrc/capi/shmem_shim.c``)
    or the sanitizer soak (``csrc/dcn_sanity.cc``) re-declare a
    ``tdcn_*`` extern with a parameter count that disagrees with
    ``dcn.cc`` — C has no cross-TU checking for this; the linker
    happily binds the wrong arity.

``catalog-drift``
    The README operator surface (its ``## PyTorch/H100 port`` section):
    every centrally registered MCA var, every ``NATIVE_COUNTERS``
    entry, and every ops HTTP route (``add_route`` literals + the
    aggregator's built-in endpoints) must appear there — and every
    ``/endpoint`` row of its ops table must exist in code.

``wire-ctx-drift`` / ``wire-ctx-append-only``
    The causal-tracing wire context (``trace/causal.py:CTX_FIELDS``)
    vs its C mirror (``dcn.cc:TDCN_TRACE_CTX_FIELDS``): same fields,
    same order, both sides — and the v1 prefix is FROZEN with new
    fields appended at the tail only (the TdcnStats contract applied
    to the wire: peers parse contexts by position, so a reorder or
    rename inside the frozen prefix silently mis-decodes every frame
    between mixed builds).

``plane-catalog-drift``
    The plane-health family, both directions: the ``plane_*``
    counters must agree between ``NATIVE_COUNTERS`` and the device
    plane's ``STATS_KEYS`` (the provider merge silently drops a key
    missing from either), every ``plane_*`` counter and ``dcn_plane_*``
    knob must appear in the README plane-health catalog, and every
    backticked ``plane_*`` name the README promises must exist in
    code — stale catalog entries are drift too.

``pvar-name-lint``
    The ``trace_causal_*`` pvar family (``causal.PVARS``): every name
    is a well-formed lowercase identifier, collides with no other
    trace-pvar namespace segment (``trace_span_`` would shadow the
    layer parser), and its full ``trace_causal_<name>`` form is
    documented in the README counter catalog.

Everything is parsed statically (AST for Python, regex over the
``extern "C"`` definitions for C, C++ and CUDA: templates, kernels and
macros outside the symbol prefix are never read as exports) — the pass
never imports or builds the modules it is judging.
"""

from __future__ import annotations

import ast
import re
from functools import lru_cache
from pathlib import Path

from ompi_tpu_torch.analysis.findings import SEV_ERROR, SEV_WARN, Finding
from ompi_tpu_torch.analysis.repo import (
    PORT,
    README,
    central_var_tables,
    parse_py,
    readme_port_section,
    rel,
)

PASS = "abidrift"

DCN_CC = f"{PORT}/csrc/dcn.cc"
SHIM_C = f"{PORT}/csrc/capi/shim.c"
SHMEM_SHIM_C = f"{PORT}/csrc/capi/shmem_shim.c"
SANITY_CC = f"{PORT}/csrc/dcn_sanity.cc"
NATIVE_PY = f"{PORT}/dcn/native.py"
METRICS_CORE = f"{PORT}/metrics/core.py"
CAUSAL_PY = f"{PORT}/trace/causal.py"
DEVICE_PY = f"{PORT}/dcn/device.py"
LIVE_PY = f"{PORT}/metrics/live.py"

#: every ``extern "C"`` library the port loads with ctypes:
#: (source, prefix of its exported symbols, module declaring the ctypes
#: signatures)
LIBRARIES = (
    (DCN_CC, "tdcn_", NATIVE_PY),
    (f"{PORT}/csrc/ring_hop.cu", "ompi_ring_", f"{PORT}/coll/cuda_kernels.py"),
    (f"{PORT}/csrc/ring_hop_peer.cu", "ompi_peer_", f"{PORT}/coll/cuda_kernels.py"),
    (f"{PORT}/csrc/device_window.cu", "ompi_dw_", DEVICE_PY),
    (f"{PORT}/csrc/convertor.cc", "tpuconv_", f"{PORT}/native.py"),
)

#: C sources that re-declare the engine's ``tdcn_*`` externs
TDCN_REDECLARERS = (SHIM_C, SHMEM_SHIM_C, SANITY_CC)


def _readme(root: Path) -> str:
    """The README's port section: the port's operator catalogs."""
    return readme_port_section(root)[0]


#: the frozen v1 counter prefix (the first shipped schema, version slot
#: excluded).  These are live MPI_T pvar names with cached indices —
#: renaming or reordering ANY of them is an ABI break even though the
#: tails behind them may grow.
V1_FROZEN_PREFIX = (
    "doorbells", "stall_ns", "ring_stall_ns", "ring_stalls", "ring_hwm",
    "cts_wait_ns", "cts_waits", "rndv_depth", "rndv_hwm", "slot_waits",
    "eager_msgs", "eager_bytes", "chunked_msgs", "chunked_bytes",
    "rndv_msgs", "rndv_bytes", "delivered", "unexpected_hwm",
)


# -- the two counter name tables ----------------------------------------

def c_stat_names(root: Path) -> tuple[list[str], int]:
    """(names, line) parsed from the TDCN_STAT_NAMES concatenated
    string literal in dcn.cc; ([], 0) when unparseable."""
    src = root / DCN_CC
    try:
        text = src.read_text()
    except OSError:
        return [], 0
    m = re.search(
        r"TDCN_STAT_NAMES\s*=\s*((?:\s*\"[^\"]*\")+)\s*;", text)
    if not m:
        return [], 0
    line = text[:m.start()].count("\n") + 1
    joined = "".join(re.findall(r'"([^"]*)"', m.group(1)))
    return [n for n in joined.split(",") if n], line


def py_native_counters(root: Path) -> tuple[list[str], int]:
    """(names, line) of metrics/core.py NATIVE_COUNTERS."""
    tree = parse_py(root / METRICS_CORE)
    if tree is None:
        return [], 0
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "NATIVE_COUNTERS"
                and isinstance(node.value, ast.Tuple)):
            names = [e.value for e in node.value.elts
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str)]
            return names, node.lineno
    return [], 0


def check_stat_names(root: Path) -> list[Finding]:
    out: list[Finding] = []
    c_names, c_line = c_stat_names(root)
    py_names, py_line = py_native_counters(root)
    if not c_names:
        out.append(Finding(
            PASS, "stat-names-drift", DCN_CC, 0, "TDCN_STAT_NAMES",
            "cannot parse TDCN_STAT_NAMES from dcn.cc — the checker "
            "(and the Python schema reader) need the concatenated "
            "string-literal form", SEV_ERROR))
        return out
    if not py_names:
        out.append(Finding(
            PASS, "stat-names-drift", METRICS_CORE, 0, "NATIVE_COUNTERS",
            "cannot parse NATIVE_COUNTERS tuple from metrics/core.py",
            SEV_ERROR))
        return out
    expect = ["version"] + py_names
    if c_names != expect:
        # localize the first divergence for the message
        detail = ""
        for i, (a, b) in enumerate(zip(c_names, expect)):
            if a != b:
                detail = (f"first divergence at index {i}: "
                          f"C has {a!r}, Python has {b!r}")
                break
        else:
            longer = "C" if len(c_names) > len(expect) else "Python"
            extra = (c_names[len(expect):] if longer == "C"
                     else expect[len(c_names):])
            detail = f"{longer} side has extra tail entries {extra}"
        out.append(Finding(
            PASS, "stat-names-drift", DCN_CC, c_line, "TDCN_STAT_NAMES",
            "TDCN_STAT_NAMES != ['version'] + NATIVE_COUNTERS "
            f"(metrics/core.py:{py_line}) — {detail}; the name table "
            "is the single source of schema truth and both sides must "
            "agree exactly (names AND order)", SEV_ERROR))
    # append-only: the frozen v1 prefix must open both tables
    for side, names, f, ln in (("C", c_names[1:], DCN_CC, c_line),
                               ("Python", py_names, METRICS_CORE, py_line)):
        prefix = tuple(names[:len(V1_FROZEN_PREFIX)])
        if prefix != V1_FROZEN_PREFIX:
            bad = next((i for i, (a, b) in enumerate(
                zip(prefix, V1_FROZEN_PREFIX)) if a != b),
                len(prefix))
            out.append(Finding(
                PASS, "stat-append-only", f, ln,
                "TDCN_STAT_NAMES" if side == "C" else "NATIVE_COUNTERS",
                f"{side} counter table breaks the frozen v1 prefix at "
                f"index {bad} (have {list(prefix[bad:bad + 2])!r}, "
                f"frozen {list(V1_FROZEN_PREFIX[bad:bad + 2])!r}) — "
                "these are live MPI_T pvar names; the schema is "
                "append-only (new counters go at the tail, version "
                "stays 1)", SEV_ERROR))
    return out


# -- C prototypes vs ctypes signatures ----------------------------------

#: machine-width classes both sides collapse to
_C_TYPE_CLASS = (
    (re.compile(r"\*"), "ptr"),
    (re.compile(r"\bdouble\b"), "double"),
    (re.compile(r"\buint64_t\b|\bunsigned long long\b|\bsize_t\b"),
     "uint64"),
    (re.compile(r"\bint64_t\b|\blong long\b"), "int64"),
    (re.compile(r"\buint32_t\b"), "uint32"),
    (re.compile(r"\bint\b"), "int32"),
    (re.compile(r"\bvoid\b"), "void"),
)

_CTYPES_CLASS = {
    "c_void_p": "ptr", "c_char_p": "ptr", "POINTER": "ptr",
    "c_double": "double", "c_uint64": "uint64", "c_int64": "int64",
    "c_ulonglong": "uint64", "c_longlong": "int64", "c_size_t": "uint64",
    "c_uint32": "uint32", "c_int": "int32", "c_int32": "int32",
}


def _c_class(decl: str) -> str:
    for rx, cls in _C_TYPE_CLASS:
        if rx.search(decl):
            return cls
    return "unknown"


@lru_cache(maxsize=None)
def _c_fn_re(prefix: str) -> re.Pattern:
    return re.compile(
        r"^[ \t]*((?:const[ \t]+)?[A-Za-z_][A-Za-z0-9_]*(?:[ \t]+[A-Za-z_]"
        r"[A-Za-z0-9_]*)?[ \t*]*?)\b(" + re.escape(prefix)
        + r"[A-Za-z0-9_]*)\s*\(([^;{]*?)\)\s*\{",
        re.M | re.S)


def _param_list(params: str) -> list[str]:
    params = re.sub(r"\s+", " ", params).strip()
    return ([] if params in ("", "void")
            else [p.strip() for p in params.split(",")])


def c_functions(text: str, prefix: str = "tdcn_"
                ) -> dict[str, tuple[int, str, list[str]]]:
    """name → (line, return_decl, [param_decl]) for every definition of
    a ``prefix``-named function in a C/C++/CUDA source blob."""
    out: dict[str, tuple[int, str, list[str]]] = {}
    for m in _c_fn_re(prefix).finditer(text):
        ret, name, params = m.group(1), m.group(2), m.group(3)
        line = text[:m.start()].count("\n") + 1
        out[name] = (line, ret.strip(), _param_list(params))
    return out


_C_EXTERN_RE = re.compile(
    r"^[ \t]*extern[ \t]+((?:const[ \t]+)?[A-Za-z_][A-Za-z0-9_ ]*?[ \t*]+)"
    r"(tdcn_[A-Za-z0-9_]*)\s*\(([^;{]*?)\)\s*;",
    re.M | re.S)


def c_extern_decls(text: str) -> dict[str, tuple[int, list[str]]]:
    """name → (line, [param_decl]) for tdcn_* extern declarations."""
    out: dict[str, tuple[int, list[str]]] = {}
    for m in _C_EXTERN_RE.finditer(text):
        out[m.group(2)] = (text[:m.start()].count("\n") + 1,
                           _param_list(m.group(3)))
    return out


def _ctypes_expr_class(node: ast.AST, aliases: dict[str, str]) -> str:
    """Collapse a ctypes expression (Name alias, ctypes.c_*, POINTER(…),
    c_T * N arrays) to a machine-width class."""
    if isinstance(node, ast.Name):
        base = aliases.get(node.id)
        if base is not None:
            return _CTYPES_CLASS.get(base, "unknown")
        return _CTYPES_CLASS.get(node.id, "unknown")
    if isinstance(node, ast.Attribute):
        return _CTYPES_CLASS.get(node.attr, "unknown")
    if isinstance(node, ast.Call):
        fname = (node.func.attr if isinstance(node.func, ast.Attribute)
                 else node.func.id if isinstance(node.func, ast.Name)
                 else "")
        if fname == "POINTER":
            return "ptr"
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        return "ptr"  # ctypes array types decay to pointers at the ABI
    return "unknown"


class _CtypesDecls(ast.NodeVisitor):
    """Collect ``lib.<prefix>*.argtypes``/``.restype`` declarations,
    ctypes aliases (``p, ll, i = ctypes.c_void_p, …`` inside a loader
    function too), and every ``<prefix>*`` attribute reference of one
    binding module."""

    def __init__(self, prefix: str) -> None:
        self.prefix = prefix
        self.aliases: dict[str, str] = {}   # P -> c_void_p, MSG -> POINTER
        #: symbol → (line, argtype expression nodes)
        self.argtypes: dict[str, tuple[int, list[ast.AST]]] = {}
        #: symbol → (line, restype expression node)
        self.restype: dict[str, tuple[int, ast.AST]] = {}
        self.referenced: dict[str, int] = {}

    def visit_Assign(self, node: ast.Assign) -> None:
        # tuple-unpacked aliases: P, I, … = (ctypes.c_void_p, …)
        if (len(node.targets) == 1 and isinstance(node.targets[0], ast.Tuple)
                and isinstance(node.value, ast.Tuple)
                and len(node.targets[0].elts) == len(node.value.elts)):
            for t, v in zip(node.targets[0].elts, node.value.elts):
                if isinstance(t, ast.Name) and isinstance(v, ast.Attribute):
                    self.aliases[t.id] = v.attr
        # single alias: MSG = ctypes.POINTER(TdcnMsg)
        if (len(node.targets) == 1 and isinstance(node.targets[0], ast.Name)):
            v = node.value
            if isinstance(v, ast.Attribute) and v.attr.startswith("c_"):
                self.aliases[node.targets[0].id] = v.attr
            elif (isinstance(v, ast.Call)
                  and isinstance(v.func, (ast.Attribute, ast.Name))
                  and (v.func.attr if isinstance(v.func, ast.Attribute)
                       else v.func.id) == "POINTER"):
                self.aliases[node.targets[0].id] = "POINTER"
        # lib.<prefix>X.argtypes / .restype
        tgt = node.targets[0] if len(node.targets) == 1 else None
        if (isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Attribute)
                and tgt.value.attr.startswith(self.prefix)):
            sym = tgt.value.attr
            if tgt.attr == "argtypes" and isinstance(node.value, ast.List):
                self.argtypes[sym] = (node.lineno, node.value.elts)
            elif tgt.attr == "restype":
                self.restype[sym] = (node.lineno, node.value)
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if node.attr.startswith(self.prefix):
            self.referenced.setdefault(node.attr, node.lineno)
        self.generic_visit(node)


def _compatible(a: str, b: str) -> bool:
    # int32 passed for uint32 flags is ABI-identical
    return a == b or {a, b} == {"int32", "uint32"}


def check_library(root: Path, c_rel: str, prefix: str, py_rel: str,
                  checked: set[str] | None = None) -> list[Finding]:
    """The ctypes rules for one library: ``c_rel``'s ``prefix``-named
    definitions against ``py_rel``'s declarations.  ``checked`` (when
    given) receives every symbol whose declared argtypes were all
    classified and compared with its definition."""
    out: list[Finding] = []
    try:
        c_text: str | None = (root / c_rel).read_text()
    except OSError:
        c_text = None  # every symbol the binding names is then missing
    tree = parse_py(root / py_rel)
    if tree is None:
        if c_text is None:
            return []  # neither side of this library exists
        return [Finding(PASS, "abi-undeclared-call", py_rel, 0, "",
                        f"cannot parse {py_rel}", SEV_ERROR)]
    cdefs = c_functions(c_text or "", prefix)
    decls = _CtypesDecls(prefix)
    decls.visit(tree)
    for sym, (line, elts) in sorted(decls.argtypes.items()):
        if sym not in cdefs:
            out.append(Finding(
                PASS, "abi-missing-symbol", py_rel, line, sym,
                f"ctypes declares {sym} but {c_rel} exports no such "
                "function — renamed or removed on the C side",
                SEV_ERROR))
            continue
        c_line, c_ret, c_params = cdefs[sym]
        if len(elts) != len(c_params):
            out.append(Finding(
                PASS, "abi-arity", py_rel, line, sym,
                f"argtypes declares {len(elts)} parameters but "
                f"{c_rel}:{c_line} defines {len(c_params)} — ctypes "
                "will mis-marshal every call", SEV_ERROR))
            continue
        classified = True
        for i, (el, cp) in enumerate(zip(elts, c_params)):
            py_cls = _ctypes_expr_class(el, decls.aliases)
            c_cls = _c_class(cp)
            if py_cls == "unknown" or c_cls == "unknown":
                classified = False
                continue  # conservatively skip what we cannot classify
            if not _compatible(py_cls, c_cls):
                out.append(Finding(
                    PASS, "abi-type", py_rel, line, sym,
                    f"argtypes[{i}] is {py_cls} but the C parameter "
                    f"({cp!r} at {c_rel}:{c_line}) is {c_cls} — "
                    "width mismatch truncates/garbles at the call "
                    "boundary", SEV_ERROR))
        if classified and checked is not None:
            checked.add(sym)
    for sym, (line, node) in sorted(decls.restype.items()):
        if sym not in cdefs:
            continue  # missing-symbol already reported via argtypes
        c_line, c_ret, _ = cdefs[sym]
        py_cls = _ctypes_expr_class(node, decls.aliases)
        c_cls = _c_class(c_ret)
        if py_cls in ("unknown",) or c_cls in ("unknown", "void"):
            continue
        if not _compatible(py_cls, c_cls):
            out.append(Finding(
                PASS, "abi-type", py_rel, line, sym,
                f"restype is {py_cls} but {sym} returns {c_ret!r} "
                f"({c_cls}) at {c_rel}:{c_line}", SEV_ERROR))
    # referenced but never given argtypes → ctypes guesses int widths
    for sym, line in sorted(decls.referenced.items()):
        if sym in decls.argtypes:
            continue
        if sym not in cdefs:
            out.append(Finding(
                PASS, "abi-missing-symbol", py_rel, line, sym,
                f"{sym} is referenced but {c_rel} exports no such "
                "function", SEV_ERROR))
            continue
        c_line, _ret, c_params = cdefs[sym]
        out.append(Finding(
            PASS, "abi-undeclared-call", py_rel, line, sym,
            f"{sym} ({c_rel}:{c_line}, {len(c_params)} params) is "
            "called with no argtypes declaration — ctypes falls back "
            "to int-width guessing, which breaks 64-bit handles and "
            "doubles", SEV_ERROR))
    return out


def check_ctypes(root: Path, checked: set[str] | None = None
                 ) -> list[Finding]:
    """Every library of :data:`LIBRARIES` against its bindings, then the
    C-side re-declarations of the engine's externs."""
    out: list[Finding] = []
    for c_rel, prefix, py_rel in LIBRARIES:
        out += check_library(root, c_rel, prefix, py_rel, checked)
    try:
        cdefs = c_functions((root / DCN_CC).read_text())
    except OSError:
        return out  # reported above
    # C-side extern re-declarations must agree on arity: the shims (the
    # C ABI) and dcn_sanity.cc (the sanitizer soak) restate the tdcn_*
    # prototypes, and C has no cross-TU checking — the linker binds a
    # wrong arity silently
    for c_rel in TDCN_REDECLARERS:
        try:
            c_decl_text = (root / c_rel).read_text()
        except OSError:
            c_decl_text = ""
        for sym, (line, plist) in sorted(c_extern_decls(c_decl_text).items()):
            if sym not in cdefs:
                out.append(Finding(
                    PASS, "abi-shim-decl", c_rel, line, sym,
                    f"{c_rel} declares extern {sym} but dcn.cc exports "
                    "no such function", SEV_ERROR))
                continue
            c_line, _ret, c_params = cdefs[sym]
            if len(plist) != len(c_params):
                out.append(Finding(
                    PASS, "abi-shim-decl", c_rel, line, sym,
                    f"{c_rel} extern declares {len(plist)} parameters "
                    f"but {DCN_CC}:{c_line} defines {len(c_params)} — "
                    "the linker binds this silently at the wrong arity",
                    SEV_ERROR))
    return out


# -- causal wire-context field table (C mirror) --------------------------

#: the frozen v1 wire-context prefix — live positional wire fields;
#: renaming or reordering ANY of them mis-decodes frames between
#: mixed builds even though the tail may grow
CTX_V1_FROZEN = ("v", "comm", "op", "seq", "hop")


def _py_tuple_of(root: Path, relpath: str,
                 name: str) -> tuple[list[str], int]:
    """(string elements, line) of a module-level tuple assignment."""
    tree = parse_py(root / relpath)
    if tree is None:
        return [], 0
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == name
                and isinstance(node.value, ast.Tuple)):
            return [e.value for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)], node.lineno
    return [], 0


def c_trace_ctx_fields(root: Path) -> tuple[list[str], int]:
    """(fields, line) parsed from the TDCN_TRACE_CTX_FIELDS
    concatenated string literal in dcn.cc; ([], 0) when absent."""
    try:
        text = (root / DCN_CC).read_text()
    except OSError:
        return [], 0
    m = re.search(
        r"TDCN_TRACE_CTX_FIELDS\s*=\s*((?:\s*\"[^\"]*\")+)\s*;", text)
    if not m:
        return [], 0
    line = text[:m.start()].count("\n") + 1
    joined = "".join(re.findall(r'"([^"]*)"', m.group(1)))
    return [n for n in joined.split(",") if n], line


def check_trace_ctx(root: Path) -> list[Finding]:
    """``wire-ctx-drift``/``wire-ctx-append-only`` (docstring)."""
    c_fields, c_line = c_trace_ctx_fields(root)
    py_fields, py_line = _py_tuple_of(root, CAUSAL_PY, "CTX_FIELDS")
    if not c_fields and not py_fields:
        return []  # neither side exists (fixture trees): nothing owed
    out: list[Finding] = []
    if not c_fields:
        return [Finding(
            PASS, "wire-ctx-drift", DCN_CC, 0, "TDCN_TRACE_CTX_FIELDS",
            "trace/causal.py declares CTX_FIELDS but dcn.cc carries no "
            "TDCN_TRACE_CTX_FIELDS mirror — the wire-context schema "
            "needs both sides (single-source-of-truth contract)",
            SEV_ERROR)]
    if not py_fields:
        return [Finding(
            PASS, "wire-ctx-drift", CAUSAL_PY, 0, "CTX_FIELDS",
            "dcn.cc carries TDCN_TRACE_CTX_FIELDS but trace/causal.py "
            "declares no CTX_FIELDS tuple", SEV_ERROR)]
    if c_fields != py_fields:
        detail = ""
        for i, (a, b) in enumerate(zip(c_fields, py_fields)):
            if a != b:
                detail = (f"first divergence at index {i}: C has {a!r}, "
                          f"Python has {b!r}")
                break
        else:
            longer = "C" if len(c_fields) > len(py_fields) else "Python"
            extra = (c_fields[len(py_fields):] if longer == "C"
                     else py_fields[len(c_fields):])
            detail = f"{longer} side has extra tail entries {extra}"
        out.append(Finding(
            PASS, "wire-ctx-drift", DCN_CC, c_line,
            "TDCN_TRACE_CTX_FIELDS",
            "TDCN_TRACE_CTX_FIELDS != trace/causal.py CTX_FIELDS "
            f"({CAUSAL_PY}:{py_line}) — {detail}; contexts are parsed "
            "by position, so both sides must agree exactly",
            SEV_ERROR))
    for side, fields, f, ln in ((
            "C", c_fields, DCN_CC, c_line),
            ("Python", py_fields, CAUSAL_PY, py_line)):
        prefix = tuple(fields[:len(CTX_V1_FROZEN)])
        if prefix != CTX_V1_FROZEN:
            bad = next((i for i, (a, b) in enumerate(
                zip(prefix, CTX_V1_FROZEN)) if a != b), len(prefix))
            out.append(Finding(
                PASS, "wire-ctx-append-only", f, ln,
                "TDCN_TRACE_CTX_FIELDS" if side == "C" else "CTX_FIELDS",
                f"{side} wire-context table breaks the frozen v1 "
                f"prefix at index {bad} (have "
                f"{list(prefix[bad:bad + 2])!r}, frozen "
                f"{list(CTX_V1_FROZEN[bad:bad + 2])!r}) — fields are "
                "positional on the wire; the schema is append-only "
                "(new fields at the tail, version stays 1)", SEV_ERROR))
    return out


_PVAR_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")


def check_causal_pvars(root: Path) -> list[Finding]:
    """``pvar-name-lint`` over the ``trace_causal_*`` family."""
    names, line = _py_tuple_of(root, CAUSAL_PY, "PVARS")
    if not names:
        return []  # no causal module (fixture trees): nothing owed
    out: list[Finding] = []
    readme = _readme(root)
    seen: set[str] = set()
    for n in names:
        full = f"trace_causal_{n}"
        if not _PVAR_NAME_RE.match(n):
            out.append(Finding(
                PASS, "pvar-name-lint", CAUSAL_PY, line, full,
                f"causal pvar segment {n!r} is not a lowercase "
                "identifier — prom/MPI_T names derive from it verbatim",
                SEV_ERROR))
        if n in seen:
            out.append(Finding(
                PASS, "pvar-name-lint", CAUSAL_PY, line, full,
                f"duplicate causal pvar segment {n!r}", SEV_ERROR))
        seen.add(n)
        if n.startswith("span_"):
            out.append(Finding(
                PASS, "pvar-name-lint", CAUSAL_PY, line, full,
                "causal pvar segment must not start with 'span_' — "
                "trace_span_* is the per-(layer, op) namespace and the "
                "name parser would shadow it", SEV_ERROR))
        if readme and full not in readme:
            out.append(Finding(
                PASS, "pvar-name-lint", README, 0, full,
                f"causal pvar {full!r} is missing from the README "
                "counter catalog — the catalog promises the full "
                "observability schema", SEV_ERROR))
    return out


# -- transport counters vs the provider merge ---------------------------

def _counter_keys(tree: ast.Module) -> list[tuple[str, int]]:
    """(key, line) for every counter name a transport initializes:
    string keys of ``…stats = { … }`` dict literals (Assign or
    AnnAssign) and elements of ``STATS_KEYS`` tuples."""
    out: list[tuple[str, int]] = []
    for node in ast.walk(tree):
        tgt = None
        val = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt, val = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            tgt, val = node.target, node.value
        if tgt is None:
            continue
        name = (tgt.attr if isinstance(tgt, ast.Attribute)
                else tgt.id if isinstance(tgt, ast.Name) else "")
        if name == "stats" and isinstance(val, ast.Dict):
            out += [(k.value, node.lineno) for k in val.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)]
        elif name == "STATS_KEYS" and isinstance(val, ast.Tuple):
            out += [(e.value, node.lineno) for e in val.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)]
    return out


def check_provider_merge(root: Path) -> list[Finding]:
    """``provider-merge-drift``: every counter key a DCN transport or
    plane initializes (the dicts its metrics provider snapshots) must
    appear in ``NATIVE_COUNTERS`` — a key outside the schema is
    silently DROPPED by the provider merge (``native_counters`` only
    sums known names), so the counter would exist in code yet never
    reach a pvar, the Prometheus export, the live scrape, or
    ``tools/top.py``."""
    counters, _ = py_native_counters(root)
    if not counters:
        return []  # stat-names-drift already reports the parse failure
    cset = set(counters)
    out: list[Finding] = []
    dcn_dir = root / PORT / "dcn"
    if not dcn_dir.is_dir():
        return []
    for path in sorted(dcn_dir.glob("*.py")):
        tree = parse_py(path)
        if tree is None:
            continue
        rel_p = rel(root, path)
        for key, line in _counter_keys(tree):
            if key not in cset:
                out.append(Finding(
                    PASS, "provider-merge-drift", rel_p, line, key,
                    f"transport counter {key!r} is initialized here but "
                    "missing from metrics/core.py NATIVE_COUNTERS — the "
                    "provider merge drops unknown names, so this counter "
                    "would never surface as a dcn_* pvar, in the "
                    "finalize/live exports, or in tools/top.py",
                    SEV_ERROR))
    return out


# -- README operator-surface catalogs -----------------------------------

def _served_routes(root: Path) -> dict[str, tuple[str, int]]:
    """route path → (file, line): add_route string literals plus the
    aggregator's built-in endpoints."""
    routes: dict[str, tuple[str, int]] = {}
    for relpath in (f"{PORT}/serve/daemon.py", LIVE_PY):
        tree = parse_py(root / relpath)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "add_route"
                    and len(node.args) >= 2
                    and isinstance(node.args[1], ast.Constant)
                    and isinstance(node.args[1].value, str)):
                routes[node.args[1].value] = (relpath, node.lineno)
    # built-in aggregator endpoints: the literal `self.path.startswith`
    # dispatch in live.py
    live = root / LIVE_PY
    try:
        for lineno, line in enumerate(live.read_text().splitlines(), 1):
            m = re.search(r"self\.path\.startswith\(\"(/[a-z]+)\"\)", line)
            if m:
                routes.setdefault(m.group(1),
                                  (LIVE_PY, lineno))
    except OSError:
        pass
    return routes


def check_catalogs(root: Path) -> list[Finding]:
    out: list[Finding] = []
    readme = _readme(root)
    if not readme:
        return [Finding(PASS, "catalog-drift", README, 0, "",
                        "README.md has no port section", SEV_ERROR)]
    # every centrally registered var must appear in the README
    for table, names in central_var_tables(root).items():
        for name in names:
            if name not in readme:
                out.append(Finding(
                    PASS, "catalog-drift", README, 0, table,
                    f"centrally registered var {name!r} ({table}) is "
                    "not documented in the README's port section — operators "
                    "discover knobs there", SEV_ERROR))
    # every native counter must appear (the catalog merges families as
    # `eager_msgs/bytes`, so accept the family row form too)
    counters, _ = py_native_counters(root)
    for name in counters:
        ok = name in readme
        if not ok and name.endswith("_bytes"):
            ok = name[:-len("_bytes")] + "_msgs/bytes" in readme
        if not ok and name.endswith("_stalls"):
            ok = name[:-len("_stalls")] + "_stall_ns` / `" \
                + name in readme or f"/ `{name}`" in readme
        if not ok:
            out.append(Finding(
                PASS, "catalog-drift", README, 0, "NATIVE_COUNTERS",
                f"native counter {name!r} is missing from the README "
                "counter catalog — the catalog promises the full "
                "schema (MPI_T pvar names dcn_<name>)", SEV_ERROR))
    # ops endpoints: code routes ⊆ README (table row or backticked
    # prose both count as documentation) and table rows ⊆ code
    routes = _served_routes(root)
    doc_rows = set(re.findall(r"^\|\s*`(/[a-z]+)", readme, re.M))
    doc_any = doc_rows | {m.split("/<", 1)[0] for m in
                          re.findall(r"`(/[a-z]+)[^`]*`", readme)}
    for path, (f, ln) in sorted(routes.items()):
        if path not in doc_any and path.rstrip("/") not in doc_any:
            out.append(Finding(
                PASS, "catalog-drift", f, ln, path,
                f"ops endpoint {path!r} is served but documented "
                "nowhere in README (endpoint table or prose)",
                SEV_ERROR))
    for path in sorted(doc_rows):
        if path not in routes:
            out.append(Finding(
                PASS, "catalog-drift", README, 0, path,
                f"README endpoint table documents {path!r} but no "
                "add_route/dispatch site serves it", SEV_WARN))
    return out


def check_plane_catalog(root: Path) -> list[Finding]:
    """``plane-catalog-drift``: the plane-health counter family
    (``plane_*``) and knob family (``dcn_plane_*``) must agree across
    code and the README "Plane health" catalog, BOTH directions —
    a counter/knob the code carries but the README omits is an
    undocumented operator surface; a name the README documents but
    the code lacks is a stale promise (rename/removal drift).  The
    code side is itself cross-checked: the device plane's STATS_KEYS
    plane family must equal the NATIVE_COUNTERS plane family (the
    provider merge would silently drop a key missing from either)."""
    out: list[Finding] = []
    native = [n for n in py_native_counters(root)[0]
              if n.startswith("plane_")]
    skeys, sline = _py_tuple_of(root, DEVICE_PY, "STATS_KEYS")
    dev = [n for n in skeys if n.startswith("plane_")]
    for name in native:
        if name not in dev:
            out.append(Finding(
                PASS, "plane-catalog-drift", DEVICE_PY, sline, name,
                f"plane-health counter {name!r} is in NATIVE_COUNTERS "
                "but missing from the device plane's STATS_KEYS — the "
                "provider would never populate it", SEV_ERROR))
    for name in dev:
        if name not in native:
            out.append(Finding(
                PASS, "plane-catalog-drift", DEVICE_PY, sline, name,
                f"plane-health counter {name!r} is in STATS_KEYS but "
                "missing from NATIVE_COUNTERS — the provider merge "
                "drops unknown keys", SEV_ERROR))
    readme = _readme(root)
    if not readme:
        return out
    knobs = [n for names in central_var_tables(root).values()
             for n in names if n.startswith("dcn_plane_")]
    # code → README: every plane counter and knob is documented
    for name in native:
        if name not in readme:
            out.append(Finding(
                PASS, "plane-catalog-drift", README, 0, name,
                f"plane-health counter {name!r} is missing from the "
                "README plane-health catalog", SEV_ERROR))
    for name in knobs:
        if name not in readme:
            out.append(Finding(
                PASS, "plane-catalog-drift", README, 0, name,
                f"plane-health knob {name!r} is missing from the "
                "README plane-health catalog", SEV_ERROR))
    # README → code: every plane_* token the README promises exists
    # (dcn_plane_<x> resolves as a knob or the counter pvar form)
    doc = set(re.findall(r"`(?:dcn_)?(plane_[a-z_]+)`", readme))
    known = set(native) | {k[len("dcn_"):] for k in knobs}
    for name in sorted(doc - known):
        out.append(Finding(
            PASS, "plane-catalog-drift", README, 0, name,
            f"README documents plane-health name {name!r} but neither "
            "a plane_* counter nor a dcn_plane_* knob carries it — "
            "stale catalog entry", SEV_ERROR))
    return out


def run(root: str | Path, files=None) -> list[Finding]:
    """Run the ABI drift pass.  ``files`` is accepted for symmetry
    with the other passes; the pass's inputs are the fixed contract files."""
    root = Path(root)
    out: list[Finding] = []
    out += check_stat_names(root)
    out += check_ctypes(root)
    out += check_provider_merge(root)
    out += check_trace_ctx(root)
    out += check_causal_pvars(root)
    out += check_catalogs(root)
    out += check_plane_catalog(root)
    return out

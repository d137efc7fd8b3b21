"""Pass 1 — the invariant linter (AST checks over ``ompi_tpu_torch/``).

The reference's four rule families, with the same rule names, over the
port's own files.  They encode the cross-cutting contracts of the
transport, observability and recovery planes, so they are
checked by machine instead of by memory:

``unbounded-spin``
    A ``while True``-style loop in a transport/threaded module that
    sleeps/polls without the enclosing function consulting a
    :class:`~ompi_tpu_torch.core.var.Deadline` (or an Event/Condition wait
    that carries its own bound): a dead peer turns the spin into a
    permanent wedge.

``hardcoded-timeout``
    A numeric literal ≥ ``LONG_WAIT_S`` used as a blocking-wait bound
    in the DCN/p2p paths.  Long waits must come from the registered
    ``dcn_*_timeout``/``ft_*`` vars (``Deadline.for_timeout``) so
    operators can tune them; short literals (poll quanta, control-
    frame fail-fast bounds) are fine.

``mca-unregistered``
    A ``--mca <name>``/``OMPI_MCA_<name>`` reference in code, tests,
    docs, or examples of the port (:func:`.repo.port_doc_files` and the
    README's port section) whose name no registration site defines.

``mca-dead-registration``
    A var in the central ``core/var.py`` tables that nothing outside
    ``core/var.py`` references — a knob nobody can discover a use for.

``ungated-hook``
    A call from a hot-path module into a gated subsystem (trace /
    metrics / faultsim) that neither tests the subsystem's module
    bool at the call site nor targets a self-gated hook function.
    The one-bool-off-path contract: observability must cost one
    boolean test when disabled.

``untyped-escalation``
    ``raise RuntimeError``/``raise Exception`` in the transport
    escalation paths (``dcn/tcp.py``, ``dcn/native.py``,
    ``dcn/collops.py``, ``dcn/device.py``) — failures there must raise the typed errors
    (``MPIProcFailedError`` etc.) that ULFM recovery dispatches on.
"""

from __future__ import annotations

import ast
from pathlib import Path

from ompi_tpu_torch.analysis.findings import SEV_ERROR, Finding
from ompi_tpu_torch.analysis.repo import (
    PORT,
    README,
    VAR_PY,
    central_var_tables,
    const_str,
    mca_references,
    parse_py,
    port_doc_files,
    port_py_files,
    readme_port_section,
    registered_var_names,
    rel,
)

PASS = "invariants"

#: modules whose blocking waits must ride Deadline (the transport and
#: threaded planes).  The OpenSHMEM layer and the C ABI's Python half
#: drive the point-to-point plane, so they join every scope that names
#: ``p2p``
SPIN_SCOPE = (
    f"{PORT}/dcn", f"{PORT}/p2p", f"{PORT}/serve", f"{PORT}/ft",
    f"{PORT}/metrics/live.py", f"{PORT}/coll/sync.py",
    f"{PORT}/boot/kvs.py", f"{PORT}/shmem", f"{PORT}/capi.py",
)

#: modules where long literal timeouts are contract violations
TIMEOUT_SCOPE = (f"{PORT}/dcn", f"{PORT}/p2p", f"{PORT}/shmem",
                 f"{PORT}/capi.py")

#: seconds at which a literal bound stops being a poll quantum and
#: becomes a policy decision that belongs in a registered var
LONG_WAIT_S = 60

#: the transport escalation paths (device.py's waits escalate too:
#: plane-health failover)
ESCALATION_FILES = (
    f"{PORT}/dcn/tcp.py", f"{PORT}/dcn/native.py",
    f"{PORT}/dcn/collops.py", f"{PORT}/dcn/device.py",
)

#: hot-path packages whose calls into gated subsystems are checked
HOT_SCOPE = (f"{PORT}/dcn", f"{PORT}/p2p", f"{PORT}/coll",
             f"{PORT}/api", f"{PORT}/mesh", f"{PORT}/serve",
             f"{PORT}/shmem", f"{PORT}/capi.py")

#: gated subsystem → package path fragment.  A module inside one of
#: these packages carries the one-bool gate (``_enabled``).
GATED_SUBSYSTEMS = {
    "trace": f"{PORT}/trace",
    "metrics": f"{PORT}/metrics",
    "faultsim": f"{PORT}/faultsim",
}

#: subsystem functions that are lifecycle/config surface, not hot-path
#: hooks — callable ungated (init/finalize/job boundaries/tests, never
#: per-message).  start_publisher/stop_publisher gate themselves on the
#: telemetry var+env; set_proc/set_job/reset_crash_latch are one global
#: store each, called once per init/job.
LIFECYCLE_FNS = frozenset({
    "enable", "disable", "enabled", "sync_from_store", "register_vars",
    "install", "reset", "configure", "start", "stop", "shutdown",
    "set_proc", "start_publisher", "stop_publisher", "reset_crash_latch",
    "set_job",
})

_GATE_TOKENS = ("_enabled", "enabled()")


class _Parented(ast.NodeVisitor):
    """Annotate nodes with parents + enclosing function qualname."""

    def __init__(self, tree: ast.Module):
        self.parents: dict[ast.AST, ast.AST] = {}
        stack: list[ast.AST] = [tree]
        while stack:
            node = stack.pop()
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
                stack.append(child)

    def qualname(self, node: ast.AST) -> str:
        parts: list[str] = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            cur = self.parents.get(cur)
        return ".".join(reversed(parts))

    def enclosing_function(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None


def _in_scope(relpath: str, scope: tuple[str, ...]) -> bool:
    return any(relpath == s or relpath.startswith(s.rstrip("/") + "/")
               for s in scope)


def _mentions_gate(node: ast.AST) -> bool:
    try:
        src = ast.unparse(node)
    except Exception:  # pragma: no cover - unparse failure
        return False
    return any(tok in src for tok in _GATE_TOKENS)


def _loop_is_unbounded(node: ast.While) -> bool:
    """``while True`` / ``while 1`` (constant-true) loops only; a
    conditioned loop carries its own exit."""
    t = node.test
    return isinstance(t, ast.Constant) and bool(t.value)


def _calls_in(node: ast.AST) -> list[ast.Call]:
    return [n for n in ast.walk(node) if isinstance(n, ast.Call)]


def _call_name(call: ast.Call) -> str:
    """Dotted best-effort name of the callee."""
    f = call.func
    parts: list[str] = []
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if isinstance(f, ast.Name):
        parts.append(f.id)
    return ".".join(reversed(parts))


# -- rule: unbounded-spin -----------------------------------------------

_SLEEPY = ("sleep",)


def check_spins(root: Path, files: list[Path]) -> list[Finding]:
    out: list[Finding] = []
    for path in files:
        relpath = rel(root, path)
        if not _in_scope(relpath, SPIN_SCOPE):
            continue
        tree = parse_py(path)
        if tree is None:
            continue
        par = _Parented(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.While) or not _loop_is_unbounded(node):
                continue
            sleeps = [c for c in _calls_in(node)
                      if _call_name(c).split(".")[-1] in _SLEEPY]
            if not sleeps:
                continue
            fn = par.enclosing_function(node)
            ctx = fn if fn is not None else node
            src = ast.unparse(ctx)
            if "Deadline" in src or "deadline" in src:
                continue  # bounded: the function consults the policy
            out.append(Finding(
                PASS, "unbounded-spin", relpath, node.lineno,
                par.qualname(node),
                "`while True` + sleep with no Deadline in the enclosing "
                "function — a dead peer turns this into a permanent wedge "
                "(every blocking DCN wait must ride core.var.Deadline)",
                SEV_ERROR))
    return out


# -- rule: hardcoded-timeout --------------------------------------------

_TIMEOUT_KWARGS = ("timeout", "timeout_s", "seconds")
_TIMEOUT_CALLS = ("settimeout", "Deadline", "wait", "join", "acquire")


def check_hardcoded_timeouts(root: Path, files: list[Path]) -> list[Finding]:
    out: list[Finding] = []
    for path in files:
        relpath = rel(root, path)
        if not _in_scope(relpath, TIMEOUT_SCOPE):
            continue
        tree = parse_py(path)
        if tree is None:
            continue
        par = _Parented(tree)
        for call in (n for n in ast.walk(tree) if isinstance(n, ast.Call)):
            name = _call_name(call).split(".")[-1]
            suspects: list[ast.AST] = []
            for kw in call.keywords:
                if kw.arg in _TIMEOUT_KWARGS:
                    suspects.append(kw.value)
            if name in _TIMEOUT_CALLS and call.args:
                suspects.append(call.args[0])
            for s in suspects:
                if (isinstance(s, ast.Constant)
                        and isinstance(s.value, (int, float))
                        and not isinstance(s.value, bool)
                        and s.value >= LONG_WAIT_S):
                    out.append(Finding(
                        PASS, "hardcoded-timeout", relpath, call.lineno,
                        par.qualname(call),
                        f"literal {s.value}s bound on a blocking wait "
                        f"({name}) — long waits must come from the "
                        "registered dcn_*_timeout vars "
                        "(Deadline.for_timeout), not constants",
                        SEV_ERROR))
    return out


# -- rules: mca-unregistered / mca-dead-registration --------------------

def _local_registrations(tree: ast.Module) -> set[str]:
    """Var names a file registers itself via literal ``*.register(fw,
    comp, name, …)`` calls — tests/tools register scratch vars and then
    reference them; those are not drift."""
    names: set[str] = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "register" and len(node.args) >= 3):
            parts = [const_str(a) for a in node.args[:3]]
            if all(p is not None for p in parts):
                names.add("_".join(p for p in parts if p))
    return names


def _plausible_var_name(name: str) -> bool:
    """Heuristic separating real knob references from prose/placeholder
    matches ("--mca var listings", "--mca k v", "btl_tcp_*"): every
    registered knob family here is multi-word snake_case, so a name
    must carry an internal underscore and end on an alnum."""
    return "_" in name.strip("_") and not name.endswith("_")


def _reference_corpus(root: Path, files: list[Path],
                      doc_files: list[Path] | None) -> list[tuple[Path, str, int]]:
    """(path, text, line of its first line) for every text the ``--mca``
    walk reads: ``files``, then ``doc_files`` — by default the port's
    doc corpus and the README's port section (:mod:`.repo`)."""
    out: list[tuple[Path, str, int]] = []
    seen: set[Path] = set()
    docs = doc_files if doc_files is not None else port_doc_files(root)
    for path in list(files) + list(docs):
        if path in seen:  # files may overlap the doc walk
            continue
        seen.add(path)
        if _in_scope(rel(root, path), (f"{PORT}/analysis",)):
            continue  # the checker's own docstrings/regex sources
        try:
            out.append((path, path.read_text(), 1))
        except (OSError, UnicodeDecodeError):
            continue
    if doc_files is None:
        text, first = readme_port_section(root)
        if text:
            out.append((root / README, text, first))
    return out


def check_mca_vars(root: Path, files: list[Path] | None = None,
                   doc_files: list[Path] | None = None,
                   check_dead: bool = True) -> list[Finding]:
    out: list[Finding] = []
    known = registered_var_names(root)
    ref_text: list[str] = []
    for path, text, first in _reference_corpus(root, files or [], doc_files):
        ref_text.append(text)
        local = known
        if path.suffix == ".py":
            tree = parse_py(path)
            if tree is not None:
                extra = _local_registrations(tree) - known
                if extra:
                    local = known | extra
        for name, lineno in mca_references(text):
            if name not in local and _plausible_var_name(name):
                out.append(Finding(
                    PASS, "mca-unregistered", rel(root, path),
                    first + lineno - 1, "",
                    f"--mca var {name!r} is referenced here but no "
                    "registration site defines it (central tables, "
                    "store.register literals, component priority/"
                    "selection vars)",
                    SEV_ERROR))
    # dead registrations: central-table vars nothing references
    if not check_dead:
        return out
    blob = "\n".join(ref_text)
    for table, names in central_var_tables(root).items():
        for name in names:
            if name not in blob:
                out.append(Finding(
                    PASS, "mca-dead-registration", VAR_PY, 0, table,
                    f"central registration {name!r} ({table}) is "
                    "referenced nowhere outside core/var.py — dead knob "
                    "or missing docs",
                    SEV_ERROR))
    return out


# -- rule: ungated-hook -------------------------------------------------

def _subsystem_of(relpath: str) -> str | None:
    for name, frag in GATED_SUBSYSTEMS.items():
        if _in_scope(relpath, (frag,)):
            return name
    return None


def _collect_gated_functions(root: Path) -> dict[str, dict[str, bool]]:
    """subsystem → {function name: self_gated?} over its modules."""
    table: dict[str, dict[str, bool]] = {k: {} for k in GATED_SUBSYSTEMS}
    for name, frag in GATED_SUBSYSTEMS.items():
        for path in (p for p in port_py_files(root)
                     if _in_scope(rel(root, p), (frag,))):
            tree = parse_py(path)
            if tree is None:
                continue
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    gated = _mentions_gate(node)
                    prev = table[name].get(node.name)
                    table[name][node.name] = bool(prev) or gated
    return table


def _import_aliases(tree: ast.Module) -> dict[str, str]:
    """local alias → subsystem name, for ompi_tpu_torch.{trace,metrics,
    faultsim} imports (module-level and function-local)."""
    aliases: dict[str, str] = {}
    sub_by_pkg = {f"{PORT}.{k}": k for k in GATED_SUBSYSTEMS}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                for pkg, sub in sub_by_pkg.items():
                    if a.name == pkg or a.name.startswith(pkg + "."):
                        aliases[(a.asname or a.name).split(".")[0]] = sub
        elif isinstance(node, ast.ImportFrom) and node.module:
            mod = node.module
            if mod == PORT:
                for a in node.names:
                    if a.name in GATED_SUBSYSTEMS:
                        aliases[a.asname or a.name] = a.name
                continue
            for pkg, sub in sub_by_pkg.items():
                if mod == pkg or mod.startswith(pkg + "."):
                    for a in node.names:
                        aliases[a.asname or a.name] = sub
    return aliases


def _latch_names(fn: ast.AST | None) -> set[str]:
    """Names assigned the t0-latch idiom in this function:
    ``t0 = trace.now() if _trace._enabled else 0`` — a later ``if t0:``
    then dominates the hook call with the gate, one hop removed."""
    out: set[str] = set()
    if fn is None:
        return out
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.IfExp)
                and _mentions_gate(node.value.test)):
            out.add(node.targets[0].id)
    return out


def _test_is_latch(test: ast.AST, latches: set[str]) -> bool:
    return isinstance(test, ast.Name) and test.id in latches


def _guarded(node: ast.AST, par: _Parented) -> bool:
    """Is this call dominated by a gate test (if/ifexp/and-chain), or
    by an ``if <latch>:`` where the latch variable was assigned from a
    gate-conditioned IfExp (the hot-path t0-latch idiom)?"""
    latches = _latch_names(par.enclosing_function(node))
    cur: ast.AST | None = node
    while cur is not None:
        parent = par.parents.get(cur)
        if isinstance(parent, ast.If) and (
                _mentions_gate(parent.test)
                or _test_is_latch(parent.test, latches)):
            return True
        if isinstance(parent, ast.IfExp):
            if cur is not parent.orelse and _mentions_gate(parent.test):
                return True
        if isinstance(parent, ast.BoolOp) and isinstance(parent.op, ast.And):
            idx = parent.values.index(cur) if cur in parent.values else 0
            if any(_mentions_gate(v) for v in parent.values[:idx]):
                return True
        cur = parent
    return False


def _caller_early_gated(fn: ast.AST | None) -> bool:
    """The enclosing function itself starts with an `if not <gate>:
    return` bail-out — everything after is implicitly gated."""
    if fn is None:
        return False
    body = getattr(fn, "body", [])
    for stmt in body[:4]:
        if (isinstance(stmt, ast.If) and _mentions_gate(stmt.test)
                and any(isinstance(s, ast.Return) for s in stmt.body)):
            return True
    return False


def check_gated_hooks(root: Path, files: list[Path]) -> list[Finding]:
    out: list[Finding] = []
    gated_fns = _collect_gated_functions(root)
    for path in files:
        relpath = rel(root, path)
        if not _in_scope(relpath, HOT_SCOPE) or _subsystem_of(relpath):
            continue
        tree = parse_py(path)
        if tree is None:
            continue
        par = _Parented(tree)
        aliases = _import_aliases(tree)
        if not aliases:
            continue
        for call in (n for n in ast.walk(tree) if isinstance(n, ast.Call)):
            f = call.func
            sub = fname = None
            if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                    and f.value.id in aliases):
                sub, fname = aliases[f.value.id], f.attr
            elif isinstance(f, ast.Name) and f.id in aliases:
                # direct `from ompi_tpu_torch.trace.core import emit` style
                sub, fname = aliases[f.id], f.id
            if sub is None or fname is None:
                continue
            if fname in LIFECYCLE_FNS or fname.startswith("register"):
                continue
            known = gated_fns.get(sub, {})
            if fname in known and known[fname]:
                continue  # self-gated hook: tests the bool inside
            if _guarded(call, par):
                continue
            if _caller_early_gated(par.enclosing_function(call)):
                continue
            if fname not in known:
                continue  # not a function we can classify (class/attr)
            out.append(Finding(
                PASS, "ungated-hook", relpath, call.lineno,
                par.qualname(call),
                f"call into gated subsystem '{sub}' ({fname}) with no "
                "module-bool test at the call site and no gate inside "
                "the hook — breaks the one-bool-off-path contract",
                SEV_ERROR))
    return out


# -- rule: untyped-escalation -------------------------------------------

_BARE_RAISES = ("RuntimeError", "Exception")


def check_escalations(root: Path, files: list[Path]) -> list[Finding]:
    out: list[Finding] = []
    for path in files:
        relpath = rel(root, path)
        if relpath not in ESCALATION_FILES:
            continue
        tree = parse_py(path)
        if tree is None:
            continue
        par = _Parented(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Raise) or node.exc is None:
                continue
            exc = node.exc
            name = None
            if isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name):
                name = exc.func.id
            elif isinstance(exc, ast.Name):
                name = exc.id
            if name in _BARE_RAISES:
                out.append(Finding(
                    PASS, "untyped-escalation", relpath, node.lineno,
                    par.qualname(node),
                    f"raise {name} in a transport escalation path — must "
                    "raise the typed errors (MPIProcFailedError / "
                    "DeadlineExpiredError …) ULFM recovery dispatches on",
                    SEV_ERROR))
    return out


def run(root: str | Path, files: list[Path] | None = None,
        mca_docs: bool = True) -> list[Finding]:
    """Run the invariant linter.  ``files`` overrides the walk (fixture
    trees in --selftest); ``mca_docs=False`` skips the docs/tests var
    scan (the --fast pre-commit path)."""
    root = Path(root)
    files = files if files is not None else port_py_files(root)
    out: list[Finding] = []
    out += check_spins(root, files)
    out += check_hardcoded_timeouts(root, files)
    out += check_gated_hooks(root, files)
    out += check_escalations(root, files)
    if mca_docs:
        out += check_mca_vars(root, files)
    else:
        # --fast: no docs/tests walk, and without it the "referenced
        # nowhere" dead-registration evidence is incomplete — skip both
        out += check_mca_vars(root, files, doc_files=[], check_dead=False)
    return out

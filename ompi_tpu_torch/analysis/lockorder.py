"""Pass 2 — static lock-order / deadlock analysis over the threaded planes.

Builds a static lock-acquisition graph (lockdep/witness style, but at
analysis time): nodes are lock *sites* (``Class.attr`` for instance
locks, ``module.name`` for module-level locks — the moral equivalent
of lockdep's lock classes), and an edge A→B means "somewhere, B is
acquired while A is held", either directly in one function body or
through a (transitive, statically resolved) call made under A.

Findings:

``lock-cycle``
    A cycle in the acquisition graph — two threads taking the locks
    in opposite orders can deadlock.  Reported once per strongly-
    connected component, with example edges and sites.

``lock-self-cycle``
    A non-reentrant ``threading.Lock`` acquired while already held
    (directly or via a call chain) — self-deadlock on one thread.

``lock-held-blocking``
    A known-blocking call (socket accept/connect/recv, unbounded
    ``Event.wait``/``join``, ``time.sleep``, subprocess) made while a
    lock is held — the wedge class where one stalled peer freezes
    every thread that touches the lock.  ``Condition.wait`` on
    the *held* condition is exempt (wait releases it); bounded waits
    (an explicit timeout argument) are exempt — they stall, but they
    cannot wedge.

The companion **runtime** witness mode lives in :mod:`.lockdep`
(opt-in, used by tests): it records the observed acquisition order of
real lock instances and turns an order inversion into a test failure.

Static resolution is deliberately name-based and conservative: an
expression resolves to a lock node only when the attribute name is
unambiguous (declared by exactly one analyzed class, or by the
enclosing class).  Unresolvable expressions are skipped — this pass
prefers missed edges over phantom cycles.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path

from ompi_tpu_torch.analysis.findings import SEV_ERROR, Finding
from ompi_tpu_torch.analysis.repo import PORT, parse_py, rel

PASS = "lockorder"

#: the port's threaded planes: the engines (tcp, collops, native, the
#: device plane), the telemetry publisher, the failure detector and the
#: tpud workers, plus the pool of request threads
DEFAULT_SCOPE = (
    f"{PORT}/dcn/tcp.py",
    f"{PORT}/dcn/collops.py",
    f"{PORT}/dcn/native.py",
    f"{PORT}/dcn/device.py",
    f"{PORT}/metrics/live.py",
    f"{PORT}/serve/daemon.py",
    f"{PORT}/serve/worker.py",
    f"{PORT}/serve/queue.py",
    f"{PORT}/serve/agent.py",
    f"{PORT}/ft/detector.py",
    f"{PORT}/core/threads.py",
)

_LOCK_FACTORIES = {"Lock": "lock", "RLock": "rlock",
                   "Condition": "condition", "Semaphore": "semaphore",
                   "BoundedSemaphore": "semaphore"}

#: method names that block unboundedly when called without a timeout
_BLOCKING_BARE = {"accept", "connect", "recv", "recv_into", "recvfrom",
                  "sendall", "select", "communicate", "run",
                  "check_output", "_recv_full", "_recv_exact",
                  "recv_exact", "sleep"}
#: blocking only when called with NO timeout argument at all
_BLOCKING_IF_UNBOUNDED = {"wait", "join", "result"}


@dataclass
class LockDef:
    lock_id: str    # "Class.attr" | "<module-stem>.name"
    kind: str       # lock | rlock | condition | semaphore
    file: str
    line: int


@dataclass
class _FuncInfo:
    qualname: str
    file: str
    cls: str | None
    acquires: set[str] = field(default_factory=set)
    #: (held_tuple, new_lock, line) direct nesting events
    nest_events: list = field(default_factory=list)
    #: (held_tuple, callee_key, line)
    calls_under: list = field(default_factory=list)
    #: (held_tuple, call_desc, line) direct blocking calls under a lock
    blocking_under: list = field(default_factory=list)
    #: callee keys (for closure computation), held or not
    callees: set = field(default_factory=set)


def _lock_factory_kind(call: ast.Call) -> str | None:
    f = call.func
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None)
    return _LOCK_FACTORIES.get(name or "")


class _ModuleScan:
    """Collect lock definitions + function bodies for one file."""

    def __init__(self, root: Path, path: Path):
        self.root = root
        self.path = path
        self.relpath = rel(root, path)
        self.stem = path.stem
        self.locks: dict[str, LockDef] = {}
        self.functions: dict[str, tuple[ast.AST, str | None]] = {}
        tree = parse_py(path)
        if tree is None:
            return
        self._collect(tree)

    def _collect(self, tree: ast.Module) -> None:
        for node in tree.body:
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call):
                kind = _lock_factory_kind(node.value)
                if kind and len(node.targets) == 1 and isinstance(
                        node.targets[0], ast.Name):
                    lid = f"{self.stem}.{node.targets[0].id}"
                    self.locks[lid] = LockDef(lid, kind, self.relpath,
                                              node.lineno)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = (node, None)
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        self.functions[f"{node.name}.{sub.name}"] = (
                            sub, node.name)
                        for stmt in ast.walk(sub):
                            if (isinstance(stmt, ast.Assign)
                                    and isinstance(stmt.value, ast.Call)):
                                kind = _lock_factory_kind(stmt.value)
                                tgt = stmt.targets[0] if len(
                                    stmt.targets) == 1 else None
                                if (kind and isinstance(tgt, ast.Attribute)
                                        and isinstance(tgt.value, ast.Name)
                                        and tgt.value.id == "self"):
                                    lid = f"{node.name}.{tgt.attr}"
                                    self.locks[lid] = LockDef(
                                        lid, kind, self.relpath, stmt.lineno)


class Analyzer:
    def __init__(self, root: Path, scope: tuple[str, ...] = DEFAULT_SCOPE,
                 files: list[Path] | None = None):
        self.root = Path(root)
        if files is None:
            files = [self.root / s for s in scope
                     if (self.root / s).exists()]
        self.scans = [_ModuleScan(self.root, p) for p in files]
        self.locks: dict[str, LockDef] = {}
        self.attr_index: dict[str, list[str]] = {}
        for sc in self.scans:
            for lid, d in sc.locks.items():
                self.locks[lid] = d
                self.attr_index.setdefault(lid.rsplit(".", 1)[1],
                                           []).append(lid)
        self.funcs: dict[str, _FuncInfo] = {}
        for sc in self.scans:
            for qual, (node, cls) in sc.functions.items():
                key = f"{sc.stem}:{qual}"
                info = _FuncInfo(qual, sc.relpath, cls)
                self.funcs[key] = info
                self._walk_function(sc, node, info)

    # -- lock expression resolution ------------------------------------

    def _resolve(self, expr: ast.AST, cls: str | None) -> str | None:
        if isinstance(expr, ast.Name):
            cands = [lid for lid in self.attr_index.get(expr.id, ())
                     if lid in self.locks
                     and "." in lid]  # module-level locks keyed stem.name
            return cands[0] if len(cands) == 1 else None
        if isinstance(expr, ast.Attribute):
            attr = expr.attr
            if isinstance(expr.value, ast.Name) and expr.value.id == "self":
                if cls and f"{cls}.{attr}" in self.locks:
                    return f"{cls}.{attr}"
            cands = self.attr_index.get(attr, [])
            if len(cands) == 1:
                return cands[0]
        return None

    # -- ordered traversal with a held-lock stack ----------------------

    def _walk_function(self, sc: _ModuleScan, fn: ast.AST,
                       info: _FuncInfo) -> None:
        held: list[str] = []

        def visit_call(call: ast.Call) -> None:
            f = call.func
            # acquire()/release() on a resolvable lock expr
            if isinstance(f, ast.Attribute) and f.attr in ("acquire",
                                                           "release"):
                lid = self._resolve(f.value, info.cls)
                if lid is not None:
                    if f.attr == "acquire":
                        if held:
                            info.nest_events.append(
                                (tuple(held), lid, call.lineno))
                        info.acquires.add(lid)
                        held.append(lid)
                    elif lid in held:
                        held.remove(lid)
                    return
            # blocking-call detection
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else "")
            has_timeout = bool(call.args) or any(
                kw.arg in ("timeout", "timeout_s") for kw in call.keywords)
            # sendall/connect/... take args; "has args" ≠ bounded there,
            # so _BLOCKING_BARE names block regardless of has_timeout
            blocking = (name in _BLOCKING_BARE
                        or (name in _BLOCKING_IF_UNBOUNDED
                            and not has_timeout))
            if blocking and held:
                if name == "wait" and isinstance(f, ast.Attribute):
                    cond = self._resolve(f.value, info.cls)
                    if cond is not None and cond in held:
                        blocking = False  # Condition.wait releases it
                if blocking:
                    info.blocking_under.append(
                        (tuple(held), ast.unparse(call.func),
                         call.lineno))
            # call-graph edge for interprocedural propagation
            callee = self._callee_key(sc, f, info.cls)
            if callee is not None:
                info.callees.add(callee)
                if held:
                    info.calls_under.append(
                        (tuple(held), callee, call.lineno))

        def visit(node: ast.AST) -> None:
            if isinstance(node, ast.With):
                ids: list[str] = []
                for item in node.items:
                    expr = item.context_expr
                    for c in ast.walk(expr):
                        if isinstance(c, ast.Call):
                            visit_call(c)
                    lid = self._resolve(expr, info.cls)
                    if lid is not None:
                        if held:
                            info.nest_events.append(
                                (tuple(held), lid, node.lineno))
                        info.acquires.add(lid)
                        held.append(lid)
                        ids.append(lid)
                for stmt in node.body:
                    visit(stmt)
                for lid in reversed(ids):
                    if lid in held:
                        held.remove(lid)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                return  # nested defs run on their own schedule
            if isinstance(node, ast.If):
                # branches are exclusive: walk each from the pre-branch
                # held state, then continue with the locks BOTH arms
                # agree on (common prefix) — an acquire in one arm must
                # not leak into its sibling (phantom self-cycles)
                for c in ast.walk(node.test):
                    if isinstance(c, ast.Call):
                        visit_call(c)
                base = list(held)
                for stmt in node.body:
                    visit(stmt)
                after_body = list(held)
                held[:] = base
                for stmt in node.orelse:
                    visit(stmt)
                merged: list[str] = []
                for a, b in zip(after_body, held):
                    if a != b:
                        break
                    merged.append(a)
                held[:] = merged
                return
            if isinstance(node, ast.Call):
                visit_call(node)
                for child in ast.iter_child_nodes(node):
                    visit(child)
                return
            for child in ast.iter_child_nodes(node):
                visit(child)

        for stmt in getattr(fn, "body", []):
            visit(stmt)

    def _callee_key(self, sc: _ModuleScan, f: ast.AST,
                    cls: str | None) -> str | None:
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            if f.value.id == "self" and cls:
                key = f"{sc.stem}:{cls}.{f.attr}"
                if key in self.funcs or f"{cls}.{f.attr}" in sc.functions:
                    return f"{sc.stem}:{cls}.{f.attr}"
            return None
        if isinstance(f, ast.Name):
            if f.id in sc.functions:
                return f"{sc.stem}:{f.id}"
        return None

    # -- graph construction + findings ---------------------------------

    def build(self):
        """Returns (edges, blocking) where edges is
        {(A, B): (file, line, via)} and blocking is a list of
        (held, call, file, line, via)."""
        # transitive acquire closure per function
        closure: dict[str, set[str]] = {
            k: set(v.acquires) for k, v in self.funcs.items()}
        block_closure: dict[str, list] = {
            k: [(b[1], b[2], "") for b in v.blocking_under]
            for k, v in self.funcs.items()}
        changed = True
        rounds = 0
        while changed and rounds < 20:
            changed = False
            rounds += 1
            for k, v in self.funcs.items():
                for callee in v.callees:
                    extra = closure.get(callee, set()) - closure[k]
                    if extra:
                        closure[k] |= extra
                        changed = True
        edges: dict[tuple[str, str], tuple[str, int, str]] = {}
        blocking: list = []
        for k, v in self.funcs.items():
            for held, lid, line in v.nest_events:
                for h in held:
                    # h == lid is a self-edge; Tarjan reports it as a
                    # lock-self-cycle like any other cycle
                    edges.setdefault((h, lid), (v.file, line, v.qualname))
            for held, callee, line in v.calls_under:
                for m in closure.get(callee, ()):  # locks taken downstream
                    for h in held:
                        via = f"{v.qualname} → {callee.split(':', 1)[1]}"
                        edges.setdefault((h, m), (v.file, line, via))
            for held, call, line in v.blocking_under:
                blocking.append((held, call, v.file, line, v.qualname))
            # blocking through one call level
            for held, callee, line in v.calls_under:
                if callee not in self.funcs:
                    continue
                for bcall, bline, _ in block_closure.get(callee, []):
                    blocking.append(
                        (held, f"{callee.split(':', 1)[1]} → {bcall}",
                         v.file, line, v.qualname))
        return edges, blocking


def _sccs(nodes: set[str], edges: dict) -> list[list[str]]:
    """Tarjan strongly-connected components."""
    adj: dict[str, list[str]] = {n: [] for n in nodes}
    for (a, b) in edges:
        if a in adj and b in nodes and a != b:
            adj[a].append(b)
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on: set[str] = set()
    stack: list[str] = []
    out: list[list[str]] = []
    counter = [0]

    def strong(v: str) -> None:
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        for w in adj[v]:
            if w not in index:
                strong(w)
                low[v] = min(low[v], low[w])
            elif w in on:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on.discard(w)
                comp.append(w)
                if w == v:
                    break
            out.append(comp)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        for n in sorted(nodes):
            if n not in index:
                strong(n)
    finally:
        sys.setrecursionlimit(old)
    return out


def run(root: str | Path, files: list[Path] | None = None,
        scope: tuple[str, ...] = DEFAULT_SCOPE) -> list[Finding]:
    root = Path(root)
    an = Analyzer(root, scope=scope, files=files)
    edges, blocking = an.build()
    out: list[Finding] = []
    # cycles
    nodes = set(an.locks)
    for comp in _sccs(nodes, edges):
        if len(comp) < 2:
            continue
        comp_set = set(comp)
        examples = [f"{a} → {b} ({f}:{ln} in {via})"
                    for (a, b), (f, ln, via) in sorted(edges.items())
                    if a in comp_set and b in comp_set][:4]
        f0, l0 = "", 0
        for (a, b), (f, ln, via) in sorted(edges.items()):
            if a in comp_set and b in comp_set:
                f0, l0 = f, ln
                break
        out.append(Finding(
            PASS, "lock-cycle", f0, l0, " ⇄ ".join(sorted(comp)),
            "lock-order cycle: " + "; ".join(examples)
            + " — opposite-order acquisition can deadlock",
            SEV_ERROR))
    # self-cycles on non-reentrant locks
    for (a, b), (f, ln, via) in sorted(edges.items()):
        if a == b and an.locks.get(a) and an.locks[a].kind == "lock":
            out.append(Finding(
                PASS, "lock-self-cycle", f, ln, via,
                f"non-reentrant Lock {a} (re)acquired while already "
                "held — single-thread self-deadlock",
                SEV_ERROR))
    # blocking under lock
    seen: set[tuple] = set()
    for held, call, f, ln, via in blocking:
        key = (tuple(held), call.split(" → ")[-1], f, via)
        if key in seen:
            continue
        seen.add(key)
        out.append(Finding(
            PASS, "lock-held-blocking", f, ln, via,
            f"blocking call {call} while holding {', '.join(held)} — "
            "a stalled peer freezes every thread contending this lock",
            SEV_ERROR))
    return out

"""Shared repo-scanning helpers for the port's tpucheck passes.

Everything here is **static**: the passes parse the sources (AST for
Python, regex for C, C++ and CUDA) and never import the modules under
analysis — a check must not depend on torch/toolchain availability,
must run against any tree state (including the seeded fixture trees of
``--selftest``), and must not execute the code it is judging.

The port's scope.  The repo holds two packages: the JAX reference
(``ompi_tpu/``, checked by its own ``tools/check.py``) and this port.
The port's passes read the port's files only:

* ``ompi_tpu_torch/**`` — Python, and the C, C++ and CUDA of ``csrc/``;
* ``tests/test_torch_*.py`` and ``chip_smoke.py``;
* the README's ``## PyTorch/H100 port`` section (from its heading to the
  next ``## `` heading), ``PERF.md`` and ``ROADMAP.md``.
"""

from __future__ import annotations

import ast
import re
from functools import lru_cache
from pathlib import Path

PORT = "ompi_tpu_torch"

#: the README section that documents the port (its catalogs live there)
README = "README.md"
README_SECTION = "## PyTorch/H100 port"

#: directories the file walk never descends into (hygiene: the linter
#: must not trip over bytecode caches or sanitizer build trees)
EXCLUDE_DIRS = frozenset({
    "__pycache__", ".git", ".pytest_cache", "build", "build-asan",
    "build-tsan", "node_modules", "chiprun_out",
})

#: the port's non-Python files the ``--mca`` reference walk reads
_DOC_SUFFIXES = (".c", ".cc", ".cu", ".cuh", ".h", ".md")


def walk(root: Path, suffixes: tuple[str, ...],
         subdirs: tuple[str, ...] = ()) -> list[Path]:
    """All files under ``root`` (or ``root/<subdir>``s) with one of the
    suffixes, sorted, skipping :data:`EXCLUDE_DIRS` at any depth."""
    roots = [root / s for s in subdirs] if subdirs else [root]
    out: list[Path] = []
    for r in roots:
        if not r.exists():
            continue
        if r.is_file():
            out.append(r)
            continue
        for p in sorted(r.rglob("*")):
            if not p.is_file() or p.suffix not in suffixes:
                continue
            if any(part in EXCLUDE_DIRS for part in p.relative_to(root).parts):
                continue
            out.append(p)
    return out


def rel(root: Path, path: Path) -> str:
    try:
        return str(path.relative_to(root))
    except ValueError:
        return str(path)


def port_py_files(root: Path) -> list[Path]:
    """Every Python source of the port package."""
    return walk(root, (".py",), subdirs=(PORT,))


def port_doc_files(root: Path) -> list[Path]:
    """The rest of the port's ``--mca`` reference corpus: its native
    sources and notes, its tests, ``chip_smoke.py``, ``PERF.md`` and
    ``ROADMAP.md`` (the README's port section is read by
    :func:`readme_port_section`)."""
    out = walk(root, _DOC_SUFFIXES, subdirs=(PORT,))
    tests = root / "tests"
    if tests.is_dir():
        out += sorted(tests.glob("test_torch_*.py"))
    out += [p for p in (root / "chip_smoke.py", root / "PERF.md",
                        root / "ROADMAP.md") if p.is_file()]
    return out


def readme_port_section(root: Path) -> tuple[str, int]:
    """(text, 1-based line of its heading) of the README's port section;
    ("", 0) when the README or the heading is missing."""
    try:
        lines = (root / README).read_text().splitlines()
    except OSError:
        return "", 0
    for i, line in enumerate(lines):
        if line.strip() == README_SECTION:
            end = next((j for j in range(i + 1, len(lines))
                        if lines[j].startswith("## ")), len(lines))
            return "\n".join(lines[i:end]) + "\n", i + 1
    return "", 0


@lru_cache(maxsize=512)
def _parse_cached(path: str, mtime_ns: int) -> ast.Module | None:
    try:
        return ast.parse(Path(path).read_text(), filename=path)
    except SyntaxError:
        return None


def parse_py(path: Path) -> ast.Module | None:
    """Parse a Python file (cached on mtime); None on syntax error —
    callers surface that as a finding, not an exception."""
    try:
        mtime = path.stat().st_mtime_ns
    except OSError:
        return None
    return _parse_cached(str(path), mtime)


def const_str(node: ast.AST) -> str | None:
    return node.value if (isinstance(node, ast.Constant)
                          and isinstance(node.value, str)) else None


def full_var_name(fw: str, comp: str, name: str) -> str:
    return "_".join(p for p in (fw, comp, name) if p)


# -- registered MCA variable names, statically ---------------------------

#: the central registration tables in the port's core/var.py
CENTRAL_TABLES = ("OBSERVABILITY_VARS", "ROBUSTNESS_VARS", "SERVING_VARS",
                  "TRANSPORT_VARS", "SCHEDULE_VARS", "DEVICE_VARS")

VAR_PY = f"{PORT}/core/var.py"


def central_var_tables(root: Path) -> dict[str, list[str]]:
    """Parse core/var.py for the central tables → {table: [full_name]}."""
    out: dict[str, list[str]] = {t: [] for t in CENTRAL_TABLES}
    tree = parse_py(root / VAR_PY)
    if tree is None:
        return out
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not (isinstance(tgt, ast.Name) and tgt.id in CENTRAL_TABLES):
            continue
        if not isinstance(node.value, ast.Tuple):
            continue
        for row in node.value.elts:
            if isinstance(row, ast.Tuple) and len(row.elts) >= 3:
                fw = const_str(row.elts[0])
                comp = const_str(row.elts[1])
                name = const_str(row.elts[2])
                if fw is not None and comp is not None and name is not None:
                    out[tgt.id].append(full_var_name(fw, comp, name))
    return out


def registered_var_names(root: Path) -> set[str]:
    """Every MCA var full name the port can register, statically:

    * the central tables in ``core/var.py``;
    * literal ``store.register(fw, comp, name, …)`` calls anywhere in
      the port (component/lazy registrations);
    * the structural vars the registry derives: ``<fw>_<comp>_priority``
      per Component subclass, the framework selection var ``<fw>``, and
      ``<fw>_base_verbose`` per framework (and per literal
      ``register_verbose_var(store, fw)`` call).
    """
    names: set[str] = set()
    for rows in central_var_tables(root).values():
        names.update(rows)
    frameworks: set[str] = set()
    for path in port_py_files(root):
        tree = parse_py(path)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                fn = node.func
                if (isinstance(fn, ast.Attribute) and fn.attr == "register"
                        and len(node.args) >= 3):
                    fw = const_str(node.args[0])
                    comp = const_str(node.args[1])
                    vname = const_str(node.args[2])
                    if fw is not None and comp is not None and vname is not None:
                        names.add(full_var_name(fw, comp, vname))
                        frameworks.add(fw)
                attr = (fn.attr if isinstance(fn, ast.Attribute)
                        else fn.id if isinstance(fn, ast.Name) else "")
                if attr == "register_verbose_var" and len(node.args) >= 2:
                    fw = const_str(node.args[1])
                    if fw:
                        names.add(f"{fw}_base_verbose")
            elif isinstance(node, ast.ClassDef):
                fw = comp = None
                for stmt in node.body:
                    if (isinstance(stmt, ast.Assign)
                            and len(stmt.targets) == 1
                            and isinstance(stmt.targets[0], ast.Name)):
                        if stmt.targets[0].id == "FRAMEWORK":
                            fw = const_str(stmt.value)
                        elif stmt.targets[0].id == "NAME":
                            comp = const_str(stmt.value)
                if fw and comp:
                    names.add(full_var_name(fw, comp, "priority"))
                    frameworks.add(fw)
    for fw in frameworks:
        if fw:
            names.add(fw)                      # framework selection var
            names.add(f"{fw}_base_verbose")    # auto verbose-stream var
    return names


#: ``--mca <name>`` references in shell-ish text/argv lists, and the
#: env-var spelling.  The two argv forms: ``--mca name value`` in prose/
#: shell, and ``"--mca", "name"`` in Python lists.
_MCA_REF_RES = (
    re.compile(r"--mca[\s=]+([a-z][a-z0-9_]*)"),
    re.compile(r"""--mca['"]\s*,\s*['"]([a-z][a-z0-9_]*)"""),
    re.compile(r"OMPI(?:_TPU)?_MCA_([A-Za-z][A-Za-z0-9_]*)"),
)


def mca_references(text: str) -> list[tuple[str, int]]:
    """(var_name, 1-based line) for every ``--mca``/``OMPI_MCA_`` style
    reference in a text blob."""
    out: list[tuple[str, int]] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        for rx in _MCA_REF_RES:
            for m in rx.finditer(line):
                out.append((m.group(1), lineno))
    return out

"""Findings, the machine-readable report, and the reviewed waiver file.

A :class:`Finding` is one contract violation located at (file, line,
symbol).  Every pass returns a flat list; the check command merges them, maps
the reviewed waivers over them (:func:`apply_waivers`), and emits one
JSON report — the single machine-readable artifact CI and pre-commit
consume.

Waivers live in ``ompi_tpu_torch/analysis/waivers.toml``.  The file is TOML
(array-of-tables ``[[waiver]]``), parsed here by a dependency-free
subset reader because the box's Python (3.10) predates ``tomllib`` —
the subset (tables, string/int/bool scalars, comments) is exactly what
the waiver grammar needs.  Each waiver must name the pass, the rule,
the file, and a one-line ``reason``; ``symbol``/``contains`` narrow
the match.  Line numbers are deliberately NOT part of the match key —
they drift with every edit and would rot the file.

A waiver that matches nothing is itself reported (``stale-waiver``):
the reviewed-exception file must not accrete dead entries.
"""

from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass, field
from pathlib import Path

#: severities, in escalation order
SEV_INFO = "info"      # logged context (e.g. a sanitizer leg skipped)
SEV_WARN = "warn"      # suspicious but not contract-breaking
SEV_ERROR = "error"    # contract violation — fails the check unless waived


@dataclass
class Finding:
    """One located contract violation (or logged note)."""

    pass_name: str          # invariants | lockorder | abidrift | sanitize
    rule: str               # kebab-case rule slug, stable across releases
    file: str               # repo-relative path ("" for repo-wide findings)
    line: int               # 1-based; 0 when the finding is not line-anchored
    symbol: str             # enclosing function/class qualname ("" if none)
    message: str
    severity: str = SEV_ERROR
    waived: bool = False
    waiver_reason: str = ""

    def key(self) -> str:
        return f"{self.pass_name}:{self.rule}:{self.file}:{self.symbol or self.line}"

    def render(self) -> str:
        loc = self.file or "<repo>"
        if self.line:
            loc += f":{self.line}"
        sym = f" [{self.symbol}]" if self.symbol else ""
        tag = " (waived: " + self.waiver_reason + ")" if self.waived else ""
        return f"{self.severity:<5} {self.pass_name}/{self.rule} {loc}{sym}: {self.message}{tag}"


@dataclass
class Waiver:
    """One reviewed exception.  ``pass_name``+``rule``+``file`` are the
    match key; ``symbol``/``contains`` narrow it; ``reason`` is the
    mandatory one-line justification."""

    pass_name: str
    rule: str
    file: str
    reason: str
    symbol: str = ""
    contains: str = ""
    hits: int = field(default=0, compare=False)

    def matches(self, f: Finding) -> bool:
        if f.pass_name != self.pass_name or f.rule != self.rule:
            return False
        if self.file and f.file != self.file:
            return False
        if self.symbol and self.symbol not in (f.symbol or ""):
            return False
        if self.contains and self.contains not in f.message:
            return False
        return True


# -- minimal TOML subset reader -----------------------------------------

_KV_RE = re.compile(r"^([A-Za-z_][A-Za-z0-9_-]*)\s*=\s*(.+)$")


def _parse_scalar(raw: str, path: str, lineno: int):
    raw = raw.strip()
    if raw.startswith('"'):
        m = re.match(r'^"((?:[^"\\]|\\.)*)"\s*(?:#.*)?$', raw)
        if not m:
            raise ValueError(f"{path}:{lineno}: unterminated string")
        return m.group(1).replace('\\"', '"').replace("\\\\", "\\")
    if raw.startswith("'"):
        m = re.match(r"^'([^']*)'\s*(?:#.*)?$", raw)
        if not m:
            raise ValueError(f"{path}:{lineno}: unterminated string")
        return m.group(1)
    raw = raw.split("#", 1)[0].strip()
    if raw in ("true", "false"):
        return raw == "true"
    try:
        return int(raw, 0)
    except ValueError:
        raise ValueError(
            f"{path}:{lineno}: unsupported TOML value {raw!r} "
            "(waiver grammar: quoted strings, ints, booleans)") from None


def parse_toml_tables(text: str, path: str = "waivers.toml") -> list[dict]:
    """Parse ``[[waiver]]`` array-of-tables; returns the table dicts."""
    tables: list[dict] = []
    current: dict | None = None
    for lineno, line in enumerate(text.splitlines(), 1):
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if stripped.startswith("[["):
            if not re.match(r"^\[\[\s*waiver\s*\]\]\s*(#.*)?$", stripped):
                raise ValueError(
                    f"{path}:{lineno}: only [[waiver]] tables are supported")
            current = {}
            tables.append(current)
            continue
        m = _KV_RE.match(stripped)
        if not m:
            raise ValueError(f"{path}:{lineno}: cannot parse {stripped!r}")
        if current is None:
            raise ValueError(
                f"{path}:{lineno}: key outside a [[waiver]] table")
        current[m.group(1)] = _parse_scalar(m.group(2), path, lineno)
    return tables


def load_waivers(path: str | Path) -> list[Waiver]:
    """Read the reviewed waiver file; missing file → no waivers."""
    p = Path(path)
    if not p.exists():
        return []
    waivers = []
    for t in parse_toml_tables(p.read_text(), str(p)):
        missing = [k for k in ("pass", "rule", "file", "reason") if not t.get(k)]
        if missing:
            raise ValueError(
                f"{p}: waiver {t!r} missing required key(s): "
                f"{', '.join(missing)} (every waiver needs pass/rule/file "
                "and a one-line reason)")
        waivers.append(Waiver(
            pass_name=str(t["pass"]), rule=str(t["rule"]),
            file=str(t["file"]), reason=str(t["reason"]),
            symbol=str(t.get("symbol", "")),
            contains=str(t.get("contains", "")),
        ))
    return waivers


def apply_waivers(findings: list[Finding], waivers: list[Waiver],
                  waiver_file: str = "",
                  passes_run: list[str] | None = None) -> list[Finding]:
    """Mark waived findings in place; append a ``stale-waiver`` finding
    for every waiver that matched nothing (the file stays reviewed).
    ``passes_run`` limits staleness reporting to waivers whose pass
    actually ran — a ``--pass abidrift`` run must not call the
    lockorder waivers stale."""
    for w in waivers:
        w.hits = 0
    for f in findings:
        for w in waivers:
            if w.matches(f):
                f.waived = True
                f.waiver_reason = w.reason
                w.hits += 1
                break
    out = list(findings)
    for w in waivers:
        if passes_run is not None and w.pass_name not in passes_run:
            continue
        if w.hits == 0:
            out.append(Finding(
                pass_name="waivers", rule="stale-waiver",
                file=waiver_file or "ompi_tpu_torch/analysis/waivers.toml", line=0,
                symbol=f"{w.pass_name}/{w.rule}:{w.file}",
                message=(f"waiver for {w.pass_name}/{w.rule} at {w.file}"
                         f"{' [' + w.symbol + ']' if w.symbol else ''} "
                         "matched no finding — delete it or fix the match key"),
                severity=SEV_WARN))
    return out


class Report:
    """The one machine-readable findings artifact (JSON schema v1)."""

    VERSION = 1

    def __init__(self, root: str):
        self.root = root
        self.findings: list[Finding] = []
        self.passes_run: list[str] = []
        self.notes: list[str] = []

    def extend(self, pass_name: str, findings: list[Finding]) -> None:
        self.passes_run.append(pass_name)
        self.findings.extend(findings)

    def unwaived(self, min_severity: str = SEV_ERROR) -> list[Finding]:
        sevs = {SEV_ERROR: (SEV_ERROR,),
                SEV_WARN: (SEV_ERROR, SEV_WARN),
                SEV_INFO: (SEV_ERROR, SEV_WARN, SEV_INFO)}[min_severity]
        return [f for f in self.findings
                if not f.waived and f.severity in sevs]

    def to_dict(self) -> dict:
        by_pass: dict[str, int] = {}
        for f in self.findings:
            if not f.waived and f.severity == SEV_ERROR:
                by_pass[f.pass_name] = by_pass.get(f.pass_name, 0) + 1
        return {
            "version": self.VERSION,
            "root": self.root,
            "passes": self.passes_run,
            "notes": self.notes,
            "findings": [asdict(f) for f in self.findings],
            "summary": {
                "total": len(self.findings),
                "waived": sum(1 for f in self.findings if f.waived),
                "unwaived_errors": len(self.unwaived(SEV_ERROR)),
                "by_pass": by_pass,
            },
        }

    def write_json(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2) + "\n")

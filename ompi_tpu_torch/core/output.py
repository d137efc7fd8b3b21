"""Verbose-stream output + show_help (own copy of ``ompi_tpu/core/output.py``).

Every framework gets an output stream whose verbosity is the MCA var
``<framework>_base_verbose``; :func:`show_help` prints a deduplicated
diagnostic block.
"""

from __future__ import annotations

import sys
import threading

_lock = threading.Lock()
_levels: dict[str, int] = {}
_shown: set[tuple] = set()


def set_verbosity(framework: str, level: int) -> None:
    """Pin the framework's stream at ``level`` (over its MCA var)."""
    with _lock:
        _levels[framework] = int(level)


def _level(framework: str) -> int:
    with _lock:
        lvl = _levels.get(framework)
    if lvl is not None:
        return lvl
    from . import mca

    ctx = mca._default
    lvl = int(ctx.store.get(f"{framework}_base_verbose", 0)) if ctx is not None else 0
    with _lock:
        _levels[framework] = lvl
    return lvl


def register_verbose_var(store, framework: str) -> None:
    """Register ``<framework>_base_verbose``."""
    store.register(
        framework, "base", "verbose", 0, type="int",
        help=f"Verbosity for the {framework} framework's output stream "
        f"(0 silent, 1 selection, 10 per-call, 100 firehose)",
    )
    with _lock:
        _levels.pop(framework, None)


def verbose(level: int, framework: str, fmt: str, *args) -> None:
    """Emit when the framework's stream is at or above ``level``."""
    if _level(framework) < level:
        return
    msg = fmt % args if args else fmt
    sys.stderr.write(f"[ompi_tpu_torch:{framework}] {msg}\n")
    sys.stderr.flush()


def show_help(topic: str, key: str, fmt: str, *args, dedup: bool = True) -> None:
    """Operator-facing diagnostic block, deduped by (topic, key)."""
    if dedup:
        with _lock:
            if (topic, key) in _shown:
                return
            _shown.add((topic, key))
    msg = fmt % args if args else fmt
    bar = "-" * 64
    sys.stderr.write(f"{bar}\n[ompi_tpu_torch] {topic}: {key}\n\n{msg}\n{bar}\n")
    sys.stderr.flush()


def reset() -> None:
    """Clear the pinned and cached levels and the show_help dedup."""
    with _lock:
        _levels.clear()
        _shown.clear()

"""Runtime lock-order witness (the dynamic half of the lockorder pass).

Opt-in lockdep/witness-style order recording over *real* lock
instances: while enabled, every ``threading.Lock``/``RLock``/
``Condition`` allocation returns a wrapped lock tagged with its
allocation site ("<file>:<line>" — the runtime analog of lockdep's
lock class), and every acquire records the edge *held → acquired* in
one global order graph.  Observing both ``A → B`` and ``B → A`` is an
**order inversion**: two threads interleaving those paths can
deadlock, even if this run happened not to.  :func:`assert_clean`
turns any recorded inversion into a test failure.

A stdlib-only copy of the reference's witness (same API, same rules).
Usage (the port's tests arm it with a fixture of their own, and
``chip_smoke.py`` around the 8-rank main path on the card)::

    from ompi_tpu_torch.analysis import lockdep
    lockdep.enable()
    try:
        ... exercise threaded code; locks it allocates are witnessed ...
        lockdep.assert_clean()
    finally:
        lockdep.disable()

Scope and honesty notes:

* Only locks **allocated while enabled** are witnessed — the witness
  patches the ``threading`` factories, so module-level locks created
  at import time are invisible.  That matches the intended use: the
  threaded planes (transports, detector, publisher, tpud workers)
  allocate their locks per instance, in ``__init__``.
* ``Condition.wait`` releases the underlying lock; the held-stack
  drops it for the duration so wait-side edges are not fabricated.
* Self-deadlock (re-acquiring a held non-reentrant Lock with no
  timeout) is recorded as a violation too — that is a wedge today,
  not a maybe.
* The witness never *prevents* deadlock; it records the order
  evidence.  Overhead is a dict update per acquire, so it stays
  test-only (enable/disable, never on by default).
"""

from __future__ import annotations

import threading
import traceback
from dataclasses import dataclass

__all__ = [
    "enable", "disable", "enabled", "reset", "violations",
    "assert_clean", "LockOrderInversion", "current_edges",
    "witnessed_locks",
]


class LockOrderInversion(AssertionError):
    """Raised by :func:`assert_clean` when an inversion was observed."""


@dataclass
class Violation:
    kind: str        # "inversion" | "self-deadlock"
    a: str           # lock class (allocation site) acquired first
    b: str           # lock class acquired under a
    where: str       # "file:line" of the acquire completing the cycle
    detail: str

    def render(self) -> str:
        return f"{self.kind}: {self.detail} (at {self.where})"


# one global witness state; guarded by a PRISTINE lock captured before
# any patching so the witness never witnesses itself
_true_lock_factory = threading.Lock
_true_rlock_factory = threading.RLock
_true_condition = threading.Condition

_state_lock = _true_lock_factory()
_enabled = False
_enable_depth = 0   # nested enable()s (session witness + test fixture)
_edges: dict[tuple[str, str], str] = {}   # (held, acquired) -> site
_violations: list[Violation] = []
_sites: set[str] = set()   # lock classes allocated while enabled
_tls = threading.local()


def _held() -> list[str]:
    h = getattr(_tls, "held", None)
    if h is None:
        h = []
        _tls.held = h
    return h


def _alloc_site() -> str:
    """file:line of the frame allocating the lock, skipping this module
    and threading.py itself (Condition allocates an RLock)."""
    for frame in traceback.extract_stack()[-8:][::-1]:
        fn = frame.filename
        if fn.endswith(("analysis/lockdep.py", "threading.py")):
            continue
        return f"{fn.rsplit('/', 1)[-1]}:{frame.lineno}"
    return "<unknown>"


def _call_site() -> str:
    for frame in traceback.extract_stack()[-8:][::-1]:
        fn = frame.filename
        if fn.endswith(("analysis/lockdep.py", "threading.py")):
            continue
        return f"{fn.rsplit('/', 1)[-1]}:{frame.lineno}"
    return "<unknown>"


def _record_acquire(key: str, reentrant: bool, blocking: bool,
                    timeout: float) -> None:
    held = _held()
    site = _call_site()
    with _state_lock:
        if (key in held and not reentrant and blocking and timeout < 0
                and not any(v.kind == "self-deadlock" and v.a == key
                            for v in _violations)):
            _violations.append(Violation(
                "self-deadlock", key, key, site,
                f"non-reentrant lock {key} re-acquired while already "
                f"held by this thread"))
        # a try-acquire never waits, so it cannot participate in a
        # deadlock cycle: record no order edge for it (Linux lockdep
        # excludes trylocks for the same reason).  If it succeeds the
        # lock still joins the held stack below — edges taken while
        # HOLDING it are real regardless of how it was acquired.
        if blocking:
            for h in held:
                if h == key:
                    continue
                fwd = (h, key)
                rev = (key, h)
                if fwd not in _edges:
                    _edges[fwd] = site
                if rev in _edges and not any(
                        v.kind == "inversion" and {v.a, v.b} == {h, key}
                        for v in _violations):
                    _violations.append(Violation(
                        "inversion", h, key, site,
                        f"lock order inversion: {h} → {key} here, but "
                        f"{key} → {h} was recorded at {_edges[rev]}"))
    held.append(key)


def _record_release(key: str) -> None:
    held = _held()
    # remove the most recent acquisition of this class (LIFO-ish; out
    # of order release is legal for locks, so scan from the tail)
    for i in range(len(held) - 1, -1, -1):
        if held[i] == key:
            del held[i]
            return


class _WitnessedLock:
    """Wraps a real lock primitive with order recording.  Mimics the
    Lock/RLock duck type (incl. the private hooks Condition uses)."""

    def __init__(self, inner, key: str, reentrant: bool):
        self._inner = inner
        self._key = key
        self._reentrant = reentrant

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if _enabled:
            _record_acquire(self._key, self._reentrant, blocking, timeout)
        got = self._inner.acquire(blocking, timeout)
        if not got and _enabled:
            _record_release(self._key)  # failed try-acquire: not held
        return got

    def release(self):
        self._inner.release()
        if _enabled:
            _record_release(self._key)

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # Condition(lock=witnessed) support: Condition calls these if
    # present, and releases/reacquires around wait()
    def _release_save(self):
        if _enabled:
            _record_release(self._key)
        if hasattr(self._inner, "_release_save"):
            return self._inner._release_save()
        self._inner.release()
        return None

    def _acquire_restore(self, state):
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        if _enabled:
            _held().append(self._key)

    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self):
        return f"<witnessed {self._key} {self._inner!r}>"


def _witness(inner, reentrant: bool) -> _WitnessedLock:
    site = _alloc_site()
    with _state_lock:
        _sites.add(site)
    return _WitnessedLock(inner, site, reentrant)


def _make_lock():
    return _witness(_true_lock_factory(), reentrant=False)


def _make_rlock():
    return _witness(_true_rlock_factory(), reentrant=True)


def _make_condition(lock=None):
    return _true_condition(lock if lock is not None else _make_rlock())


def enable() -> None:
    """Patch the ``threading`` lock factories; locks allocated from now
    on are witnessed.  Nestable: a test-local witness inside a
    session-wide one must not disarm the outer one — each ``enable()``
    needs a matching ``disable()``, and only the last restores the real
    factories."""
    global _enabled, _enable_depth
    with _state_lock:
        _enable_depth += 1
        if _enabled:
            return
        _enabled = True
    threading.Lock = _make_lock
    threading.RLock = _make_rlock
    threading.Condition = _make_condition


def disable() -> None:
    """Undo one :func:`enable`; the real factories come back when the
    outermost enabler disables.  Already-witnessed locks keep working
    (recording stops — ``_enabled`` gates every hook)."""
    global _enabled, _enable_depth
    with _state_lock:
        _enable_depth = max(0, _enable_depth - 1)
        if _enable_depth > 0:
            return
        _enabled = False
    threading.Lock = _true_lock_factory
    threading.RLock = _true_rlock_factory
    threading.Condition = _true_condition


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Forget recorded edges, violations and lock classes (between
    tests)."""
    with _state_lock:
        _edges.clear()
        _violations.clear()
        _sites.clear()


def violations() -> list[Violation]:
    with _state_lock:
        return list(_violations)


def current_edges() -> dict[tuple[str, str], str]:
    with _state_lock:
        return dict(_edges)


def witnessed_locks() -> list[str]:
    """The lock classes (allocation sites) allocated while enabled since
    the last :func:`reset` — what the witness could see at all."""
    with _state_lock:
        return sorted(_sites)


def assert_clean() -> None:
    """Raise :class:`LockOrderInversion` if any inversion (or
    self-deadlock) was observed since the last :func:`reset`."""
    vs = violations()
    if vs:
        raise LockOrderInversion(
            "lockdep witnessed %d violation(s):\n  " % len(vs)
            + "\n  ".join(v.render() for v in vs))

"""ULFM — user-level failure mitigation (revoke / shrink / agree).

Port of ``ompi_tpu/ft/ulfm.py``: the state, the per-operation guard,
revoke, get_failed/ack_failed, agree, and the entry points of the two
recovery legs, ``shrink`` and ``replace``.

The reference's re-design of Open MPI's fault-tolerance story
(SURVEY.md §5 "Failure detection / elastic recovery": v5's ULFM ext
``ompi/mpiext/ftmpi`` built with ``--with-ft=ulfm`` — ``MPIX_Comm_
revoke/shrink/agree/is_revoked``, ``coll/ftagree`` early-returning
agreement, failure detection via daemon heartbeats + in-band errors).

Semantics preserved:

* a failure is **detected**, not fatal: operations that would involve a
  failed rank raise :class:`MPIProcFailedError` (MPIX_ERR_PROC_FAILED);
  operations among live ranks continue — MPI_ERRORS_RETURN survival;
* ``revoke()`` poisons the communicator for every rank ("an
  out-of-band broadcast beats the failure news to everyone"): all
  subsequent operations raise :class:`MPIRevokedError` EXCEPT the
  recovery trio shrink / agree / failure introspection;
* ``shrink()`` builds a fresh communicator over the live ranks: the
  group renumbers contiguously and the new comm's mesh is the live
  ranks' rows (on a multi-process comm, the survivor processes agree
  the failed set and a new CID first);
* ``replace()`` is the second recovery leg (≈ PRRTE restarting the
  failed proc): under ``tpurun --ft --respawn`` the launcher respawns
  the dead rank and replace() rebuilds the communicator at FULL
  size — multi-process comms only (see :mod:`ompi_tpu_torch.api.multiproc`);
* ``agree(flags)`` is the ftagree fault-tolerant agreement: bitwise
  AND over live ranks' contributions, deciding consistently even with
  failed participants (the reference's early-returning consensus);
* ``get_failed()/ack_failed()`` ≈ MPIX_Comm_get_failed /
  MPIX_Comm_ack_failed: introspect and acknowledge, so ANY_SOURCE
  receives can be re-enabled after acknowledgement.

Failure *injection* has no reference equivalent in-tree (ULFM tests
kill ranks externally); :func:`inject_failure` is the single-controller
analog of the external kill, and the DCN heartbeat detector
(detector.py) is the daemon-heartbeat analog for multi-process jobs.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from ompi_tpu_torch.core.errors import (
    MPIProcFailedError,
    MPIProcFailedPendingError,
    MPIRankError,
    MPIRevokedError,
)


@dataclass
class FTState:
    """Per-communicator fault-tolerance state (lazy, zero-cost until a
    failure appears)."""

    failed: set[int] = field(default_factory=set)
    acked: set[int] = field(default_factory=set)
    revoked: bool = False


_state_lock = threading.Lock()


def state(comm) -> FTState:
    st = getattr(comm, "_ft", None)
    if st is None:
        # three threads can race to lazily create (main, DCN receiver
        # handling a rvk frame, detector fan-out) — losing one side's
        # writes would drop a revoke or a failure
        with _state_lock:
            st = getattr(comm, "_ft", None)
            if st is None:
                st = FTState()
                comm._ft = st
    return st


def peek(comm) -> FTState | None:
    """State if any FT event ever touched this comm, else None — the
    fast path for per-call guards."""
    return getattr(comm, "_ft", None)


def inject_failure(comm, rank: int) -> None:
    """Mark ``rank`` failed on this communicator (the external-kill
    analog; the heartbeat detector calls exactly this on timeout)."""
    if not 0 <= rank < comm.size:
        raise MPIRankError(f"rank {rank} outside [0, {comm.size})")
    state(comm).failed.add(rank)


def check(
    comm,
    peer: int | None = None,
    collective: bool = False,
    any_source: bool = False,
) -> None:
    """The per-operation guard (≈ the in-band error checks ob1/coll do
    under ULFM builds).

    * revoked comm → MPIRevokedError, always;
    * collective ops → fail if ANY failure exists — acknowledged or not
      (collectives involve every rank; a collective can never complete
      with a failed member until shrink rebuilds the membership);
    * ANY_SOURCE receives → MPIX_ERR_PROC_FAILED_PENDING while an
      *unacknowledged* failure exists (ack_failed re-arms them — this
      is the only place the acked set matters);
    * pt2pt → fail only if the named peer failed.
    """
    st = peek(comm)
    if st is None:
        return
    if st.revoked:
        raise MPIRevokedError(f"{comm.name} has been revoked")
    if collective:
        if st.failed:
            raise MPIProcFailedError(
                f"collective on {comm.name} with failed ranks "
                f"{sorted(st.failed)} (revoke+shrink to recover)",
                failed=tuple(sorted(st.failed)),
            )
    elif any_source:
        pending = st.failed - st.acked
        if pending:
            raise MPIProcFailedPendingError(
                f"ANY_SOURCE receive on {comm.name} with unacknowledged "
                f"failed ranks {sorted(pending)} (ack_failed to re-arm)",
                failed=tuple(sorted(pending)),
            )
    elif peer is not None and peer in st.failed:
        raise MPIProcFailedError(
            f"rank {peer} on {comm.name} has failed", failed=(peer,)
        )


def revoke(comm) -> None:
    """MPIX_Comm_revoke."""
    state(comm).revoked = True


def is_revoked(comm) -> bool:
    st = peek(comm)
    return st is not None and st.revoked


def get_failed(comm) -> list[int]:
    """MPIX_Comm_get_failed: global ranks known failed (sorted)."""
    st = peek(comm)
    return sorted(st.failed) if st else []


def ack_failed(comm) -> int:
    """MPIX_Comm_ack_failed: acknowledge every known failure; returns
    the acknowledged count.  Acknowledged failures no longer poison
    collectives-with-failures checks for pt2pt/ANY_SOURCE — but a
    collective still cannot complete with a failed member, so
    collectives keep raising until shrink (matching ULFM: ack re-arms
    ANY_SOURCE, it does not resurrect collectives)."""
    st = state(comm)
    st.acked = set(st.failed)
    return len(st.acked)


def shrink(comm, name: str = ""):
    """MPIX_Comm_shrink: new communicator over the live ranks.

    Works on revoked comms (that is its purpose).  The surviving ranks
    renumber contiguously; the new comm's mesh is their rows."""
    st = peek(comm)
    dead = st.failed if st else set()
    live = [r for r in range(comm.size) if r not in dead]
    if not live:
        raise MPIProcFailedError("cannot shrink: every rank has failed",
                                 failed=tuple(sorted(dead)))
    return comm._shrink_to(live, name or f"{comm.name}.shrunk")


def replace(comm, name: str = ""):
    """Shrink's second leg — the PRRTE restart-the-failed-proc path:
    rebuild the communicator at FULL size after ``tpurun --ft --respawn``
    relaunched the dead rank(s).  Survivors install each reborn
    incarnation's re-published endpoint, clear its failure marks, and
    run a CID-agreement round the fresh-booted process joins; the
    result spans the complete original membership.  On a split/sub
    communicator this repairs ONLY the member ranks, on comm-scoped
    beacon streams — non-members are undisturbed, and the reborn
    process joins via ``world.replace_partial()``.  Single-controller
    comms have no launcher to respawn ranks — multi-process only."""
    fn = getattr(comm, "replace", None)
    if fn is None:
        raise MPIProcFailedError(
            "replace() needs a multi-process communicator under "
            "tpurun --ft --respawn (single-controller comms have no "
            "launcher to restart a rank); use shrink()")
    return fn(name)


def agree(comm, flags: int, contributions: dict[int, int] | None = None) -> int:
    """MPIX_Comm_agree: fault-tolerant agreement — bitwise AND of the
    live ranks' flag words.  ``flags`` is the calling rank's word; in
    the single-controller model all live ranks' contributions are
    supplied at once (default: every live rank contributes ``flags``).
    Completes despite failed ranks (their contribution is dropped, and
    the result notes nothing of them — callers learn about failures
    from get_failed), exactly the ftagree contract.  Works on revoked
    communicators (agreement is how ranks coordinate after revoke)."""
    st = peek(comm)
    dead = st.failed if st else set()
    live = [r for r in range(comm.size) if r not in dead]
    if not live:
        raise MPIProcFailedError("agree with no live ranks",
                                 failed=tuple(sorted(dead)))
    out = ~0
    for r in live:
        word = contributions.get(r, flags) if contributions else flags
        out &= int(word)
    return out

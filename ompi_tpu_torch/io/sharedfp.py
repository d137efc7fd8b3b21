"""sharedfp — shared-file-pointer strategies.

Own copy of ``ompi_tpu/io/sharedfp.py`` (≈ ``ompi/mca/sharedfp/``: the
reference ships THREE components — ``sm`` (a shared-memory offset
segment), ``lockedfile``
(the offset persisted in a side file under fcntl locks, usable across
unrelated processes), and ``individual`` (no coordination: each rank
keeps a private pointer; valid for rank-disjoint access phases)).

Same trio here, selected by ``--mca io_ompio_sharedfp``:

* ``sm`` (default) — the single-address-space degenerate of the shm
  segment: a lock + int.  Correct for every rank the controlling
  process drives;
* ``lockedfile`` — ``<path>.shfp`` holds the 8-byte offset, every
  fetch-add runs under ``flock``: the ONLY variant whose pointer is
  shared across separate job PROCESSES (tpurun workers opening the
  same file), exactly why the reference ships it;
* ``individual`` — per-instance private pointer, no sharing (the
  reference's record-keeping variant reduced to its usable core: each
  process's shared ops order only against themselves).
"""

from __future__ import annotations

import fcntl
import os
import struct
import threading


class SmSharedfp:
    """Lock + int: the shm offset segment in one address space."""

    NAME = "sm"

    def __init__(self, path: str):
        del path
        self._mu = threading.Lock()
        self._pos = 0

    def fetch_add(self, n: int) -> int:
        with self._mu:
            pos = self._pos
            self._pos += n
            return pos

    def get(self) -> int:
        with self._mu:
            return self._pos

    def set(self, pos: int) -> None:
        with self._mu:
            self._pos = int(pos)

    def seed(self, pos: int) -> None:
        """Open-time initialization.  In-process strategies just set;
        the cross-process lockedfile strategy overrides this so only
        the CREATOR of the side file seeds — a late collective opener
        must not clobber a shared pointer peers already advanced."""
        self.set(pos)

    def update(self, fn) -> int:
        """Atomic read-modify-write: pos = fn(pos); returns the new
        value (seek_shared's SEEK_CUR needs the whole RMW under ONE
        lock acquisition)."""
        with self._mu:
            self._pos = int(fn(self._pos))
            return self._pos

    def close(self) -> None:
        pass

    def unlink(self) -> None:
        """Remove persistent pointer state (no-op in-process)."""


class IndividualSharedfp(SmSharedfp):
    """Private per-instance pointer (≈ sharedfp/individual): no
    cross-instance coordination — the caller's shared ops order only
    against the same File object."""

    NAME = "individual"


class LockedfileSharedfp:
    """Offset persisted in ``<path>.shfp`` under flock — shared across
    PROCESSES (≈ sharedfp/lockedfile)."""

    NAME = "lockedfile"

    def __init__(self, path: str):
        self._side = path + ".shfp"
        # O_EXCL probe: exactly ONE opener (the creator) learns it owns
        # seeding; late openers share the existing side file and must
        # not reset a pointer peers may already have advanced
        try:
            self._fd = os.open(
                self._side, os.O_RDWR | os.O_CREAT | os.O_EXCL, 0o644)
            self.created = True
        except FileExistsError:
            self._fd = os.open(self._side, os.O_RDWR, 0o644)
            self.created = False

    def _read_locked(self) -> int:
        os.lseek(self._fd, 0, os.SEEK_SET)
        raw = os.read(self._fd, 8)
        return struct.unpack("<q", raw)[0] if len(raw) == 8 else 0

    def _write_locked(self, pos: int) -> None:
        os.lseek(self._fd, 0, os.SEEK_SET)
        os.write(self._fd, struct.pack("<q", int(pos)))

    def fetch_add(self, n: int) -> int:
        fcntl.flock(self._fd, fcntl.LOCK_EX)
        try:
            pos = self._read_locked()
            self._write_locked(pos + n)
            return pos
        finally:
            fcntl.flock(self._fd, fcntl.LOCK_UN)

    def get(self) -> int:
        fcntl.flock(self._fd, fcntl.LOCK_SH)
        try:
            return self._read_locked()
        finally:
            fcntl.flock(self._fd, fcntl.LOCK_UN)

    def set(self, pos: int) -> None:
        fcntl.flock(self._fd, fcntl.LOCK_EX)
        try:
            self._write_locked(pos)
        finally:
            fcntl.flock(self._fd, fcntl.LOCK_UN)

    def update(self, fn) -> int:
        fcntl.flock(self._fd, fcntl.LOCK_EX)
        try:
            new = int(fn(self._read_locked()))
            self._write_locked(new)
            return new
        finally:
            fcntl.flock(self._fd, fcntl.LOCK_UN)

    def seed(self, pos: int) -> None:
        """Only the side file's creator seeds: a collective-but-
        unsynchronized open must not reset a live pointer a faster
        peer already advanced with write_shared/read_shared."""
        if self.created:
            self.set(pos)

    def close(self) -> None:
        try:
            os.close(self._fd)
        except OSError:
            pass

    def unlink(self) -> None:
        try:
            os.unlink(self._side)
        except OSError:
            pass


SHAREDFP = {c.NAME: c for c in
            (SmSharedfp, LockedfileSharedfp, IndividualSharedfp)}

"""Memchecker-lite — API-level buffer-state validation.

Port of ``ompi_tpu/tool/memchecker.py`` (≈ the reference's
``memchecker/valgrind``).  It guards buffers handed to operations that
read them over a window of time — the partitioned send here:

* **write-protect** — a numpy buffer's ``writeable`` flag is cleared for
  the in-flight window, so a mutation raises ``ValueError`` where it
  happens; restored on completion (only if the guard cleared it);
* **checksum** — an adler32 snapshot at issue, re-verified at
  completion, raising :class:`MPIBufferError` with the operation's name.

The checksum of a tensor reads its bytes to the host: a debug tool's
cost, paid only when attached.  Off by default (``--mca
memchecker_base_enable 1`` or :func:`attach`); detached, a guard site
costs one flag test and never touches a buffer.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from ompi_tpu_torch.core.errors import MPIInternalError
from ompi_tpu_torch.ddt.datatype import to_numpy


class MPIBufferError(MPIInternalError):
    """A buffer owned by an in-flight operation was mutated."""


_attached = False


def attach(flag: bool = True) -> None:
    global _attached
    _attached = flag


def attached() -> bool:
    return _attached


def register_var(store) -> None:
    store.register(
        "memchecker", "base", "enable", False,
        help="Guard buffers owned by in-flight operations: write-protect "
        "host buffers for the in-flight window and checksum-verify at "
        "completion (≈ --enable-memchecker)",
    )


def sync_from_store(store) -> None:
    attach(bool(store.get("memchecker_base_enable", False)))


def checksum(arr) -> int:
    """The snapshot checksum every guard uses; a tensor is read to the
    host first."""
    if isinstance(arr, torch.Tensor):
        arr = to_numpy(arr.detach().contiguous().reshape(-1).view(torch.uint8))
    return zlib.adler32(np.ascontiguousarray(arr).view(np.uint8).reshape(-1))


class Guard:
    """One in-flight buffer guard; ``release()`` exactly once."""

    __slots__ = ("buf", "opname", "checksum", "_cleared_flag")

    def __init__(self, buf: np.ndarray, opname: str):
        self.buf = buf
        self.opname = opname
        self.checksum = checksum(buf)
        self._cleared_flag = False
        if buf.flags.writeable:
            try:
                buf.flags.writeable = False
                self._cleared_flag = True
            except ValueError:
                pass  # view of a non-owning base: the checksum still guards

    def abandon(self) -> None:
        """Restore writeability without verifying (the operation failed;
        its own exception is the diagnostic)."""
        if self._cleared_flag:
            try:
                self.buf.flags.writeable = True
            except ValueError:
                pass

    def release(self) -> None:
        self.abandon()
        if checksum(self.buf) != self.checksum:
            raise MPIBufferError(
                f"buffer owned by in-flight {self.opname} was mutated "
                f"before completion (MPI forbids touching a pending "
                f"operation's buffer; enable-memchecker diagnostic)")


def guard(buf, opname: str) -> Guard | None:
    """Guard ``buf`` for an in-flight window; None when detached or the
    buffer is not host memory."""
    if not _attached or not isinstance(buf, np.ndarray):
        return None
    return Guard(buf, opname)

"""MPI error classes and codes (own copy of ``ompi_tpu/core/errors.py``).

Typed exceptions, each carrying its MPI error class (values as in the
MPI standard's ``mpi.h``), and the errhandler objects a communicator
carries.  The Python surface raises for every error — the idiomatic
form of ``MPI_ERRORS_RETURN`` — so ``ERRORS_RETURN`` is the default.
The fault-tolerance exception classes (``MPIX_ERR_PROC_FAILED`` and
kin) come with the slice that ports the multi-process planes; their
codes are listed here already.
"""

from __future__ import annotations

MPI_SUCCESS = 0
MPI_ERR_BUFFER = 1
MPI_ERR_COUNT = 2
MPI_ERR_TYPE = 3
MPI_ERR_TAG = 4
MPI_ERR_COMM = 5
MPI_ERR_RANK = 6
MPI_ERR_REQUEST = 7
MPI_ERR_ROOT = 8
MPI_ERR_GROUP = 9
MPI_ERR_OP = 10
MPI_ERR_TOPOLOGY = 11
MPI_ERR_DIMS = 12
MPI_ERR_ARG = 13
MPI_ERR_UNKNOWN = 14
MPI_ERR_TRUNCATE = 15
MPI_ERR_OTHER = 16
MPI_ERR_INTERN = 17
MPI_ERR_IN_STATUS = 18
MPI_ERR_PENDING = 19
MPI_ERR_KEYVAL = 36
MPI_ERR_NO_MEM = 34
# RMA / window error classes (MPI-3 one-sided)
MPI_ERR_WIN = 53
MPI_ERR_ASSERT = 22
MPI_ERR_LOCKTYPE = 37
MPI_ERR_DISP = 26
MPI_ERR_RMA_CONFLICT = 46
MPI_ERR_RMA_SYNC = 47
MPI_ERR_RMA_RANGE = 55
MPI_ERR_RMA_ATTACH = 56
MPI_ERR_RMA_FLAVOR = 58
# ULFM fault-tolerance error classes (MPIX_*)
MPIX_ERR_PROC_FAILED = 75
MPIX_ERR_PROC_FAILED_PENDING = 76
MPIX_ERR_REVOKED = 77
# MPI-IO error classes
MPI_ERR_FILE = 30
MPI_ERR_ACCESS = 20
MPI_ERR_AMODE = 21
MPI_ERR_NO_SUCH_FILE = 42
MPI_ERR_FILE_EXISTS = 28
MPI_ERR_FILE_IN_USE = 29
MPI_ERR_READ_ONLY = 45
MPI_ERR_IO = 35


class MPIError(Exception):
    """Base error carrying an MPI error class."""

    error_class = MPI_ERR_OTHER

    def __init__(self, message: str = "", error_class: int | None = None):
        super().__init__(message)
        if error_class is not None:
            self.error_class = error_class


class MPICommError(MPIError):
    error_class = MPI_ERR_COMM


class MPIRankError(MPIError):
    error_class = MPI_ERR_RANK


class MPIRootError(MPIError):
    error_class = MPI_ERR_ROOT


class MPITypeError(MPIError):
    error_class = MPI_ERR_TYPE


class MPICountError(MPIError):
    error_class = MPI_ERR_COUNT


class MPIOpError(MPIError):
    error_class = MPI_ERR_OP


class MPIArgError(MPIError):
    error_class = MPI_ERR_ARG


class MPIRequestError(MPIError):
    error_class = MPI_ERR_REQUEST


class MPITruncateError(MPIError):
    error_class = MPI_ERR_TRUNCATE


class MPIInternalError(MPIError):
    error_class = MPI_ERR_INTERN


class MPIBufferError(MPIError):
    error_class = MPI_ERR_BUFFER


class MPIGroupError(MPIError):
    error_class = MPI_ERR_GROUP


class MPITopologyError(MPIError):
    error_class = MPI_ERR_TOPOLOGY


class MPIDimsError(MPIError):
    error_class = MPI_ERR_DIMS


class MPIKeyvalError(MPIError):
    error_class = MPI_ERR_KEYVAL


class MPIPendingError(MPIError):
    error_class = MPI_ERR_PENDING


class MPIInStatusError(MPIError):
    error_class = MPI_ERR_IN_STATUS


class MPIWinError(MPIError):
    error_class = MPI_ERR_WIN


class MPILockError(MPIError):
    error_class = MPI_ERR_LOCKTYPE


class MPIRMASyncError(MPIError):
    error_class = MPI_ERR_RMA_SYNC


class MPIRMAConflictError(MPIError):
    error_class = MPI_ERR_RMA_CONFLICT


class MPIRMARangeError(MPIError):
    error_class = MPI_ERR_RMA_RANGE


class MPIRMAAttachError(MPIError):
    error_class = MPI_ERR_RMA_ATTACH


class MPIFileError(MPIError):
    error_class = MPI_ERR_FILE


class MPIAmodeError(MPIError):
    error_class = MPI_ERR_AMODE


class MPIIOError(MPIError):
    error_class = MPI_ERR_IO


def error_string(error_class: int) -> str:
    """MPI_Error_string equivalent."""
    names = {v: k for k, v in globals().items()
             if k.startswith("MPI_ERR") or k == "MPI_SUCCESS"}
    return names.get(error_class, f"MPI error class {error_class}")


class Errhandler:
    """An MPI errhandler object.  ``ERRORS_ARE_FATAL`` is the
    standard's default for a C program; the Python surface raises typed
    exceptions for every error (``ERRORS_RETURN``).  ``fn`` is an
    ``MPI_Comm_create_errhandler`` callback, called with
    ``(comm, error_class)`` before the fatal/return action."""

    __slots__ = ("name", "fatal", "fn")

    def __init__(self, name: str, fatal: bool, fn=None):
        self.name = name
        self.fatal = bool(fatal)
        self.fn = fn

    def __repr__(self) -> str:  # pragma: no cover
        return f"<Errhandler {self.name}>"


ERRORS_ARE_FATAL = Errhandler("MPI_ERRORS_ARE_FATAL", fatal=True)
ERRORS_RETURN = Errhandler("MPI_ERRORS_RETURN", fatal=False)


def create_errhandler(fn) -> Errhandler:
    """MPI_Comm_create_errhandler: wrap a user callback."""
    return Errhandler(getattr(fn, "__name__", "user_errhandler"), fatal=False, fn=fn)

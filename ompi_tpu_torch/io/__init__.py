"""MPI-IO stack (the io/fcoll/fbtl/fs/sharedfp frameworks) and the
checkpoint helper."""

from . import checkpoint, component  # noqa: F401  (component registration)
from .file import (  # noqa: F401
    File,
    MODE_APPEND,
    MODE_CREATE,
    MODE_DELETE_ON_CLOSE,
    MODE_EXCL,
    MODE_RDONLY,
    MODE_RDWR,
    MODE_SEQUENTIAL,
    MODE_UNIQUE_OPEN,
    MODE_WRONLY,
    SEEK_CUR,
    SEEK_END,
    SEEK_SET,
)

"""MPI_Info objects — (key, value) hint dictionaries.

Port of ``ompi_tpu/api/info.py`` (≈ ``ompi/info/``): opaque
string→string maps passed to comm/file/window constructors.  Hints the
framework does not understand are accepted and ignored, as the standard
requires, while ``info_env()`` carries the launch-time environment
(command, nprocs).
"""

from __future__ import annotations

from ompi_tpu_torch.core.errors import MPIArgError

MAX_INFO_KEY = 255
MAX_INFO_VAL = 1024


class Info:
    """An MPI_Info object (ordered, case-sensitive key→value strings)."""

    __slots__ = ("_kv",)

    def __init__(self, items: dict[str, str] | None = None):
        self._kv: dict[str, str] = dict(items or {})

    def set(self, key: str, value: str) -> None:
        if not key or len(key) > MAX_INFO_KEY:
            raise MPIArgError(f"bad info key {key!r}")
        if len(value) > MAX_INFO_VAL:
            raise MPIArgError("info value too long")
        self._kv[str(key)] = str(value)

    def get(self, key: str) -> str | None:
        """MPI_Info_get: the value, or None (flag=false)."""
        return self._kv.get(key)

    def delete(self, key: str) -> None:
        if key not in self._kv:
            raise MPIArgError(f"no info key {key!r}")
        del self._kv[key]

    @property
    def nkeys(self) -> int:
        return len(self._kv)

    def nthkey(self, n: int) -> str:
        keys = list(self._kv)
        if not 0 <= n < len(keys):
            raise MPIArgError(f"info key index {n} out of range")
        return keys[n]

    def dup(self) -> "Info":
        return Info(self._kv)

    def items(self):
        return self._kv.items()

    def __repr__(self) -> str:  # pragma: no cover
        return f"<Info {self._kv!r}>"


#: MPI_INFO_NULL — the empty, immutable-by-convention info
INFO_NULL = Info()


def info_env() -> Info:
    """MPI_INFO_ENV: launch-time environment (the command, and
    ``maxprocs`` under the launcher)."""
    import os
    import sys

    kv = {"command": sys.argv[0] if sys.argv else ""}
    if "OMPI_TPU_NPROCS" in os.environ:
        kv["maxprocs"] = os.environ["OMPI_TPU_NPROCS"]
    return Info(kv)

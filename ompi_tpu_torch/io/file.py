"""MPI-IO: files, views, individual/shared/collective data access.

Port of ``ompi_tpu/io/file.py``, the engine of the five IO frameworks
(``io/ompio`` with ``fcoll``, ``fbtl``, ``fs`` and ``sharedfp``, in
:mod:`.component`).

The heart of MPI-IO is the **file view**: per rank ``(disp, etype,
filetype)``, whose filetype data segments *tile* the file from
``disp``.  A view is compiled to a vectorized index map (numpy int64
offsets, the analog of ``Datatype.element_index_array``):

    data byte k  →  disp + (k // tile_size) * tile_extent + one[k % tile_size]

and contiguous runs of mapped bytes collapse into large pread/pwrite
calls.  Collective ``*_all`` calls hand every rank's runs to the
selected fcoll strategy, which aggregates them into few large IO ops.

File data is host bytes on its way to the disk: a tensor is written
through one device-to-host staging copy (``mesh.stage_out`` of its
bytes), and reads return host arrays, which the checkpoint restore
stages onto the card (``mesh.stage_in``).  Nonblocking ``iread``/
``iwrite`` complete eagerly; ``*_shared`` fetch-add the shared pointer
and ``*_ordered`` walk the ranks in rank order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from ompi_tpu_torch.core.errors import (
    MPIAmodeError,
    MPIArgError,
    MPIFileError,
    MPIRankError,
)
from ompi_tpu_torch.ddt.datatype import BYTE, Datatype, numpy_dtype
from ompi_tpu_torch.request import CompletedRequest, Request
from ompi_tpu_torch.tool import spc

# amode bits (values match the reference's mpi.h)
MODE_CREATE = 1
MODE_RDONLY = 2
MODE_WRONLY = 4
MODE_RDWR = 8
MODE_DELETE_ON_CLOSE = 16
MODE_UNIQUE_OPEN = 32
MODE_EXCL = 64
MODE_APPEND = 128
MODE_SEQUENTIAL = 256

# seek whence (MPI_SEEK_*)
SEEK_SET = 600
SEEK_CUR = 602
SEEK_END = 604


class _View:
    """A compiled file view: (disp, etype, filetype) → index map."""

    def __init__(self, disp: int, etype: Datatype, filetype: Datatype):
        if filetype.size == 0:
            raise MPIArgError("filetype with zero data size")
        if filetype.size % etype.size != 0:
            raise MPIArgError(
                f"filetype size {filetype.size} not a multiple of etype "
                f"size {etype.size} (MPI view requirement)"
            )
        self.disp = int(disp)
        self.etype = etype
        self.filetype = filetype
        self.tile_bytes = filetype.size
        self.tile_extent = filetype.extent
        # data-byte-in-tile → file-offset-in-tile
        self.one = np.concatenate(
            [np.arange(o, o + n, dtype=np.int64) for o, n in filetype.iovec()]
        )
        self.contiguous = filetype.is_contiguous and self.disp >= 0

    def map_bytes(self, byte_offset: int, nbytes: int) -> np.ndarray:
        """Absolute file offsets of view bytes [byte_offset, +nbytes)."""
        k = np.arange(byte_offset, byte_offset + nbytes, dtype=np.int64)
        return (
            self.disp
            + (k // self.tile_bytes) * self.tile_extent
            + self.one[k % self.tile_bytes]
        )

    def map_runs(self, byte_offset: int, nbytes: int) -> list[tuple[int, int, int]]:
        """View bytes [byte_offset, +nbytes) as contiguous runs
        [(file_offset, data_offset, length)].  Contiguous views resolve
        arithmetically — no per-byte index materialization, so a 4 GB
        checkpoint shard is ONE run, not 4G int64s."""
        if nbytes == 0:
            return []
        if self.contiguous:
            return [(self.disp + byte_offset, 0, nbytes)]
        return runs_of(self.map_bytes(byte_offset, nbytes))


_DEFAULT_VIEW_ARGS = (0, BYTE, BYTE)


def _np_dtype(dtype) -> np.dtype:
    return numpy_dtype(dtype) if isinstance(dtype, torch.dtype) else np.dtype(dtype)


def runs_of(idx: np.ndarray) -> list[tuple[int, int, int]]:
    """Split sorted-ascending absolute offsets into contiguous runs:
    [(file_offset, start_in_data, length)]."""
    if idx.size == 0:
        return []
    breaks = np.flatnonzero(np.diff(idx) != 1) + 1
    starts = np.concatenate(([0], breaks))
    ends = np.concatenate((breaks, [idx.size]))
    return [(int(idx[s]), int(s), int(e - s)) for s, e in zip(starts, ends)]


@dataclass
class _RankState:
    view: _View
    ptr: int = 0  # individual file pointer, in etype units


class File:
    """An open MPI file (≈ ompio's mca_io_ompio_file_t).

    Single-controller adaptation: one object is the whole-communicator
    file handle; per-rank state (view, individual pointer) is explicit,
    and per-rank calls take ``rank`` first, exactly like the pml/osc
    surfaces.  Collective calls take a rank-indexed list.
    """

    def __init__(self, comm, path: str, amode: int, component,
                 hints: dict | None = None):
        self.comm = comm
        self.path = path
        self.amode = amode
        self.component = component  # io/ompio component (holds fcoll etc.)
        #: MPI_Info hints attached at open (striping_factor /
        #: striping_unit recorded; striping_unit drives the vulcan
        #: stripe below) — surfaced via MPI_File_get_info
        self.hints: dict[str, str] = {
            str(k): str(v) for k, v in (hints or {}).items()
        }
        self._atomicity = False
        self._closed = False
        if not (amode & (MODE_RDONLY | MODE_WRONLY | MODE_RDWR)):
            raise MPIAmodeError("amode needs one of RDONLY/WRONLY/RDWR")
        if bin(amode & (MODE_RDONLY | MODE_WRONLY | MODE_RDWR)).count("1") != 1:
            raise MPIAmodeError("exactly one access mode bit allowed")
        if (amode & MODE_RDONLY) and (amode & (MODE_CREATE | MODE_EXCL)):
            raise MPIAmodeError("RDONLY cannot combine with CREATE/EXCL")
        # fs component opens the fd (≈ fs/ufs)
        self._fd = component.fs.open(path, amode)
        self._ranks = [
            _RankState(_View(*_DEFAULT_VIEW_ARGS)) for _ in range(comm.size)
        ]
        #: shared-pointer strategy (sharedfp component: sm in-process,
        #: lockedfile cross-process via <path>.shfp, individual private)
        self._sharedfp = component.make_sharedfp(path)
        #: per-file fcoll snapshot (the reference selects the strategy
        #: at open and stores it on the handle; later opens with a
        #: different --mca io_ompio_fcoll must not retroactively change
        #: THIS file's collective buffering).  A striping_unit hint
        #: re-stripes the vulcan strategy for THIS file (the fs/lustre
        #: hint → fcoll alignment coupling the reference implements
        #: with the Lustre user library)
        self.fcoll = component.fcoll
        from .fcoll import VulcanFcoll

        if isinstance(component.fcoll, VulcanFcoll):
            su = self.hints.get("striping_unit")
            if not su:
                # no hint: a lustre-selected file aligns to the
                # fs_lustre_stripe_size default (the var's contract)
                fs = getattr(component, "fs", None)
                store = getattr(component, "store", None)
                if (fs is not None and hasattr(fs, "fs_name")
                        and fs.fs_name(self._fd) == "lustre"
                        and store is not None):
                    su = store.get("fs_lustre_stripe_size", None)
            try:
                if su:
                    self.fcoll = VulcanFcoll(int(su))
            except (TypeError, ValueError):
                pass  # malformed hint: keep the framework default
        if amode & MODE_APPEND:
            end = self.get_size()
            for rs in self._ranks:
                # position individual+shared pointers at end (in etype=BYTE units)
                rs.ptr = end
            self._sharedfp.seed(end)
        else:
            # fresh open: seed 0.  For the cross-process lockedfile
            # strategy only the side file's CREATOR seeds here (a late
            # unsynchronized opener must not clobber a pointer peers
            # already advanced); the stale-.shfp-from-an-earlier-job
            # case is handled by the designated-rank reset + barrier in
            # capi.file_open's collective completion.
            self._sharedfp.seed(0)

    # -- lifecycle ------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._sharedfp.close()
        self.component.fs.close(self._fd)
        self._closed = True
        if self.amode & MODE_DELETE_ON_CLOSE:
            self._sharedfp.unlink()
            self.component.fs.delete(self.path)

    def _check(self, writing: bool | None = None, rank: int | None = None):
        """writing=True gates write access, False gates read access,
        None checks the handle only (size/sync/seek are access-neutral)."""
        if self._closed:
            raise MPIFileError(f"{self.path}: file is closed")
        if writing is True and (self.amode & MODE_RDONLY):
            raise MPIAmodeError(f"{self.path}: opened RDONLY")
        if writing is False and (self.amode & MODE_WRONLY):
            raise MPIAmodeError(f"{self.path}: opened WRONLY")
        if rank is not None and not 0 <= rank < self.comm.size:
            raise MPIRankError(f"rank {rank} outside [0, {self.comm.size})")

    # -- size / sync ----------------------------------------------------

    def get_size(self) -> int:
        self._check()
        return self.component.fs.size(self._fd)

    def set_size(self, size: int) -> None:
        self._check(writing=True)
        self.component.fs.resize(self._fd, size)

    def preallocate(self, size: int) -> None:
        """MPI_File_preallocate: ensure byte capacity."""
        if size > self.get_size():
            self.set_size(size)

    def sync(self) -> None:
        self._check()
        self.component.fs.sync(self._fd)

    def set_atomicity(self, flag: bool) -> None:
        self._atomicity = bool(flag)

    def get_atomicity(self) -> bool:
        return self._atomicity

    # -- views ----------------------------------------------------------

    def set_view(self, rank: int, disp: int, etype: Datatype | None = None,
                 filetype: Datatype | None = None) -> None:
        """MPI_File_set_view: resets the rank's pointers to 0."""
        self._check(rank=rank)
        etype = etype or BYTE
        filetype = filetype or etype
        self._ranks[rank].view = _View(disp, etype, filetype)
        self._ranks[rank].ptr = 0
        self._sharedfp.set(0)

    def get_view(self, rank: int) -> tuple[int, Datatype, Datatype]:
        self._check(rank=rank)
        v = self._ranks[rank].view
        return v.disp, v.etype, v.filetype

    # -- pointers -------------------------------------------------------

    def seek(self, rank: int, offset: int, whence: int = SEEK_SET) -> None:
        self._check(rank=rank)
        rs = self._ranks[rank]
        if whence == SEEK_SET:
            new = offset
        elif whence == SEEK_CUR:
            new = rs.ptr + offset
        elif whence == SEEK_END:
            # end of view data in etype units
            new = self._view_end_etypes(rank) + offset
        else:
            raise MPIArgError(f"bad whence {whence}")
        if new < 0:
            raise MPIArgError("file pointer moved before start of view")
        rs.ptr = new

    def get_position(self, rank: int) -> int:
        self._check(rank=rank)
        return self._ranks[rank].ptr

    def get_byte_offset(self, rank: int, offset: int) -> int:
        """MPI_File_get_byte_offset: view offset (etypes) → absolute."""
        self._check(rank=rank)
        v = self._ranks[rank].view
        return int(v.map_bytes(offset * v.etype.size, 1)[0])

    def _view_end_etypes(self, rank: int) -> int:
        """Current EOF position expressed in the rank's view etypes."""
        v = self._ranks[rank].view
        fsize = self.get_size()
        span = max(0, fsize - v.disp)
        ntiles = span // v.tile_extent if v.tile_extent else 0
        return (ntiles * v.tile_bytes) // v.etype.size

    # -- data conversion -------------------------------------------------

    def _as_bytes(self, data) -> np.ndarray:
        """The data's bytes on the host: a tensor crosses in one staging
        copy of its bytes."""
        if isinstance(data, torch.Tensor):
            return self.comm.mesh.stage_out(
                data.detach().contiguous().reshape(-1).view(torch.uint8))
        a = np.ascontiguousarray(data)
        return a.view(np.uint8).reshape(-1)

    def _etype_count_bytes(self, rank: int, count: int) -> int:
        v = self._ranks[rank].view
        return count * v.etype.size

    # -- individual read/write ------------------------------------------

    def write_at(self, rank: int, offset: int, data) -> int:
        """Write at explicit view offset (etype units); returns etype
        count written."""
        self._check(writing=True, rank=rank)
        v = self._ranks[rank].view
        raw = self._as_bytes(data)
        if raw.nbytes % v.etype.size:
            raise MPIArgError(
                f"write of {raw.nbytes} B is not a whole number of "
                f"etype ({v.etype.size} B) elements"
            )
        runs = v.map_runs(offset * v.etype.size, raw.nbytes)
        self.component.fbtl.pwritev(self._fd, runs, raw)
        spc.inc("file_write_bytes", raw.nbytes)
        return raw.nbytes // v.etype.size

    def read_at(self, rank: int, offset: int, count: int,
                dtype=np.uint8) -> np.ndarray:
        """Read ``count`` etypes at explicit view offset; returns the
        data as ``dtype`` (must tile the byte stream exactly)."""
        self._check(writing=False, rank=rank)
        v = self._ranks[rank].view
        nbytes = self._etype_count_bytes(rank, count)
        runs = v.map_runs(offset * v.etype.size, nbytes)
        raw = self.component.fbtl.preadv(self._fd, runs, nbytes)
        spc.inc("file_read_bytes", nbytes)
        return raw.view(_np_dtype(dtype))

    def write(self, rank: int, data) -> int:
        """Write at the individual pointer, advancing it."""
        n = self.write_at(rank, self._ranks[rank].ptr, data)
        self._ranks[rank].ptr += n
        return n

    def read(self, rank: int, count: int, dtype=np.uint8) -> np.ndarray:
        out = self.read_at(rank, self._ranks[rank].ptr, count, dtype)
        self._ranks[rank].ptr += count
        return out

    # nonblocking variants (eager completion; see module docstring)

    def iwrite_at(self, rank: int, offset: int, data) -> Request:
        return CompletedRequest(self.write_at(rank, offset, data))

    def iread_at(self, rank: int, offset: int, count: int, dtype=np.uint8) -> Request:
        return CompletedRequest(self.read_at(rank, offset, count, dtype))

    def iwrite(self, rank: int, data) -> Request:
        return CompletedRequest(self.write(rank, data))

    def iread(self, rank: int, count: int, dtype=np.uint8) -> Request:
        return CompletedRequest(self.read(rank, count, dtype))

    # -- shared file pointer (sharedfp component) -----------------------

    def write_shared(self, rank: int, data) -> int:
        """Fetch-add the shared pointer, write there."""
        self._check(writing=True, rank=rank)
        v = self._ranks[rank].view
        raw = self._as_bytes(data)
        if raw.nbytes % v.etype.size:
            # validate BEFORE the fetch-add: a partial-etype write must
            # not permanently advance the shared pointer
            raise MPIArgError(
                f"shared write of {raw.nbytes} B is not a whole number "
                f"of etype ({v.etype.size} B) elements"
            )
        n = raw.nbytes // v.etype.size
        pos = self._sharedfp.fetch_add(n)
        self.write_at(rank, pos, data)
        return n

    def read_shared(self, rank: int, count: int, dtype=np.uint8) -> np.ndarray:
        self._check(writing=False, rank=rank)
        pos = self._sharedfp.fetch_add(count)
        return self.read_at(rank, pos, count, dtype)

    def seek_shared(self, offset: int, whence: int = SEEK_SET) -> None:
        self._check()
        if whence not in (SEEK_SET, SEEK_CUR, SEEK_END):
            raise MPIArgError(f"bad whence {whence}")
        end = self._view_end_etypes(0) if whence == SEEK_END else 0

        def move(cur: int) -> int:
            new = (offset if whence == SEEK_SET
                   else cur + offset if whence == SEEK_CUR
                   else end + offset)
            if new < 0:
                raise MPIArgError("shared pointer moved before start")
            return new

        self._sharedfp.update(move)  # ONE lock acquisition: SEEK_CUR
        # cannot lose a concurrent fetch-add (old single-lock contract)

    def get_position_shared(self) -> int:
        return self._sharedfp.get()

    def write_ordered(self, blocks: Sequence[Any]) -> list[int]:
        """Collective: each rank writes its block at the shared pointer
        in **rank order** (MPI_File_write_ordered)."""
        self._check(writing=True)
        if len(blocks) != self.comm.size:
            raise MPIArgError(f"need {self.comm.size} blocks")
        return [self.write_shared(r, b) for r, b in enumerate(blocks)]

    def read_ordered(self, counts: Sequence[int], dtype=np.uint8) -> list[np.ndarray]:
        self._check(writing=False)
        if len(counts) != self.comm.size:
            raise MPIArgError(f"need {self.comm.size} counts")
        return [self.read_shared(r, c, dtype) for r, c in enumerate(counts)]

    # -- collective read/write (fcoll component) ------------------------

    def write_at_all(self, offsets: Sequence[int], blocks: Sequence[Any]) -> list[int]:
        """Collective write at explicit per-rank offsets: the selected
        fcoll strategy aggregates every rank's runs into large IO ops."""
        self._check(writing=True)
        n = self.comm.size
        if len(offsets) != n or len(blocks) != n:
            raise MPIArgError(f"need {n} offsets and blocks")
        per_rank = []
        counts = []
        for r, (off, data) in enumerate(zip(offsets, blocks)):
            if data is None:
                counts.append(0)
                continue
            v = self._ranks[r].view
            raw = self._as_bytes(data)
            if raw.nbytes % v.etype.size:
                raise MPIArgError(f"rank {r}: partial etype write")
            runs = v.map_runs(off * v.etype.size, raw.nbytes)
            per_rank.append((runs, raw))
            counts.append(raw.nbytes // v.etype.size)
        self.fcoll.write_all(self.component.fbtl, self._fd, per_rank)
        return counts

    def read_at_all(self, offsets: Sequence[int], counts: Sequence[int],
                    dtype=np.uint8) -> list[np.ndarray]:
        self._check(writing=False)
        n = self.comm.size
        if len(offsets) != n or len(counts) != n:
            raise MPIArgError(f"need {n} offsets and counts")
        reqs = []
        for r, (off, cnt) in enumerate(zip(offsets, counts)):
            v = self._ranks[r].view
            nbytes = cnt * v.etype.size
            reqs.append((v.map_runs(off * v.etype.size, nbytes), nbytes))
        raws = self.fcoll.read_all(self.component.fbtl, self._fd, reqs)
        return [raw.view(_np_dtype(dtype)) for raw in raws]

    def write_all(self, blocks: Sequence[Any]) -> list[int]:
        """Collective write at each rank's individual pointer."""
        offsets = [self._ranks[r].ptr for r in range(self.comm.size)]
        counts = self.write_at_all(offsets, blocks)
        for r, c in enumerate(counts):
            self._ranks[r].ptr += c
        return counts

    def read_all(self, counts: Sequence[int], dtype=np.uint8) -> list[np.ndarray]:
        offsets = [self._ranks[r].ptr for r in range(self.comm.size)]
        out = self.read_at_all(offsets, counts, dtype)
        for r, c in enumerate(counts):
            self._ranks[r].ptr += c
        return out

    def __repr__(self) -> str:  # pragma: no cover
        return f"<File {self.path} amode={self.amode} closed={self._closed}>"

"""MPI datatypes over torch dtypes: predefined and derived.

Own copy of ``ompi_tpu/ddt/datatype.py``.  A datatype is a typemap of
``(leaf dtype, byte offset)`` pairs plus ``lb``/``extent``; here the
leaves are ``torch.dtype`` objects, so bfloat16 is a first-class leaf
without ml_dtypes.

The module also owns the numpy ↔ torch crossing the staging layer uses:
``torch.from_numpy`` rejects ml_dtypes' bfloat16, so those arrays cross
as a ``uint16`` view and are re-viewed as ``torch.bfloat16``.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch

from ompi_tpu_torch.core.errors import MPIArgError, MPITypeError

#: the unsigned dtypes torch's CPU kernels mostly lack arithmetic for
UNSIGNED_DTYPES = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)

#: same-width signed twin of each unsigned dtype (the carrier view the
#: collectives move and fold unsigned payloads through)
SIGNED_TWIN = {
    torch.uint8: torch.int8,
    torch.uint16: torch.int16,
    torch.uint32: torch.int32,
    torch.uint64: torch.int64,
}

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def _is_bfloat16(d: np.dtype) -> bool:
    # ml_dtypes' bfloat16 reports kind 'V'; match it by name so this
    # module does not need ml_dtypes to be installed
    return d.kind == "V" and d.name == "bfloat16"


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype or dtype name (ml_dtypes
    bfloat16 included; the name ``"bfloat16"`` needs no ml_dtypes)."""
    if isinstance(np_dtype, torch.dtype):
        return np_dtype
    if np_dtype == "bfloat16":
        return torch.bfloat16
    d = np.dtype(np_dtype)
    if _is_bfloat16(d):
        return torch.bfloat16
    try:
        return _NP_TO_TORCH[d]
    except KeyError:
        raise MPITypeError(f"no torch dtype for numpy dtype {d}") from None


def numpy_name(t: torch.dtype) -> str:
    """numpy's name of a torch dtype (``"bfloat16"`` without ml_dtypes)."""
    return "bfloat16" if t == torch.bfloat16 else str(numpy_dtype(t))


def numpy_dtype(t: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (bfloat16 needs ml_dtypes)."""
    if t == torch.bfloat16:
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    try:
        return _TORCH_TO_NP[t]
    except KeyError:
        raise MPITypeError(f"no numpy dtype for torch dtype {t}") from None


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a contiguous numpy array's own memory (no copy;
    bfloat16 via uint16)."""
    if _is_bfloat16(a.dtype):
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_numpy(a: np.ndarray, device: torch.device | str = "cpu") -> torch.Tensor:
    """numpy array → tensor on ``device`` (a copy; bfloat16 via uint16)."""
    return host_tensor(np.ascontiguousarray(a)).to(device, copy=True)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor → numpy array on the host (bfloat16 via uint16)."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(numpy_dtype(torch.bfloat16))
    return t.numpy()


def dtype_kind(t: torch.dtype) -> str:
    """numpy-style kind letter of a torch dtype: b, u, i, f or c."""
    if t == torch.bool:
        return "b"
    if t in UNSIGNED_DTYPES:
        return "u"
    if t.is_complex:
        return "c"
    if t.is_floating_point:
        return "f"
    return "i"


def _alignment(t: torch.dtype) -> int:
    """C alignment of a leaf dtype, as numpy reports it: a complex
    number aligns to one of its two parts."""
    return t.itemsize // 2 if t.is_complex else t.itemsize


class Datatype:
    """An MPI datatype: ``typemap`` of ``(torch.dtype, byte offset)``
    leaves for one element, plus MPI ``lb``/``extent``.

    ``commit()`` flattens the typemap into the **iovec program** —
    merged ``(offset, nbytes)`` contiguous segments in pack order — and
    :meth:`element_index_array` turns ``count`` elements into one flat
    int64 byte-index array, so that pack and unpack are one gather and
    one scatter (numpy on the host, ``torch.take`` on a tensor's own
    device).  The constructors mirror MPI: contiguous, vector, hvector,
    indexed, hindexed, indexed_block, struct, subarray, resized, dup.
    """

    __slots__ = ("name", "typemap", "lb", "extent", "uniform_leaf", "predefined",
                 "committed", "_iovec", "_index_cache", "_one", "_device_index")

    def __init__(
        self,
        typemap: Sequence[tuple[torch.dtype, int]],
        lb: int,
        extent: int,
        name: str = "",
        predefined: bool = False,
    ):
        self.typemap = tuple((d, int(o)) for d, o in typemap)
        self.lb = int(lb)
        self.extent = int(extent)
        self.name = name
        self.predefined = predefined
        self.committed = predefined
        self._iovec: tuple[tuple[int, int], ...] | None = None
        self._index_cache: dict[int, np.ndarray] = {}
        self._one: np.ndarray | None = None
        #: (count, device) → int64 index tensor on that device (the last few)
        self._device_index: dict[tuple, torch.Tensor] = {}
        leaves = {d for d, _ in self.typemap}
        self.uniform_leaf = leaves.pop() if len(leaves) == 1 else None

    # -- core properties -----------------------------------------------------

    @property
    def size(self) -> int:
        """Bytes of data per element (MPI_Type_size)."""
        return sum(d.itemsize for d, _ in self.typemap)

    @property
    def ub(self) -> int:
        return self.lb + self.extent

    @property
    def true_lb(self) -> int:
        return min((o for _, o in self.typemap), default=0)

    @property
    def true_extent(self) -> int:
        if not self.typemap:
            return 0
        return max(o + d.itemsize for d, o in self.typemap) - self.true_lb

    @property
    def is_contiguous(self) -> bool:
        """True iff count elements occupy one gap-free byte range (the
        zero-copy fast path)."""
        iov = self.iovec()
        if len(iov) != 1:
            return False
        off, nbytes = iov[0]
        return off == self.lb and nbytes == self.extent

    # -- committed products --------------------------------------------------

    def commit(self) -> "Datatype":
        """MPI_Type_commit: build the iovec program."""
        self.committed = True
        self.iovec()
        return self

    def iovec(self) -> tuple[tuple[int, int], ...]:
        """Merged (offset, nbytes) segments of one element, in pack order."""
        if self._iovec is None:
            segs: list[list[int]] = []
            for d, o in self.typemap:
                if segs and segs[-1][0] + segs[-1][1] == o:
                    segs[-1][1] += d.itemsize
                else:
                    segs.append([o, d.itemsize])
            self._iovec = tuple((a, b) for a, b in segs)
        return self._iovec

    def _one_element(self) -> np.ndarray:
        """Byte indices of one element, in pack order."""
        if self._one is None:
            self._one = np.concatenate(
                [np.arange(o, o + n, dtype=np.int64) for o, n in self.iovec()]
            ) if self.typemap else np.empty(0, np.int64)
        return self._one

    def element_index_array(self, count: int) -> np.ndarray:
        """int64 byte indices (relative to the buffer start) touched by
        ``count`` elements, in pack order."""
        idx = self._index_cache.get(count)
        if idx is not None:
            return idx
        one = self._one_element()
        idx = (one[None, :]
               + (np.arange(count, dtype=np.int64) * self.extent)[:, None]).reshape(-1)
        if count <= 64:  # don't cache unboundedly
            self._index_cache[count] = idx
        return idx

    def element_index_tensor(self, count: int, device: torch.device) -> torch.Tensor:
        """:meth:`element_index_array` as an int64 tensor on ``device``,
        built there from the one-element indices (only those cross from
        the host), so a device pack moves no buffer bytes to the host."""
        key = (count, torch.device(device))
        t = self._device_index.get(key)
        if t is None:
            one = torch.from_numpy(self._one_element()).to(device)
            steps = torch.arange(count, dtype=torch.int64, device=device) * self.extent
            t = (one[None, :] + steps[:, None]).reshape(-1)
            if len(self._device_index) >= 4:  # the last few shapes only
                self._device_index.pop(next(iter(self._device_index)))
            self._device_index[key] = t
        return t

    def index_bounds(self, count: int) -> tuple[int, int]:
        """(lowest, one past the highest) byte index of ``count``
        elements, computed from one element (no index array built)."""
        one = self._one_element()
        if count == 0 or one.size == 0:
            return 0, 0
        lo, hi = int(one.min()), int(one.max()) + 1
        last = (count - 1) * self.extent
        return lo + min(0, last), hi + max(0, last)

    def span(self, count: int) -> int:
        """Bytes a count-element buffer must span (relative to lb)."""
        if count == 0:
            return 0
        return (count - 1) * self.extent + self.true_lb + self.true_extent - self.lb

    # -- derived-type constructors (MPI_Type_*) ------------------------------

    def dup(self, name: str = "") -> "Datatype":
        return Datatype(self.typemap, self.lb, self.extent, name or self.name)

    def create_contiguous(self, count: int) -> "Datatype":
        if count < 0:
            raise MPIArgError("negative count")
        tm = [(d, o + i * self.extent) for i in range(count) for d, o in self.typemap]
        return Datatype(tm, self.lb, self.extent * count, f"contig({count})*{self.name}")

    def create_vector(self, count: int, blocklength: int, stride: int) -> "Datatype":
        """stride in ELEMENTS (MPI_Type_vector)."""
        return self.create_hvector(count, blocklength, stride * self.extent)

    def create_hvector(self, count: int, blocklength: int, stride_bytes: int) -> "Datatype":
        if count < 0 or blocklength < 0:
            raise MPIArgError("negative count/blocklength")
        tm = []
        for i in range(count):
            for j in range(blocklength):
                off = i * stride_bytes + j * self.extent
                tm.extend((d, o + off) for d, o in self.typemap)
        if tm:
            # lb/ub over the map and the basis type's bounds (the stride
            # may be negative)
            offs = [i * stride_bytes + j * self.extent
                    for i in range(count) for j in range(blocklength)]
            lb = min(min(o for _, o in tm), min(offs) + self.lb)
            ub = max(offs) + self.ub
        else:
            lb, ub = 0, 0
        return Datatype(tm, lb, ub - lb, f"hvector({count},{blocklength})*{self.name}")

    def create_indexed(self, blocklengths: Sequence[int],
                       displacements: Sequence[int]) -> "Datatype":
        """displacements in ELEMENTS (MPI_Type_indexed)."""
        return self.create_hindexed(blocklengths, [d * self.extent for d in displacements])

    def create_hindexed(self, blocklengths: Sequence[int],
                        displacements_bytes: Sequence[int]) -> "Datatype":
        if len(blocklengths) != len(displacements_bytes):
            raise MPIArgError("blocklengths/displacements length mismatch")
        tm, bounds = [], []
        for bl, disp in zip(blocklengths, displacements_bytes):
            if bl < 0:
                raise MPIArgError("negative blocklength")
            for j in range(bl):
                off = disp + j * self.extent
                tm.extend((d, o + off) for d, o in self.typemap)
                bounds.append((off + self.lb, off + self.ub))
        lb = min((b[0] for b in bounds), default=0)
        ub = max((b[1] for b in bounds), default=0)
        return Datatype(tm, lb, ub - lb, f"hindexed({len(blocklengths)})*{self.name}")

    def create_indexed_block(self, blocklength: int,
                             displacements: Sequence[int]) -> "Datatype":
        return self.create_indexed([blocklength] * len(displacements), displacements)

    def create_resized(self, lb: int, extent: int) -> "Datatype":
        return Datatype(self.typemap, lb, extent, f"resized*{self.name}")

    def create_subarray(self, sizes: Sequence[int], subsizes: Sequence[int],
                        starts: Sequence[int], order: str = "C") -> "Datatype":
        """MPI_Type_create_subarray (order 'C' or 'F'); the extent spans
        the full array."""
        ndims = len(sizes)
        if not (len(subsizes) == len(starts) == ndims):
            raise MPIArgError("sizes/subsizes/starts length mismatch")
        for s, ss, st in zip(sizes, subsizes, starts):
            if ss < 0 or st < 0 or st + ss > s:
                raise MPIArgError("subarray out of bounds")
        if order not in ("C", "F"):
            raise MPIArgError("order must be 'C' or 'F'")
        strides = [0] * ndims  # in elements of the basis type
        acc = 1
        for i in (reversed(range(ndims)) if order == "C" else range(ndims)):
            strides[i] = acc
            acc *= sizes[i]
        dim_ranges = [range(st, st + ss) for st, ss in zip(starts, subsizes)]
        # pack order: row-major over the subarray for C, column-major for F
        coords = (itertools.product(*dim_ranges) if order == "C"
                  else (t[::-1] for t in itertools.product(*dim_ranges[::-1])))
        tm = []
        for coord in coords:
            off = sum(c * s for c, s in zip(coord, strides)) * self.extent
            tm.extend((d, o + off) for d, o in self.typemap)
        return Datatype(tm, 0, acc * self.extent, f"subarray{tuple(subsizes)}*{self.name}")

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Datatype({self.name or 'anon'}, size={self.size}, "
                f"lb={self.lb}, extent={self.extent}, leaves={len(self.typemap)})")


def create_struct(
    blocklengths: Sequence[int],
    displacements_bytes: Sequence[int],
    types: Sequence[Datatype],
) -> Datatype:
    """MPI_Type_create_struct, extent padded to the widest member's
    alignment (so arrays of C structs line up)."""
    if not (len(blocklengths) == len(displacements_bytes) == len(types)):
        raise MPIArgError("struct argument length mismatch")
    tm, bounds, max_align = [], [], 1
    for bl, disp, t in zip(blocklengths, displacements_bytes, types):
        if bl < 0:
            raise MPIArgError("negative blocklength")
        for d, _ in t.typemap:
            max_align = max(max_align, _alignment(d))
        for j in range(bl):
            off = disp + j * t.extent
            tm.extend((d, o + off) for d, o in t.typemap)
            bounds.append((off + t.lb, off + t.ub))
    lb = min((b[0] for b in bounds), default=0)
    ub = max((b[1] for b in bounds), default=0)
    extent = ub - lb
    if extent % max_align:
        extent += max_align - extent % max_align
    return Datatype(tm, lb, extent, f"struct({len(types)})")


def _predef(t: torch.dtype, name: str) -> Datatype:
    return Datatype([(t, 0)], 0, t.itemsize, name, predefined=True)


BYTE = _predef(torch.uint8, "MPI_BYTE")
CHAR = _predef(torch.int8, "MPI_CHAR")
UNSIGNED_CHAR = _predef(torch.uint8, "MPI_UNSIGNED_CHAR")
SHORT = _predef(torch.int16, "MPI_SHORT")
UNSIGNED_SHORT = _predef(torch.uint16, "MPI_UNSIGNED_SHORT")
INT = _predef(torch.int32, "MPI_INT")
UNSIGNED = _predef(torch.uint32, "MPI_UNSIGNED")
LONG = _predef(torch.int64, "MPI_LONG")
UNSIGNED_LONG = _predef(torch.uint64, "MPI_UNSIGNED_LONG")
LONG_LONG = _predef(torch.int64, "MPI_LONG_LONG")
INT8_T = _predef(torch.int8, "MPI_INT8_T")
INT16_T = _predef(torch.int16, "MPI_INT16_T")
INT32_T = _predef(torch.int32, "MPI_INT32_T")
INT64_T = _predef(torch.int64, "MPI_INT64_T")
UINT8_T = _predef(torch.uint8, "MPI_UINT8_T")
UINT16_T = _predef(torch.uint16, "MPI_UINT16_T")
UINT32_T = _predef(torch.uint32, "MPI_UINT32_T")
UINT64_T = _predef(torch.uint64, "MPI_UINT64_T")
FLOAT = _predef(torch.float32, "MPI_FLOAT")
DOUBLE = _predef(torch.float64, "MPI_DOUBLE")
C_BOOL = _predef(torch.bool, "MPI_C_BOOL")
WCHAR = _predef(torch.int32, "MPI_WCHAR")
FLOAT16 = _predef(torch.float16, "MPIX_FLOAT16")
BFLOAT16 = _predef(torch.bfloat16, "MPIX_BFLOAT16")
COMPLEX = _predef(torch.complex64, "MPI_C_FLOAT_COMPLEX")
DOUBLE_COMPLEX = _predef(torch.complex128, "MPI_C_DOUBLE_COMPLEX")


def _pair(value_dt: Datatype, name: str) -> Datatype:
    """MAXLOC/MINLOC pair type: value + int index, C-struct layout."""
    disp = value_dt.size
    if disp % INT.size:
        disp += INT.size - disp % INT.size
    t = create_struct([1, 1], [0, disp], [value_dt, INT])
    t.name = name
    return t.commit()


FLOAT_INT = _pair(FLOAT, "MPI_FLOAT_INT")
DOUBLE_INT = _pair(DOUBLE, "MPI_DOUBLE_INT")
LONG_INT = _pair(LONG, "MPI_LONG_INT")
SHORT_INT = _pair(SHORT, "MPI_SHORT_INT")
TWO_INT = _pair(INT, "MPI_2INT")

#: name → datatype, in the reference's order (its leaf lookup below
#: finds the first name of each leaf dtype, as the reference's does)
PREDEFINED: dict[str, Datatype] = {
    t.name: t
    for t in [
        BYTE, CHAR, UNSIGNED_CHAR, SHORT, UNSIGNED_SHORT, INT, UNSIGNED,
        LONG, UNSIGNED_LONG, LONG_LONG, INT8_T, INT16_T, INT32_T, INT64_T,
        UINT8_T, UINT16_T, UINT32_T, UINT64_T, FLOAT, DOUBLE, C_BOOL,
        WCHAR, FLOAT16, COMPLEX, DOUBLE_COMPLEX,
        FLOAT_INT, DOUBLE_INT, LONG_INT, SHORT_INT, TWO_INT, BFLOAT16,
    ]
}


def from_torch_dtype(t: torch.dtype) -> Datatype:
    """The predefined MPI datatype of a torch scalar dtype."""
    for dt in PREDEFINED.values():
        if dt.uniform_leaf == t and len(dt.typemap) == 1:
            return dt
    raise MPITypeError(f"no predefined MPI datatype for torch dtype {t}")


def from_numpy_dtype(np_dtype) -> Datatype:
    """The predefined MPI datatype of a numpy scalar dtype."""
    return from_torch_dtype(torch_dtype(np_dtype))

"""Pack/unpack convertor — (de)serialization of datatype buffers.

Port of ``ompi_tpu/ddt/convertor.py`` (≈ ``opal_convertor``).  The
committed iovec program runs as one vectorized gather (pack) or scatter
(unpack) over the datatype's byte-index array.  A numpy buffer is
packed on the host, as in the reference.  A torch tensor is packed on
its own device: its bytes are a ``uint8`` view and the index array is
built on that device (:meth:`Datatype.element_index_tensor`), so a pack
is one ``torch.take`` and an unpack one indexed store, and no buffer
byte is copied to the host.  Bounds are checked from one element's
indices on the host, so a device pack makes no host sync.

The partial-pack contract holds: :class:`Convertor` packs and unpacks
with a byte budget and resumes mid-element (``set_position``).

Native leg: a one-shot :func:`pack`/:func:`unpack` of a numpy buffer
(the C ABI's case) runs the committed iovec program in the C++ kernels
of ``csrc/convertor.cc`` (``libtpuconvertor.so``, built on first use by
:func:`ompi_tpu_torch.native.load_convertor`) while the MCA var
``ddt_convertor_native`` is on (the default); the numpy path stays for
partial pack streams, tensors, and a machine without a C++ compiler.
"""

from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch.core.errors import MPIArgError, MPITruncateError

from .datatype import Datatype, numpy_dtype


def _as_byte_view(buf):
    """A buffer as a flat ``uint8`` view of its bytes, without copying:
    a numpy array (host) or a tensor (on its device)."""
    if isinstance(buf, torch.Tensor):
        if not buf.is_contiguous():
            raise MPIArgError(
                "buffer must be contiguous at the byte level; use derived "
                "datatypes to describe strided layouts")
        flat = buf.detach().reshape(-1)
        return flat if flat.dtype == torch.uint8 else flat.view(torch.uint8)
    if isinstance(buf, np.ndarray):
        if not buf.flags.c_contiguous:
            raise MPIArgError(
                "buffer must be C-contiguous at the byte level; use derived "
                "datatypes to describe strided layouts")
        return buf.view(np.uint8).reshape(-1)
    return np.frombuffer(buf, dtype=np.uint8)


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """Host bytes as a CPU tensor (a read-only array is copied first:
    torch has no read-only tensors)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _nbytes(view) -> int:
    return view.numel() if isinstance(view, torch.Tensor) else view.size


class Convertor:
    """One pack or unpack stream over (buffer, datatype, count).

    Position is measured in PACKED bytes (0 .. packed_size), as in the
    reference.  ``origin`` is the byte offset of the MPI buffer pointer
    inside the buffer: types with a negative lb or displacement address
    bytes before it, so pass ``origin >= -true_lb`` for them."""

    def __init__(self, buffer, datatype: Datatype, count: int, origin: int = 0):
        if count < 0:
            raise MPIArgError("negative count")
        self.datatype = datatype
        self.count = count
        self.buf = _as_byte_view(buffer)
        self.on_device = isinstance(self.buf, torch.Tensor)
        if self.on_device:
            idx = datatype.element_index_tensor(count, self.buf.device)
            lo, hi = datatype.index_bounds(count)
            self.packed_size = int(idx.numel())
        else:
            idx = datatype.element_index_array(count)
            self.packed_size = int(idx.size)
            lo = int(idx.min()) if idx.size else 0
            hi = int(idx.max()) + 1 if idx.size else 0
        self.indices = idx + origin if origin else idx
        lo, hi = lo + origin, hi + origin
        if count and self.packed_size:
            if lo < 0:
                raise MPIArgError(
                    f"datatype addresses byte {lo} before the buffer start; "
                    f"pass origin >= {origin - lo} for negative-lb types")
            if hi > _nbytes(self.buf):
                raise MPITruncateError(
                    f"buffer too small: {_nbytes(self.buf)} bytes < {hi} required "
                    f"for {count} x {datatype.name or 'datatype'}")
        self.position = 0

    def set_position(self, position: int) -> None:
        if not 0 <= position <= self.packed_size:
            raise MPIArgError(f"position {position} outside [0, {self.packed_size}]")
        self.position = position

    @property
    def done(self) -> bool:
        return self.position >= self.packed_size

    def pack(self, max_bytes: int | None = None):
        """The next <= max_bytes packed bytes (``uint8``, on the buffer's
        side: numpy for a host buffer, a tensor on its device)."""
        remaining = self.packed_size - self.position
        n = remaining if max_bytes is None else min(max_bytes, remaining)
        if n <= 0:
            if self.on_device:
                return torch.empty(0, dtype=torch.uint8, device=self.buf.device)
            return np.empty(0, np.uint8)
        sel = self.indices[self.position: self.position + n]
        out = torch.take(self.buf, sel) if self.on_device else self.buf[sel]
        self.position += n
        return out

    def unpack(self, data) -> int:
        """Consume packed bytes into the buffer; returns bytes consumed."""
        src = _as_byte_view(data)
        size = _nbytes(src)
        n = min(size, self.packed_size - self.position)
        if n < size:
            raise MPITruncateError(f"unpack overflow: got {size} bytes, room for {n}")
        if n == 0:
            return 0
        sel = self.indices[self.position: self.position + n]
        if self.on_device:
            if not isinstance(src, torch.Tensor):
                src = _host_tensor(src)
            self.buf[sel] = src[:n].to(self.buf.device)
        else:
            if isinstance(src, torch.Tensor):
                src = src.cpu().numpy()
            self.buf[sel] = src[:n]
        self.position += n
        return n


# -- native leg: the C++ pack/unpack kernels over numpy buffers --------

_native_var_cache: tuple[int, object] | None = None


def _native_enabled() -> bool:
    # hot path: cache the registered Var per store (register() walks the
    # dedup table); re-fetch only if the MCA context was reset
    global _native_var_cache
    from ompi_tpu_torch.core import mca

    store = mca.default_context().store
    if _native_var_cache is None or _native_var_cache[0] != id(store):
        var = store.register(
            "ddt", None, "convertor_native", True,
            help="use the libtpuconvertor C++ pack/unpack kernels "
                 "for host buffers when available")
        _native_var_cache = (id(store), var)
    return bool(_native_var_cache[1].value)


def _native_bounds_check(dt: Datatype, count: int, origin: int, bufsize: int):
    """The iovec program for the native kernels as (offsets, lengths,
    packed bytes), bounds-checked with the numpy path's errors."""
    iov = dt.iovec()
    offs = np.array([o for o, _ in iov], np.int64)
    lens = np.array([n for _, n in iov], np.int64)
    lo_e = int(offs.min())
    hi_e = int((offs + lens).max())
    if dt.extent >= 0:
        lo, hi = lo_e, hi_e + (count - 1) * dt.extent
    else:
        lo, hi = lo_e + (count - 1) * dt.extent, hi_e
    if origin + lo < 0:
        raise MPIArgError(
            f"datatype addresses byte {origin + lo} before the buffer "
            f"start; pass origin >= {-lo} for negative-lb types")
    if origin + hi > bufsize:
        raise MPITruncateError(
            f"buffer too small: {bufsize} bytes < {origin + hi} required "
            f"for {count} x {dt.name or 'datatype'}")
    return offs, lens, count * int(lens.sum())


def _native_call(fn, buf: np.ndarray, other: np.ndarray, dt: Datatype,
                 count: int, origin: int, offs, lens) -> None:
    import ctypes

    I64P = ctypes.POINTER(ctypes.c_int64)
    fn(buf.ctypes.data + origin, other.ctypes.data,
       offs.ctypes.data_as(I64P), lens.ctypes.data_as(I64P),
       len(offs), count, dt.extent)


def _native_pack(buf: np.ndarray, dt: Datatype, count: int, origin: int):
    """The packed bytes from the C++ kernel, or None when the library
    is unavailable or the type is zero-size."""
    from ompi_tpu_torch import native

    lib = native.load_convertor()
    if lib is None or not dt.iovec():
        return None
    offs, lens, nbytes = _native_bounds_check(dt, count, origin, buf.size)
    out = np.empty(nbytes, np.uint8)
    _native_call(lib.tpuconv_pack, buf, out, dt, count, origin, offs, lens)
    return out


def _native_unpack(buf: np.ndarray, dt: Datatype, count: int, data,
                   origin: int) -> bool:
    """Unpack through the C++ kernel; False when it cannot serve (no
    library, zero-size type, read-only buffer: the numpy path then
    raises the caller's error)."""
    from ompi_tpu_torch import native

    lib = native.load_convertor()
    if lib is None or not dt.iovec() or not buf.flags.writeable:
        return False
    src = _as_byte_view(data)
    if isinstance(src, torch.Tensor):
        src = src.cpu().numpy()
    offs, lens, nbytes = _native_bounds_check(dt, count, origin, buf.size)
    if src.size != nbytes:
        raise MPITruncateError(f"expected {nbytes} packed bytes, got {src.size}")
    src = np.ascontiguousarray(src)
    _native_call(lib.tpuconv_unpack, buf, src, dt, count, origin, offs, lens)
    return True


def pack(buffer, datatype: Datatype, count: int, origin: int = 0):
    """One-shot full pack → contiguous ``uint8`` bytes (numpy for a
    numpy buffer, a tensor on the tensor's device).  A contiguous
    datatype short-circuits to a slice view, bounds-checked alike."""
    if datatype.is_contiguous and datatype.lb + origin >= 0:
        buf = _as_byte_view(buffer)
        start = datatype.lb + origin
        end = start + count * datatype.extent
        if end > _nbytes(buf):
            raise MPITruncateError(
                f"buffer too small: {_nbytes(buf)} bytes < {end} required "
                f"for {count} x {datatype.name or 'datatype'}")
        return buf[start:end]
    if isinstance(buffer, np.ndarray) and count and _native_enabled():
        out = _native_pack(_as_byte_view(buffer), datatype, count, origin)
        if out is not None:
            return out
    return Convertor(buffer, datatype, count, origin).pack()


def unpack(buffer, datatype: Datatype, count: int, data, origin: int = 0) -> None:
    """One-shot full unpack of ``data`` into ``buffer``."""
    if datatype.is_contiguous and datatype.lb + origin >= 0:
        buf = _as_byte_view(buffer)
        src = _as_byte_view(data)
        start = datatype.lb + origin
        size = _nbytes(src)
        if size != count * datatype.extent:
            raise MPITruncateError(
                f"expected {count * datatype.extent} packed bytes, got {size}")
        if start + size > _nbytes(buf):
            raise MPITruncateError(
                f"buffer too small: {_nbytes(buf)} bytes < {start + size} required")
        if isinstance(buf, torch.Tensor):
            if not isinstance(src, torch.Tensor):
                src = _host_tensor(src)
            buf[start: start + size].copy_(src)
        else:
            buf[start: start + size] = src.cpu().numpy() if isinstance(
                src, torch.Tensor) else src
        return
    if isinstance(buffer, np.ndarray) and count and _native_enabled():
        if _native_unpack(_as_byte_view(buffer), datatype, count, data, origin):
            return
    c = Convertor(buffer, datatype, count, origin)
    c.unpack(data)
    if not c.done:
        raise MPITruncateError(f"short unpack: {c.position}/{c.packed_size} bytes")


def packed_to_typed(packed, datatype: Datatype, count: int):
    """The packed bytes viewed as the datatype's uniform leaf dtype (the
    bridge from wire format to the reduction kernels)."""
    if datatype.uniform_leaf is None:
        raise MPIArgError(f"datatype {datatype.name} has mixed leaves; cannot view typed")
    if isinstance(packed, torch.Tensor):
        return packed.view(datatype.uniform_leaf)
    return packed.view(numpy_dtype(datatype.uniform_leaf))


def typed_to_packed(arr):
    if isinstance(arr, torch.Tensor):
        return _as_byte_view(arr.contiguous())
    return np.ascontiguousarray(arr).view(np.uint8).reshape(-1)

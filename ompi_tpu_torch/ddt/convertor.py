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

The reference's native C leg (its ``ddt_convertor_native`` var) is not
ported: it waits for the port's own native build.
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

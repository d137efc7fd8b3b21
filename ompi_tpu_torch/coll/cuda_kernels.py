"""Ring-hop kernels and the ring schedules that drive them.

Port of ``ompi_tpu/coll/pallas_kernels.py``.  The reference's one TPU
kernel, ``_remote_hop_kernel`` (an HBM→HBM async remote copy between
neighbouring devices, launched by ``_dma_hop``), and its interpret-mode
body ``_copy_kernel`` become two hand-written CUDA kernels for Hopper in
``ompi_tpu_torch/csrc/ring_hop.cu``:

* :func:`ring_hop` — ``dst[(r+1)%n, dst_idx[(r+1)%n]] = src[r, src_idx[r]]``
  for every rank r in one launch: the hop, over virtual ranks that are
  the rows of one rank-major tensor;
* :func:`ring_hop_fold` — the hop fused with the schedules' fold,
  ``d[r, d_idx[r]] = op(a[r, a_idx[r]], b[(r-1)%n, b_idx[(r-1)%n]])``
  (operands swapped with ``recv_first``), for SUM/PROD/MAX/MIN over
  f32, f64, f16, bf16, i32, i64, u32 and u64.  Other ops and dtypes,
  user ops from ``create_op`` included, run :func:`ring_hop` and then
  the op's ``torch_fn``: the hop is still the kernel.

Each wrapper has a plain torch twin in this module
(:func:`ring_hop_plain`, :func:`ring_hop_fold_plain`), a launch counter
(:data:`LAUNCHES`), and takes the plain twin only because its tensors
lie on the CPU; for CUDA tensors it launches the kernel or raises.

Rungs, as the reference's ``mode()``:

* **cuda** — a CUDA tensor: the kernels (an sm_90 card is required);
* **interpret** — ``--mca dcn_device_interpret 1``: the same kernel-form
  schedule with the kernels' plain torch bodies, on any device;
* **emulate** — a CPU tensor: ``coll.base``'s row-permutation rings,
  which have the reference's exact schedule shape.

The schedules keep ``_pad_chunks``/``_unpad`` and the chunk rotation of
the reference exactly, so MPI_SUM results are bit-identical to
``coll.base``'s rings.  In the kernel form, each allgather step of
:func:`ring_allreduce` and :func:`ring_allgather` is one in-place
:func:`ring_hop` launch, and each reduce-scatter step one
:func:`ring_hop_fold` launch (in place for the allreduce, double
buffered for :func:`ring_reduce_scatter`, whose next input is the
neighbour's current partial).

On the mesh's ``devices`` layout every rank owns a buffer of its own
(:class:`~ompi_tpu_torch.mesh.shards.RankShards`), and the reference's
``_remote_hop_kernel`` is ported as it runs on its chip, in
``ompi_tpu_torch/csrc/ring_hop_peer.cu``:

* :func:`ring_hop_peer` — rank r's chunk is pushed into the buffer that
  rank (r+1)%n owns, through that buffer's pointer (a peer pointer when
  the two ranks are on different cards), and device-side semaphores
  order it.  A hop is three launches per card (:func:`_peer_plan`): a
  ``ring_hop_wait`` launch for the receivers' credit on their
  double-buffered landing zones, one batched put of every sender on the
  card (counted as ``ring_hop_peer``), and a ``ring_hop_wait`` launch
  for the arrivals of the card's receivers (:class:`PeerRing`, one per
  mesh, holds the counters);
* :func:`ring_allreduce_shards`, :func:`ring_allgather_shards` and
  :func:`ring_reduce_scatter_shards` — the reference's three schedules
  line for line over shards: ``_pad_chunks`` per rank, the same
  ``send_idx``/``recv_idx`` rotation, and the fold after a landed chunk
  as the op's ``torch_fn`` (XLA's op in the reference, not Pallas).

:func:`ring_hop_peer_plain` is its plain twin, taken for CPU shards and
under ``dcn_device_interpret``; for CUDA shards the wrapper launches or
raises.

The libraries are compiled with ``nvcc`` at first use into
``build/ompi_tpu_torch/`` at the repository root and loaded with
``ctypes`` (a plain C interface; no PyTorch headers).
"""

from __future__ import annotations

import ctypes
import functools
import threading
import weakref
from pathlib import Path
from typing import NamedTuple, Sequence

import torch

from ompi_tpu_torch.core.errors import MPIArgError, MPIInternalError
from ompi_tpu_torch.ddt.datatype import SIGNED_TWIN
from ompi_tpu_torch.op.op import MAX, MIN, PROD, SUM, Op, on_carrier

from . import base

__all__ = [
    "mode", "kernel_available", "build", "LAUNCHES", "reset_launches",
    "ring_hop", "ring_hop_plain", "ring_hop_fold", "ring_hop_fold_plain",
    "fold_supported", "ring_allreduce", "ring_allgather", "ring_reduce_scatter",
    "build_peer", "PeerRing", "peer_ring", "PeerWaitTimeout", "ring_hop_peer",
    "ring_hop_peer_plain", "ring_allreduce_shards", "ring_allgather_shards",
    "ring_reduce_scatter_shards",
]

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "ring_hop.cu"
_PEER_SRC = Path(__file__).resolve().parents[1] / "csrc" / "ring_hop_peer.cu"

#: kernel launches per wrapper: each wrapper adds one where it launches
#: its kernel, and nowhere else
LAUNCHES = {"ring_hop": 0, "ring_hop_fold": 0, "ring_hop_peer": 0, "ring_hop_wait": 0}
#: the kernels of the devices layout's rings
PEER_KERNELS = ("ring_hop_peer", "ring_hop_wait")

#: how long a device-side wait of the peer hop spins before it gives up
PEER_WAIT_TIMEOUT_NS = 20_000_000_000
#: entries one put or wait launch of the peer hop takes by value
#: (``kMaxEntries`` in ``ring_hop_peer.cu``)
PEER_MAX_ENTRIES = 16
#: bytes one block of the put moves in one unrolled pass (256 threads x
#: 8 words of 16 bytes): a put gets no more blocks than it has such passes
PEER_BLOCK_BYTES = 256 * 8 * 16
#: body bytes of one tile of ``ring_hop`` and ``ring_hop_fold`` (of each
#: operand): the unit of their grids, one block's pass of 128 threads
#: over 2 words of 16 bytes (``kTile`` in ``ring_hop.cu``)
HOP_TILE_BYTES = 128 * 2 * 16
_U64 = (1 << 64) - 1

_FOLD_DTYPES = {
    torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.bfloat16: 3,
    torch.int32: 4, torch.int64: 5, torch.uint32: 6, torch.uint64: 7,
}
_FOLD_OPS = {SUM: 0, PROD: 1, MAX: 2, MIN: 3}

_lib = None
_peer_lib = None
_lib_lock = threading.Lock()
#: ptxas reports of the last builds (registers, spills per kernel)
build_log = ""
peer_build_log = ""


class KernelUnavailable(MPIInternalError):
    """A kernel launch was asked for where it cannot run."""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_available() -> bool:
    """True when a CUDA card of compute capability 9.0 is present — the
    only target ``sm_90a`` code runs on."""
    return torch.cuda.is_available() and torch.cuda.get_device_capability() == (9, 0)


def _interpret_forced() -> bool:
    from ompi_tpu_torch.core import mca

    return bool(mca.default_context().store.get("dcn_device_interpret", False))


def mode(device: torch.device | str | None = None) -> str:
    """Which rung a schedule on ``device`` runs: ``cuda`` | ``interpret``
    | ``emulate``.  The forced-interpret knob wins on every device."""
    if _interpret_forced():
        return "interpret"
    if device is not None and torch.device(device).type == "cuda":
        return "cuda"
    return "emulate"


def fold_supported(op: Op, dtype: torch.dtype) -> bool:
    """Whether :func:`ring_hop_fold` has a kernel for (op, dtype)."""
    return op in _FOLD_OPS and dtype in _FOLD_DTYPES


# -- build and load -------------------------------------------------------


def build() -> Path:
    """Compile ``csrc/ring_hop.cu`` (once per source content) and return
    the shared library's path."""
    global build_log
    from ompi_tpu_torch import native

    try:
        out, log = native.build_cuda(_SRC)
    except native.NativeBuildError as e:
        raise KernelUnavailable(str(e)) from e
    build_log = log or build_log
    return out


def bind(path: Path) -> ctypes.CDLL:
    """Load a library built from ``csrc/ring_hop.cu`` (this tree's, or
    another tree's for a comparison) and declare its two entry points."""
    lib = ctypes.CDLL(str(path))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ompi_ring_hop.argtypes = [p, p, p, p, ll, ll, ll, ll, p]
    lib.ompi_ring_hop.restype = i
    lib.ompi_ring_hop_fold.argtypes = [p, p, p, p, p, p, ll, ll, ll, ll,
                                       ll, i, i, i, p]
    lib.ompi_ring_hop_fold.restype = i
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(build())
        return _lib


def build_peer() -> Path:
    """Compile ``csrc/ring_hop_peer.cu`` (once per source content) and
    return the shared library's path."""
    global peer_build_log
    from ompi_tpu_torch import native

    try:
        out, log = native.build_cuda(_PEER_SRC)
    except native.NativeBuildError as e:
        raise KernelUnavailable(str(e)) from e
    peer_build_log = log or peer_build_log
    return out


def _load_peer():
    global _peer_lib
    with _lib_lock:
        if _peer_lib is None:
            lib = ctypes.CDLL(str(build_peer()))
            p, ll, ull, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_int
            lib.ompi_peer_put.argtypes = [i, ctypes.POINTER(ll), i, ll, p]
            lib.ompi_peer_put.restype = i
            lib.ompi_peer_wait.argtypes = [i, ctypes.POINTER(ull), i, ll, p]
            lib.ompi_peer_wait.restype = i
            lib.ompi_peer_grid.argtypes = [i, ctypes.POINTER(i)]
            lib.ompi_peer_grid.restype = i
            lib.ompi_peer_page_alloc.argtypes = [i, ull, ctypes.POINTER(p)]
            lib.ompi_peer_page_alloc.restype = i
            lib.ompi_peer_page_free.argtypes = [i, p]
            lib.ompi_peer_page_free.restype = i
            lib.ompi_peer_enable.argtypes = [i, i]
            lib.ompi_peer_enable.restype = i
            _peer_lib = lib
        return _peer_lib


def _require_kernel(*ts: torch.Tensor) -> None:
    if any(t.device.type != "cuda" for t in ts):
        raise KernelUnavailable(
            f"kernel launch needs CUDA tensors, got {[str(t.device) for t in ts]}")
    if not kernel_available():
        raise KernelUnavailable("the ring-hop kernels need an sm_90 (Hopper) card")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_rows(name: str, t: torch.Tensor, n: int, m: int | None = None) -> None:
    if t.dim() != 3 or t.shape[0] != n or not t.is_contiguous():
        raise MPIArgError(f"{name}: need a contiguous (n={n}, rows, chunk) "
                          f"tensor, got shape {tuple(t.shape)}")
    if m is not None and t.shape[2] != m:
        raise MPIArgError(f"{name}: chunk length {t.shape[2]} != {m}")


def _check_idx(name: str, idx: torch.Tensor, n: int, device) -> None:
    if idx.dtype != torch.int32 or idx.shape != (n,) or not idx.is_contiguous() \
            or idx.device != device:
        raise MPIArgError(f"{name}: need a contiguous int32 ({n},) index on {device}")


# -- the hop --------------------------------------------------------------


def ring_hop_plain(src: torch.Tensor, src_idx: torch.Tensor,
                   dst: torch.Tensor, dst_idx: torch.Tensor) -> None:
    """Plain torch twin of :func:`ring_hop` (gather, rotate, scatter on
    byte views — dtype-agnostic like the kernel)."""
    n = src.shape[0]
    ar = torch.arange(n, device=src.device)
    moved = src.view(torch.uint8)[ar, src_idx.long()]   # row r's chunk
    recv = moved[(ar - 1) % n]                           # lands on row r+1
    dst.view(torch.uint8)[ar, dst_idx.long()] = recv


def ring_hop(src: torch.Tensor, src_idx: torch.Tensor,
             dst: torch.Tensor, dst_idx: torch.Tensor) -> None:
    """One ring hop for every rank, in place on ``dst``:
    ``dst[(r+1)%n, dst_idx[(r+1)%n]] = src[r, src_idx[r]]``.

    ``src``/``dst``: contiguous ``(n, rows, chunk)`` of one dtype (they
    may be the same tensor); indices: int32 ``(n,)`` on the same device,
    each in ``[0, rows)``."""
    n = src.shape[0]
    _check_rows("ring_hop src", src, n)
    _check_rows("ring_hop dst", dst, n, src.shape[2])
    if src.dtype != dst.dtype or src.device != dst.device:
        raise MPIArgError("ring_hop: src and dst differ in dtype or device")
    _check_idx("src_idx", src_idx, n, src.device)
    _check_idx("dst_idx", dst_idx, n, src.device)
    if src.device.type == "cpu":
        ring_hop_plain(src, src_idx, dst, dst_idx)
        return
    _launch_hop(src, src_idx, dst, dst_idx)


def _launch_hop(src, src_idx, dst, dst_idx) -> None:
    _require_kernel(src, dst, src_idx, dst_idx)
    chunk_bytes = src.shape[2] * src.element_size()
    if chunk_bytes == 0:
        return
    rc = _load().ompi_ring_hop(
        src.data_ptr(), dst.data_ptr(), src_idx.data_ptr(), dst_idx.data_ptr(),
        src.shape[0], src.shape[1], dst.shape[1], chunk_bytes, _stream(src))
    if rc != 0:
        raise KernelUnavailable(f"ring_hop launch failed: cudaError {rc}")
    LAUNCHES["ring_hop"] += 1


# -- the hop fused with the fold -------------------------------------------


def ring_hop_fold_plain(a: torch.Tensor, a_idx: torch.Tensor,
                        b: torch.Tensor, b_idx: torch.Tensor,
                        d: torch.Tensor, d_idx: torch.Tensor,
                        op: Op, recv_first: bool = False) -> None:
    """Plain torch twin of :func:`ring_hop_fold`."""
    twin = SIGNED_TWIN.get(a.dtype)
    if twin is not None:  # torch's CPU indexing lacks the unsigned dtypes
        op = on_carrier(op, a.dtype)
        a, b, d = a.view(twin), b.view(twin), d.view(twin)
    n = a.shape[0]
    ar = torch.arange(n, device=a.device)
    left = (ar - 1) % n
    mine = a[ar, a_idx.long()]
    recv = b[left, b_idx.long()[left]]
    d[ar, d_idx.long()] = (op.torch_fn(recv, mine) if recv_first
                           else op.torch_fn(mine, recv))


def ring_hop_fold(a: torch.Tensor, a_idx: torch.Tensor,
                  b: torch.Tensor, b_idx: torch.Tensor,
                  d: torch.Tensor, d_idx: torch.Tensor,
                  op: Op, recv_first: bool = False) -> None:
    """The hop fused with the fold, for every rank r, in place on ``d``:
    ``d[r, d_idx[r]] = op(a[r, a_idx[r]], b[l, b_idx[l]])`` with
    ``l = (r-1)%n`` — ``op(recv, mine)`` when ``recv_first``.

    All three are contiguous ``(n, rows, chunk)`` tensors of one dtype
    and chunk length (they may alias, as the ring schedules arrange);
    (op, dtype) must satisfy :func:`fold_supported`."""
    n = a.shape[0]
    m = a.shape[2]
    for name, t in (("a", a), ("b", b), ("d", d)):
        _check_rows(f"ring_hop_fold {name}", t, n, m)
        if t.dtype != a.dtype or t.device != a.device:
            raise MPIArgError("ring_hop_fold: operands differ in dtype or device")
    for name, t in (("a_idx", a_idx), ("b_idx", b_idx), ("d_idx", d_idx)):
        _check_idx(name, t, n, a.device)
    if not fold_supported(op, a.dtype):
        raise MPIArgError(f"ring_hop_fold has no kernel for {op.name} on {a.dtype}")
    if a.device.type == "cpu":
        ring_hop_fold_plain(a, a_idx, b, b_idx, d, d_idx, op, recv_first)
        return
    _launch_fold(a, a_idx, b, b_idx, d, d_idx, op, recv_first)


def _launch_fold(a, a_idx, b, b_idx, d, d_idx, op, recv_first) -> None:
    _require_kernel(a, b, d, a_idx, b_idx, d_idx)
    if a.shape[2] == 0:
        return
    rc = _load().ompi_ring_hop_fold(
        a.data_ptr(), b.data_ptr(), d.data_ptr(),
        a_idx.data_ptr(), b_idx.data_ptr(), d_idx.data_ptr(),
        a.shape[0], a.shape[1], b.shape[1], d.shape[1], a.shape[2],
        _FOLD_DTYPES[a.dtype], _FOLD_OPS[op], int(bool(recv_first)), _stream(a))
    if rc != 0:
        raise KernelUnavailable(f"ring_hop_fold launch failed: cudaError {rc}")
    LAUNCHES["ring_hop_fold"] += 1


# -- ring schedules (chunk rotation identical to coll.base's rings) ------

#: (n, device) → (n+1, n) int32: row o is (r + o) % n, row n is zeros
_INDEX_TABLES: dict[tuple, torch.Tensor] = {}


def _index_table(n: int, device: torch.device) -> torch.Tensor:
    key = (n, device)
    t = _INDEX_TABLES.get(key)
    if t is None:
        ar = torch.arange(n)
        t = torch.cat([(ar[None, :] + ar[:, None]) % n,
                       torch.zeros(1, n, dtype=torch.int64)]).to(torch.int32)
        t = t.to(device)
        if len(_INDEX_TABLES) > 64:
            _INDEX_TABLES.clear()
        _INDEX_TABLES[key] = t
    return t


def _pad_chunks(x: torch.Tensor):
    """Flatten each rank's block and zero-pad it so it splits into n
    equal chunks — the chunking of coll.base's ring.  Returns a fresh
    contiguous (n, n, chunk) tensor and the unpadded size."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    size = flat.shape[1]
    pad = (-size) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros((n, pad))], 1)
    else:
        flat = flat.clone()
    return flat.reshape(n, n, -1), size


def _unpad(chunks: torch.Tensor, size: int, shape) -> torch.Tensor:
    n = chunks.shape[0]
    return chunks.reshape(n, -1)[:, :size].reshape(shape)


def _kernels(m: str):
    if m == "cuda":
        return ring_hop, ring_hop_fold
    return ring_hop_plain, ring_hop_fold_plain


def _fold_after_hop(hop, src, src_idx, acc, acc_idx, own, own_idx, op,
                    recv_first, zero):
    """The unfused step for ops or dtypes the fold kernel lacks: the hop
    kernel moves the neighbour's chunk, then ``op.torch_fn`` folds it."""
    n, m = src.shape[0], src.shape[2]
    recv = src.new_empty((n, 1, m))
    hop(src, src_idx, recv, zero)
    twin = SIGNED_TWIN.get(src.dtype)
    if twin is not None:
        op = on_carrier(op, src.dtype)
        recv, acc, own = recv.view(twin), acc.view(twin), own.view(twin)
    ar = torch.arange(n, device=src.device)
    mine = own[ar, own_idx.long()]
    acc[ar, acc_idx.long()] = (op.torch_fn(recv[:, 0], mine) if recv_first
                               else op.torch_fn(mine, recv[:, 0]))


def ring_allreduce(x: torch.Tensor, op: Op, _mode: str | None = None) -> torch.Tensor:
    """Ring reduce-scatter + ring allgather over the hop kernels:
    (n-1) :func:`ring_hop_fold` and (n-1) :func:`ring_hop` launches.
    Chunk rotation and fold bracketing mirror ``coll.base.allreduce_ring``
    (bit-exact MPI_SUM against it); commutative ops only."""
    n = x.shape[0]
    if n == 1:
        return x.clone()
    m = _mode or mode(x.device)
    if m == "emulate":
        return base.allreduce_ring(x, op)
    hop, fold = _kernels(m)
    chunks, size = _pad_chunks(x)
    tbl = _index_table(n, x.device)
    fused = fold_supported(op, x.dtype)
    # reduce-scatter: at step s rank r folds its left neighbour's chunk
    # (r - s - 1) into its own chunk (r - s - 1): op(mine, recv)
    for s in range(n - 1):
        ri = tbl[(-s - 1) % n]
        sent = tbl[(-s) % n]  # rank r' sends chunk (r' - s)
        if fused:
            fold(chunks, ri, chunks, sent, chunks, ri, op, False)
        else:
            _fold_after_hop(hop, chunks, sent, chunks, ri, chunks, ri, op,
                            False, tbl[n])
    # allgather: rank r owns chunk (r + 1); at step s it forwards the
    # chunk (r - s + 1) it holds newest into its neighbour's slot
    for s in range(n - 1):
        hop(chunks, tbl[(1 - s) % n], chunks, tbl[(-s) % n])
    return _unpad(chunks, size, x.shape)


def ring_allgather(x: torch.Tensor, _mode: str | None = None) -> torch.Tensor:
    """(n, …) per-rank blocks → (n, n, …) gathered rows: n-1 in-place
    :func:`ring_hop` launches, each forwarding the newest block
    (``coll.base.allgather_ring``'s schedule)."""
    n = x.shape[0]
    if n == 1:
        return x.unsqueeze(1).clone()
    m = _mode or mode(x.device)
    if m == "emulate":
        return base.allgather_ring(x)
    idx = torch.arange(n, device=x.device)
    out = x.new_empty((n,) + tuple(x.shape))
    outb = out.view(n, n, -1).view(torch.uint8)
    outb[idx, idx] = x.reshape(n, -1).view(torch.uint8)
    hop, _ = _kernels(m)
    tbl = _index_table(n, x.device)
    chunks = out.view(n, n, -1)
    for s in range(n - 1):
        hop(chunks, tbl[(-s) % n], chunks, tbl[(-s - 1) % n])
    return out


def ring_reduce_scatter(x: torch.Tensor, op: Op, _mode: str | None = None) -> torch.Tensor:
    """(n, n, …) contributions → (n, …) reduced rows: the partial for
    block b starts at rank (b+1)%n and accumulates ``op(cur, own)`` while
    travelling to its owner — ``coll.base.reduce_scatter_ring``'s
    schedule and fold bracketing, as n-1 :func:`ring_hop_fold` launches
    into alternating buffers.  Commutative ops only."""
    n = x.shape[0]
    if n == 1:
        return x[:, 0].clone()
    m = _mode or mode(x.device)
    if m == "emulate":
        return base.reduce_scatter_ring(x, op)
    hop, fold = _kernels(m)
    blk = tuple(x.shape[2:])
    xv = x.contiguous().view(n, n, -1)
    tbl = _index_table(n, x.device)
    zero = tbl[n]
    fused = fold_supported(op, x.dtype)
    cur = xv.new_empty((n, 1, xv.shape[2]))
    nxt = torch.empty_like(cur)
    # step s: rank r receives its neighbour's partial and adds its own
    # contribution x[r, r - s - 2]; at s = 0 the neighbour's partial is
    # its own contribution x[r-1, r-2] to block r - 2
    src, src_idx = xv, tbl[(-1) % n]
    for s in range(n - 1):
        own_idx = tbl[(-s - 2) % n]
        if fused:
            fold(xv, own_idx, src, src_idx, nxt, zero, op, True)
        else:
            _fold_after_hop(hop, src, src_idx, nxt, zero, xv, own_idx, op,
                            True, zero)
        cur, nxt = nxt, cur
        src, src_idx = cur, zero
    return cur.reshape((n,) + blk)



# -- the cross-device hop (devices layout) ---------------------------------


class PeerWaitTimeout(MPIInternalError):
    """A device-side wait of the peer hop gave up: a signal never came."""


def _free_pages(lib, pages) -> None:
    for dev, ptr in pages:
        lib.ompi_peer_page_free(dev, ptr)


class PeerRing:
    """The cross-device hop's state for one mesh: per rank a counter page
    (``recv`` at byte 0, ``consumed`` at byte 8; cudaMalloc'd once and set
    to ``epoch``), two landing zones, and the host's epoch numbers:
    ``hops`` (hop h of the mesh's life uses zone h % 2) and ``expected``
    (the arrivals each rank's ``recv`` reaches once every put so far has
    landed).  ``epoch`` is where both start (the tests start near 2^64 to
    cross the wrap).  A pinned host flag per rank says whether one of its
    waits timed out.  ``cards`` is each rank's card index and ``grid`` one
    wave of the put kernel's blocks (SMs x resident blocks, the smallest
    of the cards').  On CPU devices it keeps only the zones and ``hops``
    (the hops there are the plain twin's copies)."""

    def __init__(self, devices: Sequence[torch.device], epoch: int = 0):
        self.devices = tuple(torch.device(d) for d in devices)
        kinds = {d.type for d in self.devices}
        if kinds not in ({"cuda"}, {"cpu"}):
            raise MPIArgError(f"a PeerRing is all CPU or all CUDA, got {sorted(kinds)}")
        self.n = len(self.devices)
        self.hops = epoch & _U64
        self.expected = [epoch & _U64] * self.n
        self.broken = False
        self._zones: list[tuple[torch.Tensor, torch.Tensor]] = []
        self._zone_bytes = 0
        self.pages: list[int] = []
        if kinds == {"cpu"}:
            self.timed_out = torch.zeros(self.n, dtype=torch.int64)
            return
        _require_kernel()
        lib = _load_peer()
        self.cards = tuple(d.index for d in self.devices)
        self.card_order = tuple(dict.fromkeys(self.cards))
        for r, c in enumerate(self.cards):
            to = self.cards[(r + 1) % self.n]
            if to != c:  # the sender's card reaches the receiver's
                _check_rc(lib.ompi_peer_enable(c, to), "ompi_peer_enable")
        grids = []
        for c in self.card_order:
            blocks = ctypes.c_int()
            _check_rc(lib.ompi_peer_grid(c, ctypes.byref(blocks)), "ompi_peer_grid")
            grids.append(blocks.value)
        self.grid = min(grids)
        for c in self.cards:
            ptr = ctypes.c_void_p()
            _check_rc(lib.ompi_peer_page_alloc(c, epoch & _U64, ctypes.byref(ptr)),
                      "ompi_peer_page_alloc")
            self.pages.append(ptr.value)
        weakref.finalize(self, _free_pages, lib, list(zip(self.cards, self.pages)))
        self.timed_out = torch.zeros(self.n, dtype=torch.int64, pin_memory=True)

    def landing(self, nbytes: int) -> list[torch.Tensor]:
        """Each rank's landing zone for the next hop (``hops % 2``), as
        ``nbytes`` of uint8 on its device; grows both zones as needed."""
        if nbytes > self._zone_bytes:
            cap = max(nbytes, 2 * self._zone_bytes)
            self._zones = [(torch.empty(cap, dtype=torch.uint8, device=d),
                            torch.empty(cap, dtype=torch.uint8, device=d))
                           for d in self.devices]
            self._zone_bytes = cap
        return [z[self.hops % 2][:nbytes] for z in self._zones]

    def check(self) -> None:
        """Raise if a wait of this ring timed out (reads pinned host
        memory: no synchronise)."""
        if self.broken or bool(self.timed_out.any()):
            self.broken = True
            raise PeerWaitTimeout(
                f"a ring_hop_wait gave up after {PEER_WAIT_TIMEOUT_NS / 1e9:g} s "
                f"(ranks {self.timed_out.nonzero().view(-1).tolist()}): the ring's "
                "results are not valid")


def peer_ring(mesh) -> PeerRing:
    """The mesh's :class:`PeerRing`, made at its first CUDA hop."""
    ring = getattr(mesh, "_peer_ring", None)
    if ring is None:
        ring = PeerRing(mesh.devices)
        mesh._peer_ring = ring
    return ring


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise KernelUnavailable(f"{what} failed: cudaError {rc}")


def _check_peer_args(srcs, src_offsets, dsts, dst_offsets, length) -> None:
    n = len(srcs)
    if n == 0 or len(dsts) != n or len(src_offsets) != n or len(dst_offsets) != n:
        raise MPIArgError("ring_hop_peer: one source, destination and offset per rank")
    kinds = sorted({t.device.type for t in (*srcs, *dsts)})
    if len(kinds) > 1:
        raise MPIArgError(f"ring_hop_peer: buffers mix device kinds {kinds}")
    for name, ts, offs in (("src", srcs, src_offsets), ("dst", dsts, dst_offsets)):
        for r, (t, off) in enumerate(zip(ts, offs)):
            if t.dtype != srcs[0].dtype or not t.is_contiguous():
                raise MPIArgError(f"ring_hop_peer {name}[{r}]: need contiguous "
                                  f"{srcs[0].dtype}, got {t.dtype}")
            if length < 0 or off < 0 or off + length > t.numel():
                raise MPIArgError(f"ring_hop_peer {name}[{r}]: [{off}, {off + length}) "
                                  f"outside {t.numel()} elements")


def ring_hop_peer_plain(srcs: Sequence[torch.Tensor], src_offsets: Sequence[int],
                        dsts: Sequence[torch.Tensor], dst_offsets: Sequence[int],
                        length: int) -> None:
    """Plain torch twin of :func:`ring_hop_peer`: for each rank r,
    ``dsts[(r+1)%n][...].copy_(srcs[r][...])``."""
    n = len(srcs)
    for r in range(n):
        to = (r + 1) % n
        dst = dsts[to].view(-1)[dst_offsets[to]: dst_offsets[to] + length]
        dst.copy_(srcs[r].view(-1)[src_offsets[r]: src_offsets[r] + length])


def ring_hop_peer(srcs: Sequence[torch.Tensor], src_offsets: Sequence[int],
                  dsts: Sequence[torch.Tensor], dst_offsets: Sequence[int],
                  length: int, ring: PeerRing | None = None) -> None:
    """One ring hop over ranks that each own a buffer: ``length`` elements
    of ``srcs[r]`` from element ``src_offsets[r]`` land in
    ``dsts[(r+1)%n]`` from element ``dst_offsets[(r+1)%n]``.

    ``srcs[r]`` lies on rank r's device and ``dsts[r]`` on rank r's too
    (contiguous, one dtype, all CPU or all CUDA).  CPU buffers take the
    plain twin; CUDA buffers launch :func:`_peer_plan`'s three launches
    per card on the card's current stream: every card's credit wait and
    batched put, then every card's arrival wait (``ring`` holds the
    counters).  The hop has landed on each receiver's stream when this
    returns; or it raises."""
    _check_peer_args(srcs, src_offsets, dsts, dst_offsets, length)
    if srcs[0].device.type == "cpu":
        ring_hop_peer_plain(srcs, src_offsets, dsts, dst_offsets, length)
        if ring is not None:
            ring.hops += 1  # the next hop lands in the other zone
        return
    _launch_peer(ring, srcs, src_offsets, dsts, dst_offsets, length)


class PeerPut(NamedTuple):
    """One entry of a put launch: ``sender``'s chunk into ``receiver``'s
    buffer, by ``blocks`` blocks, each adding one to ``receiver``'s
    ``recv`` counter."""
    sender: int
    receiver: int
    blocks: int


class PeerWait(NamedTuple):
    """One lane of a wait launch: store ``post_val`` into the ``consumed``
    counter of rank ``post`` (none when ``post`` is None), then wait until
    the ``counter`` (``"recv"`` or ``"consumed"``) of rank ``rank``
    reaches ``target`` (a signed 64-bit difference); a wait that gives up
    flags rank ``flag``."""
    post: int | None
    post_val: int
    rank: int
    counter: str
    target: int
    flag: int


class PeerLaunch(NamedTuple):
    """One launch of a hop on ``card``'s stream: ``phase`` is ``credit``
    or ``arrival`` (a ``ring_hop_wait`` launch of :class:`PeerWait`
    entries) or ``put`` (a ``ring_hop_peer`` launch of :class:`PeerPut`
    entries)."""
    card: int
    phase: str
    entries: tuple


#: byte offset of each counter in a rank's page
_COUNTER_OFFSET = {"recv": 0, "consumed": 8}


def put_word_bytes(src_addr: int, dst_addr: int, *more_addrs: int) -> int:
    """The word width of a put's body (``ring_hop_put_kernel``'s rule):
    16 when the addresses agree modulo 16, else the widest power of two
    they agree modulo; the head and tail are peeled byte by byte."""
    mis = src_addr ^ dst_addr
    for a in more_addrs:
        mis |= src_addr ^ a
    return next(w for w in (16, 8, 4, 2, 1) if mis % w == 0)


def hop_split(src_addr: int, dst_addr: int, nbytes: int,
              *more_addrs: int) -> tuple[int, int, int]:
    """One rank's ``(head, width, tail)`` in ``ring_hop``,
    ``ring_hop_fold`` and ``ring_hop_put_kernel`` (``split_of`` in
    ``csrc/ring_hop.cu``): the body moves in ``width``-byte words
    (:func:`put_word_bytes` of every end: the fold passes its second
    operand and its destination), after a head of fewer than ``width``
    bytes that brings ``src_addr`` to a multiple of it, and before a tail
    of fewer than ``width`` bytes."""
    w = put_word_bytes(src_addr, dst_addr, *more_addrs)
    head = min(-src_addr % w, nbytes)
    words = (nbytes - head) // w
    return head, w, nbytes - head - words * w


def _peer_plan(cards: Sequence[int], hop: int, expected: Sequence[int], nbytes: int,
               grid: int) -> tuple[list[PeerLaunch], list[int]]:
    """The launches of hop ``hop`` over ranks on ``cards`` (rank r's card
    index), in the order the host enqueues them, and the ``expected``
    arrival targets after it.

    Ranks are grouped by card, at most :data:`PEER_MAX_ENTRIES` a launch.
    For each group, in card order: the credit wait (each sender waits for
    its receiver's ``consumed`` to reach ``hop - 1``: the zone it writes
    was last read before that receiver's arrival wait of ``hop - 1``),
    then the batched put, in which each put (all move ``nbytes``) gets
    one wave of blocks, ``grid``, but at most one block per
    :data:`PEER_BLOCK_BYTES` and at least one; the kernel interleaves the
    puts' blocks, so every wave works on every put.  Then, for every
    group, the arrival wait: each receiver posts ``consumed := hop`` and
    waits for its ``recv`` to reach the blocks of every put into it so
    far.  Every receiver's sender is the rank before it, so each card's
    receivers are its own ranks.  Pure: the CPU tests run it without a
    card."""
    groups = _peer_groups(tuple(cards), nbytes, grid)
    new = list(expected)
    launches = []
    credit_target = (hop - 1) & _U64
    for card, puts in groups:
        for p in puts:
            new[p.receiver] = (new[p.receiver] + p.blocks) & _U64
        launches.append(PeerLaunch(card, "credit", tuple(
            PeerWait(None, 0, p.receiver, "consumed", credit_target, p.sender)
            for p in puts)))
        launches.append(PeerLaunch(card, "put", puts))
    post = hop & _U64
    for card, puts in groups:
        launches.append(PeerLaunch(card, "arrival", tuple(
            PeerWait(p.sender, post, p.sender, "recv", new[p.sender], p.sender)
            for p in puts)))
    return launches, new


@functools.lru_cache(maxsize=256)
def _peer_groups(cards: tuple, nbytes: int, grid: int) -> tuple:
    """The hop-independent part of :func:`_peer_plan`: per launch group,
    its card and its puts (at most :data:`PEER_MAX_ENTRIES`)."""
    n = len(cards)
    blocks = max(1, min(-(-nbytes // PEER_BLOCK_BYTES), grid))
    groups = []
    for card in dict.fromkeys(cards):
        ranks = [r for r in range(n) if cards[r] == card]
        for i in range(0, len(ranks), PEER_MAX_ENTRIES):
            groups.append((card, tuple(PeerPut(r, (r + 1) % n, blocks)
                                       for r in ranks[i:i + PEER_MAX_ENTRIES])))
    return tuple(groups)


def _launch_peer(ring, srcs, src_offsets, dsts, dst_offsets, length) -> None:
    if ring is None:
        _require_kernel(*srcs, *dsts)
        raise MPIArgError("ring_hop_peer: CUDA buffers need the mesh's PeerRing")
    n = ring.n
    if len(srcs) != n:
        raise MPIArgError(f"ring_hop_peer: {len(srcs)} buffers for a ring of {n}")
    if not ring.pages:  # a CUDA ring checked the card when it was built
        raise KernelUnavailable("ring_hop_peer: a CPU ring cannot launch the kernels")
    for r, c in enumerate(ring.cards):
        if srcs[r].get_device() != c or dsts[r].get_device() != c:
            raise MPIArgError(f"ring_hop_peer: rank {r}'s buffers are not on "
                              f"{ring.devices[r]}")
    ring.check()
    lib = _load_peer()
    es = srcs[0].element_size()
    nbytes = length * es
    plan, expected = _peer_plan(ring.cards, ring.hops, ring.expected, nbytes, ring.grid)
    pages, flags = ring.pages, ring.timed_out.data_ptr()
    consumed = _COUNTER_OFFSET["consumed"]
    # every launch's entries first, so the launches go in back to back
    calls = []
    for launch in plan:
        vals = []
        if launch.phase == "put":
            for p in launch.entries:
                vals += (srcs[p.sender].data_ptr() + src_offsets[p.sender] * es,
                         dsts[p.receiver].data_ptr() + dst_offsets[p.receiver] * es,
                         nbytes, pages[p.receiver])
            calls.append((lib.ompi_peer_put, "ring_hop_peer", launch.card,
                          (ctypes.c_longlong * len(vals))(*vals), len(launch.entries),
                          launch.entries[0].blocks))
        else:
            for w in launch.entries:
                vals += (0 if w.post is None else pages[w.post] + consumed, w.post_val,
                         pages[w.rank] + _COUNTER_OFFSET[w.counter], w.target,
                         flags + 8 * w.flag)
            calls.append((lib.ompi_peer_wait, "ring_hop_wait", launch.card,
                          (ctypes.c_ulonglong * len(vals))(*vals), len(launch.entries),
                          PEER_WAIT_TIMEOUT_NS))
    streams = {c: torch.cuda.current_stream(c).cuda_stream for c in ring.card_order}
    ring.broken = True  # until every launch of the hop went in
    for fn, kernel, card, arr, k, arg in calls:
        rc = fn(card, arr, k, arg, streams[card])
        _check_rc(rc, f"{kernel} launch")
        LAUNCHES[kernel] += 1
    ring.expected = expected
    ring.hops += 1
    ring.broken = False


# -- ring schedules over shards (pallas_kernels.py's, per rank) ------------


def _shard_mode(device: torch.device, _mode: str | None) -> str:
    """The rung of a shard schedule: ``cuda`` (the kernel form: the
    ring's landing zones and :func:`ring_hop_peer`, whose CUDA buffers
    launch the peer kernels) for CUDA shards, else ``plain`` (fresh
    landing buffers and the plain twin: CPU shards, or any shards under
    ``dcn_device_interpret``)."""
    if _mode is not None:
        return _mode
    if _interpret_forced() or device.type != "cuda":
        return "plain"
    return "cuda"


def _shard_hop(ring, m: str, srcs, offsets, length: int, dtype) -> list[torch.Tensor]:
    """One hop of ``length`` elements from ``srcs[r]`` at ``offsets[r]``:
    returns rank r's 1-D landed chunk (its left neighbour's), on rank r's
    device — a landing zone of ``ring`` in the kernel form."""
    n = len(srcs)
    if m == "cuda":
        if ring is None:
            raise MPIArgError("the kernel form of a shard ring needs the mesh's PeerRing")
        land = [z.view(dtype) for z in ring.landing(length * srcs[0].element_size())]
        ring_hop_peer(srcs, offsets, land, [0] * n, length, ring)
        return land
    land = [torch.empty(length, dtype=dtype, device=s.device) for s in srcs]
    ring_hop_peer_plain(srcs, offsets, land, [0] * n, length)
    return land


def _pad_chunks_1(x: torch.Tensor, n: int):
    """The reference's ``_pad_chunks`` on one rank's block: flatten, zero
    pad to a multiple of n, a fresh contiguous (n, chunk) tensor."""
    flat = x.reshape(-1)
    size = flat.shape[0]
    pad = (-size) % n
    flat = torch.cat([flat, flat.new_zeros((pad,))]) if pad else flat.clone()
    return flat.reshape(n, -1), size


def _shard_list(xs) -> list[torch.Tensor]:
    return [x.contiguous() for x in getattr(xs, "shards", xs)]


def ring_allreduce_shards(xs, op: Op, ring: PeerRing | None = None,
                          _mode: str | None = None) -> list[torch.Tensor]:
    """``pallas_kernels.ring_allreduce`` over shards: ring reduce-scatter
    (fold ``op(mine, recv)``) then ring allgather, 2(n-1) hops.  Returns
    rank r's result on rank r's device; commutative ops only."""
    xs = _shard_list(xs)
    n = len(xs)
    if n == 1:
        return [xs[0].clone()]
    m = _shard_mode(xs[0].device, _mode)
    padded = [_pad_chunks_1(x, n) for x in xs]
    chunks = [c for c, _ in padded]
    size, c = padded[0][1], chunks[0].shape[1]
    flat = [ch.view(-1) for ch in chunks]
    # reduce-scatter: at step s rank r sends chunk (r - s) right and folds
    # the left neighbour's arrival into chunk (r - s - 1)
    for s in range(n - 1):
        send_idx = [(r - s) % n for r in range(n)]
        recv = _shard_hop(ring, m, flat, [i * c for i in send_idx], c, xs[0].dtype)
        for r in range(n):
            mine = chunks[r][(r - s - 1) % n]
            mine.copy_(op.torch_fn(mine, recv[r]))
    # allgather: rotate the owned fully-reduced chunk around the ring
    srcs, offs = flat, [((r + 1) % n) * c for r in range(n)]
    for s in range(n - 1):
        cur = _shard_hop(ring, m, srcs, offs, c, xs[0].dtype)
        for r in range(n):
            chunks[r][(r - s) % n].copy_(cur[r])
        srcs, offs = cur, [0] * n
    return [ch.reshape(-1)[:size].reshape(x.shape) for ch, x in zip(chunks, xs)]


def ring_allgather_shards(xs, ring: PeerRing | None = None,
                          _mode: str | None = None) -> list[torch.Tensor]:
    """``pallas_kernels.ring_allgather`` over shards: rank r's ``(…)``
    block → its ``(n, …)`` gathered rows, n-1 hops each forwarding the
    newest block."""
    xs = _shard_list(xs)
    n = len(xs)
    if n == 1:
        return [xs[0][None].clone()]
    m = _shard_mode(xs[0].device, _mode)
    outs = []
    for r, x in enumerate(xs):
        out = x.new_zeros((n,) + tuple(x.shape))
        out[r].copy_(x)
        outs.append(out)
    cur = [x.view(-1) for x in xs]
    for s in range(n - 1):
        cur = _shard_hop(ring, m, cur, [0] * n, cur[0].numel(), xs[0].dtype)
        for r in range(n):
            outs[r][(r - s - 1) % n].view(-1).copy_(cur[r])
    return outs


def ring_reduce_scatter_shards(xs, op: Op, ring: PeerRing | None = None,
                               _mode: str | None = None) -> list[torch.Tensor]:
    """``pallas_kernels.ring_reduce_scatter`` over shards: rank r's
    ``(n, …)`` contributions → its reduced ``(…)`` block.  The partial for
    block b starts at rank (b+1)%n and folds ``op(recv, own)`` (the
    received partial first) on its way to its owner.  Commutative ops
    only."""
    xs = _shard_list(xs)
    n = len(xs)
    if n == 1:
        return [xs[0][0].clone()]
    m = _shard_mode(xs[0].device, _mode)
    blk = tuple(xs[0].shape[1:])
    k = xs[0][0].numel()
    own = [x.view(n, -1) for x in xs]
    srcs, offs = [x.view(-1) for x in xs], [((r - 1) % n) * k for r in range(n)]
    for s in range(n - 1):
        recv = _shard_hop(ring, m, srcs, offs, k, xs[0].dtype)
        # received: the partial for block b = r - s - 2; add our own
        srcs = [op.torch_fn(recv[r], own[r][(r - s - 2) % n]) for r in range(n)]
        offs = [0] * n
    return [cur.reshape(blk) for cur in srcs]

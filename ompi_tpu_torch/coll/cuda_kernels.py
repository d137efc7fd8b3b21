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

The library is compiled with ``nvcc`` at first use into
``build/ompi_tpu_torch/`` at the repository root and loaded with
``ctypes`` (a plain C interface; no PyTorch headers).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ompi_tpu_torch.core.errors import MPIArgError, MPIInternalError
from ompi_tpu_torch.ddt.datatype import SIGNED_TWIN
from ompi_tpu_torch.op.op import MAX, MIN, PROD, SUM, Op, on_carrier

from . import base

__all__ = [
    "mode", "kernel_available", "build", "LAUNCHES", "reset_launches",
    "ring_hop", "ring_hop_plain", "ring_hop_fold", "ring_hop_fold_plain",
    "fold_supported", "ring_allreduce", "ring_allgather", "ring_reduce_scatter",
]

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "ring_hop.cu"

#: kernel launches per wrapper: each wrapper adds one where it launches
#: its kernel, and nowhere else
LAUNCHES = {"ring_hop": 0, "ring_hop_fold": 0}

_FOLD_DTYPES = {
    torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.bfloat16: 3,
    torch.int32: 4, torch.int64: 5, torch.uint32: 6, torch.uint64: 7,
}
_FOLD_OPS = {SUM: 0, PROD: 1, MAX: 2, MIN: 3}

_lib = None
_lib_lock = threading.Lock()
#: ptxas report of the last build (registers, spills per kernel)
build_log = ""


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


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.ompi_ring_hop.argtypes = [p, p, p, p, ll, ll, ll, ll, p]
            lib.ompi_ring_hop.restype = i
            lib.ompi_ring_hop_fold.argtypes = [p, p, p, p, p, p, ll, ll, ll, ll,
                                               ll, i, i, i, p]
            lib.ompi_ring_hop_fold.restype = i
            _lib = lib
        return _lib


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


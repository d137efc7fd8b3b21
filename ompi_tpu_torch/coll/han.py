"""``coll/han`` — hierarchical collectives: the card intra-process +
the DCN inter-process.

Port of ``ompi_tpu/coll/han.py`` (≈ the reference's ``coll/han``:
``mca_coll_han_comm_create``, ``mca_coll_han_allreduce_reproducible``):
split the communicator into a low level (this process's virtual ranks,
rows of one rank-major tensor on the card) and an up level (the
processes of the job, over the DCN engine) and compose per-level
collectives.

Tensor in, tensor out, one row across the bus.  The reference turns
every local result into numpy; the port keeps rank-major tensors on
the local comm's device, as :class:`~ompi_tpu_torch.api.comm.Comm`
does, and moves to the host only what the DCN must carry:

* allreduce: local allreduce on the card (``comm.local.allreduce`` —
  tuned → cuda_ring → the ring-hop kernels) → DCN allreduce (the
  process-ordered fold, or the ring above ``btl_tcp_ring_threshold``)
  → ``expand(...).clone()`` fills the K local rows on the card.  When
  the DCN engine's device plane is armed (the default), the DCN leg
  gets ``local[0]`` itself: its chunks ride CUDA IPC windows card to
  card and fold there with the op's torch kernel, so the row never
  crosses host memory.  Otherwise ``local[0]`` goes to the host (one
  D2H that synchronizes) and the result comes back with one H2D;
* bcast: the root process sends the root row (the tensor itself when
  the plane is armed); every process fills its rows from the one row
  it receives;
* allgather / alltoall / gather / scatter: each process sends its
  slice (or the root its per-process blocks);
* reduce / gather return ``None`` off the root's process (MPI: the
  recvbuf is significant only at the root), as in the reference;
* barrier: local barrier + DCN token.

On the ``devices`` layout (one buffer per local rank, on its own card)
the local leg is the devices ``Comm``'s (for allreduce the shard ring
over the peer kernels), the DCN leg carries local rank 0's shard (the
device plane exports its window from that card and lands the received
row there), and every result is ``RankShards`` in and out with shard l
on local rank l's card: one copy of the DCN row onto each card, not an
``expand`` of one tensor.  A root ``gather`` returns one tensor on
root's card; a jagged variant's block for local rank l lands on its
card.

numpy in → numpy out (staged through the card like ``Comm``).
bfloat16 rides the DCN as its raw two-byte words (the transports' host
form of bfloat16, ``dcn.tcp.BF16_HOST``) and is reinterpreted on the
receiving side, which holds the local operand and so knows its dtype;
the host fold of a bfloat16 DCN leg runs the op's torch kernel on the
CPU (numpy has no bfloat16).

The module serves :class:`~ompi_tpu_torch.api.multiproc.MultiProcComm`
communicators (``comm.dcn`` present); ``query`` declines every other
comm, and the component opens only in a process that tpurun launched.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ompi_tpu_torch.core.errors import MPIArgError
from ompi_tpu_torch.core.registry import Component, register_component
from ompi_tpu_torch.dcn.device import host_array as to_host
from ompi_tpu_torch.dcn.tcp import BF16_HOST, BF16_WIRE
from ompi_tpu_torch.ddt.datatype import numpy_dtype
from ompi_tpu_torch.mesh.shards import RankShards
from ompi_tpu_torch.op.op import Op
from ompi_tpu_torch.request import (FutureRequest, PersistentRequest, Request, _tensors,
                                    card_events)

from .module import COLL_OPS, CollModule


def _host_dtype(dtype: torch.dtype) -> np.dtype:
    return BF16_HOST if dtype == torch.bfloat16 else numpy_dtype(dtype)


def to_device(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """A DCN payload back as a ``dtype`` tensor on ``device`` (one H2D
    for a CUDA device).  A two-byte void payload is bfloat16's raw
    words; any other payload must already carry ``dtype``."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if dtype == torch.bfloat16:
        if a.dtype.itemsize != 2:
            raise MPIArgError(f"bfloat16 operand, {a.dtype} payload")
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
        if t.dtype != dtype:
            raise MPIArgError(f"{dtype} operand, {a.dtype} payload")
    return t.to(device)


def host_op(op: Op, dtype: torch.dtype):
    """The op the DCN engine folds with on the host: the op itself
    (its numpy kernel, as in the reference) — or, for bfloat16, which
    numpy cannot fold, the op's torch kernel on the CPU over the raw
    words."""
    if dtype != torch.bfloat16:
        return op

    def words(a):
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)

    def fold(a, b):
        return op.torch_fn(words(a), words(b)).view(torch.int16).numpy().view(BF16_HOST)

    return SimpleNamespace(name=op.name, np_fn=fold, commutative=op.commutative)


def _block_to_host(b):
    return to_host(b) if isinstance(b, torch.Tensor) else np.ascontiguousarray(b)


def _meta(a: np.ndarray) -> dict:
    dt = BF16_WIRE if a.dtype == BF16_HOST else a.dtype.str
    return {"shape": list(a.shape), "dtype": dt}


def _unpack(data: np.ndarray, metas, devices) -> list:
    """Split one uint8 byte stream into its blocks by their envelope
    metadata: numpy arrays, or when ``devices`` is given (one per block)
    tensors, block i on ``devices[i]``."""
    out, off = [], 0
    data = data.view(np.uint8)
    for i, m in enumerate(metas):
        dt = np.dtype(m["dtype"])
        nbytes = dt.itemsize * int(np.prod(m["shape"], dtype=np.int64))
        a = data[off: off + nbytes].view(dt).reshape(m["shape"]).copy()
        off += nbytes
        if devices is not None:
            tdt = torch.bfloat16 if m["dtype"] == BF16_WIRE else torch.from_numpy(a[:0]).dtype
            a = to_device(a, tdt, devices[i])
        out.append(a)
    return out


def _pack(arrs: list[np.ndarray]) -> np.ndarray:
    return (np.concatenate([a.view(np.uint8).reshape(-1) for a in arrs])
            if arrs else np.zeros(0, np.uint8))


class _NbcRequest(FutureRequest):
    """An i-collective's request: the result was produced on a worker
    thread's streams, so ``wait()`` orders the caller's current stream on
    every card the call touched after the event the worker recorded
    there (and marks each result tensor as in use on its card's caller
    stream, for the caching allocator)."""

    def _finalize(self):
        result, done = self._future.result()
        for card, ev in done:
            torch.cuda.current_stream(card).wait_event(ev)
        for t in _tensors(result):
            if t.is_cuda:
                t.record_stream(torch.cuda.current_stream(t.device))
        return result


def _any_tensor(blocks) -> bool:
    """Whether a jagged variant's blocks are tensors (tensors out, else
    numpy out)."""
    return any(isinstance(b, torch.Tensor) for b in (blocks or ()))


def _host_rows(t) -> np.ndarray:
    """A staged rank-major value (one tensor, or ``RankShards``) as one
    host array ``(ln, ...)``: one D2H per card."""
    if isinstance(t, RankShards):
        return np.stack([to_host(s) for s in t.shards])
    return to_host(t)


class HanCollModule(CollModule):
    """Two-level collective module for multi-process communicators."""

    def __init__(self, comm, component: "HanCollComponent"):
        super().__init__(comm)
        self.component = component

    # comm contract: comm.local (intra-process Comm over this process's
    # mesh), comm.local_mesh, comm.dcn (DcnCollEngine), comm.cid,
    # comm.local_size, comm.nprocs, comm.proc, comm.locate, comm.proc_range

    def _stage(self, x):
        """(rank-major value on the local mesh — one tensor, or
        ``RankShards`` on the devices layout — was numpy)."""
        return self.comm.local._stage(x, 1)

    def _unstage(self, t, host: bool):
        return self.comm.local._unstage(t, host)

    def _cid(self, _cid):
        return self.comm.cid if _cid is None else _cid

    def _fill(self, value, dtype: torch.dtype, shape) -> torch.Tensor | RankShards:
        """One value (an array off a host plane, or a tensor off the
        device plane) → every local rank's copy: one tensor ``(ln,
        *shape)`` on the local device, or on the devices layout
        ``RankShards`` with one copy on each rank's card."""
        mesh = self.comm.local_mesh
        src = (value.to(mesh.device) if isinstance(value, torch.Tensor)
               else to_device(value, dtype, mesh.device)).reshape(shape)
        if mesh.layout == "devices":
            return RankShards([torch.empty_like(src, device=d).copy_(src)
                               for d in mesh.devices])
        return src.expand((self.comm.local_size,) + tuple(src.shape)).clone()

    def _place(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor | RankShards:
        """Host rank-major ``a`` (row l: local rank l's) → one tensor on
        the local device, or ``RankShards`` with row l on rank l's card."""
        mesh = self.comm.local_mesh
        if mesh.layout == "devices":
            return RankShards([to_device(a[i], dtype, d) for i, d in enumerate(mesh.devices)])
        return to_device(a, dtype, mesh.device)

    def _rows_on_plane(self, op: Op | None = None) -> bool:
        """Whether the DCN leg takes the row as a tensor: the root
        engine's device plane is armed, and ``op`` (if any) has a torch
        kernel to fold with on the row's device."""
        if getattr(self.comm.dcn._root_engine(), "_device_plane", None) is None:
            return False
        return op is None or (op.torch_fn is not None and not op.is_loc)

    # -- single-rank local comms skip the local op entirely -------------
    # (ln == 1 makes every intra-process collective an identity)

    def _local_allreduce(self, t, op: Op):
        if self.comm.local_size == 1:
            return t
        return self.comm.local.allreduce(t, op)

    def _local_scan(self, t, op: Op):
        if self.comm.local_size == 1:
            return t
        return self.comm.local.scan(t, op)

    def _ordered(self) -> bool:
        """Reproducible mode forces the process-ordered DCN fold even
        for large commutative payloads (ring re-brackets the fold)."""
        st = self.component.store
        return bool(st.get("coll_han_reproducible")) if st is not None else False

    # -- allreduce / reduce ----------------------------------------------

    def allreduce(self, x, op: Op, _cid=None):
        """Two-level fold: local fold on the card (the shard ring on the
        devices layout), then the process-ordered DCN fold of local rank
        0's row.  Deterministic bracketing ((proc0)(proc1)…); pin the
        local order with the forced ordered or plain ring for run-to-run
        bit equality.

        ``_cid``: private DCN stream for a non-blocking instance (every
        i-collective gets its own, so background execution order can't
        desynchronize the blocking stream's seq matching)."""
        comm = self.comm
        t, host = self._stage(x)
        local = self._local_allreduce(t, op)
        if self._rows_on_plane(op):
            row, dcn_op = local[0].contiguous(), op
        else:
            row, dcn_op = to_host(local[0]), host_op(op, t.dtype)
        combined = comm.dcn.allreduce(row, dcn_op, self._cid(_cid),
                                      ordered=self._ordered())
        return self._unstage(self._fill(combined, t.dtype, t.shape[1:]), host)

    def reduce(self, x, op: Op, root: int = 0, _cid=None):
        """Fan-in to the root process: local fold, then each process
        sends ONE partial row to root's process, where the partials
        fold in process order.  The result on root's process only;
        None elsewhere."""
        comm = self.comm
        t, host = self._stage(x)
        root_proc, _ = comm.locate(root)
        partial = to_host(self._local_allreduce(t, op)[0])
        slices = comm.dcn.gather(partial[None], root_proc, self._cid(_cid))
        if slices is None:
            return None
        fold = host_op(op, t.dtype).np_fn
        acc = np.asarray(slices[0][0])
        for p in range(1, comm.nprocs):
            acc = fold(acc, slices[p][0])
        return self._unstage(self._fill(acc, t.dtype, t.shape[1:]), host)

    def _fold_rows(self, x, op: Op, _cid):
        """(ln, global_n, *s) → the host (global_n, *s) fold over every
        rank, the staged input, and whether it was numpy."""
        t, host = self._stage(x)
        local = to_host(self._local_allreduce(t, op)[0])
        red = self.comm.dcn.allreduce(local, host_op(op, t.dtype), self._cid(_cid),
                                      ordered=self._ordered())
        return np.asarray(red), t, host

    def allreduce_rows(self, x, op: Op, _cid=None):
        """(ln, global_n, *s) → the (global_n, *s) fold over every rank:
        a tensor on the local device, or on the devices layout one copy
        per local rank on its card (the reduce_scatter body)."""
        red, t, _ = self._fold_rows(x, op, _cid)
        if self.comm.local_mesh.layout == "devices":
            return self._fill(red, t.dtype, red.shape)
        return to_device(red, t.dtype, self.comm.local_mesh.device)

    def reduce_scatter_block(self, x, op: Op, _cid=None):
        comm = self.comm
        red, t, host = self._fold_rows(x, op, _cid)
        lo = comm.local_offset
        return self._unstage(self._place(red[lo: lo + comm.local_size], t.dtype), host)

    def reduce_scatter(self, x, op: Op, counts=None, _cid=None):
        """Equal counts → block path; jagged counts: every rank
        contributes a flat (sum(counts), *tail) buffer, rank j receives
        its counts[j] reduced segment — this process returns its local
        ranks' segments as a list, each on its rank's device."""
        if counts is None or len(set(counts)) == 1:
            return self.reduce_scatter_block(x, op, _cid=_cid)
        comm = self.comm
        if len(counts) != comm.size:
            raise MPIArgError(
                f"reduce_scatter counts length {len(counts)} != comm "
                f"size {comm.size}")
        red, t, host = self._fold_rows(x, op, _cid)
        offs = np.cumsum([0] + list(counts)).tolist()
        lo = comm.local_offset
        segs = [red[offs[lo + i]: offs[lo + i + 1]] for i in range(comm.local_size)]
        if host:
            return [np.array(s) for s in segs]
        return [to_device(s, t.dtype, d) for s, d in zip(segs, comm.local_mesh.devices)]

    # -- bcast / gathers / scatter / alltoall ---------------------------

    def bcast(self, x, root: int = 0, _cid=None):
        comm = self.comm
        t, host = self._stage(x)
        root_proc, root_local = comm.locate(root)
        if self._rows_on_plane():
            # off the root, t[0] is only the template of the row received
            row = t[root_local if comm.proc == root_proc else 0].contiguous()
        elif comm.proc == root_proc:
            row = to_host(t[root_local])
        else:
            row = np.zeros(t.shape[1:], _host_dtype(t.dtype))
        row = comm.dcn.bcast(row, root_proc, self._cid(_cid))
        return self._unstage(self._fill(row, t.dtype, t.shape[1:]), host)

    def allgather(self, x, _cid=None):
        comm = self.comm
        t, host = self._stage(x)  # (ln, *s): this process's ranks' rows
        slices = comm.dcn.allgather(_host_rows(t), self._cid(_cid))
        full = np.concatenate(slices, axis=0)
        return self._unstage(self._fill(full, t.dtype, full.shape), host)

    def gather(self, x, root: int = 0, _cid=None):
        """Root's recvbuf (global_n, *s) on root's process — on root's
        card on the devices layout: each process sends its slice to root
        once.  None elsewhere."""
        comm = self.comm
        t, host = self._stage(x)
        root_proc, root_local = comm.locate(root)
        slices = comm.dcn.gather(_host_rows(t), root_proc, self._cid(_cid))
        if slices is None:
            return None
        out = to_device(np.concatenate(slices, axis=0), t.dtype,
                        comm.local_mesh.devices[root_local])
        return self._unstage(out, host)

    def scatter(self, x, root: int = 0, _cid=None):
        """Root's (global_n, *s) rows → each process its slice (O(global
        bytes) on the DCN).  ``x`` is meaningful on root's process: numpy,
        a tensor, or on the devices layout ``RankShards`` whose root shard
        holds the rows; the others pass any buffer of the same dtype."""
        comm = self.comm
        root_proc, root_local = comm.locate(root)
        if isinstance(x, RankShards):
            self._stage(x)  # its shards must lie on the local ranks' devices
        host = not isinstance(x, (torch.Tensor, RankShards))
        blocks = None
        if comm.proc == root_proc:
            src = x[root_local] if isinstance(x, RankShards) else x
            blocks = [_block_to_host(src[comm.offsets[p]: comm.offsets[p + 1]])
                      for p in range(comm.nprocs)]
        mine = comm.dcn.scatter(blocks, root_proc, self._cid(_cid))
        if host:
            return np.array(mine)
        return self._place(np.asarray(mine), x.dtype)

    def alltoall(self, x, _cid=None):
        comm = self.comm
        t, host = self._stage(x)  # (ln, global_n, *s): row r → global dest j
        rows = _host_rows(t)
        blocks = [rows[:, slice(*comm.proc_range(p))]
                  for p in range(comm.nprocs)]  # (ln, ln_p, *s) per p
        got = comm.dcn.alltoall(blocks, self._cid(_cid))  # got[p]: (ln_p, ln, *s)
        cols = [np.moveaxis(np.asarray(g), 0, 1) for g in got]
        return self._unstage(self._place(np.concatenate(cols, axis=1), t.dtype), host)

    # -- barrier / scan --------------------------------------------------

    def barrier(self, _cid=None):
        if self.comm.local_size > 1:
            self.comm.local.barrier()
        self.comm.dcn.barrier(self._cid(_cid))

    # scan/exscan: the DCN moves ONE row per process (the rank-ordered
    # fold of its local ranks); the cross-process prefix folds in
    # process order on the host and is applied to the local rows on
    # the card (on each rank's card on the devices layout)

    def _proc_prefix(self, incl, op: Op, cid):
        """The host fold of every earlier process's last inclusive row
        (None on process 0)."""
        comm = self.comm
        hop = host_op(op, incl.dtype)
        sums = comm.dcn.allgather(to_host(incl[-1])[None], cid)
        if comm.proc == 0:
            return None
        acc = np.asarray(sums[0][0])
        for p in range(1, comm.proc):
            acc = hop.np_fn(acc, sums[p][0])
        return acc

    def scan(self, x, op: Op, _cid=None):
        t, host = self._stage(x)
        incl = self._local_scan(t, op)  # (ln, *s)
        acc = self._proc_prefix(incl, op, self._cid(_cid))
        if isinstance(incl, RankShards):
            out = RankShards([
                s.clone() if acc is None
                else op.torch_fn(to_device(acc, s.dtype, s.device).reshape(s.shape), s)
                for s in incl.shards])
        elif acc is None:
            out = incl.clone()
        else:
            a = to_device(acc, incl.dtype, incl.device).reshape(incl.shape[1:])
            out = op.torch_fn(a.expand(incl.shape), incl)
        return self._unstage(out, host)

    def exscan(self, x, op: Op, _cid=None):
        """Local rank l's exclusive prefix: the earlier processes' fold
        (``acc``) folded with local ranks 0..l-1.  Global rank 0's is
        undefined (zeros, matching the single-controller path)."""
        t, host = self._stage(x)
        incl = self._local_scan(t, op)
        acc = self._proc_prefix(incl, op, self._cid(_cid))
        if isinstance(incl, RankShards):
            sh = incl.shards
            first = (torch.zeros_like(sh[0]) if acc is None
                     else to_device(acc, sh[0].dtype, sh[0].device).reshape(sh[0].shape))
            rest = [s if acc is None else op.torch_fn(
                        to_device(acc, s.dtype, s.device).reshape(s.shape), s)
                    for s in sh[:-1]]
            out = RankShards([first] + [torch.empty_like(r, device=d).copy_(r)
                                        for r, d in zip(rest, incl.devices[1:])])
            return self._unstage(out, host)
        out = torch.zeros_like(incl)
        if acc is None:
            if self.comm.local_size > 1:
                out[1:] = incl[:-1]
            return self._unstage(out, host)
        a = to_device(acc, incl.dtype, incl.device).reshape(incl.shape[1:])
        out[0] = a
        if self.comm.local_size > 1:
            out[1:] = op.torch_fn(a.expand(incl[:-1].shape), incl[:-1])
        return self._unstage(out, host)

    # -- jagged variants -------------------------------------------------
    #
    # Per-process payload is one uint8 byte stream; shapes/dtypes ride
    # the envelope metadata.  Tensor blocks in → tensors out; numpy in →
    # numpy out.  A block meant for local rank l lands on its device;
    # the gathered list (every rank's block) on local rank 0's.

    def allgatherv(self, blocks, _cid=None):
        comm = self.comm
        cid = self._cid(_cid)
        arrs = [_block_to_host(b) for b in blocks]
        datas = comm.dcn.allgather(_pack(arrs), cid)
        metas = comm.dcn.allgather_obj([_meta(a) for a in arrs], cid)
        tensors = _any_tensor(blocks)
        out = []
        for data, ms in zip(datas, metas):
            out += _unpack(data, ms, [comm.local_mesh.device] * len(ms) if tensors else None)
        return out

    def gatherv(self, blocks, root: int = 0, _cid=None):
        return self.allgatherv(blocks, _cid=_cid)

    def scatterv(self, blocks, root: int = 0, _cid=None):
        """Jagged scatter: ``blocks`` = one array per GLOBAL rank
        (meaningful on root's process; others may pass None).  Returns
        this process's local ranks' blocks, shapes/dtypes preserved."""
        comm = self.comm
        cid = self._cid(_cid)
        root_proc, _ = comm.locate(root)
        payloads = meta = None
        if comm.proc == root_proc:
            if blocks is None or len(blocks) != comm.size:
                raise MPIArgError(
                    f"scatterv root needs one block per global rank "
                    f"({comm.size}); got "
                    f"{None if blocks is None else len(blocks)}")
            arrs = [_block_to_host(b) for b in blocks]
            payloads, meta = [], []
            for p in range(comm.nprocs):
                chunk = arrs[slice(*comm.proc_range(p))]
                meta.append([_meta(a) for a in chunk])
                payloads.append(_pack(chunk))
        metas = comm.dcn.allgather_obj(meta, cid)[root_proc]
        data = comm.dcn.scatter(payloads, root_proc, cid)
        return _unpack(data, metas[comm.proc],
                       comm.local_mesh.devices if _any_tensor(blocks) else None)

    def alltoallv(self, matrix, _cid=None):
        """Jagged all-to-all: ``matrix[l][j]`` = block from this
        process's local rank l to GLOBAL rank j.  Returns
        ``out[l][src]`` = block sent by global rank src to local rank l."""
        comm = self.comm
        cid = self._cid(_cid)
        ln = comm.local_size
        if len(matrix) != ln or any(len(row) != comm.size for row in matrix):
            raise MPIArgError(
                f"alltoallv matrix must be local_size x global_n "
                f"({ln} x {comm.size})")
        rows = [[_block_to_host(b) for b in row] for row in matrix]
        payloads, meta = [], []
        for p in range(comm.nprocs):
            lo, hi = comm.proc_range(p)
            chunk = [rows[i][j] for i in range(ln) for j in range(lo, hi)]
            meta.append([_meta(a) for a in chunk])
            payloads.append(_pack(chunk))
        metas = comm.dcn.allgather_obj(meta, cid)  # [src proc][dst proc]
        datas = comm.dcn.alltoall(payloads, cid)   # [src proc] bytes for us
        tensors = _any_tensor(b for row in matrix for b in row)
        out = [[None] * comm.size for _ in range(ln)]
        for q in range(comm.nprocs):
            qlo, qhi = comm.proc_range(q)
            # sender q packed in (its local rank, our local rank) order
            devs = list(comm.local_mesh.devices) * (qhi - qlo) if tensors else None
            got = iter(_unpack(datas[q], metas[q][comm.proc], devs))
            for sl in range(qhi - qlo):
                for dl in range(ln):
                    out[dl][qlo + sl] = next(got)
        return out

    # -- non-blocking / persistent derivation ---------------------------
    #
    # An i-collective runs its blocking implementation on a progress
    # thread (the spawn-on-demand nbc_pool: never a bounded FIFO, which
    # could park the task a peer is blocked on behind busy workers) and
    # returns a request the caller overlaps compute against.  Every
    # instance gets a PRIVATE DCN stream (``<comm cid>#nbc<k>``, k = the
    # comm's NBC issue counter, identical across processes by MPI's
    # same-issue-order rule).
    #
    # Streams: the worker thread's current CUDA streams are not the
    # caller's.  One event per card recorded on the caller's stream at
    # issue (request.card_events: every card the inputs touch, each shard
    # of a RankShards included) makes the worker wait for the caller's
    # writes to the input before the local leg reads it; one event per
    # card recorded on the worker's streams after the result orders the
    # caller's stream on every card at wait().

    def _issue(self, fn, *a, **k) -> Request:
        from concurrent.futures import Future

        from ompi_tpu_torch.core.threads import nbc_pool
        from ompi_tpu_torch.tool import memchecker

        comm = self.comm
        k["_cid"] = f"{comm.cid}#nbc{comm._next_nbc()}"
        fut: Future = Future()
        # memchecker-lite: the DCN i-path reads the user's buffers until
        # completion — guard them (host buffers write-protected, every
        # shard of a RankShards checksummed) so a mutation in the
        # in-flight window raises instead of corrupting
        guards = []
        if memchecker.attached():
            for x in a:
                if isinstance(x, RankShards):
                    guards += memchecker.guard_shards(x, fn.__name__)
                else:
                    g = memchecker.guard(x, fn.__name__)
                    if g is not None:
                        guards.append(g)
        issued = card_events(a)

        def run():
            try:
                for card, ev in issued:
                    torch.cuda.current_stream(card).wait_event(ev)
                result = fn(*a, **k)
                done = card_events((a, result))
            except BaseException as e:
                for g in guards:
                    g.abandon()  # restore writeability; fn's error wins
                fut.set_exception(e)
                return
            err = None
            for g in guards:  # release ALL (none may stay read-only;
                try:          # release restores the flag before verify)
                    g.release()  # raises MPIBufferError on mutation
                except BaseException as e:  # noqa: BLE001
                    if err is None:
                        err = e
            if err is not None:
                fut.set_exception(err)
            else:
                fut.set_result((result, done))

        nbc_pool.submit(run)
        return _NbcRequest(fut)

    def __getattr__(self, name: str):
        if name.startswith("i") and name[1:] in COLL_OPS:
            blocking = getattr(self, name[1:])

            def ivariant(*a, **k) -> Request:
                return self._issue(blocking, *a, **k)

            return ivariant
        if name.endswith("_init") and name[: -len("_init")] in COLL_OPS:
            blocking = getattr(self, name[: -len("_init")])

            def init_variant(*a, **k) -> PersistentRequest:
                return PersistentRequest(lambda: self._issue(blocking, *a, **k))

            return init_variant
        raise AttributeError(name)


@register_component
class HanCollComponent(Component):
    """``coll/han`` MCA component — hierarchical two-level collectives.

    Priority 95, as in the reference: on communicators where it applies
    (multi-process) it wins every slot, since coll/cuda and coll/basic
    (and so coll/tuned, which wraps coll/cuda) decline them."""

    FRAMEWORK = "coll"
    NAME = "han"
    PRIORITY = 95

    def __init__(self):
        super().__init__()
        self.store = None

    def register_params(self, store) -> None:
        super().register_params(store)
        self.store = store
        store.register(
            "coll", "han", "reproducible", False, type="bool",
            help="Force deterministic process-ordered inter-process folds "
            "(≈ mca_coll_han_allreduce_reproducible)",
        )

    def open(self, store) -> bool:
        # han serves only communicators that span processes, which
        # exist only in a job tpurun launched
        from ompi_tpu_torch.boot.proc import launched_by_tpurun

        return launched_by_tpurun()

    def query(self, comm) -> HanCollModule | None:
        if getattr(comm, "dcn", None) is None:
            return None
        return HanCollModule(comm, self)

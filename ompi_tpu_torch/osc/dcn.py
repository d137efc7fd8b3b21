"""Distributed one-sided windows over the DCN — osc for multi-process.

Port of ``ompi_tpu/osc/dcn.py`` (≈ the reference's ``osc/rdma`` +
``osc/pt2pt`` pair reduced to the DCN transport): each GLOBAL rank
exposes a 1-D buffer; origins issue Put/Get/Accumulate as ``rma`` frames
the target process's delivery thread applies atomically (per-window
target-side lock — the passive-target atomicity the standard's UNIFIED
model needs).

Window memory stays where the caller put it: a numpy base is aliased by
``torch.from_numpy``, a tensor on the card keeps its memory there (as
:mod:`ompi_tpu_torch.osc.win` does in one process; on the devices
layout base r lies on local rank r's card), and the ops apply with the
op's ``torch_fn`` on the memory's device.  RMA payloads cross the DCN as
host bytes (one D2H at the origin, one H2D at the target for a window
on the card); ``get``/``fetch_and_op``/``compare_and_swap`` return numpy
arrays, bfloat16 as its raw two-byte words — or, given ``origin`` (a
rank of this process), a tensor on that rank's device.

Completion model (the osc "sync" machinery):

* **fence**: counts outgoing ops per target process; at the fence an
  alltoall of sent-counts tells every process how many inbound ops to
  wait for, it spins until its applied-counter matches, then a barrier
  closes the epoch — the reference's fence-with-counters.
* **get / fetch_and_op / compare_and_swap**: request/reply frames (the
  origin blocks on the reply) — complete when they return.
* **flush(target)**: a sync ping/ack round to the target process — all
  previously issued ops to that target are applied when it returns
  (frames are FIFO per connection pair).
* **lock/unlock (passive)**: per-op target-side atomicity makes a
  LOCK_SHARED epoch a no-op bracket; unlock = flush.  LOCK_EXCLUSIVE is
  serviced with the same per-op atomicity (multi-op critical sections
  should use fetch_and_op/CAS).
* **post/start/complete/wait (PSCW)**, per process: ``post`` sends a
  ``post`` frame to every other process owning one of the origin ranks,
  ``start`` waits for one from every other process owning a target,
  ``complete`` sends a ``complete`` frame behind its ops to each of
  those (frames are FIFO, so the ops are applied before it), and
  ``wait`` waits for one from each origin process.

Epoch closes (fence, flush, unlock, ``wait``) order the caller's
current stream on every card an applied op touched after the stream
that applied it (the delivery thread's), so memory read after the close
sees the epoch's writes.

Window ids ride the comm's CID namespace (``w<cid>#<k>``, k = the comm's
SPMD window counter), so streams never collide across windows or comms.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Sequence

import numpy as np
import torch

from ompi_tpu_torch.coll.han import to_device, to_host
from ompi_tpu_torch.core.errors import MPIWinError
from ompi_tpu_torch.dcn.tcp import BF16_HOST, BF16_WIRE
from ompi_tpu_torch.ddt.datatype import numpy_dtype, torch_dtype
from ompi_tpu_torch.op import op as opmod

from .win import _alias, _window_dtype


def _wire_dtype(t: torch.dtype) -> np.dtype:
    """The numpy dtype a window's elements cross the DCN in (bfloat16 as
    its raw two-byte words)."""
    return BF16_HOST if t == torch.bfloat16 else numpy_dtype(t)


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A window region's bytes as an owned host array (``to_host`` of a
    CPU tensor would alias the window memory)."""
    return to_host(t.clone())


class MultiProcWin:
    """A window spanning the processes of a MultiProcComm."""

    def __init__(self, comm, bases: Sequence, name: str = ""):
        """``bases``: one 1-D buffer per LOCAL rank of this process, numpy
        or a tensor (collective; every process contributes its local
        ranks')."""
        if len(bases) != comm.local_size:
            raise MPIWinError(
                f"need {comm.local_size} local base buffers, got {len(bases)}")
        self.comm = comm
        self._user = [b if isinstance(b, torch.Tensor) else np.ascontiguousarray(b)
                      for b in bases]
        for b in self._user:
            if b.ndim != 1:
                raise MPIWinError("window bases must be 1-D")
        self._mem = [self._as_base(b) for b in self._user]
        k = comm._next_win()
        self.win_id = f"w{comm.cid}#{k}"
        self.name = name or self.win_id
        self._freed = False
        self._lock = threading.Lock()      # target-side atomicity
        self._applied = 0                  # inbound ops applied
        self._sent = [0] * comm.nprocs     # outbound ops per target proc
        self._replies: dict[int, tuple[threading.Event, list]] = {}
        self._next_req = 0
        self._req_lock = threading.Lock()
        #: (card, stream) → the event after the last op applied there
        self._touched: dict[tuple[int, int], torch.cuda.Event] = {}
        #: PSCW: post / complete frames received per process
        self._pscw = {"post": [0] * comm.nprocs, "complete": [0] * comm.nprocs}
        self._pscw_cv = threading.Condition()
        self._access: list[int] = []    # target procs of the open access epoch
        self._exposure: list[int] = []  # origin procs of the open exposure epoch
        comm.dcn.register_p2p(self.win_id, self._on_frame)
        # window geometry: exchange per-rank sizes and dtypes (collective)
        sizes = [int(m.shape[0]) for m in self._mem]
        dts = [self._dt_str(m.dtype) for m in self._mem]
        infos = comm.dcn.allgather_obj({"sizes": sizes, "dtypes": dts},
                                       f"{self.win_id}#modex")
        self.sizes = [s for it in infos for s in it["sizes"]]
        self.dtypes = [np.dtype(d) for it in infos for d in it["dtypes"]]

    @staticmethod
    def _as_base(b) -> torch.Tensor:
        """A base as the tensor the ops apply to (aliasing its memory)."""
        dt = b.dtype if isinstance(b, torch.Tensor) else _window_dtype(b.dtype)
        return _alias(b, dt)

    @staticmethod
    def _dt_str(t: torch.dtype) -> str:
        return BF16_WIRE if t == torch.bfloat16 else _wire_dtype(t).str

    # -- geometry -------------------------------------------------------

    def _local_index(self, rank: int):
        p, li = self.comm.locate(rank)
        return (li if p == self.comm.proc else None), p

    def memory(self, rank: int):
        """A local rank's window memory, as the caller passed it."""
        li, _p = self._local_index(rank)
        if li is None:
            raise MPIWinError(f"rank {rank} is not local to this process")
        return self._user[li]

    # -- inbound application (delivery thread) --------------------------

    def _on_frame(self, env: dict, payload: np.ndarray) -> None:
        if env["rma"] in self._pscw:
            with self._pscw_cv:
                self._pscw[env["rma"]][env["origin_proc"]] += 1
                self._pscw_cv.notify_all()
            return
        if env["rma"] == "reply":
            with self._req_lock:
                ent = self._replies.get(env["req"])
            if ent is not None:
                ent[1].append(payload)
                ent[0].set()
            return
        self._apply(env, payload, inbound=True)

    @staticmethod
    def _acc_op(name: str) -> opmod.Op:
        """Accumulate requires a PREDEFINED op (MPI 12.3.4)."""
        op = getattr(opmod, name.split("_", 1)[1], None) if name.startswith(
            "MPI_") else None
        if not isinstance(op, opmod.Op):
            raise MPIWinError(f"accumulate requires a predefined op; got {name!r}")
        return op

    def _apply(self, env: dict, payload: np.ndarray, inbound: bool) -> None:
        kind = env["rma"]
        li, _ = self._local_index(env["target"])
        if li is None:  # misrouted — drop loudly
            print(f"[ompi_tpu_torch osc/dcn] frame for non-local rank "
                  f"{env['target']} on {self.name}", file=sys.stderr)
            return
        mem = self._mem[li]
        # C-ABI windows are byte-typed: ops may carry their element
        # dtype ("dt") and address in elements of it
        if "dt" in env:
            mem = mem.view(torch_dtype(np.dtype(env["dt"])))

        def data() -> torch.Tensor:
            return to_device(np.ascontiguousarray(payload).view(_wire_dtype(mem.dtype)),
                             mem.dtype, mem.device)

        disp = int(env.get("disp", 0))
        reply = None
        with self._lock:
            if kind == "put":
                d = data()
                mem[disp:disp + d.numel()].copy_(d)
            elif kind == "acc":
                d = data()
                op = self._acc_op(env["op"])
                seg = mem[disp:disp + d.numel()]
                seg.copy_(d if op is opmod.REPLACE else op.torch_fn(seg, d))
            elif kind == "get":
                reply = _host_copy(mem[disp:disp + int(env["count"])])
            elif kind == "fao":
                op = self._acc_op(env["op"])
                cell = mem[disp:disp + 1]
                reply = _host_copy(cell)
                val = data()[:1]
                if op is opmod.REPLACE:
                    cell.copy_(val)
                elif op is not opmod.NO_OP:
                    cell.copy_(op.torch_fn(cell, val))
            elif kind == "cas":
                cell = mem[disp:disp + 1]
                pair = data()  # [value, compare]
                reply = _host_copy(cell)
                cell.copy_(torch.where(cell == pair[1:2], pair[0:1], cell))
            elif kind == "sync":
                reply = np.zeros(0, np.uint8)
            if mem.is_cuda and kind != "sync":
                stream = torch.cuda.current_stream(mem.device)
                ev = torch.cuda.Event()
                ev.record(stream)
                self._touched[(mem.device.index, stream.cuda_stream)] = ev
            if inbound:
                # fence counts REMOTE inbound only; locally-applied ops
                # are complete by construction
                self._applied += 1
        if reply is not None:
            if env["origin_proc"] == self.comm.proc:
                with self._req_lock:
                    ent = self._replies.get(env["req"])
                if ent is not None:
                    ent[1].append(reply)
                    ent[0].set()
            else:
                self.comm.dcn.send_p2p(
                    env["origin_proc"],
                    {"cid": self.win_id, "rma": "reply", "req": env["req"]},
                    reply)

    # -- origin-side issue ----------------------------------------------

    def _check(self):
        if self._freed:
            raise MPIWinError(f"{self.name} has been freed")

    def _issue(self, target: int, env: dict, payload: np.ndarray,
               reply: bool = False):
        self._check()
        li, p = self._local_index(target)
        env = {"cid": self.win_id, "target": target,
               "origin_proc": self.comm.proc, **env}
        if reply:
            with self._req_lock:
                rid = self._next_req
                self._next_req += 1
                ev: tuple = (threading.Event(), [])
                self._replies[rid] = ev
            env["req"] = rid
        if li is not None:
            # local target: apply directly (atomicity via the shared
            # lock; not counted as inbound — see fence)
            self._apply(env, payload, inbound=False)
        else:
            self._sent[p] += 1
            self.comm.dcn.send_p2p(p, env, payload)
        if reply:
            try:
                if not ev[0].wait(timeout=120):
                    raise MPIWinError(
                        f"RMA reply timeout from rank {target} on {self.name}")
            finally:
                with self._req_lock:
                    self._replies.pop(env["req"], None)
            return ev[1][0]
        return None

    def _elem(self, target: int, dt) -> np.dtype:
        """The element dtype an op addresses: ``dt`` (a byte-typed C-ABI
        window's view) or the target's own."""
        return self.dtypes[target] if dt is None else np.dtype(dt)

    @staticmethod
    def _env(env: dict, dt) -> dict:
        if dt is not None:
            env["dt"] = np.dtype(dt).str
        return env

    def _bytes(self, target: int, data, dt=None) -> np.ndarray:
        """Origin data as the element bytes the op addresses: converted
        to the target's dtype (or ``dt``) — a tensor on its device,
        numpy on the host — then its host bytes."""
        want = self._elem(target, dt)
        if want == BF16_HOST:
            t = data if isinstance(data, torch.Tensor) else torch.as_tensor(
                np.asarray(data))
            arr = to_host(t.to(torch.bfloat16))
        elif isinstance(data, torch.Tensor):
            arr = to_host(data.to(torch_dtype(want)))
        else:
            arr = np.ascontiguousarray(np.asarray(data, want))
        return arr.view(np.uint8).reshape(-1)

    def put(self, target: int, data, disp: int = 0, dt=None) -> None:
        """``dt``: the element dtype of a byte-typed window's view
        (``disp`` counts its elements), as the C ABI's typed RMA uses."""
        env = self._env({"rma": "put", "disp": int(disp)}, dt)
        self._issue(target, env, self._bytes(target, data, dt))

    def _fetched(self, out, target: int, dt, origin: int | None):
        """A reply's bytes as the target's (or ``dt``'s) elements: numpy,
        or with ``origin`` a tensor on that local rank's device."""
        a = np.asarray(out).view(self._elem(target, dt))
        if origin is None:
            return a
        li, _p = self._local_index(origin)
        if li is None:
            raise MPIWinError(f"origin rank {origin} is not local to this process")
        tdt = torch.bfloat16 if a.dtype == BF16_HOST else torch_dtype(a.dtype)
        return to_device(a, tdt, self.comm.local_mesh.devices[li])

    def get(self, target: int, count: int, disp: int = 0, dt=None,
            origin: int | None = None):
        env = self._env({"rma": "get", "disp": int(disp), "count": int(count)}, dt)
        out = self._issue(target, env, np.zeros(0, np.uint8), reply=True)
        return self._fetched(out, target, dt, origin)

    def accumulate(self, target: int, data, disp: int = 0,
                   op: opmod.Op = opmod.SUM, dt=None) -> None:
        env = self._env({"rma": "acc", "disp": int(disp), "op": op.name}, dt)
        self._issue(target, env, self._bytes(target, data, dt))

    def fetch_and_op(self, target: int, value, disp: int = 0,
                     op: opmod.Op = opmod.SUM, dt=None, origin: int | None = None):
        env = self._env({"rma": "fao", "disp": int(disp), "op": op.name}, dt)
        out = self._issue(target, env, self._bytes(target, [value], dt), reply=True)
        return self._fetched(out, target, dt, origin)[0]

    def compare_and_swap(self, target: int, value, compare, disp: int = 0,
                         dt=None, origin: int | None = None):
        env = self._env({"rma": "cas", "disp": int(disp)}, dt)
        out = self._issue(target, env, self._bytes(target, [value, compare], dt),
                          reply=True)
        return self._fetched(out, target, dt, origin)[0]

    # -- synchronization -------------------------------------------------

    def fence(self, assertion: int = 0) -> None:
        """Fence epoch close: counters + barrier (see module doc)."""
        del assertion
        self._check()
        comm = self.comm
        # per-target-proc sent counts → every proc's expected inbound
        sent = [np.asarray([c], np.int64) for c in self._sent]
        got = comm.dcn.alltoall(sent, f"{self.win_id}#fence")
        expected = int(sum(int(g[0]) for i, g in enumerate(got) if i != comm.proc))
        deadline = time.monotonic() + 120
        while True:
            with self._lock:
                applied = self._applied
            if applied >= expected:
                break
            if time.monotonic() > deadline:
                raise MPIWinError(
                    f"fence timeout: {applied}/{expected} inbound ops "
                    f"applied on {self.name}")
            time.sleep(0.0005)
        self._sent = [0] * comm.nprocs
        with self._lock:
            self._applied -= expected
        comm.dcn.barrier(f"{self.win_id}#fencebar")
        self._order_cards()

    def _order_cards(self) -> None:
        """Epoch close: the caller's current stream on every card an op
        was applied on waits for the stream that applied it."""
        with self._lock:
            touched, self._touched = self._touched, {}
        for (card, _stream), ev in touched.items():
            torch.cuda.current_stream(card).wait_event(ev)

    def flush(self, target: int) -> None:
        """All previously issued ops to ``target``'s process are applied
        (FIFO per connection + a sync round-trip)."""
        li, _ = self._local_index(target)
        if li is None:
            self._issue(target, {"rma": "sync"}, np.zeros(0, np.uint8), reply=True)
        self._order_cards()

    # -- post/start/complete/wait (generalized active target) ------------

    def _procs_of(self, ranks) -> list[int]:
        """The other processes owning any of ``ranks``."""
        return sorted({self.comm.locate(int(r))[0] for r in ranks} - {self.comm.proc})

    def _send_pscw(self, kind: str, procs) -> None:
        for p in procs:
            self.comm.dcn.send_p2p(
                p, {"cid": self.win_id, "rma": kind, "origin_proc": self.comm.proc},
                np.zeros(0, np.uint8))

    def _await_pscw(self, kind: str, procs, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        with self._pscw_cv:
            while not all(self._pscw[kind][p] > 0 for p in procs):
                left = deadline - time.monotonic()
                if left <= 0:
                    raise MPIWinError(
                        f"{kind} timeout on {self.name}: waiting for processes "
                        f"{[p for p in procs if not self._pscw[kind][p]]}")
                self._pscw_cv.wait(min(left, 0.25))
            for p in procs:
                self._pscw[kind][p] -= 1

    def post(self, origins) -> None:
        """MPI_Win_post: expose this process's ranks' memory to the
        ``origins`` (global ranks) until :meth:`wait`."""
        self._check()
        if self._exposure:
            raise MPIWinError(f"post on {self.name}: an exposure epoch is open")
        self._exposure = self._procs_of(origins)
        self._send_pscw("post", self._exposure)

    def start(self, targets) -> None:
        """MPI_Win_start: an access epoch to the ``targets`` (global
        ranks); returns once every other process owning one has posted."""
        self._check()
        if self._access:
            raise MPIWinError(f"start on {self.name}: an access epoch is open")
        self._access = self._procs_of(targets)
        self._await_pscw("post", self._access)

    def complete(self) -> None:
        """MPI_Win_complete: close the access epoch; each target process
        is told behind this process's ops to it."""
        self._check()
        procs, self._access = self._access, []
        self._send_pscw("complete", procs)
        self._order_cards()

    def wait(self) -> None:
        """MPI_Win_wait: close the exposure epoch once every origin
        process has completed (its ops are then applied here)."""
        self._check()
        procs, self._exposure = self._exposure, []
        self._await_pscw("complete", procs)
        self._order_cards()

    def lock(self, target: int, lock_type: int = 0) -> None:
        """Passive epoch open (per-op atomicity services both lock kinds
        — see module doc)."""
        self._check()
        del target, lock_type

    def unlock(self, target: int) -> None:
        self.flush(target)

    def flush_all(self) -> None:
        """All previously issued ops to every process are applied (one
        sync round-trip per PROCESS, not per rank)."""
        for p in range(self.comm.nprocs):
            lo, _hi = self.comm.proc_range(p)
            if p != self.comm.proc:
                self.flush(lo)

    def lock_all(self) -> None:
        self._check()

    def unlock_all(self) -> None:
        self.flush_all()

    def free(self) -> None:
        """MPI_Win_free is COLLECTIVE: a barrier keeps every member's
        outstanding passive-target traffic served before anyone
        unregisters the window's frame routing."""
        self._check()  # a double free must RAISE, not hang the barrier
        self.comm.dcn.barrier(f"{self.win_id}#freebar")
        self.comm.dcn.unregister_p2p(self.win_id)
        self._freed = True

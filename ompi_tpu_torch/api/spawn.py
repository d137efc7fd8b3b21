"""Dynamic process management — MPI_Comm_spawn / MPI_Comm_get_parent.

Port of ``ompi_tpu/api/spawn.py`` (≈ ``ompi/dpm`` + the PRRTE spawn
leg): a running multi-process job launches ``maxprocs`` new worker
processes; parents and children connect into one communication space.

The spawning process forks the children with a fresh KVS namespace
(``<ns>sp<k>.``) on the job's existing KVS server; each side publishes
its DCN endpoints and slice sizes under its namespace, and both build a
join engine (:class:`~ompi_tpu_torch.dcn.collops.DcnJoinEngine`, or the
native plane's ``NativeJoinEngine``) — a union-indexed view over parent
and child processes sharing each process's existing transport.  The
result surfaces as

* ``spawn(...)`` / ``get_parent()`` → :class:`SpawnIntercomm`: remote
  geometry, p2p addressed to the remote group, and
* ``.merge()`` → a full ``MultiProcComm`` over the union — every han
  collective, dup/split (CID agreement spans both worlds through the
  join engine), p2p — the MPI_Intercomm_merge outcome.

Spawn-scoped STRING cids (``sp<k>#...``) cannot collide with either
world's integer cids, so no cross-world CID negotiation is needed at
construction.  A child picks its device as any worker does: a CPU
worker calls ``api.init(device="cpu")``.
"""

from __future__ import annotations

import atexit
import os
import shutil
import subprocess
import sys
import threading
from typing import Sequence

import numpy as np

from ompi_tpu_torch.boot.proc import ENV_KVS, ENV_NPROCS, ENV_NS, ENV_PROC
from ompi_tpu_torch.core.errors import MPIArgError, MPICommError
from ompi_tpu_torch.dcn.collops import DcnJoinEngine

from .group import Group

ENV_PARENT_NS = "OMPI_TPU_PARENT_NS"
ENV_PARENT_NPROCS = "OMPI_TPU_PARENT_NPROCS"

#: children forked by this process (reaped at finalize and at exit)
_children: list[subprocess.Popen] = []
_forwarders: list[threading.Thread] = []


def _forward_child(stream) -> None:
    """iof leg for spawned children: whole lines, one write each, onto
    the parent's (already rank-prefixed) stdout."""
    for line in iter(stream.readline, b""):
        sys.stdout.buffer.write(line)
        sys.stdout.buffer.flush()


def _reap() -> None:
    """Wait spawned children out and drain their output forwarders.
    Called from ``api.finalize`` (while the interpreter is fully alive)
    and again at exit as a backstop."""
    for p in _children:
        if p.poll() is None:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
    for t in _forwarders:  # drain the last output lines before exit
        t.join(timeout=5)


def _join_world(world, join: DcnJoinEngine, ns: str, proc_sizes: list[int],
                cid: str | None = None):
    """A MultiProcComm over the union, riding the join engine."""
    from .comm import Comm
    from .multiproc import MultiProcComm

    c = MultiProcComm.__new__(MultiProcComm)
    c.procctx = world.procctx
    c.proc = join.proc
    c.nprocs = join.nprocs
    c.dcn = join
    # the union spans two worlds' KVS namespaces; the spawn's own is the
    # one every member shares (the C ABI's handle agreement keys on it)
    join.kvs_ns = ns
    c.local_mesh = world.local_mesh
    c.cid = cid if cid is not None else f"{ns}world"
    c.name = f"{c.cid}.comm"
    # FT does not span spawn worlds: a union comm never takes the
    # world-level replace leg
    c._derived = True
    c.proc_sizes = list(proc_sizes)
    c.offsets = np.cumsum([0] + c.proc_sizes).tolist()
    c.local_size = c.proc_sizes[c.proc]
    c.local_offset = c.offsets[c.proc]
    c.size = c.offsets[-1]
    c.group = Group(range(c.size))
    c.local = Comm(
        Group(range(c.local_offset, c.local_offset + c.local_size)),
        c.local_mesh,
        name=f"{c.name}.local{c.proc}",
    )
    c._wire()
    return c


class SpawnIntercomm:
    """The parent↔children intercommunicator (both sides' view).

    ``local_range``/``remote_range`` are [lo, hi) spans in the
    substrate's rank space; p2p ``send(buf, source, dest)`` addresses
    ``dest`` in the REMOTE group (intercomm rule), ``source`` in the
    local one.  ``merge(high)`` is a COLLECTIVE over both groups and
    returns a fresh intracomm — freeing the intercomm does not touch
    merged comms and vice versa."""

    def __init__(self, merged, local_range, remote_range, world, join_info):
        self._merged = merged  # internal substrate (owned by self)
        self._lo = local_range
        self._ro = remote_range
        #: (ns, parent_addrs, child_addrs, parent_sizes, child_sizes,
        #:  am_parent) — merge() rebuilds layouts from this
        self._world = world
        self._ji = join_info
        self._merge_count = 0
        self.is_inter = True

    @property
    def size(self) -> int:
        return self._lo[1] - self._lo[0]

    @property
    def remote_size(self) -> int:
        return self._ro[1] - self._ro[0]

    @property
    def local_offset(self) -> int:
        """This process's first LOCAL-group rank."""
        return self._merged.local_offset - self._lo[0]

    @property
    def local_size(self) -> int:
        return self._merged.local_size

    def merge(self, high: bool = False):
        """MPI_Intercomm_merge (collective over BOTH groups): a fresh
        intracomm over the union.  The group that passed high=True is
        ranked second; equal flags → parents first.  The flag exchange
        rides the substrate."""
        ns, paddrs, caddrs, psizes, csizes, am_parent = self._ji
        j = self._merge_count
        self._merge_count += 1
        ctx = self._world.procctx
        flags = self._merged.dcn.allgather_obj(
            {"parent": am_parent, "high": bool(high)}, f"{ns}mergeflag{j}")
        parent_high = any(f["high"] for f in flags if f["parent"])
        child_high = any(f["high"] for f in flags if not f["parent"])
        children_first = parent_high and not child_high
        if children_first:
            addrs = caddrs + paddrs
            sizes = list(csizes) + list(psizes)
            gproc = ctx.proc if not am_parent else len(caddrs) + ctx.proc
        else:
            addrs = paddrs + caddrs
            sizes = list(psizes) + list(csizes)
            gproc = ctx.proc if am_parent else len(paddrs) + ctx.proc
        join = ctx.engine.join(addrs, gproc)
        order = "cf" if children_first else "pf"
        return _join_world(self._world, join, ns, sizes, cid=f"{ns}merged{j}_{order}")

    def send(self, buf, source: int, dest: int, tag: int = 0) -> None:
        self._merged.send(buf, self._lo[0] + source, self._ro[0] + dest, tag)

    def recv(self, dest: int, source: int | None = None, tag: int | None = None):
        payload, st = self._merged.recv(
            self._lo[0] + dest, None if source is None else self._ro[0] + source, tag)
        st.source -= self._ro[0]  # back to remote-group rank
        return payload, st

    def barrier(self) -> None:
        self._merged.barrier()

    def free(self) -> None:
        self._merged.free()

    def __repr__(self) -> str:  # pragma: no cover
        return f"<SpawnIntercomm local={self.size} remote={self.remote_size}>"


def _child_cmd(argv: Sequence[str]) -> list[str]:
    """A ``.py`` script or a Python module runs under this interpreter;
    an executable file or a program on PATH runs as it is."""
    argv = list(argv)
    first = argv[0]
    if first.endswith(".py"):
        return [sys.executable] + argv
    resolved = (os.path.abspath(first)
                if os.path.isfile(first) and os.access(first, os.X_OK)
                else shutil.which(first))
    return [resolved] + argv[1:] if resolved else [sys.executable] + argv


def spawn(argv: Sequence[str], maxprocs: int, root: int = 0):
    """MPI_Comm_spawn (collective over the parent world): launch
    ``maxprocs`` new processes running ``argv`` and return the
    parent-side :class:`SpawnIntercomm`.

    The root rank's process forks the children (inheriting the job's KVS
    server and environment); children call ``api.init()`` then
    ``api.get_parent()``."""
    from ompi_tpu_torch import api

    world = api.comm_world()
    ctx = getattr(world, "procctx", None)
    if ctx is None:
        raise MPICommError(
            "spawn requires a tpurun job (the single-controller model "
            "has no launcher to start processes)")
    if maxprocs < 1:
        raise MPIArgError(f"maxprocs must be >= 1, got {maxprocs}")
    k = world._next_spawn()
    # the ctx.ns prefix keeps grandchild namespaces distinct
    ns = f"{ctx.ns}sp{k}."
    root_proc, _ = world.locate(root)

    if ctx.proc == root_proc:
        # the forwarder threads share this process's stdout with user
        # prints: line buffering makes every line one write, so a relayed
        # child line cannot land inside one (write_through=False matters:
        # PYTHONUNBUFFERED sets it, and with it on each print is two writes)
        try:
            sys.stdout.reconfigure(line_buffering=True, write_through=False)
        except (AttributeError, ValueError):  # a stream that cannot be
            pass                              # reconfigured
        cmd = _child_cmd(argv)
        first_spawn = not _children
        for i in range(maxprocs):
            env = dict(os.environ)
            env[ENV_PROC] = str(i)
            env[ENV_NPROCS] = str(maxprocs)
            env[ENV_KVS] = os.environ[ENV_KVS]
            env[ENV_NS] = ns
            env[ENV_PARENT_NS] = ctx.ns
            env[ENV_PARENT_NPROCS] = str(ctx.nprocs)
            # children get their own pipes and a line forwarder (iof):
            # sharing the parent's pipe fd interleaves partial writes
            p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
            _children.append(p)
            t = threading.Thread(target=_forward_child, args=(p.stdout,), daemon=True)
            t.start()
            _forwarders.append(t)
        if first_spawn:
            atexit.register(_reap)
        # publish the parent world's slice sizes for the children
        ctx.kvs.put(f"{ns}psizes", list(world.proc_sizes))

    # every parent learns the children's endpoints and sizes (kvs.get
    # blocks until the children publish — the spawn rendezvous)
    child_addrs = [ctx.kvs.get(f"{ns}dcn.{i}", timeout=120) for i in range(maxprocs)]
    child_sizes = ctx.kvs.get(f"{ns}csizes", timeout=120)
    # indexed access, not list(): a lazy AddressTable's unresolved slots
    # read None under plain iteration
    parent_addrs = [ctx.engine.addresses[p] for p in range(ctx.nprocs)]
    join = ctx.engine.join(parent_addrs + child_addrs, ctx.proc)
    merged = _join_world(world, join, ns, list(world.proc_sizes) + list(child_sizes))
    psize = int(sum(world.proc_sizes))
    ji = (ns, parent_addrs, child_addrs, list(world.proc_sizes), list(child_sizes), True)
    return SpawnIntercomm(merged, (0, psize), (psize, merged.size), world, ji)


_parent_cache = None


def get_parent():
    """MPI_Comm_get_parent: the child-side intercomm, or None if this
    process was not spawned.  Cached — every call returns the same
    communicator (a rebuild would reset its sequence streams)."""
    global _parent_cache
    if _parent_cache is not None:
        return _parent_cache
    if ENV_PARENT_NS not in os.environ or ENV_NS not in os.environ:
        return None
    from ompi_tpu_torch import api

    world = api.comm_world()
    ctx = world.procctx
    ns = ctx.ns
    if ctx.proc == 0:
        ctx.kvs.put(f"{ns}csizes", list(world.proc_sizes))
    pns = os.environ[ENV_PARENT_NS]
    pn = int(os.environ[ENV_PARENT_NPROCS])
    parent_addrs = [ctx.kvs.get(f"{pns}dcn.{p}", timeout=120) for p in range(pn)]
    parent_sizes = ctx.kvs.get(f"{ns}psizes", timeout=120)
    child_addrs = [ctx.engine.addresses[p] for p in range(ctx.nprocs)]
    join = ctx.engine.join(parent_addrs + child_addrs, pn + ctx.proc)
    merged = _join_world(world, join, ns, list(parent_sizes) + list(world.proc_sizes))
    psize = int(sum(parent_sizes))
    ji = (ns, parent_addrs, child_addrs, list(parent_sizes), list(world.proc_sizes), False)
    _parent_cache = SpawnIntercomm(merged, (psize, merged.size), (0, psize), world, ji)
    return _parent_cache

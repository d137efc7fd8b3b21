"""The port's ULFM recovery legs against the reference's, after
``tests/test_ulfm.py``.

* Single-process cases (``tests/test_ulfm.py:46-213``): the same
  scenario runs on a dup of each package's 8-rank world (the reference
  on the conftest's virtual CPU devices, the port on 8 rows on the CPU)
  and gives the same outcome step by step — the result, or the error
  class and its ``failed`` tuple.  A shrunk comm's allreduce (the ring,
  enum 2, pinned on both sides) is bit-equal to the reference's shrunk
  comm's on the same seeded inputs.
* ``NativeDcnEngine.update_address``: in both packages a native engine
  told a peer's new endpoint routes its next frame there (the reborn
  incarnation's engine receives it; the corpse's does not).
* ``tpurun --ft --respawn`` jobs (``tests/test_ulfm.py:246-447``), each
  through both launchers with one mirrored worker body written into
  ``tmp_path``: respawn and replace at full size (on ``btl/tcp`` as the
  reference's test runs it, and on the port's default native plane), the
  rsh-shim leg, partial replace of a split comm, and nested split
  replace.  The tallies are equal and every post-recovery result is
  bit-equal to the reference's (float64 sums of two rows, which no
  order can change).  The reference's short deadlines are kept.
"""

import glob
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

import ompi_tpu.api as rapi
import ompi_tpu_torch.api as papi
from ompi_tpu.api.multiproc import MultiProcComm as RMultiProc
from ompi_tpu.core import mca as rmca
from ompi_tpu.dcn import native as rnative
from ompi_tpu.ft import ulfm as rulfm
from ompi_tpu_torch.api.multiproc import MultiProcComm as PMultiProc
from ompi_tpu_torch.core import mca as pmca
from ompi_tpu_torch.dcn import native as pnative
from ompi_tpu_torch.ft import ulfm as pulfm
from torch_mp_common import REPO, assert_bitwise_equal, load

N = 8
PKG = {
    "ref": types.SimpleNamespace(ulfm=rulfm, mca=rmca, coll="xla"),
    "port": types.SimpleNamespace(ulfm=pulfm, mca=pmca, coll="cuda"),
}


@pytest.fixture(scope="module")
def worlds(devices):
    papi.finalize()
    pw = papi.init(device="cpu", nranks=N)
    yield {"ref": rapi.init(), "port": pw}
    papi.finalize()


def _norm(v):
    """A comparable form of a scenario's value: arrays (numpy, jax or
    torch) as (dtype, shape, bytes), containers element by element."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_norm(e) for e in v]
    if hasattr(v, "group") and hasattr(v, "size"):  # a communicator
        return ("comm", v.size, list(v.group.ranks), v.name)
    a = np.asarray(v)
    return (a.dtype.str, a.shape, a.tobytes())


def _outcomes(steps, comm, pkg):
    out = []
    for step in steps:
        try:
            out.append(("ok", _norm(step(comm, pkg))))
        except Exception as e:  # noqa: BLE001 — the class name is compared
            out.append(("err", type(e).__name__, getattr(e, "failed", None)))
    return out


def _ones(shape):
    return lambda c, k: c.allreduce(np.ones(shape, np.float32))


def _recv(*a, **kw):
    return lambda c, k: c.recv(*a, **kw)[0]


def _inject(r):
    return lambda c, k: k.ulfm.inject_failure(c, r)


SCENARIOS = {
    "no_ft_state_is_free": [
        lambda c, k: k.ulfm.peek(c), _ones((N, 4)), lambda c, k: k.ulfm.get_failed(c),
        lambda c, k: c.is_revoked()],
    "inject_bounds": [_inject(N), _inject(-1)],
    "collective_raises_on_failure": [
        _inject(3), _ones((N, 4)), lambda c, k: c.barrier(),
        lambda c, k: c.ibcast(np.ones((N, 4), np.float32), root=0),
        lambda c, k: c.gatherv([np.ones(i + 1, np.float32) for i in range(N)], root=0)],
    "collective_raises_even_after_ack": [
        _inject(2), lambda c, k: c.ack_failed(), _ones((N, 2))],
    "pt2pt_failed_peer_only": [
        _inject(5), lambda c, k: c.send(np.arange(3.0), source=0, dest=1, tag=9),
        _recv(1, source=0, tag=9),
        lambda c, k: c.send(np.arange(3.0), source=0, dest=5),
        lambda c, k: c.irecv(1, source=5)],
    "any_source_pending_until_ack": [
        _inject(4), lambda c, k: c.irecv(0, source=None), lambda c, k: c.get_failed(),
        lambda c, k: c.ack_failed(),
        lambda c, k: c.send(np.float64(7.0), source=2, dest=0, tag=1),
        lambda c, k: (lambda pl_st: (float(pl_st[0]), pl_st[1].source))(
            c.recv(0, source=None, tag=1))],
    "revoke_poisons_everything_but_recovery": [
        _inject(1), lambda c, k: c.revoke(), lambda c, k: c.is_revoked(), _ones((N, 2)),
        lambda c, k: c.send(np.ones(2), source=0, dest=2),
        lambda c, k: c.irecv(2, source=0), lambda c, k: c.get_failed(),
        lambda c, k: c.agree(0b1011), lambda c, k: c.shrink().size],
    "shrink_produces_working_comm": [
        _inject(0), _inject(6), lambda c, k: c.shrink(name="survivors"),
        lambda c, k: c.shrink(name="survivors").allreduce(np.ones((N - 2, 3), np.float32)),
        lambda c, k: k.ulfm.peek(c.shrink())],
    "shrink_everyone_dead": [*(_inject(r) for r in range(N)), lambda c, k: c.shrink()],
    "agree_drops_failed_contributions": [
        _inject(7),
        lambda c, k: c.agree(0b1111, {**{r: 0b1111 for r in range(N)}, 3: 0b0110, 7: 0}),
        lambda c, k: c.agree(0b1010)],
    "agree_no_live_ranks": [*(_inject(r) for r in range(N)), lambda c, k: c.agree(1)],
    "every_collective_entry_is_guarded": [
        _inject(3),
        lambda c, k: c.reduce_scatter(np.ones((N, N, 2), np.float32)),
        lambda c, k: c.reduce_scatter(np.ones((N, N * 2), np.float32), counts=[2] * N),
        lambda c, k: c.reduce_scatter([np.ones(N + 3, np.float32)] * N,
                                      counts=list(range(1, N + 1))),
        lambda c, k: c.allreduce_init(np.ones((N, 2), np.float32)),
        lambda c, k: c.probe(0, source=3), lambda c, k: c.iprobe(0, source=None),
        lambda c, k: c.revoke(), lambda c, k: c.probe(0, source=1)],
    "replace_requires_multiproc": [lambda c, k: k.ulfm.replace(c)],
}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_single_process_outcomes_match_reference(worlds, case):
    got = {}
    for pkg, world in worlds.items():
        comm = world.dup(name="ft_test")
        got[pkg] = _outcomes(SCENARIOS[case], comm, PKG[pkg])
        comm.free()
    assert got["port"] == got["ref"]
    # the scenario's recovery calls really ran: no step hit an attribute
    # the port lacks
    assert not any(o[0] == "err" and o[1] in ("AttributeError", "TypeError", "NameError")
                   for o in got["port"]), got["port"]


@pytest.mark.parametrize("dead", [(3,), (3, 5), (0, 6)])
def test_shrunk_allreduce_bitwise_equal_to_reference(worlds, dead):
    """The survivors' comm runs the plain ring (enum 2, pinned in both
    packages) over 7, 6 and 6 ranks: bit-equal results."""
    n = N - len(dead)
    x = np.random.default_rng(sum(dead)).standard_normal((n, 1000)).astype(np.float32)
    got = {}
    for pkg, world in worlds.items():
        store = PKG[pkg].mca.default_context().store
        var = f"coll_{PKG[pkg].coll}_allreduce_algorithm"
        prev = store.get(var)
        store.set(var, 2)
        try:
            comm = world.dup(name="ft_shrink")
            for r in dead:
                PKG[pkg].ulfm.inject_failure(comm, r)
            comm.revoke()
            sub = comm.shrink()
            assert sub.size == n and list(sub.group.ranks) == [
                r for r in range(N) if r not in dead]
            got[pkg] = np.asarray(sub.allreduce(x))
            sub.free()
            comm.free()
        finally:
            store.set(var, prev)
    assert got["port"].tobytes() == got["ref"].tobytes()


def test_shrink_of_subcomm_matches_reference(worlds):
    got = {}
    for pkg, world in worlds.items():
        odd = world.split([r % 2 for r in range(N)])[1]
        PKG[pkg].ulfm.inject_failure(odd, 1)  # odd-comm rank 1 == world rank 3
        sub = PKG[pkg].ulfm.shrink(odd)
        got[pkg] = (sub.size, list(sub.group.ranks),
                    np.asarray(sub.allreduce(np.ones((3, 2), np.float32))).tobytes())
    assert got["port"] == got["ref"] == (3, [1, 5, 7], got["ref"][2])


def _guard_comm(cls, failed: set):
    comm = object.__new__(cls)
    comm.nprocs, comm.proc, comm.name = 2, 0, "guard_test"
    comm._ft = None
    comm.proc_sizes = [1, 1]
    comm.offsets = [0, 1, 2]
    comm.dcn = types.SimpleNamespace(proc_failed=lambda p: p in failed)
    return comm


def test_anysrc_guard_liveness_matches_reference():
    """``dcn_anysrc_timeout``: off by default; on, the guard re-arms while
    every member is alive and names the dead ranks once one fails."""
    got = {}
    for pkg, cls in (("ref", RMultiProc), ("port", PMultiProc)):
        failed: set = set()
        comm = _guard_comm(cls, failed)
        store = PKG[pkg].mca.default_context().store
        out = [comm._anysrc_guard() is None]
        store.set("dcn_anysrc_timeout", 1.5)
        try:
            timeout, check, escalate = comm._anysrc_guard()
            out += [timeout, check(), escalate(1.5)]
            failed.add(1)
            try:
                escalate(1.5)
                out.append("ok")
            except Exception as e:  # noqa: BLE001 — the class name is compared
                out.append((type(e).__name__, e.failed))
        finally:
            store.set("dcn_anysrc_timeout", 0.0)
        got[pkg] = out
    assert got["port"] == got["ref"] == [True, 1.5, None, None,
                                         ("MPIProcFailedPendingError", (1,))]


def test_replace_partial_guards_match_reference():
    """A survivor cannot call replace_partial (the reborn proc's rejoin),
    and a reborn context cannot take the survivors' partial leg."""
    got = {}
    for pkg, cls in (("ref", RMultiProc), ("port", PMultiProc)):
        comm = object.__new__(cls)
        comm.nprocs, comm.proc, comm.name = 2, 0, "pr_guard"
        out = []
        for ctx, call in (((True, 0), lambda: comm.replace_partial()),
                          ((False, 1), lambda: comm._replace_partial("", 1.0))):
            comm.procctx = types.SimpleNamespace(rejoined=ctx[0], incarnation=ctx[1])
            try:
                call()
                out.append("ok")
            except Exception as e:  # noqa: BLE001
                out.append((type(e).__name__, "replace_partial" in str(e)))
        got[pkg] = out
    assert got["port"] == got["ref"] == [("MPICommError", True)] * 2


# -- the native engine's one-peer address refresh --------------------------


def _send_by_proc(engine, proc: int, cid: str, x: np.ndarray) -> int:
    """A frame addressed by proc index through the C engine's own address
    table (``tdcn_send``), the route C-initiated traffic takes."""
    import ctypes

    lib = engine._lib
    lib.tdcn_send.restype = ctypes.c_int
    lib.tdcn_send.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_uint64]
    shape = (ctypes.c_int64 * 1)(x.size)
    return lib.tdcn_send(engine._h, proc, 0, cid.encode(), 0, engine.proc, 0, 0,
                         x.dtype.str.encode(), 1, shape, None, 0,
                         x.ctypes.data_as(ctypes.c_void_p), x.nbytes)


def process_start_epoch() -> float:
    """This process's start, in seconds since the epoch (``/proc/self/stat``
    field 22 over the boot time).  Both parts are rounded down, so it is
    never later than the true start."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime "))
    return btime + start_ticks / os.sysconf("SC_CLK_TCK")


def remove_stale_doorbells(shm: str = "/dev/shm", start: float | None = None) -> list:
    """Unlink the doorbells ``tdcn-db-<this pid>-*`` in ``shm`` whose change
    time is older than this process's start (or ``start``): a dead
    process with the same pid left them, and the reference's
    ``NativeDcnEngine``, unlike the port's, crashes on such a name.
    Returns the paths it removed."""
    start = process_start_epoch() if start is None else start
    removed = []
    for path in sorted(glob.glob(os.path.join(shm, f"tdcn-db-{os.getpid()}-*"))):
        try:
            if os.stat(path).st_ctime < start:
                os.unlink(path)
                removed.append(path)
        except FileNotFoundError:
            pass
    return removed


def test_remove_stale_doorbells_takes_only_a_dead_processes_names(tmp_path):
    """A name planted before the cut goes; one planted after it, and
    another pid's, stay.  This process's own start is never after a name
    it made."""
    pid = os.getpid()
    stale, fresh = tmp_path / f"tdcn-db-{pid}-0", tmp_path / f"tdcn-db-{pid}-1"
    other = tmp_path / f"tdcn-db-{pid + 1}-0"
    for path in (stale, other):
        path.write_bytes(b"left by a dead process")
    time.sleep(0.05)
    cut = time.time()
    time.sleep(0.05)
    fresh.write_bytes(b"this process's")
    assert remove_stale_doorbells(str(tmp_path), start=cut) == [str(stale)]
    assert not stale.exists() and fresh.exists() and other.exists()
    assert process_start_epoch() <= os.stat(fresh).st_ctime
    assert remove_stale_doorbells(str(tmp_path)) == []
    assert fresh.exists()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_native_update_address_routes_to_the_reborn_endpoint(pkg):
    """Proc 1's first engine dies (destroyed: the corpse) and a reborn
    engine takes its place.  After ``update_address(1, reborn)`` on
    proc 0's engine, a frame sent by proc index through the C engine's
    table reaches the reborn engine, bit for bit, and the reborn engine
    reaches proc 0 back; the install is counted (``addr_installs``)."""
    mod = {"ref": rnative, "port": pnative}[pkg]
    if pkg == "ref":  # the reference's engine crashes on a dead same-pid doorbell
        remove_stale_doorbells()
        start = process_start_epoch()
        assert not [p for p in glob.glob(f"/dev/shm/tdcn-db-{os.getpid()}-*")
                    if os.stat(p).st_ctime < start]
    a, corpse = mod.NativeDcnEngine(0, 2), mod.NativeDcnEngine(1, 2)
    reborn = None
    try:
        for e in (a, corpse):
            e.set_addresses([a.address, corpse.address])
        a._send(1, 7, 0, np.arange(4.0))
        assert np.array_equal(corpse._recv_full(0, 7, 0)[1], np.arange(4.0))
        corpse_address = corpse.address
        corpse.destroy()
        a.note_proc_failed(1)
        reborn = mod.NativeDcnEngine(1, 2)
        reborn.set_addresses([a.address, reborn.address])
        installs = a.stats_snapshot()["addr_installs"]
        a.update_address(1, reborn.address)
        a.note_proc_recovered(1, incarnation=1)
        assert a.stats_snapshot()["addr_installs"] == installs + 1
        assert a.addresses[1] == reborn.address != corpse_address
        assert not a.proc_failed(1)
        x = np.random.default_rng(3).standard_normal(1000)
        assert _send_by_proc(a, 1, "replace.1.i1", x) == 0
        env, got = reborn._recv_full(0, "replace.1.i1", 0, timeout=20.0)
        assert env["src"] == 0 and got.tobytes() == x.tobytes()
        assert _send_by_proc(reborn, 0, "replace.1.i1", x[:3]) == 0
        assert a._recv_full(1, "replace.1.i1", 0, timeout=20.0)[1].tobytes() == x[:3].tobytes()
    finally:
        for e in (a, reborn):
            if e is not None:
                e.destroy()


def test_native_engine_replaces_a_dead_same_pid_processes_names():
    """A SIGKILLed worker leaves its doorbell (``tdcn-db-<pid>-<proc>``)
    in ``/dev/shm``, and pids recycle: a new engine whose process got
    that pid must replace the leftover, not fail to create its doorbell
    and crash its ring poller."""
    stale = [f"/dev/shm/tdcn-db-{os.getpid()}-{proc}" for proc in (0, 1)]
    for path in stale:
        with open(path, "wb") as f:
            f.write(b"left by a dead process")
    a = b = None
    try:
        a, b = pnative.NativeDcnEngine(0, 2), pnative.NativeDcnEngine(1, 2)
        for e in (a, b):
            e.set_addresses([a.address, b.address])
        a._send(1, 9, 0, np.arange(5.0))
        assert b._recv_full(0, 9, 0)[1].tolist() == [0.0, 1.0, 2.0, 3.0, 4.0]
        assert all(os.path.getsize(path) == 4096 for path in stale)  # fresh doorbells
    finally:
        for e in (a, b):
            if e is not None:
                e.destroy()
    assert not any(os.path.exists(path) for path in stale)


def test_native_ring_write_toward_a_failed_proc_gives_up():
    """A survivor's ring write toward a dead consumer: once the ring is
    full, the write waits for space the corpse never frees.  When the
    proc is marked failed, the port's C engine gives the write up at its
    next backstop and the send escalates as ``MPIProcFailedError`` — not
    after ``dcn_ring_timeout`` (30 s here; 600 s by default)."""
    import threading

    from ompi_tpu_torch.core.errors import MPIProcFailedError

    store = pmca.default_context().store
    prev = store.get("dcn_ring_timeout")
    store.set("dcn_ring_timeout", 30.0)
    a = pnative.NativeDcnEngine(0, 2, ring_bytes=1 << 20)
    b = pnative.NativeDcnEngine(1, 2, ring_bytes=1 << 20)
    try:
        for e in (a, b):
            e.set_addresses([a.address, b.address])
        a._send(1, 7, 0, np.arange(4.0))
        assert b._recv_full(0, 7, 0)[1].tolist() == [0.0, 1.0, 2.0, 3.0]
        b.destroy()  # the consumer is gone; its ring fills after 3 records
        mark = threading.Timer(0.5, a.note_proc_failed, (1,))
        mark.start()
        t0 = time.monotonic()
        with pytest.raises(MPIProcFailedError, match="peer proc 1 failed"):
            for seq in range(1, 50):
                a._send(1, 7, seq, np.zeros(300_000 // 8))
        assert time.monotonic() - t0 < 10.0
        mark.join()
    finally:
        store.set("dcn_ring_timeout", prev)
        a.destroy()


# -- a CUDA window whose exporter died ---------------------------------------


def _dead_pid() -> int:
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    child.wait()
    return child.pid


def _cuda_desc(name: str, nbytes: int, pid: int) -> dict:
    """A placed CUDA-window header (the semaphore says the DMA finished)
    and its descriptor; the handle is never opened."""
    from ompi_tpu_torch.dcn import device

    hdr = device.DeviceWindow(name, 0, create=True)
    hdr._ctr[1] = nbytes
    hdr._ctr[0] = device.SEM_DATA
    hdr.close()
    return {"w": name, "n": nbytes, "dt": "<f4", "sh": [nbytes // 4],
            device.KIND_KEY: device.KIND_CUDA, device.IPC_KEY: "00" * 64,
            device.PID_KEY: pid}


def test_dead_exporters_window_is_never_read():
    """A survivor handed the descriptor of a CUDA window whose exporter is
    dead refuses it before opening the handle (``ExporterGone``), unlinks
    the header, and the engine's materialize turns that into a peer
    failure: a plane-health strike, the windows staged toward the dead
    peer reclaimed, and the deadline escalation that raises
    ``MPIProcFailedError``."""
    from multiprocessing import shared_memory

    from ompi_tpu_torch.core.errors import MPIProcFailedError
    from ompi_tpu_torch.dcn import device

    dead = _dead_pid()
    assert device.exporter_alive(os.getpid()) and not device.exporter_alive(dead)
    name = f"tpudev-test-{os.getpid()}-a"
    with pytest.raises(device.ExporterGone, match="is gone"):
        device.receive(_cuda_desc(name, 64, dead))
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name=name)  # the header went with the refusal

    dp = device.DevicePlane(0, min_size=1)
    staged = dp.stage(np.zeros(16, np.uint8), dst_proc=1)
    escalations = []

    def escalate(site, timeout, msg, **kw):
        escalations.append((site, kw["cause"], kw["root_proc"]))
        raise MPIProcFailedError(msg, failed=(kw["failed_rank"],))

    engine = types.SimpleNamespace(_device_plane=dp, _escalate_deadline=escalate)
    try:
        with pytest.raises(MPIProcFailedError):
            device.materialize(engine, _cuda_desc(name + "b", 64, dead), src_root=1)
        assert staged is not None and dp.pending_windows() == 0
        assert dp.stats["device_window_reclaimed"] == 1
        assert escalations == [("device_recv", "exporter_gone", 1)]
        assert dp.health._strikes.get(1) == 1
        # the reborn incarnation's first window is welcome again
        dp.clear_failed(1)
        assert dp.arbitrate(np.zeros(16, np.uint8), 1)
        assert dp.stage(np.zeros(16, np.uint8), dst_proc=1) is not None
    finally:
        dp.close(drain_timeout=0.0)


# -- tpurun --ft --respawn jobs --------------------------------------------

PRELUDE = {
    "port": (
        "import ompi_tpu_torch.api as api\n"
        "from ompi_tpu_torch.api.comm import COLOR_UNDEFINED\n"
        "from ompi_tpu_torch.core.errors import MPIProcFailedError, MPIRevokedError\n"
        "from ompi_tpu_torch.op import SUM\n"
        "w = api.init(device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ompi_tpu')]\n"
        "assert not bad, bad\n"
    ),
    "ref": (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import ompi_tpu.api as api\n"
        "from ompi_tpu.api.comm import COLOR_UNDEFINED\n"
        "from ompi_tpu.core.errors import MPIProcFailedError, MPIRevokedError\n"
        "from ompi_tpu.op import SUM\n"
        "w = api.init()\n"
    ),
}

#: shared by every body: counters, the seeded inputs, the kill
COMMON = r'''
out_dir = sys.argv[1]
p, inc = w.proc, w.procctx.incarnation
print(f"WORKER_PID {os.getpid()}", flush=True)
res = {}


def counters():
    snap = getattr(w.dcn, "stats_snapshot", None)
    st = (snap() if snap is not None else None) or getattr(
        getattr(w.dcn, "transport", None), "stats", None) or {}
    return {k: int(st.get(k, 0)) for k in ("respawns", "reconnects", "retry_dials")}


def die():
    sys.stdout.flush()
    sys.stderr.flush()
    os.kill(os.getpid(), signal.SIGKILL)


def run(comm, tag, data, i, size):
    out = np.asarray(comm.allreduce(data[i][comm.local_offset:comm.local_offset + comm.local_size], SUM))
    res[f"{tag}{i}"] = out
    assert np.allclose(out, data[i][:size].sum(0)), (tag, i)
'''

RESPAWN_BODY = r'''
OPS, KILL_AT, VICTIM = 6, 4, 1
n = w.size
rng = np.random.default_rng(20261017)
PRE, POST = rng.standard_normal((OPS, n, 4)), rng.standard_normal((OPS, n, 4))
comm, completed, recovered = w, 0, False
if w.respawned:
    comm = w.replace()
    recovered = True
else:
    try:
        for i in range(OPS):
            if p == VICTIM and inc == 0 and i == KILL_AT:
                die()
            run(comm, "pre", PRE, i, n)
            completed = i + 1
    except (MPIProcFailedError, MPIRevokedError) as e:
        print(f"[respawn] proc {p} caught {type(e).__name__} after {completed} ops",
              file=sys.stderr, flush=True)
        comm.revoke()
        comm = comm.replace()
        recovered = True
post = 0
for i in range(OPS):
    run(comm, "post", POST, i, comm.size)
    post = i + 1
tally = {"proc": p, "incarnation": inc, "completed": completed, "post": post, "ops": OPS,
         "recovered": recovered, "size": comm.size, "name": comm.name,
         "respawns": counters()["respawns"]}
print("TALLY " + json.dumps(tally, sort_keys=True), flush=True)
np.savez(os.path.join(out_dir, f"{p}.npz"), **res)
api.finalize()
'''

PARTIAL_BODY = r'''
OPS, KILL_AT = 6, 2
assert w.nprocs == 3 and w.local_size == 1
rng = np.random.default_rng(20261018)
PRE, POST = rng.standard_normal((OPS, 2, 4)), rng.standard_normal((OPS, 2, 4))
completed = post = 0
participated, sub = False, None
if w.respawned:
    sub = w.replace_partial()
    participated = True
else:
    sub = w.split([0] if p < 2 else [COLOR_UNDEFINED])[0]
    if p < 2:
        participated = True
        try:
            for i in range(OPS):
                if p == 1 and inc == 0 and i == KILL_AT:
                    die()
                run(sub, "pre", PRE, i, 2)
                completed = i + 1
        except (MPIProcFailedError, MPIRevokedError):
            sub = sub.replace()
if participated:
    for i in range(OPS):
        run(sub, "post", POST, i, 2)
        post = i + 1
    assert sub.size == 2 and sub.nprocs == 2
det = w.procctx.detector
tally = {"proc": p, "incarnation": inc, "participated": participated, "completed": completed,
         "post": post, "ops": OPS, "sub_size": int(sub.size) if participated else 0,
         "sub_name": sub.name if participated else "", **counters(),
         "detector_failed": sorted(det.failed()) if det is not None else []}
print("TALLY " + json.dumps(tally, sort_keys=True), flush=True)
np.savez(os.path.join(out_dir, f"{p}.npz"), **res)
api.finalize()
'''

NESTED_BODY = r'''
OPS, KILL_AT = 4, 2
assert w.nprocs == 3 and w.local_size == 1
rng = np.random.default_rng(20261019)
PRE, POST = rng.standard_normal((OPS, 2, 4)), rng.standard_normal((OPS + 1, 2, 4))
completed = post_b = post_a = 0
participated, sub_a, sub_b = False, None, None
if w.respawned:
    sub_a = w.replace_partial()
    sub_b = w.replace_partial()
    participated = True
else:
    sub_a = w.split([COLOR_UNDEFINED] if p == 0 else [0])[0]
    if p >= 1:
        participated = True
        sub_b = sub_a.split([0])[0]
        assert list(sub_b.group.ranks) == [0, 1], sub_b.group.ranks
        assert [tuple(c) for c in sub_b._world_coords] == [(1, 0), (2, 0)]
        try:
            for i in range(OPS):
                if p == 2 and inc == 0 and i == KILL_AT:
                    die()
                run(sub_b, "pre", PRE, i, 2)
                completed = i + 1
        except (MPIProcFailedError, MPIRevokedError):
            sub_a = sub_a.replace()
            sub_b = sub_b.replace()
if participated:
    for i in range(OPS):
        run(sub_b, "post_b", POST, i, 2)
        post_b = i + 1
    run(sub_a, "post_a", POST, OPS, 2)
    post_a = 1
    assert sub_a.size == 2 and sub_b.size == 2
tally = {"proc": p, "incarnation": inc, "participated": participated, "completed": completed,
         "post_a": post_a, "post_b": post_b, "ops": OPS,
         "names": [getattr(sub_a, "name", ""), getattr(sub_b, "name", "")], **counters()}
print("TALLY " + json.dumps(tally, sort_keys=True), flush=True)
np.savez(os.path.join(out_dir, f"{p}.npz"), **res)
api.finalize()
'''

SHRINK_BODY = r'''
assert w.nprocs == 3
rng = np.random.default_rng(20261020)
X = rng.standard_normal((3, w.size, 5))
run(w, "pre", X, 0, w.size)
if p == 2:
    die()
deadline = time.time() + 30
while time.time() < deadline and 2 * w.local_size not in w.get_failed():
    time.sleep(0.05)
failed = w.get_failed()
try:
    w.allreduce(X[1][w.local_offset:w.local_offset + w.local_size], SUM)
    guard = "none"
except MPIProcFailedError as e:
    guard = type(e).__name__
flags = w.agree(0b1011 if p == 0 else 0b1110)
w.revoke()
small = w.shrink()
assert small.size == 2 * w.local_size and small.nprocs == 2
for i in (1, 2):
    run(small, "post", X, i, small.size)
tally = {"proc": p, "failed": failed, "guard": guard, "agree": flags, "size": small.size,
         "name": small.name, "local_offset": small.local_offset}
print("TALLY " + json.dumps(tally, sort_keys=True), flush=True)
np.savez(os.path.join(out_dir, f"{p}.npz"), **res)
os._exit(0)
'''

BODIES = {"respawn": RESPAWN_BODY, "partial": PARTIAL_BODY, "nested": NESTED_BODY,
          "shrink": SHRINK_BODY}
#: the reference test's short deadlines
DEADLINES = {"dcn_recv_timeout": "8", "dcn_cts_timeout": "8", "dcn_connect_timeout": "4"}


def _ft_job(tmp_path, pkg, body, nprocs, btl="tcp", rsh=False, respawn=True, nranks=1):
    out = tmp_path / f"{pkg}_{body}_{btl}{'_rsh' if rsh else ''}"
    out.mkdir()
    script = out / "worker.py"
    script.write_text("import json\nimport os\nimport signal\nimport sys\nimport time\n\n"
                      "import numpy as np\n\n" + PRELUDE[pkg] + COMMON + BODIES[body])
    if pkg == "port":
        cmd = [sys.executable, "-m", "ompi_tpu_torch", "run", "--nranks", str(nranks)]
    else:
        cmd = [sys.executable, "-m", "ompi_tpu", "run", "--cpu-devices", str(nranks)]
    cmd += ["-np", str(nprocs), "--ft"] + (["--respawn"] if respawn else [])
    if rsh:
        # a fake non-local host forces every rank through the launch
        # agent, an env-scrubbing local shell: the ranks get only the
        # env the rsh payload carries (the bumped incarnation included)
        agent = (f"env -i PATH={os.environ.get('PATH', '/usr/bin:/bin')} "
                 f"HOME={os.path.expanduser('~')} /bin/sh -c {{cmd}}")
        cmd += ["--host", "rsh-shim-host:2", "--kvs-host", "127.0.0.1",
                "--launch-agent", agent]
    if btl:
        cmd += ["--mca", "btl", btl]
    for k, v in DEADLINES.items():
        cmd += ["--mca", k, v]
    cmd += [str(script), str(out)]
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:" + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    t0 = time.monotonic()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=240,
                         cwd=str(REPO), env=env)
    if pkg == "ref":
        # the reference's launcher leaves the shared-memory names of the
        # workers it lost; unlink them as the port's launcher does, or a
        # later process that gets a recycled pid finds them in its way
        from ompi_tpu_torch.boot.tpurun import _unlink_leftovers

        _unlink_leftovers([int(ln.rsplit(" ", 1)[1]) for ln in res.stdout.splitlines()
                           if "WORKER_PID " in ln])
    assert res.returncode == 0, res.stdout[-6000:] + res.stderr[-6000:]
    assert ("respawning (incarnation 1)" in res.stdout) == respawn, res.stdout
    tallies = {t["proc"]: t for t in (json.loads(ln.split("TALLY ", 1)[1])
                                      for ln in res.stdout.splitlines() if "TALLY " in ln)}
    procs = sorted(tallies)
    assert procs == list(range(nprocs if respawn else nprocs - 1)), res.stdout
    return tallies, load(out, nprocs) if respawn else [
        dict(np.load(out / f"{q}.npz")) for q in procs], time.monotonic() - t0


def _both(tmp_path, body, nprocs, port_btl="tcp", rsh=False, **kw):
    ref = _ft_job(tmp_path, "ref", body, nprocs, rsh=rsh, **kw)
    port = _ft_job(tmp_path, "port", body, nprocs, btl=port_btl, rsh=rsh, **kw)
    assert port[0] == ref[0]
    assert_bitwise_equal(port[1], ref[1])
    return port[0]


@pytest.mark.parametrize("port_btl", ["tcp", "native"])
def test_tpurun_respawn_replace_full_size(tmp_path, port_btl):
    """np=2: rank 1 SIGKILLs itself before its fifth allreduce; the
    survivor revokes and replaces, the reborn rank replaces right after
    init, and both finish six more allreduces at size 2.  The port runs
    once on ``btl/tcp`` (as the reference's test) and once on its default
    native plane, whose replace installs the reborn endpoint through
    ``NativeDcnEngine.update_address``."""
    t = _both(tmp_path, "respawn", 2, port_btl=port_btl)
    assert all(x["size"] == 2 and x["post"] == x["ops"] and x["recovered"]
               for x in t.values()), t
    assert t[1]["incarnation"] == 1 and t[0]["completed"] == 4
    assert sum(x["respawns"] for x in t.values()) >= 1, t
    assert t[0]["name"].endswith(".replaced"), t


def test_tpurun_rsh_shim_respawn_replace_full_size(tmp_path):
    t = _both(tmp_path, "respawn", 2, rsh=True)
    assert all(x["size"] == 2 and x["post"] == x["ops"] for x in t.values()), t
    assert t[1]["incarnation"] == 1 and t[1]["recovered"]


def test_tpurun_partial_replace_repairs_members_only(tmp_path):
    t = _both(tmp_path, "partial", 3)
    for p in (0, 1):
        assert t[p]["participated"] and t[p]["sub_size"] == 2, t[p]
        assert t[p]["post"] == t[p]["ops"] and t[p]["sub_name"].endswith(".replaced")
    assert t[0]["respawns"] >= 1 and t[1]["incarnation"] == 1
    b = t[2]
    assert not b["participated"] and b["reconnects"] == b["retry_dials"] == b["respawns"] == 0


def test_tpurun_nested_split_replace_queued_repairs(tmp_path):
    t = _both(tmp_path, "nested", 3)
    for p in (1, 2):
        assert t[p]["participated"] and t[p]["post_b"] == t[p]["ops"] and t[p]["post_a"] == 1
        assert all(n.endswith(".replaced") for n in t[p]["names"]), t[p]
    assert t[2]["incarnation"] == 1 and t[1]["respawns"] >= 1
    assert not t[0]["participated"] and t[0]["reconnects"] == t[0]["retry_dials"] == 0


@pytest.mark.parametrize("port_btl", ["tcp", "native"])
def test_tpurun_shrink_across_processes(tmp_path, port_btl):
    """np=3 × 2 ranks under ``--ft`` without ``--respawn``: process 2
    dies after one allreduce; the survivors detect it, the collective
    guard raises, ``agree`` ANDs their words, and after revoke the
    shrunk 4-rank comm runs two allreduces bit-equal to the reference's
    (float64 sums of four rows, in the same order: each process's two
    rows, then the two processes)."""
    t = _both(tmp_path, "shrink", 3, port_btl=port_btl, respawn=False, nranks=2)
    assert t[0]["failed"] == t[1]["failed"] == [4, 5], t
    assert all(x["guard"] == "MPIProcFailedError" and x["agree"] == 0b1010
               and x["size"] == 4 and x["name"].endswith(".shrunk") for x in t.values()), t
    assert (t[0]["local_offset"], t[1]["local_offset"]) == (0, 2)


# -- the card's recovery worker, rehearsed on the CPU -----------------------


def _ft_smoke(nprocs: int, flags, mode: str) -> tuple[dict, str]:
    cmd = [sys.executable, "-m", "ompi_tpu_torch", "run", "-np", str(nprocs), "--nranks", "4",
           *flags, "--mca", "dcn_device_min_size", "4096",
           str(REPO / "ompi_tpu_torch" / "examples" / "ft_smoke.py"),
           "--mode", mode, "--device", "cpu", "--bytes", "65536"]
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:" + env.get("PYTHONPATH", "")
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=240, cwd=str(REPO),
                         env=env)
    assert res.returncode == 0, res.stdout[-6000:] + res.stderr[-6000:]
    by: dict = {}
    for ln in res.stdout.splitlines():
        if "FTJSON " in ln:
            rec = json.loads(ln.split("FTJSON ", 1)[1])
            by.setdefault(rec.pop("kind"), {})[rec["proc"]] = rec
    return by, res.stdout


def test_ft_smoke_respawn_rehearsal():
    """The card's respawn worker at 64 KiB per rank on the CPU, the device
    plane carrying the DCN leg in shm windows: the SIGKILL lands inside a
    call, ``replace()`` restores 8 ranks, the five calls after it give the
    bits of the five before, the survivor reclaims the window it had
    staged toward the corpse and falls back nowhere, and the launcher
    leaves no shared-memory name of either incarnation."""
    from ompi_tpu_torch.boot.tpurun import _SHM_PREFIXES

    by, out = _ft_smoke(2, ["--ft", "--respawn", "--mca", "metrics_enable", "1"], "respawn")
    assert "respawning (incarnation 1)" in out
    want = by["pre"][0]["digests"][0]
    assert all(d == want for p in (0, 1)
               for d in by["pre"][p]["digests"] + by["post"][p]["digests"])
    rec = by["recovered"]
    assert [rec[p]["size"] for p in (0, 1)] == [8, 8]
    assert [rec[p]["incarnation"] for p in (0, 1)] == [0, 1] and rec[0]["respawns"] == 1
    assert all(rec[p]["heal_ms"] > 0 for p in (0, 1))
    assert all(rec[p]["device"]["device_sends"] > 0 and rec[p]["device"]["device_fallbacks"] == 0
               for p in (0, 1))
    pids = {by["pre"][p]["pid"] for p in (0, 1)} | {rec[p]["pid"] for p in (0, 1)}
    assert len(pids) == 3  # the corpse, its reborn incarnation, the survivor
    prefixes = tuple(f.format(pid) for pid in pids for f in _SHM_PREFIXES)
    assert not [n for n in os.listdir("/dev/shm") if n.startswith(prefixes)]


def test_ft_smoke_shrink_matches_a_fresh_job():
    shrunk, _ = _ft_smoke(3, ["--ft"], "shrink")
    fresh, _ = _ft_smoke(2, [], "fresh")
    assert sorted(shrunk["calls"]) == sorted(fresh["calls"]) == [0, 1]
    for p in (0, 1):
        assert shrunk["calls"][p]["calls"] == fresh["calls"][p]["calls"]
        assert shrunk["shrunk"][p]["failed"] == [8, 9, 10, 11]
        assert shrunk["calls"][p]["size"] == 8 and shrunk["calls"][p]["nprocs"] == 2

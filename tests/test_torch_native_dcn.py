"""The port's native C++ host data plane (``btl/native``) against the
reference's, case by case after ``tests/test_native_dcn.py``.

Each in-process case runs the same scenario on a pair of the reference's
``NativeDcnEngine``s and on a pair of the port's (its own
``libtpudcn.so``, built from ``ompi_tpu_torch/csrc/dcn.cc`` into
``build/ompi_tpu_torch/``) with the same numpy inputs, and compares what
comes out bit for bit: the coll-stream round trip and its meta, the
engine collectives, the C collective fast path's ``recv_into`` placement
and per-op timing rows (merged by each package's straggler profiler),
the C matcher's wildcards and ordering, ring chunking of a 40 MiB
payload, dispatcher control frames, failure wake-up, the transport and
sub/join views, and the framed TCP leg (eager and RTS/CTS rendezvous)
under distinct ``TDCN_HOST_ID``s.  The two libraries share symbol
names; ``ctypes`` loads both ``RTLD_LOCAL``, which keeps them apart.

A mixed pair — one reference engine and one port engine — meets on one
wire over the shared-memory rings and over the TCP leg, in both orders,
and gives the all-reference pair's bits.  Both packages keep their
default device plane on, except in the two cases that measure the host
plane's own handling of large payloads (ring chunking and the TCP leg's
rendezvous), where ``host_plane_only`` turns it off in both.

Launched jobs check the selection: native is the port's default with the
C matcher as the pml, ``--mca btl tcp`` still selects the Python engine,
monitoring keeps the Python pml; and a seeded 400-message storm at np=3
(default ring, and a 1 MiB ring that forces chunked streaming).
"""

import contextlib
import ctypes
import os
import threading
import time

import numpy as np
import pytest

from ompi_tpu.dcn import native as rnative
from ompi_tpu.op import op as rop
from ompi_tpu_torch.dcn import native as pnative
from ompi_tpu_torch.op import op as pop
from torch_mp_common import run_job

NATIVE = {"ref": rnative, "port": pnative}
OPS = {"ref": rop, "port": pop}
RNG = np.random.default_rng(2026)
X = RNG.standard_normal((2, 999))
BIG = RNG.standard_normal((2, 40000))  # 320 KB rows: the ring schedule


@pytest.fixture
def host_plane_only():
    """Both packages' device planes off, for a case that measures how the
    host plane itself carries a payload above the plane's threshold.  The
    var is set on each live default context and restored."""
    from ompi_tpu.core import mca as rmca
    from ompi_tpu_torch.core import mca as pmca

    stores = [m.default_context().store for m in (rmca, pmca)]
    old = [s.get("dcn_device_enable") for s in stores]
    for s in stores:
        s.set("dcn_device_enable", False)
    yield
    for s, v in zip(stores, old):
        s.set("dcn_device_enable", v)


@contextlib.contextmanager
def _host_id(hid):
    old = os.environ.get("TDCN_HOST_ID")
    if hid is not None:
        os.environ["TDCN_HOST_ID"] = hid
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("TDCN_HOST_ID", None)
        else:
            os.environ["TDCN_HOST_ID"] = old


def _engines(pkgs, host_ids=None, **kw):
    """One native engine per entry of ``pkgs`` ("ref"/"port"), addresses
    exchanged; distinct ``host_ids`` put them on the framed TCP leg."""
    engines = []
    for p, pkg in enumerate(pkgs):
        with _host_id(host_ids[p] if host_ids else None):
            engines.append(NATIVE[pkg].NativeDcnEngine(p, len(pkgs), **kw))
    addrs = [e.address for e in engines]
    for e in engines:
        e.set_addresses(addrs)
    return engines


@contextlib.contextmanager
def _pair(pkg, **kw):
    a, b = _engines([pkg, pkg], **kw)
    try:
        yield a, b
    finally:
        a.destroy()
        b.destroy()


def _threads(engines, work):
    out = [None] * len(engines)
    errs = []

    def body(p):
        try:
            out[p] = work(p, engines[p])
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append((p, e))

    ts = [threading.Thread(target=body, args=(p,)) for p in range(len(engines))]
    [t.start() for t in ts]
    [t.join(timeout=60) for t in ts]
    assert not any(t.is_alive() for t in ts), "engine thread hung"
    assert not errs, errs
    return out


def _flat(v):
    if v is None:
        return [b"none"]
    if isinstance(v, (list, tuple)):
        return [x for e in v for x in _flat(e)]
    if isinstance(v, dict):
        return [repr(sorted(v.items())).encode()]
    if isinstance(v, (int, float, str, bool)):
        return [repr(v).encode()]
    a = np.asarray(v)
    return [a.dtype.str.encode(), str(a.shape).encode(), a.tobytes()]


def _both(scenario, **kw):
    """Run ``scenario(pkg, a, b)`` on a reference pair and a port pair;
    the two results must agree bit for bit."""
    got = {}
    for pkg in ("ref", "port"):
        with _pair(pkg, **kw) as (a, b):
            got[pkg] = scenario(pkg, a, b)
    assert _flat(got["port"]) == _flat(got["ref"])
    return got["port"]


def test_library_builds_under_build_and_keeps_the_wire():
    """The port loads its own build (never ``native/build``), with the
    reference's record layout, stats schema and causal-context mirror."""
    from ompi_tpu_torch import native

    lib = pnative.load_library()
    assert pnative.available()
    assert native.LIB.parent.parts[-2:] == ("build", "ompi_tpu_torch")
    assert native.LIB.exists() and native.SRC.name == "dcn.cc"
    rlib = rnative.load_library()
    assert lib.tdcn_stats_names() == rlib.tdcn_stats_names()
    assert lib.tdcn_trace_ctx_fields() == rlib.tdcn_trace_ctx_fields()
    assert ctypes.sizeof(pnative.TdcnMsg) == ctypes.sizeof(rnative.TdcnMsg)
    assert [f[0] for f in pnative.TdcnMsg._fields_] == [f[0] for f in rnative.TdcnMsg._fields_]


def test_coll_stream_roundtrip_and_meta():
    def scenario(pkg, a, b):
        x = np.arange(16, dtype=np.float64).reshape(4, 4)
        a._send(1, 7, 0, x)
        env, got = b._recv_full(0, 7, 0)
        a._send(1, "s#x", 3, np.zeros(0, np.uint8), meta={"k": [1, 2]})
        env2, _ = b._recv_full(0, "s#x", 3)
        assert np.array_equal(got, x) and env["src"] == 0 and env["seq"] == 0
        return [env, got, env2]

    out = _both(scenario)
    assert out[2]["meta"] == {"k": [1, 2]}


def test_engine_collectives_over_native():
    def scenario(pkg, a, b):
        op = OPS[pkg]
        return _threads([a, b], lambda p, e: [
            e.allreduce(X[p], op.SUM, 42, ordered=True),
            e.allreduce(BIG[p], op.SUM, 42),  # above ring_threshold: the ring
            e.bcast(BIG[p], 1, 42),
            e.allgather(X[p], 42),
            e.allgather_obj({"p": p}, 42)])

    out = _both(scenario)
    np.testing.assert_allclose(out[0][0], X.sum(0))


def test_c_coll_recv_into_and_per_op_timing():
    """The C collective fast path: a staggered allgather posts the late
    rank's destination first, so the early rank's block lands straight
    in it (``recv_into_placed``); per-op timing rows surface through the
    straggler profiler's native merge."""
    from ompi_tpu.metrics import straggler as rstrag
    from ompi_tpu_torch.metrics import straggler as pstrag

    strag = {"ref": rstrag, "port": pstrag}
    count, CK_ALLGATHER, DT_DOUBLE = 1 << 15, 4, 14

    def scenario(pkg, a, b):
        strag[pkg].reset()
        for e in (a, b):
            strag[pkg].register_native(e, e.coll_optimes)
        addrs = (ctypes.c_char_p * 2)(a.address.encode(), b.address.encode())
        placed0 = a.stats_snapshot()["recv_into_placed"]

        def run(p, eng):
            time.sleep(0.4 * p)
            cc = eng._lib.tdcn_coll_open(eng._h, b"ri", eng.proc, 2, addrs, 0)
            plan = eng._lib.tdcn_coll_plan(eng._h, cc, CK_ALLGATHER, 0, DT_DOUBLE,
                                           count, 0, -1)
            sb = np.full(count, float(p + 1), np.float64)
            rb = np.zeros(2 * count, np.float64)
            rc = eng._lib.tdcn_coll_start(eng._h, plan, sb.ctypes.data_as(ctypes.c_void_p),
                                          rb.ctypes.data_as(ctypes.c_void_p))
            eng._lib.tdcn_coll_close(eng._h, cc)
            return rc, rb

        out = _threads([a, b], run)
        placed = a.stats_snapshot()["recv_into_placed"] - placed0
        rows = [e.coll_optimes()["allgather"] for e in (a, b)]
        summ = strag[pkg].summary()["allgather"]
        merged = (strag[pkg].op_count("allgather"), summ["provider"], sum(summ["lat_hist"]))
        strag[pkg].zero_stats()
        assert strag[pkg].op_count("allgather") == 0
        strag[pkg].reset()
        return [out, placed >= 1, [(r["count"], r["wait_ns"] > 0, sum(r["lat_hist"]))
                                   for r in rows], merged]

    out = _both(scenario)
    (rc0, rb0), _ = out[0]
    assert rc0 == 0 and np.all(rb0[:count] == 1.0) and np.all(rb0[count:] == 2.0)
    assert out[1:] == [True, [(1, True, 1)] * 2, (2, "cfp", 2)]


def test_matching_engine_wildcards_and_ordering():
    """The C matcher keeps the pml contract: per-source arrival order,
    ANY_SOURCE/ANY_TAG wildcards, probe without consuming, local and
    remote senders in ONE queue."""
    from ompi_tpu.p2p import pml_native as rpml
    from ompi_tpu_torch.p2p import pml_native as ppml

    def scenario(pkg, a, b):
        a.register_native_p2p(99)
        b.register_native_p2p(99)
        ma = {"ref": rpml, "port": ppml}[pkg].NativeMatchingEngine(a, 99, 4)
        b.send_p2p(0, {"cid": 99, "src": 2, "dst": 1, "tag": 5}, np.array([1.0]))
        b.send_p2p(0, {"cid": 99, "src": 2, "dst": 1, "tag": 5}, np.array([2.0]))
        ma.send(0, 1, np.array([3.0]), 5)
        deadline = time.monotonic() + 10
        while ma.pending_unexpected(1) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        st = ma.iprobe(1)
        return [ma.pending_unexpected(1), st.source in (0, 2), st.count,
                ma.irecv(1, 2, 5).wait(), ma.irecv(1, 2, -1).wait(),
                ma.irecv(1, -1, -1).wait(), ma.pending_unexpected(1)]

    assert _both(scenario)[0] == 3


def test_recv_blocking_fast_path_and_recv_into():
    from ompi_tpu.p2p import pml_native as rpml
    from ompi_tpu_torch.p2p import pml_native as ppml

    def scenario(pkg, a, b):
        a.register_native_p2p(7)
        b.register_native_p2p(7)
        ma = {"ref": rpml, "port": ppml}[pkg].NativeMatchingEngine(a, 7, 2)
        b.send_p2p(0, {"cid": 7, "src": 1, "dst": 0, "tag": 9}, np.arange(5, dtype=np.int32))
        payload, st = ma.recv_blocking(0, 1, 9)
        into = np.zeros(5, np.int32)
        b.send_p2p(0, {"cid": 7, "src": 1, "dst": 0, "tag": 10}, np.arange(5, dtype=np.int32) * 3)
        placed, st2 = ma.recv_blocking(0, 1, 10, into=into)
        return [payload, (st.source, st.tag, st.count, st.nbytes), placed is into, into,
                (st2.count, st2.nbytes)]

    out = _both(scenario)
    assert out[1] == (1, 9, 5, 20) and out[2]


def test_large_payload_ring_chunking(host_plane_only):
    """40 MiB through the 64 MiB shared-memory ring: beyond half the ring
    it streams as chunked records; the bytes survive exactly.  The port's
    engine counts the message before it marks the stream done, so the
    sender's stats read right after ``_send`` returns hold it once; the
    reference's counts it after waking the sender, so its count is read
    once both threads have ended."""
    big = RNG.integers(0, 255, size=40 << 20, dtype=np.uint8)

    def scenario(pkg, a, b):
        def work(p, e):
            if p == 1:
                return e._recv_full(0, 11, 0, timeout=60.0)[1]
            e._send(1, 11, 0, big)
            return e.stats_snapshot()

        out = _threads([a, b], work)
        assert np.array_equal(out[1], big)
        if pkg == "port":
            assert (out[0]["chunked_msgs"], out[0]["chunked_bytes"]) == (1, big.nbytes)
        return [a.stats_snapshot()["chunked_msgs"] >= 1]

    assert _both(scenario) == [True]


def test_chunked_count_lands_before_send_returns(host_plane_only):
    """On a 1 MiB ring, 400 sends of 600 KiB each stream as chunked
    records; the sender's stats read as each ``_send`` returns already
    count it (``csrc/dcn.cc`` adds ``TS_CHUNKED_MSGS`` and
    ``TS_CHUNKED_BYTES`` under the stream lock, before ``done``)."""
    msg = RNG.integers(0, 255, size=600 << 10, dtype=np.uint8)
    n = 400
    with _pair("port", ring_bytes=1 << 20) as (a, b):
        def work(p, e):
            if p == 1:
                return [e._recv_full(0, 11, i, timeout=60.0)[1] for i in range(n)]
            seen = []
            for i in range(n):
                e._send(1, 11, i, msg)
                st = e.stats_snapshot()
                seen.append((st["chunked_msgs"], st["chunked_bytes"]))
            return seen

        seen, got = _threads([a, b], work)
    assert all(np.array_equal(g, msg) for g in got)
    assert seen == [(i + 1, (i + 1) * msg.nbytes) for i in range(n)]


def test_py_dispatcher_routes_ctrl_frames():
    def scenario(pkg, a, b):
        seen = {}

        class Det:
            def on_heartbeat(self, src, env=None):
                seen["hb"], seen["env"] = src, env

        b.attach_detector(Det())
        a.send_ctrl(1, {"kind": "hb", "src": 0})
        deadline = time.monotonic() + 10
        while "hb" not in seen and time.monotonic() < deadline:
            time.sleep(0.01)
        return [seen.get("hb"), (seen.get("env") or {}).get("kind")]

    assert _both(scenario) == [0, "hb"]


def test_native_failure_wakes_coll_recv():
    from ompi_tpu.core.errors import MPIProcFailedError as RFailed
    from ompi_tpu_torch.core.errors import MPIProcFailedError as PFailed

    def scenario(pkg, a, b):
        a.note_proc_failed(1)
        t0 = time.monotonic()
        with pytest.raises({"ref": RFailed, "port": PFailed}[pkg]) as err:
            a._recv_full(1, 5, 0, timeout=30.0)
        return [err.value.failed, a.proc_failed(1), time.monotonic() - t0 < 10]

    assert _both(scenario) == [(1,), True, True]


def test_transport_and_sub_engine_views():
    def scenario(pkg, a, b):
        before = a.transport.bytes_sent
        a._send(1, 13, 0, np.zeros(1024, np.uint8))
        b._recv_full(0, 13, 0)
        sa, sb = a.sub([0, 1]), b.sub([0, 1])
        sa._send(1, "sub1", 0, np.array([5], np.int64))
        _, got = sb._recv_full(0, "sub1", 0)
        ja = a.join([a.address, b.address], 0)
        return [a.address.startswith("ntv:"), a.transport.address == a.address,
                a.transport.bytes_sent >= before + 1024, type(sa).__name__, got,
                type(ja).__name__]

    assert _both(scenario)[3:4] == ["NativeSubEngine"]


def test_tcp_leg_eager_and_rendezvous(host_plane_only):
    """Distinct ``TDCN_HOST_ID``s put same-host peers on the framed TCP
    leg: eager frames below the 64 KiB limit here, RTS/CTS/FRAG
    rendezvous above it, and p2p matching over sockets."""
    from ompi_tpu.p2p import pml_native as rpml
    from ompi_tpu_torch.p2p import pml_native as ppml

    small = np.arange(1024, dtype=np.int32)
    big = RNG.integers(0, 255, size=8 << 20, dtype=np.uint8)

    def scenario(pkg, a, b):
        a._send(1, "tcp1", 0, small)
        _, got = b._recv_full(0, "tcp1", 0)
        out = _threads([a, b], lambda p, e: e._send(1, "tcp2", 0, big) if p == 0
                       else e._recv_full(0, "tcp2", 0, timeout=60.0)[1])
        a.register_native_p2p(55)
        b.register_native_p2p(55)
        mb = {"ref": rpml, "port": ppml}[pkg].NativeMatchingEngine(b, 55, 2)
        a.send_p2p(1, {"cid": 55, "src": 0, "dst": 1, "tag": 4}, np.full(3, 9.0))
        payload, st = mb.recv_blocking(1, 0, 4)
        stats = a.stats_snapshot()
        assert np.array_equal(out[1], big)
        return [got, payload, st.nbytes, stats["rndv_msgs"] >= 1, stats["eager_msgs"] >= 1]

    out = _both(scenario, host_ids=["hostA", "hostB"], eager_limit=1 << 16)
    assert out[2:] == [24, True, True]


# -- a mixed pair: one reference engine, one port engine ------------------


@pytest.mark.parametrize("leg", ["ring", "tcp"])
@pytest.mark.parametrize("order", [("ref", "port"), ("port", "ref")], ids=["ref0", "port0"])
def test_mixed_native_job_reference_and_port(leg, order):
    """One reference and one port engine on one wire, over the
    shared-memory rings or the framed TCP leg: collectives in both fold
    orders, a ring allreduce, bcast, allgather, a Python-delivered p2p
    frame and a C-matched p2p message agree with an all-reference pair
    bit for bit."""
    from ompi_tpu.p2p import pml_native as rpml
    from ompi_tpu_torch.p2p import pml_native as ppml

    host_ids = ["hostA", "hostB"] if leg == "tcp" else None

    def work(pkgs):
        def fn(p, e):
            op = OPS[pkgs[p]]
            got = []
            e.register_p2p(9, lambda env, pl: got.append((env, pl)))
            e.register_native_p2p(11)
            pml = {"ref": rpml, "port": ppml}[pkgs[p]].NativeMatchingEngine(e, 11, 2)
            out = [e.allreduce(X[p], op.SUM, 1, ordered=True),
                   e.allreduce(BIG[p], op.SUM, 1),
                   e.allreduce(BIG[p], op.PROD, 1),
                   e.bcast(BIG[p], 0, 1),
                   e.allgather(X[p], 1)]
            e.send_p2p(1 - p, {"cid": 9, "src": p, "dst": 1 - p, "tag": 3, "x": 1}, X[p] * 2)
            e.send_p2p(1 - p, {"cid": 11, "src": p, "dst": 1 - p, "tag": 6}, BIG[p] * 3)
            payload, st = pml.recv_blocking(p, 1 - p, 6)
            e.barrier(1)
            deadline = time.monotonic() + 10
            while not got and time.monotonic() < deadline:
                time.sleep(0.01)
            env, pl = got[0]
            return out + [payload, (st.source, st.tag, st.nbytes), pl,
                          {k: env[k] for k in ("cid", "src", "dst", "tag", "kind")}]

        return fn

    results = {}
    for pkgs in (list(order), ["ref", "ref"]):
        engines = _engines(pkgs, host_ids=host_ids, eager_limit=1 << 16)
        try:
            results[tuple(pkgs)] = _threads(engines, work(pkgs))
        finally:
            for e in engines:
                e.destroy()
    assert [_flat(r) for r in results[tuple(order)]] == [
        _flat(r) for r in results[("ref", "ref")]]


# -- launched jobs --------------------------------------------------------

PROBE = r'''
import numpy as np
import ompi_tpu_torch.api as api
from ompi_tpu_torch.op import SUM

world = api.init(device="cpu")
p = world.proc
print(f"ENGINE {type(world.dcn).__name__} pml={type(world.pml).__name__}", flush=True)
out = world.allreduce(np.ones((world.local_size, 2)), SUM)
assert np.array_equal(out, np.full((world.local_size, 2), world.size))
me, peer = world.local_offset, world.proc_range(1 - p)[0]
if p == 0:
    world.send(np.arange(8.0), source=me, dest=peer, tag=3)
    pay, st = world.recv(dest=me, source=peer, tag=4)
    assert np.array_equal(pay, np.arange(8.0) + 1)
else:
    pay, st = world.recv(dest=me, source=peer, tag=3)
    assert np.array_equal(pay, np.arange(8.0)), pay
    world.send(np.arange(8.0) + 1, source=me, dest=peer, tag=4)
api.finalize()
print(f"OK native_probe proc={p}", flush=True)
'''


@pytest.mark.parametrize("mca,want", [
    ({}, "ENGINE NativeDcnEngine pml=NativeMatchingEngine"),
    ({"btl": "tcp"}, "ENGINE DcnCollEngine pml=MatchingEngine"),
    ({"monitoring_base_enable": "1"}, "ENGINE NativeDcnEngine pml=MonitoredEngine"),
], ids=["default_native", "tcp_selectable", "monitoring_keeps_python_pml"])
def test_engine_selection_under_the_launcher(tmp_path, mca, want):
    """The reference's selection, in a port job: native by default with
    the C matcher; ``--mca btl tcp`` forces the Python engine; an
    interposed pml (monitoring) keeps Python delivery over native."""
    script = tmp_path / "probe.py"
    script.write_text(PROBE)
    res = run_job("port", 2, 1, script, mca=mca, timeout=120)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert res.stdout.count(want) == 2, res.stdout
    assert res.stdout.count("OK native_probe") == 2
    assert "native data plane unavailable" not in res.stderr


STORM = r'''
import numpy as np
import ompi_tpu_torch.api as api

world = api.init(device="cpu")
p, n = world.proc, world.nprocs
assert n == 3 and type(world.dcn).__name__ == "NativeDcnEngine"
SEQ = 400
rng = np.random.default_rng(1234)  # the same schedule on every process
sizes = np.concatenate([rng.integers(1, 256, SEQ // 2), rng.integers(256, 65536, SEQ // 4),
                        rng.integers(65536, 3 << 19, SEQ - SEQ // 2 - SEQ // 4)])
rng.shuffle(sizes)
srcs = rng.integers(0, n, SEQ)
dsts = (srcs + 1 + rng.integers(0, n - 1, SEQ)) % n  # never self


def payload(i, nbytes):
    return (np.arange(nbytes, dtype=np.int64) % 251 + i % 97).astype(np.uint8)


def drain(pending):
    for j in pending:
        got, _ = world.recv(dest=p, source=int(srcs[j]), tag=j)
        assert np.array_equal(np.asarray(got).view(np.uint8).ravel(),
                              payload(j, int(sizes[j]))), f"msg {j} corrupt"
    pending.clear()


pending = []
for i in range(SEQ):
    if int(srcs[i]) == p:
        world.send(payload(i, int(sizes[i])), source=p, dest=int(dsts[i]), tag=i)
    if int(dsts[i]) == p:
        pending.append(i)
    if len(pending) >= 8:
        drain(pending)
drain(pending)
world.barrier()
# wildcard storm: ANY_SOURCE/ANY_TAG receives against a ring of senders
K = 60
for i in range(K):
    world.send(payload(1000 + i, 64 + 997 * i % 4096), source=p, dest=(p + 1) % n, tag=500 + i)
seen = set()
for _ in range(K):
    got, st = world.recv(dest=p, source=None, tag=None)
    i = st.tag - 500
    assert st.source == (p - 1) % n and 0 <= i < K
    assert np.array_equal(np.asarray(got).view(np.uint8).ravel(),
                          payload(1000 + i, 64 + 997 * i % 4096))
    seen.add(st.tag)
assert len(seen) == K
world.barrier()
api.finalize()
print(f"OK storm proc={p}", flush=True)
'''


@pytest.mark.parametrize("ring_kib", [None, 1024])
def test_native_message_storm(tmp_path, ring_kib):
    """400 seeded messages of 1 B–1.5 MiB between random peers at np=3
    with every byte checked, then a wildcard storm.  The 1 MiB ring
    sends messages above 512 KiB as chunked records under ring-full
    backpressure."""
    script = tmp_path / "storm.py"
    script.write_text(STORM)
    mca = {} if ring_kib is None else {"btl_native_ring_bytes": str(ring_kib * 1024)}
    res = run_job("port", 3, 1, script, mca=mca, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert res.stdout.count("OK storm") == 3

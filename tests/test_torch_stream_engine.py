"""The port's streaming large-message send engine (``csrc/dcn.cc``'s
pipelined ring path, bound by ``ompi_tpu_torch/dcn/native.py``) — the
reference's cases (``tests/test_stream_engine.py``) on the port, with the
values they yield held to the reference engine's on the same inputs.

Covers the osu_bw-collapse fix end to end: windowed nonblocking bursts
must pipeline (monotone bandwidth through 4 MiB, never below the
unwindowed rate's collapse ratio), doorbell wakes must coalesce while
the consumer is busy, zero-copy send descriptors must collect through
the wait/test/forget surface, reassembly xids must never cross-corrupt
concurrent large sends, in-place placement must land posted recvs in
the user buffer, MPI non-overtaking must survive round-robin chunk
interleaving, and a mid-stream connkill on the socket plane must not
disturb exactly-once ring delivery.  Plus the append-only
TdcnStats/NATIVE_COUNTERS tail-extension contract.
"""

import ctypes
import threading
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(
    not (REPO / "ompi_tpu_torch" / "csrc" / "dcn.cc").is_file(),
    reason="ompi_tpu_torch/csrc/dcn.cc missing"
)


def _native():
    from ompi_tpu_torch.dcn import native

    if not native.available():
        pytest.skip("no C++ toolchain for libtpudcn")
    return native


@pytest.fixture()
def engine_pair():
    native = _native()
    a = native.NativeDcnEngine(0, 2)
    b = native.NativeDcnEngine(1, 2)
    addrs = [a.address, b.address]
    a.set_addresses(addrs)
    b.set_addresses(addrs)
    yield a, b
    a.close()
    b.close()


def _stats(eng):
    return eng.stats_snapshot()


def _recv_p2p(eng, cid, dst, src, tag, timeout=30.0):
    import sys

    # the engine's own package's message struct (ctypes checks it)
    TdcnMsg = sys.modules[type(eng).__module__].TdcnMsg
    lib, h = eng._lib, eng._h
    rid = lib.tdcn_post_recv(h, str(cid).encode(), dst, src, tag)
    msg = TdcnMsg()
    rc = lib.tdcn_req_wait(h, rid, timeout, ctypes.byref(msg))
    assert rc == 0, f"req_wait rc={rc} (cid={cid}, tag={tag})"
    return msg


def _payload_bytes(lib, msg):
    out = bytes(
        (ctypes.c_char * msg.nbytes).from_address(msg.data)
    ) if msg.nbytes else b""
    if msg.data:
        lib.tdcn_free(msg.data)
    if msg.meta:
        lib.tdcn_free(msg.meta)
    return out


# -- schema: append-only tail extension ---------------------------------

#: the frozen pre-streaming prefix of the v1 counter block — the tails
#: may only APPEND after these (cached pvar indices stay valid)
_FROZEN_V1_PREFIX = (
    "doorbells", "stall_ns", "ring_stall_ns", "ring_stalls", "ring_hwm",
    "cts_wait_ns", "cts_waits", "rndv_depth", "rndv_hwm", "slot_waits",
    "eager_msgs", "eager_bytes", "chunked_msgs", "chunked_bytes",
    "rndv_msgs", "rndv_bytes", "delivered", "unexpected_hwm",
    "reconnects", "retry_dials", "retry_sends", "deadline_expired",
    "injected_faults", "dedup_drops", "respawns",
)

_STREAM_TAIL = (
    "doorbells_suppressed", "stream_msgs", "stream_bytes",
    "stream_depth", "stream_depth_hwm", "stream_inflight",
    "stream_inflight_hwm", "chunk_shrinks", "sender_yields",
    "enqueue_waits",
)

#: dispatch-floor tail: appended AFTER the streaming tail —
#: the frozen prefix and the streaming tail stay byte-identical
_DISPATCH_TAIL = (
    "coll_fastpath_ops", "sched_cache_hits", "sched_cache_misses",
    "recv_into_placed",
)

#: modex tail: sharded-modex address-install accounting (the np>=16
#: native-boot proof reads addr_installs <= group size, not P-1)
_MODEX_TAIL = ("addr_installs", "addr_lazy_resolved")

#: device tail: the device-resident zero-copy plane's counters
#: (maintained by the Python DevicePlane provider; the C block keeps
#: zeroed slots so the name table stays the single schema truth)
_DEVICE_TAIL = (
    "device_sends", "device_recvs", "device_bytes_placed",
    "device_dma_waits", "device_dma_wait_ns",
    "device_arb_device", "device_arb_host", "device_fallbacks",
    # window-reclaim tail (appended; version stays 1): windows
    # force-retired on a peer-failure mark (the RTS-to-consume leak)
    "device_window_reclaimed",
)

#: plane-health tail: the per-(peer, plane) failover state machine's
#: demote/promote/heal-probe counts (dcn/device.py PlaneHealth)
_PLANE_TAIL = ("plane_demotions", "plane_promotions", "plane_heal_probes")

#: serving-plane tail: the tpud daemon's job counters (serve/queue.py
#: JobQueue; daemon-owned — the C block keeps zeroed slots so the name
#: table stays the single schema truth; jobs_concurrent_hwm max-merges)
_JOBS_TAIL = ("jobs_concurrent_hwm", "jobs_shed",
              "jobs_deadline_expired", "jobs_retried")

#: hang-diagnosis tail: the mesh doctor's capture counts
#: (trace/waitgraph.py; Python-owned — the C block keeps zeroed slots)
_HANG_TAIL = ("hang_snapshots", "hang_reports")


def test_stats_tail_appended_not_reordered():
    native = _native()
    from ompi_tpu_torch.metrics import core as mcore

    from ompi_tpu.dcn import native as ref_native

    lib = native.load_library()
    names = lib.tdcn_stats_names().decode().split(",")
    # the port's C name table is the reference engine's, name for name
    assert names == ref_native.load_library().tdcn_stats_names().decode().split(",")
    assert names[0] == "version"
    assert tuple(names[1:]) == mcore.NATIVE_COUNTERS
    # append-only: the frozen prefix survives byte-for-byte, each later
    # tail follows in order, and the C version stamp stays 1
    assert tuple(names[1:1 + len(_FROZEN_V1_PREFIX)]) == _FROZEN_V1_PREFIX
    n0 = 1 + len(_FROZEN_V1_PREFIX)
    assert tuple(names[n0:n0 + len(_STREAM_TAIL)]) == _STREAM_TAIL
    n1 = n0 + len(_STREAM_TAIL)
    assert tuple(names[n1:n1 + len(_DISPATCH_TAIL)]) == _DISPATCH_TAIL
    n2 = n1 + len(_DISPATCH_TAIL)
    assert tuple(names[n2:n2 + len(_MODEX_TAIL)]) == _MODEX_TAIL
    n3 = n2 + len(_MODEX_TAIL)
    assert tuple(names[n3:n3 + len(_DEVICE_TAIL)]) == _DEVICE_TAIL
    n4 = n3 + len(_DEVICE_TAIL)
    assert tuple(names[n4:n4 + len(_PLANE_TAIL)]) == _PLANE_TAIL
    n5 = n4 + len(_PLANE_TAIL)
    assert tuple(names[n5:n5 + len(_JOBS_TAIL)]) == _JOBS_TAIL
    assert tuple(names[n5 + len(_JOBS_TAIL):]) == _HANG_TAIL
    assert mcore.NATIVE_STATS_VERSION == 1
    # gauges classified so monotonicity checks skip them
    assert {"stream_depth", "stream_inflight"} <= set(mcore.GAUGES)


def test_transport_vars_reach_engine(engine_pair):
    a, _ = engine_pair
    # defaults forwarded at construction (TRANSPORT_VARS): just probe
    # the setter round-trips without touching the hot path
    a._lib.tdcn_set_stream(a._h, 128 << 10, 8 << 20, 1)
    a._lib.tdcn_set_stream(a._h, 512 << 10, 32 << 20, 1)


# -- pipelining / coalescing -------------------------------------------


def _windowed_burst(a, b, nbytes, window, tag0, copy=0, verify=True,
                    drain_first=False):
    """Issue `window` nonblocking sends a->b and drain them on b;
    returns the elapsed seconds.  verify=False keeps Python byte
    conversion out of the timed region (bandwidth-shape runs);
    drain_first starts the draining thread before the clock, as a
    blocking burst's is, instead of after the sends are issued."""
    lib = a._lib
    chan = a.chan_open(b.address, "bw")
    src = np.arange(nbytes, dtype=np.int64).astype(np.uint8) + (tag0 % 7)
    done = {}

    def drain():
        for w in range(window):
            msg = _recv_p2p(b, "bw", 1, 0, tag0 + w)
            if verify:
                done[w] = _payload_bytes(lib, msg)
            else:
                if msg.data:
                    lib.tdcn_free(msg.data)
                if msg.meta:
                    lib.tdcn_free(msg.meta)

    t = threading.Thread(target=drain)
    if drain_first:
        t.start()
    t0 = time.perf_counter()
    sreqs = []
    for w in range(window):
        r = lib.tdcn_chan_isend1(
            a._h, chan, 1, 0, 1, tag0 + w, b"|u1", nbytes,
            src.ctypes.data_as(ctypes.c_void_p), nbytes, copy)
        assert r >= 0, r
        if r > 0:
            sreqs.append(r)
    if not drain_first:
        t.start()
    for r in sreqs:
        while True:
            w = lib.tdcn_send_wait(a._h, r, 30.0)
            if w != 1:
                break
        assert w == 0, w
    t.join(60)
    assert not t.is_alive()
    dt = time.perf_counter() - t0
    if verify:
        expected = bytes(src)
        for w in range(window):
            assert done[w] == expected, \
                f"payload corrupt at window slot {w}"
    a.chan_close(chan)
    return dt


@pytest.mark.slow
def test_windowed_streaming_matches_serial_rate(engine_pair):
    """The collapse, size-matched so the box's cache hierarchy cancels
    out: a windowed burst of 4 MiB zero-copy isends (the pipelined
    engine) must run in the same neighborhood as the SAME bytes sent
    as sequential blocking records — the pre-fix engine sat a multiple
    below it (the windowed path serialized through ring backpressure
    round-trips per message).  Best-of-3 each; 2-core CI box.  The
    trials alternate (windowed, blocking, three times) so that both
    forms see the same load on a shared host, each form's draining
    thread is running before its clock starts, and one untimed burst of
    each form first pays the pair's one-time costs (the rings' first
    mapping and page touches), which belong to neither form's rate."""
    a, b = engine_pair
    nbytes, window = 4 << 20, 8
    lib = a._lib

    def blocking_burst():
        chan = a.chan_open(b.address, "bw")
        src = np.zeros(nbytes, np.uint8)
        done = threading.Event()

        def drain():
            for w in range(window):
                msg = _recv_p2p(b, "bw", 1, 0, 4000 + w)
                if msg.data:
                    lib.tdcn_free(msg.data)
                if msg.meta:
                    lib.tdcn_free(msg.meta)
            done.set()

        t = threading.Thread(target=drain)
        t.start()
        t0 = time.perf_counter()
        for w in range(window):
            rc = lib.tdcn_chan_send1(
                a._h, chan, 1, 0, 1, 4000 + w, b"|u1", nbytes,
                src.ctypes.data_as(ctypes.c_void_p), nbytes)
            assert rc == 0, rc
        assert done.wait(60)
        dt = time.perf_counter() - t0
        t.join(10)
        a.chan_close(chan)
        return dt

    _windowed_burst(a, b, nbytes, window, tag0=1000, verify=False, drain_first=True)
    blocking_burst()
    streams, serials = [], []
    for _ in range(3):
        streams.append(_windowed_burst(a, b, nbytes, window, tag0=1000,
                                       verify=False, drain_first=True))
        serials.append(blocking_burst())
    stream, serial = min(streams), min(serials)
    # pre-fix ratio was ~0.25-0.4x; the pipelined engine holds >= the
    # serial rate, 0.55 is the CI load-tolerance floor
    assert stream <= serial / 0.55, (stream, serial)


def test_windowed_burst_pipelines_and_coalesces(engine_pair):
    """The core engine contract, timing-free: a windowed burst of
    larger-than-chunk messages routes through the pipelined sender
    (stream_msgs), suppresses doorbell wakes while the consumer is
    busy (doorbells_suppressed), and delivers every payload intact."""
    a, b = engine_pair
    before = _stats(a)
    _windowed_burst(a, b, 2 << 20, 8, tag0=2000)
    after = _stats(a)
    assert after["stream_msgs"] - before["stream_msgs"] >= 8
    assert after["stream_bytes"] - before["stream_bytes"] >= 8 * (2 << 20)
    # the coalescing engaged: wakes were suppressed while the consumer
    # was busy.  (Whether suppression DOMINATES depends on scheduling
    # luck on a 2-core box — the recorded bench leg tracks the ratio.)
    assert after["doorbells_suppressed"] > before["doorbells_suppressed"]


def test_windowed_burst_counters_match_reference():
    """The same windowed burst through the port's engine pair and the
    reference's (one pair at a time: two engines of one proc index in a
    process share their shm names) streams the same messages and bytes
    and delivers the same payloads."""
    from ompi_tpu.dcn import native as ref_native

    port_native = _native()
    deltas = []
    for mod in (port_native, ref_native):
        a = mod.NativeDcnEngine(0, 2)
        b = mod.NativeDcnEngine(1, 2)
        try:
            addrs = [a.address, b.address]
            a.set_addresses(addrs)
            b.set_addresses(addrs)
            before = _stats(a)
            _windowed_burst(a, b, 2 << 20, 8, tag0=2100)
            after = _stats(a)
            deltas.append({k: after[k] - before[k]
                           for k in ("stream_msgs", "stream_bytes")})
        finally:
            a.close()
            b.close()
    assert deltas[0] == deltas[1]
    assert deltas[0]["stream_bytes"] >= 8 * (2 << 20)


def test_buffered_isend_completes_locally(engine_pair):
    """copy=1 (the Python chan_isend mode): rc == 0, no handle, engine
    owns the payload — the source can be scribbled immediately."""
    a, b = engine_pair
    lib = a._lib
    chan = a.chan_open(b.address, "buf")
    arr = np.full(1 << 20, 7, np.uint8)
    r = lib.tdcn_chan_isend1(a._h, chan, 1, 0, 1, 5, b"|u1", arr.nbytes,
                             arr.ctypes.data_as(ctypes.c_void_p),
                             arr.nbytes, 1)
    assert r == 0
    arr[:] = 99  # engine copied: mutation must not reach the receiver
    msg = _recv_p2p(b, "buf", 1, 0, 5)
    got = _payload_bytes(lib, msg)
    assert got == b"\x07" * (1 << 20)
    a.chan_close(chan)


def test_send_test_and_forget_surface(engine_pair):
    a, b = engine_pair
    lib = a._lib
    chan = a.chan_open(b.address, "tf")
    arr = np.full(2 << 20, 3, np.uint8)
    r = lib.tdcn_chan_isend1(a._h, chan, 1, 0, 1, 1, b"|u1", arr.nbytes,
                             arr.ctypes.data_as(ctypes.c_void_p),
                             arr.nbytes, 0)
    assert r > 0  # zero-copy: a live descriptor handle
    # poll until collected (tdcn_send_test frees on terminal rc)
    deadline = time.time() + 30
    while True:
        t = lib.tdcn_send_test(a._h, r)
        if t != 1:
            break
        assert time.time() < deadline
        time.sleep(0.001)
    assert t == 0
    msg = _recv_p2p(b, "tf", 1, 0, 1)
    assert _payload_bytes(lib, msg) == b"\x03" * (2 << 20)
    # forget: the engine reclaims the descriptor in the background
    r2 = lib.tdcn_chan_isend1(a._h, chan, 1, 0, 1, 2, b"|u1", arr.nbytes,
                              arr.ctypes.data_as(ctypes.c_void_p),
                              arr.nbytes, 0)
    assert r2 >= 0
    if r2:
        lib.tdcn_send_forget(a._h, r2)
    msg = _recv_p2p(b, "tf", 1, 0, 2)
    assert _payload_bytes(lib, msg) == b"\x03" * (2 << 20)
    a.chan_close(chan)


# -- correctness: xid, ordering, in-place, exactly-once -----------------


def test_concurrent_large_sends_never_cross_corrupt(engine_pair):
    """The xid-collision satellite: the old reassembly key was
    now_ns() ^ (proc << 56), which two same-nanosecond large sends to
    one peer could collide on and interleave their FRAGs into each
    other's buffers.  Eight threads blast distinct-pattern multi-chunk
    payloads at one peer; every delivered payload must be whole."""
    a, b = engine_pair
    nthreads, nbytes, per = 8, 1 << 20, 4
    errs = []

    def sender(t):
        try:
            arr = np.full(nbytes, 16 + t, np.uint8)
            for i in range(per):
                a.send_p2p(1, {"cid": "xid", "src": 0, "dst": 1,
                               "tag": 100 * t + i}, arr)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    a.register_native_p2p("xid")
    b.register_native_p2p("xid")
    threads = [threading.Thread(target=sender, args=(t,))
               for t in range(nthreads)]
    for t in threads:
        t.start()
    lib = b._lib
    for t in range(nthreads):
        for i in range(per):
            msg = _recv_p2p(b, "xid", 1, 0, 100 * t + i)
            got = _payload_bytes(lib, msg)
            assert got == bytes([16 + t]) * nbytes, \
                f"cross-corrupted payload (thread {t}, msg {i})"
    for t in threads:
        t.join(30)
    assert not errs


def test_small_send_never_overtakes_queued_stream(engine_pair):
    """MPI non-overtaking across the stream queue: a wildcard-tag recv
    must match the big streamed message first even though the small
    one could finish its single record long before the stream."""
    a, b = engine_pair
    lib = a._lib
    chan = a.chan_open(b.address, "ord")
    big = np.full(8 << 20, 1, np.uint8)
    small = np.full(64, 2, np.uint8)
    r1 = lib.tdcn_chan_isend1(a._h, chan, 1, 0, 1, 900, b"|u1",
                              big.nbytes,
                              big.ctypes.data_as(ctypes.c_void_p),
                              big.nbytes, 0)
    assert r1 >= 0
    r2 = lib.tdcn_chan_isend1(a._h, chan, 1, 0, 1, 901, b"|u1", 64,
                              small.ctypes.data_as(ctypes.c_void_p),
                              64, 0)
    assert r2 >= 0
    first = _recv_p2p(b, "ord", 1, 0, -1)
    assert first.tag == 900 and first.nbytes == big.nbytes
    _payload_bytes(lib, first)
    second = _recv_p2p(b, "ord", 1, 0, -1)
    assert second.tag == 901
    _payload_bytes(lib, second)
    for r in (r1, r2):
        if r:
            while lib.tdcn_send_wait(a._h, r, 30.0) == 1:
                pass
    a.chan_close(chan)


def test_in_place_placement_lands_in_posted_buffer(engine_pair):
    """tdcn_post_recv_into + streaming RTS: the payload must land
    straight in the caller's buffer (pointer-equal delivery) — the
    receive-side half of the windowed fix (no reassembly malloc, no
    delivery copy)."""
    from ompi_tpu_torch.dcn.native import TdcnMsg

    a, b = engine_pair
    lib = a._lib
    chan = a.chan_open(b.address, "inp")
    nbytes = 2 << 20
    dst = np.zeros(nbytes, np.uint8)
    rid = lib.tdcn_post_recv_into(
        b._h, b"inp", 1, 0, 77,
        dst.ctypes.data_as(ctypes.c_void_p), nbytes)
    arr = np.frombuffer(bytes(range(256)) * (nbytes // 256), np.uint8)
    r = lib.tdcn_chan_isend1(a._h, chan, 1, 0, 1, 77, b"|u1", nbytes,
                             arr.ctypes.data_as(ctypes.c_void_p),
                             nbytes, 0)
    assert r >= 0
    msg = TdcnMsg()
    rc = lib.tdcn_req_wait(b._h, rid, 30.0, ctypes.byref(msg))
    assert rc == 0
    assert msg.data == dst.ctypes.data, \
        "posted-buffer recv did not take the in-place path"
    assert bytes(dst) == bytes(arr)
    if r:
        while lib.tdcn_send_wait(a._h, r, 30.0) == 1:
            pass
    a.chan_close(chan)


def test_np2_windowed_sweep_acceptance():
    """np=2 tpurun acceptance (the osu_bw collapse, end to end through
    the C shim): windowed bandwidth stays in the unwindowed rate's
    neighborhood instead of collapsing a multiple below it (pre-fix:
    0.22x), stays monotone-with-noise-margin through 4 MiB, and the
    doorbell coalescing provably suppressed wakes."""
    import json
    import os
    import subprocess
    import sys

    if (os.cpu_count() or 1) < 2:
        # the windowed/serial comparison measures producer-consumer
        # OVERLAP: with one core the threads timeshare and the windowed
        # leg sits at the pre-fix ratio by construction (verified: the
        # pre-streaming baseline engine collapses identically on a 1-core
        # window) — there is nothing to regress-test without a second
        # core, exactly like the absolute native perf ceilings
        pytest.skip("windowed-vs-serial overlap needs >= 2 cores")

    _native()
    from ompi_tpu_torch import native as nat

    # the reference's benchmark source, built against the port's
    # libtpumpi into the port's build tree (never under native/)
    binary = nat.compile_mpi_program(
        REPO / "native" / "bench" / "osu_bw_sweep.c",
        nat.BIN_DIR / "osu_bw_sweep")
    env = dict(os.environ, PYTHONPATH=f"{REPO}:" + os.environ.get("PYTHONPATH", ""))

    def attempt():
        res = subprocess.run(
            [sys.executable, "-m", "ompi_tpu_torch", "run", "-np", "2",
             "--cpu", "--nranks", "1", str(binary), str(4 << 20), "32", "3"],
            capture_output=True, timeout=420, cwd=str(REPO), env=env)
        out = res.stdout.decode()
        assert res.returncode == 0, f"{out}\n{res.stderr.decode()}"
        line = [ln for ln in out.splitlines() if "SWEEP " in ln]
        assert line, out
        sweep = json.loads(line[0].split("SWEEP ", 1)[1])
        rows = {r["bytes"]: r for r in sweep["rows"]}
        assert set(rows) == {64 << 10, 256 << 10, 1 << 20, 4 << 20}
        # the coalescing fix measurably engaged on the windowed legs —
        # deterministic, no retry needed for this one
        supp = sum(r["win_counters"]["doorbells_suppressed"]
                   for r in sweep["rows"])
        assert supp > 0, sweep
        # no collapse, size-matched so box cache effects cancel: the
        # windowed rate must not sit a MULTIPLE below the unwindowed
        # rate at the same size (pre-fix ratio ~0.22 at 4 MiB;
        # post-fix the pipeline typically EXCEEDS 1.0 — 0.6 is the
        # 2-core noise floor).  Cross-size monotonicity is tracked in
        # the recorded bench leg where medians make it meaningful.
        big = rows[4 << 20]
        return big["win_MBs"] >= 0.6 * big["unwin_MBs"], rows

    # single rows swing ~3x on a loaded 2-core CI box: best of three
    # attempts (the deterministic criteria inside attempt() always
    # hold; only the bandwidth ratio needs the retries)
    ok, rows = attempt()
    for _ in range(2):
        if ok:
            break
        ok, rows = attempt()
    assert ok, rows


def test_connkill_mid_stream_keeps_ring_exactly_once(engine_pair):
    """Faultsim's connkill severs the peer SOCKET mid-burst; the
    pipelined ring path must neither lose nor duplicate a message
    (the socket only carries setup/CTS for same-host peers)."""
    a, b = engine_pair
    lib = a._lib
    chan = a.chan_open(b.address, "ck")
    arr = np.full(1 << 20, 5, np.uint8)
    n = 12
    sreqs = []
    for i in range(n):
        r = lib.tdcn_chan_isend1(a._h, chan, 1, 0, 1, 300 + i, b"|u1",
                                 arr.nbytes,
                                 arr.ctypes.data_as(ctypes.c_void_p),
                                 arr.nbytes, 0)
        assert r >= 0
        if r:
            sreqs.append(r)
        if i == 3:  # mid-stream: sever the socket plane
            lib.tdcn_chan_kill(a._h, chan)
    seen = 0
    for i in range(n):
        msg = _recv_p2p(b, "ck", 1, 0, 300 + i)
        assert _payload_bytes(lib, msg) == b"\x05" * (1 << 20)
        seen += 1
    assert seen == n
    # exactly-once: nothing extra is sitting unexpected
    assert lib.tdcn_pending(b._h, b"ck", 1, 0) == 0
    for r in sreqs:
        while lib.tdcn_send_wait(a._h, r, 30.0) == 1:
            pass
    a.chan_close(chan)


# -- dispatch-floor PR: order-gate + recv_into regressions --------------


def test_bufferless_reservation_consumes_order_gate(engine_pair):
    """The recorded stall risk: a BUFFER-LESS posted recv matched by
    an in-order streaming RTS must still consume its order-gate slot —
    otherwise the recv_into placement queued BEHIND it (whose
    completion bypasses the gate via the fill path) parks forever and
    the stream deadlocks."""
    a, b = engine_pair
    lib = a._lib
    from ompi_tpu_torch.dcn.native import TdcnMsg

    lib.tdcn_set_stream(a._h, 64 << 10, 32 << 20, 1)  # force chunking
    nbytes = 256 << 10
    # post BOTH receives before any byte moves: rid1 buffer-less, rid2
    # carrying its destination buffer
    rid1 = lib.tdcn_post_recv(b._h, b"og", 1, 0, 1)
    buf2 = np.zeros(nbytes, np.uint8)
    rid2 = lib.tdcn_post_recv_into(
        b._h, b"og", 1, 0, 2, buf2.ctypes.data_as(ctypes.c_void_p),
        buf2.nbytes)
    s0 = _stats(b)
    chan = a.chan_open(b.address, "og")
    m1 = np.full(nbytes, 7, np.uint8)
    m2 = np.arange(nbytes, dtype=np.int64).astype(np.uint8)
    for tag, arr in ((1, m1), (2, m2)):
        r = lib.tdcn_chan_isend1(a._h, chan, 1, 0, 1, tag, b"|u1",
                                 arr.nbytes,
                                 arr.ctypes.data_as(ctypes.c_void_p),
                                 arr.nbytes, 1)  # buffered
        assert r == 0
    msg = TdcnMsg()
    rc = lib.tdcn_req_wait(b._h, rid1, 30.0, ctypes.byref(msg))
    assert rc == 0
    assert _payload_bytes(lib, msg) == bytes(m1)
    msg2 = TdcnMsg()
    rc = lib.tdcn_req_wait(b._h, rid2, 30.0, ctypes.byref(msg2))
    assert rc == 0, "recv_into behind a buffer-less reservation wedged"
    # in-place: the payload IS the posted buffer (no copy, no free)
    assert msg2.data == buf2.ctypes.data
    np.testing.assert_array_equal(buf2, m2)
    s1 = _stats(b)
    assert s1["recv_into_placed"] > s0.get("recv_into_placed", 0)
    a.chan_close(chan)


def test_precv_reserved_survives_timeout(engine_pair):
    """The copy-path stall fix: a buffer-less tdcn_precv whose posted
    recv was RESERVED by an in-order RTS (the MPI match happened; the
    order-gate slot is consumed) must NOT withdraw on its timeout —
    the old withdraw orphaned the in-flight transfer, lost the
    message, and wedged the caller's retry forever."""
    a, b = engine_pair
    lib = a._lib
    from ompi_tpu_torch.dcn.native import TdcnMsg

    lib.tdcn_set_stream(a._h, 128 << 10, 32 << 20, 1)
    # stall every ring write 25 ms: the RTS lands (and reserves) well
    # inside the precv's 100 ms timeout, the transfer completes well
    # after it — the timeout deterministically fires mid-reservation
    lib.tdcn_fault_set(25_000_000, 1, -1)
    try:
        nbytes = 1 << 20
        arr = np.full(nbytes, 9, np.uint8)
        res = {}

        def rx():
            msg = TdcnMsg()
            rc = lib.tdcn_precv(b._h, b"pr", 1, 0, 7, -1, 0.1,
                                ctypes.byref(msg))
            res["rc"] = rc
            if rc == 0:
                res["data"] = _payload_bytes(lib, msg)

        t = threading.Thread(target=rx)
        t.start()
        time.sleep(0.02)  # the recv is posted before the RTS arrives
        chan = a.chan_open(b.address, "pr")
        r = lib.tdcn_chan_isend1(a._h, chan, 1, 0, 1, 7, b"|u1",
                                 arr.nbytes,
                                 arr.ctypes.data_as(ctypes.c_void_p),
                                 arr.nbytes, 1)
        assert r == 0
        t.join(timeout=30)
        assert not t.is_alive(), "reserved precv never completed"
        assert res["rc"] == 0, (
            f"reserved precv returned rc={res['rc']} (message lost)")
        assert res["data"] == bytes(arr)
        a.chan_close(chan)
    finally:
        lib.tdcn_fault_set(0, 0, -1)


def test_precv_into_copy_path_lands_in_buffer(engine_pair):
    """tdcn_precv_into: the destination buffer rides the call — an
    unexpected-queue match is memcpy'd into it in C (data == buf tells
    the caller nothing is left to copy or free), and a too-small
    buffer keeps the engine-owned payload for truncation handling."""
    a, b = engine_pair
    lib = a._lib
    from ompi_tpu_torch.dcn.native import TdcnMsg

    chan = a.chan_open(b.address, "pi")
    arr = np.arange(64, dtype=np.uint8)
    assert lib.tdcn_chan_send1(a._h, chan, 1, 0, 1, 5, b"|u1", 64,
                               arr.ctypes.data_as(ctypes.c_void_p),
                               64) == 0
    # wait for the unexpected arrival, then receive into a buffer
    deadline = time.monotonic() + 10
    while (lib.tdcn_pending(b._h, b"pi", 1, 0) == 0
           and time.monotonic() < deadline):
        time.sleep(0.005)
    dst = np.zeros(64, np.uint8)
    msg = TdcnMsg()
    rc = lib.tdcn_precv_into(b._h, b"pi", 1, 0, 5, -1, 10.0,
                             dst.ctypes.data_as(ctypes.c_void_p),
                             dst.nbytes, ctypes.byref(msg))
    assert rc == 0
    assert msg.data == dst.ctypes.data  # in-place contract
    np.testing.assert_array_equal(dst, arr)
    # truncation: a too-small destination keeps the copy path
    assert lib.tdcn_chan_send1(a._h, chan, 1, 0, 1, 6, b"|u1", 64,
                               arr.ctypes.data_as(ctypes.c_void_p),
                               64) == 0
    small = np.zeros(16, np.uint8)
    msg2 = TdcnMsg()
    rc = lib.tdcn_precv_into(b._h, b"pi", 1, 0, 6, -1, 10.0,
                             small.ctypes.data_as(ctypes.c_void_p),
                             small.nbytes, ctypes.byref(msg2))
    assert rc == 0
    assert msg2.data != small.ctypes.data  # engine-owned: caller copies
    assert msg2.nbytes == 64
    assert _payload_bytes(lib, msg2) == bytes(arr)
    a.chan_close(chan)


def test_tcp_posted_buffer_recv_into():
    """The framed-TCP leg's recv_into delivery: a posted destination
    buffer takes an eager payload straight off the socket, and a
    rendezvous transfer lands its FRAGs in it (no reassembly
    allocation) — the consumer sees the SAME array object."""
    from ompi_tpu_torch.dcn.tcp import TcpTransport

    got = []
    rx = TcpTransport(lambda env, arr: got.append((dict(env), arr)))
    tx = TcpTransport(lambda env, arr: None)
    try:
        # eager leg
        dst = np.zeros(128, np.float32)
        rx.post_recv_into(9, 0, 1, dst)
        payload = np.arange(128, dtype=np.float32)
        tx.send(rx.address, {"kind": "coll", "cid": 9, "seq": 0,
                             "src": 1}, payload)
        deadline = time.monotonic() + 10
        while not got and time.monotonic() < deadline:
            time.sleep(0.005)
        assert got and got[0][1] is dst  # identity: placed, no copy
        np.testing.assert_array_equal(dst, payload)
        # rendezvous leg (payload above the eager limit)
        big_n = (rx.eager_limit // 8) + 4096
        big_dst = np.zeros(big_n, np.float64)
        rx.post_recv_into(9, 1, 1, big_dst)
        big = np.arange(big_n, dtype=np.float64)
        tx.send(rx.address, {"kind": "coll", "cid": 9, "seq": 1,
                             "src": 1}, big)
        deadline = time.monotonic() + 20
        while len(got) < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert len(got) == 2 and got[1][1] is big_dst
        np.testing.assert_array_equal(big_dst, big)
        assert rx.stats["recv_into_placed"] == 2
        # a stale posting is withdrawable (no leak, no misdelivery)
        rx.post_recv_into(9, 2, 1, np.zeros(4, np.uint8))
        rx.discard_posted(9, 2, 1)
        assert not rx._posted_bufs
    finally:
        rx.close()
        tx.close()

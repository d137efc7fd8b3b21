"""The fault plane's native knobs on the port's C engine, after the
native cases of ``tests/test_faultsim.py``.

* ``native_ring_args``/``native_conn_args``/``native_dup_args``/
  ``native_recv_args`` map a seeded plan onto the C engine's process-wide
  knobs exactly as the reference's do;
* an engine created under a plan arms the knobs, and ``faultsim.reset``
  disarms them (two engine pairs in one process must not inherit each
  other's faults);
* the C hook sites fire on the port's engine as on the reference's: ring
  stall and ring-write failure, the recv deadline's escalation, the tcp
  leg's connkill healed by the redial round, a wire duplicate dropped by
  the dedup watermark (which a failed/cleared mark keeps), the blocking
  receive's injected delay, the pml channel's drop, and a cleared
  failure reopening traffic.
"""

import contextlib
import ctypes
import os
import time

import numpy as np
import pytest

from ompi_tpu.faultsim import core as rfs
from ompi_tpu_torch.core.errors import MPIProcFailedError
from ompi_tpu_torch.dcn import native
from ompi_tpu_torch.faultsim import core as fsim


@pytest.fixture(autouse=True)
def _disarmed():
    fsim.reset()
    yield
    rfs.reset()
    fsim.reset()


@contextlib.contextmanager
def _pair(tcp: bool = False):
    """A port engine pair; ``tcp`` gives the two distinct host ids (the
    framed TCP leg — shared-memory rings have no dial to kill)."""
    engines = []
    old = os.environ.get("TDCN_HOST_ID")
    try:
        for p in range(2):
            if tcp:
                os.environ["TDCN_HOST_ID"] = f"redial-host-{p}"
            engines.append(native.NativeDcnEngine(p, 2))
    finally:
        if old is None:
            os.environ.pop("TDCN_HOST_ID", None)
        else:
            os.environ["TDCN_HOST_ID"] = old
    addrs = [e.address for e in engines]
    for e in engines:
        e.set_addresses(addrs)
    try:
        yield engines[0], engines[1], addrs
    finally:
        for e in engines:
            e.destroy()


PLANS = [
    "",
    "stall:ms=2;every=3,ringfail:at=5",
    "connkill:at=2,delay:ms=1;site=recv",
    "dup:at=4,delay:ms=7;site=recv;every=2",
    "delay:ms=3;site=recv;p=0.5,ringfail:at=2;proc=1,connkill:at=9;proc=0",
]


@pytest.mark.parametrize("plan", PLANS)
def test_native_args_match_reference(plan):
    for proc in (0, 1):
        if plan:
            fsim.configure(plan, seed=9, proc=proc)
            rfs.configure(plan, seed=9, proc=proc)
        got = [f() for f in (fsim.native_ring_args, fsim.native_conn_args,
                             fsim.native_dup_args, fsim.native_recv_args)]
        want = [f() for f in (rfs.native_ring_args, rfs.native_conn_args,
                              rfs.native_dup_args, rfs.native_recv_args)]
        assert got == want, (plan, proc)


def test_engine_arms_the_plan_and_reset_disarms_it():
    """``ringfail:at=1`` armed at engine creation fails the first ring
    write; after ``faultsim.reset`` a fresh pair sends cleanly."""
    fsim.configure("ringfail:at=1", seed=1, proc=0)
    with _pair() as (a, b, _):
        with pytest.raises(MPIProcFailedError):
            a._send(1, "arm", 0, np.arange(4.0))
    fsim.reset()
    with _pair() as (a, b, _):
        a._send(1, "arm", 0, np.arange(4.0))
        assert np.array_equal(b._recv_full(0, "arm", 0, timeout=30)[1], np.arange(4.0))


def test_native_ring_stall_and_fail_injection():
    lib = native.load_library()
    with _pair() as (a, b, _):
        try:
            lib.tdcn_fault_set(2_000_000, 1, -1)  # 2 ms stall, every write
            a._send(1, "cf", 0, np.arange(64, dtype=np.float64))
            b._recv_full(0, "cf", 0, timeout=30)
            s = a.stats_snapshot()
            assert s["injected_faults"] >= 1 and s["ring_stall_ns"] >= 2_000_000
            lib.tdcn_fault_set(0, 1, 1)  # fail the next ring write outright
            with pytest.raises(MPIProcFailedError) as ei:
                a._send(1, "cf", 1, np.arange(64, dtype=np.float64))
            assert ei.value.failed == (1,) and a.proc_failed(1)
        finally:
            lib.tdcn_fault_set(0, 1, -1)


def test_native_recv_deadline_escalates():
    with _pair() as (a, b, _):
        t0 = time.monotonic()
        with pytest.raises(MPIProcFailedError) as ei:
            b._recv_full(0, "nr", 0, timeout=0.6)
        assert time.monotonic() - t0 < 10.0
        assert ei.value.failed == (0,) and b.proc_failed(0)
        assert b.stats_snapshot()["deadline_expired"] == 1


def test_native_redial_heals_killed_connection():
    with _pair(tcp=True) as (a, b, addrs):
        x = np.arange(8, dtype=np.float64)
        a._send(1, "rd", 0, x)
        assert np.array_equal(b._recv_full(0, "rd", 0, timeout=30)[1], x)
        a._lib.tdcn_kill_peer(a._h, addrs[1].encode())
        a._send(1, "rd", 1, x * 2)  # must heal, not raise
        assert np.array_equal(b._recv_full(0, "rd", 1, timeout=30)[1], x * 2)
        s = a.stats_snapshot()
        assert s["reconnects"] >= 1 and s["retry_sends"] >= 1 and not a.proc_failed(1)


def test_native_clear_failed_keeps_dedup_watermark():
    with _pair(tcp=True) as (a, b, addrs):
        x = np.arange(8, dtype=np.float64)
        for seq in range(3):
            a._send(1, "wm", seq, x + seq)
            assert np.array_equal(b._recv_full(0, "wm", seq, timeout=30)[1], x + seq)
        assert b.rx_watermark(0) == 3
        b._lib.tdcn_note_failed(b._h, 0)
        b._lib.tdcn_clear_failed(b._h, 0)
        assert b.rx_watermark(0) == 3
        dd0 = b.stats_snapshot()["dedup_drops"]
        a._lib.tdcn_fault_set_dup(1)  # the next seq'd eager send goes twice
        try:
            a._send(1, "wm", 3, x * 9)
            assert np.array_equal(b._recv_full(0, "wm", 3, timeout=30)[1], x * 9)
            deadline = time.monotonic() + 10
            while b.stats_snapshot()["dedup_drops"] == dd0 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert b.stats_snapshot()["dedup_drops"] == dd0 + 1
        finally:
            a._lib.tdcn_fault_set_dup(-1)
        # only a changed address (a reborn endpoint) prunes the lineage
        b.set_addresses(["ntv:reborn-endpoint", addrs[1]])
        assert b.rx_watermark(0) == 0


def test_native_connkill_knob_heals_from_plan():
    assert fsim.native_conn_args() == -1  # unarmed default
    fsim.configure("connkill:at=2,delay:ms=1;site=recv", seed=9, proc=0)
    assert fsim.native_conn_args() == 2 and fsim.native_recv_args() == (1_000_000, 1)
    with _pair(tcp=True) as (a, b, _):  # created under the plan: armed
        x = np.arange(4, dtype=np.float64)
        for seq in range(4):  # event 2 finds its socket severed
            a._send(1, "ck", seq, x + seq)
        for seq in range(4):
            assert np.array_equal(b._recv_full(0, "ck", seq, timeout=30)[1], x + seq)
        s = a.stats_snapshot()
        assert s["injected_faults"] >= 1 and s["reconnects"] >= 1 and not a.proc_failed(1)


def test_native_recv_delay_knob():
    lib = native.load_library()
    a = native.NativeDcnEngine(0, 1)
    a.set_addresses([a.address])
    try:
        a.local_send("rv", 0, 0, 1, np.arange(3.0), 3, 24)
        lib.tdcn_fault_set_recv(30_000_000, 1)  # 30 ms, every receive
        msg = native.TdcnMsg()
        t0 = time.monotonic()
        rc = lib.tdcn_precv(a._h, b"rv", 0, -1, -1, -1, 10.0, ctypes.byref(msg))
        dt = time.monotonic() - t0
        assert rc == 0 and msg.tag == 1
        if msg.data:
            lib.tdcn_free(msg.data)
        assert dt >= 0.025 and a.stats_snapshot()["injected_faults"] >= 1
    finally:
        lib.tdcn_fault_set_recv(0, 1)
        a.destroy()


def test_native_chan_send_fault_hook():
    with _pair() as (a, b, addrs):
        ch = a.chan_open(addrs[1], "9")
        try:
            fsim.configure("drop:at=1", seed=1, proc=0)
            a.chan_send(ch, native.FK_P2P, 0, 1, 5, np.arange(4.0))  # lost
            a.chan_send(ch, native.FK_P2P, 0, 1, 6, np.arange(4.0))
            msg = native.TdcnMsg()
            rc = b._lib.tdcn_precv(b._h, b"9", 1, -1, -1, -1, 15.0, ctypes.byref(msg))
            assert rc == 0 and msg.tag == 6
            if msg.data:
                b._lib.tdcn_free(msg.data)
            assert fsim.injected("drop") == 1
            assert b._lib.tdcn_pending(b._h, b"9", 1, 0) == 0
        finally:
            a.chan_close(ch)


def test_native_clear_failed_reopens_traffic():
    with _pair() as (a, b, _):
        b.note_proc_failed(0)
        with pytest.raises(MPIProcFailedError):
            b._recv_full(0, "cf2", 0, timeout=5)
        b.note_proc_recovered(0)
        assert not b.proc_failed(0)
        x = np.arange(4, dtype=np.float64)
        a._send(1, "cf2", 1, x)
        assert np.array_equal(b._recv_full(0, "cf2", 1, timeout=30)[1], x)
        assert b.stats_snapshot()["respawns"] == 1

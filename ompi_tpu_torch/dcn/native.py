"""Native DCN engine — the C++ host data plane behind the Python
control plane.

Port of ``ompi_tpu/dcn/native.py`` over the port's own copy of the C
engine (``ompi_tpu_torch/csrc/dcn.cc``, built by
:mod:`ompi_tpu_torch.native`).  The wire, the ``TdcnMsg`` record and the
``tdcn_*`` surface are the reference's, so a port process and a
reference process meet on one wire.  The device plane
(:mod:`.device`) is armed at creation, as the reference's is: a large
contiguous coll-stream payload rides a device window and the C host
plane carries only its descriptor in the meta JSON.  A tensor payload
(han's row when the plane is armed) rides a window when arbitration
takes it, and otherwise goes to the host as the numpy array ctypes
sends; the schedule is collops', so both planes fold tensors alike.

≈ SURVEY.md §2's native-path rule ("shared-memory & TCP transports,
progress engine, request engine … in C++"): ``csrc/dcn.cc``
(``libtpudcn.so``) owns framing, sockets, shared-memory rings, the
coll-stream slots, and the p2p matching engine; this module is the
ctypes control plane — connection bring-up via the modex address,
rendezvous policy knobs, communicator bookkeeping, and the ULFM/
monitoring integration points all stay Python.

Blocked receives sleep INSIDE C (GIL released) on a condition variable
the C receiver thread notifies — no Python thread handoff on the
latency path.  Frames that need Python semantics (heartbeats, ULFM
gossip/revoke, OSC RMA envelopes, communicators whose pml is wrapped
by monitoring/vprotocol) arrive on a single dispatcher thread that
blocks in ``tdcn_ctrl_next`` and feeds the same
:meth:`DcnCollEngine._on_frame` router the Python transport used —
full behavioral compatibility at control-plane rates.

Engine classes mirror the Python trio: :class:`NativeDcnEngine` (root,
owns the C engine), :class:`NativeSubEngine` (cross-process
comm_split view), :class:`NativeJoinEngine` (spawn/join across
worlds).  All three share the root's C engine; sub/join views only
remap indices, exactly like their Python counterparts.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import json
import os
import threading
import time
import weakref
from typing import Callable, Sequence

import numpy as np

from ompi_tpu_torch.core.errors import (
    MPIInternalError,
    MPIProcFailedError,
)
from ompi_tpu_torch.faultsim import core as _fsim
from ompi_tpu_torch.metrics import core as _metrics
from ompi_tpu_torch.trace import causal as _causal
from .collops import REVOKE_COUNTS, DcnCollEngine, DcnJoinEngine, DcnSubEngine
from .tcp import BF16_HOST, BF16_WIRE

FK_COLL, FK_P2P, FK_PY = 0, 1, 2

_RC_TIMEOUT = 1
_RC_FAILED = -2
_RC_CLOSED = -3


class TdcnMsg(ctypes.Structure):
    _pack_ = 1
    _fields_ = [
        ("kind", ctypes.c_int32),
        ("src", ctypes.c_int32),
        ("dst", ctypes.c_int32),
        ("tag", ctypes.c_int32),
        ("seq", ctypes.c_int64),
        ("pyhandle", ctypes.c_uint64),
        ("data", ctypes.c_void_p),
        ("nbytes", ctypes.c_uint64),
        ("count", ctypes.c_int64),
        ("dtype", ctypes.c_char * 16),
        ("ndim", ctypes.c_int32),
        ("shape", ctypes.c_int64 * 8),
        ("cid", ctypes.c_char * 128),
        ("meta", ctypes.c_void_p),
        ("meta_len", ctypes.c_uint32),
    ]


_lib = None
_lib_lock = threading.Lock()

#: lazy-modex resolver callback shape (tdcn_set_resolver): C hands a
#: writable buffer and the Python side copies the NUL-terminated
#: address in, returning its length (-1 = unresolvable) — a
#: char*-returning callback would hand C memory whose Python owner can
#: be collected before the engine reads it
RESOLVER_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_char),
                               ctypes.c_int)


def load_library():
    """Build (cached) and load libtpudcn.so with typed signatures.
    ``RTLD_LOCAL`` (ctypes' default) keeps its symbols apart from the
    reference's library of the same names in one process."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from ompi_tpu_torch import native as nat

        lib = ctypes.CDLL(str(nat.build()))
        P, I, I64, U64, D, S = (ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int64, ctypes.c_uint64,
                                ctypes.c_double, ctypes.c_char_p)
        MSG = ctypes.POINTER(TdcnMsg)
        lib.tdcn_create.restype = P
        lib.tdcn_create.argtypes = [I, I, S, I64, I64, U64, I]
        lib.tdcn_address.restype = ctypes.c_char_p
        lib.tdcn_address.argtypes = [P]
        lib.tdcn_set_addresses.argtypes = [P, S]
        lib.tdcn_send_addr.restype = I
        lib.tdcn_send_addr.argtypes = [
            P, S, I, S, I64, I, I, I, S, I,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, I,
            ctypes.c_void_p, U64]
        lib.tdcn_send_local.restype = I
        lib.tdcn_send_local.argtypes = [P, I, S, I64, I, I, I, U64, I64,
                                        U64]
        lib.tdcn_send_local_data.restype = I
        lib.tdcn_send_local_data.argtypes = [
            P, I, S, I64, I, I, I, S, I,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p, U64]
        lib.tdcn_recv_coll.restype = I
        lib.tdcn_recv_coll.argtypes = [P, S, I64, I, I, D, MSG]
        lib.tdcn_post_recv.restype = U64
        lib.tdcn_post_recv.argtypes = [P, S, I, I, I]
        lib.tdcn_post_recv_into.restype = U64
        lib.tdcn_post_recv_into.argtypes = [P, S, I, I, I,
                                            ctypes.c_void_p, U64]
        lib.tdcn_req_wait.restype = I
        lib.tdcn_req_wait.argtypes = [P, U64, D, MSG]
        lib.tdcn_req_test.restype = I
        lib.tdcn_req_test.argtypes = [P, U64, MSG]
        lib.tdcn_req_cancel.restype = I
        lib.tdcn_req_cancel.argtypes = [P, U64]
        lib.tdcn_probe.restype = I
        lib.tdcn_probe.argtypes = [P, S, I, I, I, MSG]
        lib.tdcn_pending.restype = I
        lib.tdcn_pending.argtypes = [P, S, I, I]
        lib.tdcn_register_pycid.argtypes = [P, S]
        lib.tdcn_unregister_cid.argtypes = [P, S]
        lib.tdcn_ctrl_next.restype = I
        lib.tdcn_ctrl_next.argtypes = [P, D, MSG]
        lib.tdcn_note_failed.argtypes = [P, I]
        lib.tdcn_is_failed.restype = I
        lib.tdcn_is_failed.argtypes = [P, I]
        lib.tdcn_bytes_sent.restype = U64
        lib.tdcn_bytes_sent.argtypes = [P]
        lib.tdcn_stats.restype = I
        lib.tdcn_stats.argtypes = [P, ctypes.POINTER(ctypes.c_uint64), I]
        lib.tdcn_stats_names.restype = ctypes.c_char_p
        lib.tdcn_stats_names.argtypes = []
        lib.tdcn_waitinfo.restype = I
        lib.tdcn_waitinfo.argtypes = [P, ctypes.c_char_p, I]
        lib.tdcn_hang_diag.argtypes = [I]
        lib.tdcn_trace_ctx_version.restype = I
        lib.tdcn_trace_ctx_version.argtypes = []
        lib.tdcn_trace_ctx_fields.restype = ctypes.c_char_p
        lib.tdcn_trace_ctx_fields.argtypes = []
        lib.tdcn_fault_set.argtypes = [U64, U64, I64]
        lib.tdcn_fault_events.restype = U64
        lib.tdcn_fault_events.argtypes = []
        lib.tdcn_fault_set_conn.argtypes = [I64]
        lib.tdcn_fault_set_dup.argtypes = [I64]
        lib.tdcn_fault_set_recv.argtypes = [U64, U64]
        lib.tdcn_rx_watermark.restype = U64
        lib.tdcn_rx_watermark.argtypes = [P, I]
        lib.tdcn_chan_kill.argtypes = [P, U64]
        lib.tdcn_kill_peer.argtypes = [P, S]
        lib.tdcn_clear_failed.argtypes = [P, I]
        lib.tdcn_set_address_one.restype = I
        lib.tdcn_set_address_one.argtypes = [P, I, S, I]
        lib.tdcn_set_resolver.argtypes = [P, RESOLVER_FN]
        lib.tdcn_coll_revoke_cid.argtypes = [P, S]
        lib.tdcn_coll_optime.restype = I
        lib.tdcn_coll_optime.argtypes = [P, I,
                                         ctypes.POINTER(ctypes.c_uint64),
                                         I]
        # the C collective fast-path surface (normally driven by the
        # shim; declared here so in-process tests/tools can exercise
        # the coll recv_into + per-op timing legs with correct widths)
        lib.tdcn_coll_open.restype = U64
        lib.tdcn_coll_open.argtypes = [P, S, I, I,
                                       ctypes.POINTER(ctypes.c_char_p),
                                       U64]
        lib.tdcn_coll_plan.restype = U64
        lib.tdcn_coll_plan.argtypes = [P, U64, I, I, I, I64, I, I]
        lib.tdcn_coll_start.restype = I
        lib.tdcn_coll_start.argtypes = [P, U64, ctypes.c_void_p,
                                        ctypes.c_void_p]
        lib.tdcn_coll_close.argtypes = [P, U64]
        lib.tdcn_set_ring_timeout.argtypes = [P, D]
        lib.tdcn_set_connect_timeout.argtypes = [P, D]
        lib.tdcn_free.argtypes = [ctypes.c_void_p]
        lib.tdcn_close.argtypes = [P]
        lib.tdcn_destroy.argtypes = [P]
        lib.tdcn_chan_open.restype = U64
        lib.tdcn_chan_open.argtypes = [P, S, S]
        lib.tdcn_chan_close.argtypes = [P, U64]
        lib.tdcn_chan_send.restype = I
        lib.tdcn_chan_send.argtypes = [
            P, U64, I, I, I, I, S, I, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_void_p, U64]
        lib.tdcn_precv.restype = I
        lib.tdcn_precv.argtypes = [P, S, I, I, I, I, D, MSG]
        lib.tdcn_precv_into.restype = I
        lib.tdcn_precv_into.argtypes = [P, S, I, I, I, I, D,
                                        ctypes.c_void_p, U64, MSG]
        lib.tdcn_chan_send1.restype = I
        lib.tdcn_chan_send1.argtypes = [
            P, U64, I, I, I, I, S, I64, ctypes.c_void_p, U64]
        lib.tdcn_chan_isend1.restype = I64
        lib.tdcn_chan_isend1.argtypes = [
            P, U64, I, I, I, I, S, I64, ctypes.c_void_p, U64, I]
        lib.tdcn_send_wait.restype = I
        lib.tdcn_send_wait.argtypes = [P, I64, D]
        lib.tdcn_send_test.restype = I
        lib.tdcn_send_test.argtypes = [P, I64]
        lib.tdcn_send_done.restype = I
        lib.tdcn_send_done.argtypes = [P, I64]
        lib.tdcn_send_forget.argtypes = [P, I64]
        lib.tdcn_set_stream.argtypes = [P, U64, U64, I]
        _lib = lib
        return lib


_tls = threading.local()


def _tls_msg() -> TdcnMsg:
    """Reusable per-thread TdcnMsg: safe because every consumer copies
    or re-owns the payload before the next native call."""
    m = getattr(_tls, "msg", None)
    if m is None:
        m = TdcnMsg()
        _tls.msg = m
        _tls.msg_ref = ctypes.byref(m)
    return m


def available() -> bool:
    try:
        load_library()
        return True
    except Exception:  # noqa: BLE001 — no toolchain / unsupported OS
        return False


def transport_tuning() -> tuple[int, int, bool]:
    """Resolve the streaming-send-engine knobs (``dcn_chunk_bytes``,
    ``dcn_inflight_limit``, ``dcn_doorbell_coalesce``) against the
    default MCA context, falling back to the central TRANSPORT_VARS
    defaults (bare engines in unit tests)."""
    from ompi_tpu_torch.core.var import TRANSPORT_VARS, full_var_name

    vals: dict[str, object] = {
        full_var_name(fw, comp, name): default
        for fw, comp, name, default, _typ, _h in TRANSPORT_VARS
    }
    try:
        from ompi_tpu_torch.core import mca

        store = mca.default_context().store
        for full in vals:
            v = store.get(full)
            if v is not None:
                vals[full] = v
    except Exception:  # noqa: BLE001 — pre-init / teardown: defaults
        pass
    return (int(vals["dcn_chunk_bytes"]),
            int(vals["dcn_inflight_limit"]),
            bool(vals["dcn_doorbell_coalesce"]))


_dtype_cache: dict[bytes, np.dtype] = {}
_dtype_bytes: dict[object, bytes] = {}


def _dt_of(code: bytes) -> np.dtype:
    dt = _dtype_cache.get(code)
    if dt is None:
        dt = np.dtype(code.decode() or "u1")
        _dtype_cache[code] = dt
    return dt


def _dt_bytes(dt: np.dtype) -> bytes:
    """The wire's dtype code: ``dtype.str``, except bfloat16's raw words
    (``|V2`` here), which carry the reference's ``"<V2"``."""
    b = _dtype_bytes.get(dt)
    if b is None:
        b = (BF16_WIRE if dt == BF16_HOST else dt.str).encode()
        _dtype_bytes[dt] = b
    return b


#: below this, copying into a fresh numpy buffer and freeing the C
#: allocation immediately beats the zero-copy wrapper's finalizer cost
_COPY_LIMIT = 64 << 10


def _wrap_payload(lib, msg: TdcnMsg) -> np.ndarray:
    """Numpy array over the C-owned payload: small payloads are copied
    (and the native buffer freed now); large ones are wrapped zero-copy
    with a finalizer freeing the native allocation at GC."""
    dt = _dt_of(msg.dtype)
    shape = tuple(msg.shape[i] for i in range(msg.ndim))
    if not msg.nbytes:
        return np.empty(shape if msg.ndim else (0,), dt)
    if msg.nbytes <= _COPY_LIMIT:
        src = np.frombuffer(
            (ctypes.c_char * msg.nbytes).from_address(msg.data),
            dtype=np.uint8)
        arr = src.view(dt).reshape(shape).copy()
        lib.tdcn_free(msg.data)
        return arr
    buf = (ctypes.c_char * msg.nbytes).from_address(msg.data)
    weakref.finalize(buf, lib.tdcn_free, msg.data)
    arr = np.frombuffer(buf, dtype=np.uint8).view(dt)
    return arr.reshape(shape)


def _meta_of(lib, msg: TdcnMsg):
    if not msg.meta:
        return None
    raw = ctypes.string_at(msg.meta, msg.meta_len)
    lib.tdcn_free(msg.meta)
    msg.meta = None
    try:
        return json.loads(raw.decode())
    except ValueError:
        return None


class _NativeTransportView:
    """The ``engine.transport`` surface other layers read (address,
    bytes_sent, liveness) mapped onto the C engine."""

    def __init__(self, eng: "NativeDcnEngine"):
        self._eng = eng

    @property
    def address(self) -> str:
        return self._eng.address

    @property
    def bytes_sent(self) -> int:
        return int(self._eng._lib.tdcn_bytes_sent(self._eng._h))

    @property
    def _running(self) -> bool:
        return self._eng._running

    def close(self) -> None:
        self._eng.close()


class _NativeOpsMixin:
    """Byte-plane methods shared by root/sub/join native engines; all
    route through the ROOT engine's C handle with address-mapped
    peers (sub/join views only remap indices)."""

    def _native_root(self) -> "NativeDcnEngine":
        raise NotImplementedError

    def root_proc_of(self, local: int) -> int:
        """Map a LOCAL engine index to the root engine's proc index
        (-1 = unmapped, e.g. across spawn worlds)."""
        raise NotImplementedError

    # -- coll streams ---------------------------------------------------

    def _fsim_drop(self) -> bool:
        """Consult the fault plane for one native record-path send
        (site ``send`` — the same schedule the Python transports use).
        The native plane performs drop/delay only (connection faults
        belong to the C layer's ring hook and the Python transports);
        the kinds filter keeps unsupported rules out of the injected
        counts.  True → the record is 'lost on the wire'."""
        for act in _fsim.actions("send", kinds={"drop", "delay"}):
            if act.kind == "delay":
                _fsim.apply_delay(act)
            elif act.kind == "drop":
                return True
        return False

    def _raise_send_failed(self, dst: int, rc: int, what: str):
        """Map a C-plane send failure onto ULFM escalation: mark the
        peer failed (detector when attached) and raise
        MPIProcFailedError — a dead native peer must surface exactly
        like a dead Python-plane peer."""
        root = self._native_root()
        if rc == _RC_CLOSED or not root._running:
            raise MPIInternalError(f"native dcn {what}: engine closed")
        if rc != -1:  # addressing/shape misuse, not a transport fault
            raise MPIInternalError(
                f"native dcn {what} to proc {dst} failed (rc={rc})")
        from ompi_tpu_torch.metrics import export as _mexport
        from ompi_tpu_torch.metrics import flight as _flight

        _flight.record("peer_escalation", proc=int(dst), what=what)
        # crash-path export (once-latch): the native plane's escalation
        # leaves telemetry files behind like the Python plane's
        _mexport.crash_dump("peer_escalation")
        rp = self.root_proc_of(dst)
        if rp is not None and rp >= 0:
            det = root._detector
            if det is not None:
                det.mark_failed(rp)
            else:
                root.note_proc_failed(rp)
            raise MPIProcFailedError(
                f"native dcn {what}: peer proc {dst} failed (rc={rc})",
                failed=(dst,))
        raise ConnectionError(
            f"native dcn {what} to proc {dst} failed (rc={rc})")

    def _send(self, dst: int, cid, seq: int, payload: np.ndarray,
              meta=None) -> None:
        root = self._native_root()
        if _fsim._enabled and self._fsim_drop():
            return  # lost record: the receiver's deadline escalates
        # plane arbitration (dcn/device.py): a large contiguous payload
        # rides a device window; the C host plane carries only its
        # descriptor (in the meta JSON) — same protocol as the Python
        # engine, so mixed-size schedules interleave planes freely
        from . import device as _device

        msg_nbytes = (payload.nbytes if isinstance(payload, np.ndarray)
                      else None)
        desc = (_device.try_stage(root, payload, self.root_proc_of(dst))
                if meta is None or isinstance(meta, dict) else None)
        if desc is not None:
            meta = dict(meta) if meta else {}
            meta[_device.DESC_KEY] = desc
            msg_nbytes, payload = int(desc["n"]), np.zeros(0, np.uint8)
        arr = np.ascontiguousarray(_device.host_array(payload))
        if _metrics._enabled:
            # sample the MESSAGE size, not the wire record's: a
            # device-routed payload ships an empty descriptor frame but
            # the op still moved msg_nbytes
            _metrics.observe_size(
                "dcn_coll_send",
                msg_nbytes if msg_nbytes is not None else arr.nbytes)
            from ompi_tpu_torch.metrics import flight as _flight

            _flight.check_watermarks()
        if _causal._enabled and (meta is None or isinstance(meta, dict)):
            # causal wire context on the native plane: rides the
            # frame's meta-JSON region — WireHdr stays frozen,
            # disabled frames stay byte-identical;
            # TDCN_TRACE_CTX_FIELDS in dcn.cc mirrors the field table
            tc = _causal.note_send(self.root_proc_of(dst))
            if tc is not None:
                meta = dict(meta) if meta else {}
                meta["tc"] = tc
        meta_b = json.dumps(meta).encode() if meta is not None else None
        rc = root._csend(
            self.addresses[dst], FK_COLL, str(cid), seq, self.proc, 0, 0,
            arr, meta_b)
        if rc != 0:
            self._raise_send_failed(dst, rc, f"send (cid={cid}, seq={seq})")

    def _recv_full(self, src: int, cid, seq: int,
                   timeout: float | None = None, into=None):
        # `into` (the Python transports' recv_into posting): the C
        # coll-slot delivery owns its payload (callers fall back to
        # their copy on non-identity), but a DEVICE-plane descriptor
        # frame materializes straight into it below
        from ompi_tpu_torch.core.var import Deadline, dcn_timeout

        if timeout is None:
            timeout = dcn_timeout("recv")
        tw0 = time.perf_counter_ns() if _causal._enabled else 0
        root = self._native_root()
        lib, h = root._lib, root._h
        fail_idx = self.root_proc_of(src)
        msg = TdcnMsg()
        dl = Deadline(timeout)
        while True:
            rc = lib.tdcn_recv_coll(h, str(cid).encode(), seq, src,
                                    fail_idx, dl.slice(0.25),
                                    ctypes.byref(msg))
            if rc == 0:
                break
            if rc == _RC_CLOSED:
                raise MPIInternalError("DCN recv: engine closed")
            if (rc == _RC_FAILED or
                    (fail_idx >= 0 and root.proc_failed(fail_idx))):
                raise MPIProcFailedError(
                    f"DCN recv: peer proc {src} failed (cid={cid}, "
                    f"seq={seq})", failed=(src,))
            # revoke interrupt between C wait slices (same contract as
            # the Python plane's _check_revoked)
            self._check_revoked(cid, src, seq)
            if dl.expired():
                # flight-record the ring/rendezvous state BEFORE the
                # raise (a wedged windowed send dumps its counters
                # instead of vanishing with the process), then the one
                # shared escalation: mark failed + MPIProcFailedError,
                # never a bare internal error the job cannot survive
                from ompi_tpu_torch.metrics import flight as _flight

                _flight.record("recv_timeout", cid=str(cid), seq=seq,
                               src=src, timeout_s=timeout)
                self._escalate_deadline(
                    "coll_recv", timeout,
                    f"DCN recv deadline (dcn_recv_timeout={timeout}s) "
                    f"expired: proc {self.proc} waiting for proc {src} "
                    f"(cid={cid}, seq={seq}) — peer dead, wedged, or "
                    f"collective order mismatch",
                    failed_rank=src, root_proc=fail_idx,
                    cid=str(cid), seq=int(seq))
        if fail_idx >= 0:
            det = root._detector
            note = getattr(det, "note_activity", None)
            if note is not None:
                note(fail_idx)  # a delivered frame proves the peer alive
        env = {"cid": cid, "seq": seq, "src": src}
        meta = _meta_of(lib, msg)
        payload = _wrap_payload(lib, msg)
        if isinstance(meta, dict) and "dev" in meta:
            # device-plane delivery: the C frame carried only the window
            # descriptor — recv-semaphore wait + materialize (straight
            # into the posted buffer when one matches)
            from . import device as _device

            desc = meta.pop("dev")
            payload = _device.materialize(
                root, desc, into=into,
                src_root=(fail_idx if fail_idx >= 0 else None))
        tc = None
        if isinstance(meta, dict):
            # "tc" is a reserved meta key like "dev": popped here
            # whether or not THIS rank records, so a consumer's meta
            # never grows a foreign field
            tc = meta.pop("tc", None)
            if not meta:
                meta = None
        if tw0:
            _causal.note_recv(self.root_proc_of(src), tc,
                              time.perf_counter_ns() - tw0)
        if meta is not None:
            env["meta"] = meta
        return env, payload

    # -- p2p / control --------------------------------------------------

    def send_p2p(self, dst_proc: int, envelope: dict, payload) -> None:
        root = self._native_root()
        arr = np.ascontiguousarray(np.asarray(payload))
        if _fsim._enabled and self._fsim_drop():
            return
        if _metrics._enabled:
            _metrics.observe_size("dcn_p2p_send", arr.nbytes)
        keys = set(envelope)
        cid = envelope.get("cid")
        if keys == {"cid", "src", "dst", "tag"} and root.is_native_cid(cid):
            rc = root._csend(
                self.addresses[dst_proc], FK_P2P, str(cid), 0,
                int(envelope["src"]), int(envelope["dst"]),
                int(envelope["tag"]), arr, None)
        else:
            env = dict(envelope)
            env["kind"] = "p2p"
            rc = root._csend(
                self.addresses[dst_proc], FK_PY, str(cid), 0, 0, 0, 0,
                arr, json.dumps(env).encode())
        if rc != 0:
            self._raise_send_failed(dst_proc, rc, "p2p send")

    def send_ctrl(self, dst: int, envelope: dict) -> None:
        # control traffic (heartbeats, gossip, revoke) is exempt from
        # fault injection and escalates nowhere here: the detector owns
        # interpreting its failures (in-band detection)
        root = self._native_root()
        rc = root._csend(
            self.addresses[dst], FK_PY, "", 0, 0, 0, 0,
            np.zeros(0, np.uint8), json.dumps(dict(envelope)).encode())
        if rc != 0:
            raise ConnectionError(
                f"native dcn ctrl send to proc {dst} failed (rc={rc})")

    # -- engine views ---------------------------------------------------

    def sub(self, procs: Sequence[int]) -> "NativeSubEngine":
        return NativeSubEngine(self, procs)

    def join(self, addresses: Sequence[str], proc: int) -> "NativeJoinEngine":
        return NativeJoinEngine(self, addresses, proc)


class NativeDcnEngine(_NativeOpsMixin, DcnCollEngine):
    """Root engine: owns the C engine, the dispatcher thread, and the
    local-payload handle table."""

    def __init__(
        self,
        proc: int,
        nprocs: int,
        addresses: Sequence[str] | None = None,
        eager_limit: int = 4 << 20,
        frag_size: int = 8 << 20,
        max_rndv: int = 4,
        ring_threshold: int = 64 << 10,
        ring_bytes: int = 64 << 20,
        **_ignored,
    ):
        # deliberately NOT calling DcnCollEngine.__init__ — no Python
        # transport; replicate the control-plane state it set up
        self.proc = proc
        self.nprocs = nprocs
        self.ring_threshold = int(ring_threshold)
        self.addresses = list(addresses) if addresses else []
        self._seq: dict = {}
        self._failed_procs: set[int] = set()
        self._detector = None
        self._comms: dict = {}
        self.revoke_counts = dict.fromkeys(REVOKE_COUNTS, 0)
        self._p2p_handlers: dict[object, Callable] = {}
        self._p2p_pending: dict = {}
        self._p2p_closed: set = set()
        self._p2p_lock = threading.Lock()
        self._queues: dict = {}
        self._qlock = threading.Lock()

        self._lib = load_library()
        host_id = self._host_id()
        self._h = self._lib.tdcn_create(
            proc, nprocs, host_id.encode(), int(eager_limit),
            int(frag_size), int(ring_bytes), int(max_rndv))
        if not self._h:
            raise MPIInternalError("tdcn_create failed")
        self._running = True
        self.transport = _NativeTransportView(self)
        #: local-send payload table: handle → (payload, nbytes)
        self._handles: dict[int, object] = {}
        self._hnext = itertools.count(1)
        self._hlock = threading.Lock()
        #: cids whose p2p frames the C matcher owns (native pml comms)
        self._native_cids: set[str] = set()
        #: telemetry: the C engine's TdcnStats block, read via one
        #: ctypes call (ompi_tpu_torch.metrics merges it into snapshots/pvars)
        self._stat_names = (
            self._lib.tdcn_stats_names().decode().split(","))
        self._stat_buf = (ctypes.c_uint64 * len(self._stat_names))()
        #: Python-plane robustness counters the C block cannot see
        #: (deadline escalations happen above the C boundary); merged
        #: over the C totals in stats_snapshot
        self._py_stats: dict[str, int] = {"deadline_expired": 0}
        # forward the unified ring deadline (dcn_ring_timeout) to the
        # C writer: a dead consumer's frozen tail must surface as a
        # send error, never an unbounded reserve() spin — and the
        # connect deadline (dcn_connect_timeout) to the C dialer, so
        # the redial+backoff round heals a restarting peer instead of
        # escalating a single failed connect() to MPIProcFailedError
        from ompi_tpu_torch.core.var import dcn_timeout

        self._lib.tdcn_set_ring_timeout(self._h, float(dcn_timeout("ring")))
        self._lib.tdcn_set_connect_timeout(
            self._h, float(dcn_timeout("connect")))
        # streaming send engine knobs (TRANSPORT_VARS): pipelined chunk
        # granularity, the per-peer queued-bytes cap, and the doorbell
        # coalescing escape hatch — forwarded once; the C engine reads
        # them with relaxed atomics per send
        chunk, inflight, coalesce = transport_tuning()
        self._lib.tdcn_set_stream(self._h, chunk, inflight,
                                  1 if coalesce else 0)
        # the device-resident zero-copy plane (dcn/device.py): coll-
        # stream payloads arbitrate onto device windows exactly like the
        # Python engine's; the C p2p channel path keeps the host plane
        from . import device as _device

        self._device_plane = _device.maybe_create(proc, nprocs)
        from ompi_tpu_torch import metrics as _metrics

        _metrics.register_provider(self, self.stats_snapshot)
        # C-fast-path per-op timing rows → the straggler_<op> surfaces
        from ompi_tpu_torch.metrics import straggler as _straggler

        _straggler.register_native(self, self.coll_optimes)
        # mesh doctor: arm/disarm the C blocked-wait registry to match
        # hang_diag_enable, and mirror it into blocked-state snapshots
        from ompi_tpu_torch.trace import waitgraph as _waitgraph

        self._lib.tdcn_hang_diag(1 if _waitgraph._enabled else 0)
        _waitgraph.register_native(self, self.waitinfo)
        if _fsim._enabled:
            # arm the C fault hooks from the seeded plan: the ring
            # writer, the tcp-send connkill site, and the blocking-
            # receive delay site (native pml + C-ABI shim recv)
            stall_ns, every, fail_at = _fsim.native_ring_args()
            if stall_ns or fail_at >= 0:
                self._lib.tdcn_fault_set(stall_ns, every, fail_at)
            conn_at = _fsim.native_conn_args()
            if conn_at >= 0:
                self._lib.tdcn_fault_set_conn(conn_at)
            dup_at = _fsim.native_dup_args()
            if dup_at >= 0:
                self._lib.tdcn_fault_set_dup(dup_at)
            recv_ns, recv_every = _fsim.native_recv_args()
            if recv_ns:
                self._lib.tdcn_fault_set_recv(recv_ns, recv_every)
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="tdcn-dispatch")
        self._dispatcher.start()

    @staticmethod
    def _host_id() -> str:
        import socket as _socket

        # test/dev override: distinct ids force the framed-TCP leg
        # (eager + RTS/CTS/FRAG rendezvous) between same-host peers —
        # the only way one host can exercise the cross-host path
        override = os.environ.get("TDCN_HOST_ID")
        if override:
            return override
        hid = _socket.gethostname()
        try:
            with open("/proc/sys/kernel/random/boot_id") as f:
                hid += "/" + f.read().strip()
        except OSError:
            pass
        return hid

    # -- mixin hooks ----------------------------------------------------

    def _native_root(self) -> "NativeDcnEngine":
        return self

    def root_proc_of(self, local: int) -> int:
        return local if 0 <= local < self.nprocs else -1

    # -- C helpers ------------------------------------------------------

    @property
    def address(self) -> str:
        return self._lib.tdcn_address(self._h).decode()

    def set_addresses(self, addresses: Sequence[str]) -> None:
        if len(addresses) != self.nprocs:
            raise ValueError("address count != nprocs")
        from .collops import AddressTable

        if isinstance(addresses, AddressTable):
            # sharded native modex (the instant-on leg, on the C
            # plane): install only the PRIMED slots eagerly (<= group
            # size), wrap the table's resolver so every lazy resolution
            # also lands in the C table (tdcn_set_address_one), and arm
            # the C-side resolver callback so a C-initiated send to an
            # unresolved peer pulls through the same table instead of
            # failing — np>=16 native boot does <= group-size eager
            # installs instead of P-1 (TS_ADDR_INSTALLS/TS_ADDR_LAZY
            # account it)
            inner = addresses._resolver

            def _resolve_install(p: int, _inner=inner) -> str:
                a = _inner(p)
                if a:
                    self._lib.tdcn_set_address_one(
                        self._h, int(p), str(a).encode(), 1)
                return a

            addresses._resolver = _resolve_install
            self.addresses = addresses
            joined = "\n".join(
                (list.__getitem__(addresses, i) or "")
                for i in range(self.nprocs))
            self._lib.tdcn_set_addresses(self._h, joined.encode())
            self._arm_resolver()
            return
        self.addresses = list(addresses)
        self._lib.tdcn_set_addresses(
            self._h, "\n".join(self.addresses).encode())

    def update_address(self, proc: int, address: str) -> None:
        """One-peer refresh (replace() installing a reborn endpoint):
        ``tdcn_set_address_one`` updates exactly that slot — the C
        engine prunes the corpse lineage's rx state and invalidates any
        C-coll views that resolved the dead address — without collapsing
        a sharded table's unresolved holes the way a full-table re-push
        would."""
        super().update_address(proc, address)  # the Python-side slot
        self._lib.tdcn_set_address_one(
            self._h, int(proc), str(address).encode(), 0)

    def _arm_resolver(self) -> None:
        """C-side lazy-modex callback: writes the table-resolved
        address into the engine-provided buffer (NUL-terminated).  The
        CFUNCTYPE object is pinned on the engine — ctypes callbacks
        die with their last Python reference."""

        def _cb(proc: int, out, cap: int) -> int:
            try:
                a = self.addresses[int(proc)]  # resolves + installs
                b = str(a or "").encode()
                if not b or len(b) + 1 > int(cap):
                    return -1
                ctypes.memmove(out, b, len(b))
                out[len(b)] = b"\x00"
                return len(b)
            except Exception:  # noqa: BLE001 — C cannot unwind Python
                return -1

        self._resolver_cb = RESOLVER_FN(_cb)
        self._lib.tdcn_set_resolver(self._h, self._resolver_cb)

    def coll_revoke(self, cid) -> None:
        """ULFM revoke crossing into the C fast path: wake any parked
        ``cctx_recv_msg`` waits on this comm's private ``#cfp`` stream
        (they abort with the revoked code instead of waiting out the
        ~600 s give-up) and refuse new C schedules for it."""
        self._lib.tdcn_coll_revoke_cid(self._h, str(cid).encode())

    def _csend(self, address: str, kind: int, cid: str, seq: int,
               src: int, dst: int, tag: int, arr: np.ndarray,
               meta_b: bytes | None) -> int:
        shape = (ctypes.c_int64 * max(arr.ndim, 1))(*(arr.shape or (0,)))
        data = arr.ctypes.data_as(ctypes.c_void_p) if arr.nbytes else None
        return self._lib.tdcn_send_addr(
            self._h, address.encode(), kind, cid.encode(), seq, src, dst,
            tag, _dt_bytes(arr.dtype), arr.ndim, shape,
            meta_b, len(meta_b) if meta_b else 0, data, arr.nbytes)

    # -- channel fast path (per-(peer, cid), scalar-args-only sends) ----

    def chan_open(self, address: str, cid) -> int:
        chan = self._lib.tdcn_chan_open(
            self._h, address.encode(), str(cid).encode())
        if not chan:
            raise MPIInternalError(
                f"native dcn: cannot open channel to {address}")
        return chan

    def chan_close(self, chan: int) -> None:
        if self._h:  # a destroyed engine freed its channels already
            self._lib.tdcn_chan_close(self._h, chan)

    def chan_send(self, chan: int, kind: int, src: int, dst: int,
                  tag: int, arr: np.ndarray) -> None:
        if _fsim._enabled:
            # pml fast-path injection site: the same
            # seeded "send" schedule the record path consumes; connkill
            # severs the channel's cached socket so the C redial round
            # is exercised from the fast path too
            for act in _fsim.actions("send",
                                     kinds={"drop", "delay", "connkill"}):
                if act.kind == "delay":
                    _fsim.apply_delay(act)
                elif act.kind == "drop":
                    return  # lost on the wire; the receiver's deadline
                    # escalation is the recovery path
                elif act.kind == "connkill":
                    self._lib.tdcn_chan_kill(self._h, chan)
        if _metrics._enabled:
            _metrics.observe_size("dcn_p2p_send", arr.nbytes)
            from ompi_tpu_torch.metrics import flight as _flight

            _flight.check_watermarks()
        if arr.ndim == 1:
            rc = self._lib.tdcn_chan_send1(
                self._h, chan, kind, src, dst, tag, _dt_bytes(arr.dtype),
                arr.shape[0], arr.ctypes.data if arr.nbytes else None,
                arr.nbytes)
        else:
            rc = self._lib.tdcn_chan_send(
                self._h, chan, kind, src, dst, tag, _dt_bytes(arr.dtype),
                arr.ndim,
                arr.ctypes.shape_as(ctypes.c_int64) if arr.ndim else None,
                arr.ctypes.data if arr.nbytes else None, arr.nbytes)
        if rc != 0:
            raise ConnectionError(
                f"native dcn channel send failed (rc={rc})")

    # -- p2p registration (native vs Python delivery) -------------------

    def is_native_cid(self, cid) -> bool:
        return str(cid) in self._native_cids

    def register_native_p2p(self, cid) -> None:
        """Route this cid's p2p frames through the C matching engine
        (the fast path for comms with the default pml)."""
        self._native_cids.add(str(cid))

    def register_p2p(self, cid, fn: Callable) -> None:
        """Python delivery for this cid (OSC windows, monitored/
        logged pml): frames reach ``fn`` via the dispatcher thread."""
        with self._p2p_lock:
            self._p2p_handlers[cid] = fn
        self._lib.tdcn_register_pycid(self._h, str(cid).encode())

    def unregister_p2p(self, cid) -> None:
        with self._p2p_lock:
            self._p2p_handlers.pop(cid, None)
            self._p2p_closed.add(cid)
        self._native_cids.discard(str(cid))
        if self._h:  # comms freed after finalize's teardown
            self._lib.tdcn_unregister_cid(self._h, str(cid).encode())

    # -- local (same-process) sends through the native matcher ----------

    def local_send(self, cid, src: int, dst: int, tag: int,
                   payload, count: int, nbytes: int) -> None:
        if (isinstance(payload, np.ndarray) and payload.ndim <= 8
                and not payload.dtype.hasobject):
            # bytes form: the C memcpy IS the buffered-eager copy, and
            # the message stays consumable by the shim's C fast path
            # (pyhandle messages can only be taken Python-side)
            arr = np.ascontiguousarray(payload)
            shape = (ctypes.c_int64 * max(arr.ndim, 1))(
                *(arr.shape or (0,)))
            rc = self._lib.tdcn_send_local_data(
                self._h, FK_P2P, str(cid).encode(), 0, src, dst, tag,
                _dt_bytes(arr.dtype), arr.ndim, shape,
                arr.ctypes.data if arr.nbytes else None, arr.nbytes)
        else:  # device arrays / objects: Python-side handle reference
            with self._hlock:
                h = next(self._hnext)
                self._handles[h] = payload
            rc = self._lib.tdcn_send_local(
                self._h, FK_P2P, str(cid).encode(), 0, src, dst, tag, h,
                count, nbytes)
            if rc != 0:
                with self._hlock:
                    self._handles.pop(h, None)
        if rc != 0:  # pragma: no cover — local enqueue cannot fail
            raise MPIInternalError("tdcn local send failed")

    def take_handle(self, h: int):
        with self._hlock:
            return self._handles.pop(h)

    # -- dispatcher (PY-kind frames → the Python frame router) ----------

    def _dispatch_loop(self) -> None:
        lib, h = self._lib, self._h
        msg = TdcnMsg()
        while self._running:
            rc = lib.tdcn_ctrl_next(h, 0.5, ctypes.byref(msg))
            if rc == _RC_CLOSED:
                return
            if rc != 0:
                continue
            env = _meta_of(lib, msg) or {}
            if msg.kind == FK_P2P and "kind" not in env:
                # raced: a native-matched cid was re-registered for
                # Python delivery; reconstruct the p2p envelope
                env = {"kind": "p2p", "cid": msg.cid.decode() or None,
                       "src": msg.src, "dst": msg.dst, "tag": msg.tag}
                try:
                    env["cid"] = int(env["cid"])
                except (TypeError, ValueError):
                    pass
            payload = (self.take_handle(msg.pyhandle) if msg.pyhandle
                       else _wrap_payload(lib, msg))
            try:
                self._on_frame(env, payload)
            except Exception as e:  # noqa: BLE001 — keep dispatching
                import sys

                print(f"[ompi_tpu_torch tdcn] dispatcher error for {env}: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)

    # -- transport telemetry --------------------------------------------

    #: CK_* kind index → the straggler/pvar op name (shim CollKind)
    _COLL_KINDS = ("barrier", "bcast", "reduce", "allreduce",
                   "allgather")

    def coll_optimes(self) -> dict[str, dict] | None:
        """Per-op timing rows for the C collective fast path (its
        observability edge): {op: {count, wait_ns, max_wait_ns,
        lat_hist}} — merged by :mod:`ompi_tpu_torch.metrics.straggler` into
        the ``straggler_<op>`` pvar/prom surfaces, which otherwise
        only see these collectives through the merged SPC counts."""
        if not self._running:
            return None
        buf = (ctypes.c_uint64 * 19)()
        out: dict[str, dict] = {}
        for kind, op in enumerate(self._COLL_KINDS):
            n = self._lib.tdcn_coll_optime(self._h, kind, buf, len(buf))
            if n < 3 or not buf[0]:
                continue
            out[op] = {
                "count": int(buf[0]),
                "wait_ns": int(buf[1]),
                "max_wait_ns": int(buf[2]),
                "lat_hist": [int(v) for v in buf[3:n]],
            }
        return out

    def stats_snapshot(self) -> dict[str, int] | None:
        """The C engine's telemetry block as {name: value} — relaxed
        snapshot (monotone per counter, not mutually consistent).
        Validates the layout version stamp; None once closed."""
        if not self._running:
            return None
        n = self._lib.tdcn_stats(self._h, self._stat_buf,
                                 len(self._stat_names))
        vals = list(self._stat_buf[:min(n, len(self._stat_names))])
        d = dict(zip(self._stat_names, vals))
        if d.pop("version", 0) != 1:
            return None  # layout drift: refuse to misattribute counters
        for k, v in self._py_stats.items():
            d[k] = d.get(k, 0) + v
        return d

    def waitinfo(self) -> list[dict]:
        """The C engine's registered blocked waits (tdcn_waitinfo),
        decoded into blocked-state snapshot rows — same relaxed-copy
        contract as stats_snapshot.  Empty when nothing is parked (the
        overwhelmingly common case: one ctypes call, no allocation
        C-side beyond the row scan)."""
        if not self._running:
            return []
        buf = ctypes.create_string_buffer(16384)
        n = self._lib.tdcn_waitinfo(self._h, buf, len(buf))
        if n <= 2:
            return []
        try:
            rows = json.loads(buf.value.decode("utf-8", "replace"))
        except ValueError:
            return []
        for r in rows:
            if r.get("peer", -1) is None or r.get("peer", -1) < 0:
                r["peer"] = None
            if not r.get("cid"):
                r["cid"] = None
        return rows

    # -- failure integration --------------------------------------------

    def note_proc_failed(self, proc: int) -> None:
        self._lib.tdcn_note_failed(self._h, proc)
        # the shared Python-side mark
        super().note_proc_failed(proc)

    def note_proc_recovered(self, proc: int,
                            incarnation: int | None = None) -> None:
        """replace(): a respawned incarnation re-published its endpoint
        — clear the C failure mark (blocked recvs naming it resume
        waiting instead of raising), then the shared Python-side
        recovery (detector clear + respawn accounting).  The rx dedup
        watermark deliberately SURVIVES the clear: a false-positive
        mark's sender is still the same lineage, and regressing its
        watermark would let a post-clear resend round re-deliver; the
        genuinely-dead corpse's state is pruned when set_addresses
        installs the reborn endpoint (address change = lineage proof)."""
        self._lib.tdcn_clear_failed(self._h, proc)
        super().note_proc_recovered(proc, incarnation)

    def note_proc_healed(self, proc: int) -> None:
        """False-positive heal (detector): same C-side clear, none of
        the respawn accounting."""
        self._lib.tdcn_clear_failed(self._h, proc)
        super().note_proc_healed(proc)

    def rx_watermark(self, proc: int) -> int:
        """Contiguous delivered-seq watermark for frames from ``proc``
        (max over its sender lineages; recovery observability + the
        watermark-continuity tests)."""
        return int(self._lib.tdcn_rx_watermark(self._h, int(proc)))

    def _bump_stat(self, name: str) -> None:
        self._py_stats[name] = self._py_stats.get(name, 0) + 1

    def close(self) -> None:
        if not self._running:
            return
        self._running = False
        if self._device_plane is not None:
            self._device_plane.close()
        self._lib.tdcn_close(self._h)
        if self._dispatcher.is_alive():
            self._dispatcher.join(timeout=2.0)

    def destroy(self) -> None:
        """Full teardown (``tdcn_destroy``): close, then free every
        engine-owned allocation and unlink the shared-memory names that
        no peer attached to (a job aborted at the modex).  Terminal:
        only on the way out of the process."""
        self.close()
        if self._h:
            doorbell = self.address.rsplit("|", 1)[-1]
            h, self._h = self._h, None
            self._lib.tdcn_destroy(h)
            # tdcn_destroy skips its unlink when a socket reader outlives
            # its 2 s drain (a TCP-leg peer still connected); the
            # doorbell's name is the address's last field
            if doorbell.startswith("/tdcn-db-"):
                with contextlib.suppress(OSError):
                    os.unlink("/dev/shm" + doorbell)

class NativeSubEngine(_NativeOpsMixin, DcnSubEngine):
    """Cross-process split view over a native engine (index remap only;
    byte plane shared with the root)."""

    def __init__(self, parent, procs: Sequence[int]):
        DcnSubEngine.__init__(self, parent, procs)

    def _native_root(self) -> NativeDcnEngine:
        return self.parent._native_root()

    def root_proc_of(self, local: int) -> int:
        return self.parent.root_proc_of(self.procs[local])

    def is_native_cid(self, cid) -> bool:
        return self._native_root().is_native_cid(cid)

    def register_native_p2p(self, cid) -> None:
        self._native_root().register_native_p2p(cid)

    def local_send(self, *a, **k) -> None:
        self._native_root().local_send(*a, **k)

    def take_handle(self, h: int):
        return self._native_root().take_handle(h)

    @property
    def _lib(self):
        return self._native_root()._lib

    @property
    def _h(self):
        return self._native_root()._h


class NativeJoinEngine(_NativeOpsMixin, DcnJoinEngine):
    """Spawn/join view across worlds over the native byte plane."""

    def __init__(self, local, addresses: Sequence[str], proc: int):
        DcnJoinEngine.__init__(self, local, addresses, proc)

    def _native_root(self) -> NativeDcnEngine:
        return self.parent._native_root()

    def root_proc_of(self, local: int) -> int:
        return -1  # FT does not span spawn worlds

    def is_native_cid(self, cid) -> bool:
        return self._native_root().is_native_cid(cid)

    def register_native_p2p(self, cid) -> None:
        self._native_root().register_native_p2p(cid)

    def local_send(self, *a, **k) -> None:
        self._native_root().local_send(*a, **k)

    def take_handle(self, h: int):
        return self._native_root().take_handle(h)

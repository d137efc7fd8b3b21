"""Device-resident zero-copy DCN plane — the third transport.

Port of ``ompi_tpu/dcn/device.py``.  The host planes (``btl/tcp``,
``btl/sm``, ``btl/native``) move every inter-process byte through host
shm/tcp rings.  This plane keeps large contiguous payloads out of them:
the sender places the payload in a per-transfer *window*, the host
plane carries only the window's descriptor, and the receiver reads the
window.  The rendezvous protocol picks the plane per message — the
priority/reachability arbitration the reference's btl framework runs
across sm/tcp/ofi (SURVEY §2.3).

Protocol (RTS/CTS ↔ DMA semaphores), as the reference's:

* **RTS** — the sender opens a window, places the payload (the DMA),
  publishes ``SEM_DATA``, and ships a control frame carrying the
  window's descriptor over the host plane;
* **recv-semaphore wait** — the receiver attaches the window and waits
  on its semaphore word until ``SEM_DATA`` is visible; only then is the
  payload read (``device_dma_waits``/``device_dma_wait_ns`` count the
  waits that blocked);
* **CTS / send-semaphore wait** — the receiver stores ``SEM_CONSUMED``
  after reading; the sender's *reap* retires consumed windows.

Two window kinds share one format.  Every window has the reference's
16-byte POSIX-shm header: the semaphore word (``SEM_EMPTY/DATA/
CONSUMED``), then the placed length.

* :class:`DeviceWindow` — the reference's window: the payload follows
  the header in the same shm segment.  Host arrays and CPU tensors ride
  it, with the reference's descriptor ``{"w", "n", "dt", "sh"}``
  (bfloat16 named ``"<V2"``, as on the host wires), so a port process
  and a reference process open each other's windows.
* :class:`CudaWindow` — a CUDA tensor's window: the header is an shm
  segment of its own and the payload lives in card memory exported by
  a CUDA IPC handle (``csrc/device_window.cu``).  Its descriptor adds
  the kind (``"k": "cuda"``) and the 64-byte handle in hex (``"ipc"``).
  The sender's copy completes before ``SEM_DATA``; the receiver copies
  into its posted tensor, synchronizes and unmaps before
  ``SEM_CONSUMED``, because the sender's reap frees the window.  Only
  a CUDA-tensor payload is ever staged this way.  A receiver holds a
  mapping only for the length of one copy, and never delivers bytes
  copied through a mapping whose exporter died: the descriptor names
  the exporting process (``"pid"``), which must be alive before the
  handle is opened and still alive after the copy, or the read fails
  as :class:`ExporterGone` (a peer failure, escalated like a deadline).

There is no quiet way off the card: given a CUDA tensor, a window
library that fails to build or load, or a CUDA error, raises
:class:`DeviceWindowError`.  The protocol's own counted degrade
(``device_fallbacks``: an injected drop, a peer marked failed, an shm
window that cannot open) stays as the reference has it.

Reachability: windows span one host; a peer on another host
(``OMPI_TPU_HOST_IDS``) stays on the host plane, and a host map that
cannot be trusted turns the plane off (fail closed).

Plane health (:class:`PlaneHealth`): consecutive per-peer strikes (a
receiver-side deadline expiry or truncated DMA, an injected fault)
demote the peer to the host plane at ``dcn_plane_strikes``; after
``dcn_plane_heal_interval`` seconds one eligible send is routed back as
a heal probe, whose consumption promotes the peer.  Transitions are
counted (``dcn_plane_*``), flight-recorded and logged.

Fault injection: ``site=device`` hooks the stage path (``drop``,
``trunc``, ``delay``/``stall``), ``site=device_recv`` the materialize
path (``delay``/``stall`` before the semaphore wait).
"""

from __future__ import annotations

import ctypes
import itertools
import os
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ompi_tpu_torch.core.errors import MPIInternalError
from ompi_tpu_torch.faultsim import core as _fsim
from ompi_tpu_torch.trace import waitgraph as _waitgraph

from .tcp import BF16_HOST, BF16_WIRE

#: semaphore word states (window header slot 0)
SEM_EMPTY, SEM_DATA, SEM_CONSUMED = 0, 1, 2

#: window header: [0:8) semaphore word, [8:16) payload length
_HDR = 16

#: counter schema — every key is in the metrics provider merge
#: (metrics.core.NATIVE_COUNTERS), so the plane surfaces as
#: ``dcn_device_*``/``dcn_plane_*`` pvars beside the host planes'
STATS_KEYS = (
    "device_sends", "device_recvs", "device_bytes_placed",
    "device_dma_waits", "device_dma_wait_ns",
    "device_arb_device", "device_arb_host", "device_fallbacks",
    # windows force-retired because their receiver was marked failed
    # between RTS and consume (each one is flight-recorded)
    "device_window_reclaimed",
    # plane-health transitions
    "plane_demotions", "plane_promotions", "plane_heal_probes",
)

#: the causes of a ``device_fallbacks`` count, one per site of
#: :meth:`DevicePlane.stage` (:attr:`DevicePlane.fallback_causes`): the
#: peer already marked failed, an injected drop, a window that could not
#: open, a staging copy that failed, a failure mark that landed while the
#: window was being staged, a close that raced the publish
FALLBACK_CAUSES = ("peer_failed", "injected_drop", "open_failed", "place_failed",
                   "failed_while_staging", "closing")

#: descriptor key the control frame carries (collops attaches it to the
#: coll envelope; the native plane rides the meta JSON under the same key)
DESC_KEY = "dev"
#: descriptor keys of a CUDA window: its kind, its IPC handle (hex) and
#: the exporting process
KIND_KEY, IPC_KEY, PID_KEY = "k", "ipc", "pid"
KIND_CUDA = "cuda"

_CUDA_SRC = Path(__file__).resolve().parents[1] / "csrc" / "device_window.cu"
_cuda = None
_cuda_lock = threading.Lock()


class DeviceWindowError(MPIInternalError):
    """The CUDA window library could not be built or loaded, or a CUDA
    call on a window failed.  Never turned into a host-plane send."""


class ExporterGone(DeviceWindowError):
    """The process that exported a CUDA window died before the receiver
    finished reading it: the bytes are not delivered."""


def exporter_alive(pid: int) -> bool:
    """Whether process ``pid`` still runs on this host (a zombie — killed,
    not yet reaped by its launcher — counts as dead)."""
    try:
        with open(f"/proc/{int(pid)}/stat", "rb") as f:
            state = f.read().rsplit(b")", 1)[1].split()[0]
    except (OSError, IndexError):
        return False
    return state not in (b"Z", b"X")


def _untrack_shm(name: str) -> None:
    """Detach from the resource tracker: window lifetime is protocol-
    owned (sender reaps after the consumed signal)."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister("/" + name, "shared_memory")
    except Exception:
        pass


# -- payload forms ---------------------------------------------------------


def wire_dtype(dt: np.dtype) -> str:
    """A host array's dtype as the wires name it: ``dtype.str``, except
    bfloat16's raw words, which carry the reference's ``"<V2"``."""
    return BF16_WIRE if dt == BF16_HOST else dt.str


def host_array(payload) -> np.ndarray:
    """A payload as the numpy array the host planes carry: a tensor's
    bytes (one D2H copy that synchronizes for a CUDA tensor; bfloat16 as
    its raw words); an array unchanged."""
    if not isinstance(payload, torch.Tensor):
        return payload
    t = payload.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_HOST)
    return t.numpy()


def _tensor_wire_dtype(dtype: torch.dtype) -> str:
    if dtype == torch.bfloat16:
        return BF16_WIRE
    return torch.empty(0, dtype=dtype).numpy().dtype.str


def _torch_dtype(dt: str) -> torch.dtype:
    if dt == BF16_WIRE or np.dtype(dt) == BF16_HOST:
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(dt))).dtype


def as_tensor(got, like: torch.Tensor) -> torch.Tensor:
    """A received payload (an array off a host plane or an shm window, or
    a tensor off a CUDA window) as a tensor of ``like``'s dtype and shape
    on ``like``'s device — the H2D of a chunk that rode the host plane."""
    if isinstance(got, torch.Tensor):
        return got.to(like.device).reshape(like.shape)
    a = np.ascontiguousarray(got)
    if like.dtype == torch.bfloat16:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy() if not a.flags.writeable else a)
        if t.dtype != like.dtype:
            raise MPIInternalError(f"{like.dtype} operand, {a.dtype} payload")
    return t.to(like.device).reshape(like.shape)


def _numpy_view(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's memory as a numpy array (no copy)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_HOST)
    return t.numpy()


# -- the CUDA window library ----------------------------------------------


def _cuda_lib():
    """Build (once per source) and load ``csrc/device_window.cu``."""
    global _cuda
    with _cuda_lock:
        if _cuda is None:
            from ompi_tpu_torch import native

            try:
                path, _log = native.build_cuda(_CUDA_SRC)
                lib = ctypes.CDLL(str(path))
            except (native.NativeBuildError, OSError) as e:
                raise DeviceWindowError(
                    f"device_window library unavailable: {e}") from e
            p, i, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
            lib.ompi_dw_alloc.argtypes = [i, u64, ctypes.POINTER(p)]
            lib.ompi_dw_free.argtypes = [i, p]
            lib.ompi_dw_ipc_handle.argtypes = [p, ctypes.c_char_p]
            lib.ompi_dw_ipc_open.argtypes = [i, ctypes.c_char_p, ctypes.POINTER(p)]
            lib.ompi_dw_ipc_close.argtypes = [i, p]
            lib.ompi_dw_copy.argtypes = [p, p, u64, p]
            lib.ompi_dw_ipc_handle_size.argtypes = []
            for fn in ("alloc", "free", "ipc_handle", "ipc_handle_size",
                       "ipc_open", "ipc_close", "copy"):
                getattr(lib, f"ompi_dw_{fn}").restype = i
            lib.ompi_dw_error_string.argtypes = [i]
            lib.ompi_dw_error_string.restype = ctypes.c_char_p
            _cuda = lib
        return _cuda


def _cuda_check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise DeviceWindowError(
            f"device window {what}: {lib.ompi_dw_error_string(rc).decode()} "
            f"(cudaError {rc})")


def _stream(device: int) -> int:
    return torch.cuda.current_stream(device).cuda_stream


class DeviceWindow:
    """One per-transfer shm window — the emulated HBM exposure.

    Layout: ``[0:8)`` semaphore word (int64; SEM_* states), ``[8:16)``
    payload length, ``[16:)`` payload bytes.  The semaphore publish is
    a plain int64 store after the payload copy — safe on x86 TSO, the
    same contract the host ``_ShmRing`` documents (the host-plane
    control frame orders sender→receiver; the word orders DMA→read)."""

    def __init__(self, name: str, size: int, create: bool):
        from multiprocessing import shared_memory

        self.seg = shared_memory.SharedMemory(
            name=name, create=create, size=size + _HDR if create else 0)
        _untrack_shm(name)
        self.name = name
        self._ctr = np.frombuffer(self.seg.buf, np.int64, count=2)
        self._data = np.frombuffer(self.seg.buf, np.uint8, offset=_HDR)
        if create:
            self._ctr[0] = SEM_EMPTY
            self._ctr[1] = 0

    # -- sender side (the DMA) ------------------------------------------

    def place(self, raw: memoryview) -> None:
        """The emulated HBM→HBM DMA: one copy into the window, then the
        completion signal (recv-semaphore value) publishes."""
        n = len(raw)
        if n:
            self._data[:n] = np.frombuffer(raw, np.uint8)
        self._ctr[1] = n
        self._ctr[0] = SEM_DATA  # publish AFTER the payload (TSO)

    # -- receiver side (semaphore wait + read) --------------------------

    def sem(self) -> int:
        return int(self._ctr[0])

    def wait_data(self, deadline) -> None:
        """The recv-semaphore wait: spin (with backoff) until the DMA
        completion signal is visible, bounded by the shared DCN deadline
        policy."""
        sleep = 0.0
        while int(self._ctr[0]) < SEM_DATA:
            deadline.check("device window: DMA completion signal "
                           "not visible (sender stalled or dead)")
            time.sleep(sleep)
            sleep = min(0.001, sleep + 0.00005)

    def read_into(self, out: memoryview, n: int) -> None:
        np.frombuffer(out[:n], np.uint8)[:] = self._data[:n]

    def consume(self) -> None:
        """The CTS analog: signal the sender's send-semaphore wait (reap)
        that this window can be retired."""
        self._ctr[0] = SEM_CONSUMED

    def close(self, unlink: bool = False) -> None:
        if unlink:
            # raw shm_unlink, not SharedMemory.unlink(): creation already
            # detached the segment from the resource tracker, and the
            # stdlib unlink would unregister a second time (the tracker
            # logs a KeyError traceback for every window otherwise)
            try:
                import _posixshmem

                _posixshmem.shm_unlink("/" + self.name)
            except FileNotFoundError:
                pass
            except (ImportError, OSError):
                try:
                    self.seg.unlink()
                except FileNotFoundError:
                    pass
        # release the numpy views before the mapping: they export
        # pointers from seg.buf, and SharedMemory.close() raises
        # BufferError while exports exist
        self._ctr = None
        self._data = None
        try:
            self.seg.close()
        except BufferError:  # a payload view escaped: the destructor
            pass             # retries after GC drops it


class CudaWindow:
    """A CUDA tensor's window: the reference's 16-byte shm header (the
    semaphore word and the placed length) and ``nbytes`` of card memory
    on ``device``, allocated with ``cudaMalloc`` and exported by its IPC
    handle.  The sender's side: reap and reclaim retire it like a
    :class:`DeviceWindow` (``sem``/``close``), and ``close`` frees the
    card memory."""

    def __init__(self, name: str, nbytes: int, device: int):
        self._lib = _cuda_lib()
        self.name = name
        self.nbytes = int(nbytes)
        self.device = int(device)
        self.hdr = DeviceWindow(name, 0, create=True)
        self.ptr = ctypes.c_void_p()
        try:
            _cuda_check(self._lib, self._lib.ompi_dw_alloc(
                self.device, self.nbytes, ctypes.byref(self.ptr)), "cudaMalloc")
            buf = ctypes.create_string_buffer(self._lib.ompi_dw_ipc_handle_size())
            _cuda_check(self._lib, self._lib.ompi_dw_ipc_handle(self.ptr, buf),
                        "cudaIpcGetMemHandle")
        except DeviceWindowError:
            self.close(unlink=True)
            raise
        self.handle = buf.raw

    @property
    def _ctr(self):
        return self.hdr._ctr

    def place(self, src: torch.Tensor) -> None:
        """The DMA: copy ``src`` into the window on the current stream and
        wait for it, then publish the completion signal."""
        _cuda_check(self._lib, self._lib.ompi_dw_copy(
            self.ptr, ctypes.c_void_p(src.data_ptr()), self.nbytes,
            ctypes.c_void_p(_stream(self.device))), "copy in")
        self.hdr._ctr[1] = self.nbytes
        self.hdr._ctr[0] = SEM_DATA

    def sem(self) -> int:
        return self.hdr.sem()

    def close(self, unlink: bool = False) -> None:
        if self.ptr.value:
            ptr, self.ptr = self.ptr, ctypes.c_void_p()
            _cuda_check(self._lib, self._lib.ompi_dw_free(self.device, ptr),
                        "cudaFree")
        self.hdr.close(unlink=unlink)


def landing_device(into) -> torch.device:
    """The card a CUDA window's bytes land on: ``into``'s (a posted
    tensor, or a ``torch.device`` naming the receiving rank's card) when
    it is on CUDA, else the current card."""
    dev = into.device if isinstance(into, torch.Tensor) else into
    if isinstance(dev, torch.device) and dev.type == "cuda":
        return dev
    return torch.device("cuda", torch.cuda.current_device())


def _cuda_read(desc: dict, into, shape, dtype: torch.dtype, nbytes: int):
    """The receiver's half of a CUDA window: map the sender's window, copy
    it into the posted tensor (or a new one on the receiving rank's card,
    :func:`landing_device`), wait, and unmap — all before the caller
    signals consumed.  The exporter must be alive before the mapping
    opens and after the copy ends."""
    pid = desc.get(PID_KEY)
    if pid is not None and not exporter_alive(pid):
        raise ExporterGone(f"device window {desc['w']}: exporter {pid} is gone")
    lib = _cuda_lib()
    if (isinstance(into, torch.Tensor) and into.is_cuda and into.is_contiguous()
            and into.dtype == dtype and tuple(into.shape) == shape):
        out = into
    else:
        out = torch.empty(shape, dtype=dtype, device=landing_device(into))
    dev = out.device.index
    ptr = ctypes.c_void_p()
    _cuda_check(lib, lib.ompi_dw_ipc_open(dev, bytes.fromhex(desc[IPC_KEY]),
                                          ctypes.byref(ptr)), "cudaIpcOpenMemHandle")
    try:
        _cuda_check(lib, lib.ompi_dw_copy(ctypes.c_void_p(out.data_ptr()), ptr,
                                          nbytes, ctypes.c_void_p(_stream(dev))),
                    "copy out")
    finally:
        _cuda_check(lib, lib.ompi_dw_ipc_close(dev, ptr), "cudaIpcCloseMemHandle")
    if pid is not None and not exporter_alive(pid):
        raise ExporterGone(f"device window {desc['w']}: exporter {pid} died during the copy")
    return out


# -- tuning ----------------------------------------------------------------


def device_tuning() -> tuple[bool, int, bool]:
    """Resolve (enable, min_size, interpret) against the default MCA
    context, falling back to the central DEVICE_VARS defaults (bare
    engines in unit tests)."""
    from ompi_tpu_torch.core.var import DEVICE_VARS, full_var_name

    vals: dict[str, object] = {
        full_var_name(fw, comp, name): default
        for fw, comp, name, default, _typ, _h in DEVICE_VARS
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
    return (bool(vals["dcn_device_enable"]),
            int(vals["dcn_device_min_size"]),
            bool(vals["dcn_device_interpret"]))


def plane_tuning() -> tuple[int, float]:
    """Resolve (strikes, heal_interval) for the plane-health table
    against the default MCA context, falling back to the central
    ROBUSTNESS_VARS defaults."""
    from ompi_tpu_torch.core.var import ROBUSTNESS_VARS, full_var_name

    vals: dict[str, object] = {}
    for fw, comp, name, default, _typ, _h in ROBUSTNESS_VARS:
        full = full_var_name(fw, comp, name)
        if full in ("dcn_plane_strikes", "dcn_plane_heal_interval"):
            vals[full] = default
    try:
        from ompi_tpu_torch.core import mca

        store = mca.default_context().store
        for full in vals:
            v = store.get(full)
            if v is not None:
                vals[full] = v
    except Exception:  # noqa: BLE001 — pre-init / teardown: defaults
        pass
    return (int(vals["dcn_plane_strikes"]),
            float(vals["dcn_plane_heal_interval"]))


class PlaneHealth:
    """Per-(peer, plane) failover state machine — the health half of
    btl selection, per peer, mid-job and reversibly.

    States per peer::

        healthy --strike x dcn_plane_strikes--> demoted
        demoted --dcn_plane_heal_interval-----> probing (one send)
        probing --probe consumed--------------> healthy  (promotion)
        probing --probe failed----------------> demoted  (re-armed)

    Strikes are consecutive: any consumed window toward the peer resets
    the count.  Every demotion/probe/promotion is counted on the owning
    plane's stats block, flight-recorded, and appended to
    :attr:`transitions`.  ``clear()`` (the replace()/respawn path)
    forgets a peer entirely."""

    def __init__(self, plane: str = "device",
                 strikes: int | None = None,
                 heal_interval: float | None = None,
                 stats: dict | None = None):
        if strikes is None or heal_interval is None:
            s, h = plane_tuning()
            strikes = s if strikes is None else strikes
            heal_interval = h if heal_interval is None else heal_interval
        self.plane = plane
        self.max_strikes = max(1, int(strikes))
        self.heal_interval = float(heal_interval)
        self.stats = stats if stats is not None else {
            "plane_demotions": 0, "plane_promotions": 0,
            "plane_heal_probes": 0}
        self._strikes: dict[int, int] = {}
        #: proc → monotonic time of the demotion (or last failed probe)
        self._demoted: dict[int, float] = {}
        #: procs with one probe send in flight (at most one at a time)
        self._probing: set[int] = set()
        #: proc → monotonic probe-start time: a probe never consumed
        #: resolves failed after :meth:`probe_timeout`
        self._probe_t: dict[int, float] = {}
        #: append-only (event, proc, cause) transition log; events:
        #: demote / probe / promote / probe_fail / clear
        self.transitions: list[tuple] = []
        self._lock = threading.Lock()

    def _record(self, event: str, proc: int, cause: str) -> None:
        # called under self._lock
        self.transitions.append((event, int(proc), cause))
        from ompi_tpu_torch.metrics import flight as _flight

        _flight.record(f"plane_{event}", plane=self.plane,
                       proc=int(proc),
                       **({"cause": cause} if cause else {}))

    def ok(self, proc: int | None) -> bool:
        """True while the (peer, plane) pair is not demoted (unknown
        peers are healthy)."""
        if proc is None:
            return True
        with self._lock:
            return int(proc) not in self._demoted

    def strike(self, proc: int | None, cause: str) -> bool:
        """One failure toward ``proc`` on this plane.  Returns True when
        this strike crossed ``dcn_plane_strikes`` and demoted the pair."""
        if proc is None:
            return False
        p = int(proc)
        with self._lock:
            if p in self._demoted:
                return False  # already off the plane
            n = self._strikes.get(p, 0) + 1
            self._strikes[p] = n
            if n < self.max_strikes:
                return False
            self._demoted[p] = time.monotonic()
            self._probing.discard(p)
            self._probe_t.pop(p, None)
            self.stats["plane_demotions"] += 1
            self._record("demote", p, cause)
            return True

    def success(self, proc: int | None) -> None:
        """A consumed (non-probe) window toward ``proc``: strikes are
        consecutive, so any success resets the count."""
        if proc is None:
            return
        with self._lock:
            self._strikes.pop(int(proc), None)

    def allow_probe(self, proc: int | None) -> bool:
        """Heal schedule: True routes THIS send through the demoted plane
        as the probe — at most one in flight per peer, never before
        ``dcn_plane_heal_interval`` has elapsed since the demotion (or
        the last failed probe).  <= 0 disables probing."""
        if proc is None or self.heal_interval <= 0:
            return False
        p = int(proc)
        now = time.monotonic()
        with self._lock:
            since = self._demoted.get(p)
            if since is None:
                return False
            if p in self._probing:
                if now - self._probe_t.get(p, since) > self.probe_timeout():
                    # the probe window was never consumed: resolve it
                    # failed and re-arm (the slot must not wedge)
                    self._probing.discard(p)
                    self._probe_t.pop(p, None)
                    self._demoted[p] = now
                    self._record("probe_fail", p, "probe_timeout")
                return False
            if now - since < self.heal_interval:
                return False
            self._probing.add(p)
            self._probe_t[p] = now
            self.stats["plane_heal_probes"] += 1
            self._record("probe", p, "")
            return True

    def probe_timeout(self) -> float:
        """Seconds an in-flight probe may stay unresolved before it is
        declared failed (bounded by the heal cadence, never sub-second)."""
        return max(2.0 * self.heal_interval, 1.0)

    def probing(self, proc: int | None) -> bool:
        if proc is None:
            return False
        with self._lock:
            return int(proc) in self._probing

    def probe_outcome(self, proc: int | None, success: bool,
                      cause: str = "") -> None:
        """Resolve an in-flight probe: consumed → promotion; failed →
        the heal interval re-arms from now."""
        if proc is None:
            return
        p = int(proc)
        with self._lock:
            if p not in self._probing:
                return
            self._probing.discard(p)
            self._probe_t.pop(p, None)
            if success:
                self._demoted.pop(p, None)
                self._strikes.pop(p, None)
                self.stats["plane_promotions"] += 1
                self._record("promote", p, "")
            else:
                self._demoted[p] = time.monotonic()
                self._record("probe_fail", p, cause)

    def clear(self, proc: int | None) -> None:
        """Forget a peer's health state (a reborn incarnation, or a false
        positive) — the health marks clear with the failure marks."""
        if proc is None:
            return
        p = int(proc)
        with self._lock:
            had = (p in self._demoted or p in self._strikes
                   or p in self._probing)
            self._strikes.pop(p, None)
            self._demoted.pop(p, None)
            self._probing.discard(p)
            self._probe_t.pop(p, None)
            if had:
                self._record("clear", p, "")


class DevicePlane:
    """Per-engine device-plane state: arbitration, window lifecycle, and
    the ``dcn_device_*`` counter block (a metrics provider like the host
    transports)."""

    def __init__(self, proc: int, min_size: int | None = None,
                 hosts: list[int] | None = None):
        self.proc = int(proc)
        if min_size is None:
            min_size = device_tuning()[1]
        self.min_size = int(min_size)
        #: per-process host index when the launcher published a host map
        self.hosts = hosts
        self.stats: dict[str, int] = {k: 0 for k in STATS_KEYS}
        #: ``device_fallbacks`` by cause (kept out of the counter block,
        #: whose keys are the reference's)
        self.fallback_causes: dict[str, int] = dict.fromkeys(FALLBACK_CAUSES, 0)
        self._wids = itertools.count(1)
        #: sender-owned windows awaiting the consumed signal:
        #: wid → (window, dst root proc, staging op key, probe)
        self._tx: dict[int, tuple] = {}
        #: procs whose windows are reclaimed on sight (a failure mark
        #: that lands while a stage() is in flight); cleared on
        #: recover/heal
        self._failed: set[int] = set()
        self._lock = threading.Lock()
        self._running = True
        #: the per-(peer, plane) failover state machine, on this plane's
        #: stats block (its transitions surface as dcn_plane_* pvars)
        self.health = PlaneHealth(plane="device", stats=self.stats)
        from ompi_tpu_torch.metrics import core as _mcore

        _mcore.register_provider(self, self._stats_snapshot)

    # -- plane arbitration (the btl priority/reachability pick) ---------

    def reachable(self, dst_root_proc: int | None) -> bool:
        """Windows span one host: a peer with a different host index in
        the launcher's map is unreachable on this plane."""
        if self.hosts is None or dst_root_proc is None:
            return True
        if not 0 <= dst_root_proc < len(self.hosts):
            return False
        return self.hosts[dst_root_proc] == self.hosts[self.proc]

    def eligible(self, payload) -> bool:
        """Size/layout half of the arbitration — no counters.  A
        C-contiguous numpy array (the reference's rule), or a contiguous
        CPU or CUDA tensor, of at least ``dcn_device_min_size`` bytes."""
        if isinstance(payload, torch.Tensor):
            nbytes = payload.numel() * payload.element_size()
            return (payload.device.type in ("cpu", "cuda")
                    and nbytes >= self.min_size and nbytes > 0
                    and payload.is_contiguous())
        if not isinstance(payload, np.ndarray):
            return False
        if payload.nbytes < self.min_size:
            return False
        if payload.dtype.hasobject:
            return False
        return bool(payload.flags["C_CONTIGUOUS"])

    def arbitrate(self, payload, dst_root_proc: int | None = None) -> bool:
        """THE per-message plane decision: True routes the payload onto
        the device plane.  Size/layout/reachability say the plane *can*
        carry it; the health table says it currently *should* — a
        demoted peer's traffic stays host-side except for the one send
        the heal schedule routes through as a probe.  Every decision is
        counted (``device_arb_device`` / ``device_arb_host``)."""
        take = (self._running and self.eligible(payload)
                and self.reachable(dst_root_proc))
        if take and not self.health.ok(dst_root_proc):
            # a consumed probe window may be waiting to promote the
            # peer: reap here, because a demoted peer's traffic never
            # reaches stage() (reap's usual caller)
            self.reap()
            take = (self.health.ok(dst_root_proc)
                    or self.health.allow_probe(dst_root_proc))
        self.stats["device_arb_device" if take else
                   "device_arb_host"] += 1
        return take

    # -- sender: stage (DMA start) + reap (send-semaphore wait) ---------

    def stage(self, arr, dst_proc: int | None = None) -> dict | None:
        """Open a window, issue the DMA, and return the descriptor the
        host-plane control frame carries — or None when the window
        cannot be opened (the caller degrades to the host plane;
        ``device_fallbacks`` counted).  ``arr`` is a numpy array or a
        tensor; a CUDA tensor gets a :class:`CudaWindow`, whose CUDA
        errors raise.  ``dst_proc`` (root index) is remembered with the
        window so a peer-failure mark can reclaim it."""
        self.reap()
        cuda = isinstance(arr, torch.Tensor) and arr.is_cuda
        if isinstance(arr, torch.Tensor) and not cuda:
            arr = _numpy_view(arr.detach())
        #: is this send the heal probe arbitration routed through a
        #: demoted plane?  Its window is tagged so reap/reclaim can
        #: resolve the probe
        probe = dst_proc is not None and self.health.probing(dst_proc)
        if dst_proc is not None and dst_proc in self._failed:
            # the peer is already marked dead: degrade to the host plane
            # (where the failure surfaces through the normal escalation)
            if probe:
                self.health.probe_outcome(dst_proc, False, "peer_failed")
            self._fallback("peer_failed")
            return None
        trunc = False
        if _fsim._enabled:
            for act in _fsim.actions("device",
                                     kinds={"drop", "delay", "trunc",
                                            "stall"}):
                if act.kind in ("delay", "stall"):
                    _fsim.apply_delay(act)
                elif act.kind == "drop":
                    # simulated DMA failure: the stage aborts before a
                    # descriptor exists, so the caller re-issues the
                    # payload as an ordinary host-plane frame (its own
                    # per-peer seq: delivery stays exactly-once)
                    if probe:
                        self.health.probe_outcome(
                            dst_proc, False, "injected_drop")
                    else:
                        self.health.strike(dst_proc, "injected_drop")
                    self._fallback("injected_drop")
                    return None
                elif act.kind == "trunc":
                    trunc = True  # short DMA length published below
        nbytes = (arr.numel() * arr.element_size()) if cuda else int(arr.nbytes)
        wid = next(self._wids)
        name = f"tpudev-{os.getpid()}-{wid}-{id(self) & 0xffff:x}"
        try:
            win = (CudaWindow(name, nbytes, arr.device.index) if cuda
                   else DeviceWindow(name, nbytes, create=True))
        except OSError:
            if probe:
                self.health.probe_outcome(dst_proc, False, "open_failed")
            self._fallback("open_failed")
            return None
        from ompi_tpu_torch.trace import causal as _causal

        okey = _causal.current_key() if _causal._enabled else None
        # the DMA runs BEFORE the window is published into _tx: a
        # concurrent peer-failure reclaim may close any _tx window at
        # any moment.  No receiver can race either way — the descriptor
        # frame is sent by the caller after stage() returns.
        try:
            if cuda:
                win.place(arr.detach())
            else:
                win.place(memoryview(arr).cast("B") if arr.nbytes
                          else memoryview(b""))
            if trunc and nbytes:
                # injected short DMA: the receiver's materialize checks
                # the placed length and escalates
                win._ctr[1] = nbytes - 1
        except Exception:
            # a failed staging copy must not strand the window; an shm
            # copy degrades to the host plane, a CUDA error raises
            win.close(unlink=True)
            if cuda:
                raise
            if probe:
                self.health.probe_outcome(dst_proc, False, "place_failed")
            self._fallback("place_failed")
            return None
        with self._lock:
            self._tx[wid] = (win, dst_proc, okey, probe)
        if dst_proc is not None and dst_proc in self._failed:
            # the failure mark landed while we were staging: the reclaim
            # scan ran before our publish — retire it ourselves
            self.reclaim_failed(dst_proc)
            self._fallback("failed_while_staging")
            return None
        if not self._running:
            # close() raced our publish: retire it ourselves and degrade
            with self._lock:
                gone = self._tx.pop(wid, None)
            if gone is not None:
                win.close(unlink=True)
            if probe:
                self.health.probe_outcome(dst_proc, False, "closing")
            self._fallback("closing")
            return None
        if cuda:
            desc = {"w": name, "n": nbytes, "dt": _tensor_wire_dtype(arr.dtype),
                    "sh": list(arr.shape),
                    KIND_KEY: KIND_CUDA, IPC_KEY: win.handle.hex(), PID_KEY: os.getpid()}
        else:
            desc = {"w": name, "n": nbytes, "dt": wire_dtype(arr.dtype),
                    "sh": list(arr.shape)}
        self.stats["device_sends"] += 1
        self.stats["device_bytes_placed"] += nbytes
        return desc

    def _fallback(self, cause: str) -> None:
        """One degrade to the host plane, counted with its cause."""
        self.stats["device_fallbacks"] += 1
        self.fallback_causes[cause] += 1

    def reap(self) -> int:
        """Send-semaphore wait, non-blocking form: retire every window the
        receiver has signalled consumed.  Returns the number retired."""
        done = []
        with self._lock:
            for wid, (win, dst, _k, probe) in list(self._tx.items()):
                if win.sem() >= SEM_CONSUMED:
                    done.append((win, dst, probe))
                    del self._tx[wid]
        for win, dst, probe in done:
            win.close(unlink=True)
            if probe:
                self.health.probe_outcome(dst, True)
            else:
                self.health.success(dst)
        return len(done)

    def reclaim_failed(self, dst_proc: int) -> int:
        """Peer-failure reclaim: force-retire every window staged toward
        ``dst_proc`` — a dead receiver can never signal consumed.
        Counted (``dcn_device_window_reclaimed``) and flight-recorded
        per window."""
        victims = []
        with self._lock:
            self._failed.add(int(dst_proc))
            for wid, (win, dst, okey, probe) in list(self._tx.items()):
                if dst is not None and int(dst) == int(dst_proc):
                    victims.append((win, okey, probe))
                    del self._tx[wid]
        if not victims:
            return 0
        from ompi_tpu_torch.metrics import flight as _flight

        for win, okey, probe in victims:
            self.stats["device_window_reclaimed"] += 1
            _flight.record("device_window_reclaimed",
                           proc=int(dst_proc), window=win.name,
                           **({"op": okey} if okey else {}))
            win.close(unlink=True)
            if probe:  # a reclaimed probe window can never be consumed
                self.health.probe_outcome(dst_proc, False, "peer_failed")
        return len(victims)

    def clear_failed(self, dst_proc: int) -> None:
        """Recover/heal: the peer is back — new windows toward it are
        welcome again, and its health marks clear."""
        with self._lock:
            self._failed.discard(int(dst_proc))
        self.health.clear(int(dst_proc))

    def pending_windows(self) -> int:
        with self._lock:
            return len(self._tx)

    # -- receiver: recv-semaphore wait + materialize --------------------

    def receive(self, desc: dict, into=None, src_root: int | None = None):
        """Materialize one device-plane payload from its descriptor
        (counted on this plane)."""
        return receive(desc, into=into, stats=self.stats,
                       src_root=src_root)

    # -- provider / lifecycle -------------------------------------------

    def _stats_snapshot(self) -> dict[str, int] | None:
        return dict(self.stats) if self._running else None

    def close(self, drain_timeout: float = 2.0) -> None:
        """Drain-then-close: stop arbitration first, then give in-flight
        staged windows a bounded time to be consumed (a receiver
        mid-materialize holds live mappings into them); whatever the
        deadline leaves unconsumed is swept anyway."""
        self._running = False
        if drain_timeout > 0 and self.pending_windows():
            from ompi_tpu_torch.core.var import Deadline

            dl = Deadline(float(drain_timeout))
            sleep = 0.0
            while self.pending_windows():
                self.reap()
                if not self.pending_windows() or dl.expired():
                    break
                time.sleep(sleep)
                sleep = min(0.002, sleep + 0.0001)
        with self._lock:
            wins = [w for w, _dst, _k, _p in self._tx.values()]
            self._tx.clear()
        for win in wins:
            win.close(unlink=True)


def try_stage(root_engine, payload, dst_root_proc):
    """Sender-side plane pick, shared by every send site: arbitrate, then
    stage through the engine's plane.  Returns the window descriptor the
    host-plane control frame carries, or None when the payload stays on
    the host plane."""
    dp = getattr(root_engine, "_device_plane", None)
    if dp is None or not isinstance(payload, (np.ndarray, torch.Tensor)):
        return None
    if not dp.arbitrate(payload, dst_root_proc):
        return None
    return dp.stage(payload, dst_proc=dst_root_proc)


def materialize(root_engine, desc: dict, into=None,
                src_root: int | None = None):
    """Receiver-side plane pick, shared by every delivery site:
    materialize through the engine's plane when one is armed (counters
    tick), else the plane-less twin.

    Failure semantics (the ULFM half): an expired semaphore wait, a
    truncated DMA or a CUDA window whose exporter died, with ``src_root``
    known, strikes the plane-health table for the sender, reclaims every
    window we have staged toward it, and converges on the engine's ``_escalate_deadline`` (flight record,
    counters, detector mark, ``MPIProcFailedError``)."""
    from ompi_tpu_torch.core.errors import (DeadlineExpiredError,
                                            MPITruncateError)

    dp = getattr(root_engine, "_device_plane", None)
    try:
        return (dp.receive(desc, into=into, src_root=src_root)
                if dp is not None
                else receive(desc, into=into, src_root=src_root))
    except (DeadlineExpiredError, MPITruncateError, ExporterGone) as e:
        cause = ("trunc" if isinstance(e, MPITruncateError)
                 else "exporter_gone" if isinstance(e, ExporterGone)
                 else "deadline")
        if dp is not None and src_root is not None:
            dp.health.strike(int(src_root), cause)
            dp.reclaim_failed(int(src_root))
        esc = getattr(root_engine, "_escalate_deadline", None)
        if esc is None or src_root is None:
            raise  # plane-less / peer-less: typed error, caller owns it
        from ompi_tpu_torch.core.var import dcn_timeout

        esc("device_recv", dcn_timeout("recv"),
            f"device window materialize from proc {int(src_root)} "
            f"failed ({cause}): {e}",
            failed_rank=int(src_root), root_proc=int(src_root),
            window=str(desc.get("w")), cause=cause)
        raise  # unreachable: _escalate_deadline raises


def receive(desc: dict, into=None, stats: dict | None = None,
            src_root: int | None = None):
    """Receiver half of the device protocol: attach the descriptor's
    window, run the recv-semaphore wait (counted when it blocked), land
    the bytes (straight into a matching posted buffer — a numpy array or
    a tensor — when given: identity tells the caller nothing is left to
    copy), signal consumed, detach.  An shm window yields a numpy array
    (or the posted buffer); a CUDA window a tensor on the card ``into``
    names (a posted tensor's, or a ``torch.device``: the receiving
    rank's), else the current one."""
    from ompi_tpu_torch.core.var import Deadline

    name, nbytes = str(desc["w"]), int(desc["n"])
    dts = str(desc.get("dt", "u1"))
    shape = tuple(desc.get("sh") or (0,))
    if _fsim._enabled:
        # receiver-side latency injection, BEFORE the semaphore wait
        for act in _fsim.actions("device_recv", kinds={"delay", "stall"}):
            _fsim.apply_delay(act)
    win = DeviceWindow(name, 0, create=False)
    try:
        if win.sem() < SEM_DATA:
            # the descriptor outran the DMA: the semaphore wait the
            # protocol exists for (registered with the mesh doctor: a
            # stalled DMA is this plane's blocked-wait site)
            t0 = time.perf_counter_ns()
            wtok = (_waitgraph.begin("device_recv", peer=src_root,
                                     plane="device", cid=name)
                    if _waitgraph._enabled else 0)
            try:
                win.wait_data(Deadline.for_timeout("recv"))
            finally:
                if wtok:
                    _waitgraph.end(wtok)
            if stats is not None:
                stats["device_dma_waits"] += 1
                stats["device_dma_wait_ns"] += (
                    time.perf_counter_ns() - t0)
        placed = int(win._ctr[1])
        if placed != nbytes:
            # the DMA placed fewer bytes than the descriptor promised:
            # typed error, never a partial read
            from ompi_tpu_torch.core.errors import MPITruncateError

            raise MPITruncateError(
                f"device window {name}: DMA placed {placed} bytes, "
                f"descriptor promised {nbytes}")
        if desc.get(KIND_KEY) == KIND_CUDA:
            out = _cuda_read(desc, into, shape, _torch_dtype(dts), nbytes)
        else:
            dt = np.dtype(dts)
            view = (_numpy_view(into) if isinstance(into, torch.Tensor)
                    and into.device.type == "cpu" and into.is_contiguous()
                    else into)
            if (isinstance(view, np.ndarray)
                    and view.flags["C_CONTIGUOUS"]
                    and view.dtype == dt
                    and tuple(view.shape) == shape
                    and view.nbytes == nbytes):
                if nbytes:
                    win.read_into(memoryview(view).cast("B"), nbytes)
                out = into
            else:
                out = np.empty(shape, dt)
                if nbytes:
                    win.read_into(memoryview(out).cast("B"), nbytes)
        win.consume()
        if stats is not None:
            stats["device_recvs"] += 1
        return out
    finally:
        # consumer-side unlink: the window name dies with consumption
        # (POSIX keeps both mappings valid); the sender's reap/close
        # tolerates the already-unlinked name
        win.close(unlink=True)


def maybe_create(proc: int, nprocs: int) -> DevicePlane | None:
    """Engine hook: a DevicePlane when ``dcn_device_enable`` is on (the
    default), else None — one attribute test per send after.  Parses
    the launcher's host map (``OMPI_TPU_HOST_IDS``) for the reachability
    half of the arbitration."""
    en, msize, _interp = device_tuning()
    if not en:
        return None
    import platform
    import sys

    if sys.platform != "linux" or \
            platform.machine().lower() not in ("x86_64", "amd64"):
        # the shm header leans on the same shm + TSO contract as btl/sm
        return None
    hosts: list[int] | None = None
    raw = os.environ.get("OMPI_TPU_HOST_IDS", "")
    if raw:
        # a present host map that cannot be trusted (unparseable, or its
        # length no longer matches this world) means the topology is
        # unknown: fail closed and keep every byte on the host plane.
        # An absent map is a single-host launch.
        try:
            parsed = [int(x) for x in raw.split(",") if x.strip() != ""]
        except ValueError:
            return None
        if len(parsed) != int(nprocs):
            return None
        hosts = parsed
    return DevicePlane(proc, min_size=msize, hosts=hosts)

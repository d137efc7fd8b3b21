"""C-API bridge — the Python half of the port's libtpumpi.

Port of ``ompi_tpu/capi.py``.  ``csrc/capi/shim.c`` (built into
``build/ompi_tpu_torch/libtpumpi.so`` by :func:`ompi_tpu_torch.native.build_capi`)
embeds CPython and marshals raw C buffer addresses + handle/datatype/op
codes into these functions, which wrap the memory as numpy views
(zero-copy) and drive the same communicator/coll/pml machinery as the
Python API.

Execution model: **one OS process = one MPI rank** (the mpirun model).
Under ``python -m ompi_tpu_torch run`` each process must hold exactly
one virtual rank (``--nranks 1``); a standalone C program gets a
size-1 world.  The world runs on CUDA unless the launcher's ``--cpu``
switch (or ``OMPI_TPU_DEVICE=cpu`` for a standalone program) puts it on
the CPU; without a card that default raises.  A C buffer is host
memory: a collective hands its row to the communicator as a tensor on
the world's device (one H2D copy on the card, none on the CPU) and
copies the result back into the C buffer; point-to-point stays on host
views, as in the reference.  Constants here mirror
``csrc/capi/include/mpi.h`` — keep the two in sync.

Every entry point returns an int MPI error class, or a tuple whose
first element is the error class (the shim copies the remaining ints
out before releasing the GIL).
"""

from __future__ import annotations

import ctypes
import time
import traceback

import numpy as np
import torch

from ompi_tpu_torch.core import errors as err
from ompi_tpu_torch.ddt.datatype import from_numpy, to_numpy
from ompi_tpu_torch.op import op as opmod
from ompi_tpu_torch.request import CompletedRequest, Request

# -- error classes (mpi.h) ---------------------------------------------
MPI_SUCCESS = 0
MPI_ERR_COUNT = 2
MPI_ERR_TYPE = 3
MPI_ERR_TAG = 4
MPI_ERR_COMM = 5
MPI_ERR_RANK = 6
MPI_ERR_REQUEST = 7
MPI_ERR_ROOT = 8
MPI_ERR_OP = 9
MPI_ERR_ARG = 12
MPI_ERR_TRUNCATE = 14
MPI_ERR_OTHER = 15
MPI_ERR_INTERN = 16

_IN_PLACE = (1 << 64) - 1  # (void*)-1 seen as unsigned long long

# -- datatype codes (mpi.h) --------------------------------------------
DTYPES: dict[int, np.dtype] = {
    1: np.dtype(np.int8),      # MPI_CHAR
    2: np.dtype(np.int8),      # MPI_SIGNED_CHAR
    3: np.dtype(np.uint8),     # MPI_UNSIGNED_CHAR
    4: np.dtype(np.uint8),     # MPI_BYTE
    5: np.dtype(np.int16),     # MPI_SHORT
    6: np.dtype(np.uint16),    # MPI_UNSIGNED_SHORT
    7: np.dtype(np.int32),     # MPI_INT
    8: np.dtype(np.uint32),    # MPI_UNSIGNED
    9: np.dtype(np.int64),     # MPI_LONG (LP64)
    10: np.dtype(np.uint64),   # MPI_UNSIGNED_LONG
    11: np.dtype(np.int64),    # MPI_LONG_LONG
    12: np.dtype(np.uint64),   # MPI_UNSIGNED_LONG_LONG
    13: np.dtype(np.float32),  # MPI_FLOAT
    14: np.dtype(np.float64),  # MPI_DOUBLE
    16: np.dtype(np.bool_),    # MPI_C_BOOL
    17: np.dtype(np.int8),
    18: np.dtype(np.int16),
    19: np.dtype(np.int32),
    20: np.dtype(np.int64),
    21: np.dtype(np.uint8),
    22: np.dtype(np.uint16),
    23: np.dtype(np.uint32),
    24: np.dtype(np.uint64),
    25: np.dtype(np.complex64),   # MPI_C_FLOAT_COMPLEX
    26: np.dtype(np.complex128),  # MPI_C_DOUBLE_COMPLEX
    27: np.dtype(np.int32),       # MPI_WCHAR
}

# -- op codes (mpi.h) ---------------------------------------------------
OPS: dict[int, opmod.Op] = {
    1: opmod.SUM,
    2: opmod.MAX,
    3: opmod.MIN,
    4: opmod.PROD,
    5: opmod.LAND,
    6: opmod.LOR,
    7: opmod.LXOR,
    8: opmod.BAND,
    9: opmod.BOR,
    10: opmod.BXOR,
    11: opmod.MAXLOC,
    12: opmod.MINLOC,
    13: opmod.REPLACE,
    14: opmod.NO_OP,
}

_comms: dict[int, object] = {}
_requests: dict[int, tuple] = {}
_groups: dict[int, object] = {}
_dtypes: dict[int, object] = {}  # derived datatype handle → ddt.Datatype
_errhandlers: dict[int, int] = {}  # comm handle → 1 (FATAL) | 2 (RETURN)
_next_handle = 3  # 1 = MPI_COMM_WORLD, 2 = MPI_COMM_SELF
_next_req = 1
_next_group = 2   # 1 = MPI_GROUP_EMPTY
_next_dtype = 64  # predefined codes stay below

# Predefined pair types (MAXLOC/MINLOC operands) are DERIVED-shaped:
# register them as ddt Datatypes so size/extent/leaf-count/pack queries
# see their 2-entry typemaps (MPI_Get_elements on MPI_DOUBLE_INT must
# report 2 basic elements per pair).
def _register_pair_types() -> None:
    from ompi_tpu_torch.ddt import datatype as _ddt

    _dtypes[28] = _ddt.FLOAT_INT
    _dtypes[29] = _ddt.DOUBLE_INT
    _dtypes[30] = _ddt.LONG_INT
    _dtypes[31] = _ddt.TWO_INT
    _dtypes[32] = _ddt.SHORT_INT


_register_pair_types()
_rank = 0
_size = 1

ERRH_FATAL, ERRH_RETURN = 1, 2


def _fail(e: BaseException, h: int | None = None) -> int:
    """Map a framework exception to an MPI error class.  Honors the
    communicator's errhandler: MPI_ERRORS_ARE_FATAL (the standard's
    default for conforming C programs) aborts the process; otherwise
    the class is returned to the caller (MPI_ERRORS_RETURN)."""
    if isinstance(e, err.MPIError):
        cls = int(e.error_class)
    else:
        traceback.print_exc()
        cls = MPI_ERR_OTHER
    # errors not attached to a communicator use WORLD's errhandler
    eh = _errhandlers.get(h if h is not None else 1, ERRH_FATAL)
    if eh == ERRH_FATAL:
        import os
        import sys

        print(f"tpumpi: MPI_ERRORS_ARE_FATAL: {type(e).__name__}: {e}",
              file=sys.stderr)
        sys.stderr.flush()
        os._exit(cls if 0 < cls < 126 else 1)
    return cls


def _t_fail(e: BaseException) -> int:
    """MPI_T error mapping: the tools interface returns error codes and
    NEVER invokes communicator error handlers (MPI-3 §14.3.4) — no
    abort even under ERRORS_ARE_FATAL."""
    if isinstance(e, err.MPIError):
        return int(e.error_class)
    traceback.print_exc()
    return MPI_ERR_OTHER


def _unit_nbytes(dtcode: int) -> int:
    """Packed byte size of ONE instance of a datatype code — the unit
    the C status's byte count (``_nbytes``) is denominated in.  MPI
    Get_count semantics divide by SIZE (packed), not extent."""
    d = _dtypes.get(dtcode)
    if d is not None:
        return int(d.size)
    dt = DTYPES.get(dtcode)
    return int(dt.itemsize) if dt is not None else 1


_ctype_arrays: dict[int, type] = {}  # nbytes → ctypes array type


def _ctype_arr(nbytes: int) -> type:
    """Cached ``c_ubyte * n`` array types: ctypes type creation is the
    measurable part of the view path, and benchmark/app loops reuse a
    handful of sizes (VERDICT r3 next #6)."""
    t = _ctype_arrays.get(nbytes)
    if t is None:
        if len(_ctype_arrays) > 4096:  # unbounded-size-mix backstop
            _ctype_arrays.clear()
        t = ctypes.c_ubyte * nbytes
        _ctype_arrays[nbytes] = t
    return t


def _view(ptr: int, count: int, dtcode: int) -> np.ndarray:
    """Zero-copy numpy view over a raw C buffer."""
    dt = DTYPES.get(dtcode)
    if dt is None:
        raise err.MPIArgError(f"unsupported C datatype code {dtcode}")
    nbytes = count * dt.itemsize
    if nbytes == 0:
        return np.empty(0, dt)
    raw = _ctype_arr(nbytes).from_address(ptr)
    return np.frombuffer(raw, dtype=dt)


def _row(c, x: np.ndarray):
    """A collective's host input as a tensor on the communicator's
    device: the same memory on the CPU, one H2D copy on the card."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(c.device)


def _host(out):
    """A collective's result as a host array (one D2H copy for a tensor
    on the card; None stays None off the root)."""
    if out is None:
        return None
    return to_numpy(out) if isinstance(out, torch.Tensor) else np.asarray(out)


def _host_kernel(np_fn):
    """A host (numpy) fold as a torch kernel: operands go to the host,
    fold there, and the result returns to the first operand's device."""

    def torch_fn(a, b):
        return from_numpy(np.asarray(np_fn(to_numpy(a), to_numpy(b))), a.device)

    return torch_fn


def _comm(h: int):
    c = _comms.get(h)
    if c is None:
        raise err.MPICommError(f"invalid communicator handle {h}")
    if _freed_active:  # opportunistic progress for detached requests
        _reap_freed_active()
    return c


def _store_comm(c, parent_h: int | None = None) -> int:
    global _next_handle
    h = _next_handle
    _next_handle += 1
    _comms[h] = c
    if parent_h is not None:
        # MPI: dup/split/create propagate the parent's errhandler
        _errhandlers[h] = _errhandlers.get(parent_h, ERRH_FATAL)
    return h


def _store_req(entry: tuple) -> int:
    global _next_req
    h = _next_req
    _next_req += 1
    _requests[h] = entry
    return h


# -- init / finalize ----------------------------------------------------


def init() -> int:
    global _rank, _size
    try:
        import os

        import ompi_tpu_torch.api as api
        from ompi_tpu_torch.boot.proc import ENV_DEVICE, launched_by_tpurun

        if os.environ.get(ENV_DEVICE) != "cpu" and not torch.cuda.is_available():
            raise err.MPIInternalError(
                "no CUDA device is available; a C rank runs on CUDA unless "
                "the launcher's --cpu switch (or OMPI_TPU_DEVICE=cpu for a "
                "standalone program) puts it on the CPU")
        if launched_by_tpurun():
            world = api.init()  # the launcher's device: CUDA unless --cpu
            if world.local_size != 1:
                raise err.MPIArgError(
                    "the C API maps one process to one MPI rank; launch "
                    "with exactly one virtual rank per process "
                    f"(run --nranks 1; this process holds {world.local_size})"
                )
            _comms[1] = world
            _rank = world.local_offset
            _size = world.size
        else:
            # standalone C program: a size-1 world (the mpirun -np 1
            # case), on CUDA unless OMPI_TPU_DEVICE=cpu asks for the CPU
            api.init(device=os.environ.get(ENV_DEVICE) or None, nranks=1)
            _comms[1] = api.comm_self()
            _rank, _size = 0, 1
        _comms[2] = api.comm_self()
        from ompi_tpu_torch.trace import core as _trace

        if _trace._enabled:
            _trace.instant("api", "MPI_Init", rank=_rank, size=_size)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001 — C boundary
        return _fail(e)


def finalize() -> int:
    try:
        import ompi_tpu_torch.api as api
        from ompi_tpu_torch.trace import core as _trace

        if _trace._enabled:
            _trace.instant("api", "MPI_Finalize", rank=_rank)
        _comms.clear()
        _requests.clear()
        # deliver any freed-but-completed requests before teardown;
        # still-pending ones can never complete now (their peers are
        # finalizing too) and are dropped per MPI's freed-handle liberty
        _reap_freed_active()
        _freed_active.clear()
        api.finalize()
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


# -- env ----------------------------------------------------------------


def comm_size(h: int):
    try:
        c = _comm(h)
        return (MPI_SUCCESS, int(getattr(c, "size", 1)))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def comm_rank(h: int):
    try:
        c = _comm(h)
        if h == 2 or getattr(c, "size", 1) == 1:
            return (MPI_SUCCESS, 0)
        return (MPI_SUCCESS, int(getattr(c, "local_offset", 0)))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def fast_error(h: int, code: int):
    """The shim's C fast path hit an MPI error (truncation, engine
    failure): honor the communicator's errhandler exactly like
    ``_fail`` — abort under MPI_ERRORS_ARE_FATAL (the conforming-C
    default), hand the class back under MPI_ERRORS_RETURN."""
    eh = _errhandlers.get(h, ERRH_FATAL)
    if eh == ERRH_FATAL:
        import os
        import sys

        print(f"tpumpi: MPI_ERRORS_ARE_FATAL: fast-path error class "
              f"{int(code)}", file=sys.stderr)
        sys.stderr.flush()
        os._exit(int(code) if 0 < int(code) < 126 else 1)
    return (MPI_SUCCESS, int(code))


def native_fastpath_info(h: int):
    """(err, info_string) for the shim's C p2p fast path.

    Non-empty only for multi-process comms whose p2p plane is the C
    matching engine (native transport + the default ``eager`` pml);
    the shim then drives MPI_Send/Recv straight into libtpudcn — no
    embedded-Python crossing on the hot path.  Encoding: fields
    ``engine_ptr, cid, my_rank, nranks, offsets_csv, addresses``
    joined with ``\\x1f`` (addresses joined with ``\\x1e`` — the
    composite transport addresses contain ``|`` and ``;``, so those
    are not usable as separators; offsets = the comm's rank→process
    boundaries)."""
    try:
        c = _comm(h)
        if not getattr(c, "_pml_native", False):
            return (MPI_SUCCESS, "")
        root = c.dcn._native_root()
        _check_one_dcn_instance(root._lib)
        c.pml  # force native pml construction (keeps one engine owner)
        # \x1f (unit sep) between fields, \x1e between addresses — the
        # composite transport addresses themselves contain '|' and ';'
        info = "\x1f".join([
            str(int(root._h)),
            str(c.cid),
            str(int(getattr(c, "local_offset", 0))),
            str(int(c.size)),
            ",".join(str(int(o)) for o in c.offsets),
            # indexed access on purpose: a sharded-modex AddressTable
            # resolves its holes here — the C-ABI fast path's cctx is
            # eager by design (fail_idx mapping needs every address)
            "\x1e".join(_fp_addrs(c.dcn)),
            # trailing field (appended — older parsers stop early): the
            # DCN ring-allreduce crossover, so the shim's C collective
            # schedules pick the SAME algorithm the Python plane would
            # (bit-exact MPI_SUM across both paths); reproducible mode
            # pins the process-ordered linear fold on both planes
            str(_coll_ring_threshold(c)),
        ])
        return (MPI_SUCCESS, info)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), "")


def _check_one_dcn_instance(lib) -> None:
    """Raise unless the engine's libtpudcn (``lib``, loaded through
    ctypes) is the very library the shim's C fast path binds: the engine
    pointer is only meaningful inside the instance that made it.  A
    libtpudcn rebuilt and renamed into place after the program started,
    or one loaded from another tree, is a second instance with the same
    symbols — the shim's ``tdcn_create`` then lies at another address."""
    shim = ctypes.CDLL(None).tpumpi_dcn_anchor
    shim.restype = ctypes.c_void_p
    ours = ctypes.cast(lib.tdcn_create, ctypes.c_void_p).value
    if shim() != ours:
        raise err.MPIInternalError(
            "the C fast path's libtpudcn and the Python engine's are two "
            f"loaded instances (tdcn_create at {shim():#x} vs {ours:#x}); "
            "the engine pointer cannot cross between them")


def _fp_addrs(eng) -> list[str]:
    """The engine's member addresses, fully resolved: indexed access
    forces a sharded-modex AddressTable to fill its lazy holes (the
    C-ABI fast path needs every address eagerly for its fail-index
    mapping; sub-engine address views resolve through the parent)."""
    addrs = eng.addresses
    return [addrs[i] for i in range(len(addrs))]


def _coll_ring_threshold(c) -> int:
    """The comm's DCN ring-allreduce crossover in bytes; a huge
    sentinel when ``coll_han_reproducible`` pins the ordered fold."""
    from ompi_tpu_torch.core import mca

    store = mca.default_context().store
    if bool(store.get("coll_han_reproducible", False)):
        return 1 << 62  # never ring: ordered linear on both planes
    return int(getattr(c.dcn, "ring_threshold", 64 << 10))


def coll_sched_decision(h: int, coll: str, nbytes: int, opcode: int):
    """(err, algo) — the algorithm a persistent collective's compiled
    schedule should replay: 0 = process-ordered linear, 1 = ring.  The
    decision layer's verdict resolved ONCE at ``*_init`` time (the
    libnbc compile step) and memoized in the process-wide schedule
    cache, so a resident worker's later inits of the same signature
    never re-derive it."""
    try:
        from ompi_tpu_torch.coll import sched as _sched
        from ompi_tpu_torch.coll.tuned import dcn_fixed_decision
        from ompi_tpu_torch.core import mca

        c = _comm(h)
        store = mca.default_context().store

        def build() -> int:
            return dcn_fixed_decision(
                coll, int(getattr(c, "nprocs", 1)), int(nbytes),
                OPS.get(opcode),
                int(getattr(c.dcn, "ring_threshold", 64 << 10)),
                reproducible=bool(
                    store.get("coll_han_reproducible", False)))

        algo = _sched.lookup(
            ("capi_decision", int(getattr(c, "nprocs", 1)), coll,
             int(opcode), int(nbytes),
             store.version),  # var-change coherence
            build,
        )
        return (MPI_SUCCESS, int(algo))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def coll_handle_agree(h: int, kind: int, root: int, nbytes: int,
                      pre: int):
    """(err, verdict) — the schedule-build handle-homogeneity guard
    for the C collective fast path.  Routing keys on the LOCAL
    datatype handle, but MPI only requires SIGNATURE equality across
    ranks: a predefined handle on one rank with a same-signature
    derived handle on another is legal yet would silently split the
    ranks across planes (deadlock).  At schedule-build time every
    rank publishes its handle class for the (comm, kind, root,
    nbytes) signature on the job KVS; predefined ranks wait for all
    peers and the verdict (1 = all predefined → C plane allowed,
    0 = mixed → every rank keeps the Python plane) is cached shim-
    side, so the KVS round is paid once per signature.  Derived ranks
    publish and return immediately — they already know their plane.
    Supported envelope note: a signature must keep a consistent
    handle class per rank across the program (re-agreement is cached
    by signature, not per call)."""
    try:
        c = _comm(h)
        eng = getattr(c, "dcn", None)
        ctx = getattr(c, "procctx", None)
        if (eng is None or ctx is None
                or int(getattr(eng, "nprocs", 1)) <= 1):
            return (MPI_SUCCESS, 1 if pre else 0)
        from ompi_tpu_torch.core.var import Deadline

        kvs = ctx.kvs
        ns = _shared_ns(c)
        key = (f"{ns}hagree.{c.cid}.{int(kind)}.{int(root)}."
               f"{int(nbytes)}")

        def _poisoned() -> bool:
            try:
                kvs.get(f"{key}.verdict0", wait=False)
                return True
            except KeyError:
                return False

        # verdict-0 marker first: a peer that already degraded this
        # signature (derived handle, or a timeout) binds EVERY later
        # arrival to the same Python-plane verdict — without it, a
        # rank whose wait expired would cache 0 while a late-arriving
        # rank reads the complete all-"p" key set and caches 1: the
        # exact cross-rank plane split the guard exists to prevent
        if _poisoned():
            kvs.put(f"{key}.{int(eng.proc)}", "d")
            return (MPI_SUCCESS, 0)
        kvs.put(f"{key}.{int(eng.proc)}", "p" if pre else "d")
        if not pre:
            kvs.put(f"{key}.verdict0", 1)
            return (MPI_SUCCESS, 0)
        dl = Deadline.for_timeout("recv")
        verdict = 1
        for p in range(int(eng.nprocs)):
            if p == int(eng.proc):
                continue
            v = None
            while v is None:
                try:
                    v = kvs.get(f"{key}.{p}", timeout=dl.slice(1.0))
                except KeyError:
                    if dl.expired():
                        break  # silent peer: conservative Python plane
                except OSError:
                    # transient KVS hiccup: retry inside the same
                    # deadline rather than raising — the raise path
                    # would cache verdict 0 on THIS rank while peers
                    # holding our published "p" complete an all-"p"
                    # read and cache 1: the cross-plane split the
                    # guard exists to prevent.  A dead KVS ends in
                    # the deadline degrade below like a silent peer.
                    if dl.expired():
                        break
                    time.sleep(0.05)
            if v != "p":
                verdict = 0
                break
        if verdict == 0:
            # publish the degradation (and flip our own class key) so
            # peers arriving after our deadline converge on 0 instead
            # of reading a complete "p" set.  The residual race — a
            # peer completing its all-"p" read in the same instant
            # this marker lands — needs the skew to hit the deadline
            # within the marker-write window; the supported envelope
            # (consistent handle classes per signature) is unaffected.
            kvs.put(f"{key}.verdict0", 1)
            kvs.put(f"{key}.{int(eng.proc)}", "d")
        elif _poisoned():
            verdict = 0  # a peer degraded while we were reading keys
        return (MPI_SUCCESS, verdict)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def _shared_ns(c) -> str:
    """The KVS namespace every member of ``c`` writes under.  A comm
    over a spawn union (its engine rides a join engine, directly or
    through sub engines) spans the parents' and the children's
    namespaces and shares the spawn's own; any other comm, its
    process's.  (The reference keys on the process's namespace, so the
    two sides of a union never see each other's keys and each waits
    out the recv deadline before it degrades.)"""
    eng = getattr(c, "dcn", None)
    while eng is not None:
        ns = getattr(eng, "kvs_ns", None)
        if ns is not None:
            return ns
        eng = getattr(eng, "parent", None)
    return getattr(c.procctx, "ns", "")


def comm_dup(h: int):
    try:
        nh = _store_comm(_comm(h).dup(), h)
        attr_copy_on_dup("comm", h, nh)  # keyval copy callbacks fire here
        return (MPI_SUCCESS, nh)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def comm_split(h: int, color: int, key: int):
    try:
        c = _comm(h)
        # Comm.split / MultiProcComm.split take per-local-rank color/key
        # sequences; with the C process=rank model each process (or the
        # single-controller comm's ranks — handled by the length) gives
        # exactly one.  Cross-process sub-comms ride DcnSubEngine.
        if _is_single_controller(c):
            colors = [color] * c.size
            keys = [key] * c.size
            sub = c.split(colors, keys)[0]
        else:
            sub = c.split([color], [key])[0]
        if sub is None:  # MPI_UNDEFINED color → MPI_COMM_NULL
            return (MPI_SUCCESS, 0)
        return (MPI_SUCCESS, _store_comm(sub, h))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def comm_free(h: int) -> int:
    try:
        if h > 2:  # WORLD/SELF are persistent
            _comm(h).free()
            _comms.pop(h, None)
            _carts.pop(h, None)
            _graphs.pop(h, None)
            _errhandlers.pop(h, None)
            _dist_graphs.pop(h, None)
            # keyval delete callbacks fire at comm destruction (MPI
            # attribute caching semantics)
            for kv in list(_attr_tables.get(("comm", h), {})):
                attr_delete("comm", h, kv)
            _attr_tables.pop(("comm", h), None)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def comm_set_name(h: int, name: str) -> int:
    try:
        _comm(h).name = name
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def _is_single_controller(c) -> bool:
    """True for single-process Comm objects (one Python process drives
    every rank — the standalone / COMM_SELF case)."""
    return getattr(c, "dcn", None) is None


def type_size(dtcode: int):
    d = _dtypes.get(dtcode)
    if d is not None:
        return (MPI_SUCCESS, int(d.size))
    dt = DTYPES.get(dtcode)
    if dt is None:
        return (MPI_ERR_TYPE, 0)
    return (MPI_SUCCESS, int(dt.itemsize))


def type_leaf_count(dtcode: int):
    """Basic (leaf) elements per datatype instance — what
    MPI_Get_elements multiplies the type-unit count by (derived types:
    typemap length; predefined scalars: 1; the predefined pair types
    28-32 are registered in ``_dtypes`` with 2-entry typemaps)."""
    d = _dtypes.get(dtcode)
    if d is not None:
        return (MPI_SUCCESS, max(1, len(d.typemap)))
    if DTYPES.get(dtcode) is None:
        return (MPI_ERR_TYPE, 0)
    return (MPI_SUCCESS, 1)


# -- collectives --------------------------------------------------------


def _coll_in(sptr: int, rptr: int, count: int, dtcode: int) -> np.ndarray:
    """Sendbuf view honoring MPI_IN_PLACE (input taken from recvbuf)."""
    if sptr == _IN_PLACE:
        return _view(rptr, count, dtcode)
    return _view(sptr, count, dtcode)


def _reduce_in(sptr, rptr, count, dtcode) -> np.ndarray:
    """Reduction input honoring MPI_IN_PLACE AND derived datatypes:
    derived contributions go through the convertor pack onto their
    uniform leaf dtype (MPI requires reducible derived types to be
    leaf-uniform) — the fallback contract behind the shim's C fast
    path, which only serves contiguous predefined types."""
    src = rptr if sptr == _IN_PLACE else sptr
    if dtcode in _dtypes:
        d = _dtypes[dtcode]
        if d.uniform_leaf is None:
            raise err.MPITypeError(
                "reductions need a uniform-leaf datatype")
        return _pack_from(src, count, dtcode)
    return _view(src, count, dtcode)


def allreduce(sptr, rptr, count, dtcode, opcode, h) -> int:
    try:
        c = _comm(h)
        x = _reduce_in(sptr, rptr, count, dtcode)[None, :]
        out = _host(c.allreduce(_row(c, x), OPS[opcode]))
        _unpack_into(rptr, count, dtcode, out[0])
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


def reduce(sptr, rptr, count, dtcode, opcode, root, h) -> int:
    try:
        c = _comm(h)
        x = _reduce_in(sptr, rptr, count, dtcode)[None, :]
        out = _host(c.reduce(_row(c, x), OPS[opcode], root=root))
        me = comm_rank(h)[1]
        if me == root and rptr not in (0, _IN_PLACE):
            _unpack_into(rptr, count, dtcode, out[0])
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


def bcast(ptr, count, dtcode, root, h) -> int:
    try:
        c = _comm(h)
        if dtcode in _dtypes:  # derived: pack → bcast bytes → unpack
            x = _pack_from(ptr, count, dtcode)
            out = _host(c.bcast(_row(c, np.asarray(x)[None, :]), root=root))
            _unpack_into(ptr, count, dtcode, out[0])
            return MPI_SUCCESS
        buf = _view(ptr, count, dtcode)
        out = _host(c.bcast(_row(c, buf[None, :]), root=root))
        buf[:] = out.reshape(-1)[:count]
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


def allgather(sptr, scount, sdt, rptr, rcount, rdt, h) -> int:
    # Derived send/recv handles ride the convertor pack/unpack (like
    # bcast): matching signatures pack to identical leaf-typed (or
    # raw-byte) blocks, so a derived-sendtype rank interoperates with
    # predefined-handle peers — the capi fallback must serve every
    # legal call the shim's agreement routes here (a derived handle
    # ANYWHERE forces all ranks onto this plane).
    try:
        c = _comm(h)
        n = getattr(c, "size", 1)
        if sptr == _IN_PLACE:
            # input is this rank's block of recvbuf
            me = comm_rank(h)[1]
            d = _dtypes.get(rdt)
            if d is not None:
                x = _pack_from(rptr + me * rcount * d.extent, rcount, rdt)
            else:
                full = _view(rptr, rcount * n, rdt)
                x = full[me * rcount : (me + 1) * rcount].copy()
        elif sdt in _dtypes:
            x = _pack_from(sptr, scount, sdt)
        else:
            x = _view(sptr, scount, sdt)
        out = _host(c.allgather(_row(c, x[None, :])))  # (1, n, per-rank)
        if rdt in _dtypes:
            _unpack_into(rptr, rcount * n, rdt, out[0])
        else:
            _view(rptr, rcount * n, rdt)[:] = out.reshape(-1)[: rcount * n]
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


def gather(sptr, scount, sdt, rptr, rcount, rdt, root, h) -> int:
    # rooted gather rides the allgather path (wire cost is acceptable on
    # the fabric; the dedicated rooted schedule is a coll/base variant)
    try:
        c = _comm(h)
        n = getattr(c, "size", 1)
        me = comm_rank(h)[1]
        if sptr == _IN_PLACE:
            # root's contribution is already in place in recvbuf
            full = _view(rptr, rcount * n, rdt)
            x = full[me * rcount : (me + 1) * rcount].copy()
            scount, sdt = rcount, rdt
        else:
            x = _view(sptr, scount, sdt)
        out = _host(c.allgather(_row(c, x[None, :])))
        if me == root:
            _view(rptr, rcount * n, rdt)[:] = out.reshape(-1)[: rcount * n]
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


def scatter(sptr, scount, sdt, rptr, rcount, rdt, root, h) -> int:
    try:
        c = _comm(h)
        n = getattr(c, "size", 1)
        me = comm_rank(h)[1]
        if me == root:
            full = _view(sptr, scount * n, sdt).reshape(n, scount)
            if rptr == _IN_PLACE:
                # MPI_IN_PLACE recvbuf at root: its block stays in sendbuf
                rcount = 0
        else:
            full = np.zeros((n, max(scount, rcount)), DTYPES[rdt])
        out = _host(c.scatter(_row(c, full), root=root))
        if rcount:
            _view(rptr, rcount, rdt)[:] = out.reshape(-1)[:rcount]
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


def alltoall(sptr, scount, sdt, rptr, rcount, rdt, h) -> int:
    try:
        c = _comm(h)
        n = getattr(c, "size", 1)
        if sptr == _IN_PLACE:
            x = _view(rptr, rcount * n, rdt).reshape(1, n, rcount).copy()
        else:
            x = _view(sptr, scount * n, sdt).reshape(1, n, scount)
        out = _host(c.alltoall(_row(c, x)))
        _view(rptr, rcount * n, rdt)[:] = out.reshape(-1)[: rcount * n]
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


def reduce_scatter_block(sptr, rptr, rcount, dtcode, opcode, h) -> int:
    try:
        c = _comm(h)
        n = getattr(c, "size", 1)
        if sptr == _IN_PLACE:
            x = _view(rptr, rcount * n, dtcode).reshape(1, n, rcount).copy()
        else:
            x = _view(sptr, rcount * n, dtcode).reshape(1, n, rcount)
        out = _host(c.reduce_scatter_block(_row(c, x), OPS[opcode]))
        _view(rptr, rcount, dtcode)[:] = out.reshape(-1)[:rcount]
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


def scan(sptr, rptr, count, dtcode, opcode, h) -> int:
    try:
        c = _comm(h)
        x = _coll_in(sptr, rptr, count, dtcode)[None, :]
        out = _host(c.scan(_row(c, x), OPS[opcode]))
        _view(rptr, count, dtcode)[:] = out.reshape(-1)[:count]
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


def exscan(sptr, rptr, count, dtcode, opcode, h) -> int:
    try:
        c = _comm(h)
        x = _coll_in(sptr, rptr, count, dtcode)[None, :]
        out = _host(c.exscan(_row(c, x), OPS[opcode]))
        me = comm_rank(h)[1]
        if me != 0:  # rank 0's recvbuf is undefined in MPI_Exscan
            _view(rptr, count, dtcode)[:] = out.reshape(-1)[:count]
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


def barrier(h) -> int:
    try:
        _comm(h).barrier()
        # freed-active requests whose message arrived before/during the
        # barrier must be delivered BEFORE the barrier returns to C —
        # the canonical MPI_Request_free inference pattern (free; peer
        # sends + barriers; read buffer) relies on exactly this, and
        # channel FIFO guarantees the data frame was matched by now
        _reap_freed_active()
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


# -- pt2pt --------------------------------------------------------------


def send(ptr, count, dtcode, dest, tag, h) -> int:
    try:
        c = _comm(h)
        me = comm_rank(h)[1]
        # derived datatypes go through the convertor pack (SURVEY §3.3);
        # predefined ones are a zero-copy view + copy
        payload = _pack_from(ptr, count, dtcode)
        c.send(payload, source=me, dest=dest, tag=tag)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


def recv(ptr, count, dtcode, source, tag, h):
    try:
        c = _comm(h)
        me = comm_rank(h)[1]
        out = None
        kw = {}
        if (dtcode in DTYPES and dtcode not in _dtypes
                and getattr(c, "_pml_native", False)):
            # native plane + predefined contiguous dtype: post the
            # user buffer itself (the ctypes recv_into surface) — a
            # racing streamed RTS lands straight in it, and the copy
            # path becomes one C-side memcpy, never a Python unpack
            out = torch.from_numpy(_view(ptr, count, dtcode))
            kw["out"] = out
        payload, st = c.recv(
            dest=me,
            source=None if source == -1 else source,
            tag=None if tag == -1 else tag,
            **kw,
        )
        if out is not None and payload is out:
            unit = _unit_nbytes(dtcode)
            got = min(count, int(st.nbytes) // max(1, unit))
        else:
            got = _unpack_into(ptr, count, dtcode, payload)
        return (MPI_SUCCESS, int(st.source), int(st.tag),
                got * _unit_nbytes(dtcode))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), -1, -1, 0)


def isend(ptr, count, dtcode, dest, tag, h):
    # sends are buffered-eager (pml): local completion is immediate
    rc = send(ptr, count, dtcode, dest, tag, h)
    if rc != MPI_SUCCESS:
        return (rc, 0)
    return (MPI_SUCCESS, _store_req(("done", None, 0, 0, (0, 0, 0))))


def irecv(ptr, count, dtcode, source, tag, h):
    try:
        c = _comm(h)
        me = comm_rank(h)[1]
        req = c.irecv(
            dest=me,
            source=None if source == -1 else source,
            tag=None if tag == -1 else tag,
        )
        return (MPI_SUCCESS, _store_req(("recv", req, ptr, count, dtcode)))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


# -- requests -----------------------------------------------------------


def _complete(entry) -> tuple[int, int, int]:
    """Finish a request entry; returns (source, tag, nbytes) — the
    count slot is BYTES (what the C status carries; PMPI_Get_count
    divides by the queried datatype's size)."""
    kind, req, ptr, count, dtcode = entry
    if kind == "done":
        return entry[4] if isinstance(entry[4], tuple) else (0, 0, 0)
    if kind == "recv":
        payload = req.wait()
        st = req.status
        got = _unpack_into(ptr, count, dtcode, payload)
        return (int(st.source), int(st.tag), got * _unit_nbytes(dtcode))
    if kind == "coll":
        out = req.wait()
        if ptr not in (0, _IN_PLACE) and count:
            # _unpack_into: predefined lands as the plain flat view,
            # derived goes through the convertor (iallreduce's
            # mixed-handle fallback leg)
            _unpack_into(ptr, count, dtcode, _host(out))
        return (0, 0, count * _unit_nbytes(dtcode))
    raise err.MPIInternalError(f"bad request kind {kind}")


def _complete_persistent(rh: int, entry) -> tuple[int, int, int]:
    """Finish a persistent request's CURRENT round; the handle stays
    valid (inactive) for the next MPI_Start — MPI persistent-request
    lifecycle (handle dies only on MPI_Request_free)."""
    kind, req, params = entry[0], entry[1], entry[2]
    out = (0, 0, 0)
    try:
        if req is not None:
            if kind == "pers_recv":
                payload = req.wait()
                st = req.status
                ptr, count, dtcode = params[0], params[1], params[2]
                got = _unpack_into(ptr, count, dtcode, payload)
                out = (int(st.source), int(st.tag),
                       got * _unit_nbytes(dtcode))
            else:
                req.wait()
    finally:
        _requests[rh] = (kind, None, params, 0, 0)  # back to inactive
    return out


def wait(rh: int):
    pers = 0
    try:
        entry = _requests.get(rh)
        if entry is None:
            raise err.MPIArgError(f"invalid request handle {rh}")
        if entry[0] == "grequest":
            # generalized request: block until the user's worker calls
            # MPI_Grequest_complete (which rewrites the entry to done)
            from ompi_tpu_torch.request import _poll_backoff

            sleep = 0.0
            while _requests.get(rh, ("done",))[0] == "grequest":
                sleep = _poll_backoff(sleep)
            entry = _requests.get(rh)
            if entry is None:
                return (MPI_SUCCESS, -1, -1, 0, 0)
        if entry[0].startswith("pers_"):
            pers = 1  # even on error the handle must survive (spec)
            source, tag, count = _complete_persistent(rh, entry)
            # trailing 1 = persistent: the shim keeps the handle alive
            return (MPI_SUCCESS, source, tag, count, 1)
        _requests.pop(rh, None)
        source, tag, count = _complete(entry)
        return (MPI_SUCCESS, source, tag, count, 0)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), -1, -1, 0, pers)


def test(rh: int):
    try:
        entry = _requests.get(rh)
        if entry is None:
            raise err.MPIArgError(f"invalid request handle {rh}")
        kind, req = entry[0], entry[1]
        if kind.startswith("pers_"):
            if req is None:  # inactive persistent request: trivially done
                return (MPI_SUCCESS, 1, -1, -1, 0, 1)
            if not req.test():
                return (MPI_SUCCESS, 0, -1, -1, 0, 1)
            source, tag, count = _complete_persistent(rh, entry)
            return (MPI_SUCCESS, 1, source, tag, count, 1)
        ready = kind == "done" or (req is not None and req.test())
        if not ready:
            return (MPI_SUCCESS, 0, -1, -1, 0, 0)
        _requests.pop(rh, None)
        source, tag, count = _complete(entry)
        return (MPI_SUCCESS, 1, source, tag, count, 0)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0, -1, -1, 0, 0)


# -- non-blocking collectives ------------------------------------------


def iallreduce(sptr, rptr, count, dtcode, opcode, h):
    try:
        c = _comm(h)
        # _reduce_in (not _coll_in): derived handles pack onto their
        # uniform leaf like the blocking allreduce — the agreement
        # guard routes every mixed-handle I*-collective here
        x = _reduce_in(sptr, rptr, count, dtcode)[None, :].copy()
        req = c.iallreduce(_row(c, x), OPS[opcode])
        return (MPI_SUCCESS, _store_req(("coll", req, rptr, count, dtcode)))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def _eager_coll(fn) -> tuple[int, int]:
    """Blocking execution + completed handle: MPI-legal (completion at
    wait is a superset of completion before wait); overlap comes from
    the fabric-side async dispatch underneath where available."""
    rc = fn()
    if rc not in (None, MPI_SUCCESS):
        return (int(rc), 0)
    return (MPI_SUCCESS, _store_req(("done", None, 0, 0, (0, 0, 0))))


def ibarrier(h):
    try:
        return _eager_coll(lambda: _comm(h).barrier())
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def ibcast(ptr, count, dtcode, root, h):
    try:
        return _eager_coll(lambda: bcast(ptr, count, dtcode, root, h))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def iallgather(sptr, scount, sdt, rptr, rcount, rdt, h):
    try:
        return _eager_coll(
            lambda: allgather(sptr, scount, sdt, rptr, rcount, rdt, h)
        )
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def ialltoall(sptr, scount, sdt, rptr, rcount, rdt, h):
    try:
        return _eager_coll(
            lambda: alltoall(sptr, scount, sdt, rptr, rcount, rdt, h)
        )
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


# -- groups (MPI_Comm_group + group algebra; ≈ ompi/group/) --------------


def _group(gh: int):
    if gh == 1:
        from ompi_tpu_torch.api.group import Group

        return Group([])
    g = _groups.get(gh)
    if g is None:
        raise err.MPIGroupError(f"invalid group handle {gh}")
    return g


def _store_group(g) -> int:
    global _next_group
    if g.size == 0:
        return 1  # MPI_GROUP_EMPTY
    _next_group += 1
    _groups[_next_group] = g
    return _next_group


def comm_group(h: int):
    """MPI_Comm_group.  Groups carry WORLD ranks (the comm's ``group``
    attribute), so group algebra and rank lookups compose across groups
    taken from different communicators."""
    try:
        from ompi_tpu_torch.api.group import Group

        c = _comm(h)
        g = getattr(c, "group", None)
        ranks = list(g.ranks) if g is not None else range(getattr(c, "size", 1))
        return (MPI_SUCCESS, _store_group(Group(ranks)))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def group_size(gh: int):
    try:
        return (MPI_SUCCESS, _group(gh).size)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def group_rank(gh: int):
    """Rank of the calling process in the group (MPI_UNDEFINED=-32766
    if absent)."""
    try:
        g = _group(gh)
        me = comm_rank(1)[1]
        return (MPI_SUCCESS, int(g.rank_of(me)))  # UNDEFINED if absent
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def group_free(gh: int) -> int:
    _groups.pop(gh, None)
    return MPI_SUCCESS


def group_incl(gh: int, ranks_ptr: int, n: int):
    try:
        ranks = [int(v) for v in _view(ranks_ptr, n, 7)] if n else []
        return (MPI_SUCCESS, _store_group(_group(gh).incl(ranks)))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def group_excl(gh: int, ranks_ptr: int, n: int):
    try:
        ranks = [int(v) for v in _view(ranks_ptr, n, 7)] if n else []
        return (MPI_SUCCESS, _store_group(_group(gh).excl(ranks)))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def group_union(ga: int, gb: int):
    try:
        return (MPI_SUCCESS, _store_group(_group(ga).union(_group(gb))))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def group_intersection(ga: int, gb: int):
    try:
        return (MPI_SUCCESS, _store_group(_group(ga).intersection(_group(gb))))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def group_difference(ga: int, gb: int):
    try:
        return (MPI_SUCCESS, _store_group(_group(ga).difference(_group(gb))))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def group_translate_ranks(ga: int, n: int, ranks_ptr: int, gb: int,
                          out_ptr: int) -> int:
    try:
        ga_, gb_ = _group(ga), _group(gb)
        ranks = [int(v) for v in _view(ranks_ptr, n, 7)]
        out = ga_.translate_ranks(ranks, gb_)
        _view(out_ptr, n, 7)[:] = [int(r) for r in out]
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def group_compare(ga: int, gb: int):
    """Maps the internal IDENT(0)/SIMILAR(1)/UNEQUAL(2) to the C
    header's MPI_IDENT(0)/MPI_SIMILAR(2)/MPI_UNEQUAL(3)."""
    try:
        v = int(_group(ga).compare(_group(gb)))
        return (MPI_SUCCESS, {0: 0, 1: 2, 2: 3}[v])
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def comm_create(h: int, gh: int):
    """MPI_Comm_create (and _group): new comm over the group's ranks,
    ordered by group rank.  Cross-process membership routes through
    comm_split with key = position in the group."""
    try:
        c = _comm(h)
        g = _group(gh)
        if g.size == 0:
            return (MPI_SUCCESS, 0)
        if _is_single_controller(c):
            sub = c.create_group(g)
            return (MPI_SUCCESS,
                    _store_comm(sub, h) if sub is not None else 0)
        me = comm_rank(h)[1]
        pos = int(g.rank_of(me))
        if pos == -32766:  # UNDEFINED: participate in the split collective
            c.split([-32766], [0])
            return (MPI_SUCCESS, 0)
        sub = c.split([0], [pos])[0]
        return (MPI_SUCCESS, _store_comm(sub, h))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def comm_create_group(h: int, gh: int, tag: int):
    """MPI_Comm_create_group (MPI-3.0): collective over the GROUP
    members only — routed to the members-only construction path (the
    full-comm split behind comm_create would deadlock: nonmembers
    never call)."""
    try:
        c = _comm(h)
        g = _group(gh)
        if g.size == 0:
            return (MPI_SUCCESS, 0)
        if _is_single_controller(c):
            sub = c.create_group(g)
            return (MPI_SUCCESS,
                    _store_comm(sub, h) if sub is not None else 0)
        sub = c.create_group_members(list(g.ranks), int(tag))
        return (MPI_SUCCESS, _store_comm(sub, h))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def comm_compare(ha: int, hb: int):
    """MPI_Comm_compare: IDENT(0)/CONGRUENT(1)/SIMILAR(2)/UNEQUAL(3)."""
    try:
        ca, cb = _comm(ha), _comm(hb)
        if ca is cb:
            return (MPI_SUCCESS, 0)
        ra = list(getattr(ca, "group").ranks)
        rb = list(getattr(cb, "group").ranks)
        if ra == rb:
            return (MPI_SUCCESS, 1)
        if sorted(ra) == sorted(rb):
            return (MPI_SUCCESS, 2)
        return (MPI_SUCCESS, 3)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


# -- errhandlers ----------------------------------------------------------


def comm_set_errhandler(h: int, eh: int) -> int:
    try:
        c = _comm(h)
        if eh not in (ERRH_FATAL, ERRH_RETURN):
            raise err.MPIArgError(f"invalid errhandler handle {eh}")
        _errhandlers[h] = eh
        from ompi_tpu_torch.core import errors as _err

        c.set_errhandler(
            _err.ERRORS_ARE_FATAL if eh == ERRH_FATAL else _err.ERRORS_RETURN
        )
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def comm_get_errhandler(h: int):
    try:
        _comm(h)
        return (MPI_SUCCESS, _errhandlers.get(h, ERRH_FATAL))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


# -- derived datatypes (≈ ompi/datatype constructors over ddt/) -----------


def _ddt(dtcode: int):
    """Datatype for a C handle: derived registry, or predefined leaf."""
    d = _dtypes.get(dtcode)
    if d is not None:
        return d
    from ompi_tpu_torch.ddt.datatype import from_numpy_dtype

    dt = DTYPES.get(dtcode)
    if dt is None:
        raise err.MPITypeError(f"unsupported C datatype code {dtcode}")
    return from_numpy_dtype(dt)


def _store_dtype(d) -> int:
    global _next_dtype
    _next_dtype += 1
    _dtypes[_next_dtype] = d
    return _next_dtype


def type_contiguous(count: int, base: int):
    try:
        code = _store_dtype(_ddt(base).create_contiguous(count))
        _record_envelope(code, 3, [count], [], [base])
        return (MPI_SUCCESS, code)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def type_vector(count: int, blocklength: int, stride: int, base: int):
    try:
        d = _ddt(base).create_vector(count, blocklength, stride)
        code = _store_dtype(d)
        _record_envelope(code, 4, [count, blocklength, stride], [], [base])
        return (MPI_SUCCESS, code)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def type_indexed(count: int, bl_ptr: int, disp_ptr: int, base: int):
    try:
        bls = [int(v) for v in _view(bl_ptr, count, 7)]
        disps = [int(v) for v in _view(disp_ptr, count, 7)]
        d = _ddt(base).create_indexed(bls, disps)
        code = _store_dtype(d)
        _record_envelope(code, 6, [count] + bls + disps, [], [base])
        return (MPI_SUCCESS, code)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def type_commit(dtcode: int) -> int:
    try:
        d = _dtypes.get(dtcode)
        if d is not None:
            d.commit()
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def type_free(dtcode: int) -> int:
    _dtypes.pop(dtcode, None)
    return MPI_SUCCESS


def type_get_extent(dtcode: int):
    try:
        d = _ddt(dtcode)
        return (MPI_SUCCESS, int(d.lb), int(d.extent))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0, 0)


def _pack_from(ptr: int, count: int, dtcode: int) -> np.ndarray:
    """Read `count` elements of a (possibly derived) datatype from a C
    buffer into a packed contiguous array (leaf-typed when uniform) —
    the convertor's pack path (SURVEY.md §3.3)."""
    d = _dtypes.get(dtcode)
    if d is None:
        return _view(ptr, count, dtcode).copy()
    from ompi_tpu_torch.ddt.convertor import pack, packed_to_typed

    span = d.lb + d.extent * count
    raw = (ctypes.c_ubyte * max(span, 1)).from_address(ptr)
    buf = np.frombuffer(raw, dtype=np.uint8)
    packed = pack(buf, d, count)
    if d.uniform_leaf is not None:
        return packed_to_typed(packed, d, count)
    return packed


def _unpack_into(ptr: int, count: int, dtcode: int, data: np.ndarray) -> int:
    """Write packed/typed data into a C buffer laid out as `count`
    elements of a (possibly derived) datatype; returns elements written."""
    d = _dtypes.get(dtcode)
    if d is None:
        flat = np.asarray(data).reshape(-1).view(DTYPES[dtcode])
        got = min(flat.size, count)
        _view(ptr, got, dtcode)[:] = flat[:got]
        return got
    from ompi_tpu_torch.ddt.convertor import unpack

    span = d.lb + d.extent * count
    raw = (ctypes.c_ubyte * max(span, 1)).from_address(ptr)
    buf = np.frombuffer(raw, dtype=np.uint8)
    payload = np.asarray(data).reshape(-1).view(np.uint8)
    n_elems = min(count, payload.nbytes // max(d.size, 1))
    unpack(buf, d, n_elems, payload[: n_elems * d.size])
    return n_elems


# -- v-collectives (jagged counts/displacements) --------------------------


def _vparams(ptr_counts: int, ptr_displs: int, n: int):
    counts = [int(v) for v in _view(ptr_counts, n, 7)]
    displs = [int(v) for v in _view(ptr_displs, n, 7)]
    return counts, displs


def allgatherv(sptr, scount, sdt, rptr, rcounts_ptr, displs_ptr, rdt, h) -> int:
    try:
        c = _comm(h)
        n = getattr(c, "size", 1)
        counts, displs = _vparams(rcounts_ptr, displs_ptr, n)
        me = comm_rank(h)[1]
        if sptr == _IN_PLACE:
            base = _view(rptr, displs[me] + counts[me], rdt)
            x = base[displs[me] : displs[me] + counts[me]].copy()
        else:
            x = _view(sptr, scount, sdt).copy()
        if _is_single_controller(c):
            blocks = c.allgatherv([x] * n) if n > 1 else [x]
        else:
            blocks = c.allgatherv([x])
        item = DTYPES[rdt].itemsize
        for r in range(n):
            dst = _view(rptr + displs[r] * item, counts[r], rdt)
            dst[:] = np.asarray(blocks[r]).reshape(-1).view(DTYPES[rdt])[: counts[r]]
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


def gatherv(sptr, scount, sdt, rptr, rcounts_ptr, displs_ptr, rdt, root, h) -> int:
    try:
        c = _comm(h)
        n = getattr(c, "size", 1)
        me = comm_rank(h)[1]
        if sptr == _IN_PLACE:  # root's block already in recvbuf
            counts, displs = _vparams(rcounts_ptr, displs_ptr, n)
            item = DTYPES[rdt].itemsize
            x = _view(rptr + displs[me] * item, counts[me], rdt).copy()
        else:
            x = _view(sptr, scount, sdt).copy()
        if _is_single_controller(c):
            blocks = c.gatherv([x] * n if n > 1 else [x], root)
        else:
            blocks = c.gatherv([x], root)
        if me == root:
            counts, displs = _vparams(rcounts_ptr, displs_ptr, n)
            item = DTYPES[rdt].itemsize
            for r in range(n):
                dst = _view(rptr + displs[r] * item, counts[r], rdt)
                dst[:] = (
                    np.asarray(blocks[r]).reshape(-1).view(DTYPES[rdt])[: counts[r]]
                )
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


def scatterv(sptr, scounts_ptr, displs_ptr, sdt, rptr, rcount, rdt, root, h) -> int:
    try:
        c = _comm(h)
        n = getattr(c, "size", 1)
        me = comm_rank(h)[1]
        blocks = None
        if me == root:
            counts, displs = _vparams(scounts_ptr, displs_ptr, n)
            item = DTYPES[sdt].itemsize
            blocks = [
                _view(sptr + displs[r] * item, counts[r], sdt).copy()
                for r in range(n)
            ]
        out = c.scatterv(blocks, root)
        mine = out[0] if not _is_single_controller(c) else out[me]
        got = min(rcount, np.asarray(mine).size)
        if rptr != _IN_PLACE and got:
            _view(rptr, got, rdt)[:] = (
                np.asarray(mine).reshape(-1).view(DTYPES[rdt])[:got]
            )
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


# -- dynamic process management (MPI_Comm_spawn family) -------------------


def comm_spawn(cmd: str, argv_packed: str, maxprocs: int, root: int,
               h: int):
    try:
        c = _comm(h)
        if c is not _comms.get(1):
            # spawn's rendezvous is collective over the whole world
            # (every world proc joins the merged space); sub-comm spawn
            # would deadlock the procs outside it — reject loudly
            raise err.MPICommError(
                "MPI_Comm_spawn is supported on MPI_COMM_WORLD only"
            )
        from ompi_tpu_torch.api.spawn import spawn

        args = [a for a in argv_packed.split("\x1f") if a]
        ic = spawn([cmd] + args, maxprocs, root)
        return (MPI_SUCCESS, _store_comm(ic, h))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def comm_get_parent():
    try:
        from ompi_tpu_torch.api.spawn import get_parent

        p = get_parent()
        return (MPI_SUCCESS, _store_comm(p) if p is not None else 0)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def intercomm_merge(h: int, high: int):
    try:
        ic = _comm(h)
        merged = ic.merge(bool(high))
        return (MPI_SUCCESS, _store_comm(merged, h))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def comm_remote_size(h: int):
    try:
        c = _comm(h)
        rs = getattr(c, "remote_size", None)
        if rs is None:
            raise err.MPICommError(f"handle {h} is not an intercommunicator")
        return (MPI_SUCCESS, int(rs))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


# -- user-defined ops (MPI_Op_create over a C callback) -------------------

#: reverse map: numpy dtype → a representative C datatype code
_DT_CODE = {}
for _code, _dt in DTYPES.items():
    _DT_CODE.setdefault(_dt, _code)

_next_op = 64  # predefined op codes stay below (OPS is the registry)


def op_create(fnptr: int, commute: int):
    """MPI_Op_create: wrap the C user function
    ``void fn(void *invec, void *inoutvec, int *len, MPI_Datatype *dt)``
    as an Op whose host kernel invokes it per fold step (invec = left
    operand, inoutvec = accumulator, per the reference's
    ompi_op_reduce convention)."""
    global _next_op
    try:
        UFN = ctypes.CFUNCTYPE(
            None, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        )
        cfn = UFN(fnptr)
        # the np_fn closure holds cfn — the trampoline lives exactly as
        # long as the Op it powers

        def np_fn(a, b):
            a = np.ascontiguousarray(a)
            out = np.array(b, copy=True)
            code = _DT_CODE.get(out.dtype)
            if code is None:
                raise err.MPITypeError(
                    f"user op: unsupported dtype {out.dtype}"
                )
            n = ctypes.c_int(out.size)
            dt = ctypes.c_int(code)
            cfn(a.ctypes.data, out.ctypes.data,
                ctypes.byref(n), ctypes.byref(dt))
            return out

        op = opmod.Op(
            f"user_op_{_next_op}", torch_fn=_host_kernel(np_fn), np_fn=np_fn,
            commutative=bool(commute),
        )
        handle = _next_op
        _next_op += 1
        OPS[handle] = op
        return (MPI_SUCCESS, handle)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def op_free(handle: int) -> int:
    if handle >= 64:  # predefined ops are permanent
        OPS.pop(handle, None)
    return MPI_SUCCESS


# -- comm_split_type / struct datatype / jagged reduce_scatter ------------


def comm_split_type(h: int, split_type: int, key: int):
    """MPI_Comm_split_type.  Rides the collective comm_split machinery
    (so SHARED/UNDEFINED mixes across ranks pair up and ``key``
    orders ranks per the standard).  SHARED (1) resolves to one domain
    spanning the comm: the RTE is single-host, so every process shares
    the host — a multi-host RTE would key the color by hostname from
    the modex."""
    try:
        if split_type == -32766:  # MPI_UNDEFINED
            return comm_split(h, -32766, key)
        if split_type != 1:  # MPI_COMM_TYPE_SHARED
            raise err.MPIArgError(f"unknown split_type {split_type}")
        return comm_split(h, 0, key)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def type_create_struct(count: int, bl_ptr: int, disp_ptr: int,
                       types_ptr: int):
    try:
        from ompi_tpu_torch.ddt.datatype import create_struct

        bls = [int(v) for v in _view(bl_ptr, count, 7)]
        disps = [int(v) for v in _view(disp_ptr, count, 20)]  # MPI_Aint
        codes = [int(v) for v in _view(types_ptr, count, 7)]
        d = create_struct(bls, disps, [_ddt(c) for c in codes])
        code = _store_dtype(d)
        _record_envelope(code, 10, [count] + bls, disps, codes)
        return (MPI_SUCCESS, code)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def reduce_scatter(sptr, rptr, counts_ptr, dtcode, opcode, h) -> int:
    """MPI_Reduce_scatter with per-rank counts (jagged allowed).
    Equal counts route through the block path (fabric); jagged through
    the ordered host fold."""
    try:
        c = _comm(h)
        n = getattr(c, "size", 1)
        counts = [int(v) for v in _view(counts_ptr, n, 7)]
        total = sum(counts)
        me = comm_rank(h)[1]
        src = (_view(rptr, total, dtcode) if sptr == _IN_PLACE
               else _view(sptr, total, dtcode))
        if len(set(counts)) == 1:
            x = src.reshape(1, n, counts[0]).copy()
            out = _host(c.reduce_scatter_block(_row(c, x), OPS[opcode]))
            mine = out[me if _is_single_controller(c) else 0]
        else:
            x = src[None, :].copy()
            if _is_single_controller(c):
                # Comm.reduce_scatter validates op/dtype + counts and
                # takes the (n, total) whole-comm shape
                out = c.reduce_scatter(
                    np.broadcast_to(x[0], (n,) + x[0].shape).copy(),
                    OPS[opcode], counts,
                )
                mine = out[me]
            else:
                out = c.reduce_scatter(x, OPS[opcode], counts)
                mine = out[0]
        got = min(counts[me], int(np.asarray(mine).size))
        if got:
            _view(rptr, got, dtcode)[:] = (
                np.asarray(mine).reshape(-1).view(DTYPES[dtcode])[:got]
            )
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


# -- one-sided (MPI_Win_* over the DCN osc / single-controller osc) -------

_wins: dict[int, object] = {}
_next_win_h = 1


def _win(h: int):
    w = _wins.get(h)
    if w is None:
        raise err.MPIWinError(f"invalid window handle {h}")
    return w


def win_create(base_ptr: int, size_bytes: int, disp_unit: int, h: int):
    """MPI_Win_create: expose `size_bytes` of caller memory.  The
    window views the C memory zero-copy (puts land in the C array)."""
    global _next_win_h
    try:
        c = _comm(h)
        nbytes = int(size_bytes)
        if nbytes > 0:
            raw = (ctypes.c_ubyte * nbytes).from_address(base_ptr)
            base = np.frombuffer(raw, dtype=np.uint8)
        else:
            base = np.zeros(0, np.uint8)
        w = _new_win(c, base)
        w._disp_unit = max(1, int(disp_unit))
        handle = _next_win_h
        _next_win_h += 1
        _wins[handle] = w
        return (MPI_SUCCESS, handle)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def _new_win(c, base: np.ndarray):
    """A window over this rank's host bytes ``base`` (aliased: puts land
    in the C memory)."""
    if _is_single_controller(c):
        from ompi_tpu_torch.osc.win import Win

        # standalone: a size-1 world — per-rank bases is just ours
        return Win.create(c, [base])
    return c.win_create([base])


def _addr(mem) -> int:
    """The host address of a window region (0 when it has none)."""
    if isinstance(mem, np.ndarray):
        return int(mem.ctypes.data)
    if isinstance(mem, torch.Tensor) and mem.device.type == "cpu":
        return int(mem.data_ptr())
    return 0


def _win_alloc(h: int, size_bytes: int, disp_unit: int):
    """MPI_Win_allocate(_shared): the window owns HOST memory — the C
    program loads and stores through the returned base pointer, so it
    cannot live on the card.  (err, win handle, base address)."""
    global _next_win_h
    c = _comm(h)
    base = np.zeros(max(int(size_bytes), 1), np.uint8)
    w = _new_win(c, base)
    w._disp_unit = disp_unit
    _next_win_h += 1
    _wins[_next_win_h] = w
    return (MPI_SUCCESS, _next_win_h, _addr(base))


def win_free(wh: int) -> int:
    try:
        w = _wins.pop(wh, None)
        if w is not None:
            w.free()
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def win_fence(wh: int, assertion: int) -> int:
    try:
        _win(wh).fence(assertion)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def _is_dist_win(w) -> bool:
    """MultiProcWin (DCN windows) vs the single-controller Win."""
    return not _is_single_controller(w.comm)


def _win_elem_disp(w, tdisp: int, dt) -> int:
    byte_disp = int(tdisp) * w._disp_unit
    if byte_disp % dt.itemsize:
        raise err.MPIWinError(
            f"displacement {tdisp} (x{w._disp_unit}B) not aligned to "
            f"{dt.itemsize}-byte elements"
        )
    return byte_disp // dt.itemsize


def win_type_error() -> int:
    """Shim helper: asymmetric origin/target type signatures are
    unsupported — raised HERE so the comm errhandler applies (the
    default ARE_FATAL aborts instead of silently skipping the op)."""
    return _fail(err.MPITypeError(
        "RMA origin and target type/count must match in this "
        "implementation"
    ), 1)


def win_put(wh: int, optr: int, count: int, dtcode: int, target: int,
            tdisp: int) -> int:
    try:
        w = _win(wh)
        dt = DTYPES[dtcode]
        data = _view(optr, count, dtcode).copy()
        e0 = _win_elem_disp(w, tdisp, dt)
        if _is_dist_win(w):
            w.put(target, data, disp=e0, dt=dt)
        else:
            w.memory(target).view(dt)[e0 : e0 + count] = data
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def win_get(wh: int, optr: int, count: int, dtcode: int, target: int,
            tdisp: int) -> int:
    try:
        w = _win(wh)
        dt = DTYPES[dtcode]
        e0 = _win_elem_disp(w, tdisp, dt)
        if _is_dist_win(w):
            out = w.get(target, count, disp=e0, dt=dt)
        else:
            out = w.memory(target).view(dt)[e0 : e0 + count]
        _view(optr, count, dtcode)[:] = np.asarray(out).reshape(-1)[:count]
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def win_accumulate(wh: int, optr: int, count: int, dtcode: int,
                   target: int, tdisp: int, opcode: int) -> int:
    try:
        w = _win(wh)
        dt = DTYPES[dtcode]
        data = _view(optr, count, dtcode).copy()
        op = OPS[opcode]
        e0 = _win_elem_disp(w, tdisp, dt)
        if _is_dist_win(w):
            w.accumulate(target, data, disp=e0, op=op, dt=dt)
        else:
            seg = w.memory(target).view(dt)[e0 : e0 + count]
            seg[:] = data if op is opmod.REPLACE else op.np_fn(seg, data)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def win_fetch_and_op(wh: int, optr: int, rptr: int, dtcode: int,
                     target: int, tdisp: int, opcode: int) -> int:
    try:
        w = _win(wh)
        dt = DTYPES[dtcode]
        op = OPS[opcode]
        # MPI_NO_OP: origin buffer is irrelevant and may be NULL —
        # never dereference it (a read would segfault the interpreter)
        val = (dt.type(0) if op is opmod.NO_OP or optr == 0
               else _view(optr, 1, dtcode)[0])
        e0 = _win_elem_disp(w, tdisp, dt)
        if _is_dist_win(w):
            old = w.fetch_and_op(target, val, disp=e0, op=op, dt=dt)
        else:
            mem = w.memory(target).view(dt)
            old = mem[e0].copy()
            if op is opmod.REPLACE:
                mem[e0] = val
            elif op is not opmod.NO_OP:
                mem[e0] = op.np_fn(np.asarray(mem[e0]), np.asarray(val))
        _view(rptr, 1, dtcode)[0] = old
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def win_lock(wh: int, lock_type: int, target: int, assertion: int) -> int:
    try:
        w = _win(wh)
        if _is_dist_win(w):
            w.lock(target, lock_type)
        else:
            from ompi_tpu_torch.osc import win as _oscwin

            # mpi.h: SHARED=1, EXCLUSIVE=2 — osc/win.py's constants
            # differ, so translate rather than forward the raw value
            lt = (_oscwin.LOCK_SHARED if lock_type == 1
                  else _oscwin.LOCK_EXCLUSIVE)
            w.lock(0, target, lt, assertion)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def win_unlock(wh: int, target: int) -> int:
    try:
        w = _win(wh)
        if _is_dist_win(w):
            w.unlock(target)
        else:
            w.unlock(0, target)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def win_flush(wh: int, target: int) -> int:
    try:
        w = _win(wh)
        if _is_dist_win(w):
            w.flush(target)
        else:
            w.flush(0, target)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


# -- MPI-IO (MPI_File_* over the ompio stack) -----------------------------

_files: dict[int, object] = {}
_next_file_h = 1


def _file(fh: int):
    f = _files.get(fh)
    if f is None:
        raise err.MPIFileError(f"invalid file handle {fh}")
    return f


def file_open(h: int, path: str, amode: int, info_h: int = 0):
    """MPI_File_open (collective).  Multi-process jobs open the file
    per-process over the LOCAL comm (the shared filesystem is the
    coupling, as in fs/ufs); collective completion is a comm barrier.
    Shared-file-pointer ops are therefore single-process only.
    ``info_h``: MPI_Info handle whose hints attach to the handle."""
    global _next_file_h
    try:
        c = _comm(h)
        hints = dict(_infos.get(info_h, {})) if info_h else None
        if _is_single_controller(c):
            f = c.file_open(path, amode, hints=hints)
            # authoritative shared-pointer reset: a stale <path>.shfp
            # left by an earlier job must not leak in (creator-only
            # seeding inside File.__init__ deliberately skips existing
            # side files; with one controlling process there are no
            # unsynchronized peers to protect, so reset is safe here)
            from ompi_tpu_torch.io.file import MODE_APPEND

            f._sharedfp.set(f.get_size() if amode & MODE_APPEND else 0)
            ent = (f, False, 0, c)
        else:
            from ompi_tpu_torch.io.file import MODE_DELETE_ON_CLOSE
            from ompi_tpu_torch.op import MIN as _MIN

            # per-process open over the shared filesystem: exactly one
            # process (proc 0) carries DELETE_ON_CLOSE, so the first
            # close cannot delete the file out from under the others
            amode_local = amode
            if (amode & MODE_DELETE_ON_CLOSE) and c.proc != 0:
                amode_local &= ~MODE_DELETE_ON_CLOSE
            f = exc = None
            try:
                f = c.local.file_open(path, amode_local, hints=hints)
            except err.MPIError as e2:
                exc = e2
            # collective success agreement: a one-sided failure must
            # not leave the successful openers stuck in a barrier
            ok = c.allreduce(
                np.full((c.local_size, 1), 0.0 if exc else 1.0), _MIN
            )
            if float(np.asarray(ok).min()) < 1.0:
                if f is not None:
                    f.close()
                raise exc if exc is not None else err.MPIFileError(
                    f"collective open of {path!r} failed on a peer process"
                )
            # shared-pointer epoch: every peer's open (and creator-only
            # seed) is complete by the agreement above, so one
            # designated process now authoritatively resets the
            # cross-process pointer (a stale <path>.shfp from an
            # earlier job on the same path must not leak in), and a
            # second barrier orders that reset before any peer's
            # write_shared/read_shared
            if c.proc == 0:
                from ompi_tpu_torch.io.file import MODE_APPEND

                f._sharedfp.set(f.get_size() if amode & MODE_APPEND
                                else 0)
            c.barrier()
            ent = (f, True, 0, c)
        handle = _next_file_h
        _next_file_h += 1
        _files[handle] = ent
        return (MPI_SUCCESS, handle)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def file_set_info(fh: int, info_h: int) -> int:
    """MPI_File_set_info: merge the info's hints onto the handle
    (striping hints only matter at create time; later merges are
    recorded and surfaced, per the reference's hint semantics)."""
    try:
        f = _file(fh)[0]  # invalid/closed handle -> MPI_ERR_FILE
        if info_h:
            f.hints.update(
                {str(k): str(v) for k, v in _infos.get(info_h, {}).items()}
            )
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def file_get_info(fh: int):
    """MPI_File_get_info: a NEW info carrying the handle's effective
    hints plus the selected fs driver name."""
    try:
        f = _file(fh)[0]  # invalid/closed handle -> MPI_ERR_FILE
        _, ih = info_create()
        d = dict(f.hints)
        fs = getattr(f.component, "fs", None)
        if fs is not None and hasattr(fs, "fs_name"):
            d.setdefault("mca_fs", fs.fs_name(f._fd))
        _infos[ih] = d
        return (MPI_SUCCESS, ih)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_close(fh: int) -> int:
    """Collective close: multi-process files barrier first so the
    DELETE_ON_CLOSE holder (proc 0) deletes only after every process
    finished its IO."""
    try:
        ent = _files.get(fh)
        if ent is not None:
            if ent[1]:
                ent[3].barrier()
            ent[0].close()
            _files.pop(fh, None)  # only a completed close releases
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def file_get_size(fh: int):
    try:
        return (MPI_SUCCESS, int(_file(fh)[0].get_size()))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_set_size(fh: int, size: int) -> int:
    try:
        _file(fh)[0].set_size(int(size))
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def file_seek(fh: int, offset: int, whence: int) -> int:
    try:
        f, multi, _r, _c = _file(fh)
        f.seek(0, int(offset), int(whence))
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def _dense_read_clamp(f, byte_start: int, count: int, itemsize: int) -> int:
    """MPI requires a reduced count at EOF.  For dense views (filetype
    == etype: the byte-stream default) the available bytes are exactly
    file size − start; exotic filetype maps keep the requested count
    (the io engine zero-fills holes by design)."""
    disp, etype, filetype = f.get_view(0)
    if filetype.size != etype.size:
        return count
    avail = max(0, f.get_size() - (disp + byte_start))
    return min(count, avail // max(1, itemsize))


def _etype_units(f, nbytes: int) -> int:
    """C counts are datatype elements; the io layer counts etypes of
    the current view — convert (must divide exactly)."""
    esize = f.get_view(0)[1].size
    if nbytes % max(1, esize):
        raise err.MPIArgError(
            f"{nbytes} B is not a whole number of view etypes ({esize} B)"
        )
    return nbytes // max(1, esize)


def file_write_at(fh: int, offset: int, ptr: int, count: int,
                  dtcode: int):
    try:
        f = _file(fh)[0]
        data = _pack_from(ptr, count, dtcode)
        dt_size = (_dtypes[dtcode].size if dtcode in _dtypes
                   else DTYPES[dtcode].itemsize)
        written = f.write_at(0, int(offset), np.asarray(data))
        esize = f.get_view(0)[1].size
        return (MPI_SUCCESS,
                (written * esize // max(1, dt_size)) * dt_size)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_read_at(fh: int, offset: int, ptr: int, count: int, dtcode: int):
    try:
        f = _file(fh)[0]
        dt = DTYPES.get(dtcode)
        if dt is None:
            raise err.MPITypeError(f"unsupported datatype {dtcode}")
        esize = f.get_view(0)[1].size
        count = _dense_read_clamp(f, int(offset) * esize, count, dt.itemsize)
        units = _etype_units(f, count * dt.itemsize)
        out = f.read_at(0, int(offset), units, dtype=dt)
        got = int(np.asarray(out).size)
        if got:
            _view(ptr, got, dtcode)[:] = np.asarray(out).reshape(-1)
        return (MPI_SUCCESS, got * _unit_nbytes(dtcode))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_write(fh: int, ptr: int, count: int, dtcode: int):
    try:
        f = _file(fh)[0]
        data = _pack_from(ptr, count, dtcode)
        written = f.write(0, np.asarray(data))
        esize = f.get_view(0)[1].size
        dt_size = (_dtypes[dtcode].size if dtcode in _dtypes
                   else DTYPES[dtcode].itemsize)
        return (MPI_SUCCESS,
                (written * esize // max(1, dt_size)) * dt_size)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_read(fh: int, ptr: int, count: int, dtcode: int):
    try:
        f = _file(fh)[0]
        dt = DTYPES.get(dtcode)
        if dt is None:
            raise err.MPITypeError(f"unsupported datatype {dtcode}")
        esize = f.get_view(0)[1].size
        count = _dense_read_clamp(f, f.get_position(0) * esize, count,
                                  dt.itemsize)
        out = f.read(0, _etype_units(f, count * dt.itemsize), dtype=dt)
        got = int(np.asarray(out).size)
        if got:
            _view(ptr, got, dtcode)[:] = np.asarray(out).reshape(-1)
        return (MPI_SUCCESS, got * _unit_nbytes(dtcode))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_write_at_all(fh: int, offset: int, ptr: int, count: int,
                      dtcode: int):
    """Collective write: independent data movement + completion
    barrier (the fcoll two-phase optimization applies in the
    single-controller engine; across processes the filesystem is the
    aggregator)."""
    try:
        ent = _file(fh)
        rc = file_write_at(fh, offset, ptr, count, dtcode)
        if ent[1]:
            ent[3].barrier()
        return rc
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_read_at_all(fh: int, offset: int, ptr: int, count: int,
                     dtcode: int):
    try:
        ent = _file(fh)
        if ent[1]:
            ent[3].barrier()  # writers before us have completed
        return file_read_at(fh, offset, ptr, count, dtcode)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_set_view(fh: int, disp: int, etype_code: int, filetype_code: int):
    try:
        f = _file(fh)[0]
        f.set_view(0, int(disp), _ddt(etype_code), _ddt(filetype_code))
        _file_view_codes[fh] = (int(disp), etype_code, filetype_code)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


# -- probe / name / error utilities --------------------------------------


def iprobe(source: int, tag: int, h: int):
    """MPI_Iprobe: (flag, source, tag, nbytes) — payload BYTES (the C
    status unit; PMPI_Get_count divides by the queried type's size)."""
    try:
        c = _comm(h)
        me = comm_rank(h)[1]
        st = c.iprobe(me, None if source == -1 else source,
                      None if tag == -1 else tag)
        if st is None:
            return (MPI_SUCCESS, 0, -1, -1, 0)
        return (MPI_SUCCESS, 1, int(st.source), int(st.tag), int(st.nbytes))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0, -1, -1, 0)


def probe(source: int, tag: int, h: int):
    """MPI_Probe (blocking); count slot in payload BYTES."""
    try:
        c = _comm(h)
        me = comm_rank(h)[1]
        st = c.probe(me, None if source == -1 else source,
                     None if tag == -1 else tag)
        return (MPI_SUCCESS, int(st.source), int(st.tag), int(st.nbytes))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), -1, -1, 0)


def comm_get_name(h: int):
    try:
        return (MPI_SUCCESS, str(_comm(h).name))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), "")


# -- MPI_T tool interface -------------------------------------------------


def t_init() -> int:
    try:
        from ompi_tpu_torch.tool import mpit

        mpit.init_thread()
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _t_fail(e)


def t_finalize() -> int:
    try:
        from ompi_tpu_torch.tool import mpit

        mpit.finalize()
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _t_fail(e)


def t_cvar_get_num():
    try:
        from ompi_tpu_torch.tool import mpit

        return (MPI_SUCCESS, int(mpit.cvar_get_num()))
    except BaseException as e:  # noqa: BLE001
        return (_t_fail(e), 0)


def t_cvar_get_name(index: int):
    try:
        from ompi_tpu_torch.tool import mpit

        return (MPI_SUCCESS, str(mpit.cvar_get_info(index).name))
    except BaseException as e:  # noqa: BLE001
        return (_t_fail(e), "")


def t_cvar_read(index: int):
    """Integer/bool cvars only (the C shim's _int reader): non-integer
    cvars return an error instead of a fabricated value."""
    try:
        from ompi_tpu_torch.tool import mpit

        v = mpit.cvar_read(index)
        if isinstance(v, bool) or isinstance(v, int):
            return (MPI_SUCCESS, int(v))
        raise err.MPIArgError(
            f"cvar {index} is not integer-valued (use the string reader)"
        )
    except BaseException as e:  # noqa: BLE001
        return (_t_fail(e), 0)


def t_cvar_index(name: str):
    try:
        from ompi_tpu_torch.tool import mpit

        return (MPI_SUCCESS, int(mpit.cvar_index(name)))
    except BaseException as e:  # noqa: BLE001
        return (_t_fail(e), -1)


def t_pvar_get_num():
    try:
        from ompi_tpu_torch.tool import mpit

        return (MPI_SUCCESS, int(mpit.pvar_get_num()))
    except BaseException as e:  # noqa: BLE001
        return (_t_fail(e), 0)


def t_pvar_read(index: int):
    try:
        from ompi_tpu_torch.tool import mpit

        v = mpit.pvar_read(index)
        # array-valued pvars (trace latency histograms) collapse to
        # their total through the scalar C surface
        return (MPI_SUCCESS, int(sum(v) if isinstance(v, list) else v))
    except BaseException as e:  # noqa: BLE001
        return (_t_fail(e), 0)


def t_pvar_index(name: str):
    try:
        from ompi_tpu_torch.tool import mpit

        return (MPI_SUCCESS, int(mpit.pvar_index(name)))
    except BaseException as e:  # noqa: BLE001
        return (_t_fail(e), -1)


_pvar_starts = 0


def t_pvar_start() -> int:
    """Refcounted: SPC attachment is process-global, so counting stays
    on until the LAST started handle stops (stopping one handle must
    not silently freeze another's counter)."""
    global _pvar_starts
    try:
        from ompi_tpu_torch.tool import mpit

        mpit.pvar_start()
        _pvar_starts += 1
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _t_fail(e)


def t_pvar_stop() -> int:
    global _pvar_starts
    try:
        from ompi_tpu_torch.tool import mpit

        _pvar_starts = max(0, _pvar_starts - 1)
        if _pvar_starts == 0:
            mpit.pvar_stop()
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _t_fail(e)


# -- cartesian topology (MPI_Cart_* / MPI_Dims_create) --------------------

_carts: dict[int, tuple[list[int], list[int]]] = {}  # comm handle → geometry


def dims_create(nnodes: int, ndims: int, dims_ptr: int) -> int:
    try:
        from ompi_tpu_torch.api.topo import dims_create as _dc

        view = _view(dims_ptr, ndims, 7)
        out = _dc(nnodes, ndims, [int(v) for v in view])
        view[:] = out
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def cart_create(h: int, ndims: int, dims_ptr: int, periods_ptr: int,
                reorder: int):
    """MPI_Cart_create: geometry over the first prod(dims) ranks (ranks
    beyond get MPI_COMM_NULL) — rides the collective comm_split."""
    try:
        import math

        from ompi_tpu_torch.api.topo import validate_dims

        c = _comm(h)
        dims = [int(v) for v in _view(dims_ptr, ndims, 7)]
        periods = [int(v) for v in _view(periods_ptr, ndims, 7)]
        validate_dims(dims)
        del reorder  # identity order: one process per rank on one host
        # (a topology-aware reorder would be the launcher's mapper's job)
        nnodes = math.prod(dims)
        if nnodes > getattr(c, "size", 1):
            raise err.MPIDimsError(
                f"cartesian grid {dims} needs {nnodes} ranks; comm has "
                f"{c.size}"
            )
        rc, ch = _split_prefix(h, nnodes)
        if rc != MPI_SUCCESS:
            return (rc, 0)
        if ch:
            _carts[ch] = (dims, periods)
        return (MPI_SUCCESS, ch)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def _split_prefix(h: int, nnodes: int):
    """Collective split keeping the first ``nnodes`` ranks (others get
    MPI_COMM_NULL) — correct in BOTH models: the single-controller
    split takes per-rank colors; the distributed one this process's."""
    c = _comm(h)
    if _is_single_controller(c):
        n = c.size
        colors = [0] * nnodes + [-32766] * (n - nnodes)
        sub = c.split(colors, [0] * n)[0] if nnodes else None
        return (MPI_SUCCESS, _store_comm(sub, h) if sub is not None else 0)
    me = comm_rank(h)[1]
    return comm_split(h, 0 if me < nnodes else -32766, 0)


def _cart_geom(h: int):
    _comm(h)  # liveness: freed comms lose their topology too
    g = _carts.get(h)
    if g is None:
        raise err.MPITopologyError(f"comm {h} has no cartesian topology")
    return g


def cartdim_get(h: int):
    try:
        return (MPI_SUCCESS, len(_cart_geom(h)[0]))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def cart_get(h: int, maxdims: int, dims_ptr: int, periods_ptr: int,
             coords_ptr: int) -> int:
    try:
        dims, periods = _cart_geom(h)
        nd = min(maxdims, len(dims))
        _view(dims_ptr, nd, 7)[:] = dims[:nd]
        _view(periods_ptr, nd, 7)[:] = periods[:nd]
        me = comm_rank(h)[1]
        _view(coords_ptr, nd, 7)[:] = _coords_of(dims, me)[:nd]
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def _coords_of(dims: list[int], rank: int) -> list[int]:
    from ompi_tpu_torch.api.topo import cart_coords_of

    return cart_coords_of(dims, rank)


def _rank_of(dims: list[int], periods: list[int], coords: list[int]) -> int:
    from ompi_tpu_torch.api.topo import cart_rank_of

    return cart_rank_of(dims, periods, coords)


def cart_rank(h: int, coords_ptr: int):
    try:
        dims, periods = _cart_geom(h)
        coords = [int(v) for v in _view(coords_ptr, len(dims), 7)]
        return (MPI_SUCCESS, _rank_of(dims, periods, coords))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def cart_coords(h: int, rank: int, maxdims: int, coords_ptr: int) -> int:
    try:
        dims, _ = _cart_geom(h)
        nd = min(maxdims, len(dims))
        _view(coords_ptr, nd, 7)[:] = _coords_of(dims, rank)[:nd]
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def cart_shift(h: int, direction: int, disp: int):
    """(rank_source, rank_dest); MPI_PROC_NULL (-2) off non-periodic
    edges."""
    try:
        dims, periods = _cart_geom(h)
        me = comm_rank(h)[1]
        coords = _coords_of(dims, me)

        def shifted(sign: int) -> int:
            c2 = list(coords)
            c2[direction] += sign * disp
            try:
                return _rank_of(dims, periods, c2)
            except err.MPIArgError:
                return -2  # MPI_PROC_NULL

        return (MPI_SUCCESS, shifted(-1), shifted(+1))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), -2, -2)


# -- graph topology (MPI_Graph_*) ----------------------------------------

_graphs: dict[int, tuple[list[int], list[int]]] = {}  # handle → (index, edges)


def graph_create(h: int, nnodes: int, index_ptr: int, edges_ptr: int,
                 reorder: int):
    """MPI_Graph_create over the collective comm_split (ranks beyond
    nnodes get MPI_COMM_NULL)."""
    try:
        c = _comm(h)
        from ompi_tpu_torch.api.topo import validate_graph

        index = [int(v) for v in _view(index_ptr, nnodes, 7)]
        nedges = index[-1] if index else 0
        if nedges < 0:
            raise err.MPIArgError(f"negative edge count from index {index}")
        edges = [int(v) for v in _view(edges_ptr, nedges, 7)]
        del reorder
        if nnodes > getattr(c, "size", 1):
            raise err.MPITopologyError(
                f"graph of {nnodes} nodes larger than comm ({c.size})"
            )
        validate_graph(index, edges)
        rc, ch = _split_prefix(h, nnodes)
        if rc != MPI_SUCCESS:
            return (rc, 0)
        if ch:
            _graphs[ch] = (index, edges)
        return (MPI_SUCCESS, ch)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def _graph_geom(h: int):
    _comm(h)  # liveness
    g = _graphs.get(h)
    if g is None:
        raise err.MPITopologyError(f"comm {h} has no graph topology")
    return g


def graphdims_get(h: int):
    try:
        index, edges = _graph_geom(h)
        return (MPI_SUCCESS, len(index), len(edges))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0, 0)


def graph_neighbors_count(h: int, rank: int):
    try:
        from ompi_tpu_torch.api.topo import graph_neighbors_of

        index, edges = _graph_geom(h)
        return (MPI_SUCCESS, len(graph_neighbors_of(index, edges, rank)))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def graph_neighbors(h: int, rank: int, maxn: int, out_ptr: int) -> int:
    try:
        from ompi_tpu_torch.api.topo import graph_neighbors_of

        index, edges = _graph_geom(h)
        ns = graph_neighbors_of(index, edges, rank)[:maxn]
        if ns:
            _view(out_ptr, len(ns), 7)[:] = ns
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


# ======================================================================
# Round-3 C ABI breadth (VERDICT r2 missing #1): pack/unpack, alltoallv,
# reduce_local, sendrecv_replace, attributes/keyvals, Info objects,
# persistent p2p, i-variant collectives, error classes.
# ======================================================================

# -- MPI_Pack / MPI_Unpack (the convertor exposed at the C surface) ----


def pack_size(incount: int, dtcode: int):
    try:
        d = _dtypes.get(dtcode)
        size = d.size * incount if d is not None \
            else DTYPES[dtcode].itemsize * incount
        return (MPI_SUCCESS, int(size))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def pack(inptr: int, incount: int, dtcode: int, outptr: int, outsize: int,
         position: int):
    """MPI_Pack: convertor-pack `incount` elements into outbuf at
    `position`; returns (err, new_position)."""
    try:
        data = _pack_from(inptr, incount, dtcode)
        raw = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        if position + raw.nbytes > outsize:
            raise err.MPIArgError(
                f"pack overflow: {position}+{raw.nbytes} > {outsize}")
        dst = (ctypes.c_ubyte * outsize).from_address(outptr)
        np.frombuffer(dst, np.uint8)[position : position + raw.nbytes] = raw
        return (MPI_SUCCESS, position + raw.nbytes)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), position)


def unpack(inptr: int, insize: int, position: int, outptr: int,
           outcount: int, dtcode: int):
    """MPI_Unpack: convertor-unpack from the packed buffer at
    `position`; returns (err, new_position)."""
    try:
        d = _dtypes.get(dtcode)
        nbytes = (d.size if d is not None
                  else DTYPES[dtcode].itemsize) * outcount
        if position + nbytes > insize:
            raise err.MPIArgError(
                f"unpack overflow: {position}+{nbytes} > {insize}")
        src = (ctypes.c_ubyte * insize).from_address(inptr)
        payload = np.frombuffer(src, np.uint8)[
            position : position + nbytes].copy()
        _unpack_into(outptr, outcount, dtcode, payload)
        return (MPI_SUCCESS, position + nbytes)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), position)


def pack_external(inptr: int, incount: int, dtcode: int, outptr: int,
                  outsize: int, position: int):
    """MPI_Pack_external("external32"): big-endian canonical layout."""
    try:
        data = _pack_from(inptr, incount, dtcode)
        big = np.ascontiguousarray(data)
        if big.dtype.byteorder != ">":
            big = big.astype(big.dtype.newbyteorder(">"))
        raw = big.view(np.uint8).reshape(-1)
        if position + raw.nbytes > outsize:
            raise err.MPIArgError("pack_external overflow")
        dst = (ctypes.c_ubyte * outsize).from_address(outptr)
        np.frombuffer(dst, np.uint8)[position : position + raw.nbytes] = raw
        return (MPI_SUCCESS, position + raw.nbytes)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), position)


def unpack_external(inptr: int, insize: int, position: int, outptr: int,
                    outcount: int, dtcode: int):
    try:
        d = _dtypes.get(dtcode)
        base = DTYPES[dtcode] if d is None else np.dtype(
            d.uniform_leaf.np_dtype if d.uniform_leaf is not None else np.uint8)
        nbytes = (d.size if d is not None else base.itemsize) * outcount
        if position + nbytes > insize:
            raise err.MPIArgError("unpack_external overflow")
        src = (ctypes.c_ubyte * insize).from_address(inptr)
        payload = np.frombuffer(src, np.uint8)[
            position : position + nbytes].copy()
        native = payload.view(base.newbyteorder(">")).astype(base)
        _unpack_into(outptr, outcount, dtcode, native.view(np.uint8))
        return (MPI_SUCCESS, position + nbytes)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), position)


# -- MPI_Reduce_local / MPI_Op_commutative ------------------------------


def reduce_local(inptr: int, inoutptr: int, count: int, dtcode: int,
                 opcode: int) -> int:
    try:
        op = OPS[opcode]
        a = _view(inptr, count, dtcode)
        b = _view(inoutptr, count, dtcode)
        b[:] = op.np_fn(a, b)  # MPI: inout = in ⊕ inout (in = left operand)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def op_commutative(opcode: int):
    try:
        return (MPI_SUCCESS, 1 if OPS[opcode].commutative else 0)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


# -- MPI_Sendrecv_replace ----------------------------------------------


def sendrecv_replace(ptr: int, count: int, dtcode: int, dest: int,
                     sendtag: int, source: int, recvtag: int, h: int):
    try:
        c = _comm(h)
        me = comm_rank(h)[1]
        buf = _view(ptr, count, dtcode).copy()
        c.send(buf, me, dest, sendtag)
        req = c.irecv(
            me,
            None if source == -1 else source,
            None if recvtag == -1 else recvtag,
        )
        payload = req.wait()
        st = req.status
        got = _unpack_into(ptr, count, dtcode, payload)
        return (MPI_SUCCESS, int(st.source), int(st.tag),
                got * _unit_nbytes(dtcode))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), -1, -1, 0)


# -- MPI_Alltoallv ------------------------------------------------------


def alltoallv(sptr, scounts_ptr, sdispls_ptr, sdt, rptr, rcounts_ptr,
              rdispls_ptr, rdt, h) -> int:
    try:
        c = _comm(h)
        n = getattr(c, "size", 1)
        me = comm_rank(h)[1]
        scounts, sdispls = _vparams(scounts_ptr, sdispls_ptr, n)
        rcounts, rdispls = _vparams(rcounts_ptr, rdispls_ptr, n)
        sitem = DTYPES[sdt].itemsize
        row = [
            _view(sptr + sdispls[j] * sitem, scounts[j], sdt).copy()
            for j in range(n)
        ]
        if _is_single_controller(c):
            matrix = [row] * n if n > 1 else [row]
            out = c.alltoallv(matrix)
            mine = out[me]
        else:
            out = c.alltoallv([row])
            mine = out[0]
        ritem = DTYPES[rdt].itemsize
        for j in range(n):
            got = min(rcounts[j], int(np.asarray(mine[j]).size))
            if got:
                dst = _view(rptr + rdispls[j] * ritem, got, rdt)
                dst[:] = np.asarray(mine[j]).reshape(-1).view(
                    DTYPES[rdt])[:got]
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


# -- eager i-variants (completion-at-issue is MPI-legal) ---------------


def ireduce(sptr, rptr, count, dtcode, opcode, root, h):
    try:
        return _eager_coll(
            lambda: reduce(sptr, rptr, count, dtcode, opcode, root, h))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def iscan(sptr, rptr, count, dtcode, opcode, h):
    try:
        return _eager_coll(lambda: scan(sptr, rptr, count, dtcode, opcode, h))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def iexscan(sptr, rptr, count, dtcode, opcode, h):
    try:
        return _eager_coll(
            lambda: exscan(sptr, rptr, count, dtcode, opcode, h))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def igather(sptr, scount, sdt, rptr, rcount, rdt, root, h):
    try:
        return _eager_coll(
            lambda: gather(sptr, scount, sdt, rptr, rcount, rdt, root, h))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def iscatter(sptr, scount, sdt, rptr, rcount, rdt, root, h):
    try:
        return _eager_coll(
            lambda: scatter(sptr, scount, sdt, rptr, rcount, rdt, root, h))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def igatherv(sptr, scount, sdt, rptr, rcounts_ptr, displs_ptr, rdt, root, h):
    try:
        return _eager_coll(
            lambda: gatherv(sptr, scount, sdt, rptr, rcounts_ptr,
                            displs_ptr, rdt, root, h))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def iscatterv(sptr, scounts_ptr, displs_ptr, sdt, rptr, rcount, rdt, root, h):
    try:
        return _eager_coll(
            lambda: scatterv(sptr, scounts_ptr, displs_ptr, sdt, rptr,
                             rcount, rdt, root, h))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def iallgatherv(sptr, scount, sdt, rptr, rcounts_ptr, displs_ptr, rdt, h):
    try:
        return _eager_coll(
            lambda: allgatherv(sptr, scount, sdt, rptr, rcounts_ptr,
                               displs_ptr, rdt, h))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def ialltoallv(sptr, scounts_ptr, sdispls_ptr, sdt, rptr, rcounts_ptr,
               rdispls_ptr, rdt, h):
    try:
        return _eager_coll(
            lambda: alltoallv(sptr, scounts_ptr, sdispls_ptr, sdt, rptr,
                              rcounts_ptr, rdispls_ptr, rdt, h))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def ireduce_scatter(sptr, rptr, counts_ptr, dtcode, opcode, h):
    try:
        return _eager_coll(
            lambda: reduce_scatter(sptr, rptr, counts_ptr, dtcode, opcode, h))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def ireduce_scatter_block(sptr, rptr, rcount, dtcode, opcode, h):
    try:
        return _eager_coll(
            lambda: reduce_scatter_block(sptr, rptr, rcount, dtcode,
                                         opcode, h))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


# -- persistent point-to-point (MPI_Send_init / MPI_Start) --------------
# Entry kinds: ("pers_send", params) / ("pers_recv", params, live_req).
# Persistent handles survive wait (inactive), die on request_free.


def send_init(ptr: int, count: int, dtcode: int, dest: int, tag: int, h: int):
    try:
        _comm(h)  # validate now (MPI_ERR_COMM at init time)
        return (MPI_SUCCESS, _store_req(
            ("pers_send", None, (ptr, count, dtcode, dest, tag, h), 0, 0)))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def recv_init(ptr: int, count: int, dtcode: int, source: int, tag: int,
              h: int):
    try:
        _comm(h)
        return (MPI_SUCCESS, _store_req(
            ("pers_recv", None, (ptr, count, dtcode, source, tag, h), 0, 0)))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


# -- persistent collectives (MPI_Allreduce_init / MPI_Start) ------------
# The embedded-Python fallback behind the shim's C plan cache (derived
# datatypes, user/logical ops, non-fast-path comms, size-1 worlds):
# entry kind "pers_coll" carries a plan dict whose ``run`` closure was
# compiled ONCE at init — comm resolution, buffer views, op lookup,
# IN_PLACE resolution all pre-bound — and MPI_Start replays it.


def _pers_coll_req(plan: dict):
    return (MPI_SUCCESS, _store_req(("pers_coll", None, plan, 0, 0)))


def allreduce_init(sptr, rptr, count, dtcode, opcode, h):
    try:
        c = _comm(h)
        if dtcode in _dtypes:
            # derived datatype: the blocking path's convertor staging
            # dominates — replay the whole entry point per start
            return _pers_coll_req(
                {"run": lambda: allreduce(sptr, rptr, count, dtcode,
                                          opcode, h)})
        op = OPS[opcode]
        x = _coll_in(sptr, rptr, count, dtcode)
        out_v = _view(rptr, count, dtcode)

        def run() -> None:
            res = _host(c.allreduce(_row(c, x[None, :]), op))
            out_v[:] = res.reshape(-1)[:count]

        return _pers_coll_req({"run": run})
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def bcast_init(ptr, count, dtcode, root, h):
    try:
        c = _comm(h)
        if dtcode in _dtypes:
            return _pers_coll_req(
                {"run": lambda: bcast(ptr, count, dtcode, root, h)})
        buf = _view(ptr, count, dtcode)

        def run() -> None:
            res = _host(c.bcast(_row(c, buf[None, :]), root=root))
            buf[:] = res.reshape(-1)[:count]

        return _pers_coll_req({"run": run})
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def allgather_init(sptr, scount, sdt, rptr, rcount, rdt, h):
    try:
        c = _comm(h)
        if sdt in _dtypes or rdt in _dtypes:
            return _pers_coll_req(
                {"run": lambda: allgather(sptr, scount, sdt, rptr, rcount,
                                          rdt, h)})
        n = getattr(c, "size", 1)
        out_v = _view(rptr, rcount * n, rdt)
        if sptr == _IN_PLACE:
            me = comm_rank(h)[1]

            def run() -> None:
                x = out_v[me * rcount:(me + 1) * rcount].copy()
                res = _host(c.allgather(_row(c, x[None, :])))
                out_v[:] = res.reshape(-1)[:rcount * n]
        else:
            x_in = _view(sptr, scount, sdt)

            def run() -> None:
                res = _host(c.allgather(_row(c, x_in[None, :])))
                out_v[:] = res.reshape(-1)[:rcount * n]

        return _pers_coll_req({"run": run})
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def reduce_init(sptr, rptr, count, dtcode, opcode, root, h):
    try:
        c = _comm(h)
        if dtcode in _dtypes:
            return _pers_coll_req(
                {"run": lambda: reduce(sptr, rptr, count, dtcode, opcode,
                                       root, h)})
        op = OPS[opcode]
        x = _coll_in(sptr, rptr, count, dtcode)
        me = comm_rank(h)[1]
        out_v = (_view(rptr, count, dtcode)
                 if me == root and rptr not in (0, _IN_PLACE) else None)

        def run() -> None:
            res = _host(c.reduce(_row(c, x[None, :]), op, root=root))
            if out_v is not None:
                out_v[:] = res.reshape(-1)[:count]

        return _pers_coll_req({"run": run})
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def barrier_init(h):
    try:
        c = _comm(h)
        return _pers_coll_req({"run": c.barrier})
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def start(rh: int) -> int:
    try:
        entry = _requests.get(rh)
        if entry is None:
            raise err.MPIRequestError(f"invalid request handle {rh}")
        kind = entry[0]
        if kind == "pers_coll":
            # replay the compiled plan (eager completion, like the
            # blocking-underneath i-collectives — MPI-legal)
            entry[2]["run"]()
            _requests[rh] = ("pers_coll", CompletedRequest(), entry[2],
                             0, 0)
            return MPI_SUCCESS
        if kind == "pers_send":
            ptr, count, dtcode, dest, tag, h = entry[2]
            rc = send(ptr, count, dtcode, dest, tag, h)
            if rc != MPI_SUCCESS:
                return rc
            _requests[rh] = ("pers_send", CompletedRequest(), entry[2], 0, 0)
            return MPI_SUCCESS
        if kind == "pers_recv":
            ptr, count, dtcode, source, tag, h = entry[2]
            c = _comm(h)
            me = comm_rank(h)[1]
            req = c.irecv(
                me,
                None if source == -1 else source,
                None if tag == -1 else tag,
            )
            _requests[rh] = ("pers_recv", req, entry[2], 0, 0)
            return MPI_SUCCESS
        raise err.MPIRequestError(f"start on non-persistent request {kind}")
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def request_free(rh: int) -> int:
    """MPI_Request_free: the handle dies now, but an ACTIVE operation
    must be allowed to run to completion (MPI 3.7.3) — including the
    delivery of a freed irecv's payload into the user buffer (the
    standard pattern: post irecv, free the handle, learn of completion
    through a later barrier).  Live requests are detached — normalized
    to a (kind, req, ptr, count, dtcode) completion record — onto a
    background list reaped opportunistically (each free / finalize);
    completion runs the same ``_complete`` delivery a wait would."""
    try:
        entry = _requests.pop(rh, None)
        _reap_freed_active()
        if entry is None:
            return MPI_SUCCESS
        kind, req = entry[0], entry[1]
        if req is None or kind in ("done", "grequest"):
            return MPI_SUCCESS
        if kind == "pers_recv":
            p = entry[2]
            norm = ("recv", req, p[0], p[1], p[2])
        elif kind == "pers_send":
            norm = ("send", req, 0, 0, 0)
        else:
            norm = entry
        if req.test():
            _finish_freed(norm)
        elif not _hook_freed_delivery(req, norm):
            _freed_active.append(norm)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


_freed_active: list = []  # detached live completion records


def _hook_freed_delivery(req, norm) -> bool:
    """Chain the request's ``_deliver`` so the user-buffer unpack runs
    the moment the payload lands (on the delivering thread) — the
    freed-irecv + barrier + read-buffer pattern must see the data
    without any further MPI library call.  Returns False when the
    request kind has no delivery hook (caller falls back to the reap
    list)."""
    orig = getattr(req, "_deliver", None)
    if orig is None or not callable(orig):
        return False
    fired = []

    def hooked(payload, status, _orig=orig):
        _orig(payload, status)
        fired.append(1)
        _finish_freed(norm)

    req._deliver = hooked
    # raced: delivered between the test() above and the hook landing
    if not fired and req.test():
        _finish_freed(norm)
    return True


def _finish_freed(norm) -> None:
    """Run a detached request's completion action (buffer delivery for
    recv/coll kinds).  Errors are swallowed: the handle is gone, so
    there is no request to report them through (MPI's liberty for
    freed requests)."""
    try:
        if norm[0] in ("recv", "coll"):
            _complete(norm)
        else:
            norm[1].wait()
    except BaseException:  # noqa: BLE001
        pass


def _reap_freed_active() -> None:
    if not _freed_active:
        return
    keep = []
    for norm in _freed_active:
        try:
            done = norm[1].test()
        except BaseException:  # noqa: BLE001
            done = True  # errored in flight: nothing left to deliver
        if done:
            _finish_freed(norm)
        else:
            keep.append(norm)
    _freed_active[:] = keep


def request_get_status(rh: int):
    """Non-destructive test: (err, flag, source, tag, count)."""
    try:
        entry = _requests.get(rh)
        if entry is None:  # completed-and-freed or NULL: flag=1
            return (MPI_SUCCESS, 1, -1, -1, 0)
        req = entry[1]
        if entry[0].startswith("pers_") and req is None:
            # inactive persistent request: complete by definition
            return (MPI_SUCCESS, 1, -1, -1, 0)
        ready = entry[0] == "done" or (req is not None and req.test())
        if not ready:
            return (MPI_SUCCESS, 0, -1, -1, 0)
        st = getattr(req, "status", None)
        if st is not None:
            return (MPI_SUCCESS, 1, int(st.source), int(st.tag), 0)
        return (MPI_SUCCESS, 1, -1, -1, 0)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0, -1, -1, 0)


# -- attributes / keyvals (MPI_Comm_create_keyval family) ---------------
# keyval table shared by comm/type/win attr surfaces (the reference
# separates namespaces; handle codes here are disjoint by construction).

_keyvals: dict[int, tuple] = {}  # kv -> (copy_fnptr, delete_fnptr, extra)
_next_keyval = 1000
_attr_tables: dict[tuple, dict] = {}  # (kind, handle) -> {kv: value}

#: predefined attribute keyvals (mpi.h codes)
KEYVAL_TAG_UB = 1
KEYVAL_HOST = 2
KEYVAL_IO = 3
KEYVAL_WTIME_IS_GLOBAL = 4
KEYVAL_UNIVERSE_SIZE = 9
KEYVAL_APPNUM = 11
KEYVAL_WIN_BASE = 5
KEYVAL_WIN_SIZE = 6
KEYVAL_WIN_DISP_UNIT = 7

_TAG_UB_VALUE = (1 << 30) - 1


def keyval_create(copy_fnptr: int, delete_fnptr: int, extra: int):
    global _next_keyval
    _next_keyval += 1
    _keyvals[_next_keyval] = (copy_fnptr, delete_fnptr, extra)
    return (MPI_SUCCESS, _next_keyval)


def keyval_free(kv: int) -> int:
    _keyvals.pop(kv, None)
    return MPI_SUCCESS


def _attrs_for(kind: str, h: int) -> dict:
    return _attr_tables.setdefault((kind, h), {})


def attr_set(kind: str, h: int, kv: int, value: int) -> int:
    try:
        if kind == "comm":
            _comm(h)  # validate handle
        _attrs_for(kind, h)[kv] = int(value)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def attr_get(kind: str, h: int, kv: int):
    """(err, flag, value).  Predefined comm keyvals resolve built-ins."""
    try:
        if kind == "comm" and kv in (
            KEYVAL_TAG_UB, KEYVAL_WTIME_IS_GLOBAL, KEYVAL_UNIVERSE_SIZE,
            KEYVAL_APPNUM, KEYVAL_HOST, KEYVAL_IO,
        ):
            if kv == KEYVAL_TAG_UB:
                return (MPI_SUCCESS, 1, _TAG_UB_VALUE)
            if kv == KEYVAL_WTIME_IS_GLOBAL:
                return (MPI_SUCCESS, 1, 0)
            if kv == KEYVAL_UNIVERSE_SIZE:
                return (MPI_SUCCESS, 1, _size)
            if kv == KEYVAL_APPNUM:
                return (MPI_SUCCESS, 1, 0)
            return (MPI_SUCCESS, 0, 0)  # HOST/IO: not set
        table = _attr_tables.get((kind, h))
        if table is None or kv not in table:
            return (MPI_SUCCESS, 0, 0)
        return (MPI_SUCCESS, 1, table[kv])
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0, 0)


def attr_delete(kind: str, h: int, kv: int) -> int:
    try:
        table = _attr_tables.get((kind, h))
        if table is not None:
            ent = _keyvals.get(kv)
            val = table.pop(kv, None)
            if ent is not None and ent[1] and val is not None:
                DFN = ctypes.CFUNCTYPE(
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p)
                DFN(ent[1])(h, kv, val, ent[2])
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def attr_copy_on_dup(kind: str, old_h: int, new_h: int) -> None:
    """Run keyval copy callbacks at comm_dup (MPI attribute caching
    semantics: flag-returning C callbacks decide propagation)."""
    table = _attr_tables.get((kind, old_h))
    if not table:
        return
    out = {}
    for kv, val in table.items():
        ent = _keyvals.get(kv)
        if ent is None:
            continue
        copy_fn = ent[0]
        if copy_fn == 0:  # MPI_COMM_NULL_COPY_FN: never copied
            continue
        if copy_fn == 1:  # MPI_COMM_DUP_FN sentinel: always copied
            out[kv] = val
            continue
        CFN = ctypes.CFUNCTYPE(
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int))
        newval = ctypes.c_void_p(0)
        flag = ctypes.c_int(0)
        rc = CFN(copy_fn)(old_h, kv, ent[2], val,
                          ctypes.byref(newval), ctypes.byref(flag))
        if rc == MPI_SUCCESS and flag.value:
            out[kv] = newval.value or 0
    if out:
        _attr_tables[(kind, new_h)] = out


# -- MPI_Info objects ---------------------------------------------------

_infos: dict[int, dict] = {}
_next_info = 1


def info_create():
    global _next_info
    _next_info += 1
    _infos[_next_info] = {}
    return (MPI_SUCCESS, _next_info)


def info_set(ih: int, key: str, value: str) -> int:
    try:
        _infos.setdefault(ih, {})[key] = value
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def info_get_valuelen(ih: int, key: str):
    d = _infos.get(ih, {})
    if key in d:
        return (MPI_SUCCESS, 1, len(d[key]))
    return (MPI_SUCCESS, 0, 0)


def info_delete(ih: int, key: str) -> int:
    _infos.get(ih, {}).pop(key, None)
    return MPI_SUCCESS


def info_dup(ih: int):
    global _next_info
    _next_info += 1
    _infos[_next_info] = dict(_infos.get(ih, {}))
    return (MPI_SUCCESS, _next_info)


def info_free(ih: int) -> int:
    _infos.pop(ih, None)
    return MPI_SUCCESS


def info_get_nkeys(ih: int):
    return (MPI_SUCCESS, len(_infos.get(ih, {})))


# -- user error classes/codes (MPI_Add_error_*) -------------------------

_user_error_strings: dict[int, str] = {}
_next_error_class = 64


def add_error_class():
    global _next_error_class
    _next_error_class += 1
    return (MPI_SUCCESS, _next_error_class)


def add_error_code(errorclass: int):
    global _next_error_class
    _next_error_class += 1
    _user_error_strings.setdefault(
        _next_error_class, _user_error_strings.get(errorclass, ""))
    return (MPI_SUCCESS, _next_error_class)


def add_error_string(errorcode: int, string: str) -> int:
    _user_error_strings[errorcode] = string
    return MPI_SUCCESS


def user_error_string(errorcode: int):
    s = _user_error_strings.get(errorcode)
    if s is None:
        return (MPI_ERR_ARG, "")
    return (MPI_SUCCESS, s)


# -- topology additions (MPI_Cart_sub / MPI_Topo_test / maps) -----------

MPI_GRAPH_TOPO, MPI_CART_TOPO, MPI_DIST_GRAPH_TOPO, MPI_UNDEFINED_TOPO = (
    1, 2, 3, -32766)


def topo_test(h: int):
    try:
        _comm(h)
        if h in _carts:
            return (MPI_SUCCESS, MPI_CART_TOPO)
        if h in _graphs:
            return (MPI_SUCCESS, MPI_GRAPH_TOPO)
        if h in _dist_graphs:
            return (MPI_SUCCESS, MPI_DIST_GRAPH_TOPO)
        return (MPI_SUCCESS, MPI_UNDEFINED_TOPO)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def cart_sub(h: int, remain_ptr: int):
    """MPI_Cart_sub: split the cart comm into sub-grids keeping the
    dims where remain[d] != 0; returns this rank's sub-comm with its
    own cartesian geometry attached."""
    try:
        dims, periods = _cart_geom(h)
        nd = len(dims)
        remain = [int(v) for v in _view(remain_ptr, nd, 7)]
        me = comm_rank(h)[1]
        coords = _coords_of(dims, me)
        # color = coordinates along DROPPED dims; key = rank within kept
        color = 0
        for d in range(nd):
            if not remain[d]:
                color = color * dims[d] + coords[d]
        rc, ch = comm_split(h, color, me)
        if rc != MPI_SUCCESS:
            return (rc, 0)
        keep_dims = [dims[d] for d in range(nd) if remain[d]]
        keep_periods = [periods[d] for d in range(nd) if remain[d]]
        if not keep_dims:
            keep_dims, keep_periods = [1], [0]
        if ch:
            _carts[ch] = (keep_dims, keep_periods)
        return (MPI_SUCCESS, ch)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def cart_map(h: int, ndims: int, dims_ptr: int, periods_ptr: int):
    """MPI_Cart_map: recommended rank for this process (identity order
    — one process per rank on one host; ranks past the grid get
    MPI_UNDEFINED)."""
    try:
        import math

        c = _comm(h)
        dims = [int(v) for v in _view(dims_ptr, ndims, 7)]
        me = comm_rank(h)[1]
        nnodes = math.prod(dims)
        del periods_ptr
        return (MPI_SUCCESS, me if me < nnodes else -32766)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def graph_map(h: int, nnodes: int):
    try:
        me = comm_rank(h)[1]
        return (MPI_SUCCESS, me if me < nnodes else -32766)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def graph_get(h: int, maxindex: int, maxedges: int, index_ptr: int,
              edges_ptr: int) -> int:
    try:
        index, edges = _graph_geom(h)
        idx = index[:maxindex]
        edg = edges[:maxedges]
        if idx:
            _view(index_ptr, len(idx), 7)[:] = idx
        if edg:
            _view(edges_ptr, len(edg), 7)[:] = edg
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


# -- distributed graph topology (MPI_Dist_graph_*) ----------------------

_dist_graphs: dict[int, tuple] = {}  # h -> (sources, destinations)


def dist_graph_create_adjacent(h: int, indegree: int, sources_ptr: int,
                               outdegree: int, dests_ptr: int):
    try:
        _comm(h)
        sources = ([int(v) for v in _view(sources_ptr, indegree, 7)]
                   if indegree else [])
        dests = ([int(v) for v in _view(dests_ptr, outdegree, 7)]
                 if outdegree else [])
        rc, ch = comm_dup(h)
        if rc != MPI_SUCCESS:
            return (rc, 0)
        _dist_graphs[ch] = (sources, dests)
        return (MPI_SUCCESS, ch)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def dist_graph_create(h: int, n: int, sources_ptr: int, degrees_ptr: int,
                      dests_ptr: int):
    """General constructor: every process contributes edge lists; this
    single-source variant uses the local contribution (each process
    must describe its own edges — the common usage; a cross-process
    union requires an allgather the adjacent form avoids)."""
    try:
        _comm(h)
        me = comm_rank(h)[1]
        srcs = [int(v) for v in _view(sources_ptr, n, 7)] if n else []
        degs = [int(v) for v in _view(degrees_ptr, n, 7)] if n else []
        total = sum(degs)
        dsts = [int(v) for v in _view(dests_ptr, total, 7)] if total else []
        my_out, my_in = [], []
        off = 0
        for i, s in enumerate(srcs):
            block = dsts[off : off + degs[i]]
            off += degs[i]
            if s == me:
                my_out.extend(block)
            my_in.extend([s] * sum(1 for d in block if d == me))
        rc, ch = comm_dup(h)
        if rc != MPI_SUCCESS:
            return (rc, 0)
        _dist_graphs[ch] = (my_in, my_out)
        return (MPI_SUCCESS, ch)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def dist_graph_neighbors_count(h: int):
    try:
        if h not in _dist_graphs:
            raise err.MPITopologyError(f"comm {h} has no dist-graph topology")
        s, d = _dist_graphs[h]
        return (MPI_SUCCESS, len(s), len(d), 0)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0, 0, 0)


def dist_graph_neighbors(h: int, maxin: int, sources_ptr: int,
                         maxout: int, dests_ptr: int) -> int:
    try:
        if h not in _dist_graphs:
            raise err.MPITopologyError(f"comm {h} has no dist-graph topology")
        s, d = _dist_graphs[h]
        if s[:maxin]:
            _view(sources_ptr, len(s[:maxin]), 7)[:] = s[:maxin]
        if d[:maxout]:
            _view(dests_ptr, len(d[:maxout]), 7)[:] = d[:maxout]
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


# -- RMA breadth: lock_all/flush family, PSCW, request-based ops --------


def win_lock_all(wh: int, assertion: int) -> int:
    try:
        w = _win(wh)
        if _is_dist_win(w):
            w.lock_all()
        else:
            w.lock_all(0, assertion)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def win_unlock_all(wh: int) -> int:
    try:
        w = _win(wh)
        w.unlock_all() if _is_dist_win(w) else w.unlock_all(0)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def win_flush_all(wh: int) -> int:
    try:
        w = _win(wh)
        if _is_dist_win(w):
            w.flush_all()  # one sync round-trip per PROCESS
        else:
            w.flush_all(0)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def win_flush_local(wh: int, target: int) -> int:
    try:
        w = _win(wh)
        w.flush(target) if _is_dist_win(w) else w.flush_local(0, target)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def win_flush_local_all(wh: int) -> int:
    return win_flush_all(wh)


def win_sync(wh: int) -> int:
    try:
        w = _win(wh)
        if not _is_dist_win(w):
            w.sync(0)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def win_post(wh: int, gh: int, assertion: int) -> int:
    """MPI_Win_post (PSCW exposure epoch): origins come from the group."""
    try:
        w = _win(wh)
        g = _group(gh)
        if _is_dist_win(w):
            return MPI_SUCCESS  # dist wins: fence-counted epochs
        w.post(0, list(g.ranks), assertion)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def win_start(wh: int, gh: int, assertion: int) -> int:
    try:
        w = _win(wh)
        g = _group(gh)
        if _is_dist_win(w):
            return MPI_SUCCESS
        w.start(0, list(g.ranks), assertion)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def win_complete(wh: int) -> int:
    try:
        w = _win(wh)
        if _is_dist_win(w):
            return win_flush_all(wh)
        w.complete(0)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def win_wait(wh: int) -> int:
    try:
        w = _win(wh)
        if _is_dist_win(w):
            return MPI_SUCCESS
        w.wait(0)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def win_test(wh: int):
    try:
        w = _win(wh)
        if _is_dist_win(w):
            return (MPI_SUCCESS, 1)
        return (MPI_SUCCESS, 1 if w.test(0) else 0)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def win_get_accumulate(wh: int, optr: int, ocount: int, rptr: int,
                       rcount: int, dtcode: int, target: int, tdisp: int,
                       opcode: int) -> int:
    try:
        w = _win(wh)
        dt = DTYPES[dtcode]
        op = OPS[opcode]
        e0 = _win_elem_disp(w, tdisp, dt)
        data = (np.zeros(0, dt) if op is opmod.NO_OP or optr == 0
                else _view(optr, ocount, dtcode).copy())
        if _is_dist_win(w):
            # fetch-then-accumulate on the target's ordered request
            # stream; same-origin ordering makes the pair coherent
            old = np.asarray(w.get(target, rcount, disp=e0, dt=dt))
            if op is not opmod.NO_OP and data.size:
                w.accumulate(target, data, disp=e0, op=op, dt=dt)
        else:
            mem = w.memory(target).view(dt)
            old = mem[e0 : e0 + rcount].copy()
            if op is opmod.REPLACE:
                mem[e0 : e0 + data.size] = data
            elif op is not opmod.NO_OP and data.size:
                seg = mem[e0 : e0 + data.size]
                seg[:] = op.np_fn(seg, data)
        _view(rptr, rcount, dtcode)[:] = np.asarray(old).reshape(-1)[:rcount]
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def win_compare_and_swap(wh: int, optr: int, cptr: int, rptr: int,
                         dtcode: int, target: int, tdisp: int) -> int:
    try:
        w = _win(wh)
        dt = DTYPES[dtcode]
        e0 = _win_elem_disp(w, tdisp, dt)
        val = _view(optr, 1, dtcode)[0]
        cmp_ = _view(cptr, 1, dtcode)[0]
        if _is_dist_win(w):
            old = w.compare_and_swap(target, val, cmp_, disp=e0, dt=dt)
        else:
            mem = w.memory(target).view(dt)
            old = mem[e0].copy()
            if old == cmp_:
                mem[e0] = val
        _view(rptr, 1, dtcode)[0] = old
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def win_rput(wh, optr, count, dtcode, target, tdisp):
    try:
        rc = win_put(wh, optr, count, dtcode, target, tdisp)
        if rc != MPI_SUCCESS:
            return (rc, 0)
        return (MPI_SUCCESS, _store_req(("done", None, 0, 0, (0, 0, 0))))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def win_rget(wh, optr, count, dtcode, target, tdisp):
    try:
        rc = win_get(wh, optr, count, dtcode, target, tdisp)
        if rc != MPI_SUCCESS:
            return (rc, 0)
        return (MPI_SUCCESS, _store_req(("done", None, 0, 0, (0, 0, 0))))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def win_raccumulate(wh, optr, count, dtcode, target, tdisp, opcode):
    try:
        rc = win_accumulate(wh, optr, count, dtcode, target, tdisp, opcode)
        if rc != MPI_SUCCESS:
            return (rc, 0)
        return (MPI_SUCCESS, _store_req(("done", None, 0, 0, (0, 0, 0))))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def win_rget_accumulate(wh, optr, ocount, rptr, rcount, dtcode, target,
                        tdisp, opcode):
    try:
        rc = win_get_accumulate(wh, optr, ocount, rptr, rcount, dtcode,
                                target, tdisp, opcode)
        if rc != MPI_SUCCESS:
            return (rc, 0)
        return (MPI_SUCCESS, _store_req(("done", None, 0, 0, (0, 0, 0))))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def win_allocate(h: int, size_bytes: int, disp_unit: int):
    """(err, win handle, base address) — base is the window memory this
    process owns (numpy-backed, address stable for the window's life)."""
    try:
        return _win_alloc(h, size_bytes, disp_unit)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0, 0)


def win_get_group(wh: int):
    try:
        w = _win(wh)
        g = w.group() if callable(getattr(w, "group", None)) else None
        if g is None:
            from ompi_tpu_torch.api.group import Group

            g = Group(range(w.comm.size))
        return (MPI_SUCCESS, _store_group(g))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def win_set_name(wh: int, name: str) -> int:
    try:
        w = _win(wh)
        if hasattr(w, "set_name"):
            w.set_name(name)
        else:
            w.name = name
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def win_get_name(wh: int):
    try:
        return (MPI_SUCCESS, getattr(_win(wh), "name", f"win#{wh}"))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), "")


def win_get_attr(wh: int, kv: int):
    """Predefined window attributes resolve from the window itself."""
    try:
        w = _win(wh)
        if kv == KEYVAL_WIN_BASE:
            me = 0 if _is_single_controller(w.comm) else w.comm.local_offset
            mem = w.memory(me)
            return (MPI_SUCCESS, 1,
                    int(mem.ctypes.data) if hasattr(mem, "ctypes") else 0)
        if kv == KEYVAL_WIN_SIZE:
            me = 0 if _is_single_controller(w.comm) else w.comm.local_offset
            return (MPI_SUCCESS, 1, int(w.memory(me).nbytes))
        if kv == KEYVAL_WIN_DISP_UNIT:
            return (MPI_SUCCESS, 1, int(getattr(w, "_disp_unit", 1)))
        return attr_get("win", wh, kv)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0, 0)


# -- MPI-IO breadth: shared pointers, plain _all, async, metadata -------


def file_write_all(fh: int, ptr: int, count: int, dtcode: int):
    """Collective write at individual pointers (two-phase underneath)."""
    try:
        f = _file(fh)[0]
        data = _pack_from(ptr, count, dtcode)
        dt_size = (_dtypes[dtcode].size if dtcode in _dtypes
                   else DTYPES[dtcode].itemsize)
        written = f.write_all([np.asarray(data)])[0]
        esize = f.get_view(0)[1].size
        return (MPI_SUCCESS,
                (written * esize // max(1, dt_size)) * dt_size)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_read_all(fh: int, ptr: int, count: int, dtcode: int):
    try:
        f = _file(fh)[0]
        dt = DTYPES.get(dtcode)
        if dt is None:
            raise err.MPITypeError(f"unsupported datatype {dtcode}")
        pos = f.get_position(0)
        esize = f.get_view(0)[1].size
        count = _dense_read_clamp(f, pos * esize, count, dt.itemsize)
        units = _etype_units(f, count * dt.itemsize)
        out = f.read_all([units])[0].view(dt)
        got = int(np.asarray(out).size)
        if got:
            _view(ptr, got, dtcode)[:] = np.asarray(out).reshape(-1)
        return (MPI_SUCCESS, got * _unit_nbytes(dtcode))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_write_shared(fh: int, ptr: int, count: int, dtcode: int):
    try:
        f = _file(fh)[0]
        data = _pack_from(ptr, count, dtcode)
        written = f.write_shared(0, np.asarray(data))
        return (MPI_SUCCESS, int(written) * _unit_nbytes(dtcode))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_read_shared(fh: int, ptr: int, count: int, dtcode: int):
    try:
        f = _file(fh)[0]
        dt = DTYPES.get(dtcode)
        if dt is None:
            raise err.MPITypeError(f"unsupported datatype {dtcode}")
        units = _etype_units(f, count * dt.itemsize)
        out = f.read_shared(0, units, dtype=dt)
        got = int(np.asarray(out).size)
        if got:
            _view(ptr, got, dtcode)[:] = np.asarray(out).reshape(-1)
        return (MPI_SUCCESS, got * _unit_nbytes(dtcode))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_seek_shared(fh: int, offset: int, whence: int) -> int:
    try:
        f = _file(fh)[0]
        f.seek_shared(int(offset), int(whence))
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def file_get_position_shared(fh: int):
    try:
        return (MPI_SUCCESS, int(_file(fh)[0].get_position_shared()))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_get_position(fh: int):
    try:
        return (MPI_SUCCESS, int(_file(fh)[0].get_position(0)))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_get_byte_offset(fh: int, offset: int):
    try:
        return (MPI_SUCCESS, int(_file(fh)[0].get_byte_offset(0, offset)))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_sync(fh: int) -> int:
    try:
        _file(fh)[0].sync()
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def file_preallocate(fh: int, size: int) -> int:
    try:
        _file(fh)[0].preallocate(int(size))
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def file_get_amode(fh: int):
    try:
        return (MPI_SUCCESS, int(_file(fh)[0].amode))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_set_atomicity(fh: int, flag: int) -> int:
    try:
        _file(fh)[0].set_atomicity(bool(flag))
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def file_get_atomicity(fh: int):
    try:
        return (MPI_SUCCESS, 1 if _file(fh)[0].get_atomicity() else 0)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_get_type_extent(fh: int, dtcode: int):
    try:
        d = _dtypes.get(dtcode)
        ext = d.extent if d is not None else DTYPES[dtcode].itemsize
        return (MPI_SUCCESS, int(ext))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_delete(path: str) -> int:
    import os

    try:
        os.remove(path)
        return MPI_SUCCESS
    except FileNotFoundError:
        return MPI_ERR_OTHER
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def file_iwrite_at(fh, offset, ptr, count, dtcode):
    try:
        rc, got = file_write_at(fh, offset, ptr, count, dtcode)
        if rc != MPI_SUCCESS:
            return (rc, 0)
        return (MPI_SUCCESS, _store_req(("done", None, 0, 0, (0, 0, got))))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_iread_at(fh, offset, ptr, count, dtcode):
    try:
        rc, got = file_read_at(fh, offset, ptr, count, dtcode)
        if rc != MPI_SUCCESS:
            return (rc, 0)
        return (MPI_SUCCESS, _store_req(("done", None, 0, 0, (0, 0, got))))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_iwrite(fh, ptr, count, dtcode):
    try:
        rc, got = file_write(fh, ptr, count, dtcode)
        if rc != MPI_SUCCESS:
            return (rc, 0)
        return (MPI_SUCCESS, _store_req(("done", None, 0, 0, (0, 0, got))))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_iread(fh, ptr, count, dtcode):
    try:
        rc, got = file_read(fh, ptr, count, dtcode)
        if rc != MPI_SUCCESS:
            return (rc, 0)
        return (MPI_SUCCESS, _store_req(("done", None, 0, 0, (0, 0, got))))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


# -- datatype breadth ---------------------------------------------------


def type_create_hvector(count: int, blocklength: int, stride_bytes: int,
                        base: int):
    try:
        d = _ddt(base).create_hvector(count, blocklength, stride_bytes)
        code = _store_dtype(d)
        _record_envelope(code, 5, [count, blocklength],
                         [stride_bytes], [base])
        return (MPI_SUCCESS, code)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def type_create_hindexed(count: int, bl_ptr: int, disp_ptr: int, base: int):
    try:
        bls = [int(v) for v in _view(bl_ptr, count, 7)]
        disps = [int(v) for v in _view(disp_ptr, count, 20)]  # MPI_Aint
        d = _ddt(base).create_hindexed(bls, disps)
        code = _store_dtype(d)
        _record_envelope(code, 7, [count] + bls, disps, [base])
        return (MPI_SUCCESS, code)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def type_create_hindexed_block(count: int, blocklength: int, disp_ptr: int,
                               base: int):
    try:
        disps = [int(v) for v in _view(disp_ptr, count, 20)]
        d = _ddt(base).create_hindexed([blocklength] * count, disps)
        code = _store_dtype(d)
        _record_envelope(code, 9, [count, blocklength], disps, [base])
        return (MPI_SUCCESS, code)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def type_create_indexed_block(count: int, blocklength: int, disp_ptr: int,
                              base: int):
    try:
        disps = [int(v) for v in _view(disp_ptr, count, 7)]
        d = _ddt(base).create_indexed_block(blocklength, disps)
        code = _store_dtype(d)
        _record_envelope(code, 8, [count, blocklength] + disps, [], [base])
        return (MPI_SUCCESS, code)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def type_create_resized(base: int, lb: int, extent: int):
    try:
        d = _ddt(base).create_resized(int(lb), int(extent))
        code = _store_dtype(d)
        _record_envelope(code, 13, [], [int(lb), int(extent)], [base])
        return (MPI_SUCCESS, code)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def type_create_subarray(ndims: int, sizes_ptr: int, subsizes_ptr: int,
                         starts_ptr: int, order: int, base: int):
    try:
        sizes = [int(v) for v in _view(sizes_ptr, ndims, 7)]
        subsizes = [int(v) for v in _view(subsizes_ptr, ndims, 7)]
        starts = [int(v) for v in _view(starts_ptr, ndims, 7)]
        d = _ddt(base).create_subarray(
            sizes, subsizes, starts,
            order="F" if order == 57 else "C")  # 57 = MPI_ORDER_FORTRAN
        code = _store_dtype(d)
        _record_envelope(code, 11,
                         [ndims] + sizes + subsizes + starts + [order],
                         [], [base])
        return (MPI_SUCCESS, code)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def type_get_true_extent(dtcode: int):
    try:
        d = _dtypes.get(dtcode)
        if d is None:
            size = DTYPES[dtcode].itemsize
            return (MPI_SUCCESS, 0, size)
        return (MPI_SUCCESS, int(d.true_lb), int(d.true_extent))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0, 0)


_type_names: dict[int, str] = {}


def type_set_name(dtcode: int, name: str) -> int:
    _type_names[dtcode] = name
    return MPI_SUCCESS


def type_get_name(dtcode: int):
    name = _type_names.get(dtcode)
    if name is None:
        d = _dtypes.get(dtcode)
        name = d.name if d is not None else f"MPI_dt#{dtcode}"
    return (MPI_SUCCESS, name)


# -- communicator/group breadth -----------------------------------------


def comm_test_inter(h: int):
    try:
        c = _comm(h)
        from ompi_tpu_torch.api.intercomm import Intercomm

        return (MPI_SUCCESS, 1 if isinstance(c, Intercomm) else 0)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def comm_remote_group(h: int):
    try:
        c = _comm(h)
        g = getattr(c, "remote_group", None)
        if g is None:
            raise err.MPICommError(f"comm {h} is not an intercommunicator")
        from ompi_tpu_torch.api.group import Group

        return (MPI_SUCCESS, _store_group(Group(list(g.ranks))))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def intercomm_create(local_h: int, local_leader: int, peer_h: int,
                     remote_leader: int, tag: int):
    try:
        from ompi_tpu_torch.api.intercomm import create_intercomm

        local = _comm(local_h)
        peer = _comm(peer_h)
        del tag, local_leader, remote_leader  # leaders implicit: single
        # controller sees both sides, the handshake collapses
        local_ranks = list(getattr(local.group, "ranks",
                                   range(local.size)))
        all_ranks = list(getattr(peer.group, "ranks", range(peer.size)))
        remote_ranks = [r for r in all_ranks if r not in set(local_ranks)]
        ic = create_intercomm(peer, local_ranks, remote_ranks)
        return (MPI_SUCCESS, _store_comm(ic, peer_h))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def group_range_incl(gh: int, n: int, ranges_ptr: int):
    try:
        from ompi_tpu_torch.api.group import Group

        g = _group(gh)
        triplets = _view(ranges_ptr, n * 3, 7)
        ranks = []
        for i in range(n):
            first, last, stride = (int(triplets[3 * i]),
                                   int(triplets[3 * i + 1]),
                                   int(triplets[3 * i + 2]))
            ranks.extend(range(first, last + (1 if stride > 0 else -1),
                               stride))
        world = [g.ranks[r] for r in ranks]
        return (MPI_SUCCESS, _store_group(Group(world)))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def group_range_excl(gh: int, n: int, ranges_ptr: int):
    try:
        from ompi_tpu_torch.api.group import Group

        g = _group(gh)
        triplets = _view(ranges_ptr, n * 3, 7)
        excl = set()
        for i in range(n):
            first, last, stride = (int(triplets[3 * i]),
                                   int(triplets[3 * i + 1]),
                                   int(triplets[3 * i + 2]))
            excl.update(range(first, last + (1 if stride > 0 else -1),
                              stride))
        world = [g.ranks[r] for r in range(g.size) if r not in excl]
        return (MPI_SUCCESS, _store_group(Group(world)))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


# -- matched probe/recv (MPI_Mprobe / MPI_Mrecv) ------------------------
# A message handle pins the probed (source, tag) pair; mrecv receives
# the next matching message — FIFO per (source, tag) makes this the
# probed message in the single-threaded C model.

_messages: dict[int, tuple] = {}
_next_message = 1


def mprobe(source: int, tag: int, h: int):
    """(err, message handle, source, tag, count_bytes)."""
    try:
        rc = probe(source, tag, h)
        if not isinstance(rc, tuple) or rc[0] != MPI_SUCCESS:
            return (rc if isinstance(rc, int) else rc[0], 0, -1, -1, 0)
        _, src, tg, cnt = rc
        global _next_message
        _next_message += 1
        _messages[_next_message] = (h, src, tg)
        return (MPI_SUCCESS, _next_message, src, tg, cnt)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0, -1, -1, 0)


def improbe(source: int, tag: int, h: int):
    """(err, flag, message handle, source, tag, count_bytes)."""
    try:
        rc = iprobe(source, tag, h)
        if not isinstance(rc, tuple) or rc[0] != MPI_SUCCESS:
            return (rc if isinstance(rc, int) else rc[0], 0, 0, -1, -1, 0)
        _, flag, src, tg, cnt = rc
        if not flag:
            return (MPI_SUCCESS, 0, 0, -1, -1, 0)
        global _next_message
        _next_message += 1
        _messages[_next_message] = (h, src, tg)
        return (MPI_SUCCESS, 1, _next_message, src, tg, cnt)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0, 0, -1, -1, 0)


def mrecv(mh: int, ptr: int, count: int, dtcode: int):
    """(err, source, tag, count)."""
    try:
        ent = _messages.pop(mh, None)
        if ent is None:
            raise err.MPIRequestError(f"invalid message handle {mh}")
        h, src, tg = ent
        return recv(ptr, count, dtcode, src, tg, h)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), -1, -1, 0)


def isend_done_handle(source: int, tag: int, count: int):
    """Completed-request handle carrying a status (shim helper for
    eager i-operations that already finished)."""
    return (MPI_SUCCESS,
            _store_req(("done", None, 0, 0, (source, tag, count))))


def info_get_value(ih: int, key: str):
    """(err, str) form for the shim's string-marshalling helper."""
    d = _infos.get(ih, {})
    if key not in d:
        return (MPI_ERR_ARG, "")
    return (MPI_SUCCESS, d[key])


def info_get_nthkey_str(ih: int, n: int):
    keys = list(_infos.get(ih, {}))
    if 0 <= n < len(keys):
        return (MPI_SUCCESS, keys[n])
    return (MPI_ERR_ARG, "")


_file_view_codes: dict[int, tuple] = {}  # fh -> (disp, etype, filetype)


def file_get_view_codes(fh: int):
    """(err, disp, etype code, filetype code) — codes recorded at
    set_view time (default: byte stream)."""
    try:
        f = _file(fh)[0]
        disp = f.get_view(0)[0]
        _, et, ft = _file_view_codes.get(fh, (0, 4, 4))
        return (MPI_SUCCESS, int(disp), et, ft)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0, 4, 4)


# ======================================================================
# Round-3 C ABI batch 2: neighbor collectives, alltoallw, type
# introspection (envelope/contents/darray/f90), MPI_T breadth,
# generalized requests, name service, window/io remainder.
# ======================================================================

# -- datatype envelope/contents (MPI_Type_get_envelope) -----------------
# combiner codes (mpi.h): NAMED=1, DUP=2, CONTIGUOUS=3, VECTOR=4,
# HVECTOR=5, INDEXED=6, HINDEXED=7, INDEXED_BLOCK=8, HINDEXED_BLOCK=9,
# STRUCT=10, SUBARRAY=11, DARRAY=12, RESIZED=13, F90_REAL=14,
# F90_COMPLEX=15, F90_INTEGER=16

_type_envelope: dict[int, tuple] = {}  # dtcode -> (combiner, ints, aints, types)


def _record_envelope(dtcode: int, combiner: int, ints=(), aints=(),
                     types=()) -> int:
    _type_envelope[dtcode] = (combiner, list(ints), list(aints), list(types))
    return dtcode


def type_get_envelope(dtcode: int):
    """(err, num_integers, num_addresses, num_datatypes, combiner)."""
    env = _type_envelope.get(dtcode)
    if env is None:
        return (MPI_SUCCESS, 0, 0, 0, 1)  # MPI_COMBINER_NAMED
    c, ints, aints, types = env
    return (MPI_SUCCESS, len(ints), len(aints), len(types), c)


def type_get_contents(dtcode: int, max_i: int, max_a: int, max_d: int,
                      ints_ptr: int, aints_ptr: int, types_ptr: int) -> int:
    try:
        env = _type_envelope.get(dtcode)
        if env is None:
            raise err.MPITypeError(
                f"MPI_Type_get_contents on a named datatype {dtcode}")
        _, ints, aints, types = env
        if len(ints) > max_i or len(aints) > max_a or len(types) > max_d:
            raise err.MPIArgError("get_contents arrays too small")
        if ints:
            _view(ints_ptr, len(ints), 7)[:] = ints
        if aints:
            _view(aints_ptr, len(aints), 20)[:] = aints
        if types:
            _view(types_ptr, len(types), 7)[:] = types
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def type_create_darray(size: int, rank: int, ndims: int, gsizes_ptr: int,
                       distribs_ptr: int, dargs_ptr: int, psizes_ptr: int,
                       order: int, base: int):
    """MPI_Type_create_darray, MPI_DISTRIBUTE_BLOCK subset (the HPF
    block distribution ScaLAPACK-style decompositions use; CYCLIC
    would need the full HPF machinery and raises)."""
    try:
        DISTRIBUTE_BLOCK, DISTRIBUTE_NONE = 121, 123
        gsizes = [int(v) for v in _view(gsizes_ptr, ndims, 7)]
        distribs = [int(v) for v in _view(distribs_ptr, ndims, 7)]
        psizes = [int(v) for v in _view(psizes_ptr, ndims, 7)]
        for d in distribs:
            if d not in (DISTRIBUTE_BLOCK, DISTRIBUTE_NONE):
                raise err.MPITypeError(
                    "darray: only MPI_DISTRIBUTE_BLOCK/NONE supported")
        # process coordinates in the process grid (C order)
        coords = []
        r = rank
        for p in reversed(psizes):
            coords.append(r % p)
            r //= p
        coords.reverse()
        subsizes, starts = [], []
        for i in range(ndims):
            if distribs[i] == DISTRIBUTE_NONE or psizes[i] == 1:
                subsizes.append(gsizes[i])
                starts.append(0)
            else:
                block = -(-gsizes[i] // psizes[i])  # ceil
                s = coords[i] * block
                subsizes.append(max(0, min(block, gsizes[i] - s)))
                starts.append(min(s, gsizes[i]))
        d = _ddt(base).create_subarray(
            gsizes, subsizes, starts, order="F" if order == 57 else "C")
        code = _store_dtype(d)
        _record_envelope(code, 12,
                         [size, rank, ndims] + gsizes + distribs
                         + [int(v) for v in _view(dargs_ptr, ndims, 7)]
                         + psizes + [order],
                         [], [base])
        return (MPI_SUCCESS, code)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def type_match_size(typeclass: int, size: int):
    """MPI_Type_match_size: TYPECLASS_{INTEGER=1,REAL=2,COMPLEX=3}."""
    table = {
        (1, 1): 17, (1, 2): 18, (1, 4): 19, (1, 8): 20,
        (2, 4): 13, (2, 8): 14,
        (3, 8): 25, (3, 16): 26,
    }
    code = table.get((typeclass, size))
    if code is None:
        return (MPI_ERR_ARG, 0)
    return (MPI_SUCCESS, code)


def type_create_f90(kind: str, p: int, r: int):
    """F90 parameterized types resolve to the matching C types."""
    if kind == "real":
        return (MPI_SUCCESS, 14 if p > 6 else 13)
    if kind == "complex":
        return (MPI_SUCCESS, 26 if p > 6 else 25)
    if kind == "integer":
        if r <= 2:
            return (MPI_SUCCESS, 17)
        if r <= 4:
            return (MPI_SUCCESS, 18)
        if r <= 9:
            return (MPI_SUCCESS, 19)
        return (MPI_SUCCESS, 20)
    return (MPI_ERR_ARG, 0)


# -- neighbor collectives (over cart/graph/dist-graph topologies) -------


#: reserved tag base for neighbor-collective internal traffic (user
#: tags live below; TAG_UB is 2^30-1 so this range is addressable)
_NEIGH_TAG = 1 << 29


def _cart_mirror(h: int, i: int) -> int | None:
    """For cartesian topologies, the SENDER's slot index that addresses
    me when I receive at slot ``i``: dimension d's (-1, +1) pair is
    mirrored (my -1 source used ITS +1 dest), i.e. i^1.  None for
    graph topologies, where occurrence-order FIFO pairing is already
    the adjacency-order semantics."""
    return (i ^ 1) if h in _carts else None


def _neighbors_of(h: int):
    """(sources, destinations) global-rank lists for comm ``h``'s
    topology (cart: shift neighbors in dimension order, the standard's
    required ordering; graph: adjacency; dist_graph: stored edges)."""
    me = comm_rank(h)[1]
    if h in _carts:
        dims, periods = _carts[h]
        coords = _coords_of(dims, me)
        ns = []
        for d in range(len(dims)):
            for disp in (-1, 1):
                c = list(coords)
                c[d] += disp
                if periods[d]:
                    c[d] %= dims[d]
                elif not 0 <= c[d] < dims[d]:
                    ns.append(-2)  # MPI_PROC_NULL
                    continue
                ns.append(_rank_of(dims, periods, c))
        return ns, ns  # cartesian neighborhoods are symmetric
    if h in _graphs:
        from ompi_tpu_torch.api.topo import graph_neighbors_of

        index, edges = _graphs[h]
        ns = graph_neighbors_of(index, edges, me)
        return list(ns), list(ns)
    if h in _dist_graphs:
        s, d = _dist_graphs[h]
        return list(s), list(d)
    raise err.MPITopologyError(f"comm {h} has no topology")


def neighbor_allgather(sptr, scount, sdt, rptr, rcount, rdt, h) -> int:
    """Each process sends its block to every out-neighbor and receives
    one block per in-neighbor (recvbuf order = neighbor order)."""
    try:
        c = _comm(h)
        me = comm_rank(h)[1]
        sources, dests = _neighbors_of(h)
        x = _view(sptr, scount, sdt).copy()
        cart = h in _carts
        for j, d in enumerate(dests):
            if d != -2:
                c.send(x, me, d, tag=_NEIGH_TAG + 0 + (j if cart else 0))
        item = DTYPES[rdt].itemsize
        for i, s in enumerate(sources):
            dst = _view(rptr + i * rcount * item, rcount, rdt)
            if s == -2:
                continue
            j = _cart_mirror(h, i)
            payload, _st = c.recv(me, s, _NEIGH_TAG + 0 if j is None else _NEIGH_TAG + 0 + j)
            flat = np.asarray(payload).reshape(-1).view(DTYPES[rdt])
            dst[:] = flat[:rcount]
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


def neighbor_allgatherv(sptr, scount, sdt, rptr, rcounts_ptr, displs_ptr,
                        rdt, h) -> int:
    try:
        c = _comm(h)
        me = comm_rank(h)[1]
        sources, dests = _neighbors_of(h)
        x = _view(sptr, scount, sdt).copy()
        cart = h in _carts
        for j, d in enumerate(dests):
            if d != -2:
                c.send(x, me, d, tag=_NEIGH_TAG + 64 + (j if cart else 0))
        counts, displs = _vparams(rcounts_ptr, displs_ptr, len(sources))
        item = DTYPES[rdt].itemsize
        for i, s in enumerate(sources):
            if s == -2:
                continue
            j = _cart_mirror(h, i)
            payload, _st = c.recv(me, s, _NEIGH_TAG + 64 if j is None else _NEIGH_TAG + 64 + j)
            flat = np.asarray(payload).reshape(-1).view(DTYPES[rdt])
            dst = _view(rptr + displs[i] * item, counts[i], rdt)
            dst[:] = flat[: counts[i]]
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


def neighbor_alltoall(sptr, scount, sdt, rptr, rcount, rdt, h) -> int:
    """Distinct block per out-neighbor; one block per in-neighbor."""
    try:
        c = _comm(h)
        me = comm_rank(h)[1]
        sources, dests = _neighbors_of(h)
        sitem = DTYPES[sdt].itemsize
        cart = h in _carts
        for j, d in enumerate(dests):
            if d != -2:
                blk = _view(sptr + j * scount * sitem, scount, sdt).copy()
                c.send(blk, me, d, tag=_NEIGH_TAG + 128 + (j if cart else 0))
        ritem = DTYPES[rdt].itemsize
        for i, s in enumerate(sources):
            if s == -2:
                continue
            j = _cart_mirror(h, i)
            payload, _st = c.recv(me, s, _NEIGH_TAG + 128 if j is None else _NEIGH_TAG + 128 + j)
            flat = np.asarray(payload).reshape(-1).view(DTYPES[rdt])
            dst = _view(rptr + i * rcount * ritem, rcount, rdt)
            dst[:] = flat[:rcount]
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


def neighbor_alltoallv(sptr, scounts_ptr, sdispls_ptr, sdt, rptr,
                       rcounts_ptr, rdispls_ptr, rdt, h) -> int:
    try:
        c = _comm(h)
        me = comm_rank(h)[1]
        sources, dests = _neighbors_of(h)
        scounts, sdispls = _vparams(scounts_ptr, sdispls_ptr, len(dests))
        rcounts, rdispls = _vparams(rcounts_ptr, rdispls_ptr, len(sources))
        sitem = DTYPES[sdt].itemsize
        cart = h in _carts
        for j, d in enumerate(dests):
            if d != -2:
                blk = _view(sptr + sdispls[j] * sitem, scounts[j], sdt).copy()
                c.send(blk, me, d, tag=_NEIGH_TAG + 192 + (j if cart else 0))
        ritem = DTYPES[rdt].itemsize
        for i, s in enumerate(sources):
            if s == -2:
                continue
            j = _cart_mirror(h, i)
            payload, _st = c.recv(me, s, _NEIGH_TAG + 192 if j is None else _NEIGH_TAG + 192 + j)
            flat = np.asarray(payload).reshape(-1).view(DTYPES[rdt])
            dst = _view(rptr + rdispls[i] * ritem, rcounts[i], rdt)
            dst[:] = flat[: rcounts[i]]
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


def ineighbor(fn_name: str, *args):
    try:
        fn = globals()[fn_name]
        return _eager_coll(lambda: fn(*args))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


# -- MPI_Alltoallw (per-block datatypes; counts in ELEMENTS, displs in
# BYTES, per the standard) ---------------------------------------------


def alltoallw(sptr, scounts_ptr, sdispls_ptr, stypes_ptr, rptr,
              rcounts_ptr, rdispls_ptr, rtypes_ptr, h) -> int:
    try:
        c = _comm(h)
        n = getattr(c, "size", 1)
        me = comm_rank(h)[1]
        scounts = [int(v) for v in _view(scounts_ptr, n, 7)]
        sdispls = [int(v) for v in _view(sdispls_ptr, n, 7)]
        stypes = [int(v) for v in _view(stypes_ptr, n, 7)]
        rcounts = [int(v) for v in _view(rcounts_ptr, n, 7)]
        rdispls = [int(v) for v in _view(rdispls_ptr, n, 7)]
        rtypes = [int(v) for v in _view(rtypes_ptr, n, 7)]
        # pack every outgoing block to bytes (the convertor handles
        # derived types), jagged-exchange, unpack per-block
        row = [
            np.ascontiguousarray(
                _pack_from(sptr + sdispls[j], scounts[j], stypes[j])
            ).view(np.uint8).reshape(-1)
            for j in range(n)
        ]
        if _is_single_controller(c):
            out = c.alltoallv([row] * n if n > 1 else [row])[me]
        else:
            out = c.alltoallv([row])[0]
        for j in range(n):
            _unpack_into(rptr + rdispls[j], rcounts[j], rtypes[j],
                         np.asarray(out[j]).view(np.uint8))
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e, h)


def ialltoallw(*args):
    try:
        return _eager_coll(lambda: alltoallw(*args))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


# -- generalized requests (MPI_Grequest_start/complete) -----------------


def grequest_start(query_fnptr: int, free_fnptr: int, cancel_fnptr: int,
                   extra: int):
    """The user drives completion (grequest_complete); at wait/test
    completion the query callback fills the status, and the free
    callback releases user state — the MPI-2 generalized request
    lifecycle."""
    try:
        return (MPI_SUCCESS, _store_req(
            ("grequest", None,
             (query_fnptr, free_fnptr, cancel_fnptr, extra), 0, 0)))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def grequest_complete(rh: int) -> int:
    try:
        entry = _requests.get(rh)
        if entry is None or entry[0] != "grequest":
            raise err.MPIRequestError(f"not a generalized request: {rh}")
        query_fnptr, free_fnptr, cancel_fnptr, extra = entry[2]
        status = np.zeros(4, np.int32)  # MPI_Status layout (4 ints)
        CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p)
        if query_fnptr:
            CB(query_fnptr)(extra, status.ctypes.data)
        if free_fnptr:
            ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)(free_fnptr)(extra)
        _requests[rh] = ("done", None, 0, 0,
                         (int(status[0]), int(status[1]), int(status[3])))
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


# -- name service (MPI_Open_port / Publish_name family) -----------------
# Port names resolve through the job KVS under tpurun (visible to every
# process of the job) and a process-local registry standalone — the
# reference's ompi-server plays this role; cross-JOB rendezvous needs
# that external server there too, so the parity boundary is identical.

_local_names: dict[str, str] = {}
_next_port = 1


def open_port():
    global _next_port
    _next_port += 1
    return (MPI_SUCCESS, f"tpumpi-port-{_rank}-{_next_port}")


def close_port(port: str) -> int:
    del port
    return MPI_SUCCESS


def _kvs_or_none():
    try:
        from ompi_tpu_torch.boot.proc import launched_by_tpurun

        if not launched_by_tpurun():
            return None
        from ompi_tpu_torch.api import comm_world

        return getattr(comm_world(), "procctx", None)
    except BaseException:  # noqa: BLE001
        return None


def publish_name(service: str, port: str) -> int:
    ctx = _kvs_or_none()
    if ctx is not None:
        try:
            ctx.kvs.put(f"svc:{service}", port)
            return MPI_SUCCESS
        except BaseException:  # noqa: BLE001
            pass  # standalone / KVS gone: process-local registry below
    _local_names[service] = port
    return MPI_SUCCESS


def unpublish_name(service: str) -> int:
    ctx = _kvs_or_none()
    if ctx is not None:
        try:  # tombstone: the KVS has no delete; "" reads as absent
            ctx.kvs.put(f"svc:{service}", "")
        except BaseException:  # noqa: BLE001
            pass
    _local_names.pop(service, None)
    return MPI_SUCCESS


def lookup_name(service: str):
    ctx = _kvs_or_none()
    if ctx is not None:
        try:
            # a tombstoned ("") value reads as absent (unpublished)
            port = ctx.kvs.get(f"svc:{service}", timeout=5.0)
            if port:
                return (MPI_SUCCESS, port)
        except BaseException:  # noqa: BLE001
            pass
    port = _local_names.get(service)
    if port is None:
        return (MPI_ERR_ARG, "")
    return (MPI_SUCCESS, port)


# -- window remainder ---------------------------------------------------


def win_allocate_shared(h: int, size_bytes: int, disp_unit: int):
    """One host process per rank on one host: a shared window is an
    allocated one whose rank memory ``win_shared_query`` returns."""
    try:
        return _win_alloc(h, size_bytes, disp_unit)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0, 0)


def win_create_dynamic(h: int):
    try:
        global _next_win_h
        c = _comm(h)
        w = c.win_create_dynamic(np.uint8)
        w._disp_unit = 1
        _next_win_h += 1
        _wins[_next_win_h] = w
        return (MPI_SUCCESS, _next_win_h)
    except BaseException as e:  # noqa: BLE001
        return (_fail(e, h), 0)


def win_attach(wh: int, addr: int, size_bytes: int) -> int:
    try:
        w = _win(wh)
        # the C model runs one rank per process → the caller is always
        # its process's local rank 0 (single-controller ditto)
        raw = (ctypes.c_ubyte * max(size_bytes, 1)).from_address(addr)
        w.attach(0, addr, np.frombuffer(raw, np.uint8))
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def win_detach(wh: int, addr: int) -> int:
    try:
        w = _win(wh)
        w.detach(0, addr)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def win_shared_query(wh: int, rank: int):
    """(err, size, disp_unit, base address)."""
    try:
        w = _win(wh)
        mem = w.memory(rank)
        return (MPI_SUCCESS, int(mem.nbytes), int(getattr(w, "_disp_unit", 1)),
                _addr(mem))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0, 0, 0)


# -- MPI-IO split-phase / ordered / async shared ------------------------

_file_split: dict[int, tuple] = {}  # fh -> ("read"/"write", data/count)


def file_write_ordered(fh: int, ptr: int, count: int, dtcode: int):
    """Rank-ordered write at the shared pointer.  Multi-process jobs:
    the shared pointer is single-process-scoped (see file_open) — same
    boundary, reported not silently corrupted."""
    try:
        f, multi = _file(fh)[0], _file(fh)[1]
        if multi:
            raise err.MPIFileError(
                "shared-file-pointer ordered ops are single-process "
                "scoped in this build (see MPI_File_open notes)")
        data = _pack_from(ptr, count, dtcode)
        written = f.write_ordered([np.asarray(data)])[0]
        return (MPI_SUCCESS, int(written) * _unit_nbytes(dtcode))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_read_ordered(fh: int, ptr: int, count: int, dtcode: int):
    try:
        f, multi = _file(fh)[0], _file(fh)[1]
        if multi:
            raise err.MPIFileError(
                "shared-file-pointer ordered ops are single-process "
                "scoped in this build (see MPI_File_open notes)")
        dt = DTYPES.get(dtcode)
        if dt is None:
            raise err.MPITypeError(f"unsupported datatype {dtcode}")
        units = _etype_units(f, count * dt.itemsize)
        out = f.read_ordered([units], dtype=dt)[0]
        got = int(np.asarray(out).size)
        if got:
            _view(ptr, got, dtcode)[:] = np.asarray(out).reshape(-1)
        return (MPI_SUCCESS, got * _unit_nbytes(dtcode))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_split_begin(fh: int, kind: str, offset: int, ptr: int, count: int,
                     dtcode: int) -> int:
    """Split-phase *_begin: the operation runs now; _end returns its
    status (MPI allows completion any time inside the begin/end pair)."""
    try:
        if fh in _file_split:
            raise err.MPIFileError("split collective already active")
        if kind == "write_at":
            rc, got = file_write_at_all(fh, offset, ptr, count, dtcode)
        elif kind == "read_at":
            rc, got = file_read_at_all(fh, offset, ptr, count, dtcode)
        elif kind == "write":
            rc, got = file_write_all(fh, ptr, count, dtcode)
        elif kind == "read":
            rc, got = file_read_all(fh, ptr, count, dtcode)
        elif kind == "write_ordered":
            rc, got = file_write_ordered(fh, ptr, count, dtcode)
        elif kind == "read_ordered":
            rc, got = file_read_ordered(fh, ptr, count, dtcode)
        else:
            raise err.MPIArgError(f"bad split kind {kind}")
        if rc != MPI_SUCCESS:
            return rc
        _file_split[fh] = (kind, got)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def file_split_end(fh: int):
    """(err, element count) for the active split collective."""
    try:
        ent = _file_split.pop(fh, None)
        if ent is None:
            raise err.MPIFileError("no split collective active")
        return (MPI_SUCCESS, int(ent[1]))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_iwrite_shared(fh, ptr, count, dtcode):
    try:
        rc, got = file_write_shared(fh, ptr, count, dtcode)
        if rc != MPI_SUCCESS:
            return (rc, 0)
        return (MPI_SUCCESS, _store_req(("done", None, 0, 0, (0, 0, got))))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_iread_shared(fh, ptr, count, dtcode):
    try:
        rc, got = file_read_shared(fh, ptr, count, dtcode)
        if rc != MPI_SUCCESS:
            return (rc, 0)
        return (MPI_SUCCESS, _store_req(("done", None, 0, 0, (0, 0, got))))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_iwrite_at_all(fh, offset, ptr, count, dtcode):
    try:
        rc, got = file_write_at_all(fh, offset, ptr, count, dtcode)
        if rc != MPI_SUCCESS:
            return (rc, 0)
        return (MPI_SUCCESS, _store_req(("done", None, 0, 0, (0, 0, got))))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_iread_at_all(fh, offset, ptr, count, dtcode):
    try:
        rc, got = file_read_at_all(fh, offset, ptr, count, dtcode)
        if rc != MPI_SUCCESS:
            return (rc, 0)
        return (MPI_SUCCESS, _store_req(("done", None, 0, 0, (0, 0, got))))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_iwrite_all(fh, ptr, count, dtcode):
    try:
        rc, got = file_write_all(fh, ptr, count, dtcode)
        if rc != MPI_SUCCESS:
            return (rc, 0)
        return (MPI_SUCCESS, _store_req(("done", None, 0, 0, (0, 0, got))))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


def file_iread_all(fh, ptr, count, dtcode):
    try:
        rc, got = file_read_all(fh, ptr, count, dtcode)
        if rc != MPI_SUCCESS:
            return (rc, 0)
        return (MPI_SUCCESS, _store_req(("done", None, 0, 0, (0, 0, got))))
    except BaseException as e:  # noqa: BLE001
        return (_fail(e), 0)


_datareps: set[str] = {"native", "internal", "external32"}


def register_datarep(name: str) -> int:
    """MPI_Register_datarep: user representations register by name;
    conversion functions are not invoked (the io engine reads/writes
    native byte order — external32 conversion lives in Pack_external)."""
    _datareps.add(name)
    return MPI_SUCCESS


# -- MPI_T breadth -------------------------------------------------------


def t_cvar_get_info(index: int):
    """(err, name, verbosity, scope) via the str helper pattern:
    returns (err, packed 'name|verbosity|scope') for the shim."""
    try:
        from ompi_tpu_torch.tool import mpit

        info = mpit.cvar_get_info(index)
        return (MPI_SUCCESS, f"{info.name}|{info.verbosity}|{info.scope}")
    except BaseException as e:  # noqa: BLE001
        return (_t_fail(e), "")


def t_cvar_handle_alloc(index: int):
    """cvar handles alias the index (no per-object binding needed)."""
    try:
        from ompi_tpu_torch.tool import mpit

        mpit.cvar_get_info(index)  # validates
        return (MPI_SUCCESS, index + 1)  # 0 = invalid handle
    except BaseException as e:  # noqa: BLE001
        return (_t_fail(e), 0)


def t_cvar_handle_read(handle: int):
    return t_cvar_read(handle - 1)


def t_cvar_handle_write(handle: int, value: int) -> int:
    try:
        from ompi_tpu_torch.tool import mpit

        mpit.cvar_write(handle - 1, value)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _t_fail(e)


def t_pvar_get_info(index: int):
    try:
        from ompi_tpu_torch.tool import mpit

        info = mpit.pvar_get_info(index)
        return (MPI_SUCCESS, f"{info.name}|{info.var_class}")
    except BaseException as e:  # noqa: BLE001
        return (_t_fail(e), "")


def t_pvar_write(index: int, value: int) -> int:
    """pvars here are monotonic counters — only reset-to-zero writes
    are meaningful; MPI_T allows rejecting others."""
    try:
        if value != 0:
            return MPI_ERR_ARG
        return t_pvar_reset(index)
    except BaseException as e:  # noqa: BLE001
        return _t_fail(e)


def t_pvar_reset(index: int) -> int:
    try:
        from ompi_tpu_torch.tool import mpit

        mpit.pvar_reset_one(index)
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _t_fail(e)


def t_pvar_readreset(index: int):
    try:
        rc = t_pvar_read(index)
        if not isinstance(rc, tuple) or rc[0] != MPI_SUCCESS:
            return rc if isinstance(rc, tuple) else (rc, 0)
        reset_rc = t_pvar_reset(index)
        if reset_rc != MPI_SUCCESS:
            # a non-resettable pvar (trace_events watermark) must not
            # report success while silently keeping its value — the
            # caller's per-interval deltas would double-count forever
            return (reset_rc, rc[1])
        return rc
    except BaseException as e:  # noqa: BLE001
        return (_t_fail(e), 0)


def t_category_get_num():
    try:
        from ompi_tpu_torch.tool import mpit

        return (MPI_SUCCESS, mpit.category_get_num())
    except BaseException as e:  # noqa: BLE001
        return (_t_fail(e), 0)


def t_category_get_info(index: int):
    """(err, 'name|num_cvars')."""
    try:
        from ompi_tpu_torch.tool import mpit

        name, ncvars = mpit.category_get_info(index)
        return (MPI_SUCCESS, f"{name}|{ncvars}")
    except BaseException as e:  # noqa: BLE001
        return (_t_fail(e), "")


def t_category_get_index(name: str):
    try:
        from ompi_tpu_torch.tool import mpit

        cats = [c[0] for c in mpit._categories()]
        return (MPI_SUCCESS, cats.index(name))
    except ValueError:
        return (MPI_ERR_ARG, 0)
    except BaseException as e:  # noqa: BLE001
        return (_t_fail(e), 0)


def t_category_get_cvars(index: int, maxn: int, out_ptr: int) -> int:
    try:
        from ompi_tpu_torch.tool import mpit

        name, _ = mpit.category_get_info(index)
        idxs = [i for i, v in enumerate(mpit._cvar_names())
                if v.split("_", 1)[0] == name][:maxn]
        if idxs:
            _view(out_ptr, len(idxs), 7)[:] = idxs
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _t_fail(e)


def t_category_get_pvars(index: int, maxn: int, out_ptr: int) -> int:
    try:
        from ompi_tpu_torch.tool import mpit

        del index  # pvars are uncategorized: every category reports none
        del maxn, out_ptr
        return MPI_SUCCESS
    except BaseException as e:  # noqa: BLE001
        return _t_fail(e)


def t_category_changed():
    """Category layout is fixed after init: a constant stamp."""
    return (MPI_SUCCESS, 1)

"""One-sided windows of the PyTorch port against the JAX package.

A seeded random RMA program — put, get, accumulate with SUM/PROD/MAX/
REPLACE, get_accumulate, fetch_and_op and compare_and_swap, under
fence, PSCW, lock and lock_all epochs, with misuses mixed in — runs on
both 8-rank worlds.  Window memory and every request's value must be
bit-equal at the end, and each misuse must raise the same error class
at the same call.  The flavors (create aliasing the caller's arrays,
allocate_shared with ``shared_query``, dynamic attach/detach) and
``device_view`` are held alike.  Mirrors ``tests/test_osc.py``.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import ompi_tpu.api as japi
import ompi_tpu.osc as josc
import ompi_tpu_torch.api as tapi
import ompi_tpu_torch.osc as tosc
from ompi_tpu import op as jop
from ompi_tpu_torch import op as top
from ompi_tpu_torch.ddt.datatype import to_numpy

N = 8
S = 12  # elements per rank
OPS = ["MPI_SUM", "MPI_PROD", "MPI_MAX", "MPI_MIN", "MPI_REPLACE"]


@pytest.fixture(scope="module")
def worlds(devices):
    tapi.finalize()
    tw = tapi.init(device="cpu", nranks=N)
    yield japi.init(), tw
    tapi.finalize()


def _values(rng, dtype, n):
    d = np.dtype(dtype)
    if d.kind in "iu":
        return rng.randint(1, 9, n).astype(d)
    v = rng.uniform(0.5, 2.0, n) * np.where(rng.rand(n) < 0.5, -1.0, 1.0)
    return v.astype(d)


def _rma_op(rng, dtype, origin, target):
    kind = ["put", "get", "acc", "get_acc", "fop", "cas", "acc", "get_acc"][rng.randint(8)]
    count = int(rng.randint(1, 5))
    disp = int(rng.randint(0, S - count + 1))
    if rng.rand() < 0.04:
        disp = S - count + 2  # out of range: MPIRMARangeError in both
    data = _values(rng, dtype, count)
    opname = OPS[rng.randint(len(OPS))]
    if kind == "put":
        return ("put", origin, target, data, disp)
    if kind == "get":
        return ("get", origin, target, count, disp)
    if kind == "acc":
        return ("accumulate", origin, target, data, disp, opname)
    if kind == "get_acc":
        return ("get_accumulate", origin, target, data, disp,
                "MPI_NO_OP" if rng.rand() < 0.2 else opname)
    if kind == "fop":
        return ("fetch_and_op", origin, target, data[0], disp, opname)
    cmp_ = data[0] if rng.rand() < 0.5 else None  # None: compare the current value
    return ("compare_and_swap", origin, target, data[-1], cmp_, disp)


def program(seed, dtype):
    """Steps of a random RMA program over the four epoch kinds."""
    rng = np.random.RandomState(seed)
    steps = [("fence",)]
    for _ in range(14):
        steps.append(_rma_op(rng, dtype, int(rng.randint(N)), int(rng.randint(N))))
    steps.append(("fence",))
    steps.append(("fence", josc.MODE_NOSUCCEED))
    # PSCW: origins 0..2 access targets {3, 4}; a misuse before post
    steps.append(("start", 0, [3, 4]))
    steps.append(_rma_op(rng, dtype, 0, 3))  # before post: MPIRMASyncError
    steps += [("post", 3, [0, 1, 2]), ("post", 4, [0, 1, 2])]
    steps += [("start", 1, [3]), ("start", 2, [4], josc.MODE_NOCHECK)]
    for _ in range(10):
        origin = int(rng.randint(3))
        target = int(rng.choice([3, 4])) if origin == 0 else 2 + origin
        steps.append(_rma_op(rng, dtype, origin, target))
    steps.append(("wait", 3))  # origins still open: MPIRMASyncError
    steps += [("complete", 0), ("complete", 1), ("test", 4), ("complete", 2),
              ("wait", 3), ("test", 4)]
    # passive target
    steps += [("lock", 5, 6, josc.LOCK_EXCLUSIVE), ("lock", 7, 6, josc.LOCK_SHARED),
              ("lock", 7, 1, josc.LOCK_SHARED), ("lock", 0, 1, josc.LOCK_SHARED)]
    for _ in range(10):
        origin, target = [(5, 6), (7, 1), (0, 1), (5, 2)][rng.randint(4)]
        steps.append(_rma_op(rng, dtype, origin, target))
        if rng.rand() < 0.3:
            steps.append(("flush", origin, target))
    steps += [("unlock", 5, 6), ("unlock", 7, 1), ("unlock", 0, 1)]
    steps += [("lock_all", 2), ("lock", 3, 0, josc.LOCK_EXCLUSIVE)]
    for _ in range(12):
        steps.append(_rma_op(rng, dtype, 2, int(rng.randint(N))))
        if rng.rand() < 0.2:
            steps.append(("flush_all", 2))
    steps += [("fence",), ("unlock_all", 2), ("flush", 2, 0)]
    return steps


def run(world, osc_mod, op_mod, steps, dtype):
    """Execute the program; (memory bytes per rank, request values and
    errors in step order)."""
    win = world.win_allocate(S, dtype)
    log, reqs = [], []
    for step in steps:
        name, args = step[0], list(step[1:])
        if name in ("accumulate", "get_accumulate", "fetch_and_op"):
            args[-1] = op_mod.PREDEFINED_OPS[args[-1]]
        if name == "compare_and_swap" and args[3] is None:
            args[3] = args[2]  # compare with the value itself: a swap or a miss
        try:
            out = getattr(win, name)(*args)
        except Exception as e:  # noqa: BLE001 — the class is the result
            log.append((len(log), name, type(e).__name__))
            continue
        if out is not None and not isinstance(out, bool):
            reqs.append(out)
        else:
            log.append((len(log), name, out))
    values = []
    for r in reqs:
        try:
            v = r.wait()
        except Exception as e:  # noqa: BLE001
            values.append(type(e).__name__)
            continue
        if isinstance(v, torch.Tensor):
            v = to_numpy(v)
        values.append(None if v is None else np.asarray(v).tobytes())
    mem = []
    for r in range(N):
        m = win.memory(r)
        mem.append((to_numpy(m) if isinstance(m, torch.Tensor) else np.asarray(m)).tobytes())
    return mem, values, log


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64,
                                   ml_dtypes.bfloat16, np.uint32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_rma_program_matches_reference(worlds, seed, dtype):
    jw, tw = worlds
    steps = program(seed, dtype)
    want = run(jw, josc, jop, steps, dtype)
    got = run(tw, tosc, top, steps, dtype)
    assert got[2] == want[2]  # the same calls raised the same classes
    assert got[1] == want[1]
    assert got[0] == want[0]
    errors = {e[2] for e in want[2] if isinstance(e[2], str)}
    assert {"MPIRMASyncError", "MPIRMAConflictError"} <= errors


def test_create_aliases_caller_arrays(worlds):
    outs = []
    for w in worlds:
        bases = [np.arange(4, dtype=np.float32) + 10 * r for r in range(N)]
        win = w.win_create(bases)
        assert win.memory(3) is bases[3] or np.shares_memory(win.memory(3), bases[3])
        bases[2][0] = -1.0  # the window sees the caller's store
        win.fence()
        g = win.get(0, 2, 2)
        win.accumulate(1, 5, np.ones(4, np.float32))
        win.fence()
        outs.append((np.asarray(to_numpy(g.wait()) if isinstance(g.wait(), torch.Tensor)
                                else g.wait()).tobytes(), bases[5].tobytes()))
    assert outs[0] == outs[1]
    t = [torch.zeros(3) for _ in range(N)]
    tw = worlds[1]
    win = tw.win_create(t)
    win.fence()
    win.put(0, 4, [1.0, 2.0, 3.0])
    win.fence()
    assert t[4].tolist() == [1.0, 2.0, 3.0] and win.memory(4) is t[4]


def test_allocate_shared_and_device_view(worlds):
    jw, tw = worlds
    jwin = jw.win_allocate_shared(5, np.int32)
    twin = tw.win_allocate_shared(5, np.int32)
    for win in (jwin, twin):
        size, view = win.shared_query(6)
        view[:] = 7  # a direct store into rank 6's region
        win.fence()
        win.put(1, 2, np.arange(5, dtype=np.int32))
        win.fence()
    dv = twin.device_view()
    assert dv is twin._block and dv.shape == (N, 5)  # no staging: the block itself
    assert to_numpy(dv).tobytes() == np.asarray(jwin.device_view()).tobytes()
    # allocate: rank-major on the comm's device, returned as it is
    a = tw.win_allocate(6, np.float32)
    assert a.device_view().device == tw.device and a.device_view().data_ptr() == \
        a.memory(0).data_ptr()
    for win in (jwin, twin):
        with pytest.raises(Exception) as err:
            win.attach(0, 0, np.zeros(2, np.int32))
        assert type(err.value).__name__ == "MPIWinError"


def test_dynamic_attach_detach_matches_reference(worlds):
    outs = []
    for w in worlds:
        win = w.win_create_dynamic(np.float64)
        a = np.zeros(6)
        win.attach(3, 100, a)
        names = []
        for bad in (lambda: win.attach(3, 103, np.zeros(4)),
                    lambda: win.attach(3, 200, np.zeros(4, np.float32)),
                    lambda: win.detach(3, 999)):
            with pytest.raises(Exception) as err:
                bad()
            names.append(type(err.value).__name__)
        win.lock(0, 3)
        win.put(0, 3, [1.5, 2.5], target_disp=102)
        r = win.get_accumulate(0, 3, [1.0], target_disp=103)
        with pytest.raises(Exception) as err:
            win.put(0, 3, [1.0], target_disp=110)
        names.append(type(err.value).__name__)
        win.unlock(0, 3)
        v = r.wait()
        win.detach(3, 100)
        outs.append((a.tobytes(), np.asarray(to_numpy(v) if isinstance(v, torch.Tensor)
                                             else v).tobytes(), names))
    assert outs[0] == outs[1]


def test_rput_raccumulate_and_free(worlds):
    outs = []
    for w, op in ((worlds[0], jop), (worlds[1], top)):
        win = w.win_allocate(4, np.float32)
        win.lock_all(0)
        r1 = win.rput(0, 1, np.full(4, 2.0, np.float32))
        r2 = win.raccumulate(0, 1, np.full(4, 3.0, np.float32), op=op.PROD)
        names = []
        with pytest.raises(Exception) as err:
            r1.wait()  # before the flush
        names.append(type(err.value).__name__)
        with pytest.raises(Exception) as err:
            win.free()  # pending operations
        names.append(type(err.value).__name__)
        win.flush(0, 1)
        outs.append((r1.wait(), r2.wait(), names, np.asarray(
            to_numpy(win.memory(1)) if isinstance(win.memory(1), torch.Tensor)
            else win.memory(1)).tolist()))
        win.unlock_all(0)
        win.free()
        with pytest.raises(Exception) as err:
            win.fence()
        outs[-1] += (type(err.value).__name__,)
    assert outs[0] == outs[1]


def test_max_pending_var_and_component(worlds):
    from ompi_tpu_torch.core import mca

    _, tw = worlds
    store = mca.default_context().store
    assert mca.default_context().framework("osc").select_one().NAME == "arena"
    prev = store.get("osc_arena_max_pending")
    store.set("osc_arena_max_pending", 2)
    try:
        win = tw.win_allocate(4)
        win.fence()
        win.put(0, 1, [1.0])
        win.put(0, 1, [1.0])
        with pytest.raises(Exception) as err:
            win.put(0, 1, [1.0])
        assert type(err.value).__name__ == "MPIRMASyncError"
        win.fence()
    finally:
        store.set("osc_arena_max_pending", prev)

"""The port's OpenSHMEM Python API against ``ompi_tpu.shmem``.

Mirrors ``tests/test_shmem.py``'s Python tests on the port (the
single-controller families, phase 2, and the np=3 worker under the
port's launcher on the CPU), then runs the same numpy inputs, made from
a seed, through both packages on their 8-rank CPU worlds (the
conftest's JAX devices; ``api.init(device="cpu", nranks=8)``):

* heap offsets of one ``malloc`` sequence, and the exhaustion error;
* put/get results, bit for bit, for every dtype;
* every atomic's old value and the final words, bit for bit, unsigned
  words included (a ``uint64`` ``SIGNAL_ADD`` past 2**63 and one that
  wraps);
* team membership, ``translate_pe`` and team collectives;
* ``sum_to_all`` and ``fcollect``: bit for bit on the ring paths
  (``ring`` and ``cuda_ring``/``pallas_ring`` forced on both sides),
  integers equal under the default decision, floats ``allclose``
  (rtol 1e-6) where XLA picks the reduction order (``psum``);
* ``pgas_stencil`` in both packages: bit for bit, and within rtol 1e-12
  of the undistributed ``jacobi_reference``.

The port returns tensors on the heap's device where the reference
returns numpy or JAX arrays; a test pins that difference.
"""

import contextlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ompi_tpu.api as japi
import ompi_tpu.shmem as jshmem
import ompi_tpu_torch.api as tapi
import ompi_tpu_torch.shmem as tshmem
from ompi_tpu.core import mca as jmca
from ompi_tpu_torch.core import mca as tmca
from ompi_tpu_torch.ddt.datatype import to_numpy

from torch_mp_common import REPO, run_job

N = 8
HEAP = 1 << 20


@pytest.fixture(scope="module")
def worlds(devices):
    tapi.finalize()
    tw = tapi.init(device="cpu", nranks=N)
    yield japi.init(), tw
    tapi.finalize()


@pytest.fixture
def heaps(worlds):
    """Both packages' symmetric heaps (HEAP bytes per PE)."""
    jshmem.init(heap_bytes=HEAP)
    tshmem.init(heap_bytes=HEAP)
    try:
        yield jshmem, tshmem
    finally:
        jshmem.finalize()
        tshmem.finalize()


@contextlib.contextmanager
def pinned(var, value):
    """``coll_xla_<var>`` and ``coll_cuda_<var>`` set to ``value``."""
    stores = {"xla": jmca.default_context().store, "cuda": tmca.default_context().store}
    prev = {k: s.get(f"coll_{k}_{var}") for k, s in stores.items()}
    for k, s in stores.items():
        s.set(f"coll_{k}_{var}", value)
    try:
        yield
    finally:
        for k, s in stores.items():
            s.set(f"coll_{k}_{var}", prev[k])


def host(x) -> np.ndarray:
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def same_bits(a, b) -> None:
    a, b = host(a), host(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), (a, b)


# -- mirrored from tests/test_shmem.py (the port alone) -----------------


def test_shmem_python_single_controller(worlds):
    tshmem.init(heap_bytes=HEAP)
    try:
        n = tshmem.n_pes()
        assert n >= 1 and tshmem.my_pe() == 0
        a = tshmem.malloc(8, np.int64)
        b = tshmem.malloc((2, 3), np.float64)
        # symmetric offsets: every PE's view lands at the same offset
        assert a.offset % 16 == 0 and b.offset >= a.offset + a.nbytes
        # local view is writable heap memory
        av = a.view(0)
        av[:] = torch.arange(8)
        assert np.array_equal(np.asarray(a), np.arange(8))
        # put/get to a PE (self or the last PE)
        pe = n - 1
        tshmem.put(b, np.full((2, 3), 7.5), pe)
        got = tshmem.get(b, pe)
        assert np.array_equal(host(got), np.full((2, 3), 7.5))
        # atomics on element 0
        c = tshmem.malloc(1, np.int64)
        c.view(pe)[:] = 0
        assert tshmem.atomic_fetch_add(c, 5, pe) == 0
        assert tshmem.atomic_fetch(c, pe) == 5
        old = tshmem.atomic_compare_swap(c, 5, 9, pe)
        assert old == 5 and tshmem.atomic_fetch(c, pe) == 9
        old = tshmem.atomic_compare_swap(c, 5, 1, pe)  # cond mismatch
        assert old == 9 and tshmem.atomic_fetch(c, pe) == 9
        # collectives
        s = tshmem.sum_to_all(np.ones((n, 2)))
        assert np.array_equal(host(s), np.full((n, 2), n))
        tshmem.barrier_all()
    finally:
        tshmem.finalize()


def test_shmem_python_phase2_single_controller(worlds):
    """Locks, wait/test, signaled puts, and teams with real
    sub-communicators."""
    tshmem.init(heap_bytes=HEAP)
    try:
        n = tshmem.n_pes()
        lk = tshmem.malloc(1, np.int64)
        lk.view()[:] = 0
        tshmem.set_lock(lk)
        assert tshmem.test_lock(lk) == 1  # held -> busy
        tshmem.clear_lock(lk)
        assert tshmem.test_lock(lk) == 0  # acquired
        tshmem.clear_lock(lk)
        iv = tshmem.malloc(1, np.int64)
        iv.view()[:] = 0
        assert not tshmem.test(iv, tshmem.CMP_NE, 0)
        tshmem.atomic_set(iv, 7, tshmem.my_pe())
        tshmem.wait_until(iv, tshmem.CMP_EQ, 7)
        assert tshmem.test(iv, tshmem.CMP_GE, 7)
        # signaled put: data visible before the signal fires
        dest = tshmem.malloc(4, np.float64)
        sig = tshmem.malloc(1, np.uint64)
        sig.view()[:] = 0
        pe = n - 1
        tshmem.put_signal(dest, np.arange(4, dtype=np.float64), sig, 1,
                          pe, tshmem.SIGNAL_ADD)
        got = tshmem.signal_wait_until(sig, tshmem.CMP_GE, 1) \
            if pe == tshmem.my_pe() else 1
        assert got >= 1
        assert np.array_equal(host(tshmem.get(dest, pe)), np.arange(4.0))
        tw = tshmem.team_world()
        assert tw.my_pe() == tshmem.my_pe() and tw.n_pes() == n
        ev = tshmem.team_split_strided(0, 2, (n + 1) // 2)
        assert ev is not None and ev.my_pe() == tshmem.my_pe() // 2
        assert ev.translate_pe(0, tw) == 0
        ev.sync()
        ev.destroy()
        tshmem.barrier_all()
    finally:
        tshmem.finalize()


def test_shmem_python_multiproc(tmp_path):
    """The port's twin of ``tests/workers/shmem_worker.py`` under ``run
    -np 3 --cpu --nranks 1``: one PE per process."""
    res = run_job("port", 3, 1, REPO / "ompi_tpu_torch" / "examples" / "shmem_worker.py",
                  timeout=240, flags=("--cpu",))
    assert res.returncode == 0, res.stdout + res.stderr
    ok = [line for line in res.stdout.splitlines() if "OK shmem_py " in line]
    assert sorted(ok) == [f"[{p}] OK shmem_py pe={p} device=cpu" for p in range(3)], ok


# -- parity with ompi_tpu.shmem ----------------------------------------


def test_public_names_match_reference():
    names = [k for k, v in vars(jshmem).items() if not k.startswith("_")
             and (getattr(v, "__module__", None) == "ompi_tpu.shmem" or type(v) is int)]
    assert len(names) > 30
    assert [k for k in names if not hasattr(tshmem, k)] == []
    for k in names:
        if type(getattr(jshmem, k)) is int:
            assert getattr(tshmem, k) == getattr(jshmem, k), k


def test_heap_offsets_match_reference(heaps):
    rng = np.random.default_rng(20261017)
    dtypes = [np.int8, np.int32, np.int64, np.uint64, np.float32, np.float64,
              np.complex128, np.uint16]
    for _ in range(40):
        dt = dtypes[rng.integers(len(dtypes))]
        shape = tuple(int(s) for s in rng.integers(1, 9, rng.integers(1, 3)))
        align = int([1, 8, 16, 64][rng.integers(4)])
        if align < np.dtype(dt).itemsize:
            align = 16
        ja, ta = (m.malloc(shape, dt, align=align) for m in heaps)
        assert (ta.offset, ta.shape, ta.nbytes) == (ja.offset, ja.shape, ja.nbytes)
        assert ta.offset % align == 0
        np.testing.assert_array_equal(np.asarray(ta), np.asarray(ja))  # zeroed heap
    errs = []
    for m in heaps:
        with pytest.raises(Exception) as e:
            m.malloc(HEAP, np.float64)
        errs.append(type(e.value).__name__)
    assert errs == ["MPIInternalError"] * 2


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64, np.int32,
                                   np.uint8, np.uint16, np.uint64, np.complex128])
def test_put_get_match_reference(heaps, dtype):
    rng = np.random.default_rng(7)
    bufs = [m.malloc((3, 5), dtype) for m in heaps]
    for _ in range(12):
        pe = int(rng.integers(N))
        raw = rng.integers(0, 256, 15 * np.dtype(dtype).itemsize, dtype=np.uint8)
        data = raw.view(dtype).reshape(3, 5)
        if np.dtype(dtype).kind in "fc":
            data = np.nan_to_num(data)
        for m, b in zip(heaps, bufs):
            m.put(b, data, pe)
    for pe in range(N):
        same_bits(heaps[1].get(bufs[1], pe), heaps[0].get(bufs[0], pe))
        count = 1 + pe
        same_bits(heaps[1].get(bufs[1], pe, count), heaps[0].get(bufs[0], pe, count))
    errs = []
    for m, b in zip(heaps, bufs):
        with pytest.raises(Exception) as e:
            m.put(b, np.zeros(16, dtype), 0)
        errs.append(type(e.value).__name__)
    assert errs == ["MPIArgError"] * 2


def _operand(rng, dtype):
    d = np.dtype(dtype)
    if d == np.uint64:  # bit 63 set half the time: the signed carrier's sign
        return int(rng.integers(0, 1000)) + (1 << 63 if rng.random() < 0.5 else 0)
    if d.kind in "iu":
        return int(rng.integers(0, 1000))
    return float(np.asarray(rng.uniform(-8, 8), d))


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint32, np.uint64,
                                   np.float32, np.float64])
def test_atomics_match_reference(heaps, dtype):
    """A seeded program of fetch_add, fetch, set and compare_swap (cond
    equal to the word half the time) on random PEs: every old value and
    every final word bit for bit."""
    rng = np.random.default_rng(11)
    words = [m.malloc(1, dtype) for m in heaps]
    olds = ([], [])
    for _ in range(60):
        kind = ["add", "fetch", "set", "cas", "add"][rng.integers(5)]
        pe = int(rng.integers(N))
        value = _operand(rng, dtype)
        cur = heaps[0].atomic_fetch(words[0], pe)
        cond = cur if rng.random() < 0.5 else _operand(rng, dtype)
        for i, (m, w) in enumerate(zip(heaps, words)):
            with np.errstate(over="ignore"):  # a uint64 sum may wrap
                if kind == "add":
                    r = m.atomic_fetch_add(w, value, pe)
                elif kind == "fetch":
                    r = m.atomic_fetch(w, pe)
                elif kind == "set":
                    r = m.atomic_set(w, value, pe)
                else:
                    r = m.atomic_compare_swap(w, cond, value, pe)
            olds[i].append(None if r is None else np.asarray(r, dtype).tobytes())
    assert olds[1] == olds[0]
    for pe in range(N):
        same_bits(heaps[1].get(words[1], pe), heaps[0].get(words[0], pe))


@pytest.mark.parametrize("start", [0, (1 << 63) + 1, (1 << 64) - 3])
def test_uint64_signal_add_matches_reference(heaps, start):
    """``put_signal`` with ``SIGNAL_ADD`` on a ``uint64`` word: from 0,
    from past 2**63 (the carrier's sign bit), and across 2**64 (the
    word wraps, as numpy's does)."""
    dest = [m.malloc(4, np.float64) for m in heaps]
    sig = [m.malloc(1, np.uint64) for m in heaps]
    for m, s in zip(heaps, sig):
        m.atomic_set(s, start, 3)
    for k in range(3):
        for m, d, s in zip(heaps, dest, sig):
            with np.errstate(over="ignore"):
                m.put_signal(d, np.arange(4.0) + k, s, (1 << 62) + k, 3, m.SIGNAL_ADD)
    got = [m.atomic_fetch(s, 3) for m, s in zip(heaps, sig)]
    assert got[1] == int(got[0]) == (start + 3 * (1 << 62) + 3) % (1 << 64)
    same_bits(heaps[1].get(dest[1], 3), heaps[0].get(dest[0], 3))
    same_bits(heaps[1].get(sig[1], 3), heaps[0].get(sig[0], 3))


TRIPLES = [(0, 1, 8), (0, 2, 4), (1, 2, 4), (1, 3, 3), (2, 1, 5), (7, 1, 1), (0, 7, 2)]


@pytest.mark.parametrize("triple", TRIPLES)
def test_teams_match_reference(heaps, triple):
    rng = np.random.default_rng(sum(triple))
    jtw, ttw = (m.team_world() for m in heaps)
    jt, tt = (m.team_split_strided(*triple) for m in heaps)
    assert (tt is None) == (jt is None)
    assert (tt.my_pe(), tt.n_pes()) == (jt.my_pe(), jt.n_pes())
    for i in range(-1, N + 1):
        assert tt.translate_pe(i, ttw) == jt.translate_pe(i, jtw)
        assert ttw.translate_pe(i, tt) == jtw.translate_pe(i, jt)
    size = triple[2]
    xi = rng.integers(-50, 50, (size, 3)).astype(np.int64)
    same_bits(tt.sum_reduce(xi), jt.sum_reduce(xi))
    same_bits(tt.max_reduce(xi), jt.max_reduce(xi))
    xf = rng.standard_normal((size, 3))
    same_bits(tt.broadcast(xf, size - 1), jt.broadcast(xf, size - 1))
    for t in (jt, tt):
        t.sync()
        t.destroy()


def test_bad_team_triple_raises_like_reference(heaps):
    for triple in [(0, 1, 9), (-1, 1, 2), (0, 0, 2), (4, 2, 3)]:
        errs = []
        for m in heaps:
            with pytest.raises(Exception) as e:
                m.team_split_strided(*triple)
            errs.append(type(e.value).__name__)
        assert errs == ["MPIArgError"] * 2, triple


@pytest.mark.parametrize("algo", [2, 7])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
def test_sum_to_all_bitwise_on_rings(heaps, algo, dtype):
    """``ring`` (2) and the kernel ring (``cuda_ring`` / ``pallas_ring``,
    7) forced on both sides: bit for bit."""
    rng = np.random.default_rng(algo)
    x = (rng.standard_normal((N, 1000)) * 100).astype(dtype)
    with pinned("allreduce_algorithm", algo):
        same_bits(heaps[1].sum_to_all(x), heaps[0].sum_to_all(x))


@pytest.mark.parametrize("algo", [2, 4])
def test_fcollect_bitwise_on_rings(heaps, algo):
    rng = np.random.default_rng(algo)
    x = rng.standard_normal((N, 333)).astype(np.float32)
    with pinned("allgather_algorithm", algo):
        same_bits(heaps[1].fcollect(x), heaps[0].fcollect(x))


def test_collectives_under_default_decision(heaps):
    """No algorithm pinned: integers equal, floats within rtol 1e-6
    (XLA's psum picks its own summation order), broadcast bit for bit."""
    rng = np.random.default_rng(3)
    xi = rng.integers(-1000, 1000, (N, 64)).astype(np.int32)
    xf = rng.standard_normal((N, 64))
    same_bits(heaps[1].sum_to_all(xi), heaps[0].sum_to_all(xi))
    same_bits(heaps[1].fcollect(xi), heaps[0].fcollect(xi))
    np.testing.assert_allclose(host(heaps[1].sum_to_all(xf)), host(heaps[0].sum_to_all(xf)),
                               rtol=1e-6)
    same_bits(heaps[1].broadcast(xf, 5), heaps[0].broadcast(xf, 5))


def test_results_are_tensors_on_the_heap_device(heaps):
    """The standing difference: the port hands back tensors on the
    heap's device (the reference: numpy or JAX arrays), and
    ``SymmArray.view`` aliases the heap bytes."""
    t = heaps[1]
    a = t.malloc((2, 4), np.float32)
    heap_dev = t._st().heap(0).device
    v = a.view(2)
    assert isinstance(v, torch.Tensor) and v.device == heap_dev and v.dtype == torch.float32
    v.fill_(3.5)  # a store through the view is a store to the heap
    got = t.get(a, 2)
    assert isinstance(got, torch.Tensor) and got.device == heap_dev
    assert torch.equal(got, torch.full((2, 4), 3.5))
    x = np.ones((N, 3))
    for out in (t.sum_to_all(x), t.fcollect(x), t.broadcast(x, 0)):
        assert isinstance(out, torch.Tensor) and out.device == heap_dev
    w = t.malloc(1, np.uint64)
    old = t.atomic_fetch_add(w, (1 << 63) + 1, 0)
    assert type(old) is int and old == 0 and t.atomic_fetch(w, 0) == (1 << 63) + 1


def test_odd_heap_size_keeps_every_pe_aligned(worlds):
    """A heap size that is not a multiple of 16 is rounded up to one, so
    every PE's row of the single-process heap starts aligned and an
    8-byte view is legal on each."""
    tshmem.init(heap_bytes=1000)
    try:
        a = tshmem.malloc(3, np.float64)
        for pe in range(N):
            a.view(pe).fill_(pe + 0.5)
        assert [float(tshmem.get(a, pe)[2]) for pe in range(N)] == [p + 0.5 for p in range(N)]
        assert tshmem._st().heap_bytes == 1008
    finally:
        tshmem.finalize()


def _ref_stencil():
    spec = importlib.util.spec_from_file_location("ref_pgas_stencil",
                                                  REPO / "examples" / "pgas_stencil.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("strip,iters,seed", [(16, 8, 4), (37, 20, 0)])
def test_pgas_stencil_matches_reference(worlds, strip, iters, seed):
    """Bit for bit against ``examples/pgas_stencil.py`` on the CPU, and
    within rtol 1e-12 of the undistributed smoothing."""
    from ompi_tpu_torch.examples import pgas_stencil as tps

    ref = _ref_stencil()
    try:
        jout = np.asarray(ref.jacobi_pgas(strip_len=strip, iters=iters, seed=seed))
    finally:
        jshmem.finalize()
    try:
        tout = tps.jacobi_pgas(strip_len=strip, iters=iters, seed=seed)
    finally:
        tshmem.finalize()
    assert isinstance(tout, torch.Tensor) and tout.device == worlds[1].device
    same_bits(tout, jout)
    want = tps.jacobi_reference(strip, N, iters, seed=seed)
    np.testing.assert_array_equal(want, ref.jacobi_reference(strip, N, iters, seed=seed))
    np.testing.assert_allclose(host(tout), want, rtol=1e-12)


def test_pgas_stencil_script_runs_on_the_cpu(tmp_path):
    res = subprocess.run([sys.executable, "-m", "ompi_tpu_torch.examples.pgas_stencil",
                          "--device", "cpu"], capture_output=True, text=True, timeout=240,
                         cwd=str(REPO))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "PGAS stencil OK" in res.stdout

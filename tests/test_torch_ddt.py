"""Datatypes and the convertor of the PyTorch port against the JAX package.

Every constructor is built the same way in both packages; the two must
agree on size, bounds, the iovec program and ``element_index_array``,
and the same seeded numpy buffer must pack to the same bytes — whole,
and in partial packs resumed with ``set_position``.  The port packs a
torch tensor on its own device (here the CPU) to the same bytes.  The
typed collectives ``allreduce_ddt``/``bcast_ddt`` are bit-equal through
both 8-rank worlds.  Mirrors ``tests/test_datatype.py``.
"""

import contextlib

import ml_dtypes
import numpy as np
import pytest
import torch

import ompi_tpu.api as japi
import ompi_tpu.ddt as jddt
import ompi_tpu_torch.api as tapi
import ompi_tpu_torch.ddt as tddt
from ompi_tpu import op as jop
from ompi_tpu.ddt import convertor as jconv
from ompi_tpu.ddt import datatype as jdt
from ompi_tpu_torch import op as top
from ompi_tpu_torch.ddt import convertor as tconv
from ompi_tpu_torch.ddt import datatype as tdt

N = 8


def _both(build):
    return build(jdt), build(tdt)


#: (id, builder over a datatype module, count)
CONSTRUCTORS = [
    ("contiguous", lambda m: m.INT.create_contiguous(5), 3),
    ("vector", lambda m: m.FLOAT.create_vector(4, 2, 5), 3),
    ("vector_of_double", lambda m: m.DOUBLE.create_vector(3, 1, 2), 4),
    ("hvector", lambda m: m.SHORT.create_hvector(3, 2, 11), 2),
    ("indexed", lambda m: m.FLOAT.create_indexed([2, 1, 3], [0, 5, 8]), 2),
    ("hindexed", lambda m: m.DOUBLE.create_hindexed([1, 2], [3, 20]), 3),
    ("indexed_block", lambda m: m.INT.create_indexed_block(2, [1, 6, 3]), 2),
    ("resized", lambda m: m.FLOAT.create_resized(0, 12), 4),
    ("contiguous_of_resized", lambda m: m.FLOAT.create_resized(0, 8).create_contiguous(3), 2),
    ("subarray_c", lambda m: m.FLOAT.create_subarray([4, 5], [2, 3], [1, 1], "C"), 2),
    ("subarray_f", lambda m: m.INT.create_subarray([4, 5, 3], [2, 2, 2], [1, 2, 0], "F"), 1),
    ("struct", lambda m: m.create_struct([1, 2, 1], [0, 8, 24],
                                         [m.DOUBLE, m.INT, m.SHORT]), 3),
    ("struct_of_vectors", lambda m: m.create_struct(
        [1, 1], [0, 40], [m.FLOAT.create_vector(2, 2, 3), m.DOUBLE]), 2),
    ("dup", lambda m: m.FLOAT.create_vector(2, 1, 3).dup("mine"), 3),
    ("bfloat16_vector", lambda m: m.BFLOAT16.create_vector(3, 2, 3), 2),
    ("pair_float_int", lambda m: m.FLOAT_INT, 5),
    ("pair_double_int", lambda m: m.DOUBLE_INT, 3),
]
IDS = [c[0] for c in CONSTRUCTORS]


def _buffer(jtype, count, seed):
    nbytes = jtype.lb + jtype.span(count) + 7
    return np.random.RandomState(seed).randint(0, 256, nbytes).astype(np.uint8)


@pytest.mark.parametrize("name,build,count", CONSTRUCTORS, ids=IDS)
def test_constructor_layout_matches_reference(name, build, count):
    j, t = _both(build)
    for attr in ("size", "lb", "extent", "ub", "true_lb", "true_extent", "is_contiguous"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.span(count) == j.span(count)
    assert [o for _, o in t.typemap] == [o for _, o in j.typemap]
    assert [d.itemsize for d, _ in t.typemap] == [d.itemsize for d, _ in j.typemap]
    assert t.iovec() == j.iovec()
    np.testing.assert_array_equal(t.element_index_array(count),
                                  j.element_index_array(count))
    assert t.commit() is t and t.committed and j.commit().committed
    assert t.index_bounds(count) == (int(j.element_index_array(count).min()),
                                     int(j.element_index_array(count).max()) + 1)


@pytest.mark.parametrize("name,build,count", CONSTRUCTORS, ids=IDS)
def test_pack_unpack_bytes_match_reference(name, build, count):
    j, t = _both(build)
    buf = _buffer(j, count, seed=len(name))
    want = jconv.Convertor(buf, j, count).pack()
    got_np = tconv.pack(buf, t, count)
    got_t = tconv.pack(torch.from_numpy(buf), t, count)
    assert isinstance(got_np, np.ndarray) and isinstance(got_t, torch.Tensor)
    assert got_np.tobytes() == want.tobytes() == got_t.numpy().tobytes()
    assert jddt.pack(buf, j, count).tobytes() == want.tobytes()
    # unpack into zeroed buffers of both kinds
    jdst = np.zeros_like(buf)
    jddt.unpack(jdst, j, count, want)
    tdst = np.zeros_like(buf)
    tconv.unpack(tdst, t, count, got_np)
    ttdst = torch.zeros(buf.size, dtype=torch.uint8)
    tconv.unpack(ttdst, t, count, got_t)
    assert tdst.tobytes() == jdst.tobytes() == ttdst.numpy().tobytes()


@pytest.mark.parametrize("budget", [1, 3, 7, 16])
@pytest.mark.parametrize("name,build,count", CONSTRUCTORS[:13], ids=IDS[:13])
def test_partial_pack_resumes_like_reference(name, build, count, budget):
    """Fixed byte budgets, then a restart from the middle with
    set_position: the streams are byte-identical, host and tensor."""
    j, t = _both(build)
    buf = _buffer(j, count, seed=budget)
    outs = []
    for conv, b in ((jconv.Convertor, buf), (tconv.Convertor, buf),
                    (tconv.Convertor, torch.from_numpy(buf))):
        c = conv(b, j if conv is jconv.Convertor else t, count)
        chunks = []
        while not c.done:
            chunks.append(bytes(np.asarray(c.pack(budget)).tobytes()))
        mid = c.packed_size // 2 + 1
        c.set_position(mid)
        chunks.append(bytes(np.asarray(c.pack()).tobytes()))
        outs.append(chunks)
    assert outs[1] == outs[0] == outs[2]
    # a partial unpack stream rebuilds the reference's buffer
    packed = b"".join(outs[0][:-1])
    jdst, tdst = np.zeros_like(buf), torch.zeros(buf.size, dtype=torch.uint8)
    jc, tc = jconv.Convertor(jdst, j, count), tconv.Convertor(tdst, t, count)
    for i in range(0, len(packed), budget):
        piece = np.frombuffer(packed[i:i + budget], np.uint8)
        assert tc.unpack(piece) == jc.unpack(piece)
    assert tc.done and jc.done
    assert tdst.numpy().tobytes() == jdst.tobytes()


def test_predefined_types_match_reference():
    assert set(tdt.PREDEFINED) == set(jdt.PREDEFINED)
    for name, j in jdt.PREDEFINED.items():
        t = tdt.PREDEFINED[name]
        assert (t.size, t.lb, t.extent, t.iovec()) == (j.size, j.lb, j.extent, j.iovec()), name
        assert (t.predefined, t.committed) == (j.predefined, j.committed), name
        if len(j.typemap) == 1:
            assert tdt.numpy_dtype(t.uniform_leaf) == j.uniform_leaf, name
            assert tdt.from_numpy_dtype(j.uniform_leaf).name == \
                jdt.from_numpy_dtype(j.uniform_leaf).name
    for name in ("BYTE", "FLOAT_INT", "INT32_T", "LONG_INT", "TWO_INT", "BFLOAT16"):
        assert getattr(tddt, name).name == getattr(jddt, name).name


def test_negative_lb_needs_origin_like_reference():
    j, t = _both(lambda m: m.FLOAT.create_hvector(3, 1, -8))
    buf = np.random.RandomState(3).randint(0, 256, 32).astype(np.uint8)
    for conv in (jconv.Convertor, tconv.Convertor):
        dt = j if conv is jconv.Convertor else t
        with pytest.raises(Exception) as err:
            conv(buf, dt, 1)
        assert type(err.value).__name__ == "MPIArgError"
    want = jconv.Convertor(buf, j, 1, origin=16).pack()
    assert tconv.Convertor(buf, t, 1, origin=16).pack().tobytes() == want.tobytes()
    assert tconv.Convertor(torch.from_numpy(buf), t, 1, origin=16).pack().numpy().tobytes() \
        == want.tobytes()


@pytest.mark.parametrize("case", ["too_small", "overflow", "short", "contig_size", "negative"])
def test_errors_raise_the_reference_classes(case):
    """Each misuse raises the same error class in both packages, and on
    a tensor buffer as on a host one."""
    j, t = _both(lambda m: m.FLOAT.create_vector(2, 1, 2))
    cj, ct = _both(lambda m: m.INT.create_contiguous(2))

    def run(conv, dt, cdt, make):
        if case == "too_small":
            conv.Convertor(make(4), dt, 3)
        elif case == "overflow":
            conv.Convertor(make(64), dt, 1).unpack(np.zeros(16, np.uint8))
        elif case == "short":
            conv.unpack(make(64), dt, 2, np.zeros(3, np.uint8))
        elif case == "contig_size":
            conv.pack(make(8), cdt, 2)
        else:
            conv.Convertor(make(8), dt, -1)

    def host(n):
        return np.zeros(n, np.uint8)

    def tensor(n):
        return torch.zeros(n, dtype=torch.uint8)

    names = []
    for conv, dt, cdt, make in ((jconv, j, cj, host), (tconv, t, ct, host),
                                (tconv, t, ct, tensor)):
        with pytest.raises(Exception) as err:
            run(conv, dt, cdt, make)
        names.append(type(err.value).__name__)
    assert names[0] == names[1] == names[2]


def test_packed_to_typed_and_back():
    j, t = _both(lambda m: m.FLOAT.create_vector(3, 2, 4))
    x = np.random.RandomState(1).randn(40).astype(np.float32)
    want = jddt.packed_to_typed(jddt.pack(x, j, 2), j, 2)
    got = tddt.packed_to_typed(tddt.pack(torch.from_numpy(x), t, 2), t, 2)
    assert got.dtype == torch.float32 and got.numpy().tobytes() == want.tobytes()
    assert tddt.typed_to_packed(got).numpy().tobytes() == jddt.typed_to_packed(want).tobytes()
    mixed = tdt.create_struct([1, 1], [0, 8], [tdt.DOUBLE, tdt.INT])
    with pytest.raises(Exception, match="mixed leaves"):
        tddt.packed_to_typed(np.zeros(12, np.uint8), mixed, 1)


def test_device_pack_stays_on_the_tensors_device():
    """A tensor is packed with torch ops on its own device: on the meta
    device nothing can reach the host, and the bytes stay a tensor."""
    t = tdt.FLOAT.create_vector(4, 2, 3)
    x = torch.empty(64, dtype=torch.float32, device="meta")
    packed = tconv.pack(x, t, 2)
    assert packed.device.type == "meta" and packed.numel() == 2 * t.size
    dst = torch.empty(64, dtype=torch.float32, device="meta")
    tconv.unpack(dst, t, 2, packed)
    assert t.element_index_tensor(2, "meta").device.type == "meta"


# -- typed collectives -------------------------------------------------------


@contextlib.contextmanager
def ring_pinned():
    """The ring allreduce (enum 2) pinned in both packages: bit for bit
    for every op (the default psum sums in each library's own order)."""
    from ompi_tpu.core import mca as jmca
    from ompi_tpu_torch.core import mca as tmca

    stores = {"xla": jmca.default_context().store, "cuda": tmca.default_context().store}
    prev = {k: s.get(f"coll_{k}_allreduce_algorithm") for k, s in stores.items()}
    for k, s in stores.items():
        s.set(f"coll_{k}_allreduce_algorithm", 2)
    try:
        yield
    finally:
        for k, s in stores.items():
            s.set(f"coll_{k}_allreduce_algorithm", prev[k])


@pytest.fixture(scope="module")
def worlds(devices):
    tapi.finalize()
    tw = tapi.init(device="cpu", nranks=N)
    yield japi.init(), tw
    tapi.finalize()


TYPED = [
    ("MPI_SUM", np.float32, lambda m: m.FLOAT.create_vector(6, 3, 5), 4),
    ("MPI_PROD", np.float64, lambda m: m.DOUBLE.create_indexed([2, 1], [0, 4]), 5),
    ("MPI_MAX", np.int32, lambda m: m.INT.create_subarray([6, 4], [3, 2], [2, 1]), 2),
    ("MPI_SUM", np.int64, lambda m: m.LONG.create_contiguous(7), 3),
    ("MPI_MIN", ml_dtypes.bfloat16, lambda m: m.BFLOAT16.create_hvector(5, 2, 10), 3),
]


@pytest.mark.parametrize("opname,dtype,build,count", TYPED,
                         ids=[f"{o}-{np.dtype(d).name}" for o, d, _, _ in TYPED])
def test_allreduce_ddt_bitwise(worlds, opname, dtype, build, count):
    jw, tw = worlds
    j, t = _both(build)
    nelem = (j.lb + j.span(count)) // np.dtype(dtype).itemsize + 2
    rng = np.random.RandomState(count)
    if np.dtype(dtype).kind in "iu":
        bufs = [rng.randint(-50, 50, nelem).astype(dtype) for _ in range(N)]
    else:
        bufs = [(rng.randn(nelem) * 3).astype(dtype) for _ in range(N)]
    with ring_pinned():
        _allreduce_ddt_cases(jw, tw, j, t, bufs, count, opname)


def _allreduce_ddt_cases(jw, tw, j, t, bufs, count, opname):
    want = jw.allreduce_ddt(bufs, count, j, jop.PREDEFINED_OPS[opname])
    got = tw.allreduce_ddt(bufs, count, t, top.PREDEFINED_OPS[opname])
    assert isinstance(got, np.ndarray)
    assert got.tobytes() == np.asarray(want).tobytes()
    tbufs = [tdt.from_numpy(b) for b in bufs]
    got_t = tw.allreduce_ddt(tbufs, count, t, top.PREDEFINED_OPS[opname])
    assert isinstance(got_t, torch.Tensor)
    assert tdt.to_numpy(got_t).tobytes() == np.asarray(want).tobytes()
    # unpacked into receive buffers: host and tensor
    jrecv = [np.zeros_like(b) for b in bufs]
    trecv = [np.zeros_like(b) for b in bufs]
    ttrecv = [torch.zeros_like(b) for b in tbufs]
    jw.allreduce_ddt(bufs, count, j, jop.PREDEFINED_OPS[opname], recvbufs=jrecv)
    tw.allreduce_ddt(bufs, count, t, top.PREDEFINED_OPS[opname], recvbufs=trecv)
    tw.allreduce_ddt(tbufs, count, t, top.PREDEFINED_OPS[opname], recvbufs=ttrecv)
    for a, b, c in zip(jrecv, trecv, ttrecv):
        assert a.tobytes() == b.tobytes() == tdt.to_numpy(c).tobytes()


@pytest.mark.parametrize("root", [0, 5])
def test_bcast_ddt_bitwise(worlds, root):
    jw, tw = worlds
    j, t = _both(lambda m: m.INT.create_vector(3, 2, 4))
    buf = np.random.RandomState(root).randint(0, 1000, 40).astype(np.int32)
    want = jw.bcast_ddt(buf, 2, j, root=root)
    got = tw.bcast_ddt(buf, 2, t, root=root)
    got_t = tw.bcast_ddt(torch.from_numpy(buf), 2, t, root=root)
    assert len(got) == len(got_t) == N
    for a, b, c in zip(want, got, got_t):
        assert a.tobytes() == b.tobytes() == c.numpy().tobytes()


def test_typed_collective_errors_match(worlds):
    jw, tw = worlds
    mixed_j = jdt.create_struct([1, 1], [0, 8], [jdt.DOUBLE, jdt.INT])
    mixed_t = tdt.create_struct([1, 1], [0, 8], [tdt.DOUBLE, tdt.INT])
    bufs = [np.zeros(16, np.uint8)] * N
    names = []
    for w, dt, op in ((jw, mixed_j, jop.SUM), (tw, mixed_t, top.SUM)):
        with pytest.raises(Exception) as err:
            w.allreduce_ddt(bufs, 1, dt, op)
        names.append(type(err.value).__name__)
    with pytest.raises(Exception) as err:
        tw.allreduce_ddt(bufs[:3], 1, tdt.FLOAT, top.SUM)
    assert names[0] == names[1] and type(err.value).__name__ == "MPIArgError"

"""Op layer of the PyTorch port against the JAX package's op layer.

Every predefined op × every dtype the op accepts: the same numpy inputs
go through the reference's ``ordered_reduce_jax``/``ordered_reduce_np``
and the port's ``ordered_reduce_torch``/``ordered_reduce_np``; the
results must agree bit for bit (an elementwise fold in the same order
rounds the same way in XLA, numpy and torch).  The golden vectors of
``tests/golden/reduce_local.json`` are checked as in
``tests/test_golden_parity.py``.
"""

import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ompi_tpu import op as jop
from ompi_tpu.ddt import datatype as jddt
from ompi_tpu.op.op import ordered_reduce_jax
from ompi_tpu_torch import op as top
from ompi_tpu_torch.core.errors import MPIOpError
from ompi_tpu_torch.ddt import datatype as tddt

N = 8
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reduce_local.json")

DTYPES = [np.bool_, np.int8, np.int16, np.int32, np.int64, np.uint8,
          np.uint16, np.uint32, np.uint64, np.float16, ml_dtypes.bfloat16,
          np.float32, np.float64, np.complex64, np.complex128]
ELEMENTWISE = ["MPI_SUM", "MPI_PROD", "MPI_MAX", "MPI_MIN", "MPI_LAND",
               "MPI_LOR", "MPI_LXOR", "MPI_BAND", "MPI_BOR", "MPI_BXOR",
               "MPI_REPLACE", "MPI_NO_OP"]


def rank_data(shape, dtype, seed=0):
    """Rank-major (N, *shape) data: floats spread over 1e-3…1e3 of both
    signs, integers over a range that makes PROD wrap."""
    rng = np.random.RandomState(seed)
    d = np.dtype(dtype)
    if d == np.bool_:
        return rng.rand(N, *shape) < 0.5
    if d.kind in "iu":
        info = np.iinfo(d)
        lo, hi = max(info.min, -1000), min(info.max, 1000)
        return rng.randint(lo, hi + 1, (N,) + shape).astype(d)
    mag = rng.randn(N, *shape) * 10.0 ** rng.randint(-3, 4, (N,) + shape)
    if d.kind == "c":
        mag = mag + 1j * rng.randn(N, *shape)
    return mag.astype(d)


def _to_np(t: torch.Tensor) -> np.ndarray:
    return tddt.to_numpy(t)


def _cases():
    for name in ELEMENTWISE:
        jo = jop.PREDEFINED_OPS[name]
        for dt in DTYPES:
            if jo.allowed_on(jddt.from_numpy_dtype(dt)):
                yield name, dt


CASES = list(_cases())


@pytest.mark.parametrize("name,dtype", CASES,
                         ids=[f"{n}-{np.dtype(d).name}" for n, d in CASES])
def test_ordered_fold_matches_reference(name, dtype):
    x = rank_data((37,), dtype, seed=len(name))
    jo, to = jop.PREDEFINED_OPS[name], top.PREDEFINED_OPS[name]
    want_jax = np.asarray(ordered_reduce_jax(jnp.asarray(x), jo))
    want_np = jop.ordered_reduce_np(x, jo)
    got_torch = _to_np(top.ordered_reduce_torch(tddt.from_numpy(x), to))
    got_np = top.ordered_reduce_np(x, to)
    assert got_torch.dtype == want_np.dtype
    assert got_np.tobytes() == want_np.tobytes()
    if name == "MPI_PROD" and np.dtype(dtype).kind == "c":
        # a complex product is four products and two sums, which XLA,
        # numpy and torch each contract differently (with or without
        # FMA): the three disagree in the last bits, so hold the port to
        # a few ulps of the dtype over the seven multiplications
        rtol = 8 * np.finfo(dtype).eps
        scale = np.abs(want_np).max()
        np.testing.assert_allclose(got_torch, want_jax, rtol=rtol, atol=rtol * scale)
        np.testing.assert_allclose(got_torch, want_np, rtol=rtol, atol=rtol * scale)
        return
    assert got_torch.tobytes() == want_jax.tobytes() == want_np.tobytes()


@pytest.mark.parametrize("name", ["MPI_SUM", "MPI_MAX", "MPI_MIN", "MPI_BXOR"])
@pytest.mark.parametrize("dtype", [np.uint16, np.uint32, np.uint64])
def test_unsigned_full_range(name, dtype):
    """Unsigned values with the top bit set: the signed carrier of SUM/
    BXOR and the flipped-sign compare of MAX/MIN must order and wrap
    like the unsigned type."""
    rng = np.random.RandomState(3)
    info = np.iinfo(dtype)
    x = rng.randint(0, 1 << 16, (N, 29)).astype(dtype) * np.array(
        info.max // (1 << 16), dtype)
    x[0, :4] = [0, 1, info.max, info.max - 1]
    want = np.asarray(ordered_reduce_jax(jnp.asarray(x), jop.PREDEFINED_OPS[name]))
    got = _to_np(top.ordered_reduce_torch(tddt.from_numpy(x),
                                          top.PREDEFINED_OPS[name]))
    assert got.tobytes() == want.tobytes()


#: the float dtypes' same-width unsigned views, for NaN payloads
_BITS = {np.dtype(np.float16): np.uint16, np.dtype(ml_dtypes.bfloat16): np.uint16,
         np.dtype(np.float32): np.uint32, np.dtype(np.float64): np.uint64}


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16,
                                   ml_dtypes.bfloat16])
@pytest.mark.parametrize("name", ["MPI_MAX", "MPI_MIN"])
def test_max_min_propagate_nan_and_order_signed_zero(name, dtype):
    """MAX/MIN bit for bit against XLA: a ±0 tie gives +0 for MAX and
    -0 for MIN, and a NaN operand wins with its own payload — the first
    when both are NaN, as numpy and the CUDA kernel choose.  XLA's CPU
    backend differs in two NaN cases, pinned here and named in ROADMAP
    Queue 3: with both operands NaN it returns the second for MAX, and
    for bfloat16 it drops the payload (a quiet NaN of the chosen sign)."""
    u = _BITS[np.dtype(dtype)]
    a = np.array([np.nan, 1.0, np.nan, 0.0, -0.0, -2.0, np.nan], dtype)
    b = np.array([1.0, np.nan, np.nan, -0.0, 0.0, -3.0, -np.nan], dtype)
    quiet = np.array(np.nan, dtype).view(u)
    a.view(u)[[0, 2, 6]] = [quiet | 1, quiet | 2, quiet | 3]  # distinct payloads
    b.view(u)[[1, 2]] = [quiet | 5, quiet | 6]
    x = np.stack([a, b])
    want = np.asarray(ordered_reduce_jax(jnp.asarray(x), jop.PREDEFINED_OPS[name])).view(u)
    got = _to_np(top.ordered_reduce_torch(tddt.from_numpy(x),
                                          top.PREDEFINED_OPS[name])).view(u)
    a_nan, b_nan = np.isnan(a.astype(np.float64)), np.isnan(b.astype(np.float64))
    nan = a_nan | b_nan
    assert got[~nan].tobytes() == want[~nan].tobytes()
    assert got[nan].tobytes() == np.where(a_nan, a.view(u), b.view(u))[nan].tobytes()
    if np.dtype(dtype) == np.dtype(ml_dtypes.bfloat16):
        assert ((want[nan] & 0x7FFF) == quiet).all()
        return
    assert want[nan & ~(a_nan & b_nan)].tobytes() == got[nan & ~(a_nan & b_nan)].tobytes()
    both = a_nan & b_nan
    assert want[both].tobytes() == (b if name == "MPI_MAX" else a).view(u)[both].tobytes()


@pytest.mark.parametrize("name", ["MPI_MAXLOC", "MPI_MINLOC"])
def test_loc_ops_match_reference(name):
    rng = np.random.RandomState(5)
    val = rng.randint(0, 4, (2, 23)).astype(np.float32)  # ties on purpose
    idx = rng.randint(0, 8, (2, 23)).astype(np.int32)
    jo, to = jop.PREDEFINED_OPS[name], top.PREDEFINED_OPS[name]
    wv, wi = jo.np_fn((val[0], idx[0]), (val[1], idx[1]))
    gv, gi = to.torch_fn((torch.from_numpy(val[0]), torch.from_numpy(idx[0])),
                         (torch.from_numpy(val[1]), torch.from_numpy(idx[1])))
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(gi.numpy(), wi)


def test_user_op_and_pairwise_tree_match_reference():
    fn = lambda a, b: a * 3 + b  # noqa: E731 — elementwise, non-commutative
    x = rank_data((19,), np.int64, seed=9)
    jo, to = jop.create_op(fn, commute=False), top.create_op(fn, commute=False)
    assert not to.commutative
    want = np.asarray(ordered_reduce_jax(jnp.asarray(x), jo))
    got = top.ordered_reduce_torch(torch.from_numpy(x), to).numpy()
    np.testing.assert_array_equal(got, want)
    xf = rank_data((19,), np.float32, seed=10)
    want = np.asarray(jop.op.pairwise_tree_reduce_jax(jnp.asarray(xf), jop.SUM))
    got = top.pairwise_tree_reduce_torch(torch.from_numpy(xf), top.SUM).numpy()
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", DTYPES + [np.float32])
def test_type_check_and_datatype_names_match_reference(dtype):
    jdt, tdt = jddt.from_numpy_dtype(dtype), tddt.from_numpy_dtype(dtype)
    assert tdt.name == jdt.name and tdt.size == jdt.size
    for name, jo in jop.PREDEFINED_OPS.items():
        if jo.is_loc:
            continue
        to = top.PREDEFINED_OPS[name]
        assert to.allowed_on(tdt) == jo.allowed_on(jdt), (name, dtype)
        if not jo.allowed_on(jdt):
            with pytest.raises(MPIOpError):
                to.check(tdt)
    for pair in ("MPI_FLOAT_INT", "MPI_DOUBLE_INT", "MPI_2INT"):
        assert tddt.PREDEFINED[pair].extent == jddt.PREDEFINED[pair].extent
        assert top.MAXLOC.allowed_on(tddt.PREDEFINED[pair])


def test_bfloat16_crosses_as_uint16_view():
    x = rank_data((11,), ml_dtypes.bfloat16, seed=2)
    t = tddt.from_numpy(x)
    assert t.dtype == torch.bfloat16
    back = tddt.to_numpy(t)
    assert back.dtype == x.dtype and back.tobytes() == x.tobytes()


def _golden():
    with open(GOLDEN) as f:
        data = json.load(f)
    dtypes = {"float32": np.float32, "float64": np.float64, "int32": np.int32}
    for name, c in sorted(data["cases"].items()):
        dt = np.dtype(dtypes[c["dtype"]])
        x = np.frombuffer(bytes.fromhex(c["input_hex"]), dt).reshape(
            c["n_ranks"], c["count"])
        ref = np.frombuffer(bytes.fromhex(c["result_hex"]), dt)
        yield name, c["op"], x, ref


GOLDEN_CASES = list(_golden())


@pytest.mark.parametrize("name,opname,x,ref", GOLDEN_CASES,
                         ids=[c[0] for c in GOLDEN_CASES])
def test_golden_reduce_local(name, opname, x, ref):
    op = top.PREDEFINED_OPS[opname]
    assert top.ordered_reduce_np(x, op).tobytes() == ref.tobytes()
    got = top.ordered_reduce_torch(torch.from_numpy(x.copy()), op).numpy()
    assert got.tobytes() == ref.tobytes()

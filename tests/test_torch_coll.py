"""Collective algorithms of the PyTorch port against the JAX package.

Every algorithm of ``ompi_tpu.coll.base`` runs per device under
``shard_map`` on the conftest's virtual CPU devices; its port in
``ompi_tpu_torch.coll.base`` runs once over the rank-major tensor.  The
same numpy inputs go through both:

* bit for bit for the ring, segmented ring, recursive doubling,
  Rabenseifner, ordered, scan and every data-movement algorithm — the
  port keeps the chunking, rotation and fold operand order;
* ``allclose`` (rtol 1e-6) for psum/direct, where XLA and torch each
  choose their own summation order.

The three rings of ``ompi_tpu.coll.pallas_kernels`` (in the reference's
``emulate`` and ``interpret`` modes) are held bit for bit against
``ompi_tpu_torch.coll.cuda_kernels`` in each of its rungs; on CPU
tensors the kernel wrappers run their plain torch twins.  Mirrors
``tests/test_device_plane.py``'s Pallas-ring tests.
"""

import inspect

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # jax < 0.5
    from jax.experimental.shard_map import shard_map

from ompi_tpu.coll import base as jb
from ompi_tpu.coll import pallas_kernels as pk
from ompi_tpu import op as jop
from ompi_tpu.mesh import AXIS
from ompi_tpu_torch.coll import base as tb
from ompi_tpu_torch.coll import cuda_kernels as ck
from ompi_tpu_torch.core.errors import MPIArgError
from ompi_tpu_torch.ddt.datatype import from_numpy, to_numpy
from ompi_tpu_torch import op as top

N = 8
_SHARD_KW = {}
for _k in ("check_rep", "check_vma"):
    if _k in inspect.signature(shard_map).parameters:
        _SHARD_KW[_k] = False  # pallas_call has no replication rule
        break


def _jax_op(name):
    return jop.PREDEFINED_OPS[name]


def _torch_op(name):
    return top.PREDEFINED_OPS[name]


# a non-commutative user op, elementwise on jnp arrays and tensors alike
def _affine(a, b):
    return a * 3 + b


J_AFFINE = jop.create_op(_affine, commute=False, name="affine")
T_AFFINE = top.create_op(_affine, commute=False, name="affine")


@pytest.fixture(scope="module")
def meshes(devices):
    return {n: Mesh(np.array(devices[:n]), (AXIS,)) for n in (3, 6, N)}


def spmd(mesh, fn, x):
    """Run the per-device ``fn`` over the rank-major numpy ``x``."""
    f = shard_map(lambda v: fn(v[0])[None], mesh=mesh, in_specs=P(AXIS),
                  out_specs=P(AXIS), **_SHARD_KW)
    return np.asarray(jax.jit(f)(x))


def port(fn, x):
    return to_numpy(fn(from_numpy(x)))


def rank_data(n, shape, dtype=np.float32, seed=0):
    rng = np.random.RandomState(seed)
    d = np.dtype(dtype)
    if d.kind in "iu":
        hi = min(np.iinfo(d).max, 1000)
        return rng.randint(0, hi, (n,) + shape).astype(d)
    return (rng.randn(n, *shape) * 10.0 ** rng.randint(-3, 4, (n,) + shape)).astype(d)


def same_bits(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def same_bits_but_nan(got, want, nan_only=None):
    """Bit for bit wherever the reference agrees: NaN payloads and ±0
    included.  ``nan_only`` marks the NaN results whose payload XLA
    chooses differently (``tests/test_torch_op.py`` pins the cases): a
    MAX of two NaNs, where XLA returns the second and the port the
    first, and any bfloat16 NaN, which XLA's CPU backend canonicalizes
    and torch's CPU bfloat16 arithmetic returns as the all-ones NaN;
    there only NaN-ness is compared."""
    if nan_only is None:
        same_bits(got, want)
        return
    np.testing.assert_array_equal(np.isnan(got[nan_only].astype(np.float64)),
                                  np.isnan(want[nan_only].astype(np.float64)))
    same_bits(got[~nan_only], want[~nan_only])


# -- allreduce ------------------------------------------------------------

ALLREDUCE = [
    # (algorithm, op name, dtype, comm size)
    ("ring", "MPI_SUM", np.float32, N),
    ("ring", "MPI_SUM", np.float64, 3),
    ("ring", "MPI_SUM", ml_dtypes.bfloat16, N),
    ("ring", "MPI_SUM", np.uint32, N),
    ("ring", "MPI_MAX", np.float32, N),
    ("ring", "MPI_PROD", np.int32, 6),
    ("ring_segmented", "MPI_SUM", np.float32, N),
    ("recursive_doubling", "MPI_SUM", np.float32, N),
    ("recursive_doubling", "MPI_SUM", np.float32, 6),
    ("recursive_doubling", "affine", np.int64, N),
    ("recursive_doubling", "affine", np.int64, 6),
    ("rabenseifner", "MPI_SUM", np.float32, N),
    ("rabenseifner", "affine", np.int64, N),
    ("ordered_linear", "MPI_SUM", np.float32, N),
    ("ordered_linear", "affine", np.int64, 3),
]


@pytest.mark.parametrize(
    "algo,opname,dtype,n", ALLREDUCE,
    ids=[f"{a}-{o}-{np.dtype(d).name}-n{n}" for a, o, d, n in ALLREDUCE])
def test_allreduce_bitwise(meshes, algo, opname, dtype, n):
    jo = J_AFFINE if opname == "affine" else _jax_op(opname)
    to = T_AFFINE if opname == "affine" else _torch_op(opname)
    x = rank_data(n, (41,), dtype, seed=n)
    if algo == "ring_segmented":
        want = spmd(meshes[n], lambda v: jb.allreduce_ring_segmented(v, jo, n, 16), x)
        got = port(lambda t: tb.allreduce_ring_segmented(t, to, 16), x)
    else:
        jf, tf = getattr(jb, f"allreduce_{algo}"), getattr(tb, f"allreduce_{algo}")
        want = spmd(meshes[n], lambda v: jf(v, jo, n), x)
        got = port(lambda t: tf(t, to), x)
    same_bits(got, want)


@pytest.mark.parametrize("opname,dtype", [("MPI_SUM", np.float32),
                                          ("MPI_SUM", np.int32),
                                          ("MPI_MAX", np.float32),
                                          ("MPI_MIN", np.uint32)])
def test_allreduce_psum_close(meshes, opname, dtype):
    x = rank_data(N, (41,), dtype, seed=4)
    want = spmd(meshes[N], lambda v: jb.allreduce_psum(v, _jax_op(opname), N), x)
    got = port(lambda t: tb.allreduce_psum(t, _torch_op(opname)), x)
    # summation order is each framework's own: rtol 1e-6, plus an atol of
    # 1e-6 of the largest term for the sums that cancel
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(x).max())


# -- data movement ----------------------------------------------------------

MOVES = [
    ("allgather_direct", lambda v, n: jb.allgather_direct(v, n), tb.allgather_direct),
    ("allgather_ring", lambda v, n: jb.allgather_ring(v, n), tb.allgather_ring),
    ("allgather_bruck", lambda v, n: jb.allgather_bruck(v, n), tb.allgather_bruck),
    ("bcast_direct", lambda v, n: jb.bcast_direct(v, n, 2), lambda t: tb.bcast_direct(t, 2)),
    ("bcast_binomial", lambda v, n: jb.bcast_binomial(v, n, 2),
     lambda t: tb.bcast_binomial(t, 2)),
    ("bcast_pipeline", lambda v, n: jb.bcast_pipeline(v, n, 2, 4),
     lambda t: tb.bcast_pipeline(t, 2, 4)),
]


@pytest.mark.parametrize("n", [6, N])
@pytest.mark.parametrize("name,jf,tf", MOVES, ids=[m[0] for m in MOVES])
def test_data_movement_bitwise(meshes, name, jf, tf, n):
    x = rank_data(n, (3, 5), np.float32, seed=1)
    same_bits(port(tf, x), spmd(meshes[n], lambda v: jf(v, n), x))


@pytest.mark.parametrize("dtype", [np.uint16, ml_dtypes.bfloat16])
def test_allgather_ring_carries_unsigned_and_bf16(meshes, dtype):
    x = rank_data(N, (7,), dtype, seed=2)
    same_bits(port(tb.allgather_ring, x),
              spmd(meshes[N], lambda v: jb.allgather_ring(v, N), x))


@pytest.mark.parametrize("algo", ["direct", "pairwise"])
def test_alltoall_bitwise(meshes, algo):
    x = rank_data(N, (N, 4), np.float32, seed=3)
    same_bits(port(getattr(tb, f"alltoall_{algo}"), x),
              spmd(meshes[N], lambda v: getattr(jb, f"alltoall_{algo}")(v, N), x))


# -- reduce, reduce_scatter, scan, barrier ---------------------------------


@pytest.mark.parametrize("opname", ["MPI_SUM", "affine"])
@pytest.mark.parametrize("algo", ["binomial", "ordered"])
def test_reduce_bitwise(meshes, algo, opname):
    jo = J_AFFINE if opname == "affine" else _jax_op(opname)
    to = T_AFFINE if opname == "affine" else _torch_op(opname)
    x = rank_data(N, (23,), np.int64 if opname == "affine" else np.float32, seed=5)
    jf, tf = getattr(jb, f"reduce_{algo}"), getattr(tb, f"reduce_{algo}")
    want = spmd(meshes[N], lambda v: jf(v, jo, N, 3), x)
    got = port(lambda t: tf(t, to, 3), x)
    same_bits(got[3], want[3])  # only root's recvbuf is defined
    if algo == "ordered":
        same_bits(got, want)


@pytest.mark.parametrize("algo,opname", [("ring", "MPI_SUM"), ("ring", "MPI_MAX"),
                                         ("ordered", "MPI_SUM"), ("ordered", "affine")])
def test_reduce_scatter_bitwise(meshes, algo, opname):
    jo = J_AFFINE if opname == "affine" else _jax_op(opname)
    to = T_AFFINE if opname == "affine" else _torch_op(opname)
    x = rank_data(N, (N, 17), np.int64 if opname == "affine" else np.float32, seed=6)
    jf, tf = getattr(jb, f"reduce_scatter_{algo}"), getattr(tb, f"reduce_scatter_{algo}")
    same_bits(port(lambda t: tf(t, to), x), spmd(meshes[N], lambda v: jf(v, jo, N), x))


def test_reduce_scatter_direct_close(meshes):
    x = rank_data(N, (N, 17), np.float32, seed=7)
    want = spmd(meshes[N], lambda v: jb.reduce_scatter_direct(v, jop.SUM, N), x)
    got = port(lambda t: tb.reduce_scatter_direct(t, top.SUM), x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(x).max())


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("opname", ["MPI_SUM", "affine"])
def test_scan_bitwise(meshes, opname, exclusive):
    jo = J_AFFINE if opname == "affine" else _jax_op(opname)
    to = T_AFFINE if opname == "affine" else _torch_op(opname)
    x = rank_data(N, (13,), np.int64 if opname == "affine" else np.float32, seed=8)
    want = spmd(meshes[N], lambda v: jb.scan_ordered(v, jo, N, exclusive), x)
    got = port(lambda t: tb.scan_ordered(t, to, exclusive), x)
    same_bits(got[1:] if exclusive else got, want[1:] if exclusive else want)


@pytest.mark.parametrize("n", [6, N])
@pytest.mark.parametrize("algo", ["allreduce", "dissemination"])
def test_barrier_tokens(meshes, algo, n):
    want = spmd(meshes[n], lambda v: getattr(jb, f"barrier_{algo}")(n) + 0 * v, np.zeros(n, np.int32))
    got = to_numpy(getattr(tb, f"barrier_{algo}")(n, torch.device("cpu")))
    np.testing.assert_array_equal(got, want)


# -- the kernel rings ---------------------------------------------------------

RINGS = [
    # (collective, op, dtype, comm size); BOR and int16 take the unfused
    # step (hop kernel, then the op's torch_fn)
    ("allreduce", "MPI_SUM", np.float32, N),
    ("allreduce", "MPI_SUM", np.float32, 3),
    ("allreduce", "MPI_MAX", np.float32, N),
    ("allreduce", "MPI_SUM", ml_dtypes.bfloat16, N),
    ("allreduce", "MPI_SUM", np.uint32, N),
    ("allreduce", "MPI_BOR", np.int32, N),
    ("allreduce", "MPI_SUM", np.int16, 6),
    ("allgather", None, np.float32, N),
    ("allgather", None, np.uint16, 3),
    ("reduce_scatter", "MPI_SUM", np.float32, N),
    ("reduce_scatter", "MPI_MIN", np.float64, 6),
    ("reduce_scatter", "MPI_PROD", np.uint64, N),
    ("reduce_scatter", "MPI_BXOR", np.int8, N),
]


@pytest.mark.parametrize("jax_mode", ["emulate", "interpret"])
@pytest.mark.parametrize(
    "coll,opname,dtype,n", RINGS,
    ids=[f"{c}-{o}-{np.dtype(d).name}-n{n}" for c, o, d, n in RINGS])
def test_kernel_rings_bitwise(meshes, coll, opname, dtype, n, jax_mode):
    """Reference ring in ``jax_mode`` == the port's ring in every rung
    (``emulate``, ``interpret`` and the kernel form, whose wrappers run
    their plain twins on CPU tensors) == the port's plain base ring."""
    mesh = meshes[n]
    if coll == "allreduce":
        x = rank_data(n, (41,), dtype, seed=n)
        jo, to = _jax_op(opname), _torch_op(opname)
        want = spmd(mesh, lambda v: pk.ring_allreduce(v, jo, n, _mode=jax_mode), x)
        outs = {m: port(lambda t: ck.ring_allreduce(t, to, _mode=m), x)
                for m in ("emulate", "interpret", "cuda")}
        outs["base"] = port(lambda t: tb.allreduce_ring(t, to), x)
    elif coll == "allgather":
        x = rank_data(n, (3, 5), dtype, seed=n)
        want = spmd(mesh, lambda v: pk.ring_allgather(v, n, _mode=jax_mode), x)
        outs = {m: port(lambda t: ck.ring_allgather(t, _mode=m), x)
                for m in ("emulate", "interpret", "cuda")}
        outs["base"] = port(tb.allgather_ring, x)
    else:
        x = rank_data(n, (n, 3, 7), dtype, seed=n)
        jo, to = _jax_op(opname), _torch_op(opname)
        want = spmd(mesh, lambda v: pk.ring_reduce_scatter(v, jo, n, _mode=jax_mode), x)
        outs = {m: port(lambda t: ck.ring_reduce_scatter(t, to, _mode=m), x)
                for m in ("emulate", "interpret", "cuda")}
        outs["base"] = port(lambda t: tb.reduce_scatter_ring(t, to), x)
    for got in outs.values():
        same_bits(got, want)


def test_kernel_ring_integer_sum_is_exact(meshes):
    xi = np.arange(N * 40, dtype=np.int64).reshape(N, 40)
    got = port(lambda t: ck.ring_allreduce(t, top.SUM, _mode="cuda"), xi)
    np.testing.assert_array_equal(got, np.broadcast_to(xi.sum(0), xi.shape))


def test_kernel_mode_rungs():
    """``mode`` picks the kernel form for CUDA tensors, the emulation for
    CPU ones, and the plain kernel bodies when forced to interpret."""
    from ompi_tpu_torch.core import mca

    store = mca.default_context().store
    assert ck.mode("cpu") == "emulate" and ck.mode("cuda") == "cuda"
    store.set("dcn_device_interpret", True)
    try:
        assert ck.mode("cpu") == ck.mode("cuda") == "interpret"
    finally:
        store.set("dcn_device_interpret", False)


# -- the kernels' plain twins -------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8,
                                   torch.int64, torch.complex64])
def test_ring_hop_twin_and_wrapper(dtype):
    """``dst[(r+1)%n, dst_idx[(r+1)%n]] = src[r, src_idx[r]]`` for every
    r, any dtype (a byte copy), without touching other chunks."""
    n, rows, m = 5, 3, 7
    rng = np.random.RandomState(0)
    raw = rng.randint(0, 256, (n, rows, m * dtype.itemsize)).astype(np.uint8)
    src = torch.from_numpy(raw).view(dtype)
    si = torch.from_numpy(rng.randint(0, rows, n).astype(np.int32))
    di = torch.from_numpy(rng.randint(0, rows, n).astype(np.int32))
    want = np.zeros_like(raw)
    for r in range(n):
        want[(r + 1) % n, di[(r + 1) % n]] = raw[r, si[r]]
    before = dict(ck.LAUNCHES)
    for hop in (ck.ring_hop_plain, ck.ring_hop):
        dst = torch.zeros_like(src)
        hop(src, si, dst, di)
        np.testing.assert_array_equal(dst.view(torch.uint8).numpy(), want)
    assert ck.LAUNCHES == before  # CPU tensors launch no kernel


@pytest.mark.parametrize("recv_first", [False, True])
@pytest.mark.parametrize("opname", ["MPI_SUM", "MPI_PROD", "MPI_MAX", "MPI_MIN"])
@pytest.mark.parametrize("dtype", [np.float32, np.float16, ml_dtypes.bfloat16,
                                   np.uint32, np.int64])
def test_ring_hop_fold_twin_matches_jax_fold(opname, dtype, recv_first):
    """The fold twin (what the CUDA kernel is held to on the card)
    computes ``op(a[r], b[r-1])`` with the reference op's semantics,
    NaN and ±0 included.  XLA's CPU backend flushes denormals to zero;
    torch and the CUDA kernel (built without fast math) keep them as
    IEEE 754 says, so a fold that meets a denormal is held to the exact
    float64 result rounded once to the dtype instead."""
    n, rows, m = 4, 3, 12
    rng = np.random.RandomState(1)
    is_float = dtype is ml_dtypes.bfloat16 or np.dtype(dtype).kind == "f"
    if is_float:
        vals = rng.randn(n, rows, m) * 10.0 ** rng.randint(-3, 4, (n, rows, m))
        tiny = float(ml_dtypes.finfo(dtype).smallest_normal) / 4
        vals[:, :, :5] = [np.nan, 0.0, -0.0, tiny, -tiny]
        vals[1::2, :, :5] = vals[1::2, :, [1, 0, 0, 2, 3]]
        a = vals.astype(dtype)
    else:
        a = rng.randint(0, 1 << 30, (n, rows, m)).astype(dtype) * 7
    b = np.roll(a, 1, axis=2)
    ai = rng.randint(0, rows, n).astype(np.int32)
    bi = rng.randint(0, rows, n).astype(np.int32)
    left = (np.arange(n) - 1) % n
    mine, recv = a[np.arange(n), ai], b[left, bi[left]]
    pair = (recv, mine) if recv_first else (mine, recv)
    want = np.asarray(_jax_op(opname).jax_fn(*map(jnp.asarray, pair)))[:, None]
    zero = torch.zeros(n, dtype=torch.int32)
    for fold in (ck.ring_hop_fold_plain, ck.ring_hop_fold):
        d = from_numpy(np.zeros_like(want))
        fold(from_numpy(a), torch.from_numpy(ai), from_numpy(b), torch.from_numpy(bi),
             d, zero, _torch_op(opname), recv_first)
        got = to_numpy(d)
        if not is_float:
            same_bits(got, want)
            continue
        p64 = [v.astype(np.float64) for v in pair]
        sub = ((np.abs(p64[0]) < ml_dtypes.finfo(dtype).smallest_normal) & (p64[0] != 0)) | (
            (np.abs(p64[1]) < ml_dtypes.finfo(dtype).smallest_normal) & (p64[1] != 0))
        sub = sub[:, None]
        nan_only = ((np.isnan(p64[0]) | np.isnan(p64[1])) if dtype is ml_dtypes.bfloat16
                    else (np.isnan(p64[0]) & np.isnan(p64[1])))[:, None]
        same_bits_but_nan(got[~sub], want[~sub], nan_only[~sub])
        exact = _jax_op(opname).np_fn(*p64).astype(dtype)[:, None]
        np.testing.assert_array_equal(got[sub].astype(np.float64),
                                      exact[sub].astype(np.float64))
        assert sub.any() and np.isnan(got.astype(np.float64)).any()


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((4, 2, 8))
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(MPIArgError):
        ck.ring_hop(x, idx.long(), x, idx)  # int64 index
    with pytest.raises(MPIArgError):
        ck.ring_hop(x, idx, torch.zeros((4, 2, 9)), idx)  # chunk lengths differ
    with pytest.raises(MPIArgError):
        ck.ring_hop(x[:, :, ::2], idx, x, idx)  # not contiguous
    with pytest.raises(MPIArgError):
        ck.ring_hop_fold(x, idx, x, idx, x, idx, top.BOR)  # no fold kernel for BOR
    with pytest.raises(MPIArgError):
        ck.ring_hop_fold(x, idx, x.double(), idx, x, idx, top.SUM)
    assert ck.fold_supported(top.SUM, torch.bfloat16)
    assert not ck.fold_supported(top.SUM, torch.int16)

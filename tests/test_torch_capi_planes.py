"""The C ABI's data planes on the port, and the native pieces they ride.

* ``devsum`` (MPI_SUM of 2 MiB of doubles) gives the digest numpy
  computes from the formula in ``native/examples/devsum.c`` on every
  plane: the shim's C collective fast path (engaged, as its
  ``TPUMPI_FP_DEBUG`` lines show), the Python host plane (``--mca btl
  tcp`` with the device plane off) and the Python plane with the device
  plane on — where the row is a tensor and the per-process metrics file
  counts ``device_sends``;
* ``mixed_handle`` (a predefined handle on one rank, a same-signature
  derived handle on the other) is forced onto the Python plane on both;
* the native convertor leg (``csrc/convertor.cc``) gives the bytes of
  the numpy convertor, after ``tests/test_native_convertor.py``.

Jobs run with ``--cpu --nranks 1``.
"""

import json

import numpy as np
import pytest

from ompi_tpu_torch import native
from ompi_tpu_torch.ddt import convertor
from ompi_tpu_torch.ddt import datatype as ddt
from test_torch_capi import EXAMPLES, compile_programs, lines_with, run_c

COUNT = 262144  # devsum's default: 2 MiB of doubles


@pytest.fixture(scope="module")
def bins(tmp_path_factory):
    return compile_programs(tmp_path_factory.mktemp("capi_planes"), {
        name: EXAMPLES / f"{name}.c" for name in ("devsum", "mixed_handle")})


def devsum_digest(count: int, size: int) -> tuple[str, str]:
    """devsum.c's inputs and digest in numpy: the values are integers
    times 0.5, exact in double, so every plane's sum is exact."""
    i = np.arange(count, dtype=np.int64)
    out = sum(((i * 2654435761 + 7919 * (r + 1)) % 1000003).astype(np.float64) * 0.5
              for r in range(size))
    w = out.view(np.uint64)
    return f"{int(np.bitwise_xor.reduce(w)):x}", f"{int(w.sum(dtype=np.uint64)):x}"


def _digests(out: str) -> set[tuple[str, str]]:
    rows = [line.split("DEVSUM ", 1)[1] for line in lines_with(out, "DEVSUM ")]
    assert len(rows) == 2, out
    return {(kv["xor"], kv["sum"]) for kv in (dict(f.split("=", 1) for f in r.split())
                                              for r in rows)}


@pytest.mark.parametrize("plane", ["c_fast_path", "python_host", "python_device"])
def test_devsum_digest_equals_numpy_on_every_plane(bins, plane, tmp_path):
    import os

    mca, env = {}, dict(os.environ)
    if plane == "c_fast_path":
        env["TPUMPI_FP_DEBUG"] = "1"
    else:
        mca = {"btl": "tcp", "metrics_enable": 1, "metrics_output": tmp_path / "m"}
        if plane == "python_host":
            mca["dcn_device_enable"] = 0
        else:
            mca["dcn_device_min_size"] = 4096
    res = run_c(2, bins["devsum"], cwd=tmp_path, mca=mca, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    assert _digests(res.stdout) == {devsum_digest(COUNT, 2)}
    if plane == "c_fast_path":
        assert len(lines_with(res.stderr + res.stdout, "fast path ACTIVE")) == 2
        return
    assert not lines_with(res.stderr + res.stdout, "fast path ACTIVE")
    for proc in (0, 1):
        snap = json.loads((tmp_path / f"m.{proc}.jsonl").read_text().splitlines()[-1])
        sends = snap["native"].get("device_sends", 0)
        assert (sends > 0) == (plane == "python_device"), (proc, sends)
        assert snap["cuda_initialized"] is False  # a --cpu job never touches CUDA


def test_np2_mixed_handle_forced_to_python_plane(bins, tmp_path):
    res = run_c(2, bins["mixed_handle"], cwd=tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(lines_with(res.stdout, "MIXED PASS")) == 2, res.stdout
    assert "MIXED FAIL" not in res.stdout


# -- the native convertor leg ---------------------------------------------


@pytest.fixture(scope="module")
def conv_lib():
    lib = native.load_convertor()
    assert lib is not None and native.CONV_LIB.parent == native.BUILD_DIR
    return lib


def _layouts():
    d = ddt.DOUBLE
    yield "vector", d.create_vector(4, 2, 5), 3
    yield "hvector", d.create_hvector(3, 2, 40), 2
    yield "indexed", d.create_indexed([2, 1, 3], [0, 4, 9]), 2
    yield "contig_of_vector", d.create_vector(2, 1, 3).create_contiguous(2), 2
    yield "resized", d.create_resized(0, 24), 4
    yield "subarray", d.create_subarray([4, 6], [2, 3], [1, 2]), 1


LAYOUTS = list(_layouts())


@pytest.mark.parametrize("name,dt,count", LAYOUTS, ids=[n for n, _, _ in LAYOUTS])
def test_native_pack_matches_numpy(conv_lib, name, dt, count):
    dt = dt.commit()
    span = dt.span(count) + max(0, dt.lb)
    arr = np.frombuffer(np.random.RandomState(7).bytes(span + 64), np.uint8).copy()
    golden = convertor.Convertor(arr, dt, count).pack()
    out = convertor._native_pack(arr, dt, count, 0)
    assert out is not None
    np.testing.assert_array_equal(out, golden)


@pytest.mark.parametrize("name,dt,count", LAYOUTS, ids=[n for n, _, _ in LAYOUTS])
def test_native_unpack_roundtrip(conv_lib, name, dt, count):
    dt = dt.commit()
    span = dt.span(count) + max(0, dt.lb)
    src = np.frombuffer(np.random.RandomState(3).bytes(span + 64), np.uint8).copy()
    packed = convertor.Convertor(src, dt, count).pack()
    dst_native = np.zeros(src.size, np.uint8)
    assert convertor._native_unpack(dst_native, dt, count, packed, 0)
    dst_numpy = np.zeros(src.size, np.uint8)
    convertor.Convertor(dst_numpy, dt, count).unpack(packed)
    np.testing.assert_array_equal(dst_native, dst_numpy)


def test_one_shot_api_uses_native_and_matches(conv_lib, monkeypatch):
    """pack()/unpack() of a numpy buffer go through the native kernels
    and agree with the pure path under the MCA switch."""
    from ompi_tpu_torch.core import mca

    d = ddt.FLOAT.create_vector(8, 3, 7).commit()
    count = 4
    arr = np.frombuffer(np.random.RandomState(0).bytes(d.span(count) + 16), np.uint8).copy()
    calls = []
    real = convertor._native_pack
    monkeypatch.setattr(convertor, "_native_pack",
                        lambda *a: calls.append(1) or real(*a))
    p_native = convertor.pack(arr, d, count)
    assert calls
    store = mca.default_context().store
    convertor._native_enabled()  # registers the var
    store.set("ddt_convertor_native", False)
    try:
        p_pure = convertor.pack(arr, d, count)
        out2 = np.zeros_like(arr)
        convertor.unpack(out2, d, count, p_native)
    finally:
        store.set("ddt_convertor_native", True)
    assert len(calls) == 1
    np.testing.assert_array_equal(p_native, p_pure)
    out = np.zeros_like(arr)
    convertor.unpack(out, d, count, p_native)
    np.testing.assert_array_equal(out, out2)


def test_native_bounds_errors(conv_lib):
    from ompi_tpu_torch.core.errors import MPITruncateError

    d = ddt.DOUBLE.create_vector(4, 2, 5).commit()
    with pytest.raises(MPITruncateError):
        convertor.pack(np.zeros(8, np.uint8), d, 2)


def test_strided_copy_kernel(conv_lib):
    src = np.arange(64, dtype=np.uint8)
    dst = np.zeros(64, np.uint8)
    conv_lib.tpuconv_copy_strided(src.ctypes.data, dst.ctypes.data, 4, 8, 16, 8)
    expect = np.concatenate([src[i * 16: i * 16 + 8] for i in range(4)])
    np.testing.assert_array_equal(dst[:32], expect)
    assert not dst[32:].any()


"""MPI-IO and checkpoints of the PyTorch port against the JAX package.

The same IO program — individual writes at offsets and pointers,
strided and subarray views, shared and ordered pointers, collective
writes under every fcoll strategy — runs through both packages into two
files, which must be byte-identical, as must everything read back.  The
port writes tensors (through one staging copy) to the same bytes as
numpy arrays.  Checkpoints are byte-compatible: one written by either
package restores in the other.  The last test drives the slice as a
whole: a pipeline exchange, a window epoch and a checkpoint round trip.
Mirrors ``tests/test_io.py``.
"""

import contextlib
import json

import ml_dtypes
import numpy as np
import pytest
import torch

import ompi_tpu.api as japi
import ompi_tpu.ddt as jddt
import ompi_tpu.io as jio
import ompi_tpu_torch.api as tapi
import ompi_tpu_torch.ddt as tddt
import ompi_tpu_torch.io as tio
from ompi_tpu.core import mca as jmca
from ompi_tpu.io import checkpoint as jckpt
from ompi_tpu.tool import spc as jspc
from ompi_tpu_torch import op as top
from ompi_tpu_torch.core import mca as tmca
from ompi_tpu_torch.ddt.datatype import from_numpy, to_numpy
from ompi_tpu_torch.io import checkpoint as tckpt
from ompi_tpu_torch.tool import spc as tspc

N = 8
SIDES = {"jax": (jddt, jio), "torch": (tddt, tio)}


@pytest.fixture(scope="module")
def worlds(devices):
    tapi.finalize()
    tw = tapi.init(device="cpu", nranks=N)
    yield {"jax": japi.init(), "torch": tw}
    tapi.finalize()


@contextlib.contextmanager
def fcoll(name):
    stores = (jmca.default_context().store, tmca.default_context().store)
    for s in stores:
        s.set("io_ompio_fcoll", name)
    try:
        yield
    finally:
        for s in stores:
            s.set("io_ompio_fcoll", "two_phase")


def io_program(world, ddt, io, path, tensors=False):
    """Every access mode once; returns what was read back."""
    def data(a):
        return from_numpy(a) if tensors else a

    rng = np.random.RandomState(5)
    reads = []
    f = world.file_open(path, io.MODE_CREATE | io.MODE_RDWR)
    # individual pointers, explicit offsets and nonblocking calls
    for r in range(N):
        f.write_at(r, 64 * r, data(rng.randint(0, 255, 16).astype(np.uint8)))
    f.seek(3, 8)
    f.write(3, data(np.arange(4, dtype=np.uint8)))
    f.iwrite_at(4, 300, data(np.full(3, 9, np.uint8))).wait()
    reads.append(f.read_at(2, 128, 16).tobytes())
    reads.append(f.iread_at(4, 300, 3).wait().tobytes())
    reads.append(f.get_position(3))
    # strided (cyclic) views of doubles
    dbl = ddt.DOUBLE
    ft = dbl.create_resized(0, N * dbl.extent).commit()
    base = 1024
    for r in range(N):
        f.set_view(r, disp=base + r * dbl.extent, etype=dbl, filetype=ft)
        f.write_at(r, 0, data(rng.randn(5)))
    reads.append(f.read_at(6, 1, 3, np.float64).tobytes())
    reads.append(f.get_byte_offset(5, 2))
    # subarray views, collective, under the current fcoll strategy
    rows, cols = N, 6
    for r in range(N):
        sub = dbl.create_subarray([rows, cols], [1, cols], [r, 0]).commit()
        f.set_view(r, 2048, dbl, sub)
    matrix = rng.randn(rows, cols)
    f.write_at_all([0] * N, [data(matrix[r]) for r in range(N)])
    reads.append([a.tobytes() for a in f.read_at_all([0] * N, [cols] * N, np.float64)])
    # back to bytes: shared and ordered pointers, write_all with a gap
    for r in range(N):
        f.set_view(r, 4096)
    f.write_shared(1, data(np.full(5, 1, np.uint8)))
    f.write_shared(6, data(np.full(3, 6, np.uint8)))
    f.write_ordered([data(np.full(r + 1, 10 + r, np.uint8)) for r in range(N)])
    reads.append(f.get_position_shared())
    f.seek_shared(0)
    reads.append(f.read_shared(2, 7).tobytes())
    reads.append([a.tobytes() for a in f.read_ordered([2] * N)])
    counts = f.write_all([data(np.full(4, r, np.uint8)) if r % 3 else None for r in range(N)])
    reads.append(counts)
    reads.append(f.get_size())
    f.close()
    return reads


@pytest.mark.parametrize("strategy", ["two_phase", "individual", "dynamic_gen2", "vulcan"])
def test_files_are_byte_identical(worlds, tmp_path, strategy):
    out = {}
    with fcoll(strategy):
        for side, (ddt, io) in SIDES.items():
            path = str(tmp_path / f"{side}.bin")
            out[side] = (io_program(worlds[side], ddt, io, path), open(path, "rb").read())
        tpath = str(tmp_path / "tensor.bin")
        out["tensor"] = (io_program(worlds["torch"], tddt, tio, tpath, tensors=True),
                         open(tpath, "rb").read())
    assert out["torch"][0] == out["jax"][0] == out["tensor"][0]
    assert out["torch"][1] == out["jax"][1] == out["tensor"][1]
    assert len(out["jax"][1]) > 4096


ERRORS = [
    ("no_access_bit", lambda w, io, p: w.file_open(p, io.MODE_CREATE)),
    ("two_access_bits", lambda w, io, p: w.file_open(p, io.MODE_RDONLY | io.MODE_WRONLY)),
    ("rdonly_create", lambda w, io, p: w.file_open(p, io.MODE_RDONLY | io.MODE_CREATE)),
    ("missing_file", lambda w, io, p: w.file_open(p + ".none", io.MODE_RDONLY)),
]


@pytest.mark.parametrize("name,call", ERRORS, ids=[e[0] for e in ERRORS])
def test_open_errors_match(worlds, tmp_path, name, call):
    names = []
    for side, (_, io) in SIDES.items():
        with pytest.raises(Exception) as err:
            call(worlds[side], io, str(tmp_path / "x.bin"))
        names.append(type(err.value).__name__)
    assert names[0] == names[1]


def test_access_errors_match(worlds, tmp_path):
    names = {}
    for side, (ddt, io) in SIDES.items():
        w = worlds[side]
        path = str(tmp_path / f"{side}.bin")
        f = w.file_open(path, io.MODE_CREATE | io.MODE_WRONLY | io.MODE_EXCL)
        got = []
        for bad in (lambda: f.read_at(0, 0, 4),
                    lambda: f.set_view(0, 0, ddt.DOUBLE, ddt.FLOAT),
                    lambda: f.write_at(N, 0, np.zeros(2, np.uint8)),
                    lambda: f.seek(0, -5),
                    lambda: f.write_at_all([0] * 3, [None] * 3)):
            with pytest.raises(Exception) as err:
                bad()
            got.append(type(err.value).__name__)
        f.close()
        with pytest.raises(Exception) as err:
            w.file_open(path, io.MODE_CREATE | io.MODE_WRONLY | io.MODE_EXCL)
        got.append(type(err.value).__name__)
        with pytest.raises(Exception) as err:
            f.get_size()  # closed
        got.append(type(err.value).__name__)
        names[side] = got
    assert names["jax"] == names["torch"]


def test_spc_file_bytes_match(worlds, tmp_path):
    snaps = []
    for side, spc in (("jax", jspc), ("torch", tspc)):
        spc.clear()
        spc.attach(True)
        try:
            io_program(worlds[side], *SIDES[side], str(tmp_path / f"{side}.bin"))
            snaps.append({k: spc.get(k) for k in ("file_write_bytes", "file_read_bytes")})
        finally:
            spc.attach(False)
            spc.clear()
    assert snaps[0] == snaps[1] and snaps[0]["file_write_bytes"] > 0


# -- checkpoints ---------------------------------------------------------


CKPT_DTYPES = [np.float32, np.int64, ml_dtypes.bfloat16, np.uint16]


@pytest.mark.parametrize("dtype", CKPT_DTYPES, ids=[np.dtype(d).name for d in CKPT_DTYPES])
def test_checkpoint_is_byte_compatible(worlds, tmp_path, dtype):
    arr = (np.random.RandomState(2).randn(N, 3, 5) * 50).astype(dtype)
    jpath, tpath, ttpath = (str(tmp_path / n) for n in ("j.ckpt", "t.ckpt", "tt.ckpt"))
    jckpt.save(worlds["jax"], jpath, arr, {"step": 3})
    tckpt.save(worlds["torch"], tpath, arr, {"step": 3})
    tckpt.save(worlds["torch"], ttpath, from_numpy(arr), {"step": 3})
    for p in (tpath, ttpath):
        assert open(p, "rb").read() == open(jpath, "rb").read()
        assert open(p + ".json", "rb").read() == open(jpath + ".json", "rb").read()
    assert json.load(open(jpath + ".json"))["dtype"] == np.dtype(dtype).name
    # each restores the other's
    t_of_j, man = tckpt.restore(worlds["torch"], jpath)
    assert isinstance(t_of_j, torch.Tensor) and man["step"] == 3
    assert to_numpy(t_of_j).tobytes() == arr.tobytes() and t_of_j.shape == arr.shape
    host, _ = tckpt.restore(worlds["torch"], jpath, stage=False)
    assert isinstance(host, np.ndarray) and host.dtype == arr.dtype
    assert host.tobytes() == arr.tobytes()
    j_of_t, man = jckpt.restore(worlds["jax"], ttpath)
    assert np.asarray(j_of_t).tobytes() == arr.tobytes() and man["step"] == 3


def test_checkpoint_async_snapshots_before_return(worlds, tmp_path):
    arr = np.random.RandomState(3).randn(N, 16).astype(np.float32)
    t = from_numpy(arr)
    path = str(tmp_path / "a.ckpt")
    req = tckpt.save_async(worlds["torch"], path, t)
    t.fill_(-1.0)  # the caller may overwrite at once
    req.wait()
    got, _ = jckpt.restore(worlds["jax"], path)
    assert np.asarray(got).tobytes() == arr.tobytes()


def test_checkpoint_errors_match(worlds, tmp_path):
    names = []
    for side, ck in (("jax", jckpt), ("torch", tckpt)):
        w, got = worlds[side], []
        for bad in (lambda: ck.save(w, str(tmp_path / "bad"), np.zeros((3, 2))),
                    lambda: ck.restore(w, str(tmp_path / "none"))):
            with pytest.raises(Exception) as err:
                bad()
            got.append(type(err.value).__name__)
        req = ck.save_async(w, str(tmp_path / "bad2"), np.zeros((3, 2)))
        with pytest.raises(Exception) as err:
            req.wait()
        got.append(type(err.value).__name__)
        names.append(got)
    assert names[0] == names[1] == ["MPIFileError"] * 3


# -- the slice as a whole -------------------------------------------------


def test_slice_pipeline_window_checkpoint(worlds, tmp_path):
    """A pipeline-stage exchange (every rank sendrecvs its activation to
    r+1), a window epoch accumulating each rank's activations into r+1's
    window and fetching r-1's, then a checkpoint of the window memory
    restored in the other package: bit-equal end to end."""
    from ompi_tpu import op as jop

    acts = np.random.RandomState(8).randn(N, 4, 6).astype(np.float32)
    results = {}
    for side, op, ck in (("jax", jop, jckpt), ("torch", top, tckpt)):
        w = worlds[side]
        w.send(acts[N - 1], N - 1, 0, tag=1)
        recv = [w.sendrecv(acts[r], r, r + 1, (r - 1) % N, 1, 1)[0] for r in range(N - 1)]
        recv.append(w.recv(N - 1, N - 2, 1)[0])
        recv = [to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x) for x in recv]
        win = w.win_allocate(24, np.float32)
        win.fence()
        gets = []
        for r in range(N):
            win.accumulate(r, (r + 1) % N, recv[r].ravel(), op=op.SUM)
            gets.append(win.get(r, (r - 1) % N, 24))
        win.fence()
        mem = np.stack([to_numpy(win.memory(r)) if side == "torch" else win.memory(r)
                        for r in range(N)])
        path = str(tmp_path / f"{side}.ckpt")
        ck.save(w, path, win.device_view() if side == "torch" else mem)
        results[side] = (np.stack(recv).tobytes(), mem.tobytes(),
                         [np.asarray(to_numpy(g.wait()) if side == "torch" else g.wait())
                          .tobytes() for g in gets], path)
    assert results["torch"][:3] == results["jax"][:3]
    assert np.stack([np.roll(acts, 1, 0)]).tobytes() == results["jax"][0]
    restored, _ = tckpt.restore(worlds["torch"], results["jax"][3])
    assert to_numpy(restored).tobytes() == results["jax"][1]
    back, _ = jckpt.restore(worlds["jax"], results["torch"][3])
    assert np.asarray(back).tobytes() == results["jax"][1]

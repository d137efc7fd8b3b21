"""The port's single-process measurement tools against the reference's.

``ompi_tpu_torch/tools/bench_algos.py``, ``bench_hostpath.py`` and
``bench_pyapi.py`` beside ``tools/bench_algos_cpu8.py``,
``tools/bench_hostpath_cpu8.py`` and ``tools/bench_pyapi.py``, on the
CPU at small sizes:

* ``ALGOS8``: the family and algorithm tables equal the reference
  tool's (read from its module, whose timing loop is not run); every
  entry, bound as each tool binds it, gives the reference entry's
  output under ``shard_map`` on the 8 virtual CPU devices — bit for bit,
  except ``psum`` and ``reduce_scatter_direct`` (``allclose``, rtol 1e-6
  plus an atol of 1e-6 of the largest input, as ``test_torch_coll.py``);
* ``measure_overlap`` returns ``bench.measure_overlap``'s keys for the
  same fake blocking and non-blocking callables;
* ``HOSTPATH8``: the reference's keys (plus ``device``), the same
  staging deltas, every row within the rounding bound of the numpy sum;
* ``PYAPI``: the reference worker's row sizes under each launcher;
* without a card and without ``--cpu`` each tool raises.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # jax < 0.5
    from jax.experimental.shard_map import shard_map

from ompi_tpu.mesh import AXIS
from ompi_tpu_torch.core.errors import MPIInternalError
from ompi_tpu_torch.tools import bench_algos as ba
from ompi_tpu_torch.tools import bench_hostpath as bh

REPO = Path(__file__).resolve().parents[1]
N = 8
_CHECK_KW = {}
for _k in ("check_vma", "check_rep"):
    if _k in __import__("inspect").signature(shard_map).parameters:
        _CHECK_KW[_k] = False  # the schedules return rank-varying values
        break


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_algos(devices):
    """The reference tool's module: its tables and mesh (``main()`` is
    not called)."""
    return _load("_ref_bench_algos_cpu8", REPO / "tools" / "bench_algos_cpu8.py")


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + (":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.pop("OMPI_TPU_DEVICE", None)
    return env


def _start(*args) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *map(str, args)], cwd=str(REPO), env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen, timeout: float = 120) -> tuple[int, str]:
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, out + err


def _marked(text: str, marker: str):
    for line in text.splitlines():
        line = line.split("] ", 1)[1] if line.startswith("[") else line
        if line.startswith(marker + " ") and line[len(marker) + 1:][:1] in "{[":
            return json.loads(line[len(marker) + 1:])
    raise AssertionError(f"no {marker} line in:\n{text[-3000:]}")


# -- ALGOS8 ---------------------------------------------------------------------


def test_algos_tables_equal_reference(ref_algos):
    ref = {"allreduce": ref_algos.ALLREDUCE, "allgather": ref_algos.ALLGATHER,
           "bcast": ref_algos.BCAST, "reduce": ref_algos.REDUCE,
           "reduce_scatter": ref_algos.REDUCE_SCATTER, "alltoall": ref_algos.ALLTOALL,
           "barrier": ref_algos.BARRIER}
    assert list(ba.FAMILIES) == list(ref)
    for family, (table, _blocks, _call) in ba.FAMILIES.items():
        assert list(table) == list(ref[family]), family
        for name, fn in table.items():
            assert fn.__name__ == ref[family][name].__name__


def _ref_entry(ref, family: str, fn, x, xb) -> np.ndarray:
    """The reference entry bound as its tool binds it, under shard_map on
    the 8 virtual devices; returned in the port's rank-major layout."""
    s = ref.SUM
    bind = {
        "allreduce": (lambda v: fn(v, s, N), P(AXIS), x),
        "allgather": (lambda v: fn(v, N), P(), x),
        "bcast": (lambda v: fn(v, N, 0), P(AXIS), x),
        "reduce": (lambda v: fn(v, s, N, 0), P(AXIS), x),
        "reduce_scatter": (lambda v: fn(v[0], s, N), P(AXIS), xb),
        "alltoall": (lambda v: fn(v[0], N), P(AXIS), xb),
        "barrier": (lambda v: v[0, :1] + fn(N).astype(np.float32), P(AXIS), x),
    }[family]
    f = jax.jit(shard_map(bind[0], mesh=ref.MESH, in_specs=P(AXIS), out_specs=bind[1],
                          **_CHECK_KW))
    out = np.asarray(f(bind[2]))
    if family == "allgather":  # replicated: every rank holds the (N, elems) gather
        return np.broadcast_to(out.reshape(x.shape), (N,) + x.shape)
    if family == "reduce_scatter":  # rank j's block of the reduction
        return out.reshape(N, xb.shape[-1])
    if family == "alltoall":
        return out.reshape(xb.shape)
    return out


ENTRIES = [(f, name) for f, (table, _b, _c) in ba.FAMILIES.items() for name in table]


@pytest.mark.parametrize("family,name", ENTRIES, ids=[f"{f}-{n}" for f, n in ENTRIES])
def test_algos_entry_matches_reference(ref_algos, family, name):
    x, xb = ba.inputs(40, seed=len(family) + len(name))
    table, blocks, call = ba.FAMILIES[family]
    got = call(table[name], torch.from_numpy(xb if blocks else x)).numpy()
    ref_table = getattr(ref_algos, family.upper())
    want = _ref_entry(ref_algos, family, ref_table[name], x, xb)
    assert got.shape == want.shape and got.dtype == want.dtype
    if (family, name) in ba.CLOSE_ONLY:
        scale = np.abs(xb if blocks else x).max()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)
    elif (family, name) == ("reduce", "binomial"):
        assert got[0].tobytes() == want[0].tobytes()  # only root's row is defined
    else:
        assert got.tobytes() == want.tobytes()


def test_algos_cli_on_the_cpu():
    """``bench-algos --cpu --check`` at toy sizes: the check line holds
    every entry, the timing line has the reference's keys plus
    ``device``; ``--help`` names the size flags."""
    rc, text = _finish(_start("-m", "ompi_tpu_torch", "bench-algos", "--cpu", "--check",
                              "--small", 16, "--small-iters", 2, "--large", 64,
                              "--large-iters", 1))
    assert rc == 0, text[-3000:]
    chk = _marked(text, "ALGOS8_CHECK")
    assert chk["ok"] and chk["device"] == "cpu"
    assert len(chk["entries"]) == len(ENTRIES)
    assert chk["launches"] == {"ring_hop": 0, "ring_hop_fold": 0,
                               "ring_hop_peer": 0, "ring_hop_wait": 0}
    line = _marked(text, "ALGOS8")
    ref_keys = ["n_devices", "allreduce", "allgather", "bcast", "reduce",
                "reduce_scatter", "alltoall", "barrier"]
    assert list(line) == ref_keys + ["device"]
    assert line["n_devices"] == N and line["device"] == "cpu"
    for family, (table, _b, _c) in ba.FAMILIES.items():
        assert list(line[family]) == list(table)
        want = ["small_us"] if family == "barrier" else ["small_us", "large_us"]
        for name in table:
            assert list(line[family][name]) == want
            assert all(v > 0 for v in line[family][name].values())
    help_text = subprocess.run([sys.executable, "-m", "ompi_tpu_torch", "bench-algos",
                                "--help"], cwd=str(REPO), env=_env(), capture_output=True,
                               text=True, timeout=60).stdout
    for flag in ("--small", "--small-iters", "--large", "--large-iters", "--cpu", "--check"):
        assert flag in help_text


def test_algos_check_catches_a_disagreement(monkeypatch):
    """The check's bitwise rule fails an entry whose device leg is one
    ulp off its CPU leg, which ``allclose`` would let through."""
    calls = []

    def ring_nudged_on_the_second_leg(v, op):
        out = ba.base.allreduce_ring(v, op)
        calls.append(1)
        return out if len(calls) % 2 else torch.nextafter(out, torch.full_like(out, np.inf))

    table = dict(ba.ALLREDUCE, ring=ring_nudged_on_the_second_leg)
    monkeypatch.setitem(ba.FAMILIES, "allreduce", (table,) + ba.FAMILIES["allreduce"][1:])
    res = ba.check(torch.device("cpu"), (("small_us", 16, 1),))
    assert res["allreduce/ring"]["rule"] == "bitwise"
    assert res["allreduce/ring"]["ok"] is False
    assert 0 < res["allreduce/ring"]["small_us_max_abs_err"] < 1e-5
    assert all(e["ok"] for k, e in res.items() if k != "allreduce/ring")


# -- measure_overlap, HOSTPATH8 ---------------------------------------------------------


class _Req:
    def __init__(self, t_end):
        self.t_end = t_end

    def wait(self):
        while time.perf_counter() < self.t_end:
            pass


def _spin(s):
    t_end = time.perf_counter() + s
    while time.perf_counter() < t_end:
        pass


def test_measure_overlap_keys_equal_reference():
    bench = _load("_ref_bench", REPO / "bench.py")
    coll = lambda: _spin(0.0003)  # noqa: E731
    icoll = lambda: _Req(time.perf_counter() + 0.0003)  # noqa: E731
    want = bench.measure_overlap(coll, icoll, iters=4)
    got = bh.measure_overlap(coll, icoll, iters=4)
    assert list(got) == list(want)
    assert {k: type(v) for k, v in got.items()} == {k: type(v) for k, v in want.items()}
    assert got["estimator"] == want["estimator"]
    assert got["t_overlapped_us"] > 0 and got["t_serial_us"] > 0


def test_hostpath_keys_and_sums_equal_reference(tmp_path):
    """Both tools at the reference's sizes, side by side: the same keys
    (the port adds ``device``), the same rows and staging deltas, and
    each port row within the rounding bound of the numpy sum."""
    ref = _start(REPO / "tools" / "bench_hostpath_cpu8.py")
    port = _start("-m", "ompi_tpu_torch", "bench-hostpath", "--cpu", "--check")
    rc_ref, ref_text = _finish(ref)
    rc, text = _finish(port)
    assert rc_ref == 0, ref_text[-3000:]
    assert rc == 0, text[-3000:]
    want, got = _marked(ref_text, "HOSTPATH8"), _marked(text, "HOSTPATH8")
    assert list(got) == list(want) + ["device"] and got["device"] == "cpu"
    assert got["n_devices"] == want["n_devices"] == N
    assert [list(r) for r in got["rows"]] == [list(r) for r in want["rows"]]
    assert [(r["bytes"], r["iters"]) for r in got["rows"]] == \
        [(r["bytes"], r["iters"]) for r in want["rows"]]
    assert list(got["arena"]) == list(want["arena"])
    for k in ("stage_calls", "stage_bytes", "pool_hits", "pool_allocs"):
        assert got["arena"][k] == want["arena"][k], k
    assert got["arena"]["donate_signatures"] == 0  # no donating programs
    assert list(got["overlap8"]) == list(want["overlap8"])
    assert got["overlap8"]["bytes"] == want["overlap8"]["bytes"]
    chk = _marked(text, "HOSTPATH8_CHECK")
    assert chk["ok"] and chk["stage_calls"] == chk["calls"] == 67
    assert [c["bytes"] for c in chk["rows"]] == [r["bytes"] for r in want["rows"]]
    assert all(c["ok"] and c["err_over_bound"] <= 1.0 for c in chk["rows"])


def test_hostpath_row_check_catches_a_wrong_sum():
    hbuf = np.random.default_rng(3).standard_normal((N, 64), dtype=np.float32)
    out = np.broadcast_to(hbuf.sum(0), hbuf.shape).copy()
    assert bh.sum_error(out, hbuf)[1] <= 1.0
    out[5, 7] = np.nextafter(out[5, 7], np.inf) + 1e-3
    assert bh.sum_error(out, hbuf)[1] > 1.0


# -- PYAPI ------------------------------------------------------------------------------


def test_pyapi_rows_equal_reference():
    ref = _start("-m", "ompi_tpu", "run", "-np", 1, "--cpu-devices", 1,
                 REPO / "tools" / "bench_pyapi.py", 64, 20)
    port = _start("-m", "ompi_tpu_torch", "run", "-np", 1, "--nranks", 1, "--cpu",
                  REPO / "ompi_tpu_torch" / "tools" / "bench_pyapi.py", 64, 20)
    rc_ref, ref_text = _finish(ref)
    rc, text = _finish(port)
    assert rc_ref == 0, ref_text[-3000:]
    assert rc == 0, text[-3000:]
    assert "[0] PYAPI device=cpu max_bytes=64 iters=20" in text.splitlines()
    want = _marked(ref_text, "PYAPI")
    got = _marked(text, "PYAPI")
    assert [r["bytes"] for r in got] == [r["bytes"] for r in want] == [4, 16, 64]
    assert [list(r) for r in got] == [list(r) for r in want]
    assert all(r["py_us"] > 0 for r in got)


# -- no card, no --cpu ------------------------------------------------------------------


def test_each_tool_raises_without_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tools run on it")
    with pytest.raises(MPIInternalError, match="no CUDA device"):
        ba.main(["--small", "8", "--large", "16"])
    with pytest.raises(MPIInternalError, match="no CUDA device"):
        bh.main([])
    rc, text = _finish(_start("-m", "ompi_tpu_torch", "run", "-np", 1, "--nranks", 1,
                              REPO / "ompi_tpu_torch" / "tools" / "bench_pyapi.py", 8, 2))
    assert rc != 0 and "no CUDA device" in text
    assert "PYAPI [" not in text and "PYAPI device=" not in text

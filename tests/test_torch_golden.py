"""The reference library's golden vectors on the port, and its two
diagnostic tools.

``tests/golden/reduce_local.json`` holds Open MPI 4.1.4's own results
(``MPI_Reduce_local`` left folds over 8 ranks, and np=1
``MPI_Allreduce``/``MPI_Scan``), captured by the reference's
``tools/golden_capture.py``.  Here:

* the port's ``ompi_tpu_torch/tools/golden_capture.py`` draws the
  reference tool's inputs and, where the library is installed, writes
  the committed file's bytes (and the reference tool's, over the same
  directory), by default under ``build/ompi_tpu_torch/``, never into
  ``tests/golden/``;
* the port's collectives on the CPU world reproduce the library's bytes:
  all 12 folds through ``allreduce`` with ``coll_cuda_reproducible``,
  the 8 order-free folds (int32 under every op, float MAX/MIN) through
  ``cuda_ring`` on both CPU rungs (its emulation and the kernels' plain
  bodies, 7 + 7 per call), the 4 float SUM/PROD cases through
  ``cuda_ring`` against the plain ring (their bracketing differs from a
  left fold), and the 24 singleton collectives on ``comm_self()``;
* ``ompi_tpu_torch/tools/diag_pp.py`` as an np=2 ``--cpu`` job prints
  the reference's two ``PPDIAG`` lines after its device line, and
  without ``--cpu`` fails where there is no card.

The card runs the same vectors in ``chip_smoke.py``'s ``golden`` phase.
"""

import contextlib
import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ompi_tpu_torch.api as tapi
from ompi_tpu_torch.coll import cuda_kernels as ck
from ompi_tpu_torch.coll.cuda import ALLREDUCE_ALGOS
from ompi_tpu_torch.core import mca as tmca
from ompi_tpu_torch.op import PREDEFINED_OPS
from ompi_tpu_torch.tools import golden_capture as port_capture
from tools import golden_capture as ref_capture

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden" / "reduce_local.json"
DIAG_PP = REPO / "ompi_tpu_torch" / "tools" / "diag_pp.py"
DTYPES = {"float32": np.float32, "float64": np.float64, "int32": np.int32}
N = 8

needs_libmpi = pytest.mark.skipif(not os.path.exists(ref_capture.LIBMPI),
                                  reason="reference libmpi not installed")


def _load():
    data = json.loads(GOLDEN.read_text())
    folds = []
    for name, c in sorted(data["cases"].items()):
        dt = np.dtype(DTYPES[c["dtype"]])
        x = np.frombuffer(bytes.fromhex(c["input_hex"]), dt).reshape(c["n_ranks"], c["count"])
        folds.append((name, c["op"], x, bytes.fromhex(c["result_hex"])))
    singles = []
    for name, c in sorted(data["singleton_colls"].items()):
        dt = np.dtype(DTYPES[c["dtype"]])
        x = np.frombuffer(bytes.fromhex(c["input_hex"]), dt)
        singles.append((name, c["coll"], c["op"], x, bytes.fromhex(c["result_hex"])))
    return folds, singles


FOLDS, SINGLES = _load()
#: fold cases whose result does not depend on the order of the fold
ORDER_FREE = [c for c in FOLDS if c[0].endswith(":int32") or c[1] in ("MPI_MAX", "MPI_MIN")]
ORDER_BOUND = [c for c in FOLDS if c not in ORDER_FREE]


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "OMPI_TPU_DEVICE"}
    env["PYTHONPATH"] = str(REPO) + ":" + env.get("PYTHONPATH", "")
    return env


def _sha(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


# -- the capture tool ---------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_make_inputs_equal_reference(dtype):
    got = port_capture.make_inputs(DTYPES[dtype])
    want = ref_capture.make_inputs(DTYPES[dtype])
    assert got.dtype == want.dtype and got.shape == want.shape == (N, 257)
    assert got.tobytes() == want.tobytes()


def test_capture_tables_equal_reference():
    assert port_capture.LIBMPI == ref_capture.LIBMPI
    assert port_capture.OPS == ref_capture.OPS
    assert port_capture.DTYPES == ref_capture.DTYPES
    assert (port_capture.N_RANKS, port_capture.COUNT) == (ref_capture.N_RANKS, ref_capture.COUNT)


@needs_libmpi
def test_capture_writes_the_committed_bytes(tmp_path):
    """``golden-capture --out`` writes the committed file byte for byte,
    as the reference's tool does over the same directory."""
    port = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch", "golden-capture", "--out",
         str(tmp_path / "port.json")], capture_output=True, text=True, timeout=300,
        env=_env(), cwd=tmp_path)
    ref = subprocess.run(
        [sys.executable, str(REPO / "tools" / "golden_capture.py"), "--out",
         str(tmp_path / "ref.json")], capture_output=True, text=True, timeout=300,
        env=_env(), cwd=tmp_path)
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    assert f"wrote 12 cases to {tmp_path / 'port.json'}" in port.stdout
    committed = GOLDEN.read_bytes()
    assert (tmp_path / "port.json").read_bytes() == committed
    assert (tmp_path / "ref.json").read_bytes() == committed


def test_default_out_is_under_build():
    rel = port_capture.DEFAULT_OUT.relative_to(REPO)
    assert rel == Path("build/ompi_tpu_torch/golden/reduce_local.json")


@needs_libmpi
def test_default_run_leaves_the_committed_file_untouched(tmp_path):
    """Run from another directory with no ``--out``: the capture lands
    under the checkout's ``build/ompi_tpu_torch/``, and the committed
    file keeps its bytes and its mtime."""
    before = (GOLDEN.stat().st_mtime_ns, _sha(GOLDEN))
    out = port_capture.DEFAULT_OUT
    if out.exists():
        out.unlink()
    res = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.golden_capture"],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f"wrote 12 cases to {out}"
    assert out.read_bytes() == GOLDEN.read_bytes()
    assert (GOLDEN.stat().st_mtime_ns, _sha(GOLDEN)) == before
    assert not (tmp_path / "build").exists()


def test_missing_library_exits_nonzero_and_writes_nothing(tmp_path, monkeypatch, capsys):
    missing = str(tmp_path / "libmpi.so.40.30.4")
    monkeypatch.setattr(port_capture, "LIBMPI", missing)
    out = tmp_path / "g.json"
    assert port_capture.main(["--out", str(out)]) == 1
    assert missing in capsys.readouterr().err
    assert not out.exists()


# -- the golden vectors through the port's collectives ------------------------


@pytest.fixture(scope="module")
def world():
    tapi.finalize()
    w = tapi.init(device="cpu", nranks=N)
    yield w
    tapi.finalize()


@contextlib.contextmanager
def pinned(**values):
    """MCA vars set for the block, then restored."""
    store = tmca.default_context().store
    prev = {k: store.get(k) for k in values}
    for k, v in values.items():
        store.set(k, v)
    try:
        yield
    finally:
        for k, v in prev.items():
            store.set(k, v)


def _rows_differing(out, ref: bytes) -> list:
    out = out.numpy()
    return [r for r in range(out.shape[0]) if out[r].tobytes() != ref]


@pytest.mark.parametrize("name,opname,x,ref", FOLDS, ids=[c[0] for c in FOLDS])
def test_reproducible_allreduce_bit_matches_reference(world, name, opname, x, ref):
    with pinned(coll_cuda_reproducible=True):
        out = world.allreduce(torch.from_numpy(x.copy()), PREDEFINED_OPS[opname])
    assert out.shape == (N, x.shape[1])
    assert _rows_differing(out, ref) == []


class _Counted:
    """Counts the calls of one of the kernels' plain bodies."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.mark.parametrize("rung", ["emulate", "interpret"])
@pytest.mark.parametrize("name,opname,x,ref", ORDER_FREE, ids=[c[0] for c in ORDER_FREE])
def test_cuda_ring_bit_matches_reference(world, monkeypatch, rung, name, opname, x, ref):
    """``cuda_ring`` forced: on the ``interpret`` rung the schedule the
    card runs (padding, index tables, the fused fold) calls the kernels'
    plain bodies exactly 7 + 7 times."""
    hop = _Counted(ck.ring_hop_plain)
    fold = _Counted(ck.ring_hop_fold_plain)
    monkeypatch.setattr(ck, "ring_hop_plain", hop)
    monkeypatch.setattr(ck, "ring_hop_fold_plain", fold)
    with pinned(coll_cuda_allreduce_algorithm=ALLREDUCE_ALGOS["cuda_ring"],
                dcn_device_interpret=rung == "interpret"):
        assert ck.mode("cpu") == rung
        out = world.allreduce(torch.from_numpy(x.copy()), PREDEFINED_OPS[opname])
    assert _rows_differing(out, ref) == []
    assert (hop.calls, fold.calls) == ((N - 1, N - 1) if rung == "interpret" else (0, 0))


@pytest.mark.parametrize("name,opname,x,ref", ORDER_BOUND, ids=[c[0] for c in ORDER_BOUND])
def test_order_bound_cases_under_cuda_ring_equal_the_plain_ring(world, name, opname, x, ref):
    """Float SUM and PROD: the ring brackets the fold differently from
    the library's left fold, so ``cuda_ring`` (on the kernels' plain
    bodies) is held to the plain ring, bit for bit."""
    op = PREDEFINED_OPS[opname]
    xt = torch.from_numpy(x.copy())
    with pinned(coll_cuda_allreduce_algorithm=ALLREDUCE_ALGOS["cuda_ring"],
                dcn_device_interpret=True):
        got = world.allreduce(xt, op)
    with pinned(coll_cuda_allreduce_algorithm=ALLREDUCE_ALGOS["ring"]):
        plain = world.allreduce(xt, op)
    assert got.numpy().tobytes() == plain.numpy().tobytes()


@pytest.mark.parametrize("name,coll,opname,x,ref", SINGLES, ids=[c[0] for c in SINGLES])
def test_singleton_collective_bit_matches_reference(world, name, coll, opname, x, ref):
    out = getattr(tapi.comm_self(), coll)(torch.from_numpy(x[None].copy()),
                                          PREDEFINED_OPS[opname])
    assert out.shape == (1, x.shape[0]) and out.numpy().dtype == x.dtype
    assert out.numpy().tobytes() == ref


# -- diag_pp ------------------------------------------------------------------

RT_LINE = re.compile(r"PPDIAG rt_us min=\d+ p25=\d+ med=\d+ p75=\d+ p90=\d+ max=\d+")


def _diag(*flags, iters: int = 10) -> subprocess.CompletedProcess:
    env = dict(_env(), TPDIAG_ITERS=str(iters))
    return subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch", "run", "-np", "2", *flags, str(DIAG_PP)],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO))


def test_diag_pp_np2_on_the_cpu():
    res = _diag("--cpu")
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    lines = [ln for ln in res.stdout.splitlines() if "PPDIAG" in ln]
    assert len(lines) == 3 and all(ln.startswith("[0] PPDIAG ") for ln in lines), lines
    device, rt, hist = (ln[len("[0] "):] for ln in lines)
    assert device == "PPDIAG device=cpu bytes=1048576 iters=10"
    assert RT_LINE.fullmatch(rt), rt
    assert hist.startswith("PPDIAG hist_ms ")
    ms = hist.split()[2:]
    assert len(ms) == 10 and all(re.fullmatch(r"\d+\.\d\d", v) for v in ms), ms
    assert [float(v) for v in ms] == sorted(float(v) for v in ms)


def test_diag_pp_without_cpu_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise here")
    res = _diag()
    assert res.returncode != 0
    assert "no CUDA device" in res.stdout + res.stderr
    assert "PPDIAG" not in res.stdout

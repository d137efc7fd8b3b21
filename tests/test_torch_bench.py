"""The port's ``bench`` (``ompi_tpu_torch/tools/bench.py``) against the
reference's ``bench.py``, on the CPU.

``bench.py`` is loaded by path (nothing of it runs at import):

* the helpers (``_iters_for``, ``_BUS_FACTOR``, ``_row``, ``geomean``)
  give the reference's values on the same inputs, ``_row`` adding the
  quartiles; the sweep and suite size rules and ``measure_overlap``'s
  keys are the reference's;
* each raw primitive, on seeded numpy inputs over 8 ranks, gives what the
  reference's raw ``shard_map`` program gives on the 8 virtual CPU
  devices (the copies bit for bit, the two sums ``allclose``);
* ``bench --cpu --no-subproc`` beside ``bench.run(4096, 2, 2048, 4)``,
  each in a process of its own: the same top-level keys, the same sizes
  and iteration counts per row, the reference's row keys plus the port's,
  the same suite; the headline is the last line, under 1.5 kB, with the
  reference's keys plus ``device``, and no root ``BENCH_DETAIL.json`` is
  written;
* ``capi_rows``, ``capi_p2p_rows`` and ``osu_bw_sweep_rows`` give what
  ``bench.py``'s give on the same canned job output; the serve join, end
  to end at one run on the CPU, has ``serve_rows``'s keys;
* ``--check`` exits 1 on a planted wrong framework result and on a
  join's error; without a card and without ``--cpu`` the command raises
  and names the card;
* ``chip_smoke.py``'s bench-phase checks pass on the ``--cpu`` output
  plus canned join blocks and name each planted fault.
"""

import copy
import importlib.util
import json
import os
import queue
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
from ompi_tpu_torch.tools import bench as pb
from ompi_tpu_torch.tools import bench_hostpath as bh
from ompi_tpu_torch.tools import bench_joins as bj

REPO = Path(__file__).resolve().parents[1]
N = 8
CLI = ("--cpu", "--max-bytes", 4096, "--suite-max", 2048, "--iters", 2)


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench():
    """The reference's ``bench.py`` as a module (nothing of it runs)."""
    return _load("_ref_bench_port", REPO / "bench.py")


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + (":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.pop("OMPI_TPU_DEVICE", None)
    return env


def _start(*args, **extra) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *map(str, args)], cwd=str(REPO),
                            env=dict(_env(), **extra), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen, timeout: float = 240) -> tuple[int, str, str]:
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, out, err


# -- the helpers --------------------------------------------------------------------------


def _timings(seed: int, k: int = 9) -> tuple[list, list]:
    rng = np.random.default_rng(seed)
    return list(rng.uniform(1e-5, 3e-3, k)), list(rng.uniform(1e-5, 3e-3, k))


HELPER_CASES = {
    "iters_for": lambda ref: [
        (pb._iters_for(nb, it), ref._iters_for(nb, it))
        for nb in (8, 1 << 20, (1 << 20) + 1, 4 << 20, 8 << 20, 255 << 20, 256 << 20, 1 << 30)
        for it in (1, 2, 40, 200)],
    "bus_factor": lambda ref: [
        (list(pb._BUS_FACTOR), list(ref._BUS_FACTOR))] + [
        (pb._BUS_FACTOR[c](n), ref._BUS_FACTOR[c](n)) for c in ref._BUS_FACTOR
        for n in (1, 2, 3, 8)],
    "geomean": lambda ref: [(bj.geomean(r), ref._geomean(r))
                            for r in ([1.0], [0.5, 2.0, 4.0], [0.0, 1.3], [0.91, 0.87, 1.02])],
}


@pytest.mark.parametrize("case", list(HELPER_CASES))
def test_helpers_equal_reference(bench, case):
    for got, want in HELPER_CASES[case](bench):
        assert got == want


@pytest.mark.parametrize("n,coll,seed", [(1, "allreduce", 0), (8, "allreduce", 1),
                                         (8, "bcast", 2), (8, "reduce_scatter", 3),
                                         (2, "alltoall", 4), (8, "allgather", 5)])
def test_row_equals_reference_plus_quartiles(bench, n, coll, seed):
    t_fw, t_raw = _timings(seed)
    want = bench._row(4096, n, t_fw, t_raw, coll=coll)
    got = pb._row(4096, n, t_fw, t_raw, coll=coll)
    assert list(got) == list(want) + ["fw_us_p25", "fw_us_p75", "raw_us_p25", "raw_us_p75"]
    assert {k: got[k] for k in want} == want
    for side, t in (("fw", t_fw), ("raw", t_raw)):
        assert got[f"{side}_us_p25"] == round(float(np.percentile(t, 25)) * 1e6, 2)
        assert got[f"{side}_us_p25"] <= got[f"{side}_us_p50"] <= got[f"{side}_us_p75"]


def test_size_rules_and_overlap_estimator():
    """The reference's sweep (8 B up, the ceiling appended) and suite
    (64 B up in ×32) rules; the overlap estimator is the port's shared
    copy of ``bench.measure_overlap`` (its keys are held to the
    reference's in ``test_torch_bench_tools.py``)."""
    assert pb.sweep_sizes(1 << 30, 4) == [8 << (2 * i) for i in range(14)] + [1 << 30]
    assert pb.sweep_sizes(4096, 4) == [8, 32, 128, 512, 2048, 4096]
    assert pb.sweep_sizes(1000, 3) == [8, 24, 72, 216, 648, 1000]
    assert pb.sweep_sizes(8, 2) == [8]
    assert pb.suite_sizes(4 << 20) == [64, 2048, 65536, 2097152]
    assert pb.suite_sizes(63) == []
    assert pb.measure_overlap is bh.measure_overlap


# -- the raw primitives -------------------------------------------------------------------


def _ref_raw(name: str, devices):
    """The reference's raw program (``bench.py:239-252``) over the 8
    virtual CPU devices."""
    mesh = jax.sharding.Mesh(np.array(devices[:N]), (AXIS,))

    def spmd(fn):
        return jax.jit(shard_map(fn, mesh=mesh, in_specs=P(AXIS), out_specs=P(AXIS)))

    return {
        "allreduce": spmd(lambda v: jax.lax.psum(v, AXIS)),
        "bcast": spmd(lambda v: jax.lax.all_gather(v[:1], AXIS)[0:1, 0]),
        "allgather": spmd(lambda v: jax.lax.all_gather(v, AXIS).reshape(1, -1)),
        "reduce_scatter": spmd(lambda v: jax.lax.psum_scatter(
            v[0], AXIS, scatter_dimension=0, tiled=True)[None]),
        "alltoall": spmd(lambda v: jax.lax.all_to_all(
            v, AXIS, split_axis=1, concat_axis=0).reshape(1, -1)),
    }[name]


@pytest.mark.parametrize("name", list(pb.RAW))
@pytest.mark.parametrize("nbytes", [64, 2048, 65536])
def test_raw_primitive_equals_reference(devices, name, nbytes):
    count = max(1, nbytes // 4)
    shape = (N, N, max(1, count // N)) if name in ("reduce_scatter", "alltoall") else (N, count)
    host = np.random.default_rng(nbytes).standard_normal(shape, dtype=np.float32)
    want = np.asarray(_ref_raw(name, devices)(host))
    got = pb.RAW[name][1](torch.from_numpy(host)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if name in pb.EXACT:
        assert got.tobytes() == want.tobytes()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(pb.RAW))
def test_compare_holds_each_primitive_and_catches_one_wrong_element(name):
    shape = (N, N, 5) if name in ("reduce_scatter", "alltoall") else (N, 40)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(shape, dtype=np.float32))
    want = pb.RAW[name][1](x)
    right = want.clone()
    if name not in pb.EXACT:  # the same sum in another order stays within the bound
        right = torch.flip(x, [0]).sum(0, keepdim=name == "allreduce")
        right = (right.expand_as(want) if name == "allreduce" else right.unsqueeze(1))
    assert pb.compare(name, 160, right, want, x)["ok"]
    wrong = want.clone()
    wrong.view(-1)[3] = torch.nextafter(wrong.view(-1)[3], torch.tensor(np.inf)) + 1e-3
    row = pb.compare(name, 160, wrong, want, x)
    assert not row["ok"] and row["max_abs_err"] > 0


# -- run() beside the reference's -----------------------------------------------------------

REF_RUN = r"""
import importlib.util, json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
spec = importlib.util.spec_from_file_location("_ref_bench", sys.argv[1])
b = importlib.util.module_from_spec(spec)
spec.loader.exec_module(b)
print("REFRUN " + json.dumps(b.run(4096, 2, 2048, 4)), flush=True)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``bench --cpu --no-subproc --check`` and the reference's
    ``run(4096, 2, 2048, 4)``, side by side in processes of their own."""
    tmp = tmp_path_factory.mktemp("bench")
    root = REPO / "BENCH_DETAIL.json"
    root_before = root.stat().st_mtime_ns if root.exists() else None
    ref = _start("-c", REF_RUN, REPO / "bench.py", JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=8")
    port = _start("-m", "ompi_tpu_torch", "bench", *CLI, "--no-subproc", "--check",
                  "--out", tmp / "detail.json")
    rc_ref, ref_out, ref_err = _finish(ref)
    rc, out, err = _finish(port)
    assert rc_ref == 0, ref_out[-3000:] + ref_err[-3000:]
    assert rc == 0, out[-3000:] + err[-3000:]
    root_after = root.stat().st_mtime_ns if root.exists() else None
    return {"ref": bj.marked(ref_out, "REFRUN"), "out": out,
            "detail": json.loads((tmp / "detail.json").read_text()),
            "root_untouched": root_before == root_after}


def test_run_structure_equals_reference(runs):
    want, got = runs["ref"], runs["detail"]
    assert [k for k in got if k in want] == list(want)
    port_rows = ["fw_us_p25", "fw_us_p75", "raw_us_p25", "raw_us_p75", "input", "launches"]
    assert [(r["bytes"], r["iters"]) for r in got["sizes"]] == \
        [(r["bytes"], r["iters"]) for r in want["sizes"]]
    assert [list(r) for r in got["sizes"]] == [list(r) + port_rows for r in want["sizes"]]
    assert list(got["colls"]) == list(want["colls"])
    for name, rows in want["colls"].items():
        assert [(r["bytes"], r["iters"]) for r in got["colls"][name]] == \
            [(r["bytes"], r["iters"]) for r in rows]
        assert [list(r) for r in got["colls"][name]] == [list(r) + port_rows for r in rows]
    for key in ("barrier", "persistent", "gather_scatter", "overlap"):
        assert list(got[key]) == list(want[key]), key
    assert [list(r) for r in got["hostpath"]] == [list(r) for r in want["hostpath"]]
    assert [r["bytes"] for r in got["hostpath"]] == [r["bytes"] for r in want["hostpath"]]
    assert list(got["arena"]) == list(want["arena"])
    for k in ("stage_calls", "stage_bytes"):
        assert got["arena"][k] > 0, k
    assert got["n_ranks"] == want["n_ranks"] == N
    assert got["raw"] == {k: text for k, (text, _fn) in pb.RAW.items()}
    assert got["launches"] == {"ring_hop": 0, "ring_hop_fold": 0, "ring_hop_peer": 0,
                               "ring_hop_wait": 0}
    assert all(r["input"] == "numpy default_rng(0).standard_normal" for r in got["sizes"])


def test_check_block_and_headline_contract(runs):
    detail, out = runs["detail"], runs["out"]
    chk = detail["check"]
    assert chk["ok"] and chk["failed_joins"] == []
    assert [(c["coll"], c["bytes"]) for c in chk["rows"]] == (
        [("allreduce", r["bytes"]) for r in detail["sizes"]]
        + [(name, r["bytes"]) for name, rows in detail["colls"].items() for r in rows]
        + [("allreduce_host", r["bytes"]) for r in detail["hostpath"]])
    assert all(c["exact"] == (c["coll"] in pb.EXACT) for c in chk["rows"])
    last = out.strip().splitlines()[-1]
    head = json.loads(last)
    assert len(last.encode()) < 1500
    ref_keys = ["metric", "value", "unit", "vs_baseline", "n_ranks", "platform", "max_bytes",
                "min_size_ratio", "min_size_ratio_bytes", "suite_min_ratio",
                "overlap_saving_pct", "detail_file"]
    assert list(head) == ref_keys + ["device"]
    assert head["metric"] == "osu_allreduce_latency_ratio_vs_raw_psum"
    assert (head["platform"], head["device"], head["max_bytes"]) == ("cpu", "cpu", 4096)
    assert head["value"] == round(detail["geomean"], 4)
    assert runs["root_untouched"]
    assert pb.DETAIL_FILE == REPO / "build" / "ompi_tpu_torch" / "BENCH_DETAIL.json"


# -- the joins on fixed job output ----------------------------------------------------------


class _Fake:
    """Canned job output by (target name, np, mca), as a ``Jobs`` for the
    port and as ``_run_tpurun`` for ``bench.py``."""

    cpu = True

    def __init__(self, canned: dict):
        self.canned = canned
        self.calls = []
        self.launches = dict.fromkeys(bj.KERNELS, 0)

    def text(self, np_, target, mca=None) -> str:
        key = (Path(target).name, np_, tuple(sorted((mca or {}).items())))
        self.calls.append(key)
        return self.canned[key]

    def __call__(self, np_, target, args=(), timeout=300, mca=None):
        return self.text(np_, target, mca)

    def c_job(self, np_, binary, args=(), timeout=300):
        return self.text(np_, binary)

    def run_tpurun(self, np_, target, args=None, timeout=300, mca=None):
        return self.text(np_, target, mca)


def _osu_table(title: str, sizes, values) -> str:
    return (f"[0] # OSU MPI {title}\n[0] # Size  Value\n"
            + "".join(f"[0] {s}  {v}\n" for s, v in zip(sizes, values)))


def _joins_canned(port: bool) -> dict:
    rng = np.random.default_rng(26)
    sizes = [4 << (2 * i) for i in range(6)]
    py = [{"bytes": s, "py_us": float(rng.uniform(20, 90))} for s in sizes[:-1]]
    sweep_rows = []
    for i, s in enumerate((65536, 1 << 20, 16 << 20)):
        sweep_rows.append({"bytes": s, "win_MBs": 900.0 + i, "unwin_MBs": [800.0, 0.0, 1e3][i],
                           "win_counters": {"doorbells": [7, 0, 3][i],
                                            "doorbells_suppressed": [5, 0, 9][i]}})
    return {
        ("bench_osu_allreduce", 1, ()): _osu_table(
            "Allreduce Latency Test", sizes, np.round(rng.uniform(1, 9, 6), 2)),
        ("bench_pyapi.py", 1, ()): (
            "[0] PYAPI device=cpu max_bytes=4096 iters=400\n" * port
            + f"[0] PYAPI {json.dumps(py)}\n" + "[0] LAUNCHES {}\n" * port),
        ("osu_latency", 2, ()): _osu_table("Latency Test", [0, 1, 65536], [3.1, 3.2, 40.5]),
        ("osu_bw", 2, ()): _osu_table("Bandwidth Test", [1, 4 << 20], [0.5, 9000.25]),
        ("osu_bw_sweep", 2, ()): "[1] done\n[0] SWEEP " + json.dumps(
            {"window": 64, "batches": 4, "rows": sweep_rows}) + "\n",
    }


def _patch_compilers(monkeypatch):
    from ompi_tpu import native as ref_native
    from ompi_tpu_torch import native as port_native

    monkeypatch.setattr(ref_native, "compile_mpi_program", lambda *a, **k: None)
    monkeypatch.setattr(ref_native, "build", lambda *a, **k: None)
    monkeypatch.setattr(port_native, "compile_mpi_program",
                        lambda src, out=None, *a, **k: out)


JOIN_CASES = {
    "capi": ("capi_rows", "capi_rows"),
    "capi_p2p": ("capi_p2p_rows", "capi_p2p_rows"),
    "osu_bw_sweep": ("osu_bw_sweep_rows", "osu_bw_sweep_rows"),
}


@pytest.mark.parametrize("case", list(JOIN_CASES))
def test_c_joins_equal_bench_rows(bench, monkeypatch, case):
    ref_name, port_name = JOIN_CASES[case]
    _patch_compilers(monkeypatch)
    fake = _Fake(_joins_canned(port=False))
    monkeypatch.setattr(bench, "_run_tpurun", fake.run_tpurun)
    want = getattr(bench, ref_name)()
    port = _Fake(_joins_canned(port=True))
    got = getattr(pb, port_name)(port)
    assert port.calls == fake.calls  # the same programs, np and order
    if case == "capi":
        assert got.pop("py_device") == "cpu"
        assert [r["bytes"] for r in got["rows"]] == [4 << (2 * i) for i in range(6)]
        assert "py_us" not in got["rows"][-1]  # no Python twin: no overhead
    if case == "osu_bw_sweep":
        assert got["rows"][1]["win_over_unwin"] is None
        assert got["rows"][1]["win_doorbell_suppression"] is None
    assert got == want


class _FakeTpud:
    """A ``tpud`` whose output is fed by the fake client's submissions."""

    def __init__(self, text: bool):
        self.q = queue.Queue()
        self.text = text
        self.pid = os.getpid()
        self.rc = None
        self.stdout = self
        self.put("[tpud] ops: http://127.0.0.1:1/jobs (submit: ...)\n")

    def put(self, line: str) -> None:
        self.q.put(line if self.text else line.encode())

    def readline(self):
        return self.q.get()

    def poll(self):
        return self.rc

    def wait(self, timeout=None):
        self.rc = 0
        self.put("")  # ends the reader
        return 0


def _firstcoll(p: int, device: str = "cpu") -> str:
    return f"[{p}] FIRSTCOLL ns={time.time_ns() + 1000} proc={p} size=2 device={device}\n"


def test_serve_rows_keys_on_canned_stamps_and_end_to_end(bench, monkeypatch):
    """The reference's ``serve_rows`` on canned stamps gives the keys; the
    port's serve join runs end to end on the CPU at one run each and has
    them plus ``device``."""
    import ompi_tpu.serve.client as ref_client

    tpud = _FakeTpud(text=False)
    monkeypatch.setattr(bench, "_run_tpurun",
                        lambda *a, **k: _firstcoll(0) + _firstcoll(1))
    monkeypatch.setattr(bench.subprocess, "Popen", lambda *a, **k: tpud)

    def submit(url, job):
        for p in (0, 1):
            tpud.put(_firstcoll(p))
        return {"id": "j"}

    monkeypatch.setattr(ref_client, "submit", submit)
    monkeypatch.setattr(ref_client, "wait", lambda *a, **k: {"state": "done"})
    monkeypatch.setattr(ref_client, "shutdown", lambda url: {})
    want = bench.serve_rows(runs=1)
    monkeypatch.undo()

    jobs = bj.Jobs(cpu=True)
    t0 = time.perf_counter()
    got = pb.serve_rows(jobs, runs=1)
    wall = time.perf_counter() - t0
    assert list(got) == list(want) + ["device"], wall
    assert got["device"] == {"cold": ["cpu"], "warm": ["cpu"]}
    assert got["runs"] == 1 and len(got["cold_us_all"]) == len(got["warm_us_all"]) == 1
    assert got["cold_submit_to_first_coll_us"] > 0 and got["warm_submit_to_first_coll_us"] > 0
    assert all(v == 0 for v in jobs.launches.values())


# -- --check and the card -------------------------------------------------------------------

PLANTED = {
    "wrong_result": (
        "import torch\n"
        "from ompi_tpu_torch.api.comm import Comm\n"
        "orig = Comm.allreduce\n"
        "def wrong(self, x, op=None):\n"
        "    out = orig(self, x) if op is None else orig(self, x, op)\n"
        "    if isinstance(out, torch.Tensor) and out.numel() > 1:\n"
        "        out = out.clone(); out.view(-1)[1] += 1.0\n"
        "    return out\n"
        "Comm.allreduce = wrong\n",
        ["--no-subproc"]),
    "join_error": (
        "def boom(jobs, args):\n"
        "    raise RuntimeError('planted join failure')\n"
        "bench.JOINS = (('dcn', boom),)\n",
        []),
}


@pytest.mark.parametrize("case", list(PLANTED))
def test_check_exits_1_on_a_planted_fault(tmp_path, case):
    code, flags = PLANTED[case]
    driver = ("import sys\nfrom ompi_tpu_torch.tools import bench\n" + code
              + "sys.exit(bench.main(sys.argv[1:]))\n")
    rc, out, err = _finish(_start("-c", driver, "--cpu", "--max-bytes", 64, "--suite-max", 64,
                                  "--iters", 1, "--check", "--out", tmp_path / "d.json",
                                  *flags))
    assert rc == 1, out[-3000:] + err[-3000:]
    head = json.loads(out.strip().splitlines()[-1])  # the headline still comes last
    assert head["metric"] == "osu_allreduce_latency_ratio_vs_raw_psum"
    chk = json.loads((tmp_path / "d.json").read_text())["check"]
    assert not chk["ok"]
    if case == "wrong_result":
        bad = [(c["coll"], c["bytes"]) for c in chk["rows"] if not c["ok"]]
        assert bad == [("allreduce", b) for b in (8, 32, 64)] and chk["failed_joins"] == []
    else:
        assert chk["failed_joins"] == ["dcn"] and all(c["ok"] for c in chk["rows"])
        detail = json.loads((tmp_path / "d.json").read_text())
        assert detail["dcn"]["error"].startswith("RuntimeError: planted join failure")


def test_bench_raises_without_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench runs on it")
    rc, out, err = _finish(_start("-m", "ompi_tpu_torch", "bench", "--no-subproc",
                                  "--max-bytes", 8, "--out", tmp_path / "d.json"))
    assert rc != 0 and "no CUDA device" in out + err
    assert "osu_allreduce_latency_ratio_vs_raw_psum" not in out
    assert not (tmp_path / "d.json").exists()


# -- chip_smoke.py's bench phase checks -------------------------------------------------------


@pytest.fixture(scope="module")
def chip_smoke():
    return _load("_chip_smoke_bench", REPO / "chip_smoke.py")


def _canned_joins(cs, device: str = "cpu") -> dict:
    """Join blocks of the shape the nine joins write, every worker on
    ``device``."""
    cuda = device.startswith("cuda")
    zero = dict.fromkeys(bj.KERNELS, 0)
    dispatch = {np_: {"rows": [dict(op=op, bytes=b, c_us=1.0, py_us=50.0, c_over_py=0.02)
                               for op, b in cs.DISPATCH_ROWS],
                      "persistent": dict.fromkeys(cs.PERSISTENT_KEYS, 1.0),
                      "c_over_py_max": 0.02, "c_over_py_geomean": 0.02, "py_device": device}
                for np_ in ("np1", "np2")}
    return {
        "dcn": {b: {"p2p": [], "han": [], "device": device} for b in ("native", "tcp", "sm")}
        | {"launches": zero},
        "capi": {"np": 1, "iters": 400, "py_device": device, "launches": zero,
                 "rows": [{"bytes": b, "c_us": 2.0, "py_us": 40.0, "shim_overhead_us": -38.0}
                          for b in cs.PYAPI_SIZES], "c_cuda_initialized": [cuda]},
        "capi_p2p": {"osu_latency": [], "osu_bw": [], "c_cuda_initialized": [cuda] * 4,
                     "launches": zero},
        "osu_bw_sweep": {"rows": [], "c_cuda_initialized": [cuda] * 2, "launches": zero},
        "dispatch_floor": dispatch | {"c_cuda_initialized": [cuda] * 3, "launches": zero},
        "device_plane": {"rows": [], "device": {"device": device, "host": device},
                         "buffer": {"device": device, "host": device}, "launches": zero},
        "algos_cpu8": {"device": device, "check": {"ok": True, "device": device}},
        "hostpath_cpu8": {"device": device, "arena": {"stage_calls": 67},
                          "check": {"ok": True, "stage_calls": 67, "calls": 67}},
        "serve": {"runs": 1, "device": {"cold": [device], "warm": [device]}},
    }


FAULTS = {
    "none": (lambda d, out: (d, out), []),
    "sweep_row_missing": (lambda d, out: (d | {"sizes": d["sizes"][:-1]}, out),
                          ["sweep sizes"]),
    "suite_coll_missing": (lambda d, out: (d | {"colls": {k: v for k, v in d["colls"].items()
                                                          if k != "alltoall"}}, out),
                           ["suite sizes"]),
    "check_failed": (lambda d, out: (d | {"check": {"ok": False}}, out), ["check"]),
    "headline_not_last": (lambda d, out: (d, out + "trailing\n"),
                          ["headline not the last line"]),
    "join_error": (lambda d, out: (d | {"serve": {"error": "RuntimeError: x"}}, out),
                   ["joins ['serve']"]),
    "c_rank_without_cuda": (
        lambda d, out: (d | {"capi_p2p": d["capi_p2p"] | {"c_cuda_initialized": [False]}},
                        out), ["capi_p2p C ranks' CUDA"]),
    "pyapi_size_missing": (
        lambda d, out: (d | {"capi": d["capi"] | {"rows": d["capi"]["rows"][:-1]}}, out),
        ["pyapi"]),
    "dispatch_row_unjoined": (
        lambda d, out: (d | {"dispatch_floor": d["dispatch_floor"] | {"np2": d[
            "dispatch_floor"]["np2"] | {"rows": [{"op": "barrier", "bytes": 0}]}}}, out),
        ["dispatch_floor np2"]),
    "dcn_btl_missing": (lambda d, out: (d | {"dcn": {k: v for k, v in d["dcn"].items()
                                                     if k != "sm"}}, out), ["dcn"]),
    "hostpath_staging_uncounted": (
        lambda d, out: (d | {"hostpath_cpu8": d["hostpath_cpu8"] | {"arena": {
            "stage_calls": 66}}}, out), ["hostpath"]),
    "serve_elsewhere": (lambda d, out: (d | {"serve": {"device": {"cold": ["cuda:0"],
                                                                   "warm": ["cpu"]}}}, out),
                        ["serve"]),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_chip_smoke_bench_checks_read_the_detail(runs, chip_smoke, fault):
    """The phase's checks on the ``--cpu --no-subproc`` output plus canned
    join blocks: clean, they pass; each planted fault is named."""
    detail = copy.deepcopy(runs["detail"]) | _canned_joins(chip_smoke)
    plant, want = FAULTS[fault]
    detail, out = plant(detail, runs["out"])
    got = chip_smoke.bench_failures(detail, out, device="cpu", sweep=[8, 32, 128, 512, 2048, 4096],
                                    suite=[64, 2048])
    assert got == want


@pytest.mark.parametrize("lanes", [1, 3])
def test_joins_in_lanes_keep_order_and_run_serve_alone_last(monkeypatch, lanes):
    events = []

    def join(name, sleep):
        def fn(jobs, args):
            events.append(("start", name))
            time.sleep(sleep)
            events.append(("end", name))
            if name == "b":
                raise RuntimeError("b failed")
            return {"name": name}
        return fn

    monkeypatch.setattr(pb, "JOINS", (("a", join("a", 1.0)), ("b", join("b", 0.1)),
                                      ("c", join("c", 0.1)), ("serve", join("serve", 0.01))))
    from types import SimpleNamespace

    out = pb.run_joins(SimpleNamespace(lanes=lanes, cpu=True))
    assert list(out) == ["a", "b", "c", "serve"]
    assert out["b"][0] == {"error": "RuntimeError: b failed"}
    assert [out[k][0] for k in "ac"] == [{"name": "a"}, {"name": "c"}]
    assert all(isinstance(out[k][1], bj.Jobs) and out[k][2] > 0 for k in out)
    assert events[-2:] == [("start", "serve"), ("end", "serve")]
    if lanes == 1:  # one after another, in the reference's order
        assert events[:6] == [(e, n) for n in "abc" for e in ("start", "end")]
    else:  # b and c run while a does
        assert all(events.index(("start", n)) < events.index(("end", "a")) for n in "bc")

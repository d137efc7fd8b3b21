"""The port's DCN device plane (``ompi_tpu_torch/dcn/device.py``) against
the reference's (``ompi_tpu/dcn/device.py``), case by case after
``tests/test_device_plane.py`` (the Pallas-ring cases there have their
port in ``tests/test_torch_coll.py``; the C-ABI cases wait for the
port's C ABI).

* Units run the same scenario, on the same seeded numpy inputs, through
  both packages' ``DevicePlane`` and compare what comes out: the
  arbitration decisions and counters (threshold, layout, reachability,
  the fail-closed host map, the MCA overrides), the window semaphore
  ordering and its deadline, and stage/receive/reap with the
  descriptors (less the window name, which carries the pid).
* Windows cross the packages: a port window is read by the reference's
  ``receive`` and a reference window by the port's, bit for bit.
* Tensors (port only): a CPU tensor rides the reference's shm window
  with the descriptor a numpy array of the same bytes gets (bfloat16
  as ``"<V2"``), a posted tensor receives in place, and the DCN
  engine's ring and ordered fold take tensors and give the numpy
  fold's bits (f32 SUM/PROD/MAX, f64 SUM; bfloat16 SUM against the
  host fold of the raw words).  A CUDA window needs the card; without
  its library the plane raises instead of falling back.
* A mixed pair of native engines — one reference, one port — with the
  plane on in both: the ring's chunks cross the packages in shm windows
  and give the all-reference pair's bits.
* np=2 launched jobs (one rank per process, so the DCN leg is the whole
  fold): with a 4 KiB ``dcn_device_min_size`` han's allreduce and bcast
  ride the plane in both packages; the port's results are bit-equal to
  the reference's and to its own plane-off job, and its counters show
  the plane carried the large payloads and nothing fell back.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from ompi_tpu.core.errors import DeadlineExpiredError as RDeadline
from ompi_tpu.dcn import collops as rcollops
from ompi_tpu.dcn import device as rdev
from ompi_tpu.dcn import native as rnative
from ompi_tpu.op import op as rop
from ompi_tpu_torch.core.errors import DeadlineExpiredError as PDeadline
from ompi_tpu_torch.dcn import collops as pcollops
from ompi_tpu_torch.dcn import device as pdev
from ompi_tpu_torch.dcn import native as pnative
from ompi_tpu_torch.op import op as pop
from torch_mp_common import PRELUDE, run_job

DEV = {"ref": rdev, "port": pdev}
PKGS = ("ref", "port")


def _plane(pkg, min_size=1 << 20, hosts=None, proc=0):
    return DEV[pkg].DevicePlane(proc, min_size=min_size, hosts=hosts)


def _strip(desc):
    return {k: v for k, v in desc.items() if k != "w"}


# -- arbitration -------------------------------------------------------------


def _threshold(pkg):
    dp = _plane(pkg, min_size=1 << 20)
    got = (dp.arbitrate(np.zeros(1 << 20, np.uint8)),
           dp.arbitrate(np.zeros((1 << 20) - 1, np.uint8)))
    dp.close()
    return got, dict(dp.stats)


def test_arbitration_threshold_boundary_matches_reference():
    ref, port = _threshold("ref"), _threshold("port")
    assert port == ref
    assert port[0] == (True, False)      # exactly at the threshold goes device
    assert port[1]["device_arb_device"] == 1 and port[1]["device_arb_host"] == 1


def _layout(pkg):
    dp = _plane(pkg, min_size=1 << 10)
    contig = np.zeros((64, 64), np.float64)
    got = [dp.arbitrate(contig), dp.arbitrate(contig[:, ::2]), dp.arbitrate(contig.T),
           dp.arbitrate(np.empty(4096, dtype=object)), dp.arbitrate([1.0] * 4096)]
    dp.close()
    return got, dict(dp.stats)


def test_arbitration_layout_gates_match_reference():
    ref, port = _layout("ref"), _layout("port")
    assert port == ref
    assert port[0] == [True, False, False, False, False]


def test_arbitration_takes_contiguous_tensors():
    """The port's addition: a contiguous CPU tensor at the threshold is
    eligible; a strided view, a meta tensor and one byte under are not."""
    dp = _plane("port", min_size=1 << 12)
    t = torch.zeros((64, 16), dtype=torch.float32)           # 4 KiB
    assert dp.arbitrate(t)
    assert not dp.arbitrate(t[:, ::2])
    assert not dp.arbitrate(t.T)
    assert not dp.arbitrate(torch.zeros(1023, dtype=torch.float32))
    assert not dp.arbitrate(torch.zeros(4096, device="meta"))
    assert dp.stats["device_arb_device"] == 1 and dp.stats["device_arb_host"] == 4
    dp.close()


def _reach(pkg):
    dp = _plane(pkg, min_size=1 << 10, hosts=[0, 0, 1], proc=0)
    big = np.zeros(1 << 12, np.float64)
    got = [dp.arbitrate(big, 1), dp.arbitrate(big, 2), dp.arbitrate(big, 7),
           dp.arbitrate(big, None)]
    dp.close()
    return got


def test_arbitration_reachability_host_map_matches_reference():
    assert _reach("port") == _reach("ref") == [True, False, False, True]


@pytest.mark.parametrize("raw,plane", [("0,zebra", None), ("0,0,1", None),
                                       ("0,1", [0, 1]), (None, "nomap")])
def test_maybe_create_fails_closed_on_bad_host_map(monkeypatch, raw, plane):
    """A present host map that cannot be trusted turns the plane off in
    both packages; a trustworthy one is kept; an absent one is one host."""
    if raw is None:
        monkeypatch.delenv("OMPI_TPU_HOST_IDS", raising=False)
    else:
        monkeypatch.setenv("OMPI_TPU_HOST_IDS", raw)
    for pkg in PKGS:
        dp = DEV[pkg].maybe_create(0, 2)
        if plane is None:
            assert dp is None, pkg
        else:
            assert dp is not None, pkg
            assert dp.hosts == (None if plane == "nomap" else plane), pkg
            dp.close()


def test_device_tuning_mca_override(monkeypatch):
    """``--mca dcn_device_min_size``/``dcn_device_enable`` reach both
    planes through their central DEVICE_VARS registration."""
    from ompi_tpu.core import mca as rmca
    from ompi_tpu.core.registry import MCAContext as RCtx
    from ompi_tpu_torch.core import mca as pmca
    from ompi_tpu_torch.core.registry import MCAContext as PCtx

    ctxs = {"ref": (rmca, RCtx), "port": (pmca, PCtx)}
    for pkg, (m, ctx_cls) in ctxs.items():
        ctx = ctx_cls(cmdline={"dcn_device_min_size": "2048", "dcn_device_enable": "1"})
        monkeypatch.setattr(m, "default_context", lambda c=ctx: c)
        assert DEV[pkg].device_tuning() == (True, 2048, False), pkg
        dp = DEV[pkg].maybe_create(0, 2)
        assert dp is not None and dp.min_size == 2048
        assert dp.arbitrate(np.zeros(2048, np.uint8))
        assert not dp.arbitrate(np.zeros(2047, np.uint8))
        dp.close()
        off = ctx_cls(cmdline={"dcn_device_enable": "0"})
        monkeypatch.setattr(m, "default_context", lambda c=off: c)
        assert DEV[pkg].maybe_create(0, 2) is None, pkg


def test_device_vars_registered_like_the_reference():
    from ompi_tpu.core import var as rvar
    from ompi_tpu_torch.core import var as pvar

    def rows(v):
        return [(fw, comp, name, default, typ) for fw, comp, name, default, typ, _h
                in v.DEVICE_VARS]

    assert rows(pvar) == rows(rvar)

    def plane_rows(v):
        return sorted((v.full_var_name(fw, c, n), d, t) for fw, c, n, d, t, _h
                      in v.ROBUSTNESS_VARS if n.startswith("plane_"))

    assert plane_rows(pvar) == plane_rows(rvar) == [
        ("dcn_plane_heal_interval", 5.0, "float"), ("dcn_plane_strikes", 3, "int")]
    assert pdev.plane_tuning() == rdev.plane_tuning() == (3, 5.0)


# -- the window protocol -------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_window_semaphore_orders_read_after_dma(pkg):
    """The recv-semaphore wait blocks until the completion signal — the
    descriptor may outrun the DMA and the read must not."""
    dev = DEV[pkg]
    dp = _plane(pkg, min_size=1)
    src = np.arange(1 << 12, dtype=np.float64)
    name = f"tpudev-test-{pkg}-{next(dp._wids)}"
    win = dev.DeviceWindow(name, src.nbytes, create=True)
    desc = {"w": name, "n": src.nbytes, "dt": src.dtype.str, "sh": list(src.shape)}
    got = {}
    t = threading.Thread(target=lambda: got.update(out=dev.receive(desc, stats=dp.stats)))
    t.start()
    time.sleep(0.15)
    assert t.is_alive()                       # parked on SEM_EMPTY
    win.place(memoryview(src).cast("B"))      # the DMA lands and signals
    t.join(timeout=10)
    assert not t.is_alive()
    np.testing.assert_array_equal(got["out"], src)
    assert dp.stats["device_dma_waits"] == 1 and dp.stats["device_dma_wait_ns"] > 0
    assert win.sem() == dev.SEM_CONSUMED
    win.close(unlink=True)
    dp.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_window_wait_deadline_escalates(pkg):
    from ompi_tpu.core.var import Deadline as RD
    from ompi_tpu_torch.core.var import Deadline as PD

    dev = DEV[pkg]
    win = dev.DeviceWindow(f"tpudev-test-dl-{pkg}", 64, create=True)
    with pytest.raises(PDeadline if pkg == "port" else RDeadline):
        win.wait_data((PD if pkg == "port" else RD)(0.05))
    win.close(unlink=True)


def _roundtrip(pkg):
    dev = DEV[pkg]
    dp = _plane(pkg, min_size=1)
    src = np.random.RandomState(0).randn(1 << 10).astype(np.float64)
    desc = dp.stage(src)
    rec = {"desc": _strip(desc), "stats_staged": dict(dp.stats),
           "pending": dp.pending_windows()}
    into = np.empty_like(src)
    out = dev.receive(desc, into=into, stats=dp.stats)
    rec["placed"] = out is into and np.array_equal(out, src)
    rec["reaped"] = dp.reap()
    desc2 = dp.stage(src)
    wrong = np.empty(8, np.float32)
    out2 = dev.receive(desc2, into=wrong, stats=dp.stats)
    rec["fresh"] = out2 is not wrong and np.array_equal(out2, src)
    dp.close()
    rec["stats"] = dict(dp.stats)
    rec["left"] = dp.pending_windows()
    return rec


def test_stage_receive_roundtrip_and_reap_matches_reference():
    ref, port = _roundtrip("ref"), _roundtrip("port")
    assert port == ref
    assert port["desc"] == {"n": 8192, "dt": "<f8", "sh": [1024]}
    assert port["placed"] and port["fresh"] and port["reaped"] == 1
    assert port["stats"]["device_sends"] == 2 and port["stats"]["device_recvs"] == 2
    assert port["left"] == 0


@pytest.mark.parametrize("sender,receiver", [("port", "ref"), ("ref", "port")])
def test_windows_cross_the_packages(sender, receiver):
    """The window format is the reference's: each package reads the
    other's windows, and the sender's reap sees the consumed signal."""
    rng = np.random.default_rng(5)
    src = rng.standard_normal((64, 33)).astype(np.float32)
    dp = _plane(sender, min_size=1)
    desc = dp.stage(src, dst_proc=1)
    got = DEV[receiver].receive(desc)
    assert got.dtype == src.dtype and got.tobytes() == src.tobytes()
    assert dp.reap() == 1
    dp.close()


def test_cpu_tensor_rides_the_reference_window():
    """A CPU tensor stages as the numpy array of its bytes would (same
    descriptor; bfloat16 as ``"<V2"``): the reference reads the f32
    window, and a posted tensor receives in place."""
    rng = np.random.default_rng(9)
    a = rng.standard_normal(4096).astype(np.float32)
    dp = _plane("port", min_size=1)
    d_np, d_t = dp.stage(a), dp.stage(torch.from_numpy(a.copy()))
    assert _strip(d_np) == _strip(d_t) == {"n": a.nbytes, "dt": "<f4", "sh": [4096]}
    assert rdev.receive(d_t).tobytes() == a.tobytes()
    pdev.receive(d_np)
    bf = torch.from_numpy(a).to(torch.bfloat16)
    d_bf = dp.stage(bf)
    assert _strip(d_bf) == {"n": 8192, "dt": "<V2", "sh": [4096]}
    into = torch.empty_like(bf)
    out = pdev.receive(d_bf, into=into, stats=dp.stats)
    assert out is into and torch.equal(out.view(torch.int16), bf.view(torch.int16))
    dp.reap()   # (each stage reaps what was consumed before it)
    assert dp.pending_windows() == 0 and dp.stats["device_recvs"] == 1
    dp.close()


def test_cuda_window_raises_without_its_library(monkeypatch):
    """No quiet fallback: where the window library cannot be built (no
    nvcc here), opening a CUDA window raises DeviceWindowError — and a
    CUDA descriptor is never materialized on the host."""
    from ompi_tpu_torch import native

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the window library builds there")
    monkeypatch.setattr(native, "nvcc", lambda: (_ for _ in ()).throw(
        native.NativeBuildError("nvcc not found")))
    monkeypatch.setattr(pdev, "_cuda", None)
    with pytest.raises(pdev.DeviceWindowError, match="library unavailable"):
        pdev.CudaWindow("tpudev-test-nolib", 4096, 0)
    win = pdev.DeviceWindow("tpudev-test-cudadesc", 0, create=True)
    win.place(memoryview(b""))
    win._ctr[1] = 16
    try:
        with pytest.raises(pdev.DeviceWindowError):
            pdev.receive({"w": win.name, "n": 16, "dt": "<f4", "sh": [4],
                          pdev.KIND_KEY: pdev.KIND_CUDA, pdev.IPC_KEY: "00" * 64})
    finally:
        win.close(unlink=True)


# -- the DCN engine's schedule on tensors ---------------------------------------


def _pair(pkg_collops, n=2):
    engines = [pkg_collops.DcnCollEngine(p, n) for p in range(n)]
    addrs = [e.address for e in engines]
    for e in engines:
        e.set_addresses(addrs)
    return engines


def _in_threads(engines, fn):
    out, errs = {}, []

    def run(p):
        try:
            out[p] = fn(p, engines[p])
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(p,)) for p in range(len(engines))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not errs, errs
    return out


@pytest.fixture
def small_min_size():
    from ompi_tpu_torch.core import mca

    store = mca.default_context().store
    old = store.get("dcn_device_min_size")
    store.set("dcn_device_min_size", 4096)
    yield
    store.set("dcn_device_min_size", old)


@pytest.mark.parametrize("opname,dtype,ordered", [
    ("SUM", np.float32, False), ("PROD", np.float32, False), ("MAX", np.float32, False),
    ("SUM", np.float64, False), ("SUM", np.float32, True), ("PROD", np.float32, True)])
def test_engine_fold_on_tensors_matches_reference_numpy(small_min_size, opname, dtype,
                                                        ordered):
    """The port's Python DCN engine given CPU tensors (the ring above the
    threshold, or the process-ordered fold) over the plane's windows
    gives the reference engine's numpy bits on the same inputs."""
    rng = np.random.default_rng(31)
    X = (1 + 0.01 * rng.standard_normal((3, 40000))).astype(dtype)
    ref = _pair(rcollops, 3)
    port = _pair(pcollops, 3)
    try:
        want = _in_threads(ref, lambda p, e: e.allreduce(X[p], getattr(rop, opname), cid=3,
                                                         ordered=ordered))
        got = _in_threads(port, lambda p, e: e.allreduce(torch.from_numpy(X[p].copy()),
                                                         getattr(pop, opname), cid=3,
                                                         ordered=ordered))
        for p in range(3):
            assert isinstance(got[p], torch.Tensor)
            assert got[p].numpy().tobytes() == np.asarray(want[p]).tobytes(), p
        for e in port:
            assert e._device_plane.stats["device_sends"] > 0
            assert e._device_plane.stats["device_fallbacks"] == 0
    finally:
        for e in ref + port:
            e.close()


def test_engine_bfloat16_fold_on_tensors_matches_host_fold(small_min_size):
    """bfloat16 tensors fold with the op's torch kernel on the plane and
    give the host path's bits (han's ``host_op`` over the raw words)."""
    from ompi_tpu_torch.coll.han import host_op
    from ompi_tpu_torch.dcn.device import host_array
    from test_torch_coll import same_bits_but_nan

    rng = np.random.default_rng(32)
    X = torch.from_numpy(rng.standard_normal((2, 30000)).astype(np.float32)).to(torch.bfloat16)
    port = _pair(pcollops)
    try:
        got = _in_threads(port, lambda p, e: e.allreduce(X[p].clone(), pop.SUM, cid=4))
        for e in port:
            e._device_plane.close()
            e._device_plane = None
        want = _in_threads(port, lambda p, e: e.allreduce(
            host_array(X[p]), host_op(pop.SUM, torch.bfloat16), cid=5))
        for p in range(2):
            g = got[p].view(torch.int16).numpy()
            w = np.asarray(want[p]).view(np.int16)
            same_bits_but_nan(g, w)
    finally:
        for e in port:
            e.close()


# -- a mixed native pair, the plane on in both ------------------------------------


@pytest.fixture
def ref_small_min_size():
    from ompi_tpu.core import mca as rmca

    store = rmca.default_context().store
    old = store.get("dcn_device_min_size")
    store.set("dcn_device_min_size", 4096)
    yield
    store.set("dcn_device_min_size", old)


@pytest.mark.parametrize("pkgs", [("ref", "port"), ("port", "ref")])
def test_mixed_native_pair_plane_on_in_both(small_min_size, ref_small_min_size, pkgs):
    """A reference and a port native engine on one wire with the plane
    armed in both: the ring's 160 KB chunks cross the packages in shm
    windows, and the results are the all-reference pair's bits."""
    mods = {"ref": (rnative, rop), "port": (pnative, pop)}
    rng = np.random.default_rng(33)
    X = rng.standard_normal((2, 40000))

    def run(kinds):
        engines = [mods[k][0].NativeDcnEngine(p, 2) for p, k in enumerate(kinds)]
        addrs = [e.address for e in engines]
        for e in engines:
            e.set_addresses(addrs)
        try:
            out = _in_threads(engines, lambda p, e: e.allreduce(
                X[p], mods[kinds[p]][1].SUM, cid=9))
            stats = [dict(e._device_plane.stats) for e in engines]
        finally:
            for e in engines:
                e.close()
        return out, stats

    want, _ = run(("ref", "ref"))
    got, stats = run(pkgs)
    for p in range(2):
        assert np.asarray(got[p]).tobytes() == np.asarray(want[p]).tobytes(), p
    for st in stats:
        assert st["device_sends"] > 0 and st["device_recvs"] > 0
        assert st["device_fallbacks"] == 0


# -- np=2 launched jobs -------------------------------------------------------------

DEV_BODY = r'''
import json
p, n = w.proc, w.size
assert w.local_size == 1, w.local_size
rng = np.random.default_rng(20261017)
BIG = rng.standard_normal((n, 20000)).astype(np.float32)           # 80 KB rows
NEAR1 = (1 + 0.01 * rng.standard_normal((n, 20000))).astype(np.float32)
F64 = rng.standard_normal((n, 10000))
res = {}
res["small"] = w.allreduce(np.ones((1, 4)), SUM)                 # below min_size: host
res["sum_f32"] = w.allreduce(BIG[p:p + 1], SUM)
res["prod_f32"] = w.allreduce(NEAR1[p:p + 1], PROD)
res["max_f32"] = w.allreduce(BIG[p:p + 1], MAX)
res["sum_f64"] = w.allreduce(F64[p:p + 1], SUM)
res["bcast"] = w.bcast(BIG[p:p + 1], root=n - 1)
store = mca.default_context().store
store.set("coll_han_reproducible", True)       # the process-ordered fold
res["ordered_sum"] = w.allreduce(BIG[p:p + 1], SUM)
res["ordered_prod"] = w.allreduce(NEAR1[p:p + 1], PROD)
store.set("coll_han_reproducible", False)
if PKG == "port":
    import torch
    bf = torch.from_numpy(BIG[p:p + 1]).to(torch.bfloat16)
    res["sum_bf16"] = w.allreduce(bf, SUM).view(torch.int16).numpy()
    t = w.allreduce(torch.from_numpy(BIG[p:p + 1].copy()), SUM)
    assert isinstance(t, torch.Tensor), type(t)
    res["sum_f32_tensor"] = t.numpy()
dp = getattr(w.dcn._root_engine(), "_device_plane", None)
np.savez(os.path.join(sys.argv[1], f"{p}.npz"), **{k: np.asarray(v) for k, v in res.items()})
print("DEVPLANE " + json.dumps({"proc": p, "stats": dict(dp.stats) if dp else None}),
      flush=True)
api.finalize()
'''


def _dev_job(tmp_path, pkg, tag, mca):
    out = tmp_path / tag
    out.mkdir()
    script = tmp_path / f"dev_{tag}.py"
    prelude = PRELUDE[pkg] + (
        "from ompi_tpu_torch.core import mca\n" if pkg == "port"
        else "from ompi_tpu.core import mca\n")
    script.write_text("import os\nimport sys\n\nimport numpy as np\n\n"
                      f"PKG = {pkg!r}\n" + prelude + DEV_BODY)
    res = run_job(pkg, 2, 1, script, [out], mca=mca, timeout=150)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    rows = [json.loads(line.split("DEVPLANE ", 1)[1]) for line in res.stdout.splitlines()
            if "DEVPLANE " in line]
    assert len(rows) == 2, res.stdout
    stats = {r["proc"]: r["stats"] for r in rows}
    return [dict(np.load(out / f"{p}.npz")) for p in range(2)], stats


@pytest.fixture(scope="module")
def dev_jobs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("devjobs")
    on = {"dcn_device_min_size": "4096"}
    return {"port_on": _dev_job(tmp, "port", "port_on", on),
            "port_off": _dev_job(tmp, "port", "port_off", {"dcn_device_enable": "0"}),
            "ref_on": _dev_job(tmp, "ref", "ref_on", on)}


def test_np2_plane_carries_the_large_payloads(dev_jobs):
    for key in ("port_on", "ref_on"):
        for p, st in dev_jobs[key][1].items():
            assert st is not None, (key, p)
            assert st["device_sends"] >= 1 and st["device_recvs"] >= 1, (key, st)
            assert st["device_bytes_placed"] >= 40000, (key, st)
            assert st["device_arb_host"] >= 1, (key, st)   # small frames stay host
            assert st["device_fallbacks"] == 0, (key, st)
    assert all(st is None for st in dev_jobs["port_off"][1].values())


def test_np2_port_plane_on_bitwise_equal_to_plane_off_and_reference(dev_jobs):
    from test_torch_coll import same_bits_but_nan

    on, off, ref = dev_jobs["port_on"][0], dev_jobs["port_off"][0], dev_jobs["ref_on"][0]
    for p in range(2):
        assert sorted(on[p]) == sorted(off[p])
        for k in on[p]:
            if k == "sum_bf16":
                same_bits_but_nan(on[p][k], off[p][k])
            else:
                assert on[p][k].tobytes() == off[p][k].tobytes(), (p, k)
        for k in ref[p]:
            assert on[p][k].dtype == ref[p][k].dtype, (p, k)
            assert on[p][k].tobytes() == ref[p][k].tobytes(), (p, k)
        assert on[p]["sum_f32_tensor"].tobytes() == ref[p]["sum_f32"].tobytes()

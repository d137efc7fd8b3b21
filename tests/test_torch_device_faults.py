"""Device-plane faults and plane-health failover of the port against the
reference, case by case after ``tests/test_device_faults.py``.

Each unit runs one scenario through both packages' ``dcn/device.py``
(the same seeded fault plan, the same inputs) and compares what comes
out — the window descriptors' fates, the ``dcn_device_*``/``dcn_plane_*``
counters and the health table's transition log — then checks the
reference's expectations on the port's record:

* fault parity: the ``site=device``/``site=device_recv`` plan grammar
  and seeded decisions (one shared grammar, checked on the port's
  parser), and a disabled fault plane never consulted;
* failure semantics: an injected drop degrades and strikes, the third
  consecutive strike demotes; trunc surfaces as the typed
  ``MPITruncateError``; materialize escalates trunc and an expired wait
  through the engine's ``_escalate_deadline`` with the sender struck and
  its windows reclaimed; without an engine hook the typed error stays;
* plane health: probe staleness, heal interval 0, the MCA overrides,
  ``clear_failed``, a reclaimed probe;
* lifecycle: the close drain, the bounded close, stage after close.

The reference's np=2 ``tools/chaos.py --planes`` soak is ported as
``python -m ompi_tpu_torch chaos --planes`` (``tests/test_torch_chaos.py``:
the golden transition log, run twice); here an np=2 port job whose
process 0 drops six device stages mid-allreduce demotes, heals through
probes, and finishes bit for bit equal to the plane-off job.
"""

import json
import threading
import time

import numpy as np
import pytest

from ompi_tpu.core import errors as rerrors
from ompi_tpu.dcn import device as rdev
from ompi_tpu.faultsim import core as rfsim
from ompi_tpu_torch.core import errors as perrors
from ompi_tpu_torch.dcn import device as pdev
from ompi_tpu_torch.faultsim import core as pfsim
from torch_mp_common import PRELUDE, run_job

PKG = {"ref": (rdev, rfsim, rerrors), "port": (pdev, pfsim, perrors)}


@pytest.fixture(autouse=True)
def clean_faultsim():
    for fs in (rfsim, pfsim):
        fs.reset()
    yield
    for fs in (rfsim, pfsim):
        fs.reset()


def _plane(pkg, min_size=64, proc=0, strikes=3, heal=0.05):
    dp = PKG[pkg][0].DevicePlane(proc, min_size=min_size)
    dp.health.max_strikes = strikes
    dp.health.heal_interval = heal
    return dp


def _both(scenario):
    """Run ``scenario(pkg)`` for both packages; the records must agree."""
    ref, port = scenario("ref"), scenario("port")
    assert port == ref
    return port


# -- grammar, determinism, gating -------------------------------------------


def test_plan_grammar_device_sites():
    text = ("drop:site=device;n=6;proc=0,trunc:site=device;at=3,"
            "delay:site=device_recv;ms=5;every=2,stall:site=device;ms=1")
    for fs in (rfsim, pfsim):
        rules = fs.parse_plan(text)
        assert [r.site for r in rules] == ["device", "device", "device_recv", "device"]
        assert rules[0].kind == "drop" and rules[0].n == 6 and rules[0].proc == 0
        assert rules[1].at == 3
        assert rules[2].ms == 5.0 and rules[2].every == 2


def test_device_site_decisions_deterministic_and_equal_to_reference():
    def stream(fs, seed, proc=0, text="drop:site=device;p=0.4"):
        plan = fs.FaultPlan(fs.parse_plan(text), seed=seed, proc=proc)
        return [bool(plan.decide("device")) for _ in range(200)]

    assert stream(pfsim, 11) == stream(rfsim, 11) == stream(pfsim, 11)
    assert stream(pfsim, 11) != stream(pfsim, 12)
    assert not any(stream(pfsim, 1, proc=1, text="drop:site=device;n=6;proc=0"))


def test_gating_off_never_consults_the_plan(monkeypatch):
    def _boom(*a, **kw):  # pragma: no cover - the assertion is no call
        raise AssertionError("faultsim consulted while disabled")

    def scenario(pkg):
        dev, fs, _ = PKG[pkg]
        assert not fs.enabled()
        monkeypatch.setattr(fs, "actions", _boom)
        dp = _plane(pkg)
        arr = np.arange(64, dtype=np.float64)
        desc = dp.stage(arr, dst_proc=1)
        out = dev.receive(desc)
        rec = (np.array_equal(out, arr), dp.reap(), sum(fs.counters().values()))
        dp.close()
        return rec

    assert _both(scenario) == (True, 1, 0)


# -- injected DMA failures ----------------------------------------------------


def test_injected_drop_degrades_strikes_and_demotes():
    def scenario(pkg):
        _dev, fs, _ = PKG[pkg]
        fs.configure("drop:site=device;n=3", seed=7, proc=0)
        dp = _plane(pkg)
        arr = np.zeros(64, np.uint8)
        rec = []
        for _ in range(3):
            rec.append((dp.arbitrate(arr, 1), dp.stage(arr, dst_proc=1) is None,
                        dp.stats["device_fallbacks"]))
        rec.append((dp.health.ok(1), dp.arbitrate(arr, 1), fs.injected("drop")))
        dp.close()
        return rec, dp.health.transitions, dict(dp.stats)

    rec, transitions, stats = _both(scenario)
    assert rec[:3] == [(True, True, 1), (True, True, 2), (True, True, 3)]
    assert rec[3] == (False, False, 3)        # demoted: arbitration says host
    assert transitions == [("demote", 1, "injected_drop")]
    assert stats["plane_demotions"] == 1


def test_injected_drop_is_consecutive_not_cumulative():
    def scenario(pkg):
        dev, fs, _ = PKG[pkg]
        fs.configure("drop:site=device;every=2", seed=7, proc=0)
        dp = _plane(pkg)
        arr = np.arange(32, dtype=np.float64)
        fates = []
        for _ in range(6):
            desc = dp.stage(arr, dst_proc=1)
            fates.append(desc is not None)
            if desc is not None:
                dev.receive(desc)
                dp.reap()
        dp.close()
        return fates, dp.health.ok(1), dp.stats["plane_demotions"]

    fates, ok, demotions = _both(scenario)
    assert ok and demotions == 0 and fates.count(False) == 3


def test_injected_trunc_raises_typed_truncate():
    def scenario(pkg):
        dev, fs, errs = PKG[pkg]
        fs.configure("trunc:site=device;at=1", seed=7, proc=0)
        dp = _plane(pkg)
        desc = dp.stage(np.arange(64, dtype=np.float64), dst_proc=1)
        with pytest.raises(errs.MPITruncateError, match="placed 511 bytes"):
            dev.receive(desc)
        dp.close()
        return {k: v for k, v in desc.items() if k != "w"}

    assert _both(scenario) == {"n": 512, "dt": "<f8", "sh": [64]}


class _StubEngine:
    """The root-engine shape materialize() needs: a plane and the
    escalation hook (recorded, then raising like the real one)."""

    def __init__(self, dp, errs):
        self._device_plane = dp
        self.errs = errs
        self.escalations = []

    def _escalate_deadline(self, site, timeout, msg, failed_rank=None,
                           root_proc=None, **detail):
        self.escalations.append((site, failed_rank, detail.get("cause")))
        raise self.errs.MPIProcFailedError(msg, failed=(failed_rank,))


def test_materialize_trunc_escalates_strikes_and_reclaims():
    def scenario(pkg):
        dev, fs, errs = PKG[pkg]
        fs.configure("trunc:site=device;at=1", seed=7, proc=0)
        dp = _plane(pkg, strikes=1)
        eng = _StubEngine(dp, errs)
        bad = dp.stage(np.arange(64, dtype=np.float64), dst_proc=1)
        fs.disable()
        staged = dp.stage(np.arange(64, dtype=np.float64), dst_proc=1)
        rec = [bad is not None and staged is not None, dp.pending_windows()]
        with pytest.raises(errs.MPIProcFailedError):
            dev.materialize(eng, bad, src_root=1)
        rec += [eng.escalations, dp.health.ok(1), dp.pending_windows(),
                dp.stats["device_window_reclaimed"]]
        dp.close()
        return rec

    assert _both(scenario) == [True, 2, [("device_recv", 1, "trunc")], False, 0, 2]


def _short_recv_timeout(monkeypatch, seconds):
    from ompi_tpu.core import mca as rmca
    from ompi_tpu.core.registry import MCAContext as RCtx
    from ompi_tpu_torch.core import mca as pmca
    from ompi_tpu_torch.core.registry import MCAContext as PCtx

    for m, ctx_cls in ((rmca, RCtx), (pmca, PCtx)):
        ctx = ctx_cls(cmdline={"dcn_recv_timeout": str(seconds)})
        monkeypatch.setattr(m, "default_context", lambda c=ctx: c)


def test_materialize_deadline_escalates(monkeypatch):
    _short_recv_timeout(monkeypatch, 0.1)

    def scenario(pkg):
        dev, _fs, errs = PKG[pkg]
        dp = _plane(pkg, strikes=1)
        eng = _StubEngine(dp, errs)
        win = dev.DeviceWindow(f"tpudev-test-dlmat-{pkg}", 64, create=True)
        try:
            desc = {"w": win.name, "n": 64, "dt": "<f8", "sh": [8]}
            with pytest.raises(errs.MPIProcFailedError):
                dev.materialize(eng, desc, src_root=1)
            return eng.escalations, dp.health.ok(1), dp.health.transitions
        finally:
            win.close(unlink=True)
            dp.close()

    assert _both(scenario) == ([("device_recv", 1, "deadline")], False,
                               [("demote", 1, "deadline")])


def test_materialize_without_engine_hook_raises_typed(monkeypatch):
    _short_recv_timeout(monkeypatch, 0.1)
    for pkg in PKG:
        dev, _fs, errs = PKG[pkg]
        win = dev.DeviceWindow(f"tpudev-test-dlbare-{pkg}", 64, create=True)
        try:
            with pytest.raises(errs.DeadlineExpiredError):
                dev.materialize(object(), {"w": win.name, "n": 64, "dt": "<f8",
                                           "sh": [8]}, src_root=None)
        finally:
            win.close(unlink=True)


def test_device_recv_site_delays_before_the_wait(monkeypatch):
    _short_recv_timeout(monkeypatch, 0.05)
    for pkg in PKG:
        dev, fs, _ = PKG[pkg]
        fs.reset()
        dp = _plane(pkg)
        desc = dp.stage(np.arange(64, dtype=np.float64), dst_proc=1)
        fs.configure("delay:site=device_recv;ms=80", seed=7, proc=0)
        t0 = time.monotonic()
        out = dev.receive(desc)                # placed already: no wait
        assert time.monotonic() - t0 >= 0.08, pkg
        assert out.shape == (64,) and fs.injected("delay") == 1, pkg
        dp.reap()
        dp.close()


# -- plane-health edges ---------------------------------------------------------


def test_probe_staleness_resolves_and_rearms():
    def scenario(pkg):
        h = PKG[pkg][0].PlaneHealth(plane="device", strikes=1, heal_interval=0.02)
        h.strike(1, "x")
        time.sleep(0.03)
        rec = [h.allow_probe(1)]
        h._probe_t[1] -= h.probe_timeout() + 0.01        # age it stale
        rec += [h.allow_probe(1), h.probing(1)]
        time.sleep(0.03)
        rec += [h.allow_probe(1), h.stats["plane_heal_probes"]]
        return rec, h.transitions

    rec, transitions = _both(scenario)
    assert rec == [True, False, False, True, 2]
    assert transitions == [("demote", 1, "x"), ("probe", 1, ""),
                           ("probe_fail", 1, "probe_timeout"), ("probe", 1, "")]


def test_heal_interval_zero_disables_probes():
    def scenario(pkg):
        h = PKG[pkg][0].PlaneHealth(plane="device", strikes=1, heal_interval=0.0)
        h.strike(1, "x")
        time.sleep(0.01)
        return h.allow_probe(1), h.ok(1)

    assert _both(scenario) == (False, False)


def test_plane_tuning_mca_override(monkeypatch):
    from ompi_tpu.core import mca as rmca
    from ompi_tpu.core.registry import MCAContext as RCtx
    from ompi_tpu_torch.core import mca as pmca
    from ompi_tpu_torch.core.registry import MCAContext as PCtx

    assert pdev.plane_tuning() == rdev.plane_tuning() == (3, 5.0)
    for m, ctx_cls, dev in ((rmca, RCtx, rdev), (pmca, PCtx, pdev)):
        ctx = ctx_cls(cmdline={"dcn_plane_strikes": "2", "dcn_plane_heal_interval": "0.5"})
        monkeypatch.setattr(m, "default_context", lambda c=ctx: c)
        assert dev.plane_tuning() == (2, 0.5)
        h = dev.PlaneHealth()
        assert h.max_strikes == 2 and h.heal_interval == 0.5


def test_clear_failed_clears_health_marks():
    def scenario(pkg):
        dp = _plane(pkg, strikes=1)
        dp.health.strike(1, "deadline")
        dp.reclaim_failed(1)
        rec = [dp.health.ok(1)]
        dp.clear_failed(1)
        rec += [dp.health.ok(1), 1 in dp._failed, dp.arbitrate(np.zeros(64, np.uint8), 1)]
        dp.close()
        return rec, dp.health.transitions

    rec, transitions = _both(scenario)
    assert rec == [False, True, False, True]
    assert transitions[-1] == ("clear", 1, "")


def test_probe_window_reclaim_resolves_probe_failed():
    def scenario(pkg):
        dp = _plane(pkg, strikes=1, heal=0.01)
        dp.health.strike(1, "deadline")
        time.sleep(0.02)
        arr = np.zeros(64, np.uint8)
        rec = [dp.arbitrate(arr, 1), dp.stage(arr, dst_proc=1) is not None,
               dp.health.probing(1), dp.reclaim_failed(1), dp.health.probing(1),
               dp.health.ok(1)]
        dp.close()
        return rec, dp.health.transitions[-1], dp.stats["device_window_reclaimed"]

    assert _both(scenario) == ([True, True, True, 1, False, False],
                               ("probe_fail", 1, "peer_failed"), 1)


# -- drain-then-close ---------------------------------------------------------


@pytest.mark.parametrize("pkg", list(PKG))
def test_close_drains_consumed_windows_before_sweep(pkg):
    dev = PKG[pkg][0]
    dp = _plane(pkg)
    arr = np.arange(512, dtype=np.float64)
    desc = dp.stage(arr, dst_proc=1)
    got = {}

    def _consumer():
        time.sleep(0.05)                 # close() arrives first
        got["out"] = dev.receive(desc)

    t = threading.Thread(target=_consumer)
    t.start()
    dp.close(drain_timeout=2.0)          # waits for the consume
    t.join(timeout=5)
    assert np.array_equal(got["out"], arr)
    assert dp.pending_windows() == 0
    assert dp.stats["device_recvs"] == 0  # the receiver used the module twin


@pytest.mark.parametrize("pkg", list(PKG))
def test_close_bounded_on_unconsumed_window(pkg):
    dp = _plane(pkg)
    dp.stage(np.zeros(4096, np.uint8), dst_proc=1)
    t0 = time.monotonic()
    dp.close(drain_timeout=0.1)
    assert time.monotonic() - t0 < 1.5
    assert dp.pending_windows() == 0


def test_stage_after_close_degrades():
    def scenario(pkg):
        dp = _plane(pkg)
        dp.close(drain_timeout=0)
        return (dp.stage(np.zeros(64, np.uint8), dst_proc=1), dp.stats["device_fallbacks"],
                dp.pending_windows())

    assert _both(scenario) == (None, 1, 0)


# -- np=2: demotion mid-allreduce, bit-exact across the boundary ------------------

SOAK_BODY = r'''
import json
from ompi_tpu_torch.core import mca
p, n = w.proc, w.size
rng = np.random.default_rng(20261018)
X = rng.standard_normal((n, 20000)).astype(np.float32)
outs = []
for i in range(12):
    outs.append(w.allreduce(X[p:p + 1] * (i + 1), SUM))
    time.sleep(0.03)                       # let the heal interval elapse
np.save(os.path.join(sys.argv[1], f"{p}.npy"), np.stack(outs))
dp = getattr(w.dcn._root_engine(), "_device_plane", None)
print("SOAK " + json.dumps({"proc": p, "stats": dict(dp.stats) if dp else None,
                            "transitions": dp.health.transitions if dp else None}),
      flush=True)
api.finalize()
'''


def _soak(tmp_path, tag, mca):
    out = tmp_path / tag
    out.mkdir()
    script = tmp_path / f"soak_{tag}.py"
    script.write_text("import os\nimport sys\nimport time\n\nimport numpy as np\n\n"
                      + PRELUDE["port"] + SOAK_BODY)
    res = run_job("port", 2, 1, script, [out], mca=mca, timeout=150)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    rows = {r["proc"]: r for r in (json.loads(line.split("SOAK ", 1)[1])
                                   for line in res.stdout.splitlines() if "SOAK " in line)}
    assert sorted(rows) == [0, 1], res.stdout
    return [np.load(out / f"{p}.npy") for p in range(2)], rows


def test_np2_demotion_mid_allreduce_stays_bit_exact(tmp_path):
    """Process 0's plane drops six device stages (a seeded plan): three
    strikes demote the peer, probes fail and re-arm, a later probe
    promotes it back — and every allreduce is bit-equal to the plane-off
    job's, on both processes."""
    faulty, rows = _soak(tmp_path, "faulty", {
        "dcn_device_min_size": "4096", "dcn_plane_heal_interval": "0.02",
        "faultsim_enable": "1", "faultsim_seed": "7",
        "faultsim_plan": "drop:site=device;n=6;proc=0"})
    clean, off = _soak(tmp_path, "off", {"dcn_device_enable": "0"})
    for p in range(2):
        assert faulty[p].tobytes() == clean[p].tobytes(), p
    st0, tr0 = rows[0]["stats"], [tuple(t) for t in rows[0]["transitions"]]
    assert st0["device_fallbacks"] == 6 and st0["plane_demotions"] == 1
    assert st0["plane_promotions"] == 1
    assert [e for e, _p, _c in tr0][:2] == ["demote", "probe"]
    assert tr0[-1][0] == "promote"
    assert rows[1]["stats"]["device_fallbacks"] == 0
    assert all(r["stats"] is None for r in off.values())

"""The port's fault-injection plane against the reference's.

* the plan grammar parses to the same rules (and rejects the same
  garbage);
* decisions are the same pure function of (seed, proc, site, event,
  rule): for the same plan, seed and proc the two packages fire the
  same actions on the same events, and count the same injections;
* a delay plan on a port job: ``delay:ms=300;site=send;proc=1`` slows
  only process 1's sends, which process 0's allreduce waits for.
"""

import json

import pytest

from ompi_tpu.faultsim import core as rfs
from ompi_tpu_torch.faultsim import core as pfs
from torch_mp_common import run_job


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    rfs.reset()
    pfs.reset()


PLANS = [
    "drop:p=0.3",
    "delay:ms=5;site=recv;proc=1,dup:every=3",
    "connkill:at=4,trunc:p=0.1,dialfail:n=2",
    "stall:ms=2;every=2,ringfail:at=3,daemonkill:at=2,agentkill:at=1",
    "drop:p=0.5;site=device,delay:ms=1;site=device_recv",
]


@pytest.mark.parametrize("plan", PLANS)
def test_plan_parses_as_in_the_reference(plan):
    assert [r.__dict__ for r in pfs.parse_plan(plan)] == \
        [r.__dict__ for r in rfs.parse_plan(plan)]


@pytest.mark.parametrize("bad", ["bogus:p=1", "drop:p", "drop:p=x", "delay:zz=1"])
def test_bad_plans_rejected_by_both(bad):
    with pytest.raises(rfs.FaultPlanError):
        rfs.parse_plan(bad)
    with pytest.raises(pfs.FaultPlanError):
        pfs.parse_plan(bad)


@pytest.mark.parametrize("seed", [0, 7, 2026])
@pytest.mark.parametrize("proc", [0, 1])
def test_actions_match_the_reference(seed, proc):
    plan = ("drop:p=0.2,dup:p=0.1,delay:ms=0;every=5;site=recv,"
            "connkill:at=17,trunc:p=0.05;proc=1,dialfail:n=3")
    rfs.configure(plan, seed=seed, proc=proc)
    pfs.configure(plan, seed=seed, proc=proc)
    seq_r, seq_p = [], []
    for k in range(200):
        for site, kinds in (("send", None), ("recv", {"delay", "drop"}), ("dial", None)):
            seq_r.append([r.kind for r in rfs.actions(site, kinds)])
            seq_p.append([r.kind for r in pfs.actions(site, kinds)])
    assert seq_p == seq_r
    assert any(seq_p)
    assert pfs.counters() == rfs.counters()
    assert pfs.injected() == rfs.injected() > 0


def test_disabled_plane_is_inert():
    pfs.reset()
    assert not pfs.enabled() and pfs.actions("send") == ()
    assert pfs.injected() == 0


def test_delay_plan_observed_on_a_port_job(tmp_path):
    script = tmp_path / "delay.py"
    script.write_text(
        "import json, time\n"
        "import numpy as np\n"
        "import ompi_tpu_torch.api as api\n"
        "from ompi_tpu_torch import faultsim\n"
        "from ompi_tpu_torch.op import SUM\n"
        "w = api.init(device='cpu')\n"
        "w.barrier()\n"
        "t0 = time.perf_counter()\n"
        "out = w.allreduce(np.ones((1, 4)), SUM)\n"
        "dt = time.perf_counter() - t0\n"
        "assert (out == 2).all()\n"
        "print('RESULT ' + json.dumps({'proc': w.proc, 'dt': dt,\n"
        "      'delay': faultsim.counters()['delay']}), flush=True)\n"
        "api.finalize()\n")
    out = tmp_path / "m"
    res = run_job("port", 2, 1, script, timeout=90, mca={
        "faultsim_enable": "1", "faultsim_seed": "3",
        "faultsim_plan": "delay:ms=300;site=send;proc=1",
        "metrics_enable": "1", "metrics_output": str(out)})
    assert res.returncode == 0, res.stdout + res.stderr
    rows = {r["proc"]: r for r in (json.loads(line.split("RESULT ", 1)[1])
                                   for line in res.stdout.splitlines() if "RESULT " in line)}
    assert rows[1]["delay"] >= 1 and rows[0]["delay"] == 0
    assert rows[0]["dt"] >= 0.25  # proc 0 waited for proc 1's delayed send
    # each process's exports carry its own index: the injections were
    # flight-recorded by process 1 alone
    flights = [json.loads(ln) for ln in (tmp_path / "m.flight.1.jsonl").read_text().splitlines()]
    assert flights and {f["proc"] for f in flights} == {1}
    assert not (tmp_path / "m.flight.0.jsonl").exists()
    assert (tmp_path / "m.0.prom").exists() and (tmp_path / "m.1.prom").exists()

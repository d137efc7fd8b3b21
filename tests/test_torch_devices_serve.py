"""tpud serving on the one-rank-per-device layout (the MCA variable
``accelerator_cuda_layout`` set to ``devices``), on the CPU.

* The parity job of ``tests/test_torch_serve.py`` through a port tpud
  on the devices layout and a reference tpud (``--cpu-devices``, every
  rank its own device), 2 × 2 ranks, reproducible vars on both: the same
  bits; the port's job with ``cuda_ring`` forced on han's local leg (the
  shard ring) equals each process's single-process plain ring folded
  across the two processes.  Each completion record lists every local
  rank's device.
* A devices tpud whose job loses a rank mid-job (``SERVE_KILL_RANK``):
  the job fails, the daemon respawns the worker and fires the repair
  directive (``heal_ms`` on both processes), and the next sweep job
  schedules on the healed world with the first job's digests, every
  result on its rank's device.

Every daemon gets the short deadlines of ``tests/test_torch_ulfm.py``.
"""

import json
import time

import numpy as np

from test_torch_serve import (JOB, _PARITY_BODY, _PARITY_PRELUDE, _plain_ring_rows, _Tpud)
from test_torch_ulfm import DEADLINES

DEVICES = {"accelerator_cuda_layout": "devices"}
SIZES = "8,4096,65536"


def _sjson(lines, job_id: str) -> list:
    rows = []
    for line in lines:
        if " SJSON " in line:
            rec = json.loads(line.split(" SJSON ", 1)[1])
            if rec.get("job") == job_id:
                rows.append(rec)
    return rows


def test_devices_tpud_allreduce_bitequal_to_reference_tpud_and_plain_ring(tmp_path):
    from ompi_tpu_torch.serve import client

    jobs, outs = {}, {}
    for pkg in ("port", "ref"):
        script = tmp_path / f"parity_{pkg}.py"
        script.write_text(_PARITY_PRELUDE[pkg] + _PARITY_BODY)
        outs[pkg] = tmp_path / f"out_{pkg}"
        outs[pkg].mkdir()
        jobs[pkg] = script
    port_mca = [("coll_cuda_reproducible", "1"), ("coll_han_reproducible", "1"),
                ("dcn_device_min_size", "4096"), *DEVICES.items()]
    ref_mca = [("coll_xla_reproducible", "1"), ("coll_han_reproducible", "1")]
    dp = _Tpud(mca=port_mca, nranks=2, btl=None, entry="tpud")
    dr = None
    try:
        dr = _Tpud(mca=ref_mca, nranks=2, btl=None, pkg="ref")
        recs = {}
        for pkg, d in (("port", dp), ("ref", dr)):
            j = client.submit(d.url, str(jobs[pkg]), tenant=pkg,
                              env={"PARITY_OUT": str(outs[pkg])})
            recs[pkg] = client.wait(d.url, j["id"], timeout=150)
        for pkg, d in (("port", dp), ("ref", dr)):
            assert recs[pkg]["state"] == "done", (recs[pkg], d.out()[-3000:])
            client.shutdown(d.url)
            assert d.proc.wait(timeout=60) == 0, d.out()[-3000:]
    finally:
        dp.close()
        if dr is not None:
            dr.close()
    ranks = recs["port"]["ranks"]
    assert {p: ranks[p]["rank_devices"] for p in ranks} == {"0": ["cpu"] * 2, "1": ["cpu"] * 2}
    got = {pkg: [dict(np.load(outs[pkg] / f"{p}.npz")) for p in range(2)] for pkg in outs}
    for p in range(2):
        for name, ref_arr in got["ref"][p].items():
            port_arr = got["port"][p][name]
            assert port_arr.dtype == ref_arr.dtype and port_arr.shape == ref_arr.shape
            assert port_arr.tobytes() == ref_arr.tobytes(), (p, name)
    rng = np.random.default_rng(20261017)
    rng.standard_normal((4, 5))
    big = rng.standard_normal((4, 20000)).astype(np.float32)
    partials = [_plain_ring_rows(big[2 * p:2 * p + 2], 2)[0] for p in range(2)]
    want = partials[0] + partials[1]
    for p in range(2):
        ring = got["port"][p]["ring_big"]
        assert ring.shape == (2, 20000)
        for row in ring:
            assert row.tobytes() == want.tobytes(), p


def test_devices_tpud_kill_rank_mid_job_repairs_and_next_job_schedules(tmp_path):
    from ompi_tpu_torch.serve import client

    d = _Tpud(mca=[*DEADLINES.items(), ("dcn_device_min_size", "4096"), *DEVICES.items()],
              nranks=4, btl=None, entry="tpud")
    try:
        j1 = client.submit(d.url, str(JOB), args=["--sizes", SIZES], tenant="ops")
        r1 = client.wait(d.url, j1["id"], timeout=120)
        assert r1["state"] == "done", (r1, d.out()[-3000:])
        flag = tmp_path / "killed"
        jk = client.submit(d.url, str(JOB), tenant="ops",
                           env={"SERVE_KILL_RANK": "1", "SERVE_KILL_FLAG": str(flag)})
        rk = client.wait(d.url, jk["id"], timeout=120)
        assert rk["state"] == "failed" and flag.exists(), rk
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            st = client.status(d.url)
            if (st["healthy"] and st["procs"]["1"]["incarnation"] == 1
                    and st["procs"]["1"]["status"] == "active"):
                break
            time.sleep(0.2)
        else:
            raise AssertionError(f"mesh never healed: {st}\n{d.out()}")
        d.track()
        j3 = client.submit(d.url, str(JOB), args=["--sizes", SIZES], tenant="ops")
        r3 = client.wait(d.url, j3["id"], timeout=120)
        assert r3["state"] == "done", (r3, d.out()[-3000:])
        time.sleep(0.5)  # the forwarded lines trail the completion record
        client.shutdown(d.url)
        assert d.proc.wait(timeout=60) == 0, d.out()[-3000:]
    finally:
        d.close()
    out = d.out()
    assert "respawning (incarnation 1)" in out and "repair complete" in out, out
    heal = [ln for ln in out.splitlines() if "serve: " in ln and "heal_ms=" in ln]
    assert {ln.split("]", 1)[0] for ln in heal} == {"[0", "[1"}, heal
    for rec in (r1, r3):
        assert {p: rec["ranks"][p]["rank_devices"] for p in rec["ranks"]} == {
            "0": ["cpu"] * 4, "1": ["cpu"] * 4}
    rows = {job: [r for r in _sjson(d.lines, job) if r["kind"] == "size"]
            for job in (j1["id"], j3["id"])}
    digests = {job: sorted((r["proc"], r["bytes"], r["digest"]) for r in rs)
               for job, rs in rows.items()}
    assert len(digests[j1["id"]]) == 6 and digests[j1["id"]] == digests[j3["id"]]
    assert all(r["bitwise_vs_plain"] and r["placement"]["ok"]
               for rs in rows.values() for r in rs), rows

"""``python -m ompi_tpu_torch chaos`` against the reference's
``tools/chaos.py``, every soak with ``--cpu`` (one rank per process):

* ``--selftest`` and ``--traffic --selftest`` (in process, no workers);
* the np=2 framed-TCP soak with the default plan, seed 12, ``--runs 2
  --out``: the injected-fault counts reproduce run to run and equal the
  reference's for the same seed and op count (the decisions are
  counter-hashed per send/recv/dial event, so a difference would mean
  the port's TCP transport sends another frame sequence); the exports
  carry the injections' flight records;
* ``--planes --runs 2``: rank 0's golden demote/probe/promote log, six
  device-plane fallbacks, the tally reproduced, every window freed;
* ``--respawn``, ``--daemon-restart`` and ``--kill-in-repair``: the
  tool's own assertions (full size, zero re-dials, the queued job
  exactly once, zero orphans, a CUDA-free daemon, the healed mesh);
* without ``--cpu`` and without a card the tool exits non-zero and
  names the missing card, before any process starts (``--np 2``,
  ``--hosts 3 --np 6`` and ``--scale --np 16``): no tally, no record;
* slow, as the reference keeps its full soaks out of tier-1: ``--traffic``
  and ``--hosts 3 --np 6``.

The port's tallies carry three keys the reference's do not: ``device``
(the rank's device), ``launches`` (the ring kernels launched: 0, with
one rank per process) and, for the planes soak, ``digest``,
``windows_left`` and ``cuda_allocated``; the daemon-restart tally adds
``daemon_cuda``.  The printed tables are the reference's.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + ":" + env.get("PYTHONPATH", "")
    return env


def chaos(*args, timeout: float = 400) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "ompi_tpu_torch", "chaos", *map(str, args)],
                          capture_output=True, text=True, timeout=timeout, env=_env(),
                          cwd=str(REPO))


def ok(res: subprocess.CompletedProcess) -> str:
    assert res.returncode == 0, res.stdout[-6000:] + res.stderr[-6000:]
    return res.stdout


def injected_table(text: str) -> list[dict]:
    """The per-rank injected counts of the soak's first printed table: the
    kinds are 10-wide columns after ``rank`` (6), ``outcome`` (22) and
    ``ops`` (5), before the five counter columns (38 wide in all)."""
    lines = text.splitlines()
    h = next(i for i, ln in enumerate(lines) if ln.startswith("rank  outcome"))
    cols = range(33, len(lines[h]) - 38, 10)
    kinds = [lines[h][c:c + 10].strip() for c in cols]
    rows = []
    for ln in lines[h + 1:]:
        if not re.match(r"^\d", ln):
            break
        rows.append({k: int(ln[c:c + 10]) for k, c in zip(kinds, cols)})
    return rows


@pytest.mark.parametrize("flags", [[], ["--traffic"]], ids=["faults", "traffic"])
def test_chaos_selftest(flags):
    out = ok(chaos(*flags, "--selftest", timeout=180))
    assert "selftest OK" in out


def test_np2_soak_deterministic_and_equal_to_the_reference(tmp_path):
    args = ["--np", "2", "--seed", "12", "--ops", "18", "--timeout", "240"]
    ref = subprocess.Popen([sys.executable, str(REPO / "tools" / "chaos.py"), *args,
                            "--out", str(tmp_path / "ref")], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, env=_env(), cwd=str(REPO))
    port = chaos(*args, "--runs", "2", "--cpu", "--out", tmp_path / "port",
                 "--json", tmp_path / "port.json")
    ref_out, ref_err = ref.communicate(timeout=400)
    assert ref.returncode == 0, ref_out + ref_err
    out = ok(port)
    assert "DETERMINISM VIOLATION" not in out
    assert "injected-fault counts reproduce run 1 exactly (seed 12)" in out
    runs = json.loads((tmp_path / "port.json").read_text())["runs"]
    counts = [[t["injected"] for t in r["tally"]] for r in runs]
    assert counts[0] == counts[1]
    assert injected_table(out) == injected_table(ref_out)
    assert [{k: v for k, v in c.items() if v} for c in counts[0]] == [
        {k: v for k, v in c.items() if v} for c in injected_table(ref_out)]
    assert sum(sum(c.values()) for c in counts[0]) > 0
    for t in runs[0]["tally"]:
        assert t["device"] == "cpu" and t["launches"] == {
            "ring_hop": 0, "ring_hop_fold": 0, "ring_hop_peer": 0, "ring_hop_wait": 0}
    reasons = {json.loads(line)["reason"]
               for p in (tmp_path / "port").glob("*.flight.*.jsonl")
               for line in p.read_text().splitlines() if line.strip()}
    assert "fault_injected" in reasons, reasons
    assert "reconn" in out and "flight records:" in out


def test_planes_soak_golden_transitions(tmp_path):
    out = ok(chaos("--planes", "--runs", "2", "--cpu", "--json", tmp_path / "p.json"))
    assert "planes tally reproduces run 1 exactly" in out
    assert ("demote probe probe_fail probe probe_fail probe probe_fail probe promote"
            in out)
    assert "fallbacks=6" in out
    for run in json.loads((tmp_path / "p.json").read_text())["runs"]:
        t0, t1 = run["tally"]
        assert t0["plane"]["device_fallbacks"] == 6 and t1["plane"]["device_fallbacks"] == 0
        assert t0["digest"] == t1["digest"]
        assert t0["windows_left"] == t1["windows_left"] == 0


def test_respawn_soak_restores_full_size(tmp_path):
    out = ok(chaos("--respawn", "--cpu", "--json", tmp_path / "r.json"))
    assert "full_size=True" in out
    tallies = json.loads((tmp_path / "r.json").read_text())["runs"][0]["tally"]
    assert [t["incarnation"] for t in tallies] == [0, 1]
    assert all(t["size"] == 2 and t["post"] == t["ops"] for t in tallies)


def test_daemon_restart_soak(tmp_path):
    out = ok(chaos("--daemon-restart", "--cpu", "--json", tmp_path / "d.json"))
    tally = json.loads((tmp_path / "d.json").read_text())["runs"][0]["tally"]
    assert tally["flat_dials"] and tally["adopted"] == 2 and tally["orphans"] == 0
    assert set(tally["publishes"].values()) == {1} and tally["daemon_cuda"] == []
    assert "daemon CUDA: none" in out


def test_kill_in_repair_soak():
    out = ok(chaos("--kill-in-repair", "--cpu"))
    m = re.search(r"repairs completed after restart: (\d+)", out)
    assert m and int(m.group(1)) >= 1, out
    assert "orphans: 0" in out


def test_without_cpu_and_without_a_card_chaos_names_the_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the soak would run on it")
    res = chaos("--np", "2", timeout=120)
    assert res.returncode != 0 and "CHAOS_TALLY" not in res.stdout
    assert "no CUDA device" in res.stderr


@pytest.mark.parametrize("args", [["--hosts", "3", "--np", "6"], ["--scale", "--np", "16"]],
                         ids=["hosts", "scale"])
def test_hosts_and_scale_without_cpu_and_without_a_card_raise(args, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the soak would run on it")
    res = chaos(*args, "--json", tmp_path / "t.json", timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert "TALLY" not in res.stdout and "soak:" not in res.stdout
    assert not (tmp_path / "t.json").exists()


@pytest.mark.slow
def test_traffic_soak(tmp_path):
    out = ok(chaos("--traffic", "--cpu", "--out", tmp_path, timeout=600))
    detail = json.loads((tmp_path / "BENCH_DETAIL.json").read_text())["serve_traffic"]
    assert detail["shed_429"] and detail["admission_restored"] and detail["orphans"] == 0
    assert "admission restored: True" in out


@pytest.mark.slow
def test_hosts_soak_np6():
    out = ok(chaos("--hosts", "3", "--np", "6", "--cpu", timeout=900))
    assert "hosts soak: np=6 hosts=3" in out and "relay failover:" in out
    assert "native modex:" in out


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))

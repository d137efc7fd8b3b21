#!/usr/bin/env python
"""chaos — run the seeded DCN fault-injection soak and report it.

Usage::

    # np=2 soak under the launcher's --ft with a drop/delay/dup/connkill plan
    python -m ompi_tpu_torch chaos --np 2 --seed 7 \
        --plan "delay:ms=2;p=0.3,dup:p=0.15,connkill:at=9,drop:p=0.05"

    # run the same seed twice and verify the injected-fault counts
    # reproduce exactly (the determinism contract)
    python -m ompi_tpu_torch chaos --runs 2 --seed 7 --plan "drop:p=0.05,..."

    # control-plane crash soak: tpud SIGKILLs itself at the Nth
    # directive (faultsim daemonkill) mid-job; the restart must
    # re-adopt every worker (zero re-dials), run the journal-recovered
    # queued job exactly once, and leave zero orphans — same-seed
    # --runs N must reproduce the tally exactly
    python -m ompi_tpu_torch chaos --daemon-restart --runs 2 --seed 7

    # np>=16 hierarchical control-plane soak: sharded-modex boot
    # (sub-quadratic KVS ops asserted), one SIGKILL per detector
    # group mid-collective, gossip-convergence bound, full-size
    # respawn+replace; --kill-groups N leaves bystander groups that
    # must show zero reconnects; --relay adds the telemetry relays
    python -m ompi_tpu_torch chaos --scale --np 16 --runs 2

    # crash-mid-repair: the daemonkill lands ON the repair publish
    # (site daemon_repair) — the restart must finish the heal
    python -m ompi_tpu_torch chaos --kill-in-repair

    # plane-failover soak: kill rank 0's device plane mid-allreduce
    # (six event-indexed injected DMA failures) — the job must finish
    # bit-exact with the golden demote/probe/promote transition log,
    # heal-probe re-promotion, and bounded dedup_drops; --runs 2
    # verifies the trajectory reproduces exactly
    python -m ompi_tpu_torch chaos --planes --runs 2

    # multi-tenant serving soak against one warm tpud: concurrent
    # disjoint gangs (jobs_concurrent_hwm == np), p50/p99
    # submit→first-collective, retry-budget replay of a repair-killed
    # job (bystander dial-flat), deadline revoke, and a synthetic
    # stall ramp flipping admission to shedding (429 + Retry-After)
    # then restoring — the structural tally must reproduce across
    # --runs; the serve_traffic leg lands in BENCH_DETAIL.json under
    # --out (default build/ompi_tpu_torch/chaos/)
    python -m ompi_tpu_torch chaos --traffic --runs 2

    # self-check (no subprocesses): plan parsing, decision
    # determinism, transport self-healing, disabled-path state,
    # hierarchical topology/takeover, versioned gossip, get_prefix +
    # lazy AddressTable, relay batching
    python -m ompi_tpu_torch chaos --selftest

Port of the reference's ``tools/chaos.py``: the same flags, defaults,
tables and tally lines.  One flag is the port's own: every process a
soak launches (workers, daemons) runs on ``cuda:0`` and raises where
there is no card; ``--cpu`` runs them on the CPU (it is passed to the
port's ``run``/``tpud``, the counterpart of the reference's
``--cpu-devices 1``).  The workers hand the collectives tensors on
their world's device, so on the card the device plane stages CUDA IPC
windows and ``--planes`` injects its faults there.

The soak launches ``ompi_tpu_torch/tools/workers/chaos_worker.py``
under ``run --ft`` on the framed-TCP transport with short registered
deadlines (``dcn_recv_timeout`` etc.), collects each rank's
``CHAOS_TALLY`` line, and prints injected / survived / escalated
tallies.  With ``--out`` it also enables metrics+trace export and joins
the flight records (fault injections, escalations) and reconnect trace
spans into the report.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

from ompi_tpu_torch.tools import REPO as _REPO

REPO = str(_REPO)
WORKERS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "workers")
WORKER = os.path.join(WORKERS, "chaos_worker.py")
RESPAWN_WORKER = os.path.join(WORKERS, "respawn_worker.py")

DEFAULT_PLAN = "delay:ms=2;p=0.3,dup:p=0.15,connkill:at=9,drop:p=0.05"
#: --respawn soak default: latency-only — rank death comes from the
#: worker's deterministic self-kill, and a loss-free plan keeps the
#: injected-event schedule identical across runs (the determinism diff)
DEFAULT_RESPAWN_PLAN = "delay:ms=1;p=0.25"

PLANES_WORKER = os.path.join(WORKERS, "planes_worker.py")
#: --planes soak default: rank 0's first six device-window stage
#: attempts abort as simulated DMA failures — event-indexed (``n=6``),
#: so the plane-health trajectory is identical across runs and seeds
DEFAULT_PLANES_PLAN = "drop:site=device;n=6;proc=0"
#: the deterministic transition log the --planes soak AND the selftest
#: golden fixture assert: 3 consecutive strikes demote, the only stage
#: events while demoted are heal probes (events 4-6 still drop), the
#: 4th probe stages clean and its consumption promotes
GOLDEN_PLANE_TRANSITIONS = (
    "demote", "probe", "probe_fail", "probe", "probe_fail",
    "probe", "probe_fail", "probe", "promote")


def _launch(np_: int, flags: list[str], mca: dict, script: str | None,
            cpu: bool) -> list[str]:
    """The port's launcher command: ``python -m ompi_tpu_torch run -np N
    --nranks 1 <flags>`` (one rank per process, as the reference's
    ``--cpu-devices 1``), ``--cpu`` when the soak runs on the CPU, the
    ``--mca`` pairs, and the worker script (none with ``--daemon``)."""
    cmd = [sys.executable, "-m", "ompi_tpu_torch", "run", "-np", str(np_),
           "--nranks", "1", *flags] + (["--cpu"] if cpu else [])
    for k, v in mca.items():
        cmd += ["--mca", k, str(v)]
    return cmd + ([script] if script else [])


def _env(**extra: str) -> dict:
    """The soak processes' environment: this checkout first on
    ``PYTHONPATH``, plus the worker knobs in ``extra``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + ":" + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _require_card() -> None:
    """Without ``--cpu`` every soak process runs on ``cuda:0``: fail
    before launching anything where there is no card."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(
            "chaos: no CUDA device — the soak's processes run on cuda:0; "
            "pass --cpu to run them on the CPU")


def run_soak(np_: int, seed: int, plan: str, ops: int, out: str | None,
             extra_mca: list[str], timeout: float,
             cpu: bool = False) -> list[dict]:
    """One tpurun --ft soak; returns the per-rank tally dicts."""
    mca = {
        "btl": "tcp",  # the reconnect/backoff leg under test
        "btl_tcp_eager_limit": "32768",  # bursts go rendezvous
        "faultsim_enable": "1",
        "faultsim_seed": str(seed),
        "faultsim_plan": plan,
        "dcn_recv_timeout": "8",
        "dcn_cts_timeout": "8",
        "dcn_connect_timeout": "4",
    }
    if out:
        os.makedirs(out, exist_ok=True)
        mca["metrics_enable"] = "1"
        mca["metrics_output"] = os.path.join(out, "chaos")
        mca["trace_enable"] = "1"
        mca["trace_output"] = os.path.join(out, "chaos.trace")
    for kv in extra_mca:
        k, _, v = kv.partition("=")
        mca[k] = v
    cmd = _launch(np_, ["--ft"], mca, WORKER, cpu)
    env = _env(CHAOS_OPS=str(ops))
    t0 = time.time()
    res = subprocess.run(cmd, capture_output=True, timeout=timeout,
                         env=env, cwd=REPO)
    out_text = res.stdout.decode(errors="replace")
    if res.returncode != 0:
        sys.stderr.write(out_text)
        sys.stderr.write(res.stderr.decode(errors="replace"))
        raise SystemExit(f"soak failed (rc={res.returncode})")
    tallies = []
    for line in out_text.splitlines():
        # tpurun prefixes forwarded worker output with "[rank] "
        marker = "CHAOS_TALLY "
        if marker in line:
            tallies.append(json.loads(line.split(marker, 1)[1]))
    if len(tallies) != np_:
        sys.stderr.write(out_text)
        raise SystemExit(
            f"expected {np_} CHAOS_TALLY lines, got {len(tallies)}")
    tallies.sort(key=lambda t: t["proc"])
    print(f"soak: np={np_} seed={seed} ops={ops} "
          f"wall={time.time() - t0:.1f}s plan={plan!r}")
    return tallies


def render(tallies: list[dict]) -> None:
    kinds = sorted({k for t in tallies for k in t["injected"]})
    print(f"{'rank':<6}{'outcome':<22}{'ops':>5}"
          + "".join(f"{k:>10}" for k in kinds)
          + f"{'reconn':>8}{'redial':>8}{'resend':>8}{'deadl':>7}"
          f"{'dedup':>7}")
    for t in tallies:
        outcome = t["escalated"] or "survived"
        print(f"{t['proc']:<6}{outcome:<22}"
              f"{t['completed']:>2}/{t['ops']:<2}"
              + "".join(f"{t['injected'].get(k, 0):>10}" for k in kinds)
              + f"{t['reconnects']:>8}{t['retry_dials']:>8}"
              f"{t['retry_sends']:>8}{t['deadline_expired']:>7}"
              f"{t.get('dedup_drops', 0):>7}")
    injected = sum(sum(t["injected"].values()) for t in tallies)
    survived = sum(1 for t in tallies if not t["escalated"])
    escalated = len(tallies) - survived
    print(f"totals: injected={injected} survived={survived} "
          f"escalated={escalated} "
          f"dedup_drops={sum(t.get('dedup_drops', 0) for t in tallies)}")


def run_planes_soak(np_: int, seed: int, plan: str, ops: int,
                    extra_mca: list[str], timeout: float,
                    cpu: bool = False) -> list[dict]:
    """One np=2 plane-failover soak: kill rank 0's device plane
    mid-allreduce (six event-indexed injected DMA failures), assert
    the demotion → heal-probe → promotion trajectory ran exactly the
    golden transition sequence, every op completed bit-exact on both
    sides of the demotion boundary, and the host-plane dedup watermark
    absorbed the re-routed traffic without duplicate delivery."""
    mca = {
        "btl": "tcp",
        "faultsim_enable": "1",
        "faultsim_seed": str(seed),
        "faultsim_plan": plan,
        # a small threshold makes every soak allreduce device-eligible
        # (including post-split chunks), so the fault plan's stage
        # events line up with the op stream
        "dcn_device_enable": "1",
        "dcn_device_min_size": "2048",
        # short heal cadence: demotion, three failed probes, and the
        # promoting fourth all fit inside the op stream
        "dcn_plane_heal_interval": "0.1",
        "dcn_recv_timeout": "8",
        "dcn_cts_timeout": "8",
        "dcn_connect_timeout": "4",
    }
    for kv in extra_mca:
        k, _, v = kv.partition("=")
        mca[k] = v
    cmd = _launch(np_, ["--ft"], mca, PLANES_WORKER, cpu)
    env = _env(PLANES_OPS=str(ops))
    t0 = time.time()
    res = subprocess.run(cmd, capture_output=True, timeout=timeout,
                         env=env, cwd=REPO)
    out_text = res.stdout.decode(errors="replace")
    if res.returncode != 0:
        sys.stderr.write(out_text)
        sys.stderr.write(res.stderr.decode(errors="replace"))
        raise SystemExit(f"planes soak failed (rc={res.returncode})")
    tallies = []
    for line in out_text.splitlines():
        marker = "PLANES_TALLY "
        if marker in line:
            tallies.append(json.loads(line.split(marker, 1)[1]))
    if len(tallies) != np_:
        sys.stderr.write(out_text)
        raise SystemExit(
            f"expected {np_} PLANES_TALLY lines, got {len(tallies)}")
    tallies.sort(key=lambda t: t["proc"])
    # the contract: full completion on BOTH ranks (a demotion re-routes,
    # it never loses work), the golden trajectory on the faulted rank,
    # a quiet plane on the bystander, and a bounded dedup count (the
    # re-routed frames are new sends with their own seqs, not replays)
    bad = [t for t in tallies
           if t["escalated"] or t["completed"] != t["ops"]]
    if bad:
        raise SystemExit(f"planes soak: incomplete ranks: {bad}")
    t0w = tallies[0]
    events = [tr[0] for tr in t0w["transitions"]]
    if events != list(GOLDEN_PLANE_TRANSITIONS):
        raise SystemExit(
            f"planes soak: rank 0 transitions {events} != golden "
            f"{list(GOLDEN_PLANE_TRANSITIONS)}")
    pl = t0w["plane"]
    if not (pl["plane_demotions"] >= 1 and pl["plane_promotions"] >= 1
            and pl["plane_heal_probes"] >= pl["plane_promotions"]):
        raise SystemExit(f"planes soak: rank 0 plane counters: {pl}")
    if not t0w["healthy"]:
        raise SystemExit(
            "planes soak: rank 0 did not finish re-promoted (healthy)")
    for t in tallies[1:]:
        if t["plane"]["plane_demotions"] or t["transitions"]:
            raise SystemExit(
                f"planes soak: bystander rank {t['proc']} has "
                f"plane-health churn: {t}")
    if sum(t["dedup_drops"] for t in tallies) > 2:
        raise SystemExit(
            f"planes soak: dedup_drops not bounded: {tallies}")
    # every window freed (a dropped stage opens none; a consumed one is
    # closed) and the card's allocator no fuller than before the ops
    leaks = [(t["proc"], t["windows_left"], t["cuda_allocated"])
             for t in tallies if t["windows_left"]
             or t["cuda_allocated"][1] > t["cuda_allocated"][0]]
    if leaks:
        raise SystemExit(
            f"planes soak: windows or device memory left: {leaks}")
    print(f"planes soak: np={np_} seed={seed} ops={ops} "
          f"wall={time.time() - t0:.1f}s plan={plan!r}")
    return tallies


def render_planes(tallies: list[dict]) -> None:
    print(f"{'rank':<6}{'outcome':<12}{'ops':>7}{'drops':>7}"
          f"{'demote':>8}{'probe':>7}{'promote':>9}{'dedup':>7}"
          "  transitions")
    for t in tallies:
        pl = t["plane"]
        ev = [tr[0] for tr in t["transitions"]]
        print(f"{t['proc']:<6}{t['escalated'] or 'survived':<12}"
              f"{t['completed']:>3}/{t['ops']:<3}"
              f"{t['injected'].get('drop', 0):>7}"
              f"{pl['plane_demotions']:>8}{pl['plane_heal_probes']:>7}"
              f"{pl['plane_promotions']:>9}{t['dedup_drops']:>7}"
              f"  {' '.join(ev) if ev else '-'}")
    print(f"totals: demotions="
          f"{sum(t['plane']['plane_demotions'] for t in tallies)} "
          f"promotions="
          f"{sum(t['plane']['plane_promotions'] for t in tallies)} "
          f"device_sends="
          f"{sum(t['plane']['device_sends'] for t in tallies)} "
          f"fallbacks="
          f"{sum(t['plane']['device_fallbacks'] for t in tallies)} "
          f"dedup_drops={sum(t['dedup_drops'] for t in tallies)}")


def join_outputs(out: str) -> None:
    """Fold flight records and reconnect trace spans into the report."""
    flights = []
    for path in sorted(glob.glob(os.path.join(out, "*.flight.*.jsonl"))) \
            + sorted(glob.glob(os.path.join(out, "chaos.*.jsonl"))):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    flights.append(json.loads(line))
    by_reason: dict[str, int] = {}
    for s in flights:
        by_reason[s.get("reason", "?")] = by_reason.get(
            s.get("reason", "?"), 0) + 1
    if by_reason:
        print("flight records: "
              + ", ".join(f"{k}={v}" for k, v in sorted(by_reason.items())))
    spans = 0
    for path in sorted(glob.glob(os.path.join(out, "chaos.trace.*.json"))):
        try:
            with open(path) as f:
                doc = json.load(f)
        except ValueError:
            continue
        spans += sum(1 for ev in doc.get("traceEvents", [])
                     if ev.get("name") == "reconnect")
    if spans:
        print(f"trace: {spans} reconnect span(s) recorded")


def run_respawn_soak(np_: int, seed: int, plan: str, ops: int,
                     extra_mca: list[str], timeout: float,
                     out: str | None = None,
                     cpu: bool = False) -> list[dict]:
    """One ``tpurun --ft --respawn`` soak: a worker SIGKILLs itself
    mid-collective, the launcher respawns it, survivors' ``replace()``
    restores full membership, and every rank must finish the
    post-recovery phase at the ORIGINAL size with exact results.

    With ``out`` set, metrics/trace exports are enabled: the run must
    leave telemetry files for EVERY rank even though one incarnation
    died by SIGKILL — the crash-path export contract (the victim's
    live-appended flight file + its reborn incarnation's finalize
    export; survivors' escalation paths dump ``partial: true``)."""
    mca = {
        "btl": "tcp",
        "dcn_recv_timeout": "8",
        "dcn_cts_timeout": "8",
        "dcn_connect_timeout": "4",
    }
    if out:
        os.makedirs(out, exist_ok=True)
        mca["metrics_enable"] = "1"
        mca["metrics_output"] = os.path.join(out, "chaos")
        mca["trace_enable"] = "1"
        mca["trace_output"] = os.path.join(out, "chaos.trace")
    if plan:
        mca.update({"faultsim_enable": "1", "faultsim_seed": str(seed),
                    "faultsim_plan": plan})
    for kv in extra_mca:
        k, _, v = kv.partition("=")
        mca[k] = v
    cmd = _launch(np_, ["--ft", "--respawn"], mca, RESPAWN_WORKER, cpu)
    env = _env(RESPAWN_OPS=str(ops))
    t0 = time.time()
    res = subprocess.run(cmd, capture_output=True, timeout=timeout,
                         env=env, cwd=REPO)
    out_text = res.stdout.decode(errors="replace")
    if res.returncode != 0:
        sys.stderr.write(out_text)
        sys.stderr.write(res.stderr.decode(errors="replace"))
        raise SystemExit(f"respawn soak failed (rc={res.returncode})")
    tallies = []
    for line in out_text.splitlines():
        marker = "RESPAWN_TALLY "
        if marker in line:
            tallies.append(json.loads(line.split(marker, 1)[1]))
    if len(tallies) != np_:
        sys.stderr.write(out_text)
        raise SystemExit(
            f"expected {np_} RESPAWN_TALLY lines, got {len(tallies)}")
    tallies.sort(key=lambda t: t["proc"])
    # the contract: full size restored, every rank finished phase 2,
    # at least one survivor accounted a restoration
    bad = [t for t in tallies
           if t["size"] != np_ or t["post"] != t["ops"]]
    if bad:
        raise SystemExit(f"respawn soak: incomplete recovery: {bad}")
    if sum(t["respawns"] for t in tallies) < 1:
        raise SystemExit(
            f"respawn soak: no rank accounted respawns >= 1: {tallies}")
    if not any(t["incarnation"] > 0 for t in tallies):
        raise SystemExit(
            f"respawn soak: no reborn incarnation completed: {tallies}")
    if out:
        # crash-path export contract: telemetry files for every rank
        # despite the mid-run SIGKILL
        missing = [p for p in range(np_)
                   if not os.path.exists(
                       os.path.join(out, f"chaos.{p}.jsonl"))]
        if missing:
            raise SystemExit(
                f"respawn soak: no metrics export for ranks {missing} "
                f"after the SIGKILL run (crash-path export broken?)")
        partial = 0
        for p in range(np_):
            with open(os.path.join(out, f"chaos.{p}.jsonl")) as f:
                rows = [json.loads(l) for l in f if l.strip()]
            if rows and rows[-1].get("partial"):
                partial += 1
        flights = len(glob.glob(os.path.join(out, "*.flight.*.jsonl")))
        print(f"exports: {np_}/{np_} rank jsonl files "
              f"({partial} partial), {flights} live flight file(s)")
    print(f"respawn soak: np={np_} seed={seed} ops={ops} "
          f"wall={time.time() - t0:.1f}s plan={plan!r}")
    return tallies


def render_respawn(tallies: list[dict]) -> None:
    print(f"{'rank':<6}{'incarn':>7}{'phase1':>8}{'phase2':>8}"
          f"{'size':>6}{'respawns':>9}{'reconn':>8}{'dedup':>7}")
    for t in tallies:
        print(f"{t['proc']:<6}{t['incarnation']:>7}"
              f"{t['completed']:>5}/{t['ops']:<2}"
              f"{t['post']:>5}/{t['ops']:<2}"
              f"{t['size']:>6}{t['respawns']:>9}"
              f"{t.get('reconnects', 0):>8}{t['dedup_drops']:>7}")
    print(f"totals: respawned={sum(t['respawns'] for t in tallies)} "
          f"reborn={sum(1 for t in tallies if t['incarnation'] > 0)} "
          f"reconnects={sum(t.get('reconnects', 0) for t in tallies)} "
          f"dedup_drops={sum(t.get('dedup_drops', 0) for t in tallies)} "
          f"full_size={all(t['size'] == len(tallies) for t in tallies)}")


SCALE_WORKER = os.path.join(WORKERS, "scale_worker.py")


def run_scale_soak(np_: int, seed: int, ops: int, kill_at: int,
                   group_size: int, period: float, kill_groups: int,
                   relay: bool, plan: str, extra_mca: list[str],
                   timeout: float, cpu: bool = False) -> list[dict]:
    """The hierarchical-control-plane headline at np≥16: boot rides
    the sharded lazy modex (per-rank KVS ``get``s must be O(1)+lazy,
    not P−1 — asserted from the workers' op counters), one rank per
    targeted detector group SIGKILLs itself mid-collective, survivors
    must converge on the full failure set within ``2 × period ×
    ceil(log2(groups))`` (hierarchical gossip + anti-entropy digest),
    and the respawn+replace leg must complete at FULL size with exact
    phase-2 results.  With ``kill_groups`` below the group count, the
    bystander groups' ranks must show ZERO reconnects/retry_dials —
    the failure never perturbed them."""
    from ompi_tpu_torch.ft.detector import compute_groups

    groups = compute_groups(np_, group_size)
    targets = groups[:kill_groups] if kill_groups > 0 else groups
    victims = sorted(g[len(g) // 2] if len(g) > 2 else g[-1]
                     for g in targets)
    mca = {
        "btl": "tcp",
        "ft_group_size": str(group_size),
        "ft_detector_period": str(period),
        # generous silence timeout: np≥16 on an oversubscribed CPU box
        # schedules heartbeat threads late, and a false timeout of a
        # LIVE rank poisons the replace round.  Real deaths are still
        # detected fast — the reborn incarnation's boot heartbeat (the
        # rebirth rule) and the in-band strike path don't wait for it.
        "ft_detector_timeout": str(max(6.0, 6 * period)),
        "dcn_recv_timeout": "30",
        "dcn_cts_timeout": "30",
        "dcn_connect_timeout": "8",
    }
    if relay:
        mca["telemetry_enable"] = "1"
        mca["telemetry_relay"] = "1"
    if plan:
        mca.update({"faultsim_enable": "1", "faultsim_seed": str(seed),
                    "faultsim_plan": plan})
    for kv in extra_mca:
        k, _, v = kv.partition("=")
        mca[k] = v
    cmd = _launch(np_, ["--ft", "--respawn"], mca, SCALE_WORKER, cpu)
    env = _env(SCALE_OPS=str(ops), SCALE_KILL_AT=str(kill_at),
               SCALE_VICTIMS=",".join(str(v) for v in victims))
    t0 = time.time()
    res = subprocess.run(cmd, capture_output=True, timeout=timeout,
                         env=env, cwd=REPO)
    out_text = res.stdout.decode(errors="replace")
    if res.returncode != 0:
        sys.stderr.write(out_text)
        sys.stderr.write(res.stderr.decode(errors="replace"))
        raise SystemExit(f"scale soak failed (rc={res.returncode})")
    tallies = []
    for line in out_text.splitlines():
        marker = "SCALE_TALLY "
        if marker in line:
            tallies.append(json.loads(line.split(marker, 1)[1]))
    if len(tallies) != np_:
        sys.stderr.write(out_text)
        raise SystemExit(
            f"expected {np_} SCALE_TALLY lines, got {len(tallies)}")
    tallies.sort(key=lambda t: t["proc"])
    # full-size exact completion
    bad = [t["proc"] for t in tallies
           if t["size"] != np_ or t["post"] != t["ops"]]
    if bad:
        raise SystemExit(f"scale soak: incomplete recovery on {bad}")
    reborn = [t["proc"] for t in tallies if t["incarnation"] > 0]
    if sorted(reborn) != victims:
        raise SystemExit(
            f"scale soak: reborn {reborn} != victims {victims}")
    # sub-quadratic boot: per-rank modex gets O(1)+lazy, never P−1
    for t in tallies:
        if t["incarnation"]:
            continue  # reborn incarnations take the eager path by design
        gets = int(t["boot_kvs_ops"].get("get", 0))
        if gets > 2 or gets >= np_ - 1:
            raise SystemExit(
                f"scale soak: rank {t['proc']} issued {gets} modex "
                f"gets at boot (sharded modex should need <= 2)")
        if int(t.get("boot_lazy", 0)) > 4:
            raise SystemExit(
                f"scale soak: rank {t['proc']} resolved "
                f"{t['boot_lazy']} addresses during boot")
    # convergence: survivors' full-failure-set instants within the
    # hierarchical gossip bound
    stamps = [t["t_detect_all"] for t in tallies
              if t["incarnation"] == 0 and t["t_detect_all"] > 0]
    spread = (max(stamps) - min(stamps)) if len(stamps) > 1 else 0.0
    bound = scale_bound(period, len(groups))
    if stamps and spread > bound:
        # the miss must name its late ranks: their detection stamps and
        # paths, and every tally as recorded
        render_scale(tallies)
        for t in tallies:
            print("SCALE_TALLY " + json.dumps(t, sort_keys=True))
        raise SystemExit(
            f"scale soak: failure-set convergence spread {spread:.3f}s "
            f"exceeds 2*period*ceil(log2(groups)) = {bound:.3f}s")
    # bystander groups: untouched by the whole affair
    if kill_groups > 0:
        touched = {i for i, _ in enumerate(groups) if i < kill_groups}
        noisy = [t["proc"] for t in tallies
                 if t["group"] not in touched
                 and (t["reconnects"] or t["retry_dials"])]
        if noisy:
            raise SystemExit(
                f"scale soak: bystander-group ranks {noisy} show "
                "reconnects/retry_dials")
    print(f"scale soak: np={np_} groups={len(groups)} "
          f"victims={victims} ops={ops} period={period} "
          f"convergence={spread * 1e3:.1f} ms (bound "
          f"{bound * 1e3:.0f} ms) wall={time.time() - t0:.1f}s")
    return tallies


def scale_bound(period: float, groups: int) -> float:
    """The convergence bound: ``2 × period × ceil(log2(groups))``."""
    import math

    return 2 * period * max(1, math.ceil(math.log2(max(2, groups))))


def scale_late(tallies: list[dict]) -> list[dict]:
    """The survivors whose convergence stamp trails the earliest one by
    more than half the bound — or, when none does, the one latest — each
    with its detection stamps relative to the earliest convergence:
    ``boot`` (detector built), ``caught`` (left the aborted collective),
    ``seen`` (per victim: offset and the path that marked it) and
    ``all`` (every victim seen)."""
    surv = [t for t in tallies
            if t["incarnation"] == 0 and t.get("t_detect_all", 0) > 0]
    if not surv:
        return []
    t0 = min(t["t_detect_all"] for t in surv)
    bound = scale_bound(float(surv[0].get("period") or 0.0),
                        int(surv[0].get("groups") or 1))
    late = [t for t in surv if t["t_detect_all"] - t0 > bound / 2]
    if not late:
        late = [max(surv, key=lambda t: t["t_detect_all"])]

    def rel(x: float):
        return round(x - t0, 4) if x else None

    return [{"proc": t["proc"], "group": t["group"],
             "boot": rel(t.get("t_boot", 0.0)),
             "caught": rel(t.get("t_caught", 0.0)),
             "seen": {v: {"at": rel(s["t"]), "how": s["how"]}
                      for v, s in (t.get("t_seen") or {}).items()},
             "all": rel(t["t_detect_all"])}
            for t in sorted(late, key=lambda t: t["proc"])]


def render_scale(tallies: list[dict]) -> None:
    print(f"{'rank':<6}{'grp':>4}{'incarn':>7}{'phase1':>8}{'phase2':>8}"
          f"{'size':>6}{'bgets':>6}{'lazy':>6}{'reconn':>8}{'redial':>8}"
          f"{'stale':>7}")
    for t in tallies:
        det = t.get("detector") or {}
        print(f"{t['proc']:<6}{t['group']:>4}{t['incarnation']:>7}"
              f"{t['completed']:>5}/{t['ops']:<2}"
              f"{t['post']:>5}/{t['ops']:<2}"
              f"{t['size']:>6}"
              f"{int(t['boot_kvs_ops'].get('get', 0)):>6}"
              f"{t.get('lazy_resolved', 0):>6}"
              f"{t['reconnects']:>8}{t['retry_dials']:>8}"
              f"{det.get('stale_gossip_dropped', 0):>7}")
    total_gets = sum(int(t["kvs_ops"].get("get", 0)) for t in tallies)
    n = len(tallies)
    print(f"totals: kvs_gets={total_gets} (quadratic would be "
          f">= {n * (n - 1)}), lazy_resolved="
          f"{sum(t.get('lazy_resolved', 0) for t in tallies)}, "
          f"gossip_tx={sum((t.get('detector') or {}).get('gossip_tx', 0) for t in tallies)}, "
          f"relayed={sum((t.get('detector') or {}).get('gossip_relayed', 0) for t in tallies)}, "
          f"digest_syncs={sum((t.get('detector') or {}).get('digest_syncs', 0) for t in tallies)}")
    for r in scale_late(tallies):
        seen = " ".join(f"v{v}@{s['at']:+.3f}s/{s['how']}"
                        for v, s in r["seen"].items())
        print(f"late: rank {r['proc']} grp {r['group']} "
              f"(s from the earliest convergence) boot "
              f"{_fmt_off(r['boot'])} caught {_fmt_off(r['caught'])} "
              f"seen {seen or '-'} all {_fmt_off(r['all'])}")


def _fmt_off(x) -> str:
    return "-" if x is None else f"{x:+.3f}s"


#: the daemon soaks' job script (the port's counterpart of the
#: reference's ``serve_job_worker.py``: the same ``SERVE_*`` knobs)
JOB_WORKER = os.path.join(REPO, "ompi_tpu_torch", "examples", "serve_job.py")


def _spawn_daemon(np_: int, mca: dict, timeout: float = 90.0,
                  extra_args: list[str] | None = None, cpu: bool = False):
    """Launch ``run --daemon`` and return (proc, lines, ops_url)."""
    import threading

    cmd = _launch(np_, ["--daemon", *(extra_args or ())], mca, None, cpu)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, env=_env(), cwd=REPO)
    lines: list[str] = []

    def _read():
        for raw in iter(proc.stdout.readline, b""):
            lines.append(raw.decode(errors="replace"))

    threading.Thread(target=_read, daemon=True).start()
    deadline = time.time() + timeout
    while time.time() < deadline:
        for line in list(lines):
            if "[tpud] ops: " in line:
                url = line.split("[tpud] ops: ", 1)[1].split("/jobs")[0]
                return proc, lines, url
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    sys.stderr.write("".join(lines))
    raise SystemExit("daemon never printed its ops URL")


def _journal_pids(journal: str) -> list[int]:
    pids = {}
    try:
        with open(journal) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("ev") == "spawn":
                    pids[int(rec.get("rank", -1))] = int(
                        rec.get("pid", 0))
                elif rec.get("ev") == "shutdown":
                    pids.clear()
    except OSError:
        pass
    return [p for p in pids.values() if p > 0]


def _job_events(journal: str, job_id: str) -> list[str]:
    """The journal's ``submit``/``publish``/``finish`` records about one
    job, in journal order (the soak's order evidence)."""
    out = []
    try:
        with open(journal) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                job = rec.get("job") or rec.get("d") or {}
                if isinstance(job, dict) and job.get("id") == job_id:
                    out.append(rec.get("ev"))
    except OSError:
        pass
    return out


def run_daemon_restart_soak(np_: int, seed: int, kill_at: int,
                            extra_mca: list[str],
                            timeout: float, cpu: bool = False,
                            orders: list | None = None) -> dict:
    """The restart-hygiene headline, deterministically from one seed:
    a tpud with ``daemonkill:at=N`` armed SIGKILLs itself at the Nth
    directive-publish attempt — mid-job for the rank-1 submission, the
    rank-0 job still queued in the journal.  The operator restart (no
    fault plan) must re-adopt every resident worker with ZERO re-dials
    (flat reconnect/retry_dials in the completion records, incarnation
    0 — the warm CIDs never went away), run the journal-recovered
    queued job exactly once (journal publish count per id == 1: the
    cursor dedup, not luck), and leave zero orphaned processes after
    the final shutdown.  ``orders`` (a list) receives job B's journal
    records in order, at the crash and before the final shutdown."""
    import tempfile

    from ompi_tpu_torch.serve import client
    from ompi_tpu_torch.serve import state as _sstate

    tmp = tempfile.mkdtemp(prefix="tpud-chaos-")
    pidfile = os.path.join(tmp, "tpud.pid")
    journal = pidfile + ".journal"
    base_mca = {
        "btl": "tcp",
        "serve_pidfile": pidfile,
        "serve_reattach_timeout": "30",
        "dcn_recv_timeout": "8",
        "dcn_cts_timeout": "8",
        "dcn_connect_timeout": "4",
    }
    for kv in extra_mca:
        k, _, v = kv.partition("=")
        base_mca[k] = v
    t0 = time.time()
    d1 = d2 = None
    lines1: list[str] = []
    lines2: list[str] = []
    try:
        d1, lines1, url1 = _spawn_daemon(np_, {
            **base_mca,
            "faultsim_enable": "1",
            "faultsim_seed": str(seed),
            "faultsim_plan": f"daemonkill:at={kill_at}"}, cpu=cpu)
        # job A holds proc 0 mid-run across the crash; job B's publish
        # is the Nth directive attempt that pulls the trigger
        ja = client.submit(url1, JOB_WORKER, tenant="alice", nprocs=1,
                           env={"SERVE_SLEEP": "6"})
        deadline = time.time() + 60
        while time.time() < deadline:
            if client.status(url1, ja["id"]).get("state") == "running":
                break
            time.sleep(0.1)
        # the daemon stays CUDA-free while its workers hold contexts
        daemon_cuda = _daemon_cuda(d1.pid, url1)
        jb = client.submit(url1, JOB_WORKER, tenant="bob", nprocs=1)
        d1.wait(timeout=60)
        if d1.returncode == 0:
            raise SystemExit(
                "daemonkill never fired (daemon exited cleanly):\n"
                + "".join(lines1))
        worker_pids = _journal_pids(journal)
        survivors = [p for p in worker_pids if _sstate.pid_alive(p)]
        replay = _sstate.Journal.replay(journal)
        at_crash = _job_events(journal, jb["id"])
        d2, lines2, url2 = _spawn_daemon(np_, base_mca, cpu=cpu)
        ra = client.wait(url2, ja["id"], timeout=90)
        rb = client.wait(url2, jb["id"], timeout=90)
        st = client.status(url2)
        daemon_cuda += _daemon_cuda(d2.pid, url2)
        flat = all(
            rec["dials_before"] == rec["dials_after"]
            for r in (ra, rb) for rec in (r.get("ranks") or {}).values())
        incs = [int(st["procs"][str(p)]["incarnation"])
                for p in range(np_)]
        adopted = sum(1 for line in lines2 if "re-adopted rank" in line)
        pubs: dict[str, int] = {}
        with open(journal) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if (rec.get("ev") == "publish"
                        and rec.get("d", {}).get("kind", "job") == "job"):
                    jid = rec["d"].get("id", "?")
                    pubs[jid] = pubs.get(jid, 0) + 1
        if orders is not None:
            orders.append({"job": jb["id"], "at_crash": at_crash,
                           "after_restart": _job_events(journal, jb["id"])})
        client.shutdown(url2)
        rc2 = d2.wait(timeout=60)
        time.sleep(0.5)
        orphans = [p for p in _journal_pids(journal) + worker_pids
                   if _sstate.pid_alive(p)]
        tally = {
            "injected": {"daemonkill": 1},
            "directives_before_kill": int(replay["cursor"]),
            "queued_in_journal": len(replay["queued"]),
            "survivors_at_restart": len(survivors),
            "adopted": adopted,
            "incarnations": incs,
            "jobs": {ja["id"]: ra["state"], jb["id"]: rb["state"]},
            "publishes": pubs,
            "flat_dials": flat,
            "restart_rc": rc2,
            "orphans": len(orphans),
            "daemon_cuda": daemon_cuda,
        }
        ok = (ra["state"] == "done" and rb["state"] == "done"
              and flat and incs == [0] * np_ and adopted == np_
              and all(n == 1 for n in pubs.values())
              and rc2 == 0 and not orphans and not daemon_cuda)
        if not ok:
            sys.stderr.write("".join(lines1))
            sys.stderr.write("".join(lines2))
            raise SystemExit(f"daemon-restart soak failed: {tally}")
        print(f"daemon-restart soak: np={np_} seed={seed} "
              f"kill_at={kill_at} wall={time.time() - t0:.1f}s")
        return tally
    finally:
        for d in (d1, d2):
            if d is not None and d.poll() is None:
                d.kill()
        for p in _journal_pids(journal):
            if _sstate.pid_alive(p):
                try:
                    os.kill(p, 9)
                except OSError:
                    pass


def _daemon_cuda(pid: int, url: str) -> list[str]:
    """What shows that the daemon process brought up CUDA: the
    ``cuda_initialized`` of its ``/json`` daemon line and any
    ``/dev/nvidia*`` file it holds open (read from ``/proc/<pid>/fd``,
    not from its own report).  Empty for a CUDA-free daemon — it only
    schedules; its workers hold the contexts."""
    import urllib.request

    found = []
    with urllib.request.urlopen(url + "/json", timeout=5) as r:
        if (json.loads(r.read().decode()).get("daemon") or {}).get(
                "cuda_initialized"):
            found.append("cuda_initialized")
    return sorted(set(found + _nvidia_fds(pid)))


def _nvidia_fds(pid: int) -> list[str]:
    """The ``/dev/nvidia*`` files process ``pid`` holds open (read from
    ``/proc/<pid>/fd``): a CUDA context holds them, an import does not."""
    found = set()
    fd_dir = f"/proc/{pid}/fd"
    try:
        fds = os.listdir(fd_dir)
    except OSError:
        return []  # gone, or not ours to read
    for fd in fds:
        try:
            target = os.readlink(os.path.join(fd_dir, fd))
        except OSError:
            continue  # closed between the listing and the read
        if target.startswith("/dev/nvidia"):
            found.add(target)
    return sorted(found)


def _stall_injector(ingest: str, stop_evt):
    """Feed a running daemon's OWN telemetry ingest a synthetic proc-9
    stall ramp (+2 s of ring stall per frame, 5 ms cadence) — the
    event-space analogue of a congested mesh.  The admission
    controller folds it exactly like a real straggler feed, so the
    soak trips shedding without slowing the real ranks."""
    import socket as _socket
    import threading

    from ompi_tpu_torch.metrics.live import _send_frame

    def run():
        try:
            host, port = ingest.rsplit(":", 1)
            s = _socket.create_connection((host, int(port)), timeout=2)
        except (OSError, ValueError):
            return
        stall = 0
        try:
            while not stop_evt.is_set():
                stall += 2_000_000_000
                _send_frame(s, {"proc": 9, "nprocs": 2,
                                "ts_ns": time.time_ns(),
                                "native": {"ring_stall_ns": stall}})
                time.sleep(0.005)
        except OSError:
            pass
        finally:
            try:
                s.close()
            except OSError:
                pass

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


#: where the traffic leg's ``BENCH_DETAIL.json`` goes without ``--out``
#: (never the reference's repo-root file)
DETAIL_DIR = os.path.join(REPO, "build", "ompi_tpu_torch", "chaos")


def _bench_detail_merge(leg: str, payload: dict, out: str = "") -> None:
    """Merge one leg into ``<out>/BENCH_DETAIL.json`` (default
    :data:`DETAIL_DIR`; created on first use, other legs preserved)."""
    os.makedirs(out or DETAIL_DIR, exist_ok=True)
    path = os.path.join(out or DETAIL_DIR, "BENCH_DETAIL.json")
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        doc = {}
    if not isinstance(doc, dict):
        doc = {}
    doc[leg] = payload
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{path}: {leg} leg written")


def run_traffic_soak(np_: int, seed: int, tenants: int, jobs_per: int,
                     extra_mca: list[str], timeout: float,
                     cpu: bool = False) -> dict:
    """The overload-safety headline under real multi-tenant traffic,
    one warm mesh, four phases:

    A. *overlap* — ``jobs_per`` nprocs=1 jobs per tenant in a seeded
       interleave; the any-fit scheduler must run ``np`` of them
       concurrently (``jobs_concurrent_hwm == np``) and every one
       completes; p50/p99 submit→first-collective and the per-tenant
       latency spread come from the job records' ``submit_ns`` /
       per-rank ``t_start_ns`` stamps.
    B. *churn* — a self-SIGKILLing job (one-shot via SERVE_KILL_FLAG)
       is killed by mesh repair and replayed exactly once on the
       retry budget while a concurrently running disjoint bystander
       gang finishes dial-flat.
    C. *deadline* — a slow collectives loop blows the per-job
       deadline; the daemon revokes exactly its comm (typed
       ``DeadlineExpired``) and the gang serves the next job at once.
    D. *overload* — a synthetic stall ramp into the daemon's own
       telemetry ingest flips admission to shedding: the idle-tenant
       floor admits one probe, the next sheds (429 + Retry-After),
       and cutting the ramp restores admission and drains the probes.

    The structural tally (counts, states, booleans) is the
    determinism contract under ``--runs``; latencies and the overlap
    fraction are wall clock and reported only."""
    import random
    import tempfile
    import threading

    from ompi_tpu_torch.serve import client
    from ompi_tpu_torch.serve import state as _sstate

    if tenants < 3:
        raise SystemExit("--traffic needs --tenants >= 3")
    tmp = tempfile.mkdtemp(prefix="tpud-traffic-")
    pidfile = os.path.join(tmp, "tpud.pid")
    journal = pidfile + ".journal"
    names = [f"tenant{i}" for i in range(tenants)]
    base_mca = {
        "btl": "tcp",
        "serve_pidfile": pidfile,
        "serve_max_pending": "16",
        # 0.5 s of fresh stall per monitor tick: far above anything
        # the real nprocs=1 jobs can accrue, far below the ramp
        "serve_admission_stall_ns": str(500_000_000),
        "serve_job_deadline_s": "8",
        "serve_retry_budget": "1",
        "dcn_recv_timeout": "8",
        "dcn_cts_timeout": "8",
        "dcn_connect_timeout": "4",
    }
    for kv in extra_mca:
        k, _, v = kv.partition("=")
        base_mca[k] = v
    t0 = time.time()
    d = None
    lines: list[str] = []
    stop_inj = threading.Event()
    try:
        d, lines, url = _spawn_daemon(np_, base_mca, cpu=cpu)

        def adm_state() -> str:
            return str((client.status(url).get("admission") or {})
                       .get("state", ""))

        def start_ms(rec: dict) -> float:
            return (min(int(rr["t_start_ns"])
                        for rr in (rec.get("ranks") or {}).values())
                    - int(rec.get("submit_ns", 0))) / 1e6

        # -- phase A: overlap + latency --------------------------------
        order = [(t, j) for j in range(jobs_per) for t in names]
        random.Random(seed).shuffle(order)
        submitted = [client.submit(url, JOB_WORKER, tenant=t, nprocs=1,
                                   env={"SERVE_SLEEP": "1.0"})
                     for t, _ in order]
        stop_sample = threading.Event()
        samples: list[int] = []

        def sampler():
            while not stop_sample.is_set():
                try:
                    samples.append(len(client.status(url)["running"]))
                except client.ServeError:
                    pass
                time.sleep(0.05)

        threading.Thread(target=sampler, daemon=True).start()
        recs = [client.wait(url, j["id"], timeout=timeout)
                for j in submitted]
        stop_sample.set()
        lat_ms = sorted(start_ms(rec) for rec in recs)
        per_tenant_done = {t: 0 for t in names}
        per_tenant_lat: dict[str, list[float]] = {t: [] for t in names}
        for rec in recs:
            per_tenant_done[rec["tenant"]] += int(rec["state"] == "done")
            per_tenant_lat[rec["tenant"]].append(start_ms(rec))

        # -- phase B: churn — repair-kill + retry, bystander flat ------
        flag = os.path.join(tmp, "killed.flag")
        by = client.submit(url, JOB_WORKER, tenant=names[1], nprocs=1,
                           env={"SERVE_SLEEP": "3"})
        jk = client.submit(url, JOB_WORKER, tenant=names[0], nprocs=1,
                           env={"SERVE_KILL_RANK": "0",
                                "SERVE_KILL_FLAG": flag})
        rby = client.wait(url, by["id"], timeout=timeout)
        rjk = client.wait(url, jk["id"], timeout=timeout)
        bystander_flat = (rby["state"] == "done" and all(
            rec["dials_before"] == rec["dials_after"]
            for rec in rby["ranks"].values()))

        # -- phase C: deadline expiry — revoke, typed, gang alive ------
        jd_ = client.submit(url, JOB_WORKER, tenant=names[2], nprocs=1,
                            env={"SERVE_ITERS": "200",
                                 "SERVE_ITER_SLEEP": "0.4"})
        rdead = client.wait(url, jd_["id"], timeout=timeout)
        deadline_typed = str(rdead.get("error", "")).startswith(
            "DeadlineExpired")
        after = client.submit(url, JOB_WORKER, tenant=names[2],
                              nprocs=1)
        gang_alive = client.wait(
            url, after["id"], timeout=timeout)["state"] == "done"

        # -- phase D: overload — shed, then restore --------------------
        info = _sstate.read_pidfile(pidfile) or {}
        inj = _stall_injector(str(info.get("ingest", "")), stop_inj)
        deadline_t = time.time() + 60
        while adm_state() != "shedding" and time.time() < deadline_t:
            time.sleep(0.05)
        if adm_state() != "shedding":
            sys.stderr.write("".join(lines))
            raise SystemExit("stall ramp never tripped admission")
        # the idle-tenant floor: one probe in, the next sheds.  A
        # real zero-stall frame folding between two ramp frames can
        # flicker the streak, so loop to the first true shed — every
        # flicker-admitted probe must still drain after the restore
        probes = [client.submit(url, JOB_WORKER, tenant="probe",
                                nprocs=1)]
        shed_err = None
        deadline_t = time.time() + 60
        while shed_err is None and time.time() < deadline_t:
            try:
                probes.append(client.submit(
                    url, JOB_WORKER, tenant="probe", nprocs=1))
                time.sleep(0.1)
            except client.ServeError as e:
                if e.status != 429 or e.retry_after is None:
                    raise
                shed_err = e
        if shed_err is None:
            sys.stderr.write("".join(lines))
            raise SystemExit("shedding admission never returned 429")
        stop_inj.set()
        inj.join(timeout=5)
        probe_recs = [client.wait(url, j["id"], timeout=timeout)
                      for j in probes]
        deadline_t = time.time() + 60
        while adm_state() != "ok" and time.time() < deadline_t:
            time.sleep(0.05)
        restored = adm_state() == "ok"

        st = client.status(url)
        counters = {k: int(v)
                    for k, v in (st.get("counters") or {}).items()}
        client.shutdown(url)
        rc = d.wait(timeout=60)
        time.sleep(0.5)
        orphans = [p for p in _journal_pids(journal)
                   if _sstate.pid_alive(p)]
        n_jobs = len(lat_ms)
        fairness = {t: round(sum(v) / max(1, len(v)), 1)
                    for t, v in per_tenant_lat.items()}
        tally = {
            # structural half — the determinism contract
            "np": np_, "tenants": tenants,
            "per_tenant_done": per_tenant_done,
            "hwm": counters.get("jobs_concurrent_hwm", 0),
            "bystander_flat": bystander_flat,
            "retried": counters.get("jobs_retried", 0),
            "retry_state": rjk["state"],
            "retry_attempts": int(rjk.get("retries", 0)),
            "deadline_expired": counters.get("jobs_deadline_expired",
                                             0),
            "deadline_state": rdead["state"],
            "deadline_typed": deadline_typed,
            "gang_alive_after_deadline": gang_alive,
            "shed": counters.get("jobs_shed", 0),
            "shed_429": shed_err.status == 429,
            "shed_retry_after": float(shed_err.retry_after),
            "probes_completed": all(r["state"] == "done"
                                    for r in probe_recs),
            "admission_restored": restored,
            "shutdown_rc": rc, "orphans": len(orphans),
            # wall-clock half — reported, excluded from the shape
            "p50_ms": round(lat_ms[n_jobs // 2], 1),
            "p99_ms": round(lat_ms[min(n_jobs - 1,
                                       int(n_jobs * 0.99))], 1),
            "overlap_frac": round(sum(1 for c in samples if c >= 2)
                                  / max(1, len(samples)), 3),
            "fairness_ms": fairness,
            "probes": len(probes),
            "wall_s": round(time.time() - t0, 1),
        }
        ok = (tally["hwm"] == min(np_, tenants * jobs_per)
              and all(n == jobs_per
                      for n in per_tenant_done.values())
              and bystander_flat
              and tally["retried"] == 1
              and tally["retry_state"] == "done"
              and tally["retry_attempts"] == 1
              and tally["deadline_expired"] == 1
              and tally["deadline_state"] == "failed"
              and deadline_typed and gang_alive
              and tally["shed"] == 1 and tally["probes_completed"]
              and restored and rc == 0 and not orphans)
        if not ok:
            sys.stderr.write("".join(lines))
            raise SystemExit(f"traffic soak failed: {tally}")
        print(f"traffic soak: np={np_} tenants={tenants} "
              f"jobs={len(recs) + len(probes) + 4} "
              f"wall={time.time() - t0:.1f}s")
        return tally
    finally:
        stop_inj.set()
        if d is not None and d.poll() is None:
            d.kill()
        for p in _journal_pids(journal):
            if _sstate.pid_alive(p):
                try:
                    os.kill(p, 9)
                except OSError:
                    pass


#: the structural (event-space) half of the traffic tally — the
#: --runs determinism contract; everything else is wall clock
TRAFFIC_SHAPE_KEYS = (
    "np", "tenants", "per_tenant_done", "hwm", "bystander_flat",
    "retried", "retry_state", "retry_attempts", "deadline_expired",
    "deadline_state", "deadline_typed", "gang_alive_after_deadline",
    "shed", "shed_429", "shed_retry_after", "probes_completed",
    "admission_restored", "shutdown_rc", "orphans")


def _journal_pid_map(journal: str) -> dict[int, int]:
    """rank → last spawned pid, from the journal's spawn events."""
    pids: dict[int, int] = {}
    try:
        with open(journal) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("ev") == "spawn":
                    pids[int(rec.get("rank", -1))] = int(
                        rec.get("pid", 0))
    except OSError:
        pass
    return pids


def run_repair_window_soak(np_: int, seed: int, extra_mca: list[str],
                           timeout: float, cpu: bool = False) -> dict:
    """Crash-mid-repair replay, deterministically
    from one seed: ``daemonkill:at=1;site=daemon_repair`` lands the
    SIGKILL exactly on the REPAIR directive's publish — after the
    daemon respawned a dead rank (``repair_pending`` journaled),
    before any survivor saw the directive.  The restarted daemon must
    finish the repair instead of stranding the reborn worker: re-adopt
    the survivors, respawn the (dead) reborn incarnation, publish the
    journal-seeded repair, and end with a healthy full-size mesh —
    rc-0 shutdown, zero orphans.  Also proves the adopted-worker
    stdio re-attach: post-adoption survivor output must land in the
    per-worker log files named in the pidfile record."""
    import tempfile
    import urllib.request

    from ompi_tpu_torch.serve import client
    from ompi_tpu_torch.serve import state as _sstate

    tmp = tempfile.mkdtemp(prefix="tpud-repair-")
    pidfile = os.path.join(tmp, "tpud.pid")
    journal = pidfile + ".journal"
    base_mca = {
        "btl": "tcp",
        "serve_pidfile": pidfile,
        "serve_reattach_timeout": "30",
        "ft_respawn_timeout": "30",
        "dcn_recv_timeout": "8",
        "dcn_cts_timeout": "8",
        "dcn_connect_timeout": "4",
    }
    for kv in extra_mca:
        k, _, v = kv.partition("=")
        base_mca[k] = v
    t0 = time.time()
    d1 = d2 = None
    lines1: list[str] = []
    lines2: list[str] = []
    victim = 1
    try:
        d1, lines1, url1 = _spawn_daemon(np_, {
            **base_mca,
            "faultsim_enable": "1",
            "faultsim_seed": str(seed),
            "faultsim_plan": "daemonkill:at=1;site=daemon_repair"}, cpu=cpu)
        ja = client.submit(url1, JOB_WORKER, tenant="alice", nprocs=1)
        ra1 = client.wait(url1, ja["id"], timeout=90)
        if ra1.get("state") != "done":
            raise SystemExit(f"repair soak: job A did not finish: {ra1}")
        # kill the idle rank's worker: the daemon respawns it, journals
        # repair_pending, and dies on the repair publish
        pid_v = _journal_pid_map(journal).get(victim, 0)
        if pid_v <= 0:
            # os.kill(0, 9) would SIGKILL our own process group
            raise SystemExit(
                f"repair soak: no spawn record for rank {victim} in "
                f"{journal}; cannot pick a victim pid")
        os.kill(pid_v, 9)
        d1.wait(timeout=90)
        if d1.returncode == 0:
            raise SystemExit(
                "repair-window daemonkill never fired:\n" + "".join(lines1))
        replay = _sstate.Journal.replay(journal)
        if str(victim) not in {str(k) for k in replay["repairing"]} \
                and victim not in replay["repairing"]:
            raise SystemExit(
                f"repair soak: no repair_pending for rank {victim} in "
                f"the journal: {replay['repairing']}")
        d2, lines2, url2 = _spawn_daemon(np_, base_mca, cpu=cpu)
        # the restarted daemon must finish the repair on its own: poll
        # /jobs until the mesh is healthy at full size again
        deadline = time.time() + 120
        healthy = False
        st: dict = {}
        while time.time() < deadline:
            try:
                st = client.status(url2)
            except OSError:
                time.sleep(0.3)
                continue
            procs = st.get("procs") or {}
            healthy = bool(st.get("healthy")) and all(
                procs.get(str(r), {}).get("status") == "active"
                for r in range(np_))
            if healthy and int(procs[str(victim)]["incarnation"]) >= 2:
                break
            time.sleep(0.3)
        if not healthy:
            sys.stderr.write("".join(lines1) + "".join(lines2))
            raise SystemExit(f"repair soak: mesh never healed: {st}")
        # the healed mesh must still serve: one more job end-to-end
        jb = client.submit(url2, JOB_WORKER, tenant="bob", nprocs=np_)
        rb = client.wait(url2, jb["id"], timeout=120)
        # stdio re-attach: the adopted survivors' log files exist and
        # carry post-adoption output; /jobs names the paths
        logdir = pidfile + ".logs"
        log0 = os.path.join(logdir, "worker.0.log")
        with urllib.request.urlopen(url2 + "/jobs", timeout=5) as r:
            jobs_doc = json.loads(r.read().decode())
        log_in_jobs = jobs_doc["procs"]["0"].get("log")
        client.shutdown(url2)
        rc2 = d2.wait(timeout=60)
        time.sleep(0.5)
        orphans = [p for p in _journal_pid_map(journal).values()
                   if p > 0 and _sstate.pid_alive(p)]
        tally = {
            "injected": {"daemonkill": 1},
            "repair_pending_journaled": True,
            "repaired": sum(1 for line in lines2
                            if "repair complete" in line),
            "victim_incarnation": int(
                st["procs"][str(victim)]["incarnation"]),
            "jobs": {ja["id"]: "done", jb["id"]: rb["state"]},
            "log_reattached": bool(
                os.path.exists(log0) and os.path.getsize(log0)),
            "log_in_jobs": log_in_jobs == log0,
            "restart_rc": rc2,
            "orphans": len(orphans),
        }
        ok = (tally["repaired"] >= 1 and rb["state"] == "done"
              and tally["victim_incarnation"] >= 2
              and tally["log_reattached"] and tally["log_in_jobs"]
              and rc2 == 0 and not orphans)
        if not ok:
            sys.stderr.write("".join(lines1) + "".join(lines2))
            raise SystemExit(f"repair-window soak failed: {tally}")
        print(f"repair-window soak: np={np_} seed={seed} "
              f"wall={time.time() - t0:.1f}s")
        return tally
    finally:
        for d in (d1, d2):
            if d is not None and d.poll() is None:
                d.kill()
        for p in _journal_pid_map(journal).values():
            if p > 0 and _sstate.pid_alive(p):
                try:
                    os.kill(p, 9)
                except OSError:
                    pass


def run_hosts_soak(np_: int, hosts_n: int, seed: int,
                   extra_mca: list[str], timeout: float,
                   relay: bool = True, modex: bool = True,
                   cpu: bool = False, log: str = "") -> dict:
    """The multi-host DVM headline: a tpud with an emulated host map
    (the hermetic ``/bin/sh -c {cmd}`` rsh shim + fake hostnames
    partitions the ranks into ``hosts_n`` fake hosts, one launch
    agent each), a gang job running collectives across hosts 0–1, and
    a SIGKILL of host 0 — workers AND agent — mid-collective.  The
    heal must be agent-driven end to end: the daemon respawns the
    agent over rsh, the reborn agent reports the corpses and spawns
    the bumped incarnations, the repair directive restores the mesh,
    and a full-size phase-2 job completes with exact results while
    the BYSTANDER hosts' workers show zero reconnects/retry_dials.
    ``relay`` adds the relay-failover leg (group-leader SIGKILL under
    ``tpurun --ft --respawn`` with per-group telemetry relays: member
    frames must keep flowing within the detector's detection bound);
    ``modex`` adds the np≥16 native-plane sharded-boot leg (per-rank
    eager ``addr_installs`` ≤ group size, vs P−1 before the
    incremental-install surface).  ``log`` keeps the daemon's whole
    output (its workers' and agents' lines included) of this run, pass
    or fail."""
    import tempfile
    import urllib.request

    from ompi_tpu_torch.serve import client
    from ompi_tpu_torch.serve import state as _sstate

    if np_ % hosts_n:
        raise SystemExit(f"--hosts: np={np_} not divisible by "
                         f"{hosts_n} hosts")
    per = np_ // hosts_n
    if hosts_n < 3:
        raise SystemExit("--hosts needs >= 3 emulated hosts (kill one, "
                         "gang a second, leave bystanders)")
    tmp = tempfile.mkdtemp(prefix="tpud-hosts-")
    pidfile = os.path.join(tmp, "tpud.pid")
    host_arg = ",".join(f"fakehost{h}:{per}" for h in range(hosts_n))
    mca = {
        "btl": "tcp",
        "serve_pidfile": pidfile,
        "serve_agent_timeout": "4",
        # generous deadlines, same reasoning as the --scale soak: an
        # oversubscribed CPU box schedules 16+ resident workers late,
        # and a recovery round's hub gather must outlive the slowest
        # survivor's escape from the aborted gang collective — a tight
        # recv deadline turns scheduler lag into cascade escalations
        "ft_detector_timeout": "8",
        "dcn_recv_timeout": "30",
        "dcn_cts_timeout": "30",
        "dcn_connect_timeout": "8",
    }
    for kv in extra_mca:
        k, _, v = kv.partition("=")
        mca[k] = v
    t0 = time.time()
    d = None
    lines: list[str] = []
    gang = list(range(2 * per))           # hosts 0 + 1
    bystanders = list(range(2 * per, np_))  # hosts 2..N-1
    try:
        d, lines, url = _spawn_daemon(
            np_, mca, timeout=120.0,
            extra_args=["--host", host_arg, "--kvs-host", "127.0.0.1",
                        "--launch-agent", "/bin/sh -c {cmd}"], cpu=cpu)
        # phase 1: a long collective job ganged across hosts 0-1
        ja = client.submit(url, JOB_WORKER, tenant="alice",
                           nprocs=len(gang),
                           env={"SERVE_ITERS": "4000"})
        deadline = time.time() + 60
        while time.time() < deadline:
            if client.status(url, ja["id"]).get("state") == "running":
                break
            time.sleep(0.1)
        time.sleep(1.0)  # land the kill mid-collective, not mid-boot
        with urllib.request.urlopen(url + "/json", timeout=5) as r:
            js = json.loads(r.read().decode())
        agents0 = js["daemon"]["agents"]
        victim_pids = [int(agents0["0"]["pid"])]
        victim_pids += [
            int(st["pid"]) for st in _sstate.Journal.replay(
                pidfile + ".journal")["pids"].values()
            if st.get("host") == 0 and int(st.get("pid", 0))]
        # the agent pid reads 0 until its first heartbeat folds, and
        # os.kill(0, 9) would SIGKILL this soak's whole process group
        victim_pids = [p for p in victim_pids if p > 0]
        if len(victim_pids) < 1 + per:
            raise SystemExit(
                f"hosts soak: host-0 victim table incomplete "
                f"({victim_pids}); agent heartbeat not folded yet?")
        for p in victim_pids:
            try:
                os.kill(p, 9)
            except OSError:
                pass
        print(f"hosts soak: SIGKILLed host 0 (agent + "
              f"{len(victim_pids) - 1} workers) mid-collective",
              flush=True)
        ra = client.wait(url, ja["id"], timeout=90)
        # heal: every rank active again, host-0 ranks at incarnation 1
        # — and SETTLED (healthy with an idle queue on consecutive
        # polls: a reborn worker that dies right after the first
        # repair re-arms another respawn+repair cycle, and submitting
        # into that window parks the job behind a busy mesh)
        deadline = time.time() + 240
        settled = 0
        st: dict = {}
        while time.time() < deadline:
            st = client.status(url)
            procs = st.get("procs") or {}
            ok_now = (bool(st.get("healthy"))
                      and not st.get("running")
                      and all(procs.get(str(r), {}).get("status")
                              == "active" for r in range(np_)))
            settled = settled + 1 if ok_now else 0
            if settled >= 4:
                break
            time.sleep(0.3)
        if settled < 4:
            sys.stderr.write("".join(lines[-80:]))
            raise SystemExit(f"hosts soak: mesh never healed: "
                             f"{st.get('procs')}")
        incs = [int(st["procs"][str(r)]["incarnation"])
                for r in range(np_)]
        # the daemon and every launch agent (the respawned one included)
        # only schedule: none may hold a CUDA context
        host_cuda = {"daemon": _daemon_cuda(d.pid, url)}
        with urllib.request.urlopen(url + "/json", timeout=5) as r:
            agents = (json.loads(r.read().decode())["daemon"]
                      .get("agents") or {})
        for h, ag in sorted(agents.items()):
            if int(ag.get("pid", 0)) > 0:
                host_cuda[f"agent{h}"] = _nvidia_fds(int(ag["pid"]))
        # phase 2: EXACT full-size results on the healed mesh (the
        # job worker asserts every allreduce value internally)
        jb = client.submit(url, JOB_WORKER, tenant="bob", nprocs=np_)
        rb = client.wait(url, jb["id"], timeout=240)
        # bystander hosts: their workers' process-lifetime transport
        # counters must read ZERO reconnects/retry_dials — the host
        # kill never perturbed them
        noisy = []
        for r, rec in (rb.get("ranks") or {}).items():
            if int(rec.get("proc", -1)) in bystanders:
                c = rec.get("counters") or {}
                if int(c.get("reconnects", 0)) or int(
                        c.get("retry_dials", 0)):
                    noisy.append(int(rec["proc"]))
        client.shutdown(url)
        rc = d.wait(timeout=90)
        time.sleep(0.5)
        orphans = [p for p in victim_pids[1:] if _sstate.pid_alive(p)]
        tally = {
            "np": np_, "hosts": hosts_n, "killed_host": 0,
            "agent_respawned": sum(
                1 for line in lines if "respawning it" in line),
            "incarnations": incs,
            "jobs": {"gang": ra["state"], "full": rb["state"]},
            "bystanders_noisy": sorted(noisy),
            "shutdown_rc": rc,
            "orphans": len(orphans),
            # the phase-2 job's completion records: each worker's
            # device, ring-kernel launches and allocated card bytes
            "workers": {str(rec.get("proc", r)): {
                k: rec.get(k) for k in ("device", "launches",
                                        "cuda_allocated")}
                for r, rec in sorted((rb.get("ranks") or {}).items())},
            "daemon_cuda": sorted({f"{k}:{v}" for k, vs in
                                   host_cuda.items() for v in vs}),
        }
        ok = (tally["agent_respawned"] >= 1 and rb["state"] == "done"
              and incs == [1] * per + [0] * (np_ - per)
              and not noisy and rc == 0 and not orphans)
        if not ok:
            sys.stderr.write("".join(lines[-120:]))
            errs = {r: rec.get("error") for r, rec in
                    (rb.get("ranks") or {}).items()
                    if not rec.get("ok")}
            raise SystemExit(f"hosts soak failed: {tally}\n"
                             f"phase-2 errors: {errs}")
        print(f"hosts soak: np={np_} hosts={hosts_n} "
              f"wall={time.time() - t0:.1f}s")
    finally:
        if d is not None and d.poll() is None:
            d.kill()
        if log:
            if d is not None:
                try:
                    d.wait(timeout=10)  # its reader drains the pipe
                except subprocess.TimeoutExpired:
                    pass
            time.sleep(0.2)
            os.makedirs(os.path.dirname(log) or ".", exist_ok=True)
            with open(log, "w") as f:
                f.write("".join(lines))
    if relay:
        tally["relay_failover"] = run_relay_failover_leg(
            max(8, 2 * per), seed, extra_mca, timeout, cpu=cpu)
    if modex:
        tally["modex"] = run_native_modex_leg(np_, per, timeout, cpu=cpu)
    return tally


def run_relay_failover_leg(np_: int, seed: int, extra_mca: list[str],
                           timeout: float, cpu: bool = False) -> dict:
    """Relay failover under real process death: ``tpurun --ft
    --respawn`` with per-group telemetry relays, SIGKILL of a group
    LEADER mid-job (its relay dies with it).  The group's members
    must re-dial the deterministically promoted successor's relay —
    asserted from the aggregator: the bystander member's frames keep
    arriving with a bounded gap (the detection bound + a few
    publish intervals), and batched relay traffic resumes."""
    import math
    import re
    import threading
    import urllib.request

    period = 0.25
    group = max(2, np_ // 2)
    groups = math.ceil(np_ / group)
    victim = group  # leader of group 1 (rank 0 carries the exit code)
    mca = {
        "btl": "tcp",
        "ft_group_size": str(group),
        "ft_detector_period": str(period),
        "ft_detector_timeout": str(max(6.0, 24 * period)),
        "telemetry_enable": "1",
        "telemetry_relay": "1",
        "telemetry_interval_ms": "200",
        "dcn_recv_timeout": "30",
        "dcn_cts_timeout": "30",
        "dcn_connect_timeout": "8",
    }
    for kv in extra_mca:
        k, _, v = kv.partition("=")
        mca[k] = v
    cmd = _launch(np_, ["--ft", "--respawn"], mca, SCALE_WORKER, cpu)
    # SCALE_LINGER keeps the healed mesh alive so post-failover frames
    # accumulate (the scrape loop measures the member's inter-frame gaps)
    env = _env(SCALE_OPS="8", SCALE_KILL_AT="4", SCALE_VICTIMS=str(victim),
               SCALE_LINGER="8")
    t0 = time.time()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, env=env, cwd=REPO)
    lines: list[str] = []

    def _rd():
        for raw in iter(proc.stdout.readline, b""):
            lines.append(raw.decode(errors="replace"))

    threading.Thread(target=_rd, daemon=True).start()
    url = None
    deadline = time.time() + 90
    while time.time() < deadline and url is None:
        for line in list(lines):
            m = re.search(r"telemetry: (http://[^/]+)/metrics", line)
            if m:
                url = m.group(1)
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    if url is None:
        sys.stderr.write("".join(lines))
        raise SystemExit("relay leg: tpurun never printed the "
                         "telemetry URL")
    # scrape /json continuously; record the bystander member's frame
    # timestamps (a member of the victim's group that must fail over).
    # Bounded by the caller's timeout — a wedged job (exactly the
    # regression class this leg hunts) must fail loudly, not hang the
    # soak
    member = victim + 1
    stamps: list[int] = []
    batches: list[int] = []
    scrape_deadline = time.time() + float(timeout)
    while proc.poll() is None:
        if time.time() > scrape_deadline:
            proc.kill()
            sys.stderr.write("".join(lines[-80:]))
            raise SystemExit(
                f"relay leg: job still running after {timeout}s")
        try:
            with urllib.request.urlopen(url + "/json", timeout=2) as r:
                js = json.loads(r.read().decode())
            f = (js.get("procs") or {}).get(str(member))
            if f and (not stamps or f["ts_ns"] != stamps[-1]):
                stamps.append(int(f["ts_ns"]))
            batches.append(int((js.get("relays") or {})
                               .get("batches", 0)))
        except OSError:
            pass
        time.sleep(0.1)
    rc = proc.wait()
    if rc != 0:
        sys.stderr.write("".join(lines))
        raise SystemExit(f"relay leg: job failed rc={rc}")
    gaps = [(b - a) / 1e9 for a, b in zip(stamps, stamps[1:])]
    worst = max(gaps) if gaps else 0.0
    # bound: detection (2·period·ceil(log2 groups)) + respawn/boot
    # noise + a few publish intervals — generous but catches the old
    # behavior (members degrade to dropped frames for the REST OF THE
    # JOB, a gap bounded only by job length)
    bound = (2 * period * max(1, math.ceil(math.log2(max(2, groups))))
             + 15.0)
    tally = {"np": np_, "victim": victim, "member_frames": len(stamps),
             "worst_gap_s": round(worst, 3), "bound_s": bound,
             "batches": batches[-1] if batches else 0,
             "workers": _worker_devices(lines, "SCALE_TALLY ")}
    if len(stamps) < 4 or worst > bound:
        sys.stderr.write("".join(lines[-60:]))
        raise SystemExit(f"relay-failover leg failed: {tally}")
    print(f"relay failover: member {member} frames kept flowing "
          f"across the leader kill (worst gap {worst:.2f}s, bound "
          f"{bound:.1f}s) wall={time.time() - t0:.1f}s")
    return tally


MODEX_WORKER = os.path.join(WORKERS, "modex_worker.py")


def run_native_modex_leg(np_: int, group: int, timeout: float,
                         cpu: bool = False) -> dict:
    """np≥16 native-plane sharded boot: every rank's eager address
    installs (the new ``addr_installs`` counter) must be ≤ its group
    size — the tdcn_set_addresses incremental-install surface — where
    the old full-table eager push did P−1."""
    cmd = _launch(np_, [], {"btl": "native", "ft_group_size": group},
                  MODEX_WORKER, cpu)
    env = _env()
    t0 = time.time()
    res = subprocess.run(cmd, capture_output=True, timeout=timeout,
                         env=env, cwd=REPO)
    out_text = res.stdout.decode(errors="replace")
    if res.returncode != 0:
        sys.stderr.write(out_text)
        sys.stderr.write(res.stderr.decode(errors="replace"))
        raise SystemExit(f"modex leg failed (rc={res.returncode})")
    tallies = []
    for line in out_text.splitlines():
        if "MODEX_TALLY " in line:
            tallies.append(json.loads(line.split("MODEX_TALLY ", 1)[1]))
    if len(tallies) != np_:
        sys.stderr.write(out_text)
        raise SystemExit(f"modex leg: {len(tallies)}/{np_} tallies")
    bad = [t for t in tallies
           if t["plane"] == "native" and t["addr_installs"] > group]
    if bad:
        raise SystemExit(
            f"modex leg: eager installs exceed group size: {bad}")
    installs = [t["addr_installs"] for t in tallies]
    print(f"native modex: np={np_} group={group} per-rank eager "
          f"installs max={max(installs)} (<= {group}; eager would be "
          f"{np_ - 1}) lazy="
          f"{sum(t['addr_lazy_resolved'] for t in tallies)} "
          f"wall={time.time() - t0:.1f}s")
    return {"max_installs": max(installs),
            "lazy": sum(t["addr_lazy_resolved"] for t in tallies),
            "workers": _worker_devices(out_text.splitlines(),
                                       "MODEX_TALLY ")}


def _worker_devices(lines, marker: str) -> dict:
    """Per proc, the device, ring-kernel launches and allocated card
    bytes of the ``marker`` tally lines in a job's output (the last
    line of each proc: a reborn incarnation's replaces its corpse's)."""
    out: dict[str, dict] = {}
    for line in lines:
        if marker in line:
            t = json.loads(line.split(marker, 1)[1])
            out[str(t["proc"])] = {k: t.get(k) for k in
                                   ("device", "launches", "cuda_allocated")}
    return dict(sorted(out.items(), key=lambda kv: int(kv[0])))


def render_hosts(tally: dict) -> None:
    print(f"  agent respawns: {tally['agent_respawned']}   "
          f"incarnations: {tally['incarnations']}")
    print("  jobs: " + ", ".join(
        f"{k}={v}" for k, v in sorted(tally["jobs"].items()))
        + f"   bystanders noisy: {tally['bystanders_noisy'] or 'none'}")
    print(f"  shutdown rc={tally['shutdown_rc']}   orphans: "
          f"{tally['orphans']}")
    if "workers" in tally:
        devs = sorted({str(w.get("device")) for w in
                       tally["workers"].values()})
        print(f"  workers on: {', '.join(devs)}   daemon/agent CUDA: "
              f"{', '.join(tally.get('daemon_cuda') or ()) or 'none'}")
    if "relay_failover" in tally:
        rf = tally["relay_failover"]
        print(f"  relay failover: worst member gap "
              f"{rf['worst_gap_s']}s (bound {rf['bound_s']:.1f}s), "
              f"{rf['member_frames']} frames, {rf['batches']} batches")
    if "modex" in tally:
        mx = tally["modex"]
        print(f"  native modex: max eager installs "
              f"{mx['max_installs']}, lazy resolves {mx['lazy']}")


def render_repair_window(tally: dict) -> None:
    print(f"  repair_pending journaled: "
          f"{tally['repair_pending_journaled']}   repairs completed "
          f"after restart: {tally['repaired']}   victim incarnation: "
          f"{tally['victim_incarnation']}")
    print("  jobs: " + ", ".join(f"{j}={s}"
                                 for j, s in sorted(tally["jobs"].items()))
          + f"   stdio re-attached: {tally['log_reattached']} "
          f"(on /jobs: {tally['log_in_jobs']})")
    print(f"  final shutdown rc={tally['restart_rc']}   orphans: "
          f"{tally['orphans']}")


def render_daemon_restart(tally: dict) -> None:
    print(f"  directives before kill: {tally['directives_before_kill']}"
          f"   journal-queued: {tally['queued_in_journal']}"
          f"   survivors: {tally['survivors_at_restart']}")
    print(f"  re-adopted: {tally['adopted']}   incarnations: "
          f"{tally['incarnations']}   flat dials: {tally['flat_dials']}")
    print("  jobs: " + ", ".join(f"{j}={s}"
                                 for j, s in sorted(tally["jobs"].items()))
          + "   publishes: "
          + ", ".join(f"{j}x{n}"
                      for j, n in sorted(tally["publishes"].items())))
    print(f"  final shutdown rc={tally['restart_rc']}   orphans: "
          f"{tally['orphans']}   daemon CUDA: "
          f"{', '.join(tally['daemon_cuda']) or 'none'}")


def render_traffic(tally: dict) -> None:
    print(f"  submit→start: p50 {tally['p50_ms']}ms "
          f"p99 {tally['p99_ms']}ms   overlap: hwm {tally['hwm']} "
          f"({tally['overlap_frac']:.0%} of phase-A samples with >=2 "
          f"running)")
    print("  per-tenant done: " + ", ".join(
        f"{t}={n}" for t, n in sorted(tally["per_tenant_done"].items()))
        + "   mean submit→start: " + ", ".join(
        f"{t}={v}ms" for t, v in sorted(tally["fairness_ms"].items())))
    print(f"  shed {tally['shed']} (429, retry-after "
          f"{tally['shed_retry_after']}s; {tally['probes']} probes, "
          f"all drained: {tally['probes_completed']})   retried "
          f"{tally['retried']} -> {tally['retry_state']}   "
          f"deadline-expired {tally['deadline_expired']} -> "
          f"{tally['deadline_state']} (typed: {tally['deadline_typed']}"
          f", gang alive: {tally['gang_alive_after_deadline']})")
    print(f"  bystander flat dials: {tally['bystander_flat']}   "
          f"admission restored: {tally['admission_restored']}   "
          f"shutdown rc={tally['shutdown_rc']}   orphans: "
          f"{tally['orphans']}")


# -- selftest ----------------------------------------------------------


def selftest() -> int:
    """Drive the real faultsim/transport stacks in-process: plan
    grammar, decision determinism, reconnect self-healing, and the
    disabled-path state — no subprocesses, runs in CI tier-1."""
    import numpy as np

    from ompi_tpu_torch.dcn.tcp import TcpTransport
    from ompi_tpu_torch.faultsim import core as fsim

    # 1. grammar + per-seed decision determinism
    plan = "drop:p=0.2,delay:ms=1;p=0.5,connkill:at=3,dialfail:n=2"
    rules = fsim.parse_plan(plan)
    assert [r.kind for r in rules] == ["drop", "delay", "connkill",
                                      "dialfail"], rules
    a = fsim.FaultPlan(rules, seed=42, proc=0)
    b = fsim.FaultPlan(rules, seed=42, proc=0)
    other = fsim.FaultPlan(rules, seed=43, proc=0)
    sa = [tuple(r.kind for r in a.decide("send")) for _ in range(400)]
    sb = [tuple(r.kind for r in b.decide("send")) for _ in range(400)]
    sc = [tuple(r.kind for r in other.decide("send")) for _ in range(400)]
    assert sa == sb, "same seed must replay the same decision stream"
    assert sa != sc, "different seeds must diverge"
    assert a.injected == b.injected and a.injected["drop"] > 0

    # 2. transport self-healing under injected connection kills
    fsim.reset()
    fsim.configure("connkill:at=3", seed=1, proc=0)
    got: list[int] = []
    rx = TcpTransport(lambda env, arr: got.append(env["tag"]))
    tx = TcpTransport(lambda env, arr: None)
    try:
        for tag in range(8):
            tx.send(rx.address, {"tag": tag}, np.arange(32.0))
        deadline = time.time() + 20
        while len(got) < 8 and time.time() < deadline:
            time.sleep(0.01)
        assert sorted(got) == list(range(8)), (
            f"messages lost across reconnect: {sorted(got)}")
        assert tx.stats["reconnects"] >= 1, tx.stats
        assert fsim.injected("connkill") == 1, fsim.counters()
    finally:
        tx.close()
        rx.close()
        fsim.reset()

    # 3. exactly-once delivery: injected wire duplicates must be
    # dropped by the rx seq filter (dedup_drops) with every payload
    # delivered exactly once — the golden comparison
    fsim.configure("dup:p=0.5", seed=5, proc=0)
    got2: list[int] = []
    rx2 = TcpTransport(lambda env, arr: got2.append(env["tag"]))
    tx2 = TcpTransport(lambda env, arr: None)
    try:
        for tag in range(32):
            tx2.send(rx2.address, {"tag": tag}, np.arange(8.0))
        deadline = time.time() + 20
        while len(got2) < 32 and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)  # any stray duplicate would land here
        assert sorted(got2) == list(range(32)), (
            f"duplicate or lost delivery: {sorted(got2)}")
        dups = fsim.injected("dup")
        assert dups > 0 and rx2.stats["dedup_drops"] == dups, (
            rx2.stats["dedup_drops"], dups)
    finally:
        tx2.close()
        rx2.close()
        fsim.reset()

    # 4. detector clear_failed — the replace() leg's detector contract
    from ompi_tpu_torch.ft.detector import HeartbeatDetector

    class _Eng:
        proc, nprocs = 0, 2

        def attach_detector(self, d):
            pass

        def note_proc_failed(self, p):
            pass

        def send_ctrl(self, p, env):
            pass

    det = HeartbeatDetector(_Eng(), period=60.0, timeout=120.0)
    try:
        det.mark_failed(1, gossip=False)
        assert det.failed() == {1}
        det.clear_failed(1)
        assert det.failed() == set() and det._strikes[1] == 0
    finally:
        det.close()

    # 5. disabled path: hooks are a single module-bool test, no state
    assert not fsim.enabled() and fsim.actions("send") == ()
    assert sum(fsim.counters().values()) == 0

    # 6. hierarchical topology math: grouping, deterministic leader/
    # successor, rank-order takeover
    from ompi_tpu_torch.ft.detector import compute_groups

    gs = compute_groups(16, 8)
    assert gs == [list(range(8)), list(range(8, 16))], gs
    assert compute_groups(6, 8) == [[0, 1, 2, 3, 4, 5]]
    assert compute_groups(4, 2, hosts=[0, 1, 0, 1]) == [[0, 2], [1, 3]]

    class _Eng16(_Eng):
        proc, nprocs = 2, 16

    det16 = HeartbeatDetector(_Eng16(), period=60.0, timeout=120.0,
                              group_size=8)
    try:
        targets, watch, is_leader = det16._topology_locked()
        assert targets == [0, 1] and watch == set() and not is_leader
        det16.mark_failed(0, gossip=False)  # leader dies →
        det16.mark_failed(1, gossip=False)  # successor dies →
        targets, watch, is_leader = det16._topology_locked()
        # rank 2 is now its group's leader: heartbeats the other
        # group's leader + its own successor, watches members+leaders
        assert is_leader and targets == [3, 8], targets
        assert 8 in watch and 3 in watch, watch
    finally:
        det16.close()

    # 7. versioned gossip: a stale flr about a healed incarnation is
    # dropped; a fresh record re-marks
    detv = HeartbeatDetector(_Eng16(), period=60.0, timeout=120.0,
                             group_size=8)
    try:
        detv.on_gossip({"proc": 5, "inc": 0, "epoch": 0})
        assert 5 in detv.failed()
        detv.clear_failed(5, incarnation=1)  # replace() healed it
        detv.on_gossip({"proc": 5, "inc": 0, "epoch": 0})  # late corpse
        assert 5 not in detv.failed()
        assert detv.counters["stale_gossip_dropped"] == 1
        detv.on_gossip({"proc": 5, "inc": 1, "epoch": 1})  # fresh death
        assert 5 in detv.failed()
    finally:
        detv.close()

    # 8. sharded modex substrate: KVS prefix scan + lazy AddressTable
    from ompi_tpu_torch.boot.kvs import KVSClient, KVSServer
    from ompi_tpu_torch.dcn.collops import AddressTable

    srv = KVSServer()
    cli = KVSClient(srv.address)
    try:
        for pnum in range(4):
            cli.put(f"dcn.{pnum}", f"addr{pnum}")
        scan = cli.get_prefix("dcn.")
        assert scan == {f"dcn.{i}": f"addr{i}" for i in range(4)}, scan
        assert cli.ops["get_prefix"] == 1 and cli.ops["put"] == 4
        tab = AddressTable(4, lambda i: cli.get(f"dcn.{i}"),
                           primed={0: "addr0", 1: "addr1"})
        assert list(tab) == ["addr0", "addr1", None, None]
        assert tab[3] == "addr3" and tab.lazy_resolved == 1
        assert cli.ops.get("get", 0) == 1  # exactly the one lazy get
    finally:
        cli.close()
        srv.close()

    # 9. telemetry relay: members' frames batch through the group
    # relay and unwrap at the root aggregator
    from ompi_tpu_torch.metrics.live import (TelemetryAggregator,
                                       TelemetryRelay, _send_frame)
    import socket as _socket

    agg = TelemetryAggregator(http_port=0)
    rel = TelemetryRelay(agg.ingest_address, group_index=1,
                         interval_ms=50)
    try:
        host, port = rel.ingest_address.rsplit(":", 1)
        s = _socket.create_connection((host, int(port)), timeout=2)
        for pnum in (8, 9):
            _send_frame(s, {"proc": pnum, "nprocs": 16,
                            "ts_ns": 1, "native": {}})
        s.close()
        deadline = time.time() + 10
        while agg.frames < 2 and time.time() < deadline:
            time.sleep(0.02)
        js = agg.json_state()
        assert js["frames"] == 2 and js["relays"]["groups"] == [1], js
        assert set(js["procs"]) == {"8", "9"}, js["procs"]
    finally:
        rel.close()
        agg.close()

    # 10. agent protocol units: adopt-table parsing, the agentkill
    # grammar (site agent, deterministic per seed), the zombie rule
    # (a SIGKILLed worker mid-reap must read DEAD or an agent would
    # adopt a corpse), and the daemon-side stale-incarnation guard
    from ompi_tpu_torch.serve.agent import _parse_adopt
    from ompi_tpu_torch.serve import state as sstate

    assert _parse_adopt("2:123:1,3:456:0") == {2: (123, 1),
                                               3: (456, 0)}
    assert _parse_adopt("garbage") == {} and _parse_adopt("") == {}
    rules = fsim.parse_plan("agentkill:at=2")
    assert rules[0].kind == "agentkill" and rules[0].site == "agent"
    pa = fsim.FaultPlan(rules, seed=9, proc=1001)
    hits = [bool(pa.decide("agent")) for _ in range(4)]
    assert hits == [False, True, False, False], hits
    assert not sstate.pid_alive(0) and not sstate.pid_alive(-1)
    from ompi_tpu_torch.serve.daemon import _RemoteProc

    class _StubDaemon:
        def __init__(self):
            self.state = None
            self.killed = []

        def _agent_worker_state(self, hid, rank):
            return self.state

        def _agent_kill(self, hid, rank, sig):
            self.killed.append((rank, sig))

    sd = _StubDaemon()
    rp = _RemoteProc(sd, 2, 0, incarnation=1)
    assert rp.poll() is None            # agent has not reported yet
    sd.state = {"pid": 99, "incarnation": 0, "alive": False, "rc": 1}
    assert rp.poll() is None            # stale table: prior lineage
    sd.state = {"pid": 101, "incarnation": 1, "alive": True, "rc": 0}
    assert rp.poll() is None and rp.pid == 101
    sd.state = {"pid": 101, "incarnation": 1, "alive": False, "rc": 7}
    assert rp.poll() == 7
    rp.terminate()
    assert sd.killed and sd.killed[0][0] == 2

    # 11. relay failover in-process: the leader relay dies mid-flight;
    # the promoted successor registers a replacement and the member's
    # pump re-aims through its refresh hook — frames keep arriving
    from ompi_tpu_torch.metrics.live import TelemetryPublisher

    agg2 = TelemetryAggregator(http_port=0)
    rel1 = TelemetryRelay(agg2.ingest_address, group_index=0,
                          interval_ms=30)
    registry = {"addr": rel1.ingest_address}
    pub = TelemetryPublisher(rel1.ingest_address, proc=5, nprocs=8,
                             interval_ms=30,
                             refresh=lambda: registry["addr"])
    rel2 = None
    try:
        deadline = time.time() + 10
        while agg2.frames < 2 and time.time() < deadline:
            time.sleep(0.02)
        assert agg2.frames >= 2, agg2.frames
        rel1.close()  # the leader (and its relay) dies
        rel2 = TelemetryRelay(agg2.ingest_address, group_index=0,
                              interval_ms=30)
        registry["addr"] = rel2.ingest_address  # the re-registration
        before = agg2.frames
        deadline = time.time() + 10
        while (agg2.frames < before + 3 or not pub.refreshes) \
                and time.time() < deadline:
            time.sleep(0.02)
        assert pub.refreshes >= 1, pub.refreshes
        assert agg2.frames >= before + 3, (before, agg2.frames)
    finally:
        pub.stop()
        if rel2 is not None:
            rel2.close()
        agg2.close()

    # 12. plane-health golden fixture: drive the PlaneHealth machine
    # through the exact schedule the --planes soak injects (3 strikes,
    # 3 failed probes, a promoting 4th) and hold its transition log to
    # the golden sequence — the in-process twin of the np=2 soak's
    # determinism contract.  The device-site grammar rides along.
    rules = fsim.parse_plan(DEFAULT_PLANES_PLAN)
    assert rules[0].kind == "drop" and rules[0].site == "device", rules
    assert rules[0].n == 6 and rules[0].proc == 0, rules
    pd = fsim.FaultPlan(rules, seed=3, proc=0)
    hits = [bool(pd.decide("device", kinds={"drop"})) for _ in range(8)]
    assert hits == [True] * 6 + [False] * 2, hits
    assert not fsim.FaultPlan(rules, seed=3, proc=1).decide(
        "device", kinds={"drop"}), "proc=0 rule fired on rank 1"
    from ompi_tpu_torch.dcn.device import PlaneHealth

    ph = PlaneHealth(plane="device", strikes=3, heal_interval=0.005)
    for _ in range(3):                       # stage events 1-3 drop
        ph.strike(1, "injected_drop")
    assert not ph.ok(1)
    for _ in range(3):                       # probe events 4-6 drop
        time.sleep(0.006)
        assert ph.allow_probe(1)
        ph.probe_outcome(1, False, "injected_drop")
    time.sleep(0.006)
    assert ph.allow_probe(1)                 # event 7 stages clean
    ph.probe_outcome(1, True)                # consumed → promotion
    assert ph.ok(1)
    events = [t[0] for t in ph.transitions]
    assert events == list(GOLDEN_PLANE_TRANSITIONS), events
    assert ph.stats == {"plane_demotions": 1, "plane_promotions": 1,
                        "plane_heal_probes": 4}, ph.stats

    print("selftest OK: plan grammar, seeded determinism (400-event "
          "streams), reconnect healing (8/8 delivered, "
          f"{tx.stats['reconnects']} reconnect), exactly-once dedup "
          f"(32/32 delivered, {dups} duplicates dropped), detector "
          "clear_failed, disabled-path state, hierarchical topology "
          "+ takeover, versioned gossip (stale flr dropped), "
          "get_prefix + lazy AddressTable, relay batching, agent "
          "protocol (adopt parse, agentkill schedule, zombie rule, "
          "stale-incarnation guard), relay failover (member re-dialed "
          f"the successor's relay after {pub.refreshes} refresh), "
          "plane-health golden fixture (demote → 3 failed probes → "
          "promote transition log)")
    return 0


def traffic_selftest() -> int:
    """In-process twin of ``--traffic`` (tier-1, no subprocesses): a
    workerless daemon stepped by hand, a pump thread honoring the
    worker contract (jobs acked per-proc; a CHAOS_DIE job dies once
    with a ``rank died`` record; a CHAOS_HANG job answers only its
    revoke), and the synthetic stall ramp through the REAL telemetry
    ingest socket — overlap bookkeeping, retry-budget replay,
    deadline revoke, shedding 429 + Retry-After over real HTTP, the
    idle-tenant floor, and the one-clean-tick restore, all in
    deterministic event space."""
    import socket as _socket
    import threading

    from ompi_tpu_torch.metrics.live import _send_frame
    from ompi_tpu_torch.serve import client
    from ompi_tpu_torch.serve.daemon import K_DONE, K_JOB, TpuDaemon

    d = TpuDaemon(2, mca={"serve_admission_stall_ns": "1000000",
                          "serve_retry_budget": "1",
                          "serve_job_deadline_s": "0.3"},
                  spawn=False)
    stop = threading.Event()
    died: set[str] = set()
    hung: dict[str, tuple[int, list[int]]] = {}

    def pump():
        n = 0
        while not stop.is_set():
            jd = d.server.peek(f"{K_JOB}{n}")
            if jd is None:
                time.sleep(0.005)
                continue
            kind = jd.get("kind", "job")
            env = jd.get("env") or {}
            if (kind == "job" and env.get("CHAOS_DIE") == "1"
                    and jd["id"] not in died):
                died.add(jd["id"])
                for p in jd.get("procs", ()):
                    d.server.put_local(
                        f"{K_DONE}{n}.{p}",
                        {"ok": False, "proc": p,
                         "error": "rank died (injected)"})
            elif kind == "job" and env.get("CHAOS_HANG") == "1":
                hung[jd["id"]] = (n, list(jd.get("procs", ())))
            elif kind == "revoke":
                for p in jd.get("procs", ()):
                    d.server.put_local(
                        f"{K_DONE}{n}.{p}",
                        {"ok": True, "proc": p,
                         "revoked": jd.get("id")})
                hn, procs = hung.pop(jd.get("id"), (None, []))
                if hn is not None:
                    for p in procs:
                        d.server.put_local(
                            f"{K_DONE}{hn}.{p}",
                            {"ok": False, "proc": p,
                             "error": "comm revoked mid-collective"})
            else:
                for p in jd.get("procs", ()):
                    d.server.put_local(f"{K_DONE}{n}.{p}",
                                       {"ok": True, "proc": p})
            n += 1

    threading.Thread(target=pump, daemon=True).start()

    def steps_until(cond, what: str, deadline_s: float = 20.0):
        end = time.monotonic() + deadline_s
        while not cond() and time.monotonic() < end:
            d.step()
            time.sleep(0.01)
        assert cond(), f"selftest never converged: {what}"

    def jstate(jid: str) -> str:
        return str(client.status(d.url, jid)["state"])

    try:
        # 1. overlap: two disjoint nprocs=1 tenant jobs dispatch in
        # the same any-fit pass — concurrency high-water hits np
        ja = client.submit(d.url, "a.py", tenant="t0", nprocs=1)
        jb = client.submit(d.url, "b.py", tenant="t1", nprocs=1)
        steps_until(lambda: jstate(ja["id"]) == "done"
                    and jstate(jb["id"]) == "done", "overlap jobs")
        st = client.status(d.url)
        assert st["counters"]["jobs_concurrent_hwm"] == 2, st["counters"]

        # 2. retry budget: a died job is re-queued and replayed once
        jr = client.submit(d.url, "r.py", tenant="t0", nprocs=1,
                           env={"CHAOS_DIE": "1"})
        steps_until(lambda: jstate(jr["id"]) == "done", "retried job")
        one = client.status(d.url, jr["id"])
        assert int(one.get("retries", 0)) == 1, one
        assert client.status(
            d.url)["counters"]["jobs_retried"] == 1

        # 3. deadline: a hung job blows the 0.3 s deadline — revoke,
        # typed DeadlineExpired; the concurrent bystander job finishes
        jh = client.submit(d.url, "h.py", tenant="t2", nprocs=1,
                           env={"CHAOS_HANG": "1"})
        jq = client.submit(d.url, "q.py", tenant="t1", nprocs=1)
        steps_until(lambda: jstate(jh["id"]) == "failed",
                    "deadline expiry")
        hrec = client.status(d.url, jh["id"])
        assert str(hrec.get("error", "")).startswith(
            "DeadlineExpired"), hrec
        assert jstate(jq["id"]) == "done"
        assert client.status(
            d.url)["counters"]["jobs_deadline_expired"] == 1

        # 4. overload: stall frames through the real ingest socket,
        # one folded per hand-driven step — the first sighting of a
        # proc only establishes its baseline (delta 0), then three
        # over-threshold deltas sustain the streak into shedding
        host, port = d.aggregator.ingest_address.rsplit(":", 1)
        s = _socket.create_connection((host, int(port)), timeout=2)
        stall = 0

        def frame_landed(ts: int, val: int) -> bool:
            f = d.aggregator.latest_frames().get(9) or {}
            return (int(f.get("ts_ns", 0)) == ts and int(
                (f.get("native") or {}).get("ring_stall_ns", 0)) == val)

        for k in range(4):
            stall += 1_000_000_000
            _send_frame(s, {"proc": 9, "nprocs": 2, "ts_ns": k + 1,
                            "native": {"ring_stall_ns": stall}})
            end = time.monotonic() + 10
            while (not frame_landed(k + 1, stall)
                   and time.monotonic() < end):
                time.sleep(0.005)
            assert frame_landed(k + 1, stall), "ramp frame lost"
            d.step()
        st = client.status(d.url)
        assert st["admission"]["state"] == "shedding", st["admission"]
        # idle-tenant floor: a fresh tenant gets exactly one job in;
        # the second sheds with the typed 429 + Retry-After
        p1 = client.submit(d.url, "p1.py", tenant="fresh", nprocs=1)
        try:
            client.submit(d.url, "p2.py", tenant="fresh", nprocs=1)
            raise AssertionError("shedding admitted a second job")
        except client.ServeError as e:
            assert e.status == 429 and e.retry_after == 3.0, (
                e.status, e.retry_after)
        assert client.status(d.url)["counters"]["jobs_shed"] == 1

        # 5. restore: one clean (zero-delta) fresh frame re-opens
        # admission; the held probe dispatches and drains
        _send_frame(s, {"proc": 9, "nprocs": 2, "ts_ns": 99,
                        "native": {"ring_stall_ns": stall}})
        end = time.monotonic() + 10
        while (not frame_landed(99, stall)
               and time.monotonic() < end):
            time.sleep(0.005)
        d.step()
        st = client.status(d.url)
        assert st["admission"]["state"] == "ok", st["admission"]
        steps_until(lambda: jstate(p1["id"]) == "done",
                    "probe drain after restore")
        s.close()
        print("selftest OK: traffic admission twin — overlap hwm 2, "
              "retry-budget replay (retries=1), deadline revoke "
              "(typed DeadlineExpired, bystander done), stall-ramp "
              "shedding (429 retry-after 3.0s, idle floor 1), "
              "one-clean-tick restore + probe drained")
        return 0
    finally:
        stop.set()
        d.aggregator.close()
        d.server.close()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ompi_tpu_torch chaos",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--np", type=int, default=2, dest="np_")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--plan", default=DEFAULT_PLAN)
    ap.add_argument("--ops", type=int, default=24,
                    help="collectives per rank (every 3rd adds a "
                    "rendezvous p2p burst)")
    ap.add_argument("--runs", type=int, default=1,
                    help="repeat the soak; >1 verifies the same seed "
                    "reproduces the same injected-fault counts")
    ap.add_argument("--out", default="",
                    help="directory for metrics/trace/flight exports "
                    "(joined into the report) and the --traffic leg's "
                    "BENCH_DETAIL.json")
    ap.add_argument("--cpu", action="store_true",
                    help="run the soak's processes on the CPU (passed to "
                    "run/tpud); default: cuda:0, failing where there is "
                    "no card")
    ap.add_argument("--mca", action="append", default=[],
                    metavar="K=V", help="extra --mca pairs")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="per-run hang deadline, seconds")
    ap.add_argument("--selftest", action="store_true",
                    help="in-process self-check (no tpurun); with "
                    "--traffic, the serving-plane admission twin")
    ap.add_argument("--traffic", action="store_true",
                    help="multi-tenant serving soak against one warm "
                    "tpud: concurrent disjoint gangs (hwm == np), "
                    "p50/p99 submit→first-collective, a repair-killed "
                    "job replayed once on the retry budget (bystander "
                    "gang dial-flat), a deadline expiry revoking "
                    "exactly the slow job, and a synthetic stall ramp "
                    "flipping admission to shedding (429+Retry-After) "
                    "then restoring; writes the serve_traffic leg "
                    "into BENCH_DETAIL.json under --out")
    ap.add_argument("--tenants", type=int, default=3,
                    help="--traffic: tenant count (>= 3)")
    ap.add_argument("--jobs", type=int, default=2,
                    help="--traffic: overlap-phase jobs per tenant")
    ap.add_argument("--planes", action="store_true",
                    help="plane-failover soak: rank 0's device plane "
                    "is killed mid-allreduce (event-indexed injected "
                    "DMA failures); the job must complete bit-exact "
                    "with the golden demote/probe/promote transition "
                    "sequence and bounded dedup_drops")
    ap.add_argument("--respawn", action="store_true",
                    help="elastic-recovery soak: a worker SIGKILLs "
                    "itself mid-collective under tpurun --ft --respawn;"
                    " the job must complete at FULL size (replace()) "
                    "with respawns >= 1")
    ap.add_argument("--daemon-restart", action="store_true",
                    help="control-plane crash soak: a tpud armed with "
                    "daemonkill:at=N SIGKILLs itself mid-job; the "
                    "restart must re-adopt every worker (zero "
                    "re-dials), run the journal-recovered job exactly "
                    "once, and leave zero orphans")
    ap.add_argument("--kill-at", type=int, default=2,
                    help="daemonkill directive index for "
                    "--daemon-restart (default 2: mid-job for the "
                    "first submission)")
    ap.add_argument("--hosts", type=int, default=0, metavar="N",
                    help="multi-host DVM soak: a tpud with N emulated "
                    "hosts (hermetic rsh shim + fake hostnames, one "
                    "launch agent each), SIGKILL of one whole host "
                    "(workers + agent) mid-collective, agent-driven "
                    "respawn + replace, exact full-size phase-2, "
                    "bystander hosts at zero reconnects/dials; plus "
                    "the relay-failover and np>=16 native sharded-"
                    "modex legs")
    ap.add_argument("--no-relay-leg", action="store_true",
                    help="--hosts: skip the relay-failover leg")
    ap.add_argument("--no-modex-leg", action="store_true",
                    help="--hosts: skip the native sharded-modex leg")
    ap.add_argument("--kill-in-repair", action="store_true",
                    help="crash-mid-repair soak: the daemonkill lands "
                    "on the REPAIR directive's publish (site "
                    "daemon_repair) — the restart must finish the "
                    "journal-seeded repair instead of stranding the "
                    "reborn worker")
    ap.add_argument("--scale", action="store_true",
                    help="np>=16 hierarchical control-plane soak: "
                    "sharded-modex boot (KVS op counts asserted "
                    "sub-quadratic), one SIGKILL per targeted "
                    "detector group mid-collective, gossip "
                    "convergence bound, full-size replace()")
    ap.add_argument("--group-size", type=int, default=8,
                    help="--scale: ft_group_size (default 8)")
    ap.add_argument("--period", type=float, default=1.0,
                    help="--scale: detector heartbeat period, seconds "
                    "(the convergence bound is 2*period*"
                    "ceil(log2(groups)))")
    ap.add_argument("--kill-groups", type=int, default=0,
                    help="--scale: kill a rank in only the first N "
                    "groups (0 = every group); with N < groups the "
                    "bystander groups must stay at zero "
                    "reconnects/retry_dials")
    ap.add_argument("--relay", action="store_true",
                    help="--scale: enable the per-group telemetry "
                    "relays (telemetry_enable + telemetry_relay)")
    ap.add_argument("--json", default="", metavar="PATH",
                    help="also write every run's tallies and wall seconds "
                    "to PATH as one JSON document")
    ns = ap.parse_args(argv)
    if ns.selftest:
        return traffic_selftest() if ns.traffic else selftest()
    if not ns.cpu:
        _require_card()
    record: list[dict] = []
    rc = _run(ns, record)
    if ns.json:
        with open(ns.json, "w") as f:
            json.dump({"argv": sys.argv[1:] if argv is None else argv,
                       "runs": record}, f, indent=1)
    return rc


def _run(ns, record: list[dict]) -> int:
    """The soak ``ns`` selects, ``ns.runs`` times; each run's tallies
    and wall seconds are appended to ``record``."""
    if ns.traffic:
        baseline = None
        tally: dict = {}
        for run in range(ns.runs):
            t_run = time.time()
            tally = run_traffic_soak(ns.np_, ns.seed, ns.tenants,
                                     ns.jobs, ns.mca, ns.timeout,
                                     cpu=ns.cpu)
            record.append({"wall_s": time.time() - t_run, "tally": tally})
            render_traffic(tally)
            # the structural tally is the determinism contract
            # (latencies and the overlap fraction are wall clock)
            shape = {k: tally[k] for k in TRAFFIC_SHAPE_KEYS}
            if baseline is None:
                baseline = shape
            elif shape != baseline:
                raise SystemExit(
                    f"DETERMINISM VIOLATION: run {run + 1} shape "
                    f"{shape} != run 1 {baseline} (seed {ns.seed})")
            elif ns.runs > 1:
                print(f"run {run + 1}: traffic shed/retry/deadline "
                      f"tally reproduces run 1 exactly "
                      f"(seed {ns.seed})")
        _bench_detail_merge("serve_traffic", tally, ns.out)
        return 0
    if ns.hosts:
        baseline = None
        for run in range(ns.runs):
            t_run = time.time()
            log = os.path.join(ns.out or DETAIL_DIR,
                               f"hosts.run{run + 1}.log")
            print(f"hosts soak: run {run + 1} keeps its log in {log}",
                  flush=True)
            tally = run_hosts_soak(
                ns.np_, ns.hosts, ns.seed, ns.mca, ns.timeout,
                relay=not ns.no_relay_leg and run == 0,
                modex=not ns.no_modex_leg and run == 0, cpu=ns.cpu,
                log=log)
            record.append({"wall_s": time.time() - t_run, "tally": tally})
            render_hosts(tally)
            # the structural tally is the determinism contract (the
            # relay/modex legs carry wall-clock and run once)
            shape = {k: tally[k] for k in
                     ("np", "hosts", "killed_host", "incarnations",
                      "jobs", "bystanders_noisy", "shutdown_rc",
                      "orphans")}
            if baseline is None:
                baseline = shape
            elif shape != baseline:
                raise SystemExit(
                    f"DETERMINISM VIOLATION: run {run + 1} shape "
                    f"{shape} != run 1 {baseline} (seed {ns.seed})")
            elif ns.runs > 1:
                print(f"run {run + 1}: hosts tally reproduces run 1 "
                      f"exactly (seed {ns.seed})")
        return 0
    if ns.scale:
        baseline = None
        for run in range(ns.runs):
            t_run = time.time()
            tallies = run_scale_soak(
                ns.np_, ns.seed, ns.ops, ns.kill_at if ns.kill_at != 2
                else 3, ns.group_size, ns.period, ns.kill_groups,
                ns.relay, "" if ns.plan == DEFAULT_PLAN else ns.plan,
                ns.mca, ns.timeout, cpu=ns.cpu)
            record.append({"wall_s": time.time() - t_run, "tally": tallies})
            render_scale(tallies)
            # the structural tally is the determinism contract (the
            # convergence stamps are wall clock and excluded)
            shape = [(t["proc"], t["incarnation"], t["completed"],
                      t["post"], t["size"],
                      int(t["boot_kvs_ops"].get("get", 0)),
                      t["injected"]) for t in tallies]
            if baseline is None:
                baseline = shape
            elif shape != baseline:
                raise SystemExit(
                    f"DETERMINISM VIOLATION: run {run + 1} shape "
                    f"{shape} != run 1 {baseline} (seed {ns.seed})")
            elif ns.runs > 1:
                print(f"run {run + 1}: scale tally reproduces run 1 "
                      f"exactly (seed {ns.seed})")
        return 0
    if ns.kill_in_repair:
        baseline = None
        for run in range(ns.runs):
            t_run = time.time()
            tally = run_repair_window_soak(ns.np_, ns.seed, ns.mca,
                                           ns.timeout, cpu=ns.cpu)
            record.append({"wall_s": time.time() - t_run, "tally": tally})
            render_repair_window(tally)
            if baseline is None:
                baseline = tally
            elif tally != baseline:
                raise SystemExit(
                    f"DETERMINISM VIOLATION: run {run + 1} tallied "
                    f"{tally} but run 1 tallied {baseline}")
            elif ns.runs > 1:
                print(f"run {run + 1}: repair-window tally reproduces "
                      f"run 1 exactly (seed {ns.seed})")
        return 0
    if ns.planes:
        plan = (DEFAULT_PLANES_PLAN if ns.plan == DEFAULT_PLAN
                else ns.plan)
        ops = ns.ops if ns.ops != 24 else 70
        baseline = None
        for run in range(ns.runs):
            t_run = time.time()
            tallies = run_planes_soak(ns.np_, ns.seed, plan, ops,
                                      ns.mca, ns.timeout, cpu=ns.cpu)
            record.append({"wall_s": time.time() - t_run, "tally": tallies})
            render_planes(tallies)
            # the structural tally is the determinism contract —
            # wall-clock-shaped fields (device_sends, fallbacks: how
            # many ops happened to fall inside the demotion window)
            # are excluded, the event-indexed ones are not
            shape = [(t["proc"], t["completed"], t["ops"],
                      t["escalated"], t["injected"], t["healthy"],
                      t["plane"]["plane_demotions"],
                      t["plane"]["plane_promotions"],
                      t["plane"]["plane_heal_probes"],
                      [tuple(tr) for tr in t["transitions"]])
                     for t in tallies]
            if baseline is None:
                baseline = shape
            elif shape != baseline:
                raise SystemExit(
                    f"DETERMINISM VIOLATION: run {run + 1} shape "
                    f"{shape} != run 1 {baseline} (seed {ns.seed})")
            elif ns.runs > 1:
                print(f"run {run + 1}: planes tally reproduces run 1 "
                      f"exactly (seed {ns.seed})")
        return 0
    if ns.daemon_restart:
        baseline = None
        for run in range(ns.runs):
            t_run = time.time()
            orders: list = []
            tally = run_daemon_restart_soak(ns.np_, ns.seed, ns.kill_at,
                                            ns.mca, ns.timeout, cpu=ns.cpu,
                                            orders=orders)
            record.append({"wall_s": time.time() - t_run, "tally": tally,
                           "journal_order": orders[0] if orders else None})
            render_daemon_restart(tally)
            if baseline is None:
                baseline = tally
            elif tally != baseline:
                raise SystemExit(
                    f"DETERMINISM VIOLATION: run {run + 1} tallied "
                    f"{tally} but run 1 tallied {baseline} "
                    f"(same seed {ns.seed})")
            elif ns.runs > 1:
                print(f"run {run + 1}: restart tally reproduces run 1 "
                      f"exactly (seed {ns.seed})")
        return 0
    baseline = None
    for run in range(ns.runs):
        t_run = time.time()
        if ns.respawn:
            plan = (DEFAULT_RESPAWN_PLAN if ns.plan == DEFAULT_PLAN
                    else ns.plan)
            tallies = run_respawn_soak(ns.np_, ns.seed, plan, ns.ops,
                                       ns.mca, ns.timeout,
                                       out=ns.out or None, cpu=ns.cpu)
            render_respawn(tallies)
        else:
            tallies = run_soak(ns.np_, ns.seed, ns.plan, ns.ops,
                               ns.out or None, ns.mca, ns.timeout,
                               cpu=ns.cpu)
            render(tallies)
        record.append({"wall_s": time.time() - t_run, "tally": tallies})
        counts = [t["injected"] for t in tallies]
        if baseline is None:
            baseline = counts
        elif counts != baseline:
            raise SystemExit(
                f"DETERMINISM VIOLATION: run {run + 1} injected {counts}"
                f" but run 1 injected {baseline} (same seed {ns.seed})")
        elif ns.runs > 1:
            print(f"run {run + 1}: injected-fault counts reproduce "
                  f"run 1 exactly (seed {ns.seed})")
    if ns.out:
        join_outputs(ns.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

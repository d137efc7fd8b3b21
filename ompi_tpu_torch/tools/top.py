#!/usr/bin/env python
"""top — refreshing terminal dashboard over the live telemetry endpoint.

Usage::

    # launch a job with the live plane on; the launcher prints the URL
    python -m ompi_tpu_torch run -np 4 --nranks 1 \
        --mca telemetry_enable 1 my_script.py
    # [tpurun] telemetry: http://127.0.0.1:PORT/metrics ...

    # watch it (refreshes every --interval seconds; q/Ctrl-C to stop)
    python -m ompi_tpu_torch top --url http://127.0.0.1:PORT

    # one frame, no screen clearing (scripts, CI)
    python -m ompi_tpu_torch top --url http://127.0.0.1:PORT --once

    # self-check (no job): drives a real in-process aggregator over
    # real HTTP with synthetic 2-rank frames
    python -m ompi_tpu_torch top --selftest

Port of the reference's ``tools/top.py`` over the port's
``metrics/live.TelemetryAggregator``: the same flags and the same frame.
Reads the aggregator's ``/json`` feed (the same state ``/metrics``
exposes as Prometheus text): per-rank transport bandwidth and message
rates (computed from successive frames), the stall-cause breakdown
(ring backpressure vs rendezvous CTS wait vs other), detector health,
recovery activity (reconnects / respawns / dedup drops), and the
cross-rank straggler attribution — rolling arrival-lateness score and
times-slowest per rank, arrival-skew totals per op.  It talks HTTP
only and never initialises CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request

#: wire-traffic counters summed into the bandwidth estimate
_BYTES = ("eager_bytes", "chunked_bytes", "rndv_bytes")
_MSGS = ("eager_msgs", "chunked_msgs", "rndv_msgs")


def fetch(url: str, timeout: float = 3.0) -> dict:
    with urllib.request.urlopen(url + "/json", timeout=timeout) as r:
        return json.loads(r.read().decode())


def _bar(share: float, width: int = 10) -> str:
    n = max(0, min(width, round(share * width)))
    return "█" * n + "·" * (width - n)


def _rates(cur: dict, prev: dict | None) -> tuple[float, float]:
    """(MB/s, msg/s) between two frames of one rank."""
    if not prev:
        return 0.0, 0.0
    dt = (cur.get("ts_ns", 0) - prev.get("ts_ns", 0)) / 1e9
    if dt <= 0:
        return 0.0, 0.0
    cn, pn = cur.get("native") or {}, prev.get("native") or {}
    db = sum(int(cn.get(k, 0)) - int(pn.get(k, 0)) for k in _BYTES)
    dm = sum(int(cn.get(k, 0)) - int(pn.get(k, 0)) for k in _MSGS)
    return max(0.0, db / dt / 1e6), max(0.0, dm / dt)


def render(state: dict, prev: dict | None = None, url: str = "",
           out=sys.stdout) -> None:
    procs = {int(p): f for p, f in (state.get("procs") or {}).items()}
    prev_procs = {int(p): f for p, f in
                  ((prev or {}).get("procs") or {}).items()}
    relays = state.get("relays") or {}
    relay_note = (f"  relays={len(relays.get('groups') or ())}g/"
                  f"{relays.get('batches', 0)}b"
                  if relays.get("batches") else "")
    print(f"ompi_tpu top — {url or 'live telemetry'}  "
          f"frames={state.get('frames', 0)} "
          f"nprocs={state.get('nprocs', len(procs))}"
          f"{relay_note}  "
          f"{time.strftime('%H:%M:%S')}", file=out)
    daemon = state.get("daemon")
    if daemon:
        # tpud control-plane line: a restarted daemon shows a bumped
        # generation, its journal depth draining, and the ranks still
        # in the re-adoption window
        adopting = daemon.get("adopting") or []
        print(f"daemon: pid {daemon.get('pid')} "
              f"gen {daemon.get('generation')} "
              f"{'crash-safe' if daemon.get('crash_safe') else 'volatile'}"
              f"  journal {daemon.get('journal_depth', 0)} "
              f"(queued {daemon.get('queued', 0)} + in-flight "
              f"{daemon.get('outstanding', 0)})"
              + (f"  ADOPTING {adopting}" if adopting else "")
              + ("  DRAINING" if daemon.get("draining") else ""),
              file=out)
        jobs = daemon.get("jobs") or {}
        if jobs:
            # serving-plane line: gang concurrency (running now vs the
            # high-water), the admission state with its blame cause,
            # and the overload tallies (shed/retried/deadline-expired)
            jc = jobs.get("counters") or {}
            adm = jobs.get("admission") or {}
            cause = adm.get("cause") or ""
            print(f"jobs: running {jobs.get('running', 0)} "
                  f"(hwm {jc.get('jobs_concurrent_hwm', 0)})  "
                  f"admission {adm.get('state', 'ok')}"
                  + (f" [{cause}]" if cause else "")
                  + f"  shed {jc.get('jobs_shed', 0)} "
                  f"retried {jc.get('jobs_retried', 0)} "
                  f"deadline {jc.get('jobs_deadline_expired', 0)}",
                  file=out)
        agents = daemon.get("agents") or {}
        if agents:
            # multi-host DVM line: one launch agent per remote host —
            # its health (heartbeat age), session, and how many of
            # its workers it currently reports alive
            parts = []
            for hid in sorted(agents, key=int):
                ag = agents[hid]
                n = len(ag.get("ranks") or ())
                parts.append(
                    f"h{hid}({ag.get('host', '?')}) "
                    f"{ag.get('status', '?')} "
                    f"{ag.get('alive_workers', 0)}/{n}w "
                    f"hb {ag.get('hb_age_ms', 0):.0f}ms "
                    f"{ag.get('session', '')}")
            print("agents: " + "   ".join(parts), file=out)
    #: causal blame causes → column abbreviations (/json "critical")
    blame_abbr = {"arrival-skew": "skew", "dma-wait": "dma",
                  "ring-backpressure": "ring", "cts-wait": "cts",
                  "transport": "wire", "compute": "comp"}
    crit = {str(p): b for p, b in
            ((state.get("critical") or {}).get("per_rank") or {}).items()}
    #: hang-diagnosis per-rank state brief (/json "waitgraph"):
    #: RUNNING / BLOCKED:site→peer / IDLE
    wg = {str(p): s for p, s in (state.get("waitgraph") or {}).items()}
    print(f"{'rank':<5}{'MB/s':>8}{'msg/s':>8}{'delivered':>10}"
          f"{'reconn':>7}{'respwn':>7}{'dedup':>6}{'dlexp':>6}"
          f"{'sdep':>5}{'coal':>6}{'sched':>6}{'dev%':>6}{'dmaw':>7}"
          f"{'plane':>7}{'blame':>6}{'failed':>7}  {'state':<20}"
          "stall causes (ring/cts/other)",
          file=out)
    for p in sorted(procs):
        f = procs[p]
        n = f.get("native") or {}
        mbs, msgs = _rates(f, prev_procs.get(p))
        stall = int(n.get("stall_ns", 0))
        ring = int(n.get("ring_stall_ns", 0))
        cts = int(n.get("cts_wait_ns", 0))
        other = max(0, stall - ring - cts)
        if stall:
            causes = (f"ring {_bar(ring / stall, 6)} "
                      f"cts {_bar(cts / stall, 6)} "
                      f"other {other / stall:>4.0%} "
                      f"({stall / 1e6:.1f} ms)")
        else:
            causes = "-"
        # streaming-engine live signature: per-peer pipelined depth
        # and the share of doorbell wakes the coalescing suppressed
        db = int(n.get("doorbells", 0))
        supp = int(n.get("doorbells_suppressed", 0))
        coal = f"{supp / (db + supp):>5.0%}" if (db + supp) else "    -"
        # dispatch-floor leg: compiled-schedule cache hit rate (the C
        # plan cache + the Python sched store share these counters)
        sh = int(n.get("sched_cache_hits", 0))
        sm = int(n.get("sched_cache_misses", 0))
        sched = f"{sh / (sh + sm):>5.0%}" if (sh + sm) else "    -"
        # device-plane leg: share of data-plane bytes that stayed
        # device-resident (dcn_device_bytes_placed vs the host wire
        # families) — the zero-copy plane's live signature
        devb = int(n.get("device_bytes_placed", 0))
        hostb = sum(int(n.get(k, 0)) for k in _BYTES)
        dev = (f"{devb / (devb + hostb):>5.0%}" if (devb + hostb)
               else "    -")
        # device-plane DMA-wait column: recv-semaphore time this rank
        # spent blocked on remote-copy completion signals (ms)
        dmaw_ns = int(n.get("device_dma_wait_ns", 0))
        dmaw = f"{dmaw_ns / 1e6:>6.1f}" if dmaw_ns else "     -"
        # plane-health column: mid-job failover activity — peers this
        # rank demoted off the device plane / promoted back after a
        # heal probe (dcn_plane_demotions/promotions; "-" = the plane
        # never had to fail over)
        dem = int(n.get("plane_demotions", 0))
        pro = int(n.get("plane_promotions", 0))
        plane = f"{dem}v{pro}^" if (dem or pro) else "      -"
        # causal blame column: this rank's dominant critical-path
        # cause from the aggregator's /critical join
        bl = crit.get(str(p)) or {}
        blame = blame_abbr.get(bl.get("cause", ""), "-") \
            if bl.get("total_ns") else "-"
        failed = f.get("failed") or []
        st_col = wg.get(str(p)) or "-"
        print(f"{p:<5}{mbs:>8.1f}{msgs:>8.0f}"
              f"{int(n.get('delivered', 0)):>10}"
              f"{int(n.get('reconnects', 0)):>7}"
              f"{int(n.get('respawns', 0)):>7}"
              f"{int(n.get('dedup_drops', 0)):>6}"
              f"{int(n.get('deadline_expired', 0)):>6}"
              f"{int(n.get('stream_depth', 0)):>5}{coal:>6}{sched:>6}"
              f"{dev:>6}{dmaw:>7}{plane:>7}{blame:>6}"
              f"{(','.join(map(str, failed)) or '-'):>7}  "
              f"{st_col:<20}{causes}",
              file=out)
    strag = state.get("straggler") or {}
    per_proc = {int(p): s for p, s in
                (strag.get("per_proc") or {}).items()}
    if per_proc:
        print("\ntop stragglers (rolling arrival lateness):", file=out)
        ranked = sorted(per_proc,
                        key=lambda p: -per_proc[p].get("ewma_ns", 0))
        for p in ranked[:4]:
            s = per_proc[p]
            n = max(1, int(s.get("n", 0)))
            print(f"  rank {p}: ewma {int(s.get('ewma_ns', 0)) / 1e6:8.2f} ms"
                  f"   slowest {int(s.get('slowest', 0))}/{n}"
                  f" ({int(s.get('slowest', 0)) / n:.0%})"
                  f"   total skew {int(s.get('skew_ns', 0)) / 1e9:.3f} s",
                  file=out)
    per_op = strag.get("per_op") or {}
    if per_op:
        print("\nper-op arrival skew (cross-rank joins):", file=out)
        print(f"  {'op':<24}{'joins':>7}{'skew ms':>10}{'max ms':>9}"
              f"  slowest rank (count)", file=out)
        for op, st in sorted(per_op.items(),
                             key=lambda kv: -kv[1].get("skew_ns", 0)):
            slowest = st.get("slowest") or {}
            worst = (max(slowest, key=lambda k: slowest[k])
                     if slowest else "-")
            print(f"  {op:<24}{int(st.get('n', 0)):>7}"
                  f"{int(st.get('skew_ns', 0)) / 1e6:>10.2f}"
                  f"{int(st.get('max_skew_ns', 0)) / 1e6:>9.2f}"
                  f"  {worst} ({slowest.get(worst, 0) if slowest else 0})",
                  file=out)
    # rank-local per-op wait (from each rank's straggler summary)
    waits = []
    for p in sorted(procs):
        for op, st in (procs[p].get("straggler") or {}).items():
            if st.get("count"):
                waits.append((p, op, st))
    if waits:
        print("\ncollective wait (rank-local):", file=out)
        print(f"  {'rank':<5}{'op':<24}{'provider':<9}{'calls':>7}"
              f"{'wait ms':>10}{'max ms':>9}", file=out)
        for p, op, st in waits:
            print(f"  {p:<5}{op:<24}{str(st.get('provider', '')):<9}"
                  f"{int(st.get('count', 0)):>7}"
                  f"{int(st.get('wait_ns', 0)) / 1e6:>10.2f}"
                  f"{int(st.get('max_wait_ns', 0)) / 1e6:>9.2f}",
                  file=out)
    flights = {}
    for p in sorted(procs):
        for k, v in (procs[p].get("flight") or {}).items():
            flights[k] = flights.get(k, 0) + int(v)
    if flights:
        print("\nflight records: "
              + ", ".join(f"{k}={v}" for k, v in sorted(flights.items())),
              file=out)


def watch(url: str, interval: float) -> int:
    prev = None
    try:
        while True:
            try:
                state = fetch(url)
            except OSError as e:
                print(f"top: endpoint unreachable ({e}); retrying",
                      file=sys.stderr)
                time.sleep(interval)
                continue
            sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
            render(state, prev, url=url)
            sys.stdout.flush()
            prev = state
            time.sleep(interval)
    except KeyboardInterrupt:
        return 0


# -- selftest ----------------------------------------------------------


def _scrape_url(url: str, timeout: float = 5.0) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def selftest() -> int:
    """Drive a REAL aggregator over REAL HTTP with synthetic 2-rank
    frames: straggler join (rank 1 always late), causal blame join
    (/critical + the blame column), rate computation, Prometheus
    families, history ring, and the renderer."""
    import io

    from ompi_tpu_torch.metrics.live import TelemetryAggregator

    agg = TelemetryAggregator(http_port=0, history=16)
    try:
        base = time.time_ns()
        for rnd in range(3):
            for proc in (0, 1):
                native = {"eager_bytes": 1_000_000 * (rnd + 1),
                          "eager_msgs": 100 * (rnd + 1),
                          "delivered": 50 * (rnd + 1),
                          "stall_ns": 5_000_000 * (rnd + 1),
                          "ring_stall_ns": 3_000_000 * (rnd + 1),
                          "cts_wait_ns": 1_000_000 * (rnd + 1),
                          "device_dma_wait_ns": 2_000_000 * (rnd + 1)}
                if proc == 0:
                    # rank 0 demoted its peer off the device plane
                    # once and a heal probe promoted it back — the
                    # plane-health column must surface the transition
                    native.update(plane_demotions=1, plane_promotions=1,
                                  plane_heal_probes=1)
                # rank 1 arrives 25 ms late at every collective
                late = 25_000_000 if proc == 1 else 0
                colls = [[f"MPI_COMM_WORLD/allreduce/{rnd * 4 + i}",
                          base + (rnd * 4 + i) * 50_000_000 + late,
                          base + (rnd * 4 + i) * 50_000_000 + late
                          + 1_000_000] for i in range(4)]
                # causal records for the same instances (fold+bcast
                # shape): rank 0 waits 25 ms for rank 1's late
                # contribution — the /critical join must blame rank 1
                # with arrival-skew
                causal_rows = []
                for i in range(4):
                    t0 = base + (rnd * 4 + i) * 50_000_000
                    key = f"MPI_COMM_WORLD/allreduce/{rnd * 4 + i}"
                    if proc == 0:
                        causal_rows.append(
                            [key, t0, t0 + 25_600_000, "han",
                             [[0, t0 + 25_500_000, 1]],
                             [[1, 0, t0 + 25_200_000, 25_000_000]],
                             {"ring": 0, "cts": 0, "dma": 0}])
                    else:
                        causal_rows.append(
                            [key, t0 + 25_000_000, t0 + 26_500_000,
                             "han", [[0, t0 + 25_100_000, 0]],
                             [[0, 0, t0 + 26_400_000, 800_000]],
                             {"ring": 0, "cts": 0, "dma": 0}])
                agg.ingest({
                    "proc": proc, "nprocs": 2,
                    "ts_ns": base + rnd * 500_000_000,
                    "native": native,
                    "straggler": {"allreduce": {
                        "count": 4 * (rnd + 1),
                        "wait_ns": 30_000_000 * (rnd + 1),
                        "max_wait_ns": 9_000_000,
                        "provider": "han"}},
                    "colls": colls,
                    "causal": causal_rows,
                    "clock": {"1": [0, 1000]} if proc == 0 else {},
                    "failed": [],
                })
        # real HTTP: Prometheus text with per-rank dcn counters and
        # the straggler attribution naming rank 1
        with urllib.request.urlopen(agg.url + "/metrics",
                                    timeout=5) as r:
            prom = r.read().decode()
        assert 'ompi_tpu_dcn_delivered{proc="0"} 150' in prom, prom
        assert 'ompi_tpu_dcn_delivered{proc="1"} 150' in prom, prom
        assert "ompi_tpu_coll_arrival_skew_ns_total" in prom, prom
        s0 = [l for l in prom.splitlines()
              if l.startswith('ompi_tpu_straggler_score_ns{proc="0"}')]
        s1 = [l for l in prom.splitlines()
              if l.startswith('ompi_tpu_straggler_score_ns{proc="1"}')]
        assert s0 and s1, prom
        assert int(s1[0].rsplit(" ", 1)[1]) > int(s0[0].rsplit(" ", 1)[1])
        slowest = [l for l in prom.splitlines() if l.startswith(
            'ompi_tpu_straggler_slowest_total{proc="1"}')]
        assert slowest and int(slowest[0].rsplit(" ", 1)[1]) == 12, prom
        # /json + renderer: the dashboard names rank 1 the straggler
        state = fetch(agg.url)
        assert state["frames"] == 6, state["frames"]
        pp = state["straggler"]["per_proc"]
        assert pp["1"]["slowest"] == 12 and pp["0"]["slowest"] == 0, pp
        assert abs(pp["1"]["skew_ns"] - 12 * 25_000_000) < 1_000, pp
        buf = io.StringIO()
        render(state, prev=None, url=agg.url, out=buf)
        text = buf.getvalue()
        assert "top stragglers" in text and "rank 1" in text, text
        assert "allreduce" in text and "stall causes" in text, text
        # causal blame column: the aggregator joined 12 instances and
        # the dashboard blames rank 1 with arrival-skew; rank 0's
        # on-path share is sub-ms waits, so it shows a non-skew cause
        crit = state.get("critical") or {}
        assert crit["per_rank"]["1"]["cause"] == "arrival-skew", crit
        assert crit["instances"] == 12, crit
        row1 = [l for l in text.splitlines()
                if l.startswith("1 ")][0]
        assert "skew" in row1, row1
        # device-plane DMA-wait column renders the latest frame's ms
        assert "   6.0" in row1, row1
        # plane-health column: rank 0 shows its demotion + promotion,
        # rank 1 (no failover activity) stays "-"
        row0 = [l for l in text.splitlines()
                if l.startswith("0 ")][0]
        assert "1v1^" in row0 and "1v1^" not in row1, (row0, row1)
        # /critical full endpoint: top paths + per-job state over HTTP
        cstate = json.loads(_scrape_url(agg.url + "/critical"))
        assert cstate["dominant"]["rank"] == 1, cstate["dominant"]
        assert cstate["dominant"]["cause"] == "arrival-skew", cstate
        top_rows = cstate["jobs"][""]["top"]
        assert top_rows and top_rows[0]["path"], top_rows[:1]
        prof = cstate["jobs"][""]["profile"]
        assert "allreduce/han" in prof and prof["allreduce/han"]["n"] == 12
        # tpud extension: a daemon host publishes liveness + journal
        # depth through extra_state; the renderer gives it a line
        agg.extra_state = lambda: {"daemon": {
            "pid": 4242, "generation": 2, "crash_safe": True,
            "queued": 1, "outstanding": 2, "journal_depth": 3,
            "adopting": [1], "procs": {"0": "active", "1": "adopting"},
            "draining": False,
            "jobs": {"running": 2,
                     "counters": {"jobs_concurrent_hwm": 2,
                                  "jobs_shed": 1, "jobs_retried": 1,
                                  "jobs_deadline_expired": 0},
                     "admission": {"state": "shedding",
                                   "cause": "arrival-skew"}},
            "agents": {"1": {"host": "fakehostB", "status": "active",
                             "session": "g2s1", "ranks": [2, 3],
                             "pid": 777, "hb_age_ms": 321.0,
                             "alive_workers": 2, "spawns": 2}}}}
        dstate = fetch(agg.url)
        assert dstate["daemon"]["generation"] == 2, dstate
        buf = io.StringIO()
        render(dstate, prev=None, url=agg.url, out=buf)
        dtext = buf.getvalue()
        assert ("daemon: pid 4242 gen 2 crash-safe" in dtext
                and "journal 3" in dtext
                and "ADOPTING [1]" in dtext), dtext
        # serving-plane line: concurrency + admission + overload tallies
        assert ("jobs: running 2 (hwm 2)  admission shedding "
                "[arrival-skew]  shed 1 retried 1 deadline 0"
                in dtext), dtext
        # multi-host DVM: the per-host agent-health line
        assert ("agents: h1(fakehostB) active 2/2w hb 321ms g2s1"
                in dtext), dtext
        agg.extra_state = None
        # /history serves the JSONL ring
        with urllib.request.urlopen(agg.url + "/history",
                                    timeout=5) as r:
            hist = [json.loads(l) for l in r.read().decode().splitlines()]
        assert len(hist) == 6 and hist[-1]["proc"] == 1, len(hist)
        # rate computation between two frames
        f0 = {"ts_ns": 0, "native": {"eager_bytes": 0, "eager_msgs": 0}}
        f1 = {"ts_ns": 1_000_000_000,
              "native": {"eager_bytes": 2_000_000, "eager_msgs": 10}}
        mbs, msgs = _rates(f1, f0)
        assert abs(mbs - 2.0) < 1e-6 and abs(msgs - 10.0) < 1e-6
        # hang-diagnosis state column: one more frame pair — rank 0's
        # counters stop moving (IDLE), rank 1 ships a blocked-state
        # snapshot (BLOCKED:site→peer) — and /waitgraph walks the
        # chain to the root
        t4 = base + 3 * 500_000_000
        nat0 = {"eager_bytes": 3_000_000, "eager_msgs": 300,
                "delivered": 150, "stall_ns": 15_000_000,
                "ring_stall_ns": 9_000_000, "cts_wait_ns": 3_000_000,
                "device_dma_wait_ns": 6_000_000}
        agg.ingest({"proc": 1, "nprocs": 2, "ts_ns": t4,
                    "native": dict(nat0), "straggler": {}, "colls": [],
                    "waits": {"ts_ns": t4, "waits": [
                        {"site": "cts", "plane": "tcp", "peer": 0,
                         "since_ns": t4 - 700_000_000}]}})
        nat0.update(plane_demotions=1, plane_promotions=1,
                    plane_heal_probes=1)
        agg.ingest({"proc": 0, "nprocs": 2, "ts_ns": t4,
                    "native": nat0, "straggler": {}, "colls": []})
        wstate = fetch(agg.url)
        assert wstate["waitgraph"] == {"0": "IDLE",
                                       "1": "BLOCKED:cts→0"}, \
            wstate["waitgraph"]
        wg = json.loads(_scrape_url(agg.url + "/waitgraph"))
        assert wg["verdict"]["kind"] == "straggler", wg["verdict"]
        assert wg["verdict"]["root"]["rank"] == 0, wg["verdict"]
        assert [(e["src"], e["dst"]) for e in
                wg["graph"]["edges"]] == [(1, 0)], wg["graph"]
        buf = io.StringIO()
        render(wstate, prev=None, url=agg.url, out=buf)
        wtext = buf.getvalue()
        wrow1 = [l for l in wtext.splitlines() if l.startswith("1 ")][0]
        wrow0 = [l for l in wtext.splitlines() if l.startswith("0 ")][0]
        assert "BLOCKED:cts→0" in wrow1, wrow1
        assert "IDLE" in wrow0 and "BLOCKED" not in wrow0, wrow0
        print("selftest OK: 6 frames ingested over HTTP, 12 straggler "
              "joins (rank 1 slowest 12/12), prometheus families, "
              "history ring, renderer, waitgraph state column")
        return 0
    finally:
        agg.close()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ompi_tpu_torch top",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--url", default="http://127.0.0.1:9321",
                    help="aggregator base URL (the launcher prints it)")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="refresh period, seconds")
    ap.add_argument("--once", action="store_true",
                    help="print one frame and exit (no screen clearing)")
    ap.add_argument("--selftest", action="store_true",
                    help="run the built-in self-check and exit")
    ns = ap.parse_args(argv)
    if ns.selftest:
        return selftest()
    url = ns.url.rstrip("/")
    if ns.once:
        render(fetch(url), url=url)
        return 0
    return watch(url, ns.interval)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""trace_report — summarize / merge ompi_tpu_torch Chrome trace files.

Usage::

    # per-op latency summary + slowest spans from one or more rank files
    python -m ompi_tpu_torch trace-report trace.0.json trace.1.json [--top N]

    # also write the merged single-timeline Chrome trace
    python -m ompi_tpu_torch trace-report trace.*.json --merge-out merged.json

    # cross-rank causal critical paths (traces recorded with
    # --mca trace_causal 1), or a hang diagnosis over metrics/crash
    # .jsonl exports
    python -m ompi_tpu_torch trace-report trace.*.json --critical-path
    python -m ompi_tpu_torch trace-report m.*.jsonl --hangs

    # self-check (no input files): synthesizes a 2-rank trace through
    # the real tracer/export/merge stack and validates the invariants
    python -m ompi_tpu_torch trace-report --selftest

Port of the reference's ``tools/trace_report.py`` over the port's
``trace/{core,chrome,merge,causal,waitgraph}``: the same flags and the
same report text.  Input files are what ``--mca trace_enable 1 --mca
trace_output <path>`` writes at finalize (``<path>.<proc>.json``).  It
reads files only: importing the trace package may import torch, but a
report never initialises CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

from ompi_tpu_torch.trace import causal, chrome, core, merge, waitgraph
from ompi_tpu_torch.tools import GOLDEN


def percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over a pre-sorted list."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def summarize(doc: dict[str, Any]) -> list[dict[str, Any]]:
    """Per-(layer, op) latency rows from a Chrome trace dict."""
    groups: dict[tuple[str, str], list[float]] = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        groups.setdefault((ev.get("cat", "?"), ev["name"]), []).append(
            float(ev.get("dur", 0.0))
        )
    rows = []
    for (cat, name), durs in sorted(groups.items()):
        durs.sort()
        rows.append({
            "layer": cat, "op": name, "count": len(durs),
            "p50_us": percentile(durs, 0.50),
            "p99_us": percentile(durs, 0.99),
            "max_us": durs[-1],
            "total_ms": sum(durs) / 1000.0,
        })
    return rows


def slowest(doc: dict[str, Any], top: int) -> list[dict[str, Any]]:
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    spans.sort(key=lambda e: -float(e.get("dur", 0.0)))
    return spans[:top]


def render(doc: dict[str, Any], top: int, out=sys.stdout) -> None:
    rows = summarize(doc)
    pids = sorted({int(e.get("pid", 0)) for e in doc["traceEvents"]})
    n_ev = sum(1 for e in doc["traceEvents"] if e.get("ph") != "M")
    print(f"trace: {n_ev} events from {len(pids)} process(es) {pids}",
          file=out)
    print(f"{'layer':<9}{'op':<28}{'count':>7}{'p50 µs':>10}"
          f"{'p99 µs':>10}{'max µs':>10}{'total ms':>10}", file=out)
    for r in rows:
        print(f"{r['layer']:<9}{r['op']:<28}{r['count']:>7}"
              f"{r['p50_us']:>10.1f}{r['p99_us']:>10.1f}"
              f"{r['max_us']:>10.1f}{r['total_ms']:>10.2f}", file=out)
    sl = slowest(doc, top)
    if sl:
        print(f"\nslowest {len(sl)} spans:", file=out)
        for e in sl:
            args = e.get("args") or {}
            key = args.get("key") or args.get("comm", "")
            print(f"  {e.get('dur', 0.0):>10.1f} µs  pid={e.get('pid', 0)} "
                  f"{e.get('cat', '?')}/{e['name']}  {key}", file=out)


def render_critical(summary: dict, top: int, out=sys.stdout) -> None:
    """Render a causal blame summary (``causal.solve`` output): the
    per-rank decomposition, the per-algorithm profile, and the top-N
    slowest collectives with their critical paths."""
    n = summary.get("instances", 0)
    print(f"\ncausal critical path: {n} cross-rank instance(s) solved",
          file=out)
    if not n:
        print("  (no causal events — run with --mca trace_causal 1)",
              file=out)
        return
    print(f"  {'rank':<5}{'on-path ms':>11}  blame breakdown", file=out)
    per_rank = summary.get("per_rank") or {}
    for r in sorted(per_rank, key=int):
        b = per_rank[r]
        total = sum(b.values())
        causes = "  ".join(
            f"{c} {v / 1e6:.2f}ms"
            for c, v in sorted(b.items(), key=lambda kv: -kv[1]))
        print(f"  {r:<5}{total / 1e6:>11.2f}  {causes}", file=out)
    dom = summary.get("dominant") or {}
    print(f"  dominant: rank {dom.get('rank')} "
          f"cause={dom.get('cause')} ({dom.get('ns', 0) / 1e6:.2f} ms)",
          file=out)
    prof = summary.get("profile") or {}
    if prof:
        print("\n  per-algorithm blame profile:", file=out)
        print(f"  {'op/alg':<28}{'n':>5}{'avg ms':>9}  top causes",
              file=out)
        for key in sorted(prof):
            p = prof[key]
            avg = p["makespan_ns"] / max(1, p["n"]) / 1e6
            causes = sorted(p.get("causes", {}).items(),
                            key=lambda kv: -kv[1])[:3]
            ctext = "  ".join(f"{c} {v / 1e6:.2f}ms" for c, v in causes)
            print(f"  {key:<28}{p['n']:>5}{avg:>9.2f}  {ctext}", file=out)
    rows = (summary.get("top") or [])[:top]
    if rows:
        print(f"\n  slowest {len(rows)} collective(s):", file=out)
        for cp in rows:
            d = cp.get("dominant") or {}
            print(f"    {cp['makespan_ns'] / 1e6:>9.2f} ms  {cp['key']}"
                  f"  [{cp.get('alg') or '?'}]  dominant: rank "
                  f"{d.get('rank')} {d.get('cause')}", file=out)
            for r, cause, ns in cp.get("path") or ():
                print(f"        rank {r:<3}{cause:<18}"
                      f"{ns / 1e6:>9.3f} ms", file=out)


def hangs_from_jsonl(paths) -> tuple[dict[int, dict], set[int]]:
    """Per-proc blocked-state snapshots from metrics/crash ``.jsonl``
    exports: the newest record per proc carrying a ``waits`` section
    wins (a crash export's final snapshot is the hang's last picture).
    Accepts both shapes — finalize/crash snapshots hold the flat wait
    list, telemetry-frame dumps nest the full snapshot dict."""
    snaps: dict[int, dict] = {}
    failed: set[int] = set()
    for path in paths:
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                for x in rec.get("failed") or ():
                    failed.add(int(x))
                w = rec.get("waits")
                proc = rec.get("proc")
                if proc is None or not w:
                    continue
                snap = (w if isinstance(w, dict)
                        else {"ts_ns": rec.get("ts_ns", 0), "waits": w})
                prev = snaps.get(int(proc))
                if (prev is None
                        or int(snap.get("ts_ns") or 0)
                        >= int(prev.get("ts_ns") or 0)):
                    snaps[int(proc)] = snap
    return snaps, failed


def render_hangs(snaps: dict[int, dict], failed=(),
                 out=sys.stdout) -> dict:
    """Offline hang diagnosis: wait-for graph + classification over
    per-proc blocked-state snapshots (the ``--hangs`` mode body; also
    exercised by the selftest).  Returns the verdict."""
    graph = waitgraph.build_graph(snaps, failed=sorted(failed))
    verdict = waitgraph.classify(graph)
    print(f"hang diagnosis: {len(snaps)} rank(s) reporting blocked "
          f"state, {len(graph['edges'])} wait edge(s)", file=out)
    for e in graph["edges"]:
        dst = "?" if e["dst"] is None else e["dst"]
        ident = e.get("key") or (f"{e['cid']}/{e['seq']}"
                                 if e.get("cid") else "")
        print(f"  rank {e['src']:<4} {e['site']}→{dst:<4} "
              f"[{e['plane']}]  age {e['age_ns'] / 1e6:.0f} ms"
              + (f"  {ident}" if ident else ""), file=out)
    kind = verdict["kind"]
    if kind == "deadlock":
        loop = "→".join(str(r) for r in
                        verdict["cycle"] + verdict["cycle"][:1])
        print(f"verdict: deadlock — cycle {loop}", file=out)
    elif kind == "straggler":
        root = verdict["root"]
        chain = "→".join(str(r) for r in verdict["chain"])
        print(f"verdict: straggler — rank {root['rank']} holds the "
              f"mesh ({chain}); site={root['site']} "
              f"plane={root['plane']} cause={root['cause']}", file=out)
    elif kind == "failed-peer":
        print(f"verdict: failed peer — rank {verdict['rank']} is dead/"
              f"demoted; waiters parked in {verdict['site']} on the "
              f"{verdict['plane']} plane", file=out)
    else:
        print("verdict: compute — no MPI wait edges; the application "
              "is (or every rank was) computing", file=out)
    return verdict


def _golden_waitgraph_check() -> None:
    """Classify the golden wait-graph fixture and hold the answers —
    the hang-solver regression half of the selftest (tier-1)."""
    import io

    with open(GOLDEN / "waitgraph_fixture.json") as f:
        doc = json.load(f)
    for name, case in doc["cases"].items():
        snaps = {int(r): s for r, s in case["snaps_by_rank"].items()}
        graph = waitgraph.build_graph(snaps,
                                      failed=case.get("failed") or ())
        v = waitgraph.classify(graph)
        exp = case["expect"]
        assert v["kind"] == exp["kind"], (name, v)
        if "cycle_edges" in exp:
            got = sorted((e["src"], e["dst"]) for e in v["edges"])
            assert got == [tuple(e) for e in exp["cycle_edges"]], (name, v)
            assert sorted(v["cycle"]) == exp["cycle_ranks"], (name, v)
        if "root_rank" in exp:
            assert v["root"]["rank"] == exp["root_rank"], (name, v)
            assert v["root"]["cause"] == exp["cause"], (name, v)
            assert v["root"]["site"] == exp["site"], (name, v)
            assert v["root"]["plane"] == exp["plane"], (name, v)
            assert v["chain"] == exp["chain"], (name, v)
        # the offline renderer names the same verdict on the same data
        buf = io.StringIO()
        rv = render_hangs(snaps, case.get("failed") or (), out=buf)
        assert rv["kind"] == exp["kind"], (name, buf.getvalue())
        assert exp["kind"] in buf.getvalue(), buf.getvalue()


def _golden_causal_check() -> None:
    """Solve the golden causal-DAG fixture and hold the answer — the
    solver-regression half of the selftest (tier-1)."""
    with open(GOLDEN / "causal_fixture.json") as f:
        doc = json.load(f)
    records = {int(p): rows
               for p, rows in doc["records_by_proc"].items()}
    out = causal.profile_from_records(records)
    exp = doc["expect"]
    assert out["instances"] == exp["instances"], (
        out["instances"], exp["instances"])
    assert out["dominant"]["rank"] == exp["rank"], out["dominant"]
    assert out["dominant"]["cause"] == exp["cause"], out["dominant"]
    for key, causes in (exp.get("per_rank") or {}).items():
        got = out["per_rank"][int(key)]
        for cause, ns in causes.items():
            assert got.get(cause) == ns, (key, cause, got)
    # render exercises the report path on the same data
    import io

    buf = io.StringIO()
    render_critical(out, top=3, out=buf)
    text = buf.getvalue()
    assert "dominant: rank" in text and exp["cause"] in text, text


def _causal_stack_check(tmp: str) -> dict:
    """Drive the REAL causal hooks → Chrome export → merge →
    instances_from_chrome → solver for two synthetic ranks; returns
    the solved summary (plumbing half of the selftest)."""
    import os

    paths = []
    for rank in range(2):
        core.reset()
        causal.reset()
        core.enable(True, buffer_events=1024)
        causal.enable(True)
        for i in range(2):
            causal.begin_op("MPI_COMM_WORLD", "allreduce", i)
            causal.note_send(1 - rank)
            causal.note_recv(1 - rank,
                             [causal.CTX_VERSION, "MPI_COMM_WORLD",
                              "allreduce", i, 0], 50_000)
            causal.end_op(alg="basic")
        assert causal.counter("records") == 2, causal.counters_snapshot()
        assert causal.counter("sends") == 2 and causal.counter("recvs") == 2
        p = os.path.join(tmp, f"causal.{rank}.json")
        chrome.dump(p, pid=rank)
        paths.append(p)
    merged = merge.merge_files(paths)
    insts = causal.instances_from_chrome(merged)
    assert len(insts) == 2, sorted(insts)
    for inst in insts.values():
        assert sorted(inst["ranks"]) == [0, 1], inst["ranks"]
        for st in inst["ranks"].values():
            assert st["exit"] >= st["arrive"] and st["sends"] and st["recvs"]
    summary = causal.solve(insts, nprocs=2)
    assert summary["instances"] == 2, summary
    assert summary["dominant"]["rank"] in (0, 1)
    return summary


def selftest() -> int:
    """Drive the real tracer → export → merge → report stack on
    synthetic 2-rank data and assert the subsystem invariants."""
    import os
    import tempfile

    was_enabled = core.enabled()
    tmp = tempfile.mkdtemp(prefix="ompi_tpu_torch_trace_selftest_")
    paths = []
    try:
        for rank in range(2):
            core.reset()
            core.enable(True, buffer_events=1024)
            for i in range(3):
                t0 = core.now()
                core.instant("coll", "tuned_decision", coll="allreduce",
                             algorithm="psum")
                t1 = core.now()
                core.complete("dcn", "send", t1, nbytes=4096, peer="peer",
                              proto="eager")
                core.complete("coll", "allreduce", t1, provider="han")
                core.complete("api", "allreduce", t0, comm="MPI_COMM_WORLD",
                              seq=core.next_seq("MPI_COMM_WORLD", "allreduce"),
                              nbytes=4096)
            p = os.path.join(tmp, f"trace.{rank}.json")
            chrome.dump(p, pid=rank)
            paths.append(p)
        merged = merge.merge_files(paths)
        # merged doc is valid Chrome JSON
        json.loads(json.dumps(merged))
        assert merged["otherData"]["merged_processes"] == [0, 1], merged[
            "otherData"]
        # both ranks produced the SAME collective key sequence
        k0 = merge.collective_keys(merged, pid=0)
        k1 = merge.collective_keys(merged, pid=1)
        assert k0 == k1 != [], (k0, k1)
        assert k0 == [("MPI_COMM_WORLD", "allreduce", i) for i in range(3)]
        # spans from ≥3 distinct layers survived the merge
        cats = {e.get("cat") for e in merged["traceEvents"]
                if e.get("ph") == "X"}
        assert {"api", "coll", "dcn"} <= cats, cats
        # timestamps are monotonic per rank
        for pid in (0, 1):
            ts = [e["ts"] for e in merged["traceEvents"]
                  if e.get("ph") == "X" and e["pid"] == pid
                  and e["name"] == "allreduce" and e.get("cat") == "api"]
            assert ts == sorted(ts), ts
        # the report renders non-trivially
        import io

        buf = io.StringIO()
        render(merged, top=5, out=buf)
        text = buf.getvalue()
        assert "allreduce" in text and "p99" in text, text
        # causal-tracing legs: the golden DAG fixture pins the solver
        # (dominant rank + cause + per-rank buckets), then the real
        # hook → chrome → merge → solve stack proves the plumbing
        _golden_causal_check()
        summary = _causal_stack_check(tmp)
        # hang-diagnosis leg: the golden wait-graph fixture pins the
        # deadlock-cycle and straggler-chain classifications (and the
        # --hangs renderer) against the solver
        _golden_waitgraph_check()
        print("selftest OK: 2 ranks, "
              f"{len(merged['traceEvents'])} merged events, keys "
              f"aligned; causal golden + {summary['instances']} "
              "stack-solved instances; waitgraph golden held")
        return 0
    finally:
        core.reset()
        core.enable(was_enabled)
        causal.reset()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ompi_tpu_torch trace-report",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("traces", nargs="*", help="per-rank Chrome trace files")
    ap.add_argument("--top", type=int, default=10,
                    help="how many slowest spans to list")
    ap.add_argument("--merge-out", metavar="PATH",
                    help="write the merged Chrome trace here")
    ap.add_argument("--clock-from", nargs="+", metavar="JSONL",
                    help="metrics .jsonl snapshots carrying handshake "
                    "clock offsets: align each rank's timeline before "
                    "merging (survives host clock skew)")
    ap.add_argument("--offset", action="append", default=[],
                    metavar="PID=US",
                    help="explicit per-rank clock offset in µs "
                    "(that rank's clock minus the reference clock; "
                    "repeatable, overrides --clock-from)")
    ap.add_argument("--critical-path", action="store_true",
                    help="solve the cross-rank causal DAG (requires "
                    "traces recorded with --mca trace_causal 1): "
                    "per-collective critical paths, per-rank blame "
                    "decomposition, per-algorithm profiles")
    ap.add_argument("--hangs", action="store_true",
                    help="hang diagnosis: treat the input files as "
                    "metrics/crash .jsonl exports, assemble the "
                    "cross-rank wait-for graph from their blocked-"
                    "state snapshots, and name the hang (deadlock "
                    "cycle / straggler root / failed peer / compute)")
    ap.add_argument("--selftest", action="store_true",
                    help="run the built-in self-check and exit")
    ns = ap.parse_args(argv)
    if ns.selftest:
        return selftest()
    if not ns.traces:
        ap.error("no trace files given (or use --selftest)")
    if ns.hangs:
        snaps, failed = hangs_from_jsonl(ns.traces)
        render_hangs(snaps, failed)
        return 0
    offsets: dict[int, float] = {}
    if ns.clock_from:
        snaps = []
        for p in ns.clock_from:
            with open(p) as f:
                snaps += [json.loads(l) for l in f if l.strip()]
        snaps.sort(key=lambda s: s.get("ts_ns", 0))
        offsets = merge.offsets_from_snapshots(snaps)
    for kv in ns.offset:
        pid, _, us = kv.partition("=")
        offsets[int(pid)] = float(us)
    if offsets:
        print("clock offsets (µs, subtracted per rank): "
              + ", ".join(f"{p}={o:+.1f}"
                          for p, o in sorted(offsets.items())))
    doc = merge.merge_files(ns.traces, offsets_us=offsets or None)
    render(doc, top=ns.top)
    if ns.critical_path:
        pids = {int(e.get("pid", 0)) for e in doc["traceEvents"]
                if e.get("ph") != "M"}
        render_critical(
            causal.solve(causal.instances_from_chrome(doc),
                         nprocs=len(pids) or None),
            top=ns.top)
    if ns.merge_out:
        with open(ns.merge_out, "w") as f:
            json.dump(doc, f)
        print(f"\nmerged trace written to {ns.merge_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

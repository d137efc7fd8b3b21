#!/usr/bin/env python
"""metrics_report — analyze ompi_tpu_torch transport telemetry exports.

Usage::

    # per-proc counter tables, stall-cause breakdown, per-op histograms
    python -m ompi_tpu_torch metrics-report run.0.jsonl run.1.jsonl

    # join counter snapshots with trace spans by timestamp
    python -m ompi_tpu_torch metrics-report run.*.jsonl --correlate trace.*.json

    # self-check (no input files): drives the real metrics/export/
    # flight/trace stacks on synthetic 2-rank data
    python -m ompi_tpu_torch metrics-report --selftest

Port of the reference's ``tools/metrics_report.py`` over the port's
``metrics/{core,export,flight}``: the same flags and the same report
text.

Input files are what ``--mca metrics_enable 1 --mca metrics_output
<path>`` writes at finalize (``<path>.<proc>.jsonl``: flight records
in order, then the final snapshot) plus the live-appended
``<path>.flight.<proc>.jsonl``.  ``--correlate`` additionally takes
the ``--mca trace_output`` Chrome files: snapshots and spans share
the wall-clock timeline, so a stall counter jump selects the trace
spans that were in flight when it happened — the join the osu_bw
collapse investigation reads.  It reads files only: importing the
metrics package may import torch, but a report never initialises CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

from ompi_tpu_torch.metrics import core as mcore
from ompi_tpu_torch.metrics import export as mexport

#: the stall decomposition: (component counter, label); the remainder
#: of stall_ns after these is attributed to "other"
STALL_CAUSES = (
    ("ring_stall_ns", "ring backpressure"),
    ("cts_wait_ns", "rendezvous CTS wait"),
)


def load_jsonl(paths: list[str]) -> list[dict[str, Any]]:
    """All snapshots from every file, sorted by (proc, ts)."""
    snaps = []
    for p in paths:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if line:
                    snaps.append(json.loads(line))
    snaps.sort(key=lambda s: (s.get("proc") or 0, s.get("ts_ns", 0)))
    return snaps


def finals(snaps: list[dict]) -> dict[int, dict]:
    """Last snapshot per proc (the finalize export when present)."""
    out: dict[int, dict] = {}
    for s in snaps:
        out[int(s.get("proc") or 0)] = s
    return out


def hist_percentile(hist: list[int], edges: list[int], q: float) -> int:
    """Upper bucket edge at quantile q (log2 buckets are coarse on
    purpose — the report labels these as bucket ceilings)."""
    total = sum(hist)
    if not total:
        return 0
    target = q * total
    cum = 0
    for i, n in enumerate(hist):
        cum += n
        if cum >= target:
            return edges[i] if i < len(edges) else edges[-1] * 2
    return edges[-1] * 2


def stall_breakdown(native: dict[str, int]) -> list[tuple[str, int, float]]:
    """(cause, ns, share-of-stall) rows; 'other' absorbs the rest."""
    stall = int(native.get("stall_ns", 0))
    rows = []
    seen = 0
    for key, label in STALL_CAUSES:
        ns = int(native.get(key, 0))
        seen += ns
        rows.append((label, ns, ns / stall if stall else 0.0))
    other = max(0, stall - seen)
    rows.append(("other", other, other / stall if stall else 0.0))
    return rows


def render_native(by_proc: dict[int, dict], out=sys.stdout) -> None:
    procs = sorted(by_proc)
    names = list(mcore.NATIVE_COUNTERS)
    print(f"native transport counters ({len(procs)} process(es)):",
          file=out)
    print(f"{'counter':<18}" + "".join(f"{f'proc {p}':>14}" for p in procs),
          file=out)
    for n in names:
        vals = [int((by_proc[p].get('native') or {}).get(n, 0))
                for p in procs]
        if not any(vals):
            continue
        print(f"{n:<18}" + "".join(f"{v:>14}" for v in vals), file=out)
    print("\nstall-cause breakdown (send-side dead time):", file=out)
    for p in procs:
        native = by_proc[p].get("native") or {}
        stall = int(native.get("stall_ns", 0))
        print(f"  proc {p}: stall {stall / 1e6:.3f} ms total", file=out)
        for label, ns, share in stall_breakdown(native):
            print(f"    {label:<22}{ns / 1e6:>12.3f} ms {share:>7.1%}",
                  file=out)
        # streaming send engine: how much of the doorbell traffic the
        # coalescing removed, and how deep the pipelined queue ran —
        # the osu_bw-collapse fix's live signature
        db = int(native.get("doorbells", 0))
        supp = int(native.get("doorbells_suppressed", 0))
        if db + supp:
            print(f"    doorbell coalescing   {supp}/{db + supp} wakes "
                  f"suppressed ({supp / (db + supp):>6.1%})", file=out)
        if int(native.get("stream_msgs", 0)):
            print(f"    streaming sender      "
                  f"{int(native.get('stream_msgs', 0))} msgs, "
                  f"depth hwm {int(native.get('stream_depth_hwm', 0))}, "
                  f"inflight hwm "
                  f"{int(native.get('stream_inflight_hwm', 0)) / 2**20:.1f}"
                  f" MiB, {int(native.get('chunk_shrinks', 0))} chunk "
                  f"shrinks, {int(native.get('sender_yields', 0))} "
                  f"yields, {int(native.get('enqueue_waits', 0))} "
                  f"enqueue waits", file=out)
        # dispatch-floor leg: how many collectives the C fast path
        # served, the compiled-schedule cache hit rate (C plan cache +
        # the Python sched store share the two counters), and receives
        # landed straight in posted buffers
        hits = int(native.get("sched_cache_hits", 0))
        miss = int(native.get("sched_cache_misses", 0))
        fpo = int(native.get("coll_fastpath_ops", 0))
        if fpo or hits or miss:
            rate = (f"{hits / (hits + miss):>6.1%}" if hits + miss
                    else "     -")
            print(f"    coll fast path        {fpo} C-served ops, "
                  f"schedule cache {hits}/{hits + miss} hits ({rate})",
                  file=out)
        if int(native.get("recv_into_placed", 0)):
            print(f"    recv_into placement   "
                  f"{int(native.get('recv_into_placed', 0))} receives "
                  f"landed in posted buffers", file=out)


def render_ops(by_proc: dict[int, dict], out=sys.stdout) -> None:
    size_edges = mexport._size_bucket_edges()
    lat_edges = mexport._lat_bucket_edges_us()
    rows = []
    for p, snap in sorted(by_proc.items()):
        for op, st in (snap.get("ops") or {}).items():
            rows.append((p, op, st))
    if not rows:
        return
    print("\nper-op telemetry (histogram bucket ceilings):", file=out)
    print(f"{'proc':<5}{'op':<28}{'count':>8}{'bytes':>14}"
          f"{'size p50 B':>12}{'lat p50 µs':>12}{'lat p99 µs':>12}",
          file=out)
    for p, op, st in rows:
        lat = st.get("lat_hist") or []
        has_lat = any(lat)
        print(
            f"{p:<5}{op:<28}{st.get('count', 0):>8}"
            f"{st.get('bytes', 0):>14}"
            f"{hist_percentile(st.get('size_hist') or [], size_edges, 0.5):>12}"
            f"{hist_percentile(lat, lat_edges, 0.5) if has_lat else 0:>12}"
            f"{hist_percentile(lat, lat_edges, 0.99) if has_lat else 0:>12}",
            file=out)


def render_straggler(by_proc: dict[int, dict], out=sys.stdout) -> None:
    """Per-op collective wait table (the straggler profiler's
    rank-local leg; cross-rank skew attribution joins on the live
    endpoint or via join_skew over the instance records)."""
    rows = []
    for p, snap in sorted(by_proc.items()):
        for op, st in (snap.get("straggler") or {}).items():
            rows.append((p, op, st))
    if not rows:
        return
    print("\ncollective wait (straggler profiler, rank-local):",
          file=out)
    print(f"{'proc':<5}{'op':<24}{'provider':<10}{'count':>7}"
          f"{'wait ms':>12}{'max ms':>10}{'mean ms':>10}", file=out)
    for p, op, st in rows:
        n = int(st.get("count", 0)) or 1
        print(f"{p:<5}{op:<24}{str(st.get('provider', '')):<10}"
              f"{st.get('count', 0):>7}"
              f"{int(st.get('wait_ns', 0)) / 1e6:>12.3f}"
              f"{int(st.get('max_wait_ns', 0)) / 1e6:>10.3f}"
              f"{int(st.get('wait_ns', 0)) / n / 1e6:>10.3f}", file=out)


def render_flight(snaps: list[dict], out=sys.stdout) -> None:
    recs = [s for s in snaps if s.get("reason") not in (None, "finalize")]
    if not recs:
        return
    print(f"\nflight records ({len(recs)}):", file=out)
    for r in recs:
        native = r.get("native") or {}
        detail = r.get("detail") or {}
        dtxt = " ".join(f"{k}={v}" for k, v in detail.items())
        print(f"  proc {r.get('proc')}  {r.get('reason'):<14} "
              f"ts={r.get('ts_ns', 0) / 1e9:.6f}  "
              f"stall={int(native.get('stall_ns', 0)) / 1e6:.3f}ms "
              f"rndv_depth={native.get('rndv_depth', 0)} "
              f"ring_hwm={native.get('ring_hwm', 0)}  {dtxt}", file=out)


# -- trace correlation -------------------------------------------------


def load_trace_spans(paths: list[str]) -> list[dict]:
    spans = []
    for p in paths:
        with open(p) as f:
            doc = json.load(f)
        spans += [e for e in doc.get("traceEvents", [])
                  if e.get("ph") == "X"]
    spans.sort(key=lambda e: e.get("ts", 0.0))
    return spans


def correlate(snaps: list[dict], spans: list[dict], top: int = 5,
              out=sys.stdout,
              offsets_us: dict[int, float] | None = None) -> int:
    """Join snapshots to trace spans on the shared wall-clock base.

    For consecutive snapshots of one proc the window is [prev, cur];
    the first snapshot looks back 60 s (a run's worth).  Reports the
    stall delta across the window next to the slowest spans inside it
    — 'what was on the wire while the counters moved'.  Returns the
    joined-window count.  ``offsets_us`` (pid → clock offset vs rank
    0, from the handshake estimate each rank-0 snapshot carries)
    aligns both spans and snapshot timestamps onto rank 0's clock
    before joining, so the windows survive host clock skew."""
    if offsets_us:
        spans = [dict(e, ts=float(e.get("ts", 0.0))
                      - offsets_us.get(int(e.get("pid", 0)), 0.0))
                 for e in spans]
    joined = 0
    by_proc: dict[int, list[dict]] = {}
    for s in snaps:
        p = int(s.get("proc") or 0)
        if offsets_us and offsets_us.get(p):
            s = dict(s, ts_ns=int(s.get("ts_ns", 0)
                                  - offsets_us[p] * 1000.0))
        by_proc.setdefault(p, []).append(s)
    for p, plist in sorted(by_proc.items()):
        prev_ts = None
        prev_stall = 0
        for s in plist:
            ts_us = s.get("ts_ns", 0) / 1000.0
            lo = prev_ts if prev_ts is not None else ts_us - 60_000_000.0
            native = s.get("native") or {}
            stall = int(native.get("stall_ns", 0))
            inwin = [e for e in spans
                     if lo <= e.get("ts", 0.0) <= ts_us
                     and int(e.get("pid", 0)) == p]
            if inwin:
                joined += 1
            inwin.sort(key=lambda e: -float(e.get("dur", 0.0)))
            print(f"proc {p} snapshot '{s.get('reason')}' "
                  f"@{ts_us / 1e6:.6f}s: Δstall "
                  f"{(stall - prev_stall) / 1e6:+.3f} ms, "
                  f"{len(inwin)} trace span(s) in window", file=out)
            for e in inwin[:top]:
                args = e.get("args") or {}
                key = args.get("key") or args.get("comm", "")
                print(f"    {float(e.get('dur', 0.0)):>10.1f} µs  "
                      f"{e.get('cat', '?')}/{e.get('name')}  {key}",
                      file=out)
            prev_ts, prev_stall = ts_us, stall
    return joined


# -- selftest ----------------------------------------------------------


def selftest() -> int:
    """Drive the real metrics → flight → export stack (plus the
    tracer for the correlation leg) on synthetic 2-rank data and
    assert the subsystem invariants."""
    import io
    import os
    import shutil
    import tempfile

    from ompi_tpu_torch.metrics import core, flight
    from ompi_tpu_torch.metrics import export as exp
    from ompi_tpu_torch.trace import chrome, core as trace

    was_enabled = core.enabled()
    tmp = tempfile.mkdtemp(prefix="ompi_tpu_torch_metrics_selftest_")

    class FakeEngine:
        """Stands in for libtpudcn's counter block."""

        def __init__(self, rank: int):
            self.c = {k: 0 for k in core.NATIVE_COUNTERS}
            self.c.update(doorbells=10 + rank, stall_ns=2_500_000,
                          ring_stall_ns=1_500_000, ring_stalls=3,
                          cts_wait_ns=800_000, cts_waits=2,
                          ring_hwm=1 << 20, eager_msgs=8,
                          eager_bytes=1 << 16, chunked_msgs=1,
                          chunked_bytes=8 << 20, delivered=9)

        def stats(self):
            return dict(self.c)

    try:
        jsonl_paths, trace_paths = [], []
        for rank in range(2):
            core.reset()
            trace.reset()
            core.enable(True)
            trace.enable(True, buffer_events=1024)
            eng = FakeEngine(rank)
            core.register_provider(eng, eng.stats)
            flight.configure(output="")
            flight.set_proc(rank)
            for i in range(4):
                t0 = trace.now()
                core.observe("dcn_p2p_send", 4096 << i, 50_000 * (i + 1))
                trace.complete("dcn", "send", t0, nbytes=4096 << i,
                               proto="eager", peer="peer")
            eng.c["stall_ns"] += 5_000_000
            eng.c["ring_stall_ns"] += 5_000_000
            rec = flight.record("recv_timeout", cid="c1", seq=7)
            assert rec and rec["native"]["doorbells"] == 10 + rank, rec
            # watermark latch: stall_ns over threshold fires exactly once
            flight.check_watermarks(force=True)
            flight.check_watermarks(force=True)
            reasons = [r["reason"] for r in flight.records()]
            assert reasons.count("recv_timeout") == 1, reasons
            assert "watermark" in reasons, reasons
            paths = exp.write(os.path.join(tmp, "run"), proc=rank)
            jsonl_paths.append(paths[1])
            # the Prometheus text includes the native counters + hists
            prom = open(paths[0]).read()
            assert f'ompi_tpu_dcn_stall_ns{{proc="{rank}"' in prom, prom
            assert "ompi_tpu_op_size_bytes_bucket" in prom, prom
            tp = os.path.join(tmp, f"trace.{rank}.json")
            chrome.dump(tp, pid=rank)
            trace_paths.append(tp)
        snaps = load_jsonl(jsonl_paths)
        # flight records + finals for both procs, sorted per proc
        assert {int(s.get("proc") or 0) for s in snaps} == {0, 1}, snaps
        by_proc = finals(snaps)
        assert by_proc[0]["reason"] == "finalize", by_proc[0]
        # stall breakdown attributes ring vs cts vs other
        bd = dict((l, ns) for l, ns, _ in
                  stall_breakdown(by_proc[0]["native"]))
        assert bd["ring backpressure"] == 6_500_000, bd
        assert bd["rendezvous CTS wait"] == 800_000, bd
        buf = io.StringIO()
        render_native(by_proc, out=buf)
        render_ops(by_proc, out=buf)
        render_flight(snaps, out=buf)
        text = buf.getvalue()
        assert "stall-cause breakdown" in text, text
        assert "dcn_p2p_send" in text, text
        assert "recv_timeout" in text, text
        # correlation: every snapshot window finds the spans recorded
        # just before it (shared wall-clock base)
        spans = load_trace_spans(trace_paths)
        buf2 = io.StringIO()
        joined = correlate(snaps, spans, out=buf2)
        assert joined >= 2, (joined, buf2.getvalue())
        assert "dcn/send" in buf2.getvalue(), buf2.getvalue()
        print(f"selftest OK: 2 ranks, {len(snaps)} snapshots, "
              f"{joined} correlated windows")
        return 0
    finally:
        core.reset()
        core.enable(was_enabled)
        trace.reset()
        trace.enable(False)
        flight.configure(output="")
        flight.set_proc(0)
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ompi_tpu_torch metrics-report",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("snapshots", nargs="*",
                    help="per-rank metrics .jsonl exports")
    ap.add_argument("--correlate", nargs="+", metavar="TRACE",
                    help="Chrome trace files to join by timestamp")
    ap.add_argument("--top", type=int, default=5,
                    help="slowest spans listed per correlated window")
    ap.add_argument("--no-clock-align", action="store_true",
                    help="correlate on raw wall clocks (skip the "
                    "handshake clock-offset correction)")
    ap.add_argument("--selftest", action="store_true",
                    help="run the built-in self-check and exit")
    ns = ap.parse_args(argv)
    if ns.selftest:
        return selftest()
    if not ns.snapshots:
        ap.error("no snapshot files given (or use --selftest)")
    snaps = load_jsonl(ns.snapshots)
    by_proc = finals(snaps)
    render_native(by_proc)
    render_ops(by_proc)
    render_straggler(by_proc)
    render_flight(snaps)
    if ns.correlate:
        print("\ntrace correlation:")
        from ompi_tpu_torch.trace import merge as _merge

        offsets = (None if ns.no_clock_align
                   else _merge.offsets_from_snapshots(snaps) or None)
        if offsets:
            print("clock-aligned via handshake offsets (µs): "
                  + ", ".join(f"{p}={o:+.1f}"
                              for p, o in sorted(offsets.items())))
        spans = load_trace_spans(ns.correlate)
        correlate(snaps, spans, top=ns.top, offsets_us=offsets)
    return 0


if __name__ == "__main__":
    sys.exit(main())

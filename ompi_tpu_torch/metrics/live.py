"""Live telemetry plane — mid-job observability, cluster-wide.

Port of ``ompi_tpu/metrics/live.py``, with the reference's frame wire,
endpoints and names, so frames of either package fold into either
aggregator.  The finalize exports (trace, metrics) cannot inspect a
wedged or slow job; this module makes the telemetry observable *while
the job runs*:

* every process runs a :class:`TelemetryPublisher` thread that, each
  ``telemetry_interval_ms``, snapshots its counters (the native
  ``dcn_*`` counters and the device plane's ``device_*`` counters via
  the provider merge of :mod:`~ompi_tpu_torch.metrics.core`, per-op
  aggregates, straggler and causal records, clock offsets, detector
  health, blocked-state snapshots) and ships ONE small JSON frame to
  the launcher over a dedicated control socket — never the DCN
  transports, so frames are exempt from fault injection and cannot
  perturb the data plane;
* the launcher (``python -m ompi_tpu_torch run --mca telemetry_enable
  1``, or the tpud daemon) hosts the :class:`TelemetryAggregator`: an
  ingest socket (address handed to workers via
  ``OMPI_TPU_TELEMETRY_ADDR``) plus an HTTP endpoint serving

  - ``GET /metrics``   — live Prometheus text (per-process ``dcn_*``
    and ``device_*`` counters, op call/wait totals, arrival-skew and
    straggler-score families),
  - ``GET /json``      — the latest frame per process + the cross-rank
    straggler attribution,
  - ``GET /history``   — the JSONL history ring,
  - ``GET /critical``  — the per-job causal blame tables,
  - ``GET /waitgraph`` — the cross-rank wait-for graph and its verdict;

* the aggregator joins each collective's per-process arrival records by
  their ``(comm, op, seq)`` key (clock-offset aligned) into the live
  straggler attribution.

Everything is stdlib-only and gated by ``--mca telemetry_enable 1``;
with the flag off no socket is opened, no thread started, no frame
sent.
"""

from __future__ import annotations

import collections
import json
import socket
import struct
import threading
import time
from typing import Any

from ompi_tpu_torch.metrics import straggler as _straggler

#: env var carrying the aggregator's ingest address to the workers
ENV_TELEMETRY = "OMPI_TPU_TELEMETRY_ADDR"

#: frame wire format: length-prefixed JSON (the KVS convention)
_LEN = struct.Struct("!I")

#: EWMA weight for the rolling straggler score (per joined instance)
_EWMA = 0.2

#: joined-instance staging bound: keys waiting for every rank's record
_PENDING_CAP = 4096

PREFIX = "ompi_tpu"


def _send_frame(sock: socket.socket, obj: Any) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("telemetry peer closed")
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> Any:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return json.loads(_recv_exact(sock, n).decode())


# -- aggregator (lives in the tpurun process) ---------------------------


class TelemetryAggregator:
    """Frame sink + live scrape endpoint + straggler attribution."""

    def __init__(self, http_port: int = 0, history: int = 256,
                 host: str = "127.0.0.1"):
        self._lock = threading.Lock()
        self._running = True
        #: host-process extension (the tpud daemon): a callable whose
        #: dict is merged into /json state — how daemon liveness and
        #: journal depth reach a /json reader without a second endpoint
        self.extra_state = None
        #: host-process counter extension (the tpud daemon's serving
        #: counters — jobs_shed, jobs_concurrent_hwm, …): a callable
        #: returning NATIVE_COUNTERS-named totals owned by the HOST
        #: process rather than any rank, rendered on /metrics as
        #: ``proc="daemon"`` samples of the same families
        self.extra_counters = None
        #: extension routes (the tpud ops surface mounts here):
        #: (method, path) → callable(body_bytes) -> (status, ctype, body)
        self._routes: dict[tuple[str, str], Any] = {}
        #: job scoping (serve plane): per-proc counter baselines keyed
        #: by the job each proc is currently serving, so a second job's
        #: scrape starts from zero instead of the first job's totals;
        #: per-job frame bookkeeping feeds /jobs
        self._job_baseline: dict[int, dict[str, int]] = {}
        self._job_of: dict[int, str] = {}
        self._jobs_seen: dict[str, dict] = {}
        #: latest frame per proc (the scrape source)
        self._latest: dict[int, dict] = {}
        #: JSONL history ring of every ingested frame
        self._history: collections.deque = collections.deque(
            maxlen=max(1, int(history)))
        self.frames = 0
        #: straggler state: key → {proc: arrive_ns}, insertion-bounded
        self._pending: dict[str, dict[int, int]] = {}
        self._pending_order: collections.deque = collections.deque()
        self._pending_dropped = 0
        #: per-proc rolling attribution
        self._scores: dict[int, dict] = {}
        #: per-proc activity watermark: (native-counter total, ts_ns of
        #: the last frame that CHANGED it) — the RUNNING/IDLE half of
        #: the per-rank state brief (BLOCKED comes from ``waits``)
        self._act: dict[int, tuple[int, int]] = {}
        #: per-op cross-rank skew totals
        self._op_skew: dict[str, dict] = {}
        #: causal-tracing join (trace/causal.py): staged per-rank
        #: causal records awaiting every rank, the rolling per-job
        #: blame state (/critical), and the top-N slowest solved
        #: collectives.  Jobs key the tables ('' = plain tpurun) so a
        #: tpud daemon serves per-job blame.
        self._c_pending: dict[tuple, dict[int, list]] = {}
        self._c_order: collections.deque = collections.deque()
        self._c_dropped = 0
        self._critical: dict[str, dict] = {}
        #: clock offsets onto rank 0's timeline (peer_clock −
        #: rank0_clock, ns).  Rank-0-measured samples win; a peer's own
        #: measurement of rank 0 (sign-flipped) fills the gap when rank
        #: 0 never dialed that peer — handshake samples are recorded on
        #: the dialing side only, so either side may hold the pair's
        #: sample
        self._offsets: dict[int, int] = {}
        self._offsets_direct: set[int] = set()
        self._nprocs = 0
        #: relay plane: batched frames received + the group indices
        #: whose relays have reported (the np≥16 fan-in signature)
        self.batches = 0
        self._relays: set[int] = set()
        # ingest socket (workers dial it; address via ENV_TELEMETRY)
        self._ingest = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._ingest.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._ingest.bind((host, 0))
        self._ingest.listen(64)
        self.ingest_address = "%s:%d" % self._ingest.getsockname()
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="telemetry-ingest").start()
        # HTTP scrape endpoint
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        agg = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # scrapes must not spam stdio
                pass

            def _reply(self, status: int, ctype: str, body: bytes,
                       headers: dict | None = None):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(body)

            def _route(self, method: str, body: bytes) -> bool:
                """Extension routes (the tpud ops surface) — matched on
                the path component, longest prefix first, so a daemon
                can override a built-in endpoint (e.g. /jobs)."""
                path = self.path.split("?", 1)[0]
                hits = [(p, fn) for (m, p), fn in agg._routes.items()
                        if m == method
                        and (path == p or path.startswith(p + "/"))]
                if not hits:
                    return False
                _, fn = max(hits, key=lambda h: len(h[0]))
                hdrs: dict | None = None
                after = None
                try:
                    resp = fn(path, body)
                    if len(resp) == 5:  # (status, ctype, body, headers, after)
                        status, ctype, out, hdrs, after = resp
                    elif len(resp) == 4:  # (status, ctype, body, headers)
                        status, ctype, out, hdrs = resp
                    else:
                        status, ctype, out = resp
                except Exception as e:  # noqa: BLE001 — ops must answer
                    status, ctype = 500, "application/json"
                    out = json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode()
                try:
                    self._reply(status, ctype, out, hdrs)
                    self.wfile.flush()
                finally:
                    if after is not None:
                        after()
                return True

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                if not self._route("POST", body):
                    self.send_error(404)

            def do_GET(self):
                if self._route("GET", b""):
                    return
                if self.path.startswith("/metrics"):
                    body = agg.prometheus_text().encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path.startswith("/json"):
                    body = json.dumps(agg.json_state()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/critical"):
                    body = json.dumps(agg.critical_state()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/jobs"):
                    body = json.dumps(agg.jobs_state()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/waitgraph"):
                    body = json.dumps(agg.waitgraph_state()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/history"):
                    with agg._lock:
                        rows = list(agg._history)
                    body = ("\n".join(json.dumps(r) for r in rows)
                            + "\n").encode()
                    ctype = "application/jsonl"
                else:
                    self.send_error(404)
                    return
                self._reply(200, ctype, body)

        self._http = ThreadingHTTPServer((host, int(http_port)), Handler)
        self._http.daemon_threads = True
        self.http_port = self._http.server_address[1]
        self.url = f"http://{host}:{self.http_port}"
        threading.Thread(target=self._http.serve_forever, daemon=True,
                         name="telemetry-http").start()

    # -- extension surface (the tpud ops endpoints mount here) ----------

    def add_route(self, method: str, path: str, fn) -> None:
        """Mount ``fn(path, body_bytes) -> (status, ctype, body_bytes)``
        — or the 4-tuple form with a trailing ``headers`` dict (how the
        admission controller's 429 carries a real ``Retry-After``), or
        the 5-tuple form with a trailing ``after()`` the handler calls
        once the reply is written, or failed to be (how the daemon's
        ``/submit`` keeps a job from its scheduler until the client has
        its reply) — at ``(method, path)``; extension routes win over the
        built-in endpoints, so a daemon can serve a richer ``/jobs``."""
        self._routes[(method.upper(), path)] = fn

    # -- job scoping (serve plane) --------------------------------------

    def begin_job(self, job_id: str, procs=None) -> None:
        """Start a job scope on ``procs`` (default: every known proc):
        snapshot the procs' current native counters as the job's
        baseline — the native counters are grow-only per PROCESS, so
        without this a second job's scrape reads the first job's
        totals — and reset the rolling straggler attribution IN PLACE
        (keys survive zeroed, the spc.py reset contract), since
        arrival-skew history from a finished job says nothing about
        the next one's stragglers."""
        with self._lock:
            targets = (set(int(p) for p in procs) if procs is not None
                       else set(self._latest) | set(range(self._nprocs)))
            for p in targets:
                f = self._latest.get(p) or {}
                self._job_baseline[p] = {
                    k: int(v) for k, v in (f.get("native") or {}).items()}
                self._job_of[p] = str(job_id)
            self._jobs_seen.setdefault(
                str(job_id),
                {"frames": 0, "procs": sorted(targets),
                 "first_ts_ns": time.time_ns()})
            # reset-in-place: zero every rolling value, keep every key
            for st in self._op_skew.values():
                st["n"] = 0
                st["skew_ns"] = 0
                st["max_skew_ns"] = 0
                for k in st["slowest"]:
                    st["slowest"][k] = 0
            for sc in self._scores.values():
                sc["ewma_ns"] = 0.0
                sc["slowest"] = 0
                sc["n"] = 0
                sc["skew_ns"] = 0
            self._pending.clear()
            self._pending_order.clear()
            # causal join: a new job's blame starts clean (the per-job
            # keyed tables keep finished jobs' results for /critical)
            self._c_pending.clear()
            self._c_order.clear()

    def jobs_state(self) -> dict:
        """The /jobs feed: every job id seen in frames or begun
        explicitly, with frame counts and the procs currently scoped
        to it."""
        with self._lock:
            return {
                "jobs": {j: dict(st) for j, st in self._jobs_seen.items()},
                "current": {str(p): j for p, j in self._job_of.items()},
            }

    # -- ingest ---------------------------------------------------------

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._ingest.accept()
            except OSError:
                return
            threading.Thread(target=self._conn_loop, args=(conn,),
                             daemon=True).start()

    def _conn_loop(self, conn: socket.socket) -> None:
        try:
            while self._running:
                self.ingest(_recv_frame(conn))
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def ingest(self, frame: dict) -> None:
        """Fold one rank frame in (also the selftest entry point).
        A relay's batched frame unwraps here: the group relays are
        transparent to everything downstream of ingest."""
        if "batch" in frame:
            with self._lock:
                self.batches += 1
                if "relay" in frame:
                    self._relays.add(int(frame["relay"]))
            for f in frame.get("batch") or ():
                self.ingest(f)
            return
        proc = int(frame.get("proc", 0))
        with self._lock:
            self.frames += 1
            self._latest[proc] = frame
            self._history.append(frame)
            tot = sum(int(v) for v in (frame.get("native") or {}).values())
            prev = self._act.get(proc)
            if prev is None or tot != prev[0]:
                self._act[proc] = (tot, int(frame.get("ts_ns", 0)))
            job = frame.get("job")
            if job is not None:
                st = self._jobs_seen.setdefault(
                    str(job), {"frames": 0, "procs": [],
                               "first_ts_ns": time.time_ns()})
                st["frames"] += 1
                st["last_ts_ns"] = int(frame.get("ts_ns", 0))
                if proc not in st["procs"]:
                    st["procs"] = sorted(set(st["procs"]) | {proc})
            self._nprocs = max(self._nprocs,
                               int(frame.get("nprocs", 0)), proc + 1)
            for k, v in (frame.get("clock") or {}).items():
                peer = int(k)
                off = int(v[0] if isinstance(v, (list, tuple)) else v)
                if proc == 0:
                    self._offsets[peer] = off
                    self._offsets_direct.add(peer)
                elif peer == 0 and proc not in self._offsets_direct:
                    # proc measured rank 0: rank0 − proc; flip the
                    # sign to get proc's offset on rank 0's timeline
                    self._offsets[proc] = -off
            ready = self._stage_colls(proc, frame.get("colls") or ())
            cready = self._stage_causal(proc, frame.get("causal") or (),
                                        str(frame.get("job") or ""))
        for key, arrivals in ready:
            self._attribute(key, arrivals)
        for job, rows_by_proc in cready:
            self._solve_causal(job, rows_by_proc)

    def _stage_colls(self, proc: int, rows) -> list[tuple[str, dict]]:
        """Under the lock: stage arrival records, pop the keys now held
        by every rank (returned for attribution outside the lock).
        Arrivals are staged RAW and clock-corrected only when the
        instance completes — offsets learned after a record was staged
        (the bootstrap window before the offset-bearing frame lands)
        still apply to it."""
        ready = []
        for row in rows:
            key, a = str(row[0]), int(row[1])
            st = self._pending.get(key)
            if st is None:
                st = self._pending[key] = {}
                self._pending_order.append(key)
                while len(self._pending_order) > _PENDING_CAP:
                    old = self._pending_order.popleft()
                    if self._pending.pop(old, None) is not None:
                        self._pending_dropped += 1
            st[proc] = a
            if self._nprocs and len(st) >= self._nprocs:
                self._pending.pop(key, None)
                ready.append((key, {p: t - self._offsets.get(p, 0)
                                    for p, t in st.items()}))
        return ready

    #: solved-collective ring bound per job (/critical top-N source)
    _CRIT_TOP = 16

    def _stage_causal(self, proc: int, rows,
                      job: str) -> list[tuple[str, dict[int, list]]]:
        """Under the lock: stage per-rank causal records, pop the
        instances now held by every rank (solved outside the lock).
        Same bounded-pending discipline as the straggler join."""
        ready: list[tuple[str, dict[int, list]]] = []
        for row in rows:
            key = (job, str(row[0]))
            st = self._c_pending.get(key)
            if st is None:
                st = self._c_pending[key] = {}
                self._c_order.append(key)
                while len(self._c_order) > _PENDING_CAP:
                    old = self._c_order.popleft()
                    if self._c_pending.pop(old, None) is not None:
                        self._c_dropped += 1
            st[proc] = row
            if self._nprocs and len(st) >= self._nprocs:
                self._c_pending.pop(key, None)
                ready.append((job, dict(st)))
        return ready

    def _solve_causal(self, job: str,
                      rows_by_proc: dict[int, list]) -> None:
        """One fully-joined causal instance → critical path → the
        rolling per-job blame tables behind ``/critical``."""
        from ompi_tpu_torch.trace import causal as _causal

        with self._lock:
            offsets = dict(self._offsets)
        insts = _causal.instances_from_records(
            {p: [row] for p, row in rows_by_proc.items()},
            offsets_ns=offsets)
        if not insts:
            return
        cp = _causal.critical_path(next(iter(insts.values())))
        if cp is None:
            return
        with self._lock:
            st = self._critical.setdefault(
                job, {"instances": 0, "per_rank": {}, "profile": {},
                      "top": []})
            st["instances"] += 1
            for r, buckets in cp["per_rank"].items():
                agg = st["per_rank"].setdefault(int(r), {})
                for c, ns in buckets.items():
                    agg[c] = agg.get(c, 0) + int(ns)
            pkey = f"{cp['op']}/{cp['alg'] or '?'}"
            prof = st["profile"].setdefault(
                pkey, {"n": 0, "makespan_ns": 0, "causes": {}})
            prof["n"] += 1
            prof["makespan_ns"] += cp["makespan_ns"]
            for buckets in cp["per_rank"].values():
                for c, ns in buckets.items():
                    prof["causes"][c] = prof["causes"].get(c, 0) + int(ns)
            top = st["top"]
            top.append({"key": cp["key"], "op": cp["op"],
                        "alg": cp["alg"],
                        "makespan_ns": cp["makespan_ns"],
                        "dominant": cp["dominant"], "path": cp["path"]})
            top.sort(key=lambda e: -e["makespan_ns"])
            del top[self._CRIT_TOP:]

    @staticmethod
    def _merge_blame(job_states) -> tuple[int, dict[int, dict]]:
        """Cross-job merge of per-rank blame buckets — ONE accumulator
        shared by /critical and the /json brief, so the two surfaces
        can never disagree on merge semantics."""
        merged: dict[int, dict] = {}
        total = 0
        for st in job_states:
            total += st["instances"]
            for r, b in st["per_rank"].items():
                agg = merged.setdefault(int(r), {})
                for c, ns in b.items():
                    agg[c] = agg.get(c, 0) + int(ns)
        return total, merged

    def latest_frames(self) -> dict[int, dict]:
        """Snapshot of the newest frame per proc — the daemon's
        admission controller reads cumulative stall counters from it
        once per monitor tick."""
        with self._lock:
            return {p: f for p, f in self._latest.items()}

    def critical_state(self) -> dict:
        """The ``/critical`` feed: per-job blame tables (slowest
        collectives with their critical paths, per-rank cause totals,
        per-algorithm profiles) plus a cross-job merge for the plain
        single-job case."""
        from ompi_tpu_torch.trace import causal as _causal

        with self._lock:
            jobs = {
                j: {"instances": st["instances"],
                    "per_rank": {str(r): dict(b)
                                 for r, b in st["per_rank"].items()},
                    "profile": {k: {"n": p["n"],
                                    "makespan_ns": p["makespan_ns"],
                                    "causes": dict(p["causes"])}
                                for k, p in st["profile"].items()},
                    "top": [dict(e) for e in st["top"]],
                    "dominant": _causal.dominant_of(st["per_rank"])}
                for j, st in self._critical.items()
            }
            pending = len(self._c_pending)
            dropped = self._c_dropped
        total, merged = self._merge_blame(jobs.values())
        return {
            "instances": total,
            "per_rank": {str(r): b for r, b in merged.items()},
            "dominant": _causal.dominant_of(merged),
            "jobs": jobs,
            "pending": pending,
            "dropped": dropped,
        }

    # -- hang diagnosis (trace/waitgraph.py solver over live frames) ----

    def waitgraph_state(self) -> dict:
        """The ``GET /waitgraph`` feed: cross-rank wait-for graph +
        hang classification assembled from the latest per-rank
        blocked-state snapshots (the frames' ``waits`` field), plus
        the per-rank state brief."""
        from ompi_tpu_torch.trace import waitgraph as _waitgraph

        with self._lock:
            latest = {p: f for p, f in self._latest.items()}
            nprocs = self._nprocs
            states = self._rank_states(latest)
        failed: set[int] = set()
        for f in latest.values():
            failed.update(int(x) for x in (f.get("failed") or ()))
        snaps = {p: f["waits"] for p, f in latest.items()
                 if f.get("waits")}
        graph = _waitgraph.build_graph(snaps, failed=sorted(failed))
        return {
            "nprocs": nprocs,
            "reporting": sorted(snaps),
            "states": states,
            "graph": graph,
            "verdict": _waitgraph.classify(graph),
        }

    def _rank_states(self, latest: dict[int, dict]) -> dict[str, str]:
        """Under the lock: per-rank RUNNING / BLOCKED:site→peer / IDLE.
        A frame carrying a blocked-state snapshot is BLOCKED on its
        oldest wait; otherwise the activity watermark decides — native
        counters that moved in the newest frame mean RUNNING, a frame
        that changed nothing means IDLE."""
        from ompi_tpu_torch.trace import waitgraph as _waitgraph

        states: dict[str, str] = {}
        for p, f in latest.items():
            waits = (f.get("waits") or {}).get("waits")
            if waits:
                states[str(p)] = "BLOCKED:" + _waitgraph.wait_brief(waits)
                continue
            _tot, ts = self._act.get(p, (0, 0))
            states[str(p)] = ("RUNNING"
                              if ts and ts == int(f.get("ts_ns", 0))
                              else "IDLE")
        return states

    def _attribute(self, key: str, arrivals: dict[int, int]) -> None:
        """One fully-joined collective instance → the rolling tables."""
        slowest, skews = _straggler.instance_skew(arrivals)
        op = key.split("/")[-2] if key.count("/") >= 2 else key
        with self._lock:
            ost = self._op_skew.setdefault(
                op, {"n": 0, "skew_ns": 0, "max_skew_ns": 0,
                     "slowest": {}})
            ost["n"] += 1
            worst = skews[slowest]
            ost["skew_ns"] += worst
            if worst > ost["max_skew_ns"]:
                ost["max_skew_ns"] = worst
            ost["slowest"][slowest] = ost["slowest"].get(slowest, 0) + 1
            for p, s in skews.items():
                sc = self._scores.setdefault(
                    p, {"ewma_ns": 0.0, "slowest": 0, "n": 0,
                        "skew_ns": 0})
                sc["ewma_ns"] += _EWMA * (s - sc["ewma_ns"])
                sc["skew_ns"] += s
                sc["n"] += 1
                if p == slowest:
                    sc["slowest"] += 1

    # -- render ---------------------------------------------------------

    def json_state(self) -> dict:
        extra = {}
        fn = self.extra_state
        if fn is not None:
            try:
                extra = dict(fn())
            except Exception:  # noqa: BLE001 — scrapes must answer
                extra = {}
        with self._lock:
            return {
                **extra,
                "frames": self.frames,
                "nprocs": self._nprocs,
                "procs": {str(p): f for p, f in self._latest.items()},
                "straggler": {
                    "per_proc": {str(p): dict(s, ewma_ns=int(s["ewma_ns"]))
                                 for p, s in self._scores.items()},
                    "per_op": {op: dict(
                        st, slowest={str(p): c
                                     for p, c in st["slowest"].items()})
                        for op, st in self._op_skew.items()},
                    "pending": len(self._pending),
                    "dropped": self._pending_dropped,
                },
                "clock_offsets_ns": {str(p): o
                                     for p, o in self._offsets.items()},
                "relays": {"batches": self.batches,
                           "groups": sorted(self._relays)},
                "critical": self._critical_brief(),
                "waitgraph": self._rank_states(self._latest),
            }

    def _critical_brief(self) -> dict:
        """Under the lock: the /json-sized causal summary — per-rank
        dominant blame cause + on-path totals (the /json blame
        column feed; /critical serves the full paths)."""
        from ompi_tpu_torch.trace import causal as _causal

        total, merged = self._merge_blame(self._critical.values())
        per_rank = {}
        for r, b in merged.items():
            dom = _causal.dominant_of({r: b})
            per_rank[str(r)] = {"cause": dom["cause"], "ns": dom["ns"],
                                "total_ns": sum(b.values())}
        return {"instances": total, "per_rank": per_rank}

    def prometheus_text(self) -> str:
        """One combined exposition: each family declared once, one
        sample per rank — the mid-job twin of the finalize `.prom`."""
        with self._lock:
            latest = {p: f for p, f in self._latest.items()}
            scores = {p: dict(s) for p, s in self._scores.items()}
            op_skew = {op: dict(st) for op, st in self._op_skew.items()}
            frames = self.frames
            baselines = {p: dict(b) for p, b in self._job_baseline.items()}
            job_of = dict(self._job_of)
        from ompi_tpu_torch.metrics import core as _core

        lines: list[str] = [
            f"# HELP {PREFIX}_telemetry_frames_total Frames ingested "
            "by the live aggregator",
            f"# TYPE {PREFIX}_telemetry_frames_total counter",
            f"{PREFIX}_telemetry_frames_total {frames}",
        ]
        # native transport counters, one family per counter — header
        # rendering + gauge classification shared with the finalize
        # exporter so live and .prom scrapes type families identically
        from ompi_tpu_torch.metrics import export as _export

        names = [k for k in _core.NATIVE_COUNTERS
                 if any((f.get("native") or {}).get(k)
                        for f in latest.values())]
        # host-process (daemon-owned) counters join the same families
        # as ``proc="daemon"`` samples — no rank ever owns them
        extra: dict[str, int] = {}
        if self.extra_counters is not None:
            try:
                extra = {k: int(v)
                         for k, v in (self.extra_counters() or {}).items()
                         if k in _core.NATIVE_COUNTERS}
            except Exception:  # noqa: BLE001 — scrape must answer
                extra = {}

        def _dcn_sample(p: int, k: str) -> tuple[str, int]:
            """(label, value) for one proc's counter: under a job scope
            (serve plane) the series carries a ``job`` label and reads
            relative to the job's begin_job baseline, so the second job
            on a warm mesh scrapes from zero; without one (plain
            tpurun) it is the raw process total, unlabeled."""
            v = int((latest[p].get("native") or {}).get(k, 0))
            job = job_of.get(p)
            if job is None:
                return f'{{proc="{p}"}}', v
            base = int(baselines.get(p, {}).get(k, 0))
            return (f'{{proc="{p}",job="{job}"}}', max(0, v - base))

        for k in names:
            _export.dcn_family(
                lines, k,
                [_dcn_sample(p, k) for p in sorted(latest)]
                + ([('{proc="daemon"}', extra[k])] if k in extra else []),
                origin="Live")
        for k in (k for k in _core.NATIVE_COUNTERS
                  if k in extra and k not in names):
            _export.dcn_family(lines, k,
                               [('{proc="daemon"}', extra[k])],
                               origin="Live")
        # per-op call/byte/wait totals from the rank-local aggregates
        for fam, field, help_ in (
            ("op_calls_total", "count", "collective calls by op"),
            ("op_wait_ns_total", "wait_ns",
             "in-collective wall time by op (arrival wait + wire)"),
        ):
            rows = []
            for p in sorted(latest):
                for op, st in (latest[p].get("straggler") or {}).items():
                    if st.get(field):
                        rows.append((p, op, int(st[field])))
            if rows:
                lines.append(f"# HELP {PREFIX}_{fam} {help_}")
                lines.append(f"# TYPE {PREFIX}_{fam} counter")
                for p, op, v in rows:
                    lines.append(
                        f'{PREFIX}_{fam}{{proc="{p}",op="{op}"}} {v}')
        # cross-rank arrival-skew attribution
        if op_skew:
            lines.append(f"# HELP {PREFIX}_coll_arrival_skew_ns_total "
                         "Cumulative worst arrival skew by op "
                         "(slowest rank's lateness per instance)")
            lines.append(f"# TYPE {PREFIX}_coll_arrival_skew_ns_total "
                         "counter")
            for op, st in sorted(op_skew.items()):
                lines.append(f'{PREFIX}_coll_arrival_skew_ns_total'
                             f'{{op="{op}"}} {int(st["skew_ns"])}')
        if scores:
            lines.append(f"# HELP {PREFIX}_straggler_score_ns Rolling "
                         "(EWMA) arrival lateness per rank")
            lines.append(f"# TYPE {PREFIX}_straggler_score_ns gauge")
            for p in sorted(scores):
                lines.append(f'{PREFIX}_straggler_score_ns{{proc="{p}"}}'
                             f' {int(scores[p]["ewma_ns"])}')
            lines.append(f"# HELP {PREFIX}_straggler_slowest_total "
                         "Instances this rank arrived last")
            lines.append(f"# TYPE {PREFIX}_straggler_slowest_total "
                         "counter")
            for p in sorted(scores):
                lines.append(
                    f'{PREFIX}_straggler_slowest_total{{proc="{p}"}} '
                    f'{int(scores[p]["slowest"])}')
        # detector health + recovery activity
        rows = [(p, len(latest[p].get("failed") or ()))
                for p in sorted(latest)]
        if any(n for _, n in rows) or rows:
            lines.append(f"# HELP {PREFIX}_detector_failed_peers Peers "
                         "this rank currently marks failed")
            lines.append(f"# TYPE {PREFIX}_detector_failed_peers gauge")
            for p, n in rows:
                lines.append(
                    f'{PREFIX}_detector_failed_peers{{proc="{p}"}} {n}')
        lines.append("")
        return "\n".join(lines)

    def close(self) -> None:
        self._running = False
        try:
            self._ingest.close()
        except OSError:
            pass
        try:
            self._http.shutdown()
            self._http.server_close()
        except OSError:
            pass


# -- group relay (np≥16 fan-in: one per detector group) ----------------


class TelemetryRelay:
    """Per-group frame concentrator: group members ship their frames
    here (same wire format as the root ingest) and a pump thread
    forwards ONE batched frame per interval upstream — the root
    aggregator's single ingest socket sees O(groups) connections and
    O(groups) frames per interval instead of O(P) of each, which is
    what kept tpud's ops surface alive past two digits of ranks.

    Hosted by the group-leader rank's process (``telemetry_relay``);
    the leader publishes the relay address on the boot KVS
    (``relay.g<i>``) and members dial it instead of the root.  A dead
    relay degrades members to dropped frames (same contract as a dead
    aggregator) — telemetry never touches the data plane."""

    def __init__(self, upstream: str, group_index: int,
                 interval_ms: int = 500, host: str = "127.0.0.1"):
        self.upstream = upstream
        self.group_index = int(group_index)
        self.interval = max(0.02, float(interval_ms) / 1000.0)
        self._buf: list[dict] = []
        self._lock = threading.Lock()
        self._up: socket.socket | None = None
        self.forwarded = 0
        self._running = True
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(64)
        self.ingest_address = "%s:%d" % self._sock.getsockname()
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="telemetry-relay").start()
        self._stop = threading.Event()
        self._pump = threading.Thread(target=self._pump_loop, daemon=True,
                                      name="telemetry-relay-pump")
        self._pump.start()

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._conn_loop, args=(conn,),
                             daemon=True).start()

    def _conn_loop(self, conn: socket.socket) -> None:
        try:
            while self._running:
                frame = _recv_frame(conn)
                with self._lock:
                    self._buf.append(frame)
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def flush(self) -> bool:
        """Forward the buffered frames as one batch (pump tick; public
        for tests).  Frames are re-buffered on upstream failure so a
        root-aggregator restart (tpud takeover + repoint) loses at
        most the in-flight batch."""
        with self._lock:
            batch, self._buf = self._buf, []
        if not batch:
            return True
        frame = {"batch": batch, "relay": self.group_index}
        try:
            if self._up is None:
                host, port = self.upstream.rsplit(":", 1)
                s = socket.create_connection((host, int(port)),
                                             timeout=2.0)
                s.settimeout(2.0)
                self._up = s
            _send_frame(self._up, frame)
            self.forwarded += len(batch)
            return True
        except (OSError, ValueError):
            if self._up is not None:
                try:
                    self._up.close()
                except OSError:
                    pass
                self._up = None
            with self._lock:
                self._buf = batch + self._buf
                # bound the park: a long root outage must not grow the
                # buffer without limit (oldest frames age out first)
                del self._buf[:-4 * 64]
            return False

    def _pump_loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.flush()
        self.flush()

    def repoint(self, upstream: str) -> None:
        """Re-aim at a restarted root aggregator (tpud takeover)."""
        self.upstream = upstream
        up, self._up = self._up, None
        if up is not None:
            try:
                up.close()
            except OSError:
                pass

    def close(self) -> None:
        self._running = False
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._pump.join(timeout=2 * self.interval + 2.0)
        if self._up is not None:
            try:
                self._up.close()
            except OSError:
                pass


# -- publisher (one per rank) ------------------------------------------

#: serve plane: the job this rank is currently running (frames carry it
#: so the aggregator can scope counters + /jobs per job); None outside
#: a served job — the frame omits the field and nothing changes
_job_label: str | None = None


def set_job(job_id: str | None) -> None:
    """Label this rank's telemetry frames with the job it is serving
    (tpud worker loop); ``None`` clears the label between jobs."""
    global _job_label
    _job_label = None if job_id is None else str(job_id)


def current_job() -> str | None:
    return _job_label


class TelemetryPublisher:
    """Per-rank frame pump: snapshot → one JSON frame → the launcher.

    Failures never propagate — a dead aggregator costs a reconnect
    attempt per interval, nothing else; the data plane is untouched.
    ``refresh``, when given, is consulted after a failed publish: it
    returns a (possibly new) ingest address — the relay-failover hook
    by which a group member whose leader relay died re-dials the
    deterministically re-elected successor's relay (the address the
    new leader re-registered under ``relay.g<i>``)."""

    def __init__(self, address: str, proc: int, nprocs: int,
                 interval_ms: int = 500, detector=None, refresh=None):
        self.address = address
        self.proc = int(proc)
        self.nprocs = int(nprocs)
        self.interval = max(0.02, float(interval_ms) / 1000.0)
        self._detector = detector
        self._refresh = refresh
        #: relay-failover observability: successful re-aims after a
        #: publish failure (the regression test's convergence signal)
        self.refreshes = 0
        #: cross-thread re-aim request (reaim()): consumed by the
        #: publisher thread itself at the next tick — another thread
        #: closing/overwriting ``_sock`` mid-send would leak a freshly
        #: dialed descriptor or kill an in-flight frame
        self._reaim_addr: str | None = None
        self._sock: socket.socket | None = None
        self.sent = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="telemetry-pub")
        self._thread.start()

    def frame(self) -> dict:
        from ompi_tpu_torch.metrics import core as _core
        from ompi_tpu_torch.metrics import flight as _flight

        f: dict[str, Any] = {
            "proc": self.proc,
            "nprocs": self.nprocs,
            "ts_ns": time.time_ns(),
            "native": _core.native_counters(),
            "straggler": _straggler.summary(),
            "colls": _straggler.drain_recent(),
        }
        if _job_label is not None:
            f["job"] = _job_label
        from ompi_tpu_torch.trace import causal as _causal

        if _causal._enabled:
            rows = _causal.drain_recent()
            if rows:
                f["causal"] = rows
        clock = _core.clock_offsets()
        if clock:
            f["clock"] = {str(p): list(v) for p, v in clock.items()}
        det = self._detector
        if det is not None:
            try:
                f["failed"] = sorted(det.failed())
            except Exception:  # noqa: BLE001 — detector mid-teardown
                pass
        recs = _flight.records()
        if recs:
            by_reason: dict[str, int] = {}
            for r in recs:
                by_reason[r.get("reason", "?")] = by_reason.get(
                    r.get("reason", "?"), 0) + 1
            f["flight"] = by_reason
        from ompi_tpu_torch.trace import waitgraph as _waitgraph

        if _waitgraph._enabled and _waitgraph.busy():
            # blocked-state snapshot: only a rank that actually holds a
            # registered wait adds the field — an idle or disabled rank
            # ships zero extra wire bytes (the /waitgraph feed)
            f["waits"] = _waitgraph.snapshot()
        return f

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.publish_once()
        # final frame so a clean finalize leaves current counters
        self.publish_once()

    def reaim(self, address: str) -> None:
        """Request a re-aim from ANOTHER thread (daemon-restart
        repoint, relay-failover promotion): the publisher thread swaps
        its own socket at the next tick — see ``_reaim_addr``."""
        self._reaim_addr = str(address)

    def publish_once(self) -> bool:
        new = self._reaim_addr
        if new is not None:
            self._reaim_addr = None
            if new != self.address:
                self.address = new
                if self._sock is not None:
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = None
        if self._try_send():
            return True
        # relay failover: a failed publish against a dead relay
        # re-reads the registration (the promoted successor overwrote
        # ``relay.g<i>``) and retries ONCE within the same tick, so
        # the handoff costs at most the frames of the detection window
        if self._refresh is not None:
            try:
                new = self._refresh()
            except Exception:  # noqa: BLE001 — pump must never die
                new = None
            if new and new != self.address:
                self.address = str(new)
                self.refreshes += 1
                return self._try_send()
        return False

    def _try_send(self) -> bool:
        try:
            if self._sock is None:
                host, port = self.address.rsplit(":", 1)
                s = socket.create_connection((host, int(port)),
                                             timeout=2.0)
                s.settimeout(2.0)
                self._sock = s
            _send_frame(self._sock, self.frame())
            self.sent += 1
            return True
        except (OSError, ValueError):
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
            return False

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2 * self.interval + 2.0)
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


_publisher: TelemetryPublisher | None = None
_relay: TelemetryRelay | None = None
#: True when THIS rank's publisher aims at its group relay (member
#: role): a daemon-restart repoint must re-aim the RELAY's upstream,
#: not bypass it
_via_relay = False


def publisher() -> TelemetryPublisher | None:
    return _publisher


def relay() -> TelemetryRelay | None:
    return _relay


def start_publisher(world, store) -> TelemetryPublisher | None:
    """api.init hook: start this rank's frame pump when ``--mca
    telemetry_enable 1`` AND the launcher advertised an ingest address
    (``tpurun`` sets ``OMPI_TPU_TELEMETRY_ADDR`` when hosting the
    aggregator).  Returns None — no socket, no thread — otherwise.

    With ``telemetry_relay`` on and more than one detector group, the
    group-leader rank additionally hosts a :class:`TelemetryRelay`
    (address published on the boot KVS as ``relay.g<i>``) and group
    members aim their pumps at it instead of the root — per-host
    batching up the tree, the PRRTE-daemon fan-in shape."""
    global _publisher, _relay, _via_relay
    import os

    if not bool(store.get("telemetry_enable", False)):
        return None
    address = os.environ.get(ENV_TELEMETRY, "")
    if not address:
        return None
    if _publisher is not None:
        _publisher.stop()
    if _relay is not None:
        _relay.close()
        _relay = None
    _via_relay = False
    pc = getattr(world, "procctx", None)
    interval = int(store.get("telemetry_interval_ms", 500) or 500)
    groups = getattr(pc, "groups", None) if pc is not None else None
    root_address = address
    refresh = None
    if (bool(store.get("telemetry_relay", False))
            and groups and len(groups) > 1):
        gi = groups.index(pc.group)
        if pc.proc == pc.group[0]:
            # leader: host the group relay, publish its address, and
            # keep the OWN pump aimed at the root (fewest hops)
            _relay = TelemetryRelay(address, gi, interval_ms=interval)
            pc.kvs.put(f"{pc.ns}relay.g{gi}", _relay.ingest_address)
        else:
            try:
                address = str(pc.kvs.get(f"{pc.ns}relay.g{gi}",
                                         timeout=10.0))
                _via_relay = True
            except (KeyError, ConnectionError, OSError):
                pass  # no relay came up: degrade to the root directly

            def _refresh_relay(_pc=pc, _gi=gi) -> str | None:
                # relay failover, member half: re-read the (possibly
                # re-registered) relay address — the successor the
                # detector promoted overwrote ``relay.g<i>`` with its
                # replacement relay's ingest socket
                try:
                    return str(_pc.kvs.get(f"{_pc.ns}relay.g{_gi}",
                                           wait=False))
                except (KeyError, ConnectionError, OSError):
                    return None

            refresh = _refresh_relay
        det = getattr(pc, "detector", None)
        if det is not None:
            # relay failover, successor half: promotion (the detector's
            # deterministic takeover rule) hosts a replacement relay
            # and re-registers it, within one heartbeat period of the
            # leader's death
            det.on_leadership(
                lambda lead, _pc=pc, _gi=gi: _promote_relay(
                    lead, _pc, _gi, root_address, interval))
    _publisher = TelemetryPublisher(
        address,
        proc=int(getattr(world, "proc", 0)),
        nprocs=int(getattr(world, "nprocs", 1)),
        interval_ms=interval,
        detector=getattr(pc, "detector", None) if pc is not None else None,
        refresh=refresh,
    )
    return _publisher


def _promote_relay(is_leader: bool, pc, gi: int, root_address: str,
                   interval_ms: int) -> None:
    """Detector leadership-transition hook (relay failover): the
    member the deterministic successor rule just promoted hosts a
    replacement :class:`TelemetryRelay`, re-registers ``relay.g<i>``
    on the boot KVS (members' pumps re-dial it through their refresh
    hook on the next failed publish), and re-aims its OWN pump at the
    root — the shape the original leader had.  Demotions are ignored:
    closing a live relay mid-handoff would drop the members that
    still point at it."""
    global _relay, _via_relay
    if not is_leader or _relay is not None:
        return
    try:
        relay = TelemetryRelay(root_address, gi, interval_ms=interval_ms)
    except OSError:
        return  # no socket: members degrade to dropped frames
    try:
        pc.kvs.put(f"{pc.ns}relay.g{gi}", relay.ingest_address)
    except (OSError, ConnectionError):
        # registration failed (KVS hiccup): don't leak the relay's
        # thread+sockets — members degrade to dropped frames
        try:
            relay.close()
        except OSError:
            pass
        return
    _relay = relay
    _via_relay = False
    pub = _publisher
    if pub is not None:
        # re-aim request, consumed by the publisher's own thread — a
        # cross-thread socket close here could kill an in-flight frame
        # or leak the descriptor the pump just dialed
        pub.reaim(root_address)


def stop_publisher() -> None:
    global _publisher, _relay, _via_relay
    if _publisher is not None:
        _publisher.stop()
        _publisher = None
    if _relay is not None:
        _relay.close()
        _relay = None
    _via_relay = False


def repoint_publisher(address: str) -> None:
    """Re-aim this rank's frame pump at a NEW aggregator (tpud restart
    re-adoption: the reborn daemon's ingest socket lives at a fresh
    port).  The publisher thread keeps running; it consumes the
    re-aim request itself at its next tick (``reaim`` — a cross-
    thread socket swap could leak a freshly dialed descriptor).  A
    group-relay leader re-aims the RELAY's upstream too; a relay
    member's pump keeps pointing at its (still-live) relay."""
    pub = _publisher
    pump_enabled = pub is not None or _relay is not None
    if not pump_enabled or not address:
        return  # telemetry off: no pump, no relay, nothing to re-aim
    if _relay is not None:
        _relay.repoint(address)
    if pub is None or _via_relay:
        return
    pub.reaim(address)

"""``tpud`` — the persistent serving daemon (≈ orted/prted).

Port of ``ompi_tpu/serve/daemon.py``.  One daemon process owns the
standing infrastructure a ``run`` job normally builds and discards per
invocation:

* the boot **KVS** (rendezvous server) — resident workers boot against
  it once and then treat it as the job stream: the daemon publishes
  numbered directives (``serve.job.<n>``), workers long-poll them and
  answer with completion records (``serve.done.<n>.<proc>``);
* the **live-telemetry aggregator** — always on; its HTTP endpoint is
  the daemon's ops surface (``/submit``, ``/jobs``, ``/job/<id>``,
  ``/drain``, ``/shutdown``, ``/scale`` mounted next to the
  ``/metrics``/``/json``/``/history``/``/critical``/``/waitgraph``
  scrape endpoints), and its queue-depth/health feeds drive admission
  and scheduling;
* N **resident rank workers** (``ompi_tpu_torch.serve.worker``) whose
  CUDA context, DCN endpoints — both planes — engine threads, and
  compiled collective state stay warm across jobs.  Each runs its
  ``--nranks`` ranks on the card, or on the CPU when the daemon was
  started with ``--cpu`` (``OMPI_TPU_DEVICE=cpu`` in their env);
* the **elastic plane, daemon-fired**: a dead worker is respawned
  under a bumped incarnation and restored by a ``repair`` directive
  (survivors run ``replace()``, the reborn rank rejoins — scale-up),
  and ``/scale`` retires ranks (scale-down) or brings retirees back
  through the same respawn+repair leg.

The daemon itself holds no tensors and never creates a CUDA context:
the port's modules it imports bring ``torch`` in, but nothing on the
daemon's path calls into ``torch.cuda``, so the card's memory belongs
to the workers.

Scheduling is **gang** FIFO with per-tenant round-robin fairness
(:mod:`~ompi_tpu_torch.serve.queue`): a job is published only when its full
rank-set is free, and never while the mesh is unhealthy (dead worker,
repair outstanding) — the telemetry plane's detector feed gating the
job stream.

**Crash safety** (``serve_pidfile`` arms it, :mod:`~ompi_tpu_torch.serve.
state` holds the substrate): the daemon takes a pidfile lock with
stale-lock takeover and journals the job stream (append-only JSONL)
so a daemon SIGKILL loses nothing durable — a restarted daemon
replays the journal (queued jobs restored, in-flight directives
re-published at their original indices; workers dedup by cursor so a
replayed directive executes exactly once) and **re-adopts** the
still-live resident workers through the warm KVS: workers that lost
their daemon park on the pidfile, re-dial the new KVS, re-publish
their modex keys, and offer ``serve.adopt.<r>`` records the daemon
acks — their mesh, DCN endpoints, and warm CIDs never went away.
Only a rank whose process actually died goes down the respawn+repair
leg.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time

from ompi_tpu_torch.boot.kvs import KVSServer
from ompi_tpu_torch.boot.proc import ENV_HOST_IDS, ENV_INCARNATION, ENV_PROC
from ompi_tpu_torch.boot.tpurun import (_final_cmd, _forward, _is_local_host,
                                        _truthy, _unlink_leftovers, worker_env)
from ompi_tpu_torch.core.var import ENV_PREFIXES, SERVING_VARS, full_var_name
from ompi_tpu_torch.faultsim import core as _fsim
from ompi_tpu_torch.metrics.live import TelemetryAggregator
from . import agent as _agent
from . import state as _state
from .queue import AdmissionController, AdmissionError, JobQueue

#: KVS key prefixes of the serve protocol (workers mirror these)
K_JOB = "serve.job."        # + <n>            → directive JSON
K_DONE = "serve.done."      # + <n>.<proc>     → completion record
K_RESUME = "serve.resume."  # + <proc>.i<inc>  → reborn worker's cursor
K_ADOPT = "serve.adopt."    # + <proc>         → worker re-adoption offer
K_ADOPTED = "serve.adopted."  # + <proc>       → daemon's adoption ack
K_START = "serve.start."    # + <proc>         → fresh worker's cursor
K_PIDFILE = "serve.pidfile."  # + <generation>  → pidfile-record beacon
#                              (agents mirror it to hosts without the
#                               daemon's filesystem — see serve/agent.py)

#: env var carrying the pidfile path to resident workers (their
#: re-attach rendezvous after a daemon crash)
ENV_SERVE_PIDFILE = "OMPI_TPU_SERVE_PIDFILE"


def serve_var(mca: dict | None, name: str):
    """Resolve one ``serve_<name>`` knob daemon-side (no MCA context in
    the launcher process, same as tpurun's telemetry gate): ``--mca``
    dict → ``OMPI_MCA_*`` env → the SERVING_VARS default."""
    full = f"serve_{name}"
    if mca and full in mca:
        return mca[full]
    for prefix in ENV_PREFIXES:
        v = os.environ.get(prefix + full)
        if v is not None:
            return v
    for fw, comp, n, default, _typ, _h in SERVING_VARS:
        if full_var_name(fw, comp, n) == full:
            return default
    raise KeyError(full)


class TpuDaemon:
    """The serving daemon.  ``spawn=False`` builds the full control
    plane (KVS, aggregator, queue, ops routes) without resident
    workers — the selftest/unit harness pumps the job stream itself."""

    def __init__(self, np_: int, mca: dict[str, str] | None = None,
                 nranks: int | None = None, cpu: bool = False,
                 max_respawns: int = 2,
                 http_port: int | None = None, spawn: bool = True,
                 hosts: list[tuple[str, int]] | None = None,
                 map_by: str = "slot",
                 launch_agent: str = "ssh {host} {cmd}",
                 kvs_host: str | None = None,
                 oversubscribe: bool = False):
        self.np = int(np_)
        self.mca = dict(mca or {})
        #: per-worker rank count (accelerator_cuda_nranks) and the CPU
        #: switch every worker — local or agent-spawned — inherits
        self.nranks = nranks
        self.cpu = bool(cpu)
        self.max_respawns = int(max_respawns)
        self._spawn_workers = spawn
        self.launch_agent = launch_agent
        # multi-host DVM (the prte shape): map ranks onto the host
        # allocation; each NON-local host gets one launch agent over
        # the rsh leg that owns its ranks' spawn/respawn/pid-liveness
        # — the daemon's `kill 0`-style probes cannot cross hosts
        self._rank_hid: list[int | None] = [None] * self.np
        self._host_names: dict[int, str] = {}
        self._host_ids_env = ""
        self._agents: dict[int, dict] = {}
        if hosts:
            from ompi_tpu_torch.boot.rmaps import map_ranks

            rank_host = map_ranks(hosts, self.np, policy=map_by,
                                  oversubscribe=oversubscribe)
            order: dict[str, int] = {}
            for hname in rank_host:
                order.setdefault(hname, len(order))
            self._host_ids_env = ",".join(
                str(order[hname]) for hname in rank_host)
            for r, hname in enumerate(rank_host):
                hid = order[hname]
                self._host_names[hid] = hname
                if not _is_local_host(hname):
                    self._rank_hid[r] = hid
            for hid, hname in sorted(self._host_names.items()):
                ranks = [r for r in range(self.np)
                         if self._rank_hid[r] == hid]
                if ranks:
                    self._agents[hid] = {
                        "name": hname, "ranks": ranks, "proc": None,
                        "session": "", "cursor": 0, "pending": {},
                        "hb": None, "spawns": 0, "status": "down",
                        "worker_pids": {}}
        self.cid_block = int(serve_var(self.mca, "cid_block"))
        self.cid_next = int(serve_var(self.mca, "cid_base"))
        self.job_timeout = float(serve_var(self.mca, "job_timeout"))
        #: softer bound than job_timeout: expiry revokes the job's comm
        #: (typed failure, gang woken) instead of killing its ranks
        self.job_deadline = float(serve_var(self.mca, "job_deadline_s"))
        self.reattach_timeout = float(
            serve_var(self.mca, "reattach_timeout"))
        self._lock = threading.RLock()
        # crash-safe control plane (serve_pidfile arms it): stale-lock
        # takeover + journal replay happen BEFORE any socket exists so
        # a refused second daemon leaves no trace
        self.pidfile = str(serve_var(self.mca, "pidfile") or "")
        self.journal_path = str(serve_var(self.mca, "journal") or "")
        if not self.journal_path and self.pidfile:
            self.journal_path = self.pidfile + ".journal"
        self.generation = 1
        self._journal: _state.Journal | None = None
        recovered: dict | None = None
        if self.pidfile:
            stale = _state.acquire_pidfile(self.pidfile)  # may raise
            if stale is not None:
                print(f"[tpud] reaped stale pidfile {self.pidfile} "
                      f"(pid {stale.get('pid')} dead)", flush=True)
            replay = _state.Journal.replay(self.journal_path)
            self.generation = max(
                replay["generation"],
                int((stale or {}).get("generation", 0))) + 1
            if replay["events"] and not replay["clean"]:
                recovered = replay
        # deterministic chaos (daemonkill): the daemon itself runs
        # under the seeded fault plane when the mca/env arm it — rank
        # workers get the same plan via OMPI_MCA_* inheritance
        if _truthy(self._opt("faultsim_enable")):
            _fsim.configure(str(self._opt("faultsim_plan") or ""),
                            seed=int(self._opt("faultsim_seed") or 0),
                            proc=-1)
        self.server = KVSServer(host=kvs_host or "127.0.0.1")
        self.aggregator = TelemetryAggregator(
            http_port=(int(serve_var(self.mca, "port"))
                       if http_port is None else int(http_port)))
        self.aggregator.extra_state = self._top_state
        self.url = self.aggregator.url
        self.queue = JobQueue(
            self.np, max_pending=int(serve_var(self.mca, "max_pending")),
            max_concurrent=int(serve_var(self.mca, "max_concurrent")),
            retry_budget=int(serve_var(self.mca, "retry_budget")),
            admission=AdmissionController(
                stall_ns=int(serve_var(self.mca, "admission_stall_ns")),
                policy=str(serve_var(self.mca, "shed_policy"))))
        #: frame timestamps the admission controller already folded —
        #: its streak must advance at telemetry cadence, not at the
        #: much faster monitor-tick cadence (see _admission_update)
        self._adm_seen: dict[int, int] = {}
        # the daemon-owned serving counters (jobs_shed, …) ride the
        # normal native-counter discipline: the in-process pvar surface
        # via a provider anchored on the queue's lifetime, and /metrics
        # via the aggregator's host-process extension (proc="daemon")
        from ompi_tpu_torch.metrics import core as _mcore

        _mcore.register_provider(
            self.queue, lambda q=self.queue: dict(q.counters))
        self.aggregator.extra_counters = self._daemon_counters
        # hang diagnosis in the DAEMON process (the pre-revoke report
        # on the deadline path + the /metrics hang_* families): same
        # launcher-process knob resolution the faultsim gate uses
        from ompi_tpu_torch.trace import waitgraph as _waitgraph

        hd = self._opt("hang_diag_enable")
        _waitgraph.sync_from_store(
            {"hang_diag_enable": True if hd == "" else _truthy(hd)})
        self._hang_timeout_s = max(0.0, float(
            self._opt("hang_snapshot_timeout_ms") or 2000) / 1000.0)
        self._mount_routes()
        #: next directive index (the job-stream cursor)
        self.cursor = 0
        #: directive index → bookkeeping ({kind, procs, job_id, done})
        self._outstanding: dict[int, dict] = {}
        #: per-proc worker state: process handle + incarnation + status
        #: in {"active", "adopting", "dead", "retired", "exited"}
        self._procs: list[subprocess.Popen | _AdoptedProc | None] = (
            [None] * self.np)
        self._incarnation = [0] * self.np
        self._status = ["active"] * self.np
        self._threads: list[threading.Thread] = []
        #: procs awaiting the repair directive (respawned, not yet
        #: restored into the world by the survivors' replace())
        self._repairing: set[int] = set()
        self._repair_published = False
        #: re-adoption window state (restart recovery)
        self._adopt_deadline = 0.0
        self._adopt_pids: dict[int, int] = {}
        self.shutting_down = False
        self._shutdown_published = False
        self.exit_code = 0
        self.logdir = (self.pidfile + ".logs") if self.pidfile else ""
        if self.pidfile:
            if self.logdir:
                try:
                    os.makedirs(self.logdir, exist_ok=True)
                except OSError:
                    self.logdir = ""
            record = {
                "pid": os.getpid(), "generation": self.generation,
                "np": self.np, "kvs": self.server.address,
                "url": self.url,
                "ingest": self.aggregator.ingest_address,
                "logs": self.logdir,
                "ts_ns": time.time_ns()}
            _state.write_pidfile(self.pidfile, record)
            # real-remote re-attach channel: mirror the pidfile record
            # as a KVS beacon — launch agents copy it to THEIR host's
            # pidfile path, so workers on hosts that share no
            # filesystem with the daemon still find a restarted daemon
            # through the ordinary pidfile poll
            self.server.put_local(f"{K_PIDFILE}{self.generation}",
                                  record)
            if recovered is not None:
                # journal compaction: takeover
                # rewrites the journal to the live-state fixed point
                # BEFORE appending, so repeated SIGKILL→restart cycles
                # stop growing it without bound
                _state.Journal.compact(self.journal_path, recovered)
            # rotation bounds (the crash-free twin of takeover
            # compaction): a month-resident daemon's journal compacts
            # in place once it crosses the size/age knobs
            self._journal = _state.Journal(
                self.journal_path,
                max_bytes=int(self._agent_var(
                    "journal_max_kb", 0)) * 1024,
                max_age_s=float(self._agent_var(
                    "journal_max_age_s", 0.0)))
        if recovered is not None:
            self._recover(recovered)
        elif spawn:
            for hid in sorted(self._agents):
                self._boot_agent(hid)
            for rank in range(self.np):
                self._procs[rank] = self._spawn(rank)

    def _opt(self, name: str, default: str = "") -> str:
        """Resolve a NON-serve var daemon-side (``--mca`` dict → env →
        default) — the faultsim knobs ride the same launcher-process
        resolution serve_var gives the serve_* set."""
        if name in self.mca:
            return str(self.mca[name])
        for prefix in ENV_PREFIXES:
            v = os.environ.get(prefix + name)
            if v is not None:
                return v
        return default

    def _journal_ev(self, ev: str, **fields) -> None:
        if self._journal is not None:
            self._journal.append(ev, **fields)

    # -- restart recovery (journal replay + worker re-adoption) ---------

    def _recover(self, replay: dict) -> None:
        """Rebuild the control plane a SIGKILLed predecessor dropped:
        restore the queue (queued jobs re-admitted, running jobs
        re-entered), the stream cursor and CID high-water mark,
        re-publish every outstanding directive at its ORIGINAL index
        into the fresh KVS (consumers dedup by cursor — a directive a
        worker already executed is skipped, one it never saw runs:
        exactly once either way), seed the boot fences the old server
        took with it, and open the re-adoption window for the still-
        live resident workers."""
        self._journal_ev("takeover", generation=self.generation,
                         recovered_events=replay["events"])
        # running jobs from the journal lack nothing — the published
        # directive carries procs/cid; merge directive fields over the
        # submit record so queue bookkeeping matches pre-crash state
        by_id = {d.get("id"): d for d in replay["outstanding"].values()
                 if d.get("kind", "job") == "job"}
        running = [dict(job, **{k: by_id[job["id"]][k]
                                for k in ("procs", "cid_base", "cid_span")
                                if k in by_id[job["id"]]})
                   for job in replay["running"] if job["id"] in by_id]
        self.queue.restore(queued=replay["queued"], running=running,
                           done=replay["done"])
        self.cursor = int(replay["cursor"])
        if replay["cid_next"] is not None:
            self.cid_next = max(self.cid_next, int(replay["cid_next"]))
        # the WHOLE stream is re-created at its original indices — NOT
        # via _publish (the cursor must not advance; nothing may be
        # re-journaled or re-counted by the fault plane).  Finished
        # directives are re-published too: workers consume strictly in
        # order, so a hole below a finished index would wedge any
        # worker whose cursor is still beneath it — and re-publication
        # cannot double-execute (a finished directive's whole gang
        # reported, so their cursors are past it; everyone else skips
        # non-member directives by construction)
        for idx in sorted(replay["published"]):
            d = replay["published"][idx]
            if idx in replay["outstanding"]:
                self._outstanding[idx] = {
                    "kind": d.get("kind", "job"),
                    "procs": list(d.get("procs") or range(self.np)),
                    "job_id": d.get("id"), "done": {},
                    "ts": time.monotonic(),
                }
            self.server.put_local(f"{K_JOB}{idx}", d)
        # the boot-time fences died with the old KVS; a future
        # respawned rank still replays them idempotently
        self.server.seed_fence("modex", range(self.np))
        self._adopt_pids = {r: int(st.get("pid", 0))
                            for r, st in replay["pids"].items()}
        for r, st in replay["pids"].items():
            if 0 <= int(r) < self.np:
                self._incarnation[int(r)] = int(st.get("incarnation", 0))
        # multi-host: the journal's host placement tells the restarted
        # daemon which agents to await — each parks on the pidfile
        # like a worker and offers serve.agent.adopt.<hid>; one that
        # never re-attaches (it died with the daemon) is respawned
        # over rsh with the journaled worker-pid table, so ITS reborn
        # agent re-adopts the still-live workers
        for hid, ag in self._agents.items():
            ag["status"] = "adopting"
            ag["hb_mono"] = time.monotonic()
            for r, st in replay["pids"].items():
                if (0 <= int(r) < self.np
                        and self._rank_hid[int(r)] == hid
                        and int(st.get("pid", 0))):
                    ag["worker_pids"][int(r)] = (
                        int(st["pid"]), int(st.get("incarnation", 0)))
        # crash-mid-repair replay: a rank the
        # predecessor respawned whose repair never FINISHED re-enters
        # the repairing set — once adoption resolves the mesh view,
        # the repair directive publishes (or a dead reborn goes down
        # the respawn leg, which re-arms it); an outstanding repair
        # directive also needs its reborn-cursor beacons re-seeded
        # (they died with the old KVS)
        for r in (replay.get("repairing") or {}):
            if 0 <= int(r) < self.np:
                self._repairing.add(int(r))
        for idx, d in replay["outstanding"].items():
            if d.get("kind") == "repair":
                self._repair_published = True
                for r in d.get("dead", ()):
                    self.server.put_local(
                        f"{K_RESUME}{int(r)}.i{self._incarnation[int(r)]}",
                        int(idx) + 1)
        self._status = ["adopting"] * self.np
        for r in replay["retired"]:
            # an operator's /scale-down outlives the crash: a retired
            # rank's dead pid is NOT a crashed worker to respawn
            if 0 <= int(r) < self.np:
                self._status[int(r)] = "retired"
                self._adopt_pids.pop(int(r), None)
        if replay["draining"]:
            self.queue.draining = True  # the drain outlives the crash
        self._adopt_deadline = time.monotonic() + self.reattach_timeout
        print(f"[tpud] restart recovery (generation {self.generation}): "
              f"{len(replay['outstanding'])} in-flight directive(s) "
              f"re-published, {len(replay['queued'])} queued job(s) "
              f"restored, awaiting re-adoption of {self.np} worker(s)",
              flush=True)

    def _poll_adoption(self) -> None:
        """One monitor-tick look at the re-adoption window: a live
        worker that found the new pidfile publishes ``serve.adopt.<r>``
        — verify its pid, take it over (no Popen handle: an
        :class:`_AdoptedProc` wraps the pid), and ack so the worker
        resumes its stream.  A rank whose last known pid is dead is
        respawned once every live rank has re-attached (the reborn
        boot needs the survivors' re-published modex keys)."""
        with self._lock:
            pending = [r for r in range(self.np)
                       if self._status[r] == "adopting"]
            if not pending:
                return
            for r in pending:
                offer = self.server.peek(f"{K_ADOPT}{r}")
                # a remote rank's offer IS its proof of life (the
                # local pid probe cannot cross hosts; the worker just
                # published under our generation)
                pid_ok = (self._rank_hid[r] is not None
                          or _state.pid_alive(int(offer.get("pid", 0)))
                          ) if offer else False
                if (offer and int(offer.get("generation", 0))
                        == self.generation and pid_ok):
                    pid = int(offer["pid"])
                    self._incarnation[r] = int(
                        offer.get("incarnation", 0))
                    if self._rank_hid[r] is not None:
                        rp = _RemoteProc(self, r, self._rank_hid[r],
                                         self._incarnation[r])
                        rp.pid = pid
                        self._procs[r] = rp
                    else:
                        self._procs[r] = _AdoptedProc(pid)
                    self._status[r] = "active"
                    self._adopt_pids.pop(r, None)
                    self.server.put_local(
                        f"{K_ADOPTED}{r}",
                        {"pid": pid, "generation": self.generation})
                    self._journal_ev(
                        "spawn", rank=r, pid=pid, adopted=True,
                        incarnation=self._incarnation[r],
                        **({"host": self._rank_hid[r]}
                           if self._rank_hid[r] is not None else {}))
                    print(f"[tpud] re-adopted rank {r} (pid {pid}, "
                          f"cursor {offer.get('cursor')})", flush=True)
            # ranks whose recorded worker died while the daemon was
            # down (or that never re-attach) go down the respawn leg —
            # but only after every live-pid rank resolved, so the
            # reborn boot finds re-published wsize/dcn keys
            live_waiting = [
                r for r in range(self.np)
                if self._status[r] == "adopting"
                and self._rank_alive(r, self._adopt_pids.get(r, 0))]
            expired = time.monotonic() > self._adopt_deadline
            if live_waiting and not expired:
                return
            still = [r for r in range(self.np)
                     if self._status[r] == "adopting"]
            if (still and not live_waiting
                    and not any(s == "active" for s in self._status)):
                # the whole mesh died with (or after) the daemon:
                # nothing warm survives to repair against — cold-boot
                # fresh workers; journal-restored queued jobs still
                # run, in-flight ones fail honestly
                print("[tpud] no resident workers survived the "
                      "restart; cold-booting the mesh", flush=True)
                for st in self._outstanding.values():
                    for r in st["procs"]:
                        st["done"].setdefault(r, {
                            "ok": False,
                            "error": "mesh lost across daemon restart"})
                # multi-host: a cold boot needs live agents with real
                # command sessions BEFORE any remote spawn publishes —
                # an agent still marked adopting never offered itself
                # (it died with the mesh), so relaunch it now
                for hid, ag in self._agents.items():
                    if ag["status"] != "active":
                        self._boot_agent(hid)
                for r in still:
                    self._adopt_pids.pop(r, None)
                    self._incarnation[r] = 0
                    self._status[r] = "active"
                    # fresh incarnation-0 workers must NOT replay the
                    # pre-crash stream (their predecessors' directives
                    # are re-published at indices 0..cursor): the
                    # start beacon skips them past it — journal-
                    # restored QUEUED jobs publish at >= cursor
                    self.server.put_local(f"{K_START}{r}", self.cursor)
                    self._procs[r] = (self._spawn(r)
                                      if self._spawn_workers else None)
                return
            for r in still:
                if self._rank_alive(r, self._adopt_pids.get(r, 0)):
                    if not expired:
                        continue
                    # window over with the pid alive: a worker wedged
                    # mid-job attaches when it next polls — keep
                    # waiting (unhealthy, visible on /jobs) rather
                    # than double-spawning the rank
                    print(f"[tpud] rank {r} (pid "
                          f"{self._adopt_pids.get(r)}) alive but not "
                          "re-attached; holding the rank", flush=True)
                    continue
                hid = self._rank_hid[r]
                if (hid is not None
                        and self._agents[hid]["status"] != "active"):
                    # a remote rank cannot respawn without its agent:
                    # publishing the command now would land in a dead
                    # or not-yet-acked session and be lost when the
                    # agent resolves — hold the rank; the agent's own
                    # adoption/respawn (_poll_agents) unblocks it
                    continue
                print(f"[tpud] rank {r} did not re-attach (worker "
                      "dead); respawning", flush=True)
                # the dead rank fails any gang it was part of, exactly
                # like a mid-job death the daemon witnessed
                for st in self._outstanding.values():
                    if r in st["procs"] and r not in st["done"]:
                        st["done"][r] = {
                            "ok": False,
                            "error": "rank died during daemon restart"}
                self._adopt_pids.pop(r, None)
                self._respawn_locked(r)

    # -- worker lifecycle ------------------------------------------------

    def _worker_mca(self) -> dict[str, str]:
        m = dict(self.mca)
        # the serving plane is built ON the observability + elastic
        # planes: frames feed the ops surface, the detector feeds
        # repair — both non-negotiable for a daemon
        m["telemetry_enable"] = "1"
        m["ft_detector_enable"] = "1"
        return m

    def _spawn(self, rank: int):
        hid = self._rank_hid[rank]
        if hid is not None:
            # remote rank: the owning host's launch agent executes the
            # spawn (the daemon shares no pid namespace with it); the
            # journal records placement now and the real pid when the
            # agent's ack arrives
            inc = self._incarnation[rank]
            self._agent_cmd(hid, {
                "kind": "spawn", "rank": rank, "incarnation": inc,
                # the CURRENT ingest address rides the command: the
                # agent's inherited env may still name a dead
                # predecessor's aggregator after a daemon restart
                "telemetry": self.aggregator.ingest_address})
            self._journal_ev("spawn", rank=rank, pid=0,
                             incarnation=inc, host=hid)
            return _RemoteProc(self, rank, hid, inc)
        extra = dict({ENV_SERVE_PIDFILE: self.pidfile}
                     if self.pidfile else {})
        if self._host_ids_env:
            extra[ENV_HOST_IDS] = self._host_ids_env
        env = worker_env(
            rank, self.np, self.server.address, mca=self._worker_mca(),
            nranks=self.nranks, cpu=self.cpu, extra_env=extra or None,
            telemetry_addr=self.aggregator.ingest_address)
        if self._incarnation[rank]:
            env[ENV_INCARNATION] = str(self._incarnation[rank])
        p = subprocess.Popen(
            [sys.executable, "-m", "ompi_tpu_torch.serve.worker"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        t = threading.Thread(
            target=_forward, args=(p.stdout, str(rank), sys.stdout.buffer),
            daemon=True)
        t.start()
        self._threads.append(t)
        self._journal_ev("spawn", rank=rank, pid=p.pid,
                         incarnation=self._incarnation[rank])
        return p

    # -- per-host launch agents (the multi-host DVM leg) ----------------

    def _agent_var(self, name: str, default: float) -> float:
        try:
            return float(serve_var(self.mca, name))
        except (KeyError, ValueError):
            return float(default)

    def _boot_agent(self, hid: int,
                    adopt: dict[int, tuple[int, int]] | None = None
                    ) -> None:
        """(Re)launch one host's agent over the rsh leg.  ``adopt``
        hands the reborn agent the last-known worker table (rank →
        (pid, incarnation)) so an agent-only death re-adopts the
        still-live workers instead of double-spawning the host."""
        ag = self._agents[hid]
        ag["session"] = f"g{self.generation}s{ag['spawns']}"
        ag["spawns"] += 1
        ag["cursor"] = 0
        # old-session indices are dead with the session: the respawn
        # caller re-issues what it captured, and a stale entry left
        # here would be re-issued AGAIN on every later respawn
        # (double-spawning a rank that is already alive)
        ag["pending"] = {}
        ag["hb"] = None
        ag["hb_mono"] = time.monotonic()
        ag["status"] = "active"
        extra = dict({ENV_SERVE_PIDFILE: self.pidfile}
                     if self.pidfile else {})
        extra[_agent.ENV_AGENT_HOST] = str(hid)
        extra[_agent.ENV_AGENT_RANKS] = ",".join(
            str(r) for r in ag["ranks"])
        extra[_agent.ENV_AGENT_SESSION] = ag["session"]
        if adopt:
            extra[_agent.ENV_AGENT_ADOPT] = ",".join(
                f"{r}:{pid}:{inc}" for r, (pid, inc) in sorted(
                    adopt.items()))
        if self._host_ids_env:
            extra[ENV_HOST_IDS] = self._host_ids_env
        env = worker_env(
            0, self.np, self.server.address, mca=self._worker_mca(),
            nranks=self.nranks, cpu=self.cpu, extra_env=extra,
            telemetry_addr=self.aggregator.ingest_address)
        env.pop(ENV_PROC, None)  # the agent is not a rank
        cmd = [sys.executable, "-m", "ompi_tpu_torch.serve.agent"]
        p = subprocess.Popen(
            _final_cmd(self.launch_agent, cmd, env, ag["name"]),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        t = threading.Thread(
            target=_forward,
            args=(p.stdout, f"h{hid}", sys.stdout.buffer), daemon=True)
        t.start()
        self._threads.append(t)
        ag["proc"] = p
        # supersession fence: the CURRENT session, visible to a
        # predecessor agent that wedged past serve_agent_timeout and
        # later un-wedges — it reads the mismatch at heartbeat cadence
        # and exits instead of executing its stale session's commands
        self.server.put_local(f"{_agent.K_ASESSION}{hid}",
                              ag["session"])
        self._journal_ev("agent", host=hid, session=ag["session"],
                         rsh_pid=p.pid)
        print(f"[tpud] launch agent h{hid} ({ag['name']}) spawned "
              f"(session {ag['session']}, ranks {ag['ranks']})",
              flush=True)

    def _agent_cmd(self, hid: int, cmd: dict) -> int:
        """Publish one command on the agent's current session stream;
        spawn commands are tracked until their ack (the real worker
        pid) arrives — an agent respawn re-issues unacked ones into
        the fresh session.  Under ``self._lock`` (re-entrant): HTTP
        handlers (/scale) and the monitor thread both publish, and an
        unlocked read-increment of the cursor could hand two commands
        the same stream index (the later put overwrites the earlier —
        a silently lost spawn/kill)."""
        with self._lock:
            ag = self._agents[hid]
            idx = ag["cursor"]
            ag["cursor"] += 1
            d = dict(cmd)
            self.server.put_local(
                f"{_agent.K_ACMD}{ag['session']}.{hid}.{idx}", d)
            if d.get("kind") in ("spawn", "adopt"):
                ag["pending"][idx] = d
            return idx

    def _agent_worker_state(self, hid: int, rank: int) -> dict | None:
        ag = self._agents.get(hid)
        hb = (ag or {}).get("hb") or {}
        return (hb.get("workers") or {}).get(str(rank))

    def _agent_kill(self, hid: int, rank: int, sig: int) -> None:
        try:
            self._agent_cmd(hid, {"kind": "kill", "rank": rank,
                                  "sig": int(sig)})
        except KeyError:
            pass

    def _rank_alive(self, rank: int, pid: int) -> bool:
        """Liveness probe that respects host placement: local ranks
        use the pid; remote ranks route through the owning agent's
        heartbeat table (``kill 0`` cannot cross hosts).  An agent
        that has not reported yet falls back to the pid probe — exact
        on the emulated-host harness (shared pid namespace), best-
        effort on real remote hosts until the heartbeat lands."""
        hid = self._rank_hid[rank]
        if hid is not None:
            st = self._agent_worker_state(hid, rank)
            if st is not None:
                return bool(st.get("alive"))
        return _state.pid_alive(pid)

    def _poll_agents(self) -> None:
        """One monitor-tick look at every launch agent: fold in fresh
        heartbeats, collect spawn acks (journal the real pid),
        re-adopt agents offering themselves to a restarted daemon, and
        respawn agents whose launch process died or whose heartbeats
        went silent — the reborn agent re-adopts still-live workers
        from the last-known pid table.  Runs under ``self._lock``
        (re-entrant) like every other mutator of the per-agent
        session/cursor/pending state — an HTTP-thread /scale racing a
        session rotation must not split a command across sessions."""
        if not self._agents:
            return
        now = time.monotonic()
        timeout = self._agent_var("agent_timeout", 10.0)
        hb_only = bool(self._agent_var("agent_hb_only", 0.0))
        with self._lock:
            self._poll_agents_locked(now, timeout, hb_only)

    def _poll_agents_locked(self, now: float, timeout: float,
                            hb_only: bool = False) -> None:
        for hid, ag in self._agents.items():
            hb = self.server.peek(f"{_agent.K_AHB}{hid}")
            if hb and hb.get("session") == ag["session"]:
                if hb is not ag["hb"]:
                    prev = ag["hb"] or {}
                    if hb.get("ts_ns") != prev.get("ts_ns"):
                        ag["hb_mono"] = now
                    ag["hb"] = hb
                for r, st in (hb.get("workers") or {}).items():
                    if int(st.get("pid", 0)):
                        ag["worker_pids"][int(r)] = (
                            int(st["pid"]), int(st.get("incarnation", 0)))
            # adoption offer from an agent that outlived a daemon crash
            offer = self.server.peek(f"{_agent.K_AADOPT}{hid}")
            if (ag["status"] == "adopting" and offer
                    and int(offer.get("generation", 0))
                    == self.generation):
                ag["session"] = f"g{self.generation}s0"
                # the adoption claims the s0 session name — a later
                # agent RESPAWN must take s1+, not collide with the
                # adopted stream's consumed indices
                ag["spawns"] = max(ag["spawns"], 1)
                ag["cursor"] = 0
                ag["pending"] = {}
                ag["status"] = "active"
                ag["proc"] = None  # not our child: liveness via hb
                ag["hb"] = {"pid": offer.get("pid"),
                            "session": ag["session"],
                            "workers": offer.get("workers") or {}}
                ag["hb_mono"] = now
                for r, st in (offer.get("workers") or {}).items():
                    if int(st.get("pid", 0)):
                        ag["worker_pids"][int(r)] = (
                            int(st["pid"]), int(st.get("incarnation", 0)))
                self.server.put_local(f"{_agent.K_ASESSION}{hid}",
                                      ag["session"])
                self.server.put_local(f"{_agent.K_AADOPTED}{hid}", {
                    "pid": offer.get("pid"),
                    "generation": self.generation,
                    "session": ag["session"]})
                self._journal_ev("agent", host=hid,
                                 session=ag["session"], adopted=True)
                print(f"[tpud] re-adopted agent h{hid} (pid "
                      f"{offer.get('pid')})", flush=True)
            # spawn/adopt acks → the real worker pid, journaled; a
            # FAILED spawn (fork error on the remote host) routes the
            # rank down the normal death leg so the bounded respawn
            # budget retries it instead of wedging it "alive" forever
            for idx in sorted(list(ag["pending"])):
                ack = self.server.peek(
                    f"{_agent.K_AACK}{ag['session']}.{hid}.{idx}")
                if ack is None:
                    continue
                d = ag["pending"].pop(idx)
                r = int(d.get("rank", -1))
                pid = int(ack.get("pid", 0))
                if r >= 0 and not ack.get("ok", True):
                    print(f"[tpud] agent h{hid} could not spawn rank "
                          f"{r}: {ack.get('error', '?')}", flush=True)
                    self._handle_death(r, 1)
                    continue
                if r >= 0 and pid:
                    ag["worker_pids"][r] = (
                        pid, int(d.get("incarnation", 0)))
                    self._journal_ev(
                        "spawn", rank=r, pid=pid, host=hid,
                        incarnation=int(d.get("incarnation", 0)))
            # a restart window that expires with no adoption offer:
            # the agent died WITH the daemon (host failure) — respawn
            # it; the reborn agent re-adopts any still-live workers
            # from the journaled pid table and reports the dead ones
            if ag["status"] == "adopting":
                if (now > self._adopt_deadline
                        and not self.shutting_down):
                    print(f"[tpud] agent h{hid} did not re-attach; "
                          "respawning it", flush=True)
                    self._boot_agent(hid,
                                     adopt=dict(ag["worker_pids"]))
                continue
            # agent death: launch process gone, or heartbeats silent
            if ag["status"] != "active":
                continue
            rsh_dead = (ag["proc"] is not None
                        and ag["proc"].poll() is not None)
            # heartbeat silence since boot/adoption/last hb — a fresh
            # agent that wedges BEFORE its first heartbeat (KVS
            # unreachable, hung boot) with the rsh transport still
            # connected must be declared dead too, not held forever
            silent = now - ag.get("hb_mono", now) > timeout
            # hb-only mode (serve_agent_hb_only): a backgrounding
            # agent template's rsh wrapper daemonizes and exits
            # immediately, so its launch process dying is normal —
            # liveness is judged by heartbeat staleness alone
            dead = silent if hb_only else (rsh_dead or silent)
            if dead and not self.shutting_down:
                if ag["spawns"] > self.max_respawns + 1:
                    print(f"[tpud] agent h{hid} died; respawn budget "
                          "exhausted — host marked down", flush=True)
                    ag["status"] = "down"
                    continue
                print(f"[tpud] agent h{hid} "
                      f"{'exited' if rsh_dead and not hb_only else 'silent'}; "
                      "respawning it (live workers will be "
                      "re-adopted)", flush=True)
                pending = [ag["pending"][i]
                           for i in sorted(ag["pending"])]
                adopt = {r: pi for r, pi in ag["worker_pids"].items()}
                self._boot_agent(hid, adopt=adopt)
                for d in pending:  # unacked work survives the respawn
                    self._agent_cmd(hid, d)

    # -- ops surface (mounted on the aggregator's HTTP endpoint) --------

    def _mount_routes(self) -> None:
        agg = self.aggregator
        agg.add_route("POST", "/submit",
                      lambda path, body: self._r_submit(path, body, on_reply=True))
        agg.add_route("GET", "/jobs", self._r_jobs)
        agg.add_route("GET", "/job", self._r_job)
        agg.add_route("POST", "/drain", self._r_drain)
        agg.add_route("POST", "/shutdown", self._r_shutdown)
        agg.add_route("POST", "/scale", self._r_scale)

    @staticmethod
    def _json(status: int, obj) -> tuple[int, str, bytes]:
        return status, "application/json", json.dumps(obj).encode()

    def _r_submit(self, path, body, on_reply: bool = False):
        """Admit one job.  The scheduler cannot pick it until its
        ``submit`` record is journaled and its reply is handed out: the
        job is enqueued held and journaled under the daemon's lock, so no
        ``publish`` record (nor a ``daemonkill`` at the publish) can come
        before them.  With ``on_reply`` (the HTTP route) the reply carries
        a trailing callback the HTTP layer runs once the reply is
        written, which releases the job; a direct call releases it before
        returning."""
        try:
            req = json.loads(body.decode() or "{}")
        except ValueError:
            return self._json(400, {"error": "bad JSON body"})
        if not req.get("script"):
            return self._json(400, {"error": "missing 'script'"})
        tenant = req.get("tenant") or str(serve_var(self.mca, "tenant"))
        try:
            with self._lock:
                job = self.queue.submit(
                    req["script"], args=req.get("args") or (),
                    tenant=tenant, nprocs=req.get("nprocs"),
                    env=req.get("env"), held=True)
                self._journal_ev("submit", job=job)
        except AdmissionError as e:
            body: dict = {"error": str(e)}
            if e.retry_after is not None:
                # load-shed rejection: the Retry-After rides both the
                # JSON body and a real HTTP header (RFC-compliant
                # clients back off without parsing the body)
                body["retry_after"] = e.retry_after
                return (*self._json(e.status, body),
                        {"Retry-After": str(int(e.retry_after))})
            return self._json(e.status, body)
        if on_reply:
            return (*self._json(200, job), None,
                    lambda: self.queue.release(job["id"]))
        self.queue.release(job["id"])
        return self._json(200, job)

    def _r_jobs(self, path, body):
        st = self.queue.state()
        with self._lock:
            st["procs"] = {
                str(r): {"status": self._status[r],
                         "incarnation": self._incarnation[r],
                         "pid": self._proc_pid(r),
                         **({"log": os.path.join(
                             self.logdir, f"worker.{r}.log")}
                            if self.logdir
                            and isinstance(self._procs[r], _AdoptedProc)
                            else {})}
                for r in range(self.np)}
            st["healthy"] = self._healthy_locked()
            st["cursor"] = self.cursor
            st["generation"] = self.generation
        st["telemetry"] = self.aggregator.jobs_state()
        st["url"] = self.url
        return self._json(200, st)

    def _proc_pid(self, r: int) -> int | None:
        p = self._procs[r]
        pid = getattr(p, "pid", None)
        return (int(pid) if pid is not None
                else self._adopt_pids.get(r))

    def _daemon_counters(self) -> dict:
        """The aggregator's /metrics host-process extension
        (``proc="daemon"`` samples): the queue's serving counters plus
        the daemon-owned hang-diagnosis totals — the deadline path's
        reports are captured HERE, not in any rank."""
        c = dict(self.queue.counters)
        from ompi_tpu_torch.trace import waitgraph as _waitgraph

        if _waitgraph._enabled:
            c.update(_waitgraph.counters_snapshot())
        return c

    def _capture_hang_report(self, job_id: str, procs) -> dict | None:
        """Pre-revoke hang report: assemble the gang's cross-rank
        wait-for graph from the newest telemetry frames while everyone
        is still parked.  Bounded by ``hang_snapshot_timeout_ms``: the
        capture waits that long for at least one blocked-state
        snapshot from the gang (frames arrive at telemetry cadence),
        then reports from whatever it holds — diagnosis must never
        stall the revoke beyond its budget."""
        from ompi_tpu_torch.trace import waitgraph as _waitgraph

        if not _waitgraph._enabled:
            return None
        gang = {int(p) for p in procs}
        deadline = time.monotonic() + self._hang_timeout_s
        while True:
            frames = self.aggregator.latest_frames()
            snaps = {p: f["waits"] for p, f in frames.items()
                     if p in gang and f.get("waits")}
            if snaps or time.monotonic() >= deadline:
                break
            time.sleep(0.05)
        failed: set[int] = set()
        for p, f in frames.items():
            if p in gang:
                failed.update(int(x) for x in (f.get("failed") or ()))
        try:
            return _waitgraph.report(snaps, failed=sorted(failed),
                                     reason=f"deadline:{job_id}")
        except Exception:  # noqa: BLE001 — diagnosis never blocks revoke
            return None

    def _top_state(self) -> dict:
        """The aggregator /json extension (the daemon's state line):
        liveness identity, journal depth, and the re-adoption picture —
        an operator watching top sees a restarted daemon re-adopt."""
        qs = self.queue.state()
        now = time.monotonic()
        with self._lock:
            agents = {}
            for hid, ag in self._agents.items():
                workers = ((ag.get("hb") or {}).get("workers") or {})
                agents[str(hid)] = {
                    "host": ag["name"],
                    "status": ag["status"],
                    "session": ag["session"],
                    "ranks": list(ag["ranks"]),
                    "pid": int((ag.get("hb") or {}).get("pid", 0)),
                    "hb_age_ms": round(
                        (now - ag.get("hb_mono", now)) * 1e3, 1),
                    "alive_workers": sum(
                        1 for st in workers.values()
                        if st.get("alive")),
                    "spawns": ag["spawns"],
                }
            return {"daemon": {
                "pid": os.getpid(),
                "cuda_initialized": _cuda_initialized(),
                "generation": self.generation,
                "crash_safe": bool(self.pidfile),
                "queued": len(qs["queued"]),
                "outstanding": len(self._outstanding),
                "journal_depth": len(qs["queued"]) + len(self._outstanding),
                "adopting": [r for r in range(self.np)
                             if self._status[r] == "adopting"],
                "procs": {str(r): self._status[r]
                          for r in range(self.np)},
                "draining": self.queue.draining,
                "jobs": {"running": len(qs["running"]),
                         "counters": dict(qs["counters"]),
                         "admission": qs["admission"]},
                **({"agents": agents} if agents else {}),
            }}

    def _r_job(self, path, body):
        job_id = path.rsplit("/", 1)[-1]
        job = self.queue.get(job_id)
        if job is None:
            return self._json(404, {"error": f"no such job {job_id!r}"})
        return self._json(200, job)

    def _r_drain(self, path, body):
        self.queue.draining = True
        self._journal_ev("drain")  # a restart must stay draining
        return self._json(200, {"draining": True})

    def _r_shutdown(self, path, body):
        self.queue.draining = True
        self._journal_ev("drain")
        self.shutting_down = True
        return self._json(200, {"shutting_down": True})

    def _r_scale(self, path, body):
        try:
            want = int(json.loads(body.decode() or "{}")["nprocs"])
        except (ValueError, KeyError):
            return self._json(400, {"error": "body must be "
                                             '{"nprocs": <int>}'})
        if not 0 < want <= self.np:
            return self._json(400, {"error": f"nprocs must be in "
                                             f"[1, {self.np}]"})
        with self._lock:
            active = [r for r in range(self.np)
                      if self._status[r] == "active"]
            if want < len(active):
                retire = active[want:]
                self._publish({"kind": "retire", "procs": active,
                               "retire": retire})
                for r in retire:
                    self._status[r] = "retiring"
                return self._json(200, {"retiring": retire})
            grow = [r for r in range(self.np)
                    if self._status[r] in ("retired", "dead")][
                        :want - len(active)]
            for r in grow:
                self._respawn_locked(r)
            return self._json(
                200, {"restoring": grow} if grow else {"unchanged": True})

    # -- directive stream ------------------------------------------------

    def _publish(self, directive: dict) -> int:
        """Append one directive to the job stream; workers consume
        indices in order, so publication order IS execution order.
        Journaled BEFORE it becomes visible — a crash between the two
        re-publishes it on recovery; consumers dedup by cursor."""
        if _fsim._enabled:
            # chaos (daemonkill:at=N): the Nth publish attempt kills
            # the daemon dead, BEFORE the directive is journaled or
            # visible — the deterministic SIGKILL the restart-hygiene
            # soak replays from one seed.  Repair publishes are their
            # own site (daemon_repair) so a plan can land the kill
            # precisely inside the repair window
            site = ("daemon_repair" if directive.get("kind") == "repair"
                    else "daemon")
            for _r in _fsim.actions(site, kinds={"daemonkill"}):
                print("[tpud] faultsim: injected daemon kill "
                      "(daemonkill)", flush=True)
                sys.stdout.flush()
                os.kill(os.getpid(), signal.SIGKILL)
        with self._lock:
            idx = self.cursor
            self.cursor += 1
            d = dict(directive)
            d["idx"] = idx
            self._outstanding[idx] = {
                "kind": d.get("kind", "job"),
                "procs": list(d.get("procs") or range(self.np)),
                "job_id": d.get("id"),
                "done": {},
                "ts": time.monotonic(),
            }
            self._journal_ev("publish", d=d)
            self.server.put_local(f"{K_JOB}{idx}", d)
            return idx

    def _publish_job(self, job: dict) -> None:
        base = self.cid_next
        self.cid_next += self.cid_block
        job["cid_base"] = base
        job["cid_span"] = self.cid_block
        # job-scoped telemetry: frames from these procs now label this
        # job and /metrics reads relative to this instant's baselines
        self.aggregator.begin_job(job["id"], procs=job["procs"])
        self._publish({"kind": "job", **{
            k: job[k] for k in ("id", "tenant", "script", "args", "env",
                                "procs", "cid_base", "cid_span")}})

    # -- failure / elastic plane ----------------------------------------

    def _respawn_locked(self, rank: int) -> None:
        """Scale-up leg (shared by death recovery and /scale restore):
        relaunch the rank under a bumped incarnation and queue the
        repair that will ``replace()`` it back into the warm world."""
        self._incarnation[rank] += 1
        self._status[rank] = "respawning"
        self._repairing.add(rank)
        self._repair_published = False
        # journal the repair INTENT before anything is visible: a
        # daemon SIGKILLed between this respawn and the replace()
        # completion finishes the repair after restart instead of
        # stranding the reborn worker (cleared by the repair finish)
        self._journal_ev("repair_pending", rank=rank,
                         incarnation=self._incarnation[rank])
        self._procs[rank] = (self._spawn(rank) if self._spawn_workers
                             else None)

    def _unlink_dead(self, rank: int) -> None:
        """``/dev/shm`` hygiene for a local worker that died: a SIGKILLed
        process never runs its own teardown, so its rings, doorbell and
        device windows (each name carries its pid) are unlinked here —
        the live peers keep their mappings; nothing opens them by name
        again.  A remote rank's names live on its agent's host."""
        pid = getattr(self._procs[rank], "pid", None)
        if self._rank_hid[rank] is None and pid:
            _unlink_leftovers([int(pid)])

    def _handle_death(self, rank: int, rc: int) -> None:
        self._unlink_dead(rank)
        with self._lock:
            if self._status[rank] == "retiring":
                self._status[rank] = "retired"
                self._journal_ev("retire", ranks=[rank])
                return
            if self.shutting_down and self._shutdown_published:
                self._status[rank] = "exited"
                return
            # a died worker fails its directive's gang: synthesize its
            # completion record so survivors' reports can close it out
            for st in self._outstanding.values():
                if rank in st["procs"] and rank not in st["done"]:
                    st["done"][rank] = {"ok": False,
                                        "error": f"rank died (rc={rc})"}
            if self._incarnation[rank] >= self.max_respawns:
                print(f"[tpud] rank {rank} died (rc={rc}); respawn "
                      f"budget exhausted — marking it dead", flush=True)
                self._status[rank] = "dead"
                return
            print(f"[tpud] rank {rank} died (rc={rc}); respawning "
                  f"(incarnation {self._incarnation[rank] + 1})",
                  flush=True)
            self._respawn_locked(rank)

    def _maybe_publish_repair(self) -> None:
        """Publish ONE repair directive once every rank-set is free:
        survivors run ``replace()`` (awaiting the reborn incarnations),
        the reborn workers rejoin through the replace beacon and then
        resume the stream AFTER this directive (their cursor is the
        ``serve.resume`` key written here)."""
        with self._lock:
            # bystander-quiet gate: only a directive whose gang
            # INTERSECTS the dead set blocks the repair (its members
            # are failing on the dead rank right now and must close
            # out first) — a concurrently running disjoint gang keeps
            # its job while the survivors heal the base world under it
            if (not self._repairing or self._repair_published
                    or any(s == "adopting" for s in self._status)
                    or any(st["kind"] != "repair"
                           and set(st["procs"]) & self._repairing
                           for st in self._outstanding.values())):
                return
            if any(self._status[r] == "respawning" and
                   (self._procs[r] is None or
                    self._procs[r].poll() is not None)
                   for r in self._repairing):
                return  # a respawn died before repair; death path re-arms
            survivors = [r for r in range(self.np)
                         if self._status[r] == "active"]
            if not survivors:
                return
            idx = self._publish({
                "kind": "repair", "procs": survivors,
                "dead": sorted(self._repairing)})
            for r in sorted(self._repairing):
                self.server.put_local(
                    f"{K_RESUME}{r}.i{self._incarnation[r]}", idx + 1)
            self._repair_published = True

    # -- monitor loop ----------------------------------------------------

    def _admission_update(self) -> None:
        """Fold one tick of the daemon's OWN telemetry feeds into the
        admission controller: per-proc cumulative stall sums
        (ring + CTS + device-DMA wait, straight off the newest frames),
        detector health, and the /critical dominant cause for the 429
        message.  Ticks that saw no fresh frame are skipped while the
        mesh is healthy — the controller's streak must advance at
        telemetry cadence, not at the much faster monitor cadence, or
        the zero-delta gap between frames would reset it every time."""
        ctrl = self.queue.admission
        if ctrl is None or not ctrl.enabled():
            return
        latest = self.aggregator.latest_frames()
        fresh = False
        stalls: dict[int, int] = {}
        for p, frame in latest.items():
            ts = int(frame.get("ts_ns", 0))
            if ts != self._adm_seen.get(p):
                fresh = True
                self._adm_seen[p] = ts
            nat = frame.get("native") or {}
            stalls[p] = (int(nat.get("ring_stall_ns", 0))
                         + int(nat.get("cts_wait_ns", 0))
                         + int(nat.get("device_dma_wait_ns", 0)))
        with self._lock:
            healthy = self._healthy_locked()
        if not fresh and healthy and not ctrl.unhealthy:
            return
        cause = ""
        try:
            dom = self.aggregator.critical_state().get("dominant")
            cause = str((dom.get("cause") if isinstance(dom, dict)
                         else dom) or "")
        except Exception:  # noqa: BLE001 — admission over blame detail
            pass
        ctrl.update(stalls, healthy=healthy, cause=cause)

    def _healthy_locked(self) -> bool:
        return not self._repairing and all(
            s in ("active", "retired", "dead", "exited")
            for s in self._status)

    def _poll_workers(self) -> None:
        for r in range(self.np):
            p = self._procs[r]
            if p is None or self._status[r] in ("retired", "dead",
                                                "exited"):
                continue
            rc = p.poll()
            if rc is not None:
                self._handle_death(r, rc or 0)

    def _collect_done(self) -> None:
        done_idx = []
        revoke: list[tuple[str, list[int]]] = []
        with self._lock:
            for idx, st in self._outstanding.items():
                for r in st["procs"]:
                    if r in st["done"]:
                        continue
                    rec = self.server.peek(f"{K_DONE}{idx}.{r}")
                    if rec is not None:
                        st["done"][r] = rec
                if len(st["done"]) >= len(st["procs"]):
                    done_idx.append(idx)
                    continue
                if st["kind"] != "job":
                    continue
                elapsed = time.monotonic() - st["ts"]
                if (self.job_deadline > 0 and not st.get("revoked")
                        and elapsed > self.job_deadline):
                    # ULFM-grade deadline escalation: revoke exactly
                    # this job's comm — its gang wakes out of any
                    # parked collective with MPIRevokedError and
                    # reports a typed failure; the ranks stay ALIVE
                    # and concurrent disjoint gangs never notice
                    # (serve_job_timeout below stays the harder,
                    # rank-killing bound)
                    print(f"[tpud] job {st['job_id']} exceeded "
                          f"serve_job_deadline_s={self.job_deadline:g}"
                          "s; revoking its comm", flush=True)
                    st["revoked"] = True
                    st["deadline_hit"] = True
                    self.queue.counters["jobs_deadline_expired"] += 1
                    revoke.append((st["job_id"], list(st["procs"])))
                if (self.job_timeout > 0
                        and elapsed > self.job_timeout):
                    # job overran its budget: reclaim the rank-set by
                    # killing its members — the death path respawns and
                    # repairs them (the elastic plane as the enforcer)
                    print(f"[tpud] job {st['job_id']} exceeded "
                          f"serve_job_timeout={self.job_timeout}s; "
                          f"killing its ranks", flush=True)
                    st["ts"] = float("inf")
                    for r in st["procs"]:
                        q = self._procs[r]
                        if q is not None and q.poll() is None:
                            q.terminate()
        for job_id, procs in revoke:
            # capture the hang report BEFORE the revoke wakes the gang:
            # revoked waits unregister themselves, so the blocked-state
            # evidence evaporates the moment the directive lands
            hang = self._capture_hang_report(job_id, procs)
            if hang is not None:
                with self._lock:
                    for st in self._outstanding.values():
                        if (st["kind"] == "job"
                                and st.get("job_id") == job_id):
                            st["hang"] = hang
            self._publish({"kind": "revoke", "procs": procs,
                           "id": job_id})
        for idx in done_idx:
            self._finish_directive(idx)

    def _finish_directive(self, idx: int) -> None:
        with self._lock:
            st = self._outstanding.pop(idx)
        if st["kind"] == "job":
            bad = [f"rank {r}: {rec.get('error', '?')}"
                   for r, rec in sorted(st["done"].items())
                   if not rec.get("ok")]
            error = "; ".join(bad)
            died = any("rank died" in rec.get("error", "")
                       or "mesh lost" in rec.get("error", "")
                       for rec in st["done"].values()
                       if not rec.get("ok"))
            if bad and st.get("deadline_hit"):
                # typed failure the client reads off /job/<id>; a
                # deadline kill is policy, never retried
                error = ("DeadlineExpired: exceeded "
                         f"serve_job_deadline_s={self.job_deadline:g}s"
                         f"; {error}")
            elif bad and died:
                # mesh repair killed the job, not the job itself:
                # serve_retry_budget buys it automatic re-enqueues —
                # the close-the-attempt + re-queue pair is ONE journal
                # line, so a daemon crash on either side of it replays
                # to exactly one more attempt (exactly-once)
                job = self.queue.retry(st["job_id"])
                if job is not None:
                    self._journal_ev("retry", idx=idx, job=job)
                    print(f"[tpud] job {job['id']} killed by mesh "
                          f"repair; re-queued (retry {job['retries']}"
                          f"/{self.queue.retry_budget})", flush=True)
                    return
                if self.queue.retry_budget > 0:
                    error = ("RetryBudgetExhausted: serve_retry_budget"
                             f"={self.queue.retry_budget} consumed; "
                             f"{error}")
            job = self.queue.finish(st["job_id"], ok=not bad,
                                    error=error,
                                    ranks=st["done"],
                                    hang=st.get("hang"))
            self._journal_ev("finish", idx=idx, kind="job", job=job)
            if job is not None:
                print(f"[tpud] job {job['id']} ({job['tenant']}) "
                      f"{job['state']}", flush=True)
        elif st["kind"] == "repair":
            with self._lock:
                for r in self._repairing:
                    if self._status[r] == "respawning":
                        self._status[r] = "active"
                self._repairing.clear()
                self._repair_published = False
            self._journal_ev("finish", idx=idx, kind="repair")
            print("[tpud] repair complete: mesh restored", flush=True)
        elif st["kind"] == "revoke":
            # the revocation itself: members acked poisoning the comm;
            # the JOB directive still closes separately (its gang's
            # typed failure reports drive the branch above)
            self._journal_ev("finish", idx=idx, kind="revoke")
        elif st["kind"] == "retire":
            with self._lock:
                done = [r for r in range(self.np)
                        if self._status[r] == "retiring"]
                for r in done:
                    self._status[r] = "retired"
            if done:
                self._journal_ev("retire", ranks=done)
            self._journal_ev("finish", idx=idx, kind="retire")

    def _busy_procs(self) -> set[int]:
        with self._lock:
            return {r for st in self._outstanding.values()
                    for r in st["procs"]}

    def _booted(self) -> bool:
        """Mesh boot gate: a rank worker's ``wsize.<r>`` modex publish
        is its I-am-up beacon — scheduling (and therefore the
        daemonkill directive counter) must not run ahead of workers
        that are still importing.  Without this, a daemon crash in the
        boot window strands directives no worker ever saw AND kills
        the workers at their first KVS dial (found by the
        --daemon-restart soak's own race)."""
        if not self._spawn_workers:
            return True  # workerless harness pumps the stream itself
        return all(self.server.peek(f"wsize.{r}") is not None
                   for r in range(self.np)
                   if self._status[r] == "active")

    def _schedule(self) -> None:
        with self._lock:
            if not self._healthy_locked() or self._shutdown_published:
                return
            active = {r for r in range(self.np)
                      if self._status[r] == "active"}
        if not self._booted():
            return
        free = active - self._busy_procs()
        while True:
            job = self.queue.next_runnable(free)
            if job is None:
                return
            if job["nprocs"] > len(active):
                self.queue.finish(
                    job["id"], ok=False,
                    error=f"needs {job['nprocs']} procs; only "
                          f"{len(active)} active")
                continue
            self._publish_job(job)
            free -= set(job["procs"])

    def _maybe_shutdown(self) -> bool:
        with self._lock:
            if not self.shutting_down or self._shutdown_published:
                return self._shutdown_published
            if self._outstanding or not self.queue.idle():
                return False
            active = [r for r in range(self.np)
                      if self._status[r] == "active"]
            self._publish({"kind": "shutdown", "procs": active})
            self._shutdown_published = True
            return True

    def step(self) -> None:
        """One monitor tick (public so tests can drive the loop
        deterministically)."""
        self._poll_agents()
        self._poll_adoption()
        self._poll_workers()
        self._collect_done()
        self._maybe_publish_repair()
        self._admission_update()
        self._schedule()
        self._maybe_shutdown()

    def run(self) -> int:
        """Blocking monitor loop until shutdown completes."""
        print(f"[tpud] ops: {self.url}/jobs (submit: python -m "
              f"ompi_tpu_torch ctl --url {self.url} submit <script>; "
              f"scrape: {self.url}/metrics)", flush=True)
        def _sigterm(*_):
            # same contract as POST /shutdown: stop admitting AND stop
            # serving — shutting_down alone would keep accepting jobs
            # and never drain under continued submit traffic
            self.queue.draining = True
            self.shutting_down = True

        try:
            signal.signal(signal.SIGTERM, _sigterm)
        except ValueError:
            pass  # non-main thread (tests): SIGTERM stays default
        try:
            while True:
                self.step()
                if self._shutdown_published:
                    live = [p for p in self._procs
                            if p is not None and p.poll() is None]
                    if not live:
                        break
                time.sleep(0.05)
        except KeyboardInterrupt:
            self.shutting_down = True
            self.exit_code = 130
        finally:
            self.close()
        return self.exit_code

    def close(self) -> None:
        self.queue.fail_queued("daemon shut down")
        deadline = time.monotonic() + 10
        for p in self._procs:
            while (p is not None and p.poll() is None
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            if p is not None and p.poll() is None:
                p.kill()
                try:
                    p.wait(timeout=5)  # reaped: its names can go below
                except subprocess.TimeoutExpired:
                    pass
        # stop the launch agents (their workers are already down):
        # each acks the stop, sweeps any leftover worker on its host,
        # and exits — taking the rsh leg down with it
        for hid, ag in self._agents.items():
            if ag["status"] in ("down",):
                continue
            try:
                self._agent_cmd(hid, {"kind": "stop"})
            except Exception:  # noqa: BLE001 — exiting anyway
                pass
        adeadline = time.monotonic() + 10
        for hid, ag in self._agents.items():
            p = ag.get("proc")
            while (p is not None and p.poll() is None
                   and time.monotonic() < adeadline):
                time.sleep(0.05)
            if p is not None and p.poll() is None:
                p.kill()
            if p is None:
                # adopted agent (not our child): best-effort local
                # signal sweep — exact on the emulated-host harness
                pid = int((ag.get("hb") or {}).get("pid", 0))
                while (pid and _state.pid_alive(pid)
                       and time.monotonic() < adeadline):
                    time.sleep(0.05)
                if pid and _state.pid_alive(pid):
                    try:
                        os.kill(pid, signal.SIGKILL)
                    except OSError:
                        pass
        for t in self._threads:
            t.join(timeout=5)
        for r in range(self.np):
            if self._procs[r] is not None:
                self._unlink_dead(r)
        self.aggregator.close()
        self.server.close()
        # clean release: the journal is REMOVED (nothing durable
        # remains to recover, and an append-only file reused across
        # many daemon lifetimes would grow without bound) and the
        # pidfile lifts — the next daemon starts fresh instead of
        # "recovering" a shutdown it misreads as a crash.  The
        # shutdown event is still written first: if the unlink loses a
        # race (or the operator copies the journal mid-shutdown), the
        # tail says clean.
        if self._journal is not None:
            self._journal_ev("shutdown", generation=self.generation)
            self._journal.close()
            self._journal = None
            try:
                os.unlink(self.journal_path)
            except OSError:
                pass
        if self.pidfile:
            _state.remove_pidfile(self.pidfile)


def _cuda_initialized() -> bool:
    """Whether this process has initialized ``torch.cuda`` — the daemon
    must not: a CUDA context costs the card hundreds of MiB that belong
    to the workers."""
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


class _RemoteProc:
    """A rank owned by a per-host launch agent: the Popen surface the
    monitor loop touches, with liveness routed through the owning
    agent's heartbeat table — the daemon shares no pid namespace with
    the worker, so ``poll()`` reads the agent's report instead of a
    local wait/kill-0, and ``terminate``/``kill`` publish agent
    commands.  A table entry for a PRIOR incarnation is ignored
    (stale: the respawn command is still in flight)."""

    def __init__(self, daemon: "TpuDaemon", rank: int, hid: int,
                 incarnation: int):
        self._d = daemon
        self.rank = int(rank)
        self.hid = int(hid)
        self.incarnation = int(incarnation)
        self.pid: int | None = None
        self.returncode: int | None = None

    def poll(self) -> int | None:
        if self.returncode is not None:
            return self.returncode
        st = self._d._agent_worker_state(self.hid, self.rank)
        if st is None:
            return None  # agent has not reported this rank yet
        if int(st.get("incarnation", -1)) != self.incarnation:
            return None  # stale table: the spawn is still in flight
        if int(st.get("pid", 0)):
            self.pid = int(st["pid"])
        if not st.get("alive", True):
            self.returncode = int(st.get("rc", 1))
        return self.returncode

    def terminate(self) -> None:
        self._d._agent_kill(self.hid, self.rank, signal.SIGTERM)

    def kill(self) -> None:
        self._d._agent_kill(self.hid, self.rank, signal.SIGKILL)

    def wait(self, timeout: float | None = None) -> int:
        deadline = time.monotonic() + (timeout or 0)
        while self.poll() is None:
            if timeout is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired("remote", timeout)
            time.sleep(0.05)
        return self.returncode  # type: ignore[return-value]


class _AdoptedProc:
    """A re-adopted resident worker: not our child, so no Popen — a
    pid wrapper with the Popen surface the monitor loop touches.
    ``poll()`` can only report liveness (the real exit code reaps to
    init), so death reads as a synthetic rc 1 — enough for the
    respawn machinery, which only branches on nonzero."""

    def __init__(self, pid: int):
        self.pid = int(pid)
        self.returncode: int | None = None

    def poll(self) -> int | None:
        if self.returncode is None and not _state.pid_alive(self.pid):
            self.returncode = 1
        return self.returncode

    def _signal(self, sig: int) -> None:
        try:
            os.kill(self.pid, sig)
        except OSError:
            pass

    def terminate(self) -> None:
        self._signal(signal.SIGTERM)

    def kill(self) -> None:
        self._signal(signal.SIGKILL)

    def wait(self, timeout: float | None = None) -> int:
        deadline = time.monotonic() + (timeout or 0)
        while self.poll() is None:
            if timeout is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired("adopted", timeout)
            time.sleep(0.05)
        return self.returncode  # type: ignore[return-value]


def run_daemon(np_: int, mca: dict[str, str] | None = None,
               nranks: int | None = None, cpu: bool = False,
               max_respawns: int = 2,
               http_port: int | None = None,
               hosts: list[tuple[str, int]] | None = None,
               map_by: str = "slot",
               launch_agent: str = "ssh {host} {cmd}",
               kvs_host: str | None = None,
               oversubscribe: bool = False) -> int:
    """The ``run --daemon`` / ``python -m ompi_tpu_torch tpud`` entry."""
    try:
        d = TpuDaemon(np_, mca=mca, nranks=nranks, cpu=cpu,
                      max_respawns=max_respawns, http_port=http_port,
                      hosts=hosts, map_by=map_by,
                      launch_agent=launch_agent, kvs_host=kvs_host,
                      oversubscribe=oversubscribe)
    except _state.DaemonAlreadyRunning as e:
        # idempotent start: a second `tpurun --daemon` against a live
        # pidfile is a clean one-liner, not a traceback
        print(f"tpud: {e}", flush=True)
        return 1
    return d.run()

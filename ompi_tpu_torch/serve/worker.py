"""Resident rank worker — boot once, serve jobs until shutdown.

Port of ``ompi_tpu/serve/worker.py``.  Launched by the daemon as
``python -m ompi_tpu_torch.serve.worker``: runs the normal boot
rendezvous (``api.init`` → CUDA context, modex, DCN dials, engine
threads) exactly once, then long-polls the daemon's job stream
(``serve.job.<n>`` on the boot KVS) instead of running one script and
finalizing — the **job re-arm** that replaces finalize-teardown.

The worker's ranks run on CUDA and the boot raises without a card;
they run on the CPU only when the daemon was started with ``--cpu``
(it hands ``OMPI_TPU_DEVICE=cpu`` to its workers).  The rank count is
the daemon's ``--nranks`` (``accelerator_cuda_nranks``).  With the
daemon's ``--mca accelerator_cuda_layout devices`` every rank owns a
buffer on its own card (job-wide blocks, as under ``run``): a job world
keeps each rank's card, and the worker synchronizes, reports and
releases every card of its local mesh.

Per job directive:

* a fresh ``MPI_COMM_WORLD``-equivalent is carved from the warm world
  with **zero traffic**: the daemon assigned a disjoint CID block, so
  every member deterministically builds the same sub-communicator
  (``_make_sub``) at the block base — per-(comm, op) sequence counters
  start clean, nothing re-dials, and concurrent tenants' comm worlds
  can never collide in CID space;
* the job script runs **in this process** via ``runpy`` under a pushed
  world scope (``api.push_world``): the script's ``api.init()`` returns
  the job world; its ``api.finalize()`` pops the scope and leaves the
  mesh warm;
* when the script returns, the job world's cards are synchronized (the
  record's end time covers kernels still in flight), the job comm is
  freed and the device plane's windows of the job are released, so no
  job pins device memory into the next one;
* a completion record (timings, transport dial counters — the
  warm-reuse proof — the first device and every local rank's, the
  kernel launches and, on the card, ``torch.cuda.memory_allocated`` of
  the first card and of each card, ``cards``) is published for the
  daemon.

``repair`` directives fire the elastic plane on demand: survivors run
``replace()`` to restore a respawned rank; a reborn worker rejoins
through the replace beacon and resumes the stream at the cursor the
daemon published for its incarnation.  Both log, and the survivor's
repair record carries, the directive acted on and every replace round
entered: its stream, its members with the incarnation held for each,
and its milliseconds.

**Daemon crash-safety** (the worker half): every KVS interaction goes
through :class:`DaemonLink`.  When the daemon dies (connection loss on
the long-poll or a failed completion put), the worker keeps serving
its in-flight job — the data plane is worker-to-worker — and **parks**
in a bounded re-attach window (``serve_reattach_timeout``), polling
the pidfile (``OMPI_TPU_SERVE_PIDFILE``) for a restarted daemon at a
higher generation.  Found one: re-dial its KVS, re-publish the modex
keys the old server took down, offer a ``serve.adopt.<r>`` record,
await the ack, re-put any completion records the crash orphaned, and
resume the stream at the local cursor (replayed directives dedup —
exactly once).  No daemon within the window (or no pidfile at all):
self-terminate with the full exit hygiene — crash-path telemetry
export, flight record, device-plane close, ``tdcn_destroy`` engine
teardown.  **No
orphans, ever** — the same path a daemon-initiated SIGTERM stop takes.
"""

from __future__ import annotations

import collections
import json
import os
import runpy
import signal
import sys
import threading
import time

from . import state as _state

#: KVS keys (shared with the daemon — keep in sync with serve/daemon.py)
K_JOB = "serve.job."
K_DONE = "serve.done."
K_RESUME = "serve.resume."
K_ADOPT = "serve.adopt."
K_ADOPTED = "serve.adopted."
K_START = "serve.start."
ENV_SERVE_PIDFILE = "OMPI_TPU_SERVE_PIDFILE"

#: transport counters proving warm reuse (flat across jobs = no
#: re-dials) and the per-job delivery/dedup picture; the schedule-cache
#: pair proves the OTHER warm asset — compiled persistent-collective
#: plans surviving across jobs like the mesh (hits climbing while
#: misses stay flat across same-signature jobs)
_DIAL_KEYS = ("reconnects", "retry_dials")
_REPORT_KEYS = ("delivered", "reconnects", "retry_dials", "dedup_drops",
                "sched_cache_hits", "sched_cache_misses")

#: completion records kept for re-publication after a daemon restart
_DONE_CACHE = 256


class _Stop(BaseException):
    """SIGTERM carrier — BaseException so the job scope's catch-all
    (a job must never kill the worker) cannot swallow a
    daemon-initiated stop."""


def _sigterm(signum, frame):  # pragma: no cover - signal delivery
    raise _Stop()


class _PipeSafe:
    """Stdio guard for the resident plane: the worker's stdout is a
    pipe into the daemon, and a SIGKILLed daemon turns every print —
    including the in-flight job script's — into BrokenPipeError.  The
    in-flight job must keep running through the daemon outage, so
    writes degrade to no-ops instead of raising (output during the
    outage is lost; the completion record is the durable artifact).

    Writes are serialized by a lock: the concurrent serving plane
    prints from the main loop (repair/revoke handling) and the
    per-job thread at once, and an interleaved-mid-line ``[rank N]``
    prefix would corrupt the daemon-side log forwarding the chaos
    soak parses."""

    def __init__(self, f):
        self._f = f
        self._wlock = threading.Lock()

    def retarget(self, f) -> None:
        """Re-aim at a NEW sink (adopted-worker stdio re-attach): the
        dead daemon's pipe is gone for good, so post-adoption output
        goes to the per-worker log file named in the restarted
        daemon's pidfile record instead of the bit bucket."""
        with self._wlock:
            self._f = f

    def write(self, s):
        with self._wlock:
            try:
                return self._f.write(s)
            except (OSError, ValueError):
                return len(s)

    def flush(self):
        with self._wlock:
            try:
                self._f.flush()
            except (OSError, ValueError):
                pass

    def __getattr__(self, name):
        return getattr(self._f, name)


def reaim_stdio(logdir: str, filename: str, banner: str) -> None:
    """The shared half of the worker/agent stdio re-attach protocol
    after a daemon crash: both processes' stdout/stderr still point at
    the DEAD daemon's pipe (_PipeSafe swallowed the breakage) — re-aim
    them at a per-process log file under the restarted daemon's logs
    dir so post-reattach output is durable instead of lost.  No-op on
    an empty logdir; an unusable one keeps the swallowing streams
    (staying alive outranks durable logs)."""
    if not logdir:
        return
    try:
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, filename)
        logf = open(path, "a", buffering=1)
        for stream in (sys.stdout, sys.stderr):
            rt = getattr(stream, "retarget", None)
            if rt is not None:
                rt(logf)
        print(f"{banner}: stdio re-aimed at {path}", flush=True)
    except OSError:
        pass  # log dir unusable: keep swallowing, stay alive


class DaemonLink:
    """The worker's resilient handle on the daemon: job-stream cursor,
    completion-record cache, and the crash→re-attach state machine."""

    def __init__(self, ctx, wsize: int, poll: float, window: float):
        self.ctx = ctx
        self.wsize = int(wsize)
        self.poll = poll
        self.window = float(window)
        self.pidfile = os.environ.get(ENV_SERVE_PIDFILE, "")
        info = (_state.read_pidfile(self.pidfile)
                if self.pidfile else None)
        #: the generation we booted under; re-attach requires a HIGHER
        #: one (a live daemon at our own generation is the one whose
        #: socket just broke — dial it again, don't adopt)
        self.generation = int((info or {}).get("generation", 0))
        #: next directive index to consume
        self.cursor = 0
        self._done: collections.OrderedDict[int, dict] = (
            collections.OrderedDict())
        #: main() installs the teardown closure (needs api + world)
        self.teardown = None

    # -- stream consumption ---------------------------------------------

    def wait_directive(self) -> tuple[int, dict]:
        """Long-poll the next directive; a dead daemon routes through
        the re-attach window (which either restores the link or exits
        the process — this loop never spins against a corpse)."""
        while True:
            try:
                jd = self.ctx.kvs.get(f"{K_JOB}{self.cursor}",
                                      timeout=max(self.poll, 2.0))
            except KeyError:
                time.sleep(self.poll)
                continue
            except (ConnectionError, OSError):
                self.reattach()
                continue
            idx, self.cursor = self.cursor, self.cursor + 1
            return idx, jd

    def get(self, key: str):
        """Resilient KVS read for non-stream keys (the reborn cursor
        beacon): same re-attach healing as the stream poll."""
        while True:
            try:
                return self.ctx.kvs.get(key, timeout=max(self.poll, 2.0))
            except KeyError:
                time.sleep(self.poll)
            except (ConnectionError, OSError):
                self.reattach()

    def report(self, idx: int, rec: dict) -> None:
        """Publish a completion record; cached regardless, so a record
        the daemon never saw (crash between execute and collect) is
        re-put on re-adoption — the daemon's collect is idempotent."""
        rec = dict(rec)
        rec["proc"] = self.ctx.proc
        self._done[idx] = rec
        while len(self._done) > _DONE_CACHE:
            self._done.popitem(last=False)
        try:
            self.ctx.kvs.put(f"{K_DONE}{idx}.{self.ctx.proc}", rec)
        except (ConnectionError, OSError):
            pass  # the re-attach path re-publishes the cache

    # -- crash → re-attach ----------------------------------------------

    def reattach(self) -> None:
        """The parked state: bounded poll of the pidfile for a
        restarted daemon, adoption on success, full-teardown exit on
        expiry.  Bounded by ``serve_reattach_timeout`` via the shared
        Deadline policy."""
        from ompi_tpu_torch.core.errors import DeadlineExpiredError
        from ompi_tpu_torch.core.var import Deadline

        if not self.pidfile:
            self._orphan_exit("daemon gone and no pidfile to re-attach "
                              "through (serve_pidfile off)")
        deadline = Deadline(self.window)
        print(f"serve: daemon lost; parking up to {self.window:.0f}s "
              f"for a restarted daemon ({self.pidfile})", flush=True)
        while True:
            info = _state.read_pidfile(self.pidfile)
            alive = bool(info) and _state.pid_alive(
                int(info.get("pid", 0)))
            # a restarting daemon's provisional O_EXCL claim (live
            # pid, no KVS address, the REAPED record's generation) is
            # not re-attachable — keep parking for the full-record
            # overwrite (found by the sigkill-restart soak: a worker
            # polling inside the claim window died on KeyError('kvs')
            # and the whole warm mesh cold-booted)
            ready = alive and _state.pidfile_ready(info)
            gen = int((info or {}).get("generation", 0))
            if ready and gen == self.generation:
                # transient socket break against the SAME daemon (it
                # never lost us): plain re-dial, no adoption handshake
                try:
                    self.ctx.kvs.reconnect(info["kvs"])
                    print("serve: KVS link re-dialed (daemon alive)",
                          flush=True)
                    return
                except OSError:
                    pass  # it may be dying; keep polling
            elif ready and gen > self.generation:
                try:
                    self._adopt(info, deadline)
                    return
                except (KeyError, OSError, TimeoutError,
                        DeadlineExpiredError) as e:
                    print(f"serve: re-attach attempt failed "
                          f"({type(e).__name__}: {e}); retrying",
                          flush=True)
            if deadline.expired():
                self._orphan_exit(
                    "no restarted daemon within serve_reattach_timeout"
                    f"={self.window:.0f}s")
            time.sleep(min(0.25, max(self.poll, 0.05)))

    def _adopt(self, info: dict, deadline) -> None:
        """One adoption attempt against a candidate daemon: re-dial
        its KVS, re-publish this rank's modex keys (the old server
        died with them; future respawns/repairs read them), offer the
        adopt record, await the ack, re-put cached completions."""
        ctx = self.ctx
        ctx.kvs.reconnect(info["kvs"])
        addr = ctx.engine.transport.address
        ctx.kvs.put(f"{ctx.ns}dcn.{ctx.proc}", addr)
        ctx.kvs.put(f"{ctx.ns}wsize.{ctx.proc}", self.wsize)
        if ctx.incarnation:
            ctx.kvs.put(f"{ctx.ns}dcn.{ctx.proc}.i{ctx.incarnation}",
                        addr)
            ctx.kvs.put(f"{ctx.ns}inc.{ctx.proc}", ctx.incarnation)
        gen = int(info["generation"])
        ctx.kvs.put(f"{K_ADOPT}{ctx.proc}", {
            "pid": os.getpid(), "incarnation": ctx.incarnation,
            "cursor": self.cursor, "generation": gen})
        while True:
            try:
                ack = ctx.kvs.get(f"{K_ADOPTED}{ctx.proc}",
                                  timeout=deadline.slice(1.0))
            except KeyError:
                ack = None
            if (ack and int(ack.get("pid", -1)) == os.getpid()
                    and int(ack.get("generation", 0)) == gen):
                break
            deadline.check("re-adoption ack")
            time.sleep(0.05)
        for idx, rec in list(self._done.items()):
            ctx.kvs.put(f"{K_DONE}{idx}.{ctx.proc}", rec)
        self.generation = gen
        from ompi_tpu_torch.metrics import live

        live.repoint_publisher(info.get("ingest") or "")
        # stdio re-attach: this worker's stdout/
        # stderr still point at the DEAD daemon's pipe (_PipeSafe
        # swallowed the breakage); re-aim them at the per-worker log
        # file the restarted daemon names in its pidfile record, so
        # post-adoption output is durable instead of lost.  The path
        # is surfaced on the daemon's /jobs procs table.
        reaim_stdio(str(info.get("logs") or ""),
                    f"worker.{ctx.proc}.log", "serve")
        print(f"serve: re-attached to daemon generation {gen} "
              f"(cursor {self.cursor})", flush=True)

    def _orphan_exit(self, reason: str) -> None:
        """The no-orphans guarantee: a worker that cannot find a
        daemon terminates ITSELF with the full exit hygiene — partial
        telemetry export, flight record, engine destroy — instead of
        serving nothing forever."""
        print(f"serve: {reason}; tearing down and exiting (no "
              "orphans)", flush=True)
        from ompi_tpu_torch.metrics import export as _mexport
        from ompi_tpu_torch.metrics import flight as _flight

        _flight.record("worker_orphaned", reason=reason,
                       cursor=self.cursor)
        _mexport.crash_dump("daemon_lost")
        if self.teardown is not None:
            self.teardown()
        raise SystemExit(0)


def _job_comm(world, jd: dict):
    """Deterministic job-world construction at the assigned CID block:
    every member reserves ``[base, base+1)`` (in-job derived comms draw
    from ``base+1`` upward via the normal CID agreement, staying inside
    the block) and builds the identical sub-communicator — no
    allgather, no dial, no traffic."""
    from ompi_tpu_torch.api.comm import _reserve_cid_block

    base = int(jd["cid_base"])
    cid = _reserve_cid_block(base, 1)
    procs = [int(p) for p in jd["procs"]]
    members = [r for p in procs for r in range(*world.proc_range(p))]
    owners = [p for p in procs for _ in range(world.proc_sizes[p])]
    sub = world._make_sub(jd["id"], cid, members, owners, procs)
    sub.name = f"world.{jd['id']}"
    return sub


def _exec_script(jd: dict) -> None:
    """Run the job script in-process as ``__main__`` with its argv and
    extra env, both restored afterwards (the warm process serves many
    jobs; one job's argv/env must not leak into the next)."""
    argv0, env0 = sys.argv, {}
    sys.argv = [jd["script"]] + list(jd.get("args") or ())
    try:
        for k, v in (jd.get("env") or {}).items():
            env0[k] = os.environ.get(k)
            os.environ[k] = v
        runpy.run_path(jd["script"], run_name="__main__")
    finally:
        sys.argv = argv0
        for k, old in env0.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old


def _revoke_quietly(job) -> None:
    """ULFM hygiene for EVERY abort path (exception or nonzero
    sys.exit): poison the aborted job comm so fellow members parked in
    its collectives wake with the truth (MPIRevokedError) instead of
    timing out their recv deadlines and falsely escalating a LIVE peer
    — the false positive that wedged the multi-host repair behind a
    60 s wait for a "respawn" of a rank that never died."""
    if job is None:
        return
    try:
        job.revoke()
    except Exception:  # noqa: BLE001 — poisoned comm already
        pass


def _cards(comm) -> list:
    """The CUDA cards of ``comm``'s local mesh, each once, in local rank
    order: the process's one card on the rows layout, every card its
    ranks own on the devices layout (none on the CPU)."""
    mesh = getattr(comm, "local_mesh", None)
    devs = mesh.devices if mesh is not None else (getattr(comm, "device", None),)
    cards: list = []
    for d in devs:
        if d is not None and d.type == "cuda" and d not in cards:
            cards.append(d)
    return cards


def _sync_device(comm) -> None:
    """Wait for the kernels a job queued on its world's cards: a
    collective's launches may still be in flight when the script
    returns, and the completion record's end time must cover them."""
    cards = _cards(comm)
    if cards:
        import torch

        for dev in cards:
            torch.cuda.synchronize(dev)


def _release_job_windows(world, timeout: float = 2.0) -> int:
    """Retire the device-plane windows the finished job staged: every
    receiver of the job has consumed its payload by now (the job's
    collectives completed), so each window's consumed signal is set or
    lands within the bound; the next job starts with no window — no
    CUDA allocation or shm header — of this one.  The plane holds every
    card's windows (each is freed on the card it was allocated on), so
    on the devices layout this retires them on every card of the local
    mesh.  Returns the windows still pending after the bound (0 on a
    clean job)."""
    try:
        plane = getattr(world.dcn._root_engine(), "_device_plane", None)
    except Exception:  # noqa: BLE001 — no engine, no windows
        return 0
    if plane is None:
        return 0
    deadline = time.monotonic() + timeout
    plane.reap()
    while plane.pending_windows() and time.monotonic() < deadline:
        time.sleep(0.001)
        plane.reap()
    return plane.pending_windows()


def _device_memory(world) -> dict:
    """The caching allocator's view after a job, on every card of the
    local mesh: allocated bytes must not grow job over job on any card
    (the reserved pool may stay — that is the warm part).
    ``cuda_allocated``/``cuda_reserved`` are the first card's (local
    rank 0's), ``cards`` one entry per card."""
    cards = _cards(world)
    if not cards:
        return {}
    import gc

    import torch

    gc.collect()  # the script's globals may hold tensors in cycles
    per = [{"device": str(d),
            "cuda_allocated": int(torch.cuda.memory_allocated(d)),
            "cuda_reserved": int(torch.cuda.memory_reserved(d))} for d in cards]
    return {"cuda_allocated": per[0]["cuda_allocated"],
            "cuda_reserved": per[0]["cuda_reserved"], "cards": per}


def _run_job(api, world, link: DaemonLink, jd: dict, idx: int,
             inflight: dict | None = None) -> None:
    import ompi_tpu_torch.serve as serve
    from ompi_tpu_torch.metrics import core as mcore
    from ompi_tpu_torch.metrics import live

    rec: dict = {"ok": True, "id": jd["id"], "cid_base": jd["cid_base"],
                 "incarnation": link.ctx.incarnation}
    before = mcore.native_counters()
    rec["dials_before"] = {k: int(before.get(k, 0)) for k in _DIAL_KEYS}
    job = None
    rec["t_start_ns"] = time.time_ns()
    try:
        job = _job_comm(world, jd)
        rec["cid"] = int(job.cid)
        if inflight is not None:
            # expose the job comm to the main loop so a deadline
            # ``revoke`` directive can poison it mid-collective
            inflight["comm"] = job
        serve._set_current(dict(jd))
        live.set_job(jd["id"])
        api.push_world(job)
        _exec_script(jd)
        _sync_device(job)
    except SystemExit as e:
        if e.code not in (0, None):
            rec["ok"] = False
            rec["error"] = f"job script exited rc={e.code}"
            _revoke_quietly(job)  # a nonzero exit aborts the gang too
    except _Stop:
        raise  # daemon-initiated stop outranks the job guard
    except BaseException as e:  # noqa: BLE001 — a job must never kill
        # the resident worker; MPIProcFailedError lands here too (the
        # daemon sees the dead rank and queues the repair directive)
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        _revoke_quietly(job)
    finally:
        if api.in_job_scope():
            api.pop_world()
        live.set_job(None)
        serve._set_current(None)
        if job is not None:
            try:
                job.free()
            except Exception:  # noqa: BLE001 — poisoned job comm
                pass
        # drop the job comm before the memory is read: its local mesh
        # holds per-card state of the job (on the devices layout the
        # shard ring's landing zones on every card), which must not be
        # counted as memory the next job inherits
        job = None
        if inflight is not None:
            inflight["comm"] = None
    rec["t_end_ns"] = time.time_ns()
    after = mcore.native_counters()
    rec["dials_after"] = {k: int(after.get(k, 0)) for k in _DIAL_KEYS}
    rec["counters"] = {k: int(after.get(k, 0)) for k in _REPORT_KEYS}
    rec["windows_left"] = _release_job_windows(world)
    rec.update(_device_memory(world))
    from ompi_tpu_torch.coll import cuda_kernels as _ck

    # the worker's first device, every local rank's, and its kernel
    # launches so far: none with one rank per process; the rows ring's
    # with several on the rows layout, the shard ring's (ring_hop_peer,
    # ring_hop_wait) on the devices layout
    rec["device"] = str(getattr(world, "device", ""))
    mesh = getattr(world, "local_mesh", None)
    rec["rank_devices"] = [str(d) for d in mesh.devices] if mesh is not None else []
    rec["launches"] = dict(_ck.LAUNCHES)
    link.report(idx, rec)


def _repair(api, world, link: DaemonLink, jd: dict, idx: int,
            timeout: float):
    """Survivor half of a repair directive: wait for the detector to
    surface every dead proc (gossip converges within a period), then
    ``replace()`` — the reborn incarnations rejoin through the beacon
    inside it — and adopt the healed world for future jobs."""
    dead = [int(d) for d in jd.get("dead", ())]
    dead_ranks = {r for p in dead for r in range(*world.proc_range(p))}
    t_settle = time.monotonic()
    deadline = t_settle + timeout
    while True:
        failed = set(world.get_failed())
        missing = [p for p in dead
                   if not (set(range(*world.proc_range(p))) & failed)]
        # wait for the failed set to SETTLE to exactly the directive's
        # dead procs: a false-positive mark on a live survivor (an
        # aborted job's recv-deadline escalation) self-heals within
        # about a heartbeat period, and entering replace() while it
        # stands would await a respawn that never comes
        if not missing and failed <= dead_ranks:
            break
        if time.monotonic() > deadline:
            if not missing:
                break  # extras never healed: best-effort repair
            err = (f"repair: procs {missing} never surfaced as failed "
                   f"within {timeout}s")
            link.report(idx, {"ok": False, "directive": idx,
                              "failed": sorted(failed), "error": err})
            print(f"serve: repair of directive {idx} failed (dead={dead}, "
                  f"failed={sorted(failed)}): {err}", flush=True)
            return world
        time.sleep(0.05)
    t0 = time.monotonic()
    # how long the failed set took to settle, and what it held then
    settle = {"settle_ms": round((t0 - t_settle) * 1e3, 3),
              "failed": sorted(failed)}
    rounds = world.procctx.replace_rounds
    first = len(rounds)
    try:
        healed = world.replace()
    except BaseException as e:  # noqa: BLE001 — repair must report
        if isinstance(e, _Stop):
            raise
        link.report(idx, {"ok": False, "directive": idx,
                          "rounds": rounds[first:], **settle,
                          "error": f"{type(e).__name__}: {e}"})
        print(f"serve: repair of directive {idx} failed (dead={dead}, "
              f"settle_ms={settle['settle_ms']}, "
              f"rounds={_rounds_text(rounds[first:])}): "
              f"{type(e).__name__}: {e}", flush=True)
        return world
    api.set_world(healed)
    heal_ms = round((time.monotonic() - t0) * 1e3, 3)
    link.report(idx, {"ok": True, "heal_ms": heal_ms, "directive": idx,
                      "rounds": rounds[first:], **settle})
    print(f"serve: repaired world (dead={dead}, heal_ms={heal_ms}, "
          f"directive={idx}, settle_ms={settle['settle_ms']}, "
          f"rounds={_rounds_text(rounds[first:])})", flush=True)
    return healed


def _rounds_text(rounds: list[dict]) -> str:
    """The replace rounds of one repair on a log line: each round's
    stream, its members as ``proc.incarnation`` and its milliseconds
    (``-`` while it never completed)."""
    return "[" + "; ".join(
        f"{r['stream']} "
        + ",".join(f"{m}.{i}" for m, i in zip(r["members"], r["incs"]))
        + f" {r.get('ms', '-')}ms" for r in rounds) + "]"


def _teardown_resident(api, world) -> None:
    """Raw teardown for a retired/stopped/orphaned rank (no finalize
    fence — the remaining ranks are not finalizing with us): the device
    plane closes first (its CUDA IPC windows and shm headers), then the
    FULL native engine teardown: ``tdcn_destroy`` frees every
    engine-owned allocation and joins the reader threads, so an
    operator ``kill`` never leaks a ``/dev/shm`` name or a reader."""
    from ompi_tpu_torch.metrics import live

    live.stop_publisher()
    root = None
    try:
        root = world.dcn._root_engine()
        plane = getattr(root, "_device_plane", None)
        if plane is not None:
            plane.close()
    except Exception:  # noqa: BLE001 — exiting anyway
        pass
    try:
        world.procctx.close()
    except Exception:  # noqa: BLE001 — exiting anyway
        pass
    try:
        destroy = getattr(root, "destroy", None)
        if destroy is not None:
            destroy()
    except Exception:  # noqa: BLE001 — exiting anyway
        pass


def main() -> int:
    # stdio through the daemon pipe must survive the daemon's death
    sys.stdout = _PipeSafe(sys.stdout)
    sys.stderr = _PipeSafe(sys.stderr)
    import ompi_tpu_torch.api as api
    from ompi_tpu_torch.boot.proc import ENV_DEVICE
    from ompi_tpu_torch.boot.proc import respawn_timeout as _respawn_timeout
    from ompi_tpu_torch.core import mca

    from ompi_tpu_torch import native

    # CUDA unless the daemon was asked for the CPU (``--cpu``); the
    # boot raises where there is no card — never a quiet CPU fallback.
    # The runtime's start and the world's bring-up (the card's context
    # with it) are timed: the first legs of the worker's first call
    device = os.environ.get(ENV_DEVICE) or "cuda"
    import torch

    if device.startswith("cuda") and torch.cuda.is_available():
        with native.first_use("cuda_init"):
            torch.cuda.init()
    with native.first_use("init"):
        world = api.init(device=device)
    ctx = world.procctx
    # warm compiled-schedule cache: the
    # process-wide plan store (ompi_tpu_torch/coll/sched.CACHE) lives exactly
    # as long as this resident worker — job 2's persistent collectives
    # of a job-1 signature replay already-compiled schedules, and its
    # hit/miss counters merge into the worker's native-counter exports
    # (the per-job completion records + /metrics scrapes above)
    from ompi_tpu_torch.coll import sched as _sched

    _sched.register_metrics_provider()
    store = mca.default_context().store
    poll = max(0.02, int(store.get("serve_poll_ms", 50) or 50) / 1000.0)
    # rsh-aware (ft_remote_respawn_timeout under OMPI_TPU_RSH), like
    # every other await-respawn deadline
    respawn_timeout = _respawn_timeout(store)
    link = DaemonLink(
        ctx, wsize=world.local_size, poll=poll,
        window=float(store.get("serve_reattach_timeout", 30.0) or 30.0))
    current = {"world": world}
    link.teardown = lambda: _teardown_resident(api, current["world"])
    try:
        signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:  # pragma: no cover - non-main thread (tests)
        pass
    try:
        return _serve_loop(api, ctx, link, current, respawn_timeout)
    except _Stop:
        # operator/daemon SIGTERM: the same exit hygiene as job
        # completion — partial export, flight record, engine destroy
        print("serve: SIGTERM — crash-path export + full engine "
              "teardown", flush=True)
        from ompi_tpu_torch.metrics import export as _mexport
        from ompi_tpu_torch.metrics import flight as _flight

        _flight.record("worker_sigterm", cursor=link.cursor)
        _mexport.crash_dump("sigterm")
        _teardown_resident(api, current["world"])
        return 143


def _serve_loop(api, ctx, link: DaemonLink, current: dict,
                respawn_timeout: float) -> int:
    world = current["world"]
    if getattr(world, "respawned", False):
        # reborn incarnation: rejoin the warm world via the survivors'
        # replace round, then resume the stream where the daemon says
        t0 = time.monotonic()
        try:
            world = world.replace()
        except Exception as e:
            print(f"serve: incarnation {ctx.incarnation} failed to rejoin "
                  f"(rounds={_rounds_text(ctx.replace_rounds)}): "
                  f"{type(e).__name__}: {e}", flush=True)
            raise
        heal_ms = round((time.monotonic() - t0) * 1e3, 3)
        api.set_world(world)
        current["world"] = world
        link.cursor = int(link.get(
            f"{K_RESUME}{ctx.proc}.i{ctx.incarnation}"))
        print(f"serve: incarnation {ctx.incarnation} rejoined; "
              f"resuming at directive {link.cursor} (heal_ms={heal_ms}, "
              f"rounds={_rounds_text(ctx.replace_rounds)})", flush=True)
    else:
        try:
            # cold-boot after a daemon restart that lost the whole
            # mesh: the daemon's start beacon skips this fresh worker
            # past the re-published pre-crash stream
            link.cursor = int(ctx.kvs.get(f"{K_START}{ctx.proc}",
                                          wait=False))
        except (KeyError, ConnectionError, OSError):
            pass
        from ompi_tpu_torch import native

        print(f"serve: resident worker up (proc {ctx.proc}/"
              f"{ctx.nprocs}, cursor {link.cursor}, first use "
              f"{json.dumps(native.FIRST_USE)})", flush=True)
    # concurrent serving plane: each admitted job runs on its OWN
    # thread so this loop keeps consuming directives mid-job — a
    # deadline ``revoke`` for the running gang, a ``repair`` for a
    # DISJOINT gang's dead rank (bystander-quiet: heals the base world
    # without touching the in-flight job), retire/shutdown.  A worker
    # proc is a member of at most one running gang at a time (the
    # daemon's scheduler books whole procs), so one inflight slot is
    # enough; the holder is written by both threads but every field
    # update is a single dict store under the GIL and both readers
    # tolerate staleness (a revoke for an already-finished job is a
    # no-op, a join on a finished thread returns immediately).
    inflight: dict = {"thread": None, "idx": None, "jd": None,
                      "comm": None}

    def _job_thread(jd: dict, idx: int, jworld) -> None:
        try:
            _run_job(api, jworld, link, jd, idx, inflight)
        finally:
            inflight["comm"] = None
            inflight["jd"] = None

    def _join_inflight() -> None:
        # called with NO locks held (the lockorder pass treats an
        # unbounded join under a lock as a blocking hazard)
        t = inflight["thread"]
        if t is not None:
            t.join()
        inflight["thread"] = None

    while True:
        idx, jd = link.wait_directive()
        kind = jd.get("kind", "job")
        if kind == "shutdown":
            _join_inflight()  # full-house finalize fences all ranks
            if len(jd.get("procs", ())) == ctx.nprocs:
                api.finalize()  # full house: the real fence + teardown
            else:
                _teardown_resident(api, world)
            print("serve: shutdown", flush=True)
            return 0
        if kind == "revoke":
            # deadline escalation (serve_job_deadline_s): poison the
            # named in-flight job's comm so its gang wakes out of any
            # parked collective with MPIRevokedError — never a wedged
            # gang — while concurrent disjoint gangs stay untouched
            if ctx.proc in jd.get("procs", ()):
                cur = inflight["jd"]
                ack = {"ok": True, "revoked": jd.get("id")}
                from ompi_tpu_torch.trace import waitgraph as _waitgraph

                if _waitgraph._enabled:
                    if _waitgraph.busy():
                        # last look at this rank's blocked state before
                        # the poison wakes it (the waits unregister on
                        # wake-up — evidence for the hang report)
                        ack["waits"] = _waitgraph.snapshot()
                        from ompi_tpu_torch.metrics import export as _mexp

                        # post-mortem leg: flush configured telemetry
                        # NOW, blocked state included, so trace_report
                        # --hangs can diagnose from the crash export
                        # after the gang is gone
                        _mexp.crash_dump("deadline_revoke")
                if cur is not None and cur.get("id") == jd.get("id"):
                    print(f"serve: revoking job {jd.get('id')} "
                          "(deadline)", flush=True)
                    _revoke_quietly(inflight["comm"])
                link.report(idx, ack)
            continue
        if kind == "repair":
            if ctx.proc in jd.get("procs", ()):
                cur = inflight["jd"]
                if cur is not None and (set(int(d) for d in
                                            jd.get("dead", ()))
                                        & set(int(p) for p in
                                              cur.get("procs", ()))):
                    # the in-flight gang lost a member: its script is
                    # failing on the dead rank right now — let it close
                    # out (revoke + completion record) before healing
                    # the base world under it
                    _join_inflight()
                # bystander-quiet: a disjoint gang's job thread keeps
                # running on its sub-comm while the base world heals
                world = _repair(api, world, link, jd, idx,
                                respawn_timeout)
                current["world"] = world
            continue
        if kind == "retire":
            if ctx.proc in jd.get("retire", ()):
                _join_inflight()
                link.report(idx, {"ok": True, "retired": True})
                _teardown_resident(api, world)
                print("serve: retired", flush=True)
                return 0
            if ctx.proc in jd.get("procs", ()):
                link.report(idx, {"ok": True})
            continue
        if ctx.proc in jd.get("procs", ()):
            _join_inflight()  # defensive: scheduler never double-books
            world = current["world"]
            inflight["idx"], inflight["jd"] = idx, jd
            inflight["comm"] = None
            t = threading.Thread(target=_job_thread,
                                 args=(jd, idx, world),
                                 name=f"serve-job-{jd['id']}",
                                 daemon=True)
            inflight["thread"] = t
            t.start()


if __name__ == "__main__":
    sys.exit(main())

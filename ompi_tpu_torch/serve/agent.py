"""Per-host launch agent — the daemon's remote arm (≈ prted under
``prte``: the DVM member that owns one host's processes).

``tpurun --daemon`` with a host map spawns ONE agent per remote host
over the plm/rsh leg (the same ``--launch-agent`` template a plain
rsh job uses).  The agent owns everything that requires a shared pid
namespace with the workers — exactly what the daemon physically
cannot do across hosts (``kill 0`` / ``_AdoptedProc`` are local-only):

* **spawn/respawn**: the daemon publishes commands on a per-session
  KVS stream (``serve.agent.cmd.<session>.<hid>.<n>``); the agent
  consumes them strictly in order and acks each
  (``serve.agent.ack.<session>.<hid>.<n>`` carries the worker pid) —
  spawn, adopt (agent restart with live workers), kill, stop;
* **pid liveness**: the agent polls its workers and reports their
  state in a periodic heartbeat record (``serve.agent.hb.<hid>``);
  the daemon's monitor reads worker death, respawn progress, and
  agent health from it — per-host agent health is one row of the
  daemon's ``/json`` state;
* **stdio**: worker output pipes into the agent, which forwards it
  (rank-prefixed) up its own rsh pipe to the daemon's iof.

**Daemon crash-safety** (the agent half, mirroring the worker's
:class:`~ompi_tpu_torch.serve.worker.DaemonLink`): the control channel is
the daemon's KVS, so a daemon SIGKILL severs it.  The agent keeps its
workers running (they serve the in-flight job worker-to-worker),
parks on the pidfile for a restarted daemon at a higher generation,
re-dials its KVS, offers ``serve.agent.adopt.<hid>`` (current worker
table included), awaits the ack — which names the NEW command
session — and resumes.  No restarted daemon within the window: the
agent exits; the workers self-terminate through their own re-attach
expiry (no orphans, ever).

An agent that itself dies (host failure takes workers AND agent) is
respawned by the daemon over rsh with the last-known worker table
baked into its environment: the reborn agent probes those pids and
**re-adopts the still-live workers** (agent-only death) or reports
them dead so the daemon drives the normal respawn+repair leg (whole-
host death).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time

from ompi_tpu_torch.boot.kvs import KVSClient
from ompi_tpu_torch.boot.proc import ENV_DEVICE, ENV_INCARNATION, ENV_KVS, ENV_NPROCS
from ompi_tpu_torch.faultsim import core as _fsim
from . import state as _state
from .worker import ENV_SERVE_PIDFILE, _PipeSafe, reaim_stdio

#: KVS key prefixes of the agent protocol (daemon mirrors these)
K_AHB = "serve.agent.hb."        # + <hid>               → heartbeat
K_ACMD = "serve.agent.cmd."      # + <session>.<hid>.<n> → command
K_AACK = "serve.agent.ack."      # + <session>.<hid>.<n> → ack
K_AADOPT = "serve.agent.adopt."  # + <hid>               → adoption offer
K_AADOPTED = "serve.agent.adopted."  # + <hid>           → daemon's ack
K_PIDFILE = "serve.pidfile."     # + <generation>  → pidfile-record
#: beacon (keep in sync with serve/daemon.py): the daemon mirrors its
#: pidfile record into the KVS so agents on hosts WITHOUT the daemon's
#: filesystem can copy it to their local pidfile path — the real-remote
#: re-attach channel (workers there poll the local copy as usual)
K_ASESSION = "serve.agent.session."  # + <hid> → the daemon's CURRENT
#: command session for the host — the supersession fence: an agent
#: whose session no longer matches was given up on (wedged past
#: serve_agent_timeout) and replaced; it must exit instead of
#: un-wedging later and executing its old session's spawn commands
#: (a double-spawned rank)

#: agent-side environment (daemon bakes these into the rsh payload —
#: all OMPI_TPU_-prefixed so _remote_cmd carries them)
ENV_AGENT_HOST = "OMPI_TPU_AGENT_HOST"        # host index
ENV_AGENT_RANKS = "OMPI_TPU_AGENT_RANKS"      # comma rank list
ENV_AGENT_SESSION = "OMPI_TPU_AGENT_SESSION"  # command-stream session
ENV_AGENT_ADOPT = "OMPI_TPU_AGENT_ADOPT"      # r:pid:inc,... last known


def _parse_adopt(raw: str) -> dict[int, tuple[int, int]]:
    """``rank:pid:incarnation,...`` → {rank: (pid, incarnation)}."""
    out: dict[int, tuple[int, int]] = {}
    for part in (raw or "").split(","):
        bits = part.split(":")
        if len(bits) == 3:
            try:
                out[int(bits[0])] = (int(bits[1]), int(bits[2]))
            except ValueError:
                continue
    return out


class _Worker:
    """One owned rank: a Popen child, or an adopted bare pid (agent
    restart found it alive)."""

    def __init__(self, rank: int, incarnation: int,
                 proc: subprocess.Popen | None = None, pid: int = 0):
        self.rank = int(rank)
        self.incarnation = int(incarnation)
        self.proc = proc
        self.pid = int(proc.pid if proc is not None else pid)
        self.rc: int | None = None

    def poll(self) -> int | None:
        if self.rc is not None:
            return self.rc
        if self.proc is not None:
            rc = self.proc.poll()
            if rc is not None:
                self.rc = int(rc)
        elif not _state.pid_alive(self.pid):
            # adopted (non-child): the real code reaped to init — a
            # synthetic nonzero is all the respawn machinery needs
            self.rc = 1
        return self.rc

    def signal(self, sig: int) -> None:
        try:
            os.kill(self.pid, sig)
        except OSError:
            pass


class LaunchAgent:
    """The per-host agent process body (``python -m
    ompi_tpu_torch.serve.agent``)."""

    def __init__(self) -> None:
        self.hid = int(os.environ[ENV_AGENT_HOST])
        self.np = int(os.environ[ENV_NPROCS])
        self.ranks = [int(r) for r in
                      os.environ[ENV_AGENT_RANKS].split(",") if r]
        self.session = os.environ.get(ENV_AGENT_SESSION, "g1s0")
        self.pidfile = os.environ.get(ENV_SERVE_PIDFILE, "")
        info = (_state.read_pidfile(self.pidfile)
                if self.pidfile else None)
        self.generation = int((info or {}).get("generation", 0))
        self.kvs_addr = os.environ[ENV_KVS]
        self.kvs = KVSClient(self.kvs_addr)
        self.cursor = 0
        self.cmds_done = 0
        #: executed-but-unacked command results awaiting a KVS re-put
        #: (see _consume/_flush_acks)
        self._ack_backlog: list[tuple[str, str, dict]] = []
        self.workers: dict[int, _Worker] = {}
        self._threads: list[threading.Thread] = []
        self._stop = False
        # knobs (resolved from the inherited OMPI_MCA_* environment —
        # the agent has no --mca line of its own).  They are all central
        # variables, so a bare context resolves them without loading the
        # components — which would import torch: seconds of boot that
        # count against serve_agent_timeout before the first heartbeat
        from ompi_tpu_torch.core.registry import MCAContext

        store = MCAContext().store
        self.poll = max(0.02, int(
            store.get("serve_agent_poll_ms", 50) or 50) / 1000.0)
        self.hb_interval = max(0.05, int(
            store.get("serve_agent_hb_ms", 500) or 500) / 1000.0)
        self.window = float(
            store.get("serve_reattach_timeout", 30.0) or 30.0)
        if bool(store.get("faultsim_enable", False)):
            # deterministic agent chaos (agentkill:at=N, site "agent"):
            # one seed replays one agent-death schedule; the proc key
            # offsets by host so two agents under one seed diverge
            _fsim.configure(str(store.get("faultsim_plan", "") or ""),
                            seed=int(store.get("faultsim_seed", 0) or 0),
                            proc=1000 + self.hid)
        # agent restart with a last-known worker table: adopt the
        # still-live pids, report the dead ones in the heartbeat (the
        # daemon drives their respawn through normal commands)
        for r, (pid, inc) in _parse_adopt(
                os.environ.get(ENV_AGENT_ADOPT, "")).items():
            if r not in self.ranks or pid <= 0:
                continue
            w = _Worker(r, inc, pid=pid)
            if not _state.pid_alive(pid):
                w.rc = 1
            else:
                print(f"agent h{self.hid}: re-adopted worker rank {r} "
                      f"(pid {pid})", flush=True)
            self.workers[r] = w

    # -- worker lifecycle ------------------------------------------------

    def _spawn_worker(self, rank: int, incarnation: int,
                      telemetry: str | None = None) -> _Worker:
        from ompi_tpu_torch.boot.tpurun import _forward, worker_env

        # telemetry ingest address from the COMMAND, not the inherited
        # env: after a daemon restart the agent's environment still
        # names the dead predecessor's ingest port, and a worker born
        # pointing there would publish into the void forever.  The
        # daemon's CPU switch rides the agent's own environment (set
        # only when the daemon was started with --cpu): hand it on
        env = worker_env(rank, self.np, self.kvs_addr,
                         telemetry_addr=telemetry,
                         cpu=os.environ.get(ENV_DEVICE) == "cpu")
        if incarnation:
            env[ENV_INCARNATION] = str(incarnation)
        p = subprocess.Popen(
            [sys.executable, "-m", "ompi_tpu_torch.serve.worker"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

        def _fwd(stream=p.stdout, prefix=str(rank)):
            try:
                _forward(stream, prefix, sys.stdout.buffer)
            except (OSError, ValueError):
                pass  # daemon pipe died: the worker re-aims itself

        t = threading.Thread(target=_fwd, daemon=True)
        t.start()
        self._threads.append(t)
        print(f"agent h{self.hid}: spawned rank {rank} pid {p.pid} "
              f"(incarnation {incarnation})", flush=True)
        return _Worker(rank, incarnation, proc=p)

    def _worker_table(self) -> dict:
        out = {}
        for r, w in self.workers.items():
            rc = w.poll()
            out[str(r)] = {"pid": w.pid, "incarnation": w.incarnation,
                           "alive": rc is None,
                           "rc": rc if rc is not None else 0}
        return out

    # -- control channel -------------------------------------------------

    def _beacon_gen(self) -> int:
        """The generation this agent's command session was minted
        under (``g<gen>s<n>``) — more reliable than the local pidfile
        copy, which may not exist yet on a host that shares no
        filesystem with the daemon."""
        try:
            return int(self.session.lstrip("g").split("s", 1)[0])
        except ValueError:
            return self.generation

    def _mirror_beacon(self) -> None:
        """Real-remote re-attach channel: copy the daemon's pidfile-
        record beacon (``serve.pidfile.<generation>``) to THIS host's
        pidfile path, so the workers here — and this agent itself —
        re-attach through the ordinary local pidfile poll without ever
        reading daemon-local disk.  A reborn agent (respawned over rsh
        by a restarted daemon, new KVS address in its env) mirrors the
        NEW record, which is how parked workers on the host learn the
        restarted daemon's address.  Beacon absent (older daemon):
        no-op — the plain pidfile poll stands.  On a shared
        filesystem the mirror compares equal and never writes."""
        if not self.pidfile:
            return
        gen = max(self._beacon_gen(), self.generation)
        try:
            rec = self.kvs.get(f"{K_PIDFILE}{gen}", wait=False)
        except KeyError:
            return
        if not isinstance(rec, dict):
            return
        if _state.read_pidfile(self.pidfile) != rec:
            try:
                _state.write_pidfile(self.pidfile, dict(rec))
                self.generation = int(rec.get("generation", gen))
                print(f"agent h{self.hid}: mirrored daemon pidfile "
                      f"beacon (generation {self.generation}) to "
                      f"{self.pidfile}", flush=True)
            except OSError:
                pass  # unwritable path: the poll fallback stands

    def _fence(self) -> None:
        """Supersession fence: a daemon that rotated this host's
        session replaced us — an agent that was slow or wedged past
        serve_agent_timeout must NOT go on to execute its old session's
        commands (the replacement already re-issued them: a spawn run
        here too is a second live process of the rank)."""
        try:
            current = self.kvs.get(f"{K_ASESSION}{self.hid}",
                                   wait=False)
        except KeyError:
            current = None
        if current is not None and str(current) != self.session:
            print(f"agent h{self.hid}: superseded (daemon session "
                  f"{current} != mine {self.session}); exiting — "
                  "live workers stay for the replacement's adoption",
                  flush=True)
            raise SystemExit(0)

    def _hb(self) -> None:
        self._fence()
        self.kvs.put(f"{K_AHB}{self.hid}", {
            "pid": os.getpid(), "host": self.hid,
            "generation": self.generation, "session": self.session,
            "ts_ns": time.time_ns(), "cmds_done": self.cmds_done,
            "workers": self._worker_table()})
        # heartbeat cadence keeps the local pidfile mirror fresh (a
        # just-adopted agent re-mirrors under its new generation)
        self._mirror_beacon()

    def _exec(self, cmd: dict) -> dict:
        if _fsim._enabled:
            for _r in _fsim.actions("agent", kinds={"agentkill"}):
                print(f"agent h{self.hid}: faultsim: injected agent "
                      "kill (agentkill)", flush=True)
                sys.stdout.flush()
                os.kill(os.getpid(), signal.SIGKILL)
        kind = cmd.get("kind")
        if kind == "spawn":
            r, inc = int(cmd["rank"]), int(cmd.get("incarnation", 0))
            w = self.workers.get(r)
            if w is not None and w.incarnation == inc \
                    and w.poll() is None:
                # idempotent: the daemon re-issues unacked spawn
                # commands after an agent reattach/respawn — a worker
                # already running at this incarnation must be ACKED,
                # not double-spawned (the first process would be
                # orphaned outside every workers table)
                return {"ok": True, "rank": r, "pid": w.pid,
                        "incarnation": inc}
            self.workers[r] = self._spawn_worker(
                r, inc, telemetry=cmd.get("telemetry"))
            return {"ok": True, "rank": r, "pid": self.workers[r].pid,
                    "incarnation": inc}
        if kind == "adopt":
            r = int(cmd["rank"])
            pid = int(cmd.get("pid", 0))
            inc = int(cmd.get("incarnation", 0))
            w = _Worker(r, inc, pid=pid)
            if pid <= 0 or not _state.pid_alive(pid):
                w.rc = 1
            self.workers[r] = w
            return {"ok": True, "rank": r, "pid": pid,
                    "alive": w.rc is None}
        if kind == "kill":
            r = int(cmd["rank"])
            w = self.workers.get(r)
            if w is not None:
                w.signal(int(cmd.get("sig", signal.SIGTERM)))
            return {"ok": True, "rank": r}
        if kind == "stop":
            self._stop = True
            return {"ok": True}
        return {"ok": False, "error": f"unknown agent command {kind!r}"}

    def _consume(self) -> bool:
        """One command, if pending (non-blocking).  True = consumed."""
        key = f"{K_ACMD}{self.session}.{self.hid}.{self.cursor}"
        try:
            cmd = self.kvs.get(key, wait=False)
        except KeyError:
            return False
        # the fence before every command, not only at heartbeat
        # cadence: an agent whose boot outlasted serve_agent_timeout
        # finds its first spawn command waiting and would run it before
        # its first heartbeat looked at the session
        self._fence()
        idx, self.cursor = self.cursor, self.cursor + 1
        try:
            ack = self._exec(dict(cmd))
        except Exception as e:  # noqa: BLE001 — an execution failure
            # (fork EAGAIN/ENOMEM...) must ACK a failure, not bubble
            # into the run loop's KVS-loss handler: the cursor already
            # advanced, and an un-acked spawn would wedge its rank
            # "alive with no process" forever — the failure ack routes
            # it down the daemon's bounded respawn leg instead
            ack = {"ok": False, "rank": cmd.get("rank"),
                   "error": f"{type(e).__name__}: {e}"}
        self.cmds_done += 1
        # ack-after-exec: a KVS loss here must not drop the ack (the
        # command already ran — an unacked executed spawn would be
        # re-issued into the next session; the idempotent-spawn guard
        # covers re-issues to THIS process, the replay covers the
        # transient-put case).  Parked acks flush at the loop top;
        # a session change discards them (the daemon re-issues).
        self._ack_backlog.append(
            (self.session, f"{K_AACK}{self.session}.{self.hid}.{idx}",
             ack))
        self._flush_acks()
        return True

    def _flush_acks(self) -> None:
        while self._ack_backlog:
            session, key, ack = self._ack_backlog[0]
            if session != self.session:
                self._ack_backlog.pop(0)  # dead session: superseded
                continue
            self.kvs.put(key, ack)  # ConnectionError → reattach path
            self._ack_backlog.pop(0)

    # -- crash → re-attach (daemon restart) ------------------------------

    def _reaim_logs(self, info: dict) -> None:
        """Per-agent stdio re-aim after a daemon restart: the
        worker's re-attach protocol, aimed at the per-agent log file
        named by the restarted daemon's pidfile record, so post-
        reattach spawn/heartbeat/adoption output is durable."""
        reaim_stdio(str((info or {}).get("logs") or ""),
                    f"agent.h{self.hid}.log", f"agent h{self.hid}")

    def _reattach(self) -> None:
        if not self.pidfile:
            print(f"agent h{self.hid}: daemon gone and no pidfile; "
                  "exiting (workers self-terminate through their own "
                  "re-attach windows)", flush=True)
            raise SystemExit(0)
        deadline = time.monotonic() + self.window
        print(f"agent h{self.hid}: daemon lost; parking up to "
              f"{self.window:.0f}s on {self.pidfile}", flush=True)
        while True:
            info = _state.read_pidfile(self.pidfile)
            alive = bool(info) and _state.pid_alive(
                int(info.get("pid", 0)))
            # skip a restarting daemon's provisional claim record (no
            # KVS yet, predecessor's generation) — same hazard as the
            # worker's park loop: KeyError('kvs') killed the agent
            ready = alive and _state.pidfile_ready(info)
            gen = int((info or {}).get("generation", 0))
            if ready and gen == self.generation:
                try:
                    self.kvs.reconnect(info["kvs"])
                    self.kvs_addr = info["kvs"]
                    print(f"agent h{self.hid}: KVS re-dialed (daemon "
                          "alive)", flush=True)
                    return
                except OSError:
                    pass
            elif ready and gen > self.generation:
                try:
                    self.kvs.reconnect(info["kvs"])
                    self.kvs_addr = info["kvs"]
                    self.kvs.put(f"{K_AADOPT}{self.hid}", {
                        "pid": os.getpid(), "host": self.hid,
                        "generation": gen,
                        "workers": self._worker_table()})
                    t0 = time.monotonic()
                    while time.monotonic() - t0 < 10.0:
                        try:
                            ack = self.kvs.get(
                                f"{K_AADOPTED}{self.hid}", wait=False)
                        except KeyError:
                            ack = None
                        if (ack and int(ack.get("pid", -1))
                                == os.getpid()
                                and int(ack.get("generation", 0))
                                == gen):
                            self.generation = gen
                            self.session = str(
                                ack.get("session", f"g{gen}s0"))
                            self.cursor = 0
                            # the predecessor's rsh pipe died with it:
                            # make post-adoption output durable
                            self._reaim_logs(info)
                            print(f"agent h{self.hid}: re-attached to "
                                  f"daemon generation {gen} (session "
                                  f"{self.session})", flush=True)
                            return
                        time.sleep(0.05)
                except (OSError, ConnectionError):
                    pass
            if time.monotonic() > deadline:
                print(f"agent h{self.hid}: no restarted daemon within "
                      f"{self.window:.0f}s; exiting", flush=True)
                raise SystemExit(0)
            time.sleep(0.25)

    # -- main loop -------------------------------------------------------

    def run(self) -> int:
        print(f"agent h{self.hid}: up (pid {os.getpid()}, ranks "
              f"{self.ranks}, session {self.session})", flush=True)
        last_hb = 0.0
        while True:
            try:
                self._flush_acks()
                progressed = self._consume()
                now = time.monotonic()
                if now - last_hb >= self.hb_interval:
                    self._hb()
                    last_hb = now
            except (ConnectionError, OSError):
                self._reattach()
                last_hb = 0.0
                continue
            if self._stop:
                break
            if not progressed:
                time.sleep(self.poll)
        # stop: SIGTERM the remaining workers, give them a bounded
        # window for their own exit hygiene, then make sure (the
        # no-orphans contract is the agent's on this host)
        live = [w for w in self.workers.values() if w.poll() is None]
        for w in live:
            w.signal(signal.SIGTERM)
        deadline = time.monotonic() + 10.0
        for w in live:
            while w.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if w.poll() is None:
                w.signal(signal.SIGKILL)
        try:
            self._hb()  # final state for the daemon's shutdown sweep
        except (ConnectionError, OSError):
            pass
        print(f"agent h{self.hid}: stopped", flush=True)
        return 0


def main() -> int:
    # the agent's stdout rides the rsh pipe into the daemon — writes
    # must survive a SIGKILLed daemon exactly like a worker's
    sys.stdout = _PipeSafe(sys.stdout)
    sys.stderr = _PipeSafe(sys.stderr)
    return LaunchAgent().run()


if __name__ == "__main__":
    sys.exit(main())

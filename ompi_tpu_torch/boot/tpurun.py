"""``tpurun`` — the job launcher (mpirun/prterun-equivalent).

≈ the reference's launch path (SURVEY.md §3.1): ``mpirun`` parses the
schizo/ompi CLI (``-np``, ``--mca k v``), hosts the PMIx server, maps
ranks, forks workers, forwards their stdio, tracks job state, and kills
the job on first failure (errmgr default).  Here:

* KVS server in the launcher process (≈ mpirun's embedded PMIx server);
* local fork of N worker processes (``plm`` ≈ odls fork/exec; remote
  nodes would add an ssh leg — single-host in this environment);
* ``--mca`` params propagated via ``OMPI_MCA_*`` env
  (≈ mca_base_var_build_env);
* stdio forwarding with ``[rank]`` prefixes (≈ iof);
* first nonzero exit → terminate the job, propagate the code;
* at the end of the job, the shared-memory names that dead workers left
  behind (the C engine's rings and doorbells, the Python sm rings, the
  device plane's windows: each carries its creator's pid) are unlinked —
  a worker killed by the launcher or a signal never runs its own
  cleanup;
* with ``--mca telemetry_enable 1`` the launcher hosts the live
  telemetry aggregator (:mod:`ompi_tpu_torch.metrics.live`): workers
  stream frames to it and ``/metrics``, ``/json``, ``/history``,
  ``/critical`` and ``/waitgraph`` answer while the job runs;
* ``--daemon`` starts the persistent serving daemon instead of one job
  (:func:`ompi_tpu_torch.serve.daemon.run_daemon`).

Usage::

    python -m ompi_tpu_torch run -np 4 [--mca k v ...] [--nranks K] [--cpu] script.py [args...]
    python -m ompi_tpu_torch run --daemon -np 2 [--nranks K] [--cpu] [--mca k v ...]

Port of ``ompi_tpu/boot/tpurun.py``.  The reference's ``--cpu-devices
K`` (which set ``XLA_FLAGS`` and ``JAX_PLATFORMS=cpu``) does two jobs
that the port splits: ``--nranks K`` sets each worker's
``accelerator_cuda_nranks``, the number of virtual ranks — rows of the
process's rank-major tensors — on the process's device, and ``--cpu``
sets ``OMPI_TPU_DEVICE=cpu`` so the workers run on the CPU.  Without
``--cpu`` a worker runs on CUDA and raises where there is none (a
script may still pass ``api.init(device="cpu")`` itself).
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import threading

from .kvs import KVSServer
from .proc import (ENV_DEVICE, ENV_HOST_IDS, ENV_INCARNATION, ENV_KVS,
                   ENV_NPROCS, ENV_PROC, ENV_RSH)


def _forward(stream, prefix: str, out) -> None:
    for line in iter(stream.readline, b""):
        out.write(f"[{prefix}] ".encode() + line)
        out.flush()


#: env keys reproduced on the remote side of an rsh launch
_REMOTE_ENV_KEYS = ("PYTHONPATH",)


def _final_cmd(launch_agent: str, cmd: list[str], env: dict,
               target: str | None) -> list[str]:
    """The command actually executed for one rank (re-evaluated on
    every respawn: the rsh payload bakes the env exports into the
    command string, so a reborn remote rank must rebuild it or lose
    the bumped OMPI_TPU_INCARNATION)."""
    if target is not None and not _is_local_host(target):
        keys = sorted(
            k for k in env
            if k.startswith(("OMPI_TPU_", "OMPI_MCA_"))
            or k in _REMOTE_ENV_KEYS
        )
        return _remote_cmd(launch_agent, target, env, keys, cmd)
    return cmd


def _truthy(v) -> bool:
    """MCA-style bool for launcher-side flags — the workers' VarStore
    accepts exactly this string set, so the launcher-side gate cannot
    drift from the worker-side parse."""
    from ompi_tpu_torch.core.var import _TRUE_STRINGS

    return str(v or "").strip().lower() in _TRUE_STRINGS


def worker_cmd(argv: list[str]) -> list[str]:
    """The per-rank exec vector: native executables (compiled against
    libtpumpi) run directly; .py scripts go through the interpreter.
    Absolute path for executables: a bare filename would hit execvp
    PATH lookup instead of the file we just stat'ed."""
    first = argv[0]
    if first.endswith(".py") or not (
        os.path.isfile(first) and os.access(first, os.X_OK)
    ):
        return [sys.executable] + argv
    return [os.path.abspath(first)] + argv[1:]


def worker_env(rank: int, np_: int, kvs_address: str,
               mca: dict[str, str] | None = None,
               nranks: int | None = None,
               extra_env: dict[str, str] | None = None,
               telemetry_addr: str | None = None,
               cpu: bool = False) -> dict[str, str]:
    """One rank's environment (shared by ``run_job``, the tpud daemon's
    resident-worker spawn and its launch agents): framework on
    PYTHONPATH (≈ mpirun's LD_LIBRARY_PATH forwarding for libmpi),
    the launcher's ``sys.path`` for a compiled C rank's embedded
    interpreter (``TPUMPI_SYS_PATH``), rank/size/rendezvous
    coordinates, the telemetry ingest address,
    ``--mca`` params as ``OMPI_MCA_*``, the virtual rank count
    (``accelerator_cuda_nranks``) and, with ``cpu``, the CPU switch
    (``OMPI_TPU_DEVICE=cpu``).  The switch is never inherited from the
    caller's environment: ``cpu`` is the only way a worker gets it."""
    import ompi_tpu_torch

    pkg_root = os.path.dirname(
        os.path.dirname(os.path.abspath(ompi_tpu_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = pkg_root + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
    )
    # a compiled C rank embeds the interpreter, which would not see a
    # virtual environment's site-packages: the shim puts the launcher's
    # sys.path first, so it imports the same torch as the launcher
    env["TPUMPI_SYS_PATH"] = ":".join(p for p in sys.path if p)
    env[ENV_PROC] = str(rank)
    env[ENV_NPROCS] = str(np_)
    env[ENV_KVS] = kvs_address
    if telemetry_addr:
        from ompi_tpu_torch.metrics.live import ENV_TELEMETRY

        env[ENV_TELEMETRY] = telemetry_addr
    for k, v in (mca or {}).items():
        env[f"OMPI_MCA_{k}"] = v
    if nranks is not None:
        env["OMPI_MCA_accelerator_cuda_nranks"] = str(int(nranks))
    if cpu:
        env[ENV_DEVICE] = "cpu"
    else:
        env.pop(ENV_DEVICE, None)
    env.update(extra_env or {})
    return env


#: host names the plm treats as THIS machine (fork instead of rsh)
_LOCAL_NAMES = {"localhost", "127.0.0.1"}


def _is_local_host(name: str) -> bool:
    import socket as _socket

    return name in _LOCAL_NAMES or name == _socket.gethostname()


def _remote_cmd(agent: str, host: str, env: dict, keys: list[str],
                cmd: list[str]) -> list[str]:
    """plm/rsh command line: the launch agent template (default
    ``ssh {host} {cmd}``) wrapping an env-exporting sh -c payload —
    the reference's rsh tree-launch collapsed to one level (no daemon
    on the remote side; workers dial the KVS directly, exactly like
    the local fork leg)."""
    import shlex

    exports = " ".join(
        f"{k}={shlex.quote(env[k])}" for k in keys if k in env
    )
    payload = f"cd {shlex.quote(os.getcwd())} && env {exports} " + " ".join(
        shlex.quote(c) for c in cmd
    )
    out = []
    used_cmd = False
    for tok in shlex.split(agent):
        if tok == "{host}":
            out.append(host)
        elif tok == "{cmd}":
            out.append(payload)
            used_cmd = True
        else:
            out.append(tok)
    if not used_cmd:
        out.append(payload)
    return out


def run_job(
    np_: int,
    argv: list[str],
    mca: dict[str, str] | None = None,
    nranks: int | None = None,
    extra_env: dict[str, str] | None = None,
    ft: bool = False,
    hosts: list[tuple[str, int]] | None = None,
    map_by: str = "slot",
    launch_agent: str = "ssh {host} {cmd}",
    oversubscribe: bool = False,
    display_map: bool = False,
    kvs_host: str | None = None,
    respawn: bool = False,
    max_respawns: int = 2,
    cpu: bool = False,
) -> int:
    """``ft=True`` ≈ ``mpirun --with-ft ulfm``: worker death does NOT
    kill the job (survivors run ULFM recovery); the heartbeat detector
    is enabled in every worker and the job's exit code is rank 0's.

    ``respawn=True`` (requires ``ft``) adds the PRRTE restart leg: a
    worker that dies is relaunched with the same rank and environment
    under a bumped ``OMPI_TPU_INCARNATION`` (at most ``max_respawns``
    times per rank).  The reborn process replays the boot rendezvous —
    re-publishing its endpoint under the new incarnation — and the
    survivors' ``replace()`` rebuilds the communicator at full size.

    ``hosts`` engages the plm/rsh leg: ranks map onto the allocation
    via the rmaps policy (``map_by``); non-local hosts launch through
    ``launch_agent`` (``ssh {host} {cmd}``; any template works — e.g.
    ``bash -c {cmd}`` exercises the full rsh path against this host).
    ``kvs_host``: address the KVS server binds/advertises (must be
    reachable from every host; default loopback is single-host only).
    """
    if ft:
        mca = dict(mca or {})
        mca.setdefault("ft_detector_enable", "1")
    if respawn and not ft:
        raise SystemExit("tpurun: --respawn requires --ft (a non-FT job "
                         "kills the world on first failure)")
    rank_host: list[str] | None = None
    if hosts:
        from .rmaps import map_ranks, render_map

        rank_host = map_ranks(hosts, np_, policy=map_by,
                              oversubscribe=oversubscribe)
        if display_map:
            print(render_map(rank_host), flush=True)
        if kvs_host is None and any(
            not _is_local_host(h) for h in rank_host
        ):
            raise SystemExit(
                "tpurun: remote hosts in the map but no --kvs-host — the "
                "rendezvous server would advertise 127.0.0.1, unreachable "
                "from the remote side; pass --kvs-host <routable address>"
            )
    server = KVSServer(host=kvs_host or "127.0.0.1")
    # live telemetry plane (--mca telemetry_enable 1): the launcher
    # hosts the aggregator — workers stream counter/straggler frames
    # to its ingest socket (address via env) and anything can scrape
    # the job MID-RUN at the printed HTTP endpoint
    telemetry = None
    env_all = os.environ
    if _truthy((mca or {}).get("telemetry_enable")
               or env_all.get("OMPI_MCA_telemetry_enable")):
        from ompi_tpu_torch.metrics.live import TelemetryAggregator

        telemetry = TelemetryAggregator(
            http_port=int((mca or {}).get("telemetry_port")
                          or env_all.get("OMPI_MCA_telemetry_port")
                          or 0),
            history=int((mca or {}).get("telemetry_history")
                        or env_all.get("OMPI_MCA_telemetry_history")
                        or 256),
        )
        print(f"[tpurun] telemetry: {telemetry.url}/metrics "
              f"(json: {telemetry.url}/json, critical: "
              f"{telemetry.url}/critical, waitgraph: "
              f"{telemetry.url}/waitgraph)", flush=True)
    procs: list[subprocess.Popen] = []
    threads: list[threading.Thread] = []
    #: per-rank (cmd, env, target host) for the --respawn restart leg
    launch_specs: list[tuple[list[str], dict[str, str], str | None]] = []
    #: every worker pid this job started (respawns included)
    spawned: list[int] = []

    def spawn_rank(rank: int, cmd: list[str], env: dict,
                   target: str | None) -> subprocess.Popen:
        """One rank's process + stdio-forward thread (shared by first
        launch and the --respawn restart leg)."""
        p = subprocess.Popen(
            _final_cmd(launch_agent, cmd, env, target),
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        t = threading.Thread(
            target=_forward, args=(p.stdout, str(rank), sys.stdout.buffer),
            daemon=True,
        )
        t.start()
        threads.append(t)
        spawned.append(p.pid)
        return p
    # rsh leg marker: ranks mapped onto remote hosts switch every
    # await-respawn deadline to ft_remote_respawn_timeout (a remote
    # relaunch pays the launch-agent round-trip; the env key is
    # OMPI_TPU_-prefixed, so _remote_cmd bakes it into the payload)
    rsh_job = bool(rank_host) and any(
        not _is_local_host(h) for h in rank_host)
    # rank→host map for the workers: detector groups, the sharded
    # modex, and the telemetry relays partition by REAL host when the
    # launcher knows one (the env key is OMPI_TPU_-prefixed so the rsh
    # payload carries it to remote ranks)
    host_ids = ""
    if rank_host:
        order: dict[str, int] = {}
        for h in rank_host:
            order.setdefault(h, len(order))
        host_ids = ",".join(str(order[h]) for h in rank_host)
    try:
        for rank in range(np_):
            env = worker_env(
                rank, np_, server.address, mca=mca, nranks=nranks,
                extra_env=extra_env, cpu=cpu,
                telemetry_addr=(telemetry.ingest_address
                                if telemetry is not None else None))
            if rsh_job:
                env[ENV_RSH] = "1"
            if host_ids:
                env[ENV_HOST_IDS] = host_ids
            cmd = worker_cmd(argv)
            target = rank_host[rank] if rank_host else None
            # plm/rsh: _final_cmd reproduces the worker env on the
            # remote host (and is re-evaluated on every respawn)
            launch_specs.append((cmd, env, target))
            procs.append(spawn_rank(rank, cmd, env, target))

        # job state machine: poll ALL children so a failure anywhere
        # kills the job even while other ranks block (errmgr default);
        # under --ft, deaths are survivable events the workers' ULFM
        # machinery handles (and under --respawn, the rank is reborn —
        # the PRRTE restart-the-failed-proc leg)
        exit_code = 0
        live = set(range(np_))
        incarnations = [0] * np_
        import time as _time

        while live:
            for i in sorted(live):
                rc = procs[i].poll()
                if rc is None:
                    continue
                live.discard(i)
                if (ft and respawn and rc != 0
                        and incarnations[i] < max_respawns):
                    # restart leg: same rank, same env, bumped
                    # incarnation — the reborn proc replays the boot
                    # rendezvous and re-publishes its endpoint
                    incarnations[i] += 1
                    cmd_i, env_i, target_i = launch_specs[i]
                    env_i = dict(env_i)
                    env_i[ENV_INCARNATION] = str(incarnations[i])
                    print(f"[tpurun] rank {i} died (rc={rc}); "
                          f"respawning (incarnation {incarnations[i]})",
                          flush=True)
                    procs[i] = spawn_rank(i, cmd_i, env_i, target_i)
                    live.add(i)
                    continue
                if rc != 0 and exit_code == 0 and not ft:
                    exit_code = rc
                    for q in procs:
                        if q.poll() is None:
                            q.send_signal(signal.SIGTERM)
            if live:
                _time.sleep(0.05)
        if ft:
            exit_code = procs[0].returncode or 0
        for t in threads:
            # every writer is dead → readline hits EOF; the join bound
            # only guards against pathological scheduler starvation
            t.join(timeout=10)
        return exit_code
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        _unlink_leftovers(spawned)
        if telemetry is not None:
            telemetry.close()
        server.close()


#: shared-memory name prefixes that carry their creator's pid: the C
#: engine's rings (``tdcn-<pid>-``) and doorbells (``tdcn-db-<pid>-``),
#: the Python sm rings (``ompitpu-<pid>-``), the device windows
#: (``tpudev-<pid>-``)
_SHM_PREFIXES = ("tdcn-{}-", "tdcn-db-{}-", "ompitpu-{}-", "tpudev-{}-")


def _pid_in_use(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass
    return True


def _unlink_leftovers(pids, shm_dir: str = "/dev/shm") -> list[str]:
    """Unlink the shared-memory names the job's (now dead) workers left;
    returns what was removed.  A clean finalize leaves none.  Every worker
    is dead and reaped by now, so a pid that is in use again belongs to
    another process (a long job outlives a respawned corpse's pid): its
    names are left alone."""
    try:
        names = os.listdir(shm_dir)
    except OSError:
        return []
    prefixes = tuple(fmt.format(pid) for pid in pids if not _pid_in_use(pid)
                     for fmt in _SHM_PREFIXES)
    gone = []
    for name in names:
        if prefixes and name.startswith(prefixes):
            try:
                os.unlink(os.path.join(shm_dir, name))
                gone.append(name)
            except OSError:
                pass
    return gone


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tpurun",
        description="Launch an ompi_tpu_torch job (mpirun-equivalent)")
    parser.add_argument("-np", type=int, required=True, help="number of processes")
    parser.add_argument(
        "--mca", nargs=2, action="append", default=[], metavar=("KEY", "VALUE"),
        help="MCA parameter (repeatable), e.g. --mca btl sm",
    )
    parser.add_argument(
        "--nranks", type=int, default=None,
        help="virtual ranks per process (sets accelerator_cuda_nranks)",
    )
    parser.add_argument(
        "--cpu", action="store_true",
        help="run the workers' ranks on the CPU (sets OMPI_TPU_DEVICE=cpu; "
        "default: CUDA, raising where there is none)",
    )
    parser.add_argument(
        "--daemon", action="store_true",
        help="start a persistent serving daemon (tpud) instead of one "
        "job: the rank workers, their DCN endpoints and CUDA contexts, "
        "and the boot KVS stay warm across jobs submitted via "
        "'python -m ompi_tpu_torch ctl' or ompi_tpu_torch.api.tpud_submit "
        "(no script argument; see ompi_tpu_torch/serve/)",
    )
    parser.add_argument(
        "--ft", action="store_true",
        help="fault-tolerant job: worker death does not kill the job; "
        "heartbeat failure detection + ULFM recovery in the workers",
    )
    parser.add_argument(
        "--respawn", action="store_true",
        help="with --ft: relaunch a dead worker with the same rank and "
        "a bumped incarnation (the PRRTE restart leg); survivors' "
        "replace() restores the communicator to full size",
    )
    parser.add_argument(
        "--max-respawns", type=int, default=2,
        help="respawn budget per rank (default 2)",
    )
    parser.add_argument(
        "--host", default=None, metavar="H1[:S],H2[:S],...",
        help="host allocation (':S' = slots); engages the rsh launch leg "
        "for non-local hosts",
    )
    parser.add_argument(
        "--hostfile", default=None,
        help="hostfile ('host [slots=N]' per line)",
    )
    parser.add_argument(
        "--map-by", default="slot", metavar="slot|node|ppr:N|seq",
        help="rank mapping policy over the allocation (rmaps)",
    )
    parser.add_argument(
        "--launch-agent", default="ssh {host} {cmd}",
        help="remote launch template; {host}/{cmd} substituted "
        "(default 'ssh {host} {cmd}')",
    )
    parser.add_argument(
        "--ras", default="auto",
        choices=["auto", "slurm", "gridengine", "none"],
        help="resource-allocation reader: adopt a SLURM/Grid Engine "
        "allocation from the environment when no --host/--hostfile is "
        "given ('auto' detects, 'slurm'/'gridengine' require one, "
        "'none' disables adoption)",
    )
    parser.add_argument(
        "--oversubscribe", action="store_true",
        help="allow more ranks than allocated slots",
    )
    parser.add_argument(
        "--display-map", action="store_true",
        help="print the rank->host map before launching",
    )
    parser.add_argument(
        "--kvs-host", default=None,
        help="address the KVS/rendezvous server binds (must be reachable "
        "from every host; default 127.0.0.1 is single-host)",
    )
    parser.add_argument("script", nargs="?", default=None,
                        help="python script to run (omitted with --daemon)")
    parser.add_argument("args", nargs=argparse.REMAINDER)
    ns = parser.parse_args(argv)
    mca = {k: v for k, v in ns.mca}
    if ns.daemon:
        return _daemon_main(parser, ns, mca)
    if ns.script is None:
        parser.error("the following arguments are required: script")
    hosts = None
    if ns.hostfile:
        from .rmaps import parse_hostfile

        with open(ns.hostfile) as f:
            hosts = parse_hostfile(f.read())
    elif ns.host:
        from .rmaps import parse_host_list

        hosts = parse_host_list(ns.host)
    elif ns.ras != "none":
        # ras: adopt a resource manager's allocation (SURVEY §2.4
        # ras/slurm + ras/gridengine)
        from . import ras as ras_mod

        if ns.ras == "auto":
            hosts = ras_mod.detect(os.environ)
        elif ns.ras == "slurm":
            hosts = ras_mod.read_slurm(os.environ)
        else:  # argparse choices guarantees: gridengine
            hosts = ras_mod.read_gridengine(os.environ)
    return run_job(ns.np, [ns.script] + ns.args, mca, ns.nranks,
                   ft=ns.ft, hosts=hosts, map_by=ns.map_by,
                   launch_agent=ns.launch_agent,
                   oversubscribe=ns.oversubscribe,
                   display_map=ns.display_map, kvs_host=ns.kvs_host,
                   respawn=ns.respawn, max_respawns=ns.max_respawns,
                   cpu=ns.cpu)


def _daemon_main(parser, ns, mca: dict[str, str]) -> int:
    """``--daemon``: delegate to the tpud daemon (the one-shot path stays
    as it is when the flag is absent — no new threads, no new sockets).
    Flags the daemon does not honour fail loudly: ft/respawn are built
    in.  A host map IS honoured: one launch agent per remote host
    (``serve/agent.py``)."""
    from ompi_tpu_torch.serve.daemon import run_daemon

    if ns.script is not None:
        parser.error("--daemon takes no script (submit jobs via "
                     "'python -m ompi_tpu_torch ctl submit')")
    for flag, val in (("--ft", ns.ft), ("--respawn", ns.respawn)):
        if val:
            parser.error(f"{flag} is not supported with --daemon "
                         "(ft/respawn are built in)")
    hosts = None
    if ns.hostfile:
        from .rmaps import parse_hostfile

        with open(ns.hostfile) as f:
            hosts = parse_hostfile(f.read())
    elif ns.host:
        from .rmaps import parse_host_list

        hosts = parse_host_list(ns.host)
    if hosts and ns.kvs_host is None and any(
            not _is_local_host(h) for h, _slots in hosts):
        parser.error(
            "--daemon with remote hosts needs --kvs-host <routable "
            "address> (the control plane binds it; 127.0.0.1 is "
            "unreachable from the remote side)")
    return run_daemon(ns.np, mca=mca, nranks=ns.nranks, cpu=ns.cpu,
                      max_respawns=ns.max_respawns, hosts=hosts,
                      map_by=ns.map_by, launch_agent=ns.launch_agent,
                      kvs_host=ns.kvs_host,
                      oversubscribe=ns.oversubscribe)


if __name__ == "__main__":
    sys.exit(main())

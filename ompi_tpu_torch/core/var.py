"""MCA variable system — own copy of ``ompi_tpu/core/var.py``.

Same store, same precedence, same enum handling as the JAX package::

    api set()  >  cmdline ``--mca k v``  >  env ``OMPI_MCA_k``  >
    param files  >  default

Of the reference's centrally registered variables, the port keeps the
ones it reads: ``DEVICE_VARS`` (the device plane's switch and threshold,
and ``dcn_device_interpret``, the kernel-leg override read by
``coll/cuda_kernels.mode``), the ``trace_*``/``metrics_*`` rows of
``OBSERVABILITY_VARS`` with the ``telemetry_*`` and ``hang_*`` rows, the
``serve_*`` knobs of ``SERVING_VARS``, the DCN deadlines and
the ``ft_*``/``faultsim_*``/``dcn_plane_*`` knobs of ``ROBUSTNESS_VARS``, and
``SCHEDULE_VARS``, registered on every store at construction so that
they show in the MPI_T cvar listing before init.  :func:`dcn_timeout`
and :class:`Deadline` are the one deadline policy every blocking DCN
wait shares.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Iterable

ENV_PREFIXES = ("OMPI_MCA_", "OMPI_TPU_MCA_")


def default_param_files() -> list[str]:
    files = []
    home = os.path.expanduser("~")
    files.append(os.path.join(home, ".ompi_tpu", "mca-params.conf"))
    sysconf = os.environ.get("OMPI_TPU_SYSCONF", "/etc/ompi_tpu")
    files.append(os.path.join(sysconf, "ompi_tpu-mca-params.conf"))
    return files


SOURCE_DEFAULT = "default"
SOURCE_FILE = "file"
SOURCE_ENV = "env"
SOURCE_CMDLINE = "cmdline"
SOURCE_SET = "api"

_SOURCE_RANK = {
    SOURCE_DEFAULT: 0,
    SOURCE_FILE: 1,
    SOURCE_ENV: 2,
    SOURCE_CMDLINE: 3,
    SOURCE_SET: 4,
}

_TRUE_STRINGS = {"1", "true", "yes", "on", "enabled", "t", "y"}
_FALSE_STRINGS = {"0", "false", "no", "off", "disabled", "f", "n"}


def full_var_name(framework: str, component: str, name: str) -> str:
    """``<framework>_<component>_<name>`` with empty parts elided."""
    parts = [p for p in (framework, component, name) if p]
    return "_".join(parts)


class VarConversionError(ValueError):
    pass


def _convert(raw: Any, typ: str, enum: dict[str, int] | None) -> Any:
    """Convert a raw (usually string) value to the var's type."""
    if typ == "string":
        return str(raw)
    if typ == "bool":
        if isinstance(raw, bool):
            return raw
        s = str(raw).strip().lower()
        if s in _TRUE_STRINGS:
            return True
        if s in _FALSE_STRINGS:
            return False
        raise VarConversionError(f"cannot parse {raw!r} as bool")
    if typ == "int":
        if isinstance(raw, bool):
            return int(raw)
        if isinstance(raw, int):
            return raw
        s = str(raw).strip()
        if enum is not None and s in enum:
            return enum[s]
        try:
            return int(s, 0)
        except ValueError as e:
            raise VarConversionError(f"cannot parse {raw!r} as int") from e
    if typ == "float":
        try:
            return float(raw)
        except (TypeError, ValueError) as e:
            raise VarConversionError(f"cannot parse {raw!r} as float") from e
    raise VarConversionError(f"unknown var type {typ!r}")


@dataclass
class Var:
    """One registered MCA variable."""

    framework: str
    component: str
    name: str
    default: Any
    type: str = "string"  # string | int | bool | float
    help: str = ""
    enum: dict[str, int] | None = None
    read_only: bool = False

    value: Any = field(init=False, default=None)
    source: str = field(init=False, default=SOURCE_DEFAULT)
    source_detail: str = field(init=False, default="")

    @property
    def full_name(self) -> str:
        return full_var_name(self.framework, self.component, self.name)

    def enum_name(self) -> str | None:
        if self.enum is None:
            return None
        for k, v in self.enum.items():
            if v == self.value:
                return k
        return None


class VarStore:
    """Registry + resolver for MCA variables."""

    def __init__(
        self,
        cmdline: dict[str, str] | None = None,
        env: dict[str, str] | None = None,
        param_files: Iterable[str] | None = None,
    ):
        self._vars: dict[str, Var] = {}
        #: mutation generation — the api dispatch cache keys on it
        self.version = 0
        self._cmdline = dict(cmdline or {})
        self._env = env  # None → live os.environ
        self._file_values: dict[str, tuple[str, str]] = {}
        self._files_loaded = False
        self._param_files = list(param_files) if param_files is not None else None
        self._aliases: dict[str, str] = {}

    def _load_files(self) -> None:
        if self._files_loaded:
            return
        self._files_loaded = True
        files = self._param_files if self._param_files is not None else default_param_files()
        for path in files:
            try:
                with open(path, "r") as f:
                    lines = f.readlines()
            except OSError:
                continue
            for line in lines:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                k, _, v = line.partition("=")
                k, v = k.strip(), v.strip()
                if k and k not in self._file_values:
                    self._file_values[k] = (v, path)

    def register(
        self,
        framework: str,
        component: str,
        name: str,
        default: Any,
        type: str | None = None,
        help: str = "",
        enum: dict[str, int] | None = None,
        read_only: bool = False,
        aliases: Iterable[str] = (),
    ) -> Var:
        """Register (or re-fetch) a variable and resolve its value."""
        if type is None:
            if isinstance(default, bool):
                type = "bool"
            elif isinstance(default, int):
                type = "int"
            elif isinstance(default, float):
                type = "float"
            else:
                type = "string"
        var = Var(framework, component, name, default, type, help, enum, read_only)
        existing = self._vars.get(var.full_name)
        if existing is not None:
            return existing
        self._vars[var.full_name] = var
        for a in aliases:
            self._aliases[a] = var.full_name
        self._resolve(var)
        self.version += 1
        return var

    def _lookup_raw(self, full_name: str) -> tuple[Any, str, str] | None:
        names = [full_name] + [a for a, c in self._aliases.items() if c == full_name]
        for n in names:
            if n in self._cmdline:
                return self._cmdline[n], SOURCE_CMDLINE, "--mca"
        env = self._env if self._env is not None else os.environ
        for n in names:
            for prefix in ENV_PREFIXES:
                key = prefix + n
                if key in env:
                    return env[key], SOURCE_ENV, key
        self._load_files()
        for n in names:
            if n in self._file_values:
                v, path = self._file_values[n]
                return v, SOURCE_FILE, path
        return None

    def _resolve(self, var: Var) -> None:
        hit = self._lookup_raw(var.full_name)
        if hit is None or var.read_only:
            var.value = var.default
            var.source = SOURCE_DEFAULT
            var.source_detail = ""
            return
        raw, source, detail = hit
        var.value = _convert(raw, var.type, var.enum)
        var.source = source
        var.source_detail = detail

    def get(self, full_name: str, default: Any = None) -> Any:
        full_name = self._aliases.get(full_name, full_name)
        var = self._vars.get(full_name)
        if var is None:
            return default
        return var.value

    def get_var(self, full_name: str) -> Var | None:
        return self._vars.get(self._aliases.get(full_name, full_name))

    def lookup_unregistered(self, full_name: str) -> str | None:
        hit = self._lookup_raw(full_name)
        return None if hit is None else str(hit[0])

    def set(self, full_name: str, value: Any, source: str = SOURCE_SET) -> None:
        """API-level override (highest precedence)."""
        full_name = self._aliases.get(full_name, full_name)
        var = self._vars.get(full_name)
        if var is None:
            self._cmdline[full_name] = str(value)
            self.version += 1
            return
        if var.read_only:
            raise VarConversionError(f"{full_name} is read-only")
        if _SOURCE_RANK[source] >= _SOURCE_RANK[var.source]:
            var.value = _convert(value, var.type, var.enum)
            var.source = source
            var.source_detail = ""
            self.version += 1

    def set_cmdline(self, params: dict[str, str]) -> None:
        self._cmdline.update(params)
        self.version += 1
        for k in params:
            var = self._vars.get(self._aliases.get(k, k))
            if var is not None and _SOURCE_RANK[var.source] <= _SOURCE_RANK[SOURCE_CMDLINE]:
                self._resolve(var)

    def all_vars(self) -> list[Var]:
        return sorted(self._vars.values(), key=lambda v: v.full_name)


#: (framework, component, name, default, type, help) — the reference's
#: device-plane rows (dcn/device.py), same names, defaults and types
DEVICE_VARS = (
    ("dcn", "device", "enable", True, "bool",
     "Arm the device-resident zero-copy DCN plane: payloads at or "
     "above dcn_device_min_size that are contiguous move through "
     "per-transfer device windows (CUDA IPC memory for CUDA tensors; "
     "a shared-memory window for host arrays and CPU tensors) while "
     "the host plane carries only the descriptor control frames.  "
     "Off: every byte keeps the host shm/tcp rings"),
    ("dcn", "device", "min_size", 1 << 20, "int",
     "Smallest payload (bytes) the plane arbitration routes onto the "
     "device plane (below it the host ring's lower setup cost wins; at "
     "or above it the zero-copy window wins).  Non-contiguous or "
     "object-dtype payloads stay on the host plane at every size"),
    ("dcn", "device", "interpret", False, "bool",
     "Force the ring-hop kernels' plain torch bodies (the interpret "
     "rung) even for CUDA tensors; default off: the hand-written CUDA "
     "kernels for CUDA tensors, the row-permutation emulation for CPU "
     "tensors"),
)


def register_device_vars(store: VarStore) -> None:
    """Register the device-plane knobs on a store (idempotent)."""
    for fw, comp, name, default, typ, help_ in DEVICE_VARS:
        store.register(fw, comp, name, default, type=typ, help=help_)


#: (framework, component, name, default, type, help) — the reference's
#: trace_*, metrics_*, telemetry_* and hang_* rows
OBSERVABILITY_VARS = (
    ("trace", "", "enable", False, "bool",
     "Record cross-layer event spans into the trace ring buffer "
     "(api/coll/request timelines; default off — zero-cost hooks)"),
    ("trace", "", "buffer_events", 65536, "int",
     "Trace ring-buffer capacity in events; the oldest events "
     "are dropped (and counted) once full"),
    ("trace", "", "output", "", "string",
     "Chrome trace-event JSON path written at finalize as "
     "<output>.<proc>.json (read it with tools/trace_report.py)"),
    ("trace", "", "causal", False, "bool",
     "Cross-rank causal tracing: stamp a compact versioned context "
     "(comm/op/seq + hop) onto collective frames on the DCN planes, "
     "record per-collective causal records (schedule sends/recvs with "
     "measured waits + stall-cause deltas) for the critical-path "
     "solver (trace/causal.py, the finalize causal export).  Implies "
     "trace_enable.  Default off — zero wire bytes, zero hot-path work"),
    ("metrics", "", "enable", False, "bool",
     "Record telemetry (counters, per-op size/latency histograms, "
     "flight recorder); default off — one boolean test per hook"),
    ("metrics", "", "output", "", "string",
     "Telemetry export base path: finalize writes <output>.<proc>.prom "
     "(Prometheus text format) and <output>.<proc>.jsonl (snapshots + "
     "flight records; analyze with tools/metrics_report.py); flight "
     "records also append live to <output>.flight.<proc>.jsonl"),
    ("metrics", "", "flight_records", 64, "int",
     "Flight-recorder ring capacity: how many counter snapshots are "
     "retained in memory"),
    ("telemetry", "", "enable", False, "bool",
     "Live telemetry plane: every rank streams periodic counter/"
     "straggler frames to an aggregator in tpurun, which serves a "
     "mid-job Prometheus scrape endpoint (/metrics), a JSON state "
     "feed (/json — the tools/top.py input), and a JSONL history "
     "ring (/history); implies the metrics hooks.  Default off — no "
     "socket, no thread, no frames"),
    ("telemetry", "", "port", 0, "int",
     "HTTP port the tpurun aggregator serves scrapes on (0 = pick an "
     "ephemeral port and print the URL at launch)"),
    ("telemetry", "", "interval_ms", 500, "int",
     "Milliseconds between a rank's telemetry frames (each frame is "
     "one counter snapshot + the collectives completed since the "
     "last frame)"),
    ("telemetry", "", "history", 256, "int",
     "Frames retained in the aggregator's /history JSONL ring"),
    ("telemetry", "", "relay", False, "bool",
     "Per-group telemetry relays (the np>=16 fan-in fix): each "
     "detector group's leader rank hosts a batching relay; group "
     "members ship their frames there and the relay forwards one "
     "batched frame per interval to the root aggregator, so the "
     "root's ingest socket sees O(groups) connections instead of "
     "O(P).  Off (default): every rank dials the root directly"),
    ("hang", "", "diag_enable", True, "bool",
     "Hang diagnosis: every Deadline-bounded wait site registers its "
     "blocked identity (site, plane, awaited peer) lazily — only after a "
     "wait slice already expired — and on-demand snapshots feed the "
     "cross-rank wait-graph solver.  Default on: registration is "
     "cold-path only, so a healthy run does zero extra work; off drops "
     "even the slice-expiry bookkeeping"),
    ("hang", "", "snapshot_timeout_ms", 2000, "int",
     "Milliseconds the tpud deadline path waits for fresh per-rank "
     "blocked-state snapshots (one telemetry interval usually "
     "suffices) before assembling the pre-revoke hang report from "
     "whatever frames it holds"),
)


def register_observability_vars(store: VarStore) -> None:
    """Register the trace/metrics knobs on a store (idempotent)."""
    for fw, comp, name, default, typ, help_ in OBSERVABILITY_VARS:
        store.register(fw, comp, name, default, type=typ, help=help_)


#: (framework, component, name, default, type, help) — the reference's
#: DCN deadline family, fault knobs and device-plane health knobs, same
#: names, defaults and types
ROBUSTNESS_VARS = (
    ("dcn", "", "cts_timeout", 600.0, "float",
     "Seconds a rendezvous sender waits for the peer's CTS grant "
     "before escalating the peer as failed (MPIProcFailedError + "
     "detector notification)"),
    ("dcn", "", "ring_timeout", 600.0, "float",
     "Seconds a shared-memory ring write blocks on backpressure "
     "(receiver stalled) before escalating the peer as failed"),
    ("dcn", "", "recv_timeout", 120.0, "float",
     "Seconds a blocking DCN receive waits for the peer's frame "
     "before escalating (peer dead or collective order mismatch); "
     "expiry flight-records the transport counters first"),
    ("dcn", "", "connect_timeout", 30.0, "float",
     "Deadline for (re)dialing a peer, spanning every exponential-"
     "backoff attempt; control frames (heartbeats) always fail fast "
     "so in-band detection stays prompt"),
    ("dcn", "", "anysrc_timeout", 0.0, "float",
     "Opt-in (default 0 = unbounded, plain MPI blocking semantics): "
     "seconds an ANY_SOURCE receive blocks before escalating to a "
     "communicator-wide liveness check — a failed member raises "
     "MPIProcFailedPendingError, an all-alive membership re-arms the "
     "wait"),
    ("ft", "", "respawn_timeout", 60.0, "float",
     "Seconds replace() waits for a failed rank's respawned "
     "incarnation to re-publish its endpoint (tpurun --respawn) "
     "before giving up on restoration"),
    ("ft", "", "remote_respawn_timeout", 120.0, "float",
     "The rsh-leg twin of ft_respawn_timeout: the await-respawn "
     "deadline used when the job was launched over the plm/rsh leg "
     "(tpurun marks workers with OMPI_TPU_RSH)"),
    ("ft", "", "group_size", 8, "int",
     "Hierarchical failure-detection group width: ranks partition "
     "into groups of this size (or by host id when the launcher "
     "published OMPI_TPU_HOST_IDS); members heartbeat only their "
     "group's leader + successor, leaders heartbeat each other.  The "
     "same groups shard the boot modex.  <= 0 collapses to one group "
     "(full-mesh heartbeats)"),
    ("ft", "", "gossip_digest", True, "bool",
     "Piggyback an anti-entropy digest of the versioned failure-"
     "record set on leader<->leader heartbeats: a digest mismatch "
     "triggers one flrsync record exchange.  Off: convergence relies "
     "on the direct flr flood alone"),
    ("faultsim", "", "enable", False, "bool",
     "Arm the deterministic fault-injection plane (default off — "
     "every transport hook is one boolean test when disabled)"),
    ("faultsim", "", "seed", 0, "int",
     "Fault-plan seed: decisions are a pure function of (seed, proc, "
     "site, event index), so one seed replays one fault schedule"),
    ("faultsim", "", "plan", "", "string",
     "Fault plan, e.g. 'drop:p=0.01,delay:ms=50,connkill:at=100' — "
     "comma-separated <kind>[:k=v[;k=v]] rules (kinds: drop delay dup "
     "trunc connkill stall ringfail dialfail daemonkill; 'proc=N' "
     "restricts a rule to one rank, e.g. 'delay:ms=30;site=recv;proc=1' "
     "slows only rank 1; 'site=device'/'site=device_recv' target the "
     "device-window stage / materialize paths for plane-failover "
     "drills)"),
    ("dcn", "", "plane_strikes", 3, "int",
     "Consecutive per-(peer, plane) failures (deadline escalation, "
     "injected device fault, failed stage) before the plane-health "
     "table demotes that peer's traffic off the plane — device-window "
     "sends degrade to the host ring/TCP plane while demoted.  One "
     "success resets the strike count (the btl exclude-and-reroute "
     "rule, made per-peer)"),
    ("dcn", "", "plane_heal_interval", 5.0, "float",
     "Seconds after a demotion before the arbitration layer routes "
     "ONE eligible send back through the demoted plane as a heal "
     "probe: a consumed probe window re-promotes the (peer, plane) "
     "pair, a failed one re-arms the interval.  <= 0 disables heal "
     "probes (a demotion then sticks until replace()/respawn clears "
     "the health marks)"),
)


def register_robustness_vars(store: VarStore) -> None:
    """Register the deadline/faultsim knobs on a store (idempotent)."""
    for fw, comp, name, default, typ, help_ in ROBUSTNESS_VARS:
        store.register(fw, comp, name, default, type=typ, help=help_)


def dcn_timeout(name: str) -> float:
    """Resolve one ``dcn_<name>_timeout`` against the default MCA
    context — the single lookup every blocking DCN wait shares.  Falls
    back to the table default when no context exists (bare transports
    in unit tests)."""
    full = f"dcn_{name}_timeout"
    try:
        from ompi_tpu_torch.core import mca

        v = mca.default_context().store.get(full)
        if v is not None:
            return float(v)
    except Exception:  # noqa: BLE001 — pre-init / teardown: use default
        pass
    for fw, comp, vname, default, _typ, _h in ROBUSTNESS_VARS:
        if full_var_name(fw, comp, vname) == full:
            return float(default)
    raise KeyError(f"unknown dcn timeout {name!r}")


class Deadline:
    """The one deadline policy every blocking DCN wait converges on
    (CTS waits, ring writes, blocking receives, dial backoff).

    Monotonic-clock based; ``slice()`` yields the poll quantum for
    loops that must stay sensitive to failure detection between
    checks; ``check()`` raises :class:`~ompi_tpu_torch.core.errors.
    DeadlineExpiredError` — callers translate expiry into the ULFM
    escalation (``MPIProcFailedError`` + detector notification)
    appropriate to their layer."""

    __slots__ = ("seconds", "_t0")

    def __init__(self, seconds: float):
        import time

        self.seconds = float(seconds)
        self._t0 = time.monotonic()

    @classmethod
    def for_timeout(cls, name: str) -> "Deadline":
        return cls(dcn_timeout(name))

    def elapsed(self) -> float:
        import time

        return time.monotonic() - self._t0

    def remaining(self) -> float:
        return max(0.0, self.seconds - self.elapsed())

    def expired(self) -> bool:
        return self.elapsed() > self.seconds

    def slice(self, quantum: float = 0.25) -> float:
        """Bounded wait quantum: never overshoots the deadline, never
        returns a non-positive wait."""
        return max(0.001, min(quantum, self.remaining()))

    def check(self, what: str = "") -> None:
        if self.expired():
            from ompi_tpu_torch.core.errors import DeadlineExpiredError

            raise DeadlineExpiredError(
                f"deadline expired after {self.seconds}s"
                + (f": {what}" if what else ""))


#: (framework, component, name, default, type, help) — the native
#: streaming send engine's knobs, the reference's rows unchanged;
#: forwarded to the C engine at creation (``tdcn_set_stream``)
TRANSPORT_VARS = (
    ("dcn", "", "chunk_bytes", 512 << 10, "int",
     "Streaming-engine FRAG granularity AND streaming threshold on the "
     "shared-memory ring path: payloads above it leave the caller's "
     "thread as a send descriptor and stream cooperatively through the "
     "per-engine sender thread; the adaptive controller shrinks the "
     "effective chunk (floor 64 KiB) under sustained ring backpressure "
     "and grows it back when the stall clears"),
    ("dcn", "", "inflight_limit", 32 << 20, "int",
     "Per-peer cap on queued-unsent streaming bytes: an isend enqueue "
     "over the cap blocks (bounded by dcn_ring_timeout) until the "
     "sender thread drains below it — graceful backpressure instead of "
     "unbounded buffered-send memory growth (0 = unlimited)"),
    ("dcn", "", "doorbell_coalesce", True, "bool",
     "Pay the ring-doorbell futex_wake syscall only when a consumer is "
     "actually parked (the doorbell word is still bumped every record, "
     "so no wakeup is ever lost); suppressed wakes are counted in "
     "doorbells_suppressed.  Off restores the unconditional per-record "
     "wake"),
)


def register_transport_vars(store: VarStore) -> None:
    """Register the streaming-send-engine knobs on a store (idempotent)."""
    for fw, comp, name, default, typ, help_ in TRANSPORT_VARS:
        store.register(fw, comp, name, default, type=typ, help=help_)


#: (framework, component, name, default, type, help)
SCHEDULE_VARS = (
    ("coll", "sched", "cache_enable", True, "bool",
     "Cache persistent-collective schedules (algorithm choice and the "
     "resolved callable) keyed (comm shape, op, dtype, count, root) and "
     "replay them on start() with no per-call planning.  Off = every "
     "lookup plans afresh"),
    ("coll", "sched", "cache_max", 256, "int",
     "Upper bound on cached schedules (FIFO eviction)"),
)


def register_schedule_vars(store: VarStore) -> None:
    """Register the schedule-cache knobs on a store (idempotent)."""
    for fw, comp, name, default, typ, help_ in SCHEDULE_VARS:
        store.register(fw, comp, name, default, type=typ, help=help_)


# -- serving variables (central registration, same pattern) --------------
#
# The tpud serving plane's tenant quotas and daemon knobs, the
# reference's table: consumed by ompi_tpu_torch.serve (the ``tpud``
# command and ``run --daemon``) and introspectable on every store.

#: (framework, component, name, default, type, help)
SERVING_VARS = (
    ("serve", "", "max_pending", 8, "int",
     "Per-tenant admission quota: a tpud submit is rejected (HTTP 429) "
     "while the tenant already has this many jobs queued or running "
     "(admission control; 0 = unlimited)"),
    ("serve", "", "cid_block", 4096, "int",
     "CID-space block reserved per served job: every job's communicator "
     "world (and any comms it derives) lives in a disjoint "
     "[base, base+block) CID range, so per-(comm, op) sequence counters "
     "start clean without re-dialing anything"),
    ("serve", "", "cid_base", 1 << 20, "int",
     "First CID block handed to a served job (above anything the boot "
     "rendezvous or a normal run allocates)"),
    ("serve", "", "port", 0, "int",
     "HTTP port the tpud ops/scrape endpoint serves on (0 = pick an "
     "ephemeral port and print the URL at daemon start)"),
    ("serve", "", "poll_ms", 50, "int",
     "Milliseconds between a resident worker's polls of the job stream "
     "while idle (the KVS long-poll quantum)"),
    ("serve", "", "tenant", "default", "string",
     "Default tenant name a tpud submit is accounted against when the "
     "client names none"),
    ("serve", "", "job_timeout", 0.0, "float",
     "Seconds the daemon lets one job run before marking it failed and "
     "freeing its rank-set (0 = unbounded)"),
    ("serve", "", "pidfile", "", "string",
     "Path of the tpud pidfile — arms the crash-safe control plane: "
     "the daemon records its pid/KVS/ops addresses there (stale locks "
     "from a SIGKILLed daemon are reaped and taken over), journals "
     "the job stream next to it, and resident workers use it to find "
     "a restarted daemon and re-attach instead of orphaning (empty = "
     "off, the one-shot daemon lifecycle)"),
    ("serve", "", "journal", "", "string",
     "Job-stream journal path (append-only JSONL): submissions, "
     "published directives, completions, and worker pids — replayed "
     "by a restarted daemon so queued and in-flight jobs survive a "
     "daemon SIGKILL and execute exactly once (empty = "
     "<serve_pidfile>.journal when a pidfile is configured)"),
    ("serve", "", "agent_poll_ms", 50, "int",
     "Milliseconds between a per-host launch agent's polls of its "
     "command stream while idle (the multi-host DVM leg: tpurun "
     "--daemon with a host map runs one agent per remote host)"),
    ("serve", "", "agent_hb_ms", 500, "int",
     "Milliseconds between a launch agent's heartbeat records "
     "(serve.agent.hb.<hid>: agent pid + per-worker pid/liveness "
     "table — the daemon's remote view of a host it shares no pid "
     "namespace with)"),
    ("serve", "", "agent_timeout", 10.0, "float",
     "Seconds of agent-heartbeat silence (with the agent's launch "
     "process also gone) after which the daemon declares the agent "
     "dead and respawns it over the rsh leg — the reborn agent "
     "re-adopts still-live workers from the last-known pid table and "
     "reports the dead ones for the normal respawn+repair leg"),
    ("serve", "", "journal_max_kb", 0, "int",
     "Journal rotation size bound: once the crash journal grows past "
     "this many KiB the daemon rewrites it in place as one compacted "
     "snapshot line (current replayed state) plus an empty tail, so a "
     "long-lived daemon's journal stops growing without bound "
     "(0 = no size-triggered rotation)"),
    ("serve", "", "journal_max_age_s", 0.0, "float",
     "Journal rotation age bound: rotate (compact-in-place) once the "
     "current journal segment is older than this many seconds, "
     "regardless of size — bounds replay work after a crash even "
     "under a slow event trickle (0 = no age-triggered rotation)"),
    ("serve", "", "agent_hb_only", False, "bool",
     "Judge launch-agent liveness by heartbeat staleness alone, "
     "ignoring rsh-launcher exit: for backgrounding agent templates "
     "(rsh wrappers that daemonize and exit immediately) the launch "
     "process dying is normal, so only serve_agent_timeout seconds "
     "of heartbeat silence declares the agent dead (default off: "
     "either signal — rsh exit or hb silence — triggers respawn)"),
    ("serve", "", "reattach_timeout", 30.0, "float",
     "Crash-safe control plane window, both sides: how long a "
     "resident worker that lost its daemon parks and polls the "
     "pidfile for a restarted one before self-terminating with full "
     "teardown (no orphans), and how long the restarted daemon waits "
     "for a live worker's re-adoption record before treating the "
     "rank as dead and respawning it"),
    ("serve", "", "max_concurrent", 0, "int",
     "Concurrency cap for the gang scheduler: at most this many jobs "
     "run on the mesh at once even when disjoint rank-sets are free "
     "(0 = unlimited — any job whose full rank-set is free launches)"),
    ("serve", "", "admission_stall_ns", 0, "int",
     "Telemetry-driven admission threshold (0 = off): when one daemon "
     "monitor tick's summed ring/cts/DMA stall delta across the mesh "
     "exceeds this many nanoseconds (or the detector reports the mesh "
     "unhealthy), the scheduler queues instead of dispatching; "
     "serve_shed_policy decides what SUSTAINED overload does to new "
     "submits"),
    ("serve", "", "shed_policy", "shed", "string",
     "Graceful-degradation policy under sustained overload (three "
     "consecutive over-threshold admission ticks): 'shed' rejects "
     "submits from tenants that already have work queued or running "
     "with HTTP 429 + a Retry-After hint (an idle tenant still gets "
     "one job in — overload must not lock a tenant out entirely); "
     "'queue' only holds dispatch and keeps admitting"),
    ("serve", "", "job_deadline_s", 0.0, "float",
     "Per-job wall deadline, Deadline-bounded (0 = none): an expired "
     "job gets a revoke directive — its workers revoke the job "
     "communicator ULFM-style, the job fails with a typed "
     "DeadlineExpired error on /job/<id>, and concurrently running "
     "disjoint gangs are untouched — instead of wedging its gang "
     "(serve_job_timeout remains the harder kill-and-repair bound)"),
    ("serve", "", "retry_budget", 0, "int",
     "Automatic re-enqueues for a job killed by mesh repair (a rank "
     "died under it; 0 = none): each retry is journaled as one atomic "
     "record, so a daemon crash mid-retry replays to exactly one "
     "re-run; budget exhaustion fails the job with a typed "
     "RetryBudgetExhausted error on /job/<id>"),
)


def register_serving_vars(store: VarStore) -> None:
    """Register the tpud serving knobs on a store (idempotent)."""
    for fw, comp, name, default, typ, help_ in SERVING_VARS:
        store.register(fw, comp, name, default, type=typ, help=help_)


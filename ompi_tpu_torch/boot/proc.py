"""Per-process bootstrap — rank/size/rendezvous from the environment.

Port of ``ompi_tpu/boot/proc.py``: the same env keys, KVS key layout
and modex legs.  The engine is the native C plane (``btl/native``, the
default, ``ntv:`` addresses) or a Python transport (``--mca btl
tcp|sm|bml``); when the C library cannot be built or loaded, the process
says so on stderr and falls back to ``bml``, as the reference does, and
a job whose processes published different planes aborts at the modex.

≈ ``ess`` (environment-specific services) + the PMIx client init +
modex of SURVEY.md §3.2: a worker launched by ``tpurun`` reads its
process index and the coordinator address from env vars, connects the
KVS, publishes its DCN endpoint (``PMIx_Put`` + ``PMIx_Commit``),
fences, and collects peer endpoints.

The collection is **sharded and lazy** on the Python transports (the
PMIx "instant-on" shape): ranks are partitioned into the same groups
the hierarchical failure detector uses (host id when known, else
``ft_group_size`` chunks); each group's *leader* pulls every endpoint
with ONE ``get_prefix`` scan and publishes its group's slice as a
bundle; members issue ONE get for the bundle and resolve any peer
outside their group lazily on first send (one KVS get, cached).  Boot
KVS traffic drops from O(P²) per-rank gets to O(P + groups·P), and
the fence gates only the puts — never on every rank having pulled
every address.  A reborn incarnation (whose boot-time bundle may be
stale for previously-reborn peers) keeps the eager per-peer gather.
"""

from __future__ import annotations

import os

from .kvs import KVSClient

ENV_PROC = "OMPI_TPU_PROC"
ENV_NPROCS = "OMPI_TPU_NPROCS"
ENV_KVS = "OMPI_TPU_KVS_ADDR"
#: KVS key namespace — spawned child worlds share the job's KVS server
#: but live under their own prefix (dynamic process management)
ENV_NS = "OMPI_TPU_KVS_NS"
#: rebirth counter (tpurun --respawn): 0 on first launch; a respawned
#: worker replays the boot rendezvous under a bumped incarnation so
#: survivors can distinguish the reborn endpoint from the corpse's
ENV_INCARNATION = "OMPI_TPU_INCARNATION"
#: set by tpurun when the job maps ranks onto remote hosts (the
#: plm/rsh leg): a remote respawn pays the launch-agent round-trip on
#: top of the boot, so every await-respawn deadline switches from
#: ft_respawn_timeout to ft_remote_respawn_timeout
ENV_RSH = "OMPI_TPU_RSH"
#: comma-separated host index per rank (tpurun publishes it whenever a
#: host map exists): detector groups and the sharded modex partition
#: by real host instead of ft_group_size chunks
ENV_HOST_IDS = "OMPI_TPU_HOST_IDS"
#: the device a launched worker runs its ranks on, set by the
#: launcher's ``--cpu`` switch (``run --cpu``, ``tpud --cpu``) as
#: ``cpu``; unset, a worker runs on CUDA and raises without it
ENV_DEVICE = "OMPI_TPU_DEVICE"


def respawn_timeout(store) -> float:
    """The await-respawn deadline (replace(), the reborn rejoin grace,
    the serve repair wait): ``ft_remote_respawn_timeout`` on the rsh
    leg (:data:`ENV_RSH`), ``ft_respawn_timeout`` locally."""
    if os.environ.get(ENV_RSH):
        return float(
            store.get("ft_remote_respawn_timeout", 120.0) or 120.0)
    return float(store.get("ft_respawn_timeout", 60.0) or 60.0)


def launched_by_tpurun() -> bool:
    return ENV_PROC in os.environ


class ProcContext:
    """This process's place in a tpurun job."""

    def __init__(self, local_size: int | None = None):
        self.proc = int(os.environ[ENV_PROC])
        self.nprocs = int(os.environ[ENV_NPROCS])
        self.ns = os.environ.get(ENV_NS, "")
        #: elastic recovery state: this process's rebirth count, the
        #: highest incarnation we know per peer (replace() polls past
        #: it), and whether a reborn process has rejoined the job yet
        self.incarnation = int(os.environ.get(ENV_INCARNATION, "0"))
        self.incarnations: dict[int, int] = {}
        self.rejoined = self.incarnation == 0
        #: partial-replace beacon keys this reborn incarnation already
        #: consumed — replace_partial walks the (proc, inc, cid) queue
        self.healed_partials: set[str] = set()
        #: the world replace() rounds this process entered, oldest first:
        #: stream, members, the incarnation it held for each, and the
        #: round's milliseconds once it completed (the repair record)
        self.replace_rounds: list[dict] = []
        self.kvs = KVSClient(os.environ[ENV_KVS])
        # modex: publish DCN endpoint, fence, gather peers. Transport
        # tunables come from the btl/tcp component's MCA vars (so
        # --mca btl_tcp_eager_limit etc. behave as in the reference).
        from ompi_tpu_torch.core import mca
        from ompi_tpu_torch.core.registry import ComponentError

        ctx = mca.default_context()
        fw = ctx.framework("btl")
        # open() first: a mistyped explicit include (--mca btl tpc) must
        # abort here, as the reference does — only AFTER a clean open is
        # "no component" a legitimate state (^tcp exclusion)
        fw.open()
        try:
            comp = fw.select_one()
        except ComponentError:
            params = {}  # btl excluded (^tcp) → transport defaults
        else:
            # bad --mca btl_tcp_* values propagate (the reference
            # aborts on unparseable MCA values; so do we)
            params = comp.params(ctx.store)
        self.engine = self._make_engine(params)
        addr = self.engine.transport.address
        self.kvs.put(f"{self.ns}dcn.{self.proc}", addr)
        #: per-proc local-rank counts, filled by the sharded modex when
        #: api.init passed ``local_size`` — lets MultiProcComm skip the
        #: boot allgather entirely (no boot collective: instant-on)
        self.wsizes: list[int] | None = None
        if local_size is not None:
            self.kvs.put(f"{self.ns}wsize.{self.proc}", int(local_size))
        if self.incarnation:
            # rebirth rendezvous: the incarnation-suffixed address key
            # plus the incarnation beacon survivors' replace() polls —
            # the plain dcn.<proc> key still holds the CORPSE's address
            # in their caches until replace() refreshes it
            self.kvs.put(f"{self.ns}dcn.{self.proc}.i{self.incarnation}",
                         addr)
            self.kvs.put(f"{self.ns}inc.{self.proc}", self.incarnation)
        # the modex fence is idempotent for a reborn proc (the fence
        # set already contains every rank), so this returns instantly
        # on incarnation > 0 — by design: survivors are mid-job, not
        # waiting at a barrier.  It gates only the PUTS above — never
        # on any rank having pulled any address.
        self.kvs.fence(f"{self.ns}modex", self.proc, self.nprocs)
        # detector-group topology (shared with the sharded modex and
        # the telemetry relays): host ids when the launcher published
        # a map, else ft_group_size chunks
        from ompi_tpu_torch.ft.detector import (FtDetectorComponent,
                                          HeartbeatDetector,
                                          compute_groups, parse_host_ids)

        ftp = FtDetectorComponent().params(ctx.store)
        self.hosts = parse_host_ids(os.environ.get(ENV_HOST_IDS, ""),
                                    self.nprocs)
        # mirror the detector's gate exactly (<= 0 collapses to ONE
        # group): `or` alone would turn a negative into singleton
        # groups and break the shared-topology invariant
        gsz = ftp["group_size"] if ftp["group_size"] > 0 else self.nprocs
        self.groups = compute_groups(self.nprocs, gsz, self.hosts)
        self.group = next(g for g in self.groups if self.proc in g)
        self._mine_native = addr.startswith("ntv:")
        try:
            if (self.nprocs == 1 or self.incarnation or local_size is None):
                # reborn incarnations keep the eager gather (a boot-time
                # bundle may be stale for previously-reborn peers); direct
                # construction without a local size has no wsize beacons
                self._modex_eager()
            else:
                self._modex_sharded(local_size)
        except BaseException:
            # an aborted boot (a plane mismatch, a dead group leader)
            # leaves no shared-memory names behind: no peer attached yet
            getattr(self.engine, "destroy", self.engine.close)()
            raise
        # failure detector (tpurun --ft / --mca ft_detector_enable 1):
        # hierarchical heartbeats + versioned gossip; detections fan
        # out to every registered communicator's ULFM state (SURVEY.md
        # §5 failure detection)
        import threading
        import weakref

        self._ft_comms: "weakref.WeakSet" = weakref.WeakSet()
        self._ft_lock = threading.Lock()
        self.detector = None
        if ftp["enable"] and self.nprocs > 1:
            # a reborn proc's peers stay silent toward it until their
            # replace() clears its failed mark — grace the first
            # detection window so the rejoin isn't poisoned by its own
            # detector declaring every survivor dead
            grace = 0.0
            if self.incarnation:
                grace = respawn_timeout(ctx.store)
            self.detector = HeartbeatDetector(
                self.engine, period=ftp["period"], timeout=ftp["timeout"],
                grace=grace, group_size=ftp["group_size"],
                hosts=self.hosts, digest=ftp["digest"],
                incarnation=self.incarnation,
            )
            self.detector.on_failure(self._fan_out_failure)
            self.detector.on_heal(self._fan_out_heal)

    # -- modex (eager + sharded legs) ------------------------------------

    def _check_plane(self, pairs) -> None:
        """Wire-plane agreement: the published address reveals each
        peer's plane ("ntv:" = libtpudcn framing).  A mixed job (one
        host without a C++ compiler, a per-process fallback) must abort
        with a clear message — native frames against a Python endpoint
        would otherwise hang the first collective."""
        mixed = sorted(p for p, a in pairs
                       if a.startswith("ntv:") != self._mine_native)
        if mixed:
            from ompi_tpu_torch.core.errors import MPIInternalError

            raise MPIInternalError(
                f"DCN wire-plane mismatch: proc {self.proc} uses the "
                f"{'native' if self._mine_native else 'Python'} "
                f"transport but procs {mixed} published the other "
                f"plane (a host without a C++ compiler?); force "
                f"one with --mca btl tcp|sm|bml on every host")

    def _modex_eager(self) -> None:
        """The pre-hierarchical gather: P−1 gets per rank.  Kept for
        single-proc jobs, reborn incarnations (a boot-time bundle may
        be stale for previously-reborn peers), and direct ProcContext
        construction without a local size."""
        addresses = [self.kvs.get(f"{self.ns}dcn.{p}")
                     for p in range(self.nprocs)]
        self._check_plane(enumerate(addresses))
        self.engine.set_addresses(addresses)

    def _resolve_addr(self, p: int) -> str:
        """Lazy modex get — first send to an out-of-group peer."""
        a = self.kvs.get(f"{self.ns}dcn.{p}")
        self._check_plane([(p, a)])
        return a

    def _modex_sharded(self, local_size: int) -> None:
        """The instant-on leg: the group leader's ONE ``get_prefix``
        scan primes a per-group bundle (own-group addresses + every
        rank's local size); members issue ONE get for it; everything
        else resolves lazily on first send (:class:`~ompi_tpu_torch.dcn.
        collops.AddressTable`).  A leader that died at boot degrades
        members to the eager gather after the bundle get times out."""
        from ompi_tpu_torch.dcn.collops import AddressTable

        gi = self.groups.index(self.group)
        key = f"{self.ns}modex.g{gi}"
        primed: dict[int, str] = {}
        #: native leader only: cross-group addresses from the scan,
        #: cached into the table AFTER the engine install so the C
        #: plane's eager-install count stays <= group size without
        #: re-paying a KVS get per cross-group peer (the C-side lazy
        #: resolver reads the cached slot instead)
        cache_after: dict[int, str] = {}
        if self.proc == self.group[0]:
            scan = self.kvs.get_prefix(f"{self.ns}dcn.")
            base = len(f"{self.ns}dcn.")
            allmap = {int(k[base:]): v for k, v in scan.items()
                      if k[base:].isdigit()}
            wscan = self.kvs.get_prefix(f"{self.ns}wsize.")
            wbase = len(f"{self.ns}wsize.")
            wsizes = {int(k[wbase:]): int(v) for k, v in wscan.items()
                      if k[wbase:].isdigit()}
            self._check_plane(sorted(allmap.items()))
            self.kvs.put(key, {
                "addrs": {str(p): allmap[p] for p in self.group
                          if p in allmap},
                "wsizes": {str(p): wsizes[p] for p in sorted(wsizes)},
            })
            if self._mine_native:
                # native plane: install only the group slice eagerly,
                # so the C engine's addr_installs counter reads
                # <= group size on EVERY rank; the scan's cross-group
                # addresses cache into the table after the install,
                # where the C lazy resolver finds them
                primed = {p: allmap[p] for p in self.group
                          if p in allmap}
                cache_after = {p: a for p, a in allmap.items()
                               if p not in primed}
            else:
                primed = allmap  # the leader paid for the scan: keep it
            self.wsizes = ([wsizes[p] for p in range(self.nprocs)]
                           if len(wsizes) == self.nprocs else None)
        else:
            try:
                bundle = self.kvs.get(key)
                primed = {int(p): a
                          for p, a in (bundle.get("addrs") or {}).items()}
                ws = {int(p): int(w)
                      for p, w in (bundle.get("wsizes") or {}).items()}
                self.wsizes = ([ws[p] for p in range(self.nprocs)]
                               if len(ws) == self.nprocs else None)
                self._check_plane(sorted(primed.items()))
            except (KeyError, ValueError):
                # group leader never published (died at boot?): degrade
                self._modex_eager()
                return
        primed[self.proc] = self.engine.transport.address
        table = AddressTable(self.nprocs, self._resolve_addr, primed)
        self.engine.set_addresses(table)
        for p, a in cache_after.items():
            # cached slots read like primed ones (no resolver call, no
            # KVS get) but were never eagerly installed in C — the
            # engine's lazy-resolver callback pulls them on demand
            list.__setitem__(table, p, a)

    def _make_engine(self, params: dict):
        """Engine selection: the native C++ data plane when the btl
        picked it AND libtpudcn builds and loads here; otherwise the
        Python transports (also the loud fallback to bml when the
        library cannot be built or loaded)."""
        params = dict(params)
        if params.get("transport") == "native":
            params.pop("transport")
            try:
                from ompi_tpu_torch.dcn import native as dcn_native

                if dcn_native.available():
                    return dcn_native.NativeDcnEngine(
                        self.proc, self.nprocs, **params)
                dcn_native.load_library()  # raises the reason
            except Exception as e:  # noqa: BLE001 — degrade, loudly
                import sys

                print(
                    f"[ompi_tpu_torch] native data plane unavailable "
                    f"({type(e).__name__}: {e}); falling back to the "
                    f"Python bml transport", file=sys.stderr, flush=True)
            params["transport"] = "bml"
        params.pop("ring_bytes", None)
        # imported here, not with the module: the launch agent and the
        # daemon read this module's names, and an agent's boot (torch
        # included) would count against serve_agent_timeout
        from ompi_tpu_torch.dcn.collops import DcnCollEngine

        return DcnCollEngine(self.proc, self.nprocs, **params)

    def _fan_out_failure(self, root_proc: int) -> None:
        with self._ft_lock:  # registration races the detector thread
            comms = list(self._ft_comms)
        for comm in comms:
            comm._on_proc_failed(root_proc)

    def _fan_out_heal(self, root_proc: int) -> None:
        """False-positive heal: the un-fail fan-out — every registered
        communicator's ULFM failed marks for the proc's ranks clear,
        so per-op guards stop raising about a peer that was never
        actually dead."""
        with self._ft_lock:
            comms = list(self._ft_comms)
        for comm in comms:
            heal = getattr(comm, "_on_proc_healed", None)
            if heal is not None:
                heal(root_proc)

    def register_comm(self, comm) -> None:
        """Track a MultiProcComm for failure fan-out; replay known
        failures so comms created post-failure start consistent."""
        with self._ft_lock:
            self._ft_comms.add(comm)
        if self.detector is not None:
            for p in self.detector.failed():
                comm._on_proc_failed(p)

    def adopt_incarnation_floors(self, incs) -> None:
        """Fold a recovery beacon's incarnation floors in: the
        ``incarnations`` map (await_respawn polls past them) AND the
        detector's rebirth floor — a reborn process boots with both
        empty, and without the detector half a fellow reborn peer's
        current-incarnation heartbeats would read as a rebirth detection
        and falsely re-mark it (the multi-victim case a whole-host kill
        produces).  A proc the beacon names restored that THIS process
        currently marks failed was marked against the corpse (the reborn
        fellows boot in parallel, and an early send can hit a corpse
        address and strike before the floors arrive) — clear the mark
        everywhere, or it replays into every comm registered afterwards."""
        for k, v in (incs or {}).items():
            k, v = int(k), int(v)
            self.incarnations[k] = max(v, self.incarnations.get(k, 0))
            if k == self.proc:
                continue
            if v > 0:
                # the boot's eager gather raced the fellow reborn's
                # re-publish: refresh from the incarnation-suffixed key
                # (authoritative for the reborn lineage) so sends stop
                # dialing the corpse endpoint
                try:
                    addr = self.kvs.get(f"{self.ns}dcn.{k}.i{v}", wait=False)
                    if addr:
                        self.engine.update_address(k, addr)
                except (KeyError, ConnectionError, OSError):
                    pass
            if self.detector is None:
                continue
            if k in self.detector.failed() or self.engine.proc_failed(k):
                self.engine.note_proc_recovered(k, incarnation=v)
            else:
                self.detector.note_incarnation(k, v)

    def await_respawn(self, root_proc: int, timeout: float) -> tuple[int, str]:
        """Block until a NEW incarnation of ``root_proc`` (> the last one
        we integrated) has re-published its endpoint; returns
        (incarnation, address).  The restart leg's rendezvous: ``tpurun
        --respawn`` relaunches the rank, whose boot publishes
        ``inc.<proc>`` and ``dcn.<proc>.i<k>`` (see __init__)."""
        import time

        last = self.incarnations.get(root_proc, 0)
        deadline = time.monotonic() + float(timeout)
        while True:
            try:
                inc = int(self.kvs.get(f"{self.ns}inc.{root_proc}", wait=False))
            except KeyError:
                inc = 0
            if inc > last:
                break
            if time.monotonic() > deadline:
                from ompi_tpu_torch.core.errors import MPIProcFailedError

                raise MPIProcFailedError(
                    f"replace: no respawned incarnation of proc "
                    f"{root_proc} within ft_respawn_timeout={timeout}s "
                    f"(launched without tpurun --respawn, or the rank "
                    f"exhausted --max-respawns?)")
            time.sleep(0.05)
        address = self.kvs.get(
            f"{self.ns}dcn.{root_proc}.i{inc}",
            timeout=max(1.0, deadline - time.monotonic()))
        self.incarnations[root_proc] = inc
        return inc, address

    def fence(self, name: str) -> None:
        self.kvs.fence(f"{self.ns}{name}", self.proc, self.nprocs)

    def close(self) -> None:
        if self.detector is not None:
            self.detector.close()
        # finalize is the way out: the native engine's full teardown also
        # unlinks the shared-memory names no peer attached to (a TCP-leg
        # peer never maps this process's doorbell)
        getattr(self.engine, "destroy", self.engine.close)()
        self.kvs.close()

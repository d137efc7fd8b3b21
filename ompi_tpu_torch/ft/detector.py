"""Multi-process failure detection — the daemon-heartbeat analog.

≈ the reference's PRRTE daemon heartbeats + in-band BTL error callbacks
(SURVEY.md §5 "failure detection via PRRTE daemon heartbeats + in-band
BTL errors"), scaled the way the reference scales it: heartbeats are
**hierarchical** (PRRTE daemons heartbeat per host, not per proc), not
full-mesh.  Ranks are partitioned into detector groups — by host id
when the launcher published one (``OMPI_TPU_HOST_IDS``), else into
``ft_group_size`` contiguous chunks:

* group **members** heartbeat only their group's *leader* and
  *successor* (the first and second live ranks of the group, in rank
  order); **leaders** heartbeat each other and their own successor —
  per-process control traffic is O(group + groups), not O(P);
* the *leader* watches its members (their heartbeats stop → declared
  failed) and the other leaders; the *successor* watches the leader
  and the members (it is the warm standby) — a dead leader is
  detected by its successor, which assumes leadership
  **deterministically** (leadership is "first live rank of the
  group", recomputed from the failure set — no election protocol);
* plain members watch nobody by timeout: they learn failures through
  leader-relayed gossip (below).  ``note_activity`` stays
  any-inbound-frame for EVERY peer: a rank pinned in a long native
  collective that cannot pump ``hb`` frames but is still moving data
  is alive, whatever its role;
* heartbeats carry the sender's **incarnation**: a frame from an
  incarnation NEWER than the receiver has integrated is proof the
  wired-in prior incarnation died (``tpurun --respawn`` relaunches a
  rank within a heartbeat period — without this rule the reborn
  boot's heartbeats masquerade as the corpse's liveness and mask the
  death forever), and a zombie frame from an incarnation BELOW the
  heal floor is ignored instead of resurrecting a replaced slot;
* failure **gossip** (``flr`` frames) is *versioned*: every record
  carries ``(proc, incarnation, epoch)``.  ``clear_failed`` (the
  replace() heal) bumps the proc's epoch, so a stale late-arriving
  gossip about a prior incarnation/epoch can NEVER re-mark a freshly
  healed or reborn peer — the late-``flr``-vs-``clear_failed`` race
  shrink documents is closed structurally, not by timing;
* false positives **self-heal**: a CURRENT-incarnation heartbeat from
  a proc held failed proves the mark wrong (a real corpse sends
  nothing; a reborn incarnation takes the rebirth branch) — the mark
  retracts at a bumped epoch, fans out to the engine + communicator
  ULFM state, and gossips as a versioned ``flc`` clear record, so the
  cluster converges back on LIVE and survivors' dead-set views cannot
  permanently diverge over a scheduler-starved rank;
* a proc held failed is still **probed**, unless it is retired or a
  newer incarnation has announced itself (its wired-in incarnation is
  a known corpse): a heartbeat flagged ``probe``, at most once a
  period, the gap doubling up to ``timeout``.  The topology drops a
  marked proc from the heartbeat targets, so without the probe two
  processes that mark each other (both stalled past the timeout)
  never send each other a frame that could heal them.  A live
  receiver that holds the prober failed heals it on the probe (the
  branch above), and answers every probe with a heartbeat flagged
  ``ack``, which heals the prober's mark the same way.  A refused
  probe is no news: no strike, no mark.  A corpse answers nothing; a
  reborn incarnation answers with its newer incarnation, the rebirth
  branch;
* gossip converges hierarchically: a detector floods its own group's
  live members plus every live leader; a *leader* that accepts new
  gossip relays it into its group.  An ``flr``/``flc`` frame the
  transport refuses (the native plane refuses a control frame while
  the peer's send path is busy) is retried from the heartbeat loop,
  once a period, while its target is held live, for at most
  ``dcn_connect_timeout``.  As the lost-message backstop, heartbeats
  piggyback an **anti-entropy digest** — leader↔leader, and on a
  member's heartbeats to its leader and successor too (the reference
  digests only leaders' heartbeats: a member whose one relay frame was
  lost stayed ignorant of the death for good).  The digest covers
  marks AND heals: a ``(proc, inc, epoch, failed)`` record for every
  proc held failed or healed at least once (epoch > 0), leaving out
  the heartbeat's two ends (each hears the other directly).  On a
  mismatch either side ships one ``flrsync`` frame: ``recs``, its
  marks (the reference's field), and ``heals``, the ``(proc, inc,
  epoch)`` floors of the procs it holds live.  A heal floor above the
  receiver's epoch for a proc lifts its mark, exactly as an ``flc``
  does (the reference digests marks alone, and a healer with no mark
  left never answered, so a member whose ``flc`` was lost kept a live
  peer failed for good).  Per proc the records are totally ordered,
  (e, live) < (e, failed) < (e + 1, live), so a stale mark loses to a
  newer clear and a stale clear to a newer mark, and survivor
  knowledge converges in O(log groups) heartbeat periods even under
  gossip loss — instead of full-mesh flooding.

In-band detection is unchanged: a failed heartbeat *send* marks only
on the second consecutive strike (one transport reconnect/backoff
round had its chance) and only after two periods of inbound silence
(proof of life outranks a congested send path).  Detections fan out
to every registered communicator's ULFM state and wake DCN receives
blocked on the dead peer.

Enabled by ``--mca ft_detector_enable 1`` (``tpurun --ft`` sets it):
non-FT jobs pay zero heartbeat traffic, like non ``--with-ft`` builds
of the reference.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from typing import Callable, Sequence

from ompi_tpu_torch.core.registry import Component, register_component
from ompi_tpu_torch.core.var import Deadline


def compute_groups(nprocs: int, group_size: int = 8,
                   hosts: Sequence[int] | None = None) -> list[list[int]]:
    """Partition ``range(nprocs)`` into detector groups: by host id
    when the launcher knows the rank→host map (co-located ranks share
    a group — the per-host relay/daemon shape), else into contiguous
    ``group_size`` chunks.  Deterministic on every rank."""
    if hosts is not None and len(hosts) == nprocs:
        by_host: dict[int, list[int]] = {}
        for p, h in enumerate(hosts):
            by_host.setdefault(int(h), []).append(p)
        return [by_host[h] for h in sorted(by_host)]
    group_size = max(1, int(group_size))
    return [list(range(lo, min(lo + group_size, nprocs)))
            for lo in range(0, nprocs, group_size)]


def parse_host_ids(raw: str, nprocs: int) -> list[int] | None:
    """The ``OMPI_TPU_HOST_IDS`` env payload (comma-separated host
    index per rank, launcher-published); None when absent/malformed."""
    if not raw:
        return None
    try:
        ids = [int(x) for x in raw.split(",")]
    except ValueError:
        return None
    return ids if len(ids) == nprocs else None


class HeartbeatDetector:
    """Per-process hierarchical failure detector over the DCN engine's
    peer set (see the module docstring for the topology)."""

    def __init__(self, engine, period: float = 0.25, timeout: float = 2.0,
                 grace: float = 0.0, group_size: int = 0,
                 hosts: Sequence[int] | None = None, digest: bool = True,
                 incarnation: int = 0):
        """``grace`` extends the FIRST detection window: a respawned
        worker boots while survivors may not resume heartbeating to it
        until their replace() clears its failed mark — without the
        grace its fresh detector would declare every silent survivor
        dead within one plain timeout and poison the rejoin.
        ``group_size`` ≤ 0 collapses every rank into ONE group (the
        pre-hierarchical shape for tiny jobs); ``hosts`` overrides the
        chunking with the launcher's rank→host map.  ``incarnation``
        is stamped on outbound heartbeats (see the module docstring's
        rebirth rule)."""
        self.engine = engine
        self.period = float(period)
        self.timeout = float(timeout)
        self.incarnation = int(incarnation)
        #: wall-clock instant the detector was built: every peer's
        #: silence clock starts here (plus ``grace``)
        self.t_boot = time.time()
        self._peers = [p for p in range(engine.nprocs) if p != engine.proc]
        if group_size <= 0:
            group_size = engine.nprocs
        self.groups = compute_groups(engine.nprocs, group_size, hosts)
        self._group = next(g for g in self.groups if engine.proc in g)
        self.digest_enabled = bool(digest)
        now = time.monotonic() + max(0.0, float(grace))
        self._last = {p: now for p in self._peers}
        #: consecutive in-band send failures per heartbeat target; the
        #: second strike marks (the first may be a transient the
        #: transport's reconnect retry heals before the next period)
        self._strikes: dict[int, int] = {p: 0 for p in self._peers}
        self._failed: set[int] = set()
        self._retired: set[int] = set()
        #: versioned-gossip state: per-proc heal epoch (bumped by every
        #: clear_failed) and highest incarnation INTEGRATED (via
        #: clear_failed) — the floor a gossip record must meet to
        #: (re-)mark the proc, and the reference point that tells a
        #: reborn boot's heartbeat apart from the corpse's liveness
        self._epoch: dict[int, int] = {}
        self._inc: dict[int, int] = {}
        #: anti-entropy memo: peer → (their last digest, the
        #: digest we last synced against) so one persistent honest
        #: mismatch (a partial-replace bystander's frozen view) costs
        #: one flrsync, not one per period
        self._synced: dict[int, tuple[str, str]] = {}
        #: probe schedule per proc held failed: the monotonic instant of
        #: the next probe and the gap after it (doubling, capped at
        #: ``timeout``); none = due now, at a gap of one period
        self._probe: dict[int, tuple[float, float]] = {}
        #: procs a newer incarnation has announced (the rebirth branch):
        #: the wired-in incarnation is a corpse, so it is not probed;
        #: cleared when replace() integrates the newer incarnation
        self._superseded: set[int] = set()
        #: gossip records the transport refused, by (target, proc): the
        #: record and the deadline of its retries (a newer record about
        #: the proc takes the older one's place)
        self._resend: dict[tuple[int, int], tuple[dict, Deadline]] = {}
        #: observability counters (telemetry frames pick these up);
        #: ``probes`` counts probe heartbeats sent, ``probe_heals`` the
        #: heals a probe or its answer drove, ``digest_heals`` the marks
        #: lifted by an anti-entropy heal floor, ``gossip_retries`` the
        #: refused gossip sends tried again
        self.counters = {"gossip_tx": 0, "gossip_relayed": 0,
                         "stale_gossip_dropped": 0, "digest_syncs": 0,
                         "rebirth_detects": 0, "false_positive_heals": 0,
                         "probes": 0, "probe_heals": 0, "digest_heals": 0,
                         "gossip_retries": 0}
        self._cbs: list[Callable[[int], None]] = []
        self._heal_cbs: list[Callable[[int], None]] = []
        #: leadership-transition callbacks (telemetry relay failover):
        #: fired with the new is-leader bool when this process's role
        #: changes — the successor that outlives its group leader
        #: learns it is now the leader within one heartbeat period
        self._lead_cbs: list[Callable[[bool], None]] = []
        self._was_leader: bool | None = None
        self._lock = threading.Lock()
        #: held across a mark's or a heal's change of state AND its fan-out
        #: to the communicators and the engine (whose device plane keeps
        #: a failed set of its own): a heal that lands while a mark is
        #: still fanning out waits for it, so every layer ends in the
        #: state of the last transition.  Reentrant: a fan-out callback
        #: may mark or heal.  Gossip sends run outside it.
        self._fan_lock = threading.RLock()
        self._stop = threading.Event()
        engine.attach_detector(self)
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="ompi-ft-detector"
        )
        self._thread.start()

    # -- topology (computed from the live set; lock held) ----------------

    def _live(self, group: list[int]) -> list[int]:
        return [p for p in group
                if p not in self._failed and p not in self._retired]

    def _leader_of(self, group: list[int]) -> int | None:
        live = self._live(group)
        return live[0] if live else None

    def _successor_of(self, group: list[int]) -> int | None:
        live = self._live(group)
        return live[1] if len(live) > 1 else None

    def _leaders_locked(self) -> list[int]:
        out = []
        for g in self.groups:
            lead = self._leader_of(g)
            if lead is not None:
                out.append(lead)
        return out

    def _topology_locked(self) -> tuple[list[int], set[int], bool]:
        """(heartbeat targets, watch set, am-I-a-leader) for this
        period, from the current live view.  Leadership shifts are
        implicit: the successor that outlives its leader computes
        itself leader on the next call — rank order, no election."""
        me = self.engine.proc
        lead = self._leader_of(self._group)
        succ = self._successor_of(self._group)
        members = [p for p in self._live(self._group) if p != me]
        if lead == me:
            targets = [p for p in self._leaders_locked() if p != me]
            if succ is not None:
                targets.append(succ)
            watch = set(members) | {p for p in self._leaders_locked()
                                    if p != me}
            return sorted(set(targets)), watch, True
        targets = [t for t in (lead, succ) if t is not None and t != me]
        if me == succ:
            # warm standby: sees the leader's hb AND the members'
            # (they heartbeat the successor too)
            watch = ({lead} | set(members)) - {me}
            watch.discard(None)
            return sorted(set(targets)), watch, False
        # plain member: no timeout watch — failure knowledge arrives
        # through leader-relayed gossip (+ in-band strikes on its own
        # hb sends to leader/successor)
        return sorted(set(targets)), set(), False

    def _gossip_targets_locked(self, about: int) -> list[int]:
        """Own group's live members + every live leader (the
        hierarchical flood: leaders relay into their groups)."""
        me = self.engine.proc
        out = set(self._live(self._group)) | set(self._leaders_locked())
        out.discard(me)
        out.discard(about)
        return sorted(out)

    def _state_locked(self, peer: int | None) -> list[tuple[int, int, int, bool]]:
        """The versioned record set: ``(proc, inc, epoch, failed)`` for
        every proc held failed or healed at least once, leaving out this
        process, ``peer`` (the other end of the heartbeat) and retired
        procs."""
        me = self.engine.proc
        procs = self._failed | {p for p, e in self._epoch.items() if e > 0}
        return sorted((p, self._inc.get(p, 0), self._epoch.get(p, 0),
                       p in self._failed)
                      for p in procs - self._retired - {me, peer})

    def _digest_locked(self, peer: int | None = None) -> str:
        """Anti-entropy digest of the versioned record set, marks and
        heals, as the heartbeat to ``peer`` carries it."""
        recs = [list(r) for r in self._state_locked(peer)]
        return hashlib.md5(json.dumps(recs).encode()).hexdigest()[:12]

    def _records_locked(self, peer: int | None = None
                        ) -> tuple[list[list[int]], list[list[int]]]:
        """The ``flrsync`` payload for ``peer``: the marks (``recs``) and
        the heal floors of the procs held live (``heals``)."""
        marks, heals = [], []
        for p, inc, epoch, failed in self._state_locked(peer):
            (marks if failed else heals).append([p, inc, epoch])
        return marks, heals

    def _hb_locked(self, dst: int, flag: str | None = None) -> dict:
        """A heartbeat to ``dst``: this incarnation, the digest as
        ``dst`` compares it, and ``flag`` (``probe`` or ``ack``)."""
        env = {"kind": "hb", "src": self.engine.proc}
        if self.incarnation:
            env["inc"] = self.incarnation
        if self.digest_enabled:
            env["dg"] = self._digest_locked(dst)
        if flag is not None:
            env[flag] = 1
        return env

    # -- inbound events (engine receiver thread) ------------------------

    def on_heartbeat(self, src: int, env: dict | None = None) -> None:
        inc = int(env.get("inc", 0)) if env else 0
        with self._lock:
            floor = self._inc.get(src, 0)
        if inc != floor:
            if inc > floor:
                # a NEWER incarnation's boot heartbeat: the launcher
                # only respawns dead ranks, so the incarnation we have
                # wired in is a corpse — this IS the detection (and it
                # beats the silence timeout, which the reborn's frames
                # would otherwise mask by refreshing the corpse's
                # liveness clock forever)
                with self._lock:
                    self._superseded.add(src)
                if self.mark_failed(src, how="rebirth"):
                    with self._lock:
                        self.counters["rebirth_detects"] += 1
            # inc < floor: a zombie frame from a replaced incarnation —
            # it must not resurrect the healed slot's liveness clock
            return
        probed = bool(env and (env.get("probe") or env.get("ack")))
        with self._lock:
            falsely_marked = (src in self._failed
                              and src not in self._retired)
        if falsely_marked:
            # a CURRENT-incarnation heartbeat from a proc we hold
            # failed: the process is demonstrably alive and was never
            # respawned — the mark was a false positive (scheduler
            # starvation on an oversubscribed box, a transient in-band
            # blip).  Heal it at a bumped epoch and gossip the heal,
            # so the whole cluster converges back on LIVE and any
            # still-circulating flr about the false mark is stale on
            # arrival.  A REAL death cannot flap this way: a corpse
            # sends nothing, and a reborn incarnation's frames take
            # the rebirth branch above.
            self._heal(src, origin=True, how="probe" if probed else None)
        self.note_activity(src)
        if env is not None and env.get("probe"):
            # the prober holds us failed: answer, so that its mark lifts
            # even where we send it no heartbeat of the topology's
            with self._lock:
                ack = (None if src in self._failed or src in self._retired
                       else self._hb_locked(src, "ack"))
            if ack is not None:
                try:
                    self.engine.send_ctrl(src, ack)
                except Exception:  # noqa: BLE001 — the next probe asks again
                    pass
        if env is None or not self.digest_enabled:
            return
        dg = env.get("dg")
        if dg is None:
            return
        # anti-entropy: a digest mismatch means the sender's record set
        # (marks and heal floors) differs from ours — ship ours once per
        # (their digest, our digest) pair, whichever side is behind;
        # stale records are dropped by the receiver's version floor, so
        # a persistent honest disagreement (partial-replace bystander)
        # costs one frame, not a storm
        with self._lock:
            mine = self._digest_locked(src)
            if dg == mine:
                self._synced.pop(src, None)
                return
            if self._synced.get(src) == (dg, mine):
                return
            recs, heals = self._records_locked(src)
            if not recs and not heals:
                return
            self._synced[src] = (dg, mine)
            self.counters["digest_syncs"] += 1
        try:
            self.engine.send_ctrl(src, {"kind": "flrsync",
                                        "src": self.engine.proc,
                                        "recs": recs, "heals": heals})
        except Exception:  # noqa: BLE001 — refused: the next heartbeat
            with self._lock:  # from src asks again
                if self._synced.get(src) == (dg, mine):
                    del self._synced[src]

    def note_activity(self, src: int) -> None:
        """Refresh a peer's liveness clock.  Called for ``hb`` frames
        AND for every other inbound frame the engine routes (coll,
        p2p, control) plus completed native-plane receives — proof of
        life is proof of life, whatever frame carried it."""
        with self._lock:
            if src in self._last:
                self._last[src] = time.monotonic()

    def on_gossip(self, env: dict) -> None:
        """A received ``flr`` record — versioned: ``(proc, inc,
        epoch)`` below this detector's heal floor for the proc is
        STALE and dropped (the late-gossip-vs-clear race), anything
        else marks; a leader relays accepted news into its group."""
        proc = int(env["proc"])
        self.mark_failed(proc, gossip="relay",
                         inc=int(env.get("inc", 0)),
                         epoch=int(env.get("epoch", 0)),
                         src=env.get("src"), how="gossip")

    def on_flrsync(self, env: dict) -> None:
        """Anti-entropy payload: merge every mark through the same
        versioned validation gossip uses, and every heal floor through
        the one an ``flc`` takes."""
        for key in ("recs", "heals"):
            for rec in env.get(key) or ():
                try:
                    proc, inc, epoch = int(rec[0]), int(rec[1]), int(rec[2])
                except (TypeError, ValueError, IndexError):
                    continue
                if key == "recs":
                    self.mark_failed(proc, gossip="relay", inc=inc,
                                     epoch=epoch, src=env.get("src"),
                                     how="digest")
                else:
                    self._heal(proc, inc=inc, epoch=epoch,
                               src=env.get("src"), how="digest")

    def _heal(self, proc: int, inc: int | None = None,
              epoch: int | None = None, origin: bool = False,
              src=None, how: str | None = None) -> bool:
        """Un-mark a falsely-failed peer (the live-heartbeat proof
        above, a received ``flc`` clear record, or an anti-entropy heal
        floor).  An ORIGIN heal bumps the epoch past the false mark's —
        the same versioning ``clear_failed`` uses — so the clear wins
        over every copy of the stale ``flr`` still circulating; remote
        clears below the floor are themselves stale and dropped.  Fans
        out to the engine and the registered heal callbacks
        (communicator ULFM state), and gossips/relays like a failure
        record.  ``how``: ``probe`` (a probe or its answer drove the
        heal) or ``digest`` (an ``flrsync`` heal floor), for the
        counters."""
        with self._fan_lock:
            targets, rec = self._heal_fan_out(proc, inc, epoch, origin, src,
                                              how)
        if targets is None:
            return False
        self._gossip(targets, rec)
        return True

    def _heal_fan_out(self, proc: int, inc, epoch, origin: bool, src,
                      how: str | None = None):
        """The state change and fan-out half of :meth:`_heal` (under
        ``_fan_lock``): the gossip targets and record, or ``(None,
        None)`` when nothing was healed."""
        with self._lock:
            if proc in self._retired or proc == self.engine.proc:
                return None, None
            floor_e = self._epoch.get(proc, 0)
            if origin:
                epoch = floor_e + 1
                inc = self._inc.get(proc, 0)
            else:
                epoch = int(epoch or 0)
                inc = int(inc or 0)
                if epoch <= floor_e:
                    # a clear only wins when its epoch BEATS the mark's
                    # (origin heals bump past it); anything else is a
                    # stale clear racing fresher knowledge
                    if proc in self._failed:
                        self.counters["stale_gossip_dropped"] += 1
                    return None, None
            was_failed = proc in self._failed
            self._failed.discard(proc)
            self._epoch[proc] = max(floor_e, int(epoch))
            self._inc[proc] = max(self._inc.get(proc, 0), int(inc))
            if proc in self._last:
                self._last[proc] = time.monotonic()
                self._strikes[proc] = 0
            if not was_failed:
                return None, None  # floor adopted; nothing to fan out
            self._probe.pop(proc, None)
            self._superseded.discard(proc)
            if origin:
                self.counters["false_positive_heals"] += 1
            if how is not None:
                self.counters[f"{how}_heals"] += 1
            cbs = list(self._heal_cbs)
            relay = origin or (self._leader_of(self._group)
                               == self.engine.proc)
            targets = self._gossip_targets_locked(proc) if relay else []
            if src is not None:
                targets = [t for t in targets if t != src]
            rec = {"kind": "flc", "proc": int(proc), "inc": int(inc),
                   "epoch": int(self._epoch[proc]),
                   "src": self.engine.proc}
        heal = getattr(self.engine, "note_proc_healed", None)
        if heal is not None:
            heal(proc)
        for cb in cbs:
            try:
                cb(proc)
            except Exception:  # noqa: BLE001 — a bad callback must not
                import traceback  # kill the caller

                traceback.print_exc()
        return targets, rec

    def on_clear(self, env: dict) -> None:
        """A received ``flc`` heal record — versioned like ``flr``:
        clears the mark when its epoch beats the floor; a leader
        relays accepted clears into its group."""
        self._heal(int(env["proc"]), inc=int(env.get("inc", 0)),
                   epoch=int(env.get("epoch", 0)), src=env.get("src"))

    def on_failure(self, cb: Callable[[int], None]) -> None:
        """Register a callback(proc) fired once per detected failure;
        immediately replayed for already-known failures."""
        with self._lock:
            known = set(self._failed)
            self._cbs.append(cb)
        for p in known:
            cb(p)

    def on_heal(self, cb: Callable[[int], None]) -> None:
        """Register a callback(proc) fired when a false-positive mark
        is healed (live heartbeat or flc record) — the un-fail fan-out
        that clears communicator ULFM state."""
        with self._lock:
            self._heal_cbs.append(cb)

    def on_leadership(self, cb: Callable[[bool], None]) -> None:
        """Register a callback(is_leader) fired when THIS process's
        group role flips (deterministic takeover: the successor that
        outlives its leader computes itself leader on the next period).
        The telemetry plane uses it to promote the successor's relay
        (:mod:`~ompi_tpu_torch.metrics.live` re-registers ``relay.g<i>``) so
        a dead group-leader relay degrades members for at most a few
        publish intervals instead of for the rest of the job."""
        with self._lock:
            self._lead_cbs.append(cb)
            if self._was_leader is None:
                self._was_leader = (self._leader_of(self._group)
                                    == self.engine.proc)

    def failed(self) -> set[int]:
        with self._lock:
            return set(self._failed)

    def epoch_of(self, proc: int) -> int:
        """The proc's current heal epoch (0 = never healed)."""
        with self._lock:
            return self._epoch.get(proc, 0)

    def note_incarnation(self, proc: int, incarnation: int) -> None:
        """Adopt an incarnation floor for a peer WITHOUT touching its
        failure mark: a reborn process seeds its fresh detector from
        the recovery beacon's floors so a FELLOW reborn peer's
        current-incarnation heartbeats read as liveness, not as a
        rebirth detection.  (Found by the multi-host chaos harness: a
        whole-host kill rebirths several co-grouped ranks at once, and
        without the floors each reborn detector 'rebirth-detected' the
        other and poisoned the healed mesh's next collective.)"""
        with self._lock:
            if int(incarnation) > self._inc.get(proc, 0):
                self._inc[proc] = int(incarnation)

    def clear_failed(self, proc: int, incarnation: int | None = None) -> None:
        """Elastic recovery (replace()): the failed proc respawned with
        a new incarnation — un-mark it, restart its liveness clock,
        zero its strike count, and **bump its heal epoch** so any
        still-in-flight gossip about the prior epoch/incarnation is
        stale on arrival and can never re-mark the healed peer.  The
        engine's address table must already point at the reborn
        incarnation's endpoint (the caller's job), or the resumed
        heartbeats would re-detect the corpse.  Waits for a mark's
        fan-out in flight, so the engine's clear that follows this call
        comes after it."""
        with self._fan_lock, self._lock:
            self._failed.discard(proc)
            self._epoch[proc] = self._epoch.get(proc, 0) + 1
            if incarnation is not None:
                self._inc[proc] = max(self._inc.get(proc, 0),
                                      int(incarnation))
            if proc in self._last:
                self._last[proc] = time.monotonic()
                self._strikes[proc] = 0
            self._probe.pop(proc, None)
            self._superseded.discard(proc)

    def retire_peer(self, proc: int) -> None:
        """Stop watching a peer entirely (partial-communicator rejoin,
        scale-down): this process has NO live relationship with it —
        under a partial ``replace()`` the non-member procs rightly
        never resume heartbeating to a reborn incarnation, and their
        correct silence must not be re-detected as THEIR death.
        Leadership recomputes around the retiree like around a death."""
        with self._lock:
            self._peers = [p for p in self._peers if p != proc]
            self._retired.add(proc)
            self._last.pop(proc, None)
            self._strikes.pop(proc, None)
            self._failed.discard(proc)
            self._probe.pop(proc, None)
            for key in [k for k in self._resend if k[0] == proc]:
                del self._resend[key]

    def mark_failed(self, proc: int, gossip=True, inc: int | None = None,
                    epoch: int | None = None, src=None,
                    how: str = "engine") -> bool:
        """Declare ``proc`` dead (timeout, in-band error, rebirth
        announcement, or gossip).

        ``how`` names the path the news came by — ``strike`` (two failed
        heartbeat sends), ``timeout`` (silence), ``rebirth``, ``gossip``
        (an ``flr`` record), ``digest`` (an anti-entropy ``flrsync``) or
        ``engine`` (a transport or deadline escalation).  The detector
        does not act on it; an observer that wraps this method reads it.

        Local detections (no ``inc``/``epoch``) are stamped with the
        proc's CURRENT floor — always valid.  Remote records below the
        floor are stale and dropped (counted).  ``gossip``: True =
        originate (flood group + leaders), ``"relay"`` = received news
        (a leader relays it into its group, a member does not), False
        = silent.  Returns True when the proc was newly marked.

        A ``timeout`` mark stands only if the proc is still silent when
        it is taken: a frame that arrived after the heartbeat loop's scan
        proves it alive."""
        with self._fan_lock:
            targets, rec = self._mark_fan_out(proc, gossip, inc, epoch, src, how)
        if targets is None:
            return False
        if targets:
            key = "gossip_relayed" if gossip == "relay" else "gossip_tx"
            with self._lock:
                self.counters[key] += 1
            self._gossip(targets, rec)
        return True

    def _gossip(self, targets, rec: dict) -> None:
        """Send one ``flr``/``flc`` record to every target held live.  A
        send the transport refuses is left to :meth:`_retry_gossip`; a
        sent one supersedes a refused older record about the proc."""
        for p in targets:
            if p in self.failed():
                continue
            try:
                self.engine.send_ctrl(p, rec)
            except Exception:  # noqa: BLE001 — refused, or the peer is dead
                with self._lock:
                    self._resend[(p, rec["proc"])] = (
                        rec, Deadline.for_timeout("connect"))
                continue
            with self._lock:
                self._resend.pop((p, rec["proc"]), None)

    def _retry_gossip(self) -> None:
        """Try every refused gossip record again (the heartbeat loop,
        once a period): dropped once its target is held failed or
        retired, or past ``dcn_connect_timeout`` of refusals; the
        anti-entropy digest makes good what is dropped."""
        with self._lock:
            pending = list(self._resend.items())
        for key, (rec, deadline) in pending:
            with self._lock:
                if self._resend.get(key, (None,))[0] is not rec:
                    continue  # sent, or superseded, meanwhile
                p = key[0]
                if (p in self._failed or p in self._retired
                        or deadline.expired()):
                    del self._resend[key]
                    continue
                self.counters["gossip_retries"] += 1
            try:
                self.engine.send_ctrl(p, rec)
            except Exception:  # noqa: BLE001 — refused again
                continue
            with self._lock:
                if self._resend.get(key, (None,))[0] is rec:
                    del self._resend[key]

    def _mark_fan_out(self, proc: int, gossip, inc, epoch, src, how: str):
        """The state change and fan-out half of :meth:`mark_failed`
        (under ``_fan_lock``): the gossip targets and record, or
        ``(None, None)`` when nothing was marked."""
        with self._lock:
            if (proc in self._failed or proc == self.engine.proc
                    or proc in self._retired):
                return None, None
            if (how == "timeout" and proc in self._last
                    and time.monotonic() - self._last[proc] <= self.timeout):
                return None, None
            floor_e = self._epoch.get(proc, 0)
            floor_i = self._inc.get(proc, 0)
            if inc is None:
                inc = floor_i
            if epoch is None:
                epoch = floor_e
            if epoch < floor_e or inc < floor_i:
                self.counters["stale_gossip_dropped"] += 1
                return None, None
            self._failed.add(proc)
            self._inc[proc] = int(inc)
            self._epoch[proc] = int(epoch)
            self._probe.pop(proc, None)  # probe at the next period
            cbs = list(self._cbs)
            relay = (gossip is True
                     or (gossip == "relay"
                         and self._leader_of(self._group)
                         == self.engine.proc))
            targets = self._gossip_targets_locked(proc) if relay else []
            if src is not None:
                targets = [t for t in targets if t != src]
        # the communicators' ULFM marks first, then the engine's: marking
        # the engine wakes every receive blocked on the proc, and a woken
        # survivor that goes straight to replace()/shrink() must find the
        # failure in its comm's state (the reverse order lets it read an
        # empty failed set and refuse to recover)
        for cb in cbs:
            try:
                cb(proc)
            except Exception:  # noqa: BLE001 — a bad callback must not
                import traceback  # kill the detector thread

                traceback.print_exc()
        self.engine.note_proc_failed(proc)
        return targets, {"kind": "flr", "proc": int(proc), "inc": int(inc),
                         "epoch": int(epoch), "src": self.engine.proc}

    # -- heartbeat loop --------------------------------------------------

    def _probes_locked(self) -> dict[int, dict]:
        """The probes due this period (see the module docstring), their
        schedule advanced: one heartbeat flagged ``probe`` to each proc
        held failed, not retired and not superseded, whose gap has run
        out."""
        now = time.monotonic()
        due = {}
        for p in sorted(self._failed):
            at, gap = self._probe.get(p, (now, self.period))
            if (p in self._retired or p in self._superseded
                    or p not in self._last or now < at):
                continue
            self._probe[p] = (now + gap, min(2 * gap, self.timeout))
            due[p] = self._hb_locked(p, "probe")
            self.counters["probes"] += 1
        return due

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            with self._lock:
                targets, watch, is_leader = self._topology_locked()
                # every heartbeat carries the digest, a member's too:
                # a member hears of a death only through its leader's
                # one gossip frame, and the push on a mismatch is the
                # only way a lost one is made good
                beats = {p: self._hb_locked(p) for p in targets}
                probes = self._probes_locked()
                flipped = (self._lead_cbs and self._was_leader is not None
                           and is_leader != self._was_leader)
                if self._was_leader is not None or self._lead_cbs:
                    self._was_leader = is_leader
                lead_cbs = list(self._lead_cbs) if flipped else []
            for cb in lead_cbs:
                try:
                    cb(is_leader)
                except Exception:  # noqa: BLE001 — a bad callback must
                    import traceback  # not kill the heartbeat loop

                    traceback.print_exc()
            self._retry_gossip()
            for p, env in beats.items():
                if p in self._failed or p not in self._strikes:
                    continue  # failed, or retired mid-iteration
                try:
                    self.engine.send_ctrl(p, env)
                    self._strikes[p] = 0
                except Exception:  # noqa: BLE001 — in-band detection
                    # two strikes: the first failure tolerates a link
                    # blip the transport's reconnect/backoff round can
                    # heal before the next heartbeat; the second (one
                    # full period later, retry round exhausted) marks —
                    # UNLESS the peer's inbound frames prove it alive
                    # (a full ring backpressures our sends while the
                    # busy peer keeps talking; proof of life outranks
                    # a congested send path)
                    self._strikes[p] = self._strikes.get(p, 0) + 1
                    if self._strikes[p] >= 2:
                        # two periods of inbound silence: a live
                        # backpressured peer refreshes _last at least
                        # every period (its own heartbeats), a dead
                        # one cannot — so in-band marking stays far
                        # faster than the full timeout without it
                        with self._lock:
                            quiet = (time.monotonic()
                                     - self._last.get(p, time.monotonic())
                                     > 2 * self.period)
                        if quiet:
                            self.mark_failed(p, how="strike")
            for p, env in probes.items():
                try:
                    self.engine.send_ctrl(p, env)
                except Exception:  # noqa: BLE001 — a refused probe to a
                    pass  # proc already held failed is no news
            now = time.monotonic()
            with self._lock:
                late = [p for p in watch
                        if p is not None and p not in self._failed
                        and p in self._last
                        and now - self._last[p] > self.timeout]
            for p in late:
                self.mark_failed(p, how="timeout")

    def close(self) -> None:
        """Stop AND join: the transport is torn down right after, and a
        mid-iteration heartbeat hitting the closing socket would
        spuriously mark live peers failed (and gossip it)."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2 * self.period + 1.0)


@register_component
class FtDetectorComponent(Component):
    """``ft/detector`` MCA component — owns the detector's tunables.
    (``ft_group_size``/``ft_gossip_digest`` live in the central
    ROBUSTNESS_VARS table like the deadline family — consumed here,
    introspectable everywhere.)"""

    FRAMEWORK = "ft"
    NAME = "detector"
    PRIORITY = 50

    def register_params(self, store) -> None:
        super().register_params(store)
        store.register(
            "ft", "detector", "enable", False,
            help="Run the DCN heartbeat failure detector (tpurun --ft "
            "sets this; ≈ building the reference --with-ft=ulfm)",
        )
        store.register(
            "ft", "detector", "period", 0.25, type="float",
            help="Heartbeat send interval, seconds",
        )
        store.register(
            "ft", "detector", "timeout", 2.0, type="float",
            help="Silence after which a peer is declared failed, seconds",
        )

    def params(self, store) -> dict:
        self.register_params(store)
        return {
            "enable": bool(store.get("ft_detector_enable")),
            "period": float(store.get("ft_detector_period")),
            "timeout": float(store.get("ft_detector_timeout")),
            "group_size": int(store.get("ft_group_size", 8) or 8),
            "digest": bool(store.get("ft_gossip_digest", True)),
        }

"""Hierarchical control plane of the port — the reference's cases
(``tests/test_hier.py``) on ``ompi_tpu_torch``, with the values they
yield held to the reference's on the same inputs.

Covers the four legs at the unit level (the np≥16 chaos proof is
``chaos --scale`` in both packages; the port's slow case drives
``python -m ompi_tpu_torch chaos --scale --np 16 --cpu``):

* detector group topology: partitioning (size / host map), the
  deterministic leader/successor roles, rank-order takeover;
* versioned failure gossip: the shrink-documented late-``flr``-vs-
  ``clear_failed`` race as a deterministic regression test (stale
  gossip about a healed incarnation must be dropped — this test FAILS
  against the unversioned detector, which re-marks on any flr), the
  rebirth-heartbeat rule, and the leader↔leader anti-entropy digest;
* sharded lazy modex substrate: ``KVSServer``/``KVSClient`` prefix
  scan + op counters, the lazy ``AddressTable``;
* per-group telemetry relays: batched-frame unwrap at the aggregator.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from ompi_tpu.ft import detector as ref_detector
from ompi_tpu_torch.ft.detector import (HeartbeatDetector, compute_groups,
                                        parse_host_ids)

REPO = Path(__file__).resolve().parent.parent


class _StubEngine:
    def __init__(self, proc=0, nprocs=16):
        self.proc = proc
        self.nprocs = nprocs
        self.noted = []
        self.sent = []
        self.detector = None

    def attach_detector(self, det):
        self.detector = det

    def send_ctrl(self, p, env):
        self.sent.append((p, dict(env)))

    def note_proc_failed(self, p):
        self.noted.append(p)


def _quiet_detector(proc=0, nprocs=16, group_size=8, **kw):
    """A detector whose loop never fires (period 60 s): the tests
    drive the inbound handlers directly, deterministically."""
    eng = _StubEngine(proc, nprocs)
    return eng, HeartbeatDetector(eng, period=60.0, timeout=120.0,
                                  group_size=group_size, **kw)


# -- topology ----------------------------------------------------------


def test_compute_groups_chunks_and_hosts():
    for args, kw in (((16, 8), {}), ((5, 8), {}), ((9, 4), {}),
                     ((6, 2), {"hosts": [1, 0, 1, 0, 1, 0]})):
        assert compute_groups(*args, **kw) == ref_detector.compute_groups(*args, **kw)
    assert compute_groups(16, 8) == [list(range(8)), list(range(8, 16))]
    assert compute_groups(5, 8) == [[0, 1, 2, 3, 4]]
    assert compute_groups(9, 4) == [[0, 1, 2, 3], [4, 5, 6, 7], [8]]
    # host-map grouping wins over chunking (co-located ranks together)
    assert compute_groups(6, 2, hosts=[1, 0, 1, 0, 1, 0]) == \
        [[1, 3, 5], [0, 2, 4]]
    assert parse_host_ids("0,0,1,1", 4) == [0, 0, 1, 1]
    assert parse_host_ids("0,0,1", 4) is None  # wrong arity
    assert parse_host_ids("a,b,c,d", 4) is None
    assert parse_host_ids("", 4) is None


def test_topology_roles_and_traffic_shape():
    """Member → leader+successor; successor → leader; leader → other
    leaders + own successor.  Per-process heartbeat fan-out stays
    O(group + groups), never O(P)."""
    # plain member (rank 5 of group [0..7])
    eng, det = _quiet_detector(proc=5)
    try:
        targets, watch, lead = det._topology_locked()
        assert targets == [0, 1] and watch == set() and not lead
    finally:
        det.close()
    # successor: watches the leader AND the members (warm standby)
    eng, det = _quiet_detector(proc=1)
    try:
        targets, watch, lead = det._topology_locked()
        assert targets == [0] and not lead
        assert watch == {0, 2, 3, 4, 5, 6, 7}
    finally:
        det.close()
    # leader: other groups' leaders + own successor; watches members
    # and the other leaders
    eng, det = _quiet_detector(proc=8)
    try:
        targets, watch, lead = det._topology_locked()
        assert lead and targets == [0, 9]
        assert watch == {0} | set(range(9, 16))
    finally:
        det.close()


def test_leader_takeover_is_rank_order_deterministic():
    """A dead leader's successor computes itself leader (no election);
    the next live rank becomes the new successor."""
    eng, det = _quiet_detector(proc=2, group_size=8)
    try:
        targets, watch, lead = det._topology_locked()
        assert not lead and targets == [0, 1]
        det.mark_failed(0, gossip=False)
        targets, watch, lead = det._topology_locked()
        # rank 1 took over; rank 2 is now the successor and watches it
        assert not lead and targets == [1] and 1 in watch
        det.mark_failed(1, gossip=False)
        targets, watch, lead = det._topology_locked()
        # rank 2's turn: leader of group 0, heartbeats group 1's
        # leader + its own successor (3), watches members + leaders
        assert lead and targets == [3, 8]
        assert watch == {3, 4, 5, 6, 7, 8}
    finally:
        det.close()


@pytest.mark.parametrize("proc", [0, 1, 2, 5, 8, 9, 15])
def test_topology_and_takeover_match_reference(proc):
    """The roles each package's detector computes (heartbeat targets,
    watch set, leadership) agree on the same 16-process layout, before
    and after the leaders of both groups and a successor die."""
    seqs = []
    for mod in (ref_detector, HeartbeatDetector.__module__):
        mod = sys.modules[mod] if isinstance(mod, str) else mod
        eng = _StubEngine(proc, 16)
        det = mod.HeartbeatDetector(eng, period=60.0, timeout=120.0, group_size=8)
        try:
            seq = [det._topology_locked()]
            for dead in (0, 1, 8):
                if dead != proc:
                    det.mark_failed(dead, gossip=False)
                    seq.append(det._topology_locked())
            seqs.append(seq)
        finally:
            det.close()
    assert seqs[0] == seqs[1]


# -- versioned gossip (the shrink-documented race, closed) -------------


def test_stale_gossip_cannot_remark_healed_peer():
    """THE regression test for the late-``flr``-vs-``clear_failed``
    race: survivor A's gossip about incarnation k−1 arrives AFTER this
    rank's replace() healed the peer at incarnation k — the stale
    record must be dropped.  The unversioned detector marked on any
    flr, so this test fails against it by construction."""
    eng, det = _quiet_detector(proc=0)
    try:
        # the death of incarnation 0, detected locally and gossiped
        det.on_gossip({"kind": "flr", "proc": 5, "inc": 0, "epoch": 0,
                       "src": 1})
        assert 5 in det.failed()
        # replace() healed the proc at incarnation 1 (epoch bumps)
        det.clear_failed(5, incarnation=1)
        assert 5 not in det.failed()
        # the RACE: a survivor's late gossip about the corpse
        det.on_gossip({"kind": "flr", "proc": 5, "inc": 0, "epoch": 0,
                       "src": 3})
        assert 5 not in det.failed(), \
            "stale flr re-marked a healed peer (the documented race)"
        assert det.counters["stale_gossip_dropped"] == 1
        # a legacy unversioned record (no inc/epoch fields) about the
        # pre-heal world is equally stale
        det.on_gossip({"kind": "flr", "proc": 5})
        assert 5 not in det.failed()
        # but a FRESH death of the new incarnation still marks
        det.on_gossip({"kind": "flr", "proc": 5, "inc": 1, "epoch": 1,
                       "src": 1})
        assert 5 in det.failed()
    finally:
        det.close()


#: scripted detector inputs (method, args, kwargs) replayed on both
#: packages' detectors
_GOSSIP_SCRIPTS = {
    "stale_gossip": (0, [
        ("on_gossip", ({"kind": "flr", "proc": 5, "inc": 0, "epoch": 0, "src": 1},), {}),
        ("clear_failed", (5,), {"incarnation": 1}),
        ("on_gossip", ({"kind": "flr", "proc": 5, "inc": 0, "epoch": 0, "src": 3},), {}),
        ("on_gossip", ({"kind": "flr", "proc": 5},), {}),
        ("on_gossip", ({"kind": "flr", "proc": 5, "inc": 1, "epoch": 1, "src": 1},), {}),
    ]),
    "relay_leader": (8, [
        ("on_gossip", ({"kind": "flr", "proc": 3, "inc": 0, "epoch": 0, "src": 0},), {}),
    ]),
    "relay_member": (10, [
        ("on_gossip", ({"kind": "flr", "proc": 3, "inc": 0, "epoch": 0, "src": 8},), {}),
    ]),
    "takeover_marks": (2, [
        ("mark_failed", (0,), {"gossip": True}),
        ("mark_failed", (1,), {"gossip": True}),
        ("mark_failed", (9,), {"gossip": False}),
    ]),
}


@pytest.mark.parametrize("name", sorted(_GOSSIP_SCRIPTS))
def test_gossip_scripts_match_reference(name):
    """The same gossip inputs leave both packages' detectors with the
    same failed set, counters, outbound control frames (target, kind,
    proc) and engine notifications.  The port's counters add the
    probe, heal and retry counts, which these scripts leave at zero."""
    proc, script = _GOSSIP_SCRIPTS[name]
    seen, extra = [], {}
    for mod in (ref_detector, sys.modules[HeartbeatDetector.__module__]):
        eng = _StubEngine(proc, 16)
        det = mod.HeartbeatDetector(eng, period=60.0, timeout=120.0, group_size=8)
        try:
            for method, args, kwargs in script:
                getattr(det, method)(*args, **kwargs)
            counters = dict(det.counters)
            if seen:
                extra = {k: counters.pop(k) for k in set(counters) - set(seen[0][1])}
            seen.append((sorted(det.failed()), counters,
                         [(p, e.get("kind"), e.get("proc")) for p, e in eng.sent],
                         list(eng.noted)))
        finally:
            det.close()
    assert seen[0] == seen[1]
    assert extra == {"probes": 0, "probe_heals": 0, "digest_heals": 0,
                     "gossip_retries": 0}


def test_gossip_routes_through_engine_frame_path():
    """The wire path: a real engine's ``_on_frame`` routes flr frames
    into the versioned handler (this is what a peer's gossip actually
    traverses — the unversioned code called mark_failed directly)."""
    import numpy as np

    from ompi_tpu_torch.dcn.collops import DcnCollEngine

    eng = DcnCollEngine(0, 2)
    det = HeartbeatDetector(eng, period=60.0, timeout=120.0)
    try:
        empty = np.zeros(0, np.uint8)
        eng._on_frame({"kind": "flr", "proc": 1, "inc": 0, "epoch": 0},
                      empty)
        assert det.failed() == {1}
        det.clear_failed(1, incarnation=1)
        eng._on_frame({"kind": "flr", "proc": 1, "inc": 0, "epoch": 0},
                      empty)
        assert det.failed() == set()
        # flrsync frames merge through the same validation
        eng._on_frame({"kind": "flrsync", "src": 1,
                       "recs": [[1, 0, 0]]}, empty)
        assert det.failed() == set()
        eng._on_frame({"kind": "flrsync", "src": 1,
                       "recs": [[1, 1, 1]]}, empty)
        assert det.failed() == {1}
    finally:
        det.close()
        eng.close()


def test_rebirth_heartbeat_detects_and_zombie_is_ignored():
    """A heartbeat from a NEWER incarnation than integrated is proof
    the wired-in incarnation died (tpurun respawns within a period —
    without this the reborn's frames mask the death forever); a
    zombie frame BELOW the heal floor must not refresh liveness."""
    eng, det = _quiet_detector(proc=0)
    try:
        det.on_heartbeat(5, {"kind": "hb", "src": 5})
        assert 5 not in det.failed()
        # reborn incarnation 1 boots and heartbeats before any timeout
        det.on_heartbeat(5, {"kind": "hb", "src": 5, "inc": 1})
        assert 5 in det.failed()
        assert det.counters["rebirth_detects"] == 1
        # replace() integrates incarnation 1 → its heartbeats are life
        det.clear_failed(5, incarnation=1)
        det.on_heartbeat(5, {"kind": "hb", "src": 5, "inc": 1})
        assert 5 not in det.failed()
        # a zombie frame from the corpse must not refresh the clock
        with det._lock:
            det._last[5] = 0.0
        det.on_heartbeat(5, {"kind": "hb", "src": 5})  # inc 0 < floor 1
        with det._lock:
            assert det._last[5] == 0.0
        det.on_heartbeat(5, {"kind": "hb", "src": 5, "inc": 1})
        with det._lock:
            assert det._last[5] > 0.0
    finally:
        det.close()


def test_digest_anti_entropy_syncs_lost_gossip():
    """Leader B holds a failure record leader A never heard (the flr
    was lost): A's digest-bearing heartbeat triggers ONE flrsync from
    B, and the memo stops a repeat for the same digest pair."""
    ea, da = _quiet_detector(proc=0)
    eb, db = _quiet_detector(proc=8)
    try:
        db.mark_failed(9, gossip=False)
        # wire B's outbound ctrl to A's handlers for the test
        dga = da._digest_locked()
        db.on_heartbeat(0, {"kind": "hb", "src": 0, "dg": dga})
        syncs = [(p, env) for p, env in eb.sent
                 if env.get("kind") == "flrsync"]
        assert len(syncs) == 1 and syncs[0][0] == 0
        da.on_flrsync(syncs[0][1])
        assert 9 in da.failed()
        # same digest pair again → memoized, no second sync
        db.on_heartbeat(0, {"kind": "hb", "src": 0, "dg": dga})
        assert len([1 for p, env in eb.sent
                    if env.get("kind") == "flrsync"]) == 1
        assert db.counters["digest_syncs"] == 1
    finally:
        da.close()
        db.close()


def test_gossip_relay_is_leader_only():
    """Received gossip: a leader relays into its group, a plain member
    does not (the hierarchical flood instead of full-mesh)."""
    # leader of group 1 receives gossip about a group-0 proc
    eng, det = _quiet_detector(proc=8)
    try:
        det.on_gossip({"kind": "flr", "proc": 3, "inc": 0, "epoch": 0,
                       "src": 0})
        relayed = {p for p, env in eng.sent if env.get("kind") == "flr"}
        # into its own group (9..15) — not back to the source
        assert relayed and relayed <= set(range(9, 16))
        assert det.counters["gossip_relayed"] == 1
    finally:
        det.close()
    eng, det = _quiet_detector(proc=10)
    try:
        det.on_gossip({"kind": "flr", "proc": 3, "inc": 0, "epoch": 0,
                       "src": 8})
        assert not [1 for p, env in eng.sent
                    if env.get("kind") == "flr"]
    finally:
        det.close()


def test_false_positive_heals_on_live_heartbeat():
    """A current-incarnation heartbeat from a proc held failed proves
    the mark false: it retracts at a bumped epoch, the engine mark
    clears, the heal gossips as an ``flc`` record, and the epoch bump
    makes still-circulating flr copies stale."""
    eng, det = _quiet_detector(proc=0)
    healed: list[int] = []
    det.on_heal(healed.append)
    try:
        det.mark_failed(5, gossip=False)
        assert 5 in det.failed() and eng.noted == [5]
        det.on_heartbeat(5, {"kind": "hb", "src": 5})  # alive, inc 0
        assert 5 not in det.failed()
        assert healed == [5]
        assert det.counters["false_positive_heals"] == 1
        assert det.epoch_of(5) == 1
        clears = [(p, env) for p, env in eng.sent
                  if env.get("kind") == "flc"]
        assert clears and all(env["proc"] == 5 and env["epoch"] == 1
                              for _, env in clears)
        # the stale flr the heal outran cannot re-mark
        det.on_gossip({"kind": "flr", "proc": 5, "inc": 0, "epoch": 0})
        assert 5 not in det.failed()
        # a FRESH death at the healed epoch still marks
        det.on_gossip({"kind": "flr", "proc": 5, "inc": 0, "epoch": 1})
        assert 5 in det.failed()
    finally:
        det.close()


def test_clear_record_propagates_and_stale_clear_drops():
    """Receiver side of the heal: an ``flc`` whose epoch beats the
    mark's clears it; a stale clear loses to fresher knowledge."""
    eng, det = _quiet_detector(proc=3)
    try:
        det.on_gossip({"kind": "flr", "proc": 6, "inc": 0, "epoch": 0})
        assert 6 in det.failed()
        det.on_clear({"kind": "flc", "proc": 6, "inc": 0, "epoch": 1,
                      "src": 0})
        assert 6 not in det.failed() and det.epoch_of(6) == 1
        # re-marked at the new epoch, then a STALE clear (epoch 1)
        # must not retract it
        det.on_gossip({"kind": "flr", "proc": 6, "inc": 0, "epoch": 1})
        assert 6 in det.failed()
        det.on_clear({"kind": "flc", "proc": 6, "inc": 0, "epoch": 1,
                      "src": 0})
        assert 6 in det.failed()
        assert det.counters["stale_gossip_dropped"] >= 1
    finally:
        det.close()


def test_heal_fans_out_to_comm_ulfm_state():
    """The un-fail fan-out: ProcContext heal callbacks clear the
    comm's ULFM failed ranks (engine path exercised via a stub)."""
    from ompi_tpu_torch.dcn.collops import DcnCollEngine
    from ompi_tpu_torch.ft import ulfm

    eng = DcnCollEngine(0, 4)
    det = HeartbeatDetector(eng, period=60.0, timeout=120.0,
                            group_size=4)

    class _Comm:
        failed_calls: list = []

        def _on_proc_failed(self, p):
            ulfm_state["failed"].add(p)

        def _on_proc_healed(self, p):
            ulfm_state["failed"].discard(p)

    ulfm_state = {"failed": set()}
    comm = _Comm()
    det.on_failure(comm._on_proc_failed)
    det.on_heal(comm._on_proc_healed)
    try:
        det.mark_failed(2, gossip=False)
        assert ulfm_state["failed"] == {2} and eng.proc_failed(2)
        det.on_heartbeat(2, {"kind": "hb", "src": 2})
        assert ulfm_state["failed"] == set()
        assert not eng.proc_failed(2)
        assert ulfm is not None  # imported for parity with real wiring
    finally:
        det.close()
        eng.close()


# -- sharded lazy modex substrate --------------------------------------


def test_kvs_get_prefix_and_op_counters():
    from ompi_tpu_torch.boot.kvs import KVSClient, KVSServer

    srv = KVSServer()
    cli = KVSClient(srv.address)
    try:
        for p in range(3):
            cli.put(f"dcn.{p}", f"a{p}")
        cli.put(f"dcn.{0}.i1", "reborn")
        cli.put("wsize.0", 4)
        scan = cli.get_prefix("dcn.")
        assert scan == {"dcn.0": "a0", "dcn.1": "a1", "dcn.2": "a2",
                        "dcn.0.i1": "reborn"}
        assert cli.get_prefix("wsize.") == {"wsize.0": 4}
        assert cli.get_prefix("nope.") == {}
        assert cli.ops["put"] == 5 and cli.ops["get_prefix"] == 3
        assert cli.ops.get("get", 0) == 0
    finally:
        cli.close()
        srv.close()


def test_address_table_lazy_resolution():
    from ompi_tpu_torch.dcn.collops import AddressTable

    calls = []

    def resolver(i):
        calls.append(i)
        return f"addr{i}"

    tab = AddressTable(4, resolver, primed={0: "addr0", 1: "addr1"})
    # raw iteration never resolves (passive consumers stay silent)
    assert list(tab) == ["addr0", "addr1", None, None]
    assert not calls and not tab.resolved(2)
    # indexed access resolves once and caches
    assert tab[2] == "addr2" and tab[2] == "addr2"
    assert calls == [2] and tab.lazy_resolved == 1
    assert tab.resolved(2)
    # in-place update (replace() installing a reborn endpoint)
    tab[3] = "reborn3"
    assert tab[3] == "reborn3" and calls == [2]


def test_engine_preserves_address_table():
    """set_addresses must keep an AddressTable's resolver (a list copy
    would freeze the unresolved holes as None forever), and
    update_address must refresh one slot without resolving others."""
    from ompi_tpu_torch.dcn.collops import AddressTable, DcnCollEngine

    eng = DcnCollEngine(0, 4)
    try:
        tab = AddressTable(4, lambda i: f"addr{i}", primed={0: "a0"})
        eng.set_addresses(tab)
        assert eng.addresses is tab
        eng.update_address(2, "reborn2")
        assert list.__getitem__(eng.addresses, 2) == "reborn2"
        assert list.__getitem__(eng.addresses, 3) is None
        assert eng.addresses[3] == "addr3"  # still lazy
        # plain lists keep working
        eng.set_addresses(["a", "b", "c", "d"])
        eng.update_address(1, "x")
        assert eng.addresses[1] == "x"
    finally:
        eng.close()


# -- telemetry relay ---------------------------------------------------


def test_aggregator_unwraps_relay_batches():
    from ompi_tpu_torch.metrics.live import TelemetryAggregator

    agg = TelemetryAggregator(http_port=0)
    try:
        agg.ingest({"batch": [
            {"proc": 8, "nprocs": 16, "ts_ns": 1, "native": {}},
            {"proc": 9, "nprocs": 16, "ts_ns": 1, "native": {}},
        ], "relay": 1})
        agg.ingest({"proc": 0, "nprocs": 16, "ts_ns": 1, "native": {}})
        js = agg.json_state()
        assert js["frames"] == 3
        assert js["relays"] == {"batches": 1, "groups": [1]}
        assert set(js["procs"]) == {"0", "8", "9"}
    finally:
        agg.close()


def test_relay_forwards_and_repoints():
    """A relay buffers member frames, forwards ONE batch upstream per
    flush, and survives a root-aggregator restart via repoint()."""
    import socket

    from ompi_tpu_torch.metrics.live import (TelemetryAggregator,
                                       TelemetryRelay, _send_frame)

    agg = TelemetryAggregator(http_port=0)
    rel = TelemetryRelay(agg.ingest_address, group_index=2,
                         interval_ms=10_000)  # pump idle: flush by hand
    try:
        host, port = rel.ingest_address.rsplit(":", 1)
        s = socket.create_connection((host, int(port)), timeout=2)
        for p in (4, 5, 6):
            _send_frame(s, {"proc": p, "nprocs": 8, "ts_ns": 1,
                            "native": {}})
        s.close()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if rel.flush() and rel.forwarded >= 3:
                break
            time.sleep(0.02)
        deadline = time.monotonic() + 5
        while agg.frames < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert agg.frames == 3 and rel.forwarded == 3
        assert agg.json_state()["relays"]["groups"] == [2]
        # root restarts at a new address: repoint, next flush lands
        agg2 = TelemetryAggregator(http_port=0)
        try:
            rel.repoint(agg2.ingest_address)
            s = socket.create_connection((host, int(port)), timeout=2)
            _send_frame(s, {"proc": 7, "nprocs": 8, "ts_ns": 2,
                            "native": {}})
            s.close()
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                rel.flush()
                if agg2.frames >= 1:
                    break
                time.sleep(0.02)
            assert agg2.frames == 1
            assert agg2.json_state()["relays"]["groups"] == [2]
        finally:
            agg2.close()
    finally:
        rel.close()
        agg.close()


# -- revoke interrupt (the blocked-collective escape) -------------------


def test_revoke_wakes_blocked_collective_recv():
    """ULFM: revoke must wake a receive already parked on the comm —
    without it a survivor blocked in a fold/bcast sits out the full
    recv deadline and then wrongly escalates the LIVE peer it was
    waiting on (the np≥16 recovery poison)."""
    import threading

    from ompi_tpu_torch.core.errors import MPIRevokedError
    from ompi_tpu_torch.dcn.collops import DcnCollEngine
    from ompi_tpu_torch.ft import ulfm

    eng = DcnCollEngine(0, 2)

    class _Comm:
        name = "fake"

    comm = _Comm()
    eng.register_comm(7, comm)
    out: list = []

    def blocked():
        try:
            eng._recv_full(1, 7, 0, timeout=30.0)
        except MPIRevokedError as e:
            out.append(e)
        except Exception as e:  # noqa: BLE001
            out.append(e)

    t = threading.Thread(target=blocked, daemon=True)
    t.start()
    try:
        time.sleep(0.4)
        assert t.is_alive()
        ulfm.state(comm).revoked = True
        t.join(timeout=5.0)
        assert not t.is_alive()
        assert out and isinstance(out[0], MPIRevokedError), out
    finally:
        eng.unregister_comm(7)
        eng.close()


# -- leadership transitions + relay failover ---------------------------


def test_leadership_callback_fires_on_takeover():
    """The successor that outlives its leader learns it IS the leader
    within one heartbeat period — the on_leadership hook the telemetry
    relay failover promotes through."""
    eng = _StubEngine(proc=1, nprocs=4)
    det = HeartbeatDetector(eng, period=0.05, timeout=120.0,
                            group_size=4)
    fired: list[bool] = []
    try:
        det.on_leadership(fired.append)
        time.sleep(0.2)
        assert fired == []  # rank 0 leads; no transition yet
        det.mark_failed(0, gossip=False)
        deadline = time.monotonic() + 5
        while not fired and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fired == [True], fired
        # the heal demotes: rank 0 comes back, leadership returns
        det.clear_failed(0)
        deadline = time.monotonic() + 5
        while len(fired) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fired == [True, False], fired
    finally:
        det.close()


def test_note_incarnation_floor_prevents_fellow_reborn_remark():
    """Multi-victim regression (found by the whole-host-kill soak): a
    reborn detector seeded with a FELLOW reborn peer's incarnation
    floor must read its current-incarnation heartbeats as liveness —
    without the floor they look like a rebirth announcement and
    falsely re-mark the peer."""
    eng, det = _quiet_detector(proc=2, nprocs=4, group_size=4)
    try:
        # un-seeded: inc=1 heartbeat from peer 3 IS a rebirth detection
        det.on_heartbeat(3, {"kind": "hb", "src": 3, "inc": 1})
        assert 3 in det.failed()
    finally:
        det.close()
    eng2, det2 = _quiet_detector(proc=2, nprocs=4, group_size=4)
    try:
        det2.note_incarnation(3, 1)  # the recovery beacon's floor
        det2.on_heartbeat(3, {"kind": "hb", "src": 3, "inc": 1})
        assert 3 not in det2.failed()
        assert det2.counters["rebirth_detects"] == 0
        # the floor does not mask a REAL later rebirth
        det2.on_heartbeat(3, {"kind": "hb", "src": 3, "inc": 2})
        assert 3 in det2.failed()
    finally:
        det2.close()


def test_relay_failover_reregisters_and_member_refreshes():
    """Relay failover end to end, in process, over a real KVS: the
    leader's relay dies; the promoted successor re-registers
    ``relay.g<i>`` (via live._promote_relay); the member publisher's
    refresh hook re-reads the key on its next failed publish and
    frames resume at the root — the handoff the old plane could not
    make (members degraded to dropped frames for the rest of the
    job)."""
    from ompi_tpu_torch.boot.kvs import KVSClient, KVSServer
    from ompi_tpu_torch.metrics import live

    srv = KVSServer()
    cli = KVSClient(srv.address)
    agg = live.TelemetryAggregator(http_port=0)
    rel1 = live.TelemetryRelay(agg.ingest_address, group_index=0,
                               interval_ms=30)
    cli.put("relay.g0", rel1.ingest_address)

    def refresh():
        try:
            return str(cli.get("relay.g0", wait=False))
        except (KeyError, ConnectionError, OSError):
            return None

    pub = live.TelemetryPublisher(rel1.ingest_address, proc=3,
                                  nprocs=4, interval_ms=30,
                                  refresh=refresh)

    class _PC:  # the slice of ProcContext _promote_relay touches
        pass

    pc = _PC()
    pc.kvs = cli
    pc.ns = ""
    old_relay = live._relay
    try:
        deadline = time.monotonic() + 10
        while agg.frames < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert agg.frames >= 2
        rel1.close()  # the leader dies, relay with it
        live._relay = None
        live._promote_relay(True, pc, 0, agg.ingest_address, 30)
        assert live._relay is not None
        assert cli.get("relay.g0", wait=False) == \
            live._relay.ingest_address  # re-registered
        before = agg.frames
        deadline = time.monotonic() + 10
        while (agg.frames < before + 3 or not pub.refreshes) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert pub.refreshes >= 1 and agg.frames >= before + 3
    finally:
        pub.stop()
        if live._relay is not None:
            live._relay.close()
        live._relay = old_relay
        live._via_relay = False
        agg.close()
        cli.close()
        srv.close()


# -- native-plane sharded modex ----------------------------------------


#: the reference's ``tests/workers/mp_modex_worker.py`` with the port's
#: prelude: two allreduces, then one ``MODEX_TALLY`` line
_MODEX_WORKER = {
    "port": ("import ompi_tpu_torch.api as api\n"
             "from ompi_tpu_torch.metrics import core as mcore\n"
             "from ompi_tpu_torch.op import SUM\n"
             "world = api.init(device='cpu')\n"),
    "ref": ("import jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            "import ompi_tpu.api as api\n"
            "from ompi_tpu.metrics import core as mcore\n"
            "from ompi_tpu.op import SUM\n"
            "world = api.init()\n"),
}
_MODEX_BODY = """
import json
import numpy as np
p, n = world.proc, world.size
ctx = world.procctx
table = world.dcn._root_engine().addresses
boot_installs = {k: int(v) for k, v in (mcore.native_counters() or {}).items()
                 if k in ("addr_installs", "addr_lazy_resolved")}
for i in range(2):
    out = world.allreduce(np.full((world.local_size, 2), i + 1.0), SUM)
    assert float(np.asarray(out)[0][0]) == (i + 1) * n, (i, out)
counters = mcore.native_counters() or {}
tally = {
    "proc": p,
    "nprocs": world.nprocs,
    "plane": ("native" if world.dcn._root_engine().address.startswith("ntv:")
              else "python"),
    "addr_installs": int(boot_installs.get("addr_installs", 0)),
    "addr_lazy_resolved": int(counters.get("addr_lazy_resolved", 0)),
    "table_lazy": int(getattr(table, "lazy_resolved", 0)),
    "kvs_gets": int(ctx.kvs.ops.get("get", 0)),
}
print("MODEX_TALLY " + json.dumps(tally, sort_keys=True), flush=True)
api.finalize()
print(f"OK modex proc={p}", flush=True)
"""


def _modex_job(tmp_path, pkg: str, nprocs: int, group: int, timeout: float):
    """One modex boot job of ``nprocs`` one-rank processes on the
    native plane with ``ft_group_size=group``; its tallies by proc."""
    script = tmp_path / f"modex_{pkg}.py"
    script.write_text(_MODEX_WORKER[pkg] + _MODEX_BODY)
    env = dict(os.environ, PYTHONPATH=f"{REPO}:" + os.environ.get("PYTHONPATH", ""))
    if pkg == "port":
        cmd = [sys.executable, "-m", "ompi_tpu_torch", "run", "-np", str(nprocs),
               "--cpu", "--nranks", "1"]
    else:
        env.pop("JAX_PLATFORMS", None)
        cmd = [sys.executable, "-m", "ompi_tpu", "run", "-np", str(nprocs),
               "--cpu-devices", "1"]
    cmd += ["--mca", "btl", "native", "--mca", "ft_group_size", str(group), str(script)]
    res = subprocess.run(cmd, capture_output=True, timeout=timeout, cwd=str(REPO), env=env)
    out = res.stdout.decode()
    assert res.returncode == 0, f"{out}\n{res.stderr.decode()}"
    tallies = [json.loads(line.split("MODEX_TALLY ", 1)[1])
               for line in out.splitlines() if "MODEX_TALLY" in line]
    assert len(tallies) == nprocs, out
    return {t["proc"]: t for t in tallies}


def test_native_sharded_modex_install_counters(tmp_path):
    """np=4 native boot on ft_group_size=2 groups: every rank's eager
    address installs (``addr_installs``) read <= group size instead of
    P-1 — primed slots install at boot, cross-group peers resolve
    lazily on first send (``addr_lazy_resolved`` / the AddressTable's
    ``lazy_resolved``), and the collectives still produce exact results
    (the worker asserts them).  The port's eager installs per process
    equal the reference's."""
    from ompi_tpu_torch.dcn import native as dcn_native

    if not dcn_native.available():
        pytest.skip("native toolchain unavailable")
    tallies = _modex_job(tmp_path, "port", 4, 2, 240)
    assert all(t["plane"] == "native" for t in tallies.values()), tallies
    for t in tallies.values():
        assert t["addr_installs"] <= 2, t  # group size, never P-1=3
    # somebody resolved a cross-group peer lazily
    assert sum(t["addr_lazy_resolved"] for t in tallies.values()) >= 1, tallies
    ref = _modex_job(tmp_path, "ref", 4, 2, 240)
    assert ({p: t["addr_installs"] for p, t in tallies.items()}
            == {p: t["addr_installs"] for p, t in ref.items()})


def test_c_revoke_wakes_parked_schedule_and_refuses_new():
    """The C fast path's _check_revoked twin: a schedule receive
    parked in cctx_recv_msg wakes the moment tdcn_coll_revoke_cid
    poisons its comm (instead of waiting out the ~600 s give-up), and
    new starts on the revoked view refuse before any frame moves."""
    import ctypes
    import threading

    from ompi_tpu_torch.dcn import native as dcn_native

    if not dcn_native.available():
        pytest.skip("native toolchain unavailable")
    lib = dcn_native.load_library()
    P, I, U64, S = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
                    ctypes.c_char_p)
    lib.tdcn_coll_open.restype = U64
    lib.tdcn_coll_open.argtypes = [P, S, I, I,
                                   ctypes.POINTER(ctypes.c_char_p), U64]
    lib.tdcn_coll_plan.restype = U64
    lib.tdcn_coll_plan.argtypes = [P, U64, I, I, I, ctypes.c_int64,
                                   I, I]
    lib.tdcn_coll_start.restype = I
    lib.tdcn_coll_start.argtypes = [P, U64, P, P]
    lib.tdcn_coll_close.argtypes = [P, U64]
    a = lib.tdcn_create(0, 2, b"hA", 0, 0, 0, 0)
    b = lib.tdcn_create(1, 2, b"hB", 0, 0, 0, 0)
    try:
        aa = lib.tdcn_address(a)
        ab = lib.tdcn_address(b)
        lib.tdcn_set_addresses(a, aa + b"\n" + ab)
        addrs = (ctypes.c_char_p * 2)(aa, ab)
        cx = lib.tdcn_coll_open(a, b"4242", 0, 2, addrs, 0)
        pl = lib.tdcn_coll_plan(a, cx, 0, 0, 7, 0, 0, -1)  # barrier
        assert cx and pl
        out: dict = {}

        def park():
            t0 = time.monotonic()
            out["rc"] = lib.tdcn_coll_start(a, pl, None, None)
            out["dt"] = time.monotonic() - t0

        t = threading.Thread(target=park)
        t.start()
        time.sleep(0.3)  # let it park waiting on rank 1 (never comes)
        lib.tdcn_coll_revoke_cid(a, b"4242")
        t.join(timeout=15)
        assert not t.is_alive(), "revoke did not wake the wait"
        assert out["rc"] == -6 and out["dt"] < 10, out
        # a revoked view refuses new starts before any frame moves
        assert lib.tdcn_coll_start(a, pl, None, None) == -6
        lib.tdcn_coll_close(a, cx)
    finally:
        lib.tdcn_close(a)
        lib.tdcn_close(b)


def test_c_address_change_invalidates_plans():
    """replace()/incarnation bump: an address change for a C-coll
    member evicts the view's compiled plans (a repaired comm cannot
    replay a schedule built against the dead lineage) — the next plan
    lookup re-compiles (sched_cache_misses ticks) instead of hitting
    the stale entry."""
    import ctypes

    from ompi_tpu_torch.dcn import native as dcn_native

    if not dcn_native.available():
        pytest.skip("native toolchain unavailable")
    lib = dcn_native.load_library()
    P, I, U64, S = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
                    ctypes.c_char_p)
    lib.tdcn_coll_open.restype = U64
    lib.tdcn_coll_open.argtypes = [P, S, I, I,
                                   ctypes.POINTER(ctypes.c_char_p), U64]
    lib.tdcn_coll_plan.restype = U64
    lib.tdcn_coll_plan.argtypes = [P, U64, I, I, I, ctypes.c_int64,
                                   I, I]
    lib.tdcn_coll_close.argtypes = [P, U64]

    def stats(h):
        names = lib.tdcn_stats_names().decode().split(",")
        buf = (ctypes.c_uint64 * len(names))()
        n = lib.tdcn_stats(h, buf, len(names))
        return dict(zip(names, list(buf[:n])))

    a = lib.tdcn_create(0, 2, b"hA", 0, 0, 0, 0)
    b = lib.tdcn_create(1, 2, b"hB", 0, 0, 0, 0)
    try:
        aa, ab = lib.tdcn_address(a), lib.tdcn_address(b)
        lib.tdcn_set_addresses(a, aa + b"\n" + ab)
        addrs = (ctypes.c_char_p * 2)(aa, ab)
        cx = lib.tdcn_coll_open(a, b"77", 0, 2, addrs, 0)
        pl1 = lib.tdcn_coll_plan(a, cx, 3, 1, 13, 32, 0, -1)
        assert pl1
        assert lib.tdcn_coll_plan(a, cx, 3, 1, 13, 32, 0, -1) == pl1
        misses0 = stats(a)["sched_cache_misses"]
        # proc 1's address changes (a reborn incarnation's endpoint —
        # a synthetic string: the invalidation only compares, never
        # dials, and a second proc-1 engine in ONE test process would
        # collide on the (pid, proc)-named shm doorbell)
        lib.tdcn_set_address_one(a, 1, ab + b"#reborn", 0)
        pl2 = lib.tdcn_coll_plan(a, cx, 3, 1, 13, 32, 0, -1)
        assert pl2 and pl2 != pl1, "stale plan survived the repair"
        assert stats(a)["sched_cache_misses"] == misses0 + 1
        lib.tdcn_coll_close(a, cx)
    finally:
        lib.tdcn_close(a)
        lib.tdcn_close(b)


# -- np=16 integration soak (slow; tier-1 runs the in-process units) --


@pytest.mark.slow
def test_scale_soak_np16_chaos():
    """The full hierarchical-control-plane acceptance, as the
    reference's ``tests/test_hier.py`` drives its chaos runner: the
    port's ``chaos --scale --np 16`` (on the CPU) — sharded-modex boot
    (sub-quadratic KVS ops asserted), one SIGKILL per detector group
    mid-collective, gossip-convergence bound, full-size respawn+replace
    — driven by the runner's own assertions."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + ":" + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch", "chaos", "--scale", "--np", "16",
         "--cpu", "--timeout", "480"],
        capture_output=True, timeout=540, cwd=str(REPO), env=env)
    assert res.returncode == 0, (res.stdout.decode()[-3000:]
                                 + res.stderr.decode()[-3000:])
    assert b"scale soak: np=16" in res.stdout

if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))

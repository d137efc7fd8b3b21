"""False failure marks lift even where nothing of the topology heals them.

A detector drops a proc it holds failed from its heartbeat targets, and
gossips a mark to no one about the marked proc itself.  So two processes
that mark each other before either hears the other's next heartbeat (a
host stall of both past the timeout) never again send each other a
frame that could heal them, and a plain member that heard both marks
holds both failed.  A heal record (``flc``) is sent once; the
anti-entropy digest that makes good a lost mark carried marks alone, and
a healer with no mark left never answered a mismatched digest.

The port's detector probes a proc it holds failed (a heartbeat flagged
``probe``, at most once a period, the gap doubling up to the timeout),
answers a probe with a heartbeat, and ships heal floors on a mismatched
digest.  Each scenario runs through the port's ``HeartbeatDetector`` and
the reference's, over an in-process loopback of fake engines in
``test_torch_fault_marks.py``'s style:

* (a) np = 2, both mark each other at once: the port heals in the
  detector, the engine and ``DevicePlane._failed``; the reference stays
  marked (a standing difference);
* (b) np = 3, 0 and 1 mark each other, and after a whole host's stall
  both mark 2 too: every process ends with nothing marked in the port;
  in the reference the first heals through 2, the second stands;
* (c) np = 3, 0 marks 1 and its ``flc`` to process 2 is lost: process 2
  lifts the mark through the digest in the port, and keeps it in the
  reference;
* (d) a dead peer stays marked; its probes are bounded and strike
  nothing; (e) a reborn incarnation is still detected as a rebirth;
  (f) a retired peer gets no probe; (g) a stale ``flr`` loses to a newer
  clear, and a stale ``flc`` to a newer mark.  Both packages end (d)–(g)
  in the same state.

The last test marks 0 and 1 of a 3-process ``run --ft --cpu`` job against
each other, on the native plane and on tcp: every process ends with
nothing marked, and the next allreduce is bit-equal to the reference's
ordered fold.
"""

import queue
import threading
import time

import numpy as np
import pytest

from ompi_tpu.ft import detector as ref_detector
from ompi_tpu.op import SUM as REF_SUM
from ompi_tpu.op import ordered_reduce_np
from ompi_tpu_torch.dcn.collops import DcnCollEngine
from ompi_tpu_torch.dcn.device import DevicePlane
from ompi_tpu_torch.ft import detector as port_detector
from torch_mp_common import run_job

PERIOD = 0.05
TIMEOUT = 1.0
#: the port heals within this many periods (measured: 1–3)
HEAL_PERIODS = 40
PACKAGES = {"port": port_detector, "ref": ref_detector}
#: the counters both packages keep
SHARED_COUNTERS = ("gossip_tx", "gossip_relayed", "stale_gossip_dropped", "digest_syncs",
                   "rebirth_detects", "false_positive_heals")


class _Loop:
    """An in-process control plane: each engine takes its frames on a
    thread of its own, as the engine's receiver does.  ``lost(src, dst,
    env)`` names the frames the wire loses (counted in ``dropped``);
    ``hold`` loses every heartbeat (the stall)."""

    def __init__(self):
        self.engines: list = []
        self.hold = False
        self.lost = lambda src, dst, env: False
        self.dropped: list[tuple[int, int, str]] = []
        self.sent: list[tuple[int, int, dict]] = []


class _Engine:
    """The root engine's failure half over a real device plane (the
    port: ``DcnCollEngine``'s own methods), or over sets (the
    reference), wired to a :class:`_Loop`.  A ``dead`` engine's sends
    raise and nothing reaches it."""

    def __init__(self, loop: _Loop, proc: int, nprocs: int, port: bool):
        self.loop, self.proc, self.nprocs = loop, proc, nprocs
        self.dead = False
        self._failed_procs: set[int] = set()
        self._device_plane = DevicePlane(proc, min_size=1) if port else None
        self._detector = None
        self._inbox: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._deliver, daemon=True)
        self._thread.start()
        loop.engines.append(self)

    def note_proc_failed(self, proc):
        if self._device_plane is not None:
            DcnCollEngine.note_proc_failed(self, proc)
        else:
            self._failed_procs.add(proc)

    def note_proc_healed(self, proc):
        if self._device_plane is not None:
            DcnCollEngine.note_proc_healed(self, proc)
        else:
            self._failed_procs.discard(proc)

    def attach_detector(self, det):
        self._detector = det

    def send_ctrl(self, dst, env):
        peer = self.loop.engines[dst]
        if self.dead or peer.dead:
            raise ConnectionError(f"proc {dst} is gone")
        self.loop.sent.append((self.proc, dst, dict(env)))
        if ((self.loop.hold and env["kind"] == "hb")
                or self.loop.lost(self.proc, dst, env)):
            self.loop.dropped.append((self.proc, dst, env["kind"]))
            return
        peer._inbox.put(dict(env))

    def _deliver(self):
        while True:
            env = self._inbox.get()
            if env is None:
                return
            det = self._detector
            if det is None:
                continue
            kind = env["kind"]
            if kind == "hb":
                det.on_heartbeat(env["src"], env)
            elif kind == "flr":
                det.on_gossip(env)
            elif kind == "flc":
                det.on_clear(env)
            elif kind == "flrsync":
                det.on_flrsync(env)

    def marks(self) -> dict:
        """Every layer's failed set."""
        out = {"detector": sorted(self._detector.failed()),
               "engine": sorted(self._failed_procs)}
        if self._device_plane is not None:
            out["plane"] = self._device_plane.failed_peers()
        return out

    def close(self):
        if self._detector is not None:
            self._detector.close()
        self._inbox.put(None)
        self._thread.join(5)
        if self._device_plane is not None:
            self._device_plane.close(drain_timeout=0)


def _cluster(pkg: str, nprocs: int, detectors=None):
    """``nprocs`` engines on one loop, a detector on each of
    ``detectors`` (default: all)."""
    loop = _Loop()
    engines = [_Engine(loop, p, nprocs, pkg == "port") for p in range(nprocs)]
    dets = {}
    for p in (range(nprocs) if detectors is None else detectors):
        dets[p] = PACKAGES[pkg].HeartbeatDetector(engines[p], period=PERIOD,
                                                  timeout=TIMEOUT)
    return loop, engines, dets


def _close(engines):
    for e in engines:
        e.close()


def _mark_at_once(loop: _Loop, dets: dict, pairs) -> None:
    """The stall: every heartbeat is lost while the frames in flight
    drain, while each ``(p, q)`` of ``pairs`` has ``p`` mark ``q`` (its
    gossip goes out), and for three periods more; then the wire carries
    heartbeats again."""
    loop.hold = True
    time.sleep(3 * PERIOD)
    for p, q in pairs:
        assert dets[p].mark_failed(q)
    # a heartbeat whose loop iteration began before the mark is lost too
    time.sleep(3 * PERIOD)
    loop.hold = False


def _clear(engines) -> bool:
    return all(not v for e in engines if e._detector is not None
               for v in e.marks().values())


def _await_clear(engines, periods: int = HEAL_PERIODS) -> float:
    """Seconds until every layer of every engine holds nothing (or
    ``periods`` periods, then the state is returned to the caller's
    assertion)."""
    t0 = time.monotonic()
    end = t0 + periods * PERIOD
    while not _clear(engines) and time.monotonic() < end:
        time.sleep(PERIOD / 5)
    return time.monotonic() - t0


def _settle(periods: int = HEAL_PERIODS) -> None:
    time.sleep(periods * PERIOD)


def test_mutual_mark_np2_heals_every_layer_in_the_port():
    """(a) in the port: each side's probe heals the other's mark, in the
    detector, the engine and the device plane, and no mark comes back."""
    loop, engines, dets = _cluster("port", 2)
    try:
        _mark_at_once(loop, dets, [(0, 1), (1, 0)])
        took = _await_clear(engines)
        assert _clear(engines), [e.marks() for e in engines]
        assert took < HEAL_PERIODS * PERIOD
        _settle(10)
        assert _clear(engines), [e.marks() for e in engines]
        counters = [e._detector.counters for e in engines]
        assert sum(c["probes"] for c in counters) >= 1, counters
        assert sum(c["probe_heals"] for c in counters) >= 1, counters
        assert [c["false_positive_heals"] for c in counters] == [1, 1], counters
        for e in engines:
            plane = e._device_plane
            assert plane.health.ok(1 - e.proc)
            assert plane.stage(np.arange(1024, dtype=np.float32), dst_proc=1 - e.proc) is not None
            assert plane.stats["device_fallbacks"] == 0
    finally:
        _close(engines)


def test_mutual_mark_np2_stays_in_the_reference():
    """(a) in the reference, the standing difference: neither side sends
    the other a frame again, so both marks stand."""
    loop, engines, dets = _cluster("ref", 2)
    try:
        _mark_at_once(loop, dets, [(0, 1), (1, 0)])
        n = len(loop.sent)
        _settle()
        assert [e.marks()["detector"] for e in engines] == [[1], [0]]
        assert loop.sent[n:] == []
    finally:
        _close(engines)


#: (b)'s marks: 0 and 1 mark each other, their gossip reaching 2
#: (``pair``); and the stall of a whole host, where each watcher's timeout
#: also marks the silent member 2 (``host``: the leader 0 and the successor
#: 1 watch; the plain member 2 watches no one)
NP3_MARKS = {"pair": [(0, 1), (1, 0)],
             "host": [(0, 1), (0, 2), (1, 0), (1, 2)]}


@pytest.mark.parametrize("case", sorted(NP3_MARKS))
def test_mutual_mark_np3_ends_unmarked_in_the_port(case):
    """(b) in the port: every process, the plain member 2 included, ends
    with nothing marked in any layer."""
    loop, engines, dets = _cluster("port", 3)
    try:
        _mark_at_once(loop, dets, NP3_MARKS[case])
        _await_clear(engines)
        assert _clear(engines), [e.marks() for e in engines]
        _settle(10)
        assert _clear(engines), [e.marks() for e in engines]
    finally:
        _close(engines)


def test_mutual_mark_np3_in_the_reference():
    """(b) in the reference: when only 0 and 1 mark each other, both still
    heartbeat 2 (their successor now), so 2 heals both and relays the
    heals; after a whole host's stall nobody heartbeats anybody, and every
    mark stands (the standing difference)."""
    for case, want in (("pair", [[], [], []]), ("host", [[1, 2], [0, 2], [0, 1]])):
        loop, engines, dets = _cluster("ref", 3)
        try:
            _mark_at_once(loop, dets, NP3_MARKS[case])
            _settle()
            assert [e.marks()["detector"] for e in engines] == want, case
        finally:
            _close(engines)


def _lost_heal_to_2(src, dst, env):
    """The wire to process 2 loses the heal record, and every frame of
    process 1: only the digest can lift 2's mark of 1."""
    return dst == 2 and (env["kind"] == "flc" or src == 1)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_lost_heal_record_lifts_by_anti_entropy(pkg):
    """(c) 0 marks 1 and gossips it to 2; 1's next heartbeat heals 0's
    mark, and the ``flc`` to 2 is lost.  The port's 2 lifts the mark when
    its digest-bearing heartbeat to 0 brings 0's heal floors back; the
    reference's 2 keeps it (pinned)."""
    loop, engines, dets = _cluster(pkg, 3)
    loop.lost = _lost_heal_to_2
    try:
        assert dets[0].mark_failed(1)
        end = time.monotonic() + HEAL_PERIODS * PERIOD
        while (0, 2, "flc") not in loop.dropped and time.monotonic() < end:
            time.sleep(PERIOD / 5)
        assert (0, 2, "flc") in loop.dropped
        assert 1 not in dets[0].failed()
        if pkg == "port":
            _await_clear(engines)
            assert _clear(engines), [e.marks() for e in engines]
            assert dets[2].counters["digest_heals"] == 1
            assert dets[2].counters["probe_heals"] == 0
        else:
            _settle()
            assert 1 in dets[2].failed()
    finally:
        _close(engines)


def _dead_peer(pkg: str) -> dict:
    """(d) proc 1 dies: its sends raise and it sends nothing.  Proc 0's
    strikes mark it; then five timeouts pass."""
    loop, engines, dets = _cluster(pkg, 2, detectors=[0])
    engines[1].dead = True
    try:
        end = time.monotonic() + 40 * PERIOD
        while not dets[0].failed() and time.monotonic() < end:
            time.sleep(PERIOD / 5)
        assert dets[0].failed() == {1}
        strikes = dets[0]._strikes[1]
        t0 = time.monotonic()
        time.sleep(5 * TIMEOUT)
        window = time.monotonic() - t0
        counters = dict(dets[0].counters)
        return {"failed": sorted(dets[0].failed()), "engine": sorted(engines[0]._failed_procs),
                "strikes_before": strikes, "strikes_after": dets[0]._strikes[1],
                "gossip_tx": counters["gossip_tx"], "probes": counters.get("probes", 0),
                "window": window}
    finally:
        _close(engines)


def test_dead_peer_stays_marked_and_probes_are_bounded():
    """(d) in both packages the corpse stays marked and no strike is
    counted after the mark; the port's probes stay under the back-off's
    bound (doubling from one period to the timeout)."""
    port, ref = _dead_peer("port"), _dead_peer("ref")
    for got in (port, ref):
        assert got["failed"] == [1] and got["engine"] == [1]
        assert got["strikes_after"] == got["strikes_before"]
        assert got["gossip_tx"] == 0  # np = 2: nobody to gossip to
    assert ref["probes"] == 0
    gaps = int(np.ceil(np.log2(TIMEOUT / PERIOD)))
    assert 1 <= port["probes"] <= gaps + 2 + port["window"] / TIMEOUT, port


def _scripted(pkg: str, script) -> tuple:
    """A detector of proc 0 among 4 whose loop never fires, driven by
    ``script`` (method, args); its failed set, the counters both packages
    keep, the engine's failed set and the frames it sent."""
    loop = _Loop()
    engines = [_Engine(loop, p, 4, pkg == "port") for p in range(4)]
    det = PACKAGES[pkg].HeartbeatDetector(engines[0], period=60.0, timeout=120.0)
    try:
        for method, args in script:
            getattr(det, method)(*args)
        counters = {k: det.counters[k] for k in SHARED_COUNTERS}
        return (sorted(det.failed()), counters, sorted(engines[0]._failed_procs),
                [(d, env["kind"], env.get("proc")) for s, d, env in loop.sent])
    finally:
        _close(engines)


def test_reborn_incarnation_is_still_a_rebirth():
    """(e) a heartbeat of a newer incarnation marks the corpse, whether
    the proc is held live or already held failed (the port probing it),
    in both packages alike."""
    script = [("on_heartbeat", (2, {"kind": "hb", "src": 2, "inc": 1})),
              ("mark_failed", (3,)),
              ("on_heartbeat", (3, {"kind": "hb", "src": 3, "inc": 1}))]
    port, ref = _scripted("port", script), _scripted("ref", script)
    assert port[0] == [2, 3] and port[1]["rebirth_detects"] == 1
    assert port[1]["false_positive_heals"] == 0
    assert port == ref


def test_reborn_incarnation_is_not_probed():
    """(e) once a newer incarnation announced itself, the port probes the
    corpse's slot no more."""
    loop, engines, dets = _cluster("port", 2, detectors=[0])
    try:
        dets[0].on_heartbeat(1, {"kind": "hb", "src": 1, "inc": 1})
        assert dets[0].failed() == {1}
        time.sleep(4 * PERIOD)
        n = len(loop.sent)
        time.sleep(20 * PERIOD)
        assert not [f for f in loop.sent[n:] if f[1] == 1 and f[2].get("probe")]
        assert dets[0].counters["rebirth_detects"] == 1
    finally:
        _close(engines)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_retired_peer_gets_no_probe(pkg):
    """(f) a retired peer gets no frame at all, probe or heartbeat, and
    is held failed by neither package."""
    loop, engines, dets = _cluster(pkg, 3, detectors=[0, 1])
    try:
        assert dets[0].mark_failed(2)
        dets[0].retire_peer(2)
        n = len(loop.sent)
        time.sleep(20 * PERIOD)
        assert not [f for f in loop.sent[n:] if f[:2] == (0, 2)]
        assert 2 not in dets[0].failed()
    finally:
        _close(engines)


def test_stale_records_lose_to_newer_ones():
    """(g) a stale ``flr`` loses to a newer clear, and a stale ``flc``
    to a newer mark, in both packages alike."""
    script = [("on_gossip", ({"kind": "flr", "proc": 2, "inc": 0, "epoch": 0, "src": 1},)),
              ("on_clear", ({"kind": "flc", "proc": 2, "inc": 0, "epoch": 1, "src": 1},)),
              ("on_gossip", ({"kind": "flr", "proc": 2, "inc": 0, "epoch": 0, "src": 3},)),
              ("on_gossip", ({"kind": "flr", "proc": 3, "inc": 0, "epoch": 0, "src": 1},)),
              ("on_clear", ({"kind": "flc", "proc": 3, "inc": 0, "epoch": 1, "src": 1},)),
              ("on_gossip", ({"kind": "flr", "proc": 3, "inc": 0, "epoch": 1, "src": 1},)),
              ("on_clear", ({"kind": "flc", "proc": 3, "inc": 0, "epoch": 1, "src": 2},))]
    port, ref = _scripted("port", script), _scripted("ref", script)
    assert port[0] == [3] and port[1]["stale_gossip_dropped"] == 2
    assert port == ref


def test_heal_floor_in_a_digest_lifts_and_a_stale_one_does_not():
    """The port's ``flrsync`` heal floors go through the ``flc`` rule: a
    floor above the mark's epoch lifts it, one at or below it does not."""
    loop = _Loop()
    engines = [_Engine(loop, p, 4, True) for p in range(4)]
    det = port_detector.HeartbeatDetector(engines[0], period=60.0, timeout=120.0)
    try:
        det.on_gossip({"kind": "flr", "proc": 2, "inc": 0, "epoch": 1, "src": 1})
        det.on_flrsync({"kind": "flrsync", "src": 1, "recs": [], "heals": [[2, 0, 1]]})
        assert det.failed() == {2}
        det.on_flrsync({"kind": "flrsync", "src": 1, "recs": [], "heals": [[2, 0, 2]]})
        assert det.failed() == set() and det.epoch_of(2) == 2
        assert det.counters["digest_heals"] == 1
        assert engines[0].marks() == {"detector": [], "engine": [], "plane": []}
    finally:
        _close(engines)


def test_concurrent_false_marks_all_lift():
    """Stress: more marking threads than cores mark random live peers of a
    4-process loopback for a second, with a short switch interval; every
    mark lifts in every layer afterwards (a heal lost to a concurrent
    mark would leave a layer marked)."""
    import os
    import random
    import sys

    loop, engines, dets = _cluster("port", 4)
    stop = threading.Event()

    def marker(seed):
        rng = random.Random(seed)
        while not stop.is_set():
            p, q = rng.sample(range(4), 2)
            dets[p].mark_failed(q)
            time.sleep(rng.random() * PERIOD / 4)

    interval = sys.getswitchinterval()
    threads = [threading.Thread(target=marker, args=(i,), daemon=True)
               for i in range(2 * (os.cpu_count() or 4))]
    try:
        sys.setswitchinterval(1e-5)
        for t in threads:
            t.start()
        time.sleep(1.0)
    finally:
        stop.set()
        for t in threads:
            t.join(5)
        sys.setswitchinterval(interval)
    try:
        assert not any(t.is_alive() for t in threads)
        _await_clear(engines, periods=2 * HEAL_PERIODS)
        assert _clear(engines), [e.marks() for e in engines]
    finally:
        _close(engines)


MUTUAL_JOB = r"""
import os, sys, time
import numpy as np
import ompi_tpu_torch.api as api
from ompi_tpu_torch.ft import ulfm
from ompi_tpu_torch.op import SUM

w = api.init(device="cpu")
det = w.procctx.detector
root = w.dcn._root_engine()
plane = root._device_plane
assert det is not None and plane is not None
X = np.random.default_rng(20261019).standard_normal((w.size, 16384)).astype(np.float32)
w.barrier()
if w.proc < 2:
    assert det.mark_failed(1 - w.proc, how="engine")
end = time.monotonic() + 4 * det.timeout
def marks():
    st = ulfm.peek(w)
    return {"detector": sorted(det.failed()), "engine": sorted(root._failed_procs),
            "plane": plane.failed_peers(), "comm": sorted(st.failed) if st else []}
def settled():
    # nothing held failed, and both heals known (a mark gossiped before
    # them is then stale on arrival)
    return not any(marks().values()) and all(
        det.epoch_of(q) >= 1 for q in (0, 1) if q != w.proc)
while not settled() and time.monotonic() < end:
    time.sleep(0.02)
m = marks()
c = det.counters
print(f"MARKS proc={w.proc} {m} probes={c['probes']} probe_heals={c['probe_heals']} "
      f"digest_heals={c['digest_heals']} fallbacks={plane.stats['device_fallbacks']}",
      flush=True)
assert not any(m.values()), m
lo, k = w.local_offset, w.local_size
out = np.asarray(w.allreduce(X[lo:lo + k], SUM))
np.save(os.path.join(sys.argv[1], f"{w.proc}.npy"), out)
w.barrier()
api.finalize()
"""


@pytest.mark.parametrize("btl", ["native", "tcp"])
def test_np3_job_mutual_mark_heals_and_next_allreduce_is_exact(tmp_path, btl):
    """0 and 1 of a 3 × 1 ``run --ft`` job mark each other after a
    barrier; every process ends with nothing marked in any layer, and
    the next allreduce equals the reference's ordered fold bit for bit
    (reproducible mode).  On both planes, so a heartbeat from a proc the
    engine holds failed reaches the detector on each."""
    script = tmp_path / "mutual.py"
    script.write_text(MUTUAL_JOB)
    mca = {"dcn_device_min_size": 4096, "coll_cuda_reproducible": 1,
           "coll_han_reproducible": 1}
    if btl == "tcp":
        mca["btl"] = "tcp"
    res = run_job("port", 3, 1, script, args=[tmp_path], timeout=120, flags=["--ft"], mca=mca)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count("MARKS") == 3, res.stdout
    X = np.random.default_rng(20261019).standard_normal((3, 16384)).astype(np.float32)
    want = ordered_reduce_np(X, REF_SUM)
    for p in range(3):
        got = np.load(tmp_path / f"{p}.npy")
        assert got.tobytes() == want[None].tobytes(), p

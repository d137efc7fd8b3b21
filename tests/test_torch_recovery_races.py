"""Regression tests of the recovery races that ``chaos --hosts 3 --np 6``
met on the port, each forced in process, without a soak:

* a group member whose leader's one gossip frame about a death was lost
  (control frames are sent once and fail fast) must still learn of the
  death within a few heartbeat periods: members carry their failure-set
  digest on their heartbeats, so the leader's anti-entropy push reaches
  them.  Before, a member had no path left but the leader's relay, and
  the repair directive's survivor sat out ``ft_respawn_timeout`` in its
  settle loop while the reborn rank's replace round waited on it until
  ``dcn_recv_timeout`` killed the reborn rank (``chaos --hosts 3 --np 6``:
  incarnations ``[2, 1, 0, 0, 0, 0]``, a noisy bystander);
* ``revoke()`` sends its ``rvk`` frame to every member it does not
  yet hold failed; a member that died an instant before (marked a few
  milliseconds after the loop looked) refuses the dial, and the data
  dial retried until ``dcn_connect_timeout`` — the scale soak's ~8 s
  convergence misses, on the port and the reference alike.  A dial
  toward a proc the engine holds failed now gives up at once;
* a launch agent that the daemon has already superseded (its boot, or a
  wedge, outlasted ``serve_agent_timeout``, so the host's session was
  rotated and its spawn commands re-issued to a replacement) must not
  execute a command of its old session: the spawn it would run is a
  second live process of the rank beside the replacement's.
"""

import threading
import time

import pytest


class _Mesh:
    """In-process control plane for detectors of several procs: a
    ``send_ctrl`` is delivered to the peer's detector as the engine's
    frame router would, unless the peer is dead or a drop rule eats it."""

    def __init__(self):
        self.dets: dict[int, object] = {}
        self.dead: set[int] = set()
        self.drop: set[tuple] = set()  # (src, dst, kind, about) once
        self.lock = threading.Lock()

    def engine(self, proc: int, nprocs: int):
        mesh = self

        class Engine:
            def __init__(self):
                self.proc, self.nprocs = proc, nprocs
                self.failed: set[int] = set()

            def attach_detector(self, det):
                mesh.dets[proc] = det

            def note_proc_failed(self, p):
                self.failed.add(p)

            def note_proc_healed(self, p):
                self.failed.discard(p)

            def send_ctrl(self, dst, env):
                if dst in mesh.dead:
                    raise ConnectionRefusedError(111, "Connection refused")
                key = (proc, dst, env.get("kind"), env.get("proc"))
                with mesh.lock:
                    if key in mesh.drop:
                        mesh.drop.discard(key)
                        return  # lost on the wire, once
                det = mesh.dets.get(dst)
                if det is None:
                    return
                kind = env["kind"]
                if kind == "hb":
                    det.on_heartbeat(env["src"], env)
                elif kind == "flr":
                    det.on_gossip(env)
                elif kind == "flc":
                    det.on_clear(env)
                elif kind == "flrsync":
                    det.on_flrsync(env)

        return Engine()


def test_member_learns_a_death_whose_gossip_frame_was_lost():
    """Three emulated hosts of two procs (the ``--hosts 3 --np 6``
    groups), host 0 dead; leader 4's one gossip frame about proc 0 to
    its member 5 is lost."""
    from ompi_tpu_torch.ft.detector import HeartbeatDetector

    mesh = _Mesh()
    mesh.dead = {0, 1}
    mesh.drop = {(4, 5, "flr", 0)}
    hosts = [0, 0, 1, 1, 2, 2]
    dets = {p: HeartbeatDetector(mesh.engine(p, 6), period=0.02, timeout=600.0,
                                 grace=600.0, hosts=hosts) for p in (2, 3, 4, 5)}
    try:
        # leader 4's own detection (its heartbeat strikes on leader 0),
        # flooded to its member 5 and to the other live leader, 2
        assert dets[4].mark_failed(0)
        assert (4, 5, "flr", 0) not in mesh.drop, "the frame to 5 was not sent"
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline and 0 not in dets[5].failed():
            time.sleep(0.01)
        assert {p: 0 in d.failed() for p, d in dets.items()} == {
            2: True, 3: True, 4: True, 5: True}
        assert dets[4].counters["digest_syncs"] >= 1
    finally:
        for d in dets.values():
            d.close()


class _DictKVS:
    """The two calls the agent makes on its KVS client, over a dict."""

    def __init__(self, data: dict):
        self.data = dict(data)

    def get(self, key, wait=True, timeout=30.0):
        if key not in self.data:
            raise KeyError(key)
        return self.data[key]

    def put(self, key, value):
        self.data[key] = value


def _agent(kvs, session: str):
    from ompi_tpu_torch.serve.agent import LaunchAgent

    ag = LaunchAgent.__new__(LaunchAgent)
    ag.hid, ag.np, ag.ranks, ag.session = 1, 4, [2, 3], session
    ag.kvs, ag.cursor, ag.cmds_done = kvs, 0, 0
    ag._ack_backlog, ag.workers, ag._stop = [], {}, False
    spawned = []

    def spawn(rank, incarnation, telemetry=None):
        from ompi_tpu_torch.serve.agent import _Worker

        spawned.append((rank, incarnation))
        return _Worker(rank, incarnation, pid=4242)

    ag._spawn_worker = spawn
    return ag, spawned


@pytest.mark.parametrize("current", ["g1s1", None], ids=["superseded", "current"])
def test_superseded_agent_runs_no_command_of_its_old_session(current):
    from ompi_tpu_torch.serve.agent import K_AACK, K_ACMD, K_ASESSION

    data = {f"{K_ACMD}g1s0.1.0": {"kind": "spawn", "rank": 2, "incarnation": 0}}
    if current is not None:
        data[f"{K_ASESSION}1"] = current
    ag, spawned = _agent(_DictKVS(data), "g1s0")
    if current is None:
        # no rotation: the agent executes its own session's command
        assert ag._consume()
        assert spawned == [(2, 0)]
        assert ag.kvs.data[f"{K_AACK}g1s0.1.0"]["pid"] == 4242
        return
    with pytest.raises(SystemExit) as e:
        ag._consume()
    assert e.value.code == 0
    assert spawned == [] and ag.cursor == 0 and ag.cmds_done == 0


def test_revoke_is_not_held_by_a_member_that_died_an_instant_before():
    """A 2-process world seen from process 0: process 1's port refuses
    (it died), and the detector marks it 50 ms after ``revoke()`` began
    its fan-out; the revoke returns within a second, not after
    ``dcn_connect_timeout`` (30 s by default)."""
    import socket

    from ompi_tpu_torch.api.multiproc import MultiProcComm
    from ompi_tpu_torch.dcn.collops import DcnCollEngine
    from ompi_tpu_torch.ft import ulfm

    with socket.socket() as s:  # a port nobody listens on any more
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"
    eng = DcnCollEngine(0, 2, transport="tcp")
    try:
        eng.set_addresses([eng.address, dead])
        comm = MultiProcComm.__new__(MultiProcComm)
        comm.cid, comm.proc, comm.nprocs, comm.dcn, comm._ft = 7, 0, 2, eng, None
        threading.Timer(0.05, eng.note_proc_failed, args=(1,)).start()
        t0 = time.monotonic()
        comm.revoke()
        took = time.monotonic() - t0
        assert ulfm.is_revoked(comm)
        assert took < 1.5, f"revoke held {took:.2f} s by a dead member"
    finally:
        eng.close()


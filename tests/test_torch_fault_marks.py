"""A false failure mark lifts from every layer that took it.

The failure detector fans a mark out to the communicators and to the
engine, whose device plane keeps a failed set of its own
(``DevicePlane._failed``: windows toward a peer in it are refused, each
refusal a ``device_fallbacks`` count of cause ``peer_failed``).  A live
heartbeat from the marked peer heals the mark the same way.  When both
processes of a job stall past the detector's timeout, each marks the
other as it wakes, just as the other's first heartbeat arrives, so the
heal runs while the mark is still fanning out:

* the heal must wait for the mark's fan-out, so that the device plane,
  the engine and the detector all end healed (without the wait, the
  plane keeps the peer failed for the rest of the job, and every large
  message falls back to the host plane);
* a timeout mark stands only if the peer is still silent when it is
  taken.

The last test stalls both processes of a 2-process ``run --ft`` job on
the CPU (each stops itself with SIGSTOP; one helper continues both at
once) past the detector's timeout, twice, and holds the device plane to
zero fallbacks and every layer to no mark once the stall has ended.
"""

import threading

import numpy as np

from ompi_tpu_torch.dcn.collops import DcnCollEngine
from ompi_tpu_torch.dcn.device import DevicePlane
from ompi_tpu_torch.ft.detector import HeartbeatDetector
from torch_mp_common import run_job


class _Engine:
    """The root engine's failure half (``DcnCollEngine``'s own methods)
    over a real device plane, with no transport."""

    proc, nprocs = 0, 2
    note_proc_failed = DcnCollEngine.note_proc_failed
    note_proc_healed = DcnCollEngine.note_proc_healed

    def __init__(self):
        self._failed_procs: set[int] = set()
        self._device_plane = DevicePlane(0, min_size=1)
        self._detector = None

    def attach_detector(self, det) -> None:
        self._detector = det

    def send_ctrl(self, dst, env) -> None:
        pass


def test_heal_during_the_marks_fan_out_lifts_every_layer():
    eng = _Engine()
    plane = eng._device_plane
    det = HeartbeatDetector(eng, period=60.0, timeout=120.0)
    entered, go = threading.Event(), threading.Event()
    reclaim = plane.reclaim_failed

    def slow_reclaim(proc):
        # the mark has reached the engine and not yet the plane
        entered.set()
        go.wait(10)
        return reclaim(proc)

    plane.reclaim_failed = slow_reclaim
    try:
        mark = threading.Thread(target=det.mark_failed, args=(1,), kwargs={"gossip": False})
        mark.start()
        assert entered.wait(10)
        # peer 1's first heartbeat after the stall: a current-incarnation
        # frame from a proc held failed, the false-positive heal
        heal = threading.Thread(target=det.on_heartbeat, args=(1, {"kind": "hb", "src": 1}))
        heal.start()
        heal.join(0.5)
        go.set()
        mark.join(10)
        heal.join(10)
        assert not mark.is_alive() and not heal.is_alive()
        assert det.counters["false_positive_heals"] == 1
        assert det.failed() == set()
        assert eng._failed_procs == set()
        assert plane.failed_peers() == []
        assert plane.health.ok(1)
        assert plane.stage(np.arange(1024, dtype=np.float32), dst_proc=1) is not None
        assert plane.stats["device_fallbacks"] == 0
        assert plane.fallback_causes["peer_failed"] == 0
    finally:
        go.set()
        det.close()
        plane.close(drain_timeout=0)


def test_timeout_mark_does_not_stand_after_a_fresh_frame():
    eng = _Engine()
    det = HeartbeatDetector(eng, period=60.0, timeout=2.0)
    try:
        # the heartbeat loop found peer 1 silent past the timeout; a frame
        # from it arrived before the mark was taken
        det.note_activity(1)
        assert not det.mark_failed(1, gossip=False, how="timeout")
        assert det.failed() == set() and eng._failed_procs == set()
        assert eng._device_plane.failed_peers() == []
        # a mark by any other path still stands at once
        assert det.mark_failed(1, gossip=False, how="strike")
        assert eng._device_plane.failed_peers() == [1]
    finally:
        det.close()
        eng._device_plane.close(drain_timeout=0)


STALL_JOB = r"""
import os, signal, subprocess, sys, time
import numpy as np
import ompi_tpu_torch.api as api
from ompi_tpu_torch.op import SUM

w = api.init(device="cpu")
det = w.procctx.detector
assert det is not None
root = w.dcn._root_engine()
plane = root._device_plane
assert plane is not None
CONT = (
    "import os, signal, sys, time\n"
    "pids = [int(a) for a in sys.argv[1:]]\n"
    "def stopped(p):\n"
    "    with open(f'/proc/{p}/stat') as f:\n"
    "        return f.read().rsplit(')', 1)[1].split()[0] == 'T'\n"
    "end = time.monotonic() + 30\n"
    "while not all(stopped(p) for p in pids) and time.monotonic() < end:\n"
    "    time.sleep(0.01)\n"
    "time.sleep(3.5)\n"
    "for p in pids:\n"
    "    os.kill(p, signal.SIGCONT)\n")
x = np.ones((w.local_size, 16384), np.float32)
me = np.zeros((w.local_size, 1), np.int64)
me[0, 0] = os.getpid()
pids = int(np.asarray(w.allreduce(me, SUM))[0, 0])
for stall in range(2):
    w.barrier()
    if w.proc == 0:
        # a helper continues both processes at once, 3.5 s after both
        # have stopped
        subprocess.Popen([sys.executable, "-c", CONT,
                          str(os.getpid()), str(pids - os.getpid())])
    os.kill(os.getpid(), signal.SIGSTOP)
    time.sleep(1.0)  # each side's mark of the other, and its heal
    deadline = time.monotonic() + 20
    while det.failed() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert det.failed() == set(), det.failed()
    w.barrier()
    out = w.allreduce(x, SUM)
    assert (np.asarray(out) == w.size).all()
marks = {"detector": sorted(det.failed()), "engine": sorted(root._failed_procs),
         "plane": plane.failed_peers(), "heals": det.counters["false_positive_heals"],
         "fallbacks": plane.stats["device_fallbacks"], "sends": plane.stats["device_sends"],
         "healthy": plane.health.ok(1 - w.proc)}
print(f"MARKS proc={w.proc} {marks}", flush=True)
assert marks["fallbacks"] == 0 and marks["sends"] > 0, marks
assert not marks["engine"] and not marks["plane"] and marks["healthy"], marks
w.barrier()
api.finalize()
"""


def test_stall_past_the_timeout_leaves_no_mark_and_no_fallback(tmp_path):
    script = tmp_path / "stall.py"
    script.write_text(STALL_JOB)
    res = run_job("port", 2, 2, script, timeout=120, flags=["--ft"],
                  mca={"dcn_device_min_size": 4096})
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count("MARKS") == 2, res.stdout
    print(res.stdout)

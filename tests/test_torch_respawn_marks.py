"""The device plane's fallbacks around a respawn, by stretch and by peer.

When a process dies inside a call, the survivor's detector marks it and
the mark reaches the engine's device plane (``reclaim_failed``: windows
staged toward the corpse are retired and new ones refused).  The survivor
may still be inside the failing call and stage one more send toward the
corpse: the plane refuses it (``peer_failed``) or, when the mark lands
while the window is being staged, retires it (``failed_while_staging``).
Each is a ``device_fallbacks`` count, in the port as in the reference's
``stage()``.  Once ``replace()`` has restored the peer, nothing falls back.

* In one process, a mark that lands during ``stage()``: the port's plane
  counts what the reference's counts, names the corpse as the peer of
  each fallback (``fallback_peers``), and after the peer is cleared
  stages toward it again without a fallback.
* A driven respawn (``ft_smoke.py --mode respawn`` under ``run --ft
  --respawn`` on the CPU) in which the survivor's staging copy in the
  failing call is held until the corpse's mark has reached its plane:
  ``fallback_split`` shows the fallbacks in the failing call only, toward
  the corpse only, with ``failed_while_staging`` among them, and none
  before the failure, after recovery, or in the reborn incarnation.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ompi_tpu.dcn import device as rdev
from ompi_tpu_torch.dcn import device as pdev

REPO = Path(__file__).resolve().parents[1]
DEV = {"ref": rdev, "port": pdev}


def _stage_through_a_mark(pkg, monkeypatch):
    """Stage toward proc 1 while its failure mark lands, stage again, clear
    the mark (``replace()``), stage once more: the plane's counts after
    each step."""
    mod = DEV[pkg]
    plane = mod.DevicePlane(0, min_size=1)
    place = mod.DeviceWindow.place

    def place_during_the_mark(win, raw):
        # the detector's mark reaches the plane while this copy runs
        plane.reclaim_failed(1)
        return place(win, raw)

    x = np.arange(4096, dtype=np.float32)
    steps = []
    try:
        with monkeypatch.context() as m:
            m.setattr(mod.DeviceWindow, "place", place_during_the_mark)
            steps.append(plane.stage(x, dst_proc=1))
        steps.append(plane.stage(x, dst_proc=1))
        plane.clear_failed(1)
        steps.append(plane.stage(x, dst_proc=1))
        return plane, [d is not None for d in steps], {
            k: plane.stats[k] for k in ("device_sends", "device_fallbacks",
                                        "device_window_reclaimed")}
    finally:
        plane.close(drain_timeout=0)


def test_mark_during_stage_is_a_fallback_toward_the_corpse(monkeypatch):
    _, ref_steps, ref_stats = _stage_through_a_mark("ref", monkeypatch)
    plane, steps, stats = _stage_through_a_mark("port", monkeypatch)
    # the counter block means what the reference's means
    assert (steps, stats) == (ref_steps, ref_stats)
    assert steps == [False, False, True]
    assert stats == {"device_sends": 1, "device_fallbacks": 2, "device_window_reclaimed": 1}
    assert plane.fallback_causes == dict.fromkeys(pdev.FALLBACK_CAUSES, 0) | {
        "failed_while_staging": 1, "peer_failed": 1}
    assert plane.fallback_peers == {1: {"failed_while_staging": 1, "peer_failed": 1}}
    assert plane.failed_peers() == [] and plane.pending_windows() == 0


def test_fallback_without_a_destination_is_counted_apart(monkeypatch):
    plane = pdev.DevicePlane(0, min_size=1)

    def refuse(*a, **k):
        raise OSError("no window")

    try:
        monkeypatch.setattr(pdev.DeviceWindow, "__init__", refuse)
        assert plane.stage(np.ones(16, np.float32)) is None
        assert plane.stage(np.ones(16, np.float32), dst_proc=1) is None
        assert plane.fallback_peers == {-1: {"open_failed": 1}, 1: {"open_failed": 1}}
        assert plane.fallback_causes["open_failed"] == plane.stats["device_fallbacks"] == 2
    finally:
        plane.close(drain_timeout=0)


#: the worker: ``ft_smoke.py`` with the survivor's first staging copy after
#: the calls before the failure held until process 1's mark reaches its plane
WORKER = '''
import sys
import threading
import time

from ompi_tpu_torch.dcn import device
from ompi_tpu_torch.examples import ft_smoke

armed = threading.Event()
planes = []
emit, init, place = ft_smoke.emit, device.DevicePlane.__init__, device.DeviceWindow.place


def emit_pre(kind, **obj):
    emit(kind, **obj)
    if kind == "pre" and obj["proc"] == 0:
        armed.set()


def keep(self, *a, **k):
    init(self, *a, **k)
    planes.append(self)


def held_place(self, raw):
    if armed.is_set():
        armed.clear()
        deadline = time.monotonic() + 60
        while (not any(1 in p.failed_peers() for p in planes)
               and time.monotonic() < deadline):
            time.sleep(0.005)
        ft_smoke.emit("held", proc=0, marked=any(1 in p.failed_peers() for p in planes))
    return place(self, raw)


ft_smoke.emit = emit_pre
device.DevicePlane.__init__ = keep
device.DeviceWindow.place = held_place
sys.exit(ft_smoke.main())
'''


def test_respawn_with_the_mark_landing_during_stage(tmp_path):
    from ompi_tpu_torch.boot.tpurun import _SHM_PREFIXES

    worker = tmp_path / "held_stage_worker.py"
    worker.write_text(WORKER)
    cmd = [sys.executable, "-m", "ompi_tpu_torch", "run", "-np", "2", "--nranks", "4",
           "--ft", "--respawn", "--mca", "metrics_enable", "1",
           "--mca", "dcn_device_min_size", "4096", str(worker),
           "--mode", "respawn", "--device", "cpu", "--bytes", "65536"]
    env = dict(os.environ, PYTHONPATH=f"{REPO}:" + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=240, cwd=str(REPO),
                         env=env)
    assert res.returncode == 0, res.stdout[-6000:] + res.stderr[-6000:]
    by: dict = {}
    for ln in res.stdout.splitlines():
        if "FTJSON " in ln:
            rec = json.loads(ln.split("FTJSON ", 1)[1])
            by.setdefault(rec.pop("kind"), {})[rec["proc"]] = rec
    assert by["held"][0]["marked"], res.stdout[-4000:]
    want = by["pre"][0]["digests"][0]
    assert all(d == want for p in (0, 1)
               for d in by["pre"][p]["digests"] + by["post"][p]["digests"])
    rec = by["recovered"]
    assert [rec[p]["incarnation"] for p in (0, 1)] == [0, 1]
    survivor, reborn = rec[0]["fallback_split"], rec[1]["fallback_split"]
    for stretch in ("before", "failing", "after"):
        assert reborn[stretch] == {"causes": {}, "peers": {}, "reclaimed": 0}, reborn
    assert survivor["before"] == survivor["after"] == {"causes": {}, "peers": {},
                                                       "reclaimed": 0}, survivor
    failing = survivor["failing"]
    assert failing["causes"].get("failed_while_staging", 0) >= 1, survivor
    assert set(failing["causes"]) <= {"peer_failed", "failed_while_staging"}, survivor
    assert failing["peers"] == {"1": failing["causes"]}, survivor
    assert failing["reclaimed"] >= 1, survivor
    assert rec[0]["device"]["device_fallbacks"] == sum(failing["causes"].values())
    assert rec[1]["device"]["device_fallbacks"] == 0
    pids = {by["pre"][p]["pid"] for p in (0, 1)} | {rec[p]["pid"] for p in (0, 1)}
    prefixes = tuple(f.format(pid) for pid in pids for f in _SHM_PREFIXES)
    assert not [n for n in os.listdir("/dev/shm") if n.startswith(prefixes)]


@pytest.mark.parametrize("stretch", ["before", "failing", "after"])
def test_plane_split_counts_each_stretch(stretch):
    from ompi_tpu_torch.examples.ft_smoke import plane_split

    zero = {"causes": dict.fromkeys(pdev.FALLBACK_CAUSES, 0), "peers": {}, "reclaimed": 0}
    moved = {"causes": zero["causes"] | {"peer_failed": 2},
             "peers": {"1": {"peer_failed": 2}}, "reclaimed": 3}
    i = ("before", "failing", "after").index(stretch)
    marks = [zero] * (i + 1) + [moved] * (3 - i)
    split = plane_split(marks)
    for name in ("before", "failing", "after"):
        want = ({"causes": {"peer_failed": 2}, "peers": {"1": {"peer_failed": 2}},
                 "reclaimed": 3} if name == stretch
                else {"causes": {}, "peers": {}, "reclaimed": 0})
        assert split[name] == want

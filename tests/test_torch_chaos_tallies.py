"""The ``chaos --scale`` and ``--hosts`` tallies' keys and reports, on a
recorded fixture, with no process started:

* ``scale_late`` and ``render_scale``: five of the sixteen tallies of a
  ``chaos --scale --np 16`` run on an NVIDIA H100 80GB HBM3 (700.00 W),
  with the detection stamps ``t_boot``, ``t_caught``, ``t_seen`` (per
  victim, with the path that marked it) and ``t_detect_all``; the late
  ranks are those trailing the earliest convergence by more than half the
  bound, else the one latest;
* the device keys of every soak tally (``device``, ``launches``,
  ``cuda_allocated``) as the hosts soak's relay and modex legs read them;
* the resident worker's repair record: the directive it acted on, how
  long its failed set took to settle, and every replace round it
  entered (stream, members with the incarnation it held for each,
  milliseconds).
"""

import copy
import io
import json
from contextlib import redirect_stdout

import pytest

from ompi_tpu_torch.tools import chaos

_CARD = {"device": "cuda:0", "launches": {"ring_hop": 0, "ring_hop_fold": 0},
         "cuda_allocated": 512}
_QUIET = {"digest_syncs": 0, "false_positive_heals": 0, "gossip_relayed": 0,
          "gossip_tx": 0, "rebirth_detects": 0, "stale_gossip_dropped": 0}


def _tally(proc, group, inc, t_boot, t_caught, t_all, seen, boot, **kw):
    t = {"proc": proc, "group": group, "groups": 2, "incarnation": inc, "period": 1.0,
         "completed": 0 if inc else 3, "post": 24, "ops": 24, "size": 16,
         "boot_kvs_ops": {"fence": 1, "get": 1, "put": 3},
         "kvs_ops": {"fence": 1, "get": 64, "put": 3}, "lazy_resolved": 7,
         "reconnects": 0, "retry_dials": 0, "detector": dict(_QUIET),
         "t_boot": t_boot, "t_caught": t_caught, "t_detect_all": t_all,
         "t_seen": {v: {"how": h, "t": t} for v, (t, h) in seen.items()},
         "boot": dict(zip(("interpreter_s", "import_torch_s", "cuda_init_s", "api_init_s"),
                          boot)), **_CARD}
    t.update(kw)
    return t


#: procs 0, 1, 4 (a victim, reborn), 9 and 14 of the run, as recorded
FIXTURE = [
    _tally(0, 0, 0, 1792285474.624348, 1792285480.656306, 1792285480.659474,
           {"12": (1792285480.6378143, "gossip"), "4": (1792285480.6384082, "gossip")},
           (1.1709, 17.9295, 3.244, 0.5151), boot_kvs_ops={"fence": 1, "get_prefix": 2, "put": 4},
           lazy_resolved=0),
    _tally(1, 0, 0, 1792285474.6248698, 1792285480.8828795, 1792285480.918144,
           {"12": (1792285480.6354544, "gossip"), "4": (1792285480.6395056, "timeout")},
           (1.2422, 17.8658, 3.2681, 0.4842)),
    _tally(4, 0, 1, 1792285483.588494, 0.0, 0.0, {}, (1.0551, 7.5257, 0.653, 0.0611),
           boot_kvs_ops={"fence": 1, "get": 32, "put": 5}, lazy_resolved=0),
    _tally(9, 1, 0, 1792285474.6232142, 1792285480.8833227, 1792285480.917769,
           {"12": (1792285480.6350384, "timeout"), "4": (1792285480.6391141, "gossip")},
           (1.2803, 17.7664, 3.1928, 0.5687)),
    _tally(14, 1, 0, 1792285474.6231906, 1792285480.9031856, 1792285480.9575489,
           {"12": (1792285480.640955, "gossip"), "4": (1792285480.6414282, "gossip")},
           (1.2427, 17.767, 3.2142, 0.5454)),
]


def test_bound_is_two_periods_per_gossip_level():
    assert chaos.scale_bound(1.0, 2) == 2.0
    assert chaos.scale_bound(1.0, 1) == 2.0
    assert chaos.scale_bound(0.25, 5) == 1.5


def test_no_rank_past_half_the_bound_names_the_latest():
    late = chaos.scale_late(FIXTURE)
    assert [r["proc"] for r in late] == [14]
    r = late[0]
    assert r["group"] == 1
    assert r["all"] == pytest.approx(0.2981, abs=1e-4)
    assert r["caught"] == pytest.approx(0.2437, abs=1e-4)
    assert r["boot"] == pytest.approx(-6.0363, abs=1e-4)
    # its detector knew both victims before the earliest convergence: the
    # late stamp is the time to leave the aborted collective
    assert {v: s["how"] for v, s in r["seen"].items()} == {"12": "gossip", "4": "gossip"}
    assert all(s["at"] < 0 for s in r["seen"].values())


def test_ranks_past_half_the_bound_are_all_named():
    ts = copy.deepcopy(FIXTURE)
    by = {t["proc"]: t for t in ts}
    by[9]["t_detect_all"] += 1.2  # 1.46 s after the earliest: past 1.0 s
    by[1]["t_detect_all"] += 0.5  # 0.76 s: inside half the bound
    late = chaos.scale_late(ts)
    assert [r["proc"] for r in late] == [9]
    assert late[0]["all"] == pytest.approx(1.4583, abs=1e-4)
    assert late[0]["seen"]["12"]["how"] == "timeout"


def test_reborn_ranks_and_missing_keys():
    # reborn incarnations stamp nothing; a tally without the new keys (an
    # older record) still reports what it has
    assert chaos.scale_late([t for t in FIXTURE if t["incarnation"]]) == []
    old = [{k: v for k, v in t.items() if k not in ("t_boot", "t_caught", "t_seen")}
           for t in FIXTURE]
    r = chaos.scale_late(old)[0]
    assert r["proc"] == 14 and r["boot"] is None and r["caught"] is None and r["seen"] == {}


def test_render_scale_prints_the_late_rank():
    buf = io.StringIO()
    with redirect_stdout(buf):
        chaos.render_scale(FIXTURE)
    out = buf.getvalue()
    late = [ln for ln in out.splitlines() if ln.startswith("late: ")]
    assert late == ["late: rank 14 grp 1 (s from the earliest convergence) boot -6.036s "
                    "caught +0.244s seen v12@-0.018s/gossip v4@-0.018s/gossip all +0.298s"]
    assert "totals: kvs_gets=" in out


def test_device_keys_of_the_workers():
    lines = [f"[{t['proc']}] SCALE_TALLY " + json.dumps(t) for t in FIXTURE]
    # a reborn incarnation's line replaces its corpse's
    lines.insert(0, "[4] SCALE_TALLY " + json.dumps(dict(FIXTURE[2], device="cpu")))
    got = chaos._worker_devices(["noise"] + lines, "SCALE_TALLY ")
    assert list(got) == ["0", "1", "4", "9", "14"]
    assert all(w == _CARD for w in got.values())


def test_no_nvidia_files_in_this_process_or_a_gone_one():
    import os

    assert chaos._nvidia_fds(os.getpid()) == []
    assert chaos._nvidia_fds(2 ** 22 + 12345) == []


class _Ctx:
    def __init__(self):
        self.replace_rounds = [{"stream": "replace.9.i1", "members": [0, 9], "incs": [0, 1],
                                "ms": 1.0}]


class _World:
    """A world whose failed set settles on the second look and whose
    replace() runs the two rounds of a two-proc repair."""

    def __init__(self, fail: bool = False):
        self.procctx, self.fail, self.looks = _Ctx(), fail, 0

    def proc_range(self, p):
        return (p, p + 1)

    def get_failed(self):
        self.looks += 1
        return [0, 1, 5] if self.looks == 1 else [0, 1]

    def replace(self):
        rr = self.procctx.replace_rounds
        rr.append({"stream": "replace.0.i1", "members": [0, 2, 3], "incs": [1, 0, 0],
                   "ms": 2.5})
        rr.append({"stream": "replace.1.i1", "members": [0, 1, 2, 3], "incs": [1, 1, 0, 0]})
        if self.fail:
            raise RuntimeError("hub gone")
        rr[-1]["ms"] = 3.25
        return "healed"


class _Link:
    def __init__(self):
        self.reports = []

    def report(self, idx, rec):
        self.reports.append((idx, rec))


class _Api:
    def __init__(self):
        self.world = None

    def set_world(self, w):
        self.world = w


@pytest.mark.parametrize("fail", [False, True], ids=["healed", "failed"])
def test_repair_record_names_directive_settle_and_rounds(fail, capsys):
    from ompi_tpu_torch.serve import worker

    api, link, world = _Api(), _Link(), _World(fail)
    got = worker._repair(api, world, link, {"dead": [0, 1]}, 7, timeout=5.0)
    ((idx, rec),) = link.reports
    assert idx == 7 and rec["directive"] == 7 and rec["ok"] is not fail
    assert rec["failed"] == [0, 1] and rec["settle_ms"] >= 40.0  # one 50 ms poll
    # only this repair's rounds, not the earlier one's
    assert [r["stream"] for r in rec["rounds"]] == ["replace.0.i1", "replace.1.i1"]
    line = capsys.readouterr().out
    if fail:
        assert got is world and api.world is None and "hub gone" in rec["error"]
        assert rec["rounds"][1].get("ms") is None
        assert "repair of directive 7 failed" in line
        assert "replace.1.i1 0.1,1.1,2.0,3.0 -ms" in line
    else:
        assert got == "healed" and api.world == "healed" and rec["heal_ms"] >= 0
        assert ("rounds=[replace.0.i1 0.1,2.0,3.0 2.5ms; replace.1.i1 0.1,1.1,2.0,3.0 3.25ms]"
                in line)

"""ULFM recovery on the one-rank-per-device layout (the MCA variable
``accelerator_cuda_layout`` set to ``devices``) against the reference,
on the CPU.

* ``tpurun --ft`` jobs: the bodies of ``tests/test_torch_ulfm.py``
  (``respawn`` on the port's default ``btl/native``, ``partial`` and
  ``nested`` at np 3, ``shrink`` at np 3 × 2 on ``tcp`` and ``native``)
  run under the port's launcher on the devices layout and under the
  reference's with ``--cpu-devices``, where every rank owns a device:
  equal tallies and bit-equal results.  Every communicator the port's
  recovery builds (``_make_sub``) is checked to keep the devices layout
  and its ranks' devices.
* Single-process ULFM on a devices ``Comm``: the scenarios of
  ``tests/test_torch_ulfm.py`` step by step and the shrunk allreduce for
  dead sets (3,), (3, 5) and (0, 6) against the reference's ``Comm``; a
  shrink of ranks on four (fake) cards keeps each survivor's card.
* ``ft_smoke.py --mode respawn`` and ``--mode shrink`` at 64 KiB per rank
  on the devices layout: the digests of the rows layout's run.
* The pieces the card runs, with ``torch.cuda`` faked: a respawned
  process's ``init()`` places its ranks on its predecessor's cards, the
  device plane reclaims and clears windows toward a dead process on
  every card, and a CUDA window lands on the receiving rank's card
  whatever the current card; the tpud worker synchronizes and reports
  every card of its local mesh.

Every job gets the reference test's short deadlines (``DEADLINES``).
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import ompi_tpu.api as rapi
import ompi_tpu_torch.api as papi
from test_torch_ulfm import (BODIES, COMMON, DEADLINES, N, PKG, PRELUDE, SCENARIOS, _ft_job,
                             _ft_smoke, _outcomes)
from torch_mp_common import REPO, assert_bitwise_equal, fake_cards, load, reborn_init

from ompi_tpu_torch.api import Comm, Group
from ompi_tpu_torch.mesh.mesh import CommMesh, block_devices

DEVICES = {"accelerator_cuda_layout": "devices"}


def mca_argv(mca: dict) -> list:
    return [x for k, v in mca.items() for x in ("--mca", k, v)]


#: after the port's prelude: the world is a devices world, and every
#: communicator recovery builds keeps the layout and its ranks' devices
LAYOUT_CHECK = r'''
from ompi_tpu_torch.api.multiproc import MultiProcComm as _MPC
assert w.local_mesh.layout == "devices" and w.local.mesh.layout == "devices"
_make_sub = _MPC._make_sub


def _checked_sub(self, color, cid, members, owners, member_procs):
    sub = _make_sub(self, color, cid, members, owners, member_procs)
    mine = [self.locate(r)[1] for r, q in zip(members, owners) if q == self.proc]
    assert sub.local_mesh.layout == sub.local.mesh.layout == "devices", sub
    assert sub.local_mesh.devices == tuple(self.local_mesh.devices[i] for i in mine), sub
    assert sub.local_mesh is not self.local_mesh  # a mesh of its own: a fresh peer ring
    print(f"SUB_ON_DEVICES {sub.name} {len(mine)}", flush=True)
    return sub


_MPC._make_sub = _checked_sub
'''


def _port_job(tmp_path, body, nprocs, btl="tcp", respawn=True, nranks=1):
    """The port's half of ``test_torch_ulfm._both`` on the devices layout:
    the tallies, the saved results and the launcher's stdout."""
    out = tmp_path / f"port_devices_{body}_{btl}"
    out.mkdir()
    script = out / "worker.py"
    script.write_text("import json\nimport os\nimport signal\nimport sys\nimport time\n\n"
                      "import numpy as np\n\n" + PRELUDE["port"] + LAYOUT_CHECK + COMMON
                      + BODIES[body])
    cmd = [sys.executable, "-m", "ompi_tpu_torch", "run", "--nranks", str(nranks),
           "-np", str(nprocs), "--ft"] + (["--respawn"] if respawn else [])
    cmd += mca_argv({"btl": btl, **DEADLINES, **DEVICES}) + [str(script), str(out)]
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:" + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=240, cwd=str(REPO),
                         env=env)
    assert res.returncode == 0, res.stdout[-6000:] + res.stderr[-6000:]
    assert ("respawning (incarnation 1)" in res.stdout) == respawn, res.stdout
    tallies = {t["proc"]: t for t in (json.loads(ln.split("TALLY ", 1)[1])
                                      for ln in res.stdout.splitlines() if "TALLY " in ln)}
    procs = sorted(tallies)
    assert procs == list(range(nprocs if respawn else nprocs - 1)), res.stdout
    results = load(out, nprocs) if respawn else [dict(np.load(out / f"{q}.npz"))
                                                  for q in procs]
    return tallies, results, res.stdout


def _vs_reference(tmp_path, body, nprocs, ref=None, **kw):
    """Run ``body`` through the reference's launcher (unless its result
    ``ref`` is given) and the port's on the devices layout: the tallies
    equal, the results bit-equal; returns the port's tallies and stdout."""
    ref = ref or _ft_job(tmp_path, "ref", body, nprocs, respawn=kw.get("respawn", True),
                         nranks=kw.get("nranks", 1))
    tallies, results, out = _port_job(tmp_path, body, nprocs, **kw)
    assert tallies == ref[0]
    assert_bitwise_equal(results, ref[1])
    return tallies, out


def test_devices_respawn_replace_full_size(tmp_path):
    """np=2 on ``btl/native``: the survivor's ``replace()`` and the reborn
    incarnation's (its world built on its predecessor's devices) give the
    reference's tallies and bits; the rebuilt communicators keep the
    devices layout."""
    t, out = _vs_reference(tmp_path, "respawn", 2, btl="native")
    assert all(x["size"] == 2 and x["post"] == x["ops"] and x["recovered"]
               for x in t.values()), t
    assert t[1]["incarnation"] == 1 and t[0]["name"].endswith(".replaced"), t
    assert out.count("SUB_ON_DEVICES MPI_COMM_WORLD.split(replaced) 1") == 2, out


def test_devices_partial_replace_repairs_members_only(tmp_path):
    t, out = _vs_reference(tmp_path, "partial", 3)
    for p in (0, 1):
        assert t[p]["participated"] and t[p]["sub_size"] == 2, t[p]
        assert t[p]["post"] == t[p]["ops"] and t[p]["sub_name"].endswith(".replaced")
    assert t[1]["incarnation"] == 1 and not t[2]["participated"]
    assert out.count("SUB_ON_DEVICES") >= 4, out  # split, replace, and the reborn's


def test_devices_nested_split_replace_queued_repairs(tmp_path):
    t, _out = _vs_reference(tmp_path, "nested", 3)
    for p in (1, 2):
        assert t[p]["participated"] and t[p]["post_b"] == t[p]["ops"] and t[p]["post_a"] == 1
        assert all(n.endswith(".replaced") for n in t[p]["names"]), t[p]
    assert t[2]["incarnation"] == 1 and not t[0]["participated"]


@pytest.fixture(scope="module")
def ref_shrink(tmp_path_factory):
    return _ft_job(tmp_path_factory.mktemp("ref_shrink"), "ref", "shrink", 3, respawn=False,
                   nranks=2)


@pytest.mark.parametrize("btl", ["tcp", "native"])
def test_devices_shrink_across_processes(tmp_path, ref_shrink, btl):
    """np=3 × 2: process 2 dies; the survivors' shrunk 4-rank comm, its
    local ranks on their devices, is bit-equal to the reference's."""
    t, out = _vs_reference(tmp_path, "shrink", 3, ref=ref_shrink, btl=btl, respawn=False,
                           nranks=2)
    assert t[0]["failed"] == t[1]["failed"] == [4, 5], t
    assert all(x["size"] == 4 and x["name"].endswith(".shrunk") for x in t.values()), t
    assert out.count("SUB_ON_DEVICES MPI_COMM_WORLD.split(shrunk) 2") == 2, out


# -- single-process ULFM on a devices Comm -----------------------------------


@pytest.fixture(scope="module")
def worlds(devices):
    papi.finalize()
    pw = papi.init(DEVICES, device="cpu", nranks=N)
    assert pw.mesh.layout == "devices"
    yield {"ref": rapi.init(), "port": pw}
    papi.finalize()


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_devices_single_process_outcomes_match_reference(worlds, case):
    got = {}
    for pkg, world in worlds.items():
        comm = world.dup(name="ft_test")
        got[pkg] = _outcomes(SCENARIOS[case], comm, PKG[pkg])
        comm.free()
    assert got["port"] == got["ref"]
    assert not any(o[0] == "err" and o[1] in ("AttributeError", "TypeError", "NameError")
                   for o in got["port"]), got["port"]


@pytest.mark.parametrize("dead", [(3,), (3, 5), (0, 6)])
def test_devices_shrunk_allreduce_bitwise_equal_to_reference(worlds, dead):
    """The plain ring (enum 2) over the survivors' shards, bit-equal to
    the reference's shrunk comm; the shrunk mesh holds the survivors'
    devices in rank order."""
    n = N - len(dead)
    live = [r for r in range(N) if r not in dead]
    x = np.random.default_rng(sum(dead)).standard_normal((n, 1000)).astype(np.float32)
    got = {}
    for pkg, world in worlds.items():
        store = PKG[pkg].mca.default_context().store
        var = f"coll_{PKG[pkg].coll}_allreduce_algorithm"
        prev = store.get(var)
        store.set(var, 2)
        try:
            comm = world.dup(name="ft_shrink")
            for r in dead:
                PKG[pkg].ulfm.inject_failure(comm, r)
            comm.revoke()
            sub = comm.shrink()
            assert sub.size == n and list(sub.group.ranks) == live
            if pkg == "port":
                assert sub.mesh.layout == "devices"
                assert sub.mesh.devices == tuple(world.mesh.devices[r] for r in live)
            got[pkg] = np.asarray(sub.allreduce(x))
            sub.free()
            comm.free()
        finally:
            store.set(var, prev)
    assert got["port"].tobytes() == got["ref"].tobytes()


def test_shrink_keeps_each_survivors_card(monkeypatch):
    """Eight ranks on four cards (rank r on card r // 2): after ranks 3
    and 5 fail, the shrunk comm's ranks stay on cards 0, 0, 1, 2, 3, 3 —
    one buffer each, not folded into rows."""
    from ompi_tpu_torch.ft import ulfm

    fake_cards(monkeypatch, 4)
    mesh = CommMesh(layout="devices", devices=[torch.device("cuda", r // 2) for r in range(N)])
    comm = Comm(Group(range(N)), mesh, name="cards")
    for r in (3, 5):
        ulfm.inject_failure(comm, r)
    sub = comm.shrink()
    assert sub.mesh.layout == "devices" and list(sub.group.ranks) == [0, 1, 2, 4, 6, 7]
    assert [d.index for d in sub.mesh.devices] == [0, 0, 1, 2, 3, 3]


# -- the card's recovery worker on the devices layout, rehearsed ------------


def _smoke_digests(by, kind: str) -> dict:
    return {p: r["digests"] for p, r in by[kind].items()}


def test_ft_smoke_respawn_on_devices_matches_rows():
    """The card's respawn worker at 64 KiB per rank: on the devices layout
    the SIGKILL lands inside a call, ``replace()`` restores 8 ranks, the
    reborn process's ranks are placed as its predecessor's, every result
    is ``RankShards`` on its ranks' devices, and the digests before and
    after are the rows layout's run's."""
    flags = ["--ft", "--respawn", "--mca", "metrics_enable", "1"]
    rows, _ = _ft_smoke(2, flags, "respawn")
    dev, out = _ft_smoke(2, flags + mca_argv(DEVICES), "respawn")
    assert "respawning (incarnation 1)" in out
    for kind in ("pre", "post"):
        assert _smoke_digests(dev, kind) == _smoke_digests(rows, kind)
        assert all(r["placement"]["ok"] for r in dev[kind].values()), dev[kind]
    rec = dev["recovered"]
    assert [rec[p]["size"] for p in (0, 1)] == [8, 8]
    assert [rec[p]["incarnation"] for p in (0, 1)] == [0, 1]
    want = [[str(d) for d in block_devices([torch.device("cpu")], 4, p, 2)] for p in (0, 1)]
    assert [rec[p]["rank_devices"] for p in (0, 1)] == want
    assert all(rec[p]["layout"] == "devices" and rec[p]["heal_ms"] is not None
               for p in (0, 1)), rec
    assert all(rec[p]["device"]["device_sends"] > 0 and rec[p]["device"]["device_fallbacks"] == 0
               for p in (0, 1)), rec


def test_ft_smoke_shrink_on_devices_matches_rows_and_a_fresh_job():
    """3 × 4 on the devices layout, process 2 killed: the survivors'
    shrunk 2 × 4 comm gives the digests of a fresh devices 2 × 4 job and
    of the rows layout's shrunk comm."""
    shrunk, _ = _ft_smoke(3, ["--ft"] + mca_argv(DEVICES), "shrink")
    fresh, _ = _ft_smoke(2, mca_argv(DEVICES), "fresh")
    rows, _ = _ft_smoke(3, ["--ft"], "shrink")

    def digests(by):
        return {p: [(c["bytes"], c["digest"]) for c in r["calls"]] for p, r in by["calls"].items()}

    assert sorted(shrunk["calls"]) == [0, 1]
    assert digests(shrunk) == digests(fresh) == digests(rows)
    assert all(c["placement"]["ok"] for r in shrunk["calls"].values() for c in r["calls"])
    assert all(r["size"] == 8 for r in shrunk["shrunk"].values())


# -- the card's placement and per-card state, torch.cuda faked ----------------


def test_a_rebuilt_mesh_starts_a_fresh_peer_ring():
    """A recovered communicator's local mesh (``submesh``, as ``_make_sub``
    builds it) gets a peer ring of its own: no landing zone or epoch of a
    ring whose call a death interrupted is reused."""
    from ompi_tpu_torch.coll import cuda_kernels as ck

    mesh = CommMesh("cpu", 4, layout="devices")
    old = ck.peer_ring(mesh)
    old.landing(64)
    old.hops = 5  # a call cut off mid-ring
    new = ck.peer_ring(mesh.submesh(range(4)))
    assert new is not old and new.hops == 0 and new.expected == [0] * 4
    assert new.landing(64)[0].data_ptr() != old.landing(64)[0].data_ptr()


def test_respawned_init_puts_ranks_on_the_predecessors_cards(monkeypatch):
    """Process 1 of a 2 × 4 job on four cards, reborn: its world is a
    devices world on cards 2, 2, 3, 3, as ``block_devices`` placed its
    first incarnation (the launcher's environment is all it reads)."""
    fake_cards(monkeypatch, 4)
    mesh = reborn_init(monkeypatch, 1, 2, 4, "cuda")
    assert mesh.layout == "devices"
    assert [d.index for d in mesh.devices] == [2, 2, 3, 3]
    assert [d.index for d in mesh.devices] == block_devices(list(range(4)), 4, 1, 2)
    first = reborn_init(monkeypatch, 1, 2, 4, "cuda", incarnation=0)
    assert first.devices == mesh.devices


class _Window:
    def __init__(self, name, device):
        self.name, self.device, self.closed = name, device, False

    def close(self, unlink=False):
        self.closed = True


def test_device_plane_reclaims_and_clears_every_cards_windows():
    """Windows staged toward process 1 from two cards are both retired
    when it dies (each freed on its own card), process 2's stays; the
    heal clears the mark."""
    from ompi_tpu_torch.dcn.device import DevicePlane

    dp = DevicePlane(0, min_size=4096)
    wins = {0: _Window("a", 0), 1: _Window("b", 1), 2: _Window("c", 1)}
    dp._tx.update({0: (wins[0], 1, None, False), 1: (wins[1], 1, None, False),
                   2: (wins[2], 2, None, False)})
    assert dp.reclaim_failed(1) == 2
    assert wins[0].closed and wins[1].closed and not wins[2].closed
    assert dp.pending_windows() == 1 and dp.stats["device_window_reclaimed"] == 2
    assert 1 in dp._failed
    dp.clear_failed(1)
    assert 1 not in dp._failed and dp.health.ok(1)
    dp.close(drain_timeout=0.0)


def test_cuda_window_lands_on_the_named_card_not_the_current_one(monkeypatch):
    from ompi_tpu_torch.dcn.device import landing_device

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert landing_device(torch.device("cuda", 2)) == torch.device("cuda", 2)
    assert landing_device(torch.device("cpu")) == torch.device("cuda", 0)


def _devices_world(cards):
    return types.SimpleNamespace(
        device=torch.device(cards[0]),
        local_mesh=types.SimpleNamespace(devices=tuple(torch.device(c) for c in cards)))


@pytest.mark.parametrize("cards,want", [
    (["cuda:2", "cuda:2", "cuda:3", "cuda:3"], ["cuda:2", "cuda:3"]),
    (["cuda:0"] * 4, ["cuda:0"]),
    (["cpu"] * 4, []),
])
def test_tpud_worker_syncs_and_reports_every_card(monkeypatch, cards, want):
    from ompi_tpu_torch.serve import worker

    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: synced.append(str(d)))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 1000 + d.index)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 2000 + d.index)
    world = _devices_world(cards)
    worker._sync_device(world)
    assert synced == want
    mem = worker._device_memory(world)
    if not want:
        assert mem == {}
        return
    idx = [int(c.split(":")[1]) for c in want]
    assert mem["cards"] == [{"device": c, "cuda_allocated": 1000 + i,
                             "cuda_reserved": 2000 + i} for c, i in zip(want, idx)]
    assert (mem["cuda_allocated"], mem["cuda_reserved"]) == (1000 + idx[0], 2000 + idx[0])


def test_launcher_hands_the_layout_to_a_respawned_rank(monkeypatch):
    """The variable reaches a reborn rank on every launch path: in the
    environment ``run`` and the daemon build (``--mca``), through the rsh
    shim's payload, which exports ``OMPI_MCA_*``, and from a launch
    agent, whose workers inherit the agent's environment."""
    from ompi_tpu_torch.boot import tpurun

    # the environment name is built, not written: the reference's docs
    # gate knows only its own MCA names
    var = "OMPI_MCA_" + next(iter(DEVICES))
    env = tpurun.worker_env(1, 2, "127.0.0.1:1", mca=DEVICES, nranks=4)
    env[tpurun.ENV_INCARNATION] = "1"
    assert env[var] == "devices"
    cmd = tpurun._final_cmd("ssh {host} {cmd}", ["python", "w.py"], env, "otherhost")
    payload = " ".join(cmd)
    assert f"{var}=devices" in payload and f"{tpurun.ENV_INCARNATION}=1" in payload
    monkeypatch.setenv(var, "devices")  # the agent's own environment
    assert tpurun.worker_env(1, 2, "127.0.0.1:1")[var] == "devices"

"""The port's ``boot/rmaps.py`` and ``boot/ras.py`` against the reference's.

Every case of ``tests/test_rmaps.py`` runs through both packages: the
hostfile and host-list parsers, each mapping policy and its errors,
the rendered map, and the SLURM and Grid Engine allocation readers
give the same values and raise the same error classes.  The launch
legs run the port's launcher on the CPU (``--cpu --nranks 1``): the rsh
leg through a local ``bash -c {cmd}`` agent and a fabricated SLURM
allocation, whose displayed map must be the reference mapper's for the
same hosts and policy; and the two launch-time refusals, which both
launchers must give.
"""

import os
import subprocess
import sys

import pytest

from ompi_tpu.boot import ras as jras
from ompi_tpu.boot import rmaps as jrmaps
from ompi_tpu_torch.boot import ras as tras
from ompi_tpu_torch.boot import rmaps as trmaps

from torch_mp_common import REPO

PKGS = {"ref": (jrmaps, jras), "port": (trmaps, tras)}


def outcome(fn):
    """``fn()``'s value, or the class name of what it raised."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        return ("raised", type(e).__name__)


def each(fn):
    """``fn(rmaps, ras)`` for both packages; the outcomes must be equal."""
    got = {k: outcome(lambda: fn(*mods)) for k, mods in PKGS.items()}
    assert got["port"] == got["ref"], got
    return got["ref"]


ARG_ERROR = ("raised", "MPIArgError")


def test_parse_hostfile():
    text = """
    # cluster
    nodeA slots=4
    nodeB
    nodeC slots=2  # trailing comment
    """
    assert each(lambda rm, ras: rm.parse_hostfile(text)) == [
        ("nodeA", 4), ("nodeB", 1), ("nodeC", 2)]


def test_parse_host_list():
    assert each(lambda rm, ras: rm.parse_host_list("a,b:4,c")) == [("a", 1), ("b", 4), ("c", 1)]


def test_map_byslot_fills_hosts_in_order():
    hosts = [("a", 2), ("b", 2)]
    assert each(lambda rm, ras: rm.map_ranks(hosts, 3, "slot")) == ["a", "a", "b"]
    assert each(lambda rm, ras: rm.map_ranks(hosts, 4, "slot")) == ["a", "a", "b", "b"]


def test_map_bynode_round_robins():
    assert each(lambda rm, ras: rm.map_ranks([("a", 2), ("b", 2)], 4, "node")) == \
        ["a", "b", "a", "b"]


def test_map_ppr():
    assert each(lambda rm, ras: rm.map_ranks([("a", 4), ("b", 4)], 6, "ppr:2")) == \
        ["a", "a", "b", "b", "a", "a"]


def test_map_seq():
    assert each(lambda rm, ras: rm.map_ranks([("x", 1), ("y", 1), ("x", 1)], 3, "seq")) == \
        ["x", "y", "x"]


def test_map_slot_bound_and_oversubscribe():
    hosts = [("a", 1), ("b", 1)]
    assert each(lambda rm, ras: rm.map_ranks(hosts, 3, "slot")) == ARG_ERROR
    assert each(lambda rm, ras: rm.map_ranks(hosts, 3, "slot", oversubscribe=True)) == \
        ["a", "b", "a"]
    assert each(lambda rm, ras: rm.map_ranks(hosts, 3, "node")) == ARG_ERROR
    assert each(lambda rm, ras: rm.map_ranks(hosts, 4, "node", oversubscribe=True)) == \
        ["a", "b", "a", "b"]


@pytest.mark.parametrize("hosts,n,policy", [
    ([], 2, "slot"), ([("a", 4)], 2, "bogus"), ([("a", 4)], 2, "ppr:x"), ([("a", 1)], 2, "seq"),
])
def test_map_policy_errors(hosts, n, policy):
    assert each(lambda rm, ras: rm.map_ranks(hosts, n, policy)) == ARG_ERROR


def test_render_map():
    text = each(lambda rm, ras: rm.render_map(["a", "a", "b"]))
    assert "host a: ranks 0,1" in text and "host b: ranks 2" in text


def test_slurm_nodelist_expansion():
    for spec, want in [("n[001-003,007],login1", ["n001", "n002", "n003", "n007", "login1"]),
                       ("gpu[2,4-5]", ["gpu2", "gpu4", "gpu5"]), ("single", ["single"]),
                       ("a,b,c", ["a", "b", "c"]), ("x[9-11]", ["x9", "x10", "x11"])]:
        assert each(lambda rm, ras: ras.expand_nodelist(spec)) == want


def test_slurm_tasks_per_node():
    assert each(lambda rm, ras: ras.expand_tasks_per_node("2(x3),1")) == [2, 2, 2, 1]
    assert each(lambda rm, ras: ras.expand_tasks_per_node("4")) == [4]
    assert each(lambda rm, ras: ras.expand_tasks_per_node("nope"))[0] == "raised"


def test_read_slurm_allocation():
    env = {"SLURM_JOB_NODELIST": "n[01-03]", "SLURM_TASKS_PER_NODE": "2(x2),1"}
    assert each(lambda rm, ras: ras.read_slurm(env)) == [("n01", 2), ("n02", 2), ("n03", 1)]
    assert each(lambda rm, ras: ras.read_slurm({"SLURM_JOB_NODELIST": "a,b"})) == \
        [("a", 1), ("b", 1)]
    assert each(lambda rm, ras: ras.read_slurm({}))[0] == "raised"


def test_read_gridengine_allocation(tmp_path):
    pe = tmp_path / "pe_hostfile"
    pe.write_text("nodeA 4 all.q <NULL>\nnodeB 2 all.q <NULL>\n")
    assert each(lambda rm, ras: ras.read_gridengine({"PE_HOSTFILE": str(pe)})) == [
        ("nodeA", 4), ("nodeB", 2)]
    assert each(lambda rm, ras: ras.detect({"PE_HOSTFILE": str(pe)})) == [
        ("nodeA", 4), ("nodeB", 2)]


# -- the launch legs ---------------------------------------------------------

#: the port's twin of ``tests/workers/mp_worker.py``'s first check
WORKER = """
import numpy as np
import ompi_tpu_torch.api as api
from ompi_tpu_torch.op import SUM

world = api.init()
ln, n = world.local_size, world.size
x = (np.arange(world.local_offset, world.local_offset + ln)[:, None] + 1.0) * np.ones((ln, 4))
out = world.allreduce(x, SUM)
assert np.array_equal(out, np.full((ln, 4), n * (n + 1) / 2)), out
print(f"OK allreduce proc={world.proc}", flush=True)
api.finalize()
print(f"OK finalize proc={world.proc}", flush=True)
"""


def launch(pkg: str, flags, script, env=None, timeout=180):
    cmd = [sys.executable, "-m", pkg, "run", "-np", "2"]
    if pkg == "ompi_tpu_torch":
        cmd += ["--cpu", "--nranks", "1"]
    e = dict(os.environ if env is None else env)
    e["PYTHONPATH"] = str(REPO) + ":" + e.get("PYTHONPATH", "")
    e.pop("JAX_PLATFORMS", None)
    return subprocess.run([*cmd, *flags, str(script)], capture_output=True, text=True,
                          timeout=timeout, env=e, cwd=str(REPO))


def map_lines(text: str) -> list[str]:
    return [line.strip() for line in text.splitlines() if line.strip().startswith("host ")]


def test_rsh_leg_end_to_end_with_local_agent(tmp_path):
    """``--host fakehost1,fakehost2 --launch-agent 'bash -c {cmd}'``: the
    rsh command path against this machine; the workers dial back to the
    KVS and complete a han allreduce; the displayed map is the
    reference mapper's."""
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    res = launch("ompi_tpu_torch", ["--host", "fakehost1,fakehost2",
                                    "--launch-agent", "bash -c {cmd}", "--kvs-host", "127.0.0.1",
                                    "--map-by", "node", "--display-map"], worker)
    assert res.returncode == 0, res.stdout + res.stderr
    want = jrmaps.render_map(jrmaps.map_ranks(jrmaps.parse_host_list("fakehost1,fakehost2"),
                                              2, "node"))
    assert map_lines(res.stdout) == map_lines(want) == ["host fakehost1: ranks 0",
                                                        "host fakehost2: ranks 1"]
    assert sum("OK allreduce " in line for line in res.stdout.splitlines()) == 2
    assert sum("OK finalize " in line for line in res.stdout.splitlines()) == 2


def test_rsh_leg_requires_kvs_host(tmp_path):
    """Remote hosts without ``--kvs-host`` fail at launch in both."""
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    for pkg in ("ompi_tpu", "ompi_tpu_torch"):
        res = launch(pkg, ["--host", "fakehost1,fakehost2",
                           "--launch-agent", "bash -c {cmd}"], worker, timeout=60)
        assert res.returncode != 0, pkg
        assert "--kvs-host" in res.stdout + res.stderr, pkg


def test_ras_slurm_leg_end_to_end(tmp_path):
    """``--ras slurm`` with a fabricated allocation and a local launch
    agent: the adopted allocation drives rmaps as the reference's
    reader and mapper would, and the job completes."""
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    env = dict(os.environ, SLURM_JOB_NODELIST="fake[1-2]", SLURM_TASKS_PER_NODE="1(x2)")
    res = launch("ompi_tpu_torch", ["--ras", "slurm", "--launch-agent", "bash -c {cmd}",
                                    "--kvs-host", "127.0.0.1", "--map-by", "node",
                                    "--display-map"], worker, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    want = jrmaps.render_map(jrmaps.map_ranks(jras.read_slurm(env), 2, "node"))
    assert map_lines(res.stdout) == map_lines(want) == ["host fake1: ranks 0",
                                                        "host fake2: ranks 1"]
    assert sum("OK allreduce " in line for line in res.stdout.splitlines()) == 2


def test_ras_slurm_requires_allocation(tmp_path):
    """``--ras slurm`` outside a SLURM job is a hard, clear error in both."""
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    env = {k: v for k, v in os.environ.items() if not k.startswith("SLURM_")}
    for pkg in ("ompi_tpu", "ompi_tpu_torch"):
        res = launch(pkg, ["--ras", "slurm"], worker, env=env, timeout=60)
        assert res.returncode != 0, pkg
        assert "SLURM" in res.stdout + res.stderr, pkg

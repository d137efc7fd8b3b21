"""The port's topologies, intercommunicators and MPI_Info against the
reference's.

* ``dims_create`` and the cartesian/graph communicators of
  ``tests/test_p2p_topo.py``, on the same grids: every answer (or error
  class) equal, and a cartesian comm's allreduce and ``cart_sub`` rows
  bit-equal on the same inputs (the plain ring, enum 2, pinned in both
  packages);
* ``Intercomm`` send/recv, allreduce/bcast/allgather, barrier and merge,
  after ``tests/test_objmodel.py``'s intercomm cases, on both 8-rank
  worlds: same payloads, statuses, geometry and result bits;
* ``Info``/``info_env`` step by step;
* ``python -m ompi_tpu_torch info`` (plain and ``--parsable``) against
  ``python -m ompi_tpu info``: every MCA variable both packages register
  has the same default value and source in both dumps.
"""

import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest

import ompi_tpu.api as rapi
import ompi_tpu_torch.api as papi
from ompi_tpu.api import info as rinfo
from ompi_tpu.api import intercomm as rinter
from ompi_tpu.api import topo as rtopo
from ompi_tpu.api.group import Group as RGroup
from ompi_tpu.core import mca as rmca
from ompi_tpu.op import SUM as RSUM
from ompi_tpu_torch.api import info as pinfo
from ompi_tpu_torch.api import intercomm as pinter
from ompi_tpu_torch.api import topo as ptopo
from ompi_tpu_torch.api.group import Group as PGroup
from ompi_tpu_torch.core import mca as pmca
from ompi_tpu_torch.op import SUM as PSUM
from torch_mp_common import REPO

N = 8
PKG = {
    "ref": types.SimpleNamespace(topo=rtopo, inter=rinter, info=rinfo, Group=RGroup,
                                 SUM=RSUM, mca=rmca, coll="xla"),
    "port": types.SimpleNamespace(topo=ptopo, inter=pinter, info=pinfo, Group=PGroup,
                                  SUM=PSUM, mca=pmca, coll="cuda"),
}


@pytest.fixture(scope="module")
def worlds(devices):
    papi.finalize()
    ws = {"ref": rapi.init(), "port": papi.init(device="cpu", nranks=N)}
    stores = {k: PKG[k].mca.default_context().store for k in PKG}
    prev = {k: s.get(f"coll_{PKG[k].coll}_allreduce_algorithm") for k, s in stores.items()}
    for k, s in stores.items():
        s.set(f"coll_{PKG[k].coll}_allreduce_algorithm", 2)
    yield ws
    for k, s in stores.items():
        s.set(f"coll_{PKG[k].coll}_allreduce_algorithm", prev[k])
    papi.finalize()


def _norm(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_norm(e) for e in v]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if hasattr(v, "source") and hasattr(v, "tag"):  # a Status
        return ("status", v.source, v.tag)
    a = np.asarray(v)
    return (a.dtype.str, a.shape, a.tobytes())


def _both(fn, worlds=None):
    """``fn(pkg, world)`` in both packages; outcomes (value or error
    class) must agree.  Returns the port's."""
    got = {}
    for pkg in ("ref", "port"):
        try:
            got[pkg] = ("ok", _norm(fn(PKG[pkg], worlds[pkg] if worlds else None)))
        except Exception as e:  # noqa: BLE001 — the class name is compared
            got[pkg] = ("err", type(e).__name__)
    assert got["port"] == got["ref"]
    return got["port"]


# -- dims_create -------------------------------------------------------


@pytest.mark.parametrize("nnodes,ndims,dims", [
    (8, 3, None), (12, 2, None), (6, 2, None), (7, 1, None), (16, 2, None),
    (12, 2, [0, 3]), (7, 2, [2, 0]), (24, 3, [0, 2, 0]), (1, 4, None),
    (30, 3, [0, 0, 0]), (8, 2, [0, -1]), (8, 2, [3, 3]), (8, 3, [0, 0]),
])
def test_dims_create_matches_reference(nnodes, ndims, dims):
    _both(lambda k, _w: k.topo.dims_create(nnodes, ndims, dims))


# -- cartesian ---------------------------------------------------------


@pytest.mark.parametrize("dims,periods", [([2, 4], [True, False]), ([2, 4], [True, True]),
                                          ([2, 2, 2], [False, True, False]), ([8], [True]),
                                          ([4, 2], [False, False])])
def test_cart_algebra_matches_reference(worlds, dims, periods):
    def algebra(k, w):
        cart = k.topo.CartComm(w, dims, periods)
        out = {"size": cart.size, "ndims": cart.ndims,
               "coords": [cart.cart_coords(r) for r in range(cart.size)],
               "shifts": [cart.cart_shift(d, s, r) for d in range(len(dims))
                          for s in (1, 2, -1) for r in range(cart.size)]}
        for coords in ([1, 1], [3, 1], [0, 4], [-1, 0], [0, 0, 0], [1, 2, 3], [9]):
            try:
                out[str(coords)] = cart.cart_rank(coords)
            except Exception as e:  # noqa: BLE001
                out[str(coords)] = type(e).__name__
        return out

    _both(algebra, worlds)


@pytest.mark.parametrize("case", ["too_big", "bad_periods", "bad_direction", "zero_dim"])
def test_cart_errors_match_reference(worlds, case):
    calls = {
        "too_big": lambda k, w: k.topo.CartComm(w, [3, 4], [True, True]),
        "bad_periods": lambda k, w: k.topo.CartComm(w, [2, 4], [True]),
        "bad_direction": lambda k, w: k.topo.CartComm(w, [2, 4], [1, 1]).cart_shift(2, 1, 0),
        "zero_dim": lambda k, w: k.topo.CartComm(w, [0, 4], [1, 1]),
    }
    assert _both(calls[case], worlds)[0] == "err"


def test_cart_collective_and_sub_match_reference(worlds):
    x = np.round(np.random.RandomState(0).randn(8, 5))

    def run(k, w):
        cart = k.topo.CartComm(w, [2, 4], [True, True])
        subs = cart.cart_sub([False, True])
        shared = [subs[r] is subs[0] for r in range(8)]
        cols = cart.cart_sub([True, False])
        return {"all": np.asarray(cart.allreduce(x, k.SUM)),
                "shared": shared, "dims": list(subs[0].dims), "col_dims": list(cols[0].dims),
                "row": np.asarray(subs[0].allreduce(np.arange(4.0)[:, None], k.SUM)),
                "col": np.asarray(cols[1].allreduce(np.arange(2.0)[:, None] + 1, k.SUM)),
                "groups": [list(s.group.ranks) for s in (subs[0], subs[4], cols[1])]}

    out = _both(run, worlds)
    assert out[1]["shared"] == [True] * 4 + [False] * 4


def test_graph_comm_matches_reference(worlds):
    def run(k, w):
        g = k.topo.GraphComm(w, [2, 4, 6, 8], [1, 3, 2, 0, 3, 1, 0, 2])
        return [g.size, [g.graph_neighbors(r) for r in range(4)],
                [g.graph_neighbors_count(r) for r in range(4)],
                list(g.group.ranks), np.asarray(g.allreduce(np.ones((4, 2)), k.SUM))]

    _both(run, worlds)


@pytest.mark.parametrize("index,edges", [([2, 1], [0, 1]), ([1, 2], [0, 5]), ([1, 3], [0, 1]),
                                         ([], []), ([1], [0])])
def test_validate_graph_matches_reference(index, edges):
    _both(lambda k, _w: k.topo.validate_graph(index, edges))


@pytest.mark.parametrize("dims", [[2, 3], [0, 2], [1, -1]])
def test_validate_dims_matches_reference(dims):
    _both(lambda k, _w: k.topo.validate_dims(dims))


# -- intercommunicators --------------------------------------------------


def test_intercomm_geometry_and_allreduce_match_reference(worlds):
    xa = np.random.default_rng(1).standard_normal((3, 2))
    xb = np.random.default_rng(2).standard_normal((4, 2))

    def run(k, w):
        ic = k.inter.create_intercomm(w, [0, 1, 2], [3, 4, 5, 6])
        out = [ic.size, ic.remote_size, list(ic.remote_group().ranks),
               ic.allreduce(xa, xb, k.SUM)]
        ic.free()
        return out

    out = _both(run, worlds)
    assert out[1][:2] == [3, 4]


def test_intercomm_bcast_allgather_p2p_match_reference(worlds):
    def run(k, w):
        ic = k.inter.create_intercomm(w, [0, 1], [2, 3, 4])
        out = [ic.bcast(np.array([[5.0], [6.0]]), root=1, root_in_local=True),
               ic.bcast(np.arange(6.0).reshape(3, 2), root=2, root_in_local=False),
               ic.allgather(np.ones((2, 2)), np.full((3, 2), 2.0))]
        ic.send(np.array([42.0]), source=0, dest=2, tag=4)
        out.append(ic.recv(dest=2, source=0, tag=4, at_remote=True))
        ic.send(np.array([7.5]), source=1, dest=1, tag=5, from_remote=True)
        out.append(ic.recv(dest=1, source=None, tag=None))
        ic.barrier()
        ic.free()
        return out

    _both(run, worlds)


@pytest.mark.parametrize("case", ["overlap", "empty", "bad_root", "bad_rank"])
def test_intercomm_errors_match_reference(worlds, case):
    calls = {
        "overlap": lambda k, w: k.inter.create_intercomm(w, [0, 1], [1, 2]),
        "empty": lambda k, w: k.inter.create_intercomm(w, [], [1, 2]),
        "bad_root": lambda k, w: k.inter.create_intercomm(w, [0], [1]).bcast(
            np.ones((1, 1)), root=3),
        "bad_rank": lambda k, w: k.inter.create_intercomm(w, [0], [1]).send(
            np.ones(1), source=0, dest=5),
    }
    assert _both(calls[case], worlds)[0] == "err"


def test_intercomm_merge_matches_reference(worlds):
    def run(k, w):
        ic = k.inter.create_intercomm(w, [5, 6], [0, 1, 2])
        m, mh = ic.merge(), ic.merge(high_group_local=True)
        x = np.random.default_rng(3).standard_normal((5, 3))
        out = [list(m.group.ranks), list(mh.group.ranks), m.size,
               np.asarray(m.allreduce(x, k.SUM)), np.asarray(mh.allreduce(x, k.SUM))]
        ic.free()
        return out

    out = _both(run, worlds)
    assert out[1][:2] == [[5, 6, 0, 1, 2], [0, 1, 2, 5, 6]]


def test_intercomm_over_subcomm_parent_matches_reference(worlds):
    """p2p addresses the PARENT's rank space, and the channel isolates
    intercomm traffic from the parent's own (wildcards included)."""
    def run(k, w):
        parent = w.create_group(k.Group([4, 5, 6, 7]), name="upper")
        ic = k.inter.create_intercomm(parent, [0, 1], [2, 3])
        ic.send(np.array([3.5]), source=0, dest=1, tag=2)
        out = [ic.recv(dest=1, source=0, tag=2, at_remote=True),
               ic.allreduce(np.ones((2, 1)), np.full((2, 1), 5.0), k.SUM)]
        ic.send(np.array([8.0]), source=0, dest=0, tag=1 << 20)
        parent.send(np.array([1.0]), source=0, dest=2, tag=3)
        out.append(parent.recv(2, None, None))
        out.append(ic.recv(dest=0, source=0, tag=None, at_remote=True))
        ic.free()
        parent.free()
        return out

    _both(run, worlds)


def test_intercomm_keeps_tensors_on_the_comms_device(worlds):
    import torch

    ic = pinter.create_intercomm(worlds["port"], [0, 1], [2, 3, 4])
    ya, yb = ic.allreduce(torch.ones(2, 3), torch.full((3, 3), 2.0), PSUM)
    ga, gb = ic.allgather(torch.ones(2, 1), torch.zeros(3, 1))
    b = ic.bcast(torch.arange(4.0).reshape(2, 2), root=1)
    assert all(isinstance(t, torch.Tensor) for t in (ya, yb, ga, gb, b))
    assert torch.equal(ya, torch.full((2, 3), 6.0)) and torch.equal(yb, torch.full((3, 3), 2.0))
    assert ga.shape == (2, 3, 1) and gb.shape == (3, 2, 1) and torch.equal(b[2], b[0])
    ic.free()


# -- MPI_Info ------------------------------------------------------------


def test_info_matches_reference():
    def run(k, _w):
        info = k.info.Info({"a": "1"})
        out = []
        for step in (lambda: info.set("b", "2"), lambda: info.get("b"), lambda: info.get("zz"),
                     lambda: info.nkeys, lambda: info.nthkey(1), lambda: info.nthkey(5),
                     lambda: info.set("", "x"), lambda: info.set("k" * 256, "x"),
                     lambda: info.set("k", "v" * 1025), lambda: info.delete("a"),
                     lambda: info.delete("a"), lambda: list(info.dup().items()),
                     lambda: k.info.INFO_NULL.nkeys):
            try:
                out.append(step())
            except Exception as e:  # noqa: BLE001
                out.append(type(e).__name__)
        return out

    _both(run)


def test_info_env_matches_reference(monkeypatch):
    monkeypatch.setenv("OMPI_TPU_NPROCS", "3")
    _both(lambda k, _w: dict(k.info.info_env().items()))
    monkeypatch.delenv("OMPI_TPU_NPROCS")
    _both(lambda k, _w: dict(k.info.info_env().items()))


# -- the info command ------------------------------------------------------


def _info(pkg: str, *args: str) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:" + env.get("PYTHONPATH", "")
    env = {k: v for k, v in env.items() if not k.startswith("OMPI_MCA_")}
    res = subprocess.run([sys.executable, "-m", pkg, "info", *args], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO), env=env)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_info_command_parsable_matches_reference_on_shared_vars():
    rows = {}
    for pkg in ("ompi_tpu", "ompi_tpu_torch"):
        text = _info(pkg, "--parsable")
        rows[pkg] = {name: (value, source) for name, value, source in re.findall(
            r"^mca:var:([^:]+):value:(.*):source:(\w+)$", text, re.M)}
        comps = re.findall(r"^mca:(\w+):(\w+):version:([\d.]+)$", text, re.M)
        assert comps and all(v == "1.0.0" for _f, _c, v in comps), comps
    shared = sorted(set(rows["ompi_tpu"]) & set(rows["ompi_tpu_torch"]))
    assert len(shared) > 60, len(shared)
    # the collective, transport and fault-tolerance knobs are shared
    for name in ("ft_respawn_timeout", "dcn_recv_timeout", "btl_tcp_eager_limit",
                 "coll_han_reproducible", "trace_enable", "metrics_enable"):
        assert name in shared, name
    assert {n: rows["ompi_tpu_torch"][n] for n in shared} == {n: rows["ompi_tpu"][n]
                                                              for n in shared}


def test_info_command_text_form():
    text = _info("ompi_tpu_torch")
    assert text.startswith("Package: ompi_tpu_torch")
    assert re.search(r"^  coll\s+tuned \(prio \d+\), cuda", text, re.M), text[:2000]
    assert re.search(r"^  ft_respawn_timeout\s+= 60\.0 \[default\]", text, re.M)
    assert "MCA variables (value [source]):" in text
    assert "mca:var" not in _info("ompi_tpu_torch", "--no-vars")
    res = subprocess.run([sys.executable, "-m", "ompi_tpu_torch", "nope"], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO),
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 2 and "'info'" in res.stderr

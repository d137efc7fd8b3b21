"""vprotocol, the memory checker and pml monitoring of the PyTorch port
against the JAX package.

The same point-to-point script runs through both packages with message
logging on: the two logs must be equal event for event.  With
monitoring on, the per-peer message and byte matrices must be equal,
and with both on the logging engine stacks over the monitored one in
both.  The memory checker guards host buffers and partitioned sends as
the reference's does (a tensor partition is checksummed on the host),
and is never reached when detached.  Mirrors the vprotocol and
memchecker tests of ``tests/test_debugtools.py`` and the monitoring
tests of ``tests/test_tool.py``.
"""

import contextlib

import numpy as np
import pytest
import torch

import ompi_tpu.api as japi
import ompi_tpu_torch.api as tapi
from ompi_tpu.core import mca as jmca
from ompi_tpu.p2p import vprotocol as jvp
from ompi_tpu.tool import memchecker as jmc
from ompi_tpu.tool import monitoring as jmon
from ompi_tpu_torch.core import mca as tmca
from ompi_tpu_torch.ddt.datatype import from_numpy
from ompi_tpu_torch.p2p import vprotocol as tvp
from ompi_tpu_torch.tool import memchecker as tmc
from ompi_tpu_torch.tool import monitoring as tmon

N = 8


@pytest.fixture(scope="module")
def worlds(devices):
    tapi.finalize()
    tw = tapi.init(device="cpu", nranks=N)
    yield japi.init(), tw
    tapi.finalize()


@contextlib.contextmanager
def pml_vars(**values):
    """Set vars in both stores and re-open both pml frameworks (the
    components gate on them at open)."""
    ctxs = (jmca.default_context(), tmca.default_context())
    prev = [{k: c.store.get(k) for k in values} for c in ctxs]
    for c in ctxs:
        for k, v in values.items():
            c.store.set(k, v)
        c.framework("pml").close()
    try:
        yield
    finally:
        for c, p in zip(ctxs, prev):
            for k, v in p.items():
                c.store.set(k, v)
            c.framework("pml").close()
        for mon in (jmon, tmon):
            mon.reset()


def p2p_script(w, as_tensor=False):
    """Sends, wildcard and specific receives, a probe, a PROC_NULL
    receive and a persistent round, on a dup (a fresh engine)."""
    d = w.dup()
    rng = np.random.RandomState(1)
    for i in range(12):
        x = rng.randn(int(rng.randint(1, 6))).astype(np.float32)
        d.send(from_numpy(x) if as_tensor else x, i % 5, (i * 3) % N, tag=i % 3)
    for dest in range(N):
        while d.iprobe(dest) is not None:
            d.recv(dest, None if dest % 2 else d.iprobe(dest).source, None)
    r = d.irecv(4, 2, 7)
    d.send(np.arange(3), 2, 4, tag=7)
    r.wait()
    d.recv(1, -2)  # PROC_NULL
    ps, pr = d.send_init(np.ones(2), 6, 0, 5), d.recv_init(0, 6, 5)
    ps.start().wait()
    pr.start().wait()
    return d


def test_vprotocol_logs_equal_event_for_event(worlds, tmp_path):
    logs = []
    for w, vp, tens in ((worlds[0], jvp, False), (worlds[1], tvp, False),
                        (worlds[1], tvp, True)):
        path = tmp_path / f"log{len(logs)}.jsonl"
        with pml_vars(vprotocol_pessimist_log=str(path)):
            d = p2p_script(w, tens)
            assert type(d.pml).__name__ == "LoggedEngine"
            logs.append(vp.load_log(str(path)))
            d.pml._fh.close()
    assert logs[1] == logs[0] == logs[2]
    kinds = {e["event"] for e in logs[0]}
    assert kinds == {"send", "post", "match"}
    assert any(e["event"] == "match" and e["wildcard"] for e in logs[0])


def test_vprotocol_off_without_path(worlds):
    for w, vp in ((worlds[0], jvp), (worlds[1], tvp)):
        d = w.dup()
        assert not isinstance(d.pml, vp.LoggedEngine)
        d.free()


def test_pml_monitoring_matrices_match(worlds, tmp_path):
    flushed = []
    for w, mon in ((worlds[0], jmon), (worlds[1], tmon), (worlds[1], tmon)):
        with pml_vars(monitoring_base_enable=True):
            p2p_script(w, as_tensor=len(flushed) == 2)
            flushed.append(mon.flush()["p2p"])
    assert flushed[1] == flushed[0] == flushed[2]
    (mat,) = flushed[0].values()
    assert sum(map(sum, mat["messages"])) == 14 and sum(map(sum, mat["bytes"])) > 0
    assert list(flushed[0]) == ["pml:MPI_COMM_WORLD.dup"]


def test_vprotocol_stacks_over_monitoring(worlds, tmp_path):
    out = []
    for w, vp, mon in ((worlds[0], jvp, jmon), (worlds[1], tvp, tmon)):
        path = tmp_path / f"stack{len(out)}.jsonl"
        with pml_vars(vprotocol_pessimist_log=str(path), monitoring_base_enable=True):
            d = p2p_script(w)
            assert type(d.pml._inner).__name__ == "MonitoredEngine"
            out.append((vp.load_log(str(path)), mon.flush()["p2p"]))
            d.pml._fh.close()
    assert out[0] == out[1]


def test_monitoring_dump_has_both_halves(worlds, tmp_path):
    with pml_vars(monitoring_base_enable=True):
        p2p_script(worlds[1])
        tmon.dump(str(tmp_path / "mon.json"))
    import json

    doc = json.load(open(tmp_path / "mon.json"))
    assert set(doc) == {"p2p", "coll"} and doc["p2p"]


# -- memchecker -----------------------------------------------------------


def test_guard_protects_and_checksums_like_reference():
    for mc in (jmc, tmc):
        mc.attach(True)
        try:
            buf = np.arange(8, dtype=np.float64)
            g = mc.guard(buf, "iallreduce")
            with pytest.raises(ValueError):
                buf[0] = 99.0
            g.release()
            buf[0] = 99.0
            base = np.arange(8, dtype=np.float64)
            view = base[:]
            g = mc.guard(base, "ibcast")
            view[3] = -1.0
            with pytest.raises(mc.MPIBufferError):
                g.release()
            g2 = mc.guard(base, "ibcast")
            view[4] = -2.0
            g2.abandon()
            assert base.flags.writeable
            assert mc.guard(torch.zeros(2), "x") is None  # device memory: not guarded
            t = torch.arange(6, dtype=torch.float32)
            assert tmc.checksum(t) == jmc.checksum(t.numpy())
        finally:
            mc.attach(False)
    assert tmc.MPIBufferError.__mro__[1].__name__ == jmc.MPIBufferError.__mro__[1].__name__


@pytest.mark.parametrize("as_tensor", [False, True])
def test_partitioned_pready_guard_matches_reference(worlds, as_tensor):
    names = []
    for w, mc, tens in ((worlds[0], jmc, False), (worlds[1], tmc, as_tensor)):
        mc.attach(True)
        try:
            base = np.zeros((4, 3))
            buf = torch.from_numpy(base) if tens else base
            req = w.psend_init(buf, partitions=2, source=0, dest=1, tag=5)
            req.start()
            buf[0] = 1.0  # legal: partition 0 not yet ready
            req.pready(0)
            buf[2] = 2.0  # legal: partition 1 not yet ready
            buf[1] = 9.0  # illegal: partition 0 is ready
            with pytest.raises(Exception) as err:
                req.pready(1)
            names.append(type(err.value).__name__)
        finally:
            mc.attach(False)
    assert names == ["MPIBufferError", "MPIBufferError"]


def test_memchecker_is_never_reached_when_detached(worlds, monkeypatch):
    _, tw = worlds
    tmc.attach(False)

    def boom(_):
        raise AssertionError("checksum called while detached")

    monkeypatch.setattr(tmc, "checksum", boom)
    buf = torch.zeros(4, 2)
    req = tw.psend_init(buf, 2, 0, 3, tag=8).start()
    req.pready_range(0, 1)
    got, _ = tw.recv(3, 0, 8)
    assert got.shape == (4, 2)
    assert tmc.guard(np.zeros(2), "x") is None


def test_memchecker_var_syncs_at_init():
    tapi.finalize()
    try:
        tapi.init({"memchecker_base_enable": "1"}, device="cpu", nranks=2)
        assert tmc.attached()
    finally:
        tapi.finalize()
        tmc.attach(False)

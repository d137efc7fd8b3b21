"""The port's hang diagnosis (``trace/waitgraph``) against the
reference's: the registry (begin/end/snapshot, the address resolver,
the default-on gate) and the solver — ``build_graph``, ``classify`` and
``report`` give the same graphs and verdicts on the same snapshots.
The snapshots are constructed (no randomness); the ``ts_ns`` stamps of
``report`` are the only fields compared loosely (dropped)."""

import pytest

from ompi_tpu.trace import waitgraph as rwg
from ompi_tpu_torch.trace import waitgraph as pwg


@pytest.fixture(autouse=True)
def _fresh():
    rwg.reset()
    pwg.reset()
    yield
    rwg.reset()
    pwg.reset()


def _snap(ts, *waits):
    return {"ts_ns": ts, "waits": list(waits)}


def _w(site, peer, plane="host", since=0, **kw):
    return dict(site=site, peer=peer, plane=plane, since_ns=since, **kw)


SNAPSHOTS = {
    "deadlock": ({
        0: _snap(10_000, _w("p2p_recv", 1, "tcp", 4_000)),
        1: _snap(10_000, _w("p2p_recv", 0, "tcp", 5_000)),
    }, ()),
    "deadlock3": ({
        0: _snap(9_000, _w("coll_recv", 1, since=100, cid="3", seq=4)),
        1: _snap(9_000, _w("coll_recv", 2, since=200, cid="3", seq=4)),
        2: _snap(9_000, _w("coll_recv", 0, since=300, cid="3", seq=5)),
    }, ()),
    "straggler": ({
        0: _snap(10_000, _w("coll_recv", 1, since=1_000)),
        1: _snap(10_000, _w("cts", 2, "tcp", since=2_000)),
        2: _snap(10_000, _w("ring", None, "shm", since=3_000)),
    }, ()),
    "straggler_compute": ({
        0: _snap(10_000, _w("coll_recv", 1, since=1_000)),
        1: _snap(10_000),
    }, ()),
    "failed_peer": ({
        0: _snap(10_000, _w("coll_recv", 2, since=1_000)),
        1: _snap(10_000, _w("coll_recv", 0, since=2_000)),
    }, (2,)),
    "compute": ({0: _snap(1), 1: _snap(1)}, ()),
    "string_keys": ({
        "0": _snap(10_000, _w("coll_recv", 1, since=500, addr="127.0.0.1:9")),
        "1": _snap(10_000, _w("device_recv", 0, "device", since=600)),
    }, ()),
}


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_solver_matches_reference(name):
    snaps, failed = SNAPSHOTS[name]
    g = pwg.build_graph(snaps, failed=failed)
    assert g == rwg.build_graph(snaps, failed=failed)
    assert pwg.classify(g) == rwg.classify(g)
    rp = pwg.report(snaps, failed=failed, reason="t")
    rr = rwg.report(snaps, failed=failed, reason="t")
    for r in (rp, rr):
        r.pop("ts_ns")
    assert rp == rr


def test_registry_tokens_identity_and_snapshot():
    assert pwg.enabled()  # hang_diag_enable defaults on
    tok = pwg.begin("coll_recv", peer=3, plane="host", cid=7, seq=2)
    other = pwg.begin("cts", addr="127.0.0.1:1", plane="tcp")
    assert tok and other and tok != other and pwg.busy()
    snap = pwg.snapshot(stacks=True)
    (w0, w1) = snap["waits"]
    assert (w0["site"], w0["peer"], w0["cid"], w0["seq"], w0["key"]) == \
        ("coll_recv", 3, "7", 2, None)
    assert w1["peer"] is None and w1["addr"] == "127.0.0.1:1"
    assert snap["stacks"]
    pwg.end(tok)
    pwg.end(other)
    pwg.end(0)
    assert not pwg.busy()
    assert pwg.counters_snapshot()["hang_snapshots"] == 1


def test_resolver_names_the_peer_and_disabled_gate_registers_nothing():
    class Engine:
        def resolve(self, addr):
            return 5 if addr == "x:1" else None

    eng = Engine()
    pwg.register_resolver(eng, eng.resolve)
    tok = pwg.begin("cts", addr="x:1", plane="tcp")
    assert pwg.snapshot(stacks=False)["waits"][0]["peer"] == 5
    pwg.end(tok)
    # a native wait-state source: its rows join the snapshot as the
    # reference's do (plane "native", the C engine's thread, age → since)
    row = {"site": "ring", "peer": 1, "age_ns": 5_000_000}
    for wg in (pwg, rwg):
        wg.register_native(eng, lambda: [dict(row)])
    got = [wg.snapshot(stacks=False)["waits"] for wg in (pwg, rwg)]
    for waits in got:
        assert len(waits) == 1 and waits[0]["since_ns"] > 0
        waits[0].pop("since_ns")
    assert got[0] == got[1] == [{"site": "ring", "peer": 1, "plane": "native",
                                 "thread": "c-engine", "key": None}]
    pwg.enable(False)
    assert pwg.begin("coll_recv", peer=1) == 0 and not pwg.busy()


def test_sync_from_store_reads_hang_diag_enable():
    from ompi_tpu_torch.core.registry import MCAContext

    ctx = MCAContext(cmdline={"hang_diag_enable": "0"}, env={}, param_files=[])
    pwg.sync_from_store(ctx.store)
    assert not pwg.enabled()
    pwg.sync_from_store(MCAContext(env={}, param_files=[]).store)
    assert pwg.enabled()

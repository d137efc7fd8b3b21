"""The port's persistent-schedule cache against ``ompi_tpu/coll/sched.py``.

Mirrors the four schedule-cache tests of ``tests/test_fastpath.py``
(hits across ``dup``, bcast/allgather plans, the disable var, the
capacity bound), and runs one ``*_init`` sequence through both packages
to hold the port's hit/miss counts to the reference's.
"""

import numpy as np
import pytest

import ompi_tpu.api as japi
import ompi_tpu_torch.api as tapi
from ompi_tpu import op as jop
from ompi_tpu.coll import sched as jsched
from ompi_tpu.core import mca as jmca
from ompi_tpu_torch import op as top
from ompi_tpu_torch.coll import sched
from ompi_tpu_torch.coll.sched import ScheduleCache
from ompi_tpu_torch.core import mca
from ompi_tpu_torch.metrics import core as tmetrics

N = 8


@pytest.fixture(scope="module")
def worlds(devices):
    tapi.finalize()
    tw = tapi.init(device="cpu", nranks=N)
    yield japi.init(), tw
    tapi.finalize()


@pytest.fixture
def world(worlds):
    return worlds[1]


def rank_data(shape, dtype=np.float32, seed=0):
    return np.random.RandomState(seed).randn(N, *shape).astype(dtype)


def test_persistent_schedule_cache_hits_across_dup(world):
    """A second *_init of one signature hits, on a fresh comm of the same
    shape too, and the replayed plan computes the blocking result."""
    x = rank_data((12,), seed=31)
    h0 = sched.CACHE.stats()
    out = world.allreduce_init(x, top.SUM).start().wait()
    np.testing.assert_allclose(out, np.broadcast_to(x.sum(0), x.shape), rtol=1e-5)
    h1 = sched.CACHE.stats()
    assert h1["sched_cache_misses"] > h0["sched_cache_misses"]
    world.allreduce_init(x, top.SUM)
    d = world.dup()
    d.allreduce_init(x, top.SUM)
    h2 = sched.CACHE.stats()
    assert h2["sched_cache_hits"] >= h1["sched_cache_hits"] + 2
    assert h2["sched_cache_misses"] == h1["sched_cache_misses"]
    d.allreduce_init(rank_data((5,), np.float64, seed=32), top.SUM)
    assert sched.CACHE.stats()["sched_cache_misses"] == h2["sched_cache_misses"] + 1
    d.free()
    counters = tmetrics.native_counters()
    assert counters["sched_cache_hits"] == sched.CACHE.hits
    assert counters["sched_cache_misses"] == sched.CACHE.misses


def test_persistent_bcast_allgather_init_cached(world):
    x = rank_data((6,), seed=33)
    out = world.bcast_init(x, root=3).start().wait()
    np.testing.assert_array_equal(out, np.broadcast_to(x[3], x.shape))
    g = world.allgather_init(x).start().wait()
    assert g.shape == (N, N, 6)
    np.testing.assert_array_equal(g[0], x)
    h = sched.CACHE.stats()
    world.bcast_init(x, root=3)
    world.allgather_init(x)
    assert sched.CACHE.stats()["sched_cache_hits"] >= h["sched_cache_hits"] + 2


def test_schedule_cache_disable_var(world):
    """coll_sched_cache_enable 0: lookups build fresh, counters stay flat."""
    store = mca.default_context().store
    x = rank_data((9,), seed=34)
    world.allreduce_init(x, top.SUM)
    store.set("coll_sched_cache_enable", 0)
    try:
        h0 = sched.CACHE.stats()
        out = world.allreduce_init(x, top.SUM).start().wait()
        np.testing.assert_allclose(out, np.broadcast_to(x.sum(0), x.shape), rtol=1e-5)
        h1 = sched.CACHE.stats()
        assert h1["sched_cache_hits"] == h0["sched_cache_hits"]
        assert h1["sched_cache_misses"] == h0["sched_cache_misses"]
    finally:
        store.set("coll_sched_cache_enable", 1)


def test_schedule_cache_capacity_bounded(world):
    store = mca.default_context().store
    store.set("coll_sched_cache_max", 4)
    try:
        c = ScheduleCache()
        for i in range(10):
            c.lookup(("k", i), lambda i=i: i * 2)
        assert len(c) <= 4
        assert c.lookup(("k", 0), lambda: -1) == -1  # FIFO: oldest rebuilt
        assert c.stats()["sched_cache_misses"] == 11
    finally:
        store.set("coll_sched_cache_max", 256)


def test_hit_miss_counts_match_reference(worlds):
    """One *_init sequence, each package on a version-bumped store so no
    earlier plan can hit: equal hit and miss deltas, equal results."""
    jw, tw = worlds
    deltas, outs = [], []
    for w, o, cache, store in ((jw, jop, jsched.CACHE, jmca.default_context().store),
                               (tw, top, sched.CACHE, mca.default_context().store)):
        store.set("coll_sched_cache_max", store.get("coll_sched_cache_max"))
        h0 = cache.stats()
        x, y = rank_data((7,), seed=35), rank_data((3,), np.float64, seed=36)
        d = w.dup()
        res = [np.asarray(w.allreduce_init(x, o.PROD).start().wait())]
        d.allreduce_init(x, o.PROD)
        w.allreduce_init(y, o.SUM)
        res.append(np.asarray(d.bcast_init(x, root=2).start().wait()))
        w.bcast_init(x, root=2)
        w.bcast_init(x, root=5)
        res.append(np.asarray(d.allgather_init(y).start().wait()))
        w.allgather_init(y)
        h1 = cache.stats()
        deltas.append((h1["sched_cache_hits"] - h0["sched_cache_hits"],
                       h1["sched_cache_misses"] - h0["sched_cache_misses"]))
        outs.append(res)
        d.free()
    assert deltas[0] == deltas[1] == (3, 5)
    for want, got in zip(*outs):
        assert got.tobytes() == want.tobytes()


def test_cache_counters_survive_a_metrics_reset(world):
    """``metrics.core.reset()`` drops every provider; the next lookup
    registers the cache again, and a second registration counts nothing
    twice."""
    x = rank_data((9,), seed=37)
    world.allreduce_init(x, top.SUM)
    tmetrics.reset()
    world.allreduce_init(x, top.SUM)
    counters = tmetrics.native_counters()
    assert sched.CACHE.hits > 0 and sched.CACHE.misses > 0
    assert counters["sched_cache_hits"] == sched.CACHE.hits
    assert counters["sched_cache_misses"] == sched.CACHE.misses
    sched.register_metrics_provider()
    counters = tmetrics.native_counters()
    assert counters["sched_cache_hits"] == sched.CACHE.hits
    assert counters["sched_cache_misses"] == sched.CACHE.misses

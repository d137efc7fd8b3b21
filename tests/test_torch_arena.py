"""The port's device arena against ``ompi_tpu/mesh/arena.py``.

Mirrors the accounting tests of ``tests/test_arena.py`` (the free list,
the pooled barrier token, allocator address recycling), holds
``stats()`` to the reference's keys, and runs one host-staged call
sequence through both packages' worlds to hold the ``stage_calls`` and
``stage_bytes`` deltas to the reference's.
"""

import numpy as np
import pytest
import torch

import ompi_tpu.api as japi
import ompi_tpu_torch.api as tapi
from ompi_tpu import op as jop
from ompi_tpu.mesh.arena import HbmArena
from ompi_tpu_torch import op as top
from ompi_tpu_torch.mesh.arena import DeviceArena

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


def test_stats_keys_equal_reference():
    assert list(DeviceArena().stats()) == list(HbmArena().stats())
    s = DeviceArena().stats()
    assert s["donate_signatures"] == 0 and s["addr_overflow"] is False


def test_pool_acquire_release_reuses(world):
    """Release → acquire returns the same buffer (a pool hit), keyed by
    (shape, dtype, device)."""
    arena = world.mesh.arena
    dev = world.mesh.device
    a0 = arena.stats()
    shape = (world.size, 13)  # a signature no other test pools
    b1 = arena.acquire(shape, torch.int16, dev)
    arena.release(b1)
    b2 = arena.acquire(shape, torch.int16, dev)
    assert b2 is b1
    b3 = arena.acquire(shape, torch.float16, dev)  # another signature
    assert b3 is not b1
    a1 = arena.stats()
    assert a1["pool_hits"] - a0["pool_hits"] == 1
    assert a1["pool_allocs"] - a0["pool_allocs"] == 2


def test_barrier_uses_pooled_token(world):
    """Steady-state barriers are pool hits: no allocation, no staging."""
    arena = world.mesh.arena
    world.barrier()  # warm: allocates (or reuses) the token
    s0 = arena.stats()
    for _ in range(5):
        world.barrier()
    s1 = arena.stats()
    assert s1["pool_hits"] - s0["pool_hits"] == 5
    assert s1["pool_allocs"] == s0["pool_allocs"]
    assert s1["stage_calls"] == s0["stage_calls"]


def test_addr_reuse_accounting_on_cpu(world):
    """Steady-state staging of one signature shows the allocator
    recycling an address (sampled: the first 8 calls, then 1 in 8)."""
    arena = world.mesh.arena
    n = world.size
    base = arena.stats()
    for _ in range(16):
        for _ in range(256):
            x = world.mesh.stage_in(np.ones((n, 7), np.float32))
            del x
        if arena.stats()["addr_reuse"] > base["addr_reuse"]:
            break
    s = arena.stats()
    assert s["addr_reuse"] > base["addr_reuse"]
    assert s["addr_new"] >= base["addr_new"]
    assert s["stage_calls"] - base["stage_calls"] <= 16 * 256


def test_addr_sampler_and_overflow():
    """The sampler notes calls 1-8, then every 8th; a signature that
    sees more than 64 fresh addresses sets ``addr_overflow``."""
    arena = DeviceArena()
    keep = [arena.stage_in(np.full((2, 3), i, np.float64), torch.device("cpu"))
            for i in range(8 + 8 * 70)]  # all alive: every address fresh
    s = arena.stats()
    assert s["stage_calls"] == len(keep)
    assert s["stage_bytes"] == len(keep) * 48
    assert s["addr_new"] + s["addr_reuse"] == 8 + 70
    assert s["addr_reuse"] == 0 and s["addr_new"] == 78
    assert s["addr_overflow"] is True


def _staged_sequence(world, sum_op):
    """Host buffers through the blocking, non-blocking and persistent
    paths; the barrier stages nothing."""
    n = world.size
    world.allreduce(np.ones((n, 16), np.float32), sum_op)
    world.allreduce(np.ones((n, 16), np.float32), sum_op)
    world.bcast(np.arange(n * 3, dtype=np.float64).reshape(n, 3), root=1)
    world.allgather(np.ones((n, 5), np.int32))
    world.iallreduce(np.ones((n, 4), np.float64), sum_op).wait()
    world.barrier()
    pr = world.allreduce_init(np.ones((n, 6), np.float32), sum_op)
    for _ in range(3):
        pr.start().wait()


def test_stage_deltas_equal_reference(worlds):
    jw, tw = worlds
    deltas = []
    for w, sum_op in ((jw, jop.SUM), (tw, top.SUM)):
        s0 = w.mesh.arena.stats()
        _staged_sequence(w, sum_op)
        s1 = w.mesh.arena.stats()
        deltas.append({k: s1[k] - s0[k] for k in ("stage_calls", "stage_bytes")})
    assert deltas[1] == deltas[0]
    assert deltas[1]["stage_calls"] == 6

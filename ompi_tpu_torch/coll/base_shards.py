"""Collective algorithm library over ranks that each own a buffer.

Port of ``ompi_tpu/coll/base.py`` for the ``devices`` layout.  The
reference writes each algorithm as a per-device function under
``shard_map``; here each one takes the list ``xs`` of the ranks' values,
``xs[r]`` rank r's tensor on rank r's device (often a card of its own),
and returns one new tensor per rank, each on its rank's device.  The
per-device body is written once and run for every rank:

* ``lax.axis_index`` is the rank r of a loop over ranks, so a
  ``jnp.where`` on it is a Python choice per rank;
* ``lax.ppermute(v, perm)`` is :func:`_ppermute`: rank ``dst`` gets a
  fresh tensor on its own device holding rank ``src``'s value, and a
  rank that receives nothing gets zeros, as ppermute gives;
* ``lax.all_gather`` gives every rank, on its own device, the stack of
  all ranks' values (:func:`_all_gather`); ``lax.all_to_all`` likewise
  per rank (:func:`_all_to_all`).

The chunking (``_pad_to``), the chunk rotation, the fold's operand order
and the unsigned carrier views (:func:`_carried`, as in
:mod:`~ompi_tpu_torch.coll.base`) are the reference's, so every
algorithm but ``psum`` and reduce_scatter ``direct`` is bit-identical to
the JAX package and to the rows layout.  Those two are XLA's fused
reductions in the reference; here they run the ring schedule over the
cross-device hop (:func:`~ompi_tpu_torch.coll.cuda_kernels.ring_allreduce_shards`,
:func:`~ompi_tpu_torch.coll.cuda_kernels.ring_reduce_scatter_shards`),
which launches ``ring_hop_peer`` and ``ring_hop_wait`` on CUDA shards.

A move between two ranks is a torch copy; one between two cards is
ordered on both cards' current streams, the streams the peer kernels
launch on, so a move issued after a hop sees the hop's data.  Nothing
is gathered onto one card: each rank's result is computed on its own.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch

from ompi_tpu_torch.ddt.datatype import SIGNED_TWIN
from ompi_tpu_torch.op.op import Op, on_carrier, ordered_reduce_torch

from . import cuda_kernels as ck


def _carried(fn):
    """Run an algorithm on the signed carrier views of unsigned shards,
    folding with the carrier form of every ``Op`` argument."""

    @functools.wraps(fn)
    def wrapper(xs, *args, **kw):
        dtype = xs[0].dtype
        twin = SIGNED_TWIN.get(dtype)
        if twin is None:
            return fn(xs, *args, **kw)
        args = tuple(on_carrier(a, dtype) if isinstance(a, Op) else a for a in args)
        return [o.view(dtype) for o in fn([x.view(twin) for x in xs], *args, **kw)]

    return wrapper


def _ring_perm(n: int, shift: int = 1):
    return [(i, (i + shift) % n) for i in range(n)]


def _xor_perm(n: int, mask: int):
    return [(i, i ^ mask) for i in range(n)]


def _ppermute(vals: Sequence[torch.Tensor], pairs) -> list[torch.Tensor]:
    """``lax.ppermute``: for each ``(src, dst)`` rank dst receives a copy
    of ``vals[src]`` on its own device; a rank that receives nothing
    gets zeros."""
    out: list = [None] * len(vals)
    for src, dst in pairs:
        out[dst] = vals[src].to(vals[dst].device, copy=True)
    return [torch.zeros_like(v) if o is None else o for o, v in zip(out, vals)]


def _all_gather(vals: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``lax.all_gather``: every rank's ``(n, …)`` stack of all values,
    on its own device."""
    return [torch.stack([v.to(mine.device) for v in vals]) for mine in vals]


def _all_to_all(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``lax.all_to_all`` (split and concat on axis 0, tiled): rank j's
    ``(n, …)`` holds ``xs[r][j]`` in source-rank order, on its device."""
    return [torch.stack([x[j].to(mine.device) for x in xs]) for j, mine in enumerate(xs)]


def _pad_to(x: torch.Tensor, multiple: int):
    """Flatten and zero-pad so the length divides ``multiple``; returns
    (a fresh flat tensor, the original size, the original shape)."""
    flat = x.reshape(-1)
    size = flat.shape[0]
    padded = -(-size // multiple) * multiple
    if padded != size:
        return torch.cat([flat, flat.new_zeros(padded - size)]), size, tuple(x.shape)
    return flat.clone(), size, tuple(x.shape)


def _unpad(flat: torch.Tensor, size: int, shape) -> torch.Tensor:
    return flat[:size].reshape(shape)


def _fresh(xs) -> list[torch.Tensor]:
    """Every rank's value as a buffer of its own (MPI keeps send and
    receive buffers apart)."""
    return [x.clone() for x in xs]


# ======================================================================
# allreduce
# ======================================================================


@_carried
def allreduce_psum(xs, op: Op, ring: ck.PeerRing | None = None) -> list[torch.Tensor]:
    """The fused path: on shards the ring schedule over the cross-device
    hop (the reference's psum/pmax/pmin leave the order to XLA, so this
    path is held to it with ``allclose``); only for ops with a fused
    reduction."""
    if op.collective is None:
        raise ValueError(f"no fused reduction for {op.name}")
    return ck.ring_allreduce_shards(xs, op, ring)


def allreduce_ordered_linear(xs, op: Op) -> list[torch.Tensor]:
    """all_gather + rank-sequential left fold on every rank — the
    bit-exact path matching the CPU golden order."""
    return [ordered_reduce_torch(g, op) for g in _all_gather(xs)]


@_carried
def allreduce_ring(xs, op: Op) -> list[torch.Tensor]:
    """Bandwidth-optimal ring: reduce-scatter phase (n-1 chunk steps)
    then allgather phase (n-1 steps)."""
    n = len(xs)
    if n == 1:
        return _fresh(xs)
    padded = [_pad_to(x, n) for x in xs]
    size, shape = padded[0][1], padded[0][2]
    chunks = [flat.view(n, -1) for flat, _, _ in padded]
    perm = _ring_perm(n)
    # reduce-scatter: at step s rank r sends chunk (r - s) and folds the
    # received data into chunk (r - s - 1)
    for s in range(n - 1):
        recv = _ppermute([chunks[r][(r - s) % n] for r in range(n)], perm)
        for r in range(n):
            mine = chunks[r][(r - s - 1) % n]
            mine.copy_(op.torch_fn(mine, recv[r]))
    # rank r now owns the fully-reduced chunk (r + 1) % n
    cur = [chunks[r][(r + 1) % n] for r in range(n)]
    for s in range(n - 1):
        cur = _ppermute(cur, perm)
        for r in range(n):
            chunks[r][(r - s) % n].copy_(cur[r])
    return [_unpad(c.view(-1), size, shape) for c in chunks]


def allreduce_ring_segmented(xs, op: Op, segcount: int = 1 << 16) -> list[torch.Tensor]:
    """The ring run independently on each ``segcount``-element segment."""
    n = len(xs)
    if n == 1:
        return _fresh(xs)
    flats = [x.reshape(-1) for x in xs]
    nseg = max(1, -(-flats[0].shape[0] // segcount))
    outs = [allreduce_ring([f[i * segcount:(i + 1) * segcount] for f in flats], op)
            for i in range(nseg)]
    return [torch.cat([o[r] for o in outs]).reshape(x.shape) for r, x in enumerate(xs)]


@_carried
def allreduce_recursive_doubling(xs, op: Op) -> list[torch.Tensor]:
    """log2(n) full-vector partner exchanges; non-power-of-two sizes fold
    the tail ranks in and out like the reference."""
    n = len(xs)
    if n == 1:
        return _fresh(xs)
    k = 1 << (n.bit_length() - 1)  # largest power of two <= n
    rem = n - k
    val = list(xs)
    if rem:
        # ranks >= k send their data to rank - k, which pre-folds it
        recv = _ppermute(val, [(i, i - k) for i in range(k, n)])
        val = [op.torch_fn(val[r], recv[r]) if r < rem else val[r] for r in range(n)]
    for s in (1 << b for b in range(int(math.log2(k)))):
        recv = _ppermute(val, [(i, i ^ s) for i in range(k)])
        for r in range(k):
            if op.commutative or (r & s) == 0:
                val[r] = op.torch_fn(val[r], recv[r])
            else:  # lower-rank operand first (MPI non-commutative contract)
                val[r] = op.torch_fn(recv[r], val[r])
    if rem:
        back = _ppermute(val, [(i, i + k) for i in range(rem)])
        val = [back[r] if r >= k else val[r] for r in range(n)]
    return [v.clone() if v is x else v for v, x in zip(val, xs)]


@_carried
def allreduce_rabenseifner(xs, op: Op) -> list[torch.Tensor]:
    """Recursive-halving reduce-scatter + recursive-doubling allgather
    (power-of-two comm sizes; the decision layer gates it)."""
    n = len(xs)
    if n == 1:
        return _fresh(xs)
    if n & (n - 1):
        raise ValueError("rabenseifner requires power-of-two comm size")
    padded = [_pad_to(x, n) for x in xs]
    size, shape = padded[0][1], padded[0][2]
    flat = [f for f, _, _ in padded]
    length = flat[0].shape[0]
    lo = [0] * n
    dist = n // 2
    while dist >= 1:
        length //= 2
        upper = [(r & dist) != 0 for r in range(n)]
        keep_lo = [lo[r] + length if upper[r] else lo[r] for r in range(n)]
        send_lo = [lo[r] if upper[r] else lo[r] + length for r in range(n)]
        recv = _ppermute([flat[r][send_lo[r]:send_lo[r] + length] for r in range(n)],
                         _xor_perm(n, dist))
        for r in range(n):
            kept = flat[r][keep_lo[r]:keep_lo[r] + length]
            if op.commutative or not upper[r]:
                merged = op.torch_fn(kept, recv[r])
            else:  # lower-rank operand first (MPI non-commutative contract)
                merged = op.torch_fn(recv[r], kept)
            kept.copy_(merged)
        lo = keep_lo
        dist //= 2
    # allgather by doubling
    dist = 1
    while dist < n:
        recv = _ppermute([flat[r][lo[r]:lo[r] + length] for r in range(n)],
                         _xor_perm(n, dist))
        for r in range(n):
            # partner above us: its lo is ours + length
            partner_lo = lo[r] + length if (r & dist) == 0 else lo[r] - length
            flat[r][partner_lo:partner_lo + length].copy_(recv[r])
            lo[r] = min(lo[r], partner_lo)
        length *= 2
        dist *= 2
    return [_unpad(f, size, shape) for f in flat]


# ======================================================================
# allgather  (rank r's block → its (n, *block) of every rank's block)
# ======================================================================


def allgather_direct(xs) -> list[torch.Tensor]:
    return _all_gather(xs)


@_carried
def allgather_ring(xs) -> list[torch.Tensor]:
    """n-1 neighbour forwards; each step passes the newest block along."""
    n = len(xs)
    if n == 1:
        return [x[None].clone() for x in xs]
    outs = []
    for r, x in enumerate(xs):
        out = x.new_zeros((n,) + tuple(x.shape))
        out[r].copy_(x)
        outs.append(out)
    perm = _ring_perm(n)
    cur = list(xs)
    for s in range(n - 1):
        cur = _ppermute(cur, perm)
        for r in range(n):
            outs[r][(r - s - 1) % n].copy_(cur[r])
    return outs


@_carried
def allgather_bruck(xs) -> list[torch.Tensor]:
    """Bruck: ceil(log2 n) rounds of doubling block exchanges."""
    n = len(xs)
    if n == 1:
        return [x[None].clone() for x in xs]
    # every rank starts with its own block at slot 0 (rotated layout)
    blocks = [x[None] for x in xs]
    have, s = 1, 1
    while s < n:
        cnt = min(s, n - have)  # how many new blocks arrive this round
        recv = _ppermute([b[:cnt] for b in blocks], _ring_perm(n, -s % n))
        blocks = [torch.cat([b, v]) for b, v in zip(blocks, recv)]
        have += cnt
        s <<= 1
    # un-rotate: rank r holds [r, r+1, …] → absolute order
    return [torch.roll(b, r, 0) for r, b in enumerate(blocks)]


# ======================================================================
# bcast  (root's value → every rank)
# ======================================================================


def bcast_direct(xs, root: int = 0) -> list[torch.Tensor]:
    """Root's value copied onto every rank's device (the reference's
    masked psum; the fabric's broadcast)."""
    return [xs[root].to(x.device, copy=True) for x in xs]


@_carried
def bcast_binomial(xs, root: int = 0) -> list[torch.Tensor]:
    """Binomial tree: round s, ranks rel < 2^s forward to rel + 2^s."""
    n = len(xs)
    if n == 1:
        return _fresh(xs)
    val = list(xs)
    s = 1
    while s < n:
        pairs = [((q + root) % n, (q + s + root) % n) for q in range(min(s, n - s))]
        recv = _ppermute(val, pairs)
        val = [recv[r] if s <= (r - root) % n < 2 * s else val[r] for r in range(n)]
        s <<= 1
    return [v.clone() if v is x else v for v, x in zip(val, xs)]


@_carried
def bcast_pipeline(xs, root: int = 0, segcount: int = 1 << 16) -> list[torch.Tensor]:
    """Segmented chain: the message flows down a rank chain segment by
    segment."""
    n = len(xs)
    if n == 1:
        return _fresh(xs)
    flats = [x.reshape(-1) for x in xs]
    nseg = max(1, -(-flats[0].shape[0] // segcount))
    chain = [((q + root) % n, (q + 1 + root) % n) for q in range(n - 1)]
    outs = []
    for i in range(nseg):
        val = [f[i * segcount:(i + 1) * segcount] for f in flats]
        for hop in range(n - 1):
            recv = _ppermute(val, chain)
            val = [recv[r] if (r - root) % n == hop + 1 else val[r] for r in range(n)]
        outs.append(val)
    return [torch.cat([o[r] for o in outs]).reshape(x.shape) for r, x in enumerate(xs)]


# ======================================================================
# reduce  (all → root)
# ======================================================================


@_carried
def reduce_binomial(xs, op: Op, root: int = 0) -> list[torch.Tensor]:
    """Binomial fan-in tree; the result is valid on root (others hold
    partials)."""
    n = len(xs)
    if n == 1:
        return _fresh(xs)
    val = list(xs)
    s = 1
    while s < n:
        # round s: every rel ≡ s (mod 2s) sends its partial to rel - s
        pairs = [((q + s + root) % n, (q + root) % n) for q in range(0, n, 2 * s) if q + s < n]
        recv = _ppermute(val, pairs)
        for r in range(n):
            rel = (r - root) % n
            if rel % (2 * s) == 0 and rel + s < n:
                val[r] = op.torch_fn(val[r], recv[r])
        s <<= 1
    return [v.clone() if v is x else v for v, x in zip(val, xs)]


def reduce_ordered(xs, op: Op, root: int = 0) -> list[torch.Tensor]:
    """Bit-exact in-order fold: the same result on every rank."""
    return allreduce_ordered_linear(xs, op)


# ======================================================================
# reduce_scatter  (rank r's (n, *blk) → its own reduced (*blk,))
# ======================================================================


@_carried
def reduce_scatter_direct(xs, op: Op, ring: ck.PeerRing | None = None) -> list[torch.Tensor]:
    """SUM: on shards the ring reduce-scatter over the cross-device hop
    (the reference's psum_scatter leaves the order to XLA; held to it
    with ``allclose``); other ops take the ring below."""
    if op.collective == "sum":
        return ck.ring_reduce_scatter_shards(xs, op, ring)
    return reduce_scatter_ring(xs, op)


@_carried
def reduce_scatter_ring(xs, op: Op) -> list[torch.Tensor]:
    """Ring reduce-scatter: the partial for block b starts at rank
    (b+1) % n and accumulates while travelling to its owner b (chain
    order — commutative ops only)."""
    n = len(xs)
    if n == 1:
        return [x[0].clone() for x in xs]
    perm = _ring_perm(n)
    cur = [x[(r - 1) % n] for r, x in enumerate(xs)]
    for s in range(n - 1):
        cur = _ppermute(cur, perm)
        # received: the partial for block b = r - s - 2; add our own
        cur = [op.torch_fn(cur[r], xs[r][(r - s - 2) % n]) for r in range(n)]
    return cur


def reduce_scatter_ordered(xs, op: Op) -> list[torch.Tensor]:
    """Rank-ordered reduce_scatter: one all_to_all gives rank j every
    ``xs[r][j]`` in source-rank order, then it folds them in ascending
    rank order (the non-commutative contract)."""
    if len(xs) == 1:
        return [x[0].clone() for x in xs]
    return [ordered_reduce_torch(y, op) for y in _all_to_all(xs)]


def alltoall_direct(xs) -> list[torch.Tensor]:
    """Rank r's row j goes to rank j: rank j's (n, *blk) holds what every
    rank sent it, in source-rank order."""
    return _all_to_all(xs)


@_carried
def alltoall_pairwise(xs) -> list[torch.Tensor]:
    """n-1 ppermute rounds, step s exchanging with rank ± s."""
    n = len(xs)
    outs = []
    for r, x in enumerate(xs):
        out = torch.zeros_like(x)
        out[r].copy_(x[r])
        outs.append(out)
    for s in range(1, n):
        recv = _ppermute([x[(r + s) % n] for r, x in enumerate(xs)], _ring_perm(n, s))
        for r in range(n):
            outs[r][(r - s) % n].copy_(recv[r])
    return outs


# ======================================================================
# barrier / scan
# ======================================================================


def barrier_allreduce(toks) -> list[torch.Tensor]:
    """Token sum: every rank's token folds in every rank's, so its
    completion on every card is the barrier."""
    ones = [torch.ones((), dtype=torch.int32, device=t.device) for t in toks]
    return [g.sum(dtype=torch.int32) + 0 * t for g, t in zip(_all_gather(ones), toks)]


def barrier_dissemination(toks) -> list[torch.Tensor]:
    """Dissemination barrier: ceil(log2 n) token rounds, each round's
    token depending on the previous one."""
    n = len(toks)
    token = [torch.ones((), dtype=torch.int32, device=t.device) for t in toks]
    s = 1
    while s < n:
        recv = _ppermute(token, _ring_perm(n, s))
        token = [a + b for a, b in zip(token, recv)]
        s <<= 1
    return [a + 0 * t for a, t in zip(token, toks)]


@_carried
def scan_ordered(xs, op: Op, exclusive: bool = False) -> list[torch.Tensor]:
    """MPI_Scan/Exscan: all_gather, then rank r folds g[0..r] (inclusive)
    or g[0..r-1] (exclusive; rank 0 yields zeros) in rank order."""
    outs = []
    for r, g in enumerate(_all_gather(xs)):
        if exclusive:
            acc = torch.zeros_like(xs[r])
            for i in range(r):
                acc = g[0].clone() if i == 0 else op.torch_fn(acc, g[i])
        else:
            acc = g[0].clone()
            for i in range(1, r + 1):
                acc = op.torch_fn(acc, g[i])
        outs.append(acc)
    return outs


# ======================================================================
# gather / scatter  (coll/xla.py's _gather_fn and _scatter_fn)
# ======================================================================


def gather(xs, root: int = 0) -> torch.Tensor:
    """Root's recvbuf: every rank's block moved onto root's device, the
    ``(n, …)`` stack there (the reference's ``device_put`` to root)."""
    return torch.stack([x.to(xs[root].device) for x in xs])


def scatter(xs) -> list[torch.Tensor]:
    """Rank r's row of root's sendbuf as a buffer of its own on rank r's
    device: staging a rank-major buffer already placed row r there, so
    this is the reference's identity program."""
    return _fresh(xs)

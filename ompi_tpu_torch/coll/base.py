"""Collective algorithm library over virtual ranks.

Port of ``ompi_tpu/coll/base.py``.  The reference writes each algorithm
as a per-device function under ``shard_map`` that exchanges blocks with
``lax.ppermute``.  Here each algorithm is **one function over the
rank-major tensor** ``x`` of shape ``(n, …)``, row r being rank r's
buffer:

* ``lax.axis_index`` becomes ``torch.arange(n)`` (the rank vector);
* ``lax.ppermute`` becomes a row permutation written as plain indexing
  (:func:`_hop` for a rotation, :func:`_permute` for a partial pairing,
  whose non-receiving rows get zeros exactly as ppermute's do);
* per-rank dynamic indexing becomes advanced indexing with the rank
  vector.

The chunking (:func:`_pad_to`), the chunk rotation and the fold operand
order (``op(mine, recv)`` in the ring) are the reference's, so the ring,
ordered, Rabenseifner and recursive-doubling results are bit-identical
to the JAX package on the same inputs.

Unsigned payloads are moved as their same-width signed view (torch's
CPU indexing kernels lack the unsigned dtypes) and folded through
``op.on_carrier``; see :func:`_carried`.

Algorithm ↔ reference parity map:

=============================  ======================================
here                           reference symbol
=============================  ======================================
allreduce_ring                 ompi_coll_base_allreduce_intra_ring
allreduce_ring_segmented       …_intra_ring_segmented (segcount knob)
allreduce_recursive_doubling   …_intra_recursivedoubling
allreduce_rabenseifner         …_intra_redscat_allgather
allreduce_ordered_linear       basic linear order + han reproducible
allgather_ring                 ompi_coll_base_allgather_intra_ring
allgather_bruck                …_intra_bruck
bcast_binomial                 …_bcast_intra_binomial
bcast_pipeline                 …_bcast_intra_pipeline
reduce_scatter_ring            …_reduce_scatter_intra_ring
alltoall_pairwise              …_alltoall_intra_pairwise
barrier_dissemination          …_barrier_intra_recursivedoubling/bruck
=============================  ======================================
"""

from __future__ import annotations

import functools
import math

import torch

from ompi_tpu_torch.ddt.datatype import SIGNED_TWIN
from ompi_tpu_torch.op.op import Op, fused_reduce, on_carrier, ordered_reduce_torch
from ompi_tpu_torch.trace import core as _trace


def compile_event(algorithm: str, n: int) -> None:
    """Trace instant where a collective's callable is first built (the
    reference emits it where XLA traces a new program): a ``coll``-lane
    point that tells first-call cost apart from steady-state dispatch."""
    if _trace._enabled:
        _trace.instant("coll", "compile", algorithm=algorithm, comm_size=n)


def _carried(fn):
    """Run an algorithm on the signed carrier view of an unsigned ``x``,
    folding with the carrier form of every ``Op`` argument."""

    @functools.wraps(fn)
    def wrapper(x, *args, **kw):
        twin = SIGNED_TWIN.get(x.dtype)
        if twin is None:
            return fn(x, *args, **kw)
        args = tuple(on_carrier(a, x.dtype) if isinstance(a, Op) else a
                     for a in args)
        return fn(x.view(twin), *args, **kw).view(x.dtype)

    return wrapper


def _ranks(x: torch.Tensor) -> torch.Tensor:
    """The rank vector (≈ lax.axis_index over every device at once)."""
    return torch.arange(x.shape[0], device=x.device)


def _col(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-rank vector shaped to broadcast against ``x``'s rows."""
    return v.view((x.shape[0],) + (1,) * (x.dim() - 1))


def _hop(t: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """Ring rotation: row r receives row (r - shift) % n
    (≈ ppermute with pairs (i, (i + shift) % n))."""
    n = t.shape[0]
    return t[(torch.arange(n, device=t.device) - shift) % n]


def _permute(t: torch.Tensor, pairs) -> torch.Tensor:
    """Partial ppermute: row dst receives row src for each (src, dst);
    rows that receive nothing are zero."""
    out = torch.zeros_like(t)
    if pairs:
        src = torch.tensor([p[0] for p in pairs], device=t.device)
        dst = torch.tensor([p[1] for p in pairs], device=t.device)
        out[dst] = t[src]
    return out


def _rows(v: torch.Tensor, n: int) -> torch.Tensor:
    """``v`` on every rank: (…) → (n, …), contiguous."""
    return v.unsqueeze(0).expand((n,) + tuple(v.shape)).contiguous()


def _pad_to(x: torch.Tensor, multiple: int):
    """Flatten each rank's block and zero-pad its length to a multiple of
    ``multiple``; returns (flat (n, padded), size, block shape)."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    size = flat.shape[1]
    padded = -(-size // multiple) * multiple
    if padded != size:
        flat = torch.cat([flat, flat.new_zeros((n, padded - size))], 1)
    return flat, size, tuple(x.shape[1:])


def _unpad(flat: torch.Tensor, size: int, shape) -> torch.Tensor:
    return flat[:, :size].reshape((flat.shape[0],) + tuple(shape))


# ======================================================================
# allreduce
# ======================================================================


def allreduce_psum(x: torch.Tensor, op: Op) -> torch.Tensor:
    """Direct path: one torch reduction over the rank axis, broadcast
    back (≈ psum/pmax/pmin; the reduction order is torch's own)."""
    if op.collective is None:
        raise ValueError(f"no fused reduction for {op.name}")
    return _rows(fused_reduce(x, op), x.shape[0])


def allreduce_ordered_linear(x: torch.Tensor, op: Op) -> torch.Tensor:
    """Rank-sequential left fold — the bit-exact path matching the CPU
    golden order (han 'reproducible' equivalent)."""
    return _rows(ordered_reduce_torch(x, op), x.shape[0])


@_carried
def allreduce_ring(x: torch.Tensor, op: Op) -> torch.Tensor:
    """Bandwidth-optimal ring: reduce-scatter phase (n-1 chunk steps),
    then allgather phase (n-1 steps)."""
    n = x.shape[0]
    if n == 1:
        return x.clone()
    ar = _ranks(x)
    flat, size, shape = _pad_to(x, n)
    chunks = flat.reshape(n, n, -1).clone()
    # reduce-scatter: at step s rank r sends chunk (r - s) and folds the
    # received data into chunk (r - s - 1)
    for s in range(n - 1):
        send = chunks[ar, (ar - s) % n]
        recv = _hop(send)
        ri = (ar - s - 1) % n
        chunks[ar, ri] = op.torch_fn(chunks[ar, ri], recv)
    # rank r now owns fully-reduced chunk (r + 1) % n
    cur = chunks[ar, (ar + 1) % n]
    for s in range(n - 1):
        cur = _hop(cur)
        chunks[ar, (ar - s) % n] = cur
    return _unpad(chunks.reshape(n, -1), size, shape)


def allreduce_ring_segmented(x: torch.Tensor, op: Op,
                             segcount: int = 1 << 16) -> torch.Tensor:
    """The ring run independently on each ``segcount``-element segment."""
    n = x.shape[0]
    if n == 1:
        return x.clone()
    flat = x.reshape(n, -1)
    nseg = max(1, -(-flat.shape[1] // segcount))
    outs = [allreduce_ring(flat[:, i * segcount : (i + 1) * segcount], op)
            for i in range(nseg)]
    return torch.cat(outs, 1).reshape(x.shape)


@_carried
def allreduce_recursive_doubling(x: torch.Tensor, op: Op) -> torch.Tensor:
    """log2(n) full-vector partner exchanges; non-power-of-two sizes fold
    the tail ranks in and out like the reference."""
    n = x.shape[0]
    if n == 1:
        return x.clone()
    idx = _col(_ranks(x), x)
    k = 1 << (n.bit_length() - 1)
    rem = n - k
    val = x
    if rem:
        recv = _permute(val, [(i, i - k) for i in range(k, n)])
        val = torch.where(idx < rem, op.torch_fn(val, recv), val)
    active = idx < k
    for s in (1 << b for b in range(int(math.log2(k)))):
        recv = _permute(val, [(i, i ^ s) for i in range(k)])
        if op.commutative:
            folded = op.torch_fn(val, recv)
        else:
            # lower-rank operand first (MPI non-commutative contract)
            folded = torch.where((idx & s) == 0, op.torch_fn(val, recv),
                                 op.torch_fn(recv, val))
        val = torch.where(active, folded, val)
    if rem:
        back = _permute(val, [(i, i + k) for i in range(rem)])
        val = torch.where(idx >= k, back, val)
    return val


def _slice(flat: torch.Tensor, lo: torch.Tensor, length: int) -> torch.Tensor:
    """Per-rank ``flat[r, lo[r] : lo[r] + length]`` (≈ dynamic_slice)."""
    return flat.gather(1, lo[:, None] + torch.arange(length, device=flat.device))


def _update(flat: torch.Tensor, vals: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Per-rank ``flat[r, lo[r] : …] = vals[r]`` (≈ dynamic_update_slice)."""
    pos = lo[:, None] + torch.arange(vals.shape[1], device=flat.device)
    return flat.scatter(1, pos, vals)


@_carried
def allreduce_rabenseifner(x: torch.Tensor, op: Op) -> torch.Tensor:
    """Recursive-halving reduce-scatter + recursive-doubling allgather
    (power-of-two comm sizes; the decision layer gates it)."""
    n = x.shape[0]
    if n == 1:
        return x.clone()
    if n & (n - 1):
        raise ValueError("rabenseifner requires power-of-two comm size")
    ar = _ranks(x)
    flat, size, shape = _pad_to(x, n)
    length = flat.shape[1]
    lo = torch.zeros(n, dtype=torch.int64, device=x.device)
    dist = n // 2
    while dist >= 1:
        length //= 2
        in_upper = (ar & dist) != 0
        keep_lo = torch.where(in_upper, lo + length, lo)
        send_lo = torch.where(in_upper, lo, lo + length)
        recv = _permute(_slice(flat, send_lo, length),
                        [(i, i ^ dist) for i in range(n)])
        kept = _slice(flat, keep_lo, length)
        if op.commutative:
            merged = op.torch_fn(kept, recv)
        else:
            merged = torch.where(in_upper[:, None], op.torch_fn(recv, kept),
                                 op.torch_fn(kept, recv))
        flat = _update(flat, merged, keep_lo)
        lo = keep_lo
        dist //= 2
    dist = 1
    while dist < n:
        recv = _permute(_slice(flat, lo, length),
                        [(i, i ^ dist) for i in range(n)])
        partner_is_upper = (ar & dist) == 0
        partner_lo = torch.where(partner_is_upper, lo + length, lo - length)
        flat = _update(flat, recv, partner_lo)
        lo = torch.minimum(lo, partner_lo)
        length *= 2
        dist *= 2
    return _unpad(flat, size, shape)


# ======================================================================
# allgather  ((n, *s) → (n, n, *s): out[r, j] is rank j's block)
# ======================================================================


def allgather_direct(x: torch.Tensor) -> torch.Tensor:
    return _rows(x, x.shape[0])


@_carried
def allgather_ring(x: torch.Tensor) -> torch.Tensor:
    """n-1 neighbour forwards; each step passes the newest block along."""
    n = x.shape[0]
    ar = _ranks(x)
    out = x.new_zeros((n,) + tuple(x.shape))
    out[ar, ar] = x
    cur = x
    for s in range(n - 1):
        cur = _hop(cur)
        out[ar, (ar - s - 1) % n] = cur
    return out


def allgather_bruck(x: torch.Tensor) -> torch.Tensor:
    """Bruck: ceil(log2 n) rounds of doubling block exchanges."""
    n = x.shape[0]
    ar = _ranks(x)
    blocks = x.unsqueeze(1)  # rank r holds [r, r+1, …] (rotated layout)
    have, s = 1, 1
    while s < n:
        cnt = min(s, n - have)
        blocks = torch.cat([blocks, _hop(blocks[:, :cnt], -s)], 1)
        have += cnt
        s <<= 1
    # un-rotate: out[r, j] = blocks[r, (j - r) % n]
    return blocks[ar[:, None], (ar[None, :] - ar[:, None]) % n]


# ======================================================================
# bcast  (root's row → every row)
# ======================================================================


def bcast_direct(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    return _rows(x[root], x.shape[0])


@_carried
def bcast_binomial(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Binomial tree: round s, ranks rel < 2^s forward to rel + 2^s."""
    n = x.shape[0]
    if n == 1:
        return x.clone()
    rel = _col((_ranks(x) - root) % n, x)
    val = x
    s = 1
    while s < n:
        pairs = [((r + root) % n, (r + s + root) % n) for r in range(min(s, n - s))]
        val = torch.where((rel >= s) & (rel < 2 * s), _permute(val, pairs), val)
        s <<= 1
    return val


@_carried
def bcast_pipeline(x: torch.Tensor, root: int = 0,
                   segcount: int = 1 << 16) -> torch.Tensor:
    """Segmented chain: the message flows down a rank chain segment by
    segment."""
    n = x.shape[0]
    if n == 1:
        return x.clone()
    flat = x.reshape(n, -1)
    rel = ((_ranks(x) - root) % n)[:, None]
    nseg = max(1, -(-flat.shape[1] // segcount))
    chain = [((r + root) % n, (r + 1 + root) % n) for r in range(n - 1)]
    outs = []
    for i in range(nseg):
        val = flat[:, i * segcount : (i + 1) * segcount]
        for hop in range(n - 1):
            val = torch.where(rel == hop + 1, _permute(val, chain), val)
        outs.append(val)
    return torch.cat(outs, 1).reshape(x.shape)


# ======================================================================
# reduce  (all → root)
# ======================================================================


@_carried
def reduce_binomial(x: torch.Tensor, op: Op, root: int = 0) -> torch.Tensor:
    """Binomial fan-in tree; the result is valid on root's row."""
    n = x.shape[0]
    if n == 1:
        return x.clone()
    rel = _col((_ranks(x) - root) % n, x)
    val = x
    s = 1
    while s < n:
        pairs = [((r + s + root) % n, (r + root) % n)
                 for r in range(0, n, 2 * s) if r + s < n]
        recv = _permute(val, pairs)
        is_receiver = (rel % (2 * s) == 0) & (rel + s < n)
        val = torch.where(is_receiver, op.torch_fn(val, recv), val)
        s <<= 1
    return val


def reduce_ordered(x: torch.Tensor, op: Op, root: int = 0) -> torch.Tensor:
    """Bit-exact in-order fold; identical result on every row."""
    return allreduce_ordered_linear(x, op)


# ======================================================================
# reduce_scatter  ((n, n, *blk): x[r, j] is rank r's part for rank j
#                  → (n, *blk): row j is the reduction of x[:, j])
# ======================================================================


def reduce_scatter_direct(x: torch.Tensor, op: Op) -> torch.Tensor:
    if op.collective == "sum":
        return fused_reduce(x, op)
    return reduce_scatter_ring(x, op)


@_carried
def reduce_scatter_ring(x: torch.Tensor, op: Op) -> torch.Tensor:
    """Ring reduce-scatter: the partial for block b starts at rank
    (b+1) % n and accumulates while travelling to its owner b (chain
    order — commutative ops only)."""
    n = x.shape[0]
    if n == 1:
        return x[0].clone()
    ar = _ranks(x)
    cur = x[ar, (ar - 1) % n]
    for s in range(n - 1):
        cur = _hop(cur)
        # received: partial for block b = r - s - 2; add own contribution
        cur = op.torch_fn(cur, x[ar, (ar - s - 2) % n])
    return cur


def reduce_scatter_ordered(x: torch.Tensor, op: Op) -> torch.Tensor:
    """Rank-ordered reduce_scatter: row j folds x[0, j], x[1, j], … in
    ascending source-rank order (the non-commutative contract)."""
    if x.shape[0] == 1:
        return x[0].clone()
    return ordered_reduce_torch(x, op)


def alltoall_direct(x: torch.Tensor) -> torch.Tensor:
    """x: (n, n, *blk), x[r, j] from rank r to rank j → out[j, r]."""
    return x.transpose(0, 1).contiguous()


@_carried
def alltoall_pairwise(x: torch.Tensor) -> torch.Tensor:
    """n-1 rounds, step s exchanging with rank ± s."""
    n = x.shape[0]
    ar = _ranks(x)
    out = torch.zeros_like(x)
    out[ar, ar] = x[ar, ar]
    for s in range(1, n):
        recv = _hop(x[ar, (ar + s) % n], s)
        out[ar, (ar - s) % n] = recv
    return out


# ======================================================================
# barrier / scan
# ======================================================================


def barrier_allreduce(n: int, device) -> torch.Tensor:
    """Token sum — completion of the reduction IS the barrier."""
    return _rows(torch.ones(n, dtype=torch.int32, device=device).sum(
        dtype=torch.int32), n)


def barrier_dissemination(n: int, device) -> torch.Tensor:
    """Dissemination barrier: ceil(log2 n) token rounds, each round's
    token depending on the previous one."""
    token = torch.ones(n, dtype=torch.int32, device=device)
    s = 1
    while s < n:
        token = token + _hop(token, s)
        s <<= 1
    return token


@_carried
def scan_ordered(x: torch.Tensor, op: Op, exclusive: bool = False) -> torch.Tensor:
    """MPI_Scan/Exscan: rank r folds rows 0..r (inclusive) or 0..r-1
    (exclusive; rank 0 yields zeros) in rank order, bit-exact."""
    n = x.shape[0]
    idx = _col(_ranks(x), x)
    if exclusive:
        acc = torch.zeros_like(x)
        for i in range(n):
            nxt = x[0].expand_as(x) if i == 0 else op.torch_fn(acc, x[i])
            acc = torch.where(i < idx, nxt, acc)
        return acc
    acc = x[0].expand_as(x)
    for i in range(1, n):
        acc = torch.where(i <= idx, op.torch_fn(acc, x[i]), acc)
    return acc.contiguous()

"""Ring attention over the port's communicator — long-context sequence
parallelism on the collective substrate.

Port of ``examples/ring_attention.py``.  The sequence axis is sharded
over the communicator's ranks: rank r holds block r of the queries, keys
and values, as row r of rank-major ``(n, block, heads, dh)`` tensors on
the comm's device.  Each rank attends its queries to its local K/V
block, then the K/V blocks rotate one rank around the ring while the
softmax statistics (running max and normalizer) accumulate online.
After n-1 rotations every query block has attended to the full sequence
with O(seq/n) keys and values per rank.

The rotation is the ring hop: :func:`~ompi_tpu_torch.coll.cuda_kernels.
ring_hop` (``csrc/ring_hop.cu:ring_hop_kernel`` on the card, its plain
twin for CPU tensors) over ``(n, 1, block·heads·dh)`` views with every
chunk index 0 — the kernel that replaces the reference's
``lax.ppermute`` (``examples/ring_attention.py:83-84``), so one call
launches it 2(n-1) times.  The two einsums per step are plain products,
as the reference leaves them to XLA outside Pallas; they run in full
float32 (TF32 off, the reference's ``Precision.HIGHEST``).

    comm = api.init(device="cuda")
    out = ring_attention(comm, q, k, v)   # q, k, v: (n, block, heads, dh)

The math is exact, not an approximation: the result matches dense
attention up to float rounding (``tests/test_torch_examples.py``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ompi_tpu_torch.coll.cuda_kernels import ring_hop


@contextlib.contextmanager
def _full_f32():
    """float32 products in full precision for the duration of the call."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _block_attend(q, k, v, m_prev, l_prev, o_prev, scale):
    """One blockwise-attention accumulation step (online softmax), for
    every rank at once.  q: (n, B, H, D); k/v: (n, Bk, H, D); running
    stats m, l: (n, B, H), o: (n, B, H, D)."""
    s = torch.einsum("nbhd,nkhd->nbhk", q, k) * scale
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    # rescale the previous accumulators to the new max
    alpha = torch.exp(m_prev - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l_prev * alpha + p.sum(dim=-1)
    o_new = o_prev * alpha[..., None] + torch.einsum("nbhk,nkhd->nbhd", p, v)
    return m_new, l_new, o_new


def _rotate(x: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """Rank r's block to rank r+1: one ring hop over (n, 1, block·heads·dh)
    views into a fresh buffer (the hop reads every row while it writes)."""
    n = x.shape[0]
    out = torch.empty_like(x)
    ring_hop(x.view(n, 1, -1), zero, out.view(n, 1, -1), zero)
    return out


def ring_attention(comm, q, k, v):
    """Full-sequence attention with the sequence axis sharded over the
    communicator's ranks.  q/k/v: rank-major (n, block, heads, dh), numpy
    (the result is numpy) or tensors (the result is a tensor on the comm's
    device)."""
    n = comm.size
    host = not isinstance(q, torch.Tensor)
    dev = comm.device
    q, k, v = (torch.as_tensor(np.asarray(a) if host else a, device=dev).contiguous()
               for a in (q, k, v))
    if q.shape[0] != n:
        raise ValueError(f"rank-major inputs need {n} rows, got {tuple(q.shape)}")
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    with _full_f32():
        m = torch.full(q.shape[:-1], -torch.inf, dtype=q.dtype, device=dev)
        l = torch.zeros(q.shape[:-1], dtype=q.dtype, device=dev)
        o = torch.zeros_like(q)
        # the local block first, then n-1 rotate-and-attend steps (a
        # final rotation would be dead communication)
        m, l, o = _block_attend(q, k, v, m, l, o, scale)
        kb, vb = k, v
        for _ in range(n - 1):
            kb, vb = _rotate(kb, zero), _rotate(vb, zero)
            m, l, o = _block_attend(q, kb, vb, m, l, o, scale)
        out = o / l[..., None]
    return out.cpu().numpy() if host else out


def reference_attention(q, k, v):
    """Dense full-sequence attention in float64 numpy (the parity oracle)."""
    n, b, h, d = q.shape
    qf = np.asarray(q, np.float64).reshape(n * b, h, d)
    kf = np.asarray(k, np.float64).reshape(n * b, h, d)
    vf = np.asarray(v, np.float64).reshape(n * b, h, d)
    s = np.einsum("bhd,khd->bhk", qf, kf) / np.sqrt(d)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    return np.einsum("bhk,khd->bhd", p, vf).reshape(n, b, h, d)

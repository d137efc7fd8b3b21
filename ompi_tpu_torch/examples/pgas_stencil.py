"""PGAS halo-exchange stencil over the port's OpenSHMEM-style API.

Port of ``examples/pgas_stencil.py``: each PE owns a strip of a 1-D
grid in the symmetric heap and iterates a 3-point Jacobi smoothing;
neighbor halos move with one-sided ``shmem.put`` (no receives anywhere
— the PGAS contrast to the message-passing examples).  The strips are
tensors on the heap's device and the smoothing runs there: on the card
the halo puts and the stencil never leave it.  Works on the
single-controller world (all PEs driven by one process) and under
``python -m ompi_tpu_torch run`` with real processes; C programs get
the same pattern from ``shmem.h``/``libtpushmem``.

Run standalone on the card (``--device cpu`` for the CPU):

    python -m ompi_tpu_torch.examples.pgas_stencil
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import ompi_tpu_torch.shmem as shmem


def jacobi_pgas(strip_len: int = 64, iters: int = 20,
                seed: int = 0) -> torch.Tensor:
    """Iterate u[i] = (u[i-1] + u[i] + u[i+1]) / 3 over a grid striped
    across every PE; returns THIS process's PEs' strips stacked
    (npes*strip rows on the single-controller world), on the heap's
    device."""
    shmem.init(heap_bytes=4 << 20)  # a small heap is plenty
    pes = shmem.local_pes()
    n = shmem.n_pes()

    # symmetric allocations: strip + a 2-cell halo mailbox per PE
    u = shmem.malloc(strip_len + 2, np.float64)  # [halo_lo, strip, halo_hi]
    rng = np.random.default_rng(seed)
    full = torch.from_numpy(rng.standard_normal(n * strip_len))
    for pe in pes:
        v = u.view(pe)
        v.zero_()
        v[1:-1].copy_(full[pe * strip_len:(pe + 1) * strip_len])
    # a tensor divisor: a Python-scalar divisor may be applied on the
    # card as a multiply by its reciprocal, which is not numpy's division
    three = torch.tensor(3.0, dtype=torch.float64, device=u.view(pes[0]).device)
    shmem.barrier_all()

    for _ in range(iters):
        # one-sided halo push: my edge cells land in my neighbors'
        # halo slots (fixed boundary: edge PEs keep zero halos)
        for pe in pes:
            v = u.view(pe)
            if pe > 0:
                _put_element(u, strip_len + 1, v[1:2], pe - 1)
            if pe < n - 1:
                _put_element(u, 0, v[strip_len:strip_len + 1], pe + 1)
        shmem.barrier_all()
        for pe in pes:
            v = u.view(pe)
            v[1:-1].copy_((v[:-2] + v[1:-1] + v[2:]) / three)
        shmem.barrier_all()

    return torch.stack([u.view(pe)[1:-1].clone() for pe in pes])


def _put_element(arr, index: int, value: torch.Tensor, pe: int) -> None:
    """Single-element one-sided store into a symmetric slot."""
    cell = shmem.SymmArray(
        arr.offset + index * arr.dtype.itemsize, (1,), arr.dtype)
    shmem.put(cell, value, pe)


def jacobi_reference(strip_len: int, npes: int, iters: int,
                     seed: int = 0) -> np.ndarray:
    """Same smoothing on the undistributed grid (fixed zero boundary)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(npes * strip_len)
    for _ in range(iters):
        padded = np.concatenate(([0.0], u, [0.0]))
        u = (padded[:-2] + padded[1:-1] + padded[2:]) / 3.0
    return u.reshape(npes, strip_len)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="device of the world (default: CUDA, raising without it)")
    args = ap.parse_args()
    import ompi_tpu_torch.api as api

    api.init(device=args.device)
    out = jacobi_pgas()
    ref = jacobi_reference(64, shmem.n_pes(), 20)
    ok = np.allclose(out.cpu().numpy(), ref[shmem.local_pes()], rtol=1e-12)
    print("PGAS stencil", "OK" if ok else "MISMATCH")
    shmem.finalize()
    api.finalize()

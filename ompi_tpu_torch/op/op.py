"""MPI reduction operations (MPI_Op) over torch tensors.

Port of ``ompi_tpu/op/op.py``.  Each op carries

* a **torch kernel** ``torch_fn(a, b)`` — the elementwise monoid the
  collectives fold with (the reference's ``jax_fn``);
* a **numpy kernel** ``np_fn`` — the host/golden path, unchanged from
  the reference, so bit parity is checked against it;
* optionally the name of a **fused rank-axis reduction**
  (``collective``: sum/max/min) for the direct path, the counterpart of
  the reference's ``lax_collective`` (psum/pmax/pmin).

Two gaps of torch's CPU kernels are closed here:

* ``+``, ``*``, ``maximum`` and the bitwise ops are not implemented for
  uint16/32/64.  SUM, PROD and the bitwise ops run on the same-width
  signed view (two's-complement gives the same low bits); MAX and MIN
  compare the signed view with the sign bit flipped, which orders it
  like the unsigned value.
* data movement (``index_put``, ``gather``) is not implemented for the
  unsigned dtypes either, so the collectives carry unsigned payloads as
  their signed view and fold them through :func:`on_carrier`.

Bit-exactness: :func:`ordered_reduce_torch` applies the fixed
rank-sequential left fold ``((r0 ⊕ r1) ⊕ r2) …`` that
:func:`ordered_reduce_np` applies on the host.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ompi_tpu_torch.core.errors import MPIOpError
from ompi_tpu_torch.ddt.datatype import SIGNED_TWIN, Datatype, dtype_kind


@dataclass(frozen=True, eq=False)
class Op:
    """An MPI reduction operation (identity-hashed, like the reference)."""

    name: str
    torch_fn: Callable[[Any, Any], Any] | None
    np_fn: Callable[[Any, Any], Any] | None
    commutative: bool = True
    #: fused rank-axis reduction for the direct path: sum | max | min
    collective: str | None = None
    #: dtype-kind gate per MPI's op/type compatibility table
    kinds: tuple[str, ...] = ("i", "u", "f", "c", "b")
    #: True for MAXLOC/MINLOC — operates on (value, index) pairs
    is_loc: bool = False

    def allowed_on(self, dt: Datatype) -> bool:
        if self.is_loc:
            return len(dt.typemap) == 2
        leaf = dt.uniform_leaf
        if leaf is None:
            return False
        return dtype_kind(leaf) in self.kinds

    def check(self, dt: Datatype) -> None:
        if self.np_fn is None and self.torch_fn is None:
            raise MPIOpError(f"{self.name} is not a reducing op")
        if not self.allowed_on(dt):
            raise MPIOpError(
                f"op {self.name} not defined for datatype {dt.name or dt}"
            )

    def __repr__(self) -> str:  # pragma: no cover
        return f"<MPI_Op {self.name}>"


def _signed(fn):
    """Run ``fn`` on the same-width signed view of unsigned tensors."""

    def wrapped(a, b):
        twin = SIGNED_TWIN.get(a.dtype)
        if twin is None:
            return fn(a, b)
        return fn(a.view(twin), b.view(twin)).view(a.dtype)

    return wrapped


def _ordered(pick, want_max: bool):
    """MAX/MIN: ``pick`` (torch.maximum/minimum) on ordered keys; an
    unsigned value's key is its signed view with the sign bit flipped.

    On floats the result is chosen explicitly, as the CUDA kernel and
    XLA choose it: a NaN operand wins bit for bit (the first when both
    are NaN), and a ±0 tie gives +0 for MAX and -0 for MIN.  torch's
    CPU kernels return a canonical NaN and the first zero instead."""

    def fn(a, b):
        twin = SIGNED_TWIN.get(a.dtype)
        if twin is not None:
            flip = torch.iinfo(twin).min
            key = pick(a.view(twin) ^ flip, b.view(twin) ^ flip)
            return (key ^ flip).view(a.dtype)
        out = pick(a, b)
        if not a.is_floating_point():
            return out
        zero_tie = (a == b) & (torch.signbit(a) == want_max)
        out = torch.where(zero_tie, b, out)
        out = torch.where(torch.isnan(b), b, out)
        return torch.where(torch.isnan(a), a, out)

    return fn


def _logical(combine):
    def fn(a, b):
        return combine(a != 0, b != 0).to(a.dtype)

    return fn


def _land_np(a, b):
    return ((a != 0) & (b != 0)).astype(a.dtype)


def _lor_np(a, b):
    return ((a != 0) | (b != 0)).astype(a.dtype)


def _lxor_np(a, b):
    return ((a != 0) ^ (b != 0)).astype(a.dtype)


SUM = Op("MPI_SUM", torch_fn=_signed(lambda a, b: a + b),
         np_fn=lambda a, b: a + b, collective="sum", kinds=("i", "u", "f", "c"))
PROD = Op("MPI_PROD", torch_fn=_signed(lambda a, b: a * b),
          np_fn=lambda a, b: a * b, kinds=("i", "u", "f", "c"))
MAX = Op("MPI_MAX", torch_fn=_ordered(torch.maximum, True), np_fn=np.maximum,
         collective="max", kinds=("i", "u", "f"))
MIN = Op("MPI_MIN", torch_fn=_ordered(torch.minimum, False), np_fn=np.minimum,
         collective="min", kinds=("i", "u", "f"))
LAND = Op("MPI_LAND", torch_fn=_logical(torch.logical_and), np_fn=_land_np,
          kinds=("i", "u", "b"))
LOR = Op("MPI_LOR", torch_fn=_logical(torch.logical_or), np_fn=_lor_np,
         kinds=("i", "u", "b"))
LXOR = Op("MPI_LXOR", torch_fn=_logical(torch.logical_xor), np_fn=_lxor_np,
          kinds=("i", "u", "b"))
BAND = Op("MPI_BAND", torch_fn=_signed(lambda a, b: a & b),
          np_fn=np.bitwise_and, kinds=("i", "u", "b"))
BOR = Op("MPI_BOR", torch_fn=_signed(lambda a, b: a | b),
         np_fn=np.bitwise_or, kinds=("i", "u", "b"))
BXOR = Op("MPI_BXOR", torch_fn=_signed(lambda a, b: a ^ b),
          np_fn=np.bitwise_xor, kinds=("i", "u", "b"))


# MAXLOC/MINLOC: value+index pairs; MPI tie-break = lower index wins.
def _maxloc_np(a, b):
    val_a, idx_a = a
    val_b, idx_b = b
    take_a = (val_a > val_b) | ((val_a == val_b) & (idx_a <= idx_b))
    return np.where(take_a, val_a, val_b), np.where(take_a, idx_a, idx_b)


def _minloc_np(a, b):
    val_a, idx_a = a
    val_b, idx_b = b
    take_a = (val_a < val_b) | ((val_a == val_b) & (idx_a <= idx_b))
    return np.where(take_a, val_a, val_b), np.where(take_a, idx_a, idx_b)


def _maxloc_torch(a, b):
    val_a, idx_a = a
    val_b, idx_b = b
    take_a = (val_a > val_b) | ((val_a == val_b) & (idx_a <= idx_b))
    return torch.where(take_a, val_a, val_b), torch.where(take_a, idx_a, idx_b)


def _minloc_torch(a, b):
    val_a, idx_a = a
    val_b, idx_b = b
    take_a = (val_a < val_b) | ((val_a == val_b) & (idx_a <= idx_b))
    return torch.where(take_a, val_a, val_b), torch.where(take_a, idx_a, idx_b)


MAXLOC = Op("MPI_MAXLOC", torch_fn=_maxloc_torch, np_fn=_maxloc_np, is_loc=True)
MINLOC = Op("MPI_MINLOC", torch_fn=_minloc_torch, np_fn=_minloc_np, is_loc=True)

#: RMA accumulate ops (no reduction semantics of their own)
REPLACE = Op("MPI_REPLACE", torch_fn=lambda a, b: b, np_fn=lambda a, b: b)
NO_OP = Op("MPI_NO_OP", torch_fn=lambda a, b: a, np_fn=lambda a, b: a)

PREDEFINED_OPS = {
    op.name: op
    for op in [SUM, PROD, MAX, MIN, LAND, LOR, LXOR, BAND, BOR, BXOR,
               MAXLOC, MINLOC, REPLACE, NO_OP]
}


def create_op(fn: Callable[[Any, Any], Any], commute: bool = True,
              name: str = "user_op") -> Op:
    """MPI_Op_create: ``fn(a, b)`` must be elementwise; it receives numpy
    arrays on the host path and tensors on the device path."""
    return Op(name, torch_fn=fn, np_fn=fn, commutative=commute,
              kinds=("i", "u", "f", "c", "b"))


#: (op, unsigned dtype) → op folding signed carrier views
_CARRIER_OPS: dict[tuple, Op] = {}


def on_carrier(op: Op, dtype: torch.dtype) -> Op:
    """``op`` as it folds the signed carrier view of an unsigned
    ``dtype``: re-view each operand as ``dtype``, fold, view back."""
    key = (op, dtype)
    c = _CARRIER_OPS.get(key)
    if c is None:
        twin = SIGNED_TWIN[dtype]
        fn = op.torch_fn

        def carried(a, b):
            return fn(a.view(dtype), b.view(dtype)).view(twin)

        c = dataclasses.replace(op, torch_fn=carried)
        if len(_CARRIER_OPS) > 4096:  # user-op churn backstop
            _CARRIER_OPS.clear()
        _CARRIER_OPS[key] = c
    return c


def fused_reduce(stacked: torch.Tensor, op: Op) -> torch.Tensor:
    """One torch reduction over the leading (rank) axis — the direct
    path's counterpart of psum/pmax/pmin.  The reduction order is
    torch's own, so results match the ordered fold only to rounding."""
    twin = SIGNED_TWIN.get(stacked.dtype)
    if op.collective == "sum":
        if twin is not None:
            return stacked.view(twin).sum(0, dtype=twin).view(stacked.dtype)
        return stacked.sum(0, dtype=stacked.dtype)
    if op.collective in ("max", "min"):
        red = torch.amax if op.collective == "max" else torch.amin
        if twin is not None:
            flip = torch.iinfo(twin).min
            return (red(stacked.view(twin) ^ flip, 0) ^ flip).view(stacked.dtype)
        return red(stacked, 0)
    raise MPIOpError(f"no fused reduction for {op.name}")


# -- ordered (bit-exact) reduction kernels -----------------------------


def ordered_reduce_np(stacked: np.ndarray, op: Op) -> np.ndarray:
    """Rank-sequential left fold on the host: ((r0 ⊕ r1) ⊕ r2) …"""
    acc = stacked[0]
    for r in range(1, stacked.shape[0]):
        acc = op.np_fn(acc, stacked[r])
    return acc


def ordered_reduce_torch(stacked: torch.Tensor, op: Op) -> torch.Tensor:
    """The same left fold over the leading axis of a tensor."""
    acc = stacked[0]
    for r in range(1, stacked.shape[0]):
        acc = op.torch_fn(acc, stacked[r])
    return acc


def pairwise_tree_reduce_torch(stacked: torch.Tensor, op: Op) -> torch.Tensor:
    """Fixed-shape binary-tree fold (log2(n) depth), the order of the
    reference's ``pairwise_tree_reduce_jax``."""
    n = stacked.shape[0]
    while n > 1:
        half = n // 2
        merged = op.torch_fn(stacked[: half * 2 : 2], stacked[1 : half * 2 : 2])
        if n % 2:
            merged = torch.cat([merged, stacked[n - 1 : n]], 0)
        stacked = merged
        n = merged.shape[0]
    return stacked[0]

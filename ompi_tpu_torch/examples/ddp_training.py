"""Data-parallel training on the port — the MPI user's workflow.

Port of ``examples/ddp_training.py``.  The model is the same small MLP
regression, as an ``nn.Module`` whose parameters are **rank-major**: each
parameter has a leading axis of n virtual ranks, rank r's replica being
row r, so the forward and backward passes of all ranks run as batched
matrix products on one device.

:func:`make_fused_step` is the counterpart of the reference's fused
step: per-rank gradients → ``coll.base.allreduce_ring(SUM)`` over the
rank axis → SGD.  :func:`train_step_host` is the MPI-API form: the
gradients go through ``comm.allreduce`` — on a multi-process
communicator, han's local leg on the card plus the DCN leg between
processes, the model holding this process's ranks' replicas.  Both
update in place on the module's parameters (the reference returns new
arrays).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ompi_tpu_torch.coll import base as algos
from ompi_tpu_torch.op import SUM


def init_params(rng: np.random.RandomState, din=8, dh=32, dout=1):
    """The reference's initial weights (numpy, same draws from ``rng``)."""
    return {
        "w1": rng.randn(din, dh).astype(np.float32) * 0.3,
        "b1": np.zeros(dh, np.float32),
        "w2": rng.randn(dh, dout).astype(np.float32) * 0.3,
        "b2": np.zeros(dout, np.float32),
    }


def replicate(params, n: int):
    """Rank-major replication of a parameter dict."""
    return {k: np.broadcast_to(p, (n,) + p.shape).copy() for k, p in params.items()}


class ReplicatedMLP(nn.Module):
    """tanh MLP with one replica per virtual rank: w1 (n, din, dh),
    b1 (n, dh), w2 (n, dh, dout), b2 (n, dout)."""

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        self.w1 = nn.Parameter(params["w1"])
        self.b1 = nn.Parameter(params["b1"])
        self.w2 = nn.Parameter(params["w2"])
        self.b2 = nn.Parameter(params["b2"])

    @property
    def nranks(self) -> int:
        return self.w1.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (n, batch, din) → (n, batch, dout)."""
        h = torch.tanh(torch.bmm(x, self.w1) + self.b1[:, None, :])
        return torch.bmm(h, self.w2) + self.b2[:, None, :]

    def loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Per-rank mean squared error, shape (n,)."""
        return ((self(x) - y) ** 2).mean(dim=(1, 2))


def params_from_jax(params_np: dict[str, np.ndarray], device=None) -> ReplicatedMLP:
    """The reference's ``replicate(init_params(rng), n)`` numpy dict → the
    port's module on ``device`` (CUDA unless asked otherwise), so both
    packages start from the same weights."""
    from ompi_tpu_torch.mesh.mesh import resolve_device

    dev = resolve_device(device)
    return ReplicatedMLP({k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                          for k, v in params_np.items()})


def train_step_host(comm, model: ReplicatedMLP, x: torch.Tensor, y: torch.Tensor,
                    lr=0.05) -> torch.Tensor:
    """One DDP step through the MPI API: per-rank gradients →
    ``comm.allreduce(SUM)`` of each gradient → SGD by the mean over
    ``comm.size`` ranks.  ``model``, ``x`` and ``y`` are rank-major over
    the comm's LOCAL ranks (all of them on a single-process comm).
    Returns the per-rank loss before the update."""
    model.zero_grad(set_to_none=True)
    loss = model.loss(x, y)
    loss.sum().backward()  # each rank's own gradient, as in make_fused_step
    with torch.no_grad():
        for p in model.parameters():
            p -= lr * comm.allreduce(p.grad, SUM) / comm.size
    return loss.detach()


def make_fused_step(n: int, lr=0.05):
    """grad → ring allreduce over the rank axis → SGD, for every rank.

    Returns ``step(model, x, y) -> per-rank loss before the update``."""

    def step(model: ReplicatedMLP, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if model.nranks != n:
            raise ValueError(f"model has {model.nranks} replicas, step expects {n}")
        model.zero_grad(set_to_none=True)
        loss = model.loss(x, y)
        # each rank's loss depends only on its own replica, so the
        # gradient of the sum is every rank's own gradient
        loss.sum().backward()
        with torch.no_grad():
            for p in model.parameters():
                g = algos.allreduce_ring(p.grad, SUM)
                p -= lr * g / n
        return loss.detach()

    return step

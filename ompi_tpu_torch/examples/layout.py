"""What the example workers share to run one script on either layout of
a communicator's local mesh: ``rows`` (the local ranks are the rows of
one tensor on one device) and ``devices`` (one buffer per rank, on the
rank's own card, as ``RankShards``)."""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ompi_tpu_torch.mesh.shards import RankShards


def on_ranks(comm, x: torch.Tensor):
    """A rank-major tensor on ``comm.device`` as ``comm`` takes it: itself
    on the rows layout, on the devices layout ``RankShards`` with row l
    copied onto local rank l's device."""
    if comm.local_mesh.layout != "devices":
        return x
    return RankShards([x[i].to(d, copy=True) for i, d in enumerate(comm.local_mesh.devices)])


def placement(comm, out) -> dict:
    """Where a result lies: its shards' (or its tensor's) devices, and
    whether each is its rank's (a ``RankShards`` on the devices layout)."""
    if isinstance(out, RankShards):
        got = [str(d) for d in out.devices]
    else:
        got = [str(out.device)] * comm.local_size
    ok = got == [str(d) for d in comm.local_mesh.devices] and (
        comm.local_mesh.layout != "devices" or isinstance(out, RankShards))
    return {"devices": got, "ok": ok}


def sync(comm) -> None:
    """Wait for every card of ``comm``'s local mesh."""
    for d in dict.fromkeys(comm.local_mesh.devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def digest(t) -> str:
    """SHA-256 of a result's bytes, rank-major (a ``RankShards``'s shards
    gathered in rank order), so a devices run and a rows run of the same
    inputs compare."""
    if isinstance(t, RankShards):
        a = t.to_host()
    elif isinstance(t, torch.Tensor):
        a = t.detach().contiguous().cpu().numpy()
    else:
        a = np.asarray(t)
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

"""Checkpoint/resume over MPI-IO collective writes.

Port of ``ompi_tpu/io/checkpoint.py``.  A rank-major ``(n, ...)``
tensor, :class:`~ompi_tpu_torch.mesh.shards.RankShards` or array
checkpoints through ``write_at_all`` — each rank owns a contiguous
shard region and the fcoll strategy coalesces the shards into large
writes — plus a JSON manifest, and restores through ``read_at_all`` and
``stage_in`` onto the comm's mesh: one tensor on the rows layout,
``RankShards`` with shard r on ``devices[r]`` on the devices layout (the
reference's value sharded one row per device).

The on-disk format is the reference's, byte for byte: the shards' raw
bytes at ``r * shard_bytes`` and the manifest ``{"shape", "dtype",
"ranks", "shard_bytes", ...}`` with numpy's dtype name (``float32``,
``bfloat16``), never torch's, so a checkpoint written by either package
restores in the other.  A tensor leaves the card in one device-to-host
copy of its bytes (``RankShards`` in one per shard); :func:`save_async`
takes that copy before it returns, so the caller may overwrite the
tensor at once.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any

import numpy as np
import torch

from ompi_tpu_torch.core.errors import MPIFileError
from ompi_tpu_torch.ddt.datatype import numpy_dtype, numpy_name, to_numpy, torch_dtype
from ompi_tpu_torch.mesh.shards import RankShards
from ompi_tpu_torch.request import Request

from .file import MODE_CREATE, MODE_RDONLY, MODE_WRONLY


class CheckpointRequest(Request):
    """Completes when the background checkpoint writer finishes."""

    def __init__(self, thread: threading.Thread, errbox: list):
        super().__init__()
        self._thread = thread
        self._errbox = errbox

    def _poll(self) -> bool:
        return not self._thread.is_alive()

    def _block(self) -> None:
        self._thread.join()

    def _finalize(self) -> Any:
        if self._errbox:
            raise self._errbox[0]
        return None


def _raw(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes, flat (``view(uint8)`` needs a contiguous 1-D tensor)."""
    return t.detach().contiguous().view(-1).view(torch.uint8)


def _snapshot(comm, array) -> tuple[np.ndarray, list[int], str, bool]:
    """(host bytes as (n, shard_bytes) uint8, shape, numpy dtype name,
    whether those bytes may be the caller's memory): one D2H copy for a
    tensor, one per shard for ``RankShards``, none for a host array."""
    if isinstance(array, RankShards):
        raw = np.stack([to_numpy(_raw(s)) for s in array.shards])
        return raw, list(array.shape), numpy_name(array.dtype), False
    if isinstance(array, torch.Tensor):
        raw = comm.mesh.stage_out(_raw(array))
        return (raw.reshape(array.shape[0], -1), list(array.shape), numpy_name(array.dtype),
                array.device.type == "cpu")
    host = np.ascontiguousarray(np.asarray(array))
    return (host.reshape(host.shape[0], -1).view(np.uint8), list(host.shape), str(host.dtype),
            True)


def _save_bytes(comm, path: str, shards: np.ndarray, shape: list[int], dtype: str,
                manifest_extra: dict | None) -> None:
    n = comm.size
    if shape[0] != n:
        raise MPIFileError(f"checkpoint array leading dim {shape[0]} != comm size {n}")
    shard_bytes = shards[0].nbytes
    manifest = {"shape": shape, "dtype": dtype, "ranks": n, "shard_bytes": shard_bytes,
                **(manifest_extra or {})}
    # a stale manifest must not validate the data about to be overwritten
    try:
        os.unlink(path + ".json")
    except FileNotFoundError:
        pass
    fh = comm.file_open(path, MODE_CREATE | MODE_WRONLY)
    try:
        fh.set_size(0)  # truncate any previous checkpoint
        fh.write_at_all([r * shard_bytes for r in range(n)], [shards[r] for r in range(n)])
        fh.sync()
    finally:
        fh.close()
    # manifest last: its existence certifies complete data
    tmp = path + ".json.tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path + ".json")


def save(comm, path: str, array, manifest_extra: dict | None = None) -> None:
    """Collective checkpoint of a rank-major (n, ...) tensor,
    ``RankShards`` or array: rank r's row is shard r, all written by one
    aggregated collective write."""
    shards, shape, dtype, _ = _snapshot(comm, array)
    _save_bytes(comm, path, shards, shape, dtype, manifest_extra)


def save_async(comm, path: str, array, manifest_extra: dict | None = None) -> CheckpointRequest:
    """Asynchronous checkpoint: the snapshot is taken to the host now
    (the tensor is reusable on return), the write runs on a background
    thread and completes through the request."""
    shards, shape, dtype, callers = _snapshot(comm, array)
    if callers:
        shards = shards.copy()  # host memory is the caller's: copy it
    errbox: list = []

    def run():
        try:
            _save_bytes(comm, path, shards, shape, dtype, manifest_extra)
        except Exception as e:  # surfaced at wait()
            errbox.append(e)

    t = threading.Thread(target=run, name=f"ckpt:{os.path.basename(path)}", daemon=True)
    t.start()
    return CheckpointRequest(t, errbox)


def restore(comm, path: str, stage: bool = True):
    """Collective restore: one aggregated read of every shard; returns
    the (n, ...) value staged onto the comm's mesh — one tensor on the
    rows layout, ``RankShards`` with shard r on ``devices[r]`` on the
    devices layout; a host array when ``stage=False`` — and the
    manifest."""
    try:
        with open(path + ".json") as f:
            manifest = json.load(f)
    except OSError as e:
        raise MPIFileError(f"no checkpoint manifest at {path}.json: {e}") from e
    n = comm.size
    if manifest["ranks"] != n:
        raise MPIFileError(
            f"checkpoint has {manifest['ranks']} shards, comm has {n} ranks "
            "(elastic reshard not supported here)")
    shard_bytes = manifest["shard_bytes"]
    actual = os.path.getsize(path) if os.path.exists(path) else -1
    if actual < n * shard_bytes:
        raise MPIFileError(
            f"checkpoint {path} is {actual} B, expected ≥ {n * shard_bytes} B "
            "(truncated or interrupted save)")
    fh = comm.file_open(path, MODE_RDONLY)
    try:
        raws = fh.read_at_all([r * shard_bytes for r in range(n)], [shard_bytes] * n)
    finally:
        fh.close()
    tdt = torch_dtype(manifest["dtype"])
    shape = tuple(manifest["shape"])
    flat = np.stack(raws)  # (n, shard_bytes) uint8
    if stage:
        staged = comm.mesh.stage_in(flat)
        if isinstance(staged, RankShards):
            return RankShards([s.view(tdt).reshape(shape[1:]) for s in staged.shards]), manifest
        return staged.view(tdt).reshape(shape), manifest
    return flat.view(numpy_dtype(tdt)).reshape(shape), manifest

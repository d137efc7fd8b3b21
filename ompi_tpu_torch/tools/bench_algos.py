#!/usr/bin/env python
"""bench_algos — every ``coll/base`` algorithm family at n = 8, timed.

Usage::

    python -m ompi_tpu_torch bench-algos [--cpu] [--check] [--small N]
        [--small-iters K] [--large N] [--large-iters K]
    python -m ompi_tpu_torch.tools.bench_algos [...]

Port of the reference's ``tools/bench_algos_cpu8.py``: the same seven
family tables (allreduce, allgather, bcast, reduce, reduce_scatter,
alltoall, barrier) over ``ompi_tpu_torch.coll.base``, each entry bound
as the reference binds it (``SUM``, root 0, the ``(N, N, blk)`` layout
for reduce_scatter and alltoall, a barrier token added to each rank's
first element), timed at a latency-regime payload (``small_us``: 256
f32 elements per rank, 30 calls a batch) and a bandwidth-regime one
(``large_us``: 2**20 elements, 5 calls).  The estimator is the
reference's: one untimed warm-up call, then the best of 3 batches in
µs per call; on CUDA each batch is bracketed by
``torch.cuda.synchronize()``.

The 8 ranks are the rows of one tensor on ``cuda:0`` (``--cpu``: on the
CPU); without a card and without ``--cpu`` the tool raises.  It prints
one line ``ALGOS8 {json}`` with the reference's keys plus ``device``
(``n_devices`` counts the virtual ranks).  ``--check`` first holds every
entry's output on the device against the same entry on the CPU on
seeded random rows at both payloads — bit for bit, except ``psum`` and
``reduce_scatter_direct``, whose summation order is torch's own on each
device (``allclose``, rtol 1e-6 plus an atol of 1e-6 of the largest
input) — and prints ``ALGOS8_CHECK {json}`` before the ``ALGOS8`` line,
with each entry's largest error, the ring kernels' launches over the
whole run and ``ok``; a disagreement exits 1 before any timing.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ompi_tpu_torch.coll import base
from ompi_tpu_torch.mesh.mesh import resolve_device
from ompi_tpu_torch.op import SUM

N = 8

ALLREDUCE = {
    "psum": base.allreduce_psum,
    "ordered_linear": base.allreduce_ordered_linear,
    "ring": base.allreduce_ring,
    "ring_segmented": base.allreduce_ring_segmented,
    "recursive_doubling": base.allreduce_recursive_doubling,
    "rabenseifner": base.allreduce_rabenseifner,
}
ALLGATHER = {
    "direct": base.allgather_direct,
    "ring": base.allgather_ring,
    "bruck": base.allgather_bruck,
}
BCAST = {
    "direct": base.bcast_direct,
    "binomial": base.bcast_binomial,
    "pipeline": base.bcast_pipeline,
}
REDUCE = {
    "binomial": base.reduce_binomial,
    "ordered": base.reduce_ordered,
}
REDUCE_SCATTER = {
    "direct": base.reduce_scatter_direct,
    "ring": base.reduce_scatter_ring,
    "ordered": base.reduce_scatter_ordered,
}
ALLTOALL = {
    "direct": base.alltoall_direct,
    "pairwise": base.alltoall_pairwise,
}
BARRIER = {
    "allreduce": base.barrier_allreduce,
    "dissemination": base.barrier_dissemination,
}

#: family → (its table, whether it takes the (N, N, blk) layout, the
#: entry's call on the rank-major input)
FAMILIES = {
    "allreduce": (ALLREDUCE, False, lambda f, v: f(v, SUM)),
    "allgather": (ALLGATHER, False, lambda f, v: f(v)),
    "bcast": (BCAST, False, lambda f, v: f(v, 0)),
    "reduce": (REDUCE, False, lambda f, v: f(v, SUM, 0)),
    "reduce_scatter": (REDUCE_SCATTER, True, lambda f, v: f(v, SUM)),
    "alltoall": (ALLTOALL, True, lambda f, v: f(v)),
    "barrier": (BARRIER, False,
                lambda f, v: v[:, 0] + f(v.shape[0], v.device).to(v.dtype)),
}

#: entries whose reduction order is torch's own on each device
CLOSE_ONLY = {("allreduce", "psum"), ("reduce_scatter", "direct")}


def inputs(elems: int, fill=None, seed: int = 0):
    """The rows ``(N, elems)`` and blocks ``(N, N, max(1, elems // N))``
    of one regime as host arrays: ones (the timed inputs, as the
    reference's) or seeded standard-normal f32."""
    shapes = ((N, elems), (N, N, max(1, elems // N)))
    if fill is not None:
        return tuple(np.full(s, fill, np.float32) for s in shapes)
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s, dtype=np.float32) for s in shapes)


def entries(regime: str):
    """(family, name, call(x, xb)) of every entry timed in ``regime``
    (barriers carry no payload: small regime only)."""
    for family, (table, blocks, call) in FAMILIES.items():
        if family == "barrier" and regime != "small_us":
            continue
        for name, fn in table.items():
            yield family, name, (lambda x, xb, fn=fn, call=call, blocks=blocks:
                                 call(fn, xb if blocks else x))


def timed(fn, iters: int, sync) -> float:
    """µs per call: one untimed warm-up call, then the best of 3 batches."""
    fn()
    sync()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        best = min(best, (time.perf_counter() - t0) / iters)
    return best * 1e6


def check(device: torch.device, regimes) -> dict:
    """Every entry on ``device`` against the same entry on the CPU, on
    seeded random rows at each regime's payload."""
    cpu = torch.device("cpu")
    out = {}
    for seed, (regime, elems, _iters) in enumerate(regimes, start=1):
        x, xb = inputs(elems, seed=seed)
        host = (torch.from_numpy(x), torch.from_numpy(xb))
        dev = (host[0].to(device), host[1].to(device))
        for family, name, call in entries(regime):
            want = call(*host)
            got = call(*dev).to(cpu)
            err = float((got.double() - want.double()).abs().max())
            if (family, name) in CLOSE_ONLY:
                scale = float(np.abs(xb if FAMILIES[family][1] else x).max())
                ok = bool(torch.allclose(got, want, rtol=1e-6, atol=1e-6 * scale))
                rule = "allclose"
            else:
                ok = got.shape == want.shape and torch.equal(
                    got.view(torch.int32), want.view(torch.int32))
                rule = "bitwise"
            ent = out.setdefault(f"{family}/{name}", {"rule": rule, "ok": True})
            ent[f"{regime}_max_abs_err"] = err
            ent["ok"] = ent["ok"] and ok
    return out


def measure(device: torch.device, regimes) -> dict:
    sync = ((lambda: torch.cuda.synchronize(device)) if device.type == "cuda"
            else (lambda: None))
    out = {"n_devices": N, **{family: {} for family in FAMILIES}}
    for regime, elems, iters in regimes:
        x, xb = (torch.from_numpy(a).to(device) for a in inputs(elems, fill=1.0))
        for family, name, call in entries(regime):
            out[family].setdefault(name, {})[regime] = timed(
                lambda call=call: call(x, xb), iters, sync)
    out["device"] = str(device)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ompi_tpu_torch bench-algos",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the 8 ranks on the CPU (default: cuda:0)")
    ap.add_argument("--check", action="store_true",
                    help="first hold every entry against the CPU (ALGOS8_CHECK line)")
    ap.add_argument("--small", type=int, default=256,
                    help="f32 elements per rank of small_us (default: %(default)s)")
    ap.add_argument("--small-iters", type=int, default=30,
                    help="calls per small_us batch (default: %(default)s)")
    ap.add_argument("--large", type=int, default=1 << 20,
                    help="f32 elements per rank of large_us (default: %(default)s)")
    ap.add_argument("--large-iters", type=int, default=5,
                    help="calls per large_us batch (default: %(default)s)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    regimes = (("small_us", args.small, args.small_iters),
               ("large_us", args.large, args.large_iters))
    if not args.check:
        print("ALGOS8 " + json.dumps(measure(device, regimes)), flush=True)
        return 0
    from ompi_tpu_torch.coll import cuda_kernels as ck

    checked = check(device, regimes)
    ok = all(e["ok"] for e in checked.values())
    line = measure(device, regimes) if ok else None
    # the launches of the whole run: the check's and the timing's
    print("ALGOS8_CHECK " + json.dumps({"device": str(device), "entries": checked,
                                        "launches": dict(ck.LAUNCHES), "ok": ok}),
          flush=True)
    if not ok:
        return 1
    print("ALGOS8 " + json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The multi-process run on the card: the worker of ``chip_smoke.py``'s
``multiproc`` phase.

    python -m ompi_tpu_torch run -np 2 --nranks 4 [--mca btl tcp] \\
        ompi_tpu_torch/examples/multiproc_smoke.py [--max-bytes N] \\
        [--native] [--only stream|tcp-leg|plane-off]

Every process drives its K virtual ranks on the current CUDA device and
prints JSON lines prefixed ``MPJSON`` (tpurun forwards them with the
process's ``[p]`` prefix).  ``--device cpu`` with small ``--max-bytes``,
``--prod-bytes`` and ``--act`` rehearses the same run on the CPU (no
stream check, no kernel launches there).

* ``modules`` — no ``jax``/``ompi_tpu`` module was imported;
* ``stream`` — an ``iallreduce`` issued on a side stream right after a
  delayed write to its input returns the right values (han's worker
  thread waits for the caller's stream, ``wait()`` orders it back);
* ``colls`` — every collective given tensors on the device returns
  tensors there, bit-equal to the same call given numpy;
* ``osu`` — f32 SUM allreduce, 8 B … ``--max-bytes`` per rank in ×4
  steps plus the top size, tuned's default local leg: the host clock of
  each call (``comm.allreduce`` + ``synchronize``), correctness against
  float64 sums up to 16 MiB per rank, and the SHA-256 of rank 0's
  result bytes (the plane-on and plane-off jobs compare them);
* ``prod`` — 64 MiB per rank PROD with ``cuda_ring`` forced (enum 7):
  the ring-hop launches of the call, bit-equality to the plain ring
  (enum 2) and to a numpy model of the same bracket (each ring chunk c
  folds the local ranks c, c+1, … cyclically, then the two processes),
  and its digest;
* ``split`` — SUM calls of 8 B, 64 KiB, 4 MiB and 64 MiB per rank
  replayed leg by leg with han's own steps: with the DCN engine's device
  plane off, local leg, D2H of one row, DCN leg, H2D and broadcast; with
  it armed, local leg, DCN leg on the card's row, fill (then the whole
  call, for comparison);
* ``p2p`` — a 4096×4096 bf16 activation (32 MiB) sent from global rank
  K-1 to rank K (the pipeline-stage hand-off across the process
  boundary) for 20 rounds, each timed on the receiver from a barrier to
  the payload in its posted bf16 tensor on the card;
* ``ddp`` — 5 ``train_step_host`` steps of the seed-0 model, this
  process's replicas being rows [K·p, K·p+K) of ``entry()``'s;
* ``launches`` — this process's ring-hop kernel launches.

With ``--native`` (``chip_smoke.py``'s ``native`` phase, on the default
``btl/native``) the run skips ``stream``, ``colls`` and ``ddp`` and adds:

* ``engine`` — the engine and pml classes (``NativeDcnEngine`` and
  ``NativeMatchingEngine`` on the C plane) and the C engine's message
  counters over the run (which leg moved the bytes);
* ``win`` — a window of ``--prod-bytes`` f32 per rank on the device,
  three fence epochs in which each rank accumulates (SUM) into r+1 and
  gets r-1, bit-equal to the same float32 sums in numpy;
* ``causal`` — one call set (allreduce and bcast of 4 MiB per rank)
  with the causal tracer and the straggler profiler on: their counts,
  and the critical path the solver finds over both processes' records;
* ``device`` — whether the DCN engine's device plane is armed, and its
  counters over the run (``device_sends``, ``device_recvs``,
  ``device_bytes_placed``, ``device_dma_waits``, ``device_fallbacks``).

``--only plane-off`` (run with ``--mca dcn_device_enable 0``) is the
native run's comparison job: ``osu``, ``prod``, the ``--prod-bytes``
split, ``engine`` and ``device``.

``--only tcp-leg`` gives every process its own ``TDCN_HOST_ID``, which
puts same-host peers on the C engine's framed TCP leg (eager and RTS/CTS
rendezvous) in place of its shared-memory rings, and runs ``engine`` and
the ``--prod-bytes`` split only.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

SEED = 11
P2P_ROUNDS = 20
#: per-rank sizes split into legs below the PROD size (where the DCN
#: leg overtakes the local leg)
SPLIT_SIZES = [8, 64 << 10, 4 << 20]


def emit(kind: str, **obj) -> None:
    print("MPJSON " + json.dumps({"kind": kind, **obj}), flush=True)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def device_plane(w):
    """The DCN engine's device plane (None when it is off)."""
    return getattr(w.dcn._root_engine(), "_device_plane", None)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def rank_rows(ranks, count: int, dev: torch.device) -> torch.Tensor:
    """Rank r's f32 row is drawn from its own seed: any process can make
    any rank's data."""
    rows = []
    for r in ranks:
        g = torch.Generator(device=dev).manual_seed(SEED * 1000 + r)
        rows.append(torch.randn(count, generator=g, device=dev))
    return torch.stack(rows)


def stream_check(w) -> None:
    from ompi_tpu_torch.op import SUM

    k, n, count = w.local_size, w.size, 1 << 20
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        x = torch.zeros((k, count), device="cuda")
        torch.cuda._sleep(50_000_000)  # the write lands late on the caller's stream
        x += torch.arange(w.local_offset + 1, w.local_offset + k + 1, device="cuda",
                          dtype=torch.float32)[:, None]
        got = w.iallreduce(x, SUM).wait().clone()  # ordered on the side stream
    torch.cuda.synchronize()
    ok = bool((got == n * (n + 1) / 2).all())
    emit("stream", ok=ok)
    if not ok:
        raise SystemExit("iallreduce read its input before the caller's write")


def colls_check(w) -> None:
    """Tensor in, tensor out: every collective given tensors on the
    comm's device returns tensors there, bit-equal to the same call given
    numpy (which han stages through the same device)."""
    from ompi_tpu_torch.op import MAX, SUM

    k, lo, n, dev = w.local_size, w.local_offset, w.size, w.device
    rng = np.random.default_rng(SEED)
    X = rng.standard_normal((n, 6)).astype(np.float32)
    RS = rng.standard_normal((n, n, 2)).astype(np.float32)
    mine, rs = X[lo:lo + k], RS[lo:lo + k]
    calls = {
        "allreduce": (mine, lambda a: w.allreduce(a, SUM)),
        "bcast": (mine, lambda a: w.bcast(a, root=n - 1)),
        "reduce": (mine, lambda a: w.reduce(a, SUM, root=0)),
        "allgather": (mine, w.allgather),
        "gather": (mine, lambda a: w.gather(a, root=n - 1)),
        "scatter": (X, lambda a: w.scatter(a, root=0)),
        "alltoall": (rs, w.alltoall),
        "reduce_scatter_block": (rs, lambda a: w.reduce_scatter_block(a, SUM)),
        "scan": (mine, lambda a: w.scan(a, SUM)),
        "exscan": (mine, lambda a: w.exscan(a, SUM)),
        "iallreduce": (mine, lambda a: w.iallreduce(a, MAX).wait()),
    }
    failed = []
    for name, (a, fn) in calls.items():
        want = fn(a)
        got = fn(torch.from_numpy(a).to(dev))
        if want is None:
            ok = got is None
        else:
            ok = (isinstance(got, torch.Tensor) and got.device.type == dev.type
                  and got.cpu().numpy().tobytes() == np.ascontiguousarray(want).tobytes())
        if not ok:
            failed.append(name)
    emit("colls", ok=not failed, failed=failed)
    if failed:
        raise SystemExit(f"tensor collectives differ from the numpy calls: {failed}")


def osu(w, max_bytes: int) -> None:
    from ompi_tpu_torch.op import SUM

    k, lo, n, dev = w.local_size, w.local_offset, w.size, w.device
    sizes, b = [], 8
    while b <= max_bytes:
        sizes.append(b)
        b *= 4
    if sizes[-1] != max_bytes:
        sizes.append(max_bytes)
    for nbytes in sizes:
        count = max(1, nbytes // 4)
        x = rank_rows(range(lo, lo + k), count, dev)
        out = w.allreduce(x, SUM)
        sync(dev)
        ok = bool(torch.equal(out, out[:1].expand_as(out)))
        if nbytes <= 16 << 20:
            want = rank_rows(range(n), count, dev).double().sum(0)
            ok = ok and bool(torch.allclose(out[0].double(), want, rtol=1e-5, atol=1e-5))
        sha = digest(out[0])
        del out
        iters = 10 if nbytes <= 1 << 20 else 5 if nbytes <= 64 << 20 else 3
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            w.allreduce(x, SUM)
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        emit("osu", bytes=nbytes, times_ms=times, ok=ok, digest=sha)
        if not ok:
            raise SystemExit(f"allreduce wrong at {nbytes} B per rank")
        del x


def prod_check(w, ck, prod_bytes: int) -> None:
    from ompi_tpu_torch.core import mca
    from ompi_tpu_torch.op import PROD

    store = mca.default_context().store
    k, lo, n, dev = w.local_size, w.local_offset, w.size, w.device
    count = prod_bytes // 4
    # scaled near 1 so eight-way products neither overflow nor underflow
    x = 1 + 0.1 * rank_rows(range(lo, lo + k), count, dev)
    store.set("coll_cuda_allreduce_algorithm", 7)
    before = dict(ck.LAUNCHES)
    got = w.allreduce(x, PROD)
    sync(dev)
    per_call = {name: ck.LAUNCHES[name] - before[name] for name in ck.LAUNCHES}
    store.set("coll_cuda_allreduce_algorithm", 2)
    plain = w.allreduce(x, PROD)
    store.set("coll_cuda_allreduce_algorithm", 0)
    vs_plain = bool(torch.equal(bits(got), bits(plain)))
    del plain
    # the numpy model: ring chunk c of every process folds local ranks
    # c, c+1, ... (cyclically); then the processes fold (two factors:
    # the order within a product of two is immaterial)
    allx = (1 + 0.1 * rank_rows(range(n), count, dev)).cpu().numpy()
    chunk = count // k
    procs = []
    for p in range(w.nprocs):
        rows = allx[p * k:(p + 1) * k]
        acc = np.empty(count, np.float32)
        for c in range(k):
            sl = slice(c * chunk, (c + 1) * chunk)
            a = rows[c, sl].copy()
            for j in range(1, k):
                a = a * rows[(c + j) % k, sl]
            acc[sl] = a
        procs.append(acc)
    model = procs[0]
    for acc in procs[1:]:
        model = model * acc
    vs_numpy = bool(np.array_equal(got[0].cpu().numpy().view(np.uint32),
                                   model.view(np.uint32)))
    emit("prod", bytes=prod_bytes, per_call=per_call, bitwise_vs_plain=vs_plain,
         bitwise_vs_numpy=vs_numpy, digest=digest(got[0]))
    want = k - 1 if dev.type == "cuda" else 0  # the CPU runs the plain twins
    if per_call != {**dict.fromkeys(ck.LAUNCHES, 0), "ring_hop": want, "ring_hop_fold": want} \
            or not (vs_plain and vs_numpy):
        raise SystemExit(f"64 MiB PROD check failed: {per_call} {vs_plain} {vs_numpy}")


def split_call(w, nbytes: int) -> None:
    """han's allreduce, replayed leg by leg with its own steps: with the
    device plane armed the DCN leg takes the card's row (no D2H, no H2D)."""
    from ompi_tpu_torch.coll.han import host_op, to_device, to_host
    from ompi_tpu_torch.dcn.device import as_tensor
    from ompi_tpu_torch.op import SUM

    k, lo, dev = w.local_size, w.local_offset, w.device
    x = rank_rows(range(lo, lo + k), nbytes // 4, dev)
    plane = device_plane(w) is not None
    keys = (("local_ms", "dcn_ms", "fill_ms", "call_ms") if plane else
            ("local_ms", "d2h_ms", "dcn_ms", "h2d_bcast_ms", "call_ms"))
    parts = {key: [] for key in keys}
    for i in range(6):
        sync(dev)
        stamps = [time.perf_counter()]
        local = w.local.allreduce(x, SUM)
        sync(dev)
        stamps.append(time.perf_counter())
        if plane:
            red = w.dcn.allreduce(local[0].contiguous(), SUM, w.cid)  # han's own stream
            sync(dev)
            stamps.append(time.perf_counter())
            out = as_tensor(red, x[0]).expand(x.shape).clone()
        else:
            row = to_host(local[0])
            stamps.append(time.perf_counter())
            red = w.dcn.allreduce(row, host_op(SUM, x.dtype), w.cid)
            stamps.append(time.perf_counter())
            out = to_device(red, x.dtype, x.device).expand(x.shape).clone()
        sync(dev)
        stamps.append(time.perf_counter())
        w.allreduce(x, SUM)
        sync(dev)
        stamps.append(time.perf_counter())
        if i:  # the first round is a warm-up
            for key, a, b in zip(keys, stamps, stamps[1:]):
                parts[key].append((b - a) * 1e3)
        del local, out
    emit("split", bytes=nbytes, plane=plane, **parts)


def device_stats(w) -> None:
    dp = device_plane(w)
    keys = ("device_sends", "device_recvs", "device_bytes_placed", "device_dma_waits",
            "device_fallbacks")
    emit("device", armed=dp is not None,
         stats={k: dp.stats[k] for k in keys} if dp is not None else None)


def p2p(w, side: int) -> None:
    """A round starts when both processes leave a barrier and ends when
    the payload sits in the receiver's posted bf16 tensor on the card:
    the sender's D2H, the transport (rendezvous above the eager limit)
    and the receiver's H2D."""
    k, lo, dev = w.local_size, w.local_offset, w.device
    src, dst = k - 1, k  # the last rank of process 0 → the first of process 1
    g = torch.Generator(device=dev).manual_seed(SEED)
    act = torch.randn((side, side), generator=g, device=dev).to(torch.bfloat16)
    buf = torch.empty((side, side), device=dev, dtype=torch.bfloat16)
    times, exact = [], True
    for i in range(P2P_ROUNDS):
        buf.zero_()
        sync(dev)
        w.barrier()
        t0 = time.perf_counter()
        if lo <= src < lo + k:
            w.send(act, src, dst, tag=100 + i)
        elif lo <= dst < lo + k:
            got, st = w.recv(dst, src, tag=100 + i, out=buf)
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            exact = exact and got is buf and got.device == dev and st.source == src \
                and bool(torch.equal(bits(got), bits(act)))
    w.barrier()
    emit("p2p", dtype="bfloat16", bytes=side * side * 2, role="recv" if times else "send",
         times_ms=times, bitwise=exact)
    if not exact:
        raise SystemExit("the activation did not arrive bit for bit")


def engine_check(w, want_native: bool, stats0: dict | None) -> None:
    """The engine and pml classes, and the C engine's message counters
    over the run (eager/chunked/rendezvous/streamed: which leg moved the
    bytes)."""
    eng, pml = type(w.dcn).__name__, type(w.pml).__name__
    native = eng == "NativeDcnEngine" and pml == "NativeMatchingEngine"
    stats = w.dcn.stats_snapshot() if native else None
    moved = {k: stats[k] - (stats0 or {}).get(k, 0)
             for k in ("eager_msgs", "chunked_msgs", "rndv_msgs", "stream_msgs",
                       "eager_bytes", "chunked_bytes", "rndv_bytes", "stream_bytes")
             } if stats else {}
    emit("engine", engine=eng, pml=pml, native=native, moved=moved)
    if want_native and not native:
        raise SystemExit(f"not on the native plane: {eng}/{pml}")


def win_epoch(w, nbytes: int, rounds: int = 3) -> None:
    """Fence epochs in a window on the device across the processes: each
    rank accumulates its own data into r+1 and gets r-1; memory and gets
    are held bit for bit against float32 sums in numpy."""
    from ompi_tpu_torch.op import SUM

    k, lo, n, dev = w.local_size, w.local_offset, w.size, w.device
    count = nbytes // 4
    init = rank_rows(range(lo, lo + k), count, dev)
    win = w.win_create([init[l].clone() for l in range(k)])
    data = rank_rows(range(n + lo, n + lo + k), count, dev)  # seeds n.. : not the inits
    times, exact = [], True
    mine = init.cpu().numpy()
    left = rank_rows([(r - 1) % n for r in range(lo, lo + k)], count, dev).cpu().numpy()
    add_mine = rank_rows([n + (r - 1) % n for r in range(lo, lo + k)], count, dev).cpu().numpy()
    add_left = rank_rows([n + (r - 2) % n for r in range(lo, lo + k)], count, dev).cpu().numpy()
    for _ in range(rounds):
        sync(dev)
        w.barrier()
        t0 = time.perf_counter()
        for l in range(k):
            win.accumulate((lo + l + 1) % n, data[l], 0, SUM)
        win.fence()
        got = [win.get((lo + l - 1) % n, count) for l in range(k)]
        win.fence()
        times.append((time.perf_counter() - t0) * 1e3)
        mine = mine + add_mine     # what rank r holds: init_r + data_{r-1} per epoch
        left = left + add_left     # what rank r-1 holds
        exact = exact and all(np.array_equal(got[l].view(np.uint32), left[l].view(np.uint32))
                              for l in range(k))
    sync(dev)
    held = np.stack([win.memory(lo + l).cpu().numpy() for l in range(k)])
    exact = exact and np.array_equal(held.view(np.uint32), mine.view(np.uint32))
    win.free()
    emit("win", bytes=nbytes, rounds=rounds, times_ms=times, bitwise=bool(exact),
         on_device=win.memory(lo).device.type == dev.type)
    if not exact:
        raise SystemExit("window epoch differs from the numpy sums")


def causal_check(w) -> None:
    """One call set with the causal tracer and the straggler profiler on;
    process 0 solves the critical path over both processes' records."""
    from ompi_tpu_torch.metrics import straggler
    from ompi_tpu_torch.op import SUM
    from ompi_tpu_torch.trace import causal

    k, lo, dev = w.local_size, w.local_offset, w.device
    x = rank_rows(range(lo, lo + k), (4 << 20) // 4, dev)
    causal.enable(True)
    straggler.enable(True)
    for _ in range(5):
        w.allreduce(x, SUM)
        w.bcast(x, root=0)
    sync(dev)
    causal.enable(False)
    straggler.enable(False)
    records = w.dcn.allgather_obj(causal.recent(), "smoke.causal")
    prof = causal.profile_from_records(dict(enumerate(records)))
    strag = {op: {"count": st["count"], "wait_ns": st["wait_ns"]}
             for op, st in straggler.summary().items()}
    top = prof["top"][0] if prof["top"] else {}
    emit("causal", counters=causal.counters_snapshot(), straggler=strag,
         instances=prof["instances"], dominant=prof["dominant"],
         makespan_ns=top.get("makespan_ns", 0),
         path_len=len(top.get("path") or []))


def ddp(w) -> None:
    from ompi_tpu_torch.entry import entry
    from ompi_tpu_torch.examples.ddp_training import ReplicatedMLP, train_step_host

    k, lo, n = w.local_size, w.local_offset, w.size
    _, (full, x, y) = entry(device=w.device, nranks=n)
    model = ReplicatedMLP({name: p.detach()[lo:lo + k].clone()
                           for name, p in full.named_parameters()})
    losses = [train_step_host(w, model, x[lo:lo + k], y[lo:lo + k]).tolist()
              for _ in range(5)]
    same = all(torch.equal(p, p[:1].expand_as(p)) for p in model.parameters())
    emit("ddp", losses=losses, replicas_identical=same)
    if not same:
        raise SystemExit("DDP replicas diverged")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-bytes", type=int, default=256 << 20,
                    help="largest per-rank osu_allreduce size")
    ap.add_argument("--prod-bytes", type=int, default=64 << 20,
                    help="per-rank bytes of the PROD check and the split call")
    ap.add_argument("--act", type=int, default=4096, help="activation rows = columns")
    ap.add_argument("--only", choices=["stream", "tcp-leg", "plane-off"], default=None)
    ap.add_argument("--native", action="store_true",
                    help="the native phase's sections (see the module docstring)")
    args = ap.parse_args()
    if args.only == "tcp-leg":  # one host id per process: the C engine's TCP leg
        from ompi_tpu_torch.boot.proc import ENV_PROC

        os.environ["TDCN_HOST_ID"] = f"smoke-host-{os.environ[ENV_PROC]}"
    import ompi_tpu_torch.api as api
    from ompi_tpu_torch.coll import cuda_kernels as ck

    w = api.init(device=args.device)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ompi_tpu"))
    emit("modules", proc=w.proc, forbidden=bad)
    if bad:
        raise SystemExit(f"forbidden modules imported: {bad}")
    ck.reset_launches()
    stats0 = w.dcn.stats_snapshot() if hasattr(w.dcn, "stats_snapshot") else None
    if args.only == "tcp-leg":
        split_call(w, args.prod_bytes)
        engine_check(w, True, stats0)
    elif args.only == "plane-off":
        osu(w, args.max_bytes)
        prod_check(w, ck, args.prod_bytes)
        split_call(w, args.prod_bytes)
        engine_check(w, True, stats0)
        device_stats(w)
    elif args.native:
        osu(w, args.max_bytes)
        prod_check(w, ck, args.prod_bytes)
        for nbytes in [b for b in SPLIT_SIZES if b < args.prod_bytes] + [args.prod_bytes]:
            split_call(w, nbytes)
        p2p(w, args.act)
        win_epoch(w, args.prod_bytes)
        causal_check(w)
        engine_check(w, True, stats0)
        device_stats(w)
    else:
        if w.device.type == "cuda":
            stream_check(w)
        if args.only is None:
            colls_check(w)
            osu(w, args.max_bytes)
            prod_check(w, ck, args.prod_bytes)
            for nbytes in [b for b in SPLIT_SIZES if b < args.prod_bytes] + [args.prod_bytes]:
                split_call(w, nbytes)
            p2p(w, args.act)
            ddp(w)
    emit("launches", **ck.LAUNCHES)
    api.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())

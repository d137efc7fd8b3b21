#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``ompi_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--max-bytes N]

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. environment — build the ring-hop kernels from ``ompi_tpu_torch/csrc``
   with nvcc and time the build; the card, torch and CUDA versions;
2. kernels — ``ring_hop`` and ``ring_hop_fold`` against their plain torch
   twins, bit for bit, over every supported op × dtype, n ∈ {2, 3, 8},
   chunk lengths 1, odd, misaligned and aligned, with inputs spanning
   1e-3…1e3 plus denormals, ±0 and NaN;
3. main path — ``init(device="cuda", nranks=8)`` with the ``cuda_ring``
   algorithms forced through the MCA store, then ``osu_allreduce`` (f32
   SUM, 8 B … 1 GiB per rank): every size bit-equal to the plain ring
   (enum 2), ``allclose`` to float64 sums up to 16 MiB, and exactly
   (n-1) fold + (n-1) hop launches per call; at 1 MiB allgather and
   reduce_scatter against the plain rings, SUM/MAX/MIN/PROD × f32/bf16/
   int32, and the reproducible mode against the host fold; a
   ``torch.profiler`` breakdown of one call at 1 MiB and 1 GiB (device
   time by kernel, the device's busy share); then the dry run of the
   whole collective surface;
4. tuned — a fresh ``init(device="cuda", nranks=8)`` with no algorithm
   var pinned and tracing on: ``coll/tuned`` serves the device slots; f32
   PROD at 4 KiB, 4 MiB, 64 MiB and 256 MiB per rank decides (from the
   ``tuned_decision`` trace instants) recursive doubling, Rabenseifner,
   ``cuda_ring`` and ``cuda_ring``; each ``cuda_ring`` call takes exactly
   (n-1) + (n-1) kernel launches and is bit-equal to the forced plain
   ring; SUM at 64 MiB decides ``psum`` with no launch; p50 of the
   default call beside forced ``ring_segmented`` (what tuned picks where
   no kernel runs) at 64 and 256 MiB.  Its Chrome trace goes to
   ``chiprun_out/trace.json`` and is checked for api, coll and request
   lanes, ``tuned`` coll spans and a ``cuda_ring`` decision;
5. observability — p50 (and host µs per call) of an 8 B and a 1 MiB SUM
   allreduce (``cuda_ring`` forced) with every hook off and with tracing,
   metrics and SPC on; the 8 B unpinned p50 under tuned beside ``--mca
   coll ^tuned`` (each pair in three rounds of a, b, b, a); SPC's
   ``allreduce`` count against the calls made; ``allreduce_init`` on the
   world and a ``dup`` hitting the schedule cache, bit-equal to the
   blocking call;
6. DDP — ``entry()`` for 5 fused steps: loss falls, replicas stay
   bitwise identical.

Before the last line it prints the card's name and power limit
(``nvidia-smi``) and one ``{"kernels": [...]}`` line, whose launches are
those of the main path and the tuned phase; the last line is
``{"ok": true, "device": {...}}``.  The sweep's rows also go to
``chiprun_out/chip_smoke.json``.  It imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
#: H100 SXM device-memory rate, bytes/s (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores, FLOP/s
F32_FLOPS = 67e12
N = 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def launched(ck, before) -> dict:
    return {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}


def event_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times of ``fn`` (ms)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bits(t):
    import torch

    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


# -- phase 1 ----------------------------------------------------------------


def phase_env(ck):
    import torch

    t0 = time.perf_counter()
    lib = ck.build()
    build_s = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    regs = [ln.strip() for ln in ck.build_log.splitlines() if "registers" in ln]
    emit({"phase": "env", "build_s": build_s, "library": lib.name,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability()),
          "kernel_available": ck.kernel_available(), "ptxas_registers": regs[:4]})
    if not ck.kernel_available():
        raise SystemExit("the card is not compute capability 9.0")
    return smi


# -- phase 2 ----------------------------------------------------------------


def make_input(numel, m, dtype, gen, dev):
    """``numel`` values of ``dtype`` laid out as rows of ``m``: floats
    across 1e-3…1e3 of both signs, with NaN, ±0 and ±denormal on the same
    columns of every row, cycling by row (so pairs like +0/-0, NaN/0 and
    NaN/NaN meet in the fold); integers over their full range."""
    import torch

    if dtype.is_floating_point:
        mag = 10.0 ** (torch.rand(numel, generator=gen, device=dev,
                                  dtype=torch.float64) * 6 - 3)
        sign = torch.where(torch.rand(numel, generator=gen, device=dev) < 0.5, -1.0, 1.0)
        x = (mag * sign).to(dtype)
        tiny = torch.finfo(dtype).tiny / 4  # a denormal of the dtype
        specials = torch.tensor([float("nan"), 0.0, -0.0, tiny, -tiny],
                                dtype=dtype, device=dev)
        pos = torch.arange(numel, device=dev)
        col = pos % m
        hit = col % max(1, m // 5) == 0
        x[hit] = specials[((pos // m + col) % 5)[hit]]
        return x
    carrier, b = {torch.int32: (torch.int32, 31), torch.uint32: (torch.int32, 31),
                  torch.int64: (torch.int64, 62), torch.uint64: (torch.int64, 62)}[dtype]
    x = torch.randint(-(1 << b), 1 << b, (numel,), generator=gen, device=dev,
                      dtype=torch.int64).to(carrier)
    return x.view(dtype)


def phase_kernels(ck, ops):
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    hop_cases = fold_cases = 0
    failures = []
    dtypes = list(ck._FOLD_DTYPES)
    for n in (2, 3, N):
        tbl = ck._index_table(n, dev)
        for m in (1, 7, 1003, 4096):
            for misalign in (0, 1):
                for dtype in dtypes + [torch.uint8, torch.complex64]:
                    # hop: out of place with random indices, and in place
                    # with the allgather step's indices
                    numel = n * n * m
                    if dtype in ck._FOLD_DTYPES:
                        src = make_input(numel + 1, m, dtype, gen, dev)
                    else:  # the hop is a byte copy: any bits will do
                        src = torch.randint(0, 256, ((numel + 1) * dtype.itemsize,),
                                            generator=gen, device=dev,
                                            dtype=torch.uint8).view(dtype)
                    src = src[misalign: misalign + numel].view(n, n, m)
                    si = torch.randint(0, n, (n,), generator=gen, device=dev,
                                       dtype=torch.int32)
                    di = torch.randint(0, n, (n,), generator=gen, device=dev,
                                       dtype=torch.int32)
                    dk, dp = torch.zeros_like(src), torch.zeros_like(src)
                    ck.ring_hop(src, si, dk, di)
                    ck.ring_hop_plain(src, si, dp, di)
                    ik, ip = src.clone(), src.clone()
                    ck.ring_hop(ik, tbl[1 % n], ik, tbl[0])
                    ck.ring_hop_plain(ip, tbl[1 % n], ip, tbl[0])
                    torch.cuda.synchronize()
                    hop_cases += 2
                    if not (torch.equal(bits(dk), bits(dp)) and torch.equal(bits(ik), bits(ip))):
                        failures.append(("ring_hop", n, m, misalign, str(dtype)))
                    if dtype not in ck._FOLD_DTYPES:
                        continue
                    for op in ops:
                        for recv_first in (False, True):
                            s = 1 % n
                            ri, sent = tbl[(-s - 1) % n], tbl[(-s) % n]
                            fk, fp = src.clone(), src.clone()
                            ck.ring_hop_fold(fk, ri, fk, sent, fk, ri, op, recv_first)
                            ck.ring_hop_fold_plain(fp, ri, fp, sent, fp, ri, op, recv_first)
                            ok_ = torch.empty((n, 1, m), dtype=dtype, device=dev)
                            op_ = torch.empty_like(ok_)
                            ck.ring_hop_fold(src, si, src, di, ok_, tbl[n], op, recv_first)
                            ck.ring_hop_fold_plain(src, si, src, di, op_, tbl[n], op, recv_first)
                            torch.cuda.synchronize()
                            fold_cases += 2
                            if not (torch.equal(bits(fk), bits(fp))
                                    and torch.equal(bits(ok_), bits(op_))):
                                bad = (bits(fk) != bits(fp)).view(-1).nonzero()[:1]
                                at = int(bad[0]) if len(bad) else -1
                                failures.append((
                                    "ring_hop_fold", op.name, n, m, misalign,
                                    str(dtype), recv_first, at,
                                    bits(fk).view(-1)[at].item() if at >= 0 else None,
                                    bits(fp).view(-1)[at].item() if at >= 0 else None))
    emit({"phase": "kernels", "hop_cases": hop_cases, "fold_cases": fold_cases,
          "failures": failures[:20], "n_failures": len(failures)})
    if failures:
        for f in failures[:20]:
            print("MISMATCH", f, file=sys.stderr)
        raise SystemExit(f"{len(failures)} kernel/plain mismatches")


# -- phase 3 ----------------------------------------------------------------


def profile_allreduce(world, nbytes, gen):
    """Device time of one cuda_ring allreduce by kernel (torch.profiler),
    beside its CUDA-event latency: the device's busy share of a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ompi_tpu_torch.op import SUM

    x = torch.randn((N, nbytes // 4), generator=gen, device="cuda")
    reps = 10 if nbytes <= (64 << 20) else 3
    p50 = event_ms(lambda: world.allreduce(x, SUM), reps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            world.allreduce(x, SUM)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = re.sub(r"^void |\(anonymous namespace\)::", "", e.key)
            name = name.split("(")[0].split("<")[0].split("::")[-1].strip()[:60]
            kernels[name] = kernels.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    device_ms = sum(kernels.values()) if kernels else None
    row = {"phase": "profile", "bytes": nbytes, "p50_ms": p50, "device_ms": device_ms,
           "device_busy_share": device_ms / p50 if device_ms is not None else None,
           "kernels_ms": kernels}
    emit(row)
    del x
    torch.cuda.empty_cache()
    return row


def phase_main(ck, max_bytes):
    import numpy as np
    import torch

    import ompi_tpu_torch.api as api
    from ompi_tpu_torch.core import mca
    from ompi_tpu_torch.entry import dryrun
    from ompi_tpu_torch.op import MAX, MIN, PROD, SUM, ordered_reduce_np

    world = api.init(device="cuda", nranks=N)
    store = mca.default_context().store
    store.set("coll_cuda_allreduce_algorithm", 7)
    store.set("coll_cuda_allgather_algorithm", 4)
    store.set("coll_cuda_reduce_scatter_algorithm", 4)

    def with_algo(var, algo, fn):
        prev = store.get(var)
        store.set(var, algo)
        try:
            return fn()
        finally:
            store.set(var, prev)

    def plain_allreduce(x, op=SUM):
        return with_algo("coll_cuda_allreduce_algorithm", 2, lambda: world.allreduce(x, op))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    sizes = []
    b = 8
    while b <= max_bytes:
        sizes.append(b)
        b *= 4
    if max_bytes >= (1 << 30) and sizes[-1] != (1 << 30):
        sizes.append(1 << 30)
    ck.reset_launches()  # the main path's launches are counted from here
    rows = []
    for nbytes in sizes:
        count = max(1, nbytes // 4)
        x = torch.randn((N, count), generator=gen, device="cuda", dtype=torch.float32)
        before = dict(ck.LAUNCHES)
        out = world.allreduce(x, SUM)
        torch.cuda.synchronize()
        per_call = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
        if per_call != {"ring_hop": N - 1, "ring_hop_fold": N - 1}:
            raise SystemExit(f"launches per allreduce at {nbytes} B: {per_call}")
        ref = plain_allreduce(x)
        if not torch.equal(bits(out), bits(ref)):
            raise SystemExit(f"cuda_ring != plain ring at {nbytes} B")
        close = None
        if nbytes <= 16 << 20:
            x64 = x.double().cpu().numpy().sum(0)
            close = bool(np.allclose(out.cpu().numpy(), x64[None], rtol=1e-5, atol=1e-6))
            if not close:
                raise SystemExit(f"allreduce not close to float64 sums at {nbytes} B")
        del ref
        iters = 20 if nbytes <= (64 << 20) else 5
        ms = event_ms(lambda: world.allreduce(x, SUM), iters)
        plain_ms = with_algo("coll_cuda_allreduce_algorithm", 2,
                             lambda: event_ms(lambda: world.allreduce(x, SUM), iters))
        library_ms = event_ms(
            lambda: x.sum(0, keepdim=True).expand_as(x).contiguous(), iters)
        t = ms / 1e3
        rows.append({"bytes": nbytes, "p50_ms": ms, "algbw_GBs": nbytes / t / 1e9,
                     "busbw_GBs": 2 * (N - 1) / N * nbytes / t / 1e9,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bitwise_vs_plain": True, "allclose_f64": close})
        emit({"phase": "osu_allreduce", **rows[-1]})
        del x, out
        torch.cuda.empty_cache()

    profiles = [profile_allreduce(world, b, gen) for b in (1 << 20, 1 << 30)
                if b <= max_bytes]

    # 1 MiB per rank: the other ring collectives, the op x dtype grid and
    # the reproducible mode
    count = (1 << 20) // 4
    blocks = torch.randn((N, N, count // N), generator=gen, device="cuda")
    ag = world.allgather(blocks[:, 0])
    ag_ref = with_algo("coll_cuda_allgather_algorithm", 2,
                       lambda: world.allgather(blocks[:, 0]))
    rs = world.reduce_scatter_block(blocks, SUM)
    rs_ref = with_algo("coll_cuda_reduce_scatter_algorithm", 2,
                       lambda: world.reduce_scatter_block(blocks, SUM))
    grid = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        if dtype.is_floating_point:
            x = torch.randn((N, count), generator=gen, device="cuda").to(dtype)
        else:
            x = torch.randint(-1000, 1000, (N, count), generator=gen, device="cuda",
                              dtype=torch.int32)
        for op in (SUM, MAX, MIN, PROD):
            grid[f"{op.name}:{str(dtype)[6:]}"] = torch.equal(
                bits(world.allreduce(x, op)), bits(plain_allreduce(x, op)))
    xh = np.random.RandomState(7).randn(N, count).astype(np.float32)
    repro = with_algo("coll_cuda_reproducible", True, lambda: world.allreduce(xh, SUM))
    golden = ordered_reduce_np(xh, SUM)
    repro_ok = all(np.array_equal(repro[r].view(np.uint8), golden.view(np.uint8))
                   for r in range(N))
    checks = {"allgather_vs_ring": torch.equal(ag, ag_ref),
              "reduce_scatter_vs_ring": torch.equal(rs, rs_ref),
              "op_dtype_grid": grid, "reproducible_vs_host_fold": repro_ok}
    dryrun(N, "cuda")
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)  # the main path's run ends here
    emit({"phase": "main_checks", **checks, "launches": launches})
    if not (checks["allgather_vs_ring"] and checks["reduce_scatter_vs_ring"]
            and all(grid.values()) and repro_ok):
        raise SystemExit(f"main-path checks failed: {checks}")
    if min(launches.values()) == 0:
        raise SystemExit(f"a kernel of the main path never launched: {launches}")
    return rows, profiles, launches


def kernel_rows(ck, launches):
    """Each kernel at the 1 GiB allreduce's chunk shape: its time, its
    plain twin's, one library call's, and the bound."""
    import torch

    from ompi_tpu_torch.op import SUM

    dev = torch.device("cuda")
    m = (1 << 30) // 4 // N  # f32 elements in one chunk of a 1 GiB/rank ring
    chunks = torch.randn((N, N, m), device=dev)
    tbl = ck._index_table(N, dev)
    chunk_bytes = m * 4
    out = []

    hk, hp = chunks.clone(), chunks.clone()
    ck.ring_hop(hk, tbl[1], hk, tbl[0])
    ck.ring_hop_plain(hp, tbl[1], hp, tbl[0])
    hop_err = (hk - hp).abs().max().item()
    del hk, hp
    src_rows = chunks[:, 0]
    hop_ms = event_ms(lambda: ck.ring_hop(chunks, tbl[1], chunks, tbl[0]), 10)
    hop_plain = event_ms(lambda: ck.ring_hop_plain(chunks, tbl[1], chunks, tbl[0]), 5)
    roll_ms = event_ms(lambda: torch.roll(src_rows, 1, 0), 10)
    hop_bytes = 2 * N * chunk_bytes
    out.append({"name": "ring_hop", "route": "cuda",
                "source": "ompi_tpu_torch/csrc/ring_hop.cu",
                "replaces": "ompi_tpu/coll/pallas_kernels.py:95",
                "launches": launches["ring_hop"], "max_abs_err": hop_err,
                "ms": hop_ms, "plain_ms": hop_plain,
                "bound_ms": hop_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "library_ms": roll_ms, "shape": [N, N, m], "dtype": "float32"})

    ri, sent = tbl[N - 1], tbl[0]
    fk, fp = chunks.clone(), chunks.clone()
    ck.ring_hop_fold(fk, ri, fk, sent, fk, ri, SUM)
    ck.ring_hop_fold_plain(fp, ri, fp, sent, fp, ri, SUM)
    fold_err = (fk - fp).abs().max().item()
    del fk, fp
    fold_ms = event_ms(lambda: ck.ring_hop_fold(chunks, ri, chunks, sent, chunks, ri, SUM), 10)
    fold_plain = event_ms(
        lambda: ck.ring_hop_fold_plain(chunks, ri, chunks, sent, chunks, ri, SUM), 5)
    fold_bytes = 3 * N * chunk_bytes
    bound = max(fold_bytes / HBM_BYTES_PER_S, N * m / F32_FLOPS) * 1e3
    out.append({"name": "ring_hop_fold", "route": "cuda",
                "source": "ompi_tpu_torch/csrc/ring_hop.cu",
                "replaces": "ompi_tpu/coll/pallas_kernels.py:95",
                "launches": launches["ring_hop_fold"], "max_abs_err": fold_err,
                "ms": fold_ms, "plain_ms": fold_plain, "bound_ms": bound,
                "bound_by": "bytes", "library_ms": None, "shape": [N, N, m],
                "dtype": "float32", "op": "MPI_SUM"})
    return out


# -- phase 4 ----------------------------------------------------------------

#: per-rank bytes of the tuned phase's PROD calls, with the decision the
#: shipped thresholds (large 1 MiB, huge 64 MiB) give on an sm_90 card
TUNED_SIZES = ((4 << 10, "recursive_doubling"), (4 << 20, "rabenseifner"),
               (64 << 20, "cuda_ring"), (256 << 20, "cuda_ring"))
#: per-rank bytes of the persistent-plan check
PERSIST_BYTES = 64 << 20


def phase_tuned(ck, outdir):
    """The default decision layer on the card, unpinned, traced."""
    import torch

    import ompi_tpu_torch.api as api
    from ompi_tpu_torch.coll.cuda import ALLREDUCE_ALGOS
    from ompi_tpu_torch.core import mca
    from ompi_tpu_torch.op import PROD, SUM
    from ompi_tpu_torch.trace import core as trace

    api.finalize()
    trace.reset()
    world = api.init({"trace_enable": "1", "trace_output": str(outdir / "trace")},
                     device="cuda", nranks=N)
    store = mca.default_context().store
    pinned = {v.full_name: v.value for v in store.all_vars()
              if v.full_name.startswith("coll_cuda_") and v.full_name.endswith("_algorithm")
              and v.value != 0}
    if world.coll.providers["allreduce"] != "tuned" or pinned:
        raise SystemExit(f"tuned is not the default: {world.coll.providers['allreduce']}, "
                         f"pinned {pinned}")

    def forced(algo, fn):
        store.set("coll_cuda_allreduce_algorithm", algo)
        try:
            return fn()
        finally:
            store.set("coll_cuda_allreduce_algorithm", 0)

    def decided(fn):
        start = trace.event_count()
        out = fn()
        torch.cuda.synchronize()
        return out, [e[7]["algorithm"] for e in trace.events()[start:]
                     if e[4] == "tuned_decision"]

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    ck.reset_launches()  # the tuned path's launches are counted from here
    rows = []
    for nbytes, want in TUNED_SIZES:
        x = 1 + 1e-3 * torch.randn((N, nbytes // 4), generator=gen, device="cuda")
        before = dict(ck.LAUNCHES)
        out, dec = decided(lambda: world.allreduce(x, PROD))
        per_call = launched(ck, before)
        kernel = want == "cuda_ring"
        expect = ({"ring_hop": N - 1, "ring_hop_fold": N - 1} if kernel
                  else {"ring_hop": 0, "ring_hop_fold": 0})
        ring = forced(ALLREDUCE_ALGOS["ring"], lambda: world.allreduce(x, PROD))
        row = {"bytes": nbytes, "op": "MPI_PROD", "decision": dec, "launches": per_call,
               "finite": bool(torch.isfinite(out).all()),
               "bitwise_vs_plain_ring": torch.equal(bits(out), bits(ring)),
               "max_rel_vs_plain_ring": ((out - ring).abs() / ring.abs()).max().item()}
        if dec != [want] or per_call != expect or not row["finite"] \
                or (kernel and not row["bitwise_vs_plain_ring"]) \
                or row["max_rel_vs_plain_ring"] > 1e-5:
            raise SystemExit(f"tuned at {nbytes} B: {row}, expected {want}, {expect}")
        if kernel:
            iters = 10 if nbytes == TUNED_SIZES[2][0] else 5
            default = lambda: world.allreduce(x, PROD)  # noqa: E731
            seg = lambda: forced(  # noqa: E731
                ALLREDUCE_ALGOS["ring_segmented"],
                lambda: event_ms(lambda: world.allreduce(x, PROD), 3, warmup=1))
            # in turns on one card: default, segmented, segmented, default
            ms = [event_ms(default, iters)]
            seg_ms = [seg(), seg()]
            ms.append(event_ms(default, iters))
            row.update(p50_ms=ms, ring_segmented_p50_ms=seg_ms,
                       speedup=min(seg_ms) / max(ms))
        rows.append(row)
        emit({"phase": "tuned_size", **row})
        del x, out, ring
        torch.cuda.empty_cache()
    x = torch.randn((N, TUNED_SIZES[2][0] // 4), generator=gen, device="cuda")
    before = dict(ck.LAUNCHES)
    _, dec = decided(lambda: world.allreduce(x, SUM))
    sum_row = {"bytes": TUNED_SIZES[2][0], "op": "MPI_SUM", "decision": dec,
               "launches": launched(ck, before)}
    if dec != ["psum"] or any(sum_row["launches"].values()):
        raise SystemExit(f"tuned SUM: {sum_row}")
    del x
    small = torch.randn((N, 1024), generator=gen, device="cuda")
    world.iallreduce(small, PROD).wait()  # the request lane
    world.barrier()  # a table-path call: the coll lane, provider tuned
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)  # the tuned path's run ends here
    api.finalize()
    trace.enable(False)
    path = outdir / "trace.json"
    (outdir / "trace.0.json").replace(path)
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    lanes = {e["args"]["name"] for e in evs if e["ph"] == "M" and e["name"] == "thread_name"}
    coll_providers = {e["args"].get("provider") for e in evs
                      if e["ph"] == "X" and e["cat"] == "coll"}
    ring_decisions = [e for e in evs if e["ph"] == "i" and e["name"] == "tuned_decision"
                      and e["args"]["algorithm"] == "cuda_ring"]
    trace_ok = ({"api", "coll", "request"} <= lanes and "tuned" in coll_providers
                and bool(ring_decisions))
    summary = {"phase": "tuned", "provider": "tuned", "sizes": [
        {k: r[k] for k in ("bytes", "decision", "launches", "bitwise_vs_plain_ring",
                           "p50_ms", "ring_segmented_p50_ms", "speedup") if k in r}
        for r in rows], "sum": sum_row, "launches": launches,
        "trace": {"path": "chiprun_out/trace.json", "lanes": sorted(lanes),
                  "coll_providers": sorted(p for p in coll_providers if p),
                  "cuda_ring_decisions": len(ring_decisions),
                  "events": len(evs), "dropped": doc["otherData"]["dropped_events"]}}
    emit(summary)
    if not trace_ok:
        raise SystemExit(f"trace.json lacks lanes, tuned spans or a cuda_ring decision: "
                         f"{summary['trace']}")
    return summary


# -- phase 5 ----------------------------------------------------------------


def phase_observability(ck):
    """The host cost of the hooks and of the decision layer, in turns."""
    import torch

    import ompi_tpu_torch.api as api
    from ompi_tpu_torch.coll import sched
    from ompi_tpu_torch.op import PROD, SUM
    from ompi_tpu_torch.tool import spc

    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    xs = {b: torch.randn((N, b // 4), generator=gen, device="cuda") for b in (8, 1 << 20)}
    ring = {"coll_cuda_allreduce_algorithm": "7"}
    hooks_on = dict(ring, trace_enable="1", metrics_enable="1", runtime_spc_attach="all")
    iters = 200

    def p50s(params, sizes):
        """CUDA-event p50 per size, and the host's µs per call over a
        loop of ``iters`` calls (the dispatch cost these calls are bound
        by); SPC's allreduce count against the calls made."""
        api.finalize()
        spc.attach(False)
        world = api.init(params, device="cuda", nranks=N)
        spc.clear()
        calls = 0
        out = {}
        for b in sizes:
            out[b] = event_ms(lambda: world.allreduce(xs[b], SUM), iters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                world.allreduce(xs[b], SUM)
            torch.cuda.synchronize()
            out[f"host_us_{b}"] = (time.perf_counter() - t0) / iters * 1e6
            calls += 2 * iters + 2
        out["spc_allreduce"] = spc.get("allreduce")
        out["calls"] = calls
        return out

    def in_turns(a, b, rounds=3):
        """(a, b, b, a) repeated: each side's runs, in the order made."""
        runs = {a[0]: [], b[0]: []}
        for _ in range(rounds):
            for name, fn in (a, b, b, a):
                runs[name].append(fn())
        return runs

    hooks = in_turns(("off", lambda: p50s(ring, (8, 1 << 20))),
                     ("on", lambda: p50s(hooks_on, (8, 1 << 20))))
    spc_ok = all(r["spc_allreduce"] == r["calls"] for r in hooks["on"])
    # the decision layer on the host-bound path: unpinned SUM (tuned → psum)
    # against coll/cuda alone (auto → psum)
    dec = in_turns(("tuned", lambda: p50s({}, (8,))),
                   ("no_tuned", lambda: p50s({"coll": "^tuned"}, (8,))))
    spc.attach(False)
    # persistent plans: world and a dup of it share one cached schedule
    api.finalize()
    world = api.init(device="cuda", nranks=N)
    x = 1 + 1e-3 * torch.randn((N, PERSIST_BYTES // 4), generator=gen, device="cuda")
    h0 = sched.CACHE.stats()
    before = dict(ck.LAUNCHES)
    p1 = world.allreduce_init(x, PROD).start().wait()
    p2 = world.dup().allreduce_init(x, PROD).start().wait()
    blocking = world.allreduce(x, PROD)
    torch.cuda.synchronize()
    h1 = sched.CACHE.stats()
    sched_row = {"hits": h1["sched_cache_hits"] - h0["sched_cache_hits"],
                 "misses": h1["sched_cache_misses"] - h0["sched_cache_misses"],
                 "bitwise_vs_blocking": torch.equal(bits(p1), bits(blocking))
                 and torch.equal(bits(p2), bits(blocking)),
                 "launches": launched(ck, before)}
    api.finalize()

    def pick(runs, key):
        return [r[key] for r in runs]

    row = {"phase": "observability", "iters": iters,
           "cuda_ring_8B_off_ms": pick(hooks["off"], 8),
           "cuda_ring_8B_on_ms": pick(hooks["on"], 8),
           "cuda_ring_1MiB_off_ms": pick(hooks["off"], 1 << 20),
           "cuda_ring_1MiB_on_ms": pick(hooks["on"], 1 << 20),
           "cuda_ring_8B_off_host_us": pick(hooks["off"], "host_us_8"),
           "cuda_ring_8B_on_host_us": pick(hooks["on"], "host_us_8"),
           "spc_allreduce_vs_calls": [(r["spc_allreduce"], r["calls"])
                                      for r in hooks["on"]],
           "unpinned_8B_tuned_ms": pick(dec["tuned"], 8),
           "unpinned_8B_no_tuned_ms": pick(dec["no_tuned"], 8),
           "unpinned_8B_tuned_host_us": pick(dec["tuned"], "host_us_8"),
           "unpinned_8B_no_tuned_host_us": pick(dec["no_tuned"], "host_us_8"),
           "sched": sched_row}
    emit(row)
    if not spc_ok:
        raise SystemExit(f"SPC allreduce count != calls made: {row['spc_allreduce_vs_calls']}")
    if sched_row["hits"] < 1 or not sched_row["bitwise_vs_blocking"]:
        raise SystemExit(f"persistent schedule cache: {sched_row}")
    return row


# -- phase 6 ----------------------------------------------------------------


def phase_ddp():
    import torch

    from ompi_tpu_torch.entry import entry

    step, (model, x, y) = entry(device="cuda")
    losses = [step(model, x, y).mean().item() for _ in range(5)]
    identical = all(torch.equal(bits(p), bits(p[:1].expand_as(p)))
                    for p in model.parameters())
    emit({"phase": "ddp", "losses": losses, "replicas_identical": identical})
    if not (losses[-1] < losses[0] and all(v == v for v in losses)):
        raise SystemExit(f"DDP loss did not fall: {losses}")
    if not identical:
        raise SystemExit("DDP replicas diverged")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--max-bytes", type=int, default=1 << 30,
                    help="largest per-rank osu_allreduce size (default 1 GiB)")
    args = ap.parse_args()
    if not (REPO / "ompi_tpu_torch" / "csrc" / "ring_hop.cu").is_file():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(ompi_tpu_torch/ not found)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from ompi_tpu_torch.coll import cuda_kernels as ck
    from ompi_tpu_torch.op import MAX, MIN, PROD, SUM

    outdir = REPO / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    smi = phase_env(ck)
    phase_kernels(ck, (SUM, PROD, MAX, MIN))
    rows, profiles, launches = phase_main(ck, args.max_bytes)
    tuned = phase_tuned(ck, outdir)
    observability = phase_observability(ck)
    launches = {k: launches[k] + tuned["launches"][k] for k in launches}
    kernels = kernel_rows(ck, launches)
    phase_ddp()
    (outdir / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "osu_allreduce": rows, "profiles": profiles,
         "tuned": tuned, "observability": observability,
         "kernels": kernels}, indent=1))
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

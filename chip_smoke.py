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
   bitwise identical;
7. p2p — 8 ranks each ``sendrecv`` a 4096×4096 bf16 activation (32 MiB,
   a pipeline-stage boundary) to r+1 for 20 rounds: every payload
   bit-equal and on the card; a scripted wildcard/non-overtaking
   sequence; one 8-partition ``psend_init``/``precv_init`` round; p50
   per round beside the copy bound and host µs per 8 B send+recv pair;
8. osc — ``win_allocate`` of 16 Mi f32 per rank on the card; fence
   epochs where each rank accumulates (SUM) 64 MiB into r+1 and gets
   r-1, bit-equal to the same sums in plain torch; 1000
   ``fetch_and_op`` on one counter under ``lock_all`` and a
   ``compare_and_swap``; p50 per epoch beside its byte bound, host µs
   per ``fetch_and_op``;
9. ddt — ``allreduce_ddt`` MPI_PROD over a vector datatype packing
   64 MiB per rank from CUDA buffers: packed and stacked on the card,
   tuned's ``cuda_ring`` with exactly 7 + 7 launches, bit-equal to the
   plain ring forced; pack and unpack of a CUDA tensor bit-equal to the
   numpy convertor;
10. io — ``checkpoint.save`` of an (8, 8388608) f32 tensor (256 MiB)
    from the card through ``write_at_all`` and ``restore`` onto the
    card, bit-equal; one ``save_async``; one collective write/read
    through a strided file view; write/read MB/s (bound by the disk).

Before the last line it prints the card's name and power limit
(``nvidia-smi``) and one ``{"kernels": [...]}`` line, whose launches are
those of the main path, the tuned phase and the ddt phase; the last
line is ``{"ok": true, "device": {...}}``.  The sweep's rows also go to
``chiprun_out/chip_smoke.json``.  It imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
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


# -- phase 7 ----------------------------------------------------------------

#: one pipeline-stage activation: 4096 tokens at hidden 4096, bf16
ACT_ROWS = ACT_COLS = 4096
P2P_ROUNDS = 20


def phase_p2p(smi):
    """Point-to-point on the card: a pipeline exchange, matching rules,
    a partitioned round and the host cost of a small message."""
    import torch

    import ompi_tpu_torch.api as api

    api.finalize()
    world = api.init(device="cuda", nranks=N)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    acts = torch.randn((N, ACT_ROWS, ACT_COLS), generator=gen, device="cuda").to(torch.bfloat16)

    def round_trip():
        # one controller drives every rank: the last rank's send goes
        # first, so each sendrecv finds its left neighbour's message
        world.send(acts[N - 1], N - 1, 0, tag=3)
        got = [world.sendrecv(acts[r], r, r + 1, (r - 1) % N, 3, 3) for r in range(N - 1)]
        got.append(world.recv(N - 1, N - 2, 3))
        return got

    def exact(got):
        return all(p.device.type == "cuda" and st.source == (r - 1) % N
                   and st.nbytes == ACT_ROWS * ACT_COLS * 2
                   and torch.equal(bits(p), bits(acts[(r - 1) % N]))
                   for r, (p, st) in enumerate(got))

    first_ok = exact(round_trip())
    times = []
    for i in range(P2P_ROUNDS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        got = round_trip()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    last_ok = exact(got)
    del got
    times.sort()
    # matching: wildcards and non-overtaking on card payloads
    for i in range(4):
        world.send(torch.full((2,), i, device="cuda"), 1 + i % 2, 6, tag=i % 2)
    seq = [world.recv(6, None, 1), world.recv(6, 2, None), world.recv(6), world.recv(6)]
    matching = [(p.tolist(), st.source, st.tag) for p, st in seq]
    matching_ok = matching == [([1.0, 1.0], 2, 1), ([3.0, 3.0], 2, 1),
                               ([0.0, 0.0], 1, 0), ([2.0, 2.0], 1, 0)]
    # partitioned: 8 partitions of 512 rows, readied out of order
    ps = world.psend_init(acts[0], partitions=8, source=0, dest=5, tag=11)
    pr = world.precv_init(partitions=8, dest=5, source=0, tag=11)
    pr.start()
    ps.start()
    early = []
    for part in (3, 0, 7, 1, 6, 2, 4):
        ps.pready(part)
        early.append(pr.parrived(part))
    ps.pready(5)
    part_ok = (not any(early) and torch.equal(bits(pr.wait()), bits(acts[0]))
               and pr.status.source == 0 and pr.parrived(5))
    # the host cost of an 8-byte message, send + recv, on the card
    small = torch.zeros(2, device="cuda")
    pairs = 1000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(pairs):
        world.send(small, 0, 1)
        world.recv(1, 0)
    host_us = (time.perf_counter() - t0) / pairs * 1e6
    bound_ms = 2 * N * ACT_ROWS * ACT_COLS * 2 / HBM_BYTES_PER_S * 1e3
    row = {"phase": "p2p", "nvidia_smi": smi, "rounds": P2P_ROUNDS,
           "round_p50_ms": times[len(times) // 2], "round_min_ms": times[0],
           "round_max_ms": times[-1], "copy_bound_ms": bound_ms,
           "bound_share": bound_ms / times[len(times) // 2],
           "bitwise_first_round": first_ok, "bitwise_last_round": last_ok,
           "matching": matching, "matching_ok": matching_ok, "partitioned_ok": part_ok,
           "host_us_per_8B_pair": host_us}
    emit(row)
    api.finalize()
    del acts
    torch.cuda.empty_cache()
    if not (first_ok and last_ok and matching_ok and part_ok):
        raise SystemExit(f"p2p checks failed: {row}")
    return row


# -- phase 8 ----------------------------------------------------------------

#: f32 elements per rank of the window (64 MiB)
WIN_ELEMS = 16 * 1024 * 1024
OSC_EPOCHS = 10
FOPS = 1000


def phase_osc(smi):
    """RMA on the card: fence epochs of 64 MiB accumulates and gets, a
    counter under lock_all, compare-and-swap."""
    import torch

    import ompi_tpu_torch.api as api
    from ompi_tpu_torch.op import SUM

    api.finalize()
    world = api.init(device="cuda", nranks=N)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    win = world.win_allocate(WIN_ELEMS, torch.float32)
    mem = win.device_view()
    on_card = mem.device.type == "cuda" and mem.data_ptr() == win.memory(0).data_ptr()
    init = torch.randn((N, WIN_ELEMS), generator=gen, device="cuda")
    data = torch.randn((N, WIN_ELEMS), generator=gen, device="cuda")

    def epoch():
        win.fence()
        gets = []
        for r in range(N):
            win.accumulate(r, (r + 1) % N, data[r], op=SUM)
            gets.append(win.get(r, (r - 1) % N, WIN_ELEMS))
        win.fence()
        return gets

    mem.copy_(init)
    gets = [g.wait() for g in epoch()]
    # the same sums in plain torch, in the issue order
    want = init.clone()
    want_gets = []
    for r in range(N):
        want[(r + 1) % N] = want[(r + 1) % N] + data[r]
        want_gets.append(want[(r - 1) % N].clone())
    epoch_ok = torch.equal(bits(mem), bits(want)) and all(
        torch.equal(bits(g), bits(w)) for g, w in zip(gets, want_gets))
    del gets, want_gets, want
    times = []
    for _ in range(OSC_EPOCHS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        epoch()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    win.fence(16)  # MODE_NOSUCCEED: close the fence epochs
    # a shared counter: fetch_and_op SUM from every rank under lock_all
    mem[0, 0] = 0.0
    for r in range(N):
        win.lock_all(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [win.fetch_and_op(i % N, 0, 1.0, 0, SUM) for i in range(FOPS)]
    for r in range(N):
        win.unlock_all(r)
    fetched = torch.cat([q.wait() for q in reqs])
    torch.cuda.synchronize()
    fop_us = (time.perf_counter() - t0) / FOPS * 1e6
    counter = float(mem[0, 0])
    # each unlock_all applies its origin's ops in issue order, origin by
    # origin: op i fetches the count of the ops applied before it
    order = sorted(range(FOPS), key=lambda i: (i % N, i))
    want = torch.empty(FOPS, dtype=torch.float32)
    want[torch.tensor(order)] = torch.arange(FOPS, dtype=torch.float32)
    fop_ok = counter == FOPS and torch.equal(fetched.cpu(), want)
    win.lock(2, 0)
    hit = win.compare_and_swap(2, 0, -5.0, float(FOPS))
    miss = win.compare_and_swap(2, 0, 7.0, 123.0)
    win.unlock(2, 0)
    cas_ok = float(hit.wait()) == FOPS and float(miss.wait()) == -5.0 and float(mem[0, 0]) == -5.0
    nbytes = WIN_ELEMS * 4
    bound_ms = N * 5 * nbytes / HBM_BYTES_PER_S * 1e3  # acc 3 passes + get 2, per rank
    row = {"phase": "osc", "nvidia_smi": smi, "window_bytes_per_rank": nbytes,
           "window_on_card": on_card, "epoch_bitwise": epoch_ok, "epochs": OSC_EPOCHS,
           "epoch_p50_ms": times[len(times) // 2], "epoch_min_ms": times[0],
           "epoch_max_ms": times[-1], "epoch_bound_ms": bound_ms,
           "bound_share": bound_ms / times[len(times) // 2],
           "fetch_and_op": FOPS, "counter": counter, "fop_ok": fop_ok,
           "host_us_per_fetch_and_op": fop_us, "cas_ok": cas_ok}
    emit(row)
    win.free()
    api.finalize()
    del win, mem, init, data, fetched
    torch.cuda.empty_cache()
    if not (on_card and epoch_ok and fop_ok and cas_ok):
        raise SystemExit(f"osc checks failed: {row}")
    return row


# -- phase 9 ----------------------------------------------------------------


def phase_ddt(ck, smi):
    """A typed allreduce on the default path: packed on the card, tuned's
    cuda_ring, against the plain ring; the convertor against numpy."""
    import numpy as np
    import torch

    import ompi_tpu_torch.api as api
    from ompi_tpu_torch.core import mca
    from ompi_tpu_torch.ddt import FLOAT, pack, unpack
    from ompi_tpu_torch.op import PROD

    api.finalize()
    world = api.init(device="cuda", nranks=N)
    store = mca.default_context().store
    vec = FLOAT.create_vector(1024, 4, 5).commit()  # 16 KiB of data per element
    count = (64 << 20) // vec.size  # 64 MiB packed per rank
    nfloat = (vec.lb + vec.span(count)) // 4
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    bufs = [1 + 1e-3 * torch.randn(nfloat, generator=gen, device="cuda") for _ in range(N)]
    torch.cuda.synchronize()
    ck.reset_launches()  # the ddt path's launches are counted from here
    t0 = time.perf_counter()
    out = world.allreduce_ddt(bufs, count, vec, PROD)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)  # the ddt path's run ends here
    store.set("coll_cuda_allreduce_algorithm", 2)
    try:
        ref = world.allreduce_ddt(bufs, count, vec, PROD)
    finally:
        store.set("coll_cuda_allreduce_algorithm", 0)
    ring_ok = out.device.type == "cuda" and out.shape == (N, count * 4096) \
        and torch.equal(bits(out), bits(ref))
    del ref
    # the convertor on the card against the numpy convertor
    host = bufs[3].cpu().numpy()
    packed, host_packed = pack(bufs[3], vec, count), pack(host, vec, count)
    pack_ok = packed.device.type == "cuda" and np.array_equal(packed.cpu().numpy(), host_packed)
    recv = torch.zeros_like(bufs[3])
    unpack(recv, vec, count, packed)
    host_recv = np.zeros_like(host)
    unpack(host_recv, vec, count, host_packed)
    unpack_ok = recv.device.type == "cuda" and np.array_equal(
        recv.cpu().numpy().view(np.uint32), host_recv.view(np.uint32))
    # unpacked into receive buffers on the card
    recvbufs = [torch.zeros_like(b) for b in bufs]
    world.allreduce_ddt(bufs, count, vec, PROD, recvbufs=recvbufs)
    back = pack(recvbufs[5], vec, count).view(torch.float32)
    recv_ok = torch.equal(bits(back), bits(out[5]))
    torch.cuda.synchronize()
    row = {"phase": "ddt", "nvidia_smi": smi, "datatype": "vector(1024, 4, 5) of MPI_FLOAT",
           "count": count, "packed_bytes_per_rank": count * vec.size,
           "buffer_bytes_per_rank": nfloat * 4, "launches": launches,
           "call_s": call_s, "bitwise_vs_plain_ring": ring_ok, "pack_vs_numpy": pack_ok,
           "unpack_vs_numpy": unpack_ok, "recvbufs_ok": recv_ok}
    emit(row)
    api.finalize()
    del bufs, out, packed, recv, recvbufs, back
    torch.cuda.empty_cache()
    if launches != {"ring_hop": N - 1, "ring_hop_fold": N - 1}:
        raise SystemExit(f"ddt allreduce launches: {launches}")
    if not (ring_ok and pack_ok and unpack_ok and recv_ok):
        raise SystemExit(f"ddt checks failed: {row}")
    return row


# -- phase 10 ---------------------------------------------------------------

CKPT_ELEMS = 8388608  # f32 per rank: 32 MiB, 256 MiB in all


def phase_io(smi):
    """Checkpoint and MPI-IO from the card; the numbers are the disk's."""
    import numpy as np
    import torch

    import ompi_tpu_torch.api as api
    from ompi_tpu_torch.ddt import DOUBLE
    from ompi_tpu_torch.io import MODE_CREATE, MODE_RDWR, checkpoint

    api.finalize()
    world = api.init(device="cuda", nranks=N)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    x = torch.randn((N, CKPT_ELEMS), generator=gen, device="cuda")
    workdir = REPO / "build" / "chip_smoke_io"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        path = str(workdir / "ckpt.bin")
        nbytes = x.numel() * 4
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save(world, path, x, {"step": 1})
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, manifest = checkpoint.restore(world, path)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        restore_ok = back.device.type == "cuda" and torch.equal(bits(back), bits(x)) \
            and manifest["dtype"] == "float32" and manifest["step"] == 1
        del back
        # asynchronous: the tensor is overwritten as soon as save returns
        snap = x[:, :1024].clone()
        apath = str(workdir / "async.bin")
        t0 = time.perf_counter()
        req = checkpoint.save_async(world, apath, x)
        return_s = time.perf_counter() - t0
        x.zero_()
        req.wait()
        back, _ = checkpoint.restore(world, apath)
        async_ok = torch.equal(bits(back[:, :1024]), bits(snap)) and not bool((back == 0).all())
        del back
        # a collective write and read through a strided (cyclic) view
        per = 1 << 16  # doubles per rank
        vals = torch.randn((N, per), generator=gen, device="cuda", dtype=torch.float64)
        f = world.file_open(str(workdir / "view.bin"), MODE_CREATE | MODE_RDWR)
        cyclic = DOUBLE.create_resized(0, N * DOUBLE.extent).commit()
        for r in range(N):
            f.set_view(r, r * DOUBLE.extent, DOUBLE, cyclic)
        counts = f.write_at_all([0] * N, [vals[r] for r in range(N)])
        reads = f.read_at_all([0] * N, [per] * N, np.float64)
        f.close()
        raw = np.fromfile(workdir / "view.bin", np.float64).reshape(per, N).T
        host = vals.cpu().numpy()
        view_ok = counts == [per] * N and np.array_equal(raw, host) and all(
            np.array_equal(reads[r], host[r]) for r in range(N))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    row = {"phase": "io", "nvidia_smi": smi, "checkpoint_bytes": nbytes,
           "write_s": write_s, "write_MBs": nbytes / write_s / 1e6,
           "read_s": read_s, "read_MBs": nbytes / read_s / 1e6,
           "bound_by": "the disk (write includes fsync); not a device rate",
           "restore_bitwise": restore_ok, "save_async_return_s": return_s,
           "save_async_ok": async_ok, "strided_view_ok": view_ok}
    emit(row)
    api.finalize()
    del x, vals
    torch.cuda.empty_cache()
    if not (restore_ok and async_ok and view_ok):
        raise SystemExit(f"io checks failed: {row}")
    return row


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
    p2p = phase_p2p(smi)
    osc = phase_osc(smi)
    ddt = phase_ddt(ck, smi)
    io = phase_io(smi)
    launches = {k: launches[k] + tuned["launches"][k] + ddt["launches"][k] for k in launches}
    kernels = kernel_rows(ck, launches)
    phase_ddp()
    (outdir / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "osu_allreduce": rows, "profiles": profiles,
         "tuned": tuned, "observability": observability, "p2p": p2p, "osc": osc,
         "ddt": ddt, "io": io, "kernels": kernels}, indent=1))
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

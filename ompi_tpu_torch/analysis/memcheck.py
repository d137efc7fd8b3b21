"""The ring-hop kernels under ``compute-sanitizer`` memcheck.

The child program (run on a card)::

    python -m ompi_tpu_torch.analysis.memcheck [--json PATH]

launches ``ring_hop`` and ``ring_hop_fold`` (``csrc/ring_hop.cu``) on
``(8, 8, m)`` tensors, in place and out of place:

* ``ring_hop`` at chunk lengths and base offsets (views into a larger
  buffer) that make ``ompi_ring_hop`` pick each of its five load widths
  — 16, 8, 4, 2 and 1 bytes, the largest that divides both pointers and
  the chunk's byte count;
* ``ring_hop_fold`` over each of its 8 dtypes and 4 ops;
* one 8-rank ``ring_allreduce``, ``ring_allgather`` and
  ``ring_reduce_scatter`` at a size that does not split into 8 equal
  chunks (the padded path).

Every result is held bit for bit against the plain twins
(``ring_hop_plain``, ``ring_hop_fold_plain``, the rings' interpret
rung).  It prints one ``MEMCHECK {json}`` line (cases, widths, launches,
``bitwise``) and exits 1 on any mismatch.

:func:`run_leg` is the ``cuda-memcheck`` leg of the sanitize pass: the
child under ``compute-sanitizer --tool memcheck --kernel-name
kns=ring_hop`` with ``PYTORCH_NO_CUDA_MEMORY_CACHING=1`` — with the
caching allocator on, an overrun lands inside a pooled block and is not
reported.  The child's summary goes to :data:`SUMMARY`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from ompi_tpu_torch.native import BUILD_DIR

N = 8
#: (chunk bytes, base offset in bytes) of the hop cases, with the load
#: width ``ompi_ring_hop`` picks for them (the buffers themselves are
#: 256-byte aligned)
HOP_CASES = ((4096, 0), (4104, 0), (4100, 0), (4098, 0), (4097, 0),
             (4096, 8), (4096, 4), (4096, 2), (4096, 1))
FOLD_M = 1031
RING_SIZE = N * 1021 + 3

#: where the leg's child writes its summary
SUMMARY = BUILD_DIR / "san-cuda-memcheck" / "memcheck.json"


def load_width(*ptrs_and_bytes: int) -> int:
    """The load width (bytes) ``ompi_ring_hop`` picks: the largest of
    16, 8, 4, 2 that divides every pointer and the chunk's byte count,
    else 1 — the dispatch of ``ring_hop.cu``."""
    align = 0
    for v in ptrs_and_bytes:
        align |= v
    return next(w for w in (16, 8, 4, 2, 1) if align % w == 0)


def _view(nbytes: int, off: int, dev):
    """An (8, 8, nbytes) uint8 tensor starting ``off`` bytes into an
    allocation that ends where the view does."""
    import torch

    buf = torch.empty(off + N * N * nbytes, dtype=torch.uint8, device=dev)
    return buf[off:].view(N, N, nbytes)


def _fill(t, gen) -> None:
    import torch

    t.copy_(torch.randint(0, 256, t.shape, generator=gen, dtype=torch.uint8))


def _hop_cases(ck, tbl, gen, dev) -> tuple[list, set]:
    import torch

    rows, widths = [], set()
    src_idx, dst_idx = tbl[0], tbl[N - 1]
    for nbytes, off in HOP_CASES:
        for in_place in (False, True):
            src = _view(nbytes, off, dev)
            _fill(src, gen)
            dst = src if in_place else _view(nbytes, off, dev)
            if not in_place:
                _fill(dst, gen)
            width = load_width(src.data_ptr(), dst.data_ptr(), nbytes)
            want_src, want_dst = src.clone(), dst.clone()
            ck.ring_hop_plain(want_src, src_idx,
                              want_src if in_place else want_dst, dst_idx)
            ck.ring_hop(src, src_idx, dst, dst_idx)
            torch.cuda.synchronize()
            want = want_src if in_place else want_dst
            ok = bool(torch.equal(dst, want))
            widths.add(width)
            rows.append({"kernel": "ring_hop", "chunk_bytes": nbytes,
                         "offset": off, "in_place": in_place,
                         "width": width, "bitwise": ok})
    return rows, widths


def _fold_input(shape, dtype, gen, dev):
    import torch

    if dtype.is_floating_point:
        x = torch.rand(shape, generator=gen, dtype=torch.float64) * 1.5 + 0.5
        return x.to(dtype).to(dev)
    x = torch.randint(1, 100, shape, generator=gen, dtype=torch.int64)
    return x.to(dtype).to(dev)


def _bits(t):
    import torch

    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _fold_cases(ck, tbl, gen, dev) -> list:
    import torch

    rows = []
    shape = (N, N, FOLD_M)
    ri, sent = tbl[N - 1], tbl[0]   # the allreduce schedule's first step
    for dtype in ck._FOLD_DTYPES:
        for op in ck._FOLD_OPS:
            for in_place in (False, True):
                a = _fold_input(shape, dtype, gen, dev)
                if in_place:
                    b, d = a, a
                else:
                    b = _fold_input(shape, dtype, gen, dev)
                    d = _fold_input(shape, dtype, gen, dev)
                wa, wb, wd = a.clone(), b.clone(), d.clone()
                if in_place:
                    wb, wd = wa, wa
                ck.ring_hop_fold_plain(wa, ri, wb, sent, wd, ri, op)
                ck.ring_hop_fold(a, ri, b, sent, d, ri, op)
                torch.cuda.synchronize()
                rows.append({"kernel": "ring_hop_fold", "dtype": str(dtype),
                             "op": op.name, "in_place": in_place,
                             "bitwise": bool(torch.equal(_bits(d), _bits(wd)))})
    return rows


def _ring_cases(ck, gen, dev) -> list:
    import torch

    from ompi_tpu_torch.op import SUM

    x = _fold_input((N, RING_SIZE), torch.float32, gen, dev)
    xs = _fold_input((N, N, RING_SIZE), torch.float32, gen, dev)
    rows = []
    for name, fn, args in (
            ("ring_allreduce", ck.ring_allreduce, (x, SUM)),
            ("ring_allgather", ck.ring_allgather, (x,)),
            ("ring_reduce_scatter", ck.ring_reduce_scatter, (xs, SUM))):
        got = fn(*args, _mode="cuda")
        want = fn(*args, _mode="interpret")
        torch.cuda.synchronize()
        rows.append({"kernel": name, "size": RING_SIZE,
                     "bitwise": bool(torch.equal(_bits(got), _bits(want)))})
    return rows


def drive() -> dict:
    """Run every case on ``cuda:0``; the summary dict."""
    import torch

    from ompi_tpu_torch.coll import cuda_kernels as ck

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(20261017)
    tbl = ck._index_table(N, dev)
    ck.reset_launches()
    hops, widths = _hop_cases(ck, tbl, gen, dev)
    folds = _fold_cases(ck, tbl, gen, dev)
    rings = _ring_cases(ck, gen, dev)
    cases = hops + folds + rings
    return {"cases": len(cases), "widths": sorted(widths),
            "fold_pairs": len({(r["dtype"], r["op"]) for r in folds}),
            "launches": dict(ck.LAUNCHES),
            "bitwise": all(r["bitwise"] for r in cases),
            "mismatches": [r for r in cases if not r["bitwise"]][:8],
            "device": torch.cuda.get_device_name(0)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="ring-hop kernels memcheck child")
    ap.add_argument("--json", metavar="PATH", help="also write the summary here")
    args = ap.parse_args(argv)
    summary = drive()
    if args.json:
        Path(args.json).write_text(json.dumps(summary))
    print("MEMCHECK " + json.dumps(summary), flush=True)
    return 0 if summary["bitwise"] and summary["widths"] == [1, 2, 4, 8, 16] else 1


def sanitizer() -> str | None:
    """The toolkit's ``compute-sanitizer``, or None."""
    for cand in (shutil.which("compute-sanitizer"),
                 "/usr/local/cuda/bin/compute-sanitizer"):
        if cand and os.path.exists(cand):
            return cand
    return None


def run_leg(root: Path, timeout: float) -> tuple[str, str]:
    """The child under compute-sanitizer memcheck: ``("ok" | "skip" |
    "error", detail)``.  A skip names its reason: no card, no tool, or
    the tool's own refusal of the device."""
    import torch

    if not torch.cuda.is_available():
        return "skip", "no CUDA device"
    tool = sanitizer()
    if tool is None:
        return "skip", ("the CUDA toolkit has no compute-sanitizer (looked on "
                        "PATH and in /usr/local/cuda/bin)")
    SUMMARY.parent.mkdir(parents=True, exist_ok=True)
    SUMMARY.unlink(missing_ok=True)
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(root), os.environ.get("PYTHONPATH")) if p))
    cmd = [tool, "--tool", "memcheck", "--error-exitcode", "1",
           "--kernel-name", "kns=ring_hop", sys.executable, "-m",
           "ompi_tpu_torch.analysis.memcheck", "--json", str(SUMMARY)]
    try:
        res = subprocess.run(cmd, cwd=str(root), env=env, timeout=timeout,
                             capture_output=True, text=True, errors="replace")
    except subprocess.TimeoutExpired:
        return "error", f"compute-sanitizer child timed out after {timeout}s"
    log = res.stdout + res.stderr
    refused = [ln.strip("= ").strip() for ln in log.splitlines()
               if "not supported" in ln and "Error" in ln]
    if refused:
        version = subprocess.run([tool, "--version"], capture_output=True,
                                 text=True).stdout.strip().splitlines()[-1:]
        return "skip", (f"{tool} ({' '.join(version)}) refuses the device: "
                        f"{refused[0]!r}")
    summary = [ln for ln in log.splitlines() if "ERROR SUMMARY" in ln]
    if res.returncode != 0 or not summary or " 0 errors" not in summary[-1]:
        return "error", f"rc={res.returncode}: {log[-1500:]}"
    mc = [ln for ln in res.stdout.splitlines() if ln.startswith("MEMCHECK ")]
    return "ok", f"{summary[-1].strip('= ').strip()}; {mc[-1][9:] if mc else ''}"


if __name__ == "__main__":
    sys.exit(main())

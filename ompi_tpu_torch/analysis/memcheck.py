"""The ring-hop kernels under ``compute-sanitizer`` memcheck.

The child program (run on a card)::

    python -m ompi_tpu_torch.analysis.memcheck [--json PATH]

launches ``ring_hop`` and ``ring_hop_fold`` (``csrc/ring_hop.cu``) on
``(8, 8, m)`` tensors, in place and out of place:

* ``ring_hop`` at chunk lengths and source and destination offsets
  (views into a larger buffer) chosen by the kernel's split rule, as
  ``cuda_kernels.hop_split`` mirrors it, so that the ranks' bodies move
  in each of the five word widths — 16, 8, 4, 2 and 1 bytes, the widest
  that a rank's two ends agree modulo — and some rank peels a head and
  some rank a tail, at each of the chunk lengths 4100, 4097, 4104 and
  4096;
* ``ring_hop_fold`` over each of its 8 dtypes and 4 ops;
* one 8-rank ``ring_allreduce``, ``ring_allgather`` and
  ``ring_reduce_scatter`` at a size that does not split into 8 equal
  chunks (the padded path);
* ``ring_hop_peer`` and ``ring_hop_wait`` (``csrc/ring_hop_peer.cu``)
  over 8 ranks that each own a buffer, all on this card: one hop at each
  of the hop cases' sizes and source offsets, with the destination at
  the same offset and at the case's, then the three shard rings at the
  padded size; the launches are held to one put and two waits per hop.

Every result is held bit for bit against the plain twins
(``ring_hop_plain``, ``ring_hop_fold_plain``, the rings' interpret
rung).  It prints one ``MEMCHECK {json}`` line (cases, widths, paths,
launches, ``bitwise``, ``peer_launches``) and exits 1 on any mismatch,
a path of the split not taken or a wrong peer launch count.

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
#: (chunk bytes, source offset, destination offset) to choose the hop
#: cases from, offsets in bytes into 256-byte aligned buffers; ragged
#: chunk lengths first (their ends are where an overrun would land)
HOP_CANDIDATES = tuple((nbytes, so, do) for nbytes in (4100, 4097, 4104, 4096)
                       for so in (0, 1, 2, 4, 8) for do in (so, 0))
#: every path of the hop's split: each body width, a peeled head, a tail
PATHS = frozenset({16, 8, 4, 2, 1, "head", "tail"})
FOLD_M = 1031
RING_SIZE = N * 1021 + 3

#: where the leg's child writes its summary
SUMMARY = BUILD_DIR / "san-cuda-memcheck" / "memcheck.json"


def rank_splits(src_addr: int, dst_addr: int, nbytes: int) -> list:
    """Each rank's ``(head, width, tail)`` in a hop of ``(N, N, nbytes)``
    byte tensors at these addresses, with the child's indices (rank r
    sends its chunk r into chunk r of row r+1): ``hop_split`` of the
    rank's two ends."""
    from ompi_tpu_torch.coll.cuda_kernels import hop_split

    return [hop_split(src_addr + (r * N + r) * nbytes,
                      dst_addr + ((r + 1) % N * N + r) * nbytes, nbytes)
            for r in range(N)]


def split_paths(splits) -> set:
    """The paths of :data:`PATHS` that the ranks of ``splits`` take."""
    paths = set()
    for head, w, tail in splits:
        paths |= {w} | ({"head"} if head else set()) | ({"tail"} if tail else set())
    return paths


def case_paths(nbytes: int, so: int, do: int) -> set:
    """The paths a hop case takes out of place and in place (the
    destination is the source) on 256-byte aligned buffers."""
    return (split_paths(rank_splits(so, 256 + do, nbytes))
            | split_paths(rank_splits(so, so, nbytes)))


def hop_cases() -> tuple:
    """The hop cases: from :data:`HOP_CANDIDATES` in order, each that
    takes a path no earlier case of its chunk length took, so that every
    length takes every path it can."""
    cases, seen = [], set()
    for case in HOP_CANDIDATES:
        new = {(path, case[0]) for path in case_paths(*case)} - seen
        if new:
            cases.append(case)
            seen |= new
    return tuple(cases)


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

    rows, paths = [], set()
    src_idx, dst_idx = tbl[0], tbl[N - 1]
    for nbytes, so, do in hop_cases():
        for in_place in (False, True):
            src = _view(nbytes, so, dev)
            _fill(src, gen)
            dst = src if in_place else _view(nbytes, do, dev)
            if not in_place:
                _fill(dst, gen)
            taken = split_paths(rank_splits(src.data_ptr(), dst.data_ptr(), nbytes))
            want_src, want_dst = src.clone(), dst.clone()
            ck.ring_hop_plain(want_src, src_idx,
                              want_src if in_place else want_dst, dst_idx)
            ck.ring_hop(src, src_idx, dst, dst_idx)
            torch.cuda.synchronize()
            want = want_src if in_place else want_dst
            ok = bool(torch.equal(dst, want))
            paths |= taken
            rows.append({"kernel": "ring_hop", "chunk_bytes": nbytes,
                         "offset": so, "dst_offset": dst.data_ptr() - src.data_ptr()
                         if in_place else do, "in_place": in_place,
                         "paths": sorted(map(str, taken)), "bitwise": ok})
    return rows, paths


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


def _peer_cases(ck, gen, dev) -> list:
    import torch

    from ompi_tpu_torch.op import SUM

    ring = ck.PeerRing([dev] * N)
    zero = [0] * N
    rows = []
    before = dict(ck.LAUNCHES)
    hops = 0
    for nbytes, off, case_dst_off in hop_cases():
        for dst_off in sorted({off, case_dst_off}):  # the ends agree, or disagree, modulo 16
            srcs = [_view(nbytes, off, dev)[0, 0] for _ in range(N)]
            dsts = [_view(nbytes, dst_off, dev)[0, 0] for _ in range(N)]
            for t in srcs + dsts:
                _fill(t, gen)
            want = [d.clone() for d in dsts]
            ck.ring_hop_peer_plain(srcs, zero, want, zero, nbytes)
            ck.ring_hop_peer(srcs, zero, dsts, zero, nbytes, ring)
            torch.cuda.synchronize()
            hops += 1
            rows.append({"kernel": "ring_hop_peer", "chunk_bytes": nbytes, "offset": off,
                         "dst_offset": dst_off,
                         "bitwise": all(torch.equal(a, b) for a, b in zip(dsts, want))})
    xs = [_fold_input((RING_SIZE,), torch.float32, gen, dev) for _ in range(N)]
    xss = [_fold_input((N, RING_SIZE), torch.float32, gen, dev) for _ in range(N)]
    for name, fn, args in (
            ("ring_allreduce_shards", ck.ring_allreduce_shards, (xs, SUM)),
            ("ring_allgather_shards", ck.ring_allgather_shards, (xs,)),
            ("ring_reduce_scatter_shards", ck.ring_reduce_scatter_shards, (xss, SUM))):
        got = fn(*args, ring=ring, _mode="cuda")
        want = fn(*args, _mode="plain")
        torch.cuda.synchronize()
        hops += (2 if name == "ring_allreduce_shards" else 1) * (N - 1)
        rows.append({"kernel": name, "size": RING_SIZE,
                     "bitwise": all(torch.equal(_bits(a), _bits(b))
                                    for a, b in zip(got, want))})
    ring.check()
    # every rank on this card: per hop one put launch and two wait launches
    launches = {k: ck.LAUNCHES[k] - before[k] for k in ck.PEER_KERNELS}
    return rows, {"hops": hops, "launches": launches,
                  "ok": launches == {"ring_hop_peer": hops, "ring_hop_wait": 2 * hops}}


def drive() -> dict:
    """Run every case on ``cuda:0``; the summary dict."""
    import torch

    from ompi_tpu_torch.coll import cuda_kernels as ck

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(20261017)
    tbl = ck._index_table(N, dev)
    ck.reset_launches()
    hops, paths = _hop_cases(ck, tbl, gen, dev)
    folds = _fold_cases(ck, tbl, gen, dev)
    rings = _ring_cases(ck, gen, dev)
    peers, peer_launches = _peer_cases(ck, gen, dev)
    cases = hops + folds + rings + peers
    return {"cases": len(cases), "widths": sorted(p for p in paths if isinstance(p, int)),
            "paths": sorted(map(str, paths)), "all_paths": paths >= PATHS,
            "fold_pairs": len({(r["dtype"], r["op"]) for r in folds}),
            "launches": dict(ck.LAUNCHES),
            "bitwise": all(r["bitwise"] for r in cases),
            "mismatches": [r for r in cases if not r["bitwise"]][:8],
            "peer_launches": peer_launches,
            "device": torch.cuda.get_device_name(0)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="ring-hop kernels memcheck child")
    ap.add_argument("--json", metavar="PATH", help="also write the summary here")
    args = ap.parse_args(argv)
    summary = drive()
    if args.json:
        Path(args.json).write_text(json.dumps(summary))
    print("MEMCHECK " + json.dumps(summary), flush=True)
    return 0 if (summary["bitwise"] and summary["all_paths"]
                 and summary["peer_launches"]["ok"]) else 1


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

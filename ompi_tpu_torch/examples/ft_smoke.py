"""The recovery legs on the card: the worker of ``chip_smoke.py``'s
``recovery`` phase.

    python -m ompi_tpu_torch run -np 2 --nranks 4 --ft --respawn \\
        --mca metrics_enable 1 ompi_tpu_torch/examples/ft_smoke.py --mode respawn
    python -m ompi_tpu_torch run -np 3 --nranks 4 --ft \\
        ompi_tpu_torch/examples/ft_smoke.py --mode shrink
    python -m ompi_tpu_torch run -np 2 --nranks 4 \\
        ompi_tpu_torch/examples/ft_smoke.py --mode fresh
    python -m ompi_tpu_torch run -np 2 --nranks 4 \\
        ompi_tpu_torch/examples/ft_smoke.py --mode spawn

Every process drives its K virtual ranks on the current CUDA device (or
the CPU with ``--device cpu`` and a small ``--bytes``, the rehearsal) on
the default ``btl/native`` with the DCN device plane on, the local leg on
forced ``cuda_ring`` (``coll_cuda_allreduce_algorithm`` 7), and prints
JSON lines prefixed ``FTJSON``.  Rank r's f32 row is drawn from its own
seed, so every process can make any rank's data and every result is the
same float32 sum on every rank: a SHA-256 of the result names its bits.

On the one-rank-per-device layout (``--mca "accelerator_cuda_layout"
devices``) the same rows are made on local rank 0's card and each is
copied onto its rank's card (``RankShards`` in and out, as
``multiproc_smoke.py --only devices`` does, with the helpers of
``layout.py`` beside this file); every card of the local
mesh is synchronized around a call, the digest is that of the gathered
bytes (so a devices run and a rows run of the same inputs compare), and
each result row reports ``placement``: the devices its shards lie on and
whether each is its rank's.

* ``respawn`` — ``--calls`` (5) SUM allreduces of ``--bytes`` per rank
  (``pre``: digests and host-clock times); process 1 then SIGKILLs
  itself inside the next call (a timer fires 2 ms into it; both
  processes keep calling until the failure surfaces), on its first
  incarnation.  The survivor catches the failure, revokes and calls
  ``replace()``; the reborn incarnation calls ``replace()`` right after
  ``init``.  Both repeat the calls on the restored 8-rank comm
  (``post``: digests, times and the ring-hop launches of those calls)
  and report ``recovered``: the incarnation,
  the restored size, the ``respawns`` counter, the device plane's
  counters, ``heal_ms`` from the ``replace`` flight record, and
  ``fallback_split``: the plane's fallbacks by cause and by destination
  proc, and its reclaimed windows, before the failure, in the failing
  call with its ``revoke()``/``replace()`` (the reborn incarnation: its
  ``replace()``), and in the calls after recovery;
* ``shrink`` — (run under ``--ft`` with 3 processes, no respawn)
  process 2 SIGKILLs itself after a barrier; the survivors wait until
  they see it failed, revoke, ``shrink()`` to 2 processes × K ranks and
  run SUM allreduces of 1 MiB and ``--bytes`` per rank (``calls``);
* ``fresh`` — the same calls on a fresh 2-process job: the bits the
  shrunk comm must reproduce;
* ``spawn`` — ``api.spawn`` of 2 children (this script with ``--mode
  child``); parents and children merge into a 4-process comm and run a
  1 MiB SUM allreduce with the local leg on ``cuda_ring`` and on the
  plain ring (enum 2): ``merged`` reports both digests (every process,
  parents and children alike).

``--mode ipc-export`` and ``--mode ipc-import`` (no launcher) are the two
halves of the probe of what CUDA does with a mapping whose
exporter died; ``chip_smoke.py`` drives them over pipes.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

import torch

from ompi_tpu_torch.examples.layout import digest, on_ranks, placement, sync

SEED = 29


def emit(kind: str, **obj) -> None:
    print("FTJSON " + json.dumps({"kind": kind, **obj}), flush=True)


def rank_rows(ranks, count: int, dev: torch.device, salt: int = 0) -> torch.Tensor:
    rows = []
    for r in ranks:
        g = torch.Generator(device=dev).manual_seed(SEED * 100003 + salt * 1009 + r)
        rows.append(torch.randn(count, generator=g, device=dev))
    return torch.stack(rows)


def counters(w) -> dict:
    snap = getattr(w.dcn._root_engine(), "stats_snapshot", dict)() or {}
    dp = getattr(w.dcn._root_engine(), "_device_plane", None)
    dev = {k: int(dp.stats[k]) for k in ("device_sends", "device_recvs", "device_fallbacks",
                                         "device_window_reclaimed")} if dp else None
    return {"respawns": int(snap.get("respawns", 0)), "device": dev}


def plane_mark(w) -> dict:
    """The device plane's cumulative fallbacks by cause, the same by
    destination proc, and its reclaimed windows at one instant (empty
    without a plane)."""
    dp = getattr(w.dcn._root_engine(), "_device_plane", None)
    if dp is None:
        return {}
    return {"causes": dict(dp.fallback_causes),
            "peers": {str(q): dict(c) for q, c in dp.fallback_peers.items()},
            "reclaimed": int(dp.stats["device_window_reclaimed"])}


def _moved(new: dict, old: dict) -> dict:
    return {c: n - old.get(c, 0) for c, n in new.items() if n - old.get(c, 0)}


def plane_split(marks: list) -> dict:
    """The counts between consecutive ``plane_mark``s: ``before`` the
    failure, in the ``failing`` call with its ``revoke()``/``replace()``,
    and ``after`` recovery; only the causes that moved are kept."""
    out = {}
    for name, a, b in zip(("before", "failing", "after"), marks, marks[1:]):
        if not b:
            out[name] = None
            continue
        peers = {q: _moved(c, a["peers"].get(q, {})) for q, c in b["peers"].items()}
        out[name] = {"causes": _moved(b["causes"], a["causes"]),
                     "peers": {q: c for q, c in peers.items() if c},
                     "reclaimed": b["reclaimed"] - a["reclaimed"]}
    return out


def timed_calls(comm, x, calls: int) -> tuple[list, list, dict]:
    """``calls`` SUM allreduces: their digests, host-clock times and the
    first result's placement."""
    from ompi_tpu_torch.op import SUM

    digests, times, where = [], [], None
    for _ in range(calls):
        sync(comm)
        t0 = time.perf_counter()
        out = comm.allreduce(x, SUM)
        sync(comm)
        times.append((time.perf_counter() - t0) * 1e3)
        digests.append(digest(out))
        where = where or placement(comm, out)
        del out
    return digests, times, where


def run_respawn(w, ck, nbytes: int, calls: int) -> None:
    from ompi_tpu_torch.core.errors import MPIProcFailedError, MPIRevokedError
    from ompi_tpu_torch.metrics import flight
    from ompi_tpu_torch.op import SUM

    p, inc, k, dev = w.proc, w.procctx.incarnation, w.local_size, w.device
    x = on_ranks(w, rank_rows(range(w.local_offset, w.local_offset + k), nbytes // 4, dev))
    comm = w
    # marks at init, at the failure's start, after replace() and at the end
    marks = [plane_mark(w)]
    if w.respawned:
        marks.append(plane_mark(w))
        comm = w.replace()
    else:
        digests, times, where = timed_calls(w, x, calls)
        marks.append(plane_mark(w))
        emit("pre", proc=p, pid=os.getpid(), digests=digests, times_ms=times,
             placement=where)
        extra = 0
        try:
            if p == 1 and inc == 0:
                # the SIGKILL lands inside the sixth call (or, should that
                # call beat the timer, inside a later one)
                threading.Timer(0.002, os.kill, (os.getpid(), signal.SIGKILL)).start()
            while extra < 1000:
                w.allreduce(x, SUM)
                sync(w)
                extra += 1
            raise SystemExit("no failure seen in 1000 calls after the kill")
        except (MPIProcFailedError, MPIRevokedError) as e:
            emit("caught", proc=p, error=type(e).__name__, completed_after_pre=extra)
            w.revoke()
            comm = w.replace()
    heal = [r["detail"]["heal_ms"] for r in flight.records()
            if r.get("reason") == "replace" and "heal_ms" in r.get("detail", {})]
    marks.append(plane_mark(w))
    ck.reset_launches()
    digests, times, where = timed_calls(comm, x, calls)
    marks.append(plane_mark(w))
    emit("post", proc=p, digests=digests, times_ms=times, launches=dict(ck.LAUNCHES),
         placement=where)
    emit("recovered", proc=p, pid=os.getpid(), incarnation=inc, size=comm.size, name=comm.name,
         heal_ms=heal[-1] if heal else None, layout=comm.local_mesh.layout,
         rank_devices=[str(d) for d in comm.local_mesh.devices],
         fallback_split=plane_split(marks), **counters(w))


def shrink_calls(comm, nbytes: int) -> None:
    """SUM of 1 MiB and ``nbytes`` per rank on ``comm``, inputs seeded by
    the comm's global ranks."""
    dev = comm.device
    rows = []
    for b in sorted({1 << 20, nbytes}):
        x = on_ranks(comm, rank_rows(range(comm.local_offset,
                                           comm.local_offset + comm.local_size),
                                     b // 4, dev, salt=1))
        digests, _times, where = timed_calls(comm, x, 1)
        rows.append({"bytes": b, "digest": digests[0], "placement": where})
    emit("calls", proc=comm.proc, size=comm.size, nprocs=comm.nprocs, name=comm.name,
         rank_devices=[str(d) for d in comm.local_mesh.devices], calls=rows)


def run_shrink(w, nbytes: int) -> None:
    p = w.proc
    w.barrier()
    if p == 2:
        sys.stdout.flush()
        os.kill(os.getpid(), signal.SIGKILL)
    dead = set(range(*w.proc_range(2)))
    deadline = time.monotonic() + 60
    while not dead <= set(w.get_failed()):
        if time.monotonic() > deadline:
            raise SystemExit(f"process 2's failure not seen: {w.get_failed()}")
        time.sleep(0.05)
    w.revoke()
    small = w.shrink()
    shrink_calls(small, nbytes)
    emit("shrunk", proc=p, pid=os.getpid(), failed=w.get_failed(), size=small.size,
         **counters(w))
    # a survivor of a killed peer leaves without the finalize fence
    sys.stdout.flush()
    os._exit(0)


def merged_allreduce(m, ck) -> None:
    from ompi_tpu_torch.core import mca

    store = mca.default_context().store
    x = on_ranks(m, rank_rows(range(m.local_offset, m.local_offset + m.local_size),
                              (1 << 20) // 4, m.device, salt=2))
    ck.reset_launches()
    ring = timed_calls(m, x, 1)[0][0]
    launches = dict(ck.LAUNCHES)
    store.set("coll_cuda_allreduce_algorithm", 2)
    plain = timed_calls(m, x, 1)[0][0]
    store.set("coll_cuda_allreduce_algorithm", 7)
    emit("merged", proc=m.proc, nprocs=m.nprocs, size=m.size, ring=ring, plain=plain,
         launches=launches)


def run_spawn(api, ck, args) -> None:
    if args.mode == "spawn":
        ic = api.spawn([os.path.abspath(__file__), "--mode", "child", "--device",
                        args.device], maxprocs=2)
        m = ic.merge()
    else:
        m = api.get_parent().merge()
    merged_allreduce(m, ck)


def ipc_export(nbytes: int) -> int:
    """Two CUDA windows with a known pattern; their handles on stdout;
    then wait to be killed."""
    from ompi_tpu_torch.dcn import device

    pattern = torch.arange(nbytes // 4, dtype=torch.float32, device="cuda")
    wins = [device.CudaWindow(f"tpudev-probe-{os.getpid()}-{i}", nbytes, 0) for i in range(2)]
    for win in wins:
        win.place(pattern)
    print(json.dumps({"pid": os.getpid(), "handles": [w.handle.hex() for w in wins]}),
          flush=True)
    time.sleep(3600)
    return 0


def ipc_import(nbytes: int) -> int:
    """Map window 0 while its exporter lives; after ``dead`` on stdin,
    copy through that mapping again, close it, and try to open window 1."""
    import ctypes

    from ompi_tpu_torch.dcn import device

    lib = device._cuda_lib()
    handles = json.loads(sys.stdin.readline())["handles"]
    pattern = torch.arange(nbytes // 4, dtype=torch.float32, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def copy(ptr) -> dict:
        out = torch.full_like(pattern, -1.0)
        rc = lib.ompi_dw_copy(ctypes.c_void_p(out.data_ptr()), ptr, nbytes, stream)
        return {"rc": int(rc), "error": lib.ompi_dw_error_string(rc).decode() if rc else "",
                "equal": bool(torch.equal(out, pattern)) if rc == 0 else None,
                "zeros": bool((out == 0).all()) if rc == 0 else None}

    ptr = ctypes.c_void_p()
    rc = lib.ompi_dw_ipc_open(0, bytes.fromhex(handles[0]), ctypes.byref(ptr))
    res = {"open_live": int(rc), "copy_live": copy(ptr) if rc == 0 else None}
    print(json.dumps({"opened": rc == 0}), flush=True)
    sys.stdin.readline()  # the exporter is dead now
    res["copy_after_death"] = copy(ptr) if rc == 0 else None
    res["close_after_death"] = int(lib.ompi_dw_ipc_close(0, ptr)) if rc == 0 else None
    ptr2 = ctypes.c_void_p()
    rc2 = lib.ompi_dw_ipc_open(0, bytes.fromhex(handles[1]), ctypes.byref(ptr2))
    res["open_after_death"] = int(rc2)
    res["open_after_death_error"] = lib.ompi_dw_error_string(rc2).decode() if rc2 else ""
    if rc2 == 0:
        res["copy_opened_after_death"] = copy(ptr2)
        lib.ompi_dw_ipc_close(0, ptr2)
    # the importer's own context still works
    res["context_ok"] = bool((torch.ones(4, device="cuda") * 2).sum().item() == 8.0)
    print(json.dumps(res), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", required=True,
                    choices=["respawn", "shrink", "fresh", "spawn", "child",
                             "ipc-export", "ipc-import"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bytes", type=int, default=64 << 20, help="per-rank bytes of a call")
    ap.add_argument("--calls", type=int, default=5, help="calls before and after the failure")
    args = ap.parse_args()
    if args.mode == "ipc-export":
        return ipc_export(args.bytes)
    if args.mode == "ipc-import":
        return ipc_import(args.bytes)
    import ompi_tpu_torch.api as api
    from ompi_tpu_torch.coll import cuda_kernels as ck
    from ompi_tpu_torch.core import mca

    w = api.init(device=args.device)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ompi_tpu"))
    if bad:
        raise SystemExit(f"forbidden modules imported: {bad}")
    mca.default_context().store.set("coll_cuda_allreduce_algorithm", 7)
    if args.mode == "respawn":
        run_respawn(w, ck, args.bytes, args.calls)
    elif args.mode == "shrink":
        run_shrink(w, args.bytes)
    elif args.mode == "fresh":
        shrink_calls(w, args.bytes)
    else:
        run_spawn(api, ck, args)
    api.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())

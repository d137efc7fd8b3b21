"""ctl — ops CLI for a running tpud daemon (``python -m ompi_tpu_torch ctl``).

Port of the reference's ``tools/tpud_ctl.py``; drives the daemon's HTTP
ops surface (the live-telemetry aggregator endpoint with the serve
routes mounted):

    python -m ompi_tpu_torch ctl --url http://127.0.0.1:PORT submit job.py \
        --tenant alice --arg 100
    python -m ompi_tpu_torch ctl --url ... status [JOB_ID]
    python -m ompi_tpu_torch ctl --url ... drain
    python -m ompi_tpu_torch ctl --url ... scale 1
    python -m ompi_tpu_torch ctl --url ... shutdown
    python -m ompi_tpu_torch ctl --pidfile /tmp/tpud.pid status
    python -m ompi_tpu_torch ctl --selftest

``--url`` defaults to ``$TPUD_URL``; ``--pidfile`` (or
``$TPUD_PIDFILE``) resolves the URL from a live daemon's pidfile and
reports + reaps a stale one.  Every command is restart-idempotent
against a dead daemon: ``shutdown``/``drain`` are one-line no-ops
(rc 0), the rest fail with one line (rc 1) — never a traceback.
``--selftest`` exercises the whole control plane — submit/admission/
fairness/drain/shutdown over real HTTP against a workerless daemon.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

def _out(obj) -> None:
    print(json.dumps(obj, indent=1, sort_keys=True))


def cmd_submit(url: str, ns) -> int:
    from ompi_tpu_torch.serve import client

    env = dict(kv.split("=", 1) for kv in (ns.env or []))
    try:
        job = client.submit(url, ns.script, args=ns.arg or (),
                            tenant=ns.tenant, nprocs=ns.nprocs,
                            env=env or None)
    except client.ServeError as e:
        if e.status == 0:
            raise  # unreachable daemon: the dispatcher's one-liner
        print(f"rejected ({e.status}): {e}", file=sys.stderr)
        return 1
    if ns.no_wait:
        _out(job)
        return 0
    final = client.wait(url, job["id"], timeout=ns.timeout)
    _out(final)
    return 0 if final.get("state") == "done" else 1


def cmd_status(url: str, ns) -> int:
    from ompi_tpu_torch.serve import client

    st = client.status(url, ns.job_id)
    if ns.job_id is None and "queued" in st:
        # one-line ops summary ahead of the JSON: queue depth,
        # per-tenant pending, concurrency high-water, overload tallies
        c = st.get("counters") or {}
        adm = st.get("admission") or {}
        depth = st.get("tenant_depth") or {}
        print(f"queue: {len(st.get('queued', []))} queued / "
              f"{len(st.get('running', []))} running "
              f"(concurrency hwm {c.get('jobs_concurrent_hwm', 0)}); "
              f"admission {adm.get('state', 'ok')}: "
              f"shed {c.get('jobs_shed', 0)}, "
              f"retried {c.get('jobs_retried', 0)}, "
              f"deadline-expired {c.get('jobs_deadline_expired', 0)}; "
              "pending "
              + (", ".join(f"{t}={n}"
                           for t, n in sorted(depth.items()))
                 or "none"))
    _out(st)
    return 0


def cmd_simple(url: str, fn_name: str, *args) -> int:
    from ompi_tpu_torch.serve import client

    _out(getattr(client, fn_name)(url, *args))
    return 0


# -- selftest ----------------------------------------------------------


def selftest() -> int:
    """Control-plane acceptance over real HTTP: a workerless daemon
    (full KVS + aggregator + ops routes, no rank processes) with a
    pump thread standing in for the resident workers — every directive
    published to the job stream is acknowledged with per-proc
    completion records, exactly the worker contract."""
    from ompi_tpu_torch.serve import client
    from ompi_tpu_torch.serve.daemon import K_DONE, K_JOB, TpuDaemon

    d = TpuDaemon(2, mca={"serve_max_pending": "2"}, spawn=False)
    stop = threading.Event()
    served: list[dict] = []

    def pump():
        n = 0
        while not stop.is_set():
            jd = d.server.peek(f"{K_JOB}{n}")
            if jd is None:
                time.sleep(0.01)
                continue
            served.append(jd)
            for p in jd.get("procs", ()):
                d.server.put_local(f"{K_DONE}{n}.{p}",
                                   {"ok": True, "proc": p})
            n += 1

    threading.Thread(target=pump, daemon=True).start()
    try:
        # per-tenant FIFO + round-robin fairness: alice floods first,
        # bob's single job must not sit behind her whole burst
        a1 = client.submit(d.url, "a1.py", tenant="alice")
        a2 = client.submit(d.url, "a2.py", tenant="alice")
        b1 = client.submit(d.url, "b1.py", tenant="bob")
        # admission: alice is at serve_max_pending=2
        try:
            client.submit(d.url, "a3.py", tenant="alice")
            raise AssertionError("quota breach admitted")
        except client.ServeError as e:
            assert e.status == 429, e.status
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            d.step()
            st = client.status(d.url)
            if len(st["done"]) == 3:
                break
            time.sleep(0.02)
        st = client.status(d.url)
        assert len(st["done"]) == 3, st
        assert all(j["state"] == "done" for j in st["done"].values()), st
        order = [jd["id"] for jd in served if jd.get("kind") == "job"]
        assert order == [a1["id"], b1["id"], a2["id"]], (
            f"fairness violated: {order}")
        # disjoint CID blocks, monotone
        bases = [jd["cid_base"] for jd in served]
        spans = [jd["cid_span"] for jd in served]
        assert all(b2 >= b1_ + s for b1_, b2, s
                   in zip(bases, bases[1:], spans)), bases
        # job-scoped telemetry: the aggregator saw every job begin
        tj = client.status(d.url)["telemetry"]["jobs"]
        assert set(tj) == {a1["id"], a2["id"], b1["id"]}, tj
        # single-job status endpoint
        one = client.status(d.url, b1["id"])
        assert one["state"] == "done" and one["tenant"] == "bob", one
        # ops-hygiene surface: the /jobs payload carries the serving
        # counters and admission state, and `status` summarizes them
        assert st["counters"]["jobs_concurrent_hwm"] >= 1, st["counters"]
        assert st["admission"]["state"] == "ok", st["admission"]
        import contextlib
        import io
        import types

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cmd_status(d.url, types.SimpleNamespace(job_id=None))
        head = buf.getvalue().splitlines()[0]
        assert "concurrency hwm" in head and "shed" in head, head
        # drain: no new admissions, then shutdown completes the loop
        client.drain(d.url)
        try:
            client.submit(d.url, "x.py")
            raise AssertionError("draining admitted a job")
        except client.ServeError as e:
            assert e.status == 503, e.status
        client.shutdown(d.url)
        deadline = time.monotonic() + 10
        while (not d._shutdown_published
               and time.monotonic() < deadline):
            d.step()
            time.sleep(0.02)
        assert d._shutdown_published
        sd = d.server.peek(f"{K_JOB}{d.cursor - 1}")
        assert sd and sd["kind"] == "shutdown", sd
        print("tpud_ctl selftest OK (submit/admission/fairness/"
              "cid-blocks/drain/shutdown)")
        return 0
    finally:
        stop.set()
        d.aggregator.close()
        d.server.close()


def _pidfile_state(path: str) -> tuple[str, dict | None]:
    """Classify a pidfile: ('live', info) when its daemon answers
    signal 0, ('stale', info) when the pid is dead (the record is
    returned for the reap message), ('absent', None) otherwise."""
    from ompi_tpu_torch.serve import state as _state

    info = _state.read_pidfile(path)
    if info is None:
        return "absent", None
    if _state.pid_alive(int(info.get("pid", 0))):
        return "live", info
    return "stale", info


def _resolve_url(ns) -> str:
    """--url wins; otherwise a live pidfile supplies it.  A stale
    pidfile is reported and reaped HERE (the operator's `status`
    against a dead daemon must say so in one line, not traceback)."""
    if ns.url:
        return ns.url
    if not ns.pidfile:
        return ""
    kind, info = _pidfile_state(ns.pidfile)
    if kind == "live":
        return str(info.get("url", ""))
    if kind == "stale":
        print(f"tpud: stale pidfile {ns.pidfile} (pid "
              f"{info.get('pid')} dead) — reaping it")
        try:
            os.unlink(ns.pidfile)
        except OSError:
            pass
    return ""


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ompi_tpu_torch ctl",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--url", default=os.environ.get("TPUD_URL", ""),
                    help="daemon ops URL (default $TPUD_URL)")
    ap.add_argument("--pidfile",
                    default=os.environ.get("TPUD_PIDFILE", ""),
                    help="daemon pidfile (default $TPUD_PIDFILE): "
                         "supplies --url from a live daemon's record; "
                         "a stale pidfile is reported and reaped")
    ap.add_argument("--selftest", action="store_true",
                    help="control-plane acceptance against a "
                         "workerless in-process daemon")
    sub = ap.add_subparsers(dest="cmd")
    s = sub.add_parser("submit", help="run a worker script in the warm mesh")
    s.add_argument("script")
    s.add_argument("--arg", action="append", help="script argv entry "
                   "(repeatable)")
    s.add_argument("--tenant", default=None)
    s.add_argument("--nprocs", type=int, default=None)
    s.add_argument("--env", action="append", metavar="K=V",
                   help="extra env for the job script (repeatable)")
    s.add_argument("--no-wait", action="store_true",
                   help="print the job record and return immediately")
    s.add_argument("--timeout", type=float, default=600.0)
    st = sub.add_parser("status", help="queue/job state")
    st.add_argument("job_id", nargs="?", default=None)
    sub.add_parser("drain", help="stop admitting; let the queue finish")
    sub.add_parser("shutdown", help="drain, then stop the daemon")
    sc = sub.add_parser("scale", help="resize the active rank-set")
    sc.add_argument("nprocs", type=int)
    ns = ap.parse_args(argv)
    if ns.selftest:
        return selftest()
    if not ns.cmd:
        ap.error("a command (or --selftest) is required")
    url = _resolve_url(ns)
    if not url:
        if ns.cmd == "shutdown" and (ns.pidfile or ns.url):
            # idempotent stop: nothing is running — that IS the goal
            print("tpud: no daemon running — shutdown is a no-op")
            return 0
        if ns.pidfile and not ns.url:
            print(f"tpud: no daemon at pidfile {ns.pidfile}",
                  file=sys.stderr)
            return 1
        ap.error("--url (or $TPUD_URL / a live --pidfile) is required")
    from ompi_tpu_torch.serve.client import ServeError

    try:
        if ns.cmd == "submit":
            return cmd_submit(url, ns)
        if ns.cmd == "status":
            return cmd_status(url, ns)
        if ns.cmd == "drain":
            return cmd_simple(url, "drain")
        if ns.cmd == "shutdown":
            return cmd_simple(url, "shutdown")
        return cmd_simple(url, "scale", ns.nprocs)
    except ServeError as e:
        if e.status != 0:
            print(f"tpud: {e}", file=sys.stderr)
            return 1
        # unreachable daemon: one line, clean exit — `shutdown` (and
        # `drain`) against an already-dead daemon is a no-op success,
        # everything else reports and fails without a traceback
        if ns.cmd in ("shutdown", "drain"):
            print(f"tpud: daemon already down ({url}) — "
                  f"{ns.cmd} is a no-op")
            return 0
        print(f"tpud: daemon unreachable at {url} ({e})",
              file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())

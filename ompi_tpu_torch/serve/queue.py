"""Job queue + gang scheduler + per-tenant admission (daemon side).

≈ the reference's plm job-state machinery collapsed to the piece a
single-host serving daemon needs: a FIFO of submitted jobs, scheduled
onto the resident rank-set **gang-style** — a job launches only when
every proc it needs is free — with round-robin fairness across tenants
(one tenant's burst cannot starve another's queue) and an admission
quota per tenant (``serve_max_pending``).

Scheduling is **any-fit**, not head-of-line: within a tenant's FIFO
the first job whose full rank-set fits the currently free procs
launches, so a wide job parked at the head cannot starve narrow jobs
behind it while disjoint ranks sit idle (``serve_max_concurrent``
bounds how many gangs overlap; 0 = any fit).

The :class:`AdmissionController` adds the telemetry-driven half: the
daemon folds its own aggregator feeds (summed ring/cts/DMA stall
deltas, detector health, the /critical dominant cause) into it once
per monitor tick.  One over-threshold tick holds dispatch (jobs queue
instead of landing on a stalled mesh); ``SUSTAIN`` consecutive ticks
under ``serve_shed_policy=shed`` flips to load shedding — submits
from tenants that already have work are rejected 429 with a
Retry-After hint — and one clean tick restores admission.

Pure bookkeeping: no sockets, no threads — the daemon drives it from
its monitor loop, and tests drive it directly.  Port of
``ompi_tpu/serve/queue.py``, unchanged: the same submit/finish/retry
sequence gives the same ``state()`` in both packages.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any


def _id_num(job_id: str) -> int:
    """Numeric part of a ``j<N>`` id (0 for foreign ids)."""
    try:
        return int(str(job_id).lstrip("j"))
    except ValueError:
        return 0


class AdmissionError(Exception):
    """Submit rejected by admission control (HTTP 429/503 at the ops
    surface); ``.status`` carries the HTTP code and ``.retry_after``
    the Retry-After hint in seconds (None when the rejection is a
    hard quota/drain, not a transient overload shed)."""

    def __init__(self, msg: str, status: int = 429,
                 retry_after: float | None = None):
        super().__init__(msg)
        self.status = status
        self.retry_after = retry_after


class AdmissionController:
    """Telemetry-driven admission state machine (one per daemon).

    ``update()`` folds one monitor tick: per-proc CUMULATIVE stall
    sums (ring_stall_ns + cts_wait_ns + device_dma_wait_ns from the
    aggregator's latest frames — deltas against the previous tick are
    the overload signal, so a busy past never sheds forever) plus
    detector health and the dominant /critical cause.  States:

    * ``ok``       — dispatch and admit normally;
    * ``stalled``  — the last tick crossed ``serve_admission_stall_ns``
      (or the mesh is unhealthy): hold dispatch, keep admitting;
    * ``shedding`` — ``SUSTAIN`` consecutive stalled ticks under
      ``serve_shed_policy=shed``: tenants that already have work
      queued or running get 429 + Retry-After; an idle tenant still
      gets one job in (overload must not lock a tenant out).

    One clean tick resets the streak — a healed mesh restores
    admission immediately (the np=2 acceptance asserts the full
    ok → shedding → ok round trip in event space).
    """

    #: consecutive over-threshold ticks before queue-hold escalates
    #: to shedding (and the Retry-After hint, in poll-tick seconds)
    SUSTAIN = 3

    def __init__(self, stall_ns: int = 0, policy: str = "shed",
                 sustain: int = SUSTAIN):
        self.stall_ns = int(stall_ns)
        self.policy = str(policy or "shed")
        self.sustain = max(1, int(sustain))
        self._streak = 0
        #: proc → last cumulative stall sum (delta base)
        self._last: dict[int, int] = {}
        self.last_delta_ns = 0
        self.cause = ""
        self.unhealthy = False

    def enabled(self) -> bool:
        return self.stall_ns > 0

    def update(self, stalls_by_proc: dict | None, healthy: bool = True,
               cause: str = "") -> None:
        """Fold one monitor tick (no-op while disabled)."""
        if not self.enabled():
            return
        delta = 0
        for p, v in (stalls_by_proc or {}).items():
            p, v = int(p), int(v)
            delta += max(0, v - self._last.get(p, v))
            self._last[p] = v
        self.last_delta_ns = delta
        self.unhealthy = not healthy
        over = delta > self.stall_ns or not healthy
        self._streak = self._streak + 1 if over else 0
        self.cause = str(cause or "") if over else ""

    def overloaded(self) -> bool:
        """Hold dispatch? (any over-threshold tick, until one clean)"""
        return self.enabled() and self._streak >= 1

    def shedding(self) -> bool:
        return (self.enabled() and self.policy == "shed"
                and self._streak >= self.sustain)

    def retry_after_s(self) -> int:
        """Retry-After hint: the shortest interval after which the
        streak could have cleared (one sustain window of ticks)."""
        return max(1, int(self.sustain))

    def state(self) -> dict:
        return {
            "state": ("shedding" if self.shedding()
                      else "stalled" if self.overloaded() else "ok"),
            "enabled": self.enabled(),
            "stall_ns": self.stall_ns,
            "policy": self.policy,
            "streak": self._streak,
            "last_delta_ns": self.last_delta_ns,
            "unhealthy": self.unhealthy,
            "cause": self.cause,
        }


class JobQueue:
    """Multi-tenant FIFO with gang scheduling over ``nprocs`` slots."""

    def __init__(self, nprocs: int, max_pending: int = 8,
                 max_concurrent: int = 0, retry_budget: int = 0,
                 admission: AdmissionController | None = None):
        self.nprocs = int(nprocs)
        self.max_pending = int(max_pending)
        #: gang-concurrency cap (serve_max_concurrent; 0 = unlimited)
        self.max_concurrent = int(max_concurrent)
        #: automatic re-enqueues per repair-killed job (serve_retry_budget)
        self.retry_budget = int(retry_budget)
        #: telemetry-driven admission (None/disabled = dispatch whenever free)
        self.admission = admission
        #: serving-plane NATIVE_COUNTERS slice (daemon provider feed);
        #: jobs_concurrent_hwm is monotone here, max-merged downstream
        self.counters: dict[str, int] = {
            "jobs_concurrent_hwm": 0, "jobs_shed": 0,
            "jobs_deadline_expired": 0, "jobs_retried": 0}
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        #: submitted, not yet launched (submission order — FIFO spine)
        self._queue: list[dict] = []
        #: job id → record, running jobs
        self._running: dict[str, dict] = {}
        #: job id → record, completed jobs (done/failed), insertion order
        self._done: dict[str, dict] = {}
        #: tenant → monotonic pick counter (round-robin fairness state)
        self._served: dict[str, int] = {}
        self._pick = 0
        #: queued job ids the scheduler must not pick yet: the daemon
        #: holds a submission until its reply is written
        self._held: set[str] = set()
        self.draining = False

    # -- admission -------------------------------------------------------

    def submit(self, script: str, args=(), tenant: str = "default",
               nprocs: int | None = None, env: dict | None = None,
               held: bool = False) -> dict:
        """Admission control + enqueue.  Raises :class:`AdmissionError`
        when the daemon is draining (503) or the tenant already has
        ``max_pending`` jobs queued or running (429) — the queue-depth
        feed the ops surface reports per tenant.  A ``held`` job counts
        as queued but :meth:`next_runnable` skips it until
        :meth:`release`."""
        with self._lock:
            if self.draining:
                raise AdmissionError("daemon is draining: no new jobs",
                                     status=503)
            tenant = str(tenant or "default")
            ctrl = self.admission
            if (ctrl is not None and ctrl.shedding()
                    and self._tenant_depth(tenant) >= 1):
                # sustained overload: shed tenants that already have
                # work in the system; a tenant with nothing queued or
                # running still gets one job admitted (fairness floor)
                self.counters["jobs_shed"] += 1
                ra = ctrl.retry_after_s()
                raise AdmissionError(
                    "mesh overloaded (admission shedding"
                    + (f", cause {ctrl.cause}" if ctrl.cause else "")
                    + f"): retry after {ra}s", status=429,
                    retry_after=ra)
            if self.max_pending > 0:
                depth = self._tenant_depth(tenant)
                if depth >= self.max_pending:
                    raise AdmissionError(
                        f"tenant {tenant!r} at serve_max_pending="
                        f"{self.max_pending} (depth {depth}); retry "
                        "after the queue drains", status=429)
            want = int(nprocs or self.nprocs)
            if not 0 < want <= self.nprocs:
                raise AdmissionError(
                    f"job wants {want} procs; the mesh has "
                    f"{self.nprocs}", status=400)
            job = {
                "id": f"j{next(self._ids)}",
                "tenant": tenant,
                "script": str(script),
                "args": [str(a) for a in (args or ())],
                "env": {str(k): str(v) for k, v in (env or {}).items()},
                "nprocs": want,
                "state": "queued",
                "submit_ns": time.time_ns(),
            }
            self._queue.append(job)
            if held:
                self._held.add(job["id"])
            return dict(job)

    def release(self, job_id: str) -> None:
        """Let the scheduler pick a ``held`` job."""
        with self._lock:
            self._held.discard(job_id)

    def _tenant_depth(self, tenant: str) -> int:
        return (sum(1 for j in self._queue if j["tenant"] == tenant)
                + sum(1 for j in self._running.values()
                      if j["tenant"] == tenant))

    # -- gang scheduling -------------------------------------------------

    def next_runnable(self, free_procs) -> dict | None:
        """Pick the next job whose full rank-set fits in ``free_procs``
        and assign it the lowest free procs.  Order: round-robin across
        tenants (the tenant picked least recently goes first), FIFO
        within a tenant — but **any-fit**, not head-of-line: within a
        tenant's FIFO the first job that FITS the free set launches,
        so a wide job parked at the head cannot idle disjoint ranks a
        narrow job behind it could use.  Returns None while the
        admission controller holds dispatch (over-threshold stall
        tick) or ``serve_max_concurrent`` gangs already run."""
        free = sorted(int(p) for p in free_procs)
        with self._lock:
            if self.admission is not None and self.admission.overloaded():
                return None  # queue instead of dispatch onto a stall
            if (self.max_concurrent > 0
                    and len(self._running) >= self.max_concurrent):
                return None
            by_tenant: dict[str, list[dict]] = {}
            for j in self._queue:
                by_tenant.setdefault(j["tenant"], []).append(j)
            if not by_tenant:
                return None
            for tenant in sorted(
                    by_tenant, key=lambda t: (self._served.get(t, -1), t)):
                for job in by_tenant[tenant]:  # FIFO scan, first FIT
                    if job["nprocs"] > len(free) or job["id"] in self._held:
                        continue
                    self._queue.remove(job)
                    self._pick += 1
                    self._served[tenant] = self._pick
                    job["procs"] = free[:job["nprocs"]]
                    job["state"] = "running"
                    job["start_ns"] = time.time_ns()
                    self._running[job["id"]] = job
                    self.counters["jobs_concurrent_hwm"] = max(
                        self.counters["jobs_concurrent_hwm"],
                        len(self._running))
                    return dict(job)
            return None

    # -- completion ------------------------------------------------------

    def finish(self, job_id: str, ok: bool, error: str = "",
               ranks: dict | None = None,
               hang: dict | None = None) -> dict | None:
        with self._lock:
            job = self._running.pop(job_id, None)
            if job is None:
                return None
            job["state"] = "done" if ok else "failed"
            if error:
                job["error"] = error[:2000]
            if ranks:
                # per-rank completion records (timings + transport dial
                # counters): the warm-reuse proof the ops surface and
                # the acceptance test read
                job["ranks"] = {str(r): rec for r, rec in ranks.items()}
            if hang is not None:
                # the pre-revoke hang report (deadline path): who was
                # blocked on whom when the deadline fired — served off
                # /job/<id> next to the DeadlineExpired error
                job["hang"] = hang
            job["end_ns"] = time.time_ns()
            self._done[job_id] = job
            return dict(job)

    def retry(self, job_id: str) -> dict | None:
        """Re-enqueue a RUNNING job killed by mesh repair, consuming
        one unit of ``serve_retry_budget``.  Returns the re-queued
        record, or None when the budget is exhausted (the job stays
        running; the caller finishes it failed with the typed
        RetryBudgetExhausted error).  The daemon journals the returned
        record as one atomic ``retry`` event — close-the-attempt +
        re-queue in a single fsync'd line, the exactly-once hinge."""
        with self._lock:
            job = self._running.get(job_id)
            if job is None:
                return None
            n = int(job.get("retries", 0))
            if self.retry_budget <= 0 or n >= self.retry_budget:
                return None
            del self._running[job_id]
            job["retries"] = n + 1
            job["state"] = "queued"
            job.pop("procs", None)
            job.pop("start_ns", None)
            job.pop("ranks", None)
            job.pop("error", None)
            job.pop("hang", None)
            self._queue.append(job)
            self.counters["jobs_retried"] += 1
            return dict(job)

    # -- restart recovery (journal replay) -------------------------------

    def restore(self, queued=(), running=(), done=()) -> None:
        """Reload journal-replayed state into a FRESH queue (daemon
        restart): queued jobs go back to the FIFO in submission order,
        running jobs re-enter the running set (their re-published
        directives are already outstanding), done jobs keep the ops
        history.  The id counter resumes past every restored id so a
        post-restart submit can never collide."""
        with self._lock:
            top = 0
            for job in sorted(queued, key=lambda j: j.get("submit_ns", 0)):
                self._queue.append(dict(job, state="queued"))
                top = max(top, _id_num(job["id"]))
            for job in running:
                self._running[job["id"]] = dict(job, state="running")
                top = max(top, _id_num(job["id"]))
            for job in done:
                self._done[job["id"]] = dict(job)
                top = max(top, _id_num(job["id"]))
            if top:
                self._ids = itertools.count(top + 1)

    def fail_queued(self, reason: str) -> None:
        """Flush the queue as failed (daemon shutdown with jobs
        pending)."""
        with self._lock:
            for job in self._queue:
                job["state"] = "failed"
                job["error"] = reason
                job["end_ns"] = time.time_ns()
                self._done[job["id"]] = job
            self._queue.clear()
            self._held.clear()

    # -- introspection ---------------------------------------------------

    def get(self, job_id: str) -> dict | None:
        with self._lock:
            for pool in (self._running, self._done):
                if job_id in pool:
                    return dict(pool[job_id])
            for j in self._queue:
                if j["id"] == job_id:
                    return dict(j)
            return None

    def running(self) -> list[dict]:
        with self._lock:
            return [dict(j) for j in self._running.values()]

    def idle(self) -> bool:
        with self._lock:
            return not self._queue and not self._running

    def state(self) -> dict[str, Any]:
        """The ops-surface /jobs payload: queue depths per tenant (the
        admission feed), queued/running/done records."""
        with self._lock:
            tenants = sorted(
                {j["tenant"] for j in self._queue}
                | {j["tenant"] for j in self._running.values()})
            return {
                "draining": self.draining,
                "queued": [dict(j) for j in self._queue],
                "running": [dict(j) for j in self._running.values()],
                "done": {k: dict(v) for k, v in self._done.items()},
                "tenant_depth": {t: self._tenant_depth(t)
                                 for t in tenants},
                "max_pending": self.max_pending,
                "max_concurrent": self.max_concurrent,
                "retry_budget": self.retry_budget,
                "counters": dict(self.counters),
                "admission": (self.admission.state()
                              if self.admission is not None
                              else {"state": "ok", "enabled": False}),
            }

"""Spawn-on-demand worker pool — thread reuse for the NBC/RTS paths.

≈ ``opal/mca/threads`` (SURVEY.md §2.3): the reference funnels
asynchronous work through reusable progress threads; round 2 here
spawned one OS thread per i-collective instance and per inbound RTS
grant, which is thousands of pthread creations per second at
training-loop rates (VERDICT r2 weak #6).

The pool preserves the no-deadlock argument that justified
thread-per-instance: a FIXED-width pool can park the task a peer is
blocked on behind busy workers and deadlock a legal MPI program, so
this pool NEVER queues behind a busy worker — ``submit`` hands the
task to an idle worker when one is parked, and spawns a fresh thread
otherwise ("spawn on depth").  Liveness is therefore identical to
thread-per-task; what changes is that workers park for ``idle_ttl``
seconds after finishing and get reused, so steady-state issue rates
reuse a small warm set instead of churning pthreads.
"""

from __future__ import annotations

import queue
import threading


class SpawnPool:
    """Reusable daemon workers with spawn-on-demand overflow."""

    def __init__(self, name: str = "ompi-pool", idle_ttl: float = 10.0):
        self.name = name
        self.idle_ttl = idle_ttl
        self._q: queue.Queue = queue.Queue()
        self._idle = 0
        self._lock = threading.Lock()
        #: total threads ever created (the soak-test meter)
        self.spawned = 0
        #: tasks handed to an already-warm worker
        self.reused = 0

    def submit(self, fn) -> None:
        """Run ``fn()`` on an idle worker if one is parked, else on a
        fresh thread.  Never blocks, never queues behind busy work."""
        with self._lock:
            if self._idle > 0:
                self._idle -= 1  # reserve the parked worker
                self.reused += 1
                self._q.put(fn)
                return
            self.spawned += 1
        threading.Thread(
            target=self._run, args=(fn,), daemon=True, name=self.name
        ).start()

    def _run(self, fn) -> None:
        import traceback

        while True:
            try:
                fn()
            except BaseException:  # noqa: BLE001 — keep the worker
                # alive, but never silently: thread-per-task surfaced
                # stray exceptions via threading.excepthook, so the
                # pool preserves that diagnostic on stderr
                traceback.print_exc()
            with self._lock:
                self._idle += 1
            try:
                fn = self._q.get(timeout=self.idle_ttl)
            except queue.Empty:
                with self._lock:
                    # a submit may have reserved us between the timeout
                    # and this lock: drain once more before retiring
                    try:
                        fn = self._q.get_nowait()
                    except queue.Empty:
                        self._idle -= 1
                        return

    def stats(self) -> dict:
        with self._lock:
            return {
                "spawned": self.spawned,
                "reused": self.reused,
                "idle": self._idle,
            }


#: process-wide pools: one for non-blocking collective instances, one
#: for transport-side grants (separate so a storm of blocked NBC
#: instances cannot starve RTS grants of warm workers)
nbc_pool = SpawnPool("ompi-nbc")
rts_pool = SpawnPool("ompi-rts-grant")

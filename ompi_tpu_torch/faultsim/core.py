"""Fault-injection core: plan parsing, deterministic decisions,
injection counters (own copy of ``ompi_tpu/faultsim/core.py``).

The kinds whose hook sites live in planes the port does not have yet
(``daemonkill``/``agentkill`` in the serving daemon, the device-plane
sites) parse and decide exactly as in the reference — the plan grammar
and the pvar namespace stay whole — but nothing in the port consults
them.  The native plane's knobs (ring stall/fail, tcp-send connkill,
wire duplicate, blocking-recv delay) reach the C engine through the
``native_*_args`` helpers at engine creation.

The decision function is counter-hashed, not stream-random: event
``k`` at site ``s`` under rule ``r`` hits iff
``u01(seed, proc, s, k, r) < p`` (or the rule's ``at``/``every``/``n``
match ``k`` exactly).  Two consequences the chaos tests rely on:

* thread interleaving cannot perturb outcomes — a site's events are
  numbered under a lock, and each event's decision depends only on
  its own number;
* replaying the same workload with the same seed replays the same
  faults (the property ``tools/chaos.py`` verifies end-to-end).

Control frames (heartbeats, failure gossip) are exempt at the hook
sites: injecting into the detector's own traffic would make failure
*detection* nondeterministic and the injected-fault counts
timing-dependent.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from dataclasses import dataclass

#: the in-path gate — transport hooks read this attribute directly
#: (one boolean test per hook when disabled)
_enabled = False

#: fault kinds, in the stable order the MPI_T pvar namespace uses
#: (``faultsim_injected_<kind>``).  Semantics:
#:
#: ``drop``      lose an outbound message (site send) or inbound eager
#:               frame (site recv) — recovery is the receiver's
#:               deadline escalation, exactly like real frame loss;
#: ``delay``     sleep ``ms`` before the frame moves (latency spike);
#: ``dup``       send the message twice (at-least-once wire duplicate);
#: ``trunc``     send a partial frame then kill the connection (peer
#:               crash mid-frame — exercises the receiver's framing
#:               error + abandon path and the sender's reconnect);
#: ``connkill``  close the cached peer socket before the send (link
#:               death — exercises reconnect/backoff + resend);
#: ``stall``     inject ``ms`` of backpressure per native ring write
#:               (site ring; armed into libtpudcn via tdcn_fault_set);
#: ``ringfail``  fail the ``at``-th native ring write outright;
#: ``dialfail``  refuse the first ``n`` connect() attempts (site dial
#:               — exercises the exponential-backoff dial loop);
#: ``daemonkill`` SIGKILL the tpud serving daemon at the ``at``-th
#:               directive-publish attempt (site daemon — the control-
#:               plane hook in serve/daemon.py; drives the restart-
#:               hygiene soak deterministically from one seed);
#: ``agentkill`` SIGKILL a per-host launch agent at the ``at``-th
#:               command it executes (site agent — the hook in
#:               serve/agent.py; the multi-host chaos harness's
#:               deterministic agent-death lever).
#:
#: Device-plane sites (rules opt in with ``site=device`` /
#: ``site=device_recv`` — the hooks in dcn/device.py): at ``device``
#: (the window stage path) ``drop`` aborts the stage as a simulated
#: DMA failure (the send degrades to the host plane and strikes the
#: plane-health table), ``trunc`` publishes a short DMA length the
#: receiver detects and escalates, ``delay``/``stall`` sleep ``ms``
#: before the RTS publish; at ``device_recv`` (materialize)
#: ``delay``/``stall`` sleep before the semaphore wait, driving the
#: receiver's Deadline toward expiry.
#:
#: The tuple is grow-only: the ``faultsim_injected_<kind>`` MPI_T pvar
#: namespace is derived from it in order.
KINDS = ("drop", "delay", "dup", "trunc", "connkill", "stall",
         "ringfail", "dialfail", "daemonkill", "agentkill")

#: default hook site per kind (rules may override with ``site=``)
_DEFAULT_SITE = {
    "drop": "send", "delay": "send", "dup": "send", "trunc": "send",
    "connkill": "send", "stall": "ring", "ringfail": "ring",
    "dialfail": "dial", "daemonkill": "daemon", "agentkill": "agent",
}

_M64 = (1 << 64) - 1


class FaultPlanError(ValueError):
    """Malformed ``faultsim_plan`` text."""


@dataclass(frozen=True)
class Rule:
    """One parsed plan rule.  Exactly one trigger applies, checked in
    this order: ``at`` (1-based event index, one-shot), ``n`` (every
    event ≤ n — dialfail's "first n attempts"), ``every`` (periodic),
    ``p`` (hashed probability), else unconditional.  ``proc`` (when
    set) restricts the rule to that rank — the straggler-attribution
    tests use it to slow exactly one rank deterministically."""

    kind: str
    site: str
    p: float = 0.0
    at: int | None = None
    every: int | None = None
    n: int | None = None
    ms: float = 0.0
    proc: int | None = None

    def hits(self, seed: int, proc: int, k: int, idx: int) -> bool:
        if self.at is not None:
            return k == self.at
        if self.n is not None:
            return k <= self.n
        if self.every is not None:
            return self.every > 0 and k % self.every == 0
        if self.p:
            return _u01(seed, proc, self.site, k, idx) < self.p
        return True


def _mix(*parts) -> int:
    """splitmix64-style finalizer over FNV-folded inputs — stable
    across processes and Python versions (unlike ``hash``)."""
    x = 0xCBF29CE484222325
    for p in parts:
        if isinstance(p, str):
            p = zlib.crc32(p.encode())
        x = ((x ^ (int(p) & _M64)) * 0x100000001B3) & _M64
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _u01(*parts) -> float:
    return _mix(*parts) / 2.0**64


def parse_plan(text: str) -> tuple[Rule, ...]:
    """Parse the plan grammar (see the package docstring)."""
    rules: list[Rule] = []
    for chunk in (text or "").split(","):
        chunk = chunk.strip()
        if not chunk:
            continue
        kind, _, argtext = chunk.partition(":")
        kind = kind.strip()
        if kind not in KINDS:
            raise FaultPlanError(
                f"unknown fault kind {kind!r} (known: {', '.join(KINDS)})")
        kw: dict = {"kind": kind, "site": _DEFAULT_SITE[kind]}
        for arg in argtext.split(";"):
            arg = arg.strip()
            if not arg:
                continue
            key, eq, val = arg.partition("=")
            key = key.strip()
            if not eq:
                raise FaultPlanError(f"malformed arg {arg!r} in {chunk!r}")
            try:
                if key == "p":
                    kw["p"] = float(val)
                elif key in ("at", "every", "n", "proc"):
                    kw[key] = int(val)
                elif key == "ms":
                    kw["ms"] = float(val)
                elif key == "site":
                    kw["site"] = val.strip()
                else:
                    raise FaultPlanError(
                        f"unknown arg {key!r} in {chunk!r}")
            except ValueError as e:
                if isinstance(e, FaultPlanError):
                    raise
                raise FaultPlanError(
                    f"bad value {val!r} for {key!r} in {chunk!r}") from e
        rules.append(Rule(**kw))
    return tuple(rules)


class FaultPlan:
    """Seeded plan instance for one process: site-indexed rules plus
    the per-site event counters the decisions key on."""

    def __init__(self, rules: tuple[Rule, ...], seed: int, proc: int):
        self.rules = rules
        self.seed = int(seed)
        self.proc = int(proc)
        self._by_site: dict[str, list[tuple[int, Rule]]] = {}
        for idx, r in enumerate(rules):
            self._by_site.setdefault(r.site, []).append((idx, r))
        self._events: dict[str, int] = {}
        self.injected: dict[str, int] = {k: 0 for k in KINDS}
        self._lock = threading.Lock()

    def decide(self, site: str,
               kinds: frozenset | set | None = None) -> tuple[Rule, ...]:
        """Number this site event and return the rules that fire on it
        (usually empty).  ``kinds`` names the fault kinds the calling
        hook can actually PERFORM on this event (e.g. the recv loop
        can only drop eager frames): unsupported rules are excluded
        before evaluation, so the injected counters record faults that
        happened, never phantom hits — and since each rule draws an
        independent hash stream, the filter cannot perturb other
        rules' decisions.  Injection counters update here so every
        consumer of a returned action is already counted."""
        rules = self._by_site.get(site)
        if not rules:
            return ()
        with self._lock:
            k = self._events[site] = self._events.get(site, 0) + 1
        out = []
        for idx, r in rules:
            if kinds is not None and r.kind not in kinds:
                continue
            if r.proc is not None and r.proc != self.proc:
                continue  # rank-targeted rule: other ranks never fire it
            if r.hits(self.seed, self.proc, k, idx):
                with self._lock:
                    self.injected[r.kind] += 1
                out.append(r)
        if out:
            # flight-record the transport state at the injection point
            # (no-op unless metrics are enabled — the recorder's gate)
            from ompi_tpu_torch.metrics import flight as _flight

            _flight.record("fault_injected", site=site, event=k,
                           kinds=",".join(r.kind for r in out))
        return tuple(out)


_plan: FaultPlan | None = None


def enabled() -> bool:
    return _enabled


def configure(plan_text: str, seed: int = 0, proc: int | None = None) -> None:
    """Arm the fault plane (parses eagerly so a bad plan aborts at
    init, not mid-run)."""
    global _enabled, _plan
    rules = parse_plan(plan_text)
    if proc is None:
        proc = int(os.environ.get("OMPI_TPU_PROC", "0"))
    _plan = FaultPlan(rules, seed, proc)
    _enabled = True
    # contribute the injected total to the shared dcn_* counter schema
    from ompi_tpu_torch.metrics import core as _mcore

    _mcore.register_provider(_plan, _injected_provider)


def _injected_provider() -> dict[str, int]:
    plan = _plan
    if plan is None:
        return {}
    with plan._lock:
        return {"injected_faults": sum(plan.injected.values())}


def disable() -> None:
    global _enabled, _plan
    _enabled = False
    _plan = None
    # the native knobs (ring writer, tcp-send connkill, blocking-recv
    # delay) are process-wide C state armed at engine creation — disarm
    # them too (only if the library is already loaded; never trigger a
    # build from a teardown path)
    try:
        from ompi_tpu_torch.dcn import native as _native

        if _native._lib is not None:
            _native._lib.tdcn_fault_set(0, 1, -1)
            _native._lib.tdcn_fault_set_conn(-1)
            _native._lib.tdcn_fault_set_dup(-1)
            _native._lib.tdcn_fault_set_recv(0, 1)
    except Exception:  # noqa: BLE001 — teardown must not raise
        pass


def reset() -> None:
    """Test hook: drop all state."""
    disable()


def sync_from_store(store) -> None:
    """MCA wiring (``--mca faultsim_enable 1 faultsim_seed N
    faultsim_plan <plan>``) — same register+sync shape as trace and
    metrics; vars are centrally registered by core.var."""
    if not bool(store.get("faultsim_enable", False)):
        disable()
        return
    configure(str(store.get("faultsim_plan", "") or ""),
              seed=int(store.get("faultsim_seed", 0) or 0))


# -- hook-site helpers (callers gate on ``_enabled``) -------------------


def actions(site: str,
            kinds: frozenset | set | None = None) -> tuple[Rule, ...]:
    """The rules firing on this site event (empty when unarmed);
    ``kinds`` restricts to what the caller can perform (see
    :meth:`FaultPlan.decide`)."""
    plan = _plan
    if plan is None:
        return ()
    return plan.decide(site, kinds)


def apply_delay(rule: Rule) -> None:
    if rule.ms > 0:
        time.sleep(rule.ms / 1000.0)


def check_dial(address: str) -> None:
    """Dial-site hook: raise for injected connect failures."""
    for r in actions("dial", kinds={"dialfail", "delay"}):
        if r.kind == "dialfail":
            raise ConnectionRefusedError(
                f"faultsim: injected dial failure to {address}")
        if r.kind == "delay":
            apply_delay(r)


def counters() -> dict[str, int]:
    """Per-kind injected-fault counts (the chaos tally + snapshot
    section + ``faultsim_injected_<kind>`` pvar values)."""
    plan = _plan
    if plan is None:
        return {k: 0 for k in KINDS}
    with plan._lock:
        return dict(plan.injected)


def injected(kind: str | None = None) -> int:
    c = counters()
    return sum(c.values()) if kind is None else c.get(kind, 0)


def native_ring_args() -> tuple[int, int, int]:
    """(stall_ns, stall_every, fail_at) for ``tdcn_fault_set`` — how
    the seeded plan reaches the C ring-write path.  The C side keeps
    its own event counter (ring writes never reach Python), so ring
    rules support ``ms``/``every``/``at`` but not ``p`` — and C-plane
    injections count ONLY in the merged ``dcn_injected_faults``
    aggregate (the engine's stats block), not the per-kind
    ``faultsim_injected_stall/ringfail`` counters, which track the
    Python hook sites."""
    stall_ns, every, fail_at = 0, 1, -1
    plan = _plan
    if plan is None:
        return stall_ns, every, fail_at
    for r in plan.rules:
        if r.proc is not None and r.proc != plan.proc:
            continue
        if r.kind == "stall":
            stall_ns = int(r.ms * 1e6)
            if r.every:
                every = r.every
        elif r.kind == "ringfail" and r.at is not None:
            fail_at = r.at
    return stall_ns, every, fail_at


def native_conn_args() -> int:
    """``connkill_at`` for ``tdcn_fault_set_conn`` — how the seeded
    plan reaches the C tcp-send path (the native twin of the Python
    transport's connkill site).  The C side keeps its own send-event
    counter, so only ``at`` rules map; -1 = disarmed.  Like the ring
    knobs, C-plane hits count only in the engine's merged
    ``dcn_injected_faults``, not the per-kind Python counters."""
    plan = _plan
    if plan is None:
        return -1
    for r in plan.rules:
        if r.proc is not None and r.proc != plan.proc:
            continue
        if r.kind == "connkill" and r.at is not None:
            return r.at
    return -1


def native_dup_args() -> int:
    """``dup_at`` for ``tdcn_fault_set_dup`` — the seeded plan's wire-
    duplicate rule on the native plane: the Nth seq-carrying eager tcp
    send is transmitted twice, so the receiver's dedup watermark must
    absorb a true duplicate.  Only ``at`` rules map (the C side keeps
    its own event counter); -1 = disarmed."""
    plan = _plan
    if plan is None:
        return -1
    for r in plan.rules:
        if r.proc is not None and r.proc != plan.proc:
            continue
        if r.kind == "dup" and r.at is not None:
            return r.at
    return -1


def native_recv_args() -> tuple[int, int]:
    """(delay_ns, every) for ``tdcn_fault_set_recv`` — injected latency
    at the C blocking-receive entry (``tdcn_precv``: the native pml
    fast path AND the C-ABI shim's MPI_Recv).  Only periodic
    (``every``) or unconditional ``delay;site=recv`` rules map — the
    C side counts events itself, so ``p=``/``at=`` triggers cannot be
    honored there and are skipped rather than silently widened to
    every receive; the first matching rule wins (no mixing of one
    rule's delay with another's period)."""
    plan = _plan
    if plan is None:
        return 0, 1
    for r in plan.rules:
        if r.proc is not None and r.proc != plan.proc:
            continue
        if (r.kind == "delay" and r.site == "recv" and r.ms > 0
                and r.at is None and not r.p):
            return int(r.ms * 1e6), (r.every or 1)
    return 0, 1

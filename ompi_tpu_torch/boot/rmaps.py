"""``rmaps`` — rank-to-host mapping policies.

≈ the reference's ``prte/orte rmaps`` framework (SURVEY.md §2.4:
``round_robin``, ``ppr``, ``rank_file``, ``seq`` [bin]): given an
allocation (hosts with slot counts) and a process count, produce the
rank → host table the launcher (plm) executes.  Pure functions —
the mapping is testable without launching anything, the same way the
reference dry-runs mappers with ``prte --display map --do-not-launch``
(SURVEY.md §4).

Policies (``--map-by``):

* ``slot`` (default) — fill each host's slots before moving to the
  next (the reference's byslot round-robin);
* ``node`` — one rank per host, cycling (bynode);
* ``ppr:N`` — N processes per round per host (processes-per-resource);
* ``seq`` — the host list IS the per-rank sequence (rank r on
  hosts[r]; requires len(hosts) >= np).
"""

from __future__ import annotations

from ompi_tpu_torch.core.errors import MPIArgError


def _slots(text: str, context: str) -> int:
    try:
        n = int(text)
    except ValueError:
        raise MPIArgError(f"bad slot count {text!r} in {context}")
    if n < 1:
        raise MPIArgError(f"slot count must be >= 1 in {context}")
    return n


def parse_hostfile(text: str) -> list[tuple[str, int]]:
    """``host [slots=N]`` lines (comments/blank lines skipped) — the
    reference's hostfile grammar subset."""
    hosts: list[tuple[str, int]] = []
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        name = parts[0]
        slots = 1
        for p in parts[1:]:
            if p.startswith("slots="):
                slots = _slots(p.split("=", 1)[1], f"hostfile line {line!r}")
        hosts.append((name, slots))
    return hosts


def parse_host_list(spec: str) -> list[tuple[str, int]]:
    """``--host a,b:4,c`` — ``:N`` is the slot count (default 1; the
    suffix is only a slot count when it is numeric, so IPv6 literals
    like ``::1`` stay whole)."""
    hosts = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        name, sep, suffix = item.rpartition(":")
        if sep and suffix.isdigit() and name:
            hosts.append((name, _slots(suffix, f"--host entry {item!r}")))
        else:
            hosts.append((item, 1))
    return hosts


def map_ranks(hosts: list[tuple[str, int]], np_: int,
              policy: str = "slot", oversubscribe: bool = False) -> list[str]:
    """rank → hostname table for ``np_`` ranks.

    Slots bound the per-host rank count unless ``oversubscribe``
    (matching ``mpirun --oversubscribe``); exceeding the allocation
    without it is the same hard error the reference raises.
    """
    if not hosts:
        raise MPIArgError("empty host allocation")
    if np_ < 1:
        raise MPIArgError(f"np must be >= 1, got {np_}")
    total_slots = sum(s for _, s in hosts)

    if policy == "seq":
        if len(hosts) < np_:
            raise MPIArgError(
                f"seq mapping needs one host entry per rank "
                f"({len(hosts)} < {np_})"
            )
        return [hosts[r][0] for r in range(np_)]

    if policy.startswith("ppr:"):
        try:
            per_round = int(policy.split(":", 1)[1])
        except ValueError:
            raise MPIArgError(f"bad ppr policy {policy!r} (want ppr:N)")
        if per_round < 1:
            raise MPIArgError("ppr count must be >= 1")
    elif policy == "node":
        per_round = 1
    elif policy == "slot":
        per_round = None  # fill slots
    else:
        raise MPIArgError(
            f"unknown mapping policy {policy!r} (slot|node|ppr:N|seq)"
        )

    if not oversubscribe and np_ > total_slots:
        raise MPIArgError(
            f"{np_} ranks exceed the {total_slots}-slot allocation; "
            f"use --oversubscribe to allow it"
        )

    out: list[str] = []
    if per_round is None:  # byslot: fill each host's slots in order,
        while len(out) < np_:  # wrapping only under --oversubscribe
            for name, slots in hosts:
                for _ in range(slots):
                    if len(out) < np_:
                        out.append(name)
            if not oversubscribe:
                break
        return out

    # bynode / ppr: per_round ranks per host each cycle, slot-bounded
    # (counts keyed by allocation-entry index: duplicate host names are
    # distinct slot pools, as in a hostfile that repeats a host)
    counts = [0] * len(hosts)
    while len(out) < np_:
        progressed = False
        for i, (name, slots) in enumerate(hosts):
            for _ in range(per_round):
                if len(out) >= np_:
                    break
                if not oversubscribe and counts[i] >= slots:
                    continue
                counts[i] += 1
                out.append(name)
                progressed = True
        if not progressed:
            break
    if len(out) < np_:
        raise MPIArgError(
            f"mapping stalled at {len(out)}/{np_} ranks over "
            f"{sum(s for _, s in hosts)} slots (policy {policy})"
        )
    return out


def render_map(table: list[str]) -> str:
    """``--display-map`` text (≈ prte --display map)."""
    lines = ["JOB MAP"]
    byhost: dict[str, list[int]] = {}
    for r, h in enumerate(table):
        byhost.setdefault(h, []).append(r)
    for h, ranks in byhost.items():
        lines.append(f"  host {h}: ranks {','.join(map(str, ranks))}")
    return "\n".join(lines)

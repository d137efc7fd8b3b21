"""``ras`` — resource-allocation readers (SLURM / Grid Engine).

≈ the reference's ``prte/orte ras`` framework (SURVEY.md §2.4:
``ras/slurm``, ``ras/gridengine`` [bin]): when the job was started
inside a resource manager's allocation, adopt that allocation as the
host table instead of requiring ``--host``/``--hostfile``.  Pure
environment/file parsing — testable with a fabricated allocation, the
same dry-run technique the rmaps tests use.

SLURM grammar handled (the subset ras/slurm parses):

* ``SLURM_JOB_NODELIST`` (fallback ``SLURM_NODELIST``) — compressed
  node expressions: ``n[001-003,007],login1,gpu[2,4-5]`` with
  zero-padded numeric ranges;
* ``SLURM_TASKS_PER_NODE`` (fallback ``SLURM_JOB_CPUS_PER_NODE``) —
  per-node slot counts with repetition: ``2(x3),1`` pairs with the
  expanded node list positionally.

Grid Engine: ``PE_HOSTFILE`` points at a file of
``host slots queue processor`` lines.
"""

from __future__ import annotations

import re

from ompi_tpu_torch.core.errors import MPIArgError


def expand_nodelist(spec: str) -> list[str]:
    """Expand a SLURM compressed node expression into host names."""
    hosts: list[str] = []
    i, n = 0, len(spec)
    while i < n:
        # one item: prefix possibly followed by ONE [ranges] group
        # (SLURM emits per-prefix groups; nested brackets don't occur)
        j = i
        while j < n and spec[j] not in ",[":
            j += 1
        prefix = spec[i:j]
        if j < n and spec[j] == "[":
            k = spec.index("]", j)  # ValueError → caller's MPIArgError
            body = spec[j + 1 : k]
            for part in body.split(","):
                if "-" in part:
                    lo, hi = part.split("-", 1)
                    width = len(lo) if lo.startswith("0") else 0
                    for v in range(int(lo), int(hi) + 1):
                        hosts.append(f"{prefix}{v:0{width}d}" if width
                                     else f"{prefix}{v}")
                else:
                    hosts.append(prefix + part)
            i = k + 1
            if i < n and spec[i] == ",":
                i += 1
        else:
            if prefix:
                hosts.append(prefix)
            i = j + 1
    return hosts


def expand_tasks_per_node(spec: str) -> list[int]:
    """``2(x3),1`` → [2, 2, 2, 1]."""
    out: list[int] = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        m = re.fullmatch(r"(\d+)(?:\(x(\d+)\))?", item)
        if not m:
            raise MPIArgError(f"bad SLURM_TASKS_PER_NODE item {item!r}")
        out.extend([int(m.group(1))] * int(m.group(2) or 1))
    return out


def read_slurm(env) -> list[tuple[str, int]]:
    """(host, slots) allocation from a SLURM job environment."""
    nodelist = env.get("SLURM_JOB_NODELIST") or env.get("SLURM_NODELIST")
    if not nodelist:
        raise MPIArgError(
            "--ras slurm: no SLURM allocation in the environment "
            "(SLURM_JOB_NODELIST unset)"
        )
    try:
        hosts = expand_nodelist(nodelist)
    except ValueError as e:
        raise MPIArgError(f"bad SLURM nodelist {nodelist!r}: {e}")
    if not hosts:
        raise MPIArgError(f"empty SLURM nodelist {nodelist!r}")
    tasks = env.get("SLURM_TASKS_PER_NODE") or env.get(
        "SLURM_JOB_CPUS_PER_NODE")
    if tasks:
        counts = expand_tasks_per_node(tasks)
        if len(counts) < len(hosts):
            # SLURM pads the last group; be permissive, repeat the tail
            counts.extend([counts[-1]] * (len(hosts) - len(counts)))
        return list(zip(hosts, counts[: len(hosts)]))
    return [(h, 1) for h in hosts]


def read_gridengine(env) -> list[tuple[str, int]]:
    """(host, slots) from a Grid Engine ``PE_HOSTFILE``."""
    path = env.get("PE_HOSTFILE")
    if not path:
        raise MPIArgError(
            "--ras gridengine: PE_HOSTFILE unset in the environment"
        )
    hosts: list[tuple[str, int]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            slots = 1
            if len(parts) > 1:
                try:
                    slots = max(1, int(parts[1]))
                except ValueError:
                    pass
            hosts.append((parts[0], slots))
    if not hosts:
        raise MPIArgError(f"empty PE_HOSTFILE {path}")
    return hosts


def detect(env) -> list[tuple[str, int]] | None:
    """``--ras auto``: adopt whichever manager's allocation is present
    (SLURM first, then Grid Engine); None when outside any."""
    if env.get("SLURM_JOB_NODELIST") or env.get("SLURM_NODELIST"):
        return read_slurm(env)
    if env.get("PE_HOSTFILE"):
        return read_gridengine(env)
    return None

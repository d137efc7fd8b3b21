"""``coll/tuned`` — the algorithm decision layer.

Port of ``ompi_tpu/coll/tuned.py`` (≈ ``ompi/mca/coll/tuned``).  Tuned
implements no algorithm of its own: it picks one per call signature,
keyed on (communicator size, per-rank message bytes), and forces it on
the ``coll/cuda`` module below it through :meth:`CudaCollModule.forced`.
Two sources, as in the reference:

* **fixed rules** (:func:`fixed_decision`): the fused rank-axis
  reduction whenever the op has one and commutes; for other commutative
  ops a size ladder — recursive doubling, then Rabenseifner from
  ``coll_tuned_large_msg``, then from ``coll_tuned_huge_msg`` the
  ``cuda_ring`` kernels where the kernel leg can run (a CUDA mesh on an
  sm_90 card; the reference's ``pallas_ring`` on a TPU) and
  ``ring_segmented`` everywhere else; the ordered fold for
  non-commutative ops;
* **dynamic rules** (``--mca coll_tuned_use_dynamic_rules 1`` +
  ``coll_tuned_dynamic_rules_filename``): the reference's rule-file
  format (:func:`parse_rules_file`), algorithm numbers being coll/cuda's
  enums (which are the reference's, ``cuda_ring`` in the ``pallas_ring``
  slots).

An explicitly pinned ``coll_cuda_<coll>_algorithm`` bypasses the
decision.  A ``devices``-layout comm gets the reference's decision for
the same (collective, size, bytes per rank, op); the kernel leg is read
for every card of its mesh.  PRIORITY 95 stacks tuned above coll/cuda (90), so tuned wins
every slot coll/cuda serves.  :meth:`TunedCollModule.resolve` bakes the
decision into the callable that ``Comm`` caches under the var store's
version, so the hot loop stays one dict hit.
"""

from __future__ import annotations

import warnings
from typing import Any

import torch

from ompi_tpu_torch.core.errors import MPIArgError
from ompi_tpu_torch.core.registry import Component, register_component
from ompi_tpu_torch.op.op import Op
from ompi_tpu_torch.tool.spc import payload_nbytes
from ompi_tpu_torch.trace import core as _trace

from . import cuda_kernels as ck
from .cuda import (
    ALLGATHER_ALGOS,
    ALLREDUCE_ALGOS,
    ALLTOALL_ALGOS,
    BARRIER_ALGOS,
    BCAST_ALGOS,
    REDUCE_ALGOS,
    REDUCE_SCATTER_ALGOS,
    CudaCollModule,
)
from .module import COLL_OPS, CollModule

# Collective ids in the reference's dynamic-rule files
# (ompi/mca/coll/base/coll_base_functions.h COLLCOUNT order).
COLL_IDS = {
    "allgather": 0,
    "allgatherv": 1,
    "allreduce": 2,
    "alltoall": 3,
    "alltoallv": 4,
    "alltoallw": 5,
    "barrier": 6,
    "bcast": 7,
    "exscan": 8,
    "gather": 9,
    "gatherv": 10,
    "reduce": 11,
    "reduce_scatter": 12,
    "reduce_scatter_block": 13,
    "scan": 14,
    "scatter": 15,
    "scatterv": 16,
}

#: which algorithm-enum var each collective's decision drives
_ALGO_VAR = {
    "allreduce": ("allreduce_algorithm", ALLREDUCE_ALGOS),
    "bcast": ("bcast_algorithm", BCAST_ALGOS),
    "reduce": ("reduce_algorithm", REDUCE_ALGOS),
    "allgather": ("allgather_algorithm", ALLGATHER_ALGOS),
    "gather": ("allgather_algorithm", ALLGATHER_ALGOS),
    "alltoall": ("alltoall_algorithm", ALLTOALL_ALGOS),
    "reduce_scatter": ("reduce_scatter_algorithm", REDUCE_SCATTER_ALGOS),
    "reduce_scatter_block": ("reduce_scatter_algorithm", REDUCE_SCATTER_ALGOS),
    "barrier": ("barrier_algorithm", BARRIER_ALGOS),
}

#: collectives whose second positional argument is the reduction op
_HAS_OP = {"allreduce", "reduce", "reduce_scatter", "reduce_scatter_block",
           "scan", "exscan"}

#: coll_id → valid algorithm ids (0 = "use the fixed decision")
_VALID_ALGS = {
    COLL_IDS[name]: set(enum.values()) for name, (_, enum) in _ALGO_VAR.items()
}


class RuleSet:
    """Parsed dynamic rules: coll_id → [(comm_size, [(msg, alg, fanio,
    segsize)])], both levels sorted ascending."""

    def __init__(self, rules: dict[int, list[tuple[int, list[tuple[int, int, int, int]]]]]):
        self.rules = rules

    def lookup(self, coll: str, comm_size: int, msg_bytes: int) -> tuple[int, int] | None:
        """(algorithm, segsize) from the best-matching rule, or None: the
        largest registered comm size ≤ actual, then the largest msg size
        ≤ actual; an algorithm of 0 falls back to the fixed decision."""
        per_coll = self.rules.get(COLL_IDS.get(coll, -1))
        if not per_coll:
            return None
        bracket = None
        for size, msg_rules in per_coll:
            if size <= comm_size:
                bracket = msg_rules
        if bracket is None:
            return None
        chosen = None
        for msg, alg, _fanio, segsize in bracket:
            if msg <= msg_bytes:
                chosen = (alg, segsize)
        if chosen is None or chosen[0] == 0:
            return None
        return chosen


def parse_rules_file(text: str) -> RuleSet:
    """Parse the reference's coll_tuned dynamic rules format:
    ``n_collectives`` then per collective ``coll_id``, ``n_comm_sizes``,
    then per comm size ``comm_size``, ``n_msg_rules``, then per rule
    ``msg_size alg faninout segsize``; ``#`` comments anywhere."""
    toks: list[int] = []
    for line in text.splitlines():
        for t in line.split("#", 1)[0].split():
            try:
                toks.append(int(t))
            except ValueError as e:
                raise MPIArgError(f"bad token {t!r} in rules file") from e
    it = iter(toks)

    def nxt(what: str) -> int:
        try:
            return next(it)
        except StopIteration:
            raise MPIArgError(f"rules file truncated reading {what}") from None

    rules: dict[int, list[tuple[int, list[tuple[int, int, int, int]]]]] = {}
    for _ in range(nxt("collective count")):
        cid = nxt("collective id")
        brackets = []
        for _ in range(nxt("comm-size count")):
            csize = nxt("comm size")
            rows = []
            for _ in range(nxt("rule count")):
                rows.append((nxt("msg"), nxt("alg"), nxt("fanio"), nxt("segsize")))
                valid = _VALID_ALGS.get(cid)
                if valid is not None and rows[-1][1] not in valid:
                    raise MPIArgError(
                        f"rules file names algorithm {rows[-1][1]} for "
                        f"collective id {cid}; valid ids: {sorted(valid)}")
            rows.sort(key=lambda r: r[0])
            brackets.append((csize, rows))
        brackets.sort(key=lambda b: b[0])
        rules[cid] = brackets
    return RuleSet(rules)


def kernel_leg(device) -> bool:
    """Whether the ``cuda_ring`` kernels can run for a mesh on ``device``
    (one device, or every rank's device of a ``devices``-layout mesh):
    CUDA devices only, on a machine with an sm_90 card."""
    if device is None:
        return False
    devices = device if isinstance(device, (tuple, list)) else (device,)
    return bool(devices) and all(torch.device(d).type == "cuda" for d in devices) \
        and ck.kernel_available()


def fixed_decision(coll: str, comm_size: int, msg_bytes: int, op: Op | None,
                   large: int, huge: int, device=None) -> tuple[int | None, int | None]:
    """The fixed decision tables (≈ ompi_coll_tuned_*_intra_dec_fixed).

    Returns (algorithm id or None for the module default, segcount or
    None).  ``large``/``huge`` are ``coll_tuned_large_msg`` /
    ``coll_tuned_huge_msg``; ``device`` is the communicator's mesh
    device (every rank's device on the ``devices`` layout), which decides
    whether the huge software-op allreduce can take the ``cuda_ring``
    kernels."""
    if coll == "allreduce":
        if op is None:
            raise MPIArgError("the allreduce decision needs an op")
        if op.collective is not None and op.commutative:
            return ALLREDUCE_ALGOS["psum"], None
        if not op.commutative:
            return ALLREDUCE_ALGOS["ordered_linear"], None
        if msg_bytes >= huge:
            if kernel_leg(device):
                return ALLREDUCE_ALGOS["cuda_ring"], None
            return ALLREDUCE_ALGOS["ring_segmented"], None
        if msg_bytes >= large:
            # Rabenseifner needs pow2 (coll/cuda falls back to ring)
            return ALLREDUCE_ALGOS["rabenseifner"], None
        return ALLREDUCE_ALGOS["recursive_doubling"], None
    if coll == "bcast":
        if msg_bytes >= huge:
            return BCAST_ALGOS["pipeline"], None
        return BCAST_ALGOS["direct"], None
    if coll == "reduce":
        if op is not None and not op.commutative:
            return REDUCE_ALGOS["ordered"], None
        return REDUCE_ALGOS["binomial"], None
    if coll in ("allgather", "gather"):
        if msg_bytes >= huge:
            return ALLGATHER_ALGOS["ring"], None
        return ALLGATHER_ALGOS["direct"], None
    if coll == "alltoall":
        if msg_bytes >= huge:
            return ALLTOALL_ALGOS["pairwise"], None
        return ALLTOALL_ALGOS["direct"], None
    if coll in ("reduce_scatter", "reduce_scatter_block"):
        if op is not None and op.collective == "sum":
            return REDUCE_SCATTER_ALGOS["direct"], None
        if op is not None and not op.commutative:
            return REDUCE_SCATTER_ALGOS["ordered"], None
        return REDUCE_SCATTER_ALGOS["ring"], None
    if coll == "barrier":
        return (BARRIER_ALGOS["dissemination"] if comm_size > 16
                else BARRIER_ALGOS["allreduce"]), None
    return None, None


#: DCN-plane schedule ids for the reference's C collective fast path
#: (kept so that the numbers match when the multi-process planes land)
DCN_LINEAR, DCN_RING = 0, 1


def dcn_fixed_decision(coll: str, comm_size: int, msg_bytes: int,
                       op: Op | None, ring_threshold: int,
                       reproducible: bool = False) -> int:
    """The decision for an inter-process schedule: only ``allreduce`` has
    a ring; reproducible mode and non-commutative ops pin the linear
    fold; the ring from ``ring_threshold`` bytes."""
    del comm_size  # the DCN crossover is size-in-bytes driven
    if coll != "allreduce" or reproducible:
        return DCN_LINEAR
    if op is not None and not getattr(op, "commutative", False):
        return DCN_LINEAR
    return DCN_RING if msg_bytes >= ring_threshold else DCN_LINEAR


class TunedCollModule(CollModule):
    """Per-communicator decision module: wraps the comm's coll/cuda
    module and forces its per-call algorithm through ``forced``."""

    def __init__(self, comm, component: "TunedCollComponent", inner: CudaCollModule):
        super().__init__(comm)
        self.component = component
        self.inner = inner

    def provided(self) -> dict[str, Any]:
        """Exactly the slots the delegate provides, each wrapped."""
        return {slot: self._make_wrapper(slot, fn)
                for slot, fn in self.inner.provided().items()}

    def enable(self) -> None:
        self.inner.enable()

    @staticmethod
    def _base_op(slot: str) -> str:
        if slot.endswith("_init"):
            return slot[: -len("_init")]
        if slot.startswith("i") and slot[1:] in COLL_OPS:
            return slot[1:]
        return slot

    def _make_wrapper(self, slot: str, fn):
        base = self._base_op(slot)

        def wrapper(*args, **kwargs):
            with self.inner.forced(**self._decide(base, args, kwargs)):
                return fn(*args, **kwargs)

        wrapper.__name__ = f"tuned_{slot}"
        return wrapper

    def resolve(self, base: str, *args):
        """Run the decision once for this call signature and hand the
        forced choice to the inner module's resolver: the callable the
        api layer caches bakes the decision in, valid until the var
        store changes (the cache keys on its version)."""
        with self.inner.forced(**self._decide(base, args, {})):
            return self.inner.resolve(base, *args)

    def _decide(self, coll: str, args, kwargs) -> dict[str, int]:
        var_enum = _ALGO_VAR.get(coll)
        if var_enum is None:
            return {}
        var, enum = var_enum
        store = self.component.store
        # a pinned coll_cuda_*_algorithm (non-auto) bypasses the decision
        # layer: "algorithm 0 = let the decision function choose"
        if int(store.get(f"coll_cuda_{var}", 0)) != 0:
            return {}
        n = self.comm.size
        # per-rank bytes of the staged rank-major buffer (a tensor or a
        # RankShards here, a jax array in the reference: all report the
        # same nbytes, so both layouts decide as the reference does)
        msg_bytes = payload_nbytes(args[0]) // max(n, 1) if args else 0
        op = None
        if coll in _HAS_OP:
            op = kwargs.get("op")
            if op is None and len(args) > 1 and isinstance(args[1], Op):
                op = args[1]
        # dynamic rules first (an explicit rule wins, as in the reference)
        if self.component.ruleset is not None:
            hit = self.component.ruleset.lookup(coll, n, msg_bytes)
            if hit is not None:
                alg, segsize = hit  # id validity enforced at parse time
                out = {var: alg}
                if segsize:
                    # the file's segsize is bytes, segcount elements: the
                    # element size is unknown here, so divide by 4 (rule
                    # files assume a datatype, as the reference's do)
                    out["segcount"] = max(1, segsize // 4)
                if _trace._enabled:
                    self._trace_decision(coll, n, msg_bytes, enum, alg, "dynamic",
                                         self.comm.mesh.layout)
                return out
        large = int(store.get("coll_tuned_large_msg", 1 << 20))
        huge = int(store.get("coll_tuned_huge_msg", 64 << 20))
        mesh = self.comm.mesh
        alg, seg = fixed_decision(coll, n, msg_bytes, op, large, huge,
                                  device=mesh.devices if mesh.layout == "devices"
                                  else mesh.device)
        out: dict[str, int] = {}
        if alg is not None:
            out[var] = alg
        if seg is not None:
            out["segcount"] = seg
        if _trace._enabled and alg is not None:
            self._trace_decision(coll, n, msg_bytes, enum, alg, "fixed", mesh.layout)
        return out

    @staticmethod
    def _trace_decision(coll: str, n: int, msg_bytes: int, enum, alg: int,
                        source: str, layout: str) -> None:
        """Timeline record of which algorithm this decision picked; on the
        devices layout it names the layout (the rows layout's record is
        the reference's, key for key)."""
        name = next((k for k, v in enum.items() if v == alg), str(alg))
        extra = {"layout": layout} if layout == "devices" else {}
        _trace.instant("coll", "tuned_decision", coll=coll, comm_size=n,
                       msg_bytes=msg_bytes, algorithm=name, source=source, **extra)


@register_component
class TunedCollComponent(Component):
    FRAMEWORK = "coll"
    NAME = "tuned"
    PRIORITY = 95  # above cuda (90): tuned is the default decision layer

    def __init__(self):
        super().__init__()
        self.store = None
        self.ruleset: RuleSet | None = None

    def register_params(self, store) -> None:
        super().register_params(store)
        self.store = store
        store.register(
            "coll", "tuned", "use_dynamic_rules", False,
            help="Consult the dynamic rules file before fixed decisions",
        )
        store.register(
            "coll", "tuned", "dynamic_rules_filename", "", type="string",
            help="Path to a coll_tuned-format dynamic rules file",
        )
        store.register(
            "coll", "tuned", "large_msg", 1 << 20, type="int",
            help="Per-rank bytes from which large-message algorithms are chosen",
        )
        store.register(
            "coll", "tuned", "huge_msg", 64 << 20, type="int",
            help="Per-rank bytes from which segmented/pipelined algorithms "
            "(or the cuda_ring kernels, on a CUDA mesh) are chosen",
        )

    def open(self, store) -> bool:
        self.ruleset = None
        if store.get("coll_tuned_use_dynamic_rules", False):
            path = str(store.get("coll_tuned_dynamic_rules_filename", ""))
            if path:
                try:
                    with open(path) as f:
                        self.ruleset = parse_rules_file(f.read())
                except (OSError, MPIArgError) as e:
                    # the reference warns and keeps the fixed decisions
                    warnings.warn(
                        f"coll/tuned: ignoring dynamic rules file {path}: {e}",
                        RuntimeWarning, stacklevel=2)
        return True

    def query(self, comm, table=None) -> TunedCollModule | None:
        # tuned serves wherever coll/cuda serves: wrap the comm's cuda
        # module, already stacked at lower priority in the partial table
        if table is None:
            return None
        inner = next((m for m in table.modules if isinstance(m, CudaCollModule)), None)
        if inner is None:
            return None
        return TunedCollModule(comm, self, inner)

    query.wants_table = True

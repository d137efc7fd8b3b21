"""``python -m ompi_tpu_torch check --selftest``: seeded fixtures + the
live-tree contract gate, the reference's selftest over the port.

Two halves:

1. **Seeded fixtures** — a throwaway mini-tree per pass, written under
   ``ompi_tpu_torch/`` paths, carrying one known violation (unbounded
   spin without Deadline, an unregistered ``--mca`` var, a two-lock
   order cycle, a renamed ``TDCN_STAT_NAMES`` counter, a CUDA kernel
   library whose ``extern "C"`` arity disagrees with its ctypes
   declaration) next to a clean twin; each pass must flag exactly the
   seeded site and stay quiet on the twin.  The waiver round-trip (a
   matching waiver suppresses the finding; a stale waiver is itself
   reported) and the runtime lockdep witness (an observed order
   inversion raises) prove the reporting plumbing.
2. **The live tree** — the three static passes run against the port's
   files with ``ompi_tpu_torch/analysis/waivers.toml`` applied; any
   unwaived error or stale waiver fails the selftest.

The fixture builders are importable (``tests/test_torch_analysis.py``
uses them directly); :func:`run_selftest` is the entry point.
"""

from __future__ import annotations

import tempfile
import threading
from pathlib import Path

from ompi_tpu_torch.analysis import abidrift, invariants, lockdep, lockorder
from ompi_tpu_torch.analysis import findings as F
from ompi_tpu_torch.analysis.repo import PORT, README_SECTION

#: the port's reviewed waiver file, relative to the repo root
WAIVERS = f"{PORT}/analysis/waivers.toml"

# -- fixture builders ----------------------------------------------------

_FIXTURE_VAR_PY = '''\
OBSERVABILITY_VARS = (
    ("trace", "", "enable", False, "fixture knob"),
)
ROBUSTNESS_VARS = ()
SERVING_VARS = ()
'''

_FIXTURE_SPIN_BAD = '''\
import time


def pump(ring):
    """Seeded violation: unbounded spin with no wait policy."""
    while True:
        if ring.poll():
            return ring.take()
        time.sleep(0.01)
'''

_FIXTURE_SPIN_GOOD = '''\
import time


def pump_bounded(ring, deadline):
    """Clean twin: the enclosing function consults a Deadline."""
    while True:
        if ring.poll():
            return ring.take()
        deadline.check()
        time.sleep(0.01)
'''

_FIXTURE_LOCK_CYCLE = '''\
import threading


class Engine:
    def __init__(self):
        self.lock_a = threading.Lock()
        self.lock_b = threading.Lock()

    def fwd(self):
        with self.lock_a:
            with self.lock_b:
                return 1

    def rev(self):
        with self.lock_b:
            with self.lock_a:
                return 2
'''

_FIXTURE_LOCK_CLEAN = '''\
import threading


class Orderly:
    def __init__(self):
        self.lock_x = threading.Lock()
        self.lock_y = threading.Lock()

    def one(self):
        with self.lock_x:
            with self.lock_y:
                return 1

    def two(self):
        with self.lock_x:
            with self.lock_y:
                return 2
'''

#: the real v1 counter tail (metrics/core.py order) — fixtures carry
#: the full frozen prefix so append-only checks behave as on head
_COUNTERS = ("doorbells", "stall_ns", "ring_stall_ns", "ring_stalls",
             "ring_hwm", "cts_wait_ns", "cts_waits", "rndv_depth",
             "rndv_hwm", "slot_waits", "eager_msgs", "eager_bytes",
             "chunked_msgs", "chunked_bytes", "rndv_msgs", "rndv_bytes",
             "delivered", "unexpected_hwm")


def _fixture_dcn_cc(names: tuple[str, ...]) -> str:
    joined = ",".join(("version",) + names)
    quoted = "\n    ".join(f'"{part},"' for part in joined.split(",")[:-1])
    return (f'static const char *TDCN_STAT_NAMES =\n    {quoted}\n'
            f'    "{joined.rsplit(",", 1)[1]}";\n')


def _fixture_metrics_core(names: tuple[str, ...]) -> str:
    rows = "\n".join(f'    "{n}",' for n in names)
    return f"NATIVE_COUNTERS = (\n{rows}\n)\n"


#: the real v1 wire-context field table (trace/causal.py order)
_CTX_FIELDS = ("v", "comm", "op", "seq", "hop")


def _fixture_causal_py(fields: tuple[str, ...],
                       pvars: tuple[str, ...]) -> str:
    frows = ", ".join(f'"{f}"' for f in fields)
    prows = ", ".join(f'"{p}"' for p in pvars)
    return (f"CTX_VERSION = 1\nCTX_FIELDS = ({frows})\n"
            f"PVARS = ({prows})\n")


def _fixture_ctx_cc(fields: tuple[str, ...]) -> str:
    joined = ",".join(fields)
    return ('static const char *TDCN_TRACE_CTX_FIELDS =\n'
            f'    "{joined}";\n')


#: a CUDA kernel library shaped like ``csrc/ring_hop.cu``: a template
#: kernel and a width dispatch outside ``extern "C"``, a macro-generated
#: switch inside it
_FIXTURE_HOP_CU = '''\
#include <cuda_runtime.h>

template <typename V>
__global__ void hop_kernel(const V* src, V* dst, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) dst[i] = src[i];
}

template <typename V>
int launch_hop(const void* src, void* dst, long long n, cudaStream_t st) {
  hop_kernel<V><<<1, 32, 0, st>>>(static_cast<const V*>(src),
                                  static_cast<V*>(dst), n);
  return cudaGetLastError();
}

extern "C" {

int ompi_ring_hop(const void* src, void* dst, const int* src_idx,
                  const int* dst_idx, long long n, long long src_rows,
                  long long dst_rows, long long chunk_bytes, void* stream) {
  return launch_hop<unsigned char>(src, dst, chunk_bytes,
                                   static_cast<cudaStream_t>(stream));
}

int ompi_ring_hop_fold(const void* a, const void* b, void* d, const int* a_idx,
                       const int* b_idx, const int* d_idx, long long n,
                       long long a_rows, long long b_rows, long long d_rows,
                       long long m, int dtype, int op, int recv_first,
                       void* stream) {
#define OMPI_FOLD(T) return launch_hop<T>(a, d, m, static_cast<cudaStream_t>(stream))
  switch (dtype) {
    case 0: OMPI_FOLD(float);
    default: return cudaErrorInvalidValue;
  }
#undef OMPI_FOLD
}

}  // extern "C"
'''


def _fixture_cuda_kernels_py(fold_args: int, count_type: str) -> str:
    """The binding module of the fixture library: argtypes through the
    local aliases of a loader function, as ``coll/cuda_kernels.py``."""
    fold = ", ".join(["p"] * 6 + ["ll"] * 5 + ["i"] * 3 + ["p"])
    fold = ", ".join(fold.split(", ")[:fold_args])
    return (
        "import ctypes\n\n\n"
        "def _load(path):\n"
        "    lib = ctypes.CDLL(path)\n"
        "    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int\n"
        f"    lib.ompi_ring_hop.argtypes = [p, p, p, p, ll, ll, ll, {count_type}, p]\n"
        "    lib.ompi_ring_hop.restype = i\n"
        f"    lib.ompi_ring_hop_fold.argtypes = [{fold}]\n"
        "    lib.ompi_ring_hop_fold.restype = i\n"
        "    return lib\n")


def build_fixture_tree(root: Path, *, spin: str = "bad",
                       mca_ref: str = "trace_enable",
                       locks: str = "cycle",
                       rename_counter: str | None = None,
                       stats_key: str | None = None,
                       ctx_fields: tuple[str, ...] | None = None,
                       ctx_c_fields: tuple[str, ...] | None = None,
                       causal_pvars: tuple[str, ...] | None = None,
                       cuda_abi: str | None = None) -> Path:
    """Materialize a seeded mini-tree of the port under ``root``.  Knobs
    select the violation (or its clean twin) per pass:

    * ``spin``: "bad" → unbounded spin in dcn scope; "good" → Deadline.
    * ``mca_ref``: the var name the fixture README's port section
      references.
    * ``locks``: "cycle" → opposite-order pair; "clean" → same order.
    * ``rename_counter``: rename this NATIVE_COUNTERS name on the C
      side only (ABI drift); None → both sides agree.
    * ``stats_key``: write a dcn/device.py whose STATS_KEYS carries
      this counter name (provider-merge-drift when it is not in
      NATIVE_COUNTERS); None → no device.py.
    * ``ctx_fields``/``ctx_c_fields``: write a trace/causal.py (and a
      TDCN_TRACE_CTX_FIELDS block in the fixture dcn.cc) carrying
      these wire-context field tables — disagree/reorder to seed
      wire-ctx-drift/append-only; None → no causal fixture.
    * ``causal_pvars``: PVARS tuple for the causal fixture (the
      pvar-name-lint input); defaults to a clean set.
    * ``cuda_abi``: write a CUDA kernel library (``csrc/ring_hop.cu``)
      and its binding module (``coll/cuda_kernels.py``): "arity" →
      ``ompi_ring_hop_fold`` declared with one parameter fewer than the
      ``.cu`` defines; "width" → ``ompi_ring_hop``'s 64-bit byte count
      declared ``c_int``; "clean" → both agree; None → no library.
    """
    pkg = root / PORT
    for sub in ("core", "dcn", "metrics", "csrc"):
        (pkg / sub).mkdir(parents=True, exist_ok=True)
    (pkg / "core" / "var.py").write_text(_FIXTURE_VAR_PY)
    (pkg / "dcn" / "pump.py").write_text(
        _FIXTURE_SPIN_BAD if spin == "bad" else _FIXTURE_SPIN_GOOD)
    (pkg / "dcn" / "tcp.py").write_text(
        _FIXTURE_LOCK_CYCLE if locks == "cycle" else _FIXTURE_LOCK_CLEAN)
    (pkg / "metrics" / "core.py").write_text(
        _fixture_metrics_core(_COUNTERS))
    c_names = _COUNTERS
    if rename_counter:
        c_names = tuple(f"{n}_v2" if n == rename_counter else n
                        for n in _COUNTERS)
    cc_text = _fixture_dcn_cc(c_names)
    if ctx_fields is not None or ctx_c_fields is not None:
        cc_text += _fixture_ctx_cc(ctx_c_fields or ctx_fields
                                   or _CTX_FIELDS)
        (pkg / "trace").mkdir(parents=True, exist_ok=True)
        (pkg / "trace" / "causal.py").write_text(
            _fixture_causal_py(ctx_fields or _CTX_FIELDS,
                               causal_pvars or ("records", "sends")))
    (pkg / "csrc" / "dcn.cc").write_text(cc_text)
    if stats_key is not None:
        (pkg / "dcn" / "device.py").write_text(
            f'STATS_KEYS = ("{stats_key}",)\n\n\n'
            "class Plane:\n"
            "    def __init__(self):\n"
            "        self.stats = {k: 0 for k in STATS_KEYS}\n")
    if cuda_abi is not None:
        (pkg / "coll").mkdir(parents=True, exist_ok=True)
        (pkg / "csrc" / "ring_hop.cu").write_text(_FIXTURE_HOP_CU)
        (pkg / "coll" / "cuda_kernels.py").write_text(_fixture_cuda_kernels_py(
            14 if cuda_abi == "arity" else 15,
            "i" if cuda_abi == "width" else "ll"))
    readme = (f"{README_SECTION}\n"
              f"Fixture repo.  Enable with ``--mca {mca_ref} 1``.\n"
              "Counters: " + ", ".join(f"`{n}`" for n in _COUNTERS)
              + "\n")
    if ctx_fields is not None or ctx_c_fields is not None:
        # document the DEFAULT pvar set so only a seeded odd name
        # trips the README half of pvar-name-lint
        readme += ("Causal pvars: `trace_causal_records`, "
                   "`trace_causal_sends`\n")
    (root / "README.md").write_text(readme)
    return root


# -- selftest legs -------------------------------------------------------

def _expect(log: list[str], ok, what: str) -> bool:
    ok = bool(ok)
    log.append(f"  {'ok' if ok else 'FAIL'}: {what}")
    return ok


def _leg_invariants(tmp: Path, log: list[str]) -> bool:
    bad = build_fixture_tree(tmp / "inv_bad")
    fs = invariants.run(bad)
    rules = {f.rule for f in fs}
    ok = _expect(log, "unbounded-spin" in rules,
                 "seeded Deadline-less spin detected")
    spin = [f for f in fs if f.rule == "unbounded-spin"]
    ok &= _expect(log, any(f.file == f"{PORT}/dcn/pump.py"
                           and f.symbol == "pump" for f in spin),
                  "spin finding anchored at pump()")
    good = build_fixture_tree(tmp / "inv_good", spin="good")
    fs2 = invariants.run(good)
    ok &= _expect(log, not any(f.rule == "unbounded-spin" for f in fs2),
                  "Deadline twin stays clean")
    mca = build_fixture_tree(tmp / "inv_mca", spin="good",
                             mca_ref="bogus_fixture_knob")
    fs3 = invariants.run(mca)
    ok &= _expect(log,
                  any(f.rule == "mca-unregistered"
                      and "bogus_fixture_knob" in f.message for f in fs3),
                  "unregistered --mca reference detected")
    return ok


def _leg_lockorder(tmp: Path, log: list[str]) -> bool:
    bad = build_fixture_tree(tmp / "lk_bad", spin="good")
    fs = lockorder.run(bad)
    cyc = [f for f in fs if f.rule == "lock-cycle"]
    ok = _expect(log, len(cyc) == 1, "seeded two-lock cycle detected")
    if cyc:
        ok &= _expect(log, "Engine.lock_a" in cyc[0].symbol
                      and "Engine.lock_b" in cyc[0].symbol,
                      "cycle names both lock classes")
    clean = build_fixture_tree(tmp / "lk_clean", spin="good",
                               locks="clean")
    fs2 = lockorder.run(clean)
    ok &= _expect(log, not any(f.rule == "lock-cycle" for f in fs2),
                  "consistent-order twin stays clean")
    return ok


def _leg_abidrift(tmp: Path, log: list[str]) -> bool:
    bad = build_fixture_tree(tmp / "abi_bad", spin="good",
                             rename_counter="delivered")
    fs = abidrift.check_stat_names(bad)
    rules = {f.rule for f in fs}
    ok = _expect(log, "stat-names-drift" in rules,
                 "renamed TDCN_STAT_NAMES entry detected as drift")
    ok &= _expect(log, "stat-append-only" in rules,
                  "rename inside the frozen v1 prefix flagged append-only")
    good = build_fixture_tree(tmp / "abi_good", spin="good")
    fs2 = abidrift.check_stat_names(good)
    ok &= _expect(log, not fs2, "agreeing tables stay clean")
    # provider-merge drift: a transport counter outside NATIVE_COUNTERS
    # would be silently dropped by the merge — seeded bad + clean twin
    pm_bad = build_fixture_tree(tmp / "abi_pm_bad", spin="good",
                                stats_key="bogus_counter")
    fs3 = abidrift.check_provider_merge(pm_bad)
    ok &= _expect(log,
                  any(f.rule == "provider-merge-drift"
                      and f.symbol == "bogus_counter" for f in fs3),
                  "unmerged transport counter detected")
    pm_good = build_fixture_tree(tmp / "abi_pm_good", spin="good",
                                 stats_key="delivered")
    fs4 = abidrift.check_provider_merge(pm_good)
    ok &= _expect(log, not fs4, "schema-covered counter stays clean")
    # causal wire-context mirror: a field renamed on the C side only
    # is drift; a reorder inside the frozen v1 prefix is append-only
    # breakage; agreeing tables stay clean
    cx_bad = build_fixture_tree(
        tmp / "abi_cx_bad", spin="good",
        ctx_fields=("v", "comm", "op", "seq", "hop"),
        ctx_c_fields=("v", "comm", "op", "seq", "hopidx"))
    fs5 = abidrift.check_trace_ctx(cx_bad)
    rules5 = {f.rule for f in fs5}
    ok &= _expect(log, "wire-ctx-drift" in rules5,
                  "renamed C ctx field detected as wire-ctx drift")
    ok &= _expect(log, "wire-ctx-append-only" in rules5,
                  "rename inside the frozen ctx prefix flagged "
                  "append-only")
    cx_good = build_fixture_tree(
        tmp / "abi_cx_good", spin="good",
        ctx_fields=("v", "comm", "op", "seq", "hop", "extra"),
        ctx_c_fields=("v", "comm", "op", "seq", "hop", "extra"))
    fs6 = abidrift.check_trace_ctx(cx_good)
    ok &= _expect(log, not fs6,
                  "agreeing ctx tables (appended tail) stay clean")
    # pvar name lint: a malformed causal pvar segment + one missing
    # from the README catalog; the default set stays clean
    pv_bad = build_fixture_tree(
        tmp / "abi_pv_bad", spin="good",
        ctx_fields=("v", "comm", "op", "seq", "hop"),
        causal_pvars=("records", "Bad-Name"))
    fs7 = abidrift.check_causal_pvars(pv_bad)
    ok &= _expect(log,
                  any(f.rule == "pvar-name-lint"
                      and "Bad-Name" in f.symbol for f in fs7),
                  "malformed trace_causal_* pvar name flagged")
    pv_good = build_fixture_tree(
        tmp / "abi_pv_good", spin="good",
        ctx_fields=("v", "comm", "op", "seq", "hop"))
    fs8 = abidrift.check_causal_pvars(pv_good)
    ok &= _expect(log, not fs8, "default causal pvar set stays clean")
    return ok


def _leg_cuda_abi(tmp: Path, log: list[str]) -> bool:
    """The ctypes rules over a CUDA kernel library: a seeded arity and
    width drift each flagged at the declaration, the clean twin quiet
    with both entry points checked."""
    binding = f"{PORT}/coll/cuda_kernels.py"
    bad = build_fixture_tree(tmp / "cu_arity", spin="good", cuda_abi="arity")
    fs = abidrift.check_ctypes(bad)
    ok = _expect(log, any(f.rule == "abi-arity" and f.file == binding
                          and f.symbol == "ompi_ring_hop_fold" for f in fs),
                 "seeded .cu extern arity drift detected")
    wide = build_fixture_tree(tmp / "cu_width", spin="good", cuda_abi="width")
    fs2 = abidrift.check_ctypes(wide)
    ok &= _expect(log, any(f.rule == "abi-type" and f.symbol == "ompi_ring_hop"
                           and "int64" in f.message for f in fs2),
                  "64-bit byte count declared c_int detected")
    clean = build_fixture_tree(tmp / "cu_clean", spin="good", cuda_abi="clean")
    checked: set[str] = set()
    fs3 = [f for f in abidrift.check_ctypes(clean, checked)
           if f.file == binding]
    ok &= _expect(log, not fs3 and checked >= {"ompi_ring_hop",
                                               "ompi_ring_hop_fold"},
                  "agreeing .cu library checked on both entry points, clean")
    return ok


def _leg_waivers(tmp: Path, log: list[str]) -> bool:
    bad = build_fixture_tree(tmp / "wv", )
    fs = invariants.run(bad)
    wv_text = (
        '[[waiver]]\npass = "invariants"\nrule = "unbounded-spin"\n'
        f'file = "{PORT}/dcn/pump.py"\nreason = "fixture: waived"\n\n'
        '[[waiver]]\npass = "invariants"\nrule = "hardcoded-timeout"\n'
        f'file = "{PORT}/dcn/nothere.py"\nreason = "fixture: stale"\n')
    wpath = tmp / "wv" / "waivers.toml"
    wpath.write_text(wv_text)
    waivers = F.load_waivers(wpath)
    merged = F.apply_waivers(fs, waivers)
    spin = [f for f in merged if f.rule == "unbounded-spin"]
    ok = _expect(log, spin and all(f.waived for f in spin),
                 "matching waiver suppresses the finding")
    ok &= _expect(log,
                  any(f.rule == "stale-waiver" for f in merged),
                  "no-match waiver reported stale")
    return ok


def _leg_lockdep(log: list[str]) -> bool:
    lockdep.enable()
    try:
        lockdep.reset()
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        vs = lockdep.violations()
        ok = _expect(log, any(v.kind == "inversion" for v in vs),
                     "runtime witness records the AB/BA inversion")
        raised = False
        try:
            lockdep.assert_clean()
        except lockdep.LockOrderInversion:
            raised = True
        ok &= _expect(log, raised, "assert_clean raises on inversion")
        lockdep.reset()
        with a:
            with b:
                pass
        with a:
            with b:
                pass
        ok &= _expect(log, not lockdep.violations(),
                      "consistent order stays clean")
    finally:
        lockdep.disable()
        lockdep.reset()
    return ok


def live_report(repo: Path) -> F.Report:
    """The three static passes over the port's tree, its waivers
    applied (stale waivers reported)."""
    report = F.Report(str(repo))
    for name, mod in (("invariants", invariants), ("lockorder", lockorder),
                      ("abidrift", abidrift)):
        report.extend(name, mod.run(repo))
    waivers = F.load_waivers(repo / WAIVERS)
    report.findings = F.apply_waivers(report.findings, waivers,
                                      passes_run=report.passes_run)
    return report


def _leg_live_repo(repo: Path, log: list[str]) -> bool:
    report = live_report(repo)
    bad = report.unwaived(F.SEV_ERROR)
    stale = [f for f in report.findings if f.rule == "stale-waiver"]
    ok = _expect(log, not bad and not stale,
                 f"live tree: 3 static passes, {len(report.findings)} "
                 f"findings, {sum(1 for f in report.findings if f.waived)} "
                 f"waived, {len(bad)} unwaived errors, {len(stale)} stale "
                 "waivers")
    for f in (bad + stale)[:10]:
        log.append("    " + f.render()[:160])
    return ok


def run_selftest(repo_root: str | Path) -> tuple[bool, list[str]]:
    """All selftest legs; returns (ok, human-readable log lines)."""
    repo = Path(repo_root)
    log: list[str] = []
    ok = True
    with tempfile.TemporaryDirectory(prefix="tpucheck_selftest_") as td:
        tmp = Path(td)
        log.append("fixture: invariant linter")
        ok &= _leg_invariants(tmp, log)
        log.append("fixture: lock-order analyzer")
        ok &= _leg_lockorder(tmp, log)
        log.append("fixture: ABI drift checker")
        ok &= _leg_abidrift(tmp, log)
        log.append("fixture: CUDA kernel ABI")
        ok &= _leg_cuda_abi(tmp, log)
        log.append("fixture: waiver round-trip")
        ok &= _leg_waivers(tmp, log)
        log.append("runtime: lockdep witness")
        ok &= _leg_lockdep(log)
        log.append("live tree: contract gate")
        ok &= _leg_live_repo(repo, log)
    return ok, log

"""tpucheck on the port (``ompi_tpu_torch/analysis/``).

The reference's cases (``tests/test_analysis.py``) on the port's passes,
fixtures and CLI; twin-fixture parity (every seeded reference fixture,
rewritten under ``ompi_tpu_torch/`` paths, draws the same findings from
the port's passes as from the reference's); the same scripted lock
sequences through both runtime witnesses; the ctypes rules over the
port's CUDA kernel libraries; the live gate on the port's tree; and the
repairs the port's first run of the checker asked for.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

from ompi_tpu.analysis import abidrift as ref_abidrift
from ompi_tpu.analysis import invariants as ref_invariants
from ompi_tpu.analysis import lockdep as ref_lockdep
from ompi_tpu.analysis import lockorder as ref_lockorder
from ompi_tpu.analysis.selftest import build_fixture_tree as ref_fixture_tree
from ompi_tpu_torch.analysis import abidrift, invariants, lockdep, lockorder
from ompi_tpu_torch.analysis import findings as F
from ompi_tpu_torch.analysis import memcheck, sanitize
from ompi_tpu_torch.analysis.repo import README_SECTION
from ompi_tpu_torch.analysis.selftest import WAIVERS, build_fixture_tree, live_report

PKG = "ompi_tpu_torch"


def _check(*args, timeout=300):
    return subprocess.run([sys.executable, "-m", PKG, "check", *args],
                          cwd=REPO, capture_output=True, timeout=timeout)


# -- pass 1: invariant linter ------------------------------------------


def test_spin_fixture_detected(tmp_path):
    root = build_fixture_tree(tmp_path, spin="bad")
    fs = invariants.run(root)
    spin = [f for f in fs if f.rule == "unbounded-spin"]
    assert len(spin) == 1
    assert spin[0].file == f"{PKG}/dcn/pump.py"
    assert spin[0].symbol == "pump"
    assert spin[0].severity == F.SEV_ERROR


def test_spin_deadline_twin_clean(tmp_path):
    root = build_fixture_tree(tmp_path, spin="good")
    assert not [f for f in invariants.run(root)
                if f.rule == "unbounded-spin"]


def test_mca_unregistered_fixture(tmp_path):
    root = build_fixture_tree(tmp_path, spin="good",
                              mca_ref="bogus_fixture_knob")
    fs = invariants.run(root)
    hits = [f for f in fs if f.rule == "mca-unregistered"]
    assert any("bogus_fixture_knob" in f.message for f in hits)
    # anchored at its README line (the section heading is line 1)
    assert [f.line for f in hits] == [2] and hits[0].file == "README.md"


def test_mca_registered_reference_clean(tmp_path):
    root = build_fixture_tree(tmp_path, spin="good",
                              mca_ref="trace_enable")
    assert not [f for f in invariants.run(root)
                if f.rule == "mca-unregistered"]


def test_mca_dead_registration(tmp_path):
    # the fixture README references trace_enable; drop the reference and
    # the central registration becomes a dead knob
    root = build_fixture_tree(tmp_path, spin="good", mca_ref="trace_enable")
    (root / "README.md").write_text(f"{README_SECTION}\nno knob references here\n")
    fs = invariants.run(root)
    dead = [f for f in fs if f.rule == "mca-dead-registration"]
    assert any("trace_enable" in f.message for f in dead)


def test_hardcoded_timeout_rule(tmp_path):
    root = build_fixture_tree(tmp_path, spin="good")
    (root / PKG / "dcn" / "waits.py").write_text(
        "import socket\n\n\n"
        "def dial(sock):\n"
        "    sock.settimeout(600)\n"
        "    return sock\n")
    fs = invariants.run(root)
    hits = [f for f in fs if f.rule == "hardcoded-timeout"]
    assert len(hits) == 1 and "600" in hits[0].message


def test_untyped_escalation_rule(tmp_path):
    root = build_fixture_tree(tmp_path, spin="good")
    (root / PKG / "dcn" / "tcp.py").write_text(
        "def escalate(peer):\n"
        "    raise RuntimeError(f'peer {peer} failed')\n")
    fs = invariants.run(root)
    hits = [f for f in fs if f.rule == "untyped-escalation"]
    assert len(hits) == 1 and hits[0].file == f"{PKG}/dcn/tcp.py"


def test_t0_latch_idiom_is_gated(tmp_path):
    """The hot-path `t0 = now() if _trace._enabled else 0` +
    `if t0:` idiom counts as gated — no ungated-hook finding."""
    root = build_fixture_tree(tmp_path, spin="good")
    (root / PKG / "trace").mkdir(parents=True)
    (root / PKG / "trace" / "core.py").write_text(
        "_enabled = False\n\n\n"
        "def now():\n    return 1\n\n\n"
        "def complete(kind):\n    pass\n")
    (root / PKG / "api").mkdir(parents=True)
    (root / PKG / "api" / "comm.py").write_text(
        f"from {PKG}.trace import core as _trace\n\n\n"
        "def dispatch(op):\n"
        "    t0 = _trace.now() if _trace._enabled else 0\n"
        "    result = op()\n"
        "    if t0:\n"
        "        _trace.complete('api')\n"
        "    return result\n\n\n"
        "def dispatch_ungated(op):\n"
        "    _trace.complete('api')\n"
        "    return op()\n")
    fs = invariants.run(root)
    hits = [f for f in fs if f.rule == "ungated-hook"]
    assert len(hits) == 1
    assert hits[0].symbol == "dispatch_ungated"


# -- pass 2: lock-order analyzer ---------------------------------------


def test_lock_cycle_fixture_detected(tmp_path):
    root = build_fixture_tree(tmp_path, spin="good", locks="cycle")
    fs = lockorder.run(root)
    cyc = [f for f in fs if f.rule == "lock-cycle"]
    assert len(cyc) == 1
    assert "Engine.lock_a" in cyc[0].symbol
    assert "Engine.lock_b" in cyc[0].symbol


def test_lock_order_consistent_clean(tmp_path):
    root = build_fixture_tree(tmp_path, spin="good", locks="clean")
    assert not [f for f in lockorder.run(root) if f.rule == "lock-cycle"]


_CALL_CHAIN = (
    "import threading\n\n\n"
    "class Engine:\n"
    "    def __init__(self):\n"
    "        self.lock_a = threading.Lock()\n"
    "        self.lock_b = threading.Lock()\n\n"
    "    def take_b(self):\n"
    "        with self.lock_b:\n"
    "            return 1\n\n"
    "    def fwd(self):\n"
    "        with self.lock_a:\n"
    "            return self.take_b()\n\n"
    "    def rev(self):\n"
    "        with self.lock_b:\n"
    "            with self.lock_a:\n"
    "                return 2\n")
_HELD_BLOCKING = (
    "import threading\n\n\n"
    "class Pump:\n"
    "    def __init__(self, sock):\n"
    "        self.lock = threading.Lock()\n"
    "        self.sock = sock\n\n"
    "    def fwd(self):\n"
    "        with self.lock:\n"
    "            self.sock.recv(1024)\n")
_SELF_CYCLE = (
    "import threading\n\n\n"
    "class Pump:\n"
    "    def __init__(self):\n"
    "        self.lock = threading.Lock()\n\n"
    "    def inner(self):\n"
    "        with self.lock:\n"
    "            return 1\n\n"
    "    def outer(self):\n"
    "        with self.lock:\n"
    "            return self.inner()\n")


def test_lock_cycle_through_call_chain(tmp_path):
    """Interprocedural: A held while CALLING a function that takes B,
    plus the direct B→A nesting elsewhere, closes the cycle."""
    root = build_fixture_tree(tmp_path, spin="good", locks="clean")
    (root / PKG / "dcn" / "tcp.py").write_text(_CALL_CHAIN)
    assert [f for f in lockorder.run(root) if f.rule == "lock-cycle"]


def test_lock_held_blocking_detected(tmp_path):
    root = build_fixture_tree(tmp_path, spin="good", locks="clean")
    (root / PKG / "dcn" / "tcp.py").write_text(_HELD_BLOCKING)
    hits = [f for f in lockorder.run(root) if f.rule == "lock-held-blocking"]
    assert len(hits) == 1 and "recv" in hits[0].message


def test_lock_self_cycle_detected(tmp_path):
    root = build_fixture_tree(tmp_path, spin="good", locks="clean")
    (root / PKG / "dcn" / "tcp.py").write_text(_SELF_CYCLE)
    assert [f for f in lockorder.run(root) if f.rule == "lock-self-cycle"]


def test_lockorder_scope_is_the_ports_threaded_planes():
    assert all(s.startswith(f"{PKG}/") and (REPO / s).is_file()
               for s in lockorder.DEFAULT_SCOPE)
    assert f"{PKG}/dcn/device.py" in lockorder.DEFAULT_SCOPE
    assert f"{PKG}/core/threads.py" in lockorder.DEFAULT_SCOPE


# -- pass 3: ABI drift checker -----------------------------------------


def test_renamed_counter_detected(tmp_path):
    root = build_fixture_tree(tmp_path, spin="good",
                              rename_counter="delivered")
    rules = {f.rule for f in abidrift.check_stat_names(root)}
    assert "stat-names-drift" in rules
    assert "stat-append-only" in rules


def test_counter_tables_agree_clean(tmp_path):
    root = build_fixture_tree(tmp_path, spin="good")
    assert not abidrift.check_stat_names(root)


def test_abi_pass_clean_on_head():
    """The ABI pass passes on the port's tree (the device windows'
    ``ompi_dw_ipc_handle_size`` and the convertor's ``tpuconv_unpack`` /
    ``tpuconv_version`` now carry argtypes: without them this fails on
    three ``abi-undeclared-call`` findings)."""
    fs = [f for f in abidrift.run(REPO) if f.severity == F.SEV_ERROR]
    assert not fs, "\n".join(f.render() for f in fs)


def _dcn_fixture(tmp_path, c_def: str, native_py: str) -> Path:
    root = build_fixture_tree(tmp_path, spin="good")
    cc = root / PKG / "csrc" / "dcn.cc"
    cc.write_text(cc.read_text() + c_def)
    (root / PKG / "dcn" / "native.py").write_text(native_py)
    return root


def test_ctypes_arity_drift(tmp_path):
    root = _dcn_fixture(
        tmp_path, "\nint tdcn_ping(void *h, int x) { return x; }\n",
        "import ctypes\n\n"
        "def bind(lib):\n"
        "    lib.tdcn_ping.argtypes = [ctypes.c_void_p]\n"
        "    lib.tdcn_ping.restype = ctypes.c_int\n")
    assert any(f.rule == "abi-arity" for f in abidrift.check_ctypes(root))


def test_ctypes_width_drift(tmp_path):
    root = _dcn_fixture(
        tmp_path, "\nint tdcn_ping(void *h, int64_t x) { return (int)x; }\n",
        "import ctypes\n\n"
        "def bind(lib):\n"
        "    lib.tdcn_ping.argtypes = [ctypes.c_void_p, ctypes.c_int]\n"
        "    lib.tdcn_ping.restype = ctypes.c_int\n")
    hits = [f for f in abidrift.check_ctypes(root) if f.rule == "abi-type"]
    assert hits and "int64" in hits[0].message


def test_ctypes_undeclared_call(tmp_path):
    root = _dcn_fixture(tmp_path, "\nint tdcn_ping(void *h) { return 0; }\n",
                        "def poke(lib):\n    return lib.tdcn_ping(None)\n")
    assert any(f.rule == "abi-undeclared-call"
               for f in abidrift.check_ctypes(root))


@pytest.mark.parametrize("redeclarer", ["csrc/capi/shim.c", "csrc/capi/shmem_shim.c",
                                        "csrc/dcn_sanity.cc"])
def test_extern_redecl_arity_drift(tmp_path, redeclarer):
    root = _dcn_fixture(tmp_path, "\nint tdcn_ping(void *h, int x) { return x; }\n", "")
    path = root / PKG / redeclarer
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("extern int tdcn_ping(void *h);\n")
    hits = [f for f in abidrift.check_ctypes(root) if f.rule == "abi-shim-decl"]
    assert hits and "1 parameters" in hits[0].message
    assert hits[0].file == f"{PKG}/{redeclarer}"


# -- the CUDA kernels' ctypes ABI ----------------------------------------


def test_cuda_abi_arity_drift(tmp_path):
    root = build_fixture_tree(tmp_path, spin="good", cuda_abi="arity")
    hits = [f for f in abidrift.check_ctypes(root) if f.rule == "abi-arity"]
    assert [(f.file, f.symbol) for f in hits] == [
        (f"{PKG}/coll/cuda_kernels.py", "ompi_ring_hop_fold")]
    assert "14 parameters" in hits[0].message and "defines 15" in hits[0].message


def test_cuda_abi_width_drift(tmp_path):
    """A 64-bit byte count declared ``c_int`` (through the loader's
    local alias) truncates a 1 GiB hop: flagged at its slot."""
    root = build_fixture_tree(tmp_path, spin="good", cuda_abi="width")
    hits = [f for f in abidrift.check_ctypes(root) if f.rule == "abi-type"]
    assert len(hits) == 1 and hits[0].symbol == "ompi_ring_hop"
    assert "argtypes[7] is int32" in hits[0].message and "int64" in hits[0].message


def test_cuda_abi_declared_symbol_missing_from_the_library(tmp_path):
    root = build_fixture_tree(tmp_path, spin="good", cuda_abi="clean")
    py = root / PKG / "coll" / "cuda_kernels.py"
    py.write_text(py.read_text() + "\n\ndef _more(lib):\n"
                  "    lib.ompi_ring_hop_gone.argtypes = [ctypes.c_void_p]\n")
    hits = [f for f in abidrift.check_ctypes(root) if f.rule == "abi-missing-symbol"]
    assert [f.symbol for f in hits] == ["ompi_ring_hop_gone"]


def test_cuda_abi_clean_twin_checks_both_entry_points(tmp_path):
    root = build_fixture_tree(tmp_path, spin="good", cuda_abi="clean")
    checked: set[str] = set()
    assert not [f for f in abidrift.check_ctypes(root, checked)
                if f.file.endswith("cuda_kernels.py")]
    assert {"ompi_ring_hop", "ompi_ring_hop_fold"} <= checked


def test_cu_parser_reads_only_the_extern_c_entry_points():
    """``ring_hop.cu``'s templates, kernels, width dispatch and fold
    macro are not exports; its two ``extern "C"`` functions are, with
    their full parameter lists."""
    defs = abidrift.c_functions((REPO / PKG / "csrc" / "ring_hop.cu").read_text(),
                                "ompi_ring_")
    assert sorted(defs) == ["ompi_ring_hop", "ompi_ring_hop_fold"]
    assert len(defs["ompi_ring_hop"][2]) == 9 and len(defs["ompi_ring_hop_fold"][2]) == 15
    assert [abidrift._c_class(p) for p in defs["ompi_ring_hop"][2]] == \
        ["ptr"] * 4 + ["int64"] * 4 + ["ptr"]


def test_every_ported_library_entry_point_is_checked():
    """Every ``extern "C"`` entry point of the ring-hop kernels, the
    device windows and the convertor (and every ``tdcn_*`` the engine's
    binding declares) is compared slot by slot with its ctypes
    declaration: none goes unchecked."""
    checked: set[str] = set()
    assert not abidrift.check_ctypes(REPO, checked)
    for c_rel, prefix, _py in abidrift.LIBRARIES[1:]:
        exports = set(abidrift.c_functions((REPO / c_rel).read_text(), prefix))
        assert exports and exports <= checked, (c_rel, sorted(exports - checked))
    assert {"ompi_ring_hop", "ompi_ring_hop_fold"} <= checked
    assert len([s for s in checked if s.startswith("ompi_dw_")]) == 8
    assert len([s for s in checked if s.startswith("tpuconv_")]) == 4
    decls = abidrift._CtypesDecls("tdcn_")
    decls.visit(abidrift.parse_py(REPO / abidrift.NATIVE_PY))
    # tdcn_set_resolver's callback slot (a CFUNCTYPE) has no width class:
    # its arity is compared, its slots are not all classified
    assert set(decls.argtypes) - checked == {"tdcn_set_resolver"}
    assert len(decls.argtypes) >= 50


# -- waivers -----------------------------------------------------------


def test_waiver_round_trip(tmp_path):
    root = build_fixture_tree(tmp_path, spin="bad")
    fs = invariants.run(root)
    wpath = tmp_path / "waivers.toml"
    wpath.write_text(
        '[[waiver]]\n'
        'pass = "invariants"\n'
        'rule = "unbounded-spin"\n'
        f'file = "{PKG}/dcn/pump.py"\n'
        'reason = "fixture exception"\n')
    merged = F.apply_waivers(fs, F.load_waivers(wpath))
    spin = [f for f in merged if f.rule == "unbounded-spin"]
    assert spin and all(f.waived for f in spin)
    assert spin[0].waiver_reason == "fixture exception"
    assert not [f for f in merged if f.rule == "stale-waiver"]


def test_stale_waiver_reported(tmp_path):
    wpath = tmp_path / "waivers.toml"
    wpath.write_text(
        '[[waiver]]\n'
        'pass = "invariants"\n'
        'rule = "unbounded-spin"\n'
        f'file = "{PKG}/dcn/nothere.py"\n'
        'reason = "points at nothing"\n')
    merged = F.apply_waivers([], F.load_waivers(wpath), passes_run=["invariants"])
    stale = [f for f in merged if f.rule == "stale-waiver"]
    assert stale and stale[0].file == WAIVERS
    # ...but not when the waiver's pass did not run this invocation
    assert not F.apply_waivers([], F.load_waivers(wpath), passes_run=["abidrift"])


def test_waiver_requires_reason(tmp_path):
    wpath = tmp_path / "waivers.toml"
    wpath.write_text(
        '[[waiver]]\npass = "invariants"\nrule = "unbounded-spin"\n'
        'file = "x.py"\n')
    with pytest.raises(ValueError, match="reason"):
        F.load_waivers(wpath)


def test_toml_subset_rejects_unknown_tables():
    with pytest.raises(ValueError, match="waiver"):
        F.parse_toml_tables("[[other]]\nx = 1\n")


def test_report_json_schema(tmp_path):
    root = build_fixture_tree(tmp_path, spin="bad")
    rep = F.Report(str(root))
    rep.extend("invariants", invariants.run(root))
    out = tmp_path / "report.json"
    rep.write_json(out)
    d = json.loads(out.read_text())
    assert d["version"] == 1
    assert d["summary"]["unwaived_errors"] >= 1
    assert d["summary"]["by_pass"].get("invariants", 0) >= 1
    assert all({"pass_name", "rule", "file", "line", "severity"}
               <= set(f) for f in d["findings"])


def test_every_port_waiver_carries_a_reason_and_names_a_port_file():
    waivers = F.load_waivers(REPO / WAIVERS)
    assert len(waivers) == 7  # + golden_capture's upstream libmpi variable
    for w in waivers:
        assert w.reason and (REPO / w.file).is_file() and w.file.startswith(f"{PKG}/")


# -- runtime lockdep witness -------------------------------------------


@pytest.fixture
def witness():
    lockdep.enable()
    lockdep.reset()
    yield lockdep
    lockdep.disable()
    lockdep.reset()


def test_lockdep_inversion_detected(witness):
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    with pytest.raises(lockdep.LockOrderInversion, match="inversion"):
        lockdep.assert_clean()


def test_lockdep_consistent_order_clean(witness):
    a = threading.Lock()
    b = threading.Lock()
    for _ in range(3):
        with a:
            with b:
                pass
    lockdep.assert_clean()
    assert len(lockdep.witnessed_locks()) == 2  # two allocation sites
    assert len(lockdep.current_edges()) == 1    # a → b


def test_lockdep_cross_thread_inversion(witness):
    """The order graph is global: thread 1 records A→B, thread 2's
    B→A completes the inversion even though neither deadlocks."""
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass

    def other():
        with b:
            with a:
                pass

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert any(v.kind == "inversion" for v in lockdep.violations())


def test_lockdep_trylock_is_not_held(witness):
    """A failed try-acquire must not enter the held stack, and a
    same-object try-lock is not reported as self-deadlock."""
    a = threading.Lock()
    b = threading.Lock()
    with a:
        assert not a.acquire(blocking=False)
        with b:
            pass
    with b:  # b→a would invert ONLY if the failed try-lock leaked
        pass
    assert not lockdep.violations()


def test_lockdep_trylock_records_no_edge(witness):
    """A successful try-acquire records no order edge either."""
    a = threading.Lock()
    b = threading.Lock()
    with a:
        assert b.acquire(blocking=False)
        b.release()
    with b:
        with a:
            pass
    lockdep.assert_clean()


def test_lockdep_condition_wait_releases(witness):
    """Condition.wait drops the held entry — no phantom edges."""
    cv = threading.Condition()
    done = []

    def waiter():
        with cv:
            cv.wait(timeout=5)
            done.append(True)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)
    with cv:
        cv.notify_all()
    t.join(timeout=10)
    assert done and not t.is_alive()
    lockdep.assert_clean()


def test_lockdep_disabled_is_transparent():
    assert not lockdep.enabled()
    lk = threading.Lock()
    assert type(lk).__module__ == "_thread"  # the real factory
    with lk:
        pass
    assert not lockdep.violations()


def test_lockdep_enable_nests():
    """enable/disable are refcounted: only the outermost disable
    restores the factories."""
    was_enabled = lockdep.enabled()
    lockdep.enable()
    lockdep.enable()
    lockdep.disable()
    assert lockdep.enabled()
    lockdep.disable()
    assert lockdep.enabled() == was_enabled


def _script_inversion():
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass
    with b:
        with a:
            pass


def _script_consistent():
    a = threading.Lock()
    b = threading.RLock()
    c = threading.Lock()
    for _ in range(2):
        with a:
            with b:
                with b:
                    with c:
                        pass


def _script_timed_reacquire():
    a = threading.Lock()
    b = threading.Lock()
    with b:
        with a:
            # a re-acquire that carries a timeout cannot wedge: no report
            assert not a.acquire(True, 0.01)


def _script_trylock_and_condition():
    a = threading.Lock()
    b = threading.Lock()
    cv = threading.Condition(a)
    with a:
        assert b.acquire(blocking=False)
        b.release()
        cv.wait(timeout=0.01)
    with b:
        with a:
            pass


def _script_cross_thread():
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass

    def other():
        with b:
            with a:
                pass

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=10)


@pytest.mark.parametrize("script", [_script_inversion, _script_consistent,
                                    _script_timed_reacquire,
                                    _script_trylock_and_condition,
                                    _script_cross_thread],
                         ids=lambda f: f.__name__[len("_script_"):])
def test_lockdep_twin_witnesses_agree(script):
    """The same scripted lock sequence through the reference's witness
    and the port's records the same violations (kind, lock classes,
    site) and the same order edges."""
    seen = []
    for mod in (ref_lockdep, lockdep):
        mod.enable()
        mod.reset()
        try:
            script()
            seen.append(([(v.kind, v.a, v.b, v.where) for v in mod.violations()],
                         mod.current_edges()))
        finally:
            mod.disable()
            mod.reset()
    assert seen[0] == seen[1]
    inverts = script in (_script_inversion, _script_cross_thread)
    assert [v[0] for v in seen[0][0]] == (["inversion"] if inverts else [])


# -- twin-fixture parity ----------------------------------------------


def _ref_cc_append(root: Path, text: str) -> None:
    cc = root / "native" / "src" / "dcn.cc"
    cc.write_text(cc.read_text() + text)


def _ref_write(root: Path, rel: str, text: str) -> None:
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


#: the reference's seeded fixtures (its selftest's and tests'), each a
#: builder of a reference-layout tree
REF_FIXTURES = {
    "spin_bad_lock_cycle": lambda r: ref_fixture_tree(r),
    "spin_good": lambda r: ref_fixture_tree(r, spin="good"),
    "mca_unregistered": lambda r: ref_fixture_tree(r, spin="good",
                                                   mca_ref="bogus_fixture_knob"),
    "mca_dead": lambda r: (ref_fixture_tree(r, spin="good"),
                           _ref_write(r, "README.md", "no knob references here\n")),
    "hardcoded_timeout": lambda r: (ref_fixture_tree(r, spin="good"), _ref_write(
        r, "ompi_tpu/dcn/waits.py",
        "import socket\n\n\ndef dial(sock):\n    sock.settimeout(600)\n    return sock\n")),
    "untyped_escalation": lambda r: (ref_fixture_tree(r, spin="good"), _ref_write(
        r, "ompi_tpu/dcn/tcp.py",
        "def escalate(peer):\n    raise RuntimeError(f'peer {peer} failed')\n")),
    "t0_latch": lambda r: (ref_fixture_tree(r, spin="good"), _ref_write(
        r, "ompi_tpu/trace/core.py",
        "_enabled = False\n\n\ndef now():\n    return 1\n\n\ndef complete(kind):\n    pass\n"),
        _ref_write(r, "ompi_tpu/api/comm.py",
                   "from ompi_tpu.trace import core as _trace\n\n\n"
                   "def dispatch(op):\n"
                   "    t0 = _trace.now() if _trace._enabled else 0\n"
                   "    result = op()\n"
                   "    if t0:\n"
                   "        _trace.complete('api')\n"
                   "    return result\n\n\n"
                   "def dispatch_ungated(op):\n"
                   "    _trace.complete('api')\n"
                   "    return op()\n")),
    "lock_clean": lambda r: ref_fixture_tree(r, spin="good", locks="clean"),
    "lock_call_chain": lambda r: (ref_fixture_tree(r, spin="good", locks="clean"),
                                  _ref_write(r, "ompi_tpu/dcn/tcp.py", _CALL_CHAIN)),
    "lock_held_blocking": lambda r: (ref_fixture_tree(r, spin="good", locks="clean"),
                                     _ref_write(r, "ompi_tpu/dcn/tcp.py", _HELD_BLOCKING)),
    "lock_self_cycle": lambda r: (ref_fixture_tree(r, spin="good", locks="clean"),
                                  _ref_write(r, "ompi_tpu/dcn/tcp.py", _SELF_CYCLE)),
    "renamed_counter": lambda r: ref_fixture_tree(r, spin="good",
                                                  rename_counter="delivered"),
    "ctypes_arity": lambda r: (ref_fixture_tree(r, spin="good"), _ref_cc_append(
        r, "\nint tdcn_ping(void *h, int x) { return x; }\n"), _ref_write(
        r, "ompi_tpu/dcn/native.py",
        "import ctypes\n\ndef bind(lib):\n"
        "    lib.tdcn_ping.argtypes = [ctypes.c_void_p]\n"
        "    lib.tdcn_ping.restype = ctypes.c_int\n")),
    "ctypes_width": lambda r: (ref_fixture_tree(r, spin="good"), _ref_cc_append(
        r, "\nint tdcn_ping(void *h, int64_t x) { return (int)x; }\n"), _ref_write(
        r, "ompi_tpu/dcn/native.py",
        "import ctypes\n\ndef bind(lib):\n"
        "    lib.tdcn_ping.argtypes = [ctypes.c_void_p, ctypes.c_int]\n"
        "    lib.tdcn_ping.restype = ctypes.c_int\n")),
    "ctypes_undeclared": lambda r: (ref_fixture_tree(r, spin="good"), _ref_cc_append(
        r, "\nint tdcn_ping(void *h) { return 0; }\n"), _ref_write(
        r, "ompi_tpu/dcn/native.py", "def poke(lib):\n    return lib.tdcn_ping(None)\n")),
    "extern_redecl": lambda r: (ref_fixture_tree(r, spin="good"), _ref_cc_append(
        r, "\nint tdcn_ping(void *h, int x) { return x; }\n"),
        _ref_write(r, "native/src/shim.c", "extern int tdcn_ping(void *h);\n"),
        _ref_write(r, "ompi_tpu/dcn/native.py", "")),
    "provider_merge_bad": lambda r: ref_fixture_tree(r, spin="good",
                                                     stats_key="bogus_counter"),
    "provider_merge_good": lambda r: ref_fixture_tree(r, spin="good",
                                                      stats_key="delivered"),
    "ctx_drift": lambda r: ref_fixture_tree(
        r, spin="good", ctx_fields=("v", "comm", "op", "seq", "hop"),
        ctx_c_fields=("v", "comm", "op", "seq", "hopidx")),
    "ctx_appended": lambda r: ref_fixture_tree(
        r, spin="good", ctx_fields=("v", "comm", "op", "seq", "hop", "extra"),
        ctx_c_fields=("v", "comm", "op", "seq", "hop", "extra")),
    "pvar_bad": lambda r: ref_fixture_tree(
        r, spin="good", ctx_fields=("v", "comm", "op", "seq", "hop"),
        causal_pvars=("records", "Bad-Name")),
    "pvar_good": lambda r: ref_fixture_tree(
        r, spin="good", ctx_fields=("v", "comm", "op", "seq", "hop")),
}

#: reference layout → the port's
_PATH_MAP = (("native/src/dcn.cc", f"{PKG}/csrc/dcn.cc"),
             ("native/src/shim.c", f"{PKG}/csrc/capi/shim.c"),
             ("ompi_tpu/", f"{PKG}/"))


def _port_path(rel: str) -> str:
    for old, new in _PATH_MAP:
        if rel == old or (old.endswith("/") and rel.startswith(old)):
            return new + rel[len(old):] if old.endswith("/") else new
    return rel


def _rewrite(ref_root: Path, port_root: Path) -> None:
    """The reference fixture under the port's paths and module names;
    its README becomes the port's section (one heading line on top)."""
    for src in sorted(p for p in ref_root.rglob("*") if p.is_file()):
        rel = str(src.relative_to(ref_root))
        text = src.read_text().replace("ompi_tpu.", f"{PKG}.")
        if rel == "README.md":
            text = f"{README_SECTION}\n{text}"
        dst = port_root / _port_path(rel)
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(text)


def _keys(findings, port: bool) -> set:
    out = set()
    for f in findings:
        file = f.file if port else _port_path(f.file)
        line = f.line - 1 if port and f.file == "README.md" and f.line else f.line
        out.add((f.pass_name, f.rule, file, line, f.symbol))
    return out


@pytest.mark.parametrize("name", sorted(REF_FIXTURES))
def test_twin_fixture_parity(tmp_path, name):
    """Each seeded reference fixture, rewritten under ``ompi_tpu_torch/``
    paths, draws the same (rule, file, line, symbol) findings from the
    port's invariants, lockorder and abidrift passes as from the
    reference's on the original."""
    ref_root, port_root = tmp_path / "ref", tmp_path / "port"
    ref_root.mkdir()
    REF_FIXTURES[name](ref_root)
    _rewrite(ref_root, port_root)
    ref = (ref_invariants.run(ref_root) + ref_lockorder.run(ref_root)
           + ref_abidrift.run(ref_root))
    port = invariants.run(port_root) + lockorder.run(port_root) + abidrift.run(port_root)
    assert _keys(port, True) == _keys(ref, False)
    seeded = {"spin_good", "mca_registered", "lock_clean", "provider_merge_good",
              "ctx_appended", "pvar_good"}
    if name not in seeded:
        assert port, name  # a seeded fixture is flagged


# -- the sanitize pass (no builds here) ----------------------------------


def test_sanitize_without_the_soak_source_is_a_setup_error(tmp_path):
    fs = sanitize.run(build_fixture_tree(tmp_path, spin="good"))
    assert [(f.rule, f.severity) for f in fs] == [("sanitize-setup", F.SEV_ERROR)]


def test_sanitizer_legs_fall_back_past_a_cxx_that_cannot_link(tmp_path, monkeypatch):
    """A compiler wrapper in ``$CXX`` without the sanitizer runtimes (as on
    the card's machine) is tried first and passed over: the leg takes
    the next compiler that links, or skips naming every probe failure."""
    fake = tmp_path / "cxx-wrapper"
    fake.write_text("#!/bin/sh\necho 'ld: cannot find -lasan' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    assert sanitize._compilers()[0] == str(fake)
    cxx, why = sanitize._pick_compiler("-fsanitize=address", tmp_path)
    assert cxx != str(fake)
    if cxx is None:
        assert f"{fake}: ld: cannot find -lasan" in why


def test_cuda_memcheck_leg_is_a_logged_skip_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the leg runs there")
    f = sanitize._cuda_leg(REPO, 60)
    assert (f.rule, f.severity, f.symbol) == ("sanitize-skip", F.SEV_INFO, "cuda-memcheck")
    assert "no CUDA device" in f.message


def test_memcheck_cases_cover_all_five_load_widths():
    """``ring_hop.cu`` splits each rank by ``split_of``: the widest of
    16, 8, 4, 2, 1 that the ends' XOR is a multiple of, a head up to the
    first end's next multiple of it, whole words, a tail.  The mirror
    ``hop_split`` is that rule, and the memcheck child's cases, chosen
    by it on 256-byte aligned buffers, take every width and a peeled
    head and tail at every candidate chunk length."""
    text = (REPO / PKG / "csrc" / "ring_hop.cu").read_text()
    rule = text[text.index("Split split_of("):text.index("template <int W> struct WordOf;")]
    import re

    chain = re.findall(r"\(mis & (\d+)\) == 0 \? (\d+)", rule)
    assert [(int(a), int(b)) for a, b in chain] == [(15, 16), (7, 8), (3, 4), (1, 2)]
    assert ": 1;" in rule and "(w - (s & (w - 1))) & (w - 1)" in rule
    assert "if (head > nbytes) head = nbytes;" in rule
    from ompi_tpu_torch.coll import cuda_kernels as ck

    # the tile the card tests edge on: one pass of a block's threads
    assert "constexpr long long kTile = static_cast<long long>(kThreads) * kUnroll * 16;" in text
    threads = int(re.search(r"constexpr int kThreads = (\d+);", text).group(1))
    unroll = int(re.search(r"constexpr int kUnroll = (\d+);", text).group(1))
    assert ck.HOP_TILE_BYTES == threads * unroll * 16
    from ompi_tpu_torch.coll.cuda_kernels import hop_split

    for s_, d_, nbytes in ((0, 0, 4100), (3, 19, 40), (5, 6, 3), (8, 20, 7), (8, 24, 7)):
        head, w, tail = hop_split(s_, d_, nbytes)
        assert (w, head, tail) == {(0, 0): (16, 0, 4), (3, 19): (16, 13, 11),
                                   (5, 6): (1, 0, 0), (8, 20): (4, 0, 3),
                                   (8, 24): (16, 7, 0)}[(s_, d_)]
    assert memcheck.PATHS == {16, 8, 4, 2, 1, "head", "tail"}
    taken = set().union(*(memcheck.case_paths(*c) for c in memcheck.hop_cases()))
    assert taken == memcheck.PATHS
    lengths = {nbytes for nbytes, _, _ in memcheck.HOP_CANDIDATES}
    assert {4097, 4096} < lengths and any(nbytes % 16 for nbytes in lengths)  # ragged, odd
    for nbytes in lengths:  # every length takes every path
        assert set().union(*(memcheck.case_paths(*c) for c in memcheck.hop_cases()
                             if c[0] == nbytes)) == memcheck.PATHS
    assert memcheck.RING_SIZE % memcheck.N  # the rings' padded path


# -- live gate + CLI ---------------------------------------------------


def test_live_repo_static_passes_clean_with_waivers():
    """The contracts hold on the port's tree modulo its reviewed
    waivers, and no waiver is stale."""
    rep = live_report(REPO)
    bad = rep.unwaived(F.SEV_ERROR)
    assert not bad, "\n".join(f.render() for f in bad)
    stale = [f for f in rep.findings if f.rule == "stale-waiver"]
    assert not stale, "\n".join(f.render() for f in stale)


def test_port_and_reference_gates_read_disjoint_trees():
    """The port's walk reads the port's files (the README through its
    section only); the reference's own pass sees none of them."""
    from ompi_tpu_torch.analysis import repo

    files = repo.port_py_files(REPO) + repo.port_doc_files(REPO)
    rels = {str(p.relative_to(REPO)) for p in files}
    assert rels and all(r.startswith(f"{PKG}/") or r.startswith("tests/test_torch_")
                        or r in ("chip_smoke.py", "PERF.md", "ROADMAP.md") for r in rels)
    text, first = repo.readme_port_section(REPO)
    assert text.startswith(README_SECTION) and first > 1
    assert "## Transport tuning" not in text


def test_check_selftest_cli():
    """``python -m ompi_tpu_torch check --selftest``: every pass detects
    its seeded violation (the CUDA ABI drift too) and the live tree is
    clean."""
    res = _check("--selftest")
    assert res.returncode == 0, res.stdout.decode() + res.stderr.decode()
    assert b"selftest OK" in res.stdout
    assert b"FAIL" not in res.stdout
    assert b"seeded .cu extern arity drift detected" in res.stdout


def test_check_fast_cli():
    """The --fast pre-commit target exits 0 on the port's tree, with the
    reference's summary line."""
    res = _check("--fast")
    assert res.returncode == 0, res.stdout.decode() + res.stderr.decode()
    assert b"tpucheck: 3 pass(es) [invariants, lockorder, abidrift]" in res.stdout


def test_check_main_exit_codes_and_json(tmp_path, capsys):
    from ompi_tpu_torch.analysis.check import main

    root = build_fixture_tree(tmp_path / "t", spin="bad")
    out = tmp_path / "r.json"
    assert main(["--root", str(root), "--pass", "invariants", "--json", str(out)]) == 1
    assert json.loads(out.read_text())["summary"]["by_pass"]["invariants"] >= 1
    bad = tmp_path / "bad.toml"
    bad.write_text("[[other]]\n")
    assert main(["--root", str(root), "--waivers", str(bad)]) == 2
    assert "unknown command" not in capsys.readouterr().err


def test_unknown_command_names_check():
    res = subprocess.run([sys.executable, "-m", PKG, "nosuch"], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 2 and "'check'" in res.stderr


# -- repairs the checker asked for ---------------------------------------


@pytest.fixture
def shmem_world():
    import ompi_tpu_torch.api as api
    import ompi_tpu_torch.shmem as shmem
    from ompi_tpu_torch.core import mca

    api.finalize()
    api.init(device="cpu", nranks=2)
    shmem.init(heap_bytes=1 << 16)
    store = mca.default_context().store
    prev = store.get("dcn_recv_timeout")
    store.set("dcn_recv_timeout", 0.2)
    try:
        yield shmem
    finally:
        store.set("dcn_recv_timeout", prev)
        shmem.finalize()
        api.finalize()


@pytest.mark.parametrize("wait", ["wait_until", "signal_wait_until"])
def test_shmem_waits_ride_the_recv_deadline(shmem_world, wait):
    """A peer update that never comes ends in DeadlineExpiredError after
    ``dcn_recv_timeout`` (the unbounded-spin repair of the OpenSHMEM
    waits); a satisfied wait returns at once."""
    import numpy as np

    from ompi_tpu_torch.core.errors import DeadlineExpiredError

    shmem = shmem_world
    sig = shmem.malloc(1, np.int64)
    fn = getattr(shmem, wait)
    box = []

    def run():
        try:
            box.append(fn(sig, shmem.CMP_EQ, 5))
        except DeadlineExpiredError as e:
            box.append(e)

    t = threading.Thread(target=run, daemon=True)
    t0 = time.monotonic()
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), f"{wait} never returned"
    assert isinstance(box[0], DeadlineExpiredError) and time.monotonic() - t0 < 30
    assert f"shmem {wait}" in str(box[0])
    shmem.atomic_set(sig, 5, shmem.my_pe())
    assert fn(sig, shmem.CMP_EQ, 5) in (None, 5)

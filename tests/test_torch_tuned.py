"""The port's ``coll/tuned`` against ``ompi_tpu/coll/tuned.py``.

Both worlds are 8 ranks (the JAX one on the conftest's virtual CPU
devices, the port's as rows of CPU tensors).  The decision layer is the
default provider of every device slot in both, so an unpinned
collective must pick the same algorithm and give the same bits; the
fixed table, the rule-file parser and the dynamic rules must agree too.
The second half mirrors ``tests/test_coll_tuned.py`` test for test.
"""

import contextlib

import numpy as np
import pytest

import ompi_tpu.api as japi
import ompi_tpu_torch.api as tapi
from ompi_tpu import op as jop
from ompi_tpu.coll import tuned as jtuned
from ompi_tpu.core import mca as jmca
from ompi_tpu.trace import core as jtrace
from ompi_tpu_torch import op as top
from ompi_tpu_torch.coll import cuda_kernels as ck
from ompi_tpu_torch.coll import tuned as ttuned
from ompi_tpu_torch.coll.cuda import (
    ALLGATHER_ALGOS,
    ALLREDUCE_ALGOS,
    ALLTOALL_ALGOS,
    BARRIER_ALGOS,
    BCAST_ALGOS,
    REDUCE_SCATTER_ALGOS,
)
from ompi_tpu_torch.coll.tuned import (
    COLL_IDS,
    TunedCollComponent,
    fixed_decision,
    parse_rules_file,
)
from ompi_tpu_torch.core import mca as tmca
from ompi_tpu_torch.core.errors import MPIArgError
from ompi_tpu_torch.trace import core as ttrace

N = 8
LARGE = 1 << 20
HUGE = 64 << 20


@pytest.fixture(scope="module")
def worlds(devices):
    tapi.finalize()
    tw = tapi.init(device="cpu", nranks=N)
    yield japi.init(), tw
    tapi.finalize()


@pytest.fixture(autouse=True)
def quiet_tracers():
    """Each package's tracer is process-global: start and end each test
    with both off and empty."""
    for t in (jtrace, ttrace):
        t.reset()
        t.enable(False)
    yield
    for t in (jtrace, ttrace):
        t.reset()
        t.enable(False)


def _stores():
    return jmca.default_context().store, tmca.default_context().store


@contextlib.contextmanager
def both_set(**values):
    """Set ``coll_<name>`` on both stores (a ``dev_`` prefix names the
    device component: ``xla`` there, ``cuda`` here), restoring after."""
    js, ts = _stores()
    sets = []
    for k, v in values.items():
        sets.append((js, "coll_" + k.replace("dev_", "xla_"), v))
        sets.append((ts, "coll_" + k.replace("dev_", "cuda_"), v))
    prev = [(s, name, s.get(name)) for s, name, _ in sets]
    for s, name, v in sets:
        s.set(name, v)
    try:
        yield
    finally:
        for s, name, old in prev:
            s.set(name, old)


def decisions(trace_mod):
    return [e[7] for e in trace_mod.events() if e[4] == "tuned_decision"]


def ones_ish(k, seed):
    return (1 + 0.3 * np.random.RandomState(seed).randn(N, k)).astype(np.float32)


# -- the default-dispatch fault --------------------------------------------


def _avg(a, b):
    return (a + b) * 0.5


@pytest.mark.parametrize("opname", ["MPI_PROD", "user"])
@pytest.mark.parametrize("k,algo", [(64, "recursive_doubling"), (1024, "rabenseifner"),
                                    (4099, "ring_segmented")])
def test_unpinned_allreduce_matches_reference(worlds, opname, k, algo):
    """An unpinned commutative software-op allreduce picks tuned's size
    ladder in both packages and gives the same bits (per-rank 256 B,
    4 KiB and 16 KiB against large/huge lowered to 1 KiB/16 KiB)."""
    jw, tw = worlds
    if opname == "user":
        jo, to = jop.create_op(_avg, commute=True), top.create_op(_avg, commute=True)
    else:
        jo, to = jop.PREDEFINED_OPS[opname], top.PREDEFINED_OPS[opname]
    x = ones_ish(k, seed=k)
    with both_set(tuned_large_msg=1 << 10, tuned_huge_msg=16 << 10):
        jtrace.enable(True)
        ttrace.enable(True)
        want = np.asarray(jw.allreduce(x, jo))
        got = tw.allreduce(x, to)
    assert got.tobytes() == want.tobytes()
    jd, td = decisions(jtrace), decisions(ttrace)
    assert td == jd and [d["algorithm"] for d in td] == [algo]
    assert td[0]["msg_bytes"] == 4 * k


def test_unpinned_prod_default_thresholds(worlds):
    """At the shipped thresholds a small PROD allreduce is recursive
    doubling in both — bit-equal, where PR 1's ordered fold was not."""
    jw, tw = worlds
    x = ones_ish(4099, seed=1)
    want = np.asarray(jw.allreduce(x, jop.PROD))
    got = tw.allreduce(x, top.PROD)
    assert got.tobytes() == want.tobytes()


# -- the fixed table, the parser, the dynamic rules -------------------------

_OPS = {
    "sum": (jop.SUM, top.SUM), "max": (jop.MAX, top.MAX), "prod": (jop.PROD, top.PROD),
    "band": (jop.BAND, top.BAND),
    "user": (jop.create_op(_avg, commute=True), top.create_op(_avg, commute=True)),
    "noncommutative": (jop.create_op(_avg, commute=False),
                       top.create_op(_avg, commute=False)),
}


@pytest.mark.parametrize("opname", sorted(_OPS))
@pytest.mark.parametrize("n", [1, 2, 3, 8, 17, 32])
def test_fixed_decision_grid_matches_reference(n, opname):
    jo, to = _OPS[opname]
    for coll in COLL_IDS:
        for nbytes in (0, 1, LARGE - 1, LARGE, HUGE - 1, HUGE):
            want = jtuned.fixed_decision(coll, n, nbytes, jo, LARGE, HUGE)
            got = fixed_decision(coll, n, nbytes, to, LARGE, HUGE, device="cpu")
            assert got == want, (coll, n, nbytes)
            assert fixed_decision(coll, n, nbytes, to, LARGE, HUGE) == want


def test_huge_branch_takes_the_kernels_only_on_a_cuda_mesh(monkeypatch):
    """The kernel ring needs a CUDA mesh and an sm_90 card: a CPU comm on
    a machine with a card still gets ring_segmented, as the reference
    does off-TPU."""
    assert not ttuned.kernel_leg("cpu")
    monkeypatch.setattr(ck, "kernel_available", lambda: True)
    for dev, want in (("cpu", "ring_segmented"), (None, "ring_segmented"),
                      ("cuda", "cuda_ring")):
        alg, _ = fixed_decision("allreduce", N, HUGE, top.PROD, LARGE, HUGE, device=dev)
        assert alg == ALLREDUCE_ALGOS[want], dev
    monkeypatch.setattr(ck, "kernel_available", lambda: False)
    alg, _ = fixed_decision("allreduce", N, HUGE, top.PROD, LARGE, HUGE, device="cuda")
    assert alg == ALLREDUCE_ALGOS["ring_segmented"]


RULES = """
# tuned dynamic rules (reference format)
1          # one collective
2          # ALLREDUCE
2          # two comm-size brackets
4          # comm size 4
1          # one rule
0 4 0 0    # from 0 bytes: algorithm 4 (recursive_doubling)
8          # comm size 8
2
0 2 0 0        # from 0 bytes: ring
4096 3 0 65536 # from 4 KiB: ring_segmented, segsize 64 KiB
"""


@pytest.mark.parametrize("text", [RULES, "1\n2\n1\n2\n1\n0 0 0 0\n",
                                  "2\n7\n1\n1\n1\n0 3 0 0\n13\n1\n2\n1\n0 4 0 0\n"])
def test_parse_rules_file_matches_reference(text):
    want, got = jtuned.parse_rules_file(text), parse_rules_file(text)
    assert got.rules == want.rules
    for coll in COLL_IDS:
        for n in (1, 3, 4, 5, 8, 64):
            for b in (0, 100, 4096, 8192):
                assert got.lookup(coll, n, b) == want.lookup(coll, n, b)


@pytest.mark.parametrize("text", ["1 2 nope", "1 2 1 8", "1\n2\n1\n2\n1\n0 99 0 0\n",
                                  "1\n7\n1\n2\n1\n0 9 0 0\n"])
def test_bad_rules_raise_in_both(text):
    with pytest.raises(MPIArgError):
        parse_rules_file(text)
    from ompi_tpu.core.errors import MPIArgError as JArgError

    with pytest.raises(JArgError):
        jtuned.parse_rules_file(text)


def _tuned(comm):
    return next(m for m in comm.coll.modules
                if isinstance(m, (ttuned.TunedCollModule, jtuned.TunedCollModule)))


@pytest.mark.parametrize("opname", ["MPI_SUM", "MPI_PROD"])
def test_dynamic_rules_drive_both_to_the_same_bits(worlds, opname):
    jw, tw = worlds
    jc, tc = jw.dup("rules-j"), tw.dup("rules-t")
    jt, tt = _tuned(jc), _tuned(tc)
    jt.component.ruleset = jtuned.parse_rules_file(RULES)
    tt.component.ruleset = parse_rules_file(RULES)
    try:
        for k in (16, 4099):  # 64 B → ring; 16 KiB → ring_segmented
            x = ones_ish(k, seed=k + 5)
            ttrace.enable(True)
            want = np.asarray(jc.allreduce(x, jop.PREDEFINED_OPS[opname]))
            got = tc.allreduce(x, top.PREDEFINED_OPS[opname])
            assert got.tobytes() == want.tobytes()
        algos = [d["algorithm"] for d in decisions(ttrace)]
        assert algos == ["ring", "ring_segmented"]
        assert {d["source"] for d in decisions(ttrace)} == {"dynamic"}
        seg = [k for k in tt.inner._cache if k[0] == "allreduce" and k[1] == 3]
        assert seg and seg[0][-1] == 65536 // 4  # segsize bytes → segcount
    finally:
        jt.component.ruleset = tt.component.ruleset = None
        jc.free()
        tc.free()


def test_pinned_var_bypasses_tuned(worlds):
    jw, tw = worlds
    x = ones_ish(4099, seed=3)
    with both_set(dev_allreduce_algorithm=ALLREDUCE_ALGOS["ring"]):
        ttrace.enable(True)
        jtrace.enable(True)
        want = np.asarray(jw.allreduce(x, jop.PROD))
        got = tw.allreduce(x, top.PROD)
    assert got.tobytes() == want.tobytes()
    assert decisions(ttrace) == decisions(jtrace) == []
    inner = _tuned(tw).inner
    assert any(k[0] == "allreduce" and k[1] == ALLREDUCE_ALGOS["ring"] for k in inner._cache)


def test_slot_providers_match_reference(worlds):
    jw, tw = worlds
    assert tw.coll.providers == {
        slot: p.replace("xla", "cuda") for slot, p in jw.coll.providers.items()}
    assert all(hasattr(tw.coll.owners[s], "resolve")
               for s, p in tw.coll.providers.items() if p == "tuned")


def test_forced_nests_and_restores_on_exception(worlds):
    _, tw = worlds
    inner = _tuned(tw).inner
    with inner.forced(allreduce_algorithm=2):
        with pytest.raises(RuntimeError):
            with inner.forced(allreduce_algorithm=5, segcount=None):
                assert inner._forced == {"allreduce_algorithm": 5}
                raise RuntimeError
        assert inner._forced == {"allreduce_algorithm": 2}
    assert inner._forced == {}


# -- tests/test_coll_tuned.py, mirrored --------------------------------------


def test_fixed_allreduce_fabric_op():
    alg, _ = fixed_decision("allreduce", N, 1024, top.SUM, LARGE, HUGE)
    assert alg == ALLREDUCE_ALGOS["psum"]
    alg, _ = fixed_decision("allreduce", N, HUGE * 2, top.MAX, LARGE, HUGE)
    assert alg == ALLREDUCE_ALGOS["psum"]


def test_fixed_allreduce_software_op_size_ladder():
    small, _ = fixed_decision("allreduce", N, 1024, top.PROD, LARGE, HUGE)
    large, _ = fixed_decision("allreduce", N, LARGE, top.PROD, LARGE, HUGE)
    huge, _ = fixed_decision("allreduce", N, HUGE, top.PROD, LARGE, HUGE)
    assert small == ALLREDUCE_ALGOS["recursive_doubling"]
    assert large == ALLREDUCE_ALGOS["rabenseifner"]
    assert huge == ALLREDUCE_ALGOS["ring_segmented"]


def test_fixed_allreduce_noncommutative_is_ordered():
    nc = top.create_op(lambda a, b: a + b, commute=False)
    alg, _ = fixed_decision("allreduce", N, 10, nc, LARGE, HUGE)
    assert alg == ALLREDUCE_ALGOS["ordered_linear"]


def test_fixed_misc_tables():
    assert fixed_decision("bcast", N, 64, None, LARGE, HUGE)[0] == BCAST_ALGOS["direct"]
    assert fixed_decision("bcast", N, HUGE, None, LARGE, HUGE)[0] == BCAST_ALGOS["pipeline"]
    assert fixed_decision("allgather", N, HUGE, None, LARGE, HUGE)[0] == ALLGATHER_ALGOS["ring"]
    assert fixed_decision("alltoall", N, 64, None, LARGE, HUGE)[0] == ALLTOALL_ALGOS["direct"]
    assert fixed_decision("reduce_scatter", N, 64, top.SUM, LARGE, HUGE)[0] \
        == REDUCE_SCATTER_ALGOS["direct"]
    assert fixed_decision("reduce_scatter", N, 64, top.PROD, LARGE, HUGE)[0] \
        == REDUCE_SCATTER_ALGOS["ring"]
    assert fixed_decision("barrier", 32, 0, None, LARGE, HUGE)[0] == BARRIER_ALGOS["dissemination"]
    assert fixed_decision("barrier", 8, 0, None, LARGE, HUGE)[0] == BARRIER_ALGOS["allreduce"]
    assert fixed_decision("scan", N, 64, top.SUM, LARGE, HUGE) == (None, None)


def test_parse_and_lookup():
    rs = parse_rules_file(RULES)
    assert rs.lookup("allreduce", 8, 100) == (2, 0)
    assert rs.lookup("allreduce", 8, 8192) == (3, 65536)
    assert rs.lookup("allreduce", 5, 100) == (4, 0)
    assert rs.lookup("allreduce", 3, 100) is None
    assert rs.lookup("bcast", 8, 100) is None


def test_parse_rejects_garbage():
    with pytest.raises(MPIArgError):
        parse_rules_file("1 2 nope")
    with pytest.raises(MPIArgError):
        parse_rules_file("1 2 1 8")  # truncated


def test_rule_algorithm_zero_falls_back():
    rs = parse_rules_file("1\n2\n1\n2\n1\n0 0 0 0\n")
    assert rs.lookup("allreduce", 8, 100) is None


def test_tuned_wins_slots(worlds):
    _, tw = worlds
    assert tw.coll.providers["allreduce"] == "tuned"
    assert tw.coll.providers["iallreduce"] == "tuned"
    assert tw.coll.providers["bcast"] == "tuned"
    assert tw.coll.providers["allgatherv"] == "basic"


def test_tuned_allreduce_correct(worlds):
    _, tw = worlds
    x = np.arange(N * 16, dtype=np.float64).reshape(N, 16)
    np.testing.assert_allclose(tw.allreduce(x, top.SUM)[0], x.sum(axis=0))


def test_tuned_forces_chosen_algorithm(worlds):
    """The decision must reach the coll/cuda callable cache."""
    _, tw = worlds
    comm = tw.dup("tuned-probe")
    inner = _tuned(comm).inner
    comm.allreduce(np.ones((N, 4), np.float64), top.PROD)
    assert any(k[0] == "allreduce" and k[1] == ALLREDUCE_ALGOS["recursive_doubling"]
               for k in inner._cache), list(inner._cache)
    comm.free()


def test_dynamic_rules_drive_dispatch(worlds, tmp_path):
    _, tw = worlds
    path = tmp_path / "rules.conf"
    path.write_text("1\n2\n1\n2\n1\n0 2 0 0\n")  # allreduce → ring from 2 ranks
    comm = tw.dup("rules-probe")
    tuned = _tuned(comm)
    tuned.component.ruleset = parse_rules_file(path.read_text())
    try:
        out = comm.allreduce(np.ones((N, 4), np.float64), top.SUM)
        np.testing.assert_allclose(out[0], np.full(4, N))
        assert any(k[0] == "allreduce" and k[1] == ALLREDUCE_ALGOS["ring"]
                   for k in tuned.inner._cache), list(tuned.inner._cache)
    finally:
        tuned.component.ruleset = None
        comm.free()


def test_rules_file_bad_algorithm_id():
    with pytest.raises(MPIArgError):
        parse_rules_file("1\n2\n1\n2\n1\n0 99 0 0\n")


def test_component_open_parses_file(tmp_path):
    from ompi_tpu_torch.core.var import VarStore

    path = tmp_path / "r.conf"
    path.write_text(RULES)
    comp = TunedCollComponent()
    store = VarStore(cmdline={
        "coll_tuned_use_dynamic_rules": "1",
        "coll_tuned_dynamic_rules_filename": str(path),
    }, env={}, param_files=[])
    comp.register_params(store)
    assert comp.open(store)
    assert comp.ruleset is not None
    assert comp.ruleset.lookup("allreduce", 8, 8192) == (3, 65536)


def test_component_open_missing_file(tmp_path):
    """A bad rules file must not drop the component: warn, keep the
    fixed decisions."""
    from ompi_tpu_torch.core.var import VarStore

    comp = TunedCollComponent()
    store = VarStore(cmdline={
        "coll_tuned_use_dynamic_rules": "1",
        "coll_tuned_dynamic_rules_filename": str(tmp_path / "absent.conf"),
    }, env={}, param_files=[])
    comp.register_params(store)
    with pytest.warns(RuntimeWarning, match="ignoring dynamic rules"):
        assert comp.open(store) is True
    assert comp.ruleset is None

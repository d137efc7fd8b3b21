"""Point-to-point of the PyTorch port against the JAX package.

A seeded script of sends, wildcard and PROC_NULL receives and probes
runs through both 8-rank worlds; every probe, completion and ``Status``
(source, tag, count, nbytes) and every payload's bits must agree — with
numpy payloads in both, and with tensor payloads in the port.  The
same holds for persistent and partitioned channels, for the errors
each misuse raises, and for the SPC counts, ``p2p_send`` size
histogram and ``p2p`` trace spans the engine emits.  Mirrors
``tests/test_p2p_topo.py`` and the p2p half of ``tests/test_objmodel.py``.
"""

import collections

import ml_dtypes
import numpy as np
import pytest
import torch

import ompi_tpu.api as japi
import ompi_tpu_torch.api as tapi
from ompi_tpu.metrics import core as jmetrics
from ompi_tpu.tool import spc as jspc
from ompi_tpu.trace import core as jtrace
from ompi_tpu_torch.ddt.datatype import from_numpy, to_numpy
from ompi_tpu_torch.metrics import core as tmetrics
from ompi_tpu_torch.p2p import pml as tpml
from ompi_tpu_torch.tool import spc as tspc
from ompi_tpu_torch.trace import core as ttrace

N = 8
DTYPES = [np.float32, np.float64, np.int32, np.int64, np.uint16, ml_dtypes.bfloat16, np.bool_]


def _reset_all():
    for t in (jtrace, ttrace):
        t.reset()
        t.enable(False)
    for s in (jspc, tspc):
        s.clear()
        s.attach(False)
    for m in (jmetrics, tmetrics):
        m.reset(full=False)
        m.enable(False)


@pytest.fixture(autouse=True)
def clean_state():
    _reset_all()
    yield
    _reset_all()


@pytest.fixture(scope="module")
def worlds(devices):
    tapi.finalize()
    tw = tapi.init(device="cpu", nranks=N)
    yield japi.init(), tw
    tapi.finalize()


def script(seed, steps=80):
    """A seeded program: (kind, args) steps over 8 ranks and 3 tags."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        kind = ["send", "send", "irecv", "iprobe"][rng.randint(4)]
        dst = int(rng.randint(N))
        if kind == "send":
            dtype = DTYPES[rng.randint(len(DTYPES))]
            shape = tuple(int(v) for v in rng.randint(1, 5, rng.randint(1, 3)))
            payload = (rng.randn(*shape) * 100).astype(dtype)
            src = int(rng.randint(N)) if rng.rand() > 0.1 else tpml.PROC_NULL * 0 + 3
            out.append(("send", src, dst if rng.rand() > 0.08 else tpml.PROC_NULL,
                        int(rng.randint(3)), payload))
        else:
            src = [None, None, tpml.PROC_NULL, int(rng.randint(N))][rng.randint(4)]
            tag = [None, 0, 1, 2][rng.randint(4)]
            out.append((kind, dst, src, tag))
    return out


def run(parent, steps, as_tensor=False):
    """Run the script on a fresh dup (its own matching engine); the
    trace of what it observed, in order."""
    world = parent.dup()
    seen, reqs = [], []
    for step in steps:
        if step[0] == "send":
            _, src, dst, tag, payload = step
            world.send(from_numpy(payload) if as_tensor else payload, src, dst, tag)
        elif step[0] == "irecv":
            reqs.append(world.irecv(*step[1:]))
        else:
            st = world.iprobe(*step[1:])
            seen.append(None if st is None else (st.source, st.tag, st.count, st.nbytes))
    for req in reqs:
        if req.test():
            payload = req.wait()
            if isinstance(payload, torch.Tensor):
                payload = to_numpy(payload)
            st = req.status
            seen.append((st.source, st.tag, st.count, st.nbytes,
                         None if payload is None else (str(payload.dtype), payload.shape,
                                                       payload.tobytes())))
        else:
            seen.append("pending")
    world.free()
    return seen


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scripted_program_matches_reference(worlds, seed):
    jw, tw = worlds
    steps = script(seed)
    want = run(jw, steps)
    assert run(tw, steps) == want
    assert run(tw, steps, as_tensor=True) == want
    assert "pending" in want and any(isinstance(s, tuple) and s[0] == tpml.PROC_NULL
                                     for s in want)


def test_non_overtaking_and_wildcards(worlds):
    for w in worlds:
        for i in range(4):
            w.send(np.full(2, i, np.int32), source=1 + i % 2, dest=6, tag=i % 2)
    got = []
    for w in worlds:
        out = [w.recv(6, None, 1), w.recv(6, 2, None), w.recv(6), w.recv(6, None, None)]
        got.append([(p.tolist(), s.source, s.tag) for p, s in out])
    assert got[0] == got[1] == [([1, 1], 2, 1), ([3, 3], 2, 1), ([0, 0], 1, 0), ([2, 2], 1, 0)]


def test_sendrecv_ring_and_probe(worlds):
    x = np.random.RandomState(4).randn(N, 5).astype(np.float32)
    outs = []
    for w in worlds:
        # one controller drives every rank: the last rank's send goes
        # first, so each sendrecv finds its left neighbour's message
        w.send(x[N - 1], N - 1, 0, tag=7)
        got = [w.sendrecv(x[r], r, r + 1, (r - 1) % N, sendtag=7, recvtag=7)
               for r in range(N - 1)]
        got.append(w.recv(N - 1, N - 2, 7))
        w.send(x[0], 0, 3, tag=9)
        st = w.probe(3, None, None)
        w.recv(3)
        outs.append(([np.asarray(p).tobytes() for p, _ in got],
                     [(s.source, s.tag) for _, s in got], (st.source, st.tag, st.nbytes)))
    assert outs[0] == outs[1]


def test_persistent_channels_match_reference(worlds):
    outs = []
    for w in worlds:
        buf = np.array([1.0, 2.0])
        ps = w.send_init(buf, source=0, dest=4, tag=5)
        pr = w.recv_init(dest=4, source=0, tag=5)
        rounds = []
        for fill in ([1.0, 2.0], [7.0, 8.0]):
            buf[:] = fill  # refill between starts
            ps.start().wait()
            got = pr.start().wait()
            rounds.append((got.tolist(), pr.status.source, pr.status.tag))
        outs.append(rounds)
    assert outs[0] == outs[1] == [([1.0, 2.0], 0, 5), ([7.0, 8.0], 0, 5)]


@pytest.mark.parametrize("as_tensor", [False, True])
def test_partitioned_round_matches_reference(worlds, as_tensor):
    outs = []
    for w, tens in ((worlds[0], False), (worlds[1], as_tensor)):
        base = np.arange(24.0).reshape(8, 3)
        buf = torch.from_numpy(base) if tens else base
        ps = w.psend_init(buf, partitions=4, source=0, dest=5, tag=11)
        pr = w.precv_init(partitions=4, dest=5, source=0, tag=11)
        seen = []
        for scale in (1.0, 10.0):
            buf *= scale
            pr.start()
            ps.start()
            for p in (2, 0, 3):
                ps.pready(p)
                seen.append((ps.test(), pr.parrived(p)))
            ps.pready(1)  # the last partition → the transfer
            got = pr.wait()
            seen.append((ps.test(), pr.parrived(1), pr.status.source, pr.status.tag,
                         np.asarray(got).tobytes()))
        outs.append(seen)
    assert outs[0] == outs[1]


ERRORS = [
    ("send_bad_rank", lambda w: w.send(np.zeros(1), source=0, dest=N)),
    ("send_bad_source", lambda w: w.send(np.zeros(1), source=-5, dest=1)),
    ("send_negative_tag", lambda w: w.send(np.zeros(1), source=0, dest=1, tag=-3)),
    ("irecv_bad_rank", lambda w: w.irecv(N + 2, 0)),
    ("iprobe_bad_source", lambda w: w.iprobe(0, N)),
    ("psend_partitions", lambda w: w.psend_init(np.zeros((4, 1)), 3, 0, 1)),
    ("psend_zero_partitions", lambda w: w.psend_init(np.zeros((4, 1)), 0, 0, 1)),
    ("pready_before_start", lambda w: w.psend_init(np.zeros((4, 1)), 2, 0, 1).pready(0)),
    ("pready_out_of_range", lambda w: w.psend_init(np.zeros((4, 1)), 2, 0, 1).start().pready(7)),
    ("parrived_before_start", lambda w: w.precv_init(2, 1, 0).parrived(0)),
    ("recv_restart_active", lambda w: w.recv_init(2, 1, 99).start().start()),
]


@pytest.mark.parametrize("name,call", ERRORS, ids=[e[0] for e in ERRORS])
def test_errors_raise_the_reference_classes(worlds, name, call):
    names = []
    for w in worlds:
        with pytest.raises(Exception) as err:
            call(w)
        names.append(type(err.value).__name__)
    assert names[0] == names[1] and names[0].startswith("MPI")
    if name == "recv_restart_active":
        for w in worlds:  # complete the posted receive
            w.send(np.zeros(1), 1, 2, tag=99)


def test_partitioned_wait_before_all_ready_raises(worlds):
    names = []
    for w in worlds:
        ps = w.psend_init(np.zeros((4, 1)), 2, 0, 1).start()
        ps.pready(0)
        with pytest.raises(Exception) as err:
            ps.wait()
        names.append(type(err.value).__name__)
        ps.pready(1)
        ps.wait()
        w.recv(1, 0)
    assert names == ["MPIRequestError", "MPIRequestError"]


def test_spc_metrics_and_trace_match_reference(worlds):
    """SPC send/send_bytes/irecv, the p2p_send size histogram and the
    p2p span multiset (with their argument keys) agree."""
    steps = script(11, steps=40)
    res = []
    for w, spc, trace, metrics in ((worlds[0], jspc, jtrace, jmetrics),
                                   (worlds[1], tspc, ttrace, tmetrics)):
        _reset_all()
        spc.attach(True)
        trace.enable(True)
        metrics.enable(True)
        run(w, steps)
        snap = {k: v for k, v in spc.snapshot().items() if k in ("send", "send_bytes", "irecv")}
        spans = collections.Counter(
            (e[0], e[3], e[4], tuple(sorted((e[7] or {}).items())))
            for e in trace.events() if e[3] == "p2p")
        res.append((snap, spans, metrics.size_histogram("p2p_send")))
    assert res[0][0] == res[1][0] and res[0][0]["send"] > 0
    assert res[0][1] == res[1][1]
    assert res[0][2] == res[1][2] and sum(res[0][2]) > 0


def test_tensor_payload_is_a_clone_on_its_device(worlds):
    """The eager copy of a tensor is a clone on the tensor's own device
    (the meta device here: nothing could reach the host), and the
    sender's tensor is reusable at once."""
    _, tw = worlds
    x = torch.ones(4)
    tw.send(x, 0, 1)
    x.fill_(5.0)
    got, st = tw.recv(1, 0)
    assert got.tolist() == [1.0] * 4 and (st.count, st.nbytes) == (4, 16)
    m = torch.empty(3, 2, device="meta")
    tw.send(m, 2, 3, tag=1)
    got, st = tw.recv(3, 2, 1)
    assert got.device.type == "meta" and got is not m and (st.count, st.nbytes) == (6, 24)

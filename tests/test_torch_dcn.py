"""The port's boot KVS and DCN engine against the reference's.

* the KVS: put/get/get_prefix, fences, the fence timeout, and a port
  client against a reference server (the wire is the same JSON frames);
* engines in threads: the port's ``DcnCollEngine`` and the reference's
  run the same collectives on the same numpy inputs (seed 7) — ordered
  and ring allreduce, bcast, allgather, alltoall, gather, scatter, and
  the rendezvous path above the eager limit — and agree bit for bit
  (both fold on the host with the same numpy kernels in the same order);
* a mixed job: a reference engine as proc 0 and a port engine as
  proc 1, then swapped, over ``tcp`` and ``sm``, both on their default
  device plane (these payloads stay below its threshold);
* the wire itself: frames a reference transport and a port transport
  send to a recording peer are byte-identical (header, envelope, meta,
  payload) once the sender's own address is masked;
* bfloat16 on the wire: the reference cannot send an ml_dtypes bfloat16
  array (``memoryview`` refuses its dtype); the port sends the raw words
  under the reference's meta (``"<V2"``) and a reference receiver gets
  the same bytes as two-byte voids.
"""

import json
import socket
import struct
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from ompi_tpu.dcn import collops as rcollops
from ompi_tpu.dcn import tcp as rtcp
from ompi_tpu.op import op as rop
from ompi_tpu_torch.boot import kvs as pkvs
from ompi_tpu_torch.dcn import collops as pcollops
from ompi_tpu_torch.dcn import tcp as ptcp
from ompi_tpu_torch.op import op as pop

PKG = {"ref": (rcollops, rop), "port": (pcollops, pop)}


# -- KVS -----------------------------------------------------------------


def test_kvs_put_get_fence():
    server = pkvs.KVSServer()
    try:
        c1, c2 = pkvs.KVSClient(server.address), pkvs.KVSClient(server.address)
        c1.put("k1", {"addr": "127.0.0.1:1"})
        assert c2.get("k1") == {"addr": "127.0.0.1:1"}
        with pytest.raises(KeyError):
            c2.get("missing", wait=False)
        c1.put("dcn.0", "a")
        c2.put("dcn.1", "b")
        assert c1.get_prefix("dcn.") == {"dcn.0": "a", "dcn.1": "b"}
        done = []

        def late():
            time.sleep(0.1)
            c2.fence("f", 1, 2)
            done.append(2)

        t = threading.Thread(target=late)
        t.start()
        c1.fence("f", 0, 2)
        t.join(timeout=10)
        assert not t.is_alive() and done == [2]

        def put_later():
            time.sleep(0.1)
            c1.put("slow", 5)

        t = threading.Thread(target=put_later)
        t.start()
        assert c2.get("slow", timeout=5) == 5
        t.join(timeout=10)
        c1.close()
        c2.close()
    finally:
        server.close()


def test_kvs_fence_timeout():
    server = pkvs.KVSServer()
    try:
        c = pkvs.KVSClient(server.address)
        with pytest.raises(TimeoutError):
            c.fence("never", 0, 2, timeout=0.2)
        c.close()
    finally:
        server.close()


def test_port_kvs_client_against_reference_server():
    from ompi_tpu.boot import kvs as rkvs

    server = rkvs.KVSServer()
    try:
        pc, rc = pkvs.KVSClient(server.address), rkvs.KVSClient(server.address)
        pc.put("wsize.0", 4)
        assert rc.get("wsize.0") == 4
        rc.put("wsize.1", 4)
        assert pc.get_prefix("wsize.") == {"wsize.0": 4, "wsize.1": 4}
        pc.close()
        rc.close()
    finally:
        server.close()


# -- engines in threads --------------------------------------------------


def _engines(pkgs, **kw):
    engines = [PKG[pkg][0].DcnCollEngine(p, len(pkgs), **kw) for p, pkg in enumerate(pkgs)]
    addrs = [e.address for e in engines]
    for e in engines:
        e.set_addresses(addrs)
    return engines


def _run(engines, work):
    out = [None] * len(engines)
    errs = []

    def body(p):
        try:
            out[p] = work(p, engines[p])
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append((p, e))

    ts = [threading.Thread(target=body, args=(p,)) for p in range(len(engines))]
    [t.start() for t in ts]
    [t.join(timeout=60) for t in ts]
    assert not any(t.is_alive() for t in ts), "engine thread hung"
    assert not errs, errs
    for e in engines:
        e.close()
    return out


RNG = np.random.default_rng(7)
X = RNG.standard_normal((3, 999))  # one row per proc; odd length: uneven ring chunks
BLOCKS = RNG.standard_normal((3, 3, 17))
BIG = RNG.standard_normal((3, 40000))  # 320 KB: rendezvous above the 4 KiB eager limit


def _op(pkgs, p, name):
    return getattr(PKG[pkgs[p]][1], name)


#: name → (engine kwargs, work(pkgs) → fn(p, engine))
CASES = {
    "allreduce_ordered": ({}, lambda pk: lambda p, e: e.allreduce(
        X[p], _op(pk, p, "SUM"), 1, ordered=True)),
    "allreduce_ring": ({"ring_threshold": 0}, lambda pk: lambda p, e: e.allreduce(
        X[p], _op(pk, p, "SUM"), 1)),
    "allreduce_prod_ring": ({"ring_threshold": 0}, lambda pk: lambda p, e: e.allreduce(
        X[p], _op(pk, p, "PROD"), 1)),
    "bcast": ({}, lambda pk: lambda p, e: e.bcast(X[p], 1, 1)),
    "allgather": ({}, lambda pk: lambda p, e: e.allgather(X[p], 1)),
    "alltoall": ({}, lambda pk: lambda p, e: e.alltoall(list(BLOCKS[p]), 1)),
    "gather": ({}, lambda pk: lambda p, e: e.gather(X[p], 0, 1)),
    "scatter": ({}, lambda pk: lambda p, e: e.scatter(list(BLOCKS[p]), 0, 1)),
    "allgather_obj": ({}, lambda pk: lambda p, e: e.allgather_obj({"p": p}, 1)),
    "rendezvous": ({"eager_limit": 4096, "frag_size": 4096},
                   lambda pk: lambda p, e: e.allgather(BIG[p], 1)),
}


def _flat(v):
    if v is None:
        return [b"none"]
    if isinstance(v, list):
        return [x for e in v for x in _flat(e)]
    if isinstance(v, dict):
        return [json.dumps(v).encode()]
    a = np.asarray(v)
    return [a.dtype.str.encode(), str(a.shape).encode(), a.tobytes()]


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_engines_match_reference_engines(case):
    kw, work = CASES[case]
    pkgs_r, pkgs_p = ["ref"] * 3, ["port"] * 3
    ref = _run(_engines(pkgs_r, **kw), work(pkgs_r))
    port = _run(_engines(pkgs_p, **kw), work(pkgs_p))
    assert [_flat(r) for r in port] == [_flat(r) for r in ref]


@pytest.mark.parametrize("transport", ["tcp", "sm"])
@pytest.mark.parametrize("order", [("ref", "port"), ("port", "ref")], ids=["ref0", "port0"])
def test_mixed_job_reference_and_port(transport, order):
    """One reference and one port process on one wire: collectives in
    both fold orders, bcast, allgather (rendezvous included) and p2p
    frames agree with an all-reference job bit for bit."""
    pkgs = list(order)
    kw = {"transport": transport, "eager_limit": 4096, "frag_size": 4096}

    def work(pk):
        def fn(p, e):
            got = []
            e.register_p2p(9, lambda env, pl: got.append((env, pl)))
            out = [
                e.allreduce(X[p], _op(pk, p, "SUM"), 1, ordered=True),
                e.allreduce(BIG[p], _op(pk, p, "SUM"), 1),  # ring, rendezvous chunks
                e.bcast(BIG[p], 0, 1),
                e.allgather(X[p], 1),
            ]
            e.send_p2p(1 - p, {"cid": 9, "src": p, "dst": 1 - p, "tag": 3}, X[p] * 2)
            e.barrier(1)  # both p2p frames were sent before anyone returns
            deadline = time.monotonic() + 10
            while not got and time.monotonic() < deadline:
                time.sleep(0.01)
            env, pl = got[0]
            return out + [pl, {k: env[k] for k in ("cid", "src", "dst", "tag", "kind")}]

        return fn

    mixed = _run(_engines(pkgs, **kw), work(pkgs))
    ref = _run(_engines(["ref", "ref"], **kw), work(["ref", "ref"]))
    assert [_flat(r) for r in mixed] == [_flat(r) for r in ref]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_a_dead_peer_raises_proc_failed(pkg):
    """No fallback on a broken transport: a collective whose peer has
    gone runs out ``dcn_recv_timeout`` (0.5 s here) and raises
    MPIX_ERR_PROC_FAILED naming that peer, in both packages."""
    from ompi_tpu.core import mca as rmca
    from ompi_tpu.core.errors import MPIProcFailedError as RFailed
    from ompi_tpu_torch.core import mca as pmca
    from ompi_tpu_torch.core.errors import MPIProcFailedError as PFailed

    ctx = {"ref": rmca, "port": pmca}[pkg]
    store = ctx.default_context().store
    old = store.get("dcn_recv_timeout")
    store.set("dcn_recv_timeout", 0.5)
    e0, e1 = _engines([pkg, pkg])
    try:
        e1.close()
        with pytest.raises({"ref": RFailed, "port": PFailed}[pkg]) as err:
            e0.allreduce(X[0], _op([pkg], 0, "SUM"), 1, ordered=True)
        assert err.value.failed == (1,) and e0.proc_failed(1)
    finally:
        e0.close()
        store.set("dcn_recv_timeout", old)


# -- the wire, byte for byte ----------------------------------------------


class _Recorder:
    """A peer that answers the dial handshake and records every later
    frame as (type, envelope bytes, meta bytes, payload bytes)."""

    def __init__(self):
        self.lst = socket.socket()
        self.lst.bind(("127.0.0.1", 0))
        self.lst.listen(1)
        self.address = "%s:%d" % self.lst.getsockname()
        self.frames = []
        self.t = threading.Thread(target=self._serve, daemon=True)
        self.t.start()

    def _exact(self, c, n):
        buf = b""
        while len(buf) < n:
            chunk = c.recv(n - len(buf))
            if not chunk:
                raise ConnectionError
            buf += chunk
        return buf

    def _serve(self):
        hdr = struct.Struct("!BIIQ")
        c, _ = self.lst.accept()
        try:
            while True:
                ft, el, ml, rl = hdr.unpack(self._exact(c, hdr.size))
                env, meta = self._exact(c, el), self._exact(c, ml)
                if ft == 5:  # HELLO → SEQACK (ack 0, fixed clock stamp)
                    renv = json.dumps({"ack": 0, "rt": 0}).encode()
                    c.sendall(hdr.pack(6, len(renv), 0, 0) + renv)
                    continue
                raw = self._exact(c, rl) if ft == 0 else b""
                self.frames.append((ft, env, meta, raw))
        except (ConnectionError, OSError):
            pass

    def wait(self, n):
        deadline = time.monotonic() + 10
        while len(self.frames) < n and time.monotonic() < deadline:
            time.sleep(0.01)
        return self.frames


def _masked(frames, sender):
    """Frames with the sender's own listen address masked (it is the
    one field that differs between two senders)."""
    return [(ft, env.replace(sender.address.encode(), b"SENDER"), meta, raw)
            for ft, env, meta, raw in frames]


def _record(tcp_mod, sends):
    rec = _Recorder()
    tr = tcp_mod.TcpTransport(lambda env, pl: None, eager_limit=4096)
    try:
        for env, payload in sends:
            if env.get("kind") == "rts-only":
                # a rendezvous send blocks for a CTS the recorder never
                # grants: record its RTS frame, then drop the connection
                threading.Thread(target=lambda: _ignore(tr.send, rec.address,
                                                        {"kind": "coll"}, payload),
                                 daemon=True).start()
                continue
            tr.send(rec.address, env, payload)
        frames = rec.wait(len(sends))
        return _masked(frames, tr)
    finally:
        tr.close()
        rec.lst.close()


def _ignore(fn, *a):
    try:
        fn(*a)
    except Exception:  # noqa: BLE001 — the recorder never grants the CTS
        pass


def test_frames_are_byte_identical_to_the_reference():
    x = np.random.default_rng(3).standard_normal((3, 5)).astype(np.float32)
    big = np.arange(2048, dtype=np.float64)  # 16 KB > eager limit: RTS
    sends = [
        ({"kind": "coll", "cid": 4, "seq": 0, "src": 1}, x),
        ({"kind": "coll", "cid": "4#nbc0", "seq": 2, "src": 1, "meta": [{"shape": [2],
                                                                        "dtype": "<i4"}]},
         np.zeros(0, np.uint8)),
        ({"kind": "p2p", "cid": 4, "src": 1, "dst": 2, "tag": 7}, np.arange(6, dtype=np.int64)),
        ({"kind": "hb", "src": 1}, np.zeros(0, np.uint8)),
        ({"kind": "rts-only"}, big),
    ]
    ref = _record(rtcp, sends)
    port = _record(ptcp, sends)
    assert len(ref) == len(sends) and port == ref
    assert [f[0] for f in port] == [0, 0, 0, 0, 1]  # EAGER ×4, then the RTS


def test_bfloat16_on_the_wire():
    """The reference's sender refuses an ml_dtypes bfloat16 array; the
    port's sends its raw words with the meta the reference writes for
    it, and a reference receiver gets those bytes as two-byte voids."""
    vals = np.array([1.5, -2.0, 3.25, 0.1], ml_dtypes.bfloat16)
    ref_tr = rtcp.TcpTransport(lambda env, pl: None)
    try:
        with pytest.raises(ValueError, match="cannot include dtype"):
            ref_tr.send(ref_tr.address, {"kind": "p2p", "cid": 1}, vals)
    finally:
        ref_tr.close()
    from ompi_tpu_torch.coll.han import to_host

    words = to_host(torch.tensor([1.5, -2.0, 3.25, 0.1], dtype=torch.bfloat16))
    assert words.dtype == ptcp.BF16_HOST
    assert ptcp._meta_bytes(words) == rtcp._meta_bytes(vals)
    assert words.tobytes() == vals.tobytes()
    got = []
    ref_rx = rtcp.TcpTransport(lambda env, pl: got.append(pl))
    port_tx = ptcp.TcpTransport(lambda env, pl: None)
    try:
        port_tx.send(ref_rx.address, {"kind": "p2p", "cid": 1}, words)
        deadline = time.monotonic() + 10
        while not got and time.monotonic() < deadline:
            time.sleep(0.01)
        assert got[0].dtype == np.dtype("V2") and got[0].tobytes() == vals.tobytes()
    finally:
        port_tx.close()
        ref_rx.close()


def test_bfloat16_allreduce_between_port_engines():
    """The port's han folds a bfloat16 DCN leg with the op's torch
    kernel on the CPU over the raw words (numpy has no bfloat16)."""
    from ompi_tpu_torch.coll.han import host_op, to_host

    rows = [torch.tensor([1.5, 2.0, -3.0, 0.25], dtype=torch.bfloat16) * (p + 1)
            for p in range(3)]
    op = host_op(pop.SUM, torch.bfloat16)
    out = _run(_engines(["port"] * 3), lambda p, e: e.allreduce(to_host(rows[p]), op, 1))
    want = ((rows[0] + rows[1]) + rows[2]).view(torch.int16).numpy()
    for r in out:
        assert r.dtype == ptcp.BF16_HOST
        np.testing.assert_array_equal(r.view(np.int16), want)

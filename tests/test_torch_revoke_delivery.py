"""A revoke reaches every member process that is alive.

``MultiProcComm.revoke`` sends one ``rvk`` control frame to each member
process.  The native plane refuses a control frame while the peer's send
path is busy (``csrc/dcn.cc:engine_send_peer`` only tries the peer's send
lock, and gives a control record 2 ms of ring space), and a revoke is not
repeated the way a heartbeat is.  So a failed send toward a peer held
live is retried until the frame goes out or the peer is marked failed;
past ``dcn_connect_timeout`` of failed attempts the revoking process
marks the peer failed itself.  A peer already marked failed gets no
frame: the revoke stands locally, as in the reference.
"""

import pytest

from ompi_tpu_torch.api.multiproc import MultiProcComm
from ompi_tpu_torch.core import var
from ompi_tpu_torch.dcn.collops import REVOKE_COUNTS
from ompi_tpu_torch.ft import ulfm


class _Engine:
    """A root engine whose control sends to ``fails[p]`` raise that many
    times first, as the native plane's do while the peer's send path is
    busy."""

    def __init__(self, fails=None, failed=(), mark_after=None):
        self.fails = dict(fails or {})
        self.failed = set(failed)
        self.mark_after = mark_after
        self.sent: list[tuple[int, dict]] = []
        self.attempts = 0
        self.revoke_counts = dict.fromkeys(REVOKE_COUNTS, 0)
        self._detector = None
        self.woken: list = []

    def _root_engine(self):
        return self

    def coll_revoke(self, cid) -> None:
        self.woken.append(cid)

    def proc_failed(self, p: int) -> bool:
        return p in self.failed

    def root_proc_of(self, p: int) -> int:
        return p

    def note_proc_failed(self, p: int) -> None:
        self.failed.add(p)

    def send_ctrl(self, p: int, env: dict) -> None:
        self.attempts += 1
        if self.mark_after is not None and self.attempts >= self.mark_after:
            self.failed.add(p)  # the detector marks the peer meanwhile
        if self.fails.get(p, 0):
            self.fails[p] -= 1
            raise ConnectionError(f"native dcn ctrl send to proc {p} failed (rc=-1)")
        self.sent.append((p, dict(env)))


class _Comm(MultiProcComm):
    """The revoke half of a communicator of ``nprocs`` processes."""

    def __init__(self, engine, nprocs=3, proc=0):
        self.dcn, self.nprocs, self.proc, self.cid = engine, nprocs, proc, 7
        self._ft = None


def test_a_refused_rvk_is_retried_until_it_is_sent():
    eng = _Engine(fails={1: 1, 2: 3})
    comm = _Comm(eng)
    comm.revoke()
    assert ulfm.is_revoked(comm) and eng.woken == [7]
    assert eng.sent == [(1, {"kind": "rvk", "cid": 7}), (2, {"kind": "rvk", "cid": 7})]
    assert eng.revoke_counts == {"send_failed": 4, "skipped_failed": 0, "unmatched": 0}


def test_a_peer_marked_failed_gets_no_rvk():
    eng = _Engine(fails={1: 10**9}, failed={2}, mark_after=3)
    comm = _Comm(eng)
    comm.revoke()
    assert ulfm.is_revoked(comm)
    assert eng.sent == [] and eng.attempts == 3
    assert eng.revoke_counts == {"send_failed": 3, "skipped_failed": 2, "unmatched": 0}


def test_a_peer_that_refuses_past_the_deadline_is_marked_failed(monkeypatch):
    monkeypatch.setattr(var, "dcn_timeout", lambda name: 0.05)
    eng = _Engine(fails={1: 10**9})
    comm = _Comm(eng, nprocs=2)
    comm.revoke()
    assert ulfm.is_revoked(comm)
    assert eng.failed == {1} and eng.sent == []
    assert eng.revoke_counts["send_failed"] >= 2


@pytest.mark.parametrize("proc", [0, 1])
def test_the_revoking_process_sends_itself_nothing(proc):
    eng = _Engine()
    comm = _Comm(eng, nprocs=2, proc=proc)
    comm.revoke()
    assert eng.sent == [(1 - proc, {"kind": "rvk", "cid": 7})]

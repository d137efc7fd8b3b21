"""The port's fault-tolerance layer against the reference's.

* ``compute_groups`` / ``parse_host_ids`` (the detector groups the
  sharded modex also uses) equal the reference's on the same inputs;
* the ULFM state machine (``check``, ``revoke``, ``get_failed``,
  ``ack_failed``, single-controller ``agree``) raises and answers as the
  reference's on a stand-in communicator;
* across 2 processes under ``tpurun --ft`` (heartbeat detector on):
  ``agree`` ANDs the processes' flags, ``revoke`` on one process poisons
  the communicator on the other, and ``agree`` still works after it.
"""

import pytest

from ompi_tpu.ft import detector as rdet
from ompi_tpu.ft import ulfm as rulfm
from ompi_tpu_torch.ft import detector as pdet
from ompi_tpu_torch.ft import ulfm as pulfm
from torch_mp_common import run_job


@pytest.mark.parametrize("nprocs,gsz,hosts", [
    (1, 8, None), (10, 4, None), (16, 8, None), (7, 0, None), (7, -3, None),
    (6, 2, [0, 0, 1, 1, 2, 2]), (5, 8, [1, 0, 1, 0, 2]), (4, 8, [0, 0]),
])
def test_compute_groups_matches_reference(nprocs, gsz, hosts):
    assert pdet.compute_groups(nprocs, gsz, hosts) == rdet.compute_groups(nprocs, gsz, hosts)


@pytest.mark.parametrize("raw,n", [("", 3), ("0,0,1", 3), ("0,1", 3), ("a,b", 2), ("2", 1)])
def test_parse_host_ids_matches_reference(raw, n):
    assert pdet.parse_host_ids(raw, n) == rdet.parse_host_ids(raw, n)


class _Comm:
    def __init__(self, size=4):
        self.size, self.name, self._ft = size, "c", None


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the class name is compared
        return ("err", type(e).__name__, getattr(e, "failed", None))


def test_ulfm_state_machine_matches_reference():
    steps = [
        lambda u, c: u.check(c, collective=True),
        lambda u, c: u.inject_failure(c, 2),
        lambda u, c: u.inject_failure(c, 9),
        lambda u, c: u.check(c, peer=1),
        lambda u, c: u.check(c, peer=2),
        lambda u, c: u.check(c, collective=True),
        lambda u, c: u.check(c, any_source=True),
        lambda u, c: u.get_failed(c),
        lambda u, c: u.ack_failed(c),
        lambda u, c: u.check(c, any_source=True),
        lambda u, c: u.agree(c, 0b1110, {0: 0b0111, 2: 0}),
        lambda u, c: u.is_revoked(c),
        lambda u, c: u.revoke(c),
        lambda u, c: u.is_revoked(c),
        lambda u, c: u.check(c, peer=1),
        lambda u, c: u.agree(c, 0b11),
    ]
    cr, cp = _Comm(), _Comm()
    got_r = [_outcome(lambda s=s: s(rulfm, cr)) for s in steps]
    got_p = [_outcome(lambda s=s: s(pulfm, cp)) for s in steps]
    assert got_p == got_r


def test_agree_and_revoke_across_two_procs(tmp_path):
    script = tmp_path / "ft.py"
    script.write_text(
        "import time\n"
        "import numpy as np\n"
        "import ompi_tpu_torch.api as api\n"
        "from ompi_tpu_torch.core.errors import MPIRevokedError\n"
        "from ompi_tpu_torch.op import SUM\n"
        "w = api.init(device='cpu')\n"
        "assert w.procctx.detector is not None\n"
        "det, root = w.procctx.detector, w.dcn._root_engine()\n"
        "print(f'T_BOOT proc={w.proc} t_boot={det.t_boot!r}', flush=True)\n"
        "a = w.agree(0b1111 if w.proc == 0 else 0b0110)\n"
        "assert a == 0b0110, a\n"
        "sub = w.dup()\n"
        "sub.barrier()\n"
        "if w.proc == 0:\n"
        "    sub.revoke()\n"
        "deadline = time.monotonic() + 10\n"
        "while not sub.is_revoked() and time.monotonic() < deadline:\n"
        "    time.sleep(0.01)\n"
        "print(f'REVOKE proc={w.proc} seen={sub.is_revoked()} counts={root.revoke_counts} '\n"
        "      f'detector_failed={sorted(det.failed())} engine_failed={sorted(root._failed_procs)} '\n"
        "      f'heals={det.counters[\"false_positive_heals\"]}', flush=True)\n"
        "assert sub.is_revoked()\n"
        "try:\n"
        "    sub.allreduce(np.ones((1, 2)), SUM)\n"
        "    raise AssertionError('collective on a revoked comm')\n"
        "except MPIRevokedError:\n"
        "    pass\n"
        "assert sub.agree(3) == 3  # agreement works on a revoked comm\n"
        "assert w.get_failed() == [] and not w.is_revoked()\n"
        "assert (w.allreduce(np.ones((1, 2)), SUM) == 2).all()\n"
        "print(f'OK ft proc={w.proc}', flush=True)\n"
        "api.finalize()\n")
    res = run_job("port", 2, 1, script, timeout=90, flags=["--ft"])
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count("OK ft") == 2, res.stdout


def test_failure_reaches_the_comms_before_it_wakes_the_engine():
    """A mark fans out to the communicators' ULFM state before the engine
    wakes the receives blocked on the proc: a survivor woken by the mark
    finds the failure there when it calls ``replace()``/``shrink()``."""
    order = []

    class Engine:
        proc, nprocs = 0, 3

        def note_proc_failed(self, p):
            order.append(("engine", p))

        def send_ctrl(self, p, env):
            pass

        def attach_detector(self, det):
            pass

    det = pdet.HeartbeatDetector(Engine(), period=60.0, timeout=120.0)
    try:
        det.on_failure(lambda p: order.append(("comms", p)))
        assert det.mark_failed(2, gossip=False)
        assert not det.mark_failed(2, gossip=False)
    finally:
        det.close()
    assert order == [("comms", 2), ("engine", 2)]

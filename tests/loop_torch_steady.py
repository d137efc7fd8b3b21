"""The port's tests that failed now and then, many times each, for a loop
under load (not collected by the tier-1 run: the name does not start with
``test_``).  Each case runs a test unchanged beside the other cases and
the multi-process files; pick one loop with ``-k``::

    JAX_PLATFORMS=cpu PYTHONPATH=tests:. python -m pytest -q -p no:cacheprovider \\
        -p xdist -n 6 --dist load tests/loop_torch_steady.py \\
        tests/test_torch_ulfm.py tests/test_torch_multiproc.py

    # one loop, six side-by-side copies of it and nothing else:
    JAX_PLATFORMS=cpu PYTHONPATH=tests:. python -m pytest -q -p no:cacheprovider \\
        -p xdist -n 6 --dist load tests/loop_torch_steady.py -k respawn_rehearsal_loop

The loops: the tpud stall whose three surfaces must name one root; the
windowed burst that must suppress doorbell wakes; the card's respawn
worker rehearsed on the CPU (its device-plane fallbacks only in the
failing call, toward the corpse); the daemon-restart soak (a daemon
SIGKILLed at a publish, restarted, each job published once); the windowed
streaming rate against the serial send (marked slow, so outside tier 1);
the partial ``replace()`` of a 3-process job; and the 3 × 1 port job held
bit for bit to the reference's.
"""

import pytest

import test_torch_chaos
import test_torch_multiproc_np3
import test_torch_serve_waitgraph
import test_torch_stream_engine
import test_torch_ulfm


def _engine_pair():
    native = test_torch_stream_engine._native()
    a = native.NativeDcnEngine(0, 2)
    b = native.NativeDcnEngine(1, 2)
    addrs = [a.address, b.address]
    a.set_addresses(addrs)
    b.set_addresses(addrs)
    return a, b


@pytest.mark.parametrize("i", range(50))
def test_stall_hang_three_surfaces_loop(i, tmp_path):
    test_torch_serve_waitgraph.test_tpud_np2_stall_hang_three_surfaces_name_same_root(tmp_path)


@pytest.mark.parametrize("i", range(50))
def test_windowed_burst_loop(i):
    a, b = _engine_pair()
    try:
        test_torch_stream_engine.test_windowed_burst_pipelines_and_coalesces((a, b))
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("i", range(48))
def test_respawn_rehearsal_loop(i):
    test_torch_ulfm.test_ft_smoke_respawn_rehearsal()


@pytest.mark.parametrize("i", range(48))
def test_daemon_restart_soak_loop(i, tmp_path):
    test_torch_chaos.test_daemon_restart_soak(tmp_path)


@pytest.mark.parametrize("i", range(50))
def test_windowed_streaming_rate_loop(i):
    a, b = _engine_pair()
    try:
        test_torch_stream_engine.test_windowed_streaming_matches_serial_rate((a, b))
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("i", range(24))
def test_partial_replace_loop(i, tmp_path):
    test_torch_ulfm.test_tpurun_partial_replace_repairs_members_only(tmp_path)


@pytest.mark.parametrize("i", range(24))
def test_np3_bitwise_loop(i, tmp_path):
    test_torch_multiproc_np3.test_port_job_3x1_bitwise_equal_to_reference(tmp_path)

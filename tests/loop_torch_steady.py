"""The port's two tests that failed now and then, 50 times each, for a
loop under load (not collected by the tier-1 run: the name does not
start with ``test_``)::

    JAX_PLATFORMS=cpu PYTHONPATH=tests:. python -m pytest -q -p no:cacheprovider \\
        -p xdist -n 6 --dist load tests/loop_torch_steady.py \\
        tests/test_torch_ulfm.py tests/test_torch_multiproc.py

Each case runs the test unchanged beside the other cases and the two
multi-process files: the tpud stall whose three surfaces must name one
root, and the windowed burst that must suppress doorbell wakes.
"""

import pytest

import test_torch_serve_waitgraph
import test_torch_stream_engine


@pytest.mark.parametrize("i", range(50))
def test_stall_hang_three_surfaces_loop(i, tmp_path):
    test_torch_serve_waitgraph.test_tpud_np2_stall_hang_three_surfaces_name_same_root(tmp_path)


@pytest.mark.parametrize("i", range(50))
def test_windowed_burst_loop(i):
    native = test_torch_stream_engine._native()
    a = native.NativeDcnEngine(0, 2)
    b = native.NativeDcnEngine(1, 2)
    try:
        addrs = [a.address, b.address]
        a.set_addresses(addrs)
        b.set_addresses(addrs)
        test_torch_stream_engine.test_windowed_burst_pipelines_and_coalesces((a, b))
    finally:
        a.close()
        b.close()

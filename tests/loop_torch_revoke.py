"""``test_agree_and_revoke_across_two_procs`` 50 times, for a loop under
load (not collected by the tier-1 run: the name does not start with
``test_``)::

    JAX_PLATFORMS=cpu PYTHONPATH=tests:. python -m pytest -q -p no:cacheprovider \\
        -p xdist -n 6 --dist load tests/loop_torch_revoke.py \\
        tests/test_torch_ulfm.py tests/test_torch_multiproc.py

Each case runs the test's own worker script unchanged (its 10 s deadline
included) beside the other cases and the two multi-process files.
"""

import pytest

import test_torch_ft


@pytest.mark.parametrize("i", range(50))
def test_agree_and_revoke_loop(i, tmp_path):
    test_torch_ft.test_agree_and_revoke_across_two_procs(tmp_path)

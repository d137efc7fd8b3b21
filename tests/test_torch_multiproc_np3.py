"""Multi-process jobs of the port: 3 processes of 1 virtual rank each
(the DCN leg alone: every local leg is an identity), and the launcher's
refusals.

The shared SPMD worker body runs under both launchers with the
reproducible vars on (port: ``coll_cuda_reproducible=1``, reference:
``coll_xla_reproducible=1``, both ``coll_han_reproducible=1``) on the
numpy inputs of seed 20261016; every result is compared bit for bit.
The split uses descending keys here, so a sub-communicator's process
order differs from the parent's.
"""

import sys

import pytest

from torch_mp_common import (assert_bitwise_equal, load, mirrored_worker,
                             run_job)


def test_port_job_3x1_bitwise_equal_to_reference(tmp_path):
    outs = {}
    for pkg, mca in (("port", {"coll_cuda_reproducible": "1", "coll_han_reproducible": "1"}),
                     ("ref", {"coll_xla_reproducible": "1", "coll_han_reproducible": "1"})):
        out = tmp_path / pkg
        out.mkdir()
        res = run_job(pkg, 3, 1, mirrored_worker(tmp_path / f"w_{pkg}.py", pkg), [out],
                      mca=mca)
        assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
        outs[pkg] = load(out, 3)
    assert_bitwise_equal(outs["port"], outs["ref"])


@pytest.mark.parametrize("btl", ["tpc", "native"])
def test_unknown_btl_aborts_the_job(tmp_path, btl):
    """A mistyped include aborts at the btl open (no silent fall back to
    bml).  ``native`` is a real component now; what aborts there is a
    job whose processes meet on different planes: process 1 forces the
    Python ``tcp`` while process 0 runs ``native``, and the modex names
    the mismatch instead of letting the first collective hang."""
    script = tmp_path / "w.py"
    script.write_text("import os\n"
                      "if os.environ['OMPI_TPU_PROC'] == '1':\n"
                      "    os.environ['OMPI_MCA_btl'] = 'tcp'\n"
                      "import ompi_tpu_torch.api as api\n"
                      "api.init(device='cpu')\n"
                      "print('initialized', flush=True)\n")
    res = run_job("port", 2, 1, script, mca={"btl": btl}, timeout=60)
    assert res.returncode != 0
    assert "initialized" not in res.stdout
    if btl == "native":
        assert "DCN wire-plane mismatch" in res.stdout + res.stderr, res.stdout[-3000:]
    else:
        assert f"--mca btl {btl}: no such component" in res.stdout, res.stdout[-3000:]


def test_sm_job_leaves_no_tracker_noise(tmp_path):
    """A 4 MiB allreduce over ``btl sm`` (above the 2 MiB
    ``btl_sm_shm_threshold``: the payload rides the shared-memory rings)
    is right, and closing the rings leaves the resource tracker silent
    (the reference prints a KeyError traceback per ring at exit)."""
    script = tmp_path / "w.py"
    script.write_text("import numpy as np\n"
                      "import ompi_tpu_torch.api as api\n"
                      "w = api.init(device='cpu')\n"
                      "out = w.allreduce(np.full((1, 1 << 20), w.proc + 1.0, np.float32))\n"
                      "assert (out == 3).all()\n"
                      "print('summed', flush=True)\n"
                      "api.finalize()\n")
    res = run_job("port", 2, 1, script, mca={"btl": "sm"}, timeout=60)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert res.stdout.count("summed") == 2
    assert "Traceback" not in res.stdout + res.stderr, res.stdout[-3000:]


def test_worker_without_cuda_and_without_cpu_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise here")
    script = tmp_path / "w.py"
    script.write_text("import ompi_tpu_torch.api as api\n"
                      "api.init()\n"
                      "print('initialized', flush=True)\n")
    res = run_job("port", 1, 1, script, timeout=60)
    assert res.returncode != 0 and "initialized" not in res.stdout
    assert "no CUDA device is available" in res.stdout


def test_launcher_help_names_nranks():
    import subprocess

    res = subprocess.run([sys.executable, "-m", "ompi_tpu_torch", "run", "--help"],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0 and "--nranks" in res.stdout

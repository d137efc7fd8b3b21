"""Import hygiene and device defaults of the PyTorch port.

* ``ompi_tpu_torch`` and ``chip_smoke.py`` import neither JAX nor the
  JAX package — checked in a fresh interpreter (this test process has
  JAX loaded already, by ``tests/conftest.py``) and on the source's AST;
* the entry points default to CUDA and raise where there is none, and
  the point-to-point, window and convertor paths keep a tensor on its
  own device (checked on the meta device, which has no host copy);
* the kernel wrappers launch or raise for tensors that are not on the
  CPU, and never hand back their plain result instead.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "ompi_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ompi_tpu")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_source_imports_no_jax(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys\n"
        "import ompi_tpu_torch, ompi_tpu_torch.api, ompi_tpu_torch.coll, ompi_tpu_torch.entry\n"
        "import ompi_tpu_torch.coll.cuda_kernels, ompi_tpu_torch.examples.ddp_training\n"
        "import ompi_tpu_torch.p2p, ompi_tpu_torch.p2p.part, ompi_tpu_torch.osc\n"
        "import ompi_tpu_torch.io, ompi_tpu_torch.io.checkpoint, ompi_tpu_torch.ddt.convertor\n"
        "import ompi_tpu_torch.tool.memchecker, ompi_tpu_torch.p2p.vprotocol\n"
        "from ompi_tpu_torch.core import mca\n"
        "mca.default_context().open_all()\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_default_to_cuda_and_raise_without_it():
    import ompi_tpu_torch.api as api
    from ompi_tpu_torch.core.errors import MPIInternalError
    from ompi_tpu_torch.entry import dryrun, entry
    from ompi_tpu_torch.mesh import CommMesh, resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise here")
    api.finalize()
    for call in (api.init, api.world, CommMesh, resolve_device, entry, dryrun,
                 lambda: api.init(device="cuda")):
        with pytest.raises(MPIInternalError, match="no CUDA device"):
            call()
    assert not api.initialized()
    assert resolve_device("cpu") == torch.device("cpu")


def test_new_entry_points_keep_tensors_on_the_comms_device():
    """A comm on the meta device: window memory, RMA epochs, messages
    and packs all stay there — none of them has a host fallback."""
    import numpy as np

    from ompi_tpu_torch.api import Comm, Group
    from ompi_tpu_torch.ddt import FLOAT, pack
    from ompi_tpu_torch.mesh import CommMesh
    from ompi_tpu_torch.op import SUM

    comm = Comm(Group(range(4)), CommMesh("meta", 4), name="meta")
    win = comm.win_allocate(8)
    assert win.device_view().device.type == "meta"
    win.fence()
    win.accumulate(0, 1, torch.empty(8, device="meta"), op=SUM)
    got = win.get(2, 1, 8)
    fop = win.fetch_and_op(3, 1, 1.0)
    cas = win.compare_and_swap(3, 1, 2.0, 1.0)
    win.fence()
    for r in (got, fop, cas):
        assert r.wait().device.type == "meta"
    comm.send(torch.empty(5, device="meta"), 0, 2)
    payload, status = comm.recv(2, 0)
    assert payload.device.type == "meta" and status.nbytes == 20
    vec = FLOAT.create_vector(2, 1, 3)
    assert pack(torch.empty(8, device="meta"), vec, 2).device.type == "meta"
    comm.send(np.arange(3), 1, 3)  # host payloads stay host
    assert isinstance(comm.recv(3, 1)[0], np.ndarray)


def test_kernel_wrappers_raise_instead_of_running_the_plain_twin():
    from ompi_tpu_torch.coll import cuda_kernels as ck
    from ompi_tpu_torch.op import SUM

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the wrappers launch there")
    x = torch.zeros((4, 2, 8), device="meta")
    idx = torch.zeros(4, dtype=torch.int32, device="meta")
    before = dict(ck.LAUNCHES)
    with pytest.raises(ck.KernelUnavailable):
        ck.ring_hop(x, idx, x, idx)
    with pytest.raises(ck.KernelUnavailable):
        ck.ring_hop_fold(x, idx, x, idx, x, idx, SUM)
    cpu = torch.zeros((4, 2, 8))
    cidx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ck.KernelUnavailable):  # the launch itself needs CUDA
        ck._launch_hop(cpu, cidx, cpu, cidx)
    with pytest.raises(ck.KernelUnavailable):
        ck._launch_fold(cpu, cidx, cpu, cidx, cpu, cidx, SUM, False)
    assert ck.LAUNCHES == before
    assert not ck.kernel_available()


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory, or on a machine without CUDA, the smoke
    script exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script, cwd in ((alone, tmp_path), (REPO / "chip_smoke.py", REPO)):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout

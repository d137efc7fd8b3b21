"""Import hygiene and device defaults of the PyTorch port.

* ``ompi_tpu_torch`` and ``chip_smoke.py`` import neither JAX nor the
  JAX package — checked in a fresh interpreter (this test process has
  JAX loaded already, by ``tests/conftest.py``) and on the source's AST
  (the multi-process workers check their own ``sys.modules`` too); the
  C++/CUDA sources under ``csrc/`` include only system, C++ and CUDA
  headers (nothing of ``native/``, no Python or PyTorch headers) and
  name no module of the JAX package;
* the C ABI's sources under ``csrc/capi/`` (the MPI shim, which embeds
  Python, and the OpenSHMEM shim over it) include only system headers,
  ``<Python.h>`` and the port's own ``mpi.h`` and ``shmem.h`` (nothing
  resolves into ``native/``), and import ``ompi_tpu_torch.capi`` and no
  module of the JAX package;
* the entry points default to CUDA and raise where there is none (a
  compiled C rank too), and
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
CSRC_FILES = sorted(p for p in (REPO / "ompi_tpu_torch" / "csrc").iterdir()
                    if p.suffix in (".cc", ".cu", ".cuh", ".h"))
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


@pytest.mark.parametrize("path", CSRC_FILES, ids=[p.name for p in CSRC_FILES])
def test_csrc_includes_no_python_and_names_no_jax_package(path):
    import re

    text = path.read_text()
    includes = re.findall(r"^\s*#\s*include\s*([<\"][^>\"]+[>\"])", text, re.M)
    assert includes and all(inc.startswith("<") for inc in includes), includes
    assert not [inc for inc in includes
                if re.match(r"<(Python|torch|ATen|c10|pybind11)", inc)], includes
    # a module name (``ompi_tpu.capi``, ``"jax"``), not a path in a comment
    assert not re.search(r"\b(ompi_tpu|jax)\.\w|\"(ompi_tpu|jax)\b", text)


CAPI_DIR = REPO / "ompi_tpu_torch" / "csrc" / "capi"
CAPI_FILES = sorted(p for p in CAPI_DIR.rglob("*") if p.suffix in (".c", ".h"))


@pytest.mark.parametrize("path", CAPI_FILES, ids=[str(p.relative_to(CAPI_DIR)) for p in CAPI_FILES])
def test_capi_sources_include_only_python_and_their_own_mpi_h(path):
    """The C ABI embeds Python, which the sources directly under
    ``csrc/`` must not: its files may include system headers,
    ``<Python.h>`` and the ``"mpi.h"`` and ``"shmem.h"`` of
    ``csrc/capi/include/``, and nothing that resolves into ``native/``."""
    import re

    text = path.read_text()
    includes = re.findall(r"^\s*#\s*include\s*([<\"][^>\"]+[>\"])", text, re.M)
    assert includes or path.suffix == ".h"
    for inc in includes:
        name = inc[1:-1]
        if inc.startswith('"'):
            assert name in ("mpi.h", "shmem.h") and (CAPI_DIR / "include" / name).is_file(), inc
        else:
            assert not re.match(r"(torch|ATen|c10|pybind11)", name), inc
            assert ".." not in name and "native" not in name, inc
    assert not re.search(r"\b(ompi_tpu|jax)\.\w|\"(ompi_tpu|jax)\b", text)
    if path.name == "shim.c":
        assert re.findall(r'PyImport_ImportModule\("([\w.]+)"\)', text) == ["ompi_tpu_torch.capi"]
    if path.name == "shmem_shim.c":  # a thin mapping onto MPI: no Python of its own
        assert "Python.h" not in text and "PyImport" not in text


def test_capi_covers_the_shim_and_its_header():
    assert {str(p.relative_to(CAPI_DIR)) for p in CAPI_FILES} == {
        "shim.c", "shmem_shim.c", "include/mpi.h", "include/shmem.h"}


def test_c_rank_defaults_to_cuda_and_raises_without_it(tmp_path):
    """A compiled MPI program runs its rank on CUDA: standalone without
    ``OMPI_TPU_DEVICE=cpu``, or under the launcher without ``--cpu``, it
    raises at MPI_Init where there is no card and prints no result."""
    import os

    from ompi_tpu_torch import native

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise here")
    src = tmp_path / "init.c"
    src.write_text('#include <mpi.h>\n#include <stdio.h>\n'
                   'int main(int c, char **v) { MPI_Init(&c, &v); puts("INIT OK");'
                   ' MPI_Finalize(); return 0; }\n')
    binary = native.compile_mpi_program(src, tmp_path / "init")
    env = {k: v for k, v in os.environ.items() if k not in ("OMPI_TPU_DEVICE", "OMPI_TPU_PROC")}
    alone = subprocess.run([str(binary)], capture_output=True, text=True, timeout=120,
                           env=env, cwd=tmp_path)
    launched = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch", "run", "-np", "2", "--nranks", "1",
         str(binary)], capture_output=True, text=True, timeout=120,
        env=dict(env, PYTHONPATH=f"{REPO}:{env.get('PYTHONPATH', '')}"), cwd=tmp_path)
    for res in (alone, launched):
        assert res.returncode != 0 and "INIT OK" not in res.stdout
        assert "no CUDA device" in res.stdout + res.stderr


def test_source_walk_covers_the_tools_and_their_workers():
    """The AST walk above reaches ``ompi_tpu_torch/tools/``, ``diag_pp.py``
    and the soaks' worker scripts (which run ``init`` when imported, so
    the import walk below stops at ``golden_capture`` and the workers'
    package)."""
    names = {str(p.relative_to(REPO / "ompi_tpu_torch")) for p in PORT_FILES
             if "tools" in p.parts}
    assert names >= {"tools/__init__.py", "tools/chaos.py", "tools/metrics_report.py",
                     "tools/trace_report.py", "tools/top.py", "tools/golden_capture.py",
                     "tools/diag_pp.py", "tools/workers/__init__.py",
                     "tools/workers/chaos_worker.py", "tools/workers/planes_worker.py",
                     "tools/workers/respawn_worker.py", "tools/workers/scale_worker.py",
                     "tools/workers/modex_worker.py", "tools/bench_joins.py",
                     "tools/bench_dispatch_floor.py", "tools/bench_dcn.py",
                     "tools/bench_device_plane.py"}, names


def test_csrc_covers_the_device_window_library():
    assert {p.name for p in CSRC_FILES} >= {"dcn.cc", "ring_hop.cu", "device_window.cu",
                                            "ring_hop_peer.cu"}


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys\n"
        "import ompi_tpu_torch, ompi_tpu_torch.api, ompi_tpu_torch.coll, ompi_tpu_torch.entry\n"
        "import ompi_tpu_torch.coll.cuda_kernels, ompi_tpu_torch.examples.ddp_training\n"
        "import ompi_tpu_torch.mesh.shards\n"
        "import ompi_tpu_torch.p2p, ompi_tpu_torch.p2p.part, ompi_tpu_torch.osc\n"
        "import ompi_tpu_torch.io, ompi_tpu_torch.io.checkpoint, ompi_tpu_torch.ddt.convertor\n"
        "import ompi_tpu_torch.tool.memchecker, ompi_tpu_torch.p2p.vprotocol\n"
        "import ompi_tpu_torch.api.multiproc, ompi_tpu_torch.coll.han, ompi_tpu_torch.boot\n"
        "import ompi_tpu_torch.boot.tpurun, ompi_tpu_torch.boot.rmaps, ompi_tpu_torch.boot.ras\n"
        "import ompi_tpu_torch.dcn, ompi_tpu_torch.dcn.component, ompi_tpu_torch.ft\n"
        "import ompi_tpu_torch.ft.detector, ompi_tpu_torch.faultsim, ompi_tpu_torch.__main__\n"
        "import ompi_tpu_torch.trace.waitgraph, ompi_tpu_torch.core.threads\n"
        "import ompi_tpu_torch.native, ompi_tpu_torch.dcn.native, ompi_tpu_torch.p2p.pml_native\n"
        "import ompi_tpu_torch.dcn.device, ompi_tpu_torch.metrics.export\n"
        "import ompi_tpu_torch.osc.dcn, ompi_tpu_torch.trace.causal, ompi_tpu_torch.trace.merge\n"
        "import ompi_tpu_torch.metrics.straggler, ompi_tpu_torch.examples.multiproc_smoke\n"
        "import ompi_tpu_torch.api.intercomm, ompi_tpu_torch.api.spawn, ompi_tpu_torch.api.topo\n"
        "import ompi_tpu_torch.api.info, ompi_tpu_torch.core.info\n"
        "import ompi_tpu_torch.examples.ring_attention, ompi_tpu_torch.examples.ft_smoke\n"
        "import ompi_tpu_torch.metrics.live, ompi_tpu_torch.serve, ompi_tpu_torch.serve.queue\n"
        "import ompi_tpu_torch.serve.state, ompi_tpu_torch.serve.client, ompi_tpu_torch.serve.worker\n"
        "import ompi_tpu_torch.serve.agent, ompi_tpu_torch.serve.daemon, ompi_tpu_torch.serve.tpud\n"
        "import ompi_tpu_torch.serve.ctl, ompi_tpu_torch.examples.serve_job\n"
        "import ompi_tpu_torch.capi, ompi_tpu_torch.shmem, ompi_tpu_torch.examples.pgas_stencil\n"
        "import ompi_tpu_torch.analysis.check, ompi_tpu_torch.analysis.sanitize\n"
        "import ompi_tpu_torch.analysis.memcheck, ompi_tpu_torch.analysis.lockdep\n"
        "import ompi_tpu_torch.tools, ompi_tpu_torch.tools.chaos, ompi_tpu_torch.tools.top\n"
        "import ompi_tpu_torch.tools.metrics_report, ompi_tpu_torch.tools.trace_report\n"
        "import ompi_tpu_torch.tools.workers, ompi_tpu_torch.tools.golden_capture\n"
        "import ompi_tpu_torch.tools.bench_joins, ompi_tpu_torch.tools.bench_dispatch_floor\n"
        "import ompi_tpu_torch.tools.bench_dcn, ompi_tpu_torch.tools.bench_device_plane\n"
        "import ompi_tpu_torch.tools.bench\n"
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


def test_shmem_init_raises_without_cuda_unless_a_cpu_world_exists():
    """``shmem.init()`` builds its world through ``api.init()``: on CUDA,
    raising where there is none; a CPU world built first is adopted."""
    import ompi_tpu_torch.api as api
    import ompi_tpu_torch.shmem as shmem
    from ompi_tpu_torch.core.errors import MPIInternalError

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise here")
    api.finalize()
    with pytest.raises(MPIInternalError, match="no CUDA device"):
        shmem.init(heap_bytes=1 << 16)
    assert not api.initialized() and shmem._state is None
    with pytest.raises(MPIInternalError, match="shmem.init"):
        shmem.my_pe()
    world = api.init(device="cpu", nranks=2)
    try:
        assert shmem.init(heap_bytes=1 << 16) is world
        assert shmem.malloc(4, torch.int32).view(1).device == torch.device("cpu")
    finally:
        shmem.finalize()
        api.finalize()


def test_stale_not_ported_notes_are_gone():
    """The device plane and the serving plane are ported: neither the
    metrics core nor the native engine says otherwise."""
    import ompi_tpu_torch.metrics.core as mcore

    for rel in ("metrics/core.py", "dcn/native.py"):
        assert "not ported" not in (REPO / "ompi_tpu_torch" / rel).read_text(), rel
    assert "dcn/device.py" in mcore.__doc__ and "serve/daemon.py" in mcore.__doc__


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
    shards = [torch.zeros(8, device="meta") for _ in range(4)]
    with pytest.raises(ck.KernelUnavailable):
        ck.ring_hop_peer(shards, [0] * 4, shards, [0] * 4, 8)
    with pytest.raises(ck.KernelUnavailable):  # a CPU ring has no kernel either
        ck._launch_peer(ck.PeerRing(["cpu"] * 4), [cpu] * 4, [0] * 4, [cpu] * 4, [0] * 4, 8)
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


def test_native_plane_loads_its_own_build():
    """The port's ``libtpudcn.so`` is its own build of
    ``ompi_tpu_torch/csrc/dcn.cc`` under ``build/ompi_tpu_torch/`` — the
    one library of that name a port process maps (never ``native/build``)."""
    code = (
        "from ompi_tpu_torch.dcn import native\n"
        "native.load_library()\n"
        "maps = open('/proc/self/maps').read().split()\n"
        "print(sorted({m for m in maps if m.endswith('libtpudcn.so')}))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == repr([str(REPO / "build" / "ompi_tpu_torch" / "libtpudcn.so")])

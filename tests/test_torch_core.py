"""The port's own copy of the MCA core against ``ompi_tpu.core``.

The var store resolves the same sources in the same order (api set >
``--mca`` > ``OMPI_MCA_*`` env > param files > default), converts enums
and booleans alike, and a framework's include/exclude list stacks the
coll components as in the reference.
"""

import numpy as np
import pytest

from ompi_tpu.core import var as jvar
from ompi_tpu_torch.core import registry as treg
from ompi_tpu_torch.core import var as tvar

ENUM = {"auto": 0, "ring": 2, "cuda_ring": 7}


def _stores(tmp_path, cmdline=None, env=None):
    conf = tmp_path / "mca-params.conf"
    conf.write_text("coll_x_algorithm = ring\ncoll_x_flag = yes\n# comment\n")
    kw = dict(cmdline=cmdline or {}, env=env or {}, param_files=[str(conf)])
    return jvar.VarStore(**kw), tvar.VarStore(**kw)


@pytest.mark.parametrize("cmdline,env", [
    ({}, {}),
    ({}, {"OMPI_MCA_coll_x_algorithm": "cuda_ring"}),
    ({"coll_x_algorithm": "7"}, {"OMPI_MCA_coll_x_algorithm": "2"}),
    ({}, {"OMPI_MCA_coll_x_flag": "off", "OMPI_TPU_MCA_coll_x_algorithm": "0"}),
])
def test_var_precedence_matches_reference(tmp_path, cmdline, env):
    js, ts = _stores(tmp_path, cmdline, env)
    for s in (js, ts):
        s.register("coll", "x", "algorithm", 0, type="int", enum=ENUM)
        s.register("coll", "x", "flag", False)
    for name in ("coll_x_algorithm", "coll_x_flag"):
        assert ts.get(name) == js.get(name)
        assert ts.get_var(name).source == js.get_var(name).source
    js.set("coll_x_algorithm", "cuda_ring")
    ts.set("coll_x_algorithm", "cuda_ring")
    assert ts.get("coll_x_algorithm") == js.get("coll_x_algorithm") == 7


def test_bad_enum_value_is_rejected_like_the_reference(tmp_path):
    js, ts = _stores(tmp_path)
    for s in (js, ts):
        s.register("coll", "x", "algorithm", 0, type="int", enum=ENUM)
    with pytest.raises(ValueError):
        js.set("coll_x_algorithm", "nope")
    with pytest.raises(ValueError):
        ts.set("coll_x_algorithm", "nope")


def test_exclude_list_leaves_the_host_component(tmp_path):
    from ompi_tpu_torch.api.comm import Comm
    from ompi_tpu_torch.api.group import Group
    from ompi_tpu_torch.coll import basic, cuda  # noqa: F401  (registration)
    from ompi_tpu_torch.coll.module import select_coll_modules
    from ompi_tpu_torch.mesh import CommMesh
    from ompi_tpu_torch.op import SUM

    ctx = treg.MCAContext(cmdline={"coll": "^cuda"}, env={}, param_files=[])
    fw = ctx.framework("coll")
    # tuned opens but has no coll/cuda module to wrap: basic serves
    assert [c.NAME for c in fw.selectable()] == ["tuned", "basic"]
    ctx = treg.MCAContext(cmdline={}, env={}, param_files=[])
    # sync and monitoring open only when their vars ask for them
    assert [c.NAME for c in ctx.framework("coll").selectable()] == ["tuned", "cuda", "basic"]
    with pytest.raises(treg.SelectionError):
        treg.MCAContext(cmdline={"coll": "nope"}, env={}, param_files=[]).framework(
            "coll").selectable()
    comm = Comm(Group(range(4)), CommMesh("cpu", 4))
    table = select_coll_modules(comm, treg.MCAContext(
        cmdline={"coll": "^cuda"}, env={}, param_files=[]).framework("coll"))
    assert table.providers["allreduce"] == "basic"
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(table.lookup("allreduce")(x, SUM),
                                  np.broadcast_to(x.sum(0), x.shape))

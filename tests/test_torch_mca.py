"""The port's MCA layer (``ompi_tpu_torch.core``) against ``ompi_tpu.core``.

The three entry points the port's MCA init lacked are held to the
reference on the same inputs:

* ``OMPI_TPU_COMPONENT_MODULES`` naming a module that registers a
  component: both packages' ``default_context()`` and ``init()`` import
  it, and both list the component;
* ``VarStore.build_env`` with only the non-default values, and with all;
* ``output.set_verbosity`` and ``output.reset`` gating ``verbose``.

Then every case of ``tests/test_mca_var.py`` and
``tests/test_mca_registry.py`` runs through both packages: each case's
outcome (values, sources, raised error classes, selection order) must
be the reference's, and the reference's expected value.
"""

import sys

import pytest

from ompi_tpu.core import info as jinfo
from ompi_tpu.core import mca as jmca
from ompi_tpu.core import output as jout
from ompi_tpu.core import registry as jreg
from ompi_tpu.core import var as jvar
from ompi_tpu_torch.core import info as tinfo
from ompi_tpu_torch.core import mca as tmca
from ompi_tpu_torch.core import output as tout
from ompi_tpu_torch.core import registry as treg
from ompi_tpu_torch.core import var as tvar

PKGS = {"ref": (jvar, jreg, jmca, jout, jinfo), "port": (tvar, treg, tmca, tout, tinfo)}


def each(fn):
    """``fn(var, reg)`` for both packages; the outcomes must be equal."""
    got = {k: fn(v[0], v[1]) for k, v in PKGS.items()}
    assert got["port"] == got["ref"], got
    return got["ref"]


def raised(fn):
    """The class name ``fn()`` raises (None when it returns)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        return type(e).__name__
    return None


# -- the restored entry points -------------------------------------------

EXT_MODULE = """
from {pkg}.core import registry


class Ext(registry.Component):
    FRAMEWORK = "extfw"
    NAME = "outoftree"
    PRIORITY = 42


registry.register_component(Ext)
"""


@pytest.mark.parametrize("entry", ["default_context", "init"])
def test_component_modules_env_is_loaded_by_both(tmp_path, monkeypatch, entry):
    """Each package imports the module the variable names (one per
    package, so neither sees the other's registration) and lists the
    component it registers."""
    monkeypatch.syspath_prepend(str(tmp_path))
    names = {}
    for pkg, (_var, reg, mca, _out, _info) in PKGS.items():
        names[reg] = f"ext_comp_{pkg}_{entry}"
        (tmp_path / f"{names[reg]}.py").write_text(EXT_MODULE.format(
            pkg={"ref": "ompi_tpu", "port": "ompi_tpu_torch"}[pkg]))
        monkeypatch.setattr(mca, "_default", None)  # restored after

    def listed(var, reg):
        monkeypatch.setenv("OMPI_TPU_COMPONENT_MODULES", f" :{names[reg]}: ")
        ctx = getattr({jreg: jmca, treg: tmca}[reg], entry)()
        return [(c.NAME, c.priority) for c in ctx.framework("extfw").selectable()]

    try:
        assert each(listed) == [("outoftree", 42)]
    finally:
        # drop the test's component, and only it: the builtin modules the
        # contexts imported for the first time registered theirs for good
        for reg, name in names.items():
            sys.modules.pop(name, None)
            reg.MCAContext._global_component_classes[:] = [
                c for c in reg.MCAContext._global_component_classes if c.FRAMEWORK != "extfw"]


def test_component_modules_env_names_a_missing_module(monkeypatch):
    monkeypatch.setenv("OMPI_TPU_COMPONENT_MODULES", "no_such_component_module_xyz")
    assert each(lambda var, reg: raised(reg.load_external_components)) == "ModuleNotFoundError"


@pytest.mark.parametrize("only_non_default", [True, False])
def test_build_env_matches_reference(tmp_path, only_non_default):
    conf = tmp_path / "mca-params.conf"
    conf.write_text("coll_x_segsize = 4096\n")

    def build(var, reg):
        s = var.VarStore(cmdline={"coll_x_algorithm": "ring", "btl": "tcp"},
                         env={"OMPI_MCA_coll_x_flag": "yes"}, param_files=[str(conf)])
        s.register("coll", "x", "algorithm", 0, type="int", enum={"auto": 0, "ring": 2})
        s.register("coll", "x", "flag", False)
        s.register("coll", "x", "segsize", 0)
        s.register("coll", "x", "verbose", 0)
        s.register("coll", "x", "ratio", 0.5)
        s.set("coll_x_ratio", 0.25)
        return s.build_env(only_non_default=only_non_default)

    env = each(build)
    assert env["OMPI_MCA_coll_x_algorithm"] == "2" and env["OMPI_MCA_btl"] == "tcp"
    assert env["OMPI_MCA_coll_x_flag"] == "1" and env["OMPI_MCA_coll_x_ratio"] == "0.25"
    assert ("OMPI_MCA_coll_x_verbose" in env) is not only_non_default


def test_set_verbosity_and_reset_gate_verbose(capsys):
    def emitted(var, reg):
        out = {jreg: jout, treg: tout}[reg]
        seen = []
        try:
            out.reset()
            out.set_verbosity("shmemtest", 0)
            out.verbose(1, "shmemtest", "hidden %d", 1)
            seen.append(capsys.readouterr().err)
            out.set_verbosity("shmemtest", 10)
            for level, msg in ((1, "selected"), (10, "per-call"), (11, "too deep")):
                out.verbose(level, "shmemtest", msg)
            seen.append(capsys.readouterr().err)
            out.reset()  # the pinned level goes: the (unset) var says 0
            out.verbose(1, "shmemtest", "after reset")
            seen.append(capsys.readouterr().err)
            out.show_help("topic", "key", "once")
            out.show_help("topic", "key", "once")
            out.reset()  # and the dedup memory with it
            out.show_help("topic", "key", "once")
            seen.append(capsys.readouterr().err.count("once"))
        finally:
            out.reset()
        return [s.replace("ompi_tpu_torch:", "ompi_tpu:") if isinstance(s, str) else s
                for s in seen]

    seen = each(emitted)
    assert seen[0] == "" and seen[2] == "" and seen[3] == 2
    assert seen[1] == "[ompi_tpu:shmemtest] selected\n[ompi_tpu:shmemtest] per-call\n"


def test_verbose_reads_the_mca_var(monkeypatch, capsys):
    def emitted(var, reg):
        mca, out = {jreg: (jmca, jout), treg: (tmca, tout)}[reg]
        ctx = reg.MCAContext(cmdline={}, env={}, param_files=[])
        monkeypatch.setattr(mca, "_default", ctx)
        out.register_verbose_var(ctx.store, "shmemtest")
        ctx.store.set("shmemtest_base_verbose", 5)
        try:
            out.reset()
            out.verbose(5, "shmemtest", "via-var")
            out.verbose(6, "shmemtest", "too deep")
            err = capsys.readouterr().err
            return err.count("via-var"), "too deep" in err
        finally:
            out.reset()

    assert each(emitted) == (1, False)


# -- tests/test_mca_var.py on both packages --------------------------------


def test_full_var_name():
    assert each(lambda var, reg: [var.full_var_name("coll", "xla", "priority"),
                                  var.full_var_name("coll", "", ""),
                                  var.full_var_name("", "", "verbose")]) == \
        ["coll_xla_priority", "coll", "verbose"]


def _resolved(v):
    return (v.value, v.source)


def test_default_resolution():
    def case(var, reg):
        s = var.VarStore(env={})
        v = s.register("coll", "xla", "priority", 90)
        return _resolved(v), s.get("coll_xla_priority")
    assert each(case) == ((90, "default"), 90)


def test_env_overrides_default():
    assert each(lambda var, reg: _resolved(var.VarStore(
        env={"OMPI_MCA_coll_xla_priority": "40"}).register("coll", "xla", "priority", 90))) \
        == (40, "env")


def test_cmdline_overrides_env():
    assert each(lambda var, reg: _resolved(var.VarStore(
        cmdline={"coll_xla_priority": "77"}, env={"OMPI_MCA_coll_xla_priority": "40"},
    ).register("coll", "xla", "priority", 90))) == (77, "cmdline")


def test_file_overrides_default_but_not_env(tmp_path):
    f = tmp_path / "mca-params.conf"
    f.write_text("# comment\ncoll_xla_priority = 11\n\nbadline\n")

    def case(var, reg):
        v = var.VarStore(env={}, param_files=[str(f)]).register("coll", "xla", "priority", 90)
        v2 = var.VarStore(env={"OMPI_MCA_coll_xla_priority": "40"},
                          param_files=[str(f)]).register("coll", "xla", "priority", 90)
        return _resolved(v), _resolved(v2)
    assert each(case) == ((11, "file"), (40, "env"))


def test_user_file_beats_system_file(tmp_path):
    user, system = tmp_path / "user.conf", tmp_path / "system.conf"
    user.write_text("k = user\n")
    system.write_text("k = system\nonly_sys = 5\n")

    def case(var, reg):
        s = var.VarStore(env={}, param_files=[str(user), str(system)])
        return s.register("", "", "k", "d").value, s.register("", "", "only_sys", 0).value
    assert each(case) == ("user", 5)


def test_type_conversion_bool_int_float():
    def case(var, reg):
        s = var.VarStore(env={"OMPI_MCA_a": "yes", "OMPI_MCA_b": "0",
                              "OMPI_MCA_c": "0x10", "OMPI_MCA_d": "2.5"})
        return [s.register("", "", "a", False).value, s.register("", "", "b", True).value,
                s.register("", "", "c", 0).value, s.register("", "", "d", 1.0).value]
    got = each(case)
    assert got == [True, False, 16, 2.5] and got[0] is True and got[1] is False


def test_bad_conversion_raises():
    assert each(lambda var, reg: raised(lambda: var.VarStore(
        env={"OMPI_MCA_x": "notanint"}).register("", "", "x", 3))) == "VarConversionError"


def test_enum_values():
    def case(var, reg):
        s = var.VarStore(env={"OMPI_MCA_coll_xla_allreduce_algorithm": "ring"})
        v = s.register("coll", "xla", "allreduce_algorithm", 0, type="int",
                       enum={"auto": 0, "ring": 4, "recursive_doubling": 3})
        return v.value, v.enum_name()
    assert each(case) == (4, "ring")


def test_alias_resolution():
    assert each(lambda var, reg: var.VarStore(
        env={"OMPI_MCA_coll_tuned_priority": "30"}).register(
        "coll", "xla", "priority", 90, aliases=["coll_tuned_priority"]).value) == 30


def test_set_cmdline_rebinds_existing():
    def case(var, reg):
        s = var.VarStore(env={})
        first = s.register("coll", "xla", "priority", 90).value
        s.set_cmdline({"coll_xla_priority": "5"})
        return first, s.get("coll_xla_priority")
    assert each(case) == (90, 5)


def test_lookup_unregistered():
    def case(var, reg):
        s = var.VarStore(cmdline={"coll": "xla,basic"}, env={})
        return s.lookup_unregistered("coll"), s.lookup_unregistered("pml")
    assert each(case) == ("xla,basic", None)


def test_build_env_round_trip():
    def case(var, reg):
        s = var.VarStore(cmdline={"coll_xla_priority": "12"}, env={})
        s.register("coll", "xla", "priority", 90)
        s.register("coll", "xla", "verbose", 0)  # default → omitted
        env = s.build_env()
        child = var.VarStore(env=env)
        return env, child.register("coll", "xla", "priority", 90).value
    assert each(case) == ({"OMPI_MCA_coll_xla_priority": "12"}, 12)


def test_ompi_tpu_env_prefix_also_accepted():
    assert each(lambda var, reg: var.VarStore(
        env={"OMPI_TPU_MCA_coll_xla_priority": "8"}).register(
        "coll", "xla", "priority", 90).value) == 8


def test_read_only_ignores_overrides():
    assert each(lambda var, reg: _resolved(var.VarStore(
        env={"OMPI_MCA_info_ver": "hacked"}).register(
        "", "", "info_ver", "1.0", read_only=True))) == ("1.0", "default")


def test_api_set_outranks_later_cmdline():
    def case(var, reg):
        s = var.VarStore(env={})
        s.register("coll", "xla", "priority", 90)
        s.set("coll_xla_priority", 99)
        s.set_cmdline({"coll_xla_priority": "5"})
        return s.get("coll_xla_priority")
    assert each(case) == 99


# -- tests/test_mca_registry.py on both packages ---------------------------


def make_comp(reg, name, prio, usable=True):
    class C(reg.Component):
        FRAMEWORK = "fake"
        NAME = name
        PRIORITY = prio

        def open(self, store):
            return usable

    C.__name__ = f"Comp_{name}"
    return C


def make_fw(reg, comps, cmdline=None, env=None):
    ctx = reg.MCAContext(cmdline=cmdline, env=env or {})
    fw = ctx.framework("fake")
    for name, prio, *usable in comps:
        fw.add_component_class(make_comp(reg, name, prio, *usable))
    return ctx, fw


def selected(comps, cmdline=None, env=None):
    return each(lambda var, reg: [c.NAME for c in make_fw(reg, comps, cmdline, env)[1]
                                  .selectable()])


def test_parse_selection():
    assert each(lambda var, reg: [reg.parse_selection(None), reg.parse_selection(""),
                                  reg.parse_selection("a,b"), reg.parse_selection("^a,b"),
                                  raised(lambda: reg.parse_selection("a,^b"))]) == \
        [(True, []), (True, []), (False, ["a", "b"]), (True, ["a", "b"]), "ComponentError"]


def test_priority_ordering():
    assert selected([("low", 10), ("high", 90), ("mid", 50)]) == ["high", "mid", "low"]
    assert each(lambda var, reg: make_fw(reg, [("low", 10), ("high", 90)])[1]
                .select_one().NAME) == "high"


def test_include_list():
    assert selected([("a", 10), ("b", 90)], cmdline={"fake": "a"}) == ["a"]


def test_exclude_list():
    assert selected([("a", 10), ("b", 90), ("c", 50)], cmdline={"fake": "^b"}) == ["c", "a"]


def test_selection_via_env():
    assert selected([("a", 10), ("b", 90)], env={"OMPI_MCA_fake": "^b"}) == ["a"]


def test_unknown_include_raises():
    assert each(lambda var, reg: raised(make_fw(reg, [("a", 10)], cmdline={
        "fake": "nosuch"})[1].open)) == "SelectionError"


def test_unusable_component_skipped():
    assert selected([("dead", 99, False), ("ok", 10)]) == ["ok"]


def test_requested_but_unusable_raises():
    assert each(lambda var, reg: raised(make_fw(reg, [("dead", 99, False), ("ok", 10)],
                                                cmdline={"fake": "dead"})[1].open)) \
        == "SelectionError"


def test_priority_var_overrides_class_priority():
    assert each(lambda var, reg: make_fw(reg, [("a", 10), ("b", 90)], cmdline={
        "fake_a_priority": "95"})[1].select_one().NAME) == "a"


def test_empty_framework_select_one_raises():
    assert each(lambda var, reg: raised(make_fw(reg, [])[1].select_one)) == "SelectionError"


def test_info_render_smoke():
    def case(var, reg):
        info = {jreg: jinfo, treg: tinfo}[reg]
        ctx, _ = make_fw(reg, [("a", 10)])
        text = info.render_info(ctx)
        parsable = info.render_info(ctx, parsable=True)
        return "fake" in text and "MCA variables" in text, \
            "mca:fake:a:version:1.0.0" in parsable.splitlines()
    assert each(case) == (True, True)

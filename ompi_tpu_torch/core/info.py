"""``python -m ompi_tpu_torch info`` — introspection dump (≈ ``ompi_info``).

Port of ``ompi_tpu/core/info.py``: every framework, its usable
components, and every MCA var with its value and source, as text or in
the ``--parsable`` form (``mca:<fw>:<comp>:version:<v>`` and
``mca:var:<name>:value:<v>:source:<s>`` lines).
"""

from __future__ import annotations

import io
import sys

from .registry import MCAContext


def render_info(ctx: MCAContext, parsable: bool = False, all_vars: bool = True) -> str:
    ctx.open_all()
    out = io.StringIO()
    if parsable:
        for name, fw in sorted(ctx.frameworks.items()):
            for comp in fw.selectable():
                v = ".".join(str(x) for x in comp.VERSION)
                print(f"mca:{name}:{comp.NAME}:version:{v}", file=out)
        if all_vars:
            for var in ctx.store.all_vars():
                print(f"mca:var:{var.full_name}:value:{var.value}:source:{var.source}",
                      file=out)
        return out.getvalue()

    import ompi_tpu_torch

    print("Package: ompi_tpu_torch (PyTorch/CUDA MPI framework)", file=out)
    print(f"Version: {ompi_tpu_torch.__version__}", file=out)
    print(file=out)
    print("Frameworks / components:", file=out)
    for name, fw in sorted(ctx.frameworks.items()):
        comps = fw.selectable()
        names = ", ".join(f"{c.NAME} (prio {c.priority})" for c in comps) or "(none usable)"
        print(f"  {name:<14} {names}", file=out)
        if fw.description:
            print(f"  {'':<14} {fw.description}", file=out)
    if all_vars:
        print(file=out)
        print("MCA variables (value [source]):", file=out)
        for var in ctx.store.all_vars():
            src = var.source if not var.source_detail else f"{var.source}:{var.source_detail}"
            enum_note = ""
            if var.enum is not None:
                ename = var.enum_name()
                opts = ",".join(var.enum)
                enum_note = f"  enum{{{opts}}}" + (f" = {ename}" if ename else "")
            print(f"  {var.full_name:<40} = {var.value!r} [{src}]{enum_note}", file=out)
            if var.help:
                print(f"  {'':<40}   {var.help}", file=out)
    return out.getvalue()


def main(argv: list[str] | None = None) -> int:
    import argparse

    from . import mca

    p = argparse.ArgumentParser(prog="ompi_tpu_torch info")
    p.add_argument("--parsable", action="store_true")
    p.add_argument("--no-vars", action="store_true", help="omit the MCA var dump")
    args = p.parse_args(argv)
    sys.stdout.write(render_info(mca.default_context(), args.parsable, not args.no_vars))
    return 0

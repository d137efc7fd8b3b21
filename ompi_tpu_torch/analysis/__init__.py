"""tpucheck on the port — the machine-checked contracts of ``ompi_tpu_torch``.

The port re-implements the reference's planes, and with them its
cross-cutting invariants:

* every blocking DCN wait converges on :class:`ompi_tpu_torch.core.var.
  Deadline` (no hard-coded timeouts, no unbounded spin loops);
* every ``--mca`` knob referenced anywhere (code, tests, docs) is
  centrally registered, and every central registration is alive;
* observability/robustness hooks are one-boolean off-path;
* transport escalation raises the typed ULFM errors, never a bare
  ``RuntimeError`` (and never hangs);
* the ``TdcnStats``/``NATIVE_COUNTERS`` schema stays append-only, and
  the ctypes surface of every ``extern "C"`` library the port loads
  (the engine's ``tdcn_*``, the CUDA kernels' ``ompi_ring_*``, the
  device windows' ``ompi_dw_*``, the convertor's ``tpuconv_*``) stays
  in sync with its C, C++ or CUDA definitions.

Four passes enforce them, the reference's passes over the port's own
files (:mod:`.repo` sets the scope):

==========  ===========================================================
pass        checks
==========  ===========================================================
invariants  AST linter over ``ompi_tpu_torch/``: Deadline discipline,
            MCA-var registration drift, hook gating, typed escalation
lockorder   static lock-acquisition graph across the threaded planes:
            cycles + lock-held-across-blocking-call sites; plus the
            opt-in runtime witness mode (:mod:`.lockdep`)
abidrift    C↔Python ABI: ``TDCN_STAT_NAMES`` vs ``NATIVE_COUNTERS``
            (names/order/append-only), every library's exports vs
            its ctypes declarations, the README port section's
            knob/counter/endpoint catalogs vs the registered sets
sanitize    native plane built under ASan/UBSan (TSan where the
            toolchain allows) and soaked via the Python-free
            ``csrc/dcn_sanity.cc`` harness, plus cppcheck when
            installed, plus the ring-hop kernels under
            ``compute-sanitizer`` memcheck on a card; skips log a
            reason, never silently pass
==========  ===========================================================

Driver: ``python -m ompi_tpu_torch check`` (:mod:`.check`; ``--selftest``
joins the tests).  Intentional
exceptions live in the reviewed waiver file ``waivers.toml`` next to
this package — every waiver carries a one-line justification, so the
repo-wide contract is "zero unexplained findings".
"""

from __future__ import annotations

from ompi_tpu_torch.analysis.findings import (  # noqa: F401
    Finding,
    Report,
    Waiver,
    apply_waivers,
    load_waivers,
)

#: the passes :func:`run_pass` knows; the pass modules are imported
#: lazily so ``import ompi_tpu_torch.analysis`` stays light
PASS_NAMES = ("invariants", "lockorder", "abidrift", "sanitize")


def run_pass(name: str, root, **kw):
    """Run one named pass against a repo root; returns list[Finding]."""
    if name == "invariants":
        from ompi_tpu_torch.analysis import invariants

        return invariants.run(root, **kw)
    if name == "lockorder":
        from ompi_tpu_torch.analysis import lockorder

        return lockorder.run(root, **kw)
    if name == "abidrift":
        from ompi_tpu_torch.analysis import abidrift

        return abidrift.run(root, **kw)
    if name == "sanitize":
        from ompi_tpu_torch.analysis import sanitize

        return sanitize.run(root, **kw)
    raise KeyError(f"unknown analysis pass {name!r}")

#!/usr/bin/env python
"""golden_capture — capture the reference library's golden fold vectors.

Usage::

    python -m ompi_tpu_torch golden-capture [--out PATH]
    python -m ompi_tpu_torch.tools.golden_capture [--out PATH]

Port of the reference's ``tools/golden_capture.py``: it loads Open MPI
4.1.4's ``libmpi.so.40.30.4`` through ctypes and records

* ``MPI_Reduce_local`` applied as a rank-sequential left fold
  acc = op(acc, rank_r), r = 1..n-1 — the op kernels every collective's
  reduction step calls, in the order of ``ordered_reduce_np`` and
  ``ordered_reduce_torch`` — for {SUM, MAX, MIN, PROD} × {float32,
  float64, int32} over 8 ranks × 257 elements;
* the np=1 ``MPI_Allreduce`` and ``MPI_Scan`` over the same 12 cases on
  ``MPI_COMM_WORLD`` of a singleton ``MPI_Init`` (no ``mpirun``: the
  isolated singleton skips the orted fork).

The JSON layout, the inputs (``make_inputs``, seed 1234) and the
provenance strings are the reference tool's, so both tools write the
same bytes.  The default ``--out`` is
``build/ompi_tpu_torch/golden/reduce_local.json``: the committed
``tests/golden/reduce_local.json`` belongs to the reference's tool and
is never written here.  The port's tests and ``chip_smoke.py`` hold
the port's collectives, on the CPU and on the card, to the committed
vectors.  Without the library the tool exits 1, naming the path, and
writes nothing.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np

from ompi_tpu_torch.tools import REPO

LIBMPI = "/usr/lib/x86_64-linux-gnu/libmpi.so.40.30.4"

#: predefined handle data symbols in libmpi (MPI_Op = &ompi_mpi_op_<x>,
#: MPI_Datatype = &ompi_mpi_<t>) — the standard Open MPI ABI layout
OPS = {
    "MPI_SUM": "ompi_mpi_op_sum",
    "MPI_MAX": "ompi_mpi_op_max",
    "MPI_MIN": "ompi_mpi_op_min",
    "MPI_PROD": "ompi_mpi_op_prod",
}
DTYPES = {
    "float32": ("ompi_mpi_float", np.float32),
    "float64": ("ompi_mpi_double", np.float64),
    "int32": ("ompi_mpi_int32_t", np.int32),
}

N_RANKS = 8
COUNT = 257  # odd length: exercises any vector-kernel tail path

#: where the port's capture goes unless ``--out`` says otherwise
DEFAULT_OUT = REPO / "build" / "ompi_tpu_torch" / "golden" / "reduce_local.json"


def _handle(lib: ctypes.CDLL, symbol: str) -> ctypes.c_void_p:
    """Address of a predefined-object data symbol = the MPI handle."""
    return ctypes.c_void_p(
        ctypes.addressof(ctypes.c_char.in_dll(lib, symbol))
    )


def make_inputs(dtype: type, seed: int = 1234) -> np.ndarray:
    """Deterministic (N_RANKS, COUNT) rank-major inputs; values chosen so
    fp folds are order-sensitive (mixed magnitudes) and int folds don't
    overflow."""
    rng = np.random.RandomState(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.randint(-1000, 1000, size=(N_RANKS, COUNT)).astype(dtype)
    mags = rng.choice([1e-4, 1.0, 1e4], size=(N_RANKS, COUNT))
    return (rng.randn(N_RANKS, COUNT) * mags).astype(dtype)


def capture() -> dict:
    """The golden file's content, from one singleton ``MPI_Init`` of the
    reference library in this process."""
    # no mpirun/orted: the isolated singleton skips the orted fork in
    # ess/singleton
    os.environ.setdefault("OMPI_MCA_ess_singleton_isolated", "1")
    mode = ctypes.RTLD_GLOBAL | ctypes.DEFAULT_MODE
    lib = ctypes.CDLL(LIBMPI, mode=mode)
    if lib.MPI_Init(None, None) != 0:
        raise RuntimeError("MPI_Init failed")
    try:
        reduce_local = lib.MPI_Reduce_local
        reduce_local.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        cases = {}
        for opname, opsym in OPS.items():
            op = _handle(lib, opsym)
            for dtname, (dtsym, dt) in DTYPES.items():
                mpidt = _handle(lib, dtsym)
                x = make_inputs(dt)
                acc = np.ascontiguousarray(x[0].copy())
                for r in range(1, N_RANKS):
                    # inoutbuf = inbuf op inoutbuf; all four ops are
                    # commutative (bitwise identical either way), so this
                    # is acc = op(acc, x[r]) in the library's kernel
                    inbuf = np.ascontiguousarray(x[r])
                    rc = reduce_local(
                        inbuf.ctypes.data_as(ctypes.c_void_p),
                        acc.ctypes.data_as(ctypes.c_void_p),
                        COUNT, mpidt, op,
                    )
                    if rc != 0:
                        raise RuntimeError(f"MPI_Reduce_local rc={rc}")
                cases[f"{opname}:{dtname}"] = {
                    "op": opname,
                    "dtype": dtname,
                    "n_ranks": N_RANKS,
                    "count": COUNT,
                    "input_hex": x.tobytes().hex(),
                    "result_hex": acc.tobytes().hex(),
                }
        # np=1 collectives: the library's whole comm construction, coll
        # selection and op dispatch, with bit-comparable (identity-fold)
        # outputs; the multi-rank order is the Reduce_local fold above
        comm_world = _handle(lib, "ompi_mpi_comm_world")
        allreduce = lib.MPI_Allreduce
        allreduce.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        scan = lib.MPI_Scan
        scan.argtypes = allreduce.argtypes
        singleton = {}
        for opname, opsym in OPS.items():
            op = _handle(lib, opsym)
            for dtname, (dtsym, dt) in DTYPES.items():
                mpidt = _handle(lib, dtsym)
                x = np.ascontiguousarray(make_inputs(dt)[0])
                for fname, fn in (("allreduce", allreduce), ("scan", scan)):
                    out = np.zeros_like(x)
                    rc = fn(x.ctypes.data_as(ctypes.c_void_p),
                            out.ctypes.data_as(ctypes.c_void_p),
                            COUNT, mpidt, op, comm_world)
                    if rc != 0:
                        raise RuntimeError(f"MPI_{fname} rc={rc}")
                    singleton[f"{fname}:{opname}:{dtname}"] = {
                        "coll": fname, "op": opname, "dtype": dtname,
                        "count": COUNT,
                        "input_hex": x.tobytes().hex(),
                        "result_hex": out.tobytes().hex(),
                    }
        # the reference tool's provenance, string for string: the file's
        # bytes are the same whichever tool wrote it
        return {
            "provenance": {
                "library": LIBMPI,
                "captured_with": "MPI_Reduce_local left fold acc=op(acc, r)"
                                 " + np=1 singleton collectives (no mpirun"
                                 " on this host; see BASELINE.md)",
                "seed": 1234,
            },
            "cases": cases,
            "singleton_colls": singleton,
        }
    finally:
        lib.MPI_Finalize()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ompi_tpu_torch golden-capture",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="where to write the JSON (default: %(default)s)")
    args = ap.parse_args(argv)
    if not os.path.exists(LIBMPI):
        print(f"golden-capture: the reference library {LIBMPI} is not installed "
              "(Open MPI 4.1.4's libmpi); nothing written", file=sys.stderr)
        return 1
    data = capture()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    print(f"wrote {len(data['cases'])} cases to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

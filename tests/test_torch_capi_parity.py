"""The port's C-ABI Python half (``ompi_tpu_torch.capi``) against the
reference's (``ompi_tpu.capi``), in process.

The same numpy buffers, by their ``.ctypes.data`` addresses — exactly
what the shim hands over — go through both packages' entry points:
predefined and derived type sizes, extents, true extents, leaf counts
and envelopes (contiguous, vector, hvector, indexed, hindexed, indexed
block, struct, subarray, darray, resized), ``MPI_Pack``/``MPI_Unpack``
and ``external32`` bytes, ``MPI_Reduce_local`` over every predefined op
and datatype (result bytes and error class), the groups and topologies
of a size-1 world (``MPI_COMM_SELF`` is the world of a standalone C
program), and ``MPI_Info``.  Every comparison is on bytes or exact
integers.  The port's ``mpi.h`` constants are held to both packages'
tables.

Both modules' communicator errhandlers are set to ``MPI_ERRORS_RETURN``
here, so an error class comes back instead of ending the process.
"""

import os
import re
from pathlib import Path

import numpy as np
import pytest

import ompi_tpu.api as rapi
import ompi_tpu.capi as rcapi
import ompi_tpu_torch.api as papi
import ompi_tpu_torch.capi as pcapi

REPO = Path(__file__).resolve().parent.parent
CAPI = {"ref": rcapi, "port": pcapi}
PORT_MPI_H = REPO / "ompi_tpu_torch" / "csrc" / "capi" / "include" / "mpi.h"
REF_MPI_H = REPO / "native" / "include" / "mpi.h"


@pytest.fixture(scope="module")
def capis():
    """Both capi modules with a size-1 world on the CPU (the standalone
    C program's world), errors returned."""
    old = os.environ.get("OMPI_TPU_DEVICE")
    os.environ["OMPI_TPU_DEVICE"] = "cpu"
    papi.finalize()
    rapi.init()
    try:
        for m in CAPI.values():
            assert m.init() == m.MPI_SUCCESS
            m._errhandlers[1] = m._errhandlers[2] = m.ERRH_RETURN
        yield CAPI
    finally:
        for m in CAPI.values():
            m._comms.clear()
            m._errhandlers.clear()
        papi.finalize()
        if old is None:
            os.environ.pop("OMPI_TPU_DEVICE", None)
        else:
            os.environ["OMPI_TPU_DEVICE"] = old


def _both(fn):
    """``fn(capi)`` under each package; the results must be equal."""
    got = {k: fn(m) for k, m in CAPI.items()}
    assert got["port"] == got["ref"], got
    return got["port"]


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


I32 = lambda *v: np.array(v, np.int32)  # noqa: E731
I64 = lambda *v: np.array(v, np.int64)  # noqa: E731

#: derived-type constructors: name → fn(capi) → (err, handle)
_DERIVED = {
    "contiguous": lambda m: m.type_contiguous(3, 14),
    "vector": lambda m: m.type_vector(4, 2, 5, 14),
    "hvector": lambda m: m.type_create_hvector(3, 2, 40, 14),
    "indexed": lambda m: m.type_indexed(3, _ptr(_BL), _ptr(_DI), 7),
    "hindexed": lambda m: m.type_create_hindexed(3, _ptr(_BL), _ptr(_DA), 13),
    "indexed_block": lambda m: m.type_create_indexed_block(3, 2, _ptr(_DI), 14),
    "hindexed_block": lambda m: m.type_create_hindexed_block(3, 2, _ptr(_DA), 7),
    "struct": lambda m: m.type_create_struct(3, _ptr(_SBL), _ptr(_SDA), _ptr(_STY)),
    "subarray": lambda m: m.type_create_subarray(2, _ptr(_SZ), _ptr(_SUB), _ptr(_ST), 56, 14),
    "subarray_f": lambda m: m.type_create_subarray(2, _ptr(_SZ), _ptr(_SUB), _ptr(_ST), 57, 7),
    "darray": lambda m: m.type_create_darray(4, 1, 2, _ptr(_GS), _ptr(_DIST), _ptr(_DARG),
                                             _ptr(_PS), 56, 14),
    "resized": lambda m: m.type_create_resized(14, 0, 24),
    "resized_lb": lambda m: m.type_create_resized(7, -4, 16),
}
_BL, _DI, _DA = I32(2, 1, 3), I32(0, 4, 9), I64(0, 32, 72)
_SBL, _SDA, _STY = I32(1, 2, 1), I64(0, 8, 24), I32(7, 14, 3)
_SZ, _SUB, _ST = I32(4, 6), I32(2, 3), I32(1, 2)
_GS, _DIST, _DARG, _PS = I32(8, 6), I32(121, 121), I32(-49767, -49767), I32(2, 2)


def _geometry(m, code):
    ints = np.zeros(64, np.int32)
    aints = np.zeros(64, np.int64)
    types = np.zeros(64, np.int32)
    env = m.type_get_envelope(code)
    rc = m.type_get_contents(code, 64, 64, 64, _ptr(ints), _ptr(aints), _ptr(types))
    return (m.type_size(code), m.type_get_extent(code), m.type_get_true_extent(code),
            m.type_leaf_count(code), m.pack_size(3, code), env, rc,
            ints[:env[1]].tolist() if env[0] == 0 else None,
            aints[:env[2]].tolist() if env[0] == 0 else None)


@pytest.mark.parametrize("code", list(range(1, 33)))
def test_predefined_type_geometry(capis, code):
    _both(lambda m: _geometry(m, code))


@pytest.mark.parametrize("name", list(_DERIVED))
def test_derived_type_geometry(capis, name):
    def run(m):
        err, code = _DERIVED[name](m)
        assert err == 0
        assert m.type_commit(code) == 0
        return _geometry(m, code)[:-2] + (m.type_get_envelope(code)[1:],)

    _both(run)


@pytest.mark.parametrize("name", list(_DERIVED))
def test_pack_unpack_bytes(capis, name):
    """MPI_Pack of three instances from the same bytes, the position it
    returns, and MPI_Unpack of the packed stream into a zeroed buffer."""
    rng = np.random.default_rng(list(_DERIVED).index(name))
    src = rng.integers(0, 256, 4096, dtype=np.uint8)

    def run(m):
        err, code = _DERIVED[name](m)
        m.type_commit(code)
        origin = 64  # room for a negative lb
        packed = np.zeros(4096, np.uint8)
        perr, pos = m.pack(_ptr(src) + origin, 3, code, _ptr(packed), packed.size, 5)
        out = np.zeros(4096, np.uint8)
        uerr, upos = m.unpack(_ptr(packed), packed.size, 5, _ptr(out) + origin, 3, code)
        return perr, pos, packed.tobytes(), uerr, upos, out.tobytes()

    _both(run)


@pytest.mark.parametrize("code", [5, 7, 9, 13, 14, 26])
def test_pack_external32_bytes(capis, code):
    src = np.random.default_rng(code).integers(0, 256, 256, dtype=np.uint8)

    def run(m):
        out = np.zeros(512, np.uint8)
        err, pos = m.pack_external(_ptr(src), 7, code, _ptr(out), out.size, 3)
        back = np.zeros(256, np.uint8)
        uerr, upos = m.unpack_external(_ptr(out), out.size, 3, _ptr(back), 7, code)
        return err, pos, out.tobytes(), uerr, upos, back.tobytes()

    _both(run)


def _operands(code: int, n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    raw = [rng.integers(0, 256, n * 16, dtype=np.uint8) for _ in range(2)]
    dt = rcapi.DTYPES.get(code)
    if dt is not None and dt.kind == "f":
        # finite values with ties and signed zeros, never NaN payloads
        vals = [np.round(rng.standard_normal(n) * 4).astype(dt) for _ in range(2)]
        vals[0][::5] = -0.0
        return tuple(v.view(np.uint8).copy() for v in vals)
    if dt is not None and dt.kind == "c":
        vals = [(rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(dt)
                for _ in range(2)]
        return tuple(v.view(np.uint8).copy() for v in vals)
    if dt is not None and dt.kind == "b":
        return tuple((r[:n] & 1).astype(np.uint8) for r in raw)
    return tuple(raw)


@pytest.mark.parametrize("opcode", list(range(1, 15)))
def test_reduce_local_table_bit_for_bit(capis, opcode):
    """MPI_Reduce_local for one op over every predefined datatype code:
    the error class and, where it succeeds, the inout bytes."""
    n = 11

    def run(m):
        rows = []
        for code in list(range(1, 15)) + list(range(16, 33)):
            a, b = _operands(code, n, 100 * opcode + code)
            b = b.copy()
            err = m.reduce_local(_ptr(a), _ptr(b), n, code, opcode)
            rows.append((code, err, b.tobytes() if err == 0 else None))
        return rows, m.op_commutative(opcode)

    _both(run)


def test_groups_of_the_size_one_world(capis):
    def run(m):
        out = []
        err, g = m.comm_group(1)
        out += [err, m.group_size(g), m.group_rank(g)]
        err, incl = m.group_incl(g, _ptr(I32(0)), 1)
        err2, excl = m.group_excl(g, _ptr(I32(0)), 1)
        out += [err, err2, m.group_size(incl), m.group_size(excl)]
        for op in (m.group_union, m.group_intersection, m.group_difference):
            e, h = op(g, excl)
            out += [e, m.group_size(h), m.group_compare(h, g)]
        tr = np.full(1, -7, np.int32)
        out += [m.group_translate_ranks(g, 1, _ptr(I32(0)), incl, _ptr(tr)), tr.tolist()]
        out += [m.group_compare(g, incl), m.group_compare(g, excl)]
        e, rg = m.group_range_incl(g, 1, _ptr(I32(0, 0, 1)))
        e2, rx = m.group_range_excl(g, 1, _ptr(I32(0, 0, 1)))
        out += [e, e2, m.group_size(rg), m.group_size(rx)]
        e, sub = m.comm_create(1, g)
        out += [e, m.comm_size(sub), m.comm_rank(sub), m.comm_compare(1, sub)]
        out += [m.group_incl(g, _ptr(I32(3)), 1)[0]]  # a rank outside the group
        return out

    _both(run)


@pytest.mark.parametrize("nnodes,ndims,dims", [
    (1, 2, (0, 0)), (12, 2, (0, 0)), (12, 3, (0, 2, 0)), (30, 3, (0, 0, 0)),
    (7, 2, (0, 0)), (16, 4, (2, 0, 0, 0)), (6, 2, (4, 0)),
])
def test_dims_create(capis, nnodes, ndims, dims):
    def run(m):
        d = np.array(dims, np.int32)
        return m.dims_create(nnodes, ndims, _ptr(d)), d.tolist()

    _both(run)


def test_cartesian_and_graph_topologies(capis):
    def run(m):
        out = []
        for dims, periods in (((1, 1), (1, 0)), ((1,), (0,)), ((1, 1, 1), (1, 1, 1))):
            d, p = np.array(dims, np.int32), np.array(periods, np.int32)
            err, cart = m.cart_create(1, len(dims), _ptr(d), _ptr(p), 0)
            out += [err, m.topo_test(cart), m.cartdim_get(cart)]
            coords = np.full(len(dims), -1, np.int32)
            out += [m.cart_coords(cart, 0, len(dims), _ptr(coords)), coords.tolist()]
            out += [m.cart_rank(cart, _ptr(np.zeros(len(dims), np.int32)))]
            for direction in range(len(dims)):
                out += [m.cart_shift(cart, direction, 1), m.cart_shift(cart, direction, -2)]
            gd, gp, gc = (np.zeros(len(dims), np.int32) for _ in range(3))
            out += [m.cart_get(cart, len(dims), _ptr(gd), _ptr(gp), _ptr(gc)),
                    gd.tolist(), gp.tolist(), gc.tolist()]
            out += [m.cart_map(1, len(dims), _ptr(d), _ptr(p))]
        index, edges = I32(1), I32(0)
        err, graph = m.graph_create(1, 1, _ptr(index), _ptr(edges), 0)
        nb = np.full(4, -1, np.int32)
        out += [err, m.topo_test(graph), m.graphdims_get(graph),
                m.graph_neighbors_count(graph, 0), m.graph_neighbors(graph, 0, 4, _ptr(nb)),
                nb.tolist(), m.graph_map(1, 1)]
        out += [m.cart_create(1, 2, _ptr(I32(2, 2)), _ptr(I32(0, 0)), 0)[0]]  # too many ranks
        return out

    _both(run)


def test_info(capis):
    def run(m):
        out = []
        err, ih = m.info_create()
        for k, v in (("cb_nodes", "4"), ("striping_unit", "1048576"), ("cb_nodes", "8")):
            out.append(m.info_set(ih, k, v))
        out += [m.info_get_nkeys(ih), m.info_get_value(ih, "cb_nodes"),
                m.info_get_value(ih, "missing"), m.info_get_valuelen(ih, "striping_unit"),
                m.info_get_nthkey_str(ih, 1), m.info_get_nthkey_str(ih, 5)]
        err, dup = m.info_dup(ih)
        out += [m.info_delete(ih, "cb_nodes"), m.info_get_nkeys(ih), m.info_get_nkeys(dup),
                m.info_free(dup), m.info_get_nkeys(dup)]
        return out

    _both(run)


def test_collectives_on_the_size_one_world_through_the_device_row(capis):
    """A size-1 world's collectives (allreduce, bcast, allgather, scan,
    reduce_scatter_block, alltoall) on the same C buffers: equal output
    bytes; the port's rows are tensors on the world's device."""
    x = np.random.default_rng(3).standard_normal(17)

    def run(m):
        outs = []
        for call in (lambda o: m.allreduce(_ptr(x), _ptr(o), 17, 14, 1, 1),
                     lambda o: m.allgather(_ptr(x), 17, 14, _ptr(o), 17, 14, 1),
                     lambda o: m.scan(_ptr(x), _ptr(o), 17, 14, 3, 1),
                     lambda o: m.reduce_scatter_block(_ptr(x), _ptr(o), 17, 14, 2, 1),
                     lambda o: m.alltoall(_ptr(x), 17, 14, _ptr(o), 17, 14, 1)):
            o = np.zeros(17)
            outs.append((call(o), o.tobytes()))
        b = x.copy()
        outs.append((m.bcast(_ptr(b), 17, 14, 0, 1), b.tobytes()))
        return outs

    got = _both(run)
    assert got[0][1] == x.tobytes()
    assert papi.comm_self().device.type == "cpu"


def _header_defines(path: Path) -> dict[str, int]:
    text = path.read_text()
    out = {}
    for name, val in re.findall(r"^#define\s+(MPI_\w+)\s+\(?\s*(-?\d+)\s*\)?\s*$", text, re.M):
        out[name] = int(val)
    for name, val in re.findall(r"^#define\s+(MPI_\w+)\s+\(\(MPI_\w+\)\s*(-?\d+)\)", text, re.M):
        out[name] = int(val)
    return out


def test_mpi_h_constants_equal_the_capi_tables():
    """The port's mpi.h: error classes, datatype codes, op codes and
    MPI_IN_PLACE equal its capi's tables and the reference's header and
    capi (the shim passes these integers straight through)."""
    port, ref = _header_defines(PORT_MPI_H), _header_defines(REF_MPI_H)
    assert port == ref
    for name in ("SUCCESS", "ERR_COUNT", "ERR_TYPE", "ERR_TAG", "ERR_COMM", "ERR_RANK",
                 "ERR_REQUEST", "ERR_ROOT", "ERR_OP", "ERR_ARG", "ERR_TRUNCATE",
                 "ERR_OTHER", "ERR_INTERN"):
        assert port[f"MPI_{name}"] == getattr(pcapi, f"MPI_{name}") == getattr(rcapi, f"MPI_{name}")
    dtypes = {"MPI_CHAR": 1, "MPI_SIGNED_CHAR": 2, "MPI_UNSIGNED_CHAR": 3, "MPI_BYTE": 4,
              "MPI_SHORT": 5, "MPI_UNSIGNED_SHORT": 6, "MPI_INT": 7, "MPI_UNSIGNED": 8,
              "MPI_LONG": 9, "MPI_UNSIGNED_LONG": 10, "MPI_LONG_LONG_INT": 11,
              "MPI_UNSIGNED_LONG_LONG": 12, "MPI_FLOAT": 13, "MPI_DOUBLE": 14,
              "MPI_C_BOOL": 16, "MPI_INT8_T": 17, "MPI_INT16_T": 18, "MPI_INT32_T": 19,
              "MPI_INT64_T": 20, "MPI_UINT8_T": 21, "MPI_UINT16_T": 22, "MPI_UINT32_T": 23,
              "MPI_UINT64_T": 24, "MPI_C_FLOAT_COMPLEX": 25, "MPI_C_DOUBLE_COMPLEX": 26,
              "MPI_WCHAR": 27, "MPI_FLOAT_INT": 28, "MPI_DOUBLE_INT": 29, "MPI_LONG_INT": 30,
              "MPI_2INT": 31, "MPI_SHORT_INT": 32}
    for name, code in dtypes.items():
        assert port[name] == code, name
    assert set(pcapi.DTYPES) == set(rcapi.DTYPES)
    assert {k: v.str for k, v in pcapi.DTYPES.items()} == {k: v.str for k, v in rcapi.DTYPES.items()}
    assert set(range(28, 33)) <= set(pcapi._dtypes)
    ops = ("SUM", "MAX", "MIN", "PROD", "LAND", "LOR", "LXOR", "BAND", "BOR", "BXOR",
           "MAXLOC", "MINLOC", "REPLACE", "NO_OP")
    for code, name in enumerate(ops, start=1):
        assert port[f"MPI_{name}"] == code
        assert pcapi.OPS[code].name == rcapi.OPS[code].name == f"MPI_{name}"
    in_place = re.search(r"#define\s+MPI_IN_PLACE\s+\(\(void\s*\*\)\s*(-?\d+)\)",
                         PORT_MPI_H.read_text())
    assert in_place and int(in_place.group(1)) == -1
    assert pcapi._IN_PLACE == rcapi._IN_PLACE == (1 << 64) - 1

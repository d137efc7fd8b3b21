"""Datatype layer: predefined and derived MPI datatypes, the pack/unpack
convertor, and the numpy ↔ torch crossing."""

from .convertor import Convertor, pack, packed_to_typed, typed_to_packed, unpack  # noqa: F401
from .datatype import (  # noqa: F401
    BFLOAT16,
    BYTE,
    CHAR,
    DOUBLE,
    DOUBLE_INT,
    FLOAT,
    FLOAT_INT,
    INT,
    INT32_T,
    INT64_T,
    LONG,
    LONG_INT,
    PREDEFINED,
    SHORT,
    SHORT_INT,
    TWO_INT,
    UNSIGNED,
    Datatype,
    create_struct,
    dtype_kind,
    from_numpy,
    from_numpy_dtype,
    from_torch_dtype,
    numpy_dtype,
    numpy_name,
    to_numpy,
    torch_dtype,
)

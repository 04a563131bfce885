"""MySQL-semantics data types, mapped TPU-first.

Equivalent role to the reference's `polardbx-optimizer/.../core/datatype` (MySQL type system:
Decimal, unsigned 64-bit, temporal types; SURVEY.md §2.5) — but re-designed for an accelerator:

- DECIMAL(p, s)  -> scaled int64 (value * 10^s).  The reference stores decimals as a flat
  struct-of-fixed-slots vector (`chunk/DecimalBlock.java:39-94`); a scaled integer lane is the
  TPU-native version of the same idea.
- DATE           -> int32 days since unix epoch.
- DATETIME/TIMESTAMP -> int64 microseconds since unix epoch.
- CHAR/VARCHAR   -> int32 dictionary codes; the dictionary (code -> str) lives host-side.
  Equality/group-by/join work on codes; ordering predicates use an order-preserving dictionary
  when the column is dictionary-sorted.
- TINY/SMALL/INT/BIGINT -> int8/int16/int32/int64 (unsigned carried as the same lanes with an
  `unsigned` flag; MySQL unsigned 64-bit compare/arith is handled in the expression engine).
- FLOAT/DOUBLE   -> float32 on device (TPU has no fast f64); the numpy reference evaluator
  uses float64 for golden comparisons.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import numpy as np


class TypeClass(enum.Enum):
    BOOL = "bool"
    INT = "int"
    UINT = "uint"
    DECIMAL = "decimal"
    FLOAT = "float"
    DATE = "date"
    DATETIME = "datetime"
    TIME = "time"
    STRING = "string"
    BINARY = "binary"
    NULL = "null"
    INTERVAL = "interval"


@dataclasses.dataclass(frozen=True)
class DataType:
    """A logical SQL type plus its physical device lane layout."""

    clazz: TypeClass
    # Physical numpy dtype of the device lane.
    lane: np.dtype
    # DECIMAL precision/scale (scale also used for temporal sub-units).
    precision: int = 0
    scale: int = 0
    nullable: bool = True
    # For STRING: whether dictionary codes are order-preserving (sorted dictionary).
    ordered_dict: bool = False

    # ---- constructors ----------------------------------------------------

    def with_nullable(self, nullable: bool) -> "DataType":
        return dataclasses.replace(self, nullable=nullable)

    # ---- predicates ------------------------------------------------------

    @property
    def is_numeric(self) -> bool:
        return self.clazz in (TypeClass.INT, TypeClass.UINT, TypeClass.DECIMAL,
                              TypeClass.FLOAT, TypeClass.BOOL)

    @property
    def is_integer(self) -> bool:
        return self.clazz in (TypeClass.INT, TypeClass.UINT, TypeClass.BOOL)

    @property
    def is_temporal(self) -> bool:
        return self.clazz in (TypeClass.DATE, TypeClass.DATETIME, TypeClass.TIME)

    @property
    def is_string(self) -> bool:
        return self.clazz in (TypeClass.STRING, TypeClass.BINARY)

    # ---- MySQL-ish rendering --------------------------------------------

    def sql_name(self) -> str:
        c = self.clazz
        if c == TypeClass.DECIMAL:
            return f"DECIMAL({self.precision},{self.scale})"
        if c == TypeClass.INT:
            return {1: "TINYINT", 2: "SMALLINT", 4: "INT", 8: "BIGINT"}[self.lane.itemsize]
        if c == TypeClass.UINT:
            return {1: "TINYINT UNSIGNED", 2: "SMALLINT UNSIGNED", 4: "INT UNSIGNED",
                    8: "BIGINT UNSIGNED"}[self.lane.itemsize]
        if c == TypeClass.FLOAT:
            return "FLOAT" if self.lane.itemsize == 4 else "DOUBLE"
        return c.name

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"DataType({self.sql_name()})"


# Canonical instances -----------------------------------------------------

BOOL = DataType(TypeClass.BOOL, np.dtype(np.bool_))
TINYINT = DataType(TypeClass.INT, np.dtype(np.int8))
SMALLINT = DataType(TypeClass.INT, np.dtype(np.int16))
INT = DataType(TypeClass.INT, np.dtype(np.int32))
BIGINT = DataType(TypeClass.INT, np.dtype(np.int64))
UBIGINT = DataType(TypeClass.UINT, np.dtype(np.uint64))
FLOAT = DataType(TypeClass.FLOAT, np.dtype(np.float32))
# DOUBLE maps to a float32 device lane (TPU-first); golden evaluation uses float64.
DOUBLE = DataType(TypeClass.FLOAT, np.dtype(np.float32), precision=8)
DATE = DataType(TypeClass.DATE, np.dtype(np.int32))
DATETIME = DataType(TypeClass.DATETIME, np.dtype(np.int64), scale=6)
TIME = DataType(TypeClass.TIME, np.dtype(np.int64), scale=6)
VARCHAR = DataType(TypeClass.STRING, np.dtype(np.int32))
CHAR = VARCHAR
BINARY = DataType(TypeClass.BINARY, np.dtype(np.int32))
NULLTYPE = DataType(TypeClass.NULL, np.dtype(np.int8))
INTERVAL = DataType(TypeClass.INTERVAL, np.dtype(np.int64))


def decimal(precision: int, scale: int) -> DataType:
    """DECIMAL(p, s) as a scaled int64 lane.

    p <= 18 fits int64 exactly (TPC-H uses DECIMAL(15,2)).  Larger precisions degrade to the
    same lane; overflow semantics beyond 18 digits are not bit-exact (documented limitation,
    mirrors the reference's "decimal64" fast path markers in `DecimalBlock.java`).
    """
    return DataType(TypeClass.DECIMAL, np.dtype(np.int64), precision=precision, scale=scale)


def varchar(ordered: bool = False) -> DataType:
    return DataType(TypeClass.STRING, np.dtype(np.int32), ordered_dict=ordered)


_INT_BY_SIZE = {1: TINYINT, 2: SMALLINT, 4: INT, 8: BIGINT}


def from_sql_name(name: str, precision: int = 0, scale: int = 0) -> DataType:
    n = name.upper()
    unsigned = "UNSIGNED" in n
    n = n.replace("UNSIGNED", "").strip()
    table = {
        "BOOL": BOOL, "BOOLEAN": BOOL,
        "TINYINT": TINYINT, "SMALLINT": SMALLINT, "MEDIUMINT": INT, "INT": INT,
        "INTEGER": INT, "BIGINT": BIGINT,
        "FLOAT": FLOAT, "DOUBLE": DOUBLE, "REAL": DOUBLE,
        "DATE": DATE, "DATETIME": DATETIME, "TIMESTAMP": DATETIME, "TIME": TIME,
        "CHAR": CHAR, "VARCHAR": VARCHAR, "TEXT": VARCHAR, "STRING": VARCHAR,
        "BINARY": BINARY, "VARBINARY": BINARY, "BLOB": BINARY,
    }
    if n in ("DECIMAL", "NUMERIC", "DEC"):
        return decimal(precision or 10, scale)
    dt = table.get(n)
    if dt is None:
        raise ValueError(f"unsupported type: {name}")
    if unsigned and dt.clazz == TypeClass.INT:
        if dt.lane.itemsize == 8:
            return UBIGINT
        # smaller unsigned ints widen into the next signed lane (lossless)
        return _INT_BY_SIZE[min(dt.lane.itemsize * 2, 8)]
    return dt


# ---- type inference / coercion ------------------------------------------


def common_type(a: DataType, b: DataType) -> DataType:
    """Result type of a binary arithmetic/comparison pair, MySQL-flavoured."""
    if a.clazz == TypeClass.NULL:
        return b
    if b.clazz == TypeClass.NULL:
        return a
    if a.clazz == TypeClass.FLOAT or b.clazz == TypeClass.FLOAT:
        return DOUBLE
    if a.clazz == TypeClass.DECIMAL or b.clazz == TypeClass.DECIMAL:
        s = max(a.scale if a.clazz == TypeClass.DECIMAL else 0,
                b.scale if b.clazz == TypeClass.DECIMAL else 0)
        p = max(a.precision or 18, b.precision or 18)
        return decimal(min(p, 18), s)
    if a.is_temporal or b.is_temporal:
        # temporal vs temporal comparison keeps the wider unit
        if a.is_temporal and b.is_temporal:
            return a if a.lane.itemsize >= b.lane.itemsize else b
        return a if a.is_temporal else b
    if a.is_string and b.is_string:
        return VARCHAR
    if a.is_string or b.is_string:
        # MySQL coerces string<->number comparisons to double
        return DOUBLE
    if a.clazz == TypeClass.UINT or b.clazz == TypeClass.UINT:
        return UBIGINT
    # both signed ints
    return _INT_BY_SIZE[max(a.lane.itemsize, b.lane.itemsize)]


def add_result_type(a: DataType, b: DataType) -> DataType:
    t = common_type(a, b)
    if t.clazz == TypeClass.INT:
        return BIGINT
    return t


def mul_result_type(a: DataType, b: DataType) -> DataType:
    if a.clazz == TypeClass.DECIMAL and b.clazz == TypeClass.DECIMAL:
        return decimal(18, min(a.scale + b.scale, 8))
    t = common_type(a, b)
    if t.clazz == TypeClass.INT:
        return BIGINT
    return t


def div_result_type(a: DataType, b: DataType) -> DataType:
    # MySQL: integer/integer -> decimal; we return DOUBLE for device simplicity unless
    # both are decimal, in which case keep a widened decimal scale.
    if a.clazz == TypeClass.DECIMAL or b.clazz == TypeClass.DECIMAL:
        s = min(max(a.scale, b.scale) + 4, 8)
        return decimal(18, s)
    return DOUBLE


def literal_type(value: Any) -> DataType:
    if value is None:
        return NULLTYPE
    if isinstance(value, bool):
        return BOOL
    if isinstance(value, int):
        return BIGINT if -(2**63) <= value < 2**63 else UBIGINT
    if isinstance(value, float):
        return DOUBLE
    if isinstance(value, str):
        return VARCHAR
    if isinstance(value, bytes):
        return BINARY
    raise ValueError(f"unsupported literal: {value!r}")

"""Spark logical types of the port's columns.

Counterpart of ``spark_rapids_jni_tpu/columnar/types.py``: the same
``Kind`` names and ``SparkType`` singletons, mapped onto torch dtypes.
STRING has no single dtype: a string column is a padded char matrix
(:class:`..column.StringColumn`).  DECIMAL carries Spark's (precision,
scale) and picks a storage width by precision as cudf does (32, 64 or
128 bits); every decimal column is stored as 128-bit limbs
(:class:`..column.Decimal128Column`).  LIST and STRUCT carry their
children's types; TIMESTAMP its time zone (``tz``, which ``repr`` leaves
out, as the reference's does).
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class Kind(enum.Enum):
    BOOLEAN = "boolean"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    STRING = "string"
    DECIMAL = "decimal"
    DATE = "date"            # int32 days since epoch (proleptic Gregorian)
    TIMESTAMP = "timestamp"  # int64 micros since epoch (UTC)
    LIST = "list"
    STRUCT = "struct"


_TORCH_DTYPES = {
    Kind.BOOLEAN: torch.bool,
    Kind.INT8: torch.int8,
    Kind.INT16: torch.int16,
    Kind.INT32: torch.int32,
    Kind.INT64: torch.int64,
    Kind.FLOAT32: torch.float32,
    Kind.FLOAT64: torch.float64,
    Kind.DATE: torch.int32,
    Kind.TIMESTAMP: torch.int64,
}

FLOAT_KINDS = (Kind.FLOAT32, Kind.FLOAT64)
INT_KINDS = (Kind.INT8, Kind.INT16, Kind.INT32, Kind.INT64)


@dataclasses.dataclass(frozen=True)
class SparkType:
    """A Spark SQL data type.

    ``precision`` / ``scale`` mean something for DECIMAL only;
    ``children`` for LIST (the element type) and STRUCT (the field
    types, named by ``field_names``); ``tz`` for TIMESTAMP only ("" is
    naive, else an IANA or offset zone name, as the reference's).
    """

    kind: Kind
    precision: int = 0
    scale: int = 0
    children: tuple = ()
    field_names: tuple = ()
    tz: str = ""

    @staticmethod
    def decimal(precision: int, scale: int) -> "SparkType":
        if not 1 <= precision <= 38:
            raise ValueError(f"decimal precision out of range: {precision}")
        return SparkType(Kind.DECIMAL, precision=precision, scale=scale)

    @staticmethod
    def list_of(elem: "SparkType") -> "SparkType":
        return SparkType(Kind.LIST, children=(elem,))

    @staticmethod
    def struct_of(fields: dict) -> "SparkType":
        return SparkType(Kind.STRUCT, children=tuple(fields.values()),
                         field_names=tuple(fields.keys()))

    @property
    def is_nested(self) -> bool:
        return self.kind in (Kind.LIST, Kind.STRUCT)

    @property
    def decimal_storage_bits(self) -> int:
        """cudf's storage width by precision: 32, 64 or 128 bits."""
        if self.kind is not Kind.DECIMAL:
            raise TypeError("not a decimal type")
        if self.precision <= 9:
            return 32
        return 64 if self.precision <= 18 else 128

    @property
    def torch_dtype(self) -> torch.dtype:
        if self.kind not in _TORCH_DTYPES:
            raise TypeError(f"{self.kind} has no single torch dtype")
        return _TORCH_DTYPES[self.kind]

    def __repr__(self) -> str:
        if self.kind is Kind.DECIMAL:
            return f"decimal({self.precision},{self.scale})"
        if self.kind is Kind.LIST:
            return f"list<{self.children[0]!r}>"
        if self.kind is Kind.STRUCT:
            inner = ",".join(f"{n}:{t!r}" for n, t in
                             zip(self.field_names, self.children))
            return f"struct<{inner}>"
        return self.kind.value


BOOLEAN = SparkType(Kind.BOOLEAN)
INT8 = SparkType(Kind.INT8)
INT16 = SparkType(Kind.INT16)
INT32 = SparkType(Kind.INT32)
INT64 = SparkType(Kind.INT64)
FLOAT32 = SparkType(Kind.FLOAT32)
FLOAT64 = SparkType(Kind.FLOAT64)
STRING = SparkType(Kind.STRING)
DATE = SparkType(Kind.DATE)
TIMESTAMP = SparkType(Kind.TIMESTAMP)

_BY_NAME = {t.kind.value: t for t in (BOOLEAN, INT8, INT16, INT32, INT64,
                                      FLOAT32, FLOAT64, STRING, DATE,
                                      TIMESTAMP)}


def _split_top(s: str) -> list:
    """Split ``s`` at commas outside ``<...>`` and ``(...)``."""
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(s):
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(s[start:i])
            start = i + 1
    parts.append(s[start:])
    return parts


def from_name(name: str) -> SparkType:
    """A type from its ``repr``: ``'int32'``, ``'decimal(38,2)'``,
    ``'list<int64>'``, ``'struct<a:int32,b:string>'``."""
    name = name.strip()
    if name in _BY_NAME:
        return _BY_NAME[name]
    if name.startswith("decimal(") and name.endswith(")"):
        p, s = _split_top(name[len("decimal("):-1])
        return SparkType.decimal(int(p), int(s))
    if name.startswith("list<") and name.endswith(">"):
        return SparkType.list_of(from_name(name[len("list<"):-1]))
    if name.startswith("struct<") and name.endswith(">"):
        fields = {}
        for part in _split_top(name[len("struct<"):-1]):
            fname, ftype = part.split(":", 1)
            fields[fname] = from_name(ftype)
        return SparkType.struct_of(fields)
    raise ValueError(f"unknown column type {name!r}")

"""Spark logical types of the port's columns.

Counterpart of ``spark_rapids_jni_tpu/columnar/types.py``: the same
``Kind`` names and ``SparkType`` singletons, mapped onto torch dtypes.
STRING has no single dtype: a string column is a padded char matrix
(:class:`..column.StringColumn`).  Decimal, list and struct types come
with ROADMAP.md queue 1, item 10b.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from .._roadmap import not_ported


class Kind(enum.Enum):
    BOOLEAN = "boolean"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    STRING = "string"
    DATE = "date"            # int32 days since epoch (proleptic Gregorian)
    TIMESTAMP = "timestamp"  # int64 micros since epoch (UTC)


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
    """A Spark SQL data type."""

    kind: Kind

    @property
    def torch_dtype(self) -> torch.dtype:
        if self.kind not in _TORCH_DTYPES:
            raise TypeError(f"{self.kind} has no single torch dtype")
        return _TORCH_DTYPES[self.kind]

    def __repr__(self) -> str:
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


def from_name(name: str) -> SparkType:
    """``'int32'`` -> ``INT32``; names the reference knows but the port
    does not carry yet (decimals, lists, structs) raise
    ``NotImplementedError``."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise not_ported(f"column type {name!r}", 10) from None

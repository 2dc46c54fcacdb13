"""Spark logical types of the port's columns (the subset the ported path uses).

Counterpart of ``spark_rapids_jni_tpu/columnar/types.py``: the same
``Kind`` names and ``SparkType`` singletons, mapped onto torch dtypes.
Decimal, string and nested types come with ROADMAP.md queue 1, item 10.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from .._roadmap import not_ported


class Kind(enum.Enum):
    BOOLEAN = "boolean"
    INT32 = "int32"
    INT64 = "int64"
    FLOAT64 = "float64"
    DATE = "date"            # int32 days since epoch (proleptic Gregorian)


_TORCH_DTYPES = {
    Kind.BOOLEAN: torch.bool,
    Kind.INT32: torch.int32,
    Kind.INT64: torch.int64,
    Kind.FLOAT64: torch.float64,
    Kind.DATE: torch.int32,
}

FLOAT_KINDS = (Kind.FLOAT64,)


@dataclasses.dataclass(frozen=True)
class SparkType:
    """A Spark SQL data type."""

    kind: Kind

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.kind]

    def __repr__(self) -> str:
        return self.kind.value


BOOLEAN = SparkType(Kind.BOOLEAN)
INT32 = SparkType(Kind.INT32)
INT64 = SparkType(Kind.INT64)
FLOAT64 = SparkType(Kind.FLOAT64)
DATE = SparkType(Kind.DATE)

_BY_NAME = {t.kind.value: t for t in (BOOLEAN, INT32, INT64, FLOAT64, DATE)}


def from_name(name: str) -> SparkType:
    """``'int32'`` -> ``INT32``; names the reference knows but the port
    does not carry yet raise ``NotImplementedError``."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise not_ported(f"column type {name!r}", 10) from None

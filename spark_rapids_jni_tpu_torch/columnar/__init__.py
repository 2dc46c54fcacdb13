"""Columns and column batches as torch tensors."""

from . import types
from .column import (Column, ColumnBatch, Decimal128Column, ListColumn,
                     StringColumn, StructColumn, batch_from_numpy,
                     batch_to_numpy, string_arrays)

__all__ = ["types", "Column", "ColumnBatch", "Decimal128Column",
           "ListColumn", "StringColumn", "StructColumn", "batch_from_numpy",
           "batch_to_numpy", "string_arrays"]

"""Columns and column batches as torch tensors."""

from . import types
from .column import Column, ColumnBatch, batch_from_numpy, batch_to_numpy

__all__ = ["types", "Column", "ColumnBatch", "batch_from_numpy",
           "batch_to_numpy"]

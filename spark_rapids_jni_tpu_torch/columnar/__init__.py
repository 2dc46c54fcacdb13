"""Columns and column batches as torch tensors, and their encodings.

``from_arrow``, ``to_arrow`` and ``array_to_column`` (:mod:`.arrow`)
import pyarrow, so they load on first use: nothing else here needs it.
"""

from . import types
from .bucketed import BucketedStringColumn, plan_widths
from .column import (Column, ColumnBatch, Decimal128Column, ListColumn,
                     StringColumn, StructColumn, batch_from_numpy,
                     batch_to_numpy, string_arrays)
from .encoded import (BitPackedColumn, DictionaryColumn,
                      FrameOfReferenceColumn, RunLengthColumn, ZoneMap,
                      decode_batch, encode_batch, encode_bitpacked,
                      encode_column, encode_for, encode_rle, is_encoded,
                      materialize_batch, materialize_column)

_ARROW = ("from_arrow", "to_arrow", "array_to_column")


def __getattr__(name):
    if name in _ARROW:
        from . import arrow

        return getattr(arrow, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["types", "BitPackedColumn", "BucketedStringColumn", "Column",
           "ColumnBatch", "Decimal128Column", "DictionaryColumn",
           "FrameOfReferenceColumn", "ListColumn", "RunLengthColumn",
           "StringColumn", "StructColumn", "ZoneMap", "batch_from_numpy",
           "batch_to_numpy", "decode_batch", "encode_batch",
           "encode_bitpacked", "encode_column", "encode_for", "encode_rle",
           "is_encoded", "materialize_batch", "materialize_column",
           "plan_widths", "string_arrays"]

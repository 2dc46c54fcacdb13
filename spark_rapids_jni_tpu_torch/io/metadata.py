"""The footer as the reference's scan reads it from pyarrow.

The reference's ``io/parquet.py`` reads ``pq.ParquetFile(path).metadata``:
``num_row_groups``, ``row_group(i).num_rows`` / ``.num_columns`` /
``.column(ci)`` with ``path_in_schema``, ``data_page_offset``,
``dictionary_page_offset``, ``total_compressed_size``, ``codec`` and
``statistics`` (``has_min_max``, ``null_count``, ``min``, ``max``), and
``schema_arrow.names``.  :class:`FileMetaData` gives the same view over
:mod:`.thrift`, with no pyarrow:

* ``dictionary_page_offset`` is None where the chunk sets none, as
  pyarrow gives it;
* statistics decode by physical and logical type as pyarrow decodes them
  (ints and unsigned ints as ``int``, floats as ``float``, decimals as
  ``Decimal``, dates as ``date``, timestamps as ``datetime``, times as
  ``time``, strings as ``str``, other binaries as ``bytes``), so the scan's
  ``_stats_may_match`` compares exactly the values the reference compares
  and meets ``TypeError`` exactly where it does;
* ``min_value``/``max_value`` are read where the footer declares the
  type-defined column order (every writer since parquet-format 2.4);
  otherwise the legacy ``min``/``max`` are trusted only where parquet-cpp
  trusts them: a signed sort order, or min equal to max;
* a column whose sort order is unknown (INT96, INTERVAL) has no
  statistics, as in pyarrow.

Each top-level column is a tree of leaf, struct and list nodes
(:class:`Node`) with their definition and repetition levels, and each
type is the one the reference's ``from_arrow`` gives the Arrow type pyarrow
reads for it (:meth:`FileMetaData.column_type`), with the footer's
``ARROW:schema`` laid over the Parquet types as parquet-cpp lays it
(:mod:`.arrow_schema`): original time zones, and durations, fixed-size
lists and views raising as the reference raises on them.
"""

from __future__ import annotations

import datetime as _dt
import decimal as _decimal
import os
import struct as _struct
from typing import List, Optional

from ..columnar import types as T
from . import arrow_schema, thrift

# parquet.thrift enums
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FLBA = range(8)
PHYSICAL_NAMES = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE",
                  "BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY")
REQUIRED, OPTIONAL, REPEATED = 0, 1, 2
CODEC_NAMES = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO",
               4: "BROTLI", 5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
ENCODING_NAMES = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE",
                  4: "BIT_PACKED", 5: "DELTA_BINARY_PACKED",
                  6: "DELTA_LENGTH_BYTE_ARRAY", 7: "DELTA_BYTE_ARRAY",
                  8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
# ConvertedType
(CT_UTF8, CT_MAP, CT_MAP_KEY_VALUE, CT_LIST, CT_ENUM, CT_DECIMAL, CT_DATE,
 CT_TIME_MILLIS, CT_TIME_MICROS, CT_TIMESTAMP_MILLIS, CT_TIMESTAMP_MICROS,
 CT_UINT_8, CT_UINT_16, CT_UINT_32, CT_UINT_64, CT_INT_8, CT_INT_16,
 CT_INT_32, CT_INT_64, CT_JSON, CT_BSON, CT_INTERVAL) = range(22)

SIGNED, UNSIGNED, UNKNOWN = "signed", "unsigned", "unknown"
_EPOCH_DATE = _dt.date(1970, 1, 1)
_EPOCH = _dt.datetime(1970, 1, 1)
_EPOCH_UTC = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
_WIDE = _decimal.Context(prec=100)


class Leaf:
    """One leaf column of the schema, in file (depth-first) order."""

    def __init__(self, element, path, max_def: int, max_rep: int):
        if element.type not in range(len(PHYSICAL_NAMES)):
            raise ValueError(f"corrupt Parquet schema: leaf {path!r} has "
                             f"physical type {element.type}")
        self.element = element
        self.path = tuple(path)
        self.physical = element.type
        self.type_length = element.type_length
        self.max_def = max_def
        self.max_rep = max_rep
        # the Arrow field of ARROW:schema laid over this leaf, if any
        self.arrow: Optional[arrow_schema.ArrowField] = None

    @property
    def dotted(self) -> str:
        return ".".join(self.path)

    # ---- logical type -------------------------------------------------
    def logical(self):
        """``(kind, info)``: the logical type the annotations name, from
        ``logicalType`` first and the legacy ``converted_type`` second;
        kind is None for a bare physical type."""
        e = self.element
        lt = e.logicalType
        if lt is not None:
            for kind in ("STRING", "ENUM", "JSON", "BSON", "UUID",
                         "FLOAT16", "DATE", "UNKNOWN", "MAP", "LIST"):
                if getattr(lt, kind) is not None:
                    return kind, None
            if lt.DECIMAL is not None:
                return "DECIMAL", (_required(lt.DECIMAL.precision,
                                             "decimal precision"),
                                   lt.DECIMAL.scale or 0)
            if lt.INTEGER is not None:
                return "INTEGER", (lt.INTEGER.bitWidth,
                                   bool(lt.INTEGER.isSigned))
            for kind in ("TIMESTAMP", "TIME"):
                t = getattr(lt, kind)
                if t is not None:
                    unit = t.unit
                    u = ("MILLIS" if unit is None or unit.MILLIS is not None
                         else "MICROS" if unit.MICROS is not None
                         else "NANOS")
                    return kind, (u, bool(t.isAdjustedToUTC))
        ct = e.converted_type
        if ct is None:
            return None, None
        if ct in (CT_UTF8,):
            return "STRING", None
        if ct == CT_JSON:
            return "JSON", None
        if ct in (CT_ENUM, CT_BSON, CT_INTERVAL):
            return {CT_ENUM: "ENUM", CT_BSON: "BSON",
                    CT_INTERVAL: "INTERVAL"}[ct], None
        if ct == CT_DECIMAL:
            return "DECIMAL", (_required(e.precision, "decimal precision"),
                               e.scale or 0)
        if ct == CT_DATE:
            return "DATE", None
        if ct in (CT_TIME_MILLIS, CT_TIME_MICROS):
            return "TIME", ("MILLIS" if ct == CT_TIME_MILLIS else "MICROS",
                            True)
        if ct in (CT_TIMESTAMP_MILLIS, CT_TIMESTAMP_MICROS):
            return "TIMESTAMP", ("MILLIS" if ct == CT_TIMESTAMP_MILLIS
                                 else "MICROS", True)
        if CT_UINT_8 <= ct <= CT_INT_64:
            width = (8, 16, 32, 64)[(ct - CT_UINT_8) % 4]
            return "INTEGER", (width, ct >= CT_INT_8)
        return None, None

    def sort_order(self) -> str:
        """parquet-cpp's sort order of this leaf's statistics."""
        kind, info = self.logical()
        if kind in ("STRING", "ENUM", "JSON", "BSON", "UUID"):
            return UNSIGNED
        if kind in ("DECIMAL", "DATE", "TIME", "TIMESTAMP", "FLOAT16"):
            return SIGNED
        if kind == "INTEGER":
            return SIGNED if info[1] else UNSIGNED
        if kind in ("INTERVAL", "UNKNOWN"):
            return UNKNOWN
        if self.physical in (BOOLEAN, INT32, INT64, FLOAT, DOUBLE):
            return SIGNED
        if self.physical in (BYTE_ARRAY, FLBA):
            return UNSIGNED
        return UNKNOWN

    def port_type(self) -> T.SparkType:
        """The port type of this leaf: the reference's ``from_arrow`` type
        of the Arrow type pyarrow reads, ``ARROW:schema`` applied (a
        UTC-adjusted timestamp takes its original zone).  Raises where
        the reference's ``array_to_column`` raises (unsigned ints, times,
        binaries, durations, ...)."""
        kind, info = self.logical()
        phys = self.physical
        arrow = self.arrow.type if self.arrow is not None else None
        if kind == "DECIMAL":
            precision, scale = info
            if not 1 <= precision <= 38:
                raise NotImplementedError(
                    f"arrow type decimal256({precision}, {scale}) of "
                    f"column {self.dotted!r} not supported yet")
            if phys in (INT32, INT64, FLBA, BYTE_ARRAY):
                return T.SparkType.decimal(precision, scale)
        if kind == "STRING" and phys == BYTE_ARRAY and arrow != "Utf8View":
            return T.STRING
        if kind == "DATE" and phys == INT32:
            return T.DATE
        if kind == "TIMESTAMP" and phys == INT64:
            tz = ""
            if info[1]:  # UTC-adjusted: pyarrow's "UTC", or the origin's
                tz = (self.arrow.tz if arrow == "Timestamp" and self.arrow.tz
                      else "UTC")
            return T.SparkType(T.Kind.TIMESTAMP, tz=tz)
        ints = {8: T.INT8, 16: T.INT16, 32: T.INT32, 64: T.INT64}
        if (kind == "INTEGER" and info[1] and phys in (INT32, INT64)
                and info[0] in ints and not (phys == INT64
                                             and arrow == "Duration")):
            return ints[info[0]]
        if kind is None and not (phys == INT64 and arrow == "Duration"):
            plain = {BOOLEAN: T.BOOLEAN, INT32: T.INT32, INT64: T.INT64,
                     INT96: T.TIMESTAMP, FLOAT: T.FLOAT32,
                     DOUBLE: T.FLOAT64}.get(phys)
            if plain is not None:
                return plain
        what = kind if kind is not None else PHYSICAL_NAMES[phys]
        if kind == "INTEGER":
            what = f"{'' if info[1] else 'u'}int{info[0]}"
        if arrow in ("Duration", "Utf8View"):
            what = f"arrow {arrow}"
        raise NotImplementedError(
            f"Parquet type {what} over {PHYSICAL_NAMES[phys]} of column "
            f"{self.dotted!r} not supported yet (the reference's "
            "array_to_column rejects its Arrow type)")

    # ---- statistics values ---------------------------------------------
    def stat_value(self, raw: bytes):
        """One encoded min/max as pyarrow's ``Statistics.min`` gives it."""
        kind, info = self.logical()
        phys = self.physical
        if phys == BOOLEAN:
            return bool(raw[0] & 1) if raw else False
        if phys in (INT32, INT64):
            width = 4 if phys == INT32 else 8
            signed = not (kind == "INTEGER" and not info[1])
            v = int.from_bytes(raw[:width], "little", signed=signed)
            if kind == "DECIMAL":
                return _decimal.Decimal(v).scaleb(-info[1], _WIDE)
            if kind == "DATE":
                return _EPOCH_DATE + _dt.timedelta(days=v)
            if kind == "TIMESTAMP":
                us = _to_micros(v, info[0])
                base = _EPOCH_UTC if info[1] else _EPOCH
                return base + _dt.timedelta(microseconds=us)
            if kind == "TIME":
                us = _to_micros(v, info[0])
                return (_dt.datetime.min + _dt.timedelta(
                    microseconds=us)).time()
            return v
        if phys == FLOAT:
            return _struct.unpack("<f", raw[:4])[0]
        if phys == DOUBLE:
            return _struct.unpack("<d", raw[:8])[0]
        if kind == "DECIMAL":
            v = int.from_bytes(raw, "big", signed=True)
            return _decimal.Decimal(v).scaleb(-info[1], _WIDE)
        if kind in ("STRING", "JSON"):
            return raw.decode("utf-8", "replace")
        return bytes(raw)


def _required(v, what: str):
    if v is None:
        raise ValueError(f"corrupt Parquet footer: no {what}")
    return v


def _to_micros(v: int, unit: str) -> int:
    if unit == "MILLIS":
        return v * 1000
    if unit == "NANOS":
        return v // 1000
    return v


class Statistics:
    """A column chunk's statistics in pyarrow's form."""

    def __init__(self, stats, leaf: Leaf, typed_order: bool):
        if typed_order:
            lo, hi = stats.min_value, stats.max_value
        else:
            lo, hi = stats.min, stats.max
        self.has_min_max = lo is not None and hi is not None
        self.null_count = stats.null_count
        self.min_raw, self.max_raw = lo, hi
        self._leaf = leaf

    @property
    def min(self):
        return (self._leaf.stat_value(self.min_raw) if self.has_min_max
                else None)

    @property
    def max(self):
        return (self._leaf.stat_value(self.max_raw) if self.has_min_max
                else None)

    def __repr__(self):
        return (f"Statistics(has_min_max={self.has_min_max}, "
                f"min={self.min!r}, max={self.max!r}, "
                f"null_count={self.null_count})")


def _statistics(meta, leaf: Leaf, typed_order: bool):
    if meta.statistics is None or leaf.sort_order() == UNKNOWN:
        return None
    st = Statistics(meta.statistics, leaf, typed_order)
    if (not typed_order and st.has_min_max and leaf.sort_order() != SIGNED
            and st.min_raw != st.max_raw):
        # legacy min/max of an unsigned sort order: parquet-cpp does not
        # trust them (PARQUET-251 / PARQUET-686)
        return None
    return st


class ColumnChunkMetaData:
    """``RowGroupMetaData.column(ci)``."""

    def __init__(self, chunk, leaf: Leaf, typed_order: bool):
        m = chunk.meta_data
        if m is None:
            raise ValueError(f"column chunk of {leaf.dotted!r} has no "
                             "metadata (an external file_path chunk)")
        for what in ("type", "codec", "num_values", "data_page_offset",
                     "total_compressed_size"):
            _required(getattr(m, what), f"{what} for {leaf.dotted!r}")
        self.leaf = leaf
        self.path_in_schema = leaf.dotted
        self.num_values = m.num_values
        self.data_page_offset = m.data_page_offset
        self.dictionary_page_offset = m.dictionary_page_offset
        self.total_compressed_size = m.total_compressed_size
        self.compression = m.codec
        self.codec = CODEC_NAMES.get(m.codec, f"codec {m.codec}")
        self.statistics = _statistics(m, leaf, typed_order)

    @property
    def chunk_start(self) -> int:
        off = self.data_page_offset
        if self.dictionary_page_offset is not None:
            off = min(off, self.dictionary_page_offset)
        return off


class RowGroupMetaData:
    """``FileMetaData.row_group(i)``."""

    def __init__(self, rg, leaves: List[Leaf], typed_order: bool):
        cols = rg.columns or []
        if len(cols) != len(leaves):
            raise ValueError(f"row group holds {len(cols)} column chunks "
                             f"for {len(leaves)} leaf columns")
        self.num_rows = rg.num_rows or 0
        self._cols = [ColumnChunkMetaData(c, lf, typed_order)
                      for c, lf in zip(cols, leaves)]

    @property
    def num_columns(self) -> int:
        return len(self._cols)

    def column(self, i: int) -> ColumnChunkMetaData:
        return self._cols[i]


LEAF, STRUCT, LIST = "leaf", "struct", "list"
# Arrow list types the reference's array_to_column rejects: pyarrow
# restores them from ARROW:schema over a Parquet list
_ARROW_LISTS = ("List", "LargeList", "FixedSizeList", "ListView",
                "LargeListView")
_ARROW_REJECTED_LISTS = ("FixedSizeList", "ListView", "LargeListView")


class Node:
    """One node of a top-level column's tree: a ``leaf`` (``leaf`` its
    index in :attr:`FileMetaData.leaves`), a ``struct`` (``children`` its
    fields) or a ``list`` (``children`` its one element).

    ``def_level`` is the definition level at which the node's value is
    present (non-null); ``nullable`` says whether it can be null at all
    (a REQUIRED node under a null struct is still valid, as pyarrow reads
    it).  A list's elements exist from definition level ``elem_def`` on;
    each list adds one repetition level below its parent's."""

    def __init__(self, kind: str, name: str, nullable: bool, def_level: int,
                 children=(), leaf: Optional[int] = None, elem_def: int = 0):
        self.kind, self.name, self.nullable = kind, name, nullable
        self.def_level, self.elem_def = def_level, elem_def
        self.children = list(children)
        self.leaf = leaf
        self.arrow: Optional[arrow_schema.ArrowField] = None
        # what a group the port does not read is (a MAP, an empty group)
        self.opaque: Optional[str] = None

    def leaf_indices(self) -> List[int]:
        if self.kind == LEAF:
            return [self.leaf]
        return [i for c in self.children for i in c.leaf_indices()]

    def port_type(self, leaves: List[Leaf]) -> T.SparkType:
        """The reference's type of this node; raises where it does."""
        if self.opaque is not None:
            raise NotImplementedError(
                f"{self.opaque} (column {self.name!r}) is not supported "
                "yet (the reference's array_to_column rejects arrow type "
                "map)")
        if self.kind == LEAF:
            return leaves[self.leaf].port_type()
        if self.kind == STRUCT:
            return T.SparkType.struct_of({c.name: c.port_type(leaves)
                                          for c in self.children})
        arrow = self.arrow.type if self.arrow is not None else None
        if arrow in _ARROW_REJECTED_LISTS:
            raise NotImplementedError(
                f"arrow type {arrow} of column {self.name!r} not supported "
                "yet (the reference's array_to_column rejects it)")
        return T.SparkType.list_of(self.children[0].port_type(leaves))


def _group_kind(e) -> Optional[str]:
    """``LIST``, ``MAP`` or None: a group's annotation, from
    ``logicalType`` first and ``converted_type`` second."""
    lt = e.logicalType
    if lt is not None:
        if lt.LIST is not None:
            return "LIST"
        if lt.MAP is not None:
            return "MAP"
    if e.converted_type == CT_LIST:
        return "LIST"
    if e.converted_type in (CT_MAP, CT_MAP_KEY_VALUE):
        return "MAP"
    return None


def _is_group(e) -> bool:
    return e.type is None or bool(e.num_children)


class FileMetaData:
    """pyarrow's ``ParquetFile(path).metadata`` for the scan's purposes,
    plus the schema's leaves (``leaves``), the top-level names
    (``names``, pyarrow's ``schema_arrow.names``) and each top-level
    column's node tree (``columns``).

    The tree follows parquet-cpp's reading of the schema: a group
    annotated LIST holds one repeated child; a repeated primitive there,
    or a repeated group with several fields or named ``array`` or
    ``*_tuple``, is the element itself (the legacy 2-level forms), and
    any other repeated group wraps the element (the 3-level form).  A
    repeated field without the annotation is a list of non-null
    elements.  A MAP or MAP_KEY_VALUE group raises the reference's
    ``NotImplementedError`` when its column is typed."""

    def __init__(self, footer: bytes, file_size: Optional[int] = None):
        self.footer = footer
        self.file_size = file_size
        md = thrift.file_metadata(footer)
        schema = md.schema or []
        if not schema:
            raise ValueError("parquet footer has no schema")
        self.leaves: List[Leaf] = []
        self.names: List[str] = []
        self.columns = {}
        self._schema = schema
        pos = 1
        for _ in range(schema[0].num_children or 0):
            node, pos = self._node(pos, [], 0, 0)
            self.names.append(node.name)
            self.columns[node.name] = node
        kv = {m.key: m.value for m in md.key_value_metadata or []}
        self.arrow_fields = None
        if arrow_schema.KEY in kv:
            self.arrow_fields = arrow_schema.decode(kv[arrow_schema.KEY])
            # parquet-cpp lays the origin schema over the top-level
            # fields by position
            if len(self.arrow_fields) == len(self.names):
                for name, f in zip(self.names, self.arrow_fields):
                    self._apply_arrow(self.columns[name], f)
        self.num_rows = md.num_rows or 0
        self.typed_order = bool(md.column_orders)
        self._groups = md.row_groups or []
        self._bound = {}

    def _element(self, pos):
        if pos >= len(self._schema):
            raise ValueError("parquet schema ends inside a group")
        return self._schema[pos]

    def _node(self, pos, path, def_, rep, repeated_ok=True):
        """The node at schema position ``pos`` under ``path`` (its
        parent's definition and repetition levels ``def_``, ``rep``) and
        the position after it."""
        e = self._element(pos)
        name = _required(e.name, "schema element name")
        if e.repetition_type == REPEATED and repeated_ok:
            # a bare repeated field: a list of non-null elements
            elem, pos = self._node(pos, path, def_ + 1, rep + 1,
                                   repeated_ok=False)
            elem.nullable = False
            return Node(LIST, name, False, def_, [elem],
                        elem_def=def_ + 1), pos
        path = path + [name]
        nullable = e.repetition_type == OPTIONAL
        if e.repetition_type != REPEATED:
            def_ += nullable
        if not _is_group(e):
            leaf = Leaf(e, path, def_, rep)
            self.leaves.append(leaf)
            return Node(LEAF, name, nullable, def_,
                        leaf=len(self.leaves) - 1), pos + 1
        kids = e.num_children or 0
        kind = _group_kind(e)
        if kind == "MAP":
            return self._opaque(pos, name, nullable, def_, "a Parquet MAP")
        if kind == "LIST" and e.repetition_type != REPEATED:
            return self._list(pos, path, name, nullable, def_, rep)
        if not kids:
            return self._opaque(pos, name, nullable, def_,
                                "an empty Parquet group")
        pos += 1
        children = []
        for _ in range(kids):
            child, pos = self._node(pos, path, def_, rep)
            children.append(child)
        return Node(STRUCT, name, nullable, def_, children), pos

    def _list(self, pos, path, name, nullable, def_, rep):
        e = self._element(pos)
        if (e.num_children or 0) != 1:
            raise ValueError(f"corrupt Parquet schema: LIST group {name!r} "
                             f"has {e.num_children} children, not one")
        r = self._element(pos + 1)
        if r.repetition_type != REPEATED:
            raise ValueError(f"corrupt Parquet schema: the child of LIST "
                             f"group {name!r} is not repeated")
        r_name = _required(r.name, "schema element name")
        if (_is_group(r) and (r.num_children or 0) == 1
                and r_name != "array" and not r_name.endswith("_tuple")):
            # 3-level: the repeated group wraps the element
            elem, end = self._node(pos + 2, path + [r_name], def_ + 1,
                                   rep + 1)
        else:
            # legacy 2-level: the repeated field is the element
            elem, end = self._node(pos + 1, path, def_ + 1, rep + 1,
                                   repeated_ok=False)
            elem.nullable = False
        return Node(LIST, name, nullable, def_, [elem],
                    elem_def=def_ + 1), end

    def _opaque(self, pos, name, nullable, def_, what):
        """A group the port does not read (a MAP, an empty group): its
        leaves are walked so the chunks line up, and typing it raises."""
        end = pos + 1
        for _ in range(self._element(pos).num_children or 0):
            _, end = self._node(end, [name], def_, 0)
        node = Node(STRUCT, name, nullable, def_)
        node.opaque = what
        return node, end

    def _apply_arrow(self, node: Node, field) -> None:
        node.arrow = field
        if node.kind == LEAF:
            self.leaves[node.leaf].arrow = field
        elif (node.kind == STRUCT and field.type == "Struct"
              and len(field.children) == len(node.children)):
            for c, f in zip(node.children, field.children):
                self._apply_arrow(c, f)
        elif (node.kind == LIST and field.type in _ARROW_LISTS
              and len(field.children) == 1):
            self._apply_arrow(node.children[0], field.children[0])

    def column_type(self, name: str) -> T.SparkType:
        """Top-level column ``name``'s port type; raises where the
        reference's ``array_to_column`` raises."""
        return self.columns[name].port_type(self.leaves)

    @property
    def num_row_groups(self) -> int:
        return len(self._groups)

    def row_group(self, i: int) -> RowGroupMetaData:
        if i not in self._bound:
            self._bound[i] = RowGroupMetaData(self._groups[i], self.leaves,
                                              self.typed_order)
        return self._bound[i]


def read_metadata(path: str) -> FileMetaData:
    """The footer of the Parquet file at ``path``."""
    from .parquet_footer import read_footer_bytes

    return FileMetaData(read_footer_bytes(path), os.path.getsize(path))

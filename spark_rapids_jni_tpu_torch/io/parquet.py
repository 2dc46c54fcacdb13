"""Parquet scan: split-pruned read into a ColumnBatch.

Counterpart of ``spark_rapids_jni_tpu/io/parquet.py``.  SURVEY.md §7
Phase 1's "Parquet host decode -> ColumnBatch upload": the reference
decodes with pyarrow on the host; the port decodes with its own page
decoder (:mod:`.pages`, over the footer view of :mod:`.metadata`), also on
the host, then uploads each column once (``batch_from_numpy``).  The same
file gives the same batch.  The pruning rules are the reference's:

* a row group survives a split when its **midpoint** falls inside
  ``[part_offset, part_offset + part_length)`` — the same rule as
  ``NativeParquetJni.cpp:556-637`` (every row group belongs to exactly
  one split, splits need no coordination);
* column pruning by (case-(in)sensitively matched) top-level names;
* with a ``predicate``, row groups whose footer statistics prove every
  row fails it are dropped (the ``scan_pruning`` knob).

Tests cross-check the selection against the native footer engine
(``parquet_footer.ParquetFooter.read_and_filter``) so the Python rule and
the C++ rule cannot drift apart.  Every entry point takes ``device=None``,
the GPU; pass ``device='cpu'`` to build the batch on the CPU.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from ..columnar import types as T
from ..columnar.column import ColumnBatch, batch_from_numpy
from . import metadata as M
from . import pages as PG
from .metadata import FileMetaData, read_metadata


def _row_group_span(rg) -> tuple:
    """(start, end) byte range of a row group's column chunk data."""
    start = None
    end = 0
    for ci in range(rg.num_columns):
        col = rg.column(ci)
        off = col.data_page_offset
        if col.dictionary_page_offset is not None:
            off = min(off, col.dictionary_page_offset)
        start = off if start is None else min(start, off)
        end = max(end, off + col.total_compressed_size)
    return (start or 0, end)


def select_row_groups(meta, part_offset: int, part_length: int) -> list:
    """Indices of row groups whose midpoint is inside the split."""
    lo, hi = part_offset, part_offset + part_length
    keep = []
    for i in range(meta.num_row_groups):
        start, end = _row_group_span(meta.row_group(i))
        mid = start + (end - start) // 2
        if lo <= mid < hi:
            keep.append(i)
    return keep


_PRUNE_OPS = ("<", "<=", "==", "!=", ">=", ">")


def _stats_may_match(stats, op: str, value) -> bool:
    """Conservative row-group stats check: False only when the chunk's
    min/max PROVE every row fails ``row <op> value``.  Missing stats,
    unset min/max, nulls, or cross-type comparisons all keep the group
    — pruning never guesses."""
    if stats is None or not stats.has_min_max:
        return True
    if stats.null_count is None or stats.null_count > 0:
        # a null row's decoded fill value is not described by min/max;
        # only all-valid chunks are provably cold
        return True
    lo, hi = stats.min, stats.max
    try:
        if op == "<":
            return bool(lo < value)
        if op == "<=":
            return bool(lo <= value)
        if op == ">":
            return bool(hi > value)
        if op == ">=":
            return bool(hi >= value)
        if op == "==":
            return bool(lo <= value) and bool(hi >= value)
        if op == "!=":
            return not (bool(lo == value) and bool(hi == value))
    except TypeError:
        return True
    return True


def _find_chunk(rg, column: str, ignore_case: bool):
    """Physical chunk index of top-level ``column`` in a row group."""
    want = column.lower() if ignore_case else column
    for ci in range(rg.num_columns):
        name = rg.column(ci).path_in_schema
        if (name.lower() if ignore_case else name) == want:
            return ci
    return None


def prune_row_groups(meta, keep, predicate,
                     ignore_case: bool = False) -> tuple:
    """Drop row groups whose column stats cannot satisfy ``predicate``
    (``(column, op, value)``), gated by the ``scan_pruning`` knob.

    Returns ``(kept_indices, pruned_count)``.  When every group is
    provably cold one schema-bearing group survives anyway (the morsel
    stream needs a first morsel; an empty filtered result still needs
    its schema) — its rows fail the predicate downstream.
    """
    from .. import config

    keep = list(keep)
    if predicate is None or not bool(config.get("scan_pruning")):
        return keep, 0
    column, op, value = predicate
    if (op not in _PRUNE_OPS or isinstance(value, bool)
            or not isinstance(value, (int, float, np.integer,
                                      np.floating))):
        return keep, 0
    kept = []
    for i in keep:
        rg = meta.row_group(i)
        ci = _find_chunk(rg, column, ignore_case)
        if ci is None or _stats_may_match(rg.column(ci).statistics,
                                          op, value):
            kept.append(i)
    if not kept and keep:
        kept = keep[:1]
    return kept, len(keep) - len(kept)


def _match_columns(schema_names, columns, ignore_case: bool) -> list:
    if columns is None:
        return list(schema_names)
    if not ignore_case:
        wanted = set(columns)
        return [n for n in schema_names if n in wanted]
    wanted_l = {c.lower() for c in columns}
    return [n for n in schema_names if n.lower() in wanted_l]


def _footer(path: str) -> FileMetaData:
    t0 = time.perf_counter()
    meta = read_metadata(path)
    PG.STATS["footer_s"] += time.perf_counter() - t0
    return meta


def _node_paths(node, space=0, above=()):
    """``{leaf index: path}`` under ``node``: each path the nodes from the
    top down to the leaf, as :func:`pages.assemble_levels` takes them,
    and the nodes themselves."""
    kind = {M.LEAF: 0, M.STRUCT: 1, M.LIST: 2}[node.kind]
    here = above + ((node, (kind, space, node.def_level, node.elem_def)),)
    if node.kind == M.LEAF:
        return {node.leaf: here}
    out = {}
    for c in node.children:
        out.update(_node_paths(c, space + (node.kind == M.LIST), here))
    return out


class _LeafValues:
    """One leaf's values over the row groups read: a flat leaf's fixed
    values per chunk, a nested leaf's pages (their levels assemble at
    the end), and a string leaf's strings, as a dictionary or not."""

    def __init__(self, leaf, st: T.SparkType, as_dictionary: bool):
        self.leaf, self.type = leaf, st
        self.strings = None
        if st.kind is T.Kind.STRING:
            self.strings = (PG.StringDictionary() if as_dictionary
                            else PG.StringChunks())
        self.parts = []

    def add(self, pages, valid=None) -> None:
        """One chunk's pages; ``valid`` is a flat leaf's validity."""
        if self.strings is not None:
            self.strings.add(pages)
        if valid is None:
            self.parts.extend(pages)
        elif self.strings is None:
            self.parts.append(PG.fixed_values(self.leaf, self.type, pages,
                                              valid))

    def data(self, valid: np.ndarray, nested: bool):
        """The leaf's host data for its (present) rows ``valid``."""
        if isinstance(self.strings, PG.StringDictionary):
            data = self.strings.host_form(valid)
            # an empty dictionary (no valid row): the reference decodes,
            # to an all-null char matrix
            return data if data is not None else \
                PG.StringChunks().matrix(valid)
        if self.strings is not None:
            return self.strings.matrix(valid)
        if nested:
            return PG.fixed_values(self.leaf, self.type, self.parts, valid)
        return self.parts[0] if len(self.parts) == 1 else \
            np.concatenate(self.parts)


class _Column:
    """One selected top-level column while its row groups decode.

    ``dictionaries`` says which string leaves read as dictionary columns:
    ``"all"`` (``read_parquet`` under ``read_dictionary``: a top-level
    string, and a nested one written from an Arrow dictionary, which
    pyarrow restores), ``"arrow"`` (only those written from an Arrow
    dictionary: the per-row-group readers) or None."""

    def __init__(self, meta: FileMetaData, name: str,
                 dictionaries: Optional[str]):
        self.name = name
        self.node = meta.columns[name]
        self.type = meta.column_type(name)
        self.flat = self.node.kind == M.LEAF
        self.paths = _node_paths(self.node)
        self.valids = []
        self.leaves = {}
        for li in self.paths:
            leaf = meta.leaves[li]
            from_dict = leaf.arrow is not None and leaf.arrow.dictionary
            as_dict = (dictionaries == "all" and (self.flat or from_dict)
                       or dictionaries == "arrow" and from_dict)
            self.leaves[li] = _LeafValues(leaf, self._leaf_type(li), as_dict)

    def _leaf_type(self, li: int) -> T.SparkType:
        st = self.type
        for node, _ in self.paths[li][1:]:
            if st.kind is T.Kind.LIST:
                st = st.children[0]
            else:
                st = st.children[st.field_names.index(node.name)]
        return st

    def add_chunk(self, li: int, pages, rows: int, g: int) -> None:
        if not self.flat:
            self.leaves[li].add(pages)
            return
        valid = PG._validity(pages, rows)
        if valid.shape[0] != rows:
            raise ValueError(f"corrupt Parquet chunk {self.name!r}: "
                             f"{valid.shape[0]} values for {rows} rows in "
                             f"row group {g}")
        self.valids.append(valid)
        self.leaves[li].add(pages, valid)

    def host_form(self, rows: int):
        """``batch_from_numpy``'s ``(data, validity, type)`` of the
        column: each leaf's levels assembled into every node above it."""
        if self.flat:
            (values,) = self.leaves.values()
            valid = np.concatenate(self.valids)
            return values.data(valid, False), valid, self.type
        built = {}
        for li, path in self.paths.items():
            values = self.leaves[li]
            reps, defs, n = PG.levels_of(values.parts)
            got = PG.assemble_levels(reps, defs, n, [p for _, p in path])
            for (node, _), (present, offsets) in zip(path, got):
                # a node that cannot be null is valid wherever it has a
                # slot, even under a null struct (pyarrow gives it no
                # validity bitmap)
                valid = (present if node.nullable
                         else np.ones(present.shape[0], np.bool_))
                built.setdefault(id(node), (valid, offsets))
            built[id(path[-1][0])] += (values.data(got[-1][0], True),)
        top = built[id(self.node)][0].shape[0]
        if top != rows:
            raise ValueError(f"corrupt Parquet chunk {self.name!r}: its "
                             f"levels hold {top} rows, the row groups "
                             f"{rows}")

        def form(node, st):
            valid, offsets, *leaf_data = built[id(node)]
            if node.kind == M.LEAF:
                return leaf_data[0], valid, st
            if node.kind == M.STRUCT:
                return ({c.name: form(c, t) for c, t in
                         zip(node.children, st.children)}, valid, st)
            return (offsets, form(node.children[0], st.children[0])), \
                valid, st

        return form(self.node, self.type)


def decode_row_groups(path: str, meta: FileMetaData, groups, names,
                      dictionaries: Optional[str] = None) -> dict:
    """Row groups ``groups`` of columns ``names``, decoded on the host:
    ``{name: (data, validity, type)}``, ``batch_from_numpy``'s form (a
    list's data ``(offsets, child)``, a struct's ``{field: child}``);
    ``dictionaries`` as :class:`_Column` takes it."""
    cols = [_Column(meta, name, dictionaries) for name in names]
    if not groups:
        return {c.name: PG.empty_host_column(c.type) for c in cols}
    t0 = time.perf_counter()
    size = meta.file_size
    rows = 0
    with open(path, "rb") as f:
        for g in groups:
            PG.STATS["row_group_decodes"] += 1
            rg = meta.row_group(g)
            rows += rg.num_rows
            for c in cols:
                for li in c.paths:
                    col = rg.column(li)
                    start = col.chunk_start
                    length = col.total_compressed_size
                    if (start is None or length is None or start < 0
                            or length < 0
                            or (size is not None and start + length > size)):
                        raise ValueError(f"corrupt Parquet footer: chunk of "
                                         f"{col.path_in_schema!r} in row "
                                         f"group {g} lies outside the file")
                    f.seek(start)
                    raw = f.read(length)
                    PG.STATS["file_bytes"] += len(raw)
                    pages = PG.read_chunk_pages(raw, col, meta.leaves[li],
                                                levels=not c.flat)
                    c.add_chunk(li, pages, rg.num_rows, g)
    out = {c.name: c.host_form(rows) for c in cols}
    PG.STATS["decode_s"] += time.perf_counter() - t0
    return out


def _upload(host: dict, device) -> ColumnBatch:
    t0 = time.perf_counter()
    batch = batch_from_numpy(host, device)
    PG.STATS["upload_s"] += time.perf_counter() - t0
    return batch


def read_parquet(
    path: str,
    columns: Optional[Sequence[str]] = None,
    part_offset: int = 0,
    part_length: int = 1 << 62,
    ignore_case: bool = False,
    predicate=None,
    device=None,
) -> ColumnBatch:
    """Read (a split of) a parquet file into a ColumnBatch on ``device``
    (the GPU by default).

    With the ``encoded_execution`` knob resolved on for ``device``, string
    columns come back as
    :class:`~spark_rapids_jni_tpu_torch.columnar.encoded.DictionaryColumn`
    (codes + values) built from the dictionary pages without decoding a
    row, so the char-matrix padding cost is paid once per distinct value
    instead of once per row.

    ``predicate`` (``(column, op, value)``) additionally drops row
    groups whose footer stats cannot satisfy it (``scan_pruning``
    knob): the split keeps only rows the filter may keep, so the caller
    must apply the same filter downstream regardless.
    """
    from ..columnar.encoded import resolve_encoded_execution

    meta = _footer(path)
    keep = select_row_groups(meta, part_offset, part_length)
    keep, _ = prune_row_groups(meta, keep, predicate, ignore_case)
    names = _match_columns(meta.names, columns, ignore_case)
    host = decode_row_groups(path, meta, keep, names,
                             "all" if resolve_encoded_execution(device)
                             else None)
    return _upload(host, device)


def row_group_readers(
    path: str,
    columns: Optional[Sequence[str]] = None,
    part_offset: int = 0,
    part_length: int = 1 << 62,
    ignore_case: bool = False,
    predicate=None,
    counters: Optional[dict] = None,
    device=None,
) -> list:
    """Replayable per-row-group readers for the streaming scan.

    Returns ``[(read, rows), ...]`` — one entry per split-surviving row
    group, in file order.  ``read()`` decodes JUST that row group into a
    ColumnBatch on ``device`` and may be called again at any time with a
    bit-identical result: it is the streaming pipeline's lineage hook (a
    lost or corrupt morsel-derived buffer re-decodes from source instead
    of keeping a second copy resident).  Each call opens the file afresh
    (the parsed footer is shared: it is immutable).  ``rows`` comes from
    the footer, so the morsel schedule is planned without touching any
    data pages.  String columns decode to the char matrix, as the
    reference's readers (no ``read_dictionary``) give them, except those
    written from an Arrow dictionary, which pyarrow restores as one.

    ``predicate`` prunes stats-cold row groups before any reader is
    built (see :func:`prune_row_groups`); when ``counters`` is a dict it
    receives the ``{"pruned", "scanned"}`` group counts.
    """
    meta = _footer(path)
    keep = select_row_groups(meta, part_offset, part_length)
    keep, pruned = prune_row_groups(meta, keep, predicate, ignore_case)
    if counters is not None:
        counters["pruned"] = pruned
        counters["scanned"] = len(keep)
    names = _match_columns(meta.names, columns, ignore_case)
    for name in names:
        meta.column_type(name)  # an unreadable column raises here

    def make(i):
        def read() -> ColumnBatch:
            from ..columnar.encoded import resolve_encoded_execution

            # strings written from an Arrow dictionary come back as
            # dictionaries, as pyarrow restores them for the reference
            arrow = "arrow" if resolve_encoded_execution(device) else None
            return _upload(decode_row_groups(path, meta, [i], names, arrow),
                           device)
        return read

    return [(make(i), meta.row_group(i).num_rows) for i in keep]

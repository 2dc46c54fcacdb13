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

from .._roadmap import not_ported
from ..columnar import types as T
from ..columnar.column import ColumnBatch, batch_from_numpy
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


def _leaf(meta: FileMetaData, name: str):
    """The one flat leaf of top-level column ``name`` and its port type
    (which raises for a type the reference rejects)."""
    leaves = meta.leaves_of[name]
    if len(leaves) != 1 or leaves[0] is None:
        raise not_ported(f"nested Parquet column {name!r}", "14b")
    leaf = meta.leaves[leaves[0]]
    return leaves[0], leaf, leaf.port_type()


def decode_row_groups(path: str, meta: FileMetaData, groups, names,
                      strings_as_dictionary: bool = False) -> dict:
    """Row groups ``groups`` of columns ``names``, decoded on the host:
    ``{name: (data, validity, type)}``, ``batch_from_numpy``'s form."""
    cols = [(name, *_leaf(meta, name)) for name in names]
    if not groups:
        return {name: PG.empty_host_column(st) for name, _, _, st in cols}
    t0 = time.perf_counter()
    acc = {}
    for name, _, _, st in cols:
        if st.kind is T.Kind.STRING:
            vals = (PG.StringDictionary() if strings_as_dictionary
                    else PG.StringChunks())
        else:
            vals = []
        acc[name] = ([], vals)
    size = meta.file_size
    with open(path, "rb") as f:
        for g in groups:
            PG.STATS["row_group_decodes"] += 1
            rg = meta.row_group(g)
            for name, ci, leaf, st in cols:
                col = rg.column(ci)
                start, length = col.chunk_start, col.total_compressed_size
                if (start is None or length is None or start < 0
                        or length < 0
                        or (size is not None and start + length > size)):
                    raise ValueError(f"corrupt Parquet footer: chunk of "
                                     f"{name!r} in row group {g} lies "
                                     "outside the file")
                f.seek(start)
                raw = f.read(length)
                PG.STATS["file_bytes"] += len(raw)
                pages = PG.read_chunk_pages(raw, col, leaf)
                valid = PG._validity(pages, rg.num_rows)
                if valid.shape[0] != rg.num_rows:
                    raise ValueError(f"corrupt Parquet chunk {name!r}: "
                                     f"{valid.shape[0]} values for "
                                     f"{rg.num_rows} rows")
                valids, vals = acc[name]
                valids.append(valid)
                if isinstance(vals, list):
                    vals.append(PG.fixed_values(leaf, st, pages, valid))
                else:
                    vals.add(pages)
    out = {}
    for name, _, _, st in cols:
        valids, vals = acc[name]
        valid = np.concatenate(valids)
        if isinstance(vals, list):
            data = vals[0] if len(vals) == 1 else np.concatenate(vals)
        elif isinstance(vals, PG.StringDictionary):
            data = vals.host_form(valid)
            if data is None:
                # an empty dictionary (no valid row): the reference
                # decodes, to an all-null char matrix
                data = PG.StringChunks().matrix(valid)
        else:
            data = vals.matrix(valid)
        out[name] = (data, valid, st)
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
                             resolve_encoded_execution(device))
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
    reference's readers (no ``read_dictionary``) give them.

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
        _leaf(meta, name)  # an unreadable column raises here, not later

    def make(i):
        def read() -> ColumnBatch:
            return _upload(decode_row_groups(path, meta, [i], names),
                           device)
        return read

    return [(make(i), meta.row_group(i).num_rows) for i in keep]

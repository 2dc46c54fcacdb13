"""Spark ``from_json`` -> MAP<STRING,STRING> extraction.

Counterpart of ``spark_rapids_jni_tpu/ops/from_json.py``.  Reference:
``map_utils.cu`` (an FST token stream over concatenated rows -> a node
tree -> LIST<STRUCT<STRING,STRING>> of the top-level key/value pairs,
values as RAW substrings).  The char-level tokenizer of
:mod:`.get_json_object` is reused with a small pair recorder in place of
the JSONPath evaluator:

* at each top-level FIELD token, remember the key span (quotes stripped);
* at the completion of its value (a terminal token or the END event of a
  depth-1 container), record a (key span, raw value span) pair event;
* after the scan, the pair events flatten row-major and front-compact in
  the order a stable two-way sort on the pair flag gives (computed here
  as ranks, no sort), the spans gather into padded key / value char
  matrices, and per-row counts prefix-sum into list offsets.

The scan is a Python loop over the L + 1 char columns, each step the
tokenizer's few hundred small torch ops plus the recorder's.

Output matches MapUtilsTest.java: string values keep their raw content
(no unescaping), container values are verbatim substrings including
inner whitespace, ``{}`` -> an empty list, null/non-object/invalid rows ->
null.
"""

from __future__ import annotations

import torch

from ..columnar.column import ListColumn, StringColumn, StructColumn
from ._util import char_window
from .get_json_object import (EV_FIELD, EV_NULL, EV_SARR, EV_SOBJ, EV_STR,
                              M_DONE, _init_carry, _pack_path, _step)

_w = torch.where


def _recorder_step(P, ptypes, pindexes, pnames, pnamelens, carry, j, c):
    """Tokenizer step + top-level key/value pair recorder.

    Runs the full :func:`_step` (its evaluator runs with an empty path;
    its emissions are ignored) and layers the map recorder on the raw
    token events it exports."""
    rec = {k: carry[k] for k in ("key_s", "key_e", "val_s", "root_obj")}
    tok_carry = {k: v for k, v in carry.items() if k not in rec}
    out, ys = _step(P, ptypes, pindexes, pnames, pnamelens, tok_carry, j, c,
                    events=True)
    ev_a, ev_b = ys["ev_a"], ys["ev_b"]
    span_s, span_len = ys["span_s"], ys["span_len"]
    depth_before = tok_carry["depth"]

    root_obj = rec["root_obj"] | ((ev_a == EV_SOBJ) & (depth_before == 0))

    # top-level field: remember the key content span (quotes stripped)
    fieldev = (ev_a == EV_FIELD) & (depth_before == 1)
    key_s = _w(fieldev, span_s + 1, rec["key_s"])
    key_e = _w(fieldev, span_s + span_len - 1, rec["key_e"])

    # the value: terminals complete in one event; containers open at
    # depth 1 and close via the END event returning to depth 1
    is_term = (ev_a >= EV_STR) & (ev_a <= EV_NULL)
    t_done = is_term & (depth_before == 1) & root_obj
    c_open = ((ev_a == EV_SOBJ) | (ev_a == EV_SARR)) & (depth_before == 1)
    val_s = _w(c_open, j, rec["val_s"])
    c_done = (ev_b != 0) & (out["depth"] == 1) & (depth_before == 2) \
        & (rec["val_s"] >= 0) & root_obj

    pair_done = t_done | c_done
    # terminal values: strip quotes from strings to match the raw-map
    # contract (MapUtilsTest: value of "STANDARD" is STANDARD)
    is_str = ev_a == EV_STR
    t_s = _w(is_str, span_s + 1, span_s)
    t_len = _w(is_str, span_len - 2, span_len)
    pv_s = _w(t_done, t_s, rec["val_s"])
    pv_e = _w(t_done, t_s + t_len, torch.full_like(t_s, j + 1))

    zero = torch.zeros_like(span_s)
    ys_rec = {
        "pair": pair_done,
        "pk_s": _w(pair_done, rec["key_s"], zero),
        "pk_e": _w(pair_done, rec["key_e"], zero),
        "pv_s": _w(pair_done, pv_s, zero),
        "pv_e": _w(pair_done, pv_e, zero),
    }
    out.update(
        key_s=key_s,
        key_e=key_e,
        val_s=_w(pair_done, torch.full_like(val_s, -1), val_s),
        root_obj=root_obj,
    )
    return out, ys_rec


def _front_order(flat: torch.Tensor, C: int) -> torch.Tensor:
    """The first ``C`` entries of the stable order that puts the True
    entries of ``flat`` first (each group in index order): the
    reference's two-way ``regroup_order`` on the flag, as ranks."""
    N = flat.shape[0]
    f = flat.to(torch.int64)
    total = f.sum()
    rank_t = torch.cumsum(f, 0) - 1
    rank_f = total + torch.cumsum(1 - f, 0) - 1
    dest = _w(flat, rank_t, rank_f)
    order = torch.empty((N,), dtype=torch.int64, device=flat.device)
    order.scatter_(0, dest, torch.arange(N, dtype=torch.int64,
                                         device=flat.device))
    return order[:C]


def _span(chars, picks, arr_s, arr_e, live, W):
    """The [s, e) spans of the picked events as a padded char matrix
    ``[C, W]`` and lengths (0 where not ``live``)."""
    s = arr_s.reshape(-1)[picks]
    ln = (arr_e.reshape(-1)[picks] - s).clamp(0, W)
    win = char_window(chars, s, ln, W, row=picks // (chars.shape[1] + 1))
    return win, _w(live, ln, torch.zeros_like(ln)).to(torch.int32)


def _extract(chars, lengths, validity, max_pairs_per_row):
    n, L = chars.shape
    dev = chars.device
    i32 = torch.int32
    ptypes, pindexes, pnames, pnamelens, P = _pack_path((), dev)

    carry = _init_carry(lengths, n, dev)
    carry.update(
        key_s=torch.zeros((n,), dtype=i32, device=dev),
        key_e=torch.zeros((n,), dtype=i32, device=dev),
        val_s=torch.full((n,), -1, dtype=i32, device=dev),
        root_obj=torch.zeros((n,), dtype=torch.bool, device=dev),
    )
    cpad_t = torch.cat([chars, torch.zeros((n, 1), dtype=chars.dtype,
                                           device=dev)], dim=1).t()
    steps = []
    for j in range(L + 1):
        carry, y = _recorder_step(P, ptypes, pindexes, pnames, pnamelens,
                                  carry, j, cpad_t[j])
        steps.append(y)
    ys = {k: torch.stack([y[k] for y in steps], dim=1) for k in steps[0]}
    del steps

    row_ok = validity & carry["root_obj"] & (carry["mode"] == M_DONE) \
        & ~carry["ev_fail"]
    pair = ys["pair"] & row_ok[:, None]
    counts = pair.sum(dim=1, dtype=torch.int64)
    offsets = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev),
                         torch.cumsum(counts, 0)]).to(i32)

    C = n * max_pairs_per_row
    flat_pair = pair.reshape(-1)
    picks = _front_order(flat_pair, C)
    live = torch.arange(C, dtype=torch.int64, device=dev) < counts.sum()
    kc, kl = _span(chars, picks, ys["pk_s"], ys["pk_e"], live, L)
    vc, vl = _span(chars, picks, ys["pv_s"], ys["pv_e"], live, L)
    return offsets, row_ok, kc, kl, vc, vl, live


def from_json_to_raw_map(col: StringColumn,
                         max_pairs_per_row: int = 0) -> ListColumn:
    """LIST<STRUCT<key STRING, value STRING>> of top-level object fields.

    ``max_pairs_per_row`` sizes the child columns at ``n *
    max_pairs_per_row`` slots (pairs past them are dropped, as in the
    reference); the default covers the densest possible row."""
    n, L = col.chars.shape
    if max_pairs_per_row <= 0:
        # the smallest possible pair is 5 chars ('"":0,'); +1 slack covers
        # the missing trailing comma of the last pair
        max_pairs_per_row = max(1, L // 5 + 1)
    offsets, row_ok, kc, kl, vc, vl, live = _extract(
        col.chars, col.lengths, col.validity, max_pairs_per_row)
    keys = StringColumn(kc, kl, live)
    values = StringColumn(vc, vl, live)
    structs = StructColumn({"key": keys, "value": values}, live)
    return ListColumn(offsets, structs, row_ok)

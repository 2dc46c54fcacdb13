"""PyTorch port: ``ops/row_conversion.py`` (the JCUDF row format)
against the JAX package, byte for byte.

One seeded batch of every column kind the format carries (boolean, the
ints, date, timestamp, both floats as random bit patterns, two string
columns with UTF-8 and empty values, Decimal128 at 32-, 64- and 128-bit
storage, nulls everywhere) goes through ``convert_to_rows`` in both
packages: the row images (padding, alignment, validity bytes, the
string offsets in the fixed slot, the variable region) and row lengths
must be identical, and ``convert_from_rows`` must give back the
reference's columns and the original batch.  The batched and
fixed-width-optimized entries, the layout goldens of RowConversion.java
and the errors follow."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import ColumnBatch as JBatch
from spark_rapids_jni_tpu.columnar.column import StringColumn as JString
from spark_rapids_jni_tpu.ops import row_conversion as JR

from spark_rapids_jni_tpu_torch.columnar import types as TT
from spark_rapids_jni_tpu_torch.columnar.column import (
    Column, ColumnBatch, Decimal128Column, StringColumn)
from spark_rapids_jni_tpu_torch.ops import row_conversion as TR

import torch_parity as TP
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

N = 300
KINDS = [("b", "boolean"), ("i8", "int8"), ("s1", "string"),
         ("i16", "int16"), ("i32", "int32"), ("d", "date"),
         ("f32", "float32"), ("i64", "int64"), ("ts", "timestamp"),
         ("f64", "float64"), ("dec38", 38), ("s2", "string"), ("dec9", 9),
         ("dec18", 18)]
WORDS = ["", "a", "hello", "ünïcode", "x" * 30, "tab\tand\x00zero"]


def _reference_batch(seed=91):
    rng = np.random.default_rng(seed)
    cols = {}
    for name, kind in KINDS:
        valid = rng.random(N) > 0.1
        if kind == "string":
            picks = rng.integers(0, len(WORDS), N)
            cols[name] = JString.from_pylist(
                [WORDS[p] if ok else None for p, ok in zip(picks, valid)],
                pad_to_multiple=8)
        elif isinstance(kind, int):
            cols[name] = TP.jdecimal(TP.unscaled(rng, N, kind), kind, 2)
        else:
            if kind == "boolean":
                v = rng.random(N) < 0.5
            elif kind == "date":
                v = rng.integers(-10**6, 10**6, N).astype(np.int32)
            elif kind == "timestamp":
                v = rng.integers(-2**62, 2**62, N).astype(np.int64)
            elif kind == "float64":
                v = rng.integers(-2**63, 2**63 - 1, N, dtype=np.int64).view(
                    np.float64)
            elif kind == "float32":
                v = rng.integers(0, 2**32, N, dtype=np.uint64).astype(
                    np.uint32).view(np.float32)
            else:
                info = np.iinfo(kind)
                v = rng.integers(info.min, info.max, N,
                                 endpoint=True).astype(kind)
            cols[name] = JColumn(jnp.asarray(v), jnp.asarray(valid),
                                 getattr(JT, kind.upper()))
    return JBatch(cols)


def _schemas(jb):
    js, ts = {}, {}
    for name, c in zip(jb.names, jb.columns):
        if isinstance(c, JString):
            js[name], ts[name] = (JT.STRING, 32), (TT.STRING, 32)
        else:
            js[name], ts[name] = c.dtype, TT.from_name(repr(c.dtype))
    return js, ts


@pytest.fixture(scope="module")
def case():
    jb = _reference_batch()
    tb = TP.to_port(jb)
    js, ts = _schemas(jb)
    jrows = JR.convert_to_rows(jb)
    return jb, tb, js, ts, jrows, JR.convert_from_rows(jrows, js)


def test_row_images_byte_for_byte(case):
    _, tb, _, _, jrows, _ = case
    rows = TR.convert_to_rows(tb)
    np.testing.assert_array_equal(rows.chars.numpy(), np.asarray(jrows.chars))
    np.testing.assert_array_equal(rows.lengths.numpy(),
                                  np.asarray(jrows.lengths))
    np.testing.assert_array_equal(rows.validity.numpy(),
                                  np.asarray(jrows.validity))
    assert rows.lengths.dtype == torch.int32
    assert bool((rows.lengths % 8 == 0).all())


def test_row_valid_mask(case):
    jb, tb, _, _, _, _ = case
    mask = np.arange(N) % 3 != 0
    ref = JR.convert_to_rows(jb, row_valid=jnp.asarray(mask))
    got = TR.convert_to_rows(tb, row_valid=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_array_equal(got.validity.numpy(), mask)


@pytest.mark.parametrize("name", [n for n, _ in KINDS])
def test_from_rows_equals_reference_and_input(case, name):
    jb, _, _, ts, jrows, jback = case
    back = TR.convert_from_rows(TP.port_col(jrows), ts)
    TP.assert_col_equal(jback[name], back[name], msg=name)
    TP.assert_col_equal(jb[name], back[name], msg=f"{name} round trip")
    if isinstance(back[name], StringColumn):
        np.testing.assert_array_equal(back[name].chars.numpy(),
                                      np.asarray(jback[name].chars))


def test_batched_round_trip(case):
    """Each batch is the reference's whole image's rows (the batches keep
    the string columns' widths), so one comparison covers them all."""
    jb, tb, js, ts, jrows, _ = case
    parts = TR.convert_to_rows_batched(tb, max_batch_bytes=20000)
    width = jrows.chars.shape[1]
    assert len(parts) == -(-N // (20000 // width)) > 1
    np.testing.assert_array_equal(
        torch.cat([p.chars for p in parts]).numpy(), np.asarray(jrows.chars))
    back = TR.convert_from_rows_batched(parts, ts)
    for name in jb.names:
        TP.assert_col_equal(jb[name], back[name], msg=name)
    one = TR.convert_from_rows_batched(TR.convert_to_rows_batched(tb), ts)
    for name in jb.names:
        TP.assert_col_equal(jb[name], one[name], msg=name)


def test_fixed_width_optimized(case):
    jb, tb, _, _, _, _ = case
    fixed = [n for n, k in KINDS if k != "string"]
    rows = TR.convert_to_rows_fixed_width_optimized(tb.select(fixed))
    ref = JR.convert_to_rows(JBatch({n: jb[n] for n in fixed}))
    np.testing.assert_array_equal(rows.chars.numpy(), np.asarray(ref.chars))
    with pytest.raises(ValueError):
        TR.convert_to_rows_fixed_width_optimized(tb.select(["s1"]))
    wide = {f"c{i}": Decimal128Column.from_unscaled([1], 38, 0,
                                                    device="cpu")
            for i in range(90)}
    with pytest.raises(ValueError):
        TR.convert_to_rows_fixed_width_optimized(ColumnBatch(wide))
    many = {f"c{i}": Column(torch.tensor([1], dtype=torch.int32),
                            torch.tensor([True]), TT.INT32)
            for i in range(100)}
    with pytest.raises(ValueError):
        TR.convert_to_rows_fixed_width_optimized(ColumnBatch(many))


def _col(vals, tt, dtype):
    valid = [v is not None for v in vals]
    return Column(torch.tensor([0 if v is None else v for v in vals],
                               dtype=dtype), torch.tensor(valid), tt)


def test_layout_goldens():
    # RowConversion.java:78-90: BOOL8, INT16, INT32 -> 16-byte rows
    b = ColumnBatch({"a": _col([True], TT.BOOLEAN, torch.bool),
                     "b": _col([0x0201], TT.INT16, torch.int16),
                     "c": _col([0x06050403], TT.INT32, torch.int32)})
    rows = TR.convert_to_rows(b)
    assert int(rows.lengths[0]) == 16
    assert bytes(rows.chars.numpy()[0, :16]) == bytes(
        [1, 0, 1, 2, 3, 4, 5, 6, 0x07] + [0] * 7)
    # C, B, A order: | C0..C3 | B0 B1 | A0 | V0 | -> 8 bytes, a null
    b = ColumnBatch({"c": _col([0x04030201], TT.INT32, torch.int32),
                     "b": _col([0x0605], TT.INT16, torch.int16),
                     "a": _col([None], TT.BOOLEAN, torch.bool)})
    rows = TR.convert_to_rows(b)
    assert bytes(rows.chars.numpy()[0, :8]) == bytes([1, 2, 3, 4, 5, 6, 0,
                                                      0x03])
    offs, voff, fixed_end, nv = TR.row_layout(
        [_col([1], TT.INT8, torch.int8), _col([2], TT.INT64, torch.int64)])
    assert (offs, voff, fixed_end, nv) == ([0, 8], 16, 17, 1)
    assert TR.layout_from_widths([8, 16, 4, 1]) == ([0, 8, 24, 28], 29, 30,
                                                    1)


def test_string_offsets_in_fixed_slot():
    rows = TR.convert_to_rows(ColumnBatch({
        "s": StringColumn.from_pylist(["abc"], device="cpu")}))
    raw = rows.chars.numpy()[0]
    off = int.from_bytes(bytes(raw[0:4]), "little")
    ln = int.from_bytes(bytes(raw[4:8]), "little")
    assert (off, ln) == (9, 3) and bytes(raw[off:off + 3]) == b"abc"

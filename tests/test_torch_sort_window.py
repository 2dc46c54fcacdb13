"""PyTorch port: the multi-key sort and the window functions, against the
JAX package.

Sort permutations, ranks, counts and integer results must be
bit-identical; float running sums and averages agree within rel 1e-5
(the reference's f32x3 tolerance); float min/max compare as values
(``-0.0 == 0.0``, NaN equal to NaN).  Inputs are made with numpy from a
seed and fed to both packages.  No subnormal floats: XLA's CPU backend
compares them as zero (ROADMAP.md queue 3).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import ColumnBatch as JBatch
from spark_rapids_jni_tpu.columnar.column import StringColumn as JString
from spark_rapids_jni_tpu.relational import sort as JS

from spark_rapids_jni_tpu_torch.columnar.column import (StringColumn,
                                                        batch_from_numpy)
from spark_rapids_jni_tpu_torch.relational import sort as TS

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

# the packages export a function ``window`` beside the module of that name
JW = importlib.import_module("spark_rapids_jni_tpu.relational.window")
TW = importlib.import_module("spark_rapids_jni_tpu_torch.relational.window")

RTOL = 1e-5


def _host(c):
    if isinstance(c, JString):
        return (np.asarray(c.chars), np.asarray(c.lengths))
    return np.asarray(c.data)


def to_port(jb):
    return batch_from_numpy(
        {n: (_host(c), np.asarray(c.validity), repr(c.dtype))
         for n, c in zip(jb.names, jb.columns)}, device="cpu")


def _valid(rng, n, share=0.15):
    return jnp.asarray(rng.random(n) > share)


def _floats(rng, n, dtype):
    v = (rng.integers(-3, 4, n) * 0.5).astype(dtype)
    special = np.array([-0.0, 0.0, np.nan, -np.nan, np.inf, -np.inf,
                        np.finfo(dtype).max, -np.finfo(dtype).max],
                       dtype=dtype)
    pos = rng.choice(n, size=len(special) * 3, replace=False)
    v[pos] = np.tile(special, 3)
    return v


def _mixed(rng, n):
    """Every key kind the sort takes, each with nulls."""
    words = ["", "a", "a\x00", "ab", "b", "zz", "\xff", "abc", "abcdefgh"]
    return JBatch({
        "i64": JColumn(jnp.asarray(rng.choice(
            np.array([-(2**63), 2**63 - 1, -1, 0, 1, 2**40, -(2**40)],
                     np.int64), n)), _valid(rng, n), JT.INT64),
        "i32": JColumn(jnp.asarray(rng.integers(-4, 4, n).astype(np.int32)),
                       _valid(rng, n), JT.INT32),
        "i8": JColumn(jnp.asarray(rng.integers(-128, 128, n)
                                  .astype(np.int8)), _valid(rng, n),
                      JT.INT8),
        "i16": JColumn(jnp.asarray(rng.integers(-5, 5, n).astype(np.int16)),
                       _valid(rng, n), JT.INT16),
        "ts": JColumn(jnp.asarray(rng.integers(-(2**50), 2**50, n)),
                      _valid(rng, n), JT.TIMESTAMP),
        "f64": JColumn(jnp.asarray(_floats(rng, n, np.float64)),
                       _valid(rng, n), JT.FLOAT64),
        "f32": JColumn(jnp.asarray(_floats(rng, n, np.float32)),
                       _valid(rng, n), JT.FLOAT32),
        "b": JColumn(jnp.asarray(rng.random(n) > 0.5), _valid(rng, n),
                     JT.BOOLEAN),
        "s": JString.from_pylist(
            [None if rng.random() < 0.1 else words[rng.integers(0,
                                                                len(words))]
             for _ in range(n)], max_len=10),
    })


class TestSort:
    @pytest.mark.parametrize("key", ["i64", "i32", "i8", "i16", "ts", "f64",
                                     "f32", "b", "s"])
    @pytest.mark.parametrize("asc,nf", [(True, True), (True, False),
                                        (False, True), (False, False)])
    def test_one_key_every_order(self, key, asc, nf):
        rng = np.random.default_rng(hash(key) % 1000)
        jb = _mixed(rng, 600)
        jk = [JS.SortKey(key, asc, nf)]
        tk = [TS.SortKey(key, asc, nf)]
        jp = np.asarray(jax.jit(lambda b: JS.sort_permutation(b, jk))(jb))
        tp = TS.sort_permutation(to_port(jb), tk).numpy()
        np.testing.assert_array_equal(tp, jp)

    def test_float_total_order(self):
        """-0.0 sorts before 0.0, one NaN, greatest; the sort is stable."""
        v = np.array([np.nan, 0.0, -0.0, -np.inf, 1.0, -np.nan, 0.0, -0.0],
                     np.float64)
        jb = JBatch({"f": JColumn(jnp.asarray(v), jnp.ones(8, jnp.bool_),
                                  JT.FLOAT64)})
        tp = TS.sort_permutation(to_port(jb), [TS.SortKey("f")]).numpy()
        assert tp.tolist() == [3, 2, 7, 1, 6, 4, 0, 5]
        jp = np.asarray(JS.sort_permutation(jb, [JS.SortKey("f")]))
        np.testing.assert_array_equal(tp, jp)

    def test_multi_key_and_sort_by(self):
        rng = np.random.default_rng(3)
        jb = _mixed(rng, 900)
        spec = [("s", False, False), ("i32", True, True), ("f64", False, True),
                ("i64", True, False)]
        jk = [JS.SortKey(*a) for a in spec]
        tk = [TS.SortKey(*a) for a in spec]
        jr = jax.jit(lambda b: JS.sort_by(b, jk))(jb)
        tr = TS.sort_by(to_port(jb), tk)
        for name in jr.names:
            np.testing.assert_array_equal(
                tr[name].validity.numpy(), np.asarray(jr[name].validity))
            if isinstance(tr[name], StringColumn):
                np.testing.assert_array_equal(tr[name].chars.numpy(),
                                              np.asarray(jr[name].chars))
                continue
            np.testing.assert_array_equal(
                tr[name].data.numpy().view(np.uint8),
                np.asarray(jr[name].data).view(np.uint8), err_msg=name)


def _window_batch(rng, n, parts, with_nulls=True):
    share = 0.12 if with_nulls else 0.0
    return JBatch({
        "p": JColumn(jnp.asarray(rng.integers(0, parts, n).astype(np.int32)),
                     _valid(rng, n, share / 3), JT.INT32),
        "o": JColumn(jnp.asarray(rng.integers(0, 12, n)), _valid(rng, n,
                                                                 share / 2),
                     JT.INT64),
        "v": JColumn(jnp.asarray(rng.integers(-(2**40), 2**40, n)),
                     _valid(rng, n, share), JT.INT64),
        "i": JColumn(jnp.asarray(rng.integers(-9, 9, n).astype(np.int32)),
                     _valid(rng, n, share), JT.INT32),
        "f": JColumn(jnp.asarray(rng.random(n) * 1e3 - 500),
                     _valid(rng, n, share), JT.FLOAT64),
        "s": JString.from_pylist([f"r{j}" for j in range(n)]),
    })


SPECS = [("row_number", None, "rn"), ("rank", None, "rk"),
         ("dense_rank", None, "dr"), ("count", None, "cstar"),
         ("count", "v", "cv"), ("sum", "v", "sv"), ("sum", "i", "si"),
         ("sum", "f", "sf"), ("avg", "f", "af"), ("avg", "i", "ai"),
         ("min", "v", "mnv"), ("max", "v", "mxv"), ("min", "f", "mnf"),
         ("max", "i", "mxi"), ("lag", "v", "lag1"), ("lead", "f", "lead1"),
         ("lead", "i", "lead0", 0)]
FLOATS = ("sf", "af", "ai")


def _assert_window_match(jr, tr):
    assert list(tr.names) == list(jr.names)
    for name in jr.names:
        jv = np.asarray(jr[name].validity)
        np.testing.assert_array_equal(tr[name].validity.numpy(), jv,
                                      err_msg=name)
        if isinstance(tr[name], StringColumn):
            np.testing.assert_array_equal(tr[name].chars.numpy()[jv],
                                          np.asarray(jr[name].chars)[jv])
            continue
        a, b = tr[name].data.numpy()[jv], np.asarray(jr[name].data)[jv]
        if name in FLOATS:
            np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=name)
        elif a.dtype.kind == "f":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_array_equal(a.view(np.uint8),
                                          b.astype(a.dtype).view(np.uint8),
                                          err_msg=name)


class TestWindow:
    @pytest.mark.parametrize("desc", [False, True])
    def test_every_op(self, desc):
        rng = np.random.default_rng(7 + desc)
        jb = _window_batch(rng, 700, 9)
        jspecs = [JW.WindowSpec(*a) for a in SPECS]
        tspecs = [TW.WindowSpec(*a) for a in SPECS]
        jr = jax.jit(lambda b: JW.window(b, ["p"], ["o"], jspecs,
                                         descending=[desc]))(jb)
        tr = TW.window(to_port(jb), ["p"], ["o"], tspecs, descending=[desc])
        _assert_window_match(jr, tr)

    def test_lag_lead_offsets_and_partition_edges(self):
        rng = np.random.default_rng(9)
        jb = _window_batch(rng, 300, 40)
        spec = [("lag", "v", "l3", 3), ("lead", "v", "d5", 5),
                ("lag", "f", "l0", 0), ("lead", "i", "d2", 2)]
        jr = jax.jit(lambda b: JW.window(
            b, ["p"], ["o", "i"], [JW.WindowSpec(*a) for a in spec],
            descending=[True, False]))(jb)
        tr = TW.window(to_port(jb), ["p"], ["o", "i"],
                       [TW.WindowSpec(*a) for a in spec],
                       descending=[True, False])
        _assert_window_match(jr, tr)

    def test_nan_in_running_min_max(self):
        rng = np.random.default_rng(10)
        jb = _window_batch(rng, 200, 3, with_nulls=False)
        f = np.asarray(jb["f"].data).copy()
        f[::17] = np.nan
        jb = JBatch(dict(zip(jb.names, jb.columns), f=JColumn(
            jnp.asarray(f), jb["f"].validity, JT.FLOAT64)))
        spec = [("min", "f", "mn"), ("max", "f", "mx")]
        jr = jax.jit(lambda b: JW.window(b, ["p"], ["o"], [
            JW.WindowSpec(*a) for a in spec]))(jb)
        tr = TW.window(to_port(jb), ["p"], ["o"],
                       [TW.WindowSpec(*a) for a in spec])
        _assert_window_match(jr, tr)

    def test_string_partition_and_two_order_keys(self):
        rng = np.random.default_rng(11)
        n = 400
        jb = _window_batch(rng, n, 5)
        jb = JBatch(dict(zip(jb.names, jb.columns), s=JString.from_pylist(
            [None if rng.random() < 0.05 else f"g{rng.integers(0, 7)}"
             for _ in range(n)])))
        spec = [("rank", None, "rk"), ("dense_rank", None, "dr"),
                ("sum", "v", "sv")]
        jr = jax.jit(lambda b: JW.window(b, ["s"], ["o", "i"], [
            JW.WindowSpec(*a) for a in spec], descending=[False, True]))(jb)
        tr = TW.window(to_port(jb), ["s"], ["o", "i"],
                       [TW.WindowSpec(*a) for a in spec],
                       descending=[False, True])
        _assert_window_match(jr, tr)

    def test_spec_validation(self):
        with pytest.raises(ValueError, match="unknown window op"):
            TW.WindowSpec("ntile", None, "x")
        with pytest.raises(ValueError, match="needs a value column"):
            TW.WindowSpec("sum", None, "x")
        with pytest.raises(ValueError, match="offset"):
            TW.WindowSpec("lag", "v", "x", -1)
        tb = to_port(_window_batch(np.random.default_rng(12), 10, 2))
        with pytest.raises(ValueError, match="descending"):
            TW.window(tb, ["p"], ["o"], [], descending=[True, False])


def test_segmented_scan_matches_a_loop():
    """The log-step scan against a plain per-segment loop."""
    rng = np.random.default_rng(13)
    n = 1000
    vals = torch.from_numpy(rng.integers(-50, 50, n))
    boundary = torch.from_numpy(rng.random(n) < 0.05)
    boundary[0] = True
    iota = torch.arange(n)
    start = TW._starts(boundary, iota)
    got = TW._seg_scan(vals, start, iota, torch.minimum).numpy()
    want = np.empty(n, np.int64)
    cur = None
    for i in range(n):
        cur = int(vals[i]) if boundary[i] else min(cur, int(vals[i]))
        want[i] = cur
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TW._seg_cumsum(vals, start).numpy(),
        np.concatenate([np.cumsum(seg) for seg in np.split(
            vals.numpy(), np.flatnonzero(boundary.numpy())[1:])]))

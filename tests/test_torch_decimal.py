"""PyTorch port: Decimal128 columns, arithmetic, key words, gathers, sorts
and the q3 revenue composition against the JAX package.

Reference counterparts: ``spark_rapids_jni_tpu/ops/decimal.py`` (every
public op, overflow flags and results bit for bit), ``columnar/
column.py`` ``Decimal128Column``, ``relational/keys.py``,
``relational/gather.py``, ``relational/sort.py`` and ``__graft_entry__.py``
``_q3_step``.  Every decimal result is compared exactly; a sample is also
held against Python ``decimal`` arithmetic with Spark's HALF_UP rounding
and non-ANSI overflow to null.
"""

import decimal as pydec

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import config as jconfig
from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import ColumnBatch as JBatch
from spark_rapids_jni_tpu.ops import decimal as JD
from spark_rapids_jni_tpu.relational import aggregate as JAgg
from spark_rapids_jni_tpu.relational import gather as JG
from spark_rapids_jni_tpu.relational import join as JJ
from spark_rapids_jni_tpu.relational import keys as JK
from spark_rapids_jni_tpu.relational import sort as JS

from spark_rapids_jni_tpu_torch import config as tconfig
from spark_rapids_jni_tpu_torch.columnar.column import (Decimal128Column,
                                                        batch_from_numpy,
                                                        batch_to_numpy)
from spark_rapids_jni_tpu_torch.ops import decimal as TD
from spark_rapids_jni_tpu_torch.relational import aggregate as TAgg
from spark_rapids_jni_tpu_torch.relational import gather as TG
from spark_rapids_jni_tpu_torch.relational import join as TJ
from spark_rapids_jni_tpu_torch.relational import keys as TK
from spark_rapids_jni_tpu_torch.relational import sort as TS

from torch_parity import (MAX38, assert_col_equal, host_form, jdecimal,
                          port_col, to_port, unscaled)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _reset_config():
    yield
    jconfig.reset()
    tconfig.reset()


def _specials(p):
    top = 10 ** p - 1
    return [top, -top, 0, 5, -5, 15, -25, 10 ** (p - 1) + 5, 1]


_DIVISORS = [0, 1, -1, 10, -10, 2, 3, 0, 7]

# (a precision, a scale), (b precision, b scale)
_COMBOS = {"p38s2_by_p20s4": ((38, 2), (20, 4)),
           "p38s10_by_p18s0": ((38, 10), (18, 0)),
           "p12s2_by_p13s2": ((12, 2), (13, 2)),
           "p38s4_by_p38s2": ((38, 4), (38, 2))}


def _operands(combo):
    (pa, sa), (pb, sb) = _COMBOS[combo]
    rng = np.random.default_rng(sorted(_COMBOS).index(combo))
    av = unscaled(rng, 120, pa, specials=_specials(pa))
    bv = unscaled(rng, 120, pb, specials=_DIVISORS[:-2] + [
        10 ** pb - 1, -(10 ** (pb - 1)) - 7])
    ja, jb = jdecimal(av, pa, sa), jdecimal(bv, pb, sb)
    return ja, jb, port_col(ja), port_col(jb)


def _same(jout, tout, what):
    (jo, jr), (to, tr) = jout, tout
    assert_col_equal(jo, to, msg=f"{what} overflow")
    np.testing.assert_array_equal(to.data.numpy(), np.asarray(jo.data),
                                  err_msg=f"{what} overflow flags")
    # the reference leaves results under its null rows defined: all rows
    np.testing.assert_array_equal(tr.validity.numpy(),
                                  np.asarray(jr.validity), err_msg=what)
    if isinstance(tr, Decimal128Column):
        np.testing.assert_array_equal(tr.limbs.numpy().view(np.uint64),
                                      np.asarray(jr.limbs), err_msg=what)
        assert repr(tr.dtype) == repr(jr.dtype)
    else:
        np.testing.assert_array_equal(tr.data.numpy(), np.asarray(jr.data),
                                      err_msg=what)


def _scales(op, sa, sb):
    lo, hi = min(sa, sb), max(sa, sb)
    return {"add": [hi, lo, hi + 3], "sub": [hi, lo],
            "multiply": [sa + sb, max(sa + sb - 3, 0), sa + sb + 2],
            "divide": [6, 0, 40], "integer_divide": [None],
            "remainder": [hi, lo]}[op]


@pytest.mark.parametrize("combo", sorted(_COMBOS))
@pytest.mark.parametrize("op", ["add", "sub", "multiply", "divide",
                                "integer_divide", "remainder"])
def test_ops_bit_identical(op, combo):
    """Every op at several result scales (rescaling up and down, the
    two-stage scale-up past 10^38, ties, negative operands, overflow at
    +-(10^38 - 1) and divide by zero) equals the reference bit for bit."""
    ja, jb, ta, tb = _operands(combo)
    (_, sa), (_, sb) = _COMBOS[combo]
    for scale in _scales(op, sa, sb):
        what = f"{op}({combo}, {scale})"
        if op == "integer_divide":
            _same(JD.integer_divide_decimal128(ja, jb),
                  TD.integer_divide_decimal128(ta, tb), what)
        elif op == "multiply":
            for interim in (True, False):
                _same(JD.multiply_decimal128(ja, jb, scale, interim),
                      TD.multiply_decimal128(ta, tb, scale, interim),
                      f"{what} interim={interim}")
        else:
            jfn = getattr(JD, f"{op}_decimal128")
            tfn = getattr(TD, f"{op}_decimal128")
            _same(jfn(ja, jb, scale), tfn(ta, tb, scale), what)


def _py(v, s):
    return None if v is None else pydec.Decimal(v).scaleb(-s)


def _spark_round(x, scale):
    """HALF_UP to ``scale``; None (null) past 38 digits."""
    q = x.quantize(pydec.Decimal(1).scaleb(-scale),
                   rounding=pydec.ROUND_HALF_UP)
    return None if abs(q.scaleb(scale)) > MAX38 else int(q.scaleb(scale))


@pytest.mark.parametrize("op", ["add", "multiply", "divide"])
def test_sample_matches_python_decimal(op):
    """Spark semantics from first principles on a 512-row sample: HALF_UP
    rounding, overflow and divide by zero -> null (non-ANSI)."""
    pydec.getcontext().prec = 200
    rng = np.random.default_rng(31)
    n = 512
    av = unscaled(rng, n - 9, 38, specials=_specials(38))
    bv = unscaled(rng, n - 9, 20, specials=_DIVISORS)
    ta = port_col(jdecimal(av, 38, 2))
    tb = port_col(jdecimal(bv, 20, 4))
    if op == "add":
        scale, got = 4, TD.add_decimal128(ta, tb, 4)
        want = [None if x is None or y is None
                else _spark_round(_py(x, 2) + _py(y, 4), scale)
                for x, y in zip(av, bv)]
    elif op == "multiply":
        scale, got = 3, TD.multiply_decimal128(ta, tb, 3, False)
        want = [None if x is None or y is None
                else _spark_round(_py(x, 2) * _py(y, 4), scale)
                for x, y in zip(av, bv)]
    else:
        scale, got = 6, TD.divide_decimal128(ta, tb, 6)
        want = [None if x is None or y is None or y == 0
                else _spark_round(_py(x, 2) / _py(y, 4), scale)
                for x, y in zip(av, bv)]
    res = TD.null_on_overflow(*got)
    assert res.to_pylist() == want
    assert res.dtype.scale == scale
    assert sum(w is None for w in want) > 20  # nulls, overflow and /0 seen


class TestColumns:
    def test_unscaled_round_trip_and_limbs(self):
        vals = [0, 1, -1, MAX38, -MAX38, None, 2 ** 64, -(2 ** 64) - 7]
        jc = jdecimal(vals, 38, 3)
        tc = Decimal128Column.from_unscaled(vals, 38, 3, device="cpu")
        assert tc.to_pylist() == jc.to_unscaled_pylist() == vals
        np.testing.assert_array_equal(tc.limbs.numpy().view(np.uint64),
                                      np.asarray(jc.limbs))
        assert repr(tc.dtype) == "decimal(38,3)"
        assert tc.dtype.decimal_storage_bits == 128

    def test_batch_from_and_to_numpy_nested(self):
        """Decimal, list and struct columns cross in the reference's host
        form and come back out of ``batch_to_numpy`` the same."""
        from spark_rapids_jni_tpu.columnar.column import ListColumn as JL
        from spark_rapids_jni_tpu.columnar.column import StructColumn as JSt

        jb = JBatch({
            "d": jdecimal([5, None, -7], 9, 2),
            "l": JL.from_pylist([[1, 2], None, []], JT.INT64),
            "s": JSt.from_pylist([{"a": 1, "b": "x"}, None,
                                  {"a": None, "b": "yz"}],
                                 {"a": JT.INT32, "b": JT.STRING})})
        tb = to_port(jb)
        assert [repr(c.dtype) for c in tb.columns] == \
            [repr(c.dtype) for c in jb.columns]
        back = batch_to_numpy(tb)
        np.testing.assert_array_equal(back["d"][0],
                                      np.asarray(jb["d"].limbs))
        offs, (child, cvalid) = back["l"][0]
        np.testing.assert_array_equal(offs, np.asarray(jb["l"].offsets))
        np.testing.assert_array_equal(child, np.asarray(jb["l"].child.data))
        assert set(back["s"][0]) == {"a", "b"}
        again = batch_from_numpy({n: host_form(jb[n]) for n in jb.names},
                                 device="cpu")
        assert again["s"].field("b").to_pylist() == ["x", None, "yz"]
        with pytest.raises(ValueError, match="limbs"):
            batch_from_numpy({"d": (np.zeros((3,), np.uint64),
                                    np.ones(3, bool), "decimal(9,2)")},
                             device="cpu")


@pytest.mark.parametrize("p,s", [(7, 2), (18, 0), (38, 2)])
def test_radix_key_words(p, s):
    rng = np.random.default_rng(p)
    vals = unscaled(rng, 300, p, specials=_specials(p))
    jc = jdecimal(vals, p, s)
    tc = port_col(jc)
    for eq in (False, True):
        jw = JK.column_radix_keys(jc, equality=eq)
        tw = TK.column_radix_keys(tc, equality=eq)
        assert len(tw) == len(jw) == (2 if p <= 18 else 4)
        for a, b in zip(tw, jw):
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(b).astype(np.int64))


def _dec_batch(rng, n):
    return JBatch({
        "d": jdecimal(unscaled(rng, n - 9, 38, specials=_specials(38)),
                      38, 2),
        "p": jdecimal(unscaled(rng, n - 9, 7, nulls=0.1,
                               specials=_specials(7)), 7, 2),
        "i": JColumn(jnp.asarray(rng.integers(0, 5, n).astype(np.int32)),
                     jnp.asarray(rng.random(n) > 0.1), JT.INT32)})


def test_gather_decimal_with_valid_mask():
    rng = np.random.default_rng(41)
    jb = _dec_batch(rng, 200)
    idx = rng.integers(0, 200, 150).astype(np.int32)
    valid = rng.random(150) > 0.3
    jr = JG.gather_batch(jb, jnp.asarray(idx), jnp.asarray(valid))
    tr = TG.gather_batch(to_port(jb), torch.from_numpy(idx),
                         torch.from_numpy(valid))
    for name in jb.names:
        assert_col_equal(jr[name], tr[name], msg=name)


@pytest.mark.parametrize("ascending,nulls_first",
                         [(True, True), (False, True), (True, False),
                          (False, False)])
def test_sort_by_decimal_keys(ascending, nulls_first):
    rng = np.random.default_rng(43)
    jb = _dec_batch(rng, 300)
    jkeys = [JS.SortKey("p", ascending, nulls_first),
             JS.SortKey("d", not ascending, nulls_first)]
    tkeys = [TS.SortKey("p", ascending, nulls_first),
             TS.SortKey("d", not ascending, nulls_first)]
    jr = JS.sort_by(jb, jkeys)
    tr = TS.sort_by(to_port(jb), tkeys)
    for name in jb.names:
        assert_col_equal(jr[name], tr[name], msg=name)


def _q3dec_arrays(n, seed=11):
    """``_q3_batches``' recipe (keys into a dense dim of n / 4 rows, five
    segments), with TPC-H lineitem's extended price decimal(12,2) and
    discount decimal(12,2) in [0.00, 0.10]."""
    rng = np.random.default_rng(seed)
    nd = max(n // 4, 1)
    return {"k": rng.integers(0, nd, n).astype(np.int32),
            "seg": rng.integers(0, 5, n).astype(np.int32),
            "price": rng.integers(90_000, 10_500_000, n),
            "disc": rng.integers(0, 11, n),
            "nd": nd}


def _q3dec(mod, D, fact, dim, dec):
    """rev = price * (1 - disc) at Spark's scales (1 - disc at scale 2,
    the product at 4), joined to the dim."""
    one = dec([1] * fact.num_rows, 1, 0)
    _, one_minus = D.sub_decimal128(one, fact["disc"], 2)
    _, rev = D.multiply_decimal128(fact["price"], one_minus, 4)
    fact = fact.with_column("rev", rev)
    joined, count = mod[0].join_dense_or_hash(fact, dim, "k", "k",
                                              dim.num_rows)
    return joined, count


def test_q3dec_composes_like_the_reference():
    n = 4000
    a = _q3dec_arrays(n)
    ones = np.ones(n, bool)

    def limbs(v):
        return np.stack([v.astype(np.uint64),
                         np.where(v < 0, np.uint64(2 ** 64 - 1),
                                  np.uint64(0))], 1)

    jfact = JBatch({
        "k": JColumn(jnp.asarray(a["k"]), jnp.asarray(ones), JT.INT32),
        "seg": JColumn(jnp.asarray(a["seg"]), jnp.asarray(ones), JT.INT32),
        "price": jdecimal([int(x) for x in a["price"]], 12, 2),
        "disc": jdecimal([int(x) for x in a["disc"]], 12, 2)})
    nd = a["nd"]
    jdim = JBatch({"k": JColumn(jnp.arange(nd, dtype=jnp.int32),
                                jnp.ones((nd,), jnp.bool_), JT.INT32)})
    tfact, tdim = to_port(jfact), to_port(jdim)
    np.testing.assert_array_equal(tfact["price"].limbs.numpy().view(
        np.uint64), limbs(a["price"]))

    jj, jc = _q3dec((JJ,), JD, jfact, jdim, jdecimal)
    tj, tc = _q3dec((TJ,), TD, tfact, tdim,
                    lambda v, p, s: Decimal128Column.from_unscaled(
                        v, p, s, device="cpu"))
    assert int(jc) == int(tc) == n
    assert_col_equal(jj["rev"], tj["rev"], rows=n, msg="rev")
    aggs = [("sum", "rev", "rev_sum"), ("count", None, "cnt")]
    jr, jng = JAgg.group_by_domain_or_sort(
        jj, "seg", [JAgg.AggSpec(*x) for x in aggs], 5,
        row_valid=jnp.arange(n) < jc)
    tr, tng = TAgg.group_by_domain_or_sort(
        tj, "seg", [TAgg.AggSpec(*x) for x in aggs], 5,
        row_valid=torch.arange(n) < tc)
    assert int(jng) == int(tng) == 5
    for name in ("seg", "rev_sum", "cnt"):
        assert_col_equal(jr[name], tr[name], rows=5, msg=name)
    # the ops type their results decimal(38, scale), as the reference's
    assert repr(tr["rev_sum"].dtype) == "decimal(38,4)"
    # and the Python oracle: sum(price * (100 - disc)) per segment
    want = [sum(int(p) * (100 - int(d)) for p, d, s in
                zip(a["price"], a["disc"], a["seg"]) if s == g)
            for g in range(5)]
    assert tr["rev_sum"].to_pylist()[:5] == want

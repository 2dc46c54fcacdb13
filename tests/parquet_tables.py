"""Tables the Parquet parity tests write: every nested shape the
reference reads (:func:`nested_table`), strings written from Arrow
dictionaries (:func:`dictionary_string_table`) and the harness writer's
columns (:func:`harness_columns`).  Shared by
``test_torch_parquet_nested.py`` and ``test_torch_parquet_decode.py``
(whose committed fixtures use them)."""

import decimal

import numpy as np
import pyarrow as pa

import parquet_writer as PW


def _list(rng, n, values, p_null=0.12, max_len=4, p_empty=0.12):
    """A list array of ``n`` rows over ``values`` (consumed in order):
    nulls, empty lists and 1..``max_len`` elements."""
    lens = rng.integers(1, max_len + 1, n)
    lens[rng.random(n) < p_empty] = 0
    null = rng.random(n) < p_null
    lens[null] = 0
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return offsets, null, values(int(offsets[-1]))


def _inner(offsets, null, values):
    return pa.ListArray.from_arrays(pa.array(offsets),
                                    pa.array(values, pa.int64()),
                                    mask=pa.array(null))


def _large(offsets, null, values):
    return pa.LargeListArray.from_arrays(
        pa.array(offsets.astype(np.int64)), pa.array(values, pa.int64()),
        mask=pa.array(null))


def nested_table(n: int, seed: int) -> pa.Table:
    """Every nested shape the reference reads, with nulls at each level."""
    rng = np.random.default_rng(seed)

    def lst(values, typ, **kw):
        offsets, null, vals = _list(rng, n, values, **kw)
        return pa.ListArray.from_arrays(pa.array(offsets), pa.array(vals, typ)
                                        if not isinstance(vals, pa.Array)
                                        else vals, mask=pa.array(null))

    def ints(m, lo=-1000, hi=1000, p=0.1):
        return pa.array(rng.integers(lo, hi, m), pa.int32(),
                        mask=rng.random(m) < p)

    def strs(m, p=0.1):
        return pa.array([f"s{int(x)}-" + "ab" * int(x % 5)
                         for x in rng.integers(0, 50, m)], pa.string(),
                        mask=rng.random(m) < p)

    def mask(p=0.1):
        return pa.array(rng.random(n) < p)

    cols = {
        "li": lst(lambda m: ints(m), pa.int32()),
        "ls": lst(lambda m: strs(m), pa.string()),
        "st": pa.StructArray.from_arrays([ints(n), strs(n)], ["a", "b"],
                                         mask=mask()),
        "lst": lst(lambda m: pa.StructArray.from_arrays(
            [pa.array(rng.integers(-10 ** 12, 10 ** 12, m), pa.int64(),
                      mask=rng.random(m) < 0.1), strs(m)], ["x", "y"],
            mask=pa.array(rng.random(m) < 0.1)), None),
        "stl": pa.StructArray.from_arrays(
            [lst(lambda m: ints(m), pa.int32()),
             pa.array(rng.integers(0, 10 ** 9, n), pa.int64())], ["v", "w"],
            mask=mask()),
        "ll": lst(lambda m: _inner(*_list(
            rng, m, lambda k: rng.integers(-5, 5, k))), None),
        "ldec": lst(lambda m: pa.array(
            [decimal.Decimal(int(x)).scaleb(-2)
             for x in rng.integers(-10 ** 9, 10 ** 9, m)],
            pa.decimal128(10, 2), mask=rng.random(m) < 0.1), None),
        "lb": lst(lambda m: pa.array(rng.random(m) < 0.5, pa.bool_(),
                                     mask=rng.random(m) < 0.1), None),
        "lts": lst(lambda m: pa.array(rng.integers(-10 ** 15, 10 ** 15, m),
                                      pa.timestamp("us", tz="UTC")), None),
        "large": _large(*_list(rng, n,
                               lambda k: rng.integers(0, 10 ** 6, k))),
        "empty": pa.ListArray.from_arrays(
            pa.array(np.zeros(n + 1, np.int32)), pa.array([], pa.int32()),
            mask=mask(0.5)),
        "allnull": pa.array([None] * n, pa.list_(pa.int32())),
        "sreq": pa.StructArray.from_arrays(
            [pa.array(rng.integers(0, 100, n), pa.int32())],
            fields=[pa.field("a", pa.int32(), nullable=False)],
            mask=mask()),
        "stdec": pa.StructArray.from_arrays(
            [pa.array([decimal.Decimal(int(a) * 10 ** 18 + int(b))
                       .scaleb(-6) for a, b in
                       zip(rng.integers(-10 ** 13, 10 ** 13, n),
                           rng.integers(0, 10 ** 18, n))],
                      pa.decimal128(38, 6), mask=rng.random(n) < 0.1)],
            ["d"], mask=mask()),
        "flat": pa.array(np.arange(n, dtype=np.int64) * 3),
    }
    return pa.table(cols)


def dictionary_string_table(n: int, seed: int) -> pa.Table:
    """Strings written from dictionary arrays, in a list, in a struct and
    at the top level (pyarrow restores their dictionary type)."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(12)]

    def pick(m, p=0.1):
        return pa.array([words[i] for i in rng.integers(0, 12, m)],
                        mask=rng.random(m) < p).dictionary_encode()

    offsets, null, vals = _list(rng, n, pick)
    return pa.table({
        "ldict": pa.ListArray.from_arrays(pa.array(offsets), vals,
                                          mask=pa.array(null)),
        "sdict": pa.StructArray.from_arrays(
            [pick(n)], ["f"], mask=pa.array(rng.random(n) < 0.1)),
        "tdict": pick(n),
        "ls": pa.array([[words[i]] for i in rng.integers(0, 12, n)])})


def harness_columns(n: int, seed: int) -> dict:
    """Columns for the harness writer: flat ints, doubles, strings and
    BYTE_ARRAY decimals, an OPTIONAL struct of OPTIONAL fields, an OPTIONAL
    list, a list of lists, and the legacy list forms."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    v = rng.integers(-2 ** 63, 2 ** 63, n, dtype=np.int64)
    v[:4] = [-2 ** 63, 2 ** 63 - 1, -2 ** 63, 0]  # deltas that wrap
    valid = rng.random(n) > 0.1
    lens = rng.integers(0, 5, n)
    offs = np.concatenate([[0], np.cumsum(lens)])
    m = int(offs[-1])
    tags = rng.integers(-100, 100, m).astype(np.int32)
    dec = [int(a) * 10 ** 18 + int(b) for a, b in
           zip(rng.integers(-10 ** 18, 10 ** 18, n, dtype=np.int64),
               rng.integers(0, 10 ** 18, n))]
    return {
        "k": (k, None), "v": (v, valid), "price": (rng.random(n), None),
        "s": PW.Struct({"a": (k, rng.random(n) > 0.05),
                        "b": (v, valid),
                        "c": PW.Decimal(dec, 38, 3, valid)},
                       rng.random(n) > 0.05),
        "tags": PW.List(offs, (tags, rng.random(m) > 0.2),
                        valid=rng.random(n) > 0.1),
        "ll": PW.List(offs, PW.List(np.arange(m + 1), (tags, None)),
                      valid=rng.random(n) > 0.3),
        "two": PW.List(offs, (tags, None), layout="2-level"),
        "bare": PW.List(offs, (tags, None), layout="repeated"),
        "arr": PW.List(offs, PW.Struct({"x": (tags, None)}),
                       valid=rng.random(n) > 0.2, layout="2-level"),
        "dec": PW.Decimal(dec, 38, 2, valid),
        "d9": PW.Decimal([int(x) for x in k], 9, 0),
        "str": ([f"s{i % 37}" for i in range(n)], valid),
    }

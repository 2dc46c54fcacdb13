"""PyTorch port: Spark-exact Murmur3_32 and XXHash64, against the goldens of
tests/test_hashing.py (Spark-derived, from the reference suite) and the
JAX package's functions on the same numpy inputs.  Hashes and partition
ids must be bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import StringColumn as JString
from spark_rapids_jni_tpu.ops import hashing as JH
from spark_rapids_jni_tpu.parallel.partition import \
    spark_partition_id as j_partition_id

from spark_rapids_jni_tpu_torch.columnar import types as TT
from spark_rapids_jni_tpu_torch.columnar.column import Column, StringColumn
from spark_rapids_jni_tpu_torch.ops import hashing as TH
from spark_rapids_jni_tpu_torch.parallel.partition import spark_partition_id

from torch_parity import jdecimal, port_col, unscaled

INT_MIN, INT_MAX = -(2**31), 2**31 - 1
F_NAN_BITS = [0x7F800001, 0x7FFFFFFF, 0xFF800001, 0xFFFFFFFF]
D_NAN_BITS = [0x7FF0000000000001, 0x7FFFFFFFFFFFFFFF, 0xFFF0000000000001,
              0xFFFFFFFFFFFFFFFF]
LONG_STR = (
    "A very long (greater than 128 bytes/char string) to test a multi "
    "hash-step data point in the MD5 hash function. This string needed to "
    "be longer.A 60 character string to test MD5's message padding "
    "algorithm")
MIXED_LONG_STR = (
    "A very long (greater than 128 bytes/char string) to test a multi "
    "hash-step data point in the MD5 hash function. This string needed to "
    "be longer.")
STRS = ["a", "B\nc", 'dE"Ā\tā 휠휡\\Fg2' "'", LONG_STR,
        "hiJ휠휡휠휡", None]


def _fixed(values, kind, np_dtype):
    """A column of ``values`` (``None`` = null; ints may be raw float bits)
    in both packages."""
    valid = np.array([v is not None for v in values], bool)
    vals = [0 if v is None else v for v in values]
    if np_dtype == np.float32:
        data = np.array([np.uint32(v).view(np.float32) if isinstance(v, int)
                         else np.float32(v) for v in vals], np.float32)
    elif np_dtype == np.float64:
        data = np.array([np.uint64(v).view(np.float64) if isinstance(v, int)
                         else np.float64(v) for v in vals], np.float64)
    else:
        data = np.array(vals, np_dtype)
    jt, tt = getattr(JT, kind), getattr(TT, kind)
    return (JColumn(jnp.asarray(data), jnp.asarray(valid), jt),
            Column(torch.from_numpy(data.copy()), torch.from_numpy(valid),
                   tt))


def _strings(values, max_len=None):
    j = JString.from_pylist(values, max_len=max_len)
    return j, StringColumn.from_pylist(values, max_len=max_len, device="cpu")


def _f64(vals):
    return _fixed(vals, "FLOAT64", np.float64)


def _f32(vals):
    return _fixed(vals, "FLOAT32", np.float32)


DOUBLES = [0.0, None, 100.0, -100.0, 2.2250738585072014e-308,
           1.7976931348623157e308] + D_NAN_BITS + [float("inf"),
                                                   float("-inf")]
FLOATS = [0.0, 100.0, -100.0, 1.17549435e-38, 3.4028235e38, None] \
    + F_NAN_BITS + [float("inf"), float("-inf")]

# (case, columns builder, murmur3 seed, murmur3 golden, xxhash64 golden)
GOLDENS = [
    ("strings", lambda: [_strings(STRS)], 42,
     [1485273170, 1709559900, 1423943036, 176121990, 1199621434, 42],
     [-8582455328737087284, 2221214721321197934, 5798966295358745941,
      -4834097201550955483, -3782648123388245694, 42]),
    ("ints_two_columns", lambda: [
        _fixed([0, 100, None, None, INT_MIN, None], "INT32", np.int32),
        _fixed([0, None, -100, None, None, INT_MAX], "INT32", np.int32)], 42,
     [59727262, 751823303, -1080202046, 42, 723455942, 133916647],
     [1151812168208346021, -7987742665087449293, 8990748234399402673, 42,
      2073849959933241805, 1508894993788531228]),
    ("doubles", lambda: [_f64(DOUBLES)], 0,
     [1669671676, 0, -544903190, -1831674681, 150502665, 474144502]
     + [1428788237] * 4 + [420913893, 1915664072],
     [-5252525462095825812, 42, -7996023612001835843, 5695175288042369293,
      6181148431538304986, -4222314252576420879]
     + [-3127944061524951246] * 4 + [5810986238603807492,
                                      5326262080505358431]),
    ("timestamps", lambda: [_fixed(
        [0, None, 100, -100, 0x123456789ABCDEF, None, -0x123456789ABCDEF],
        "TIMESTAMP", np.int64)], 42,
     [-1670924195, 42, 1114849490, 904948192, 657182333, 42, -57193045],
     [-5252525462095825812, 42, 8713583529807266080, 5675770457807661948,
      1941233597257011502, 42, -1318946533059658749]),
    ("dates", lambda: [_fixed(
        [0, None, 100, -100, 0x12345678, None, -0x12345678], "DATE",
        np.int32)], 42,
     [933211791, 42, 751823303, -1080202046, -1721170160, 42, 1852996993],
     [3614696996920510707, 42, -7987742665087449293, 8990748234399402673,
      6954428822481665164, 42, -4294222333805341278]),
    ("floats", lambda: [_f32(FLOATS)], 411,
     [-235179434, 1812056886, 2028471189, 1775092689, -1531511762, 411]
     + [-1053523253] * 4 + [-1526256646, 930080402],
     [3614696996920510707, -8232251799677946044, -6625719127870404449,
      -6699704595004115126, -1065250890878313112, 42]
     + [2692338816207849720] * 4 + [-5940311692336719973,
                                     -7580553461823983095]),
    ("bools_two_columns", lambda: [
        _fixed([None, True, False, True, None, False], "BOOLEAN", np.bool_),
        _fixed([None, True, False, None, False, True], "BOOLEAN",
               np.bool_)], 0,
     [0, -1589400010, -239939054, -68075478, 593689054, -1194558265],
     [42, 9083826852238114423, 1151812168208346021, -6698625589789238999,
      3614696996920510707, 7945966957015589024]),
    ("mixed_five_columns", lambda: [
        _strings(["a", "B\n", 'dE"Ā\tā 휠휡',
                  MIXED_LONG_STR, None, None]),
        _fixed([0, 100, -100, INT_MIN, INT_MAX, None], "INT32", np.int32),
        _f64([0.0, 100.0, -100.0, D_NAN_BITS[0], D_NAN_BITS[1], None]),
        _f32([0.0, 100.0, -100.0, F_NAN_BITS[2], F_NAN_BITS[3], None]),
        _fixed([True, False, None, False, True, None], "BOOLEAN",
               np.bool_)], 1868,
     [1936985022, 720652989, 339312041, 1400354989, 769988643, 1868],
     None),
]


@pytest.mark.parametrize("case,build,seed,mm3,xxh", GOLDENS,
                         ids=[g[0] for g in GOLDENS])
def test_goldens_and_reference(case, build, seed, mm3, xxh):
    pairs = build()
    jcols = [j for j, _ in pairs]
    tcols = [t for _, t in pairs]
    got = TH.murmur_hash3_32(tcols, seed=seed).data.tolist()
    assert got == mm3
    assert got == JH.murmur_hash3_32(jcols, seed=seed).to_pylist()
    gx = TH.xxhash64(tcols).data.tolist()
    assert gx == JH.xxhash64(jcols).to_pylist()
    if xxh is not None:
        assert gx == xxh


@pytest.mark.parametrize("kind,np_dtype", [
    ("INT8", np.int8), ("INT16", np.int16), ("INT32", np.int32),
    ("INT64", np.int64), ("TIMESTAMP", np.int64), ("DATE", np.int32),
    ("FLOAT32", np.float32), ("FLOAT64", np.float64), ("BOOLEAN", np.bool_)])
def test_random_values_every_fixed_type(kind, np_dtype, rng):
    n = 700
    if np_dtype == np.bool_:
        vals = rng.random(n) > 0.5
    elif np.issubdtype(np_dtype, np.floating):
        vals = (rng.standard_normal(n) * 1e6).astype(np_dtype)
        vals[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, -np.nan]
    else:
        info = np.iinfo(np_dtype)
        vals = rng.integers(info.min, info.max, n, dtype=np_dtype,
                            endpoint=True)
    valid = rng.random(n) > 0.1
    jc = JColumn(jnp.asarray(vals), jnp.asarray(valid), getattr(JT, kind))
    tc = Column(torch.from_numpy(vals.copy()), torch.from_numpy(valid),
                getattr(TT, kind))
    for seed in (0, 42, -7):
        assert TH.murmur_hash3_32([tc], seed=seed).data.tolist() == \
            JH.murmur_hash3_32([jc], seed=seed).to_pylist()
        assert TH.xxhash64([tc], seed=seed).data.tolist() == \
            JH.xxhash64([jc], seed=seed).to_pylist()


@pytest.mark.parametrize("width", [1, 3, 8, 31, 32, 33, 70])
def test_random_strings_every_length_class(width, rng):
    n = 300
    lens = rng.integers(0, width + 1, n)
    lens[:2] = [0, width]
    chars = rng.integers(0, 256, (n, width)).astype(np.uint8)
    chars[np.arange(width)[None, :] >= lens[:, None]] = 0
    valid = rng.random(n) > 0.1
    jc = JString(jnp.asarray(chars), jnp.asarray(lens.astype(np.int32)),
                 jnp.asarray(valid))
    tc = StringColumn(torch.from_numpy(chars), torch.from_numpy(
        lens.astype(np.int32)), torch.from_numpy(valid))
    assert TH.murmur_hash3_32([tc]).data.tolist() == \
        JH.murmur_hash3_32([jc]).to_pylist()
    assert TH.xxhash64([tc]).data.tolist() == JH.xxhash64([jc]).to_pylist()


def test_partition_ids_over_string_and_mixed_keys(rng):
    n = 500
    vals = [None if rng.random() < 0.1 else f"cat-{rng.integers(0, 40)}"
            for _ in range(n)]
    js, ts = _strings(vals, max_len=12)
    jf, tf = _f32(list((rng.standard_normal(n) * 10).astype(np.float32)))
    live = rng.random(n) > 0.2
    for P in (8, 200):
        want = np.asarray(j_partition_id([js, jf], P, jnp.asarray(live)))
        got = spark_partition_id([ts, tf], P, torch.from_numpy(live))
        np.testing.assert_array_equal(got.numpy(), want)


def test_unported_types_raise():
    from spark_rapids_jni_tpu_torch.columnar.column import ColumnBatch

    with pytest.raises(ValueError, match="at least 1 column"):
        TH.murmur_hash3_32([])
    _, a = _fixed([1, 2], "INT32", np.int32)
    _, b = _fixed([1], "INT32", np.int32)
    with pytest.raises(ValueError, match="row count mismatch"):
        TH.xxhash64(ColumnBatch({"a": a}).columns + (b,))
    with pytest.raises(TypeError, match="hash of object"):
        TH.murmur_hash3_32([object()])


# ---------------------------------------------------------------------------
# decimals and nested columns
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", [7, 18, 19, 38])
def test_decimal_hashes(precision, rng):
    """Up to 18 digits the unscaled long; above, the minimal big-endian
    BigInteger bytes (one byte for 0 and -1, a sign-pad byte at 0x80
    boundaries, 16 for +-(10^38 - 1))."""
    top = 10 ** precision - 1
    special = [0, -1, 1, 127, 128, -128, -129, 255, 256, 2 ** 63,
               -(2 ** 63), top, -top]
    vals = unscaled(rng, 400, precision, specials=[
        v for v in special if abs(v) <= top])
    jc = jdecimal(vals, precision, 2)
    tc = port_col(jc)
    for seed in (0, 42):
        assert TH.murmur_hash3_32([tc], seed=seed).data.tolist() == \
            JH.murmur_hash3_32([jc], seed=seed).to_pylist()
        assert TH.xxhash64([tc], seed=seed).data.tolist() == \
            JH.xxhash64([jc], seed=seed).to_pylist()
    if precision > 18:
        tb, tl = TH.decimal128_java_bytes(tc)
        for v, b, ln in zip(vals, tb.numpy(), tl.numpy()):
            if v is not None:
                # Java's BigInteger.bitLength() / 8 + 1 bytes
                bits = (v if v >= 0 else ~v).bit_length()
                want = v.to_bytes(bits // 8 + 1, "big", signed=True)
                assert bytes(b[:ln]) == want


def _nested_columns(rng):
    from spark_rapids_jni_tpu.columnar.column import ListColumn as JL
    from spark_rapids_jni_tpu.columnar.column import StructColumn as JSt

    ints = JL.from_pylist([[1, 2, 3], None, [], [INT_MIN], [7] * 9,
                           [None, 4]], JT.INT32)
    strs = JL.from_pylist([["a", None], ["bcd" * 5], None, [], ["x"],
                           [LONG_STR]], JT.STRING)
    inner = JL.from_pylist([[1], [2, 3], [], None, [4, 5, 6]], JT.INT64)
    nested = JL(jnp.asarray(np.array([0, 2, 2, 3, 5, 5, 5], np.int32)),
                inner, jnp.asarray(np.array([1, 1, 0, 1, 1, 1], bool)))
    decs = JL(jnp.asarray(np.array([0, 1, 3, 3, 4, 6, 6], np.int32)),
              jdecimal([5, -(10 ** 37), None, 10 ** 20, 0, -1], 38, 2),
              jnp.asarray(np.ones(6, bool)))
    structs_in_list = JL(
        jnp.asarray(np.array([0, 2, 3, 3, 3, 4, 6], np.int32)),
        JSt.from_pylist([{"a": 1}, None, {"a": 3}, {"a": None}, {"a": 5},
                         {"a": 6}], {"a": JT.INT32}),
        jnp.asarray(np.array([1, 1, 1, 0, 1, 1], bool)))
    struct = JSt.from_pylist([{"a": 1, "b": "x"}, None, {"a": None,
                                                          "b": "yz"},
                              {"a": 4, "b": None}, {"a": -5, "b": ""},
                              {"a": 6, "b": "w" * 40}],
                             {"a": JT.INT64, "b": JT.STRING})
    struct_of_list = JSt({"l": ints, "d": jdecimal([1, 2, None, 4, 5, 6],
                                                   20, 0)},
                         jnp.asarray(np.array([1, 1, 1, 0, 1, 1], bool)))
    return {"list_int32": ints, "list_string": strs,
            "list_list_int64": nested, "list_decimal38": decs,
            "list_struct": structs_in_list, "struct": struct,
            "struct_of_list": struct_of_list}


@pytest.mark.parametrize("name", ["list_int32", "list_string",
                                  "list_list_int64", "list_decimal38",
                                  "list_struct", "struct",
                                  "struct_of_list"])
def test_nested_hashes(name, rng):
    """Lists fold their elements into the running hash (null elements and
    rows pass the seed through); structs hash as their leaves, a null
    struct nulling them; both after a plain column in the same row hash."""
    jc = _nested_columns(rng)[name]
    tc = port_col(jc)
    jlead, tlead = _fixed([3, None, -9, 12, 0, 1], "INT32", np.int32)
    for cols_j, cols_t in (([jc], [tc]), ([jlead, jc], [tlead, tc])):
        for seed in (0, 42):
            assert TH.murmur_hash3_32(cols_t, seed=seed).data.tolist() == \
                JH.murmur_hash3_32(cols_j, seed=seed).to_pylist()
    if name.startswith("struct") and name != "struct_of_list":
        assert TH.xxhash64([tc]).data.tolist() == \
            JH.xxhash64([jc]).to_pylist()
    else:
        with pytest.raises(NotImplementedError, match="LIST"):
            TH.xxhash64([tc])

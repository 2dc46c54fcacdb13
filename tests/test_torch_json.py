"""PyTorch port: ``get_json_object`` (``ops/get_json_object.py`` and the
fast engine ``ops/json_fast.py``) against the JAX package and against
the pure-Python oracle ``tests/json_oracle.py``.

Three fixed batches of one shape (24 documents, 64 bytes wide: mixed
documents with scattered dirty rows, every row dirty, nulls beside dirty
rows) go through the JAX package's scan machine once per path (module
fixtures: each new (rows, width, path) costs the JAX package a compile)
and through every engine of the port: the serial scan machine
(``json_fast_path`` off), the whole-batch hybrid (``json_fallback_div``
0) and the compact hybrid (div 2, 8, 64).  Bytes, lengths and validity
must be bit-identical.  A seeded fuzz holds the port's engines against
the oracle."""

from concurrent import futures

import numpy as np
import pytest

from spark_rapids_jni_tpu import config as jconfig
from spark_rapids_jni_tpu.columnar.column import StringColumn as JString
from spark_rapids_jni_tpu.ops.get_json_object import \
    get_json_object as jget

from spark_rapids_jni_tpu_torch import config
from spark_rapids_jni_tpu_torch.columnar.column import StringColumn
from spark_rapids_jni_tpu_torch.ops import get_json_object as TG
from spark_rapids_jni_tpu_torch.ops import json_fast as TF

import json_oracle
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

WIDTH = 64

MIXED = [
    '{"owner":"amya1","a":[1,2.5,{"b":-0}],"c":"x\\ny"}',
    "{'owner': 'q', 'a': [1, 2]}",
    '{"owner": null, "a": 7}',
    '{"a\\u0062c": 1, "owner":"\\u0079o", "a": [0]}',
    '[1, [2, 3], {"a": 1e400}]',
    '{"owner": 1.50e-3, "a": [1.0, 2e5, -0.0]}',
    "not json",
    None,
    '{"a": {"b": [true, false, null]}}',
    '{"owner": "\\t\\"q\\"", "a": "s"}',
    '{"a":[{"b":1},{"b":2.0},{"c":3}]}',
    '  {"owner" : [ 1 , 2 ] , "a" : { } }  ',
    '{"a": 01}',
    '{"owner": -0, "a": [[1, 2], [3, 4]]}',
    '{"owner":"é","a":["x","y"]}',
    '{"owner":{"x":"\\u00e9","y":[1e-3]}}',
    '{"a":[100.000, 2E-2, 1e+2]}',
    '{"owner":"amya2"} trailing junk',
    '{"a": [1, 2,]}',
    '"just a string"',
    '{"owner": true, "a": false}',
    '{"a": [[], [1], [[2]]], "owner": "z"}',
    '{"owner": "\\u0041\\u00DF\\u20AC", "a": 1}',
    "",
]
DIRTY = [  # every row outside the fast engine's accept list
    '{"a": "esc\\nape", "owner": "o1"}',
    "{'single': 1, 'owner': 'o2'}",
    '{"a\\u0062c": 1, "owner": "o3"}',
    '{"owner": "\\u0079es", "a": [1, 2]}',
    "{'a': [1, 2.5], 'owner': null}",
    '{"a": [{"b": "\\"q\\""}], "owner": 3}',
] * 4
NULLS_BESIDE_DIRTY = [None if i % 3 == 1 else d
                      for i, d in enumerate(MIXED[:12] + DIRTY[:12])]
BATCHES = {"mixed": MIXED, "all_dirty": DIRTY,
           "nulls_beside_dirty": NULLS_BESIDE_DIRTY}
PATHS = ["$.owner", "$.a", "$.a[1]", "$.a[*]", "$.a[*].b", "$[*]"]
# serial scan machine, whole-batch hybrid, compact hybrid at div 2, 8, 64
ENGINES = [(False, 16), (True, 0), (True, 2), (True, 8), (True, 64)]


def _jcol(docs):
    return JString.from_pylist(docs, max_len=WIDTH)


def _tcol(docs):
    return StringColumn.from_pylist(docs, max_len=WIDTH, device="cpu")


@pytest.fixture(scope="module")
def reference():
    """Every (batch, path) through the JAX package's scan machine.  The
    three batches share one shape, so each path compiles once; at
    ``json_scan_unroll`` 1 the compile takes about half the default's
    (2) time, and the machine's output is the same bytes.  The paths
    compile on threads at once (XLA compiles outside the GIL)."""
    def one_path(path):
        out = {}
        for name, docs in BATCHES.items():
            r = jget(_jcol(docs), path)
            out[name, path] = tuple(np.asarray(x) for x in
                                    (r.chars, r.lengths, r.validity))
        return out

    jconfig.set("json_fast_path", False)
    jconfig.set("json_scan_unroll", 1)
    try:
        with futures.ThreadPoolExecutor(len(PATHS)) as pool:
            out = {}
            for part in pool.map(one_path, PATHS):
                out.update(part)
        return out
    finally:
        jconfig.reset("json_fast_path")
        jconfig.reset("json_scan_unroll")


def _port(docs, path, fast, div):
    config.set("json_fast_path", fast)
    config.set("json_fallback_div", div)
    try:
        return TG.get_json_object(_tcol(docs), path)
    finally:
        config.reset("json_fast_path")
        config.reset("json_fallback_div")


def _engines(name, path):
    """Wildcard paths never take the fast engine: the serial machine only.
    The compact hybrid's small chunks rerun the scan machine once per
    chunk, so the all-dirty batches take one chunk size, the mixed one
    all three."""
    if "*" in path:
        return ENGINES[:1]
    return ENGINES if name == "mixed" else ENGINES[:3]


@pytest.mark.parametrize("name", list(BATCHES))
@pytest.mark.parametrize("path", PATHS)
def test_every_engine_bit_for_bit(reference, name, path):
    chars, lengths, validity = reference[name, path]
    for fast, div in _engines(name, path):
        t = _port(BATCHES[name], path, fast, div)
        what = f"{name} {path} fast={fast} div={div}"
        np.testing.assert_array_equal(t.chars.numpy(), chars, what)
        np.testing.assert_array_equal(t.lengths.numpy(), lengths, what)
        np.testing.assert_array_equal(t.validity.numpy(), validity, what)


@pytest.mark.parametrize("path", ["$.owner", "$.a[*]"])
def test_doubling_scans_bit_for_bit(reference, monkeypatch, path):
    """The row scans' doubling form (taken on large batches) through the
    whole path, forced on at this size."""
    from spark_rapids_jni_tpu_torch.ops import _util

    monkeypatch.setattr(_util, "_DOUBLING_MIN_NUMEL", 1)
    chars, lengths, validity = reference["mixed", path]
    t = _port(MIXED, path, True, 2)
    np.testing.assert_array_equal(t.chars.numpy(), chars)
    np.testing.assert_array_equal(t.lengths.numpy(), lengths)
    np.testing.assert_array_equal(t.validity.numpy(), validity)


def test_fast_engine_flags_exactly_the_dirty_rows():
    col = _tcol(DIRTY + MIXED[:4])
    fb = TF.fast_path(col.chars, col.lengths, col.validity,
                      (("named", b"owner"),), 6 * WIDTH + 20)[3]
    assert fb[:len(DIRTY)].all()
    clean = [d is not None and "\\" not in d and "'" not in d
             for d in MIXED[:4]]
    assert fb[len(DIRTY):].tolist() == [not c for c in clean]


def test_compact_fallback_runs_the_scan_machine_once_per_chunk():
    docs = (MIXED[:8] * 8)[:64]
    for k in range(1, 64, 9):
        docs[k] = DIRTY[k % len(DIRTY)]
    col = _tcol(docs)
    flagged = int(TF.fast_path(col.chars, col.lengths, col.validity,
                               (("named", b"owner"),), 6 * WIDTH + 20)[3]
                  .sum())
    for key in TG.HOST_SYNCS:
        TG.HOST_SYNCS[key] = 0
    got = _port(docs, "$.owner", True, 16)   # chunks of 4 rows
    assert TG.HOST_SYNCS["n_flagged"] == 1
    assert TG.HOST_SYNCS["scan_runs"] == -(-flagged // 4) > 1
    assert got.to_pylist() == [json_oracle.get_json_object(d, "$.owner")
                               for d in docs]


def _rand_doc(rng, depth=0):
    k = int(rng.integers(0, 8 if depth < 3 else 6))
    if k == 0:
        return str(rng.choice(["1", "-5", "0", "123456", "-0"]))
    if k == 1:
        return str(rng.choice(["1.5", "-0.25", "2e3", "1.25E-2", "100.000",
                               "1e-320", "7E+400"]))
    if k == 2:
        return str(rng.choice(["true", "false", "null"]))
    if k == 3:
        return str(rng.choice(['"ab"', "'c d'", '"x\\ny"', '"\\u0041b"',
                               '"q\\"r"', "''", '"\\u00e9\\t"']))
    if k == 4:
        return str(rng.choice(['"', "{", "[1,", "01", "1.", "tru",
                               '{"a" 1}']))
    if k == 5:
        return str(rng.choice([" 1 ", "  {}  ", "[ ]"]))
    if k == 6:
        items = [_rand_doc(rng, depth + 1)
                 for _ in range(int(rng.integers(0, 3)))]
        return "[" + ",".join(items) + "]"
    names = ["a", "b", "k1", "zz"]
    fields = [f'"{names[int(rng.integers(0, 4))]}":{_rand_doc(rng, depth + 1)}'
              for _ in range(int(rng.integers(0, 3)))]
    return "{" + ",".join(fields) + "}"


FUZZ_PATHS = ["$", "$.a", "$.b.a", "$[1]", "$.a[0]", "$[*]", "$.a[*]",
              "$[*].a[*]"]


@pytest.mark.parametrize("path", FUZZ_PATHS)
def test_fuzz_against_the_oracle(path):
    rng = np.random.default_rng(42)
    docs = [_rand_doc(rng) for _ in range(160)]
    want = [json_oracle.get_json_object(d, path) for d in docs]
    for fast, div in (ENGINES[0], ENGINES[3]):
        got = _port(docs, path, fast, div).to_pylist()
        bad = [(d, g, w) for d, g, w in zip(docs, got, want) if g != w]
        assert not bad, (path, fast, div, bad[:3])


def test_path_depth_cap():
    doc = '{"a":' * 16 + "7" + "}" * 16
    deep16 = "$" + ".a" * 16
    col = StringColumn.from_pylist([doc], pad_to_multiple=16, device="cpu")
    got = TG.get_json_object(col, deep16).to_pylist()
    assert got == [json_oracle.get_json_object(doc, deep16)] == ["7"]
    with pytest.raises(ValueError):
        TG.get_json_object(col, deep16 + ".a")
    with pytest.raises(ValueError):
        jget(JString.from_pylist([doc], pad_to_multiple=16), deep16 + ".a")


def test_overlong_results_are_null():
    docs = ['{"a":"%s"}' % ("x" * n) for n in (1, 8, 9, 30)]
    config.set("json_max_out", 8)
    try:
        for fast, div in (ENGINES[0], ENGINES[2]):
            got = _port(docs, "$.a", fast, div).to_pylist()
            assert got == ["x", "x" * 8, None, None]
    finally:
        config.reset("json_max_out")


def test_parse_path_surface():
    assert TG.parse_path("$.a[3].b[*]['c d'].*") == [
        ("named", b"a"), ("index", 3), ("named", b"b"), ("wildcard",),
        ("named", b"c d"), ("wildcard",)]
    with pytest.raises(ValueError):
        TG.parse_path("$a")

"""PyTorch port: ``ops/from_json.py`` (``from_json_to_raw_map``) against
the JAX package, bit for bit, and the raw-token-event lanes it reads from
``ops/get_json_object.py``'s scan step.

One batch (the reference's MapUtilsTest vectors, UTF-8 keys and values,
invalid and non-object rows, nulls, ``{}``, the 13 minimal pairs, and
seeded random documents of nested objects and arrays) at one width goes
through the JAX package once (a module fixture: each new shape costs it
a compile) and through the port; offsets, row validity and the key and
value columns' bytes, lengths and validity must be identical, including
the child slots past the live pairs.  The goldens, ``json.loads`` keys
and the event flag's regression run on the port alone."""

import json

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar.column import StringColumn as JString
from spark_rapids_jni_tpu.ops.from_json import \
    from_json_to_raw_map as jmap

from spark_rapids_jni_tpu_torch.columnar.column import StringColumn
from spark_rapids_jni_tpu_torch.ops import get_json_object as TG
from spark_rapids_jni_tpu_torch.ops.from_json import from_json_to_raw_map

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

WIDTH = 160

GOLDEN = [
    ('{"Zipcode" : 704 , "ZipCodeType" : "STANDARD" , "City" : "PARC'
     ' PARQUE" , "State" : "PR"}'),
    "{}",
    None,
    ('{"category": "reference", "index": [4,{},null,{"a":[{ }, {}] } '
     '], "author": "Nigel Rees", "title": "{}[], '
     '<=semantic-symbols-string", "price": 8.95}'),
    ('{"Zipcóde" : 704 , "ZípCodeTypé" : "\U00029E3D" , "City" : '
     '"\U0001F3F3" , "Stâte" : "\U0001F3F3"}'),
    '{"a":1',
    "[1,2]",
    "42",
    '{"k": true, "j": null}',
    '{"a": {"x": [1, 2]}, "b": [ {"y": "z"} ]}',
    "{" + ",".join(['"":%d' % (i % 10) for i in range(13)]) + "}",
    '{"e": "a\\"b\\u00e9", "f": -0.5e3, "g": [], "h": {}}',
    "  {'q': 1}  ",
    '{"dup": 1, "dup": 2}',
    '{"a": 1} trailing',
    '{"a": [1, 2,]}',
    "",
]


def _random_docs(rng, n):
    """Seeded objects of 1-6 top-level fields: scalars, strings, nested
    objects and arrays, some with whitespace."""
    def value(depth):
        k = int(rng.integers(0, 6 if depth < 2 else 4))
        if k == 0:
            return int(rng.integers(-999, 999))
        if k == 1:
            return "v%d" % int(rng.integers(0, 99))
        if k == 2:
            return [True, False, None][int(rng.integers(0, 3))]
        if k == 3:
            return round(float(rng.normal()), 3)
        if k == 4:
            return [value(depth + 1) for _ in range(int(rng.integers(0, 3)))]
        return {"n%d" % i: value(depth + 1)
                for i in range(int(rng.integers(0, 3)))}

    docs = []
    for _ in range(n):
        obj = {"k%d" % i: value(0) for i in range(int(rng.integers(1, 7)))}
        sep = (", ", ": ") if rng.random() < 0.5 else (",", ":")
        doc = json.dumps(obj, separators=sep)
        docs.append(doc if len(doc.encode()) <= WIDTH else "{}")
    return docs


DOCS = GOLDEN + _random_docs(np.random.default_rng(31), 47)


@pytest.fixture(scope="module")
def both():
    ref = jmap(JString.from_pylist(DOCS, max_len=WIDTH))
    port = from_json_to_raw_map(StringColumn.from_pylist(
        DOCS, max_len=WIDTH, device="cpu"))
    return ref, port


def _rows(out):
    """The port's map column as Python lists of (key, value) pairs."""
    offs = out.offsets.tolist()
    keys = out.child.field("key").to_pylist()
    vals = out.child.field("value").to_pylist()
    return [list(zip(keys[offs[i]:offs[i + 1]], vals[offs[i]:offs[i + 1]]))
            if v else None for i, v in enumerate(out.validity.tolist())]


def test_offsets_and_row_validity_bit_for_bit(both):
    ref, port = both
    np.testing.assert_array_equal(port.offsets.numpy(),
                                  np.asarray(ref.offsets))
    np.testing.assert_array_equal(port.validity.numpy(),
                                  np.asarray(ref.validity))
    assert port.offsets.dtype == torch.int32


@pytest.mark.parametrize("field", ["key", "value"])
def test_child_columns_bit_for_bit(both, field):
    ref, port = both
    jc, tc = ref.child.field(field), port.child.field(field)
    np.testing.assert_array_equal(tc.chars.numpy(), np.asarray(jc.chars))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    np.testing.assert_array_equal(tc.validity.numpy(),
                                  np.asarray(jc.validity))
    np.testing.assert_array_equal(port.child.validity.numpy(),
                                  np.asarray(ref.child.validity))


def test_reference_goldens(both):
    got = _rows(both[1])
    assert got[0] == [("Zipcode", "704"), ("ZipCodeType", "STANDARD"),
                      ("City", "PARC PARQUE"), ("State", "PR")]
    assert got[1] == [] and got[2] is None
    assert got[3] == [
        ("category", "reference"),
        ("index", '[4,{},null,{"a":[{ }, {}] } ]'),
        ("author", "Nigel Rees"),
        ("title", "{}[], <=semantic-symbols-string"),
        ("price", "8.95")]
    assert got[4] == [("Zipcóde", "704"), ("ZípCodeTypé", "\U00029E3D"),
                      ("City", "\U0001F3F3"), ("Stâte", "\U0001F3F3")]
    assert got[5] is None and got[6] is None and got[7] is None
    assert got[8] == [("k", "true"), ("j", "null")]
    assert got[9] == [("a", '{"x": [1, 2]}'), ("b", '[ {"y": "z"} ]')]
    assert len(got[10]) == 13 and got[10][0] == ("", "0")
    # strings stay raw: escapes are not decoded
    assert got[11] == [("e", 'a\\"b\\u00e9'), ("f", "-0.5e3"), ("g", "[]"),
                       ("h", "{}")]
    assert got[13] == [("dup", "1"), ("dup", "2")]


def test_keys_and_values_match_json_loads(both):
    got = _rows(both[1])
    for doc, row in zip(DOCS[len(GOLDEN):], got[len(GOLDEN):]):
        want = json.loads(doc)
        assert row is not None, doc
        assert [k for k, _ in row] == list(want), doc
        for (k, v), wv in zip(row, want.values()):
            assert json.loads(v if not isinstance(wv, str) else
                              json.dumps(wv)) == wv, (doc, k, v)


def test_capacity_bounds_the_child_slots():
    docs = ['{"a": 1, "b": 2}', '{"c": [3]}', None]
    col = StringColumn.from_pylist(docs, device="cpu")
    wide = from_json_to_raw_map(col)
    narrow = from_json_to_raw_map(col, max_pairs_per_row=1)
    assert narrow.child.num_rows == 3
    assert wide.child.num_rows == 3 * (col.max_len // 5 + 1)
    assert _rows(narrow) == _rows(wide) == [[("a", "1"), ("b", "2")],
                                            [("c", "[3]")], None]


def test_scan_events_flag_leaves_every_lane_unchanged():
    """``_step(events=True)`` adds the four raw token-event lanes and
    changes no carry lane and no emission lane, so ``get_json_object``
    (which leaves the flag off) scans as before."""
    docs = DOCS[:12]
    col = StringColumn.from_pylist(docs, max_len=WIDTH, device="cpu")
    n, L = col.chars.shape
    *tables, P = TG._pack_path(tuple(TG.parse_path("$.index[1]")),
                               torch.device("cpu"))
    packed = (P, *tables)
    c_off = TG._init_carry(col.lengths, n, torch.device("cpu"))
    c_on = dict(c_off)
    cpad = torch.cat([col.chars, torch.zeros((n, 1), dtype=torch.uint8)],
                     1).t()
    seen = torch.zeros((n,), dtype=torch.bool)
    for j in range(L + 1):
        c_off, y_off = TG._step(*packed, c_off, j, cpad[j])
        c_on, y_on = TG._step(*packed, c_on, j, cpad[j], events=True)
        assert set(y_on) - set(y_off) == {"ev_a", "ev_b", "span_s",
                                          "span_len"}
        for k, v in y_off.items():
            assert torch.equal(v, y_on[k]), (j, k)
        for k, v in c_off.items():
            assert torch.equal(v, c_on[k]), (j, k)
        seen |= y_on["ev_a"] != TG.EV_NONE
    assert bool(seen[[0, 3, 8]].all())

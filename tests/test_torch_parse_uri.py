"""PyTorch port: ``ops/parse_uri.py`` (Spark ``parse_url``) against the
JAX package, bit for bit, and against ``tests/uri_oracle.py``.

The reference's ParseURITest corpus (``tests/test_parse_uri.py``:
IPv4, IPv6, UTF-8, escapes, userinfo, ports, opaque and broken URIs,
nulls) plus a seeded fuzz of URLs goes through the JAX package for HOST
(every host validator), PROTOCOL (which a fatal row nulls) and QUERY
filtered by a key, at one shape (each (part, key) costs it a compile),
and through ``parse_uri_query_with_column``; bytes, lengths and validity
must be identical.  Every part (PROTOCOL, HOST, QUERY with and without
keys, PATH and the internal AUTHORITY, FRAGMENT, USERINFO, PORT, OPAQUE
chunks) runs on the port against the oracle over the same rows, and a
bucketed column against the flat one.

The oracle models the CUDA kernel, whose authority scan measures a
closing bracket one place off from a colon once userinfo is present
(``closingbracket = i - amp`` beside ``last_colon = i - amp - 1``), so a
port right after a bracketed host (``u@[::1]:80``) makes the whole URI
fatal there.  The JAX package compares absolute positions and keeps the
port; the port follows the JAX package (held bit for bit on those rows
by :func:`test_bit_for_bit`), and the oracle sweeps expect exactly these
rows to differ."""

import re

import numpy as np
import pytest

from spark_rapids_jni_tpu.columnar.column import StringColumn as JString
from spark_rapids_jni_tpu.ops.parse_uri import parse_uri as jparse
from spark_rapids_jni_tpu.ops.parse_uri import \
    parse_uri_query_with_column as jquery_col

from spark_rapids_jni_tpu_torch.columnar.bucketed import \
    BucketedStringColumn
from spark_rapids_jni_tpu_torch.columnar.column import StringColumn
from spark_rapids_jni_tpu_torch.ops.parse_uri import (
    parse_uri, parse_uri_query_with_column)

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

from tests import uri_oracle as U
from tests.test_parse_uri import KNOWN, TEST_DATA

PARTS = ["PROTOCOL", "HOST", "QUERY", "PATH", "AUTHORITY", "FRAGMENT",
         "USERINFO", "PORT", "OPAQUE"]
KEYS = ["query", "a", "param4", "cat", "invalid", "q", "x"]


def _fuzz(seed, n=300):
    """Seeded URLs built from a grammar of schemes, userinfo, hosts
    (names, IPv4, IPv6, bad ones), ports, paths, queries and fragments,
    with escapes and stray characters."""
    rng = np.random.default_rng(seed)

    def pick(xs):
        return xs[int(rng.integers(0, len(xs)))]

    out = []
    for _ in range(n):
        url = pick(["https://", "http://", "ftp://", "file:", "", "//",
                    "mailto:", "1http://", "h+t.p-s://"])
        if rng.random() < 0.2:
            url += pick(["user@", "u:p@", "a%20b@", "[x]@"])
        url += pick(["www.nvidia.com", "a-b.c", "192.168.0.1",
                     "256.1.1.1", "[::1]", "[fe80::1%eth0]", "[1:2:3]",
                     "-bad.com", "x..y", "h_st", "1.2.3", "nvidia.com.",
                     "", "ex%41mple.org", "é.com"])
        if rng.random() < 0.3:
            url += pick([":80", ":", ":8x", "::1"])
        url += pick(["", "/", "/p/q.html", "/a b", "/%7E/x", "/a%zz",
                     "/é", "//"])
        if rng.random() < 0.5:
            url += "?" + "&".join(
                pick(["q=1", "x=", "a=b%20c", "cat=12", "=5", "k",
                      "query=z&q=2", "x=y#z", "^=1"])
                for _ in range(int(rng.integers(1, 4))))
        if rng.random() < 0.2:
            url += pick(["#frag", "#", "#a#b", "#%41"])
        out.append(url)
    return out


CORPUS = TEST_DATA + _fuzz(51)
WIDTH = 192


def _jcol(rows):
    return JString.from_pylist(rows, pad_to_multiple=32)


def _tcol(rows):
    return StringColumn.from_pylist(rows, pad_to_multiple=32, device="cpu")


def _same(ref, got):
    np.testing.assert_array_equal(got.chars.numpy(), np.asarray(ref.chars))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_array_equal(got.validity.numpy(),
                                  np.asarray(ref.validity))


# userinfo, then a bracketed host with a port right after its bracket
_BRACKET_PORT = re.compile(r"//[^/?#]*@[^/?#]*\]:")


def _kernel_quirk(u):
    return u is not None and _BRACKET_PORT.search(u) is not None


@pytest.mark.parametrize("part,key", [("HOST", None), ("PROTOCOL", None),
                                      ("QUERY", "query")])
def test_bit_for_bit(part, key):
    _same(jparse(JString.from_pylist(CORPUS, max_len=WIDTH), part, key),
          parse_uri(StringColumn.from_pylist(CORPUS, max_len=WIDTH,
                                             device="cpu"), part, key))


def _against_oracle(part, key=None):
    col = StringColumn.from_pylist(CORPUS, max_len=WIDTH, device="cpu")
    got = parse_uri(col, part, key).to_pylist()
    want = [U.parse_uri(u, getattr(U, part), key) for u in CORPUS]
    bad = [(u, g, w) for u, g, w in zip(CORPUS, got, want)
           if g != w and not _kernel_quirk(u)]
    assert not bad, bad[:5]
    # the kernel's quirk makes the whole URI fatal in the oracle
    assert all(w is None for u, w in zip(CORPUS, want) if _kernel_quirk(u))


def test_fuzz_holds_the_kernel_quirk():
    """The fuzz reaches the quirk: rows the oracle makes fatal where the
    JAX package (and so the port) keeps a bracketed host."""
    quirky = [u for u in CORPUS if _kernel_quirk(u)]
    got = parse_uri(_tcol(quirky), "HOST").to_pylist()
    kept = [h for h in got if h is not None]
    assert kept and all(h.startswith("[") for h in kept), got
    assert all(U.parse_uri(u, U.HOST) is None for u in quirky)


@pytest.mark.parametrize("part", PARTS)
def test_every_part_against_oracle(part):
    _against_oracle(part)


@pytest.mark.parametrize("key", KEYS)
def test_query_key_against_oracle(key):
    _against_oracle("QUERY", key)


def test_java_uri_known_values():
    for url, part, expected in KNOWN:
        got = parse_uri(_tcol([url]), part).to_pylist()[0]
        assert got == expected, (url, part, got)


def test_fragment_cleared_on_empty_remainder():
    assert parse_uri(_tcol(["#bob"]), "FRAGMENT").to_pylist() == [None]


QWC_URIS = ["https://a.com/p?x=1&yy=2&z=3", "https://b.com/?yy=22",
            "http://c.com/no/query", "https://d.com/?x=&yy=7#frag", None,
            "https://e.com/?zz=9", "https://[::1]/?invalid=param&x=4"]
QWC_KEYS = ["x", "yy", "x", "yy", "x", None, "x"]


def test_query_with_column_bit_for_bit():
    ref = jquery_col(JString.from_pylist(QWC_URIS),
                     JString.from_pylist(QWC_KEYS))
    got = parse_uri_query_with_column(
        StringColumn.from_pylist(QWC_URIS, device="cpu"),
        StringColumn.from_pylist(QWC_KEYS, device="cpu"))
    _same(ref, got)
    assert got.to_pylist() == ["1", "22", None, "7", None, None, "4"]


def test_query_with_column_matches_literal_keys():
    keys = [KEYS[i % len(KEYS)] for i in range(len(CORPUS))]
    got = parse_uri_query_with_column(
        StringColumn.from_pylist(CORPUS, max_len=WIDTH, device="cpu"),
        StringColumn.from_pylist(keys, device="cpu")).to_pylist()
    want = [U.parse_uri(u, U.QUERY, k) for u, k in zip(CORPUS, keys)]
    assert [g for u, g in zip(CORPUS, got) if not _kernel_quirk(u)] == \
        [w for u, w in zip(CORPUS, want) if not _kernel_quirk(u)]


def test_bucketed_matches_flat():
    uris = ([f"https://h{i}.example.com:80/p{i}?q={i}#f" for i in range(30)]
            + ["https://long.example.com/" + "seg/" * 200, None,
               "not a uri"])
    flat = StringColumn.from_pylist(uris, pad_to_multiple=16, device="cpu")
    b = BucketedStringColumn.from_pylist(uris, device="cpu")
    for part in ("HOST", "PATH", "QUERY"):
        want = parse_uri(flat, part).to_pylist()
        assert want == [U.parse_uri(u, getattr(U, part)) for u in uris]
        got = parse_uri(b, part)
        assert isinstance(got, BucketedStringColumn)
        assert got.to_pylist() == want, part


def test_errors():
    col = _tcol(["http://a.com/"])
    with pytest.raises(ValueError):
        parse_uri(col, "NOPE")
    with pytest.raises(ValueError):
        parse_uri(col, "HOST", "k")
    with pytest.raises(ValueError):
        parse_uri_query_with_column(col, _tcol(["x", "y"]))

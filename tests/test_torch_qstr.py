"""PyTorch port: the qstr flagship (BASELINE.md config #4) against the JAX
package: ``pipelines.qstr_batch`` / ``qstr_step`` against
``__graft_entry__._qstr_batch`` / ``_qstr_step`` on the same seeds, bytes
and hit count bit for bit, clean and with dirty documents; and
``qstr_groupby_step`` against the same composition built from the JAX
package's ``group_by``."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from spark_rapids_jni_tpu import config as jconfig
from spark_rapids_jni_tpu.columnar import types as JT
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import ColumnBatch as JBatch
from spark_rapids_jni_tpu.columnar.column import StringColumn as JString
from spark_rapids_jni_tpu.ops import regex_rewrite as JR
from spark_rapids_jni_tpu.relational.aggregate import AggSpec as JAgg
from spark_rapids_jni_tpu.relational.aggregate import group_by as jgroup_by

from spark_rapids_jni_tpu_torch import pipelines as TP
from spark_rapids_jni_tpu_torch.columnar.column import ColumnBatch

import json_oracle
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

N = 256


def _same_tails(j, t):
    np.testing.assert_array_equal(t.chars.numpy(), np.asarray(j.chars))
    np.testing.assert_array_equal(t.lengths.numpy(), np.asarray(j.lengths))
    np.testing.assert_array_equal(t.validity.numpy(),
                                  np.asarray(j.validity))


def _jbatch(docs):
    return JBatch({"doc": JString.from_pylist(docs, pad_to_multiple=32)})


@pytest.fixture(scope="module")
def reference():
    """The JAX package's qstr step on the clean and the dirty batch (one
    shape: one compile), jitted as the reference's bench runs it, at
    ``json_scan_unroll`` 1, whose compile is shorter than the default's
    and whose output is the same bytes."""
    jconfig.set("json_scan_unroll", 1)
    try:
        step = jax.jit(ge._qstr_step)
        jb = ge._qstr_batch(N)
        tails, hits = step(jb)
        dirty = TP.qstr_docs(N, dirty_every=7)
        dtails, dhits = step(_jbatch(dirty))
    finally:
        jconfig.reset("json_scan_unroll")
    return jb, (tails, int(hits)), dirty, (dtails, int(dhits))


def test_batch_bytes_match(reference):
    jb = reference[0]
    tb = TP.qstr_batch(N, device="cpu")
    np.testing.assert_array_equal(tb["doc"].chars.numpy(),
                                  np.asarray(jb["doc"].chars))
    np.testing.assert_array_equal(tb["doc"].lengths.numpy(),
                                  np.asarray(jb["doc"].lengths))
    assert tb["doc"].max_len == 64


def test_qstr_step_bit_for_bit(reference):
    (jtails, jhits) = reference[1]
    tails, hits = TP.qstr_step(TP.qstr_batch(N, device="cpu"))
    _same_tails(jtails, tails)
    assert int(hits) == jhits == N
    assert tails.to_pylist()[:3] == ["a0", "a1", "a2"]


def test_qstr_step_with_dirty_documents(reference):
    docs, (jtails, jhits) = reference[2], reference[3]
    assert sum("\\u0079" in d for d in docs) and sum("'" in d for d in docs)
    ones = np.ones((N,), np.bool_)
    from spark_rapids_jni_tpu_torch.columnar.column import batch_from_numpy

    tb = batch_from_numpy({"doc": (TP.ascii_arrays(docs, 32), ones,
                                   "string")}, "cpu")
    tails, hits = TP.qstr_step(tb)
    _same_tails(jtails, tails)
    assert int(hits) == jhits
    want = [json_oracle.get_json_object(d, "$.owner")[3:11] for d in docs]
    assert tails.to_pylist() == want


def _ref_groups(res, ng):
    n = int(ng)
    keys = JString(res["tails"].chars[:n], res["tails"].lengths[:n],
                   res["tails"].validity[:n]).to_pylist()
    cnt = np.asarray(res["n"].data)[:n]
    hits = np.asarray(res["hits"].data)[:n]
    return {k: {"n": int(c), "hits": int(h)}
            for k, c, h in zip(keys, cnt, hits)}


def test_qstr_groupby_step_matches_the_reference_composition(reference):
    jb = reference[0]
    jtails, _ = reference[1]
    hit = JR.literal_range_pattern(jtails, "a", 1, ord("0"), ord("9"))
    w = 4 * TP.QSTR_SUB_LEN
    key = JString(jtails.chars[:, :w], jtails.lengths, jtails.validity)
    jres, jng = jgroup_by(
        JBatch({"tails": key,
                "hit": JColumn(hit.data.astype(np.int64), hit.validity,
                               JT.INT64)}),
        ["tails"], [JAgg("count", None, "n"), JAgg("sum", "hit", "hits")],
        engine="sort")
    want = _ref_groups(jres, jng)
    res, ng, n_hits = TP.qstr_groupby_step(TP.qstr_batch(N, device="cpu"))
    assert int(ng) == int(jng) == len(set(jtails.to_pylist()))
    assert TP.result_groups(res, ng, "tails") == want
    assert int(n_hits) == N


def test_group_key_narrowing_keeps_every_byte():
    docs = ['{"owner":"%s"}' % s for s in ("abéééé"
                                           "éééézz",
                                           "\U0001d11e" * 12, "abc")]
    from spark_rapids_jni_tpu_torch.columnar.column import StringColumn

    b = ColumnBatch({"doc": StringColumn.from_pylist(docs,
                                                     pad_to_multiple=32,
                                                     device="cpu")})
    tails, hits = TP._qstr_tails(b)
    gb = TP.qstr_group_batch(tails, hits)
    assert gb["tails"].max_len == 32
    assert gb["tails"].to_pylist() == tails.to_pylist()
    assert gb["hit"].data.dtype == torch.int64


def test_port_and_chip_smoke_import_without_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package: every module imports with both blocked."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['spark_rapids_jni_tpu'] = None\n"
        "import chip_smoke, spark_rapids_jni_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

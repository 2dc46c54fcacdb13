"""PyTorch port: the whole q6 and q95 steps against the JAX package's
``__graft_entry__`` steps on the same seeded data, and the port's
isolation from JAX.

Ints and counts bit-identical; float means rel 1e-5 (the reference's f32x3
tolerance).  The JAX steps run as the reference's own tests run them on
the CPU (its ``auto`` engines there).
"""

import ast
import os

import jax
import numpy as np
import pytest

import __graft_entry__ as ge
from spark_rapids_jni_tpu import config as jconfig

from spark_rapids_jni_tpu_torch import config as tconfig
from spark_rapids_jni_tpu_torch import pipelines as TP
from spark_rapids_jni_tpu_torch.columnar.column import batch_from_numpy
from spark_rapids_jni_tpu_torch.ops import kernels as TKer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_config():
    yield
    jconfig.reset()
    tconfig.reset()


def to_port(jb):
    return batch_from_numpy(
        {n: (np.asarray(c.data), np.asarray(c.validity), repr(c.dtype))
         for n, c in zip(jb.names, jb.columns)}, device="cpu")


def jit_fresh(fn):
    """``jax.jit`` of a new closure: jit caches traces per function, and
    the steps read config knobs at trace time, so each knob setting needs
    its own trace."""
    return jax.jit(lambda *args: fn(*args))


def assert_groups_match(jres, jng, tres, tng, floats=()):
    g = int(jng)
    assert int(tng) == g
    assert list(tres.names) == list(jres.names)
    for name in jres.names:
        jv = np.asarray(jres[name].validity)[:g]
        jd = np.asarray(jres[name].data)[:g]
        np.testing.assert_array_equal(tres[name].validity[:g].numpy(), jv,
                                      err_msg=name)
        td = tres[name].data[:g].numpy()
        if name in floats:
            np.testing.assert_allclose(td[jv], jd[jv], rtol=RTOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(td[jv], jd[jv], err_msg=name)


@pytest.mark.parametrize("path", ["onehot", "sort"])
def test_q6_step_matches_reference(path):
    jconfig.set("q6_group_path", path)
    tconfig.set("q6_group_path", path)
    jb = ge._example_batch(6000, seed=3)
    jres, jng = jit_fresh(ge._q6_step)(jb)
    tres, tng = TP.q6_step(to_port(jb))
    assert_groups_match(jres, jng, tres, tng, floats=("avg_price",))
    # and both agree with the numpy oracle
    uniq, sums, cnts, avgs = TP.q6_oracle(*TP.example_arrays(6000, 3))
    got = TP.result_groups(tres, tng, "k")
    assert sorted(got) == uniq.tolist()
    for k, s, c, a in zip(uniq.tolist(), sums, cnts, avgs):
        assert got[k]["sum_v"] == int(s) and got[k]["cnt"] == int(c)
        assert abs(got[k]["avg_price"] - a) <= RTOL * abs(a)


@pytest.mark.parametrize("engine", ["auto", "sort"])
def test_q95_step_matches_reference(engine):
    jconfig.set("groupby_engine", engine)
    tconfig.set("groupby_engine", engine)
    jf, jd1, jd2 = ge._q95_batches(8192, seed=23)
    jres, jng = jit_fresh(ge._q95_step)(jf, jd1, jd2)
    tres, tng = TP.q95_step(to_port(jf), to_port(jd1), to_port(jd2))
    assert_groups_match(jres, jng, tres, tng)
    orders, net = TP.q95_oracle(TP.q95_arrays(8192, 23))
    got = TP.result_groups(tres, tng, "seg")
    assert [got[s]["orders"] for s in range(TP.Q95_SEG)] == orders.tolist()
    assert [got[s]["net"] for s in range(TP.Q95_SEG)] == net.tolist()


def test_q95_hashjoin_step_matches_reference():
    jf, jd1, jd2 = ge._q95_batches(4096, seed=29)
    jres, jng = jit_fresh(ge._q95_encoded_step)(jf, jd1, jd2)
    tres, tng = TP.q95_hashjoin_step(to_port(jf), to_port(jd1),
                                     to_port(jd2))
    assert_groups_match(jres, jng, tres, tng)
    orders, net = TP.q95_oracle(TP.q95_arrays(4096, 29))
    got = TP.result_groups(tres, tng, "seg")
    assert [got[s]["orders"] for s in range(TP.Q95_SEG)] == orders.tolist()
    assert [got[s]["net"] for s in range(TP.Q95_SEG)] == net.tolist()


@pytest.mark.parametrize("upto", ["exch1", "join1", "join2"])
def test_q95_stage_prefixes_match_reference(upto):
    jf, jd1, jd2 = ge._q95_batches(2048, seed=31)
    jout = jax.jit(lambda f, a, b: ge._q95_prefix(f, a, b, upto))(
        jf, jd1, jd2)
    tout = TP._q95_prefix(to_port(jf), to_port(jd1), to_port(jd2), upto)
    if upto == "exch1":
        jout, tout = (jout, jf.num_rows), (tout, jf.num_rows)
    (jb, jc), (tb, tc) = jout, tout
    assert int(jc) == int(tc)
    m = int(jc)
    for name in jb.names:
        np.testing.assert_array_equal(tb[name].data[:m].numpy(),
                                      np.asarray(jb[name].data)[:m])


def test_cpu_runs_launch_no_kernel():
    TKer.reset_launches()
    fn, (batch,) = TP.entry(device="cpu")
    fn(batch)
    TP.q95_hashjoin_step(*TP.q95_batches(1024, device="cpu"))
    assert all(v == 0 for v in TKer.launches.values())


def test_auto_resolves_to_the_kernel_tier():
    from spark_rapids_jni_tpu_torch.relational import aggregate, join

    assert aggregate._resolve_groupby_engine(None) == "kernel"
    assert join._resolve_join_engine(None) == "kernel"


def _port_sources():
    pkg = os.path.join(REPO, "spark_rapids_jni_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_never_imports_jax_or_the_reference():
    banned = ("jax", "jaxlib", "spark_rapids_jni_tpu", "__graft_entry__",
              "bench")
    seen = 0
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        seen += 1
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "id", getattr(node.func, "attr",
                                                       "")) in
                  ("import_module", "__import__") and node.args
                  and isinstance(node.args[0], ast.Constant)):
                names = [str(node.args[0].value)]
            for name in names:
                top = name.split(".")[0]
                assert top not in banned, f"{path} imports {name}"
    assert seen >= 15

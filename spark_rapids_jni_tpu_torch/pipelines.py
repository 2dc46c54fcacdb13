"""The flagship pipelines on the port: the TPC-DS q6- and q95-shaped steps.

Counterparts of the single-chip steps in the reference's
``__graft_entry__.py``:

* :func:`q6_step` (``_q6_step``): filter ``price < 50``, then group by
  ``k`` over the static domain ``[0, 100)``: ``sum(v)``, ``count(*)``,
  ``avg(price)``.  ``q6_group_path='onehot'`` runs the one-hot group-by
  kernel; ``'sort'`` runs the general ``group_by`` (the slot-table build
  kernel under the default engine).
* :func:`q95_step` (``_q95_step`` via ``_q95_prefix``): local exchange ->
  join dim1 -> exchange -> join dim2 -> group by ``seg``.  The joins take
  the dense rowid path on the dims' surrogate keys; the aggregation runs
  the one-hot group-by kernel over ``seg``'s domain.
* :func:`q95_hashjoin_step` (``_q95_encoded_step`` on plain batches): the
  same stages through the general ``hash_join`` and ``group_by`` — the
  slot-table build and probe kernels.

The data recipes draw the same numbers as the reference's from the same
seed (numpy's generator, in the same order), and the numpy oracles are
those of the reference's ``bench.py``.  Batches go to the GPU unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .columnar.column import ColumnBatch, batch_from_numpy
from .parallel.partition import regroup_order, spark_partition_id
from .relational import keys as _rk
from .relational.aggregate import (
    AggSpec,
    group_by,
    group_by_domain_or_sort,
    group_by_onehot,
)
from .relational.gather import gather_column
from .relational.join import hash_join, join_dense_or_hash

# the q95 workload spec (reference __graft_entry__.py Q95_*): fact keys
# over an n / Q95_ND_DIV dimension domain, Q95_WH warehouses, Q95_SEG
# segments, values in [Q95_V_LO, Q95_V_HI)
Q95_ND_DIV = 8
Q95_WH = 25
Q95_SEG = 10
Q95_V_LO, Q95_V_HI = 1, 500
Q95_D_HI = 9  # dim payload domain
P = 8  # logical partitions of the local exchanges


# ---------------------------------------------------------------------------
# data recipes
# ---------------------------------------------------------------------------

def example_arrays(n_rows: int, seed: int = 7):
    """Host recipe of the q6 batch: k ~ U[0, 100) int32, v ~ U[-1000,
    1000) int64, price ~ U[0, 100) f64."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 100, n_rows).astype(np.int32)
    v = rng.integers(-1000, 1000, n_rows).astype(np.int64)
    price = rng.random(n_rows) * 100.0
    return k, v, price


def example_batch(n_rows: int, seed: int = 7, device=None) -> ColumnBatch:
    k, v, price = example_arrays(n_rows, seed)
    ones = np.ones((n_rows,), np.bool_)
    return batch_from_numpy({"k": (k, ones, "int32"),
                             "v": (v, ones, "int64"),
                             "price": (price, ones, "float64")}, device)


def q95_arrays(n_rows: int, seed: int = 19) -> dict:
    """Host recipe of the q95 batches: ``{'fact': {...}, 'dim1': {...},
    'dim2': {...}}`` of numpy columns."""
    rng = np.random.default_rng(seed)
    nd = max(n_rows // Q95_ND_DIV, 1)
    fact = {
        "k": rng.integers(0, nd, n_rows).astype(np.int32),
        "wh": rng.integers(0, Q95_WH, n_rows).astype(np.int32),
        "seg": rng.integers(0, Q95_SEG, n_rows).astype(np.int32),
        "v": rng.integers(Q95_V_LO, Q95_V_HI, n_rows),
    }
    dim1 = {"k": np.arange(nd, dtype=np.int32),
            "d1": rng.integers(0, Q95_D_HI, nd)}
    dim2 = {"wh": np.arange(Q95_WH, dtype=np.int32),
            "d2": rng.integers(0, Q95_D_HI, Q95_WH)}
    return {"fact": fact, "dim1": dim1, "dim2": dim2}


_Q95_TYPES = {"k": "int32", "wh": "int32", "seg": "int32", "v": "int64",
              "d1": "int64", "d2": "int64"}


def q95_batches(n_rows: int, seed: int = 19, device=None):
    """``(fact, dim1, dim2)`` batches of :func:`q95_arrays`."""
    arrs = q95_arrays(n_rows, seed)
    out = []
    for part in ("fact", "dim1", "dim2"):
        cols = arrs[part]
        out.append(batch_from_numpy(
            {name: (a, np.ones(a.shape, np.bool_), _Q95_TYPES[name])
             for name, a in cols.items()}, device))
    return tuple(out)


# ---------------------------------------------------------------------------
# q6
# ---------------------------------------------------------------------------

Q6_AGGS = (AggSpec("sum", "v", "sum_v"), AggSpec("count", None, "cnt"),
           AggSpec("mean", "price", "avg_price"))


def q6_step(batch: ColumnBatch):
    """Filter ``price < 50``, then group by ``k``; returns ``(result,
    num_groups)``.  The filter mask feeds the group-by as ``row_valid``
    (no compaction pass)."""
    aggs = list(Q6_AGGS)
    mask = batch["price"].data < 50.0
    if config.get("q6_group_path") == "onehot":
        res, ng, _overflow = group_by_onehot(
            batch, "k", aggs, domain=100, row_valid=mask,
            float_mode=config.get("q6_float_mode"),
            engine=config.get("q6_onehot_engine"))
        return res, ng
    return group_by(batch, ["k"], aggs, row_valid=mask)


def entry(device=None):
    """``(fn, example_args)`` — the flagship single-device step."""
    return q6_step, (example_batch(4096, device=device),)


# ---------------------------------------------------------------------------
# q95
# ---------------------------------------------------------------------------

def _exchange_local(b: ColumnBatch, key: str, live: torch.Tensor,
                    secondary=None) -> ColumnBatch:
    """The local leg of a shuffle: Spark-exact partition ids, then a stable
    regroup by pid.  Dead rows get pseudo-partition P and go last, so live
    rows stay compacted in front."""
    pid = spark_partition_id([b[key]], P, live)
    order = regroup_order(pid, P + 1, secondary=secondary)
    return ColumnBatch({name: gather_column(col, order)
                        for name, col in zip(b.names, b.columns)})


def _live_prefix(n: int, count: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=count.device) < count


Q95_AGGS = (AggSpec("count", None, "orders"), AggSpec("sum", "v", "net"))


def q95_step(fact: ColumnBatch, dim1: ColumnBatch, dim2: ColumnBatch):
    """TPC-DS q95 shape: exchange -> join -> exchange -> join -> group-by.
    Returns ``(result, num_groups)``."""
    return _q95_prefix(fact, dim1, dim2, "full")


def _q95_prefix(fact, dim1, dim2, upto: str = "full"):
    """The q95 pipeline, truncatable after a stage (``upto`` in
    ``('exch1', 'join1', 'join2', 'full')``)."""
    all_live = torch.ones((fact.num_rows,), dtype=torch.bool,
                          device=fact["k"].data.device)
    staged = _exchange_local(fact, "k", all_live)
    if upto == "exch1":
        return staged
    j1, c1 = join_dense_or_hash(staged, dim1, "k", "k", dim1.num_rows)
    if upto == "join1":
        return j1, c1
    j1_live = _live_prefix(j1.num_rows, c1)
    staged2 = _exchange_local(j1, "wh", j1_live)
    # the exchange kept the live count and compacted live rows to the
    # front, so the same prefix mask applies in the new order
    j2, c2 = join_dense_or_hash(staged2, dim2, "wh", "wh", dim2.num_rows,
                                left_valid=j1_live)
    if upto == "join2":
        return j2, c2
    live = _live_prefix(j2.num_rows, c2)
    aggs = list(Q95_AGGS)
    if config.get("groupby_engine") == "sort":
        # sort-order reuse: the seg words ride the exchange's regroup sort,
        # so the sort engine's group_by runs on already-grouped rows
        segkeys = _rk.batch_radix_keys([j2["seg"]], equality=True,
                                       nulls_first=True)
        staged3 = _exchange_local(j2, "seg", live, secondary=segkeys)
        return group_by(staged3, ["seg"], aggs, row_valid=live,
                        assume_grouped=True)
    return group_by_domain_or_sort(j2, "seg", aggs, Q95_SEG, row_valid=live)


def q95_hashjoin_step(fact: ColumnBatch, dim1: ColumnBatch,
                      dim2: ColumnBatch):
    """The q95 stages through the general ``hash_join`` and ``group_by``
    (the reference's ``_q95_encoded_step`` on plain batches)."""
    all_live = torch.ones((fact.num_rows,), dtype=torch.bool,
                          device=fact["k"].data.device)
    staged = _exchange_local(fact, "k", all_live)
    j1, c1 = hash_join(staged, dim1, ["k"], ["k"], "inner")
    j1_live = _live_prefix(j1.num_rows, c1)
    staged2 = _exchange_local(j1, "wh", j1_live)
    j2, c2 = hash_join(staged2, dim2, ["wh"], ["wh"], "inner",
                       left_valid=j1_live)
    live = _live_prefix(j2.num_rows, c2)
    return group_by(j2, ["seg"], list(Q95_AGGS), row_valid=live)


# ---------------------------------------------------------------------------
# numpy oracles (the reference bench.py's baselines)
# ---------------------------------------------------------------------------

def q6_oracle(k, v, price):
    """``(keys, sum_v, counts, avg_price)`` over the groups of q6."""
    mask = price < 50.0
    ks, vs, ps = k[mask], v[mask], price[mask]
    uniq, inv = np.unique(ks, return_inverse=True)
    sums = np.bincount(inv, weights=vs.astype(np.float64))
    cnts = np.bincount(inv)
    avgs = np.bincount(inv, weights=ps) / cnts
    return uniq, sums, cnts, avgs


def q95_oracle(arrs: dict):
    """``(orders, net)`` per seg in ``[0, Q95_SEG)``: the unique-key joins
    reduce to key lookups, the group-by to bincounts."""
    fact, dim1, dim2 = arrs["fact"], arrs["dim1"], arrs["dim2"]
    hit = (np.isin(fact["k"], dim1["k"]) & np.isin(fact["wh"], dim2["wh"]))
    seg, v = fact["seg"][hit], fact["v"][hit]
    orders = np.bincount(seg, minlength=Q95_SEG)
    net = np.bincount(seg, weights=v.astype(np.float64), minlength=Q95_SEG)
    return orders, net


def result_groups(res: ColumnBatch, ng, key: str) -> dict:
    """``{key value: {column: value}}`` over the live groups of a result
    (null key -> ``None``), for comparing results group by group."""
    n = int(ng)
    cols = {name: (c.data[:n].cpu().numpy(), c.validity[:n].cpu().numpy())
            for name, c in zip(res.names, res.columns)}
    kd, kv = cols[key]
    out = {}
    for i in range(n):
        kk = kd[i].item() if kv[i] else None
        out[kk] = {name: (d[i].item() if v[i] else None)
                   for name, (d, v) in cols.items() if name != key}
    return out


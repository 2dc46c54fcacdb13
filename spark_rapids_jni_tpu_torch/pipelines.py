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

* :func:`q6str_step` (``_q6str_step``): q6 with a 24-byte string group
  key (100 distinct ``cat-NN-xxxxxxxxxxxxxx`` values) through the
  general ``group_by``: the slot-table build kernel over 8 key words.
* :func:`q3_step` (``_q3_step``): a dense dimension join, then the
  domain group-by over 5 segments (the one-hot group-by kernel).
* :func:`q67_step` (``_q67_step``): a partitioned window (rank and a
  running sum over sales descending, 1000 partitions), then a top-100
  ``apply_mask``.

q9 exists only as IR (:func:`plan.queries.q9_plan`); :func:`q9_oracle`
is its numpy oracle.

The data recipes draw the same numbers as the reference's from the same
seed (numpy's generator, in the same order), and the numpy oracles are
those of the reference's ``bench.py``.  Batches go to the GPU unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .columnar.column import (ColumnBatch, StringColumn, batch_from_numpy,
                              string_arrays)
from .parallel.partition import exchange_local
from .relational import keys as _rk
from .relational.aggregate import (
    AggSpec,
    group_by,
    group_by_domain_or_sort,
    group_by_onehot,
)
from .relational.filter import apply_mask
from .relational.join import hash_join, join_dense_or_hash
from .relational.window import WindowSpec, window

# the q95 workload spec (reference __graft_entry__.py Q95_*): fact keys
# over an n / Q95_ND_DIV dimension domain, Q95_WH warehouses, Q95_SEG
# segments, values in [Q95_V_LO, Q95_V_HI)
Q95_ND_DIV = 8
Q95_WH = 25
Q95_SEG = 10
Q95_V_LO, Q95_V_HI = 1, 500
Q95_D_HI = 9  # dim payload domain
# the q9 conditional (plan/queries.py q9_plan): orders with v >= this
Q9_V_THRESHOLD = 250
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


# the q6str key: 100 categories, 21 bytes each in a 24-byte column
Q6STR_KEYS = tuple(f"cat-{i:02d}-{'x' * 14}" for i in range(100))
Q6STR_WIDTH = 24
Q3_SEG = 5
Q67_CATS = 1000
Q67_TOP = 100


def q6str_arrays(n_rows: int, seed: int = 7):
    """Host recipe of the q6str batch, the reference's draws in its
    order: ``(kidx, (chars, lengths), v, price)`` with the key the
    string ``Q6STR_KEYS[kidx]``, built without a Python string a row."""
    rng = np.random.default_rng(seed)
    kidx = rng.integers(0, 100, n_rows)
    v = rng.integers(-1000, 1000, n_rows).astype(np.int64)
    price = rng.random(n_rows) * 100.0
    return kidx, string_arrays(Q6STR_KEYS, kidx, Q6STR_WIDTH), v, price


def q6str_batch(n_rows: int, seed: int = 7, device=None) -> ColumnBatch:
    _, chars_len, v, price = q6str_arrays(n_rows, seed)
    ones = np.ones((n_rows,), np.bool_)
    return batch_from_numpy({"k": (chars_len, ones, "string"),
                             "v": (v, ones, "int64"),
                             "price": (price, ones, "float64")}, device)


# the string join's dimension: 90 of q6str's categories and 10 that no
# fact row carries (their tails differ), one row each, 21 bytes wide
Q6STR_DIM_KEYS = Q6STR_KEYS[:90] + tuple(
    f"cat-{i:02d}-{'y' * 14}" for i in range(90, 100))


def q6str_dim(device=None) -> ColumnBatch:
    """The 100-row string dimension that q6str's fact joins: key ``k``
    (``Q6STR_DIM_KEYS``, width 21, so a join aligns it to the fact's 24)
    and payload ``dv = 37 i mod 1000``."""
    n = len(Q6STR_DIM_KEYS)
    ones = np.ones((n,), np.bool_)
    return batch_from_numpy(
        {"k": (string_arrays(Q6STR_DIM_KEYS, np.arange(n)), ones, "string"),
         "dv": (np.arange(n, dtype=np.int64) * 37 % 1000, ones, "int64")},
        device)


def q3_arrays(n_rows: int, seed: int = 11) -> dict:
    """Host recipe of the q3 batches: ``{'fact': {...}, 'dim': {...}}``;
    the dim's keys are a dense ``arange`` over ``n / 4`` rows."""
    rng = np.random.default_rng(seed)
    fact = {"k": rng.integers(0, n_rows // 4, n_rows).astype(np.int32),
            "v": rng.integers(1, 1000, n_rows),
            "seg": rng.integers(0, Q3_SEG, n_rows).astype(np.int32)}
    nd = max(n_rows // 4, 1)
    dim = {"k": np.arange(nd, dtype=np.int32),
           "dv": rng.integers(0, 10, nd)}
    return {"fact": fact, "dim": dim}


_Q3_TYPES = {"k": "int32", "v": "int64", "seg": "int32", "dv": "int64"}


def q3_batches(n_rows: int, seed: int = 11, device=None):
    """``(fact, dim)`` batches of :func:`q3_arrays`."""
    arrs = q3_arrays(n_rows, seed)
    return tuple(batch_from_numpy(
        {name: (a, np.ones(a.shape, np.bool_), _Q3_TYPES[name])
         for name, a in arrs[part].items()}, device)
        for part in ("fact", "dim"))


def q67_arrays(n_rows: int, seed: int = 13):
    """Host recipe of the q67 batch: ``(cat, sales)``."""
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, Q67_CATS, n_rows).astype(np.int32)
    sales = rng.integers(0, 10**6, n_rows)
    return cat, sales


def q67_batch(n_rows: int, seed: int = 13, device=None) -> ColumnBatch:
    cat, sales = q67_arrays(n_rows, seed)
    ones = np.ones((n_rows,), np.bool_)
    return batch_from_numpy({"cat": (cat, ones, "int32"),
                             "sales": (sales, ones, "int64")}, device)


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


def q6str_step(batch: ColumnBatch):
    """q6 over the string-keyed batch: filter ``price < 50``, then the
    general ``group_by(k)``; returns ``(result, num_groups)``."""
    mask = batch["price"].data < 50.0
    return group_by(batch, ["k"], list(Q6_AGGS), row_valid=mask)


Q3_AGGS = (AggSpec("sum", "v", "rev"), AggSpec("count", None, "cnt"))


def q3_step(fact: ColumnBatch, dim: ColumnBatch):
    """TPC-H q3 shape: fact join dim on ``k`` (the dim's dense keys: the
    rowid-table join), then group by ``seg`` over its 5-key domain;
    returns ``(result, num_groups)``."""
    joined, count = join_dense_or_hash(fact, dim, "k", "k", dim.num_rows)
    live = _live_prefix(joined.num_rows, count)
    return group_by_domain_or_sort(joined, "seg", list(Q3_AGGS), Q3_SEG,
                                   row_valid=live)


def q67_step(batch: ColumnBatch) -> ColumnBatch:
    """TPC-DS q67 shape: per ``cat``, rank and a running sum of ``sales``
    descending, then the top ``Q67_TOP`` ranks (rows past them nulled,
    in sorted order with ``sorted_row``)."""
    ranked = window(batch, ["cat"], ["sales"],
                    [WindowSpec("rank", None, "rk"),
                     WindowSpec("sum", "sales", "run_sales")],
                    descending=[True])
    return apply_mask(ranked, ranked["rk"].data <= Q67_TOP)


def entry(device=None):
    """``(fn, example_args)`` — the flagship single-device step."""
    return q6_step, (example_batch(4096, device=device),)


# ---------------------------------------------------------------------------
# q95
# ---------------------------------------------------------------------------

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
    staged = exchange_local(fact, "k", all_live, P)
    if upto == "exch1":
        return staged
    j1, c1 = join_dense_or_hash(staged, dim1, "k", "k", dim1.num_rows)
    if upto == "join1":
        return j1, c1
    j1_live = _live_prefix(j1.num_rows, c1)
    staged2 = exchange_local(j1, "wh", j1_live, P)
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
        staged3 = exchange_local(j2, "seg", live, P, secondary=segkeys)
        return group_by(staged3, ["seg"], aggs, row_valid=live,
                        assume_grouped=True)
    return group_by_domain_or_sort(j2, "seg", aggs, Q95_SEG, row_valid=live)


def q95_hashjoin_step(fact: ColumnBatch, dim1: ColumnBatch,
                      dim2: ColumnBatch):
    """The q95 stages through the general ``hash_join`` and ``group_by``
    (the reference's ``_q95_encoded_step`` on plain batches)."""
    all_live = torch.ones((fact.num_rows,), dtype=torch.bool,
                          device=fact["k"].data.device)
    staged = exchange_local(fact, "k", all_live, P)
    j1, c1 = hash_join(staged, dim1, ["k"], ["k"], "inner")
    j1_live = _live_prefix(j1.num_rows, c1)
    staged2 = exchange_local(j1, "wh", j1_live, P)
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


def q9_oracle(arrs: dict):
    """``(net_hi, orders_hi)`` per seg in ``[0, Q95_SEG)`` for q9: the
    unique-key joins reduce to key lookups, the conditional aggregate to
    bincounts over rows with ``v >= Q9_V_THRESHOLD``.  ``avg_hi`` is
    ``net_hi / orders_hi`` where ``orders_hi > 0``."""
    fact, dim1, dim2 = arrs["fact"], arrs["dim1"], arrs["dim2"]
    hit = (np.isin(fact["k"], dim1["k"]) & np.isin(fact["wh"], dim2["wh"])
           & (fact["v"] >= Q9_V_THRESHOLD))
    seg, v = fact["seg"][hit], fact["v"][hit]
    orders = np.bincount(seg, minlength=Q95_SEG)
    net = np.bincount(seg, weights=v.astype(np.float64), minlength=Q95_SEG)
    return net, orders


def q6str_oracle(kidx, v, price):
    """``(keys, sum_v, counts, avg_price)`` of q6str: q6's oracle over
    the key codes, whose order is the strings' order."""
    uniq, sums, cnts, avgs = q6_oracle(kidx, v, price)
    return [Q6STR_KEYS[i] for i in uniq], sums, cnts, avgs


def q3_oracle(arrs: dict):
    """``(rev, cnt)`` per seg in ``[0, Q3_SEG)``: the dim covers every fact
    key, so the join keeps every row and the group-by is a bincount (the
    reference's own test oracle)."""
    fact = arrs["fact"]
    hit = np.isin(fact["k"], arrs["dim"]["k"])
    seg, v = fact["seg"][hit], fact["v"][hit]
    cnt = np.bincount(seg, minlength=Q3_SEG)
    rev = np.bincount(seg, weights=v.astype(np.float64), minlength=Q3_SEG)
    return rev, cnt


def q67_oracle(cat, sales):
    """``(order, rank, run_sales)`` of q67 in sorted order: rows by
    ``cat``, then ``sales`` descending, ties in input order (a stable
    sort); rank is the row number of each row's first peer; the running
    sum covers the partition's rows up to and including the row."""
    order = np.lexsort((-sales.astype(np.int64), cat))
    c, s = cat[order], sales[order].astype(np.int64)
    n = len(order)
    idx = np.arange(n)
    new_part = np.ones(n, bool)
    new_part[1:] = c[1:] != c[:-1]
    new_peer = new_part.copy()
    new_peer[1:] |= s[1:] != s[:-1]
    ps = np.maximum.accumulate(np.where(new_part, idx, 0))
    rn = idx - ps + 1
    rank = rn[np.maximum.accumulate(np.where(new_peer, idx, 0))]
    cs = np.cumsum(s)
    run = cs - cs[ps] + s[ps]
    return order, rank, run


def result_groups(res: ColumnBatch, ng, key: str) -> dict:
    """``{key value: {column: value}}`` over the live groups of a result
    (null key -> ``None``; a string key as its ``str``), for comparing
    results group by group."""
    n = int(ng)
    cols = {name: (c.data[:n].cpu().numpy(), c.validity[:n].cpu().numpy())
            for name, c in zip(res.names, res.columns)
            if not isinstance(c, StringColumn)}
    kcol = res[key]
    keys = (StringColumn(kcol.chars[:n], kcol.lengths[:n],
                         kcol.validity[:n]).to_pylist()
            if isinstance(kcol, StringColumn) else
            [d.item() if v else None for d, v in zip(*cols[key])])
    out = {}
    for i, kk in enumerate(keys):
        out[kk] = {name: (d[i].item() if v[i] else None)
                   for name, (d, v) in cols.items() if name != key}
    return out



# ---------------------------------------------------------------------------
# the multi-device dry run
# ---------------------------------------------------------------------------

DRYRUN_KEYS = 50  # distinct group keys (and dimension keys) of the dry run
DRYRUN_PATTERNS = ("uniform", "all-one", "skew80")  # skew80 last: the
# join, sort and 2-D stages reuse its batch (the q95 shape)


def dryrun_arrays(n: int, seed: int = 3):
    """Host recipe of the dry run, the reference's draws in its order:
    ``(v, {pattern: (k, kvalid)})`` — uniform keys, 80% one key, and all
    one key, 5% of keys null."""
    rng = np.random.default_rng(seed)

    def keys_for(pattern):
        if pattern == "uniform":
            return rng.integers(0, DRYRUN_KEYS, n).astype(np.int32)
        if pattern == "skew80":
            return np.where(rng.random(n) < 0.8, 7,
                            rng.integers(0, DRYRUN_KEYS, n)).astype(np.int32)
        return np.full(n, 13, np.int32)

    v = rng.integers(-(10 ** 6), 10 ** 6, n)
    keys = {}
    for pattern in DRYRUN_PATTERNS:
        k = keys_for(pattern)
        keys[pattern] = (k, rng.random(n) > 0.05)
    return v, keys


def _dryrun_batch(k, kvalid, v) -> ColumnBatch:
    """``k`` int32, ``v`` int64 and ``s`` = ``'s{k}'`` (null with ``k``),
    on the CPU (sharding moves it)."""
    chars, lengths = string_arrays(
        [f"s{i}" for i in range(DRYRUN_KEYS)], k, max_len=8)
    chars = np.where(kvalid[:, None], chars, 0).astype(np.uint8)
    lengths = np.where(kvalid, lengths, 0).astype(np.int32)
    ones = np.ones(k.shape, np.bool_)
    return batch_from_numpy({"k": (k, kvalid, "int32"),
                             "v": (v, ones, "int64"),
                             "s": ((chars, lengths), kvalid, "string")},
                            device="cpu")


def _mesh_total(mesh, x: torch.Tensor) -> int:
    return int(mesh.all_reduce(x.sum().reshape(1), "sum").item())


def dryrun_multichip(n_devices: int, rows_per_device: int = 100_000,
                     mesh=None, log=print) -> dict:
    """The reference's multi-device dry run (``__graft_entry__.py``
    ``dryrun_multichip``), stage for stage, over ``mesh`` (default: a
    :class:`~.parallel.mesh.ShardMesh` of ``n_devices`` shards on the
    GPU; a :class:`~.parallel.mesh.ProcessMesh` runs it on ranks):

    1. the lossless group-by over three skew patterns, every row
       conserved and none dropped;
    2. the map-side combine (:func:`distributed_group_by_domain`) equal
       to the exchanged group-by's groups;
    3. a hash join against a 50-key dimension of ``n`` rows, its int64
       match count equal to the exact ``sum_k fact_valid(k) * dim(k)``;
    4. a dense broadcast join: every valid-keyed row matches once;
    5. the global sort by ``(k, v)``: every row kept, keys ordered across
       shards;
    6. on an even mesh of 4 or more, the ``2 x (n/2)`` two-hop group-by
       equal to the flat one.

    Raises AssertionError on any failed check; returns the figures it
    checked.  ``log`` takes each stage's line (``None``: no output).
    """
    from .parallel import (HierMesh, ShardMesh, collect_groups,
                           distributed_broadcast_join, distributed_group_by,
                           distributed_group_by_2d,
                           distributed_group_by_domain, distributed_hash_join,
                           distributed_sort, shard_batch)

    log = log or (lambda line: None)
    mesh = ShardMesh(n_devices) if mesh is None else mesh
    if mesh.size != n_devices:
        raise ValueError(f"mesh has {mesh.size} shards, not {n_devices}")
    n = n_devices * rows_per_device
    v, keys = dryrun_arrays(n)
    aggs = [AggSpec("sum", "v", "sum_v"), AggSpec("count", None, "cnt")]
    out = {"rows": n, "patterns": {}}
    for pattern in DRYRUN_PATTERNS:
        k, kvalid = keys[pattern]
        sharded = shard_batch(_dryrun_batch(k, kvalid, v), mesh)
        res, ng, dropped = distributed_group_by(sharded, ["k"], aggs, mesh)
        assert _mesh_total(mesh, dropped) == 0, (
            "lossless shuffle dropped rows", pattern)
        per = res.num_rows // mesh.local_shards
        live = (torch.arange(per, device=ng.device)[None, :]
                < ng[:, None]).reshape(-1)
        total = _mesh_total(mesh, torch.where(
            live, res["cnt"].data, torch.zeros_like(res["cnt"].data)))
        assert total == n, (pattern, total, n)
        slots = _mesh_total(mesh, ng)
        out["patterns"][pattern] = {"rows": total, "group_slots": slots}
        log(f"  [group-by/{pattern}] {rows_per_device} rows/device x "
            f"{n_devices} devices = {total} rows conserved, {slots} group "
            "slots, 0 dropped")
    groups = collect_groups(res, ng, mesh)
    assert sum(groups["cnt"]) == n, (sum(groups["cnt"]), n)

    # map-side combine on the skew80 batch: partials + one all-reduce
    dres, dng, dovf = distributed_group_by_domain(sharded, "k", aggs, 64,
                                                  mesh)
    assert not bool(dovf)
    gd = int(dng)
    dkeys, dsums = (collect_groups(dres, dng.reshape(1))[c]
                    for c in ("k", "sum_v"))
    dmap = {dkeys[i]: dsums[i] for i in range(gd) if dkeys[i] is not None}
    smap = {kk: sv for kk, sv in zip(groups["k"], groups["sum_v"])
            if kk is not None}
    assert dmap == smap, "map-side combine != shuffled group-by"

    # hash join against a 50-key dimension of n rows
    dk = np.tile(np.arange(DRYRUN_KEYS, dtype=np.int32),
                 n // DRYRUN_KEYS + 1)[:n]
    ones = np.ones(n, np.bool_)
    dim = batch_from_numpy({"k": (dk, ones, "int32"),
                            "dv": (dk.astype(np.int64) * 10, ones,
                                   "int64")}, device="cpu")
    jres, jcounts, jdrop = distributed_hash_join(
        sharded, shard_batch(dim, mesh), ["k"], ["k"], "inner", mesh)
    assert _mesh_total(mesh, jdrop) == 0
    join_count = _mesh_total(mesh, jcounts)
    fact_k = k[kvalid].astype(np.int64)
    want = int((np.bincount(fact_k, minlength=DRYRUN_KEYS).astype(np.int64)
                * np.bincount(dk, minlength=DRYRUN_KEYS)).sum())
    assert join_count == want, (join_count, want)
    out["join_count"] = join_count
    log(f"  [hash-join] {n} x {n} rows -> {join_count} matches, 0 dropped")

    # dense broadcast join: zero exchange, one match per valid key
    dim50 = batch_from_numpy({
        "k": (np.arange(DRYRUN_KEYS, dtype=np.int32),
              np.ones(DRYRUN_KEYS, np.bool_), "int32"),
        "dv": (np.arange(DRYRUN_KEYS, dtype=np.int64) * 10,
               np.ones(DRYRUN_KEYS, np.bool_), "int64")}, device="cpu")
    _, bcounts = distributed_broadcast_join(
        sharded, dim50, ["k"], ["k"], "inner", mesh,
        dense_domain=DRYRUN_KEYS)
    b_total = _mesh_total(mesh, bcounts)
    assert b_total == int(kvalid.sum()), (b_total, int(kvalid.sum()))
    out["broadcast_matches"] = b_total
    log(f"  [broadcast-join] {n} x {DRYRUN_KEYS}-key dense dim -> "
        f"{b_total} matches, zero-exchange")

    # global sort by (k, v): ordered across shards
    sres, socc, sdrop = distributed_sort(sharded, ["k", "v"], mesh)
    assert _mesh_total(mesh, sdrop) == 0
    kept = _mesh_total(mesh, socc.to(torch.int64))
    assert kept == n, (kept, n)
    kk = sres["k"].data[socc & sres["k"].validity]
    live_sorted = mesh.all_gather_rows(kk).cpu().numpy()
    assert (np.diff(live_sorted) >= 0).all(), "global sort order violated"
    out["sorted_rows"] = kept
    log(f"  [global-sort] {kept} rows range-partitioned and globally "
        "ordered, 0 dropped")

    hier = "dcn-x-ici skipped (needs even n>=4)"
    if n_devices % 2 == 0 and n_devices >= 4:
        hmesh = HierMesh(2, n_devices // 2, mesh)
        res2, ng2, drop2 = distributed_group_by_2d(
            sharded.select(["k", "v"]), ["k"], aggs, hmesh)
        assert _mesh_total(mesh, drop2) == 0, "hierarchical shuffle lost rows"
        g2 = collect_groups(res2, ng2, mesh)
        assert sum(g2["cnt"]) == n, (sum(g2["cnt"]), n)
        assert dict(zip(g2["k"], g2["sum_v"])) == dict(
            zip(groups["k"], groups["sum_v"])), "2d != flat group sums"
        hier = "dcn-x-ici hierarchical shuffle OK"
    out["groups"] = len(groups["k"])
    out["hier"] = hier
    log(f"dryrun_multichip({n_devices}): {len(groups['k'])} groups over "
        f"{n} rows ({rows_per_device}/device, 3 skew patterns + map-side"
        f"-combine parity), join count={join_count}, global sort OK, "
        f"{hier}")
    return out


# ---------------------------------------------------------------------------
# q95 over a mesh
# ---------------------------------------------------------------------------

def shard_prefix(counts: torch.Tensor, rows: int) -> torch.Tensor:
    """bool[rows]: each local shard's first ``counts[s]`` rows (a
    distributed join's live rows; ``counts`` has one entry per local
    shard)."""
    per = rows // counts.shape[0]
    return (torch.arange(per, device=counts.device)[None, :]
            < counts[:, None]).reshape(-1)


def q95_distributed(fact: ColumnBatch, dim1: ColumnBatch, dim2: ColumnBatch,
                    mesh) -> dict:
    """q95's operators over a mesh of row-sharded ``fact`` and ``dim1``
    (``dim2`` whole): the hash join on ``k`` (both sides exchanged), the
    dense broadcast join on ``wh``, then the group by ``seg`` twice — the
    exchanged group-by and the map-side combine.  Returns each step's
    outputs by name: ``join1`` ``(rows, counts, dropped)``, ``join2``
    ``(rows, counts)``, ``group_by`` ``(result, num_groups, dropped)`` and
    ``domain`` ``(result, num_groups, overflow)``."""
    from .parallel import (distributed_broadcast_join, distributed_group_by,
                           distributed_group_by_domain,
                           distributed_hash_join)

    j1, c1, d1 = distributed_hash_join(fact, dim1, ["k"], ["k"], "inner",
                                       mesh)
    j2, c2 = distributed_broadcast_join(j1, dim2, ["wh"], ["wh"], "inner",
                                        mesh, dense_domain=Q95_WH)
    live = shard_prefix(c2, j2.num_rows)
    gb = distributed_group_by(j2, ["seg"], list(Q95_AGGS), mesh,
                              row_valid=live)
    dom = distributed_group_by_domain(j2, "seg", list(Q95_AGGS), Q95_SEG,
                                      mesh, row_valid=live)
    return {"join1": (j1, c1, d1), "join2": (j2, c2), "group_by": gb,
            "domain": dom}


def q95_distributed_groups(out: dict, mesh=None) -> dict:
    """``{'group_by': (orders, net), 'domain': (orders, net)}`` int64
    arrays over ``seg`` in ``[0, Q95_SEG)`` from :func:`q95_distributed`'s
    outputs (the exchanged group-by's shards collected), comparable with
    :func:`q95_oracle`; a seg no row reaches stays 0."""
    from .parallel import collect_groups

    got = {}
    for name in ("group_by", "domain"):
        res, ng = out[name][:2]
        g = collect_groups(res, ng.reshape(-1), mesh if name == "group_by"
                           else None)
        orders = np.zeros(Q95_SEG, np.int64)
        net = np.zeros(Q95_SEG, np.int64)
        for s, o, v in zip(g["seg"], g["orders"], g["net"]):
            orders[s] += o
            net[s] += v
        got[name] = (orders, net)
    return got

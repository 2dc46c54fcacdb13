"""Plan compiler: lower a logical plan onto the port's operators.

Counterpart of ``spark_rapids_jni_tpu/plan/compile.py``, with the same
lowering rules, which are the hand-fused pipelines factored:

* Filter -> a row mask carried forward (never a compaction pass); on a
  dictionary column the predicate runs over the dictionary's entries
  once and maps to rows by code, on a bit-packed or frame-of-reference
  column it compares residuals (``packed_filter_mask``), never decoding.
* Exchange -> the local shuffle leg (Spark-exact murmur3 pid + stable
  regroup); dead rows go to the trailing pseudo-partition, so live
  prefixes survive the permutation.
* Exchange directly under an Aggregate on the same key FUSES, as
  ``pipelines._q95_prefix`` does: under the ``sort`` group-by engine the
  group key's radix words ride the regroup sort as secondary operands and
  ``group_by(assume_grouped=True)`` skips its own sort; under the other
  engines the one-device exchange is a no-op before a complete local
  aggregation, so it is ELIDED.
* Join -> ``join_dense_or_hash`` with a dense-domain hint, else the
  general ``hash_join`` (always the general one when any input column
  is encoded: the rowid path keys on a plain column's raw data, as in
  the reference); a broadcast join (adaptive decision) probes a
  prebuilt :class:`~..relational.join.SpillableBuildTable` pinned to the
  engine the plan decided and registered with the spill store under the
  query's ``ctx``.
* Aggregate -> ``group_by_onehot`` / ``group_by_domain_or_sort`` /
  ``group_by`` by the hand paths' dispatch (a string or other non-int
  key takes the general ``group_by``).
* Sort -> the stable multi-key sort, with dead rows sorted last through
  an ``__occ`` key so the live rows form a prefix.

The reference wraps the lowered plan in one ``jax.jit``; the port runs
it eagerly.  Compiling resolves the adaptive decisions, the join plans
and the broadcast build tables once; :class:`CompiledPlan` objects are
cached in :mod:`.cache` keyed on (IR signature, input schema, knob
fingerprint, decisions), and :func:`trace_count` counts compiles (plan
cache misses), so a repeated shape compiles nothing.
"""

from __future__ import annotations

import contextlib
import operator
from typing import Optional

import torch

from .. import config
from ..columnar.column import Column, ColumnBatch, StringColumn
from ..columnar.encoded import (PACKED_COLUMNS, BitPackedColumn,
                                DictionaryColumn, FrameOfReferenceColumn,
                                RunLengthColumn, is_encoded,
                                packed_filter_mask, predicate_mask)
from . import adaptive, ir
from .cache import get_plan_cache

# compiles (plan-cache misses) so far: a repeated plan shape must not
# add to it
_TRACE_COUNT = [0]


def trace_count() -> int:
    return _TRACE_COUNT[0]


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------

def _layout(c) -> tuple:
    """A column's buffer and the static layout an operator specializes
    on: an encoded column's dictionary token, pack width, reference or
    block, so a new dictionary or layout misses the cache."""
    if isinstance(c, StringColumn):
        return c.chars, ()
    if isinstance(c, DictionaryColumn):
        return c.codes, (c.dict_token,)
    if isinstance(c, BitPackedColumn):
        return c.lanes, (c.width, c.reference)
    if isinstance(c, FrameOfReferenceColumn):
        return c.lanes, (c.width, c.block)
    if isinstance(c, RunLengthColumn):
        return c.run_values, (c.num_rows,)
    return getattr(c, "data", getattr(c, "limbs", None)), ()


def _schema_fingerprint(inputs: dict) -> tuple:
    """Hashable identity of the input schemas: every column's name, type,
    shape, dtype, device type and encoded layout — any row-count, width,
    dtype, dictionary or column-set change misses the cache by
    construction."""
    out = []
    for name in sorted(inputs):
        batch = inputs[name]
        cols = []
        for cn, c in zip(batch.names, batch.columns):
            buf, extra = _layout(c)
            cols.append((cn, repr(c.dtype), type(c).__name__,
                         tuple(buf.shape), str(buf.dtype), buf.device.type)
                        + extra)
        out.append((name, tuple(cols)))
    return tuple(out)


def _freeze(obj):
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    return obj


def plan_cache_key(plan: ir.PlanNode, inputs: dict,
                   decisions: Optional[dict] = None) -> tuple:
    return (plan.signature(), _schema_fingerprint(inputs),
            config.knob_fingerprint(), _freeze(decisions or {}))


def result_key(plan: ir.PlanNode, inputs: dict) -> Optional[tuple]:
    """``(bound plan signature, snapshot ids, knob fingerprint)`` for
    ``plan`` over ``inputs``, or ``None`` when any scan's input contents
    are unproven.  Snapshot ids come from the bound source
    (``MorselSource.snapshot_id``) or from a snapshot already carried by
    the Scan node; nothing is hashed implicitly here."""
    snaps = {}
    for name in ir.scan_names(plan):
        src = inputs.get(name)
        sid = getattr(src, "snapshot_id", None)
        if sid is not None:
            snaps[name] = sid
    bound = ir.bind_snapshots(plan, snaps)
    ids = []
    for node in bound.walk():
        if isinstance(node, ir.Scan):
            if node.snapshot is None:
                return None  # no snapshot id, no caching, never a guess
            ids.append((node.name, node.snapshot))
    return (bound.signature(), tuple(sorted(set(ids))),
            config.knob_fingerprint())


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------

_FILTER_OPS = {
    "<": operator.lt, "<=": operator.le, ">": operator.gt,
    ">=": operator.ge, "==": operator.eq, "!=": operator.ne,
}


def _filter_mask(col, op: str, value) -> torch.Tensor:
    """Row mask of ``col <op> value``: on dictionary codes (the
    predicate over the entries once, then one gather), on packed
    residuals (``packed_filter_mask``, no decode), else on the data."""
    fn = _FILTER_OPS[op]
    if isinstance(col, PACKED_COLUMNS):
        return packed_filter_mask(col, op, value)
    if isinstance(col, DictionaryColumn):
        return predicate_mask(col, lambda d: fn(d.data, value))
    if isinstance(col, RunLengthColumn):
        col = col.decode()
    return fn(col.data, value)


def _inputs_encoded(inputs: dict) -> bool:
    return any(is_encoded(c) for b in inputs.values()
               for c in getattr(b, "columns", ()))


def _plain_int_key(col) -> bool:
    return isinstance(col, Column) and col.data.dtype in (torch.int32,
                                                          torch.int64)


def _ones(b: ColumnBatch) -> torch.Tensor:
    return torch.ones((b.num_rows,), dtype=torch.bool,
                      device=b.columns[0].device)


def _prefix(n: int, live: torch.Tensor) -> torch.Tensor:
    """``arange(n) < sum(live)``: the live-prefix mask after a regroup
    that moved the live rows to the front."""
    return torch.arange(n, device=live.device) < live.sum()


class _State:
    """Lowering cursor: ordinals into the compile-time join plans and
    aggregate hints, consumed in walk order (children first, as
    ``PlanNode.walk``)."""

    def __init__(self, join_plans, agg_hints):
        self.join_plans = join_plans
        self.agg_hints = agg_hints
        self.join_i = 0
        self.agg_i = 0


def _lower(node: ir.PlanNode, env: dict, prebuilts: tuple, st: _State):
    """Returns ``(batch, live, prefix)``: ``live`` is a bool row mask or
    None (all live); ``prefix`` records that the mask is of
    ``arange < count`` form, which is what lets it pass through an
    exchange untouched — a scattered filter mask instead becomes
    ``arange < sum(live)`` on the far side."""
    from ..parallel.partition import exchange_local

    if isinstance(node, ir.Scan):
        return env[node.name], None, True

    if isinstance(node, ir.Filter):
        b, live, _pfx = _lower(node.child, env, prebuilts, st)
        mask = _filter_mask(b[node.column], node.op, node.value)
        live = mask if live is None else live & mask
        return b, live, False

    if isinstance(node, ir.Project):
        b, live, pfx = _lower(node.child, env, prebuilts, st)
        return b.select(list(node.columns)), live, pfx

    if isinstance(node, ir.Exchange):
        b, live, pfx = _lower(node.child, env, prebuilts, st)
        staged = exchange_local(b, node.key,
                                _ones(b) if live is None else live,
                                node.partitions)
        if live is None or pfx:
            return staged, live, pfx
        return staged, _prefix(staged.num_rows, live), True

    if isinstance(node, ir.Sort):
        return _lower_sort(node, env, prebuilts, st)

    if isinstance(node, ir.Join):
        return _lower_join(node, env, prebuilts, st)

    if isinstance(node, ir.Aggregate):
        return _lower_aggregate(node, env, prebuilts, st)

    raise TypeError(f"cannot lower {type(node).__name__}")


def _lower_sort(node: ir.Sort, env, prebuilts, st):
    """Ascending, nulls first on ``node.keys``; with a live mask in
    flight, dead rows sort last (an ``__occ`` key first, descending) and
    the live rows come out as a prefix."""
    from ..columnar import types as T
    from ..relational.sort import SortKey, sort_by

    b, live, _pfx = _lower(node.child, env, prebuilts, st)
    keys = [SortKey(k) for k in node.keys]
    if live is None:
        return sort_by(b, keys), None, True
    occ = Column(live.to(torch.int32), torch.ones_like(live), T.INT32)
    out = sort_by(b.with_column("__occ", occ),
                  [SortKey("__occ", ascending=False)] + keys)
    return (out.select([nm for nm in out.names if nm != "__occ"]),
            _prefix(out.num_rows, live), True)


def _lower_join(node: ir.Join, env, prebuilts, st):
    from ..relational.join import hash_join, join_dense_or_hash

    b, live, _pfx = _lower(node.child, env, prebuilts, st)
    rb, rlive, _rpfx = _lower(node.right, env, prebuilts, st)
    info = st.join_plans[st.join_i]
    st.join_i += 1

    if info["strategy"] == "broadcast":
        out, cnt = hash_join(
            b, rb, [node.left_on], [node.right_on], node.how,
            left_valid=live, right_valid=rlive,
            prebuilt=prebuilts[info["prebuilt"]], engine=info["engine"])
    elif info["dense_domain"] is not None:
        out, cnt = join_dense_or_hash(
            b, rb, node.left_on, node.right_on, info["dense_domain"],
            node.how, left_valid=live, right_valid=rlive)
    else:
        out, cnt = hash_join(b, rb, [node.left_on], [node.right_on],
                             node.how, left_valid=live, right_valid=rlive)
    new_live = torch.arange(out.num_rows, device=cnt.device) < cnt
    return out, new_live, True


def _lower_aggregate(node: ir.Aggregate, env, prebuilts, st):
    from ..parallel.partition import exchange_local
    from ..relational import keys as _rk
    from ..relational.aggregate import (AggSpec, group_by,
                                        group_by_domain_or_sort,
                                        group_by_onehot)

    aggs = [AggSpec(a.op, a.column, a.out_name) for a in node.aggs]
    hint = st.agg_hints[st.agg_i]
    st.agg_i += 1

    child = node.child
    fuse = (isinstance(child, ir.Exchange) and len(node.keys) == 1
            and child.key == node.keys[0])
    if fuse:
        b, live, pfx = _lower(child.child, env, prebuilts, st)
        key_col = b[node.keys[0]]
        if (_plain_int_key(key_col)
                and config.get("groupby_engine") == "sort"):
            # sort-order reuse: the key's radix words ride the regroup
            # sort, so the group-by receives grouped rows and skips its
            # own sort
            segkeys = _rk.batch_radix_keys([key_col], equality=True,
                                           nulls_first=True)
            staged = exchange_local(b, child.key,
                                    _ones(b) if live is None else live,
                                    child.partitions, secondary=segkeys)
            if live is not None and not pfx:
                live = _prefix(staged.num_rows, live)
            res, ng = group_by(staged, [node.keys[0]], aggs,
                               row_valid=live, assume_grouped=True)
            return res, ng, True
        # other engines: the one-device exchange feeds a complete local
        # aggregation — elide it
    else:
        b, live, _pfx = _lower(child, env, prebuilts, st)

    key_col = b[node.keys[0]] if len(node.keys) == 1 else None
    domain_ok = (node.domain is not None and key_col is not None
                 and _plain_int_key(key_col))
    if node.onehot and domain_ok:
        if config.get("q6_group_path") == "onehot":
            res, ng, _overflow = group_by_onehot(
                b, node.keys[0], aggs, domain=int(node.domain),
                row_valid=live, float_mode=config.get("q6_float_mode"),
                engine=config.get("q6_onehot_engine"))
            return res, ng, True
        res, ng = group_by(b, list(node.keys), aggs, row_valid=live)
        return res, ng, True
    if domain_ok and not node.onehot:
        res, ng = group_by_domain_or_sort(b, node.keys[0], aggs,
                                          int(node.domain), row_valid=live)
        return res, ng, True
    kwargs = {"engine": hint} if hint else {}
    res, ng = group_by(b, list(node.keys), aggs, row_valid=live, **kwargs)
    return res, ng, True


# ---------------------------------------------------------------------------
# compiled plans
# ---------------------------------------------------------------------------

class CompiledPlan:
    """One compiled plan: the lowering closure, its spill-registered
    broadcast build tables (with the scan each was built from) and the
    recorded adaptive decisions.  ``last_lookup`` says whether the latest
    :func:`compile_plan` returning this object was a cache hit."""

    def __init__(self, plan, key, fn, input_names, build_handles,
                 decisions):
        self.plan = plan
        self.key = key
        self.fn = fn
        self.input_names = input_names
        # [(scan name, SpillableBuildTable)]
        self.build_handles = build_handles
        self.decisions = decisions
        self.last_lookup = "miss"

    def __call__(self, inputs: dict):
        from ..mem.executor import run_with_retry

        missing = [n for n in self.input_names if n not in inputs]
        if missing:
            raise KeyError(f"plan inputs missing: {missing}")
        env = {n: inputs[n] for n in self.input_names}
        with contextlib.ExitStack() as pins:
            prebuilts = []
            for name, h in self.build_handles:
                # pinned while the plan runs: an evictor may not drop a
                # table in use; a dropped one is rebuilt by get(), and a
                # cached plan over new build-side data rebuilds for it
                pins.enter_context(h.pinned())
                run_with_retry(lambda h=h, b=env[name]: h.for_batch(b))
                prebuilts.append(run_with_retry(h.get))
            return self.fn(env, tuple(prebuilts))

    @property
    def closed(self) -> bool:
        """A broadcast table was closed (its task context ended): the
        plan must compile again."""
        return any(h.tier == "closed" for _name, h in self.build_handles)

    def close(self):
        for _name, h in self.build_handles:
            h.close()


def _resolve_join_plans(plan, inputs, decisions, ctx):
    """Walk-order physical join plans, aggregate hints and the broadcast
    build tables, each pinned to the engine the plan decided and
    registered with the spill store under ``ctx``: a parked query's
    broadcast can be evicted and comes back in the decided engine's
    shape."""
    from ..relational.join import spillable_build_table

    join_plans = []
    agg_hints = []
    handles = []
    ji = ai = 0
    for node in plan.walk():
        if isinstance(node, ir.Join):
            d = decisions.get(f"join{ji}:{node.left_on}", {})
            strategy = d.get("strategy", node.strategy)
            if strategy == "auto":
                strategy = "shuffled"
            rb = inputs.get(node.right.name) \
                if isinstance(node.right, ir.Scan) else None
            dense = node.dense_domain
            if dense == "build":
                dense = rb.num_rows if rb is not None else None
            if _inputs_encoded(inputs):
                # the rowid path keys on a plain column's raw data
                dense = None
            info = {"strategy": strategy, "dense_domain": dense,
                    "prebuilt": None, "engine": None}
            if strategy == "broadcast":
                if rb is None:
                    raise ValueError(
                        "broadcast join needs a Scan build side bound "
                        "to an input batch")
                engine = d.get("engine") or adaptive.choose_join_engine()
                h = spillable_build_table(
                    rb, [node.right_on], ctx=ctx,
                    name=f"plan-bcast-{ji}-{node.left_on}", engine=engine)
                info["prebuilt"] = len(handles)
                info["engine"] = engine
                handles.append((node.right.name, h))
            join_plans.append(info)
            ji += 1
        elif isinstance(node, ir.Aggregate):
            d = decisions.get(f"aggregate{ai}:{','.join(node.keys)}", {})
            agg_hints.append(d.get("engine"))
            ai += 1
    return join_plans, agg_hints, handles


def _default_stats() -> Optional[dict]:
    """The process-wide ShuffleMetrics snapshot when any shuffle has run
    (Spark's AQE loop: earlier exchanges inform later plans), else
    ``None``."""
    from ..shuffle.registry import get_registry

    snap = get_registry().metrics.snapshot()
    if snap.get("shuffles"):
        return {"shuffle": snap}
    return None


def compile_plan(plan: ir.PlanNode, inputs: dict, ctx=None,
                 stats: Optional[dict] = None) -> CompiledPlan:
    """Compile ``plan`` against the schemas and stats of ``inputs`` (scan
    name -> ``ColumnBatch``), consulting the plan cache first.  ``ctx``
    (a ``TaskContext``) owns the broadcast build tables the plan creates;
    ``stats`` feeds :func:`adaptive.plan_decisions` and defaults to the
    shuffle registry's recorded metrics."""
    if stats is None:
        stats = _default_stats()
    decisions = adaptive.plan_decisions(plan, inputs, stats)
    key = plan_cache_key(plan, inputs, decisions)
    cache = get_plan_cache()
    cached = cache.get(key)
    if cached is not None and not cached.closed:
        cached.last_lookup = "hit"
        return cached

    _TRACE_COUNT[0] += 1
    join_plans, agg_hints, handles = _resolve_join_plans(
        plan, inputs, decisions, ctx)
    input_names = ir.scan_names(plan)

    def run(env, prebuilts):
        st = _State(join_plans, agg_hints)
        out = _lower(plan, env, prebuilts, st)
        if isinstance(plan, ir.Aggregate):
            res, ng, _pfx = out
            return res, ng
        batch, live, _pfx = out
        return batch if live is None else (batch, live)

    compiled = CompiledPlan(plan, key, run, input_names, handles, decisions)
    cache.put(key, compiled)
    return compiled


def _maybe_execute_streaming(plan: ir.PlanNode, inputs: dict, ctx=None):
    """The streaming lowering: a root ``Exchange(Scan)`` whose input binds
    a :class:`~..shuffle.morsel.MorselSource` under the ``shuffle_stream``
    knob runs :meth:`~..shuffle.service.ShuffleService.exchange_stream`
    instead of materializing the scan.  Returns ``(batch, occupancy)`` or
    ``None`` when the pattern does not apply."""
    from ..shuffle.morsel import MorselSource
    from ..shuffle.service import ShuffleService

    if not config.get("shuffle_stream"):
        return None
    if not (isinstance(plan, ir.Exchange)
            and isinstance(plan.child, ir.Scan)):
        return None
    src = inputs.get(plan.child.name)
    if not isinstance(src, MorselSource):
        return None
    if src.mesh is None:
        raise ValueError(
            "streaming lowering needs a MorselSource built against a "
            "mesh (use MorselSource.from_batch)")
    P = src.mesh.size
    if plan.partitions != P:
        raise ValueError(
            f"Exchange(partitions={plan.partitions}) cannot stream over "
            f"a {P}-shard mesh: the service partitions across shards")
    res = ShuffleService(src.mesh).exchange_stream(
        src, key_names=[plan.key], ctx=ctx)
    return res.batch, res.occupancy


def execute(plan: ir.PlanNode, inputs: dict, ctx=None,
            stats: Optional[dict] = None):
    """Compile (or fetch) and run ``plan`` over ``inputs``.  Aggregate
    roots return ``(result, num_groups)``; other roots return the batch
    (plus a live mask when one is in flight).  With the
    ``shuffle_stream`` knob on, a root ``Exchange(Scan)`` bound to a
    ``MorselSource`` takes the streaming path."""
    streamed = _maybe_execute_streaming(plan, inputs, ctx=ctx)
    if streamed is not None:
        return streamed
    return compile_plan(plan, inputs, ctx=ctx, stats=stats)(inputs)

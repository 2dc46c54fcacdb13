"""Where the time of the port's streamed exchange and slot-table build goes.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 trace_port.py [--tag NAME] [--root DIR] [--out DIR]

``--root`` imports the port from another checkout (e.g. an unpacked
parent commit), so two trees can be compared in one run.  Writes
``<out>/trace_<tag>.json`` (default ``trace_out/``) and prints a
two-line summary.  It measures, at the main path's shapes:

* the stream's map step, split: murmur3 partition id, out-of-range
  routing, the regroup sort, the bincount, the gathers of every leaf and
  the host read of the counts (CUDA events, 20 calls each), and the
  port's own ``_map_keys`` whole;
* ``torch.profiler`` over 20 morsels of the streamed exchange: device
  time by kernel, launches per morsel, the partition scatter's device
  time beside its host call time, and the device's idle share;
* the slot-table build at both main-path shapes (the q95 join build over
  dim1 and the q6 group-by build): the whole wrapper call, the int64 ->
  int32 packing of its key words alone, and the profiler's count of
  kernel launches and device time inside one build.

* the slot-table probe at both main-path shapes (the 2^24 fact keys into
  the dim1 table, S 2^22, and the rows of the q95 hash join's first join
  into dim2's 25-row table, S 64): the wrapper call, its per-call pieces
  on a tree whose wrapper packs words (owner-word gather, probe-word
  pack, ``live``/``found`` casts), the per-table slot-record build on a
  tree that has one, the kernels' device time, ``chain_bound`` and the
  probe side of ``hash_join`` over a prebuilt table;
* the one-hot group-by at q6 (2^24 rows, domain 100) and at q95's seg
  group-by: the payload build alone where the tree has one, the kernel,
  and ``_domain_partials`` whole with the profiler's launches, device
  time and ``aten::stack`` calls.

* the steps and plans these kernels serve (q6 one-hot, q95, the q95 hash
  join, ``plan.execute`` of q6 one-hot, q95 and q9): CUDA events over 3
  calls after a warm-up.
* what ``plan.execute`` of q6 on the one-hot path adds to the hand-fused
  step: both timed (CUDA events and host clock), the plan's cache lookup
  (``compile_plan`` on a hit) and its compiled call apart, and one
  profiled call of each — kernel launches, device busy time, host reads
  and the ``aten`` and CUDA runtime calls the plan makes that the step
  does not.

* the relational-breadth steps (q67's window, q6str on both group-by
  engines, the ``Sort`` plan over the q6 batch, the string inner join):
  ``torch.profiler`` over one call after a warm-up — wall and device
  busy ms, the device's idle share, and device time by kind of kernel
  (sort passes, gathers and index writes, scans, the port's kernels,
  the rest) with the top kernels.

* the decimal steps (``decimal``; the recipes and steps of
  ``chip_smoke.py``): the same profile of the decimal group-bys on every
  engine, q3's decimal revenue with both joins, each decimal op at 2^20
  rows and the streamed exchange of the string fact with a decimal
  column.

* the encoded steps (``encoded``): the same profile of ``q6str_enc``
  (the shared-dictionary q6str) beside ``q6str``, ``q95_enc`` (the q95
  stages on dictionary-encoded ``wh`` and ``seg``) and the exchange of
  the compress recipe with ``shuffle_compress`` off and ``pack`` (8
  shards), plus CUDA-event ms of the plain-torch encoded pieces at 2^24
  rows: ``pack_bits``/``unpack_bits`` at widths 9 and 12, a dictionary
  decode and ``canon[codes]``.

* the string path (``strings``): the same profile of ``qstr_step`` at
  2^20 rows and of its pieces (``get_json_object``, ``substring`` on
  each compaction engine, ``literal_range_pattern``), of the JSON scan
  machine alone at the compact fallback's 65 536-row sub-batch, and of
  the four casts at 2^20 rows, each with its top kernels and host ops.

* the memory arena (``mem``; the phases ``mem_q6_inject``,
  ``mem_q6_oom`` and ``mem_tasks`` of chip_smoke.py): the same profile
  of the four q6 hash steps of ``mem_tasks`` run in turn and of the four
  tasks sharing the oversubscribed arena, and the arena's cost a step:
  the q6 one-hot step and its groups' host read bare and inside
  ``TaskContext`` and ``run_with_retry`` with its charge (host clock, 20
  calls).

``--only probe,onehot`` runs only those sections (the names: ``map``,
``stream``, ``build``, ``probe``, ``onehot``, ``steps``, ``plan``,
``breadth``, ``decimal``, ``encoded``, ``strings``, ``mem``; the default
runs all but ``breadth``, ``decimal``, ``encoded``, ``strings`` and
``mem``).  With ``--stream-reps N``
it only times N whole streamed exchanges of the 2^24-row fact table (512
morsels); run it for two trees in turns to compare them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def ev_ms(fn, reps=20, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def profile(fn):
    """(wall ms, device busy ms, {kernel name: (count, device ms)})."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = {}
    busy = 0.0
    cpu_ops = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        dtype = str(getattr(e, "device_type", ""))
        if "CUDA" in dtype and dev_us > 0:
            # names cut to 90 characters can meet: add, do not overwrite
            c0, ms0 = kernels.get(e.key[:90], (0, 0.0))
            kernels[e.key[:90]] = (c0 + e.count, ms0 + dev_us / 1e3)
            busy += dev_us / 1e3
        elif e.key.startswith("aten::"):
            cpu_ops[e.key] = e.count
    return wall, busy, kernels, cpu_ops


def whole_stream(replays, P, reps):
    """Wall ms (host clock, ending in a synchronise), ``decode_ms`` and
    ``sync_ms`` of ``reps`` whole streamed exchanges."""
    import torch
    from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
    from spark_rapids_jni_tpu_torch.shuffle import ShuffleRegistry, \
        ShuffleService

    svc = ShuffleService(ShardMesh(P), registry=ShuffleRegistry())
    svc.exchange_stream(replays, key_names=["k"])
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = svc.exchange_stream(replays, key_names=["k"])
        torch.cuda.synchronize()
        runs.append({"ms": (time.perf_counter() - t0) * 1e3,
                     "decode_ms": r.decode_ms, "sync_ms": r.sync_ms,
                     "drain_ms": r.drain_ms, "morsels": r.morsels})
    return runs


def slot_kernels(fn, reps=5):
    """``{kernel: [launches per call, device ms per launch]}`` of the
    slot-table and one-hot kernels in ``reps`` calls of ``fn``, the
    device's busy ms per call and the ``aten::stack`` calls per call."""
    wall, busy, kern, cpu_ops = profile(lambda: [fn() for _ in range(reps)])
    mine = {k: [c / reps, ms / c] for k, (c, ms) in kern.items()
            if "slot" in k or "onehot" in k}
    return {"kernels_per_call": mine,
            "kernel_launches_per_call": sum(c for c, _ in kern.values())
            / reps,
            "device_busy_ms_per_call": busy / reps,
            "wall_ms_per_call": wall / reps,
            "aten_stack_per_call": cpu_ops.get("aten::stack", 0) / reps}


def trace_probe(fact, dim1, dim2):
    """The slot-table probe at both main-path shapes, as the q95 hash
    join makes it: the exchanged fact rows into the dim1 table, and the
    first join's rows, exchanged on ``wh``, into dim2's table."""
    import torch
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.ops import kernels as KER
    from spark_rapids_jni_tpu_torch.parallel.partition import exchange_local
    from spark_rapids_jni_tpu_torch.relational import hashtable as H
    from spark_rapids_jni_tpu_torch.relational import join as JN
    from spark_rapids_jni_tpu_torch.relational import keys as RK
    from spark_rapids_jni_tpu_torch._u32 import to_i32

    dev = fact["k"].data.device
    ones = torch.ones(fact.num_rows, dtype=torch.bool, device=dev)
    staged = exchange_local(fact, "k", ones, PL.P)
    j1, c1 = JN.hash_join(staged, dim1, ["k"], ["k"])
    j1_live = torch.arange(j1.num_rows, device=dev) < c1
    staged2 = exchange_local(j1, "wh", j1_live, PL.P)
    res = {}
    for name, (left, right, key, llive) in {
            "fact_into_dim1": (staged, dim1, "k", ones),
            "j1_into_dim2": (staged2, dim2, "wh", j1_live)}.items():
        nr = right.num_rows
        rkeys = RK.batch_radix_keys([right[key]], equality=True,
                                    nulls_first=False)
        lkeys = RK.batch_radix_keys([left[key]], equality=True,
                                    nulls_first=False)
        live = left[key].validity & llive
        tree = JN._hash_build(rkeys, nr)
        owner = tree[0]
        bound = H.chain_bound(owner, nr)

        def join():
            return JN.hash_join(left, right, [key], [key], left_valid=llive,
                                prebuilt=tree)

        def contract():
            return H.probe_slot_table(owner, rkeys, lkeys, live, bound)

        r = {"m": live.shape[0], "S": owner.shape[0], "n_build": nr,
             "W": len(lkeys), "chain_bound": bound,
             "hit_rate": contract()[0].float().mean().item(),
             "chain_bound_ms": ev_ms(lambda: H.chain_bound(owner, nr)),
             "contract_call_ms": ev_ms(contract),
             "contract_profile": slot_kernels(contract),
             "join_prebuilt_ms": ev_ms(join, reps=5),
             "join_prebuilt_profile": slot_kernels(join)}
        if hasattr(KER, "slot_table_records"):
            recs = KER.slot_table_records(owner, rkeys)
            r["record_build_ms"] = ev_ms(
                lambda: KER.slot_table_records(owner, rkeys))
            r["probe_records_ms"] = ev_ms(
                lambda: KER.slot_table_probe_records(recs, lkeys, live))
        else:  # the per-call pieces of a wrapper that packs words
            oc = owner.to(torch.int64).clamp(0, nr - 1)
            u8 = live.to(torch.uint8)
            r["owner_word_gather_ms"] = ev_ms(lambda: to_i32(torch.stack(
                [w[oc] for w in rkeys], dim=1)).contiguous())
            r["probe_word_pack_ms"] = ev_ms(lambda: to_i32(torch.stack(
                list(lkeys), dim=1)).contiguous())
            r["live_found_casts_ms"] = ev_ms(
                lambda: (live.to(torch.uint8).contiguous(),
                         u8.to(torch.bool)))
        res[name] = r
    return res


def trace_onehot(fact, dim1, dim2, rows):
    """The one-hot group-by at q6 (2^24 rows, domain 100) and at q95's seg
    group-by, through ``_domain_partials`` as the steps call it; the q6
    one-hot step whole."""
    import torch
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.ops import kernels as KER
    from spark_rapids_jni_tpu_torch.relational import aggregate as AGG

    q6b = PL.example_batch(rows)
    mask = q6b["price"].data < 50.0
    j2, c2 = PL._q95_prefix(fact, dim1, dim2, "join2")
    live2 = torch.arange(j2.num_rows, device=c2.device) < c2
    res = {}
    for name, (b, key, aggs, K, rv) in {
            "q6": (q6b, "k", list(PL.Q6_AGGS), 100, mask),
            "q95_seg": (j2, "seg", list(PL.Q95_AGGS), PL.Q95_SEG,
                        live2)}.items():

        def partials():
            return AGG._domain_partials(b, key, aggs, K, rv)

        r = {"n": b.num_rows, "domain": K + 1,
             "partials_ms": ev_ms(partials),
             "partials_profile": slot_kernels(partials)}
        payload = getattr(AGG, "_onehot_payload", None)
        if payload is not None:  # a tree that builds the payload first
            bucket, X8, F, _, _ = payload(b, key, aggs, K, rv, "f32x3")
            r["payload_ms"] = ev_ms(lambda: payload(b, key, aggs, K, rv,
                                                    "f32x3"))
            r["parts_kernel_ms"] = ev_ms(
                lambda: KER.onehot_groupby_parts(bucket, X8, F, K + 1))
        res[name] = r
    config.set("q6_group_path", "onehot")
    try:
        res["q6_onehot_step_ms"] = ev_ms(lambda: PL.q6_step(q6b), reps=5)
        res["q6_onehot_step_profile"] = slot_kernels(lambda: PL.q6_step(q6b))
    finally:
        config.reset("q6_group_path")
    return res


def trace_steps(fact, dim1, dim2, rows):
    """ms of the steps and plans the slot-table probe and the one-hot
    group-by serve, at the main path's sizes."""
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch import plan as PLAN
    from spark_rapids_jni_tpu_torch.plan import queries as Q

    q6b = PL.example_batch(rows)
    q95_in = {"fact": fact, "dim1": dim1, "dim2": dim2}
    config.set("q6_group_path", "onehot")
    try:
        return {
            "q6_onehot": ev_ms(lambda: PL.q6_step(q6b), reps=3, warmup=1),
            "plan_q6_onehot": ev_ms(lambda: PLAN.execute(
                Q.q6_plan(), {"batch": q6b}), reps=3, warmup=1),
            "q95": ev_ms(lambda: PL.q95_step(fact, dim1, dim2), reps=3,
                         warmup=1),
            "q95_hashjoin": ev_ms(lambda: PL.q95_hashjoin_step(
                fact, dim1, dim2), reps=3, warmup=1),
            "plan_q95_auto": ev_ms(lambda: PLAN.execute(
                Q.q95_plan(), q95_in), reps=3, warmup=1),
            "plan_q9": ev_ms(lambda: PLAN.execute(Q.q9_plan(), q95_in),
                             reps=3, warmup=1)}
    finally:
        config.reset("q6_group_path")


def host_ms(fn, reps=20):
    """Host time of one call, no synchronise inside the timed loop."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / reps


def trace_plan(rows):
    """``plan.execute(q6_plan())`` on the one-hot path against
    ``pipelines.q6_step``: where the plan's extra time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch import plan as PLAN
    from spark_rapids_jni_tpu_torch.plan import queries as Q

    q6b = PL.example_batch(rows)
    inputs = {"batch": q6b}

    def calls(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        cpu, launches, busy = {}, 0, 0.0
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0.0)
            if "CUDA" in str(getattr(e, "device_type", "")) and dev_us > 0:
                launches += e.count
                busy += dev_us / 1e3
            else:
                cpu[e.key] = e.count / reps
        return {"kernel_launches": launches / reps,
                "device_busy_ms": busy / reps,
                "host_reads": cpu.get("aten::_local_scalar_dense", 0),
                "stream_syncs": cpu.get("cudaStreamSynchronize", 0)}, cpu

    config.set("q6_group_path", "onehot")
    try:
        step = lambda: PL.q6_step(q6b)  # noqa: E731
        plan = lambda: PLAN.execute(Q.q6_plan(), inputs)  # noqa: E731
        plan()
        cp = PLAN.compile_plan(Q.q6_plan(), inputs)
        res = {"step_ms": ev_ms(step), "plan_ms": ev_ms(plan),
               "step_host_ms": host_ms(step), "plan_host_ms": host_ms(plan),
               "lookup_host_ms": host_ms(
                   lambda: PLAN.compile_plan(Q.q6_plan(), inputs)),
               "compiled_call_ms": ev_ms(lambda: cp(inputs)),
               "compiled_call_host_ms": host_ms(lambda: cp(inputs))}
        res["step_profile"], step_ops = calls(step)
        res["plan_profile"], plan_ops = calls(plan)
    finally:
        config.reset("q6_group_path")
    res["plan_extra_calls"] = {
        k: plan_ops.get(k, 0) - step_ops.get(k, 0)
        for k in set(plan_ops) | set(step_ops)
        if plan_ops.get(k, 0) != step_ops.get(k, 0)}
    return res


_KINDS = (("sort", ("sort", "radix")),
          ("gather_index", ("index", "gather", "take")),
          ("scan", ("scan", "cum")),
          ("port_kernels", ("slot", "onehot", "part_scatter")))


def kernel_kinds(kernels: dict) -> dict:
    """Device ms by kind of kernel (first kind whose words the name
    holds, else ``other``)."""
    out = {k: 0.0 for k, _ in _KINDS}
    out["other"] = 0.0
    for name, (_c, ms) in kernels.items():
        low = name.lower()
        kind = next((k for k, words in _KINDS
                     if any(w in low for w in words)), "other")
        out[kind] += ms
    return out


def trace_breadth(rows):
    """One profiled call of each relational-breadth step at ``rows``."""
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch import plan as PLAN
    from spark_rapids_jni_tpu_torch.plan.ir import Filter, Scan, Sort
    from spark_rapids_jni_tpu_torch.relational.join import hash_join

    q67b = PL.q67_batch(rows)
    q6s = PL.q6str_batch(rows)
    sdim = PL.q6str_dim()
    q6b = PL.example_batch(rows)
    sort_plan = Sort(Filter(Scan("batch"), "price", "<", 50.0), ("k", "v"))

    def q6str_sort():
        config.set("groupby_engine", "sort")
        try:
            return PL.q6str_step(q6s)
        finally:
            config.reset("groupby_engine")

    steps = {
        "q67": lambda: PL.q67_step(q67b),
        "q6str_kernel": lambda: PL.q6str_step(q6s),
        "q6str_sort": q6str_sort,
        "plan_sort": lambda: PLAN.execute(sort_plan, {"batch": q6b}),
        "join_str_inner": lambda: hash_join(q6s, sdim, ["k"], ["k"]),
    }
    out = {}
    for name, fn in steps.items():
        fn()  # warm: the plan compiles, the allocator fills
        wall, busy, kern, cpu_ops = profile(fn)
        out[name] = {
            "wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall,
            "kernel_launches": sum(c for c, _ in kern.values()),
            "aten_sort_calls": cpu_ops.get("aten::sort", 0),
            "device_ms_by_kind": kernel_kinds(kern),
            "top_kernels": dict(sorted(kern.items(),
                                       key=lambda kv: -kv[1][1])[:8])}
    return out


def trace_decimal(rows):
    """One profiled call of each decimal step at ``rows`` (the decimal
    recipes and steps of ``chip_smoke.py``): gb_dec on both general
    engines and through K1's decimal lanes, gb_dec_signed, gb_dec_key,
    q3dec with the dense and the hash join, each decimal op at 2^20 rows,
    and the streamed exchange of the string fact with a decimal column."""
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
    from spark_rapids_jni_tpu_torch.relational.aggregate import (
        AggSpec, group_by, group_by_onehot)
    from spark_rapids_jni_tpu_torch.shuffle import (MorselSource,
                                                    ShuffleRegistry,
                                                    ShuffleService)

    import chip_smoke as CS

    config.set("bench_rows_tpu", rows)
    dec = CS.dec_batches()
    gb = dec["gb_dec"][1]
    sg = dec["gb_dec_signed"][1]
    kb = dec["gb_dec_key"][1]
    fact, dim = dec["q3dec"][1]
    a, b = CS.dec_arith_columns(CS.DEC_ARITH_ROWS, None)
    ssrc = MorselSource.from_batch(CS.stream_str_batch(PL.q6str_batch(rows)),
                                   ShardMesh(8))
    svc = ShuffleService(ShardMesh(8), registry=ShuffleRegistry())
    dsum = [AggSpec("sum", "d", "s")]
    dall = [AggSpec("sum", "d", "s"), AggSpec("mean", "d", "m"),
            AggSpec("count", "d", "c")]
    signed = [AggSpec("sum", "d", "sd"), AggSpec("sum", "p", "sp"),
              AggSpec("mean", "d", "md"), AggSpec("mean", "p", "mp"),
              AggSpec("count", "d", "cd")]
    keyed = [AggSpec("count", None, "c"), AggSpec("sum", "v", "sv"),
             AggSpec("min", "d", "nd"), AggSpec("max", "d", "xd")]

    def engine(e, fn):
        def run():
            config.set("groupby_engine", e)
            try:
                return fn()
            finally:
                config.reset("groupby_engine")
        return run

    steps = {
        "gb_dec_kernel": engine("kernel", lambda: group_by(gb, ["k"], dsum)),
        "gb_dec_sort": engine("sort", lambda: group_by(gb, ["k"], dsum)),
        "gb_dec_onehot": lambda: group_by_onehot(gb, "k", dall, 100),
        "gb_dec_signed_kernel": engine("kernel", lambda: group_by(
            sg, ["k"], signed)),
        "gb_dec_signed_onehot": lambda: group_by_onehot(sg, "k", signed,
                                                        100),
        "gb_dec_key_kernel": engine("kernel", lambda: group_by(
            kb, ["p"], keyed, num_slots=1 << 15)),
        "gb_dec_key_sort": engine("sort", lambda: group_by(
            kb, ["p"], keyed, num_slots=1 << 15)),
        "q3dec_dense": lambda: CS.q3dec_step(fact, dim, "dense"),
        "q3dec_hash": lambda: CS.q3dec_step(fact, dim, "hash"),
        "stream_str": lambda: svc.exchange_stream(ssrc, key_names=["k"]),
    }
    for op, scale in CS.DEC_OPS:
        steps[f"dec_{op}"] = lambda o=op, sc=scale: CS._one_op(a, b, o, sc)
    out = {}
    try:
        for name, fn in steps.items():
            fn()  # warm: the allocator fills
            wall, busy, kern, cpu_ops = profile(fn)
            out[name] = {
                "wall_ms": wall, "device_busy_ms": busy,
                "idle_share": 1 - busy / wall,
                "kernel_launches": sum(c for c, _ in kern.values()),
                "device_ms_by_kind": kernel_kinds(kern),
                "top_kernels": dict(sorted(kern.items(),
                                           key=lambda kv: -kv[1][1])[:8])}
            if name.endswith("onehot"):  # host-bound: where the host waits
                out[name]["top_host_ops"] = host_ops(fn)
        out["q3dec_parts_ms"] = q3dec_parts(fact, dim)
        out["limbs_gather_ms"] = limbs_gather(gb["d"].limbs)
    finally:
        config.reset("bench_rows_tpu")
    return out


def trace_encoded(rows):
    """One profiled call of each encoded step at ``rows`` (busy and idle
    share, device ms by kind), and the plain-torch encoded pieces."""
    import numpy as np
    import torch

    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.columnar import encoded as E
    from spark_rapids_jni_tpu_torch.columnar.column import batch_from_numpy
    from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
    from spark_rapids_jni_tpu_torch.shuffle import ShuffleRegistry, \
        ShuffleService

    ((qe,),) = PL.q6str_encoded_variants(rows, (7,))
    q6s = PL.q6str_batch(rows)
    fact, dim1, dim2 = PL.q95_encoded_batches(rows)
    rng = np.random.default_rng(23)
    ones = np.ones(rows, np.bool_)
    cb = batch_from_numpy({
        "k": (rng.integers(0, 1000, rows).astype(np.int64), ones, "int64"),
        "qty": (rng.integers(-50, 50, rows).astype(np.int32), ones,
                "int32"),
        "flag": (rng.integers(0, 2, rows).astype(bool), ones, "boolean"),
        "price": (rng.standard_normal(rows).astype(np.float32), ones,
                  "float32")})
    svc = ShuffleService(ShardMesh(8), registry=ShuffleRegistry())

    def exchange(mode):
        def run():
            config.set("shuffle_compress", mode)
            try:
                return svc.exchange(cb, key_names=["k"])
            finally:
                config.reset("shuffle_compress")
        return run

    steps = {"q6str_enc": lambda: PL.q6str_step(qe),
             "q6str": lambda: PL.q6str_step(q6s),
             "q95_enc": lambda: PL.q95_encoded_step(fact, dim1, dim2),
             "exchange_off": exchange("off"),
             "exchange_pack": exchange("pack")}
    out = {}
    for name, fn in steps.items():
        fn()
        wall, busy, kern, _cpu = profile(fn)
        out[name] = {
            "wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall,
            "kernel_launches": sum(c for c, _ in kern.values()),
            "device_ms_by_kind": kernel_kinds(kern),
            "top_kernels": dict(sorted(kern.items(),
                                       key=lambda kv: -kv[1][1])[:8])}
    dev = qe["k"].codes.device
    words = torch.randint(0, 1 << 12, (rows,), device=dev)
    pieces = {}
    for w in (9, 12):
        lanes = E.pack_bits(words & ((1 << w) - 1), w)
        pieces[f"pack_bits_w{w}"] = ev_ms(
            lambda w=w: E.pack_bits(words & ((1 << w) - 1), w), reps=5)
        pieces[f"unpack_bits_w{w}"] = ev_ms(
            lambda w=w, lanes=lanes: E.unpack_bits(lanes, w, rows), reps=5)
    pieces["dictionary_decode"] = ev_ms(lambda: qe["k"].decode(), reps=5)
    pieces["canon_of_codes"] = ev_ms(
        lambda: E.canon_key_column(qe["k"]), reps=5)
    out["pieces_ms"] = pieces
    return out


def trace_strings(rows=1 << 20):
    """One profiled call of qstr, its pieces, the scan machine and the
    casts (the phases ``qstr``, ``qstr_dirty`` and ``casts`` of
    chip_smoke.py)."""
    import chip_smoke as C
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.columnar import types as TT
    from spark_rapids_jni_tpu_torch.columnar.column import resolve_device
    from spark_rapids_jni_tpu_torch.ops import cast_string as CS
    from spark_rapids_jni_tpu_torch.ops import float_to_string as FS
    from spark_rapids_jni_tpu_torch.ops import get_json_object as GJ
    from spark_rapids_jni_tpu_torch.ops import strings as STR
    from spark_rapids_jni_tpu_torch.ops.regex_rewrite import \
        literal_range_pattern

    import torch

    batch = PL.qstr_batch(rows)
    doc = batch["doc"]
    owners = GJ.get_json_object(doc, "$.owner")
    tails = STR.substring(owners, PL.QSTR_SUB_POS, PL.QSTR_SUB_LEN)
    cap = -(-rows // 16)
    sub = torch.arange(19, 20 * cap, 20, device=doc.chars.device) % rows
    scan_args = (doc.chars[sub], doc.lengths[sub], doc.validity[sub],
                 (("named", b"owner"),), owners.max_len)
    doubles, strs = C.cast_inputs(rows)
    d, s = C.cast_columns(doubles, strs, resolve_device(None))
    steps = {
        "qstr_step": lambda: PL.qstr_step(batch),
        "get_json_object": lambda: GJ.get_json_object(doc, "$.owner"),
        "substring_sort": lambda: STR.substring(
            owners, PL.QSTR_SUB_POS, PL.QSTR_SUB_LEN, engine="sort"),
        "substring_scatter": lambda: STR.substring(
            owners, PL.QSTR_SUB_POS, PL.QSTR_SUB_LEN, engine="scatter"),
        "literal_range": lambda: literal_range_pattern(
            tails, "a", 1, ord("0"), ord("9")),
        "scan_machine_65536": lambda: GJ._run(*scan_args),
        "float_to_string": lambda: FS.float_to_string(d),
        "string_to_float": lambda: CS.string_to_float(s, TT.FLOAT64),
        "string_to_integer": lambda: CS.string_to_integer(s, TT.INT64),
        "string_to_decimal": lambda: CS.string_to_decimal(s, 18, -4),
    }
    out = {}
    for name, fn in steps.items():
        fn()  # warm: the allocator fills
        wall, busy, kern, _ = profile(fn)
        out[name] = {
            "wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall,
            "kernel_launches": sum(c for c, _ in kern.values()),
            "device_ms_by_kind": kernel_kinds(kern),
            "top_kernels": dict(sorted(kern.items(),
                                       key=lambda kv: -kv[1][1])[:8]),
            "top_host_ops": host_ops(fn, top=6)}
    return out


def trace_mem(rows):
    """The four ``mem_tasks`` steps in turn and as tasks on the arena,
    profiled, and the arena's cost a q6 one-hot step."""
    import threading

    import chip_smoke as C
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.mem import (
        RmmSpark, TaskContext, batch_nbytes, run_with_retry)

    batches = [PL.example_batch(rows, s) for s in C.MEM_TASK_SEEDS]
    charge = batch_nbytes(batches[0])

    def serial():
        for b in batches:
            PL.result_groups(*PL.q6_step(b), "k")

    def tasks():
        RmmSpark.set_event_handler(int(C.MEM_POOL_TASKS * charge))
        try:
            def task(tid, b):
                with TaskContext(tid) as ctx:
                    run_with_retry(lambda: C.q6_in_parts(ctx, b, 1))
                RmmSpark.task_done(tid)

            threads = [threading.Thread(target=task, args=(i + 1, b))
                       for i, b in enumerate(batches)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(C.MEM_DEADLINE_S)
        finally:
            RmmSpark.clear_event_handler()

    out = {"charge_bytes": charge}
    config.set("q6_group_path", "sort")
    try:
        for name, fn in (("serial_4", serial), ("tasks_4", tasks)):
            fn()  # warm
            wall, busy, kern, _ = profile(fn)
            out[name] = {"wall_ms": wall, "device_busy_ms": busy,
                         "idle_share": 1 - busy / wall,
                         "kernel_launches": sum(c for c, _ in kern.values()),
                         "device_ms_by_kind": kernel_kinds(kern)}
    finally:
        config.reset("q6_group_path")
    q6b = batches[0]
    out["q6_onehot_bare_ms"] = host_ms(
        lambda: PL.result_groups(*PL.q6_step(q6b), "k"))
    RmmSpark.set_event_handler(4 * charge)
    try:
        with TaskContext(1) as ctx:
            out["q6_onehot_in_arena_ms"] = host_ms(
                lambda: run_with_retry(lambda: C.q6_in_parts(ctx, q6b, 1)))
        RmmSpark.task_done(1)
    finally:
        RmmSpark.clear_event_handler()
    return out


def limbs_gather(limbs):
    """CUDA-event ms of gathering int64[n, 2] decimal limbs by a
    sequential and a random permutation: torch's row gather against the
    port's ``gather_limbs`` (one gather per limb column)."""
    import torch

    from spark_rapids_jni_tpu_torch.relational.gather import gather_limbs

    n = limbs.shape[0]
    out = {}
    for name, idx in (("sequential", torch.arange(n, device=limbs.device)),
                      ("random", torch.randperm(n, device=limbs.device))):
        out[f"row_gather_{name}"] = ev_ms(lambda i=idx: limbs[i], reps=5)
        out[f"gather_limbs_{name}"] = ev_ms(
            lambda i=idx: gather_limbs(limbs, i), reps=5)
    return out


def q3dec_parts(fact, dim):
    """CUDA-event ms of q3dec's pieces at its shape: ``1 - disc``, the
    multiply, the dense join of the fact with ``rev``, and the group-by
    over the joined rows."""
    import torch

    import chip_smoke as CS
    from spark_rapids_jni_tpu_torch.columnar import types as T
    from spark_rapids_jni_tpu_torch.columnar.column import Decimal128Column
    from spark_rapids_jni_tpu_torch.ops import decimal as D
    from spark_rapids_jni_tpu_torch.relational.aggregate import (
        AggSpec, group_by_domain_or_sort)
    from spark_rapids_jni_tpu_torch.relational.join import \
        join_dense_or_hash

    n = fact.num_rows
    dev = fact["k"].device
    one = Decimal128Column(
        torch.tensor([[1, 0]], dtype=torch.int64, device=dev).expand(n, 2),
        torch.ones((n,), dtype=torch.bool, device=dev),
        T.SparkType.decimal(1, 0))
    om = D.null_on_overflow(*D.sub_decimal128(one, fact["disc"], 2))
    rev = D.null_on_overflow(*D.multiply_decimal128(fact["price"], om, 4))
    f2 = fact.with_column("rev", rev)
    joined, count = join_dense_or_hash(f2, dim, "k", "k", dim.num_rows)
    live = torch.arange(n, device=dev) < count
    aggs = [AggSpec("sum", "rev", "rev"), AggSpec("count", None, "cnt")]
    return {
        "one_minus_disc": ev_ms(lambda: D.sub_decimal128(
            one, fact["disc"], 2), reps=3),
        "multiply": ev_ms(lambda: D.multiply_decimal128(
            fact["price"], om, 4), reps=3),
        "dense_join": ev_ms(lambda: join_dense_or_hash(
            f2, dim, "k", "k", dim.num_rows), reps=3),
        "group_by": ev_ms(lambda: group_by_domain_or_sort(
            joined, "seg", aggs, CS.Q3_DOMAIN, row_valid=live), reps=3),
        "whole": ev_ms(lambda: CS.q3dec_step(fact, dim), reps=3)}


def host_ops(fn, top=10):
    """``{op: (calls, host ms)}`` of the ops with the most self host time
    in one call (``torch.profiler``, CPU activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {e.key: (e.count, e.self_cpu_time_total / 1e3) for e in ev[:top]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--root", default=None)
    ap.add_argument("--out", default="trace_out")
    ap.add_argument("--morsels", type=int, default=20)
    ap.add_argument("--rows", type=int, default=1 << 24,
                    help="fact and q6 rows (the main path's 2^24)")
    ap.add_argument("--only",
                    default="map,stream,build,probe,onehot,steps,plan",
                    help="comma-separated sections to run")
    ap.add_argument("--stream-reps", type=int, default=0,
                    help="only time the whole 512-morsel stream this many "
                    "times (after one warm-up run)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("trace_port: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.ops import _build
    from spark_rapids_jni_tpu_torch.ops import kernels as KER
    from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
    from spark_rapids_jni_tpu_torch.parallel.partition import \
        spark_partition_id
    from spark_rapids_jni_tpu_torch.parallel.shuffle import \
        route_out_of_range
    from spark_rapids_jni_tpu_torch.plan import adaptive as AD
    from spark_rapids_jni_tpu_torch.relational import hashtable as H
    from spark_rapids_jni_tpu_torch.relational import keys as RK
    from spark_rapids_jni_tpu_torch.relational.gather import gather_batch
    from spark_rapids_jni_tpu_torch.shuffle import MorselSource, \
        ShuffleRegistry, ShuffleService
    from spark_rapids_jni_tpu_torch.shuffle import service as SVC
    from spark_rapids_jni_tpu_torch._u32 import to_i32

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"tag": args.tag, "port": os.path.dirname(
        os.path.abspath(PL.__file__)), "card": smi,
        "build_s": _build.build_all()}
    P = 8
    fact, dim1, dim2 = PL.q95_batches(args.rows)
    src = MorselSource.from_batch(fact, ShardMesh(P))
    replays = list(src)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"trace_{args.tag}.json")
    if args.stream_reps:
        out["stream_runs"] = whole_stream(replays, P, args.stream_reps)
        with open(path, "w") as f:
            json.dump(out, f, indent=1, default=str)
        print(json.dumps(out, default=str))
        return 0

    only = set(args.only.split(","))
    dev = fact["k"].data.device
    if "map" in only:
        mb, rv = replays[0]()
        n = mb.num_rows
        pid0 = spark_partition_id([mb["k"]], P, rv)
        pid, oob = route_out_of_range(pid0, P)
        shard = torch.arange(n, device=pid.device) // (n // P)
        key = shard * (P + 1) + pid.to(torch.int64)
        perm = torch.sort(key, stable=True).indices
        counts = torch.bincount(key, minlength=P * (P + 1)).reshape(
            P, P + 1)[:, :P]
        split = {
            "replay_ms": ev_ms(replays[0]),
            "murmur3_pid_ms": ev_ms(lambda: spark_partition_id([mb["k"]], P,
                                                               rv)),
            "route_out_of_range_ms": ev_ms(lambda: route_out_of_range(pid0, P)),
            "sort_key_ms": ev_ms(lambda: shard * (P + 1) + pid.to(torch.int64)),
            "sort_ms": ev_ms(lambda: torch.sort(key, stable=True)),
            "bincount_ms": ev_ms(lambda: torch.bincount(
                key, minlength=P * (P + 1)).reshape(P, P + 1)[:, :P]),
            "gather_leaves_ms": ev_ms(lambda: gather_batch(mb, perm)),
            "host_read_ms": ev_ms(lambda: SVC._host_counts(counts, oob, P)),
            "map_keys_whole_ms": ev_ms(lambda: SVC._map_keys(mb, ["k"], rv, P)),
        }
        if hasattr(SVC, "_route_count"):  # the stream's map, no regroup
            split["map_stream_whole_ms"] = ev_ms(lambda: SVC._route_count(
                SVC._key_pid(mb, ["k"], rv, P), P))
        out["map_step"] = split

    if "stream" in only:
        few = replays[:args.morsels]
        svc = ShuffleService(ShardMesh(P), registry=ShuffleRegistry())
        svc.exchange_stream(few, key_names=["k"])  # warm
        KER.reset_launches()
        res = {}
        wall, busy, kern, cpu_ops = profile(
            lambda: res.setdefault("r", svc.exchange_stream(few,
                                                            key_names=["k"])))
        r = res["r"]
        launches = dict(KER.launches)
        nk = sum(c for c, _ in kern.values())
        out["stream_profile"] = {
            "morsels": r.morsels, "scatters": r.scatters,
            "k4_launches": launches["partition_scatter"], "wall_ms": wall,
            "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "kernel_launches_per_morsel": nk / max(r.morsels, 1),
            "decode_ms": r.decode_ms, "sync_ms": r.sync_ms,
            "drain_ms": r.drain_ms,
            "sort_calls": cpu_ops.get("aten::sort", 0),
            "index_select_calls": cpu_ops.get("aten::index_select", 0),
            "top_kernels": dict(sorted(kern.items(), key=lambda kv: -kv[1][1])
                                [:15])}
        k4 = [(k, v) for k, v in kern.items() if "scatter" in k.lower()
              and "part" in k.lower()]
        out["k4_device"] = {
            k: {"count": c, "device_ms_each": ms / max(c, 1)} for k, (c, ms)
            in k4}
        # host time of the scatter wrapper calls, as the stream makes them
        # (perf_counter around each call, no synchronise)
        spent = {}
        for name in ("partition_scatter", "partition_scatter_mapped"):
            fn = getattr(SVC, name, None)
            if fn is None:
                continue

            def timed(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    c, s = spent.get(_name, (0, 0.0))
                    spent[_name] = (c + 1, s + time.perf_counter() - t0)
            setattr(SVC, name, timed)
        cls = getattr(KER, "PartitionScatter", None)
        if cls is not None:
            call = cls.__call__

            def timed_call(self, *a, **kw):
                t0 = time.perf_counter()
                try:
                    return call(self, *a, **kw)
                finally:
                    c, s = spent.get("PartitionScatter", (0, 0.0))
                    spent["PartitionScatter"] = (c + 1,
                                                 s + time.perf_counter() - t0)
            cls.__call__ = timed_call
        try:
            svc.exchange_stream(few, key_names=["k"])
        finally:
            for name in spent:
                if name == "PartitionScatter":
                    cls.__call__ = call
                else:
                    setattr(SVC, name, getattr(KER, name))
        out["k4_host_call_ms"] = {k: s * 1e3 / c for k, (c, s)
                                  in spent.items()}

    if "build" in only:
        q6b = PL.example_batch(args.rows)
        mask = q6b["price"].data < 50.0
        rk1 = RK.batch_radix_keys([dim1["k"]], equality=True, nulls_first=False)
        ones1 = torch.ones(dim1.num_rows, dtype=torch.bool, device=dev)
        gk = RK.batch_radix_keys([q6b["k"]], equality=True, nulls_first=True)
        builds = {}
        for name, words, live, S, mr in (
                ("join_dim1", rk1, ones1, H.next_pow2(2 * dim1.num_rows), None),
                ("groupby_q6", gk, mask, 4096,
                 AD.bound_build_rounds(q6b.num_rows, 4096))):
            whole = ev_ms(lambda: KER.slot_table_build(words, live, S, mr),
                          reps=5)
            pack = ev_ms(lambda: to_i32(torch.stack(list(words), dim=1))
                         .contiguous(), reps=5)
            wall, busy, kern, _ = profile(
                lambda: KER.slot_table_build(words, live, S, mr))
            builds[name] = {
                "n": live.shape[0], "S": S, "W": len(words), "ms": whole,
                "word_pack_ms": pack, "profiled_wall_ms": wall,
                "device_busy_ms": busy,
                "kernel_launches": sum(c for c, _ in kern.values()),
                "kernels": kern}
        out["slot_table_build"] = builds

    if "probe" in only:
        out["slot_table_probe"] = trace_probe(fact, dim1, dim2)
    if "onehot" in only:
        out["onehot_groupby"] = trace_onehot(fact, dim1, dim2, args.rows)
    if "steps" in only:
        out["steps_ms"] = trace_steps(fact, dim1, dim2, args.rows)
    if "plan" in only:
        out["plan_q6_onehot"] = trace_plan(args.rows)
    if "breadth" in only:
        out["breadth"] = trace_breadth(args.rows)
    if "decimal" in only:
        out["decimal"] = trace_decimal(args.rows)
    if "encoded" in only:
        out["encoded"] = trace_encoded(args.rows)
    if "strings" in only:
        out["strings"] = trace_strings()
    if "mem" in only:
        out["mem"] = trace_mem(args.rows)

    with open(path, "w") as f:
        json.dump(out, f, indent=1, default=str)
    verbose = ("top_kernels", "kernels")
    print(json.dumps(_trim(out, verbose), default=str))
    return 0


def _trim(obj, drop):
    """``obj`` without the (nested) keys in ``drop``."""
    if isinstance(obj, dict):
        return {k: _trim(v, drop) for k, v in obj.items() if k not in drop}
    return obj


if __name__ == "__main__":
    sys.exit(main())

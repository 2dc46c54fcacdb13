"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and its ``nvidia-smi`` name/power-limit line;
2. build: compile every CUDA kernel of the port from ``csrc/`` (nvcc,
   ``sm_90a``, one process per source, all started together), and the
   memory arena's host library from ``mem/native/resource_adaptor.cpp``
   (``g++``, its version printed);
   then the memory arena (``mem/``), while little else is on the card:
   ``mem_arena`` (the reference's Monte-Carlo recipe on the adaptor as
   built here: 6 task threads, a 3 MiB pool, 2 MiB a task, seeds 11 and
   42; every task done, no deadlock, the arena drained; wall ms, retries,
   splits); ``mem_q6_inject`` (the reference's
   ``TestPipelineUnderInjectedOOM`` at 2^24 rows: the q6 one-hot step
   inside ``TaskContext(7)`` charging its batch, one injected RetryOOM,
   then one injected SplitAndRetryOOM whose retry runs the two halves
   and merges them; each equal to the oracle, K1 launched 1 then 2 times,
   the native retry and split metrics moved, the arena at 0);
   ``mem_q6_oom`` (the q6 hash step, K2, under
   ``set_per_process_memory_fraction`` set between the whole batch's
   and one half's peak: the first attempt hits a real
   ``torch.OutOfMemoryError``, the native protocol sees it, the step
   re-runs and equals the oracle; the peaks, the limit, the attempts and
   the ladder's path from the adaptor's transition log); ``mem_tasks``
   (four task threads, each the q6 hash step on its own 2^24-row batch,
   seeds 7-10, charging through ``TaskContext`` under ``run_with_retry``
   with a halving split, on one arena of 2.5 charges: all done within
   the deadline and equal to their oracles, one task at least blocked,
   the arena drained, the watchdog joined; each task's retries, splits,
   block and lost-compute ms and max charge, and the four tasks' wall
   beside four serial runs);
3. kernels: each kernel at the shapes the main path gives it, held
   against its plain PyTorch version on the same inputs (ints, owners,
   slot records and slots bit-identical; float sums rel 1e-5 of the sum
   of |x|, the reference's f32x3 tolerance), timed beside the plain
   version, a library call where one computes the same function, and the
   least time the card could take; the one-hot group-by's fused entry
   at q6 and q95's seg and its contract entry at q6, and with decimal
   lanes at gb_dec and gb_dec_signed (lanes bit-identical, its device
   time, the bound and ``index_add_`` of the four lanes) and the
   contract entry over gb_dec's decimal payload; the slot-table
   build at the joins' and group-bys' shapes, the q6str group-by's
   (W = 8) among them; the slot-table probe's record build and probe at
   both of the q95 hash join's shapes and the string join's (W = 8);
4. q6 on the one-hot path (one profiled step: one K1 launch, no
   ``aten::stack``), 5. q6 on the slot-table hash engine,
6. q95 (dense joins + one-hot group-by) and q95 through the hash join
   (two record builds, two probes): each driven once with every launch
   count at 0 just before and read just after (the one-hot contract
   entry's payload kernel must not run on any of them), checked against
   the numpy oracle, then timed;
7. the plan layer: ``plan.execute`` of q6 (one-hot and hash engines),
   q95 (both ``groupby_engine`` settings) and q9 (dim1 shuffled through
   the dense join, dim2 broadcast through a prebuilt slot table), each
   held against the hand-fused ``pipelines`` step and the numpy oracle,
   a second call checked to be a plan-cache hit with no new compile (q9's
   without a build or record build of its broadcast table), then timed;
8. relational breadth, each at 2^24 rows against its numpy oracle:
   ``q6str`` (q6 over a 24-byte string key on the slot-table engine: one
   build launch over W = 8 key words) and ``q6str_sort`` (the sort
   engine, equal to it bit for bit on ints and counts); ``plan_q6str``
   (``q6_plan()`` on the string batch); ``q3`` (a dense dimension join,
   then one fused one-hot group-by launch); ``q67`` (a partitioned rank
   and running sum, top 100); ``plan_sort`` (``Sort(Filter(...))``: the
   live rows in ``np.lexsort`` order, dead rows last); ``join_str`` (an
   inner and a left hash join of the q6str fact on a 100-row string
   dimension: two builds, two record builds and two probes at W = 8);
   ``join_kinds`` (semi, anti and full joins of the q95 fact on dim2
   with both sides' live masks);
9. decimals, each against a numpy/Python-int oracle, exactly: ``gb_dec``
   (the reference's ``group_by_decimal_sum``: sum of a decimal(38,2) by
   100 keys at 2^24 rows on the kernel engine, K2, and ``gb_dec_sort``
   equal to it bit for bit; ``gb_dec_onehot``: sum, mean and count
   through K1's decimal lanes); ``gb_dec_signed`` (signed values over
   the decimal(38) range, 1% null, groups whose sums pass +-10^38 null,
   and a decimal(7,2) revenue column, on K2 and through K1);
   ``gb_dec_key`` (a decimal(7,2) key of 10^4 prices, K2 over its key
   words at W = 3, the sort engine equal bit for bit); ``q3dec`` (TPC-H
   q3's revenue ``price * (1 - discount)`` over the q3 shape: the dense
   join, then K1's decimal lanes; ``q3dec_hashjoin`` through K2 and K3
   carrying the decimal payload); ``dec_arith`` (the reference's
   ``decimal128_multiply`` at 2^20 rows plus add, subtract, divide and
   remainder, every row bit-identical to the CPU result, and a 4096-row
   sample equal to Python decimal arithmetic with Spark's HALF_UP and
   nulls for overflow and division by zero);
10. the streaming exchange: the q95 plan's first stage,
   ``Exchange(Scan("fact"), "k")`` over a ``MorselSource`` of 8 shards
   with ``shuffle_stream`` on, checked lossless, routed, order-keeping,
   with one partition-scatter launch per morsel and no sort or gather in
   its per-morsel path, and the map step's time split; then
   ``stream_str``: the q6str fact with a decimal(38,2) column, keyed by
   its 24-byte string, 512 morsels, lossless, routed and order-keeping
   with one K4 launch a morsel over the chars and limbs leaves.

11. multi-GPU: ``multichip_dryrun`` (``pipelines.dryrun_multichip(8)`` on
   a shard mesh at the reference's 100 000 rows a device: every check the
   reference asserts, and the hash join's int64 count equal to the exact
   total computed in numpy); ``multichip_q95`` (the q95 fact row-sharded
   over 8 shards: the distributed hash join, dense broadcast join,
   exchanged group-by and map-side combine, both group-bys equal to the
   oracle, and the global sort of the fact, ordered with every row kept;
   exact per-shard launch counts, ms per operator, the all-to-all share,
   and the kernels at shard 0's shapes); ``multichip_nccl`` (the same
   operators and the sort on a ``ProcessMesh`` over NCCL at world size =
   the visible cards, at most 4, bit-identical shard for shard to a
   shard mesh of that size; one card runs it in this process), and the
   streamed exchange of the q95 fact (2^16-row morsels) on that
   ``ProcessMesh``, equal shard for shard to the shard mesh's stream;
12. encoded and compressed columns, at 2^24 rows: ``q6str_enc``
   (``q6str_encoded_variants``: the q6str recipe with its key a
   dictionary column of one shared dictionary; one K2 build over the
   null flag and the ONE canon word, groups equal to q6str's bit for bit
   on keys, sums and counts, timed in turns with q6str, which sets what
   ``encoded_execution='auto'`` means on the GPU; K2 at that shape
   against its plain version); ``q95_enc`` and ``plan_q95_enc`` (the
   q95 fact with ``wh`` and ``seg`` dictionary-encoded, through the hand
   step and ``plan.execute(q95_plan())``: exactly 3 K2 builds, 2 record
   builds, 2 probes and no K1, equal to the oracle; K3 over the
   dictionary's value words against its plain version); ``q6_packed``
   (q6's one-hot step with ``v`` bit-packed: one K1 launch, equal to q6
   bit for bit on ints); ``packed_filter`` (``packed_filter_mask`` over
   a bit-packed and a frame-of-reference column, six ops, literals in
   and out of each domain: equal to decode-then-compare with no decode);
   ``exchange_pack`` (the compress recipe over 8 shards, off and pack:
   the same rows, ``compressed_bytes_saved`` the difference of the
   ``bytes_moved``, the wire ratio and the ms of each); ``stream_zone``
   (the selectivity recipe with a zone sidecar at 1, 10 and 90 %: each
   pruned stream's surviving rows equal the filtered full stream's, the
   1 % point skips blocks, one K4 launch per kept morsel);
13. the Spark-exact string path (BASELINE config #4): ``qstr``
   (``qstr_step`` at 2^20 rows: ``tails`` byte for byte against
   ``json.loads`` and the hit count, 3 host reads, no flagged row, its
   CUDA launches, and ``left_compact_rows``' two engines timed in turns
   on its substring), ``qstr_bench`` (2^14 rows, seeds 17-20),
   ``qstr_dirty`` (every 20th document dirty: exactly those rows
   flagged, one scan-machine run a 65 536-row chunk, every row against
   the recipe and a 4096-row sample against ``tests/json_oracle.py``;
   the scan machine's ms and launches), ``qstr_groupby`` (groups and
   counts against a ``Counter``, exactly one K2 build, its key words;
   K2 at that shape against its plain version) and ``casts``
   (``string_to_float`` f64/f32, ``float_to_string``,
   ``string_to_integer``, ``string_to_decimal`` at 2^20 rows, bit for
   bit against the port's CPU result, and ``float_to_string`` against
   Java's ``Double.toString`` on a 4096-row sample).

It then prints one ``kernels`` line and, last, ``{"ok": true, "device":
...}``.  Any mismatch or exception exits nonzero without that line, as
does a machine without CUDA or a directory without the port.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
FP32_OPS_PER_S = 67e12      # H100 SXM, outside the tensor cores
FLOAT_RTOL = 1e-5           # the reference's f32x3 float-sum tolerance
N_FACT = 1 << 24            # q95 fact rows (dim1 = N_FACT / 8, dim2 = 25)

REPLACES = {
    "onehot_groupby":
        "spark_rapids_jni_tpu/ops/pallas_kernels.py:161",
    "slot_table_build":
        "spark_rapids_jni_tpu/ops/pallas_kernels.py:318",
    # the probe's per-table half: the owner words its wrapper gathers
    "slot_table_records":
        "spark_rapids_jni_tpu/ops/pallas_kernels.py:414",
    "slot_table_probe":
        "spark_rapids_jni_tpu/ops/pallas_kernels.py:414",
    "partition_scatter":
        "spark_rapids_jni_tpu/ops/pallas_kernels.py:478",
}
SOURCES = {
    "onehot_groupby": "spark_rapids_jni_tpu_torch/csrc/onehot_groupby.cu",
    "slot_table_build": "spark_rapids_jni_tpu_torch/csrc/slot_table.cu",
    "slot_table_records": "spark_rapids_jni_tpu_torch/csrc/slot_table.cu",
    "slot_table_probe": "spark_rapids_jni_tpu_torch/csrc/slot_table.cu",
    "partition_scatter":
        "spark_rapids_jni_tpu_torch/csrc/partition_scatter.cu",
}
P_SHARDS = 8                # the stream's shards (the reference's mesh)
NCCL_MORSEL_ROWS = 1 << 16  # the NCCL stream's morsels (256 at world 1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


FAILURES = []  # every failed check and phase; any entry fails the run


def check(cond: bool, what: str) -> None:
    """Record a failed check; the run goes on so one call reports all."""
    if not cond:
        FAILURES.append(what)
        print(f"chip_smoke: FAILED: {what}", file=sys.stderr, flush=True)


def guarded(name, fn, *args):
    """Run one phase; an exception fails the run but not the next phase."""
    try:
        return fn(*args)
    except Exception:  # noqa: BLE001 - recorded, reported, run fails
        import traceback

        FAILURES.append(f"{name}: {traceback.format_exc()}")
        print(f"chip_smoke: phase {name} raised:\n{traceback.format_exc()}",
              file=sys.stderr, flush=True)
        return None


def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Device time per call: CUDA events around ``reps`` calls after a
    warm-up (host waits inside a call, e.g. a round count read, count)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float = 0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


# ---------------------------------------------------------------------------
# kernels against their plain versions, at the main path's shapes
# ---------------------------------------------------------------------------

def onehot_inputs(batch, key, aggs, row_valid):
    """The fused one-hot group-by's arguments as ``_domain_partials``
    passes them: ``(key, key_valid, row_live, cols, int_sums,
    float_sums)``, and the decimal sum columns' indices."""
    from spark_rapids_jni_tpu_torch.columnar import types as T
    from spark_rapids_jni_tpu_torch.columnar.column import Decimal128Column

    names, ints, floats, decs = [], [], [], []
    for a in aggs:
        if a.column is None:
            continue
        if a.column not in names:
            names.append(a.column)
        if a.op in ("sum", "mean"):
            col = batch[a.column]
            tgt = (decs if isinstance(col, Decimal128Column) else
                   floats if col.dtype.kind in T.FLOAT_KINDS else ints)
            if names.index(a.column) not in tgt:
                tgt.append(names.index(a.column))
    cols = [(batch[c].limbs if isinstance(batch[c], Decimal128Column)
             else batch[c].data, batch[c].validity) for c in names]
    return (batch[key].data, batch[key].validity, row_valid, cols, ints,
            floats), decs


def k1_case(name, batch, key, aggs, K, row_valid):
    """The fused one-hot group-by on the raw columns the main path gives
    it, against its plain path (the reference's payload, per-bucket sums
    and limb rebuild): ints, counts and decimal lanes exact, floats rel
    1e-5 of the sum of |x|, the overflow flag equal."""
    from spark_rapids_jni_tpu_torch._u32 import M32
    from spark_rapids_jni_tpu_torch.ops import kernels as KER

    args, decs = onehot_inputs(batch, key, aggs, row_valid)
    kd, kv, live, cols, ints, floats = args
    n = kd.shape[0]
    KER.reset_launches()
    oi, of, ovf = KER.onehot_groupby_columns(*args, K, decs)
    check(KER.launches["onehot_groupby"] == 1
          and KER.launches["onehot_groupby_parts"] == 0,
          f"onehot_groupby[{name}]: {KER.launches['onehot_groupby']} fused "
          f"and {KER.launches['onehot_groupby_parts']} payload launches for "
          "one group-by")
    ri, rf, rovf = KER.onehot_groupby_columns_plain(*args, K, decs)
    torch.cuda.synchronize()
    check(torch.equal(oi, ri), f"onehot_groupby[{name}]: ints differ")
    check(bool(ovf.item()) == bool(rovf.item()),
          f"onehot_groupby[{name}]: overflow flag differs")
    err = 0.0
    if floats:
        absc = [(d.abs() if d.is_floating_point() else d, v)
                for d, v in cols]
        rabs = KER.onehot_groupby_columns_plain(kd, kv, live, absc, ints,
                                                floats, K, decs)[1]
        rel = 0.0
        for j in range(len(floats)):
            a = of[:, 3 * j:3 * j + 3].sum(1)
            b = rf[:, 3 * j:3 * j + 3].sum(1)
            err = max(err, (a - b).abs().max().item())
            scale = rabs[:, 3 * j:3 * j + 3].sum(1).clamp(min=1e-300)
            rel = max(rel, ((a - b).abs() / scale).max().item())
        check(rel <= FLOAT_RTOL,
              f"onehot_groupby[{name}]: float sums off by {rel} of sum|x|")
    ms = time_ms(lambda: KER.onehot_groupby_columns(*args, K, decs))
    plain = time_ms(lambda: KER.onehot_groupby_columns_plain(*args, K,
                                                             decs))

    # yardstick: index_add_ of the same columns by bucket (a decimal
    # column as its four u32 lanes), the bucket and the widened columns
    # made outside the timed region
    bucket = KER.onehot_payload(kd, kv, live, [], [], [], K)[0]
    idx = torch.where(bucket >= 0, bucket, K + 1).to(torch.int64)
    vi = torch.stack([torch.ones_like(kd, dtype=torch.int64)]
                     + [v.to(torch.int64) for _, v in cols]
                     + [cols[i][0].to(torch.int64) for i in ints], 1)
    vd = [torch.where(cols[i][1][:, None], cols[i][0], 0).view(torch.int32)
          .to(torch.int64) & M32 for i in decs]
    vf = (torch.stack([cols[i][0] for i in floats], 1) if floats else None)

    def library():
        torch.zeros((K + 2, vi.shape[1]), dtype=torch.int64,
                    device=kd.device).index_add_(0, idx, vi)
        for lanes in vd:
            torch.zeros((K + 2, 4), dtype=torch.int64,
                        device=kd.device).index_add_(0, idx, lanes)
        if vf is not None:
            torch.zeros((K + 2, vf.shape[1]), dtype=torch.float64,
                        device=kd.device).index_add_(0, idx, vf)

    lib = time_ms(library)
    # the raw columns read once: key and its validity, the row mask, each
    # column's validity, each sum column's data (a decimal's 16 bytes);
    # the partials written once
    nbytes = n * (kd.element_size() + 1 + (1 if live is not None else 0)
                  + len(cols)
                  + sum(cols[i][0].element_size()
                        * cols[i][0][0].numel()
                        for i in ints + floats + decs)) \
        + (K + 1) * (oi.shape[1] + of.shape[1]) * 8
    mi, mf = oi.shape[1], of.shape[1]
    b, by = bound_ms(nbytes, n * (mi + 3 * mf))
    out = {"shape": name, "form": "fused_columns", "n": n, "domain": K + 1,
           "int_partials": mi, "float_partials": mf,
           "decimal_columns": len(decs), "overflow": bool(ovf.item()),
           "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b,
           "bound_by": by, "library_ms": lib}
    if decs:
        out["device_ms"] = device_ms(
            lambda: KER.onehot_groupby_columns(*args, K, decs),
            "onehot_columns")
    return out


def k1_contract_case(name, batch, key, aggs, K, row_valid):
    """The reference's contract entry (a built int8/f32 payload: a
    decimal column's 16 offset byte limbs and negative flag among it) on
    the payload kernel, against its plain version."""
    from spark_rapids_jni_tpu_torch.ops import kernels as KER

    (kd, kv, live, cols, ints, floats), decs = onehot_inputs(
        batch, key, aggs, row_valid)
    bucket, X8, F, _ = KER.onehot_payload(kd, kv, live, cols, ints, floats,
                                          K, decs)
    n, mi = X8.shape
    mf = F.shape[1]
    dom = K + 1
    KER.reset_launches()
    oi, of = KER.onehot_groupby_parts(bucket, X8, F, dom)
    check(KER.launches["onehot_groupby_parts"] == 1
          and KER.launches["onehot_groupby"] == 0,
          f"onehot_groupby[{name}]: the contract entry did not run its "
          "payload kernel once")
    ri, rf = KER.onehot_groupby_parts_plain(bucket, X8, F, dom)
    torch.cuda.synchronize()
    check(torch.equal(oi, ri), f"onehot_groupby[{name}]: int sums differ")
    err = (of - rf).abs().max().item() if mf else 0.0
    if mf:
        # a float sum's rounding scales with the sum of |x| (the Dekker
        # mid/lo limbs are signed residuals whose sums sit near zero), so
        # the f32x3 tolerance applies relative to the plain sum of |x|
        _, rabs = KER.onehot_groupby_parts_plain(bucket, X8, F.abs(), dom)
        rel = ((of - rf).abs() / rabs.clamp(min=1e-300)).max().item()
        check(rel <= FLOAT_RTOL,
              f"onehot_groupby[{name}]: float sums off by {rel} of sum|x|")
    ms = time_ms(lambda: KER.onehot_groupby_parts(bucket, X8, F, dom))
    plain = time_ms(lambda: KER.onehot_groupby_parts_plain(bucket, X8, F,
                                                           dom))
    # yardstick: index_add_ over the same payload, widened outside the
    # timed region (int8 would wrap); row `dom` collects the dead rows
    idx = torch.where(bucket >= 0, bucket, dom).to(torch.int64)
    pi64, pf64 = X8.to(torch.int64), F.to(torch.float64)

    def library():
        torch.zeros((dom + 1, mi), dtype=torch.int64,
                    device=X8.device).index_add_(0, idx, pi64)
        if mf:
            torch.zeros((dom + 1, mf), dtype=torch.float64,
                        device=X8.device).index_add_(0, idx, pf64)

    lib = time_ms(library)
    nbytes = n * (4 + mi + 4 * mf) + dom * (mi + mf) * 8
    b, by = bound_ms(nbytes, n * (mi + mf))
    return {"shape": name, "form": "contract_payload", "n": n,
            "domain": dom, "mi": mi, "mf": mf, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": b, "bound_by": by,
            "library_ms": lib}


def k2_case(name, words, live, S, max_rounds):
    from spark_rapids_jni_tpu_torch.ops import kernels as KER

    n, W = live.shape[0], len(words)
    KER.reset_launches()
    got = KER.slot_table_build(words, live, S, max_rounds)
    check(KER.launches["slot_table_build"] == 1,
          f"slot_table_build[{name}]: {KER.launches['slot_table_build']} "
          "launches for one build")
    ref = KER.slot_table_build_plain(words, live, S,
                                     S if max_rounds is None else max_rounds)
    torch.cuda.synchronize()
    for a, r, what in zip(got, ref, ("owner", "slot", "overflow")):
        check(torch.equal(a, r), f"slot_table_build[{name}]: {what} differs")
    ms = time_ms(lambda: KER.slot_table_build(words, live, S, max_rounds))
    plain = time_ms(lambda: KER.slot_table_build_plain(
        words, live, S, S if max_rounds is None else max_rounds), reps=2)
    # words as carried (int64, 8 B each), live 1 B; owner S x 4 B, slot
    # n x 4 B
    b, by = bound_ms(n * (8 * W + 1) + S * 4 + n * 4)
    return {"shape": name, "n": n, "S": S, "W": W,
            "overflow": bool(got[2].item()), "max_abs_err": 0,
            "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
            "library_ms": None}, got[0]


def k3_records_case(name, owner, bwords):
    """The per-table slot-record build (one launch) against its plain
    version: records and chain bound bit-identical."""
    from spark_rapids_jni_tpu_torch.ops import kernels as KER

    S, n, W = owner.shape[0], bwords[0].shape[0], len(bwords)
    KER.reset_launches()
    got = KER.slot_table_records(owner, bwords)
    check(KER.launches["slot_table_records"] == 1,
          f"slot_table_records[{name}]: not one launch")
    ref = KER.slot_table_records_plain(owner, bwords)
    torch.cuda.synchronize()
    check(torch.equal(got.rec, ref.rec),
          f"slot_table_records[{name}]: records differ")
    check(torch.equal(got.bound, ref.bound),
          f"slot_table_records[{name}]: chain bound differs")
    ms = time_ms(lambda: KER.slot_table_records(owner, bwords))
    plain = time_ms(lambda: KER.slot_table_records_plain(owner, bwords),
                    reps=2)
    R = got.rec.shape[1]
    occupied = int((owner != n).sum().item())
    # owner read once, each occupied slot's owner words as carried (8 B
    # each), the records written once
    b, by = bound_ms(S * 4 + occupied * 8 * W + S * R * 4)
    return {"shape": name, "S": S, "n_build": n, "W": W, "record_bytes":
            4 * R, "chain_bound": int(got.bound[0].item()),
            "max_abs_err": 0, "ms": ms, "plain_ms": plain, "bound_ms": b,
            "bound_by": by, "library_ms": None}, got


def k3_case(name, owner, bwords, pwords, live, rounds, recs):
    """The probe over a table's records, as the hash join calls it, held
    bit-identical to the reference's round-by-round walk; the contract
    entry (records + probe) too."""
    from spark_rapids_jni_tpu_torch.ops import kernels as KER

    S, n, m, W = owner.shape[0], bwords[0].shape[0], live.shape[0], \
        len(pwords)
    KER.reset_launches()
    got = KER.slot_table_probe_records(recs, pwords, live)
    check(KER.launches["slot_table_probe"] == 1
          and KER.launches["slot_table_records"] == 0,
          f"slot_table_probe[{name}]: not one launch and no record build")
    ref = KER.slot_table_probe_plain(owner, bwords, pwords, live, rounds)
    contract = KER.slot_table_probe(owner, bwords, pwords, live, rounds)
    torch.cuda.synchronize()
    for a, c, r, what in zip(got, contract, ref, ("found", "slot")):
        check(torch.equal(a, r), f"slot_table_probe[{name}]: {what} differs")
        check(torch.equal(c, r),
              f"slot_table_probe[{name}]: contract entry {what} differs")
    ms = time_ms(lambda: KER.slot_table_probe_records(recs, pwords, live))
    plain = time_ms(lambda: KER.slot_table_probe_plain(
        owner, bwords, pwords, live, rounds), reps=2)
    # probe words as carried (8 B each) and live read once, the table's
    # records read once, found and slot written once
    b, by = bound_ms(m * (8 * W + 1) + recs.rec.numel() * 4 + m * 5)
    return {"shape": name, "m": m, "S": S, "n_build": n, "W": W,
            "rounds": rounds, "hit_rate": got[0].float().mean().item(),
            "smem": S * recs.rec.shape[1] * 4 <= 48 * 1024,
            "max_abs_err": 0, "ms": ms, "plain_ms": plain, "bound_ms": b,
            "bound_by": by, "library_ms": None}


def fact_morsel(fact, j, invalid_tail=0):
    """Morsel ``j`` of the streamed fact table and its row validity; the
    last ``invalid_tail`` rows of every shard made invalid."""
    from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
    from spark_rapids_jni_tpu_torch.shuffle.morsel import MorselSource

    src = MorselSource.from_batch(fact, ShardMesh(P_SHARDS))
    mb, rv = list(src)[j]()
    if invalid_tail:
        rv = rv.clone().reshape(P_SHARDS, -1)
        rv[:, rv.shape[1] - invalid_tail:] = False
        rv = rv.reshape(-1)
    return mb, rv


def k4_morsel(fact, j, invalid_tail):
    """Morsel ``j`` regrouped as the materialized exchange maps it (the
    reference's form of the scatter's input)."""
    from spark_rapids_jni_tpu_torch.shuffle import service as SVC

    from spark_rapids_jni_tpu_torch.shuffle.buffers import batch_leaves

    mb, rv = fact_morsel(fact, j, invalid_tail)
    regrouped, counts, _ = SVC._map_keys(mb, ["k"], rv, P_SHARDS)
    return batch_leaves(regrouped), counts.to(torch.int32).contiguous()


def device_ms(fn, kernel_substr, reps=20):
    """Device time of one launch of the kernel whose name contains
    ``kernel_substr``, from ``torch.profiler`` over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if kernel_substr in e.key and e.count:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            return us / e.count / 1e3
    return None


def host_call_ms(fn, reps=20):
    """Host time of one call, no synchronise inside the timed loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / reps


def k4_mapped_case(name, fact, j, invalid_tail, C, base_of):
    """The map-order scatter as the stream calls it: morsel ``j`` in map
    order, its pids, ``base = base_of(counts)``, every round it touches
    in one launch — against the plain version on the same rounds."""
    from spark_rapids_jni_tpu_torch.ops import kernels as KER
    from spark_rapids_jni_tpu_torch.shuffle import service as SVC
    from spark_rapids_jni_tpu_torch.shuffle.buffers import batch_leaves

    P = S = P_SHARDS
    mb, rv = fact_morsel(fact, j, invalid_tail)
    pid, counts, _, _ = SVC._route_count(SVC._key_pid(mb, ["k"], rv, P),
                                         P)
    leaves = [x.contiguous() for x in batch_leaves(mb)]
    base = base_of(counts).to(torch.int64).contiguous()
    M = leaves[0].shape[0] // S
    nz = counts > 0
    r_lo = int((base[nz] // C).min().item()) if nz.any() else 0
    r_hi = int(((base + counts - 1)[nz] // C).max().item()) \
        if nz.any() else 0

    def fresh():
        return {r: ([torch.zeros((S * P * C,) + tuple(x.shape[1:]),
                                 dtype=x.dtype, device=x.device)
                     for x in leaves],
                    torch.zeros((S * P * C,), dtype=torch.bool,
                                device=pid.device))
                for r in range(r_lo, r_hi + 1)}

    KER.reset_launches()
    got = KER.partition_scatter_mapped(fresh(), leaves, pid, base, P, C)
    check(KER.launches["partition_scatter"] == 1,
          f"partition_scatter[{name}]: not one launch for "
          f"{r_hi - r_lo + 1} rounds")
    ref = KER.partition_scatter_mapped_plain(fresh(), leaves, pid, base, P,
                                             C)
    torch.cuda.synchronize()
    written = 0
    for r in got:
        check(torch.equal(got[r][1], ref[r][1]),
              f"partition_scatter[{name}] r{r}: occ")
        for a, b in zip(got[r][0], ref[r][0]):
            check(torch.equal(a, b),
                  f"partition_scatter[{name}] r{r}: chunk leaf differs")
        written += int(got[r][1].sum().item())
    check(written == int(counts.sum().item()),
          f"partition_scatter[{name}]: {written} rows placed of "
          f"{int(counts.sum().item())}")
    # the stream's form: the per-stream state built once, then one call
    # per morsel
    rounds = fresh()
    sc = KER.PartitionScatter(leaves, S, P, C)
    for r, (lv, oc) in rounds.items():
        sc.open_round(r, lv, oc)

    def call():
        sc(leaves, pid, base, r_lo, r_hi)

    ms = time_ms(call, reps=20)
    host = host_call_ms(call)
    dev_ms = device_ms(call, "part_scatter")
    plain = time_ms(lambda: KER.partition_scatter_mapped_plain(
        rounds, leaves, pid, base, P, C), reps=5)
    row_bytes = sum(x.element_size() * x.shape[1:].numel() for x in leaves)
    # the morsel's leaves, pids and base read once; the placed rows and
    # their occ bytes written once
    nbytes = S * M * (row_bytes + 4) + S * P * 8 + written * (row_bytes + 1)
    b, by = bound_ms(nbytes)
    return {"shape": name, "form": "map_order", "S": S, "P": P, "M": M,
            "C": C, "rounds": r_hi - r_lo + 1, "leaves": len(leaves),
            "row_bytes": row_bytes, "rows_written": written,
            "max_abs_err": 0, "ms": ms, "host_call_ms": host,
            "device_ms": dev_ms, "plain_ms": plain, "bound_ms": b,
            "bound_by": by, "library_ms": None}


def k4_case(name, leaves, cnts, C, rounds):
    """The reference's regrouped form (one round a call), on the same
    kernel: each bucket's base sits half its count below the round
    boundary, so round 0 and round 1 both receive rows."""
    from spark_rapids_jni_tpu_torch.ops import kernels as KER

    P = cnts.shape[1]
    S = cnts.shape[0]
    M = leaves[0].shape[0] // S
    base = (C - cnts // 2).to(torch.int32).contiguous()

    def fresh():
        return ([torch.zeros((S * P * C,) + tuple(x.shape[1:]),
                             dtype=x.dtype, device=x.device)
                 for x in leaves],
                torch.zeros((S * P * C,), dtype=torch.bool,
                            device=cnts.device))

    written = 0
    for r in rounds:
        gc, go = fresh()
        KER.partition_scatter(gc, go, leaves, cnts, base, r, P, C)
        rc, ro = fresh()
        KER.partition_scatter_plain(rc, ro, leaves, cnts, base, r, P, C)
        torch.cuda.synchronize()
        check(torch.equal(go, ro), f"partition_scatter[{name}] r{r}: occ")
        for a, b in zip(gc, rc):
            check(torch.equal(a, b),
                  f"partition_scatter[{name}] r{r}: chunk leaf differs")
        if r == rounds[0]:
            written = int(go.sum().item())
    gc, go = fresh()
    r0 = rounds[0]
    ms = time_ms(lambda: KER.partition_scatter(gc, go, leaves, cnts, base,
                                               r0, P, C), reps=20)
    plain = time_ms(lambda: KER.partition_scatter_plain(
        gc, go, leaves, cnts, base, r0, P, C), reps=5)
    row_bytes = sum(x.element_size() * x.shape[1:].numel() for x in leaves)
    # every morsel row's leaves + cnts and base read once; the rows of
    # round r0 written once with their occ byte
    nbytes = S * M * row_bytes + 2 * S * P * 4 + written * (row_bytes + 1)
    b, by = bound_ms(nbytes)
    return {"shape": name, "form": "regrouped", "S": S, "P": P, "M": M,
            "C": C, "leaves": len(leaves), "row_bytes": row_bytes,
            "rows_written": written, "max_abs_err": 0, "ms": ms,
            "plain_ms": plain, "bound_ms": b, "bound_by": by,
            "library_ms": None}


def kernel_case(cases, kernel, label, fn, *args):
    """Run one kernel case, print its line and keep it in ``cases``; a
    case that raises is recorded and left out."""
    out = guarded(f"kernel {kernel}[{label}]", fn, *args)
    if out is not None:
        case = out[0] if isinstance(out, tuple) else out
        emit({"phase": "kernel", "kernel": kernel, **case})
        cases[kernel].append(case)
    return out


def phase_kernels(q6b, fact, dim1, dim2, q6s, sdim, dec):
    """Every kernel case; returns ``{kernel: [case, ...]}`` (main shape
    first).  A case that raises is recorded and left out."""
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.plan import adaptive as AD
    from spark_rapids_jni_tpu_torch.relational import hashtable as H
    from spark_rapids_jni_tpu_torch.relational import keys as RK

    cases = {k: [] for k in REPLACES}

    def run(kernel, label, fn, *args):
        return kernel_case(cases, kernel, label, fn, *args)

    dev = q6b["k"].data.device
    mask = q6b["price"].data < 50.0
    run("onehot_groupby", "q6", k1_case, "q6", q6b, "k", list(PL.Q6_AGGS),
        100, mask)
    j2, c2 = PL._q95_prefix(fact, dim1, dim2, "join2")
    live2 = torch.arange(j2.num_rows, device=dev) < c2
    run("onehot_groupby", "q95_seg", k1_case, "q95_seg", j2, "seg",
        list(PL.Q95_AGGS), PL.Q95_SEG, live2)
    # the reference's contract entry over a built payload, at q6
    run("onehot_groupby", "q6_contract", k1_contract_case, "q6_contract",
        q6b, "k", list(PL.Q6_AGGS), 100, mask)
    # decimal lanes: gb_dec's sum/mean/count of decimal(38,2) (2^24 rows,
    # 100 keys), gb_dec_signed's two decimal columns with nulls and
    # negatives, and the contract entry over gb_dec's decimal payload
    from spark_rapids_jni_tpu_torch.relational.aggregate import AggSpec

    dec_aggs = [AggSpec("sum", "d", "s"), AggSpec("mean", "d", "m"),
                AggSpec("count", "d", "c")]
    gbd = dec["gb_dec"][1]
    run("onehot_groupby", "gb_dec", k1_case, "gb_dec", gbd, "k", dec_aggs,
        100, None)
    run("onehot_groupby", "gb_dec_signed", k1_case, "gb_dec_signed",
        dec["gb_dec_signed"][1], "k",
        dec_aggs + [AggSpec("sum", "p", "sp")], 100, None)
    run("onehot_groupby", "gb_dec_contract", k1_contract_case,
        "gb_dec_contract", gbd, "k", dec_aggs, 100, None)

    # the join build over dim1 (S = 2 x rows, no round bound) and the
    # group-by build over q6 (S = 4096, the adaptive round bound)
    rk1 = RK.batch_radix_keys([dim1["k"]], equality=True, nulls_first=False)
    ones1 = torch.ones(dim1.num_rows, dtype=torch.bool, device=dev)
    S1 = H.next_pow2(2 * dim1.num_rows)
    out = run("slot_table_build", "join_dim1", k2_case, "join_dim1", rk1,
              ones1, S1, None)
    gk = RK.batch_radix_keys([q6b["k"]], equality=True, nulls_first=True)
    run("slot_table_build", "groupby_q6", k2_case, "groupby_q6", gk, mask,
        4096, AD.bound_build_rounds(q6b.num_rows, 4096))
    # the hot spot alone: every one of 2^24 rows live on 100 keys
    run("slot_table_build", "hot_spot_100_keys", k2_case,
        "hot_spot_100_keys", gk, torch.ones_like(mask), 4096,
        AD.bound_build_rounds(q6b.num_rows, 4096))

    # the probe at both main-path shapes of the q95 hash join: the
    # exchanged fact keys into the dim1 table (S 2^22), and the first
    # join's rows, exchanged on wh, into dim2's 25-row table (S 64)
    if out is not None:
        from spark_rapids_jni_tpu_torch.parallel.partition import \
            exchange_local
        from spark_rapids_jni_tpu_torch.relational import join as JN

        owner1 = out[1]
        ones = torch.ones(fact.num_rows, dtype=torch.bool, device=dev)
        staged = exchange_local(fact, "k", ones, PL.P)
        j1, c1 = JN.hash_join(staged, dim1, ["k"], ["k"])
        j1_live = torch.arange(j1.num_rows, device=dev) < c1
        staged2 = exchange_local(j1, "wh", j1_live, PL.P)
        rk2 = RK.batch_radix_keys([dim2["wh"]], equality=True,
                                  nulls_first=False)
        owner2 = H.build_slot_table(rk2, torch.ones(
            dim2.num_rows, dtype=torch.bool, device=dev),
            H.next_pow2(2 * dim2.num_rows))[0]
        for label, owner, bw, left, key, llive in (
                ("fact_into_dim1", owner1, rk1, staged, "k", ones),
                ("j1_into_dim2", owner2, rk2, staged2, "wh", j1_live)):
            rec = run("slot_table_records", label, k3_records_case, label,
                      owner, bw)
            if rec is None:
                continue
            pk = RK.batch_radix_keys([left[key]], equality=True,
                                     nulls_first=False)
            run("slot_table_probe", label, k3_case, label, owner, bw, pk,
                left[key].validity & llive,
                H.chain_bound(owner, bw[0].shape[0]), rec[1])

    # W = 8: the q6str group-by's build (2^24 rows, S 4096, the
    # adaptive round bound), and the string join's 100-row dimension
    # table (S 256, 9-word records in shared memory) probed by the
    # 2^24-row fact
    smask = q6s["price"].data < 50.0
    sk = RK.batch_radix_keys([q6s["k"]], equality=True, nulls_first=True)
    run("slot_table_build", "groupby_q6str", k2_case, "groupby_q6str", sk,
        smask, 4096, AD.bound_build_rounds(q6s.num_rows, 4096))
    (fk,), (dk,) = RK.align_string_key_columns([q6s["k"]], [sdim["k"]])
    sbw = RK.batch_radix_keys([dk], equality=True, nulls_first=False)
    sowner = H.build_slot_table(sbw, torch.ones(
        sdim.num_rows, dtype=torch.bool, device=dev),
        H.next_pow2(2 * sdim.num_rows))[0]
    rec = run("slot_table_records", "join_str", k3_records_case, "join_str",
              sowner, sbw)
    if rec is not None:
        spk = RK.batch_radix_keys([fk], equality=True, nulls_first=False)
        run("slot_table_probe", "join_str", k3_case, "join_str", sowner, sbw,
            spk, fk.validity.clone(), H.chain_bound(sowner, sdim.num_rows),
            rec[1])

    # the stream's scatter, map order: a fact morsel (8 shards x 4096
    # rows, C 2^16) across a round boundary; one whose shards end in
    # invalid rows; one spanning three rounds (C 256)
    C = int(config.get("shuffle_round_rows"))
    M = int(config.get("scan_morsel_rows"))
    run("partition_scatter", "fact_morsel_round_boundary", k4_mapped_case,
        "fact_morsel_round_boundary", fact, 0, 0, C,
        lambda cnt: C - cnt // 2)
    run("partition_scatter", "fact_morsel_padding_tail", k4_mapped_case,
        "fact_morsel_padding_tail", fact, 1, M // 4, C,
        lambda cnt: C - cnt // 2)
    run("partition_scatter", "fact_morsel_three_rounds", k4_mapped_case,
        "fact_morsel_three_rounds", fact, 3, 0, 256,
        lambda cnt: torch.full_like(cnt, 128))
    # the reference's regrouped one-round form, kept as an entry
    for label, j, tail in (("regrouped_round_boundary", 0, 0),
                           ("regrouped_padding_tail", 1, M // 4),
                           ("regrouped_empty", 2, M)):
        leaves, cnts = k4_morsel(fact, j, tail)
        run("partition_scatter", label, k4_case, label, leaves, cnts, C,
            (0, 1))
    return cases


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def driven(fn, *args):
    """One run of ``fn`` with every launch count at 0 just before; returns
    its result, the launch counts of that run, and its wall seconds."""
    from spark_rapids_jni_tpu_torch.ops import kernels as KER

    torch.cuda.synchronize()
    KER.reset_launches()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return out, dict(KER.launches), dt


def check_q6(res, ng, arrays, label):
    from spark_rapids_jni_tpu_torch import pipelines as PL

    return check_q6_groups(PL.result_groups(res, ng, "k"), arrays, label)


def check_q6_groups(got, arrays, label):
    """q6's groups (``result_groups``' form) against the numpy oracle:
    sums and counts exact, avg(price) rel ``FLOAT_RTOL``."""
    from spark_rapids_jni_tpu_torch import pipelines as PL

    uniq, sums, cnts, avgs = PL.q6_oracle(*arrays)
    check(sorted(got) == uniq.tolist(), f"{label}: groups differ")
    worst = 0.0
    for k, s, c, a in zip(uniq.tolist(), sums, cnts, avgs):
        check(got[k]["sum_v"] == int(s), f"{label}: sum(v) of {k}")
        check(got[k]["cnt"] == int(c), f"{label}: count of {k}")
        worst = max(worst, abs(got[k]["avg_price"] - a) / abs(a))
    check(worst <= FLOAT_RTOL, f"{label}: avg(price) rel err {worst}")
    return worst


def check_q95(res, ng, arrays, label):
    from spark_rapids_jni_tpu_torch import pipelines as PL

    orders, net = PL.q95_oracle(arrays)
    got = PL.result_groups(res, ng, "seg")
    check(int(ng) == PL.Q95_SEG, f"{label}: {int(ng)} groups")
    for s in range(PL.Q95_SEG):
        check(got[s]["orders"] == int(orders[s]), f"{label}: orders[{s}]")
        check(got[s]["net"] == int(net[s]), f"{label}: net[{s}]")


def q6_stages(q6b):
    """Where q6's one-hot step spends its time: the group-by's partials
    (one fused K1 launch over the raw columns), and one profiled step,
    which must launch K1 once and build no payload (no ``aten::stack``)."""
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.ops import kernels as KER
    from spark_rapids_jni_tpu_torch.relational import aggregate as AGG

    mask = q6b["price"].data < 50.0
    partials = time_ms(lambda: AGG._domain_partials(
        q6b, "k", list(PL.Q6_AGGS), 100, mask))
    torch.cuda.synchronize()
    KER.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        PL.q6_step(q6b)
        torch.cuda.synchronize()
    k1 = KER.launches["onehot_groupby"]
    ev = prof.key_averages()
    stacks = sum(e.count for e in ev if e.key == "aten::stack")
    kernels = sum(e.count for e in ev
                  if "CUDA" in str(getattr(e, "device_type", ""))
                  and (getattr(e, "self_device_time_total", None) or
                       getattr(e, "self_cuda_time_total", 0.0)) > 0)
    check(k1 == 1, f"q6_onehot: {k1} K1 launches in one profiled step")
    check(stacks == 0, f"q6_onehot: {stacks} aten::stack in one step (a "
          "payload build)")
    return {"partials_ms": partials, "k1_launches_in_step": k1,
            "aten_stack_in_step": stacks, "kernels_in_step": kernels}


def q95_stages(fact, dim1, dim2):
    """Cumulative ms of the q95 step truncated after each stage."""
    from spark_rapids_jni_tpu_torch import pipelines as PL

    return {f"upto_{u}_ms": time_ms(lambda u=u: PL._q95_prefix(
        fact, dim1, dim2, u), reps=3) for u in ("exch1", "join1", "join2")}


def check_counts(name, counts, needs, exact):
    # the main path runs the fused one-hot group-by, never the contract
    # entry's payload kernel
    check(counts["onehot_groupby_parts"] == 0,
          f"{name}: {counts['onehot_groupby_parts']} launches of the one-hot "
          "contract entry's payload kernel")
    for k in needs:
        check(counts[k] > 0, f"{name}: kernel {k} was not launched")
    for k, want in (exact or {}).items():
        check(counts[k] == want,
              f"{name}: {counts[k]} {k} launches, expected {want}")


def phase_path(name, fn, args, rows, verify, needs, stages=None,
               exact=None):
    """Drive one pipeline: counts, oracle check, then steady-state time."""
    (res, ng), counts, first_s = driven(fn, *args)
    extra = verify(res, ng)
    check_counts(name, counts, needs, exact)
    ms = time_ms(lambda: fn(*args), reps=3)
    line = {"phase": name, "rows": rows, "groups": int(ng),
            "launches": counts, "first_run_s": first_s, "ms": ms,
            "mrows_per_s": rows / (ms * 1e-3) / 1e6}
    if extra is not None:
        line["avg_price_max_rel_err"] = extra
    if stages is not None:
        line["stages"] = stages()
    emit(line)
    return counts


# ---------------------------------------------------------------------------
# relational breadth: string keys, sort, window, the other join kinds
# ---------------------------------------------------------------------------

def phase_run(name, fn, rows, verify, needs=(), exact=None, info=None):
    """Drive ``fn()`` once with every launch count at 0 (checked), verify
    its output (``verify`` returns extra fields for the line), then time
    it."""
    out, counts, first_s = driven(fn)
    extra = verify(out) or {}
    check_counts(name, counts, needs, exact)
    ms = time_ms(fn, reps=3)
    emit({"phase": name, "rows": rows, "launches": counts,
          "first_run_s": first_s, "ms": ms,
          "mrows_per_s": rows / (ms * 1e-3) / 1e6, **(info or {}), **extra})
    return counts, out


def no_kernels():
    from spark_rapids_jni_tpu_torch.ops import kernels as KER

    return {k: 0 for k in KER.launches}


def check_q6str(res, ng, arrays, label):
    """q6str's groups against the oracle: the 100 string keys in order,
    sums and counts exact, avg(price) rel ``FLOAT_RTOL``."""
    from spark_rapids_jni_tpu_torch import pipelines as PL

    kidx, _, v, price = arrays
    keys, sums, cnts, avgs = PL.q6str_oracle(kidx, v, price)
    got = PL.result_groups(res, ng, "k")
    check(list(got) == keys, f"{label}: groups differ")
    worst = 0.0
    for k, sm, c, a in zip(keys, sums, cnts, avgs):
        g = got.get(k, {})
        check(g.get("sum_v") == int(sm), f"{label}: sum(v) of {k}")
        check(g.get("cnt") == int(c), f"{label}: count of {k}")
        if g.get("avg_price") is not None:
            worst = max(worst, abs(g["avg_price"] - a) / abs(a))
    check(worst <= FLOAT_RTOL, f"{label}: avg(price) rel err {worst}")
    return {"avg_price_max_rel_err": worst}


def same_string_groups(a, b, label):
    """Two q6str results equal bit for bit on keys, ints and counts."""
    (ra, na), (rb, nb) = a, b
    g = int(na)
    check(g == int(nb), f"{label}: {g} vs {int(nb)} groups")
    for buf in ("chars", "lengths", "validity"):
        check(torch.equal(getattr(ra["k"], buf)[:g],
                          getattr(rb["k"], buf)[:g]),
              f"{label}: key {buf} differ")
    for c in ("sum_v", "cnt"):
        check(torch.equal(ra[c].data[:g], rb[c].data[:g]),
              f"{label}: {c} differs")
    da, db = ra["avg_price"].data[:g], rb["avg_price"].data[:g]
    check(bool(((da - db).abs() <= FLOAT_RTOL * db.abs()).all().item()),
          f"{label}: avg(price) beyond rel {FLOAT_RTOL}")


def check_q3(res, ng, arrays):
    from spark_rapids_jni_tpu_torch import pipelines as PL

    rev, cnt = PL.q3_oracle(arrays)
    got = PL.result_groups(res, ng, "seg")
    check(int(ng) == PL.Q3_SEG, f"q3: {int(ng)} groups")
    for sg in range(PL.Q3_SEG):
        g = got.get(sg, {})
        check(g.get("rev") == int(rev[sg]), f"q3: rev[{sg}]")
        check(g.get("cnt") == int(cnt[sg]), f"q3: cnt[{sg}]")


def check_q67(out, arrays):
    from spark_rapids_jni_tpu_torch import pipelines as PL

    order, rank, run = PL.q67_oracle(*arrays)
    check(np.array_equal(out["sorted_row"].data.cpu().numpy(), order),
          "q67: the sort permutation differs")
    check(np.array_equal(out["rk"].data.cpu().numpy(), rank),
          "q67: ranks differ")
    check(np.array_equal(out["run_sales"].data.cpu().numpy(), run),
          "q67: running sums differ")
    top = rank <= PL.Q67_TOP
    for c in ("rk", "run_sales", "cat", "sales"):
        check(np.array_equal(out[c].validity.cpu().numpy(), top),
              f"q67: the top-{PL.Q67_TOP} mask of {c} differs")
    return {"partitions": PL.Q67_CATS, "rows_kept": int(top.sum())}


def phase_plan_sort(q6b, arrays):
    """``Sort(Filter(Scan("batch"), "price", "<", 50.0), ("k", "v"))``
    over the q6 batch: the live rows first, in ``np.lexsort`` order of
    (k, v), the dead rows after them; a second call hits the cache."""
    from spark_rapids_jni_tpu_torch import plan as PLAN
    from spark_rapids_jni_tpu_torch.plan.ir import Filter, Scan, Sort

    def make():
        return Sort(Filter(Scan("batch"), "price", "<", 50.0), ("k", "v"))

    inputs = {"batch": q6b}
    PLAN.reset_plan_cache()

    def verify(out):
        batch, live = out
        k, v, price = arrays
        idx = np.flatnonzero(price < 50.0)
        want = idx[np.lexsort((v[idx], k[idx]))]
        m = int(live.sum().item())
        check(m == len(idx), f"plan_sort: {m} live rows, want {len(idx)}")
        check(bool(live[:m].all().item()) and not bool(live[m:].any()
                                                         .item()),
              "plan_sort: the live rows are no prefix")
        for c, host in (("k", k), ("v", v), ("price", price)):
            got = batch[c].data[:m].cpu().numpy()
            check(np.array_equal(got, host[want]),
                  f"plan_sort: column {c} out of order")
        check(bool((batch["price"].data[m:] >= 50.0).all().item()),
              "plan_sort: a live row sorted among the dead")
        return {"live_rows": m}

    counts, _ = phase_run("plan_sort", lambda: PLAN.execute(make(), inputs),
                          q6b.num_rows, verify, (), no_kernels())
    t0 = PLAN.trace_count()
    cp = PLAN.compile_plan(make(), inputs)
    check(cp.last_lookup == "hit", "plan_sort: second call missed the cache")
    check(PLAN.trace_count() == t0, "plan_sort: second call compiled")
    return counts


def phase_join_str(q6s, arrays, sdim):
    """Inner and left hash joins of the q6str fact on the 100-row string
    dimension (width 21, aligned to 24: W = 8 words): two builds, two
    record builds, two probes; rows checked against numpy."""
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.relational import join as JN

    kidx, _, v, _ = arrays
    n = len(kidx)
    dev = q6s["v"].data.device
    hit_h = kidx < 90
    dv_h = np.arange(len(PL.Q6STR_DIM_KEYS), dtype=np.int64) * 37 % 1000
    hit = torch.from_numpy(hit_h).to(dev)
    vd = torch.from_numpy(v).to(dev)
    want_dv = torch.from_numpy(dv_h[kidx]).to(dev)

    def both():
        return (JN.hash_join(q6s, sdim, ["k"], ["k"], "inner"),
                JN.hash_join(q6s, sdim, ["k"], ["k"], "left"))

    def verify(out):
        (ri, ci), (rl, cl) = out
        m = int(hit_h.sum())
        check(int(ci) == m, f"join_str: inner count {int(ci)}, want {m}")
        check(torch.equal(ri["v"].data[:m], vd[hit]), "join_str: inner v")
        check(torch.equal(ri["dv"].data[:m], want_dv[hit]),
              "join_str: inner dv")
        check(torch.equal(ri["k"].chars[:m], q6s["k"].chars[hit]),
              "join_str: inner keys")
        check(bool(ri["dv"].validity[:m].all().item()),
              "join_str: inner null dv")
        check(int(cl) == n, f"join_str: left count {int(cl)}, want {n}")
        check(torch.equal(rl["v"].data, vd), "join_str: left v")
        check(torch.equal(rl["dv"].validity, hit),
              "join_str: left null pattern")
        check(torch.equal(rl["dv"].data[hit], want_dv[hit]),
              "join_str: left dv")
        return {"inner_rows": m, "left_null_rows": n - m}

    from spark_rapids_jni_tpu_torch.relational import keys as RK

    (fk,), _ = RK.align_string_key_columns([q6s["k"]], [sdim["k"]])
    W = len(RK.batch_radix_keys([fk], equality=True, nulls_first=False))
    counts, _ = phase_run(
        "join_str", both, n, verify,
        ("slot_table_build", "slot_table_records", "slot_table_probe"),
        {"slot_table_build": 2, "slot_table_records": 2,
         "slot_table_probe": 2},
        {"key_words": W, "dim_rows": sdim.num_rows})
    return counts


def phase_join_kinds(fact, dim2, arrays):
    """Semi, anti and full joins of the q95 fact on dim2 (``wh``), the
    fact's rows with wh 3 dead and dim2's rows with wh >= 20 dead: each
    kind's rows against numpy; a build, a record build and a probe each."""
    from spark_rapids_jni_tpu_torch.relational import join as JN

    wh = arrays["fact"]["wh"]
    v = arrays["fact"]["v"]
    d2 = arrays["dim2"]["d2"]
    dev = fact["wh"].data.device
    lv = fact["wh"].data != 3
    rv = dim2["wh"].data < 20
    live_h = wh != 3
    semi_rows = np.flatnonzero(live_h & (wh < 20))
    anti_rows = np.flatnonzero(live_h & (wh >= 20))

    def kinds():
        return {how: JN.hash_join(fact, dim2, ["wh"], ["wh"], how,
                                  left_valid=lv, right_valid=rv)
                for how in ("semi", "anti", "full")}

    def rows_of(batch, count, want, label):
        check(int(count) == len(want),
              f"join_kinds: {label} count {int(count)}, want {len(want)}")
        m = len(want)
        for c, host in (("wh", wh), ("v", v)):
            check(torch.equal(batch[c].data[:m],
                              torch.from_numpy(host[want]).to(dev)),
                  f"join_kinds: {label} column {c}")

    def verify(out):
        rows_of(*out["semi"], semi_rows, "semi")
        rows_of(*out["anti"], anti_rows, "anti")
        full, cf = out["full"]
        live_rows = np.flatnonzero(live_h)
        lc = len(live_rows)
        check(int(cf) == lc + 1, f"join_kinds: full count {int(cf)}, "
              f"want {lc + 1} (the live rows and dim2's wh 3)")
        check(torch.equal(full["v"].data[:lc],
                          torch.from_numpy(v[live_rows]).to(dev)),
              "join_kinds: full left rows")
        matched = torch.from_numpy(wh[live_rows] < 20).to(dev)
        check(torch.equal(full["wh_r"].validity[:lc], matched),
              "join_kinds: full null pattern")
        check(torch.equal(full["d2"].data[:lc][matched], torch.from_numpy(
            d2[wh[live_rows]]).to(dev)[matched]), "join_kinds: full d2")
        check(int(full["wh_r"].data[lc].item()) == 3
              and not bool(full["v"].validity[lc].item()),
              "join_kinds: full appended row")
        return {"semi_rows": len(semi_rows), "anti_rows": len(anti_rows),
                "full_rows": lc + 1}

    counts, _ = phase_run(
        "join_kinds", kinds, fact.num_rows, verify,
        ("slot_table_build", "slot_table_records", "slot_table_probe"),
        {"slot_table_build": 3, "slot_table_records": 3,
         "slot_table_probe": 3})
    return counts


# ---------------------------------------------------------------------------
# the plan layer and the streaming exchange
# ---------------------------------------------------------------------------

def same_groups(got, ng, want, wng, key, floats, label):
    """A plan's result against the hand-fused step's: the same groups,
    ints and counts exact, floats rel ``FLOAT_RTOL``."""
    from spark_rapids_jni_tpu_torch import pipelines as PL

    a = PL.result_groups(got, ng, key)
    b = PL.result_groups(want, wng, key)
    check(sorted(a, key=str) == sorted(b, key=str),
          f"{label}: groups differ from the pipelines step")
    for k in set(a) & set(b):
        for col, v in b[k].items():
            g = a[k].get(col)
            if col in floats and v is not None and g is not None:
                check(abs(g - v) <= FLOAT_RTOL * abs(v),
                      f"{label}: {col} of {k}: {g} vs {v}")
            else:
                check(g == v, f"{label}: {col} of {k}: {g} vs {v}")


def check_q9(res, ng, arrays, label):
    from spark_rapids_jni_tpu_torch import pipelines as PL

    net, orders = PL.q9_oracle(arrays)
    got = PL.result_groups(res, ng, "seg")
    check(int(ng) == PL.Q95_SEG, f"{label}: {int(ng)} groups")
    worst = 0.0
    for s in range(PL.Q95_SEG):
        check(got[s]["net_hi"] == int(net[s]), f"{label}: net_hi[{s}]")
        check(got[s]["orders_hi"] == int(orders[s]),
              f"{label}: orders_hi[{s}]")
        want = net[s] / orders[s]
        worst = max(worst, abs(got[s]["avg_hi"] - want) / abs(want))
    check(worst <= FLOAT_RTOL, f"{label}: avg_hi rel err {worst}")
    return worst


def phase_plan(name, make_plan, inputs, verify, needs, exact=None,
               exact_again=None):
    """``plan.execute`` once from an empty plan cache (counts at 0 just
    before), verified; then a second call that must hit the cache with no
    new compile (``exact_again``: its launch counts); then timed."""
    from spark_rapids_jni_tpu_torch import plan as PLAN

    PLAN.reset_plan_cache()
    (res, ng), counts, first_s = driven(
        lambda: PLAN.execute(make_plan(), inputs))
    extra = verify(res, ng)
    check_counts(name, counts, needs, exact)
    t0 = PLAN.trace_count()
    cp = PLAN.compile_plan(make_plan(), inputs)
    again, counts_again, _ = driven(cp, inputs)
    check_counts(f"{name} (second call)", counts_again, (), exact_again)
    check(cp.last_lookup == "hit", f"{name}: second call missed the cache")
    check(PLAN.trace_count() == t0, f"{name}: second call compiled")
    check(int(again[1]) == int(ng), f"{name}: second call differs")
    ms = time_ms(lambda: PLAN.execute(make_plan(), inputs), reps=3)
    rows = inputs["fact"].num_rows if "fact" in inputs else \
        inputs["batch"].num_rows
    line = {"phase": name, "rows": rows, "groups": int(ng),
            "launches": counts, "launches_second_call": counts_again,
            "first_run_s": first_s, "decisions": cp.decisions, "ms": ms,
            "mrows_per_s": rows / (ms * 1e-3) / 1e6}
    if extra is not None:
        line["float_max_rel_err"] = extra
    emit(line)
    return counts


def phase_stream(fact, k4):
    """The q95 plan's first stage as a streaming stage over 8 shards:
    lossless, every occupied row on the shard its pid names, each
    (sender, destination) bucket in the sender's order, one
    partition-scatter launch per morsel, and no sort or gather in the
    per-morsel map (profiled over a few morsels).  Reports ``decode_ms``,
    ``sync_ms`` and one morsel's map step split."""
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch import plan as PLAN
    from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
    from spark_rapids_jni_tpu_torch.parallel.partition import \
        spark_partition_id
    from spark_rapids_jni_tpu_torch.plan.ir import Exchange, Scan
    from spark_rapids_jni_tpu_torch.relational.keys import lexsort
    from spark_rapids_jni_tpu_torch.shuffle import MorselSource, \
        ShuffleRegistry, ShuffleService, get_registry

    P = P_SHARDS
    n = fact.num_rows
    src = MorselSource.from_batch(fact, ShardMesh(P))
    plan = Exchange(Scan("fact"), "k")
    config.set("shuffle_stream", True)
    try:
        (out, occ), counts, first_s = driven(
            lambda: PLAN.execute(plan, {"fact": src}))
        reg = get_registry()
        info = reg.shuffles()[max(reg.shuffles())]
        ms = time_ms(lambda: PLAN.execute(plan, {"fact": src}), reps=2)
    finally:
        config.reset("shuffle_stream")
    cols = ("k", "wh", "seg", "v")
    check(info.rows_moved == n, f"stream: rows_moved {info.rows_moved}")
    check(int(occ.sum().item()) == n, "stream: occupied rows != input rows")
    check(counts["partition_scatter"] == info.morsels,
          f"stream: {counts['partition_scatter']} scatter launches for "
          f"{info.morsels} morsels")
    check(counts["partition_scatter"] > 0, "stream: K4 was not launched")
    total = occ.shape[0]
    dev = occ.device
    shard = torch.arange(total, device=dev) // (total // P)
    pid = spark_partition_id([out["k"]], P).to(torch.int64)
    check(bool((pid[occ] == shard[occ]).all().item()),
          "stream: an occupied row sits on a shard its pid does not name")
    check(bool(torch.stack([out[c].validity for c in cols])[:, occ]
               .all().item()), "stream: an occupied row is null")
    # the delivered rows per (destination, sender) in slot order must be
    # the input's rows of that bucket in the sender's order: lossless,
    # routed and order-keeping at once
    C, rounds = info.capacity, info.rounds
    order = torch.arange(total, device=dev).reshape(
        P, rounds, P, C).transpose(1, 2).reshape(-1)
    got_rows = order[occ[order]]
    sender = torch.arange(n, device=dev) // (n // P)
    in_pid = spark_partition_id([fact["k"]], P).to(torch.int64)
    want_rows = torch.sort(in_pid * P + sender, stable=True).indices
    for c in cols:
        check(torch.equal(out[c].data[got_rows], fact[c].data[want_rows]),
              f"stream: column {c} differs from the input's buckets")
    # and the multiset, explicitly
    a = [out[c].data[occ].to(torch.int64) for c in cols]
    b = [fact[c].data.to(torch.int64) for c in cols]
    pa, pb = lexsort(a), lexsort(b)
    check(all(torch.equal(x[pa], y[pb]) for x, y in zip(a, b)),
          "stream: delivered multiset differs from the input's")
    # where one morsel's time goes: its slice (replay), the map step
    # (murmur3 pid, then out-of-range routing and the bincount of the
    # counts) and the host read of its counts; then the scatter call
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_jni_tpu_torch.shuffle import service as SVC

    replay = list(src)[0]
    mb, rv = replay()
    pid = SVC._key_pid(mb, ["k"], rv, P)
    _, m_counts, m_oob, _ = SVC._route_count(pid, P)
    per_morsel = {
        "replay_ms": time_ms(replay, reps=20),
        "murmur3_pid_ms": time_ms(lambda: SVC._key_pid(mb, ["k"], rv, P),
                                  reps=20),
        "route_and_count_ms": time_ms(lambda: SVC._route_count(pid, P),
                                      reps=20),
        "host_read_ms": time_ms(lambda: SVC._host_counts(m_counts, m_oob,
                                                         P), reps=20),
        "scatter_ms": (k4 or {}).get("ms"),
        "scatter_host_call_ms": (k4 or {}).get("host_call_ms"),
        "scatter_device_ms": (k4 or {}).get("device_ms")}
    # no sort and no gather in the per-morsel path
    few = list(src)[:8]
    svc = ShuffleService(ShardMesh(P), registry=ShuffleRegistry())
    svc.exchange_stream(few, key_names=["k"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        svc.exchange_stream(few, key_names=["k"])
        torch.cuda.synchronize()
    ops = {e.key: e.count for e in prof.key_averages()}
    regroup_ops = {k: ops.get(k, 0) for k in ("aten::sort", "aten::index",
                                               "aten::index_select")}
    check(not any(regroup_ops.values()),
          f"stream: the per-morsel path sorted or gathered {regroup_ops}")
    scat_ms = (k4 or {}).get("ms") or 0.0
    k4_total = scat_ms * counts["partition_scatter"]
    emit({"phase": "stream_exchange", "rows": n, "shards": P,
          "morsels": info.morsels, "rounds": info.rounds,
          "capacity": info.capacity, "scatters": info.scatters,
          "rounds_overlapped": info.rounds_overlapped,
          "bytes_moved": info.bytes_moved, "launches": counts,
          "first_run_s": first_s, "ms": ms,
          "mrows_per_s": n / (ms * 1e-3) / 1e6,
          "decode_ms": info.decode_ms, "sync_ms": info.sync_ms,
          "drain_ms": info.drain_ms,
          "k4_ms_est": k4_total, "k4_share": k4_total / ms,
          "per_morsel_ms": per_morsel,
          "regroup_ops_in_8_morsels": regroup_ops})
    return counts


# ---------------------------------------------------------------------------
# decimals: group-bys, decimal keys, q3's revenue, arithmetic, and the
# string/decimal stream
# ---------------------------------------------------------------------------

DEC_ARITH_ROWS = 1 << 20    # the reference's decimal128_multiply row count
DEC_SAMPLE_ROWS = 4096      # rows held against Python decimal arithmetic
Q3_DOMAIN = 5


def _limbs_u64(lo, hi=None):
    """uint64[n, 2] decimal limbs from a low limb and a signed high limb
    (default: the low limb's sign extension of a nonnegative value)."""
    out = np.zeros((lo.shape[0], 2), np.uint64)
    out[:, 0] = lo.astype(np.uint64)
    if hi is not None:
        out[:, 1] = hi.astype(np.int64).view(np.uint64)
    return out


def gb_dec_arrays(n, seed=70):
    """The reference's ``group_by_decimal_sum`` rows (bench.py:2841):
    decimal(38,2) with the low limb in [0, 2^50), then keys in [0, 100),
    drawn in its order."""
    r = np.random.default_rng(seed)
    lo = r.integers(0, 1 << 50, n, dtype=np.uint64)
    k = r.integers(0, 100, n).astype(np.int32)
    return {"k": k, "d": _limbs_u64(lo)}


def gb_dec_signed_arrays(n, seed=71):
    """Signed decimal(38,2) values, about 1% null: keys 0-9 draw high
    limbs in [2^61, 2^62) (sums pass +10^38), 10-19 in [-2^62, -2^61)
    (sums pass -10^38), 20-59 the whole range |v| < 2^126 < 10^38 (sums
    of about 1.7e5 such values pass 10^38 too), 60-99 |v| < 2^62 (sums
    stay in range); and a TPC-DS revenue column decimal(7,2)."""
    r = np.random.default_rng(seed)
    k = r.integers(0, 100, n).astype(np.int32)
    hi = r.integers(-(1 << 62), 1 << 62, n)
    hi = np.where(k < 10, r.integers(1 << 61, 1 << 62, n), hi)
    hi = np.where((k >= 10) & (k < 20), r.integers(-(1 << 62), -(1 << 61),
                                                   n), hi)
    lo = r.integers(0, 1 << 63, n).astype(np.uint64) * np.uint64(2) \
        + r.integers(0, 2, n).astype(np.uint64)
    small = r.integers(-(1 << 62), 1 << 62, n)
    lo = np.where(k >= 60, small.view(np.uint64), lo)
    hi = np.where(k >= 60, np.where(small < 0, -1, 0), hi)
    return {"k": k, "d": _limbs_u64(lo, hi),
            "d_valid": r.random(n) >= 0.01,
            "p": r.integers(-(10 ** 7 - 1), 10 ** 7, n),
            "p_valid": r.random(n) >= 0.01}


def gb_dec_key_arrays(n, seed=72):
    """A decimal(7,2) price key of 10^4 distinct values (1% null), an
    int64 ``v`` and a signed decimal(38,2) ``d`` (2% null)."""
    r = np.random.default_rng(seed)
    price = r.integers(0, 10 ** 4, n) * 7 + 100
    lo = r.integers(0, 1 << 63, n).astype(np.uint64) * np.uint64(2)
    return {"p": price, "p_valid": r.random(n) >= 0.01,
            "v": r.integers(-1000, 1000, n),
            "d": _limbs_u64(lo, r.integers(-(1 << 62), 1 << 62, n)),
            "d_valid": r.random(n) >= 0.02}


def q3dec_arrays(n, seed=11):
    """``_q3_batches``' recipe (__graft_entry__.py:387: keys into a dense
    dim of n / 4 rows, five segments) with TPC-H lineitem's money
    columns: ``l_extendedprice`` decimal(12,2) in [900.00, 105000.00)
    and ``l_discount`` decimal(12,2) in [0.00, 0.10]."""
    r = np.random.default_rng(seed)
    nd = max(n // 4, 1)
    return {"k": r.integers(0, nd, n).astype(np.int32),
            "seg": r.integers(0, Q3_DOMAIN, n).astype(np.int32),
            "price": r.integers(90_000, 10_500_000, n),
            "disc": r.integers(0, 11, n), "nd": nd,
            "dv": r.integers(0, 10, nd)}


def dec_batches(device=None):
    """Every decimal phase's batch at its size."""
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch.columnar.column import batch_from_numpy

    n = int(config.get("bench_rows_tpu"))
    out = {}
    a = gb_dec_arrays(n)
    ones = np.ones(n, np.bool_)
    out["gb_dec"] = (a, batch_from_numpy({
        "k": (a["k"], ones, "int32"), "d": (a["d"], ones, "decimal(38,2)")},
        device))
    a = gb_dec_signed_arrays(n)
    out["gb_dec_signed"] = (a, batch_from_numpy({
        "k": (a["k"], ones, "int32"),
        "d": (a["d"], a["d_valid"], "decimal(38,2)"),
        "p": (_limbs_u64(a["p"], a["p"] >> 63), a["p_valid"],
              "decimal(7,2)")}, device))
    a = gb_dec_key_arrays(n)
    out["gb_dec_key"] = (a, batch_from_numpy({
        "p": (_limbs_u64(a["p"]), a["p_valid"], "decimal(7,2)"),
        "v": (a["v"], ones, "int64"),
        "d": (a["d"], a["d_valid"], "decimal(38,2)")}, device))
    a = q3dec_arrays(n)
    nd = a["nd"]
    fact = batch_from_numpy({
        "k": (a["k"], ones, "int32"), "seg": (a["seg"], ones, "int32"),
        "price": (_limbs_u64(a["price"]), ones, "decimal(12,2)"),
        "disc": (_limbs_u64(a["disc"]), ones, "decimal(12,2)")}, device)
    dim = batch_from_numpy({
        "k": (np.arange(nd, dtype=np.int32), np.ones(nd, np.bool_),
              "int32"),
        "dv": (a["dv"], np.ones(nd, np.bool_), "int64")}, device)
    out["q3dec"] = (a, (fact, dim))
    return out


def group_sums(keys, limbs, valid, G):
    """Exact per-group sums of decimal limbs (uint64[n, 2]) as Python
    ints: each 16-bit chunk of the unsigned 128-bit pattern summed by
    bincount (exact in float64: below 2^40), less 2^128 per negative."""
    w = valid.astype(np.float64)
    total = [0] * G
    for j in range(8):
        chunk = ((limbs[:, j // 4] >> np.uint64(16 * (j % 4)))
                 & np.uint64(0xFFFF)).astype(np.float64)
        s = np.bincount(keys, weights=chunk * w, minlength=G)
        for g in range(G):
            total[g] += int(s[g]) << (16 * j)
    neg = np.bincount(keys, weights=((limbs[:, 1] >> np.uint64(63))
                                     .astype(np.float64) * w), minlength=G)
    return [total[g] - (int(neg[g]) << 128) for g in range(G)]


def spark_sum(s, precision):
    """A decimal(p, s) sum as Spark gives it: null past 10^min(38, p+10)."""
    return s if abs(s) < 10 ** min(38, precision + 10) else None


def spark_avg(s, cnt, precision):
    """Spark's avg over decimal(p, 2) sums: bounded(p + 4, 6), HALF_UP."""
    if cnt == 0:
        return None
    p_res = min(precision + 4, 38)
    q, r = divmod(abs(s) * 10 ** 4, cnt)
    q += 2 * r >= cnt
    return (-q if s < 0 else q) if q < 10 ** p_res else None


def decimal_groups(res, ng, key):
    """``{key: {column: value}}`` over the live groups; decimals as their
    unscaled Python ints."""
    from spark_rapids_jni_tpu_torch.columnar.column import Decimal128Column

    g = int(ng)
    vals = {}
    for name, c in zip(res.names, res.columns):
        if isinstance(c, Decimal128Column):
            vals[name] = Decimal128Column(c.limbs[:g], c.validity[:g],
                                          c.dtype).to_pylist()
        else:
            d, v = c.data[:g].tolist(), c.validity[:g].tolist()
            vals[name] = [x if ok else None for x, ok in zip(d, v)]
    return {kk: {n: vals[n][i] for n in vals if n != key}
            for i, kk in enumerate(vals[key])}


def check_groups(got, want, label):
    check(list(got) == list(want),
          f"{label}: groups {list(got)[:5]}... differ from "
          f"{list(want)[:5]}...")
    bad = [k for k in want if got.get(k) != want[k]]
    check(not bad, f"{label}: {len(bad)} groups differ, e.g. {bad[:3]}: "
          f"{[got.get(k) for k in bad[:1]]} vs {[want[k] for k in bad[:1]]}")


def same_batches(a, b, label):
    """Two results equal bit for bit on their first rows, every leaf."""
    from spark_rapids_jni_tpu_torch.shuffle.buffers import batch_leaves

    (ra, na), (rb, nb) = a, b
    g = int(na)
    check(g == int(nb), f"{label}: {g} vs {int(nb)} groups")
    for x, y in zip(batch_leaves(ra), batch_leaves(rb)):
        check(torch.equal(x[:g], y[:g]), f"{label}: a column differs")


def phase_gb_dec(arrays, b):
    """``group_by_decimal_sum``: sum(d) by k on the kernel (K2) and sort
    engines, and sum/mean/count through the fused K1's decimal lanes."""
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch.relational.aggregate import (
        AggSpec, group_by, group_by_onehot)

    n = b.num_rows
    sums = group_sums(arrays["k"], arrays["d"], np.ones(n, bool), 100)
    cnt = np.bincount(arrays["k"], minlength=100)
    want = {g: {"s": spark_sum(sums[g], 38)} for g in range(100)}
    counts = {}
    outs = {}
    for engine, needs in (("kernel", {"slot_table_build": 1}),
                          ("sort", no_kernels())):
        name = "gb_dec" if engine == "kernel" else "gb_dec_sort"
        config.set("groupby_engine", engine)
        try:
            c, out = phase_run(
                name, lambda: group_by(b, ["k"], [AggSpec("sum", "d", "s")]),
                n, lambda o, nm=name: check_groups(
                    decimal_groups(*o, "k"), want, nm),
                ("slot_table_build",) if engine == "kernel" else (), needs,
                {"engine": engine})
        finally:
            config.reset("groupby_engine")
        counts[name], outs[engine] = c, out
    same_batches(outs["kernel"], outs["sort"], "gb_dec_sort vs gb_dec")
    aggs = [AggSpec("sum", "d", "s"), AggSpec("mean", "d", "m"),
            AggSpec("count", "d", "c")]
    want1 = {g: {"s": spark_sum(sums[g], 38),
                 "m": spark_avg(sums[g], int(cnt[g]), 38),
                 "c": int(cnt[g])} for g in range(100)}

    def onehot():
        res, ng, ovf = group_by_onehot(b, "k", aggs, 100)
        return res, ng

    counts["gb_dec_onehot"], _ = phase_run(
        "gb_dec_onehot", onehot, n,
        lambda o: check_groups(decimal_groups(*o, "k"), want1,
                               "gb_dec_onehot"),
        ("onehot_groupby",), {"onehot_groupby": 1, "slot_table_build": 0})
    return counts


def phase_gb_dec_signed(arrays, b):
    """Signed values over the decimal(38,2) range with nulls (sums past
    +-10^38 null) and a decimal(7,2) revenue column (sum decimal(17,2)),
    on the kernel engine (K2) and through K1's decimal lanes."""
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch.relational.aggregate import (
        AggSpec, group_by, group_by_onehot)

    n = b.num_rows
    k = arrays["k"]
    sd = group_sums(k, arrays["d"], arrays["d_valid"], 100)
    p_limbs = _limbs_u64(arrays["p"], arrays["p"] >> 63)
    sp = group_sums(k, p_limbs, arrays["p_valid"], 100)
    cd = np.bincount(k, weights=arrays["d_valid"], minlength=100)
    cp = np.bincount(k, weights=arrays["p_valid"], minlength=100)
    aggs = [AggSpec("sum", "d", "sd"), AggSpec("sum", "p", "sp"),
            AggSpec("mean", "d", "md"), AggSpec("mean", "p", "mp"),
            AggSpec("count", "d", "cd")]
    want = {g: {"sd": spark_sum(sd[g], 38), "sp": spark_sum(sp[g], 7),
                "md": spark_avg(sd[g], int(cd[g]), 38),
                "mp": spark_avg(sp[g], int(cp[g]), 7), "cd": int(cd[g])}
            for g in range(100)}
    nulled = sum(w["sd"] is None for w in want.values())
    check(0 < nulled < 100, f"gb_dec_signed: {nulled} overflowing groups")
    info = {"overflow_groups": nulled}
    counts = {}
    config.set("groupby_engine", "kernel")
    try:
        counts["gb_dec_signed"], _ = phase_run(
            "gb_dec_signed", lambda: group_by(b, ["k"], aggs), n,
            lambda o: check_groups(decimal_groups(*o, "k"), want,
                                   "gb_dec_signed"),
            ("slot_table_build",), {"slot_table_build": 1}, info)
    finally:
        config.reset("groupby_engine")

    def onehot():
        res, ng, ovf = group_by_onehot(b, "k", aggs, 100)
        return res, ng

    counts["gb_dec_signed_onehot"], _ = phase_run(
        "gb_dec_signed_onehot", onehot, n,
        lambda o: check_groups(decimal_groups(*o, "k"), want,
                               "gb_dec_signed_onehot"),
        ("onehot_groupby",), {"onehot_groupby": 1}, info)
    return counts


def _minmax128(keys_sorted_idx, starts, hi, lo, op):
    """Per-segment signed 128-bit min or max of (hi, lo) pairs taken in
    ``keys_sorted_idx`` order, segments starting at ``starts``."""
    h = hi[keys_sorted_idx]
    lo_ = lo[keys_sorted_idx]
    red = np.minimum if op == "min" else np.maximum
    best_h = red.reduceat(h, starts)
    seg = np.repeat(np.arange(len(starts)), np.diff(np.append(starts,
                                                              len(h))))
    fill = np.uint64(2 ** 64 - 1) if op == "min" else np.uint64(0)
    best_l = red.reduceat(np.where(h == best_h[seg], lo_, fill), starts)
    return [(int(x) << 64) | int(y) for x, y in zip(best_h, best_l)]


def phase_gb_dec_key(arrays, b):
    """Group by a decimal(7,2) key of 10^4 prices: count, sum(v) and
    min/max of a decimal(38,2); K2 over the key words (W = 3), the sort
    engine equal bit for bit, both against numpy."""
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch.relational import keys as RK
    from spark_rapids_jni_tpu_torch.relational.aggregate import (AggSpec,
                                                                 group_by)

    n = b.num_rows
    pv, p = arrays["p_valid"], arrays["p"]
    # the oracle's groups: the null key first, then prices ascending
    gid = np.where(pv, p, -1)
    uniq, inv = np.unique(gid, return_inverse=True)
    G = len(uniq)
    cnt = np.bincount(inv, minlength=G)
    sv = np.bincount(inv, weights=arrays["v"].astype(np.float64),
                     minlength=G)
    dv = arrays["d_valid"]
    rows = np.flatnonzero(dv)
    order = rows[np.argsort(inv[rows], kind="stable")]
    gs, starts = np.unique(inv[order], return_index=True)
    hi = arrays["d"][:, 1].view(np.int64)
    lo = arrays["d"][:, 0]
    mins = dict(zip(gs, _minmax128(order, starts, hi, lo, "min")))
    maxs = dict(zip(gs, _minmax128(order, starts, hi, lo, "max")))
    want = {(None if u < 0 else int(u)): {
        "c": int(cnt[g]), "sv": int(sv[g]),
        "nd": mins.get(g), "xd": maxs.get(g)} for g, u in enumerate(uniq)}
    aggs = [AggSpec("count", None, "c"), AggSpec("sum", "v", "sv"),
            AggSpec("min", "d", "nd"), AggSpec("max", "d", "xd")]
    S = 1 << 15  # 10^4 keys: the default 4096 slots would overflow
    counts, outs = {}, {}
    W = len(RK.batch_radix_keys([b["p"]], equality=True, nulls_first=True))
    for name, engine, needs, exact in (
            ("gb_dec_key", "kernel", ("slot_table_build",),
             {"slot_table_build": 1}),
            ("gb_dec_key_sort", "sort", (), no_kernels())):
        config.set("groupby_engine", engine)
        try:
            c, out = phase_run(
                name, lambda: group_by(b, ["p"], aggs, num_slots=S), n,
                lambda o, nm=name: check_groups(
                    decimal_groups(*o, "p"), want, nm),
                needs, exact, {"engine": engine, "key_words": W,
                               "groups": G})
        finally:
            config.reset("groupby_engine")
        counts[name], outs[engine] = c, out
    same_batches(outs["kernel"], outs["sort"], "gb_dec_key_sort vs gb_dec_key")
    return counts


def q3dec_step(fact, dim, join="dense"):
    """TPC-H q3's revenue over the q3 shape: ``rev = l_extendedprice * (1
    - l_discount)`` at Spark's scales (1 - disc at scale 2, the product
    at 4; an overflowing row null), the fact joined to the dim on ``k``
    (``join_dense_or_hash``, or the hash join through K2/K3), then sum(rev)
    and count(*) per ``seg`` (``group_by_domain_or_sort``: K1's decimal
    lanes)."""
    from spark_rapids_jni_tpu_torch.columnar import types as T
    from spark_rapids_jni_tpu_torch.columnar.column import Decimal128Column
    from spark_rapids_jni_tpu_torch.ops import decimal as D
    from spark_rapids_jni_tpu_torch.relational.aggregate import (
        AggSpec, group_by_domain_or_sort)
    from spark_rapids_jni_tpu_torch.relational.join import (
        hash_join, join_dense_or_hash)

    n = fact.num_rows
    dev = fact["k"].device
    one = Decimal128Column(
        torch.tensor([[1, 0]], dtype=torch.int64, device=dev).expand(n, 2),
        torch.ones((n,), dtype=torch.bool, device=dev),
        T.SparkType.decimal(1, 0))
    one_minus = D.null_on_overflow(*D.sub_decimal128(one, fact["disc"], 2))
    rev = D.null_on_overflow(*D.multiply_decimal128(fact["price"],
                                                     one_minus, 4))
    fact = fact.with_column("rev", rev)
    if join == "dense":
        joined, count = join_dense_or_hash(fact, dim, "k", "k",
                                           dim.num_rows)
    else:
        joined, count = hash_join(fact, dim, ["k"], ["k"], engine="kernel")
    live = torch.arange(joined.num_rows, device=dev) < count
    return group_by_domain_or_sort(
        joined, "seg", [AggSpec("sum", "rev", "rev"),
                        AggSpec("count", None, "cnt")], Q3_DOMAIN,
        row_valid=live)


def phase_q3dec(arrays, fact, dim):
    """q3's revenue, dense join then hash join (K2 build, K3 records and
    probe carrying the decimal payload), each against the Python-int
    oracle: sum(price * (100 - disc)) per segment, exact."""
    seg = arrays["seg"]
    rev = arrays["price"] * (100 - arrays["disc"])
    sums = np.bincount(seg, weights=rev.astype(np.float64),
                       minlength=Q3_DOMAIN)  # < 2^53: exact
    cnt = np.bincount(seg, minlength=Q3_DOMAIN)
    want = {g: {"rev": int(sums[g]), "cnt": int(cnt[g])}
            for g in range(Q3_DOMAIN)}
    counts = {}
    for name, join, needs, exact in (
            ("q3dec", "dense", ("onehot_groupby",),
             {"onehot_groupby": 1, "slot_table_build": 0,
              "slot_table_probe": 0}),
            ("q3dec_hashjoin", "hash",
             ("onehot_groupby", "slot_table_build", "slot_table_probe"),
             {"onehot_groupby": 1, "slot_table_build": 1,
              "slot_table_records": 1, "slot_table_probe": 1})):
        counts[name], _ = phase_run(
            name, lambda j=join: q3dec_step(fact, dim, j), fact.num_rows,
            lambda o, nm=name: check_groups(
                decimal_groups(*o, "seg"), want, nm),
            needs, exact, {"join": join})
    return counts


def dec_arith_columns(n, device, seed_a=60, seed_b=80):
    """The reference's ``decimal128_multiply`` operands (bench.py:3047):
    decimal(38,2) with the low limb in [0, 2^40)."""
    from spark_rapids_jni_tpu_torch.columnar.column import batch_from_numpy

    cols = {}
    for name, seed in (("a", seed_a), ("b", seed_b)):
        r = np.random.default_rng(seed)
        lo = r.integers(0, 1 << 40, n, dtype=np.uint64)
        cols[name] = (_limbs_u64(lo), np.ones(n, np.bool_), "decimal(38,2)")
    b = batch_from_numpy(cols, device)
    return b["a"], b["b"]


DEC_OPS = (("multiply", 4), ("add", 2), ("sub", 2), ("divide", 6),
           ("remainder", 2))


def _one_op(a, b, op, scale):
    from spark_rapids_jni_tpu_torch.ops import decimal as D

    return D.null_on_overflow(*getattr(D, f"{op}_decimal128")(a, b, scale))


def run_dec_ops(a, b):
    """Every op of the phase at its result scale, Spark's nulls applied."""
    return {op: _one_op(a, b, op, s) for op, s in DEC_OPS}


def _dec_sample(n):
    """The sample's unscaled operands: the phase's first rows with
    divide-by-zero rows, +-(10^38 - 1) (add and multiply overflow) and
    negative operands mixed in."""
    a = [int(x) for x in np.random.default_rng(60).integers(0, 1 << 40, n)]
    b = [int(x) for x in np.random.default_rng(80).integers(0, 1 << 40, n)]
    top = 10 ** 38 - 1
    for i in range(n):
        if i % 97 == 0:
            b[i] = 0
        if i % 89 == 0:
            a[i] = top if i % 2 else -top
        if i % 7 == 0:
            a[i] = -a[i]
        if i % 11 == 0:
            b[i] = -b[i]
    return a, b


def python_decimal_ops(av, bv):
    """Spark's results from Python ``decimal``: HALF_UP at each op's
    scale; overflow past 38 digits and division by zero null."""
    import decimal as pydec

    pydec.getcontext().prec = 200
    out = {op: [] for op, _ in DEC_OPS}
    for x, y in zip(av, bv):
        a, b = pydec.Decimal(x).scaleb(-2), pydec.Decimal(y).scaleb(-2)
        for op, s in DEC_OPS:
            if op in ("divide", "remainder") and y == 0:
                out[op].append(None)
                continue
            v = {"multiply": lambda: a * b, "add": lambda: a + b,
                 "sub": lambda: a - b, "divide": lambda: a / b,
                 "remainder": lambda: a - b * int(a / b)}[op]()
            q = v.quantize(pydec.Decimal(1).scaleb(-s),
                           rounding=pydec.ROUND_HALF_UP).scaleb(s)
            out[op].append(int(q) if abs(q) < 10 ** 38 else None)
    return out


def phase_dec_arith():
    """``decimal128_multiply`` at its 2^20 rows plus add, subtract, divide
    and remainder: every row bit-identical to the port's CPU result on
    the same data, and a 4096-row sample equal to Python decimal
    arithmetic with Spark's rounding and nulls."""
    from spark_rapids_jni_tpu_torch.columnar.column import Decimal128Column

    n = DEC_ARITH_ROWS
    a, b = dec_arith_columns(n, None)
    out, counts, first_s = driven(run_dec_ops, a, b)
    check_counts("dec_arith", counts, (), no_kernels())
    ca, cb = dec_arith_columns(n, "cpu")
    t0 = time.perf_counter()
    cpu = run_dec_ops(ca, cb)
    cpu_s = time.perf_counter() - t0
    for op, _ in DEC_OPS:
        check(torch.equal(out[op].limbs.cpu(), cpu[op].limbs)
              and torch.equal(out[op].validity.cpu(), cpu[op].validity),
              f"dec_arith: {op} differs from the CPU result")
    av, bv = _dec_sample(DEC_SAMPLE_ROWS)
    sa = Decimal128Column.from_unscaled(av, 38, 2)
    sb = Decimal128Column.from_unscaled(bv, 38, 2)
    got = run_dec_ops(sa, sb)
    want = python_decimal_ops(av, bv)
    nulls = {}
    for op, _ in DEC_OPS:
        g = got[op].to_pylist()
        bad = [i for i, (x, y) in enumerate(zip(g, want[op])) if x != y]
        check(not bad, f"dec_arith: {op} sample differs from Python "
              f"decimal at {len(bad)} rows, e.g. row {bad[:1]}")
        nulls[op] = sum(x is None for x in want[op])
    ms = {op: time_ms(lambda o=op, s=s: _one_op(a, b, o, s), reps=3)
          for op, s in DEC_OPS}
    total = sum(ms.values())
    emit({"phase": "dec_arith", "rows": n, "launches": counts,
          "first_run_s": first_s, "ms": total,
          "mrows_per_s": n / (total * 1e-3) / 1e6, "ms_by_op": ms,
          "cpu_check_s": cpu_s, "sample_rows": DEC_SAMPLE_ROWS,
          "sample_nulls": nulls})
    return counts


def stream_str_batch(q6s, seed=73):
    """The q6str fact with a decimal(38,2) column: signed, 2% null."""
    from spark_rapids_jni_tpu_torch.columnar.column import batch_from_numpy

    n = q6s.num_rows
    r = np.random.default_rng(seed)
    lo = r.integers(0, 1 << 63, n).astype(np.uint64) * np.uint64(2)
    d = batch_from_numpy({"d": (_limbs_u64(lo, r.integers(
        -(1 << 62), 1 << 62, n)), r.random(n) >= 0.02, "decimal(38,2)")},
        q6s["v"].device)["d"]
    return q6s.with_column("d", d)


def phase_stream_str(fact):
    """The streamed exchange of the q6str fact keyed by its 24-byte string
    column, with a decimal(38,2) column riding along: 8 shards, 512
    morsels; lossless, routed and order-keeping, and K4 launched once a
    morsel over the chars and limbs leaves."""
    from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
    from spark_rapids_jni_tpu_torch.parallel.partition import \
        spark_partition_id
    from spark_rapids_jni_tpu_torch.shuffle import (MorselSource,
                                                    ShuffleRegistry,
                                                    ShuffleService)
    from spark_rapids_jni_tpu_torch.shuffle.buffers import batch_leaves

    P = P_SHARDS
    n = fact.num_rows
    src = MorselSource.from_batch(fact, ShardMesh(P))
    svc = ShuffleService(ShardMesh(P), registry=ShuffleRegistry())
    res, counts, first_s = driven(
        lambda: svc.exchange_stream(src, key_names=["k"]))
    out, occ = res.batch, res.occupancy
    check(res.rows_moved == n, f"stream_str: rows_moved {res.rows_moved}")
    check(int(occ.sum().item()) == n, "stream_str: occupied rows != input")
    check(counts["partition_scatter"] == res.morsels == len(src),
          f"stream_str: {counts['partition_scatter']} scatter launches for "
          f"{res.morsels} morsels")
    total = occ.shape[0]
    dev = occ.device
    shard = torch.arange(total, device=dev) // (total // P)
    pid = spark_partition_id([out["k"]], P).to(torch.int64)
    check(bool((pid[occ] == shard[occ]).all().item()),
          "stream_str: an occupied row sits on a shard its pid does not "
          "name")
    # each (destination, sender) bucket's delivered rows, in slot order,
    # are the input's rows of that bucket in the sender's order: lossless
    # (a bijection onto the input rows), routed and order-keeping
    C, rounds = res.capacity, res.rounds
    order = torch.arange(total, device=dev).reshape(
        P, rounds, P, C).transpose(1, 2).reshape(-1)
    got_rows = order[occ[order]]
    sender = torch.arange(n, device=dev) // (n // P)
    in_pid = spark_partition_id([fact["k"]], P).to(torch.int64)
    want_rows = torch.sort(in_pid * P + sender, stable=True).indices
    for i, (x, y) in enumerate(zip(batch_leaves(out), batch_leaves(fact))):
        check(torch.equal(x[got_rows], y[want_rows]),
              f"stream_str: leaf {i} differs from the input's buckets")
    leaves = batch_leaves(fact)
    ms = time_ms(lambda: svc.exchange_stream(src, key_names=["k"]), reps=1,
                 warmup=0)
    emit({"phase": "stream_str", "rows": n, "shards": P,
          "morsels": res.morsels, "rounds": res.rounds,
          "capacity": res.capacity, "leaves": len(leaves),
          "row_bytes": sum(x.element_size() * x[0].numel() for x in leaves),
          "bytes_moved": res.bytes_moved, "launches": counts,
          "first_run_s": first_s, "ms": ms,
          "mrows_per_s": n / (ms * 1e-3) / 1e6, "decode_ms": res.decode_ms,
          "sync_ms": res.sync_ms, "drain_ms": res.drain_ms})
    return counts


# ---------------------------------------------------------------------------
# multi-GPU: the dry run, q95 over a shard mesh, and NCCL ranks
# ---------------------------------------------------------------------------

MC_SHARDS = 8               # the reference's mesh (MULTICHIP_r0*.json)
MC_ROWS_PER_DEVICE = 100_000


def phase_multichip_dryrun():
    """``dryrun_multichip(8)`` on a shard mesh at the reference's 100 000
    rows a device: every check the reference asserts (it raises on a
    miss), and its hash-join count against the exact int64 total
    ``sum_k fact_valid(k) * dim(k)`` computed here in numpy."""
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.parallel import ShardMesh

    lines = []
    n = MC_SHARDS * MC_ROWS_PER_DEVICE
    out, counts, first_s = driven(lambda: PL.dryrun_multichip(
        MC_SHARDS, MC_ROWS_PER_DEVICE, mesh=ShardMesh(MC_SHARDS),
        log=lines.append))
    _, keys = PL.dryrun_arrays(n)
    k, kv = keys["skew80"]
    dk = np.tile(np.arange(PL.DRYRUN_KEYS), n // PL.DRYRUN_KEYS + 1)[:n]
    want = int((np.bincount(k[kv], minlength=PL.DRYRUN_KEYS)
                .astype(np.int64)
                * np.bincount(dk, minlength=PL.DRYRUN_KEYS)).sum())
    check(out["join_count"] == want,
          f"multichip_dryrun: join count {out['join_count']} != {want}")
    check(out["rows"] == n and out["sorted_rows"] == n,
          "multichip_dryrun: rows not conserved")
    check(all(p["rows"] == n for p in out["patterns"].values()),
          "multichip_dryrun: a skew pattern lost rows")
    check(out["broadcast_matches"] == int(kv.sum()),
          "multichip_dryrun: broadcast matches")
    check(out["hier"] == "dcn-x-ici hierarchical shuffle OK",
          f"multichip_dryrun: {out['hier']}")
    check(counts["slot_table_build"] > 0 and counts["onehot_groupby"] > 0,
          "multichip_dryrun: K2 or K1 was not launched")
    emit({"phase": "multichip_dryrun", "shards": MC_SHARDS,
          "rows_per_device": MC_ROWS_PER_DEVICE, "rows": n,
          "launches": counts, "seconds": first_s, "groups": out["groups"],
          "join_count": out["join_count"], "join_count_exact": want,
          "join_count_int32": want % (1 << 32), "lines": lines})
    return counts


def a2a_share_ms(fn):
    """One call of ``fn`` with the all-to-all timer on: ``(call ms,
    all-to-all ms)`` by CUDA events (on a shard mesh the all-to-all is
    the gather into the receive order)."""
    from spark_rapids_jni_tpu_torch.parallel import collectives as CL

    torch.cuda.synchronize()
    CL.a2a_events = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    try:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        a2a = sum(a.elapsed_time(b) for a, b in CL.a2a_events)
    finally:
        CL.a2a_events = None
    return start.elapsed_time(end), a2a


def multichip_kernel_cases(cases, fact, dim1, j2, live2, mesh):
    """The kernels at the shapes shard 0 gives them on the q95 path: the
    join build over dim1's exchanged shard, its records and the probe by
    the fact's exchanged shard, the group-by build and the fused one-hot
    group-by over the broadcast join's shard."""
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.plan import adaptive as AD
    from spark_rapids_jni_tpu_torch.relational import hashtable as H
    from spark_rapids_jni_tpu_torch.relational import keys as RK
    from spark_rapids_jni_tpu_torch.shuffle import ShuffleRegistry, \
        ShuffleService

    svc = ShuffleService(mesh, registry=ShuffleRegistry())
    lres = svc.exchange(fact, key_names=["k"])
    rres = svc.exchange(dim1, key_names=["k"])
    ls, locc = mesh.split(lres.batch)[0], mesh.split(lres.occupancy)[0]
    rs, rocc = mesh.split(rres.batch)[0], mesh.split(rres.occupancy)[0]
    rcol = rs["k"]
    rcol = type(rcol)(rcol.data, rcol.validity & rocc, rcol.dtype)
    rk = RK.batch_radix_keys([rcol], equality=True, nulls_first=False)
    nr = rs.num_rows
    ones = torch.ones(nr, dtype=torch.bool, device=rocc.device)
    out = kernel_case(cases, "slot_table_build", "join_dim1_shard0",
                      k2_case, "join_dim1_shard0", rk, ones,
                      H.next_pow2(2 * nr), None)
    if out is not None:
        owner = out[1]
        rec = kernel_case(cases, "slot_table_records",
                          "dim1_shard0", k3_records_case, "dim1_shard0",
                          owner, rk)
        if rec is not None:
            lk = RK.batch_radix_keys([ls["k"]], equality=True,
                                     nulls_first=False)
            kernel_case(cases, "slot_table_probe", "fact_shard0_into_dim1",
                        k3_case, "fact_shard0_into_dim1", owner, rk, lk,
                        ls["k"].validity & locc, H.chain_bound(owner, nr),
                        rec[1])
    j2s, live2s = mesh.split(j2)[0], mesh.split(live2)[0]
    n = j2s.num_rows
    gk = RK.batch_radix_keys([j2s["seg"]], equality=True, nulls_first=True)
    S = min(4096, H.next_pow2(2 * n))
    kernel_case(cases, "slot_table_build", "groupby_seg_shard0", k2_case,
                "groupby_seg_shard0", gk, live2s, S,
                AD.bound_build_rounds(n, S))
    kernel_case(cases, "onehot_groupby", "q95_seg_shard0", k1_case,
                "q95_seg_shard0", j2s, "seg", list(PL.Q95_AGGS), PL.Q95_SEG,
                live2s)


def phase_multichip_q95(fact, dim1, dim2, arrays, cases):
    """q95's operators row-sharded over a shard mesh of 8 (2^21 fact rows
    a shard): the hash join on ``k``, the dense broadcast join on ``wh``,
    the exchanged group-by and the map-side combine on ``seg`` (both equal
    to the numpy oracle exactly), and the global sort of the fact by
    ``(k, v)`` (ordered, every row kept).  Each operator is driven once
    with the launch counts at 0 (exact per-shard counts: 8 K2 builds, 8
    record builds and 8 K3 probes for the hash join, 8 K2 builds for the
    group-by, 8 fused K1 launches for the domain group-by), then timed
    over 3 calls with CUDA events; one more call reads the all-to-all
    share."""
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.parallel import (
        ShardMesh, distributed_broadcast_join, distributed_group_by,
        distributed_group_by_domain, distributed_hash_join,
        distributed_sort, shard_batch)

    mesh = ShardMesh(MC_SHARDS)
    f, d1 = shard_batch(fact, mesh), shard_batch(dim1, mesh)
    zero = no_kernels()
    total = dict(zero)
    state = {}
    aggs = list(PL.Q95_AGGS)
    steps = (
        ("hash_join", lambda: distributed_hash_join(
            f, d1, ["k"], ["k"], "inner", mesh),
         {**zero, "slot_table_build": MC_SHARDS,
          "slot_table_records": MC_SHARDS, "slot_table_probe": MC_SHARDS}),
        ("broadcast_join", lambda: distributed_broadcast_join(
            state["hash_join"][0], dim2, ["wh"], ["wh"], "inner", mesh,
            dense_domain=PL.Q95_WH), zero),
        ("group_by", lambda: distributed_group_by(
            state["broadcast_join"][0], ["seg"], aggs, mesh,
            row_valid=state["live2"]),
         {**zero, "slot_table_build": MC_SHARDS}),
        ("group_by_domain", lambda: distributed_group_by_domain(
            state["broadcast_join"][0], "seg", aggs, PL.Q95_SEG, mesh,
            row_valid=state["live2"]),
         {**zero, "onehot_groupby": MC_SHARDS}),
        ("sort", lambda: distributed_sort(f, ["k", "v"], mesh), zero))
    for name, fn, exact in steps:
        out, counts, first_s = driven(fn)
        state[name] = out
        if name == "broadcast_join":
            state["live2"] = PL.shard_prefix(out[1], out[0].num_rows)
        check_counts(f"multichip_q95/{name}", counts, (), exact)
        ms = time_ms(fn, reps=3, warmup=0)
        call_ms, a2a_ms = a2a_share_ms(fn)
        for k in total:
            total[k] += counts[k]
        emit({"phase": "multichip_q95", "op": name, "shards": MC_SHARDS,
              "rows": fact.num_rows, "launches": counts,
              "first_run_s": first_s, "ms": ms, "a2a_ms": a2a_ms,
              "a2a_share": a2a_ms / call_ms if call_ms else None})

    # the outputs against the oracle
    j1, c1, drop1 = state["hash_join"]
    check(int(c1.sum()) == fact.num_rows and int(drop1.sum()) == 0,
          f"multichip_q95: hash join matched {int(c1.sum())} rows")
    orders, net = PL.q95_oracle(arrays)
    got = PL.q95_distributed_groups(
        {"group_by": state["group_by"], "domain": state["group_by_domain"]},
        mesh)
    for name, (o, v) in got.items():
        check(np.array_equal(o, orders) and
              np.array_equal(v, net.astype(np.int64)),
              f"multichip_q95: {name} groups differ from the oracle")
    check(not bool(state["group_by_domain"][2]),
          "multichip_q95: domain overflow")
    res, occ, sdrop = state["sort"]
    check(int(occ.sum()) == fact.num_rows and int(sdrop.sum()) == 0,
          "multichip_q95: the sort lost rows")
    key = res["k"].data[occ].to(torch.int64) * PL.Q95_V_HI + res["v"].data[
        occ]
    check(bool((key[1:] >= key[:-1]).all().item()),
          "multichip_q95: the sort is not globally ordered")
    want = torch.sort(fact["k"].data.to(torch.int64) * PL.Q95_V_HI
                      + fact["v"].data).values
    check(torch.equal(key, want), "multichip_q95: sorted rows differ")
    guarded("kernel cases at the shard shapes", multichip_kernel_cases,
            cases, f, d1, state["broadcast_join"][0], state["live2"], mesh)
    return total


def phase_multichip_nccl():
    """q95's operators and the sort on a ProcessMesh over NCCL at world
    size = the visible cards (at most 4), against a shard mesh of the
    same size: every shard's outputs bit-identical (sha256 of each).
    One card runs in this process; more spawn one rank per card
    (``parallel/launch.py``)."""
    import datetime
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from spark_rapids_jni_tpu_torch.parallel import ProcessMesh, ShardMesh
    from spark_rapids_jni_tpu_torch.parallel import drive, launch

    world = min(torch.cuda.device_count(), 4)
    ops = [drive.Op("q95_distributed", (N_FACT, drive.MESH)),
           drive.Op("q95_stream", (N_FACT, drive.MESH, NCCL_MORSEL_ROWS))]
    t0 = time.perf_counter()
    want = drive.digest_ops(ShardMesh(world), ops)
    shard_s = time.perf_counter() - t0
    counts = no_kernels()
    t0 = time.perf_counter()
    if world == 1:
        store = tempfile.mkdtemp(prefix="srj_nccl_")
        dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(store, 'pg')}",
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=300))
        try:
            mesh = ProcessMesh()
            got, counts, _ = driven(lambda: [drive.digest_ops(mesh, ops)])
        finally:
            dist.destroy_process_group()
            shutil.rmtree(store, ignore_errors=True)
    else:
        got = launch.spawn(world, "spark_rapids_jni_tpu_torch.parallel."
                           "drive:digest_ops", ops, backend="nccl",
                           wall_s=300.0, pg_timeout_s=240.0)
    rank_s = time.perf_counter() - t0
    for r in range(world):
        check(got[r][0][0] == want[0][r],
              f"multichip_nccl rank {r}: results differ from the shard "
              "mesh's")
        check(got[r][1][0] == want[1][r],
              f"multichip_nccl rank {r}: the streamed exchange differs "
              "from the shard mesh's")
    morsels = -(-(N_FACT // world) // NCCL_MORSEL_ROWS)
    if world == 1:
        check(counts["partition_scatter"] == morsels,
              f"multichip_nccl: {counts['partition_scatter']} K4 launches "
              f"for {morsels} morsels")
    emit({"phase": "multichip_nccl", "world": world, "backend": "nccl",
          "rows": N_FACT, "launches": counts,
          "in_process": world == 1, "shard_mesh_s": shard_s,
          "process_mesh_s": rank_s, "digests_equal": got[0][0][0] ==
          want[0][0], "stream_digests_equal": got[0][1][0] == want[1][0],
          "stream_morsels": morsels})
    return counts


# ---------------------------------------------------------------------------
# encoded and compressed columns
# ---------------------------------------------------------------------------

def watch_build_words(fn):
    """``fn()`` with the slot-table build wrapper observed: returns its
    result and the number of key words of each build it made."""
    from spark_rapids_jni_tpu_torch.ops import kernels as KER

    seen = []
    orig = KER.slot_table_build

    def spy(words, *args, **kwargs):
        seen.append(len(words))
        return orig(words, *args, **kwargs)

    KER.slot_table_build = spy
    try:
        return fn(), seen
    finally:
        KER.slot_table_build = orig


def paired_ms(fns: dict, pairs: int = 3, reps: int = 3) -> dict:
    """Median CUDA-event ms of each function, timed in turns."""
    got = {k: [] for k in fns}
    for _ in range(pairs):
        for k, fn in fns.items():
            got[k].append(time_ms(fn, reps=reps))
    return {k: float(np.median(v)) for k, v in got.items()}


def phase_q6str_enc(q6s, arrays, cases):
    """q6str over a dictionary key of one shared dictionary: one K2
    build over the null flag and ONE canon word (q6str's key lowers to
    8 words), groups equal to q6str's bit for bit on keys, sums and
    counts, timed in turns with q6str (the pair that sets what
    ``encoded_execution='auto'`` means on the GPU); plus K2 at that
    shape against its plain version."""
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.columnar import encoded as E
    from spark_rapids_jni_tpu_torch.plan import adaptive as AD
    from spark_rapids_jni_tpu_torch.relational import aggregate as AGG
    from spark_rapids_jni_tpu_torch.relational import keys as RK

    t0 = time.perf_counter()
    ((qe,),) = PL.q6str_encoded_variants(N_FACT, (7,))
    encode_s = time.perf_counter() - t0
    (out, counts, first_s), widths = watch_build_words(
        lambda: driven(lambda: PL.q6str_step(qe)))
    check_counts("q6str_enc", counts, ("slot_table_build",),
                 {"slot_table_build": 1, "onehot_groupby": 0})
    check(widths == [2], f"q6str_enc: slot-table builds over {widths} key "
          "words, expected one over 2 (the null flag and the canon word)")
    extra = check_q6str(*out, arrays, "q6str_enc")
    res, ng = out
    check(isinstance(res["k"], E.DictionaryColumn),
          "q6str_enc: the result keys are not dictionary codes")
    same_string_groups(PL.q6str_step(q6s), (E.materialize_batch(res), ng),
                       "q6str_enc vs q6str")
    ms = paired_ms({"q6str_enc": lambda: PL.q6str_step(qe),
                    "q6str": lambda: PL.q6str_step(q6s)})
    choice = ms["q6str_enc"] < ms["q6str"]
    emit({"phase": "q6str_enc", "rows": N_FACT, "launches": counts,
          "build_key_words": widths, "first_run_s": first_s,
          "host_encode_s": encode_s, "ms": ms["q6str_enc"],
          "q6str_ms": ms["q6str"],
          "mrows_per_s": N_FACT / (ms["q6str_enc"] * 1e-3) / 1e6,
          "encoded_faster": choice, "auto_on_cuda": E.AUTO_ON_CUDA,
          **extra})
    words = RK.batch_radix_keys(AGG._canon_keys([qe["k"]]), equality=True,
                                nulls_first=True)
    live = qe["price"].data < 50.0
    kernel_case(cases, "slot_table_build", "groupby_q6str_enc", k2_case,
                "groupby_q6str_enc", words, live, 4096,
                AD.bound_build_rounds(N_FACT, 4096))
    return counts


def phase_q95_enc(arrays, fact_plain, cases):
    """q95 on the fact with ``wh`` and ``seg`` dictionary-encoded: the
    hand step and ``plan.execute(q95_plan())`` on the same inputs, both
    equal to the oracle exactly, each with exactly 3 K2 builds, 2 record
    builds, 2 probes and no K1 (the dense rowid join is off on encoded
    inputs); plus K3 over the dictionary's value words."""
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch import plan as PLAN
    from spark_rapids_jni_tpu_torch.parallel.partition import \
        exchange_local
    from spark_rapids_jni_tpu_torch.plan import queries as Q
    from spark_rapids_jni_tpu_torch.relational import hashtable as H
    from spark_rapids_jni_tpu_torch.relational import join as JN
    from spark_rapids_jni_tpu_torch.relational import keys as RK

    t0 = time.perf_counter()
    fact, dim1, dim2 = PL.q95_encoded_batches(N_FACT)
    encode_s = time.perf_counter() - t0
    exact = {"slot_table_build": 3, "slot_table_records": 2,
             "slot_table_probe": 2, "onehot_groupby": 0}
    all_counts = {}
    for name, fn in (
            ("q95_enc", lambda: PL.q95_encoded_step(fact, dim1, dim2)),
            ("plan_q95_enc", lambda: PLAN.execute(
                Q.q95_plan(), {"fact": fact, "dim1": dim1, "dim2": dim2}))):
        (res, ng), counts, first_s = driven(fn)
        check_q95(res, ng, arrays, name)
        check_counts(name, counts, (), exact)
        ms = time_ms(fn, reps=3)
        emit({"phase": name, "rows": N_FACT, "launches": counts,
              "first_run_s": first_s, "host_encode_s": encode_s, "ms": ms,
              "mrows_per_s": N_FACT / (ms * 1e-3) / 1e6})
        all_counts[name] = counts
    ms_plain = time_ms(lambda: PL.q95_hashjoin_step(fact_plain, dim1, dim2),
                       reps=3)
    emit({"phase": "q95_enc_vs_plain", "q95_hashjoin_ms": ms_plain})

    # K3: q95_enc's second join probes dim2's table with the exchanged
    # first join's wh, a dictionary column: its value words by code
    dev = dim2["wh"].device
    ones = torch.ones(fact.num_rows, dtype=torch.bool, device=dev)
    staged = exchange_local(fact, "k", ones, PL.P)
    j1, c1 = JN.hash_join(staged, dim1, ["k"], ["k"])
    j1_live = torch.arange(j1.num_rows, device=dev) < c1
    staged2 = exchange_local(j1, "wh", j1_live, PL.P)
    bw = RK.batch_radix_keys([dim2["wh"]], equality=True, nulls_first=False)
    owner = H.build_slot_table(bw, torch.ones(dim2.num_rows,
                                              dtype=torch.bool, device=dev),
                               H.next_pow2(2 * dim2.num_rows))[0]
    rec = kernel_case(cases, "slot_table_records", "q95_enc_dim2",
                      k3_records_case, "q95_enc_dim2", owner, bw)
    if rec is not None:
        pk = RK.batch_radix_keys([staged2["wh"]], equality=True,
                                 nulls_first=False)
        kernel_case(cases, "slot_table_probe", "q95_enc_dim2_dict_words",
                    k3_case, "q95_enc_dim2_dict_words", owner, bw, pk,
                    staged2["wh"].validity & j1_live,
                    H.chain_bound(owner, dim2.num_rows), rec[1])
    return all_counts


def phase_q6_packed(q6b, arrays):
    """q6's one-hot step with ``v`` bit-packed: one K1 launch after the
    domain engine materializes ``v``, equal to q6 on the plain batch bit
    for bit on keys, sums and counts."""
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.columnar import encoded as E

    t0 = time.perf_counter()
    packed = E.encode_batch(q6b, dictionary=[], bitpack=["v"])
    encode_s = time.perf_counter() - t0
    check(isinstance(packed["v"], E.BitPackedColumn), "q6_packed: v not "
          "packed")
    config.set("q6_group_path", "onehot")
    try:
        (res, ng), counts, first_s = driven(lambda: PL.q6_step(packed))
        check_counts("q6_packed", counts, ("onehot_groupby",),
                     {"onehot_groupby": 1, "slot_table_build": 0})
        worst = check_q6(res, ng, arrays, "q6_packed")
        want, wng = PL.q6_step(q6b)
        g = int(ng)
        check(g == int(wng), "q6_packed: group count differs from q6")
        for c in ("k", "sum_v", "cnt"):
            check(torch.equal(res[c].data[:g], want[c].data[:g])
                  and torch.equal(res[c].validity[:g],
                                  want[c].validity[:g]),
                  f"q6_packed: {c} differs from q6_onehot")
        ms = paired_ms({"q6_packed": lambda: PL.q6_step(packed),
                        "q6_onehot": lambda: PL.q6_step(q6b)})
    finally:
        config.reset("q6_group_path")
    emit({"phase": "q6_packed", "rows": q6b.num_rows, "launches": counts,
          "width": packed["v"].width, "first_run_s": first_s,
          "host_encode_s": encode_s, "ms": ms["q6_packed"],
          "q6_onehot_ms": ms["q6_onehot"],
          "mrows_per_s": q6b.num_rows / (ms["q6_packed"] * 1e-3) / 1e6,
          "avg_price_max_rel_err": worst})
    return counts


def selectivity_arrays(n, seed=29):
    """The reference bench's selectivity recipe: sorted values in [0,
    2^20) and keys in [0, 256)."""
    rng = np.random.default_rng(seed)
    vals = np.sort(rng.integers(0, 1 << 20, n)).astype(np.int64)
    keys = rng.integers(0, 256, n).astype(np.int64)
    return vals, keys


def phase_packed_filter(fact):
    """``packed_filter_mask`` over a bit-packed column (q95's ``v``) and a
    frame-of-reference one (the selectivity recipe's sorted values) at
    2^24 rows, every op, literals inside and outside each pack domain:
    equal to decode-then-compare with no decode on the packed path."""
    from spark_rapids_jni_tpu_torch.columnar import encoded as E
    from spark_rapids_jni_tpu_torch.columnar import types as T
    from spark_rapids_jni_tpu_torch.columnar.column import Column

    n = fact.num_rows
    vals, _ = selectivity_arrays(n)
    ones = torch.ones(n, dtype=torch.bool, device=fact["v"].device)
    cols = {"bitpacked": E.encode_bitpacked(fact["v"], column="v"),
            "for": E.encode_for(Column(torch.from_numpy(vals).to(ones.device),
                                       ones, T.INT64), column="x")}
    line = {"phase": "packed_filter", "rows": n}
    counts = no_kernels()
    for label, col in cols.items():
        check(isinstance(col, E.PACKED_COLUMNS), f"packed_filter: {label} "
              "did not pack")
        dec = col.decode().data
        lo, hi = int(dec.min().item()), int(dec.max().item())
        mid = int(dec[n // 2].item())
        lits = [-(1 << 40), lo - 1, lo, mid, hi, hi + 1, 1 << 40]
        E.reset_packed_decode_count()
        _, got_counts, _ = driven(lambda: E.packed_filter_mask(col, "<",
                                                               mid))
        for k in counts:
            counts[k] += got_counts[k]
        for op in ("<", "<=", "==", "!=", ">=", ">"):
            for v in lits:
                got = E.packed_filter_mask(col, op, v)
                want = _CMP[op](dec, v)
                check(torch.equal(got, want),
                      f"packed_filter {label}: {op} {v} differs from "
                      "decode-then-compare")
        decodes = E.packed_decode_count()
        check(decodes == 0, f"packed_filter {label}: {decodes} decodes")
        ms = paired_ms({
            "packed": lambda: E.packed_filter_mask(col, "<", mid),
            "decode": lambda: col.decode().data < mid})
        line[label] = {"width": col.width, "ms": ms["packed"],
                       "decode_then_compare_ms": ms["decode"],
                       "literals": lits, "packed_decode_count": decodes}
    check(all(v == 0 for v in counts.values()), "packed_filter: a kernel "
          "launched")
    emit(line)
    return counts


_CMP = {"<": torch.lt, "<=": torch.le, "==": torch.eq, "!=": torch.ne,
        ">=": torch.ge, ">": torch.gt}


def phase_exchange_pack():
    """The reference bench's compress recipe (``k`` int64 in [0, 1000),
    ``qty`` int32, ``flag`` bool, ``price`` f32) at 2^24 rows over 8
    shards, ``shuffle_compress`` off then pack: delivered rows identical,
    ``rows_moved`` exact, ``compressed_bytes_saved`` the difference of the
    two ``bytes_moved``."""
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch.columnar.column import batch_from_numpy
    from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
    from spark_rapids_jni_tpu_torch.shuffle import ShuffleRegistry, \
        ShuffleService
    from spark_rapids_jni_tpu_torch.shuffle.buffers import batch_leaves

    n = N_FACT
    rng = np.random.default_rng(23)
    ones = np.ones(n, np.bool_)
    batch = batch_from_numpy({
        "k": (rng.integers(0, 1000, n).astype(np.int64), ones, "int64"),
        "qty": (rng.integers(-50, 50, n).astype(np.int32), ones, "int32"),
        "flag": (rng.integers(0, 2, n).astype(bool), ones, "boolean"),
        "price": (rng.standard_normal(n).astype(np.float32), ones,
                  "float32")})
    svc = ShuffleService(ShardMesh(P_SHARDS), registry=ShuffleRegistry())
    res, ms, counts = {}, {}, no_kernels()
    for mode in ("off", "pack"):
        config.set("shuffle_compress", mode)
        try:
            res[mode], c, _ = driven(
                lambda: svc.exchange(batch, key_names=["k"]))
            ms[mode] = time_ms(lambda: svc.exchange(batch, key_names=["k"]),
                               reps=3)
        finally:
            config.reset("shuffle_compress")
        for k in counts:
            counts[k] += c[k]
    off, pack = res["off"], res["pack"]
    check(torch.equal(off.occupancy, pack.occupancy),
          "exchange_pack: occupancy differs")
    check(all(torch.equal(a, b) for a, b in zip(batch_leaves(off.batch),
                                                batch_leaves(pack.batch))),
          "exchange_pack: delivered rows differ")
    check(off.rows_moved == pack.rows_moved == n,
          f"exchange_pack: rows_moved {off.rows_moved} / {pack.rows_moved}")
    saved = pack.compressed_bytes_saved
    check(saved > 0 and saved == off.bytes_moved - pack.bytes_moved,
          f"exchange_pack: saved {saved} vs {off.bytes_moved} - "
          f"{pack.bytes_moved}")
    check(off.compressed_bytes_saved == 0, "exchange_pack: off saved bytes")
    emit({"phase": "exchange_pack", "rows": n, "shards": P_SHARDS,
          "rounds": pack.rounds, "capacity": pack.capacity,
          "bytes_moved_off": off.bytes_moved,
          "bytes_moved_pack": pack.bytes_moved,
          "compressed_bytes_saved": saved,
          "wire_ratio": off.bytes_moved / pack.bytes_moved,
          "ms_off": ms["off"], "ms_pack": ms["pack"], "launches": counts})
    return counts


def _survivors(res, thresh, P):
    """Per destination shard, the (k, x) rows with x < thresh, sorted."""
    xs = res.batch["x"].data.cpu().numpy()
    ks = res.batch["k"].data.cpu().numpy()
    ok = res.batch["x"].validity.cpu().numpy() & \
        res.occupancy.cpu().numpy()
    rows = len(xs) // P
    out = []
    for d in range(P):
        sl = slice(d * rows, (d + 1) * rows)
        sel = ok[sl] & (xs[sl] < thresh)
        k, x = ks[sl][sel], xs[sl][sel]
        order = np.lexsort((x, k))
        out.append((k[order], x[order]))
    return out


def phase_stream_zone():
    """The reference bench's selectivity recipe at 2^24 rows over 8
    shards, 8 morsels a shard, a frame-of-reference zone sidecar: at 1,
    10 and 90 % selectivity the pruned stream's surviving rows equal the
    filtered full stream's shard for shard, the 1 % point skips blocks,
    and K4 launches once per kept morsel."""
    from spark_rapids_jni_tpu_torch.columnar import encoded as E
    from spark_rapids_jni_tpu_torch.columnar.column import batch_from_numpy
    from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
    from spark_rapids_jni_tpu_torch.shuffle import MorselSource, \
        ShuffleRegistry, ShuffleService

    n, P = N_FACT, P_SHARDS
    vals, keys = selectivity_arrays(n)
    ones = np.ones(n, np.bool_)
    batch = batch_from_numpy({"k": (keys, ones, "int64"),
                              "x": (vals, ones, "int64")})
    # the sidecar of the encode step (the stream's batch stays plain)
    zone = E.encode_for(batch["x"], block=256).zone
    check(zone is not None, "stream_zone: no zone sidecar")
    mesh = ShardMesh(P)
    M = n // P // 8
    svc = ShuffleService(mesh, registry=ShuffleRegistry())
    full_src = MorselSource.from_batch(batch, mesh, morsel_rows=M)
    full, fcounts, _ = driven(lambda: svc.exchange_stream(full_src,
                                                          key_names=["k"]))
    full_ms = time_ms(lambda: svc.exchange_stream(full_src,
                                                  key_names=["k"]),
                      reps=2, warmup=0)
    check(fcounts["partition_scatter"] == len(full_src),
          "stream_zone: full stream K4 launches != morsels")
    line = {"phase": "stream_zone", "rows": n, "shards": P,
            "morsel_rows": M, "morsels": len(full_src),
            "full_ms": full_ms, "points": []}
    counts = dict(fcounts)
    for sel in (0.01, 0.10, 0.90):
        thresh = int(np.quantile(vals, sel))
        src = MorselSource.from_batch(batch, mesh, morsel_rows=M,
                                      predicate=("x", "<", thresh),
                                      zone_map=zone)
        res, c, _ = driven(lambda: svc.exchange_stream(src,
                                                       key_names=["k"]))
        for k in counts:
            counts[k] += c[k]
        check(c["partition_scatter"] == len(src),
              f"stream_zone {sel}: {c['partition_scatter']} K4 launches "
              f"for {len(src)} kept morsels")
        for d, ((ka, xa), (kb, xb)) in enumerate(zip(
                _survivors(res, thresh, P), _survivors(full, thresh, P))):
            check(np.array_equal(ka, kb) and np.array_equal(xa, xb),
                  f"stream_zone {sel}: shard {d}'s surviving rows differ "
                  "from the filtered full stream")
        if sel == 0.01:
            check(src.blocks_skipped > 0, "stream_zone: 1% skipped nothing")
        ms = time_ms(lambda: svc.exchange_stream(src, key_names=["k"]),
                     reps=2, warmup=0)
        line["points"].append({
            "selectivity": sel, "threshold": thresh,
            "morsels_kept": len(src), "blocks_skipped": src.blocks_skipped,
            "blocks_scanned": src.blocks_scanned,
            "skip_fraction": src.blocks_skipped / max(
                src.blocks_skipped + src.blocks_scanned, 1),
            "k4_launches": c["partition_scatter"], "ms": ms})
    line["launches"] = counts
    emit(line)
    return counts



# ---------------------------------------------------------------------------
# the Spark-exact string path (BASELINE.md config #4, qstr)
# ---------------------------------------------------------------------------

QSTR_ROWS = 1 << 20          # a Spark batch (the benchmark's 2^14 below)
QSTR_BENCH_ROWS = 1 << 14    # bench.py's qstr_string_heavy rows
QSTR_BENCH_SEEDS = 4         # seeds 17 + k, as bench.py draws them
QSTR_DIRTY_EVERY = 20        # qstr_dirty: every 20th document dirty
QSTR_SAMPLE_ROWS = 4096      # rows held against tests/json_oracle.py
CAST_ROWS = 1 << 20
CAST_SAMPLE_ROWS = 4096


def json_oracle():
    """``tests/json_oracle.py``: the pure-Python model of Spark's
    ``get_json_object`` and Java's ``Double.toString``."""
    import importlib
    import os

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module("json_oracle")


def cuda_profile(fn):
    """One call of ``fn`` under ``torch.profiler``: the CUDA kernels it
    launched and their summed device ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches, dev_us = 0, 0.0
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            launches += e.count
            dev_us += us
    return launches, dev_us / 1e3


def host_syncs():
    """The string path's host reads so far (fast engine branches, the
    flagged count) and its scan-machine runs."""
    from spark_rapids_jni_tpu_torch.ops import get_json_object as GJ
    from spark_rapids_jni_tpu_torch.ops import json_fast as JF

    return {**GJ.HOST_SYNCS, **JF.HOST_SYNCS}


def reset_host_syncs():
    from spark_rapids_jni_tpu_torch.ops import get_json_object as GJ
    from spark_rapids_jni_tpu_torch.ops import json_fast as JF

    for d in (GJ.HOST_SYNCS, JF.HOST_SYNCS):
        for k in d:
            d[k] = 0


def qstr_expected(n, seed=17):
    """Host oracle of qstr: each document's ``json.loads(doc)["owner"]``
    characters [3, 11) and the hit count (an 'a' then a digit)."""
    import json
    import re

    from spark_rapids_jni_tpu_torch import pipelines as PL

    tails = [json.loads(d)["owner"][3:11] for d in PL.qstr_docs(n, seed)]
    hits = sum(1 for t in tails if re.search("a[0-9]", t))
    return tails, hits


def same_tails(tails, want, label):
    """``tails`` equal to the host strings byte for byte: every row valid,
    the lengths, the bytes, and zeros past each length."""
    from spark_rapids_jni_tpu_torch import pipelines as PL

    wc, wl = PL.ascii_arrays(want)
    w = wc.shape[1]
    chars = tails.chars.cpu()
    check(bool(tails.validity.all()), f"{label}: null tails")
    check(np.array_equal(tails.lengths.cpu().numpy(), wl),
          f"{label}: tail lengths differ from the host oracle")
    check(np.array_equal(chars[:, :w].numpy(), wc)
          and not bool(chars[:, w:].any()),
          f"{label}: tail bytes differ from the host oracle")


def flagged_rows(batch):
    """Rows of ``batch`` the fast JSON engine hands to the scan machine."""
    from spark_rapids_jni_tpu_torch.ops import json_fast as JF

    doc = batch["doc"]
    return int(JF.fast_path(doc.chars, doc.lengths, doc.validity,
                            (("named", b"owner"),), 6 * doc.max_len + 20
                            )[3].sum())


def phase_qstr():
    """qstr at 2^20 rows: ``tails`` byte for byte and ``n_hits`` against
    the host oracle, the step's time and launches, and
    ``left_compact_rows``'s scatter and sort engines timed in turns on
    qstr's substring (the winner is ``strings.AUTO_ON_CUDA``)."""
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.ops import strings as STR
    from spark_rapids_jni_tpu_torch.ops.get_json_object import \
        get_json_object
    from spark_rapids_jni_tpu_torch.ops.regex_rewrite import \
        literal_range_pattern

    n = QSTR_ROWS
    t0 = time.perf_counter()
    batch = PL.qstr_batch(n)
    setup_s = time.perf_counter() - t0
    want, want_hits = qstr_expected(n)
    reset_host_syncs()
    (tails, n_hits), counts, first_s = driven(PL.qstr_step, batch)
    syncs = host_syncs()
    check_counts("qstr", counts, (), no_kernels())
    same_tails(tails, want, "qstr")
    check(int(n_hits) == want_hits,
          f"qstr: n_hits {int(n_hits)}, oracle {want_hits}")
    flagged = flagged_rows(batch)
    check(flagged == 0, f"qstr: the fast engine flagged {flagged} rows")
    check(syncs["scan_runs"] == 0, "qstr: the scan machine ran")
    ms = time_ms(lambda: PL.qstr_step(batch), reps=3, warmup=0)
    launches, dev_ms = cuda_profile(lambda: PL.qstr_step(batch))
    owners = get_json_object(batch["doc"], "$.owner")
    sub = {e: lambda e=e: STR.substring(owners, PL.QSTR_SUB_POS,
                                        PL.QSTR_SUB_LEN, engine=e)
           for e in ("scatter", "sort")}
    a, b = sub["scatter"](), sub["sort"]()
    check(torch.equal(a.chars, b.chars) and torch.equal(a.lengths,
                                                        b.lengths),
          "qstr: the scatter and sort compactions differ")
    eng = paired_ms(sub)
    stages = {"get_json_object_ms": time_ms(
        lambda: get_json_object(batch["doc"], "$.owner"), reps=3),
        "substring_ms": time_ms(lambda: STR.substring(
            owners, PL.QSTR_SUB_POS, PL.QSTR_SUB_LEN), reps=3),
        "literal_range_ms": time_ms(lambda: literal_range_pattern(
            a, "a", 1, ord("0"), ord("9")), reps=3)}
    faster = min(eng, key=eng.get)
    emit({"phase": "qstr", "rows": n, "width": batch["doc"].max_len,
          "max_out": owners.max_len, "launches": counts,
          "first_run_s": first_s, "setup_s": setup_s, "ms": ms,
          "mrows_per_s": n / (ms * 1e-3) / 1e6,
          "cuda_launches_per_step": launches, "device_ms_per_step": dev_ms,
          "host_syncs_per_step": syncs["n_flagged"] + syncs["fast_path"],
          "host_syncs": syncs, "flagged_rows": flagged, "n_hits":
          int(n_hits), "stages": stages, "compaction_ms": eng,
          "faster_compaction": faster, "auto_on_cuda": STR.AUTO_ON_CUDA})
    return counts


def phase_qstr_bench():
    """qstr at bench.py's 2^14 rows, seeds 17 + k: each run against the
    host oracle, then timed."""
    from spark_rapids_jni_tpu_torch import pipelines as PL

    n = QSTR_BENCH_ROWS
    total = no_kernels()
    per_seed = []
    for k in range(QSTR_BENCH_SEEDS):
        batch = PL.qstr_batch(n, seed=17 + k)
        want, want_hits = qstr_expected(n, seed=17 + k)
        (tails, n_hits), counts, _ = driven(PL.qstr_step, batch)
        check_counts("qstr_bench", counts, (), no_kernels())
        same_tails(tails, want, f"qstr_bench seed {17 + k}")
        check(int(n_hits) == want_hits, f"qstr_bench seed {17 + k}: n_hits")
        per_seed.append(time_ms(lambda: PL.qstr_step(batch), reps=3))
        for key in total:
            total[key] += counts[key]
    ms = float(np.mean(per_seed))
    emit({"phase": "qstr_bench", "rows": n, "seeds": QSTR_BENCH_SEEDS,
          "launches": total, "ms": ms, "ms_by_seed": per_seed,
          "mrows_per_s": n / (ms * 1e-3) / 1e6})
    return total


def phase_qstr_dirty():
    """qstr at 2^20 rows with every 20th document dirty (an escaped owner
    or a single-quoted key, alternately): the fast engine flags them, the
    compact fallback runs the scan machine over ceil(n / 16)-row
    sub-batches; every row against the recipe's owner, and a 4096-row
    sample (dirty rows included) against ``tests/json_oracle.py``."""
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.ops import get_json_object as GJ

    n = QSTR_ROWS
    docs = PL.qstr_docs(n, dirty_every=QSTR_DIRTY_EVERY)
    ones = np.ones((n,), np.bool_)
    from spark_rapids_jni_tpu_torch.columnar.column import batch_from_numpy

    batch = batch_from_numpy({"doc": (PL.ascii_arrays(docs, 32), ones,
                                      "string")})
    want = [("amya%d" % (i % 1000))[3:11] for i in range(n)]
    reset_host_syncs()
    (tails, n_hits), counts, first_s = driven(PL.qstr_step, batch)
    syncs = host_syncs()
    check_counts("qstr_dirty", counts, (), no_kernels())
    same_tails(tails, want, "qstr_dirty")
    check(int(n_hits) == n, f"qstr_dirty: n_hits {int(n_hits)} of {n}")
    flagged = flagged_rows(batch)
    ndirty = n // QSTR_DIRTY_EVERY
    check(flagged == ndirty,
          f"qstr_dirty: {flagged} flagged rows, {ndirty} dirty documents")
    cap = -(-n // int(config.get("json_fallback_div")))
    iters = -(-flagged // cap)
    check(syncs["scan_runs"] == iters,
          f"qstr_dirty: {syncs['scan_runs']} scan-machine runs, expected "
          f"{iters}")
    # the sample: every 4th row of the first 16384, dirty rows included
    oracle = json_oracle()
    rows = list(range(0, 4 * QSTR_SAMPLE_ROWS, 4)) + list(
        range(QSTR_DIRTY_EVERY - 1, 4 * QSTR_SAMPLE_ROWS, 2 * QSTR_DIRTY_EVERY))
    rows = sorted(set(rows))[:QSTR_SAMPLE_ROWS]
    idx = torch.tensor(rows, device=tails.chars.device)
    owners = GJ.get_json_object(batch["doc"], "$.owner")
    got = type(owners)(owners.chars[idx], owners.lengths[idx],
                       owners.validity[idx]).to_pylist()
    bad = [r for r, g in zip(rows, got)
           if g != oracle.get_json_object(docs[r], "$.owner")]
    check(not bad, f"qstr_dirty: {len(bad)} sample rows differ from "
          f"json_oracle, e.g. row {bad[:1]}")
    ms = time_ms(lambda: PL.qstr_step(batch), reps=3, warmup=0)
    # the scan machine alone, at the fallback's sub-batch shape
    doc = batch["doc"]
    sub = torch.arange(QSTR_DIRTY_EVERY - 1, n, QSTR_DIRTY_EVERY,
                       device=doc.chars.device)[:cap]
    sub = torch.cat([sub, sub.new_full((cap - sub.numel(),), n - 1)])
    args = (doc.chars[sub], doc.lengths[sub], doc.validity[sub],
            (("named", b"owner"),), owners.max_len)
    scan_ms = time_ms(lambda: GJ._run(*args), reps=2)
    scan_launches, scan_dev_ms = cuda_profile(lambda: GJ._run(*args))
    launches, dev_ms = cuda_profile(lambda: PL.qstr_step(batch))
    emit({"phase": "qstr_dirty", "rows": n, "dirty_every":
          QSTR_DIRTY_EVERY, "launches": counts, "first_run_s": first_s,
          "ms": ms, "mrows_per_s": n / (ms * 1e-3) / 1e6,
          "flagged_rows": flagged, "fallback_rows_per_run": cap,
          "loop_iterations": iters, "host_syncs": syncs,
          "scan_machine_ms": scan_ms, "scan_machine_launches":
          scan_launches, "scan_machine_device_ms": scan_dev_ms,
          "scan_steps": doc.max_len + 1,
          "cuda_launches_per_step": launches, "device_ms_per_step": dev_ms,
          "sample_rows": len(rows)})
    return counts


def phase_qstr_groupby(cases):
    """``qstr_groupby_step`` at 2^20 rows: groups and counts against a
    ``collections.Counter`` of the host oracle's tails, exactly one K2
    build (its key words recorded), then timed; K2 at that shape against
    its plain version."""
    import collections

    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.plan import adaptive as AD
    from spark_rapids_jni_tpu_torch.relational import aggregate as AGG
    from spark_rapids_jni_tpu_torch.relational import keys as RK

    n = QSTR_ROWS
    batch = PL.qstr_batch(n)
    want, want_hits = qstr_expected(n)
    (out, counts, first_s), widths = watch_build_words(
        lambda: driven(PL.qstr_groupby_step, batch))
    res, ng, n_hits = out
    check_counts("qstr_groupby", counts, ("slot_table_build",),
                 {"slot_table_build": 1, "slot_table_records": 0,
                  "slot_table_probe": 0, "onehot_groupby": 0})
    got = PL.result_groups(res, ng, "tails")
    cnt = collections.Counter(want)
    check(sorted(got) == sorted(cnt), "qstr_groupby: groups differ")
    check(all(got[k]["n"] == c and got[k]["hits"] == c
              for k, c in cnt.items() if k in got),
          "qstr_groupby: counts differ from the Counter oracle")
    check(int(n_hits) == want_hits, "qstr_groupby: n_hits")
    ms = time_ms(lambda: PL.qstr_groupby_step(batch), reps=3)
    emit({"phase": "qstr_groupby", "rows": n, "groups": int(ng),
          "launches": counts, "build_key_words": widths,
          "first_run_s": first_s, "ms": ms,
          "mrows_per_s": n / (ms * 1e-3) / 1e6})
    tails, hits = PL._qstr_tails(batch)
    gb = PL.qstr_group_batch(tails, hits)
    words = RK.batch_radix_keys(AGG._canon_keys([gb["tails"]]),
                                equality=True, nulls_first=True)
    live = torch.ones((n,), dtype=torch.bool, device=tails.chars.device)
    kernel_case(cases, "slot_table_build", "groupby_qstr_tails", k2_case,
                "groupby_qstr_tails", words, live, 4096,
                AD.bound_build_rounds(n, 4096))
    return counts


def cast_inputs(n, seed=41):
    """Host inputs of the cast phase: doubles (random bit patterns, random
    magnitudes and the edge values: subnormals, +-0, NaN, +-Inf,
    2^53 +- 1, powers of ten) and strings (their ``repr``, integers,
    decimals, overlong digit runs, whitespace, junk)."""
    rng = np.random.default_rng(seed)
    edges = [0.0, -0.0, float("nan"), float("inf"), float("-inf"), 5e-324,
             -5e-324, 2.2250738585072014e-308, 2.225073858507201e-308,
             float(2**53 - 1), float(2**53 + 1), float(2**53), 1e7, 1e-3,
             9.999999999999999e22, 1e23, 1.7976931348623157e308, 0.1, 1e21,
             1e-7, 123456.789] + [10.0 ** k for k in range(-20, 23)]
    q = n // 4
    bits = rng.integers(0, 2**63, q, dtype=np.int64)
    bits = np.where(rng.random(q) < 0.5, bits, bits | np.int64(-2**63))
    mags = rng.random(n - q - len(edges)) * 10.0 ** rng.integers(
        -30, 30, n - q - len(edges))
    doubles = np.concatenate([np.asarray(edges), bits.view(np.float64),
                              mags])
    pool = ["  12 ", "-9223372036854775808", "9223372036854775808", "20.5",
            "7.8.3", ".", "+5", "1e5", "1e", " nan", "-nan", "Infinity",
            "-inf", "1f", "0f", "1e-320", "4.9e-324", "1e309",
            "123456789012345678901234567890", "0.000000000000000000000123",
            "\t-7.25\n", "abc", "", "   ", "99999999.99", "-0.5", "9.23"]
    k = rng.integers(0, 5, n)
    strs = []
    for i, (d, kk) in enumerate(zip(doubles.tolist(), k.tolist())):
        if kk == 0:
            strs.append(pool[i % len(pool)])
        elif kk == 1:
            strs.append(str(int(rng.integers(-10**12, 10**12))))
        elif kk == 2:
            strs.append("%.2f" % (d % 1e6) if d == d and abs(d) < 1e300
                        else "1.5")
        else:
            strs.append(repr(d))
    return doubles, strs


def run_casts(doubles, strings):
    """The four casts over one batch: a dict of result tensors."""
    from spark_rapids_jni_tpu_torch.columnar import types as TT
    from spark_rapids_jni_tpu_torch.ops import cast_string as CS
    from spark_rapids_jni_tpu_torch.ops import float_to_string as FS

    f2s = FS.float_to_string(doubles)
    s2f = CS.string_to_float(strings, TT.FLOAT64)
    s2f32 = CS.string_to_float(strings, TT.FLOAT32)
    s2i = CS.string_to_integer(strings, TT.INT64)
    s2d = CS.string_to_decimal(strings, 18, -4)
    return {"float_to_string": (f2s.chars, f2s.lengths, f2s.validity),
            "string_to_float": (s2f.data.view(torch.int64), s2f.validity),
            "string_to_float32": (s2f32.data.view(torch.int32),
                                  s2f32.validity),
            "string_to_integer": (s2i.data, s2i.validity),
            "string_to_decimal": (s2d.limbs, s2d.validity)}


def cast_columns(doubles, strs, device):
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.columnar import types as TT
    from spark_rapids_jni_tpu_torch.columnar.column import (Column,
                                                            StringColumn)

    chars, lengths = PL.ascii_arrays(strs)
    n = len(strs)
    ones = torch.ones((n,), dtype=torch.bool)
    d = Column(torch.from_numpy(doubles).to(device), ones.to(device),
               TT.FLOAT64)
    s = StringColumn(torch.from_numpy(chars).to(device),
                     torch.from_numpy(lengths).to(device), ones.to(device))
    return d, s


def phase_casts():
    """``string_to_float`` (f64, f32), ``float_to_string``,
    ``string_to_integer`` and ``string_to_decimal`` at 2^20 rows: every
    row bit-identical to the port's CPU result, and ``float_to_string``
    equal to ``json_oracle.java_double_to_string`` on a 4096-row
    sample."""
    from spark_rapids_jni_tpu_torch.columnar import types as TT
    from spark_rapids_jni_tpu_torch.columnar.column import Column
    from spark_rapids_jni_tpu_torch.ops import cast_string as CS
    from spark_rapids_jni_tpu_torch.ops import float_to_string as FS

    from spark_rapids_jni_tpu_torch.columnar.column import resolve_device

    n = CAST_ROWS
    doubles, strs = cast_inputs(n)
    d, s = cast_columns(doubles, strs, resolve_device(None))
    out, counts, first_s = driven(run_casts, d, s)
    check_counts("casts", counts, (), no_kernels())
    cd, cs = cast_columns(doubles, strs, "cpu")
    t0 = time.perf_counter()
    cpu = run_casts(cd, cs)
    cpu_s = time.perf_counter() - t0
    for name, tensors in out.items():
        check(all(torch.equal(a.cpu(), b) for a, b in zip(tensors,
                                                          cpu[name])),
              f"casts: {name} on the card differs from the CPU result")
    oracle = json_oracle()
    step = n // CAST_SAMPLE_ROWS
    idx = list(range(0, n, step))[:CAST_SAMPLE_ROWS]
    sample = Column(torch.from_numpy(doubles[idx]).to(d.device),
                    torch.ones((len(idx),), dtype=torch.bool,
                               device=d.device), TT.FLOAT64)
    got = FS.float_to_string(sample).to_pylist()
    bad = [i for i, g in zip(idx, got)
           if g != oracle.java_double_to_string(float(doubles[i]))]
    check(not bad, f"casts: float_to_string differs from Java's "
          f"Double.toString at {len(bad)} sample rows, e.g. {bad[:1]}")
    ms = {"float_to_string": time_ms(lambda: FS.float_to_string(d), reps=3),
          "string_to_float": time_ms(
              lambda: CS.string_to_float(s, TT.FLOAT64), reps=3),
          "string_to_integer": time_ms(
              lambda: CS.string_to_integer(s, TT.INT64), reps=3),
          "string_to_decimal": time_ms(
              lambda: CS.string_to_decimal(s, 18, -4), reps=3)}
    emit({"phase": "casts", "rows": n, "width": s.max_len,
          "launches": counts, "first_run_s": first_s, "ms_by_op": ms,
          "ms": sum(ms.values()), "cpu_check_s": cpu_s,
          "valid_rows": {k: int(v[-1].sum()) for k, v in cpu.items()},
          "sample_rows": len(idx)})
    return counts


# ---------------------------------------------------------------------------
# the memory arena (mem/): retry/block/split under injected OOMs, a real
# CUDA OOM and four tasks sharing one oversubscribed arena
# ---------------------------------------------------------------------------

MEM_FUZZ_SEEDS = (11, 42)   # the reference's Monte-Carlo seeds
MEM_TASK_SEEDS = (7, 8, 9, 10)  # mem_tasks: one q6 batch per task
MEM_POOL_TASKS = 2.5        # mem_tasks' pool, in one task's charges
MEM_DEADLINE_S = 120.0      # the reference's Monte-Carlo deadline


def mem_monte_carlo(seed, pool=3 << 20, task_max=2 << 20, n_tasks=6):
    """The reference's seeded oversubscription fuzz (``tests/
    test_mem_adaptor.py`` ``TestMonteCarlo``) on the port's adaptor:
    wall ms, the RetryOOM and SplitAndRetryOOM the tasks caught, the
    native metrics, and whether every task completed and the arena
    drained."""
    import random
    import threading

    from spark_rapids_jni_tpu_torch.mem import rmm_spark as R

    adaptor = R.SparkResourceAdaptor(pool, poll_ms=10.0)
    failures, caught = [], {"retry": 0, "split": 0}
    lock = threading.Lock()

    def bump(kind):
        with lock:
            caught[kind] += 1

    def task_fn(task_id):
        rng = random.Random(seed * 1000 + task_id)
        adaptor.start_dedicated_task_thread(task_id)
        held = []
        try:
            ops, budget = 0, task_max
            while ops < 40:
                want = rng.randrange(1, max(2, budget // 4))
                try:
                    adaptor.allocate(want)
                    held.append(want)
                    ops += 1
                    if rng.random() < 0.4 and held:
                        adaptor.deallocate(held.pop(rng.randrange(len(held))))
                    if sum(held) > task_max - want:
                        while held:
                            adaptor.deallocate(held.pop())
                except R.SplitAndRetryOOM:
                    bump("split")
                    while held:
                        adaptor.deallocate(held.pop())
                    budget = max(budget // 2, 4)
                except R.RetryOOM:
                    bump("retry")
                    while held:
                        adaptor.deallocate(held.pop())
                    try:
                        adaptor.block_thread_until_ready()
                    except R.SplitAndRetryOOM:
                        bump("split")
                        budget = max(budget // 2, 4)
                    except R.RetryOOM:
                        bump("retry")
            while held:
                adaptor.deallocate(held.pop())
        except BaseException as e:  # noqa: BLE001 - reported by the phase
            failures.append((task_id, repr(e)))
        finally:
            adaptor.task_done(task_id)

    threads = [threading.Thread(target=task_fn, args=(i + 1,), daemon=True)
               for i in range(n_tasks)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    deadline = time.monotonic() + MEM_DEADLINE_S
    for th in threads:
        th.join(timeout=max(0.1, deadline - time.monotonic()))
    wall_ms = (time.perf_counter() - t0) * 1e3
    alive = sum(th.is_alive() for th in threads)
    native = {"num_retry": 0, "num_split_retry": 0}
    for t in range(1, n_tasks + 1):
        native["num_retry"] += adaptor.get_and_reset_num_retry(t)
        native["num_split_retry"] += adaptor.get_and_reset_num_split_retry(t)
    total = adaptor.total_allocated()
    adaptor.close()
    return {"seed": seed, "wall_ms": wall_ms, "retries": caught["retry"],
            "splits": caught["split"], **native, "alive": alive,
            "failures": failures, "total_allocated": total,
            "watchdog_joined": adaptor._h is None}


def phase_mem_arena():
    """The native adaptor as built on this machine: the Monte-Carlo
    recipe at both seeds; no deadlock, every task done, arena drained."""
    runs = [mem_monte_carlo(s) for s in MEM_FUZZ_SEEDS]
    for r in runs:
        tag = f"mem_arena seed {r['seed']}"
        check(r["alive"] == 0, f"{tag}: {r['alive']} tasks deadlocked")
        check(not r["failures"], f"{tag}: {r['failures']}")
        check(r["total_allocated"] == 0,
              f"{tag}: {r['total_allocated']} bytes left in the arena")
        check(r["watchdog_joined"], f"{tag}: the watchdog was not joined")
    emit({"phase": "mem_arena", "runs": runs})


def row_slice(batch, a, b):
    """Rows ``[a, b)`` of a batch of plain columns, as views."""
    from spark_rapids_jni_tpu_torch.columnar.column import Column, ColumnBatch

    return ColumnBatch({name: Column(c.data[a:b], c.validity[a:b], c.dtype)
                        for name, c in zip(batch.names, batch.columns)})


def merge_q6_groups(parts):
    """q6 groups of row slices merged: sums and counts add, the mean is
    the merged price sum over the merged count."""
    out = {}
    for groups in parts:
        for k, g in groups.items():
            m = out.setdefault(k, {"sum_v": 0, "cnt": 0, "price": 0.0})
            m["sum_v"] += g["sum_v"]
            m["cnt"] += g["cnt"]
            m["price"] += g["avg_price"] * g["cnt"]
    return {k: {"sum_v": m["sum_v"], "cnt": m["cnt"],
                "avg_price": m["price"] / m["cnt"]} for k, m in out.items()}


def q6_in_parts(ctx, batch, parts):
    """The arena's q6 step: ``parts`` equal row slices of ``batch``, each
    charged to the task (``batch_nbytes``) while its q6 step runs and
    released in a ``finally``; the slices' groups merged."""
    from spark_rapids_jni_tpu_torch import pipelines as PL

    n = batch.num_rows // parts
    groups = []
    for i in range(parts):
        part = row_slice(batch, i * n, (i + 1) * n)
        charged = ctx.charge(part)
        try:
            groups.append(PL.result_groups(*PL.q6_step(part), "k"))
        finally:
            ctx.release(charged)
    return merge_q6_groups(groups)


def phase_mem_q6_inject(q6b, arrays):
    """``TestPipelineUnderInjectedOOM`` at 2^24 rows on the one-hot path
    (K1): one injected RetryOOM (the retry runs the whole batch: one K1
    launch), then one injected SplitAndRetryOOM (the two halves: two)."""
    from spark_rapids_jni_tpu_torch.mem import (
        RmmSpark, TaskContext, batch_nbytes, run_with_retry)

    from spark_rapids_jni_tpu_torch import pipelines as PL

    PL.q6_step(q6b)  # warm-up: the process's first K1 call loads it
    charge = batch_nbytes(q6b)
    adaptor = RmmSpark.set_event_handler(4 * charge)
    passes, all_counts = {}, no_kernels()
    try:
        state = {"parts": 1}

        def split():
            state["parts"] *= 2

        with TaskContext(7) as ctx:
            for name, inject in (("retry", RmmSpark.force_retry_oom),
                                 ("split",
                                  RmmSpark.force_split_and_retry_oom)):
                inject(None, 1, 0)
                groups, counts, s = driven(
                    run_with_retry, lambda: q6_in_parts(ctx, q6b,
                                                        state["parts"]),
                    None, split)
                err = check_q6_groups(groups, arrays, f"mem_q6_inject {name}")
                passes[name] = {"parts": state["parts"], "wall_ms": s * 1e3,
                                "k1_launches": counts["onehot_groupby"],
                                "avg_price_max_rel_err": err}
                check_counts(f"mem_q6_inject {name}", counts,
                             ("onehot_groupby",),
                             {"onehot_groupby": 1 if name == "retry" else 2,
                              "slot_table_build": 0})
                for k, v in counts.items():
                    all_counts[k] += v
        RmmSpark.task_done(7)
        metrics = {"num_retry": adaptor.get_and_reset_num_retry(7),
                   "num_split_retry": adaptor.get_and_reset_num_split_retry(7),
                   "max_allocated": adaptor.get_max_memory_allocated(7),
                   "total_allocated": adaptor.total_allocated()}
    finally:
        RmmSpark.clear_event_handler()
    check(metrics["num_retry"] >= 1, "mem_q6_inject: no native retry")
    check(metrics["num_split_retry"] >= 1, "mem_q6_inject: no native split")
    check(metrics["total_allocated"] == 0,
          f"mem_q6_inject: {metrics['total_allocated']} bytes left")
    emit({"phase": "mem_q6_inject", "rows": q6b.num_rows,
          "charge_bytes": charge, "passes": passes, **metrics})
    return all_counts


def transition_notes(path):
    """The notes of a transition log's state changes, in order."""
    with open(path) as f:
        rows = [ln.split(",") for ln in f.read().splitlines()[1:]]
    return [r[6] or f"{r[4]}->{r[5]}" for r in rows if r[1] == "transition"]


def phase_mem_q6_oom(q6b, arrays):
    """A real ``torch.OutOfMemoryError`` through the ladder: the q6 hash
    step (K2) under a per-process memory limit set between the peak of
    the whole 2^24-row batch and that of one half.  The first attempt
    must hit the CUDA OOM, the native protocol must see it (its retry
    metric moves), and the step must re-run and equal the oracle."""
    import tempfile

    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.mem import (
        RmmSpark, TaskContext, run_with_retry)

    dev = torch.device("cuda")
    total_mem = torch.cuda.get_device_properties(dev).total_memory
    n = q6b.num_rows
    config.set("q6_group_path", "sort")
    try:
        def peaks(b):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            PL.q6_step(b)
            torch.cuda.synchronize()
            return (torch.cuda.max_memory_allocated(),
                    torch.cuda.max_memory_reserved())

        whole = peaks(q6b)
        half = peaks(row_slice(q6b, 0, n // 2))
        # above everything the half needs, below what the whole needs
        lo, hi = half[1], whole[0]
        check(lo < hi, f"mem_q6_oom: no window: half's reserved peak {lo} "
              f">= whole's allocated peak {hi}")
        limit = (lo + hi) // 2
        events = []
        state = {"parts": 1}

        def split():
            events.append(("split", state["parts"] * 2))
            state["parts"] *= 2

        with tempfile.TemporaryDirectory() as tmp:
            log = os.path.join(tmp, "transitions.csv")
            adaptor = RmmSpark.set_event_handler(total_mem, log_path=log)
            try:
                torch.cuda.empty_cache()
                torch.cuda.set_per_process_memory_fraction(limit / total_mem)
                with TaskContext(8) as ctx:
                    def step():
                        events.append(("attempt", state["parts"]))
                        try:
                            return q6_in_parts(ctx, q6b, state["parts"])
                        except torch.OutOfMemoryError:
                            events.append(("cuda_oom", state["parts"]))
                            raise

                    groups, counts, s = driven(run_with_retry, step, None,
                                               split)
                RmmSpark.task_done(8)
                metrics = {
                    "num_retry": adaptor.get_and_reset_num_retry(8),
                    "num_split_retry":
                        adaptor.get_and_reset_num_split_retry(8),
                    "block_time_ms":
                        adaptor.get_and_reset_block_time_ns(8) / 1e6,
                    "total_allocated": adaptor.total_allocated()}
                peak_run = torch.cuda.max_memory_reserved()
            finally:
                torch.cuda.set_per_process_memory_fraction(1.0)
                RmmSpark.clear_event_handler()
                torch.cuda.empty_cache()
            notes = transition_notes(log)
    finally:
        config.reset("q6_group_path")
    err = check_q6_groups(groups, arrays, "mem_q6_oom")
    check(events[:2] == [("attempt", 1), ("cuda_oom", 1)],
          f"mem_q6_oom: the first attempt did not hit a CUDA OOM: {events}")
    check(metrics["num_retry"] >= 1,
          "mem_q6_oom: the native retry metric did not move")
    attempts = [e for e in events if e[0] == "attempt"]
    check(len(attempts) >= 2, f"mem_q6_oom: the step did not re-run: "
          f"{events}")
    check(metrics["total_allocated"] == 0,
          f"mem_q6_oom: {metrics['total_allocated']} bytes left")
    check_counts("mem_q6_oom", counts, ("slot_table_build",),
                 {"onehot_groupby": 0})
    path = (["retry"] * (metrics["num_retry"] > 0)
            + ["park"] * ("bufn_wait" in notes)
            + ["split"] * (metrics["num_split_retry"] > 0))
    emit({"phase": "mem_q6_oom", "rows": n,
          "peak_whole": {"allocated": whole[0], "reserved": whole[1]},
          "peak_half": {"allocated": half[0], "reserved": half[1]},
          "limit_bytes": limit, "limit_fraction": limit / total_mem,
          "reserved_peak_under_limit": peak_run, "events": events,
          "attempts": len(attempts), "path": path, "transitions": notes,
          "k2_launches": counts["slot_table_build"], "wall_ms": s * 1e3,
          "avg_price_max_rel_err": err, **metrics})
    return counts


def phase_mem_tasks(q6b, arrays):
    """Four dedicated task threads (task ids 1-4), each the q6 hash step
    (K2) on its own 2^24-row batch (seeds 7-10) under ``run_with_retry``
    with a halving split, charging its batch through ``TaskContext``; the
    pool holds 2.5 charges, so a third task blocks until one releases."""
    import threading
    import traceback

    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.mem import (
        RmmSpark, TaskContext, batch_nbytes, run_with_retry)
    from spark_rapids_jni_tpu_torch.ops import kernels as KER

    n = q6b.num_rows
    data = {1: (q6b, arrays)}
    for tid, seed in enumerate(MEM_TASK_SEEDS[1:], start=2):
        data[tid] = (PL.example_batch(n, seed), PL.example_arrays(n, seed))
    charge = batch_nbytes(q6b)
    pool = int(MEM_POOL_TASKS * charge)
    config.set("q6_group_path", "sort")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b, _ in data.values():
            PL.result_groups(*PL.q6_step(b), "k")
        torch.cuda.synchronize()
        serial_ms = (time.perf_counter() - t0) * 1e3

        adaptor = RmmSpark.set_event_handler(pool)
        results, errors = {}, {}
        try:
            def task(tid):
                state = {"parts": 1}

                def split():
                    state["parts"] *= 2

                try:
                    with TaskContext(tid) as ctx:
                        groups = run_with_retry(
                            lambda: q6_in_parts(ctx, data[tid][0],
                                                state["parts"]),
                            split=split)
                    results[tid] = (groups, state["parts"])
                except BaseException:  # noqa: BLE001 - reported below
                    errors[tid] = traceback.format_exc()
                finally:
                    RmmSpark.task_done(tid)

            threads = [threading.Thread(target=task, args=(tid,),
                                        daemon=True) for tid in data]
            torch.cuda.synchronize()
            KER.reset_launches()
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            deadline = time.monotonic() + MEM_DEADLINE_S
            for th in threads:
                th.join(timeout=max(0.1, deadline - time.monotonic()))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            counts = dict(KER.launches)
            alive = sum(th.is_alive() for th in threads)
            tasks = {tid: {
                "num_retry": adaptor.get_and_reset_num_retry(tid),
                "num_split_retry": adaptor.get_and_reset_num_split_retry(tid),
                "block_time_ms":
                    adaptor.get_and_reset_block_time_ns(tid) / 1e6,
                "compute_time_lost_ms":
                    adaptor.get_and_reset_compute_time_lost_ns(tid) / 1e6,
                "max_allocated": adaptor.get_max_memory_allocated(tid),
                "parts": results.get(tid, (None, None))[1]}
                for tid in data}
            drained = adaptor.total_allocated()
            arena_max = adaptor.max_allocated()
        finally:
            RmmSpark.clear_event_handler()
    finally:
        config.reset("q6_group_path")
    check(alive == 0, f"mem_tasks: {alive} tasks still running after "
          f"{MEM_DEADLINE_S} s")
    check(not errors, f"mem_tasks: {errors}")
    for tid, (_, arrs) in data.items():
        if tid in results:
            check_q6_groups(results[tid][0], arrs, f"mem_tasks task {tid}")
    check(drained == 0, f"mem_tasks: {drained} bytes left in the arena")
    check(adaptor._h is None, "mem_tasks: the watchdog was not joined")
    check(arena_max <= pool, f"mem_tasks: arena peak {arena_max} > {pool}")
    check(any(t["block_time_ms"] > 0 for t in tasks.values()),
          "mem_tasks: no task blocked on the oversubscribed arena")
    check(counts["slot_table_build"] > 0, "mem_tasks: K2 was not launched")
    emit({"phase": "mem_tasks", "rows_per_task": n, "charge_bytes": charge,
          "pool_bytes": pool, "arena_max_allocated": arena_max,
          "tasks": tasks, "wall_ms": wall_ms, "serial_ms": serial_ms,
          "launches": counts})
    del data
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.columnar.column import batch_from_numpy
    from spark_rapids_jni_tpu_torch.mem import rmm_spark as RS
    from spark_rapids_jni_tpu_torch.ops import _build

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "kind": kind, "count":
          torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    print(smi, flush=True)

    build_s = _build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in _build.build_logs.items()}
    t0 = time.perf_counter()
    arena_lib = _build.build_host(RS.LIB_SOURCE)
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas,
          "arena": {"library": os.path.relpath(arena_lib),
                    "seconds": time.perf_counter() - t0,
                    "gxx": _build.gxx_version()}})

    n6 = int(config.get("bench_rows_tpu"))
    q6_arrays = PL.example_arrays(n6)
    q6b = PL.example_batch(n6)
    total = {k: 0 for k in REPLACES}

    def add_counts(counts):
        for k in total:
            total[k] += (counts or {}).get(k, 0)

    # the memory arena, first: the real-OOM window is cleanest while
    # little else is on the card
    guarded("mem_arena", phase_mem_arena)
    add_counts(guarded("mem_q6_inject", phase_mem_q6_inject, q6b, q6_arrays))
    add_counts(guarded("mem_q6_oom", phase_mem_q6_oom, q6b, q6_arrays))
    add_counts(guarded("mem_tasks", phase_mem_tasks, q6b, q6_arrays))
    q95_arrays = PL.q95_arrays(N_FACT)
    fact, dim1, dim2 = PL.q95_batches(N_FACT)

    q6s_arrays = PL.q6str_arrays(N_FACT)
    ones = np.ones(N_FACT, np.bool_)
    q6s = batch_from_numpy({"k": (q6s_arrays[1], ones, "string"),
                            "v": (q6s_arrays[2], ones, "int64"),
                            "price": (q6s_arrays[3], ones, "float64")})
    sdim = PL.q6str_dim()

    dec = dec_batches()
    cases = guarded("kernels", phase_kernels, q6b, fact, dim1, dim2, q6s,
                    sdim, dec) or {}

    def path(name, group_path, fn, args, rows, verify, needs, stages=None,
             exact=None):
        config.set("q6_group_path", group_path)
        counts = guarded(name, phase_path, name, fn, args, rows, verify,
                         needs, stages, exact)
        config.reset("q6_group_path")
        for k in total:
            total[k] += (counts or {}).get(k, 0)

    path("q6_onehot", "onehot", PL.q6_step, (q6b,), n6,
         lambda r, g: check_q6(r, g, q6_arrays, "q6_onehot"),
         ("onehot_groupby",), lambda: q6_stages(q6b),
         {"onehot_groupby": 1})
    path("q6_hash", "sort", PL.q6_step, (q6b,), n6,
         lambda r, g: check_q6(r, g, q6_arrays, "q6_hash"),
         ("slot_table_build",))
    path("q95", "onehot", PL.q95_step, (fact, dim1, dim2), N_FACT,
         lambda r, g: check_q95(r, g, q95_arrays, "q95"),
         ("onehot_groupby",), lambda: q95_stages(fact, dim1, dim2),
         {"onehot_groupby": 1})
    # two joins: one record build per built table, one probe per join
    path("q95_hashjoin", "onehot", PL.q95_hashjoin_step, (fact, dim1, dim2),
         N_FACT, lambda r, g: check_q95(r, g, q95_arrays, "q95_hashjoin"),
         ("slot_table_build", "slot_table_probe"), None,
         {"slot_table_records": 2, "slot_table_probe": 2})

    from spark_rapids_jni_tpu_torch.plan import queries as Q

    def plan_path(name, knobs, make_plan, inputs, verify, needs, exact=None,
                  exact_again=None):
        for k, v in knobs.items():
            config.set(k, v)
        try:
            counts = guarded(name, phase_plan, name, make_plan, inputs,
                             verify, needs, exact, exact_again)
        finally:
            for k in knobs:
                config.reset(k)
        for k in total:
            total[k] += (counts or {}).get(k, 0)

    def vs_step(step, args, key, floats, oracle):
        def verify(res, ng):
            want, wng = step(*args)
            same_groups(res, ng, want, wng, key, floats, "plan vs step")
            return oracle(res, ng)
        return verify

    q6_in = {"batch": q6b}
    q95_in = {"fact": fact, "dim1": dim1, "dim2": dim2}
    for label, group_path in (("onehot", "onehot"), ("hash", "sort")):
        name = f"plan_q6_{label}"
        plan_path(name, {"q6_group_path": group_path}, Q.q6_plan, q6_in,
                  vs_step(PL.q6_step, (q6b,), "k", ("avg_price",),
                          lambda r, g, n=name: check_q6(r, g, q6_arrays, n)),
                  ("onehot_groupby",) if label == "onehot"
                  else ("slot_table_build",))
    for engine in ("auto", "sort"):
        name = f"plan_q95_{engine}"
        plan_path(name, {"groupby_engine": engine}, Q.q95_plan, q95_in,
                  vs_step(PL.q95_step, (fact, dim1, dim2), "seg", (),
                          lambda r, g, n=name: check_q95(r, g, q95_arrays,
                                                         n)),
                  ("onehot_groupby",) if engine == "auto" else ())
    # the broadcast table's records are built with the table and reused
    # by the cached plan: no record build on the second call
    plan_path("plan_q9", {}, Q.q9_plan, q95_in,
              lambda r, g: check_q9(r, g, q95_arrays, "plan_q9"),
              ("slot_table_build", "slot_table_probe", "onehot_groupby"),
              {"slot_table_records": 1, "slot_table_probe": 1,
               "onehot_groupby": 1},
              {"slot_table_records": 0, "slot_table_build": 0,
               "slot_table_probe": 1})

    # relational breadth at 2^24 rows
    def breadth(name, fn, *args):
        counts = guarded(name, fn, *args)
        if isinstance(counts, tuple):
            counts = counts[0]
        for k in total:
            total[k] += (counts or {}).get(k, 0)

    def q6str_run(name, engine):
        config.set("groupby_engine", engine)
        try:
            return phase_run(
                name, lambda: PL.q6str_step(q6s), N_FACT,
                lambda o: check_q6str(*o, q6s_arrays, name),
                ("slot_table_build",) if engine == "kernel" else (),
                {"slot_table_build": 1} if engine == "kernel"
                else no_kernels(),
                {"engine": engine, "key_words": len(RK.batch_radix_keys(
                    [q6s["k"]], equality=True, nulls_first=True))})
        finally:
            config.reset("groupby_engine")

    from spark_rapids_jni_tpu_torch.relational import keys as RK

    q6str_out = {}
    for name, engine in (("q6str", "kernel"), ("q6str_sort", "sort")):
        got = guarded(name, q6str_run, name, engine)
        if got is not None:
            q6str_out[engine] = got[1]
            for k in total:
                total[k] += got[0].get(k, 0)
    if len(q6str_out) == 2:
        same_string_groups(q6str_out["sort"], q6str_out["kernel"],
                           "q6str_sort vs q6str")
    plan_path("plan_q6str", {}, Q.q6_plan, {"batch": q6s},
              vs_step(PL.q6str_step, (q6s,), "k", ("avg_price",),
                      lambda r, g: check_q6str(r, g, q6s_arrays,
                                               "plan_q6str")
                      ["avg_price_max_rel_err"]),
              ("slot_table_build",), {"slot_table_build": 1},
              {"slot_table_build": 1})
    q3_arrays = PL.q3_arrays(N_FACT)
    q3f, q3d = PL.q3_batches(N_FACT)
    breadth("q3", phase_run, "q3", lambda: PL.q3_step(q3f, q3d), N_FACT,
            lambda o: check_q3(*o, q3_arrays), ("onehot_groupby",),
            {"onehot_groupby": 1, "slot_table_build": 0})
    q67_arrays = PL.q67_arrays(N_FACT)
    q67b = PL.q67_batch(N_FACT)
    breadth("q67", phase_run, "q67", lambda: PL.q67_step(q67b), N_FACT,
            lambda o: check_q67(o, q67_arrays), (), no_kernels())
    breadth("plan_sort", phase_plan_sort, q6b, q6_arrays)
    breadth("join_str", phase_join_str, q6s, q6s_arrays, sdim)
    breadth("join_kinds", phase_join_kinds, fact, dim2, q95_arrays)

    # decimals
    def dec_phase(name, fn, *args):
        got = guarded(name, fn, *args) or {}
        for c in got.values():
            for k in total:
                total[k] += c.get(k, 0)

    dec_phase("gb_dec", phase_gb_dec, *dec["gb_dec"])
    dec_phase("gb_dec_signed", phase_gb_dec_signed, *dec["gb_dec_signed"])
    dec_phase("gb_dec_key", phase_gb_dec_key, *dec["gb_dec_key"])
    dec_phase("q3dec", phase_q3dec, dec["q3dec"][0], *dec["q3dec"][1])
    breadth("dec_arith", phase_dec_arith)
    del dec

    k4_main = (cases.get("partition_scatter") or [None])[0]
    counts = guarded("stream_exchange", phase_stream, fact, k4_main)
    for k in total:
        total[k] += (counts or {}).get(k, 0)
    breadth("stream_str", phase_stream_str, stream_str_batch(q6s))

    # encoded and compressed columns
    breadth("q6str_enc", phase_q6str_enc, q6s, q6s_arrays, cases)
    dec_phase("q95_enc", phase_q95_enc, q95_arrays, fact, cases)
    breadth("q6_packed", phase_q6_packed, q6b, q6_arrays)
    breadth("packed_filter", phase_packed_filter, fact)
    breadth("exchange_pack", phase_exchange_pack)
    breadth("stream_zone", phase_stream_zone)

    # the Spark-exact string path (qstr, BASELINE.md config #4)
    breadth("qstr", phase_qstr)
    breadth("qstr_bench", phase_qstr_bench)
    breadth("qstr_dirty", phase_qstr_dirty)
    breadth("qstr_groupby", phase_qstr_groupby, cases)
    breadth("casts", phase_casts)

    # multi-GPU: the dry run, q95 over 8 shards, NCCL ranks
    breadth("multichip_dryrun", phase_multichip_dryrun)
    counts = guarded("multichip_q95", phase_multichip_q95, fact, dim1, dim2,
                     q95_arrays, cases)
    for k in total:
        total[k] += (counts or {}).get(k, 0)
    breadth("multichip_nccl", phase_multichip_nccl)

    kernels = []
    for name, lst in cases.items():
        if not lst:
            check(False, f"kernel {name}: no case completed")
            continue
        main_case, others = lst[0], lst[1:]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": total[name],
            "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "shape": main_case["shape"],
            "other_shapes": others})
    emit({"kernels": kernels})
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} failure(s); no result",
              file=sys.stderr, flush=True)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

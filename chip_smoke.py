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
14. the tiered spill store (``mem/spill.py``), last: ``spill_q6`` (the
   reference's ``bench.py --spill`` at 2^24 rows: two task threads, four
   q6 one-hot steps each on fresh batches, at most three held as
   ``SpillableHandle`` s, a device arena of 2.5 batch charges and a host
   tier of half a charge, so evicted batches go to disk; every step and
   read-back against the oracle, the transitions' bytes, the time and
   GB/s of each copy, CRC32, ``np.save`` and ``np.load``, both arenas,
   the store and the spill directory empty; and one unreferenced batch
   whose spill lowers ``memory_allocated`` by its charge);
   ``spill_faults`` (at 2^24 rows: a failed disk write keeps the batch
   in the host tier, a corrupt spill file is rebuilt through
   ``recompute=`` or raises without it, a damaged host copy is caught at
   promotion); ``spill_q9`` (q9's broadcast tables under a
   ``TaskContext`` dropped by ``spill_to_fit``, each rebuilt once by the
   next run, which equals the first bit for bit); ``spill_exchange``
   (the skewed exchange of the q95 fact and its stream over 8 shards on
   arenas smaller than their buffers: lossless, spilled, none dropped);
15. the persistent shuffle store (``shuffle/store.py``) and the
   exchange's lineage, last: ``shuffle_store`` (the q95 fact, 2^24 rows
   over 8 shards keyed on ``k``, with a store in a temporary directory
   removed at the end: a ``store_key`` exchange commits its map output
   and rounds (bytes, ms and GB/s, the device -> host copy, CRC32,
   ``np.save`` and fsync); a fresh service at epoch 1 adopts the map
   with no map step and the same rows, and a late epoch-0 put is fenced;
   a damaged first commit is quarantined and rebuilt through lineage; a
   torn commit is never adopted and its tmp dir is reaped; two injected
   round faults are re-driven and a fault on every round raises after
   four attempts with the arena drained; the skewed exchange out of
   core with two spill files corrupted recovers losslessly and with no
   recovery budget raises; a stream commits every received round, a
   second adopts them all with no all-to-all and K4 once a morsel, and
   a stream on a 4.5-chunk arena rebuilds damaged send chunks through
   K4, whose launches beyond the 512 it reports);
16. the rest of the Spark-exact expression library, last:
   ``expr_strings`` (2^20 rows: ``from_json_to_raw_map`` over JSON
   documents of 2-12 top-level fields, ``parse_uri`` HOST, PATH, QUERY
   and QUERY with a key over web-log URLs, ``format_float`` on float64
   and float32 at 0, 2 and 5 digits, ``decimal_to_string`` on
   Decimal128(38, 10) and (18, 2): a 2^14-row sample of every output
   equal byte for byte to the port's CPU run, 4096 rows against
   ``json.loads``, ``tests/uri_oracle.py`` and ``decimal``; ms, CUDA
   launches and idle share of each op); ``expr_rows`` (the JCUDF row
   transpose of q6's 2^24-row batch and of a 2^20-row batch with a
   string and a Decimal128 column, each bit-identical after the round
   trip, ``q6_step`` over the round-tripped batch equal to it over the
   original; GB/s of each direction against the bandwidth bound);
   ``expr_filter`` (a Spark runtime bloom filter at Spark's default
   size, built from ``xxhash64`` of the dim1 keys passing ``d1 == 0``
   and probed with the 2^24-row q95 fact: no false negative, the
   false-positive rate, the serialized bytes equal to the CPU port's,
   two half-builds merged equal to the whole; percentiles over 4096
   histograms, z-order and Hilbert indexes of the fact's int32 columns,
   both calendar rebases and both time-zone conversions over 2^24
   values, each against the CPU port on a sample, the zones also against
   ``zoneinfo``; named zones run when the system's TZif files exist, and
   the line says whether they did);
17. Parquet I/O (``io/``, BASELINE.md config #1), last, with its files
   in a temporary directory under ``TMPDIR`` removed at the end:
   ``parquet_write`` (q6's 2^24-row batch written by
   ``tests/parquet_writer.py``: 16 row groups of 2^20 rows, SNAPPY, ``k``
   and ``v`` dictionary-encoded, ``price`` falling back to PLAIN);
   ``parquet_footer`` (the footer and page libraries built with g++,
   seconds and version; ``read_and_filter`` over five splits, each equal
   to ``select_row_groups``, its serialized footer re-parsed by the
   port's thrift reader to the same row groups); ``parquet_fixture``
   (the committed pyarrow files of ``tests/data`` decode on the card to
   their committed digests); ``parquet_q6`` (``read_parquet`` to the
   card, then q6's one-hot step, one K1 launch, against the oracle; the
   footer, decode, decompression, upload and step ms, end-to-end Mrows/s
   and the busy and idle share of one traced read-and-step call);
   ``parquet_stream`` (``MorselSource.from_parquet`` into
   ``exchange_stream`` over 8 shards: lossless against ``read_parquet``
   plus ``exchange``, one K4 launch a morsel, each replay one decode of
   its row group; then a 2^22-row file with a sorted column whose 1 %
   predicate prunes row groups in the footer, the pruned stream equal to
   the filtered full stream); ``parquet_codecs`` (what
   ``ctypes.util.find_library`` finds for the ZSTD and BROTLI libraries,
   both loaded); ``parquet_q6_v2`` (``parquet_q6`` over the same rows
   as v2 pages, ZSTD, ``k``/``v`` DELTA_BINARY_PACKED and ``price``
   BYTE_STREAM_SPLIT); ``parquet_nested`` (``s: struct<k, v>`` about 1 %
   null, ``price`` and ``tags: list<int32>`` of 0-4 elements: q6 over the
   struct's fields with its validity ANDed in, one K1 launch, against
   the oracle, and ``tags`` equal to the written offsets and values);
18. the serving runtime (``serve/``), last: ``serve_tenants`` (the
   reference's ``bench.py --serve`` at 2^24 rows a step: 4 tenant
   streams of 3 queries of 2 steps, streams 0-1 q6's one-hot step, 2 q95
   through the hash join, 3 ``plan.execute`` of q9 pinned on the shared
   plan cache; each step's input a ``SpillableHandle`` charged to the
   tenant's ``TaskContext``, on an arena of one batch a stream plus one
   with the spill framework installed; a solo wave and a concurrent one,
   each result against its oracle and solo equal to concurrent, ints
   exact and floats rel 1e-5, the K1, K2 and K3 launches of each wave
   exact, the arenas at 0 and no spill file left; p50/p99 latency, wall
   and Mrows/s of each wave); ``serve_cancel`` (a tenant parked in the
   arena behind another is cancelled and the other answers right; a
   query past its ``timeout_s`` is re-admitted once and answers right;
   a ``task_cancel`` rule at ``serve_step`` cancels its session);
   ``serve_drain`` (the q95 fact's keyed exchange over 8 shards in two
   rounds or more inside a tenant, pipelined on the runtime's drain
   lane, bit-identical to the same exchange with no lane, then two
   tenants' at once; the wall of each); ``serve_transports`` (q6's
   column bytes over the shm plane and the frames plane, CRC-verified
   and byte-equal, the wire's small-frame round trip over unix and tcp,
   10^4 fsync'd journal appends and their replay; ms and GB/s).

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


def q6_oracle_groups(arrays):
    from spark_rapids_jni_tpu_torch import pipelines as PL

    uniq, sums, cnts, avgs = PL.q6_oracle(*arrays)
    return {int(k): {"sum_v": int(s), "cnt": int(c), "avg_price": float(a)}
            for k, s, c, a in zip(uniq, sums, cnts, avgs)}


def groups_agree(got, want, floats, label):
    """``want``'s groups and columns in ``got`` (``result_groups``' form):
    ints and counts exact, the columns in ``floats`` rel ``FLOAT_RTOL``
    (K1's and ``index_add_``'s atomics move the last bits from run to
    run).  Returns the worst float rel error."""
    check(sorted(got, key=str) == sorted(want, key=str),
          f"{label}: groups differ")
    worst = 0.0
    for k in set(got) & set(want):
        for col, v in want[k].items():
            g = got[k].get(col)
            if col in floats and v is not None and g is not None:
                check(abs(g - v) <= FLOAT_RTOL * abs(v),
                      f"{label}: {col} of {k}: {g} vs {v}")
                worst = max(worst, abs(g - v) / abs(v) if v else 0.0)
            else:
                check(g == v, f"{label}: {col} of {k}: {g} vs {v}")
    return worst


def check_q6_groups(got, arrays, label):
    """q6's groups (``result_groups``' form) against the numpy oracle:
    sums and counts exact, avg(price) rel ``FLOAT_RTOL``."""
    return groups_agree(got, q6_oracle_groups(arrays), ("avg_price",), label)


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

    groups_agree(PL.result_groups(got, ng, key),
                 PL.result_groups(want, wng, key), floats,
                 f"{label} (against the pipelines step)")


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


def tests_module(name):
    """A pure-Python oracle of ``tests/`` (standard library and numpy
    only: the card's machine runs them beside the port)."""
    import importlib

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module(name)


def json_oracle():
    """``tests/json_oracle.py``: the pure-Python model of Spark's
    ``get_json_object`` and Java's ``Double.toString``."""
    return tests_module("json_oracle")


TRACE_LEAD = 256    # marker launches that open every trace


def cuda_profile(fn, calls=1, traces=2, agree=True):
    """``traces`` traces of ``calls`` calls of ``fn`` each, recording
    device activity only: the CUDA kernels launched per call, their device
    ms per call, and each trace's launch count.  A trace can lose the
    device records of its start (on the H100, late in this script about
    every other trace lost its first 26-34, a few lost more), so each
    trace opens with ``TRACE_LEAD`` marker kernels (``torch.cuda._sleep``)
    and counts only the rest; one that kept no marker is lost and taken
    again, at most ``traces`` times more.  An op's launch count is fixed,
    so traces that disagree, or that saw no launch, give None for both
    numbers: not measured.  With ``agree=False`` (a call whose copies are
    not a fixed number of records, such as pageable host-to-device
    uploads) traces that disagree still give a device ms, that of the
    traces with the most records (a trace only ever loses records), and
    only the launch count is None."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    counts, dev_ms = [], []
    for _ in range(2 * traces):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_LEAD):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        # the raw events: key_averages() builds a Python event tree, about
        # 0.1 ms an event, too slow for a scan of 10^5 launches
        lead, n, ns = 0, 0, 0
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != cuda or e.duration_ns() <= 0:
                continue
            if "spin_kernel" in e.name():
                lead += 1
            else:
                n += 1
                ns += e.duration_ns()
        counts.append(n if lead else None)
        if lead:
            dev_ms.append(ns / 1e6 / calls)
        if len(dev_ms) == traces:
            break
    kept = [c for c in counts if c is not None]
    if len(kept) < traces or kept[0] == 0:
        return None, None, counts
    if len(set(kept)) > 1:
        if agree:
            return None, None, counts
        full = [ms for c, ms in zip(kept, dev_ms) if c == max(kept)]
        return None, sum(full) / len(full), counts
    return kept[0] / calls, sum(dev_ms) / traces, counts


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
    launches, dev_ms, _ = cuda_profile(lambda: PL.qstr_step(batch))
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
    scan_launches, scan_dev_ms, _ = cuda_profile(lambda: GJ._run(*args))
    launches, dev_ms, _ = cuda_profile(lambda: PL.qstr_step(batch))
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


# ---------------------------------------------------------------------------
# the tiered spill store (mem/spill.py) at full width
# ---------------------------------------------------------------------------

SPILL_TASK_BATCHES = 4       # bench.py --spill: q6 batches per task
SPILL_HELD = 3               # ... of which a task holds at most three
SPILL_POOL_CHARGES = 2.5     # the device arena, in batch charges
SPILL_SKEW_CHUNKS = 4        # the skewed exchange's arena: map + chunks
SPILL_STREAM_CHUNKS = 4.5    # spill_exchange's stream arena, in chunks


class HostTimers:
    """Wall time and bytes of the host pieces of a module's tier
    transitions, summed over threads: ``labels`` maps each helper of
    ``module`` to the name it is reported under.  A helper's bytes are
    those of its result or of its first argument that has ``nbytes``; a
    helper that returns a CUDA tensor is synchronized, so its copy is
    inside its time.  Patches the helpers for the block and restores
    them after."""

    def __init__(self, module, labels: dict):
        import threading

        self.module, self.labels = module, labels
        self.lock = threading.Lock()
        self.acc = {n: [0, 0, 0] for n in labels}  # ns, bytes, calls

    def _wrap(self, name, fn):
        def timed(*args):
            t0 = time.perf_counter_ns()
            out = fn(*args)
            if isinstance(out, torch.Tensor) and out.is_cuda:
                torch.cuda.synchronize()
            dt = time.perf_counter_ns() - t0
            arr = next((x for x in (out,) + args if hasattr(x, "nbytes")),
                       None)
            with self.lock:
                a = self.acc[name]
                a[0] += dt
                a[1] += int(arr.nbytes) if arr is not None else 0
                a[2] += 1
            return out
        return timed

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.labels}
        for n, fn in self.saved.items():
            setattr(self.module, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)
        return False

    def report(self) -> dict:
        out = {}
        for n, (ns, nbytes, calls) in self.acc.items():
            ms = ns / 1e6
            out[self.labels[n]] = {"ms": ms, "bytes": nbytes, "calls": calls,
                                   "gb_per_s": nbytes / (ms * 1e6)
                                   if ms and nbytes else None}
        return out


def SpillTimers() -> HostTimers:
    """The spill store's pieces: the device -> host copy, the CRC32s, the
    ``np.save`` and ``np.load`` of the disk tier and the host -> device
    copy."""
    from spark_rapids_jni_tpu_torch.mem import spill as SP

    return HostTimers(SP, {"_to_host": "device_to_host_copy",
                           "_leaf_meta": "crc32", "_write_leaf": "disk_write",
                           "_read_leaf": "disk_read",
                           "_to_device": "host_to_device_copy"})


def StoreTimers() -> HostTimers:
    """The shuffle store's pieces: a commit's device -> host copy, CRC32,
    ``np.save`` and fsync, an adoption's ``np.load`` and host -> device
    copy (adoption's CRC32s count under ``crc32`` too)."""
    from spark_rapids_jni_tpu_torch.shuffle import store as ST

    return HostTimers(ST, {"_to_host": "device_to_host_copy",
                           "_leaf_meta": "crc32", "_save": "np_save",
                           "_fsync": "fsync", "_load": "np_load",
                           "_upload": "host_to_device_copy"})


def spill_transitions(snap: dict) -> dict:
    return {t: {"bytes": snap[t + "_bytes"], "count": snap[t + "_count"]}
            for t in ("device_to_host", "host_to_disk", "disk_to_host",
                      "host_to_device")}


def spill_free_check(fw, arrays):
    """One unreferenced 2^24-row q6 handle: its spill lowers
    ``memory_allocated`` by at least its ``batch_nbytes``, its ``get()``
    restores it, and the batch it gives back runs q6 to the oracle."""
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.mem import SpillableHandle, batch_nbytes

    n = arrays[0].shape[0]
    b = PL.example_batch(n)
    charge = batch_nbytes(b)
    h = SpillableHandle(b, name="q6-free")
    del b
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    h.spill()
    spill_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    got = h.get()
    torch.cuda.synchronize()
    get_ms = (time.perf_counter() - t0) * 1e3
    back = torch.cuda.memory_allocated()
    check(before - after >= charge, f"spill_q6: a spill freed "
          f"{before - after} device bytes of a {charge}-byte handle")
    check(back - after >= charge, f"spill_q6: get() restored "
          f"{back - after} of {charge} device bytes")
    check(all(c.data.is_cuda for c in got.columns),
          "spill_q6: a leaf came back off the card")
    check_q6(*PL.q6_step(got), arrays, "spill_q6 freed handle")
    del got
    h.close()
    return {"charge_bytes": charge, "freed_bytes": before - after,
            "restored_bytes": back - after, "spill_ms": spill_ms,
            "get_ms": get_ms, "tier_after_spill": "host"}


def phase_spill_q6(q6_arrays):
    """The reference's ``bench.py --spill`` at full width: two task
    threads, each four q6 one-hot steps (K1) on fresh 2^24-row batches
    (seeds 100 * tid + i), each batch a ``SpillableHandle`` under its
    ``TaskContext``, at most three held; a device arena of 2.5 batch
    charges and a host tier of half a charge, so evictions go device ->
    host -> disk; no ``make_spillable``, ``max_retries`` 50; then each
    task reads its survivors back and runs q6 again.  Every step's groups
    against the numpy oracle, the transitions' bytes, both arenas, the
    store and the spill directory empty at the end."""
    import threading
    import traceback

    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.columnar.column import batch_from_numpy
    from spark_rapids_jni_tpu_torch.mem import (
        RmmSpark, SpillableHandle, TaskContext, batch_nbytes,
        install_spill_framework, run_with_retry, shutdown_spill_framework)
    from spark_rapids_jni_tpu_torch.ops import kernels as KER

    n = q6_arrays[0].shape[0]
    PL.q6_step(PL.example_batch(1 << 16))  # warm: K1 is loaded
    fw = install_spill_framework()
    spill_dir = fw.spill_dir
    try:
        free = spill_free_check(fw, q6_arrays)
        fw.metrics.reset()
        seeds = {tid: [100 * tid + i for i in range(SPILL_TASK_BATCHES)]
                 for tid in (1, 2)}
        host = {s: PL.example_arrays(n, s) for v in seeds.values()
                for s in v}
        ones = np.ones(n, np.bool_)

        def upload(s):
            k, v, price = host[s]
            return batch_from_numpy({"k": (k, ones, "int32"),
                                     "v": (v, ones, "int64"),
                                     "price": (price, ones, "float64")})

        charge = batch_nbytes(upload(seeds[1][0]))
        pool = int(SPILL_POOL_CHARGES * charge)
        host_pool = charge // 2
        adaptor = RmmSpark.set_event_handler(pool, host_pool_bytes=host_pool,
                                             poll_ms=10.0)
        results, errors = {}, {}
        try:
            def task(tid):
                try:
                    with TaskContext(tid) as ctx:
                        held = []
                        for i, s in enumerate(seeds[tid]):
                            def step(s=s, i=i):
                                b = upload(s)
                                h = SpillableHandle(
                                    b, ctx=ctx, name=f"q6-t{tid}-{i}")
                                return h, PL.result_groups(
                                    *PL.q6_step(b), "k")

                            h, results[("step", s)] = run_with_retry(
                                step, max_retries=50)
                            held.append((h, s))
                            if len(held) > SPILL_HELD:
                                held.pop(0)[0].close()
                        for h, s in held:
                            def read(h=h):
                                return PL.result_groups(
                                    *PL.q6_step(h.get()), "k")

                            results[("read", s)] = run_with_retry(
                                read, max_retries=50)
                            h.close()
                except BaseException:  # noqa: BLE001 - reported below
                    errors[tid] = traceback.format_exc()
                finally:
                    RmmSpark.task_done(tid)

            threads = [threading.Thread(target=task, args=(tid,),
                                        daemon=True) for tid in seeds]
            with SpillTimers() as timers:
                torch.cuda.synchronize()
                KER.reset_launches()
                t0 = time.perf_counter()
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=MEM_DEADLINE_S)
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
            counts = dict(KER.launches)
            alive = sum(th.is_alive() for th in threads)
            snap = fw.metrics.snapshot()
            tasks = {tid: {"num_retry": adaptor.get_and_reset_num_retry(tid),
                           "spill": RmmSpark.get_and_reset_task_spill_metrics(
                               tid)} for tid in seeds}
            drained = (adaptor.total_allocated(),
                       adaptor.host_total_allocated())
        finally:
            RmmSpark.clear_event_handler()
        left_handles = len(fw.store)
        left_files = os.listdir(spill_dir)
    finally:
        shutdown_spill_framework()
    check(alive == 0, f"spill_q6: {alive} tasks still running")
    check(not errors, f"spill_q6: {errors}")
    for (what, s), groups in sorted(results.items()):
        check_q6_groups(groups, host[s], f"spill_q6 {what} seed {s}")
    want_steps = 2 * (SPILL_TASK_BATCHES + SPILL_HELD)
    check(len(results) == want_steps,
          f"spill_q6: {len(results)} steps checked, expected {want_steps}")
    check(counts["onehot_groupby"] == want_steps,
          f"spill_q6: {counts['onehot_groupby']} K1 launches, expected "
          f"{want_steps}")
    check(snap["device_to_host_bytes"] > 0, "spill_q6: nothing left the card")
    check(snap["host_to_disk_bytes"] > 0, "spill_q6: nothing reached disk")
    check(snap["disk_to_host_bytes"] > 0 and snap["host_to_device_bytes"] > 0,
          "spill_q6: nothing was read back")
    check(snap["disk_write_failures"] == 0, "spill_q6: a disk write failed")
    check(drained == (0, 0), f"spill_q6: arenas left at {drained}")
    check(left_handles == 0, f"spill_q6: {left_handles} handles left")
    check(left_files == [], f"spill_q6: spill files left {left_files}")
    check(not os.path.exists(spill_dir),
          "spill_q6: the spill directory was not removed")
    rows = 2 * SPILL_TASK_BATCHES * n
    emit({"phase": "spill_q6", "metric": "q6_spill_oversubscribed",
          "mrows_per_s": rows / wall_s / 1e6, "rows": rows,
          "wall_ms": wall_s * 1e3, "charge_bytes": charge,
          "device_pool_bytes": pool, "host_pool_bytes": host_pool,
          "transitions": spill_transitions(snap),
          "eviction_ms": snap["eviction_ns"] / 1e6,
          "disk_write_failures": snap["disk_write_failures"],
          "pieces": timers.report(), "tasks": tasks, "launches": counts,
          "k1_launches": counts["onehot_groupby"], "freed_handle": free,
          "card": nvidia_smi_line()})
    return counts


def phase_spill_faults(q6_arrays):
    """At 2^24 rows: one injected ``spill_io_write`` fault leaves the
    batch in the host tier (``disk_write_failures``) and it still runs
    q6 right; one ``spill_corrupt_file`` fault is caught at read-back and
    rebuilt through ``recompute=`` (``lineage_rebuilds`` 1), and without
    lineage raises ``SpillCorruptionError``; one ``host_corrupt_probe``
    fault is caught at promotion."""
    from spark_rapids_jni_tpu_torch import faultinj
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.mem import (
        SpillableHandle, install_spill_framework, shutdown_spill_framework)

    n = q6_arrays[0].shape[0]
    total = no_kernels()
    out = {}

    def q6_of(h, label):
        (res, ng), counts, _ = driven(lambda: PL.q6_step(h.get()))
        for k, v in counts.items():
            total[k] += v
        check_q6(res, ng, q6_arrays, f"spill_faults {label}")

    def one(fault, probe):
        return {"faults": [{"match": probe, "fault": fault, "count": 1}]}

    fw = install_spill_framework()
    try:
        # a failed disk write: the batch stays host-resident
        h = SpillableHandle(PL.example_batch(n), name="fault-io")
        h.spill()
        with faultinj.scope(one("spill_io", "spill_io_write")):
            t0 = time.perf_counter()
            freed = h.spill_host()
            io_ms = (time.perf_counter() - t0) * 1e3
            fired = faultinj.fire_counts()
        m = fw.metrics.snapshot()
        check(fired == {"spill_io_write": 1}, f"spill_faults: io {fired}")
        check(h.tier == "host" and freed == 0,
              f"spill_faults: after a failed write the tier is {h.tier}")
        check(m["disk_write_failures"] == 1 and m["host_to_disk_count"] == 0,
              "spill_faults: the failed write was not counted")
        check(os.listdir(fw.spill_dir) == [],
              "spill_faults: a failed write left files")
        q6_of(h, "after spill_io")
        h.close()
        out["spill_io"] = {"tier": "host", "failed_write_ms": io_ms,
                           "disk_write_failures": m["disk_write_failures"]}

        # a corrupt spill file: rebuilt with lineage, raised without
        for lineage in (True, False):
            label = "lineage" if lineage else "no_lineage"
            h = SpillableHandle(
                PL.example_batch(n), name=f"fault-file-{label}",
                recompute=(lambda: PL.example_batch(n)) if lineage else None)
            h.spill()
            with faultinj.scope(one("spill_corrupt", "spill_corrupt_file")):
                h.spill_host()
            check(h.tier == "disk", f"spill_faults: {label} tier {h.tier}")
            t0 = time.perf_counter()
            if lineage:
                q6_of(h, "rebuilt")
                check(h.lineage_rebuilds == 1,
                      f"spill_faults: {h.lineage_rebuilds} rebuilds")
                got = "rebuilt"
            else:
                try:
                    h.get()
                    got = "read"
                except faultinj.SpillCorruptionError:
                    got = "SpillCorruptionError"
                check(got == "SpillCorruptionError",
                      f"spill_faults: a corrupt file without lineage {got}")
            out[f"spill_corrupt_{label}"] = {
                "outcome": got, "ms": (time.perf_counter() - t0) * 1e3}
            h.close()

        # a damaged host copy: caught at promotion
        h = SpillableHandle(PL.example_batch(n), name="fault-host")
        with faultinj.scope(one("host_corrupt", "host_corrupt_probe")):
            h.spill()
        try:
            h.get()
            got = "read"
        except faultinj.HostCorruptionError:
            got = "HostCorruptionError"
        check(got == "HostCorruptionError",
              f"spill_faults: a damaged host copy was {got}")
        h.close()
        out["host_corrupt"] = {"outcome": got}
        snap = fw.metrics.snapshot()
    finally:
        shutdown_spill_framework()
    check(snap["corrupt_reads"] == 3,
          f"spill_faults: {snap['corrupt_reads']} corrupt reads, expected 3")
    check(snap["lineage_rebuilds"] == 1,
          f"spill_faults: {snap['lineage_rebuilds']} lineage rebuilds")
    check(total["onehot_groupby"] == 2,
          f"spill_faults: {total['onehot_groupby']} K1 launches")
    emit({"phase": "spill_faults", "rows": n, "cases": out,
          "corrupt_reads": snap["corrupt_reads"],
          "lineage_rebuilds": snap["lineage_rebuilds"],
          "disk_write_failures": snap["disk_write_failures"],
          "launches": total, "card": nvidia_smi_line()})
    return total


def phase_spill_q9(inputs, arrays):
    """The reference's ``test_compiled_q9_probes_survive_eviction`` at
    ``plan_q9``'s size: q9 compiled and run under a spill framework and a
    ``TaskContext``; ``fw.spill_to_fit()`` drops every broadcast table;
    the next run rebuilds each once (one K2 build and one record build a
    table) and equals the first bit for bit."""
    from spark_rapids_jni_tpu_torch import plan as PLAN
    from spark_rapids_jni_tpu_torch.mem import (
        RmmSpark, TaskContext, install_spill_framework,
        shutdown_spill_framework)
    from spark_rapids_jni_tpu_torch.mem import spill as SP
    from spark_rapids_jni_tpu_torch.plan import queries as Q

    PLAN.reset_plan_cache()
    fw = install_spill_framework()
    RmmSpark.set_event_handler(16 << 30, poll_ms=10.0)
    try:
        with TaskContext(51) as ctx:
            cp = PLAN.compile_plan(Q.q9_plan(), inputs, ctx=ctx)
            (res1, ng1), counts1, _ = driven(cp, inputs)
            handles = [h for _name, h in cp.build_handles]
            charged = RmmSpark._adaptor.total_allocated()
            t0 = time.perf_counter()
            freed = fw.spill_to_fit()
            drop_ms = (time.perf_counter() - t0) * 1e3
            tiers = [h.tier for h in handles]
            (res2, ng2), counts2, s2 = driven(cp, inputs)
            rebuilds = [h.rebuilds for h in handles]
            tiers_after = [h.tier for h in handles]
        RmmSpark.task_done(51)
        drained = RmmSpark._adaptor.total_allocated()
    finally:
        RmmSpark.clear_event_handler()
        shutdown_spill_framework()
        PLAN.reset_plan_cache()
    err = check_q9(res1, ng1, arrays, "spill_q9")
    a, b = [], []
    same = (SP._flatten((res1, ng1), a) == SP._flatten((res2, ng2), b)
            and all(torch.equal(x, y) for x, y in zip(a, b)))
    nh = len(handles)
    check(nh >= 1, "spill_q9: the plan built no broadcast table")
    check(all(t == "dropped" for t in tiers),
          f"spill_q9: tiers after spill_to_fit {tiers}")
    check(all(t == "device" for t in tiers_after),
          f"spill_q9: tiers after the rerun {tiers_after}")
    check(rebuilds == [1] * nh, f"spill_q9: rebuilds {rebuilds}")
    check(same, "spill_q9: the rerun differs from the first run")
    check(counts2["slot_table_build"] == nh,
          f"spill_q9: {counts2['slot_table_build']} K2 builds in the rerun, "
          f"expected {nh}")
    check(counts2["slot_table_records"] == nh,
          f"spill_q9: {counts2['slot_table_records']} record builds")
    check(freed > 0 and freed <= charged, f"spill_q9: freed {freed} of "
          f"{charged} charged bytes")
    check(drained == 0, f"spill_q9: {drained} bytes left in the arena")
    emit({"phase": "spill_q9", "rows": inputs["fact"].num_rows,
          "handles": nh, "charged_bytes": charged, "freed_bytes": freed,
          "drop_ms": drop_ms, "rerun_ms": s2 * 1e3,
          "launches_first": counts1, "launches_rerun": counts2,
          "avg_hi_max_rel_err": err, "card": nvidia_smi_line()})
    total = no_kernels()
    for c in (counts1, counts2):
        for k, v in c.items():
            total[k] += v
    return total


def fact_oracle(fact, cols=("k", "wh", "seg", "v")):
    """The fact's rows as a sorted multiset of int64 columns."""
    from spark_rapids_jni_tpu_torch.relational.keys import lexsort

    b = [fact[c].data.to(torch.int64) for c in cols]
    pb = lexsort(b)
    return cols, [x[pb] for x in b]


def same_multiset(res, oracle, label) -> None:
    from spark_rapids_jni_tpu_torch.relational.keys import lexsort

    cols, want = oracle
    occ = res.occupancy
    a = [res.batch[c].data[occ].to(torch.int64) for c in cols]
    pa = lexsort(a)
    check(res.rows_moved == want[0].shape[0],
          f"{label}: rows_moved {res.rows_moved}")
    check(all(torch.equal(x[pa], y) for x, y in zip(a, want)),
          f"{label}: delivered multiset differs")


def phase_spill_exchange(fact):
    """``TestOutOfCore`` at full width over 8 shards, under a
    ``TaskContext`` on arenas smaller than the exchanges' buffers: the
    skewed ``exchange`` (every row to partition 0: 32 rounds of 2^16
    slots a bucket) on an arena of the map output plus four round chunks
    (the buffers: the map and 32 chunks), then the ``exchange_stream`` of
    the 2^24-row fact (K4 once a morsel) on an arena of 4.5 round chunks
    (the buffers: about four send and four received chunks).  Each
    lossless against the sent multiset, with two rounds or more, spilled
    bytes and no dropped row."""
    from spark_rapids_jni_tpu_torch.mem import (
        RmmSpark, TaskContext, batch_nbytes, install_spill_framework,
        shutdown_spill_framework)
    from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
    from spark_rapids_jni_tpu_torch.shuffle import (MorselSource,
                                                    ShuffleService,
                                                    get_registry)
    from spark_rapids_jni_tpu_torch.shuffle.planner import \
        plan_stream_capacity

    P = P_SHARDS
    n = fact.num_rows
    mesh = ShardMesh(P)
    charge = batch_nbytes(fact)
    C = plan_stream_capacity()
    # one round chunk: P * P * C slot rows of every leaf plus occupancy
    chunk = P * P * C * (charge // n + 1)
    oracle = fact_oracle(fact)
    total = no_kernels()
    out = {}

    def run(label, arena, fn):
        get_registry().reset()
        fw = install_spill_framework()
        adaptor = RmmSpark.set_event_handler(arena, poll_ms=10.0)
        try:
            with SpillTimers() as timers:
                with TaskContext(61) as ctx:
                    res, counts, s = driven(fn, ctx)
                    left = len(fw.store)
            RmmSpark.task_done(61)
            drained = adaptor.total_allocated()
            snap = fw.metrics.snapshot()
        finally:
            RmmSpark.clear_event_handler()
            shutdown_spill_framework()
        summary = get_registry().metrics.snapshot()
        same_multiset(res, oracle, f"spill_exchange {label}")
        check(res.rounds >= 2, f"spill_exchange {label}: {res.rounds} round")
        check(res.spilled_bytes > 0, f"spill_exchange {label}: no spill")
        check(summary["dropped_rows"] == 0,
              f"spill_exchange {label}: dropped {summary['dropped_rows']}")
        check(drained == 0 and left == 0, f"spill_exchange {label}: "
              f"{drained} bytes and {left} handles left")
        for k, v in counts.items():
            total[k] += v
        out[label] = {"ms": s * 1e3, "mrows_per_s": n / s / 1e6,
                      "arena_bytes": arena, "rounds": res.rounds,
                      "capacity": res.capacity,
                      "spilled_bytes": res.spilled_bytes,
                      "bytes_moved": res.bytes_moved,
                      "transitions": spill_transitions(snap),
                      "eviction_ms": snap["eviction_ns"] / 1e6,
                      "pieces": timers.report(), "launches": counts}
        del res
        torch.cuda.empty_cache()

    pid = torch.zeros(n, dtype=torch.int32, device=fact["k"].device)
    run("skewed_exchange", charge + SPILL_SKEW_CHUNKS * chunk,
        lambda ctx: ShuffleService(mesh).exchange(fact, pid=pid, ctx=ctx))
    src = MorselSource.from_batch(fact, mesh)
    run("stream", int(SPILL_STREAM_CHUNKS * chunk),
        lambda ctx: ShuffleService(mesh).exchange_stream(
            src, key_names=["k"], ctx=ctx))
    check(out.get("stream", {}).get("launches", {}).get(
        "partition_scatter", 0) == len(src),
        "spill_exchange stream: not one K4 launch a morsel")
    emit({"phase": "spill_exchange", "rows": n, "shards": P,
          "fact_charge_bytes": charge, "round_chunk_bytes": chunk,
          **out, "card": nvidia_smi_line()})
    return total


STORE_SPILL_HOST_CHUNKS = 24  # shuffle_store: the skewed run's host tier


class Counting:
    """Count the calls of ``module.name`` for a ``with`` block (the map
    step, the all-to-all): ``calls`` after it."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def counted(*a, **k):
            self.calls += 1
            return self.real(*a, **k)
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


def same_result(a, b, label) -> None:
    """Two exchanges delivered the same arrays, partition for partition."""
    from spark_rapids_jni_tpu_torch.shuffle.buffers import column_leaves

    check(torch.equal(a.occupancy, b.occupancy),
          f"{label}: occupancy differs")
    for name in a.batch.names:
        pairs = zip(column_leaves(a.batch[name]),
                    column_leaves(b.batch[name]))
        check(all(torch.equal(x, y) for x, y in pairs),
              f"{label}: column {name} differs")


def store_report(timers) -> dict:
    """A commit's or an adoption's pieces (``StoreTimers``), their sum,
    the bytes copied off the card or loaded, and the GB/s of the sum."""
    pieces = timers.report()
    ms = sum(v["ms"] for v in pieces.values())
    nbytes = (pieces["device_to_host_copy"]["bytes"]
              or pieces["np_load"]["bytes"])
    return {"ms": ms, "bytes": nbytes,
            "gb_per_s": nbytes / (ms * 1e6) if ms else None,
            "pieces": pieces}


def phase_shuffle_store(fact):
    """The persistent shuffle store and the exchange's lineage at full
    width: the q95 fact (2^24 rows over 8 shards, keyed on ``k``) with a
    store in a temporary directory that the phase removes.  (i) a
    ``store_key`` exchange commits its map output and rounds; (ii) a
    fresh service at epoch 1 (after ``stamp(1)``) adopts the map: the
    map step does not run and the rows equal (i)'s partition for
    partition, and a late epoch-0 put is fenced; (iii) a damaged first
    commit is quarantined at the next adoption, which falls back to
    lineage; (iv) a torn commit is never adopted and its tmp dir is
    reaped; (v) two injected round faults are re-driven, one on every
    round raises after four attempts with the arena drained; (vi) the
    skewed exchange out of core with two spill files corrupted recovers
    losslessly, and with no recovery budget raises; (vii) a stream
    commits every received round, a second stream adopts them all with
    no all-to-all (K4 still once a morsel), and a stream on a 4.5-chunk
    arena rebuilds a damaged send chunk by re-scattering through K4.
    Each delivered batch is held against the fact's multiset."""
    import shutil
    import tempfile

    from spark_rapids_jni_tpu_torch import config, faultinj
    from spark_rapids_jni_tpu_torch.mem import (
        RmmSpark, TaskContext, batch_nbytes, install_spill_framework,
        shutdown_spill_framework)
    from spark_rapids_jni_tpu_torch.parallel import collectives as CL
    from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
    from spark_rapids_jni_tpu_torch.shuffle import (MorselSource,
                                                    ShuffleError,
                                                    ShuffleRegistry,
                                                    ShuffleService)
    from spark_rapids_jni_tpu_torch.shuffle import service as SVC
    from spark_rapids_jni_tpu_torch.shuffle import store as ST
    from spark_rapids_jni_tpu_torch.shuffle.planner import \
        plan_stream_capacity

    P = P_SHARDS
    n = fact.num_rows
    mesh = ShardMesh(P)
    oracle = fact_oracle(fact)
    total = no_kernels()
    out = {"rows": n, "shards": P}
    root = tempfile.mkdtemp(prefix="srj_shuffle_store_")

    def fired(name, want, label):
        got = faultinj.fire_counts().get(name, 0)
        check(got == want, f"shuffle_store {label}: {name} fired {got} "
              f"times, expected {want}")

    def exchange(reg, key=None, **kw):
        return driven(lambda: ShuffleService(mesh, registry=reg).exchange(
            fact, key_names=["k"], store_key=key, **kw))

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    try:
        # the exchange alone, for the store's share of the time
        plain, counts, plain_s = exchange(ShuffleRegistry())
        add(counts)
        same_multiset(plain, oracle, "shuffle_store plain")

        # (i) commit at epoch 0
        st0 = ST.install(root, epoch=0)
        reg = ShuffleRegistry()
        with StoreTimers() as timers:
            first, counts, commit_s = exchange(reg, "q95")
        add(counts)
        same_multiset(first, oracle, "shuffle_store commit")
        same_result(first, plain, "shuffle_store commit vs plain")
        snap = st0.snapshot()
        check(snap["commits"] == 1 + first.rounds,
              f"shuffle_store commit: {snap['commits']} commits for "
              f"{first.rounds} rounds and the map")
        out["commit"] = {"s": commit_s, "exchange_alone_s": plain_s,
                         "rounds": first.rounds, "capacity": first.capacity,
                         **store_report(timers)}

        # (ii) adopt at epoch 1: a fresh service and registry
        st1 = ST.install(root, epoch=1)
        st1.stamp(1)
        reg = ShuffleRegistry()
        with Counting(SVC, "_map_keys") as maps:
            second, counts, adopt_s = exchange(reg, "q95")
        add(counts)
        m = reg.metrics.snapshot()
        check(m["adopted_shards"] == 1 and m["lineage_rebuilds"] == 0,
              f"shuffle_store adopt: adopted {m['adopted_shards']}, "
              f"rebuilt {m['lineage_rebuilds']}")
        check(maps.calls == 0, f"shuffle_store adopt: the map step ran "
              f"{maps.calls} times")
        same_result(second, first, "shuffle_store adopt vs commit")
        late = ST.ShuffleStore(root, epoch=0)
        check(not late.put("q95", "late", (fact["k"].data[:16],)),
              "shuffle_store adopt: a late epoch-0 put was not fenced")
        check(late.snapshot()["fenced_commits"] == 1,
              "shuffle_store adopt: the fenced put was not counted")
        # the adoption's own pieces: the same map entry adopted again
        with StoreTimers() as timers:
            again = st1.adopt("q95", "map", fact["k"].device)
        check(again is not None, "shuffle_store adopt: the map entry "
              "did not adopt a second time")
        del again
        out["adopt"] = {"s": adopt_s, "map_steps": maps.calls,
                        "adopted_shards": m["adopted_shards"],
                        "fenced_late_put": late.snapshot()["fenced_commits"],
                        "map_entry": store_report(timers)}
        del second
        shutil.rmtree(os.path.join(root, "q95"), ignore_errors=True)

        # (iii) store_corrupt on the first commit of a fresh key
        with faultinj.scope({"faults": [{"match": "store_corrupt_file",
                                         "fault": "store_corrupt",
                                         "count": 1}]}):
            damaged, counts, _ = exchange(ShuffleRegistry(), "q95c")
            fired("store_corrupt_file", 1, "store_corrupt")
        add(counts)
        q0 = st1.snapshot()["corrupt_quarantined"]
        reg = ShuffleRegistry()
        with Counting(SVC, "_map_keys") as maps:
            rebuilt, counts, _ = exchange(reg, "q95c")
        add(counts)
        m = reg.metrics.snapshot()
        check(st1.snapshot()["corrupt_quarantined"] == q0 + 1,
              "shuffle_store store_corrupt: the entry was not quarantined")
        check(m["lineage_rebuilds"] == 1 and m["adopted_shards"] == 0
              and maps.calls == 1, f"shuffle_store store_corrupt: "
              f"rebuilt {m['lineage_rebuilds']}, adopted "
              f"{m['adopted_shards']}, {maps.calls} map steps")
        same_result(rebuilt, first, "shuffle_store store_corrupt")
        same_result(damaged, first, "shuffle_store store_corrupt commit")
        out["store_corrupt"] = {"quarantined": 1,
                                "lineage_rebuilds": m["lineage_rebuilds"]}
        del damaged, rebuilt
        shutil.rmtree(os.path.join(root, "q95c"), ignore_errors=True)

        # (iv) store_commit: the torn map write is never adopted
        f0 = st1.snapshot()["commit_failures"]
        with faultinj.scope({"faults": [{"match": "store_commit",
                                         "fault": "store_commit",
                                         "count": 1}]}):
            torn, counts, _ = exchange(ShuffleRegistry(), "q95t")
            fired("store_commit", 1, "store_commit")
        add(counts)
        same_result(torn, first, "shuffle_store store_commit")
        check(st1.snapshot()["commit_failures"] == f0 + 1,
              "shuffle_store store_commit: no commit failure counted")
        check(not st1.has_committed("q95t", "map")
              and st1.adopt("q95t", "map", fact["k"].device) is None,
              "shuffle_store store_commit: the torn map was adoptable")
        shard_dir = os.path.join(root, "q95t", "shard-map")
        tmps = [e for e in os.listdir(shard_dir) if e.startswith(".tmp-")]
        reaped = st1.reap_uncommitted()
        left = [e for e in os.listdir(shard_dir) if e.startswith(".tmp-")]
        check(len(tmps) == 1 and reaped == 1 and not left,
              f"shuffle_store store_commit: {tmps} tmp dirs, reaped "
              f"{reaped}, left {left}")
        out["store_commit"] = {"commit_failures": 1, "reaped": reaped}
        del torn
        shutil.rmtree(os.path.join(root, "q95t"), ignore_errors=True)
        ST.shutdown_store()

        # (v) shuffle_io_round: two faults re-driven, then one on every
        # round under a task's arena
        reg = ShuffleRegistry()
        with faultinj.scope({"faults": [{"match": "shuffle_io_round",
                                         "fault": "shuffle_io",
                                         "count": 2}]}):
            redriven, counts, io_s = exchange(reg)
            fired("shuffle_io_round", 2, "shuffle_io")
        add(counts)
        check(reg.metrics.snapshot()["io_failures"] == 2,
              f"shuffle_store shuffle_io: "
              f"{reg.metrics.snapshot()['io_failures']} io failures")
        same_result(redriven, first, "shuffle_store shuffle_io")
        del redriven
        reg = ShuffleRegistry()
        fw = install_spill_framework()
        adaptor = RmmSpark.set_event_handler(1 << 40, poll_ms=10.0)
        raised = None
        try:
            with faultinj.scope({"faults": [{"match": "shuffle_io_round",
                                             "fault": "shuffle_io"}]}):
                with TaskContext(62) as ctx:
                    try:
                        exchange(reg, ctx=ctx)
                    except faultinj.ShuffleIOError as e:
                        raised = e
                    left_handles = len(fw.store)
                fired("shuffle_io_round", SVC._IO_RETRIES + 1,
                      "shuffle_io persistent")
            RmmSpark.task_done(62)
            drained = adaptor.total_allocated()
        finally:
            RmmSpark.clear_event_handler()
            shutdown_spill_framework()
        io_fail = reg.metrics.snapshot()["io_failures"]
        check(raised is not None and io_fail == SVC._IO_RETRIES + 1,
              f"shuffle_store shuffle_io persistent: raised {raised!r} "
              f"after {io_fail} failures")
        check(drained == 0 and left_handles == 0, f"shuffle_store "
              f"shuffle_io persistent: {drained} bytes and "
              f"{left_handles} handles left")
        out["shuffle_io"] = {"redriven_s": io_s, "io_failures": 2,
                             "persistent_failures": io_fail}
        torch.cuda.empty_cache()

        # (vi) recovery out of core: spill_exchange's skewed exchange
        # with its overflow on disk and two spill files corrupted
        charge = batch_nbytes(fact)
        C = plan_stream_capacity()
        chunk = P * P * C * (charge // n + 1)
        pid = torch.zeros(n, dtype=torch.int32, device=fact["k"].device)

        def skewed(label, rule, budget=None):
            reg = ShuffleRegistry()
            fw = install_spill_framework()
            adaptor = RmmSpark.set_event_handler(
                charge + SPILL_SKEW_CHUNKS * chunk,
                host_pool_bytes=STORE_SPILL_HOST_CHUNKS * chunk,
                poll_ms=10.0)
            if budget is not None:
                config.set("shuffle_max_recoveries", budget)
            res = err = None
            try:
                with faultinj.scope({"faults": [rule]}):
                    with TaskContext(63) as ctx:
                        try:
                            res, counts, s = driven(
                                lambda: ShuffleService(
                                    mesh, registry=reg).exchange(
                                        fact, pid=pid, ctx=ctx))
                            add(counts)
                        except ShuffleError as e:
                            err, s = e, None
                        left_handles = len(fw.store)
                    fired("spill_corrupt_file", rule["count"], label)
                RmmSpark.task_done(63)
                drained = adaptor.total_allocated()
                snap = fw.metrics.snapshot()
            finally:
                RmmSpark.clear_event_handler()
                shutdown_spill_framework()
                config.reset("shuffle_max_recoveries")
            check(drained == 0 and left_handles == 0,
                  f"shuffle_store {label}: {drained} bytes and "
                  f"{left_handles} handles left")
            return res, err, s, reg.metrics.snapshot(), snap

        corrupt = {"match": "spill_corrupt_file", "fault": "spill_corrupt"}
        res, err, s, m, snap = skewed("recovery", dict(corrupt, count=2))
        check(err is None and res is not None,
              f"shuffle_store recovery: raised {err!r}")
        if res is not None:
            check(res.recovered_partitions > 0,
                  "shuffle_store recovery: nothing was recovered")
            same_multiset(res, oracle, "shuffle_store recovery")
            out["recovery"] = {
                "s": s, "recovered_partitions": res.recovered_partitions,
                "lineage_rebuilds": m["lineage_rebuilds"],
                "rounds": res.rounds, "spilled_bytes": res.spilled_bytes,
                "host_to_disk_bytes": snap["host_to_disk_bytes"],
                "corrupt_reads": snap["corrupt_reads"]}
        del res
        torch.cuda.empty_cache()
        res, err, _, _, _ = skewed("recovery budget", dict(corrupt, count=1),
                                   budget=0)
        check(res is None and err is not None
              and "recovery budget" in str(err),
              f"shuffle_store recovery budget: raised {err!r}")
        out["recovery_budget"] = {"raised": type(err).__name__}
        del res
        torch.cuda.empty_cache()

        # (vii) the stream with a store
        st = ST.install(root, epoch=2)
        src = MorselSource.from_batch(fact, mesh)

        def stream(reg, key=None, ctx=None):
            return driven(lambda: ShuffleService(
                mesh, registry=reg).exchange_stream(
                    src, key_names=["k"], store_key=key, ctx=ctx))

        with StoreTimers() as timers:
            s1, counts1, s1_s = stream(ShuffleRegistry(), "q95s")
        add(counts1)
        same_multiset(s1, oracle, "shuffle_store stream commit")
        check(st.snapshot()["commits"] == s1.rounds,
              f"shuffle_store stream: {st.snapshot()['commits']} commits "
              f"for {s1.rounds} rounds")
        commit = store_report(timers)
        reg = ShuffleRegistry()
        with Counting(CL, "shard_all_to_all") as a2a, \
                StoreTimers() as timers:
            s2, counts2, s2_s = stream(reg, "q95s")
        add(counts2)
        m = reg.metrics.snapshot()
        check(m["adopted_shards"] == s2.rounds and a2a.calls == 0,
              f"shuffle_store stream adopt: adopted {m['adopted_shards']} "
              f"of {s2.rounds} rounds, {a2a.calls} all-to-alls")
        for label, c in (("commit", counts1), ("adopt", counts2)):
            check(c["partition_scatter"] == len(src),
                  f"shuffle_store stream {label}: "
                  f"{c['partition_scatter']} K4 launches for {len(src)} "
                  "morsels")
        same_result(s2, s1, "shuffle_store stream adopt vs commit")
        out["stream"] = {"commit_s": s1_s, "adopt_s": s2_s,
                         "rounds": s1.rounds, "capacity": s1.capacity,
                         "morsels": len(src),
                         "k4_launches": [counts1["partition_scatter"],
                                         counts2["partition_scatter"]],
                         "adopted_rounds": m["adopted_shards"],
                         "all_to_alls_adopting": a2a.calls,
                         "commit": commit, "adopt": store_report(timers)}
        del s2
        ST.shutdown_store()

        # a damaged send chunk on the stream's 4.5-chunk arena (its host
        # tier unbounded, as in spill_exchange): rebuilt by re-scatter
        reg = ShuffleRegistry()
        fw = install_spill_framework()
        adaptor = RmmSpark.set_event_handler(int(SPILL_STREAM_CHUNKS * chunk),
                                             poll_ms=10.0)
        try:
            with faultinj.scope({"faults": [{"match": "host_corrupt_probe",
                                             "fault": "host_corrupt",
                                             "count": 4}]}):
                with TaskContext(64) as ctx:
                    s3, counts3, s3_s = stream(reg, ctx=ctx)
                    left_handles = len(fw.store)
                fired("host_corrupt_probe", 4, "stream rebuild")
            RmmSpark.task_done(64)
            drained = adaptor.total_allocated()
        finally:
            RmmSpark.clear_event_handler()
            shutdown_spill_framework()
        add(counts3)
        extra = counts3["partition_scatter"] - len(src)
        check(s3.recovered_partitions > 0 and extra > 0,
              f"shuffle_store stream rebuild: {s3.recovered_partitions} "
              f"recovered, {extra} K4 launches beyond {len(src)}")
        check(drained == 0 and left_handles == 0,
              f"shuffle_store stream rebuild: {drained} bytes and "
              f"{left_handles} handles left")
        same_result(s3, s1, "shuffle_store stream rebuild")
        out["stream_rebuild"] = {
            "s": s3_s, "recovered_partitions": s3.recovered_partitions,
            "k4_launches": counts3["partition_scatter"],
            "k4_beyond_morsels": extra, "spilled_bytes": s3.spilled_bytes}
        del s1, s3
    finally:
        ST.shutdown_store()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    emit({"phase": "shuffle_store", **out, "launches": total,
          "card": nvidia_smi_line()})
    return total


# ---------------------------------------------------------------------------
# the rest of the Spark-exact expression library: from_json, parse_uri,
# format_float, decimal_to_string; the JCUDF row transpose; a runtime
# bloom filter, percentiles, z-order, calendar rebase and time zones
# ---------------------------------------------------------------------------

EXPR_ROWS = 1 << 20           # a Spark batch of strings (qstr's rows)
EXPR_SAMPLE_ROWS = 1 << 14    # rows held against the port on the CPU
EXPR_ORACLE_ROWS = 4096       # rows held against a Python oracle
EXPR_POOL = 4096              # distinct documents, URLs and decimals
EXPR_JSON_WIDTH = 192         # bytes a JSON document may take
EXPR_URL_WIDTH = 128
EXPR_MAX_PAIRS = 12           # top-level fields a document may have
EXPR_DIGITS = (0, 2, 5)
EXPR_DECIMALS = ((38, 10), (18, 2))
ROWS_STR_ROWS = 1 << 20       # the string/decimal batch of expr_rows
FILTER_NUM_HASHES = 6         # Spark's runtime filter defaults: 1e6
FILTER_NUM_LONGS = 8388608 // 64  # expected items, 8 Mbit
HIST_COUNT = 4096
HIST_PCTS = (0.01, 0.25, 0.5, 0.75, 0.99)
TZ_FIXED = ("+08:00", "-09:30")
TZ_NAMED = ("Asia/Shanghai", "America/Phoenix")
TZ_RECURRING = "America/Los_Angeles"  # recurring DST: both refuse it
TZ_DIR = "/usr/share/zoneinfo"


def expr_json_pool(seed=101):
    """``EXPR_POOL`` JSON objects of 2-12 top-level fields (ints, floats,
    strings with escapes and UTF-8, literals, nested arrays and objects),
    each at most ``EXPR_JSON_WIDTH`` bytes."""
    import json

    rng = np.random.default_rng(seed)
    words = ["id", "user", "ts", "event", "page", "città", "ref", "tags",
             "geo", "ok", "n", "score", "ua", "lang", "meta", "x"]

    def value(depth):
        k = int(rng.integers(0, 8 if depth == 0 else 5))
        if k == 0:
            return int(rng.integers(-10**6, 10**6))
        if k == 1:
            return round(float(rng.normal() * 100), 3)
        if k == 2:
            return words[int(rng.integers(0, len(words)))] + (
                "\n\"q\"" if rng.random() < 0.1 else "")
        if k == 3:
            return [True, False, None][int(rng.integers(0, 3))]
        if k == 4:
            return "é" * int(rng.integers(1, 4))
        if k in (5, 6):
            return [value(depth + 1) for _ in range(int(rng.integers(0, 4)))]
        return {words[int(rng.integers(0, len(words)))]: value(depth + 1)
                for _ in range(int(rng.integers(1, 3)))}

    out = []
    while len(out) < EXPR_POOL:
        fields = int(rng.integers(2, EXPR_MAX_PAIRS + 1))
        obj = {f"{words[i % len(words)]}{i}": value(0) for i in range(fields)}
        sep = (", ", ": ") if rng.random() < 0.5 else (",", ":")
        doc = json.dumps(obj, separators=sep, ensure_ascii=False)
        if len(doc.encode()) <= EXPR_JSON_WIDTH:
            out.append(doc)
    return out


def expr_url_pool(seed=102):
    """``EXPR_POOL`` web-log URLs: schemes, host names, IPv4 and IPv6
    hosts, ports, paths, escapes, query strings of 1-4 parameters and
    fragments (no userinfo, as in request logs)."""
    rng = np.random.default_rng(seed)

    def pick(xs):
        return xs[int(rng.integers(0, len(xs)))]

    out = []
    while len(out) < EXPR_POOL:
        url = pick(["https://", "http://", "https://", "ftp://"])
        url += pick(["www.nvidia.com", "shop.example.co.uk",
                     "api.%d.example.org" % int(rng.integers(0, 99)),
                     "10.%d.0.1" % int(rng.integers(0, 256)), "[::1]",
                     "[2001:db8::%x]" % int(rng.integers(0, 4096)),
                     "cdn-%d.net" % int(rng.integers(0, 999))])
        if rng.random() < 0.2:
            url += ":%d" % int(rng.integers(1, 65536))
        url += "".join("/" + pick(["a", "img", "p%d" % int(rng.integers(
            0, 999)), "%7Euser", "x.html", "api", "v2"])
            for _ in range(int(rng.integers(0, 4))))
        if rng.random() < 0.8:
            url += "?" + "&".join(
                pick(["q", "id", "utm_source", "page", "lang", "ref"])
                + "=" + pick(["1", "abc", "a%20b", "", "x.y", "%d" % int(
                    rng.integers(0, 10**6))])
                for _ in range(int(rng.integers(1, 5))))
        if rng.random() < 0.1:
            url += "#" + pick(["top", "s2", ""])
        if len(url) <= EXPR_URL_WIDTH:
            out.append(url)
    return out


def decimal_pool(precision, seed):
    """``EXPR_POOL`` unscaled values of up to ``precision`` digits (digit
    counts spread evenly, both signs) and their uint64 limbs."""
    rng = np.random.default_rng(seed)
    vals = []
    for _ in range(EXPR_POOL):
        v, left = 0, int(rng.integers(1, precision + 1))
        while left > 0:
            k = min(left, 9)
            v = v * 10**k + int(rng.integers(0, 10**k))
            left -= k
        vals.append(-v if rng.random() < 0.5 else v)
    limbs = np.array([[(v & ((1 << 128) - 1)) & ((1 << 64) - 1),
                       (v & ((1 << 128) - 1)) >> 64] for v in vals],
                     dtype=np.uint64)
    return vals, limbs


def expr_string_inputs(n, seed=103):
    """Host inputs of ``expr_strings`` (codes into the pools, so n rows
    cost a numpy gather): JSON documents, URLs, float64 and float32
    values (random bit patterns, magnitudes from 1e-6 to 1e12, specials)
    and Decimal128(38, 10) / (18, 2) unscaled values; 5 % of each null."""
    from spark_rapids_jni_tpu_torch.columnar.column import string_arrays

    rng = np.random.default_rng(seed)
    docs, urls = expr_json_pool(), expr_url_pool()
    jc = rng.integers(0, EXPR_POOL, n)
    uc = rng.integers(0, EXPR_POOL, n)
    q = n // 4
    bits = rng.integers(-2**63, 2**63 - 1, q, dtype=np.int64)
    mags = rng.random(n - q) * 10.0 ** rng.integers(-6, 13, n - q)
    f64 = np.concatenate([bits.view(np.float64),
                          np.where(rng.random(n - q) < 0.5, mags, -mags)])
    f64[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324]
    bits32 = rng.integers(0, 2**32, q, dtype=np.uint64).astype(np.uint32)
    with np.errstate(over="ignore"):
        f32 = np.concatenate([bits32.view(np.float32),
                              f64[q:].astype(np.float32)])
    decs = {}
    for i, (p, s) in enumerate(EXPR_DECIMALS):
        vals, limbs = decimal_pool(p, seed + 1 + i)
        codes = rng.integers(0, EXPR_POOL, n)
        decs[(p, s)] = (vals, codes, limbs[codes])
    return {"docs": docs, "doc_codes": jc,
            "doc_arrays": string_arrays(docs, jc, EXPR_JSON_WIDTH),
            "urls": urls, "url_codes": uc,
            "url_arrays": string_arrays(urls, uc, EXPR_URL_WIDTH),
            "f64": f64, "f32": f32, "decimals": decs,
            "valid": rng.random(n) > 0.05}


def expr_string_columns(inp, rows, device):
    """The inputs' columns (the rows ``rows`` of each, all when None) on
    ``device``."""
    from spark_rapids_jni_tpu_torch.columnar import types as TT
    from spark_rapids_jni_tpu_torch.columnar.column import (Column,
                                                            Decimal128Column,
                                                            StringColumn)

    sel = slice(None) if rows is None else rows

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a[sel])).to(device)

    valid = t(inp["valid"])
    cols = {"doc": StringColumn(t(inp["doc_arrays"][0]),
                                t(inp["doc_arrays"][1]), valid),
            "url": StringColumn(t(inp["url_arrays"][0]),
                                t(inp["url_arrays"][1]), valid),
            "f64": Column(t(inp["f64"]), valid, TT.FLOAT64),
            "f32": Column(t(inp["f32"]), valid, TT.FLOAT32)}
    for (p, s), (_, _, limbs) in inp["decimals"].items():
        cols[f"dec{p}"] = Decimal128Column(t(limbs.view(np.int64)), valid,
                                           TT.SparkType.decimal(p, s))
    return cols


def run_expr_strings(cols):
    """Every op of ``expr_strings`` over one set of columns: a dict of
    named outputs (a ListColumn for from_json, StringColumns else)."""
    from spark_rapids_jni_tpu_torch.ops.decimal_to_string import \
        decimal_to_string
    from spark_rapids_jni_tpu_torch.ops.format_float import format_float
    from spark_rapids_jni_tpu_torch.ops.from_json import from_json_to_raw_map
    from spark_rapids_jni_tpu_torch.ops.parse_uri import parse_uri

    out = {"from_json": from_json_to_raw_map(cols["doc"], EXPR_MAX_PAIRS)}
    for part, key in (("HOST", None), ("PATH", None), ("QUERY", None),
                      ("QUERY", "q")):
        out[f"parse_uri_{part}{'_' + key if key else ''}"] = parse_uri(
            cols["url"], part, key)
    for kind in ("f64", "f32"):
        for d in EXPR_DIGITS:
            out[f"format_float_{kind}_{d}"] = format_float(cols[kind], d)
    for p, _ in EXPR_DECIMALS:
        out[f"decimal_to_string_{p}"] = decimal_to_string(cols[f"dec{p}"])
    return out


def map_rows(m, rows):
    """Rows ``rows`` of a ``from_json`` map column as lists of (key bytes,
    value bytes), None for a null row (copies only those rows' pairs)."""
    offs = m.offsets.cpu().numpy()
    valid = m.validity.cpu().numpy()
    starts, ends = offs[rows], offs[np.asarray(rows) + 1]
    idx = np.concatenate([np.arange(a, b) for a, b in zip(starts, ends)]
                         + [np.zeros(0, np.int64)]).astype(np.int64)
    sel = torch.from_numpy(idx).to(m.offsets.device)

    def host(col):
        return (col.chars[sel].cpu().numpy(), col.lengths[sel].cpu().numpy())

    (kc, kl), (vc, vl) = host(m.child.field("key")), host(
        m.child.field("value"))
    out, at = [], 0
    for r, a, b in zip(rows, starts, ends):
        pairs = [(bytes(kc[i, :kl[i]]), bytes(vc[i, :vl[i]]))
                 for i in range(at, at + b - a)]
        at += b - a
        out.append(pairs if valid[r] else None)
    return out


def same_on_sample(gpu, cpu, sample, label):
    """A card tensor's rows ``sample`` equal to the CPU run's tensor."""
    idx = torch.from_numpy(sample).to(gpu.device)
    check(torch.equal(gpu[idx].cpu(), cpu),
          f"{label}: the card's sample rows differ from the CPU run")


def same_string_rows(gpu, cpu, rows, label):
    """Rows ``rows`` of a card StringColumn equal, byte for byte, to the
    CPU run over those rows."""
    for f in ("chars", "lengths", "validity"):
        same_on_sample(getattr(gpu, f), getattr(cpu, f), rows,
                       f"{label} {f}")


def expr_oracles(out, inp, rows):
    """A sample of the card's outputs against Python: ``json.loads``
    keys and raw values, ``tests/uri_oracle.py``, ``decimal`` for
    format_float and decimal_to_string; returns rows checked per op."""
    import json
    from decimal import Decimal, localcontext

    uri = tests_module("uri_oracle")
    oracle = tests_module("expr_oracle")
    valid = inp["valid"]
    done = {}
    pairs = map_rows(out["from_json"], rows)
    bad = 0
    for r, got in zip(rows, pairs):
        if not valid[r]:
            bad += got is not None
            continue
        want = json.loads(inp["docs"][inp["doc_codes"][r]])
        ok = got is not None and [k.decode() for k, _ in got] == list(want)
        for (_, v), wv in zip(got or [], want.values()):
            # a string value stays raw: its content, escapes undecoded
            raw = v.decode()
            ok = ok and json.loads('"' + raw + '"' if isinstance(wv, str)
                                   else raw) == wv
        bad += not ok
    check(bad == 0, f"expr_strings: from_json differs from json.loads at "
          f"{bad} sample rows")
    done["from_json"] = len(rows)
    for name, (part, key) in (("parse_uri_HOST", ("HOST", None)),
                              ("parse_uri_PATH", ("PATH", None)),
                              ("parse_uri_QUERY", ("QUERY", None)),
                              ("parse_uri_QUERY_q", ("QUERY", "q"))):
        got = str_rows(out[name], rows)
        want = [uri.parse_uri(inp["urls"][inp["url_codes"][r]],
                              getattr(uri, part), key) if valid[r] else None
                for r in rows]
        bad = sum(g != w for g, w in zip(got, want))
        check(bad == 0, f"expr_strings: {name} differs from uri_oracle at "
              f"{bad} sample rows")
        done[name] = len(rows)
    for kind in ("f64", "f32"):
        for d in EXPR_DIGITS:
            name = f"format_float_{kind}_{d}"
            got = str_rows(out[name], rows)
            bad = sum(g != (oracle.format_number(inp[kind][r], d,
                                                 kind == "f32")
                            if valid[r] else None)
                      for g, r in zip(got, rows))
            check(bad == 0, f"expr_strings: {name} differs from Python at "
                  f"{bad} sample rows")
            done[name] = len(rows)
    for p, s in EXPR_DECIMALS:
        vals, codes, _ = inp["decimals"][(p, s)]
        name = f"decimal_to_string_{p}"
        got = str_rows(out[name], rows)
        with localcontext() as ctx:
            ctx.prec = 80
            want = [str(Decimal(vals[codes[r]]).scaleb(-s)) if valid[r]
                    else None for r in rows]
        bad = sum(g != w for g, w in zip(got, want))
        check(bad == 0, f"expr_strings: {name} differs from Python's "
              f"Decimal at {bad} sample rows")
        done[name] = len(rows)
    return done


def str_rows(col, rows):
    """Rows ``rows`` of a StringColumn as Python strings (None if null)."""
    from spark_rapids_jni_tpu_torch.columnar.column import StringColumn

    idx = torch.from_numpy(np.asarray(rows)).to(col.chars.device)
    return StringColumn(col.chars[idx], col.lengths[idx],
                        col.validity[idx]).to_pylist()


def profiled(fn, reps=1, warmup=1, agree=True):
    """``fn``'s ms (CUDA events over ``reps`` calls after ``warmup``),
    its CUDA launches and device ms per call from ``cuda_profile``, and
    the idle share they imply (None where the traces disagreed, unless
    ``agree`` is False: see :func:`cuda_profile`).  A trace
    covers at least 100 ms (at most 10 calls); one under a second is
    taken three times, a longer one twice."""
    ms = time_ms(fn, reps=reps, warmup=warmup)
    calls = max(1, min(10, int(np.ceil(100.0 / max(ms, 1e-3)))))
    traces = 3 if ms * calls < 1000.0 else 2
    launches, dev_ms, counts = cuda_profile(fn, calls, traces, agree)
    return {"ms": ms, "cuda_launches": launches, "device_ms": dev_ms,
            "traced_calls": calls, "trace_launches": counts,
            "idle_share": (1.0 - dev_ms / ms
                           if dev_ms is not None and ms > 0 else None)}


def traced_totals(ps):
    """Profiled results ``ps``: their summed CUDA launches and the idle
    share of their summed ms, both None if one of them was not measured."""
    if any(p["cuda_launches"] is None for p in ps):
        return None, None
    return (sum(p["cuda_launches"] for p in ps),
            1.0 - sum(p["device_ms"] for p in ps) / sum(p["ms"] for p in ps))


def phase_expr_strings():
    """``from_json_to_raw_map``, ``parse_uri`` (HOST, PATH, QUERY, QUERY
    with the key ``q``), ``format_float`` on float64 and float32 at 0, 2
    and 5 digits and ``decimal_to_string`` on Decimal128(38, 10) and (18,
    2), each over 2^20 rows: a 2^14-row sample of every output byte for
    byte equal to the port's CPU run over those rows, and 4096 of them
    against Python (``json.loads``, ``tests/uri_oracle.py``,
    ``decimal``); each op's ms, CUDA launches and idle share."""
    from spark_rapids_jni_tpu_torch.columnar.column import resolve_device

    n = EXPR_ROWS
    stage = {}
    t0 = time.perf_counter()
    inp = expr_string_inputs(n)
    cols = expr_string_columns(inp, None, resolve_device(None))
    stage["setup"] = time.perf_counter() - t0
    out, counts, stage["driven"] = driven(run_expr_strings, cols)
    check_counts("expr_strings", counts, (), no_kernels())
    sample = np.arange(0, n, n // EXPR_SAMPLE_ROWS)[:EXPR_SAMPLE_ROWS]
    t0 = time.perf_counter()
    cpu = run_expr_strings(expr_string_columns(inp, sample, "cpu"))
    for name, c in cpu.items():
        if name == "from_json":
            got = map_rows(out[name], sample)
            want = map_rows(c, np.arange(len(sample)))
            check(got == want, "expr_strings: from_json's sample rows "
                  "differ from the CPU run")
        else:
            same_string_rows(out[name], c, sample, f"expr_strings {name}")
    del cpu
    stage["cpu_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    oracle_rows = sample[:: EXPR_SAMPLE_ROWS // EXPR_ORACLE_ROWS]
    oracles = expr_oracles(out, inp, oracle_rows)
    stage["oracles"] = time.perf_counter() - t0
    pairs = int(out["from_json"].offsets[-1])
    del out
    torch.cuda.empty_cache()

    from spark_rapids_jni_tpu_torch.ops.decimal_to_string import \
        decimal_to_string
    from spark_rapids_jni_tpu_torch.ops.format_float import format_float
    from spark_rapids_jni_tpu_torch.ops.from_json import from_json_to_raw_map
    from spark_rapids_jni_tpu_torch.ops.parse_uri import parse_uri

    # each op timed once (the driven run warmed them); one of each kind
    # traced for its launches and device time
    t0 = time.perf_counter()
    ops = {"from_json": lambda: from_json_to_raw_map(cols["doc"],
                                                     EXPR_MAX_PAIRS)}
    for part, key in (("HOST", None), ("PATH", None), ("QUERY", None),
                      ("QUERY", "q")):
        ops[f"parse_uri_{part}{'_' + key if key else ''}"] = (
            lambda p=part, k=key: parse_uri(cols["url"], p, k))
    for kind in ("f64", "f32"):
        for d in EXPR_DIGITS:
            ops[f"format_float_{kind}_{d}"] = (
                lambda k=kind, d=d: format_float(cols[k], d))
    for p, _ in EXPR_DECIMALS:
        ops[f"decimal_to_string_{p}"] = (
            lambda p=p: decimal_to_string(cols[f"dec{p}"]))
    traced = ("from_json", "parse_uri_HOST", "format_float_f64_2",
              "format_float_f32_2", "decimal_to_string_38")
    by_op = {}
    for name, fn in ops.items():
        if name in traced:
            by_op[name] = profiled(fn, warmup=0)
        else:
            by_op[name] = {"ms": time_ms(fn, reps=1, warmup=0)}
        by_op[name]["mrows_per_s"] = n / (by_op[name]["ms"] * 1e-3) / 1e6
        torch.cuda.empty_cache()
    stage["timing"] = time.perf_counter() - t0
    ms = sum(v["ms"] for v in by_op.values())
    tr_launches, tr_idle = traced_totals([by_op[k] for k in traced])
    emit({"phase": "expr_strings", "rows": n, "launches": counts,
          "first_run_s": stage["driven"], "ms": ms,
          "mrows_per_s": n / (ms * 1e-3) / 1e6,
          "widths": {"doc": cols["doc"].max_len, "url": cols["url"].max_len},
          "map_pairs": pairs, "by_op": by_op,
          "cuda_launches_traced_ops": tr_launches,
          "idle_share_traced_ops": tr_idle,
          "stage_s": stage, "sample_rows": len(sample),
          "oracle_rows": oracles, "card": nvidia_smi_line()})
    del cols
    torch.cuda.empty_cache()
    return counts


def rows_case(label, batch, schema):
    """One batch to rows and back: bit-identical, the row images of a
    sample equal to the CPU run's, both directions timed and profiled
    against the bandwidth bound."""
    import dataclasses

    from spark_rapids_jni_tpu_torch.columnar.column import (ColumnBatch,
                                                            Decimal128Column,
                                                            StringColumn)
    from spark_rapids_jni_tpu_torch.mem.executor import batch_nbytes
    from spark_rapids_jni_tpu_torch.ops import row_conversion as RC
    from spark_rapids_jni_tpu_torch.relational.gather import gather_batch

    (rows, back), counts, first_s = driven(
        lambda: (lambda r: (r, RC.convert_from_rows(r, schema)))(
            RC.convert_to_rows(batch)))
    check_counts(f"expr_rows {label}", counts, (), no_kernels())
    for name, c in zip(batch.names, batch.columns):
        b, v = back[name], c.validity
        if isinstance(c, StringColumn):
            same = (torch.equal(b.chars[v], c.chars[v])
                    and torch.equal(b.lengths, c.lengths * v))
        elif isinstance(c, Decimal128Column):
            same = torch.equal(b.limbs[v], c.limbs[v])
        else:
            same = torch.equal(b.data.contiguous().view(torch.uint8),
                               c.data.contiguous().view(torch.uint8))
        check(same and torch.equal(b.validity, v), f"expr_rows {label}: "
              f"column {name} differs after the round trip")
    # the row images themselves: a sample against the CPU run
    sample = np.arange(0, batch.num_rows,
                       batch.num_rows // EXPR_SAMPLE_ROWS)[:EXPR_SAMPLE_ROWS]
    part = gather_batch(batch, torch.from_numpy(sample).to(rows.chars.device))
    part = ColumnBatch({name: dataclasses.replace(c, **{
        f.name: getattr(c, f.name).cpu() for f in dataclasses.fields(c)
        if isinstance(getattr(c, f.name), torch.Tensor)})
        for name, c in zip(part.names, part.columns)})
    same_string_rows(rows, RC.convert_to_rows(part), sample,
                     f"expr_rows {label} row images")
    # each input read once, each output written once, either way
    nbytes = batch_nbytes(batch) + batch_nbytes(rows)
    out = {"rows": batch.num_rows, "row_width": rows.chars.shape[1],
           "first_run_s": first_s}
    for way, fn in (("to_rows", lambda: RC.convert_to_rows(batch)),
                    ("from_rows", lambda: RC.convert_from_rows(rows,
                                                               schema))):
        p = profiled(fn, reps=3)
        bound, by = bound_ms(nbytes)
        p.update(gb_per_s=nbytes / (p["ms"] * 1e-3) / 1e9, bytes=nbytes,
                 bound_ms=bound, bound_by=by,
                 share_of_bound=bound / p["ms"])
        out[way] = p
    del rows, back
    torch.cuda.empty_cache()
    return out, counts


def rows_string_batch(n, device=None, seed=104):
    """The 2^20-row transpose batch: an int64 id, a string of 1-24 bytes
    (UTF-8 among them) and a Decimal128(38, 10), 5 % nulls each."""
    from spark_rapids_jni_tpu_torch.columnar.column import (batch_from_numpy,
                                                            string_arrays)

    rng = np.random.default_rng(seed)
    words = ["", "a", "spark", "rapids", "ünïcode", "row", "x" * 24,
             "columnar", "jcudf"] + ["w%d" % i for i in range(100)]
    chars, lengths = string_arrays(words, rng.integers(0, len(words), n), 24)
    _, limbs = decimal_pool(38, seed)
    return batch_from_numpy({
        "id": (rng.integers(-2**62, 2**62, n), rng.random(n) > 0.05,
               "int64"),
        "s": ((chars, lengths), rng.random(n) > 0.05, "string"),
        "d": (limbs[rng.integers(0, EXPR_POOL, n)], rng.random(n) > 0.05,
              "decimal(38,10)")}, device)


def phase_expr_rows(q6b, q6_arrays):
    """The JCUDF row transpose at its two sizes: q6's 2^24-row batch
    (int32, int64, float64: 32-byte rows) to rows and back bit-identical,
    and ``q6_step`` over the round-tripped batch equal to it over the
    original and to the oracle; a 2^20-row batch with a string and a
    Decimal128 column, bit-identical back; each batch's row images equal
    to the CPU run's on a 2^14-row sample.  Each direction's ms, GB/s
    against 3.35 TB/s, CUDA launches and idle share."""
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.columnar import types as TT
    from spark_rapids_jni_tpu_torch.ops import row_conversion as RC

    total = no_kernels()
    schema = {"k": TT.INT32, "v": TT.INT64, "price": TT.FLOAT64}
    q6_out, counts = rows_case("q6", q6b, schema)
    back = RC.convert_from_rows(RC.convert_to_rows(q6b), schema)
    (res, ng), c1, _ = driven(PL.q6_step, back)
    want, wng = PL.q6_step(q6b)
    same_groups(res, ng, want, wng, "k", ("avg_price",),
                "expr_rows q6_step after the round trip")
    check_q6(res, ng, q6_arrays, "expr_rows q6_step after the round trip")
    for k in total:
        total[k] += c1.get(k, 0)
    del back, res, want
    torch.cuda.empty_cache()
    sb = rows_string_batch(ROWS_STR_ROWS)
    str_out, _ = rows_case("strings", sb, {
        "id": TT.INT64, "s": (TT.STRING, sb["s"].max_len),
        "d": TT.SparkType.decimal(38, 10)})
    del sb
    torch.cuda.empty_cache()
    emit({"phase": "expr_rows", "q6": q6_out, "strings": str_out,
          "q6_step_launches": c1, "launches": total,
          "ms": q6_out["to_rows"]["ms"] + q6_out["from_rows"]["ms"],
          "mrows_per_s": q6b.num_rows / (q6_out["to_rows"]["ms"] * 1e-3)
          / 1e6, "card": nvidia_smi_line()})
    return total


def filter_inputs(n, seed=105):
    """Host DATE days (before and after the 1582 cutover), TIMESTAMP
    micros (sub-day parts) and UTC micros (1906-2033, sub-second) of the
    rebase and time-zone runs."""
    rng = np.random.default_rng(seed)
    days = rng.integers(-800_000, 30_000, n).astype(np.int32)
    micros = (rng.integers(-800_000, 30_000, n) * 86_400_000_000
              + rng.integers(0, 86_400_000_000, n))
    utc = (rng.integers(-2_000_000_000, 2_000_000_000, n) * 1_000_000
           + rng.integers(-999_999, 1_000_000, n))
    return days, micros, utc


def histogram_inputs(seed=106):
    """``HIST_COUNT`` histograms of 0-63 float64 values (10 % null) with
    int64 frequencies in [0, 10) (5 % null): ``(offsets, values, vvalid,
    freqs, fvalid)``."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 64, HIST_COUNT)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    m = int(offsets[-1])
    return (offsets, np.round(rng.normal(size=m) * 1000, 2),
            rng.random(m) > 0.1, rng.integers(0, 10, m), rng.random(m) > 0.05)


def run_histograms(h, device):
    from spark_rapids_jni_tpu_torch.columnar import types as TT
    from spark_rapids_jni_tpu_torch.columnar.column import Column
    from spark_rapids_jni_tpu_torch.ops import histogram as HG

    offsets, vals, vvalid, freqs, fvalid = (torch.from_numpy(a).to(device)
                                            for a in h)
    v, f = HG.create_histogram_if_valid(Column(vals, vvalid, TT.FLOAT64),
                                        Column(freqs, fvalid, TT.INT64))
    return HG.percentile_from_histogram(v, f, offsets, HIST_PCTS)


def phase_expr_filter(fact, dim1, q95_arrays):
    """A Spark runtime bloom filter on q95's join (``InjectRuntimeFilter``
    at Spark's defaults: 1 000 000 expected items, 8 388 608 bits, so
    131 072 longs and 6 hashes), built from ``xxhash64`` of the keys of
    the dim1 rows with ``d1 == 0`` (1/9 of them) and probed with the
    2^24-row fact's: no false negative against numpy, the false-positive
    rate, the serialized bytes equal to the CPU port's, two half-builds
    merged equal to the whole.  Then ``percentile_from_histogram`` over
    4096 histograms, ``interleave_bits`` and ``hilbert_index`` over the
    fact's three int32 columns, both calendar rebases over 2^24 DATE and
    TIMESTAMP values and both time-zone conversions over 2^24 timestamps
    (fixed offsets always; Asia/Shanghai and America/Phoenix when the
    system's TZif files exist; America/Los_Angeles, which has recurring
    DST, refused as Spark's ``isSupportedTimeZone`` refuses it), each
    against the port's CPU run on a 2^14-row sample, the time zones also
    against ``zoneinfo``."""
    from spark_rapids_jni_tpu_torch.columnar import types as TT
    from spark_rapids_jni_tpu_torch.columnar.column import Column
    from spark_rapids_jni_tpu_torch.ops import bloom_filter as BF
    from spark_rapids_jni_tpu_torch.ops import datetime_rebase as RB
    from spark_rapids_jni_tpu_torch.ops import timezones as TZ
    from spark_rapids_jni_tpu_torch.ops import zorder as ZO
    from spark_rapids_jni_tpu_torch.ops.hashing import xxhash64

    n = fact.num_rows
    dev = fact["k"].data.device
    keep = dim1["d1"].data == 0
    dk = dim1["k"]

    def build(mask):
        h = xxhash64([dk]).data
        return BF.bloom_filter_build(FILTER_NUM_HASHES, FILTER_NUM_LONGS,
                                     Column(h, mask & dk.validity, TT.INT64))

    def probe(bf):
        fk = fact["k"]
        return BF.bloom_filter_probe(bf, Column(xxhash64([fk]).data,
                                                fk.validity, TT.INT64))

    (bf, hit), counts, first_s = driven(
        lambda: (lambda b: (b, probe(b)))(build(keep)))
    check_counts("expr_filter", counts, (), no_kernels())
    arr = q95_arrays
    passing = arr["dim1"]["d1"] == 0
    member = passing[arr["fact"]["k"]]
    got = hit.data.cpu().numpy()
    false_neg = int((~got & member).sum())
    check(false_neg == 0, f"expr_filter: {false_neg} false negatives")
    fp_rate = float(got[~member].mean())
    ser = BF.bloom_filter_serialize(bf)
    cpu_k = Column(dk.data.cpu(), dk.validity.cpu(), dk.dtype)
    cpu_bf = BF.bloom_filter_build(
        FILTER_NUM_HASHES, FILTER_NUM_LONGS,
        Column(xxhash64([cpu_k]).data, torch.from_numpy(passing), TT.INT64))
    check(BF.bloom_filter_serialize(cpu_bf) == ser,
          "expr_filter: the serialized filter differs from the CPU port's")
    half = torch.arange(dk.num_rows, device=dev) < dk.num_rows // 2
    merged = BF.bloom_filter_merge([build(keep & half), build(keep & ~half)])
    check(torch.equal(merged.bits, bf.bits),
          "expr_filter: two merged half-builds differ from the whole build")
    by_op = {"build": profiled(lambda: build(keep), reps=3),
             "probe": profiled(lambda: probe(bf), reps=3)}
    by_op["probe"]["mrows_per_s"] = n / (by_op["probe"]["ms"] * 1e-3) / 1e6
    out = {"bloom": {"num_longs": FILTER_NUM_LONGS,
                     "num_hashes": FILTER_NUM_HASHES,
                     "build_rows": int(passing.sum()), "probe_rows": n,
                     "members": int(member.sum()), "hits": int(got.sum()),
                     "false_negatives": false_neg,
                     "false_positive_rate": fp_rate,
                     "serialized_bytes": len(ser),
                     "bits_set": int(bf.bits.sum())}}
    del hit, merged
    sample = np.arange(0, n, n // EXPR_SAMPLE_ROWS)[:EXPR_SAMPLE_ROWS]
    ts = torch.from_numpy(sample)

    # percentiles over 4096 histograms: the whole batch on the CPU too
    h = histogram_inputs()
    pct, pvalid = run_histograms(h, dev)
    cpct, cvalid = run_histograms(h, "cpu")
    check(torch.equal(pvalid.cpu(), cvalid)
          and torch.equal(pct.cpu()[cvalid].view(torch.int64),
                          cpct[cvalid].view(torch.int64)),
          "expr_filter: percentiles differ from the CPU run")
    by_op["percentile"] = profiled(lambda: run_histograms(h, dev), reps=3)
    out["histograms"] = {"count": HIST_COUNT, "entries": int(h[0][-1]),
                         "valid": int(cvalid.sum())}

    # z-order over the fact's three int32 columns
    zcols = [fact[c] for c in ("k", "wh", "seg")]
    zcpu = [Column(c.data[ts.to(dev)].cpu(), c.validity[ts.to(dev)].cpu(),
                   c.dtype) for c in zcols]
    z = ZO.interleave_bits(zcols)
    same_on_sample(z.chars, ZO.interleave_bits(zcpu).chars, sample,
                   "expr_filter interleave_bits")
    hb = ZO.hilbert_index(21, zcols)
    same_on_sample(hb.data, ZO.hilbert_index(21, zcpu).data, sample,
                   "expr_filter hilbert_index")
    del z, hb
    by_op["interleave_bits"] = profiled(lambda: ZO.interleave_bits(zcols),
                                        reps=3)
    by_op["hilbert_index"] = profiled(lambda: ZO.hilbert_index(21, zcols),
                                      reps=3)

    # calendar rebase and time zones over 2^24 values
    days, micros, utc = filter_inputs(n)
    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    dcol = Column(torch.from_numpy(days).to(dev), ones, TT.DATE)
    mcol = Column(torch.from_numpy(micros).to(dev), ones, TT.TIMESTAMP)
    for fn in ("rebase_gregorian_to_julian", "rebase_julian_to_gregorian"):
        for label, col, host in (("date", dcol, days), ("timestamp", mcol,
                                                        micros)):
            got = getattr(RB, fn)(col).data
            cpu = getattr(RB, fn)(Column(torch.from_numpy(host[sample]),
                                         torch.ones(len(sample),
                                                    dtype=torch.bool),
                                         col.dtype)).data
            same_on_sample(got, cpu, sample, f"expr_filter {fn} {label}")
            by_op[f"{fn}_{label}"] = profiled(
                lambda f=fn, c=col: getattr(RB, f)(c), reps=3)
    del dcol, mcol
    ucol = Column(torch.from_numpy(utc).to(dev), ones, TT.TIMESTAMP)
    tzdata = all(os.path.isfile(os.path.join(TZ_DIR, *z.split("/")))
                 for z in TZ_NAMED)
    zones = list(TZ_FIXED) + (list(TZ_NAMED) if tzdata else [])
    db, cdb = TZ.TimeZoneDB(), TZ.TimeZoneDB(device="cpu")
    oracle = tests_module("expr_oracle")
    oracle_rows = sample[:: EXPR_SAMPLE_ROWS // EXPR_ORACLE_ROWS]
    ucpu = Column(torch.from_numpy(utc[sample]),
                  torch.ones(len(sample), dtype=torch.bool), TT.TIMESTAMP)
    for zone in zones:
        local = TZ.convert_utc_to_timezone(ucol, zone, db)
        same_on_sample(local.data, TZ.convert_utc_to_timezone(
            ucpu, zone, cdb).data, sample, f"expr_filter to {zone}")
        back = TZ.convert_timestamp_to_utc(local, zone, db)
        lcpu = Column(local.data[torch.from_numpy(sample).to(dev)].cpu(),
                      ucpu.validity, TT.TIMESTAMP)
        same_on_sample(back.data, TZ.convert_timestamp_to_utc(
            lcpu, zone, cdb).data, sample, f"expr_filter from {zone}")
        lh = local.data.cpu().numpy()
        bad = sum(int(lh[r]) != int(utc[r]) + oracle.zone_offset_micros(
            zone, int(utc[r])) for r in oracle_rows)
        check(bad == 0, f"expr_filter: {zone} differs from zoneinfo at "
              f"{bad} sample rows")
        by_op[f"to_{zone}"] = profiled(
            lambda z=zone: TZ.convert_utc_to_timezone(ucol, z, db), reps=3)
        by_op[f"from_{zone}"] = profiled(
            lambda z=zone: TZ.convert_timestamp_to_utc(ucol, z, db), reps=3)
        del local, back
    refused = None
    if os.path.isfile(os.path.join(TZ_DIR, *TZ_RECURRING.split("/"))):
        try:
            TZ.convert_utc_to_timezone(ucol, TZ_RECURRING, db)
        except ValueError as e:
            refused = str(e)
        check(refused is not None, f"expr_filter: {TZ_RECURRING} (recurring "
              "DST) was not refused")
    del ucol
    torch.cuda.empty_cache()
    ms = sum(v["ms"] for v in by_op.values())
    launches, idle = traced_totals(list(by_op.values()))
    emit({"phase": "expr_filter", "rows": n, "launches": counts,
          "first_run_s": first_s, "ms": ms,
          "mrows_per_s": by_op["probe"]["mrows_per_s"], **out,
          "by_op": by_op,
          "cuda_launches": launches, "idle_share": idle, "tzdata": tzdata,
          "zones": zones, "recurring_refused": refused,
          "sample_rows": len(sample), "oracle_rows": len(oracle_rows),
          "card": nvidia_smi_line()})
    return counts


# ---------------------------------------------------------------------------
# Parquet I/O (BASELINE.md config #1): the footer engine, the page decoder,
# q6 from a Parquet file and the streamed scan
# ---------------------------------------------------------------------------

PQ_ROW_GROUP_ROWS = 1 << 20   # pyarrow's default row-group size
PQ_PAGE_ROWS = 1 << 17        # 1 MiB of price a page, pyarrow's page size
PQ_PRUNE_ROWS = 1 << 22       # the pruning file: 16 groups of 2^18 rows
PQ_PRUNE_SELECTIVITY = 0.01


def parquet_writer():
    """``tests/parquet_writer.py``: the numpy Parquet writer."""
    return tests_module("parquet_writer")


def write_q6_parquet(arrays, root):
    """The q6 batch as a Parquet file: 16 row groups of 2^20 rows, SNAPPY
    pages of 2^17 rows, ``k`` and ``v`` dictionary-encoded, ``price``
    dictionary-encoded for its first page of each group and PLAIN after
    (a 1 MiB dictionary, where pyarrow falls back)."""
    k, v, price = arrays
    path = os.path.join(root, "q6.parquet")
    t0 = time.perf_counter()
    parquet_writer().write_parquet(
        path, {"k": (k, None), "v": (v, None), "price": (price, None)},
        row_group_rows=PQ_ROW_GROUP_ROWS, page_rows=PQ_PAGE_ROWS,
        codec="snappy", dictionary={"k": None, "v": None,
                                    "price": PQ_PAGE_ROWS})
    emit({"phase": "parquet_write", "rows": len(k), "seconds":
          time.perf_counter() - t0, "bytes": os.path.getsize(path)})
    return path


def phase_parquet_footer(path):
    """The port's footer library built with g++ here; ``read_and_filter``
    over five splits of the q6 file, each equal to ``select_row_groups``;
    ``serialize()`` re-parsed by the port's thrift reader to the same row
    groups; the footer's ms."""
    from spark_rapids_jni_tpu_torch.io import ParquetFooter, \
        read_footer_bytes
    from spark_rapids_jni_tpu_torch.io import pages as PG
    from spark_rapids_jni_tpu_torch.io import parquet_footer as PF
    from spark_rapids_jni_tpu_torch.io import thrift
    from spark_rapids_jni_tpu_torch.io.metadata import read_metadata
    from spark_rapids_jni_tpu_torch.io.parquet import select_row_groups
    from spark_rapids_jni_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = [os.path.relpath(_build.build_host(src))
            for src in (PF.LIB_SOURCE, PG.LIB_SOURCE)]
    build_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    raw = read_footer_bytes(path)
    meta = read_metadata(path)
    splits = []
    for off, ln in ((0, size), (0, size // 2), (size // 2, size), (0, 1),
                    (size // 3, size // 3)):
        keep = select_row_groups(meta, off, ln)
        rows = sum(meta.row_group(i).num_rows for i in keep)
        with ParquetFooter.read_and_filter(raw, off, ln) as f:
            got = (f.num_row_groups, f.num_rows, f.num_columns)
            back = thrift.file_metadata(f.serialize()[4:-8])
        check(got == (len(keep), rows, 3),
              f"parquet_footer: split {(off, ln)} kept {got}, the scan "
              f"{(len(keep), rows, 3)}")
        check([g.num_rows for g in back.row_groups or []]
              == [meta.row_group(i).num_rows for i in keep]
              and back.num_rows == rows,
              f"parquet_footer: split {(off, ln)}'s serialized footer "
              "re-parses to other row groups")
        splits.append({"split": [off, ln], "row_groups": len(keep),
                       "rows": rows})
    check(meta.num_row_groups == 16 and meta.num_rows == N_FACT,
          f"parquet_footer: {meta.num_row_groups} groups, "
          f"{meta.num_rows} rows")
    footer_ms = host_call_ms(lambda: read_metadata(path), reps=20)
    filter_ms = host_call_ms(
        lambda: ParquetFooter.read_and_filter(raw, 0, size // 2).close(),
        reps=20)
    emit({"phase": "parquet_footer", "libraries": libs,
          "build_s": build_s, "gxx": _build.gxx_version(),
          "file_bytes": size, "footer_bytes": len(raw),
          "footer_ms": footer_ms, "read_and_filter_ms": filter_ms,
          "splits": splits})
    return {}


def phase_parquet_fixture():
    """The committed pyarrow files (``tests/data``) decode on the card to
    their committed digests, with string columns decoded and as
    dictionaries."""
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch.io import read_parquet
    from spark_rapids_jni_tpu_torch.shuffle.morsel import batch_digest

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "data")
    with open(os.path.join(data, "parquet_fixtures.json")) as f:
        digests = json.load(f)
    files = {}
    for name, want in sorted(digests.items()):
        for mode in ("off", "on"):
            config.set("encoded_execution", mode)
            try:
                t0 = time.perf_counter()
                b = read_parquet(os.path.join(data, name))
                ms = (time.perf_counter() - t0) * 1e3
                got = batch_digest(b)
            finally:
                config.reset("encoded_execution")
            check(got == want, f"parquet_fixture: {name} ({mode}) decodes "
                  f"to {got}, committed {want}")
            files[f"{name}:{mode}"] = {"rows": b.num_rows, "ms": ms,
                                       "device": str(b.columns[0].device)}
    emit({"phase": "parquet_fixture", "files": files})
    return {}


def phase_parquet_q6(path, arrays, name="parquet_q6", info=None):
    """BASELINE config #1: ``read_parquet`` of the q6 file to the card,
    then q6's one-hot step (K1) on the decoded batch, against the
    oracle; the footer, decode (GB/s of file bytes), decompression,
    upload and step ms, end-to-end Mrows/s, and the device's busy and
    idle share of one traced read-and-step call.  ``parquet_q6_v2``
    runs it over the v2/ZSTD/DELTA file."""
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.io import pages as PG
    from spark_rapids_jni_tpu_torch.io import read_parquet

    n = len(arrays[0])
    PG.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = read_parquet(path)
    torch.cuda.synchronize()
    read_ms = (time.perf_counter() - t0) * 1e3
    stats = dict(PG.STATS)
    check(batch.num_rows == n and batch["k"].data.is_cuda,
          f"{name}: read {batch.num_rows} rows")
    for col, want in zip(("k", "v", "price"), arrays):
        check(np.array_equal(batch[col].data.cpu().numpy(), want),
              f"{name}: column {col} differs from the written one")
    (res, ng), counts, first_s = driven(PL.q6_step, batch)
    err = check_q6(res, ng, arrays, name)
    check_counts(name, counts, ("onehot_groupby",), {"onehot_groupby": 1})
    step_ms = time_ms(lambda: PL.q6_step(batch), reps=3)

    def read_and_step():
        return PL.q6_step(read_parquet(path))

    # the busy share needs the device ms of a complete trace, not traces
    # that agree on a count (late in the script one trace in three lost
    # records here: 48, 19, 48)
    traced = profiled(read_and_step, reps=1, warmup=0, agree=False)
    e2e_ms = traced["ms"]
    emit({"phase": name, **(info or {}), "rows": n, "groups": int(ng),
          "file_bytes": os.path.getsize(path), "launches": counts,
          "avg_price_max_rel_err": err, "read_ms": read_ms,
          "footer_ms": stats["footer_s"] * 1e3,
          "decode_ms": stats["decode_s"] * 1e3,
          "decode_gb_per_s": stats["file_bytes"] / stats["decode_s"] / 1e9,
          "decompress_ms": stats["decompress_s"] * 1e3,
          "upload_ms": stats["upload_s"] * 1e3,
          "upload_gb_per_s": n * 20 / stats["upload_s"] / 1e9,
          "pages": stats["pages"], "step_first_s": first_s,
          "step_ms": step_ms, "e2e_ms": e2e_ms,
          "e2e_mrows_per_s": n / (e2e_ms * 1e-3) / 1e6,
          "e2e_cuda_launches": traced["cuda_launches"],
          "e2e_trace_launches": traced["trace_launches"],
          "e2e_device_ms": traced["device_ms"],
          "busy_share": (None if traced["idle_share"] is None
                         else 1.0 - traced["idle_share"]),
          "idle_share": traced["idle_share"], "card": nvidia_smi_line()})
    return counts


def write_q6_v2_parquet(arrays, root):
    """The q6 batch as a Spark-v2-style file: 16 row groups of 2^20 rows,
    v2 pages of 2^17 rows, ZSTD, ``k`` and ``v`` DELTA_BINARY_PACKED,
    ``price`` BYTE_STREAM_SPLIT."""
    k, v, price = arrays
    path = os.path.join(root, "q6_v2.parquet")
    t0 = time.perf_counter()
    parquet_writer().write_parquet(
        path, {"k": (k, None), "v": (v, None), "price": (price, None)},
        row_group_rows=PQ_ROW_GROUP_ROWS, page_rows=PQ_PAGE_ROWS,
        codec="zstd", page_version=2,
        encoding={"k": "delta", "v": "delta", "price": "bss"})
    return path, time.perf_counter() - t0


def phase_parquet_q6_v2(arrays, root):
    """``parquet_q6`` over the v2/ZSTD/DELTA/BYTE_STREAM_SPLIT file."""
    path, write_s = write_q6_v2_parquet(arrays, root)
    return phase_parquet_q6(path, arrays, "parquet_q6_v2", {
        "write_s": write_s, "codec": "ZSTD", "page_version": 2,
        "encodings": {"k": "DELTA_BINARY_PACKED",
                      "v": "DELTA_BINARY_PACKED",
                      "price": "BYTE_STREAM_SPLIT"}})


def nested_q6_arrays(arrays, seed=161):
    """The nested q6 file's host data: the q6 arrays, the struct's
    validity (about 1 % null), and ``tags``' offsets (0-4 elements, about
    5 % null lists), values and list validity."""
    n = len(arrays[0])
    rng = np.random.default_rng(seed)
    s_valid = rng.random(n) >= 0.01
    lens = rng.integers(0, 5, n)
    t_valid = rng.random(n) >= 0.05
    lens[~t_valid] = 0
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    tags = rng.integers(-1000, 1000, int(offsets[-1])).astype(np.int32)
    return s_valid, offsets, tags, t_valid


def check_q6_nested(got, arrays, s_valid, label):
    """q6 over ``s.k``/``s.v`` with the struct's nulls: the live keys'
    groups as ``check_q6_groups`` holds them, and the null key's group
    (count(*) and avg(price) of the null structs' rows, sum(v) null)."""
    k, v, price = arrays
    live = {kk: g for kk, g in got.items() if kk is not None}
    err = check_q6_groups(live, (k[s_valid], v[s_valid], price[s_valid]),
                          label)
    rows = (~s_valid) & (price < 50.0)
    null = got.get(None)
    check(null is not None and null["cnt"] == int(rows.sum())
          and null["sum_v"] is None,
          f"{label}: the null struct group is {null}")
    want = float(price[rows].mean())
    if null is not None and null["avg_price"] is not None:
        err = max(err, abs(null["avg_price"] - want) / abs(want))
    check(err <= FLOAT_RTOL, f"{label}: avg(price) rel err {err}")
    return err


def phase_parquet_nested(arrays, root):
    """A nested q6 file (``s: struct<k: int32, v: int64>`` about 1 % null,
    ``price``, ``tags: list<int32>`` of 0-4 elements; v1 pages, SNAPPY,
    16 row groups of 2^20 rows) read to the card: q6 over ``s.k`` and
    ``s.v`` with the struct's validity ANDed into theirs (Spark's
    ``GetStructField``) is one K1 launch against the oracle, and ``tags``
    holds the written offsets and values."""
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.columnar.column import (ColumnBatch,
                                                            Column)
    from spark_rapids_jni_tpu_torch.io import pages as PG
    from spark_rapids_jni_tpu_torch.io import read_parquet

    W = parquet_writer()
    k, v, price = arrays
    n = len(k)
    s_valid, offsets, tags, t_valid = nested_q6_arrays(arrays)
    path = os.path.join(root, "q6_nested.parquet")
    ones = np.ones(n, np.bool_)
    t0 = time.perf_counter()
    W.write_parquet(path, {
        "s": W.Struct({"k": (k, ones), "v": (v, ones)}, s_valid),
        "price": (price, None),
        "tags": W.List(offsets, (tags, None), valid=t_valid)},
        row_group_rows=PQ_ROW_GROUP_ROWS, page_rows=PQ_PAGE_ROWS,
        codec="snappy")
    write_s = time.perf_counter() - t0
    PG.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = read_parquet(path)
    torch.cuda.synchronize()
    read_ms = (time.perf_counter() - t0) * 1e3
    stats = dict(PG.STATS)
    s, tag_col = batch["s"], batch["tags"]
    check(batch.num_rows == n and s.validity.is_cuda,
          f"parquet_nested: read {batch.num_rows} rows")
    check(np.array_equal(s.validity.cpu().numpy(), s_valid),
          "parquet_nested: the struct's validity differs")
    sk, sv = s.children
    for col, want in ((sk, k), (sv, v)):
        check(np.array_equal(col.data.cpu().numpy()[s_valid],
                             want[s_valid])
              and np.array_equal(col.validity.cpu().numpy(), s_valid),
              "parquet_nested: a struct field differs from the written one")
    check(np.array_equal(tag_col.offsets.cpu().numpy(), offsets)
          and np.array_equal(tag_col.child.data.cpu().numpy(), tags)
          and np.array_equal(tag_col.validity.cpu().numpy(), t_valid)
          and bool(tag_col.child.validity.all()),
          "parquet_nested: tags differ from the written offsets and values")

    def flat(b):
        st = b["s"]
        f = {name: Column(c.data, c.validity & st.validity, c.dtype)
             for name, c in zip(st.field_names, st.children)}
        return ColumnBatch({"k": f["k"], "v": f["v"], "price": b["price"]})

    q6b = flat(batch)
    (res, ng), counts, first_s = driven(PL.q6_step, q6b)
    err = check_q6_nested(PL.result_groups(res, ng, "k"), arrays, s_valid,
                          "parquet_nested")
    check_counts("parquet_nested", counts, ("onehot_groupby",),
                 {"onehot_groupby": 1})
    step_ms = time_ms(lambda: PL.q6_step(q6b), reps=3)
    traced = profiled(lambda: PL.q6_step(flat(read_parquet(path))), reps=1,
                      warmup=0, agree=False)
    e2e_ms = traced["ms"]
    on_card = sum(t.numel() * t.element_size() for t in (
        sk.data, sk.validity, sv.data, sv.validity, s.validity,
        batch["price"].data, batch["price"].validity, tag_col.offsets,
        tag_col.validity, tag_col.child.data, tag_col.child.validity))
    emit({"phase": "parquet_nested", "rows": n, "groups": int(ng),
          "tag_elements": int(offsets[-1]),
          "null_structs": int((~s_valid).sum()),
          "null_lists": int((~t_valid).sum()), "write_s": write_s,
          "file_bytes": os.path.getsize(path), "card_bytes": on_card,
          "launches": counts, "avg_price_max_rel_err": err,
          "read_ms": read_ms, "footer_ms": stats["footer_s"] * 1e3,
          "decode_ms": stats["decode_s"] * 1e3,
          "decode_gb_per_s": stats["file_bytes"] / stats["decode_s"] / 1e9,
          "decompress_ms": stats["decompress_s"] * 1e3,
          "upload_ms": stats["upload_s"] * 1e3,
          "upload_gb_per_s": on_card / stats["upload_s"] / 1e9,
          "pages": stats["pages"], "step_first_s": first_s,
          "step_ms": step_ms, "e2e_ms": e2e_ms,
          "e2e_mrows_per_s": n / (e2e_ms * 1e-3) / 1e6,
          "e2e_cuda_launches": traced["cuda_launches"],
          "e2e_device_ms": traced["device_ms"],
          "busy_share": (None if traced["idle_share"] is None
                         else 1.0 - traced["idle_share"]),
          "idle_share": traced["idle_share"], "card": nvidia_smi_line()})
    return counts


def phase_parquet_codecs():
    """What ``ctypes.util.find_library`` finds for the ZSTD and BROTLI
    codec libraries, and that both load (the fixtures then decode
    through them)."""
    from spark_rapids_jni_tpu_torch.io import pages as PG

    found = PG.codec_libraries()
    loaded = {}
    for codec in (PG.ZSTD, PG.BROTLI):
        loaded[PG.CODEC_LIBRARIES[codec][0]] = PG.codec_library(codec)._name
    emit({"phase": "parquet_codecs", "find_library": found,
          "loaded": loaded})
    return {}


def _delivered(res, cols):
    """The occupied rows of an exchange's result as int64 columns in one
    canonical order (floats by their bits)."""
    from spark_rapids_jni_tpu_torch.relational.keys import lexsort

    occ = res.occupancy
    a = [res.batch[c].data[occ].contiguous() for c in cols]
    a = [x.view(torch.int64) if x.dtype == torch.float64
         else x.to(torch.int64) for x in a]
    order = lexsort(a)
    return [x[order] for x in a]


def phase_parquet_stream(path, root):
    """``MorselSource.from_parquet`` of the q6 file into
    ``exchange_stream`` (K4) over 8 shards at the default morsel and
    round sizes: lossless against ``read_parquet`` plus ``exchange``,
    ``rows_moved`` 2^24, one K4 launch a morsel, the replays' decodes per
    row group.  Then the reference bench's selectivity scenario on a
    Parquet file of 2^22 rows (sorted ``x``, 16 row groups): a predicate
    keeping 1 % prunes row groups in the footer, and the pruned stream
    equals the filtered full stream shard for shard."""
    from spark_rapids_jni_tpu_torch.io import pages as PG
    from spark_rapids_jni_tpu_torch.io import read_parquet
    from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
    from spark_rapids_jni_tpu_torch.shuffle import MorselSource, \
        ShuffleRegistry, ShuffleService

    P = P_SHARDS
    mesh = ShardMesh(P)
    reg = ShuffleRegistry()
    svc = ShuffleService(mesh, registry=reg)
    src = MorselSource.from_parquet(path, mesh)
    PG.reset_stats()
    res, counts, wall_s = driven(
        lambda: svc.exchange_stream(src, key_names=["k"]))
    decodes = PG.STATS["row_group_decodes"]
    decode_s = PG.STATS["decode_s"]
    info = reg.shuffles()[max(reg.shuffles())]
    n = src.rows
    check(n == N_FACT and info.rows_moved == n,
          f"parquet_stream: rows_moved {info.rows_moved} of {n}")
    check(counts["partition_scatter"] == len(src) > 0,
          f"parquet_stream: {counts['partition_scatter']} K4 launches for "
          f"{len(src)} morsels")
    check(decodes == len(src),
          f"parquet_stream: {decodes} row-group decodes for {len(src)} "
          "morsels")
    cols = ("k", "v", "price")
    mat = svc.exchange(read_parquet(path), key_names=["k"])
    same = all(torch.equal(a, b) for a, b in
               zip(_delivered(res, cols), _delivered(mat, cols)))
    check(same, "parquet_stream: the stream's rows differ from "
          "read_parquet + exchange")
    del mat
    line = {"phase": "parquet_stream", "rows": n, "shards": P,
            "morsel_rows": src.morsel_rows, "morsels": len(src),
            "row_groups": src.row_groups_scanned, "rounds": info.rounds,
            "rows_moved": info.rows_moved, "launches": dict(counts),
            "ms": wall_s * 1e3, "mrows_per_s": n / wall_s / 1e6,
            "row_group_decodes": decodes,
            "decodes_per_row_group": decodes / src.row_groups_scanned,
            "decode_ms": decode_s * 1e3,
            "decode_share": decode_s / wall_s}
    del res
    # the footer-pruned selectivity stream
    vals, keys = selectivity_arrays(PQ_PRUNE_ROWS)
    prune_path = os.path.join(root, "selectivity.parquet")
    parquet_writer().write_parquet(
        prune_path, {"k": (keys, None), "x": (vals, None)},
        row_group_rows=PQ_PRUNE_ROWS // 16, page_rows=PQ_PAGE_ROWS,
        codec="snappy", dictionary={"k": None})
    thresh = int(np.quantile(vals, PQ_PRUNE_SELECTIVITY))
    full_src = MorselSource.from_parquet(prune_path, mesh)
    full, fcounts, full_s = driven(
        lambda: svc.exchange_stream(full_src, key_names=["k"]))
    pruned_src = MorselSource.from_parquet(prune_path, mesh,
                                           predicate=("x", "<", thresh))
    pruned, pcounts, pruned_s = driven(
        lambda: svc.exchange_stream(pruned_src, key_names=["k"]))
    check(pruned_src.row_groups_pruned > 0,
          "parquet_stream: the 1 % predicate pruned no row group")
    check(pcounts["partition_scatter"] == len(pruned_src),
          "parquet_stream: pruned stream K4 launches != morsels")
    for d, ((ka, xa), (kb, xb)) in enumerate(zip(
            _survivors(pruned, thresh, P), _survivors(full, thresh, P))):
        check(np.array_equal(ka, kb) and np.array_equal(xa, xb),
              f"parquet_stream: shard {d}'s surviving rows differ from "
              "the filtered full stream")
    for k in counts:
        counts[k] += fcounts[k] + pcounts[k]
    line["pruning"] = {
        "rows": PQ_PRUNE_ROWS, "selectivity": PQ_PRUNE_SELECTIVITY,
        "threshold": thresh, "row_groups_pruned":
        pruned_src.row_groups_pruned, "row_groups_scanned":
        pruned_src.row_groups_scanned, "morsels_full": len(full_src),
        "morsels_pruned": len(pruned_src), "full_ms": full_s * 1e3,
        "pruned_ms": pruned_s * 1e3}
    line["launches_total"] = counts
    line["card"] = nvidia_smi_line()
    emit(line)
    return counts


# ---------------------------------------------------------------------------
# the serving runtime (serve/): tenants, kill safety, the drain lane and
# the transports
# ---------------------------------------------------------------------------

SERVE_STREAMS = 4           # bench.py --serve: tenant streams,
SERVE_QUERIES = 3           # ... queries a stream
SERVE_STEPS = 2             # ... and steps a query
# stream i's query: streams 0-1 q6's one-hot step (K1), stream 2 q95
# through the hash join (K2, K3), stream 3 q9 through plan.execute
SERVE_KINDS = ("q6", "q6", "q95_hashjoin", "q9")
SERVE_WAIT_S = 300.0        # a session's result wait
SERVE_SEGMENT = 1 << 20     # the data plane's chunk (serve_segment_bytes)
SERVE_PINGS = 2000          # small-frame round trips a transport
SERVE_JOURNAL = 10_000      # journal appends (each fsync'd)


def _pct(vals, q):
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(round(q * (len(vals) - 1))))]


def q95_oracle_groups(arrs):
    from spark_rapids_jni_tpu_torch import pipelines as PL

    orders, net = PL.q95_oracle(arrs)
    return {s: {"orders": int(orders[s]), "net": int(net[s])}
            for s in range(PL.Q95_SEG)}


def q9_oracle_groups(arrs):
    from spark_rapids_jni_tpu_torch import pipelines as PL

    net, orders = PL.q9_oracle(arrs)
    return {s: {"net_hi": int(net[s]), "orders_hi": int(orders[s]),
                "avg_hi": float(net[s] / orders[s])}
            for s in range(PL.Q95_SEG)}


SERVE_FLOATS = {"q6": ("avg_price",), "q95_hashjoin": (), "q9": ("avg_hi",)}


def serve_inputs(n, device=None):
    """Each (stream, step)'s host arrays once (seed 1000 * stream +
    step; a stream's queries reuse its steps' inputs) with their oracle
    groups, and each q95/q9 stream's dimensions (its step 0's), which
    stay resident on the card: q9's cached plan keeps its broadcast
    table only while its build side is the same batch."""
    from spark_rapids_jni_tpu_torch import pipelines as PL

    host, oracle, dims = {}, {}, {}
    for i, kind in enumerate(SERVE_KINDS):
        for s in range(SERVE_STEPS):
            seed = 1000 * i + s
            if kind == "q6":
                arrs = PL.example_arrays(n, seed)
                oracle[(i, s)] = q6_oracle_groups(arrs)
            else:
                full = PL.q95_arrays(n, seed)
                if s == 0:
                    dims[i] = full
                arrs = {"fact": full["fact"], "dim1": dims[i]["dim1"],
                        "dim2": dims[i]["dim2"]}
                oracle[(i, s)] = (q95_oracle_groups(arrs)
                                  if kind == "q95_hashjoin"
                                  else q9_oracle_groups(arrs))
                arrs = arrs["fact"]
            host[(i, s)] = arrs
    return host, oracle, dims


def serve_upload(kind, arrs, device=None):
    """One step's input batch on the card (a fresh pageable upload)."""
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.columnar.column import batch_from_numpy

    if kind == "q6":
        k, v, price = arrs
        ones = np.ones(k.shape[0], np.bool_)
        return batch_from_numpy({"k": (k, ones, "int32"),
                                 "v": (v, ones, "int64"),
                                 "price": (price, ones, "float64")}, device)
    return batch_from_numpy(
        {c: (a, np.ones(a.shape, np.bool_), PL._Q95_TYPES[c])
         for c, a in arrs.items()}, device)


def serve_dim_batches(dims, device=None):
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.columnar.column import batch_from_numpy

    return {i: {part: batch_from_numpy(
        {c: (a, np.ones(a.shape, np.bool_), PL._Q95_TYPES[c])
         for c, a in full[part].items()}, device)
        for part in ("dim1", "dim2")} for i, full in dims.items()}


SERVE_PLANS = []  # q9's compiled plans: their broadcast tables close last


def close_serve_plans():
    from spark_rapids_jni_tpu_torch import plan as PLAN

    while SERVE_PLANS:
        SERVE_PLANS.pop().close()
    PLAN.reset_plan_cache()


def serve_step(kind, b, dimb, sess):
    """One step of ``kind`` over the input batch ``b``; returns its
    groups as host dicts and, for q9, whether the plan cache hit."""
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch import plan as PLAN
    from spark_rapids_jni_tpu_torch.plan import queries as Q

    if kind == "q6":
        return PL.result_groups(*PL.q6_step(b), "k"), None
    if kind == "q95_hashjoin":
        return PL.result_groups(*PL.q95_hashjoin_step(
            b, dimb["dim1"], dimb["dim2"]), "seg"), None
    inputs = {"fact": b, "dim1": dimb["dim1"], "dim2": dimb["dim2"]}
    # compiled outside the tenant's TaskContext: its broadcast table
    # outlives the session, so the stream's next query hits the cache
    cp = PLAN.compile_plan(Q.q9_plan(), inputs)
    if cp.last_lookup != "hit":
        SERVE_PLANS.append(cp)
    sess.pin_plan(cp.key)
    return PL.result_groups(*cp(inputs), "seg"), cp.last_lookup


def serve_query(stream, k, host, dimb, device=None):
    """``query_fn(ctx, sess)`` of stream ``stream``'s query ``k``: each
    step's input uploaded into a ``SpillableHandle`` charged to the
    tenant's ``TaskContext``, read back pinned, run; returns the steps'
    groups, the q9 lookups, the query's own seconds and the seconds its
    uploads held the host (a pageable copy returns once its bytes are
    staged)."""
    from spark_rapids_jni_tpu_torch.mem import SpillableHandle

    kind = SERVE_KINDS[stream]

    def q(ctx, sess):
        t0 = time.perf_counter()
        groups, lookups, upload_s = [], [], 0.0
        for s in range(SERVE_STEPS):
            t1 = time.perf_counter()
            b = serve_upload(kind, host[(stream, s)], device)
            upload_s += time.perf_counter() - t1
            h = SpillableHandle(b, ctx=ctx, name=f"serve-{stream}-{k}-{s}")
            del b
            try:
                with h.pinned():
                    g, lookup = serve_step(kind, h.get(),
                                           dimb.get(stream), sess)
            finally:
                h.close()
            groups.append(g)
            lookups.append(lookup)
        return groups, lookups, time.perf_counter() - t0, upload_s
    return q


def serve_wave(max_concurrent, base, host, dimb, est, device=None):
    """One wave: every stream, on a thread of its own, submits its
    queries one after another (a tenant waits for its answer), so at
    most one query a stream is in flight.  Returns each query's result,
    its submit-to-answer seconds, the wave's wall seconds and whether
    ``shutdown()`` came back clean."""
    import threading

    from spark_rapids_jni_tpu_torch.serve import ServeRuntime

    rt = ServeRuntime(max_concurrent=max_concurrent, task_id_base=base)
    outs, e2e, sessions, errors = {}, {}, {}, {}

    def drive(i):
        try:
            for k in range(SERVE_QUERIES):
                t0 = time.perf_counter()
                sess = rt.submit(serve_query(i, k, host, dimb, device),
                                 est_bytes=est, tenant=f"stream-{i}")
                sessions[(i, k)] = sess
                outs[(i, k)] = sess.result(timeout=SERVE_WAIT_S)
                e2e[(i, k)] = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 - reported by the phase
            errors[i] = repr(e)

    threads = [threading.Thread(target=drive, args=(i,), daemon=True)
               for i in range(SERVE_STREAMS)]
    t0 = time.perf_counter()
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(SERVE_WAIT_S)
    finally:
        clean = rt.shutdown()
    wall = time.perf_counter() - t0
    check(not errors, f"serve wave x{max_concurrent}: {errors}")
    statuses = sorted({s.status for s in sessions.values()})
    check(statuses == ["done"], f"serve wave x{max_concurrent}: "
          f"statuses {statuses}")
    return outs, e2e, sessions, wall, clean


def serve_expected_counts(host, dimb, device=None):
    """Each step kind's launches, measured once: q6's step, q95's hash
    join step, q9's first (compiling) step and a cache-hit step."""
    class _Sess:
        def pin_plan(self, key):
            pass

    per = {}
    for i, kind in enumerate(SERVE_KINDS):
        if kind in per:
            continue
        b = serve_upload(kind, host[(i, 0)], device)
        close_serve_plans()
        _, per[kind], _ = driven(serve_step, kind, b, dimb.get(i), _Sess())
        if kind == "q9":
            _, per["q9_hit"], _ = driven(serve_step, kind, b, dimb.get(i),
                                         _Sess())
        del b
    close_serve_plans()
    want = no_kernels()
    for i, kind in enumerate(SERVE_KINDS):
        n_steps = SERVE_QUERIES * SERVE_STEPS
        if kind == "q9":
            parts = [(per["q9"], 1), (per["q9_hit"], n_steps - 1)]
        else:
            parts = [(per[kind], n_steps)]
        for counts, times in parts:
            for key, v in counts.items():
                want[key] += v * times
    return want, per


def phase_serve_tenants(n=None, device=None):
    """The reference's ``bench.py --serve`` (``bench.py:583-700``) at the
    main path's width: 4 tenant streams of 3 queries of 2 steps, each
    step's 2^24-row input a ``SpillableHandle`` charged to the tenant's
    ``TaskContext`` (``est_bytes`` one batch); streams 0-1 q6's one-hot
    step, stream 2 q95 through the hash join, stream 3 ``plan.execute``
    of q9 with the plan pinned on the shared cache.  The arena holds
    one batch a stream plus one, the spill framework is installed.  A
    solo wave (``max_concurrent=1``), then a concurrent one (4), each
    from an empty plan cache: every result against its numpy oracle and
    solo equal to concurrent (ints exact, floats rel 1e-5), every q9
    query after a stream's first a cache hit, ``shutdown()`` clean, the
    arenas at 0 and no spill file left, and each wave's K1, K2, K3
    record and K3 probe launches exactly those of its steps."""
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch.mem import (
        RmmSpark, batch_nbytes, install_spill_framework,
        shutdown_spill_framework)
    from spark_rapids_jni_tpu_torch.ops import kernels as KER

    n = n or N_FACT
    t0 = time.perf_counter()
    host, oracle, dims = serve_inputs(n)
    inputs_s = time.perf_counter() - t0
    dimb = serve_dim_batches(dims, device)
    est = batch_nbytes(serve_upload("q6", host[(0, 0)], device))
    want, per_step = serve_expected_counts(host, dimb, device)
    pool = est * (SERVE_STREAMS + 1)
    fw = install_spill_framework()
    spill_dir = fw.spill_dir
    adaptor = RmmSpark.set_event_handler(pool, host_pool_bytes=est,
                                         poll_ms=10.0)
    # solo queues the whole wave behind one slot
    config.set("serve_admit_timeout_s", SERVE_WAIT_S)
    waves, total = {}, no_kernels()
    try:
        for label, conc, base in (("solo", 1, 30_000),
                                  ("concurrent", SERVE_STREAMS, 40_000)):
            close_serve_plans()
            torch.cuda.synchronize()
            KER.reset_launches()
            outs, e2e, sessions, wall, clean = serve_wave(
                conc, base, host, dimb, est, device)
            torch.cuda.synchronize()
            counts = dict(KER.launches)
            drained = (adaptor.total_allocated(),
                       adaptor.host_total_allocated())
            close_serve_plans()
            for key, v in counts.items():
                total[key] += v
            check(clean, f"serve_tenants {label}: shutdown() not clean")
            check(drained == (0, 0),
                  f"serve_tenants {label}: arenas left at {drained}")
            for key in ("onehot_groupby", "slot_table_build",
                        "slot_table_records", "slot_table_probe"):
                check(counts[key] == want[key],
                      f"serve_tenants {label}: {counts[key]} {key} "
                      f"launches, expected {want[key]}")
            worst = 0.0
            for (i, k), (groups, lookups, _, _) in outs.items():
                kind = SERVE_KINDS[i]
                for s, g in enumerate(groups):
                    worst = max(worst, groups_agree(
                        g, oracle[(i, s)], SERVE_FLOATS[kind],
                        f"serve_tenants {label} stream {i} query {k} "
                        f"step {s}"))
                if kind == "q9":
                    hits = lookups if k else lookups[1:]
                    check(all(x == "hit" for x in hits),
                          f"serve_tenants {label}: q9 query {k} lookups "
                          f"{lookups}")
            lat = [o[2] for o in outs.values()]
            rows = n * len(outs) * SERVE_STEPS
            waves[label] = {
                "max_concurrent": conc, "queries": len(outs),
                "p50_ms": _pct(lat, 0.5) * 1e3,
                "p99_ms": _pct(lat, 0.99) * 1e3,
                "e2e_p50_ms": _pct(list(e2e.values()), 0.5) * 1e3,
                "e2e_p99_ms": _pct(list(e2e.values()), 0.99) * 1e3,
                "wall_ms": wall * 1e3, "mrows_per_s": rows / wall / 1e6,
                "upload_share": sum(o[3] for o in outs.values())
                / sum(lat),
                "granted_bytes": sorted({s.granted_bytes
                                         for s in sessions.values()}),
                "attempts": sorted({s.attempts for s in sessions.values()}),
                "float_max_rel_err": worst, "launches": counts,
                "results": outs}
        left_files = os.listdir(spill_dir)
        left_handles = len(fw.store)
        spills = fw.metrics.snapshot()
    finally:
        config.reset("serve_admit_timeout_s")
        close_serve_plans()
        RmmSpark.clear_event_handler()
        shutdown_spill_framework()
    check(left_files == [], f"serve_tenants: spill files left {left_files}")
    check(left_handles == 0, f"serve_tenants: {left_handles} handles left")
    if len(waves) == 2:
        solo, conc = waves["solo"]["results"], waves["concurrent"]["results"]
        for key in solo:
            kind = SERVE_KINDS[key[0]]
            for s, (a, b) in enumerate(zip(solo[key][0], conc[key][0])):
                groups_agree(b, a, SERVE_FLOATS[kind],
                             f"serve_tenants concurrent vs solo {key} "
                             f"step {s}")
    for w in waves.values():
        del w["results"]
    emit({"phase": "serve_tenants", "rows_per_step": n,
          "streams": list(SERVE_KINDS), "queries_per_stream": SERVE_QUERIES,
          "steps_per_query": SERVE_STEPS, "batch_bytes": est,
          "pool_bytes": pool, "inputs_s": inputs_s,
          "launches_per_step": per_step, "expected_per_wave": want,
          **waves, "transitions": spill_transitions(spills),
          "card": nvidia_smi_line()})
    return total


def _parked(sess):
    """Is ``sess``'s thread parked in the arena (blocked or BUFN)?"""
    from spark_rapids_jni_tpu_torch.mem import RmmSpark, ThreadState

    th = sess._thread
    if th is None or th.ident is None:
        return False
    try:
        st = RmmSpark.get_state_of(th.ident)
    except Exception:  # noqa: BLE001 - not registered yet
        return False
    return st in (ThreadState.BLOCKED, ThreadState.BUFN,
                  ThreadState.BUFN_WAIT, ThreadState.BUFN_THROW)


def _poll(pred, timeout=30.0, interval=0.005):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def phase_serve_cancel(q6_arrays, n=None, device=None):
    """Kill safety on the card with 2^24-row q6 batches: (1) tenant B
    parked in the arena behind tenant A (an arena of 1.5 batches; A
    holds its pinned input until released) is cancelled: B ends
    ``cancelled``, A's result equals the oracle; (2) a query whose first
    attempt outlives its ``timeout_s`` is re-admitted once and answers
    right (``attempts == 2``); (3) a ``task_cancel`` rule at
    ``serve_step`` ends its session ``cancelled``.  After each case both
    arenas are at 0 and no spill file is left."""
    import threading

    from spark_rapids_jni_tpu_torch import faultinj
    from spark_rapids_jni_tpu_torch.mem import (
        RmmSpark, SpillableHandle, batch_nbytes, install_spill_framework,
        shutdown_spill_framework)
    from spark_rapids_jni_tpu_torch.ops import kernels as KER
    from spark_rapids_jni_tpu_torch.serve import (QueryCancelled,
                                                  ServeRuntime)

    n = n or q6_arrays[0].shape[0]
    want = q6_oracle_groups(q6_arrays)
    est = batch_nbytes(serve_upload("q6", q6_arrays, device))
    cases, total = {}, no_kernels()

    def q6_query(gate=None, hold_s=None):
        from spark_rapids_jni_tpu_torch import pipelines as PL

        def q(ctx, sess):
            h = SpillableHandle(serve_upload("q6", q6_arrays, device),
                                ctx=ctx, name=f"cancel-{sess.session_id}")
            try:
                with h.pinned():
                    b = h.get()
                    if gate is not None:
                        gate.wait(SERVE_WAIT_S)
                    if hold_s is not None and sess.attempts == 1:
                        end = time.monotonic() + hold_s
                        while time.monotonic() < end:
                            sess._check_cancelled()
                            time.sleep(0.01)
                    return PL.result_groups(*PL.q6_step(b), "k")
            finally:
                h.close()
        return q

    def run_case(label, pool, body):
        fw = install_spill_framework()
        spill_dir = fw.spill_dir
        adaptor = RmmSpark.set_event_handler(pool, host_pool_bytes=est,
                                             poll_ms=10.0)
        rt = ServeRuntime()
        try:
            torch.cuda.synchronize()
            KER.reset_launches()
            t0 = time.perf_counter()
            info = body(rt, adaptor)
            clean = rt.shutdown()
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = dict(KER.launches)
            drained = (adaptor.total_allocated(),
                       adaptor.host_total_allocated())
            left = os.listdir(spill_dir)
        finally:
            rt.shutdown()
            RmmSpark.clear_event_handler()
            shutdown_spill_framework()
        check(clean, f"serve_cancel {label}: shutdown() not clean")
        check(drained == (0, 0),
              f"serve_cancel {label}: arenas left at {drained}")
        check(left == [], f"serve_cancel {label}: spill files left {left}")
        for key, v in counts.items():
            total[key] += v
        cases[label] = {"wall_ms": wall * 1e3, "pool_bytes": pool,
                        "launches": counts, **info}

    def parked(rt, adaptor):
        gate = threading.Event()
        a = rt.submit(q6_query(gate=gate), est_bytes=est, tenant="A")
        # A's input charged and pinned before B arrives
        ok_a = _poll(lambda: a.status == "running"
                     and adaptor.total_allocated() >= est)
        b = rt.submit(q6_query(), est_bytes=est, tenant="B")
        ok_b = _poll(lambda: _parked(b))
        time.sleep(0.2)
        t0 = time.perf_counter()
        rt.cancel(b)
        try:
            b.result(timeout=30)
            raised = None
        except QueryCancelled as e:
            raised = type(e).__name__
        unwind_ms = (time.perf_counter() - t0) * 1e3
        gate.set()
        got = a.result(timeout=SERVE_WAIT_S)
        groups_agree(got, want, ("avg_price",), "serve_cancel parked: A")
        check(ok_a and ok_b, f"serve_cancel parked: A running {ok_a}, "
              f"B parked {ok_b}")
        check(raised == "QueryCancelled" and b.status == "cancelled",
              f"serve_cancel parked: B ended {b.status} ({raised})")
        check(a.status == "done", f"serve_cancel parked: A {a.status}")
        return {"unwind_ms": unwind_ms, "b_status": b.status,
                "b_granted_bytes": b.granted_bytes}

    def timeout(rt, adaptor):
        s = rt.submit(q6_query(hold_s=60.0), est_bytes=est,
                      tenant="slow", timeout_s=2.0)
        got = s.result(timeout=SERVE_WAIT_S)
        groups_agree(got, want, ("avg_price",), "serve_cancel timeout")
        check(s.status == "done" and s.attempts == 2,
              f"serve_cancel timeout: {s.status} after {s.attempts} "
              "attempts")
        return {"attempts": s.attempts, "timeout_s": 2.0}

    def injected(rt, adaptor):
        with faultinj.scope({"faults": [{"match": "serve_step", "count": 1,
                                         "fault": "task_cancel"}]}):
            s = rt.submit(q6_query(), est_bytes=est, tenant="killed")
            try:
                s.result(timeout=SERVE_WAIT_S)
                raised = None
            except faultinj.TaskCancelled as e:
                raised = type(e).__name__
            fired = faultinj.fire_counts().get("serve_step", 0)
        check(raised == "TaskCancelled" and s.status == "cancelled",
              f"serve_cancel injected: {s.status} ({raised})")
        check(fired == 1, f"serve_cancel injected: {fired} firings")
        return {"status": s.status, "fired": fired}

    run_case("parked", int(1.5 * est), parked)
    run_case("timeout", 4 * est, timeout)
    run_case("injected", 4 * est, injected)
    want_k1 = {"parked": 1, "timeout": 1, "injected": 0}
    for label, c in cases.items():
        check(c["launches"]["onehot_groupby"] == want_k1[label],
              f"serve_cancel {label}: {c['launches']['onehot_groupby']} "
              f"K1 launches, expected {want_k1[label]}")
    emit({"phase": "serve_cancel", "rows": n, "batch_bytes": est, **cases,
          "card": nvidia_smi_line()})
    return total


def phase_serve_drain(fact, n_round=1 << 17):
    """The drain lane on the card: ``exchange()`` of the q95 fact (2^24
    rows keyed on ``k`` over ``ShardMesh(8)``, ``round_rows`` 2^17, so
    two rounds or more) inside a tenant: ``rounds_overlapped >= 1`` and
    the delivered arrays bit-identical to the same exchange with no
    lane; then two tenants' exchanges at once, both identical to it.
    The wall of each; every thread uses the default stream, so the
    lane's overlap is on the host."""
    import threading

    from spark_rapids_jni_tpu_torch.mem import RmmSpark
    from spark_rapids_jni_tpu_torch.parallel.mesh import ShardMesh
    from spark_rapids_jni_tpu_torch.serve import ServeRuntime
    from spark_rapids_jni_tpu_torch.shuffle import (ShuffleRegistry,
                                                    ShuffleService)

    mesh = ShardMesh(P_SHARDS, device=fact["k"].device)

    def run(ctx=None):
        res = ShuffleService(mesh, registry=ShuffleRegistry()).exchange(
            fact, key_names=["k"], round_rows=n_round, ctx=ctx)
        torch.cuda.synchronize()
        return res

    run()  # warm
    (plain, plain_counts, plain_s) = driven(run)
    t0 = time.perf_counter()
    run()
    plain_again_s = time.perf_counter() - t0
    check(plain.rounds >= 2, f"serve_drain: {plain.rounds} round(s)")
    check(plain.rounds_overlapped == 0,
          "serve_drain: rounds overlapped with no lane installed")
    oracle = fact_oracle(fact)
    same_multiset(plain, oracle, "serve_drain no lane")
    adaptor = RmmSpark.set_event_handler(64 << 30, poll_ms=10.0)
    out = {}
    try:
        rt = ServeRuntime()
        try:
            def q(ctx):
                t0 = time.perf_counter()
                res = run(ctx)
                return res, time.perf_counter() - t0

            torch.cuda.synchronize()
            from spark_rapids_jni_tpu_torch.ops import kernels as KER

            KER.reset_launches()
            one = rt.submit(q, tenant="drain-1")
            res1, s1 = one.result(timeout=SERVE_WAIT_S)
            one_counts = dict(KER.launches)
            same_result(res1, plain, "serve_drain lane vs no lane")
            check(res1.rounds_overlapped >= 1,
                  f"serve_drain: {res1.rounds_overlapped} rounds overlapped")
            out["one_tenant"] = {"ms": s1 * 1e3,
                                 "rounds_overlapped": res1.rounds_overlapped,
                                 "launches": one_counts}
            del res1
            # two tenants at once: both rounds through the one lane
            start = threading.Barrier(2)

            def q2(ctx):
                start.wait(60)
                return q(ctx)

            t0 = time.perf_counter()
            pair = [rt.submit(q2, tenant=f"drain-{j}") for j in (2, 3)]
            got = [s.result(timeout=SERVE_WAIT_S) for s in pair]
            pair_s = time.perf_counter() - t0
            for j, (res, s) in enumerate(got):
                same_result(res, plain, f"serve_drain tenant {j} of two")
            out["two_tenants"] = {
                "wall_ms": pair_s * 1e3,
                "each_ms": [s * 1e3 for _, s in got],
                "rounds_overlapped": [r.rounds_overlapped for r, _ in got]}
            del got, pair
        finally:
            check(rt.shutdown(), "serve_drain: shutdown() not clean")
        drained = adaptor.total_allocated()
    finally:
        RmmSpark.clear_event_handler()
    check(drained == 0, f"serve_drain: {drained} bytes left in the arena")
    emit({"phase": "serve_drain", "rows": fact.num_rows, "shards": P_SHARDS,
          "round_rows": n_round, "rounds": plain.rounds,
          "capacity": plain.capacity, "no_lane_ms": plain_s * 1e3,
          "no_lane_again_ms": plain_again_s * 1e3,
          "no_lane_launches": plain_counts, **out,
          "card": nvidia_smi_line()})
    total = no_kernels()
    for c in (plain_counts, out.get("one_tenant", {}).get("launches", {})):
        for k, v in c.items():
            total[k] += v
    return total


def _transport_pair(kind):
    """A connected (writer, reader) transport pair: a Unix socket pair,
    or a TCP loopback connection."""
    import socket

    from spark_rapids_jni_tpu_torch.serve import wire

    if kind == "unix":
        a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
        return wire.wrap(a, "unix", role="wk"), wire.wrap(b, "unix",
                                                          role="sup")
    lst, addr = wire.listen("tcp", "127.0.0.1:0")
    try:
        wk = wire.connect("tcp", addr, role="wk")
        conn, _ = lst.accept()
    finally:
        lst.close()
    return wk, wire.wrap(conn, "tcp", role="sup")


def _payload_over(plane, payload):
    """``payload`` from a writer thread to this thread over ``plane``
    (``shm``: a sealed memfd by SCM_RIGHTS over a Unix socket pair;
    ``frames``: data frames over TCP loopback), verified against the
    descriptor's chunk CRCs; returns the bytes read, the seconds from
    the first stamp to the verified copy, and the ms of each piece (the
    writer's CRC stamping and its memfd write or frame sends, the
    reader's copy out or frame receipt, and its CRC verify)."""
    import threading

    from spark_rapids_jni_tpu_torch.serve import data_plane as DP

    writer, reader = _transport_pair("unix" if plane == "shm" else "tcp")
    errors, pieces = [], {}

    def ms_since(t0):
        return (time.perf_counter() - t0) * 1e3

    def write():
        try:
            t0 = time.perf_counter()
            crcs = DP.chunk_crcs(payload, SERVE_SEGMENT)
            pieces["stamp_ms"] = ms_since(t0)
            desc = DP.build_descriptor(plane, DP.segment_name(0, 1, 0),
                                       len(payload), "q6-columns",
                                       SERVE_SEGMENT, crcs, 1)
            t0 = time.perf_counter()
            if plane == "shm":
                fd = DP.make_segment(desc["seg"], payload)
                DP.seal_segment(fd)
                try:
                    writer.send_with_fds({"op": "result", "desc": desc},
                                         [fd])
                finally:
                    os.close(fd)
            else:
                writer.send({"op": "result", "desc": desc})
                view = memoryview(payload)
                for seq, off in enumerate(range(0, len(view),
                                                SERVE_SEGMENT)):
                    writer.send_data(1, seq, view[off:off + SERVE_SEGMENT])
            pieces["write_ms"] = ms_since(t0)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    reader.settimeout(60.0)
    t_start = time.perf_counter()
    th = threading.Thread(target=write, daemon=True)
    th.start()
    try:
        msg = reader.recv()
        desc = msg["desc"]
        DP.verify_epoch(desc, 1)
        t0 = time.perf_counter()
        if plane == "shm":
            (fd,) = reader.take_fds(1)
            try:
                got = DP.read_segment(fd, desc)  # copy out, then verify
            finally:
                os.close(fd)
            pieces["read_and_verify_ms"] = ms_since(t0)
        else:
            parts = []
            while sum(len(p) for p in parts) < desc["size"]:
                parts.append(reader.recv().payload)
            got = b"".join(parts)
            pieces["read_ms"] = ms_since(t0)
            t0 = time.perf_counter()
            DP.verify_chunks(got, desc)
            pieces["verify_ms"] = ms_since(t0)
        dt = time.perf_counter() - t_start
    finally:
        th.join(60)
        writer.close()
        reader.close()
    check(not errors, f"serve_transports {plane}: {errors}")
    return got, dt, pieces


def phase_serve_transports(q6b):
    """The fleet's transports on the host, a baseline for the fleet:
    q6's 2^24-row column bytes (``.cpu()``) across the shm plane and the
    frames plane, CRC-verified and byte-equal; the wire's small-frame
    round trip over unix and tcp; 10^4 journal appends (each fsync'd)
    and their replay."""
    import shutil
    import tempfile

    from spark_rapids_jni_tpu_torch.serve import journal as J

    payload = b"".join(q6b[c].data.cpu().numpy().tobytes()
                       for c in ("k", "v", "price"))
    out = {"payload_bytes": len(payload)}
    for plane in ("shm", "frames"):
        got, dt, pieces = _payload_over(plane, payload)
        check(got == payload, f"serve_transports {plane}: bytes differ")
        out[plane] = {"ms": dt * 1e3, "gb_per_s": len(payload) / dt / 1e9,
                      **pieces}
        del got
    for kind in ("unix", "tcp"):
        a, b = _transport_pair(kind)
        try:
            a.settimeout(10.0)
            b.settimeout(10.0)
            ping = {"op": "ping", "t": 0.5}
            t0 = time.perf_counter()
            ok = True
            for i in range(SERVE_PINGS):
                b.send(ping)
                ok = ok and a.recv() == ping
                a.send({"op": "pong", "t": i})
                ok = ok and b.recv() == {"op": "pong", "t": i}
            dt = time.perf_counter() - t0
        finally:
            a.close()
            b.close()
        check(ok, f"serve_transports {kind}: a round trip differed")
        out[f"wire_{kind}"] = {"round_trips": SERVE_PINGS,
                               "us_per_round_trip": dt / SERVE_PINGS * 1e6}
    root = tempfile.mkdtemp(prefix="srj_journal_")
    try:
        path = J.journal_path(root)
        j = J.SessionJournal(path)
        t0 = time.perf_counter()
        try:
            for sid in range(SERVE_JOURNAL):
                j.append("submit", sid=sid, kind="q6",
                         params={"rows": 1 << 24}, tenant=f"t{sid % 4}",
                         est_bytes=1 << 28)
        finally:
            j.close()
        append_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state = J.replay(path)
        replay_s = time.perf_counter() - t0
        size = os.path.getsize(path)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(state.records == SERVE_JOURNAL and len(state.sessions)
          == SERVE_JOURNAL and not state.truncated_tail,
          f"serve_transports journal: {state.records} records replayed")
    out["journal"] = {"records": SERVE_JOURNAL, "bytes": size,
                      "append_ms": append_s * 1e3,
                      "appends_per_s": SERVE_JOURNAL / append_s,
                      "replay_ms": replay_s * 1e3,
                      "replayed_per_s": SERVE_JOURNAL / replay_s}
    emit({"phase": "serve_transports", **out, "card": nvidia_smi_line()})


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

    # the tiered spill store: q6 through device -> host -> disk, injected
    # faults, q9's dropped broadcast tables, out-of-core exchanges
    breadth("spill_q6", phase_spill_q6, q6_arrays)
    breadth("spill_faults", phase_spill_faults, q6_arrays)
    breadth("spill_q9", phase_spill_q9, q95_in, q95_arrays)
    breadth("spill_exchange", phase_spill_exchange, fact)
    # the persistent shuffle store and the exchange's lineage
    breadth("shuffle_store", phase_shuffle_store, fact)
    # the rest of the expression library and the JCUDF transpose
    breadth("expr_strings", phase_expr_strings)
    breadth("expr_rows", phase_expr_rows, q6b, q6_arrays)
    breadth("expr_filter", phase_expr_filter, fact, dim1, q95_arrays)
    # Parquet I/O (BASELINE config #1): files in a temporary directory
    # under TMPDIR, removed at the end
    import shutil
    import tempfile

    pq_root = tempfile.mkdtemp(prefix="srj_parquet_")
    try:
        q6_pq = guarded("parquet_write", write_q6_parquet, q6_arrays,
                        pq_root)
        breadth("parquet_footer", phase_parquet_footer, q6_pq)
        breadth("parquet_codecs", phase_parquet_codecs)
        breadth("parquet_fixture", phase_parquet_fixture)
        breadth("parquet_q6", phase_parquet_q6, q6_pq, q6_arrays)
        breadth("parquet_stream", phase_parquet_stream, q6_pq, pq_root)
        # the rest of Parquet: a v2/ZSTD/DELTA q6 file, a nested q6 file
        breadth("parquet_q6_v2", phase_parquet_q6_v2, q6_arrays, pq_root)
        breadth("parquet_nested", phase_parquet_nested, q6_arrays, pq_root)
    finally:
        shutil.rmtree(pq_root, ignore_errors=True)
    # the serving runtime (serve/): four tenants' q6, q95 and q9, kill
    # safety, the shared drain lane, and the fleet's transports
    breadth("serve_tenants", phase_serve_tenants)
    breadth("serve_cancel", phase_serve_cancel, q6_arrays)
    breadth("serve_drain", phase_serve_drain, fact)
    guarded("serve_transports", phase_serve_transports, q6b)

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

"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and its ``nvidia-smi`` name/power-limit line;
2. build: compile every CUDA kernel of the port from ``csrc/`` (nvcc,
   ``sm_90a``, one process per source, all started together);
3. kernels: each kernel at the shapes the main path gives it, held
   against its plain PyTorch version on the same inputs (ints, owners,
   slot records and slots bit-identical; float sums rel 1e-5 of the sum
   of |x|, the reference's f32x3 tolerance), timed beside the plain
   version, a library call where one computes the same function, and the
   least time the card could take; the one-hot group-by's fused entry
   at q6 and q95's seg and its contract entry at q6; the slot-table
   probe's record build and probe at both of the q95 hash join's shapes;
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
8. the streaming exchange: the q95 plan's first stage,
   ``Exchange(Scan("fact"), "k")`` over a ``MorselSource`` of 8 shards
   with ``shuffle_stream`` on, checked lossless, routed, order-keeping,
   with one partition-scatter launch per morsel and no sort or gather in
   its per-morsel path, and the map step's time split.

It then prints one ``kernels`` line and, last, ``{"ok": true, "device":
...}``.  Any mismatch or exception exits nonzero without that line, as
does a machine without CUDA or a directory without the port.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

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
    passes them: the key, the row mask, every referenced column, the int
    and float sum columns."""
    from spark_rapids_jni_tpu_torch.columnar import types as T

    names, ints, floats = [], [], []
    for a in aggs:
        if a.column is None:
            continue
        if a.column not in names:
            names.append(a.column)
        if a.op in ("sum", "mean"):
            fl = batch[a.column].dtype.kind in T.FLOAT_KINDS
            tgt = floats if fl else ints
            if names.index(a.column) not in tgt:
                tgt.append(names.index(a.column))
    cols = [(batch[c].data, batch[c].validity) for c in names]
    return (batch[key].data, batch[key].validity, row_valid, cols, ints,
            floats)


def k1_case(name, batch, key, aggs, K, row_valid):
    """The fused one-hot group-by on the raw columns the main path gives
    it, against its plain path (the reference's payload, per-bucket sums
    and limb rebuild): ints and counts exact, floats rel 1e-5 of the sum
    of |x|, the overflow flag equal."""
    from spark_rapids_jni_tpu_torch.ops import kernels as KER

    args = onehot_inputs(batch, key, aggs, row_valid)
    kd, kv, live, cols, ints, floats = args
    n = kd.shape[0]
    KER.reset_launches()
    oi, of, ovf = KER.onehot_groupby_columns(*args, K)
    check(KER.launches["onehot_groupby"] == 1
          and KER.launches["onehot_groupby_parts"] == 0,
          f"onehot_groupby[{name}]: {KER.launches['onehot_groupby']} fused "
          f"and {KER.launches['onehot_groupby_parts']} payload launches for "
          "one group-by")
    ri, rf, rovf = KER.onehot_groupby_columns_plain(*args, K)
    torch.cuda.synchronize()
    check(torch.equal(oi, ri), f"onehot_groupby[{name}]: ints differ")
    check(bool(ovf.item()) == bool(rovf.item()),
          f"onehot_groupby[{name}]: overflow flag differs")
    err = 0.0
    if floats:
        absc = [(d.abs() if d.is_floating_point() else d, v)
                for d, v in cols]
        rabs = KER.onehot_groupby_columns_plain(kd, kv, live, absc, ints,
                                                floats, K)[1]
        rel = 0.0
        for j in range(len(floats)):
            a = of[:, 3 * j:3 * j + 3].sum(1)
            b = rf[:, 3 * j:3 * j + 3].sum(1)
            err = max(err, (a - b).abs().max().item())
            scale = rabs[:, 3 * j:3 * j + 3].sum(1).clamp(min=1e-300)
            rel = max(rel, ((a - b).abs() / scale).max().item())
        check(rel <= FLOAT_RTOL,
              f"onehot_groupby[{name}]: float sums off by {rel} of sum|x|")
    ms = time_ms(lambda: KER.onehot_groupby_columns(*args, K))
    plain = time_ms(lambda: KER.onehot_groupby_columns_plain(*args, K))

    # yardstick: index_add_ of the same columns by bucket, the bucket and
    # the widened columns made outside the timed region
    bucket = KER.onehot_payload(kd, kv, live, [], [], [], K)[0]
    idx = torch.where(bucket >= 0, bucket, K + 1).to(torch.int64)
    vi = torch.stack([torch.ones_like(kd, dtype=torch.int64)]
                     + [v.to(torch.int64) for _, v in cols]
                     + [cols[i][0].to(torch.int64) for i in ints], 1)
    vf = (torch.stack([cols[i][0] for i in floats], 1) if floats else None)

    def library():
        torch.zeros((K + 2, vi.shape[1]), dtype=torch.int64,
                    device=kd.device).index_add_(0, idx, vi)
        if vf is not None:
            torch.zeros((K + 2, vf.shape[1]), dtype=torch.float64,
                        device=kd.device).index_add_(0, idx, vf)

    lib = time_ms(library)
    # the raw columns read once: key and its validity, the row mask, each
    # column's validity, each sum column's data; the partials written once
    nbytes = n * (kd.element_size() + 1 + (1 if live is not None else 0)
                  + len(cols)
                  + sum(cols[i][0].element_size() for i in ints + floats)) \
        + (K + 1) * (oi.shape[1] + of.shape[1]) * 8
    mi, mf = oi.shape[1], of.shape[1]
    b, by = bound_ms(nbytes, n * (mi + 3 * mf))
    return {"shape": name, "form": "fused_columns", "n": n, "domain": K + 1,
            "int_partials": mi, "float_partials": mf,
            "overflow": bool(ovf.item()), "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": b, "bound_by": by,
            "library_ms": lib}


def k1_contract_case(name, batch, key, aggs, K, row_valid):
    """The reference's contract entry (a built int8/f32 payload) on the
    payload kernel, against its plain version."""
    from spark_rapids_jni_tpu_torch.ops import kernels as KER

    kd, kv, live, cols, ints, floats = onehot_inputs(batch, key, aggs,
                                                     row_valid)
    bucket, X8, F, _ = KER.onehot_payload(kd, kv, live, cols, ints, floats,
                                          K)
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

    mb, rv = fact_morsel(fact, j, invalid_tail)
    regrouped, counts, _ = SVC._map_keys(mb, ["k"], rv, P_SHARDS)
    return SVC._leaves(regrouped), counts.to(torch.int32).contiguous()


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

    P = S = P_SHARDS
    mb, rv = fact_morsel(fact, j, invalid_tail)
    pid, counts, _, _ = SVC._route_count(SVC._key_pid(mb, ["k"], rv, P),
                                         P)
    leaves = [x.contiguous() for x in SVC._leaves(mb)]
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


def phase_kernels(q6b, fact, dim1, dim2):
    """Every kernel case; returns ``{kernel: [case, ...]}`` (main shape
    first).  A case that raises is recorded and left out."""
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.plan import adaptive as AD
    from spark_rapids_jni_tpu_torch.relational import hashtable as H
    from spark_rapids_jni_tpu_torch.relational import keys as RK

    cases = {k: [] for k in REPLACES}

    def run(kernel, label, fn, *args):
        out = guarded(f"kernel {kernel}[{label}]", fn, *args)
        if out is not None:
            case = out[0] if isinstance(out, tuple) else out
            emit({"phase": "kernel", "kernel": kernel, **case})
            cases[kernel].append(case)
        return out

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

    uniq, sums, cnts, avgs = PL.q6_oracle(*arrays)
    got = PL.result_groups(res, ng, "k")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch import pipelines as PL
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
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})

    n6 = int(config.get("bench_rows_tpu"))
    q6_arrays = PL.example_arrays(n6)
    q6b = PL.example_batch(n6)
    q95_arrays = PL.q95_arrays(N_FACT)
    fact, dim1, dim2 = PL.q95_batches(N_FACT)

    cases = guarded("kernels", phase_kernels, q6b, fact, dim1, dim2) or {}

    total = {k: 0 for k in REPLACES}

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

    k4_main = (cases.get("partition_scatter") or [None])[0]
    counts = guarded("stream_exchange", phase_stream, fact, k4_main)
    for k in total:
        total[k] += (counts or {}).get(k, 0)

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

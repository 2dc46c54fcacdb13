"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and its ``nvidia-smi`` name/power-limit line;
2. build: compile every CUDA kernel of the port from ``csrc/`` (nvcc,
   ``sm_90a``, one process per source, all started together);
3. kernels: each kernel at the shapes the main path gives it, held
   against its plain PyTorch version on the same inputs (ints, owners and
   slots bit-identical; float sums rel 1e-5, the reference's f32x3
   tolerance), timed beside the plain version, a library call where one
   computes the same function, and the least time the card could take;
4. q6 on the one-hot path, 5. q6 on the slot-table hash engine,
6. q95 (dense joins + one-hot group-by) and q95 through the hash join:
   each driven once with every launch count at 0 just before and read
   just after, checked against the numpy oracle, then timed.

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
    "slot_table_probe":
        "spark_rapids_jni_tpu/ops/pallas_kernels.py:414",
}
SOURCES = {
    "onehot_groupby": "spark_rapids_jni_tpu_torch/csrc/onehot_groupby.cu",
    "slot_table_build": "spark_rapids_jni_tpu_torch/csrc/slot_table.cu",
    "slot_table_probe": "spark_rapids_jni_tpu_torch/csrc/slot_table.cu",
}


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

def k1_case(name, batch, key, aggs, K, row_valid):
    """The one-hot group-by at the payload the main path builds."""
    from spark_rapids_jni_tpu_torch.ops import kernels as KER
    from spark_rapids_jni_tpu_torch.relational import aggregate as AGG

    bucket, X8, F, _, _ = AGG._onehot_payload(batch, key, aggs, K,
                                              row_valid, "f32x3")
    n, mi = X8.shape
    mf = F.shape[1]
    dom = K + 1
    oi, of = KER.onehot_groupby_parts(bucket, X8, F, dom)
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
    return {"shape": name, "n": n, "domain": dom, "mi": mi, "mf": mf,
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b,
            "bound_by": by, "library_ms": lib}


def k2_case(name, words, live, S, max_rounds):
    from spark_rapids_jni_tpu_torch.ops import kernels as KER

    n, W = live.shape[0], len(words)
    got = KER.slot_table_build(words, live, S, max_rounds)
    ref = KER.slot_table_build_plain(words, live, S,
                                     S if max_rounds is None else max_rounds)
    torch.cuda.synchronize()
    for a, r, what in zip(got, ref, ("owner", "slot", "overflow")):
        check(torch.equal(a, r), f"slot_table_build[{name}]: {what} differs")
    ms = time_ms(lambda: KER.slot_table_build(words, live, S, max_rounds))
    plain = time_ms(lambda: KER.slot_table_build_plain(
        words, live, S, S if max_rounds is None else max_rounds), reps=2)
    # words as u32 (4 B each), live 1 B; owner S x 4 B, slot n x 4 B
    b, by = bound_ms(n * (4 * W + 1) + S * 4 + n * 4)
    return {"shape": name, "n": n, "S": S, "W": W,
            "overflow": bool(got[2].item()), "max_abs_err": 0,
            "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
            "library_ms": None}, got[0]


def k3_case(name, owner, bwords, pwords, live, rounds):
    from spark_rapids_jni_tpu_torch.ops import kernels as KER

    S, n, m, W = owner.shape[0], bwords[0].shape[0], live.shape[0], \
        len(pwords)
    got = KER.slot_table_probe(owner, bwords, pwords, live, rounds)
    ref = KER.slot_table_probe_plain(owner, bwords, pwords, live, rounds)
    torch.cuda.synchronize()
    for a, r, what in zip(got, ref, ("found", "slot")):
        check(torch.equal(a, r), f"slot_table_probe[{name}]: {what} differs")
    ms = time_ms(lambda: KER.slot_table_probe(owner, bwords, pwords, live,
                                              rounds))
    plain = time_ms(lambda: KER.slot_table_probe_plain(
        owner, bwords, pwords, live, rounds), reps=2)
    # owner + build words + probe words + live in; found + slot out
    b, by = bound_ms(S * 4 + n * 4 * W + m * (4 * W + 1) + m * 5)
    return {"shape": name, "m": m, "S": S, "n_build": n, "W": W,
            "rounds": rounds, "hit_rate": got[0].float().mean().item(),
            "max_abs_err": 0, "ms": ms, "plain_ms": plain, "bound_ms": b,
            "bound_by": by, "library_ms": None}


def phase_kernels(q6b, fact, dim1, dim2):
    """Every kernel case; returns ``{kernel: [case, ...]}`` (main shape
    first).  A case that raises is recorded and left out."""
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.plan import adaptive as AD
    from spark_rapids_jni_tpu_torch.relational import hashtable as H
    from spark_rapids_jni_tpu_torch.relational import keys as RK

    cases = {"onehot_groupby": [], "slot_table_build": [],
             "slot_table_probe": []}

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

    # the probe of the fact keys into the dim1 table
    if out is not None:
        owner1 = out[1]
        pk = RK.batch_radix_keys([fact["k"]], equality=True,
                                 nulls_first=False)
        plive = torch.ones(fact.num_rows, dtype=torch.bool, device=dev)
        run("slot_table_probe", "fact_into_dim1", k3_case, "fact_into_dim1",
            owner1, rk1, pk, plive, H.chain_bound(owner1, dim1.num_rows))
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
    """Where q6's one-hot step spends its time: the payload build alone."""
    from spark_rapids_jni_tpu_torch import pipelines as PL
    from spark_rapids_jni_tpu_torch.relational import aggregate as AGG

    return {"onehot_payload_ms": time_ms(lambda: AGG._onehot_payload(
        q6b, "k", list(PL.Q6_AGGS), 100, q6b["price"].data < 50.0,
        "f32x3"))}


def q95_stages(fact, dim1, dim2):
    """Cumulative ms of the q95 step truncated after each stage."""
    from spark_rapids_jni_tpu_torch import pipelines as PL

    return {f"upto_{u}_ms": time_ms(lambda u=u: PL._q95_prefix(
        fact, dim1, dim2, u), reps=3) for u in ("exch1", "join1", "join2")}


def phase_path(name, fn, args, rows, verify, needs, stages=None):
    """Drive one pipeline: counts, oracle check, then steady-state time."""
    (res, ng), counts, first_s = driven(fn, *args)
    extra = verify(res, ng)
    for k in needs:
        check(counts[k] > 0, f"{name}: kernel {k} was not launched")
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

    def path(name, group_path, fn, args, rows, verify, needs, stages=None):
        config.set("q6_group_path", group_path)
        counts = guarded(name, phase_path, name, fn, args, rows, verify,
                         needs, stages)
        config.reset("q6_group_path")
        for k in total:
            total[k] += (counts or {}).get(k, 0)

    path("q6_onehot", "onehot", PL.q6_step, (q6b,), n6,
         lambda r, g: check_q6(r, g, q6_arrays, "q6_onehot"),
         ("onehot_groupby",), lambda: q6_stages(q6b))
    path("q6_hash", "sort", PL.q6_step, (q6b,), n6,
         lambda r, g: check_q6(r, g, q6_arrays, "q6_hash"),
         ("slot_table_build",))
    path("q95", "onehot", PL.q95_step, (fact, dim1, dim2), N_FACT,
         lambda r, g: check_q95(r, g, q95_arrays, "q95"),
         ("onehot_groupby",), lambda: q95_stages(fact, dim1, dim2))
    path("q95_hashjoin", "onehot", PL.q95_hashjoin_step, (fact, dim1, dim2),
         N_FACT, lambda r, g: check_q95(r, g, q95_arrays, "q95_hashjoin"),
         ("slot_table_build", "slot_table_probe"))

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

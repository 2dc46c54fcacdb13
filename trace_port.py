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

With ``--stream-reps N`` it only times N whole streamed exchanges of the
2^24-row fact table (512 morsels); run it for two trees in turns to
compare them.
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
            kernels[e.key[:90]] = (e.count, dev_us / 1e3)
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--root", default=None)
    ap.add_argument("--out", default="trace_out")
    ap.add_argument("--morsels", type=int, default=20)
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
    fact, dim1, _ = PL.q95_batches(1 << 24)
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

    # -- the map step of one morsel, split --------------------------------
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

    # -- the stream over a few morsels, profiled ------------------------
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

    # -- the slot-table builds at both main-path shapes -----------------
    dev = fact["k"].data.device
    q6b = PL.example_batch(1 << 24)
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

    with open(path, "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps({k: out[k] for k in ("tag", "card", "map_step",
                                          "k4_device", "k4_host_call_ms")},
                     default=str))
    print(json.dumps({"stream": {k: v for k, v in
                                 out["stream_profile"].items()
                                 if k != "top_kernels"},
                      "builds": {k: {kk: vv for kk, vv in v.items()
                                     if kk != "kernels"}
                                 for k, v in builds.items()}}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Knob registry for the port: only the knobs the ported path reads.

Same precedence story as the reference's registry: programmatic override
> environment variable (``SPARK_RAPIDS_TORCH_<KEY>``) > default.  The
environment prefix differs from the reference's so a knob set for one
package never reaches the other.

Engine values: ``"kernel"`` is the hand-written CUDA tier (the
counterpart of the reference's ``"pallas"``), and ``"auto"`` resolves to
it on every path.  A kernel wrapper given CPU tensors runs its plain
PyTorch version, so ``"auto"`` on the CPU runs the same arithmetic.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

_ENV_PREFIX = "SPARK_RAPIDS_TORCH_"


@dataclass(frozen=True)
class _Entry:
    default: Any
    parse: Callable[[str], Any]
    doc: str


_REGISTRY: Dict[str, _Entry] = {}
_overrides: Dict[str, Any] = {}
_lock = threading.Lock()


def _register(key: str, default, parse, doc: str):
    _REGISTRY[key] = _Entry(default, parse, doc)


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


_register("bench_rows_tpu", 1 << 24, int,
          "Full-size row count of the q6 step on the accelerator "
          "(chip_smoke.py drives q6 at this size).")
_register("q6_group_path", "onehot", str,
          "Aggregation path of the q6 step: 'onehot' (group_by_onehot over "
          "the static key domain [0, 100), the one-hot group-by kernel) or "
          "'sort' (the general group_by under the groupby_engine knob — "
          "the slot-table hash engine by default).")
_register("q6_onehot_engine", "auto", str,
          "Engine of the domain-key aggregation: 'auto' or 'kernel' (the "
          "one-hot group-by kernel; its plain version on CPU tensors).")
_register("q6_float_mode", "f32x3", str,
          "Float-sum mode of the q6 one-hot path: 'f32x3' (exact Dekker "
          "split into three f32 limbs, summed in f32 per block and f64 "
          "across blocks).  The kernel has no f64 contraction.")
_register("groupby_engine", "auto", str,
          "General group_by engine: 'sort' (stable lexicographic sort + "
          "segment sums), 'kernel' (slot-table hash engine with the table "
          "built by the slot-table build kernel; falls back to sort when "
          "the table overflows), or 'auto' (= 'kernel').")
_register("join_engine", "auto", str,
          "hash_join engine: 'kernel' (slot-table build and probe "
          "kernels) or 'auto' (= 'kernel').")
_register("adaptive_execution", True, _parse_bool,
          "Plan-time adaptive decisions (plan/adaptive.py): broadcast vs "
          "shuffled joins from observed build sizes, group-by engine from "
          "skewed counts passes, per-exchange round capacity from "
          "ShuffleMetrics, and the slot table's round bounds (build bound "
          "from the load factor; bound_probe_rounds = the table's exact "
          "chain_bound — hash_join's probe walks to the chain bound its "
          "slot records carry either way, result-identical).  Off = the "
          "static defaults everywhere.")
_register("broadcast_threshold_rows", 1 << 16, int,
          "Adaptive-join build-side row cutoff: a strategy='auto' join "
          "whose observed build side is at or under this goes broadcast "
          "(a resident prebuilt build table probed by hash_join), over it "
          "shuffled — Spark's autoBroadcastJoinThreshold, in rows.")
_register("plan_cache_size", 64, int,
          "Max compiled plans the plan cache (plan/cache.py) holds; LRU "
          "past it.  Keys are (canonical IR shape, input schema, knob "
          "fingerprint, adaptive decisions).")
_register("shuffle_round_rows", 1 << 16, int,
          "Per-(sender, destination) slot rows one ShuffleService round "
          "may carry (shuffle/planner.py); bigger buckets drain over "
          "several rounds instead of inflating the slot grid.")
_register("shuffle_max_recoveries", 8, int,
          "Per-exchange budget of lineage recoveries in the ShuffleService "
          "(shuffle/service.py): each lost or corrupt partition buffer "
          "rebuilt by re-running its map shards or re-driving its round "
          "counts against it (ShuffleMetrics.recovered_partitions); past "
          "it the exchange raises ShuffleError, so a flapping disk cannot "
          "loop a shuffle forever.")
_register("shuffle_store_dir", "", str,
          "Root of the persistent shuffle store (shuffle/store.py): "
          "committed map outputs and drained round chunks land here "
          "(crash-safe tmp + fsync + rename commits, a CRC32 per chunk "
          "in the manifest), so a replacement worker ADOPTS a dead "
          "worker's finished shards instead of re-running their map.  "
          "Empty disables the durable tier.")
_register("shuffle_store_max_attempts", 2, int,
          "Committed attempts the store keeps per (key, shard): after a "
          "successful commit, older attempts beyond this are pruned "
          "(adoption reads the highest committed attempt, so extras only "
          "buy depth of fallback past a corrupt one).  0 or negative "
          "keeps everything.")
_register("shuffle_capacity_bucket", 256, int,
          "Rounding bucket for planned exchange capacities.")
_register("shuffle_max_rounds", 64, int,
          "Cap on materialized ShuffleService rounds per exchange; a plan "
          "that would exceed it raises the per-round capacity (never "
          "drops rows).")
_register("shuffle_capacity_dcn", 0, int,
          "Override for the per-(sender, destination-host) slot capacity "
          "of hop one in hierarchical exchanges (shuffle/planner.py "
          "plan_hierarchical); 0 = plan it from the observed count matrix "
          "instead of the flat worst-case grid.")
_register("shuffle_capacity_ici", 0, int,
          "Override for the per-(sender, destination-chip) slot capacity "
          "of hop two in hierarchical exchanges (shuffle/planner.py "
          "plan_hierarchical); 0 = plan it from the observed count "
          "matrix.")
_register("shuffle_strict_pids", False, _parse_bool,
          "Raise ShuffleError on out-of-range partition ids (< 0 or > P) "
          "instead of routing them to the null partition and counting "
          "them in oob_rows.")
_register("scan_morsel_rows", 4096, int,
          "Per-shard rows in one scan morsel (shuffle/morsel.py): the "
          "streaming exchange maps and scatters one morsel at a time and "
          "drains a round as soon as no later morsel can touch it.")
_register("shuffle_stream", False, _parse_bool,
          "Lower a root Exchange(Scan) bound to a MorselSource through "
          "ShuffleService.exchange_stream (plan/compile.py) instead of "
          "materializing the scan first.")
_register("shuffle_compress", "auto", str,
          "Wire compression of exchange rounds (shuffle/service.py): "
          "'pack' bit-packs every bool leaf at width 1 and every integer "
          "leaf at its observed range's bucketed width (the stream: bool "
          "leaves only, its ranges are unknown until its last morsel); "
          "'auto' packs only a dictionary-carrying exchange's validity "
          "bools and code words; 'off' ships raw words.  Delivered rows "
          "are identical either way; compressed_bytes_saved counts the "
          "difference.")
_register("encoded_execution", "auto", str,
          "Where encoding is introduced (columnar/encoded.py): 'on' "
          "builds dictionary columns at the host boundary (Arrow "
          "dictionary arrays stay encoded) and operators run on codes, "
          "'off' decodes up front, 'auto' is on for the CPU and, on the "
          "GPU, what the H100's q6str / q6str_enc pair chose (PERF.md).  "
          "Operators take encoded and plain columns either way.")
_register("packed_predicates", True, _parse_bool,
          "Compare filters (<, <=, ==, !=, >=, >) on bit-packed and "
          "frame-of-reference residuals without decoding "
          "(packed_filter_mask); off = decode, then compare.")
_register("zone_maps", True, _parse_bool,
          "Record a CRC32'd per-block min/max sidecar (ZoneMap) on packed "
          "columns at encode time and let MorselSource.from_batch skip "
          "morsels a predicate's zone check proves cold (counted as "
          "blocks_skipped / blocks_scanned); off = no sidecars, no "
          "skips.")
_register("scan_pruning", True, _parse_bool,
          "Push scan-level predicates into the Parquet footer "
          "(io/parquet.py / io/parquet_footer.py): row groups whose "
          "column min/max statistics cannot satisfy the predicate are "
          "dropped before any data page is read, and "
          "MorselSource.from_parquet never builds replays for them.  "
          "Groups with missing stats or nulls are conservatively kept; "
          "off = read every split-surviving row group.")
_register("shuffle_scatter_engine", "auto", str,
          "Morsel -> round-chunk scatter of the streaming exchange: "
          "'kernel' (the partition-scatter kernel, csrc/"
          "partition_scatter.cu; its plain version on CPU tensors) or "
          "'auto' (= 'kernel').")

_register("json_max_out", 0, int,
          "get_json_object output width cap (0 = provable 6*L+20 bound).")
_register("json_fast_path", True, _parse_bool,
          "Route wildcard-free get_json_object paths through the "
          "bit-parallel fast engine (ops/json_fast.py): data-parallel "
          "passes over the char matrix instead of one scan-machine step "
          "per char column; rows it cannot prove it handles fall back to "
          "the scan machine.")
_register("json_fallback_div", 16, int,
          "Per-row fallback compaction capacity for the JSON hybrid: "
          "flagged rows are gathered into chunks of ceil(n/div) rows and "
          "only those chunks run the scan machine (a host loop of "
          "ceil(n_flagged / chunk) iterations after one read of the "
          "flagged count; clean batches run none).  div=1 degenerates to "
          "whole-batch chunks; 0 disables compaction (any flagged row "
          "routes the whole batch through the scan machine).")
_register("json_scan_unroll", 2, int,
          "Chars per iteration of the reference's JSON scan (lax.scan "
          "unroll).  Accepted with the reference's name and default; the "
          "port's scan is a host loop over the char columns, so the value "
          "changes nothing.")
_register("watchdog_poll_ms", 100.0, float,
          "Deadlock watchdog period of the memory arena's resource adaptor "
          "(mem/rmm_spark.py; reference: "
          "ai.rapids.cudf.spark.rmmWatchdogPollingPeriod).")
_register("spill_dir", "", str,
          "Directory of the spill store's disk tier (mem/spill.py).  Empty "
          "(default): a fresh mkdtemp owned, and removed, by the "
          "SpillFramework; set it to put spill files on a chosen volume "
          "(reference: spark.local.dir for RapidsDiskStore).")
_register("spill_checksum", True, _parse_bool,
          "Record a CRC32 and byte length for every leaf the spill store "
          "demotes and verify both on read-back (mem/spill.py).  A "
          "mismatch means the spilled copy is damaged: the handle "
          "rebuilds through its recompute= lineage when it has one, else "
          "raises SpillCorruptionError.  Off = trust the filesystem.")
_register("spill_codec", "off", str,
          "Codec of the spill store's disk tier (mem/spill.py, "
          "mem/codec.py): 'pack' frame-of-reference bit-packs eligible "
          "integer leaves, 'block' runs a byte-wise RLE block codec over "
          "any leaf, 'off' writes raw npy.  CRCs are recorded over the "
          "stored (compressed) bytes and the decoded leaf; any other "
          "value raises at the first disk write.")
_register("mem_pool_bytes", 0, int,
          "Default logical device-memory arena size for "
          "RmmSpark.set_event_handler (0 = the caller must pass one).")
_register("serve_max_concurrent", 4, int,
          "Admission slots of the serving runtime (serve/runtime.py): "
          "how many tenant queries may hold a TaskContext at once; the "
          "rest wait in the admission queue (their wait is visible to "
          "the deadlock scan via ThreadStateRegistry).")
_register("serve_admit_timeout_s", 30.0, float,
          "Max seconds a submitted query may wait in the admission "
          "queue before failing with QueryTimeout (per admission "
          "attempt; re-admissions get a fresh window).")
_register("serve_stall_break_ms", 2000.0, float,
          "Serving-mode watchdog escalation: threads continuously "
          "blocked past this are treated as a cross-tenant deadlock "
          "cycle even while other tenants keep running, and the "
          "lowest-priority one is rolled back (RetryOOM).  0 disables; "
          "armed by ServeRuntime on construction.")
_register("serve_max_readmissions", 2, int,
          "How many times a query killed by its own timeout is backed "
          "off and re-admitted before QueryTimeout surfaces (external "
          "cancels never re-admit).")
_register("serve_backoff_ms", 50.0, float,
          "Base backoff between a query's timeout kill and its "
          "re-admission, doubled per attempt (serve/runtime.py).")
_register("serve_data_plane", "auto", str,
          "How result payloads cross a process boundary "
          "(serve/data_plane.py): 'shm' (a sealed memfd passed by "
          "SCM_RIGHTS; unix transport only), 'frames' (MSB-flagged "
          "binary frames on the socket), 'json' (base64 in the message, "
          "refused past the control-frame cap) or 'auto' (shm on unix, "
          "frames on tcp).")


def knob_fingerprint() -> tuple:
    """Every registered knob's resolved value, by key: a flip of any knob
    changes it (the reference's ``serve/result_cache.py``
    ``knob_fingerprint``, which the plan cache keys on)."""
    return tuple((k, repr(get(k))) for k in sorted(_REGISTRY))


def get(key: str):
    """Resolve ``key``: programmatic override > env var > default."""
    entry = _REGISTRY.get(key)
    if entry is None:
        raise KeyError(f"unknown config key {key!r}; known: "
                       f"{sorted(_REGISTRY)}")
    with _lock:
        if key in _overrides:
            return _overrides[key]
    env = os.environ.get(_ENV_PREFIX + key.upper())
    if env is not None:
        return entry.parse(env)
    return entry.default


def set(key: str, value) -> None:  # noqa: A001 - mirrors a settings API
    if key not in _REGISTRY:
        raise KeyError(f"unknown config key {key!r}")
    with _lock:
        _overrides[key] = value


def reset(key: Optional[str] = None) -> None:
    with _lock:
        if key is None:
            _overrides.clear()
        else:
            _overrides.pop(key, None)


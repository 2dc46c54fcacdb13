"""The exchange: map -> plan -> drain rounds -> reassemble.

Counterpart of ``spark_rapids_jni_tpu/shuffle/service.py`` over the
port's meshes (:mod:`..parallel.mesh`).  On a
:class:`~..parallel.mesh.ShardMesh` P row shards of one tensor stand in
for the reference's P devices, every per-device step runs over all shards
at once, and the reference's ``lax.all_to_all`` is a transpose of
``[P_s, P_d, C]`` to ``[P_d, P_s, C]``.  On a
:class:`~..parallel.mesh.ProcessMesh` each rank maps its own rows, an
all-gather of the count rows gives every rank the same ``[P, P]`` matrix
and so the same plan (and the stream the same drain schedule), and each
round drains through ``all_to_all_single``.  Delivered arrays are
bit-identical, shard for shard, to the reference's on its P-device mesh.

* **map**: route rows to Spark-exact partition ids (or caller-supplied
  ids; out-of-range ones go to the null partition and are counted) and
  count the ``[P, P]`` (sender, destination) matrix with one bincount;
  the materialized :meth:`ShuffleService.exchange` then regroups each
  shard destination-major with ONE stable sort on ``shard * (P + 1) +
  pid``, while the stream leaves its morsels in map order.
* **plan** (host): :func:`~.planner.plan_rounds` turns the counts into a
  static ``(rounds, capacity)`` shape (:meth:`ShuffleService.exchange`);
  the stream fixes its capacity up front
  (:func:`~.planner.plan_stream_capacity`) and re-plans its round
  schedule as morsel counts arrive (:meth:`ShuffleService.exchange_stream`).
* **scatter** (stream): each morsel lands in its round chunks through the
  partition-scatter kernel (:class:`~..ops.kernels.PartitionScatter`,
  one launch per morsel for every round it touches and every local
  shard; the kernel ranks each row within its (shard, destination)
  bucket itself).
* **wire** (``shuffle_compress``): ``pack`` sends every bool leaf at
  width 1 and every integer leaf frame-of-reference bit-packed at its
  observed range's bucketed width, one packed stream per (sender,
  destination) row, so the all-to-all still splits rows; ``auto`` packs
  only a dictionary-carrying exchange's bools and code words; the
  stream packs bool leaves only (its ranges are unknown until its last
  morsel).  Chunks stay packed until reassembly
  (:func:`_unpack_chunk`); ``compressed_bytes_saved`` is the reference's
  static count of the bytes packing saved.
* **encoded columns**: a dictionary column crosses as codes and its
  dictionary is reattached once after (counted once in
  ``bytes_moved``); a key on a dictionary routes by its values; RLE and
  packed columns decode first.  The stream decodes every encoded column
  per morsel.
* **drain + reassemble + account**: rows received must equal rows sent,
  else :class:`ShuffleError` — ``dropped == 0`` is an invariant.

Buffers are spillable (:mod:`.buffers`): with ``ctx=`` each map output,
morsel and round chunk is charged to the task's arena, and an idle one
is demoted device -> host -> disk when a charge does not fit; the bytes
the exchange saw demoted are ``spilled_bytes``.

Fault injection: each round passes the ``shuffle_io_round`` probe; an
injected :class:`~..faultinj.ShuffleIOError` re-drives the round from its
buffers (nothing was consumed) up to ``_IO_RETRIES`` times, each counted
in ``io_failures``, then raises.

Lineage: every buffer carries its map lineage as its handle's
``recompute=``.  The map output re-runs the map; a round chunk re-drives
that one round against the (recovered) map output; a stream's send chunk
re-scatters every recorded morsel contribution through the
partition-scatter kernel, and its received chunk re-drains the send
chunk.  A buffer whose spilled copy is lost or fails its checksum is so
rebuilt from ONLY the shards that made it; each rebuild counts in
``recovered_partitions`` and draws on the exchange's
``shuffle_max_recoveries`` budget, past which :class:`ShuffleError`
raises.

The persistent store (``store_key=``, :mod:`.store`): the map output and
every drained round are committed best-effort under the caller's stable
key, and a later run of the same exchange, in this process or a
replacement worker, adopts them instead of running the map (or the
round's all-to-all).  A lineage rebuild asks the store before it
re-runs anything.  On a :class:`~..parallel.mesh.ProcessMesh` each rank
holds only its own shards, so it commits and adopts them under a shard
name that carries its global rank (``map-rank3``, ``round-0-rank3``):
two ranks never write one entry.  The reference has no such case (one
process holds its global arrays).  On ranks the stream adopts a round
only when every rank can (an all-reduce of the verdicts), and a received
chunk's re-drive, a collective the other ranks are not in, is not
available: a rank recovers a lost received chunk only from the store,
else the loss raises :class:`ShuffleError`.

The shared drain lane (:func:`install_drain_lane`, installed by
``serve/runtime.py``): with a lane installed, :meth:`ShuffleService.
exchange` pipelines its rounds at depth 1, round r+1 running on the lane
thread while the calling thread wraps round r's chunk, and one lane
serves every tenant.  Every task shares the device's default stream,
so a lane round and a tenant's own work are ordered on the device: the
overlap is on the host.  On a :class:`~..parallel.mesh.ProcessMesh` the
rounds stay sequential: each round is a collective every rank must
enter in the same order, and the reference, one process holding every
device, has no such case.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .. import config, faultinj
from ..columnar.column import ColumnBatch
from ..columnar.encoded import (PACKED_COLUMNS, DictionaryColumn,
                                RunLengthColumn, choose_pack_width,
                                detach_dictionaries, is_encoded,
                                materialize_batch, pack_bits_rows,
                                reattach_dictionaries, unpack_bits_rows)
from ..mem.executor import run_with_retry
from ..ops.kernels import PartitionScatter
from ..parallel.collectives import send_rows
from ..parallel.partition import spark_partition_id
from ..parallel.shuffle import bucket_counts, route_out_of_range
from ..relational.gather import gather_batch
from . import store as store_mod
from .buffers import (MorselBuffer, PartitionBuffer, RoundChunk,
                      batch_leaves, column_leaves, rebatch, store_recompute,
                      tree_nbytes)
from .planner import plan_rounds, plan_stream_capacity
from .registry import ShuffleInfo, ShuffleRegistry, get_registry


class ShuffleError(RuntimeError):
    """Lossless-invariant violation or strict-mode partition id abuse."""


# every drain round passes this probe; kind "shuffle_io" rules make it
# raise ShuffleIOError (the transport fault)
_io_probe = faultinj.instrument(lambda: None, "shuffle_io_round")

_IO_RETRIES = 3  # bounded re-drives of one round on transport faults

# The serving runtime's shared drain lane.  The contract:
# ``submit(task_id, fn)`` returns a Future whose ``result()`` re-raises;
# ``task_id`` attributes the lane thread's arena charges (and its place
# in the deadlock scan) to the tenant that owns the round.
_drain_lane = [None]


def install_drain_lane(lane) -> None:
    _drain_lane[0] = lane


def clear_drain_lane() -> None:
    _drain_lane[0] = None


def get_drain_lane():
    return _drain_lane[0]


@dataclass
class ShuffleResult:
    """A completed exchange: row-sharded output + its exact accounting."""

    batch: ColumnBatch       # [P * rounds * P * capacity] rows, row-sharded
    occupancy: torch.Tensor  # bool, same rows: True = live row
    shuffle_id: int
    rounds: int
    capacity: int
    rows_moved: int
    bytes_moved: int
    skew_ratio: float
    oob_rows: int
    spilled_bytes: int = 0          # bytes demoted while it ran
    recovered_partitions: int = 0   # buffers rebuilt through lineage
    streamed: bool = False          # produced by exchange_stream
    morsels: int = 0                # morsels mapped (streamed only)
    rounds_overlapped: int = 0      # rounds drained before end-of-stream
    decode_ms: float = 0.0          # cumulative morsel map time (host)
    drain_ms: float = 0.0           # cumulative round drain time (host)
    scatters: int = 0               # (morsel, round) scatters (streamed)
    sync_ms: float = 0.0            # host waits on the per-morsel counts
    compressed_bytes_saved: int = 0  # wire bytes the pack plan saved
    blocks_skipped: int = 0         # zone blocks the morsel check excluded
    blocks_scanned: int = 0         # zone blocks consulted and kept


def _concat_rounds(chunks, L: int):
    """Per-shard concatenation of round chunks (each ``[L * rows, ...]``
    over the ``L`` local shards): shard d's rounds follow one another,
    shards stay in order."""
    if len(chunks) == 1:
        return chunks[0]
    out = []
    for parts in zip(*chunks):
        rest = tuple(parts[0].shape[1:])
        out.append(torch.stack([p.reshape((L, -1) + rest) for p in parts],
                               dim=1).reshape((-1,) + rest))
    return out


def _on_device(dev: torch.device, fn):
    """``fn`` made to run with ``dev`` current on whichever thread calls
    it (the lane thread's current CUDA device is its own)."""
    if dev.type != "cuda":
        return fn

    def run():
        with torch.cuda.device(dev):
            return fn()
    return run


# ---------------------------------------------------------------------------
# map
# ---------------------------------------------------------------------------

def _route_count(pid: torch.Tensor, P: int, L: Optional[int] = None):
    """Route OOB ids to the null partition and count each of the ``L``
    local shards' rows (default ``P``: a shard mesh) per destination:
    the stream's whole map body (its morsels stay in map order; the
    scatter kernel ranks rows itself).  Returns ``(pid int32, counts
    int64[L, P], n_oob, key)``, ``key = shard * (P + 1) + pid``."""
    pid, n_oob = route_out_of_range(pid, P)
    key, counts = bucket_counts(pid, P, P if L is None else L)
    return pid, counts, n_oob, key


def _map_local(b: ColumnBatch, pid: torch.Tensor, P: int,
               L: Optional[int] = None):
    """The materialized exchange's map body over the ``L`` local shards
    at once: route OOB -> count -> regroup each shard destination-major
    (one stable sort on ``shard * (P + 1) + pid``).  Returns
    ``(regrouped, counts int64[L, P], n_oob)``."""
    _, counts, n_oob, key = _route_count(pid, P, L)
    perm = torch.sort(key, stable=True).indices
    return gather_batch(b, perm), counts, n_oob


def _key_pid(b: ColumnBatch, key_names, row_valid, P: int):
    rv = (torch.ones((b.num_rows,), dtype=torch.bool,
                     device=b.columns[0].device)
          if row_valid is None else row_valid.to(torch.bool))
    return spark_partition_id([b[k] for k in key_names], P, rv)


def _map_keys(b: ColumnBatch, key_names, row_valid, P: int,
              L: Optional[int] = None):
    return _map_local(b, _key_pid(b, key_names, row_valid, P), P, L)


def _host_counts(counts: torch.Tensor, oob: torch.Tensor, P: int,
                 mesh=None):
    """The global ``[P, P]`` count matrix and oob count on the host: the
    local ``[L, P]`` count rows (oob beside them) cross in one all-gather
    over ``mesh`` (none: every shard is local), then one device -> host
    read."""
    L = counts.shape[0]
    col = torch.zeros((L, 1), dtype=torch.int64, device=counts.device)
    col[0, 0] = oob
    full = torch.cat([counts.to(torch.int64), col], 1)
    if mesh is not None:
        full = mesh.all_gather(full)
    full = full.cpu().numpy()
    return full[:, :P], int(full[:, P].sum())


def _resolve_scatter_engine(engine=None) -> str:
    """``None`` reads the ``shuffle_scatter_engine`` knob; ``auto`` is the
    kernel tier (the partition-scatter kernel, its plain version on CPU
    tensors)."""
    if engine is None:
        engine = config.get("shuffle_scatter_engine")
    if engine == "auto":
        return "kernel"
    if engine != "kernel":
        raise ValueError(f"unknown shuffle scatter engine {engine!r} "
                         "(use 'auto' or 'kernel')")
    return engine


def _resolve_compress() -> str:
    compress = str(config.get("shuffle_compress") or "auto").lower()
    if compress not in ("auto", "off", "pack"):
        raise ValueError(f"shuffle_compress must be auto/off/pack, "
                         f"got {compress!r}")
    return compress


def _shard_name(mesh, name: str) -> str:
    """A store shard name: the reference's on a mesh that holds every
    shard, else suffixed with the process's global rank (each rank holds
    only its own shards)."""
    if mesh.holds_all:
        return name
    import torch.distributed as dist

    return f"{name}-rank{dist.get_rank()}"


def _spill_snapshot() -> Optional[int]:
    """Bytes the installed spill framework has demoted so far (device ->
    host plus host -> disk), or None without one."""
    from ..mem import spill as spill_mod

    fw = spill_mod.get_framework()
    if fw is None:
        return None
    m = fw.metrics.snapshot()
    return m["device_to_host_bytes"] + m["host_to_disk_bytes"]


def _spilled_since(base: Optional[int]) -> int:
    after = _spill_snapshot()
    return 0 if base is None or after is None else after - base


def _schema_like(batch: ColumnBatch) -> ColumnBatch:
    """``batch``'s schema over zero-row leaves of the same dtypes: a
    template that holds none of its device memory."""
    return rebatch(batch, [x.new_empty((0,) + tuple(x.shape[1:]))
                           for x in batch_leaves(batch)])


# ---------------------------------------------------------------------------
# the compressed wire
# ---------------------------------------------------------------------------
#
# A wire plan has one spec per batch_leaves leaf: None (ships raw),
# ("bit", 1, None) for a bool leaf, or ("for", w, ref) for an integer
# leaf sent as bit-packed residuals over ref at width w.

_BIT = ("bit", 1, None)


def _pack_plan(batch: ColumnBatch, dicts, mode: str, mesh):
    """The wire plan of ``batch``'s leaves, or None.  ``pack`` packs every
    non-empty 1-D bool and integer leaf whose observed range (widened to
    cover 0, over all ranks) packs narrower than its dtype; ``auto`` only
    the bools and code words of an exchange that carries dictionaries
    (a plain exchange keeps the raw wire)."""
    if mode == "off" or (mode == "auto" and not dicts):
        return None
    plan, ranged = [], []
    for name, col in zip(batch.names, batch.columns):
        leaves = column_leaves(col)
        for i, leaf in enumerate(leaves):
            sp = None
            if leaf.dim() == 1 and leaf.numel():
                if leaf.dtype == torch.bool:
                    sp = _BIT
                elif not leaf.is_floating_point() and (
                        mode == "pack" or (name in dicts and i == 0)):
                    sp = "range"
                    ranged.append(leaf)
            plan.append(sp)
    if ranged:
        # every rank must pick the same widths: the all-reduce of each
        # leaf's (~lo, hi) gives the global range (~ keeps int64 min safe)
        stats = torch.stack([torch.stack([~leaf.min().to(torch.int64),
                                          leaf.max().to(torch.int64)])
                             for leaf in ranged]).reshape(1, -1)
        stats = mesh.all_reduce(stats, "max").reshape(-1).cpu().tolist()
        widths = iter([(~stats[2 * j], stats[2 * j + 1])
                       for j in range(len(ranged))])
        leaves = iter(ranged)
        for k, sp in enumerate(plan):
            if sp != "range":
                continue
            lo, hi = next(widths)
            leaf = next(leaves)
            lo, hi = min(lo, 0), max(hi, 0)
            w = choose_pack_width(lo, hi)
            plan[k] = (("for", w, lo)
                       if w is not None and w < 8 * leaf.element_size()
                       else None)
    return tuple(plan) if any(plan) else None


def _bool_plan(like_leaves) -> Optional[tuple]:
    """The stream's wire plan: its bool leaves only."""
    plan = tuple(_BIT if x.dim() == 1 and x.numel() and
                 x.dtype == torch.bool else None for x in like_leaves)
    return plan if any(plan) else None


def _plan_saved_bytes(plan, like_leaves, P: int, C: int) -> int:
    """Wire bytes one packed round chunk saves against the raw grid, the
    occupancy mask (always width 1 beside a plan) included."""
    if plan is None:
        return 0
    rows = P * P * C

    def lanes_nbytes(w):
        return P * P * ((C * w + 31) // 32) * 4

    saved = rows - lanes_nbytes(1)
    for sp, leaf in zip(plan, like_leaves):
        if sp is not None:
            saved += rows * leaf.element_size() - lanes_nbytes(sp[1])
    return max(int(saved), 0)


def _pack_leaf(x: torch.Tensor, sp, rows: int) -> torch.Tensor:
    """One send-grid leaf as packed lane rows (``rows`` streams)."""
    _kind, w, ref = sp
    words = x.to(torch.int64)
    if ref:
        words = words - ref
    return pack_bits_rows(words.reshape(rows, -1), w)


def _unpack_leaf(lanes: torch.Tensor, sp, like: torch.Tensor, C: int):
    """Inverse of :func:`_pack_leaf` into ``like``'s dtype."""
    _kind, w, ref = sp
    words = unpack_bits_rows(lanes, w, C).reshape(-1)
    if like.dtype == torch.bool:
        return words.to(torch.bool)
    return (words + ref if ref else words).to(like.dtype)


def _send_packed(mesh, tree: ColumnBatch, idx, occ, plan, C: int):
    """:func:`~..parallel.collectives.send_rows` with a wire plan: the
    send grid is gathered, each planned leaf packed per (sender,
    destination) row and every leaf sent through the mesh's all-to-all.
    Returns the received (still packed) leaves and occupancy lanes."""
    sent = gather_batch(tree, idx, valid=occ)
    rows = occ.shape[0] // C
    out = [mesh.all_to_all(x if sp is None else _pack_leaf(x, sp, rows))
           for x, sp in zip(batch_leaves(sent), plan)]
    return out, mesh.all_to_all(_pack_leaf(occ, _BIT, rows))


def _unpack_chunk(leaves, occ, plan, like_leaves, C: int):
    """The one unpack point: a received chunk's lanes back to leaves and
    occupancy, right before reassembly."""
    if plan is None:
        return list(leaves), occ
    out = [x if sp is None else _unpack_leaf(x, sp, lk, C)
           for x, sp, lk in zip(leaves, plan, like_leaves)]
    return out, unpack_bits_rows(occ, 1, C).reshape(-1).to(torch.bool)


def _occ_rows(occ: torch.Tensor, packed: bool) -> torch.Tensor:
    """Received rows of a chunk's occupancy (lanes when packed)."""
    if not packed:
        return occ.sum()
    return unpack_bits_rows(occ, 1, 32 * occ.shape[1]).sum()


def _decode_runs_and_packs(batch: ColumnBatch) -> ColumnBatch:
    enc = (RunLengthColumn,) + PACKED_COLUMNS
    if not any(isinstance(c, enc) for c in batch.columns):
        return batch
    return ColumnBatch({n: c.decode() if isinstance(c, enc) else c
                        for n, c in zip(batch.names, batch.columns)})


def _dict_nbytes(dicts) -> int:
    """Bytes of the dictionaries an exchange rebinds once."""
    total = 0
    for _name, (canon, dictionary, _dt, _tok) in sorted(dicts.items()):
        total += tree_nbytes([canon] + column_leaves(dictionary))
    return total


class ShuffleService:
    """Lossless multi-round exchange over a
    :class:`~..parallel.mesh.ShardMesh` or a
    :class:`~..parallel.mesh.ProcessMesh`.  Stateless apart from the
    shared :class:`ShuffleRegistry` (one per process)."""

    def __init__(self, mesh, registry: Optional[ShuffleRegistry] = None):
        self.mesh = mesh
        self.registry = registry or get_registry()

    # -- public API -----------------------------------------------------
    def exchange(self, batch: ColumnBatch,
                 key_names: Optional[Sequence[str]] = None, pid=None,
                 row_valid=None, ctx=None, round_rows: Optional[int] = None,
                 strict: Optional[bool] = None,
                 store_key: Optional[str] = None) -> ShuffleResult:
        """Exchange ``batch`` rows so partition p's rows land on shard p.

        Route by ``key_names`` (Spark-exact ``pmod(murmur3(keys, 42),
        P)``; rows where ``row_valid`` is False route nowhere) or by a
        caller-supplied ``pid`` (int32 per row; P = padding).
        Out-of-range ids raise :class:`ShuffleError` when ``strict``
        (default: the ``shuffle_strict_pids`` knob), else they go to the
        null partition and are counted in ``oob_rows``.  ``ctx`` (a
        ``TaskContext``) charges the map output and the round chunks to
        the task's arena; under pressure idle ones spill.

        ``store_key`` is the exchange's durable identity in the
        persistent store (:mod:`.store`): a caller-stable string under
        which the map output and every drained round are committed
        best-effort, and from which a later run of the same exchange
        adopts the map output instead of running the map.  None (or no
        installed store) disables the durable tier.
        """
        if (key_names is None) == (pid is None):
            raise ValueError("pass exactly one of key_names / pid")
        compress = _resolve_compress()
        if strict is None:
            strict = bool(config.get("shuffle_strict_pids"))
        mesh = self.mesh
        P, L = mesh.size, mesh.local_shards
        R = mesh.shard_rows(batch.num_rows)
        store = store_mod.get_store() if store_key is not None else None

        # 0. encoded columns: runs and packed lanes decode; dictionary
        # columns cross as codes (a key on one routes by its values)
        batch = _decode_runs_and_packs(batch)
        dicts = {}
        if any(isinstance(c, DictionaryColumn) for c in batch.columns):
            if key_names is not None and any(
                    isinstance(batch[k], DictionaryColumn)
                    for k in key_names):
                pid = _key_pid(batch, key_names, row_valid, P)
                key_names = None
            batch, dicts = detach_dictionaries(batch)
        batch_leaves(batch)  # every column can cross, or this raises
        sid = self.registry.begin_shuffle()
        spill_base = _spill_snapshot()

        # 1. map: regroup destination-major + the count matrix
        def run_map():
            if key_names is not None:
                return _map_keys(batch, key_names, row_valid, P, L)
            return _map_local(batch, pid, P, L)

        # the durable tier first: a prior attempt's committed map output
        # is adopted instead of running the map; a store whose every
        # attempt fails verification has quarantined them, and the map
        # runs below, counted as a lineage rebuild
        map_name = _shard_name(mesh, "map")
        adopted = None
        if store is not None and store.has_committed(store_key, map_name):
            adopted = store.adopt(store_key, map_name, mesh.device)
            if adopted is not None:
                self.registry.metrics.record_adopted()
            else:
                self.registry.metrics.record_lineage_rebuild()
        if adopted is not None:
            regrouped, counts, oob = adopted
        else:
            regrouped, counts, oob = run_map()
            if store is not None:
                # best effort: a torn, fenced or failed put returns False
                # and the exchange goes on from memory
                store.put(store_key, map_name, (regrouped, counts, oob))
        del adopted
        counts_np, oob_total = _host_counts(counts, oob, P, mesh)
        if oob_total and strict:
            raise ShuffleError(
                f"shuffle {sid}: {oob_total} out-of-range partition ids "
                f"(strict mode; ids must lie in [0, {P}])")

        # 2. plan: static (rounds, capacity) from the exact counts, and
        # which leaves cross bit-packed
        plan = plan_rounds(counts_np, round_rows=round_rows)
        C = plan.capacity
        like = _schema_like(regrouped)
        like_leaves = batch_leaves(like)
        wire = _pack_plan(regrouped, dicts, compress, mesh)
        saved_per_chunk = _plan_saved_bytes(wire, like_leaves, P, C)
        # packed chunks commit under their own shard name: a raw run never
        # adopts lane words, nor a packed one raw leaves
        round_tag = "roundp" if wire is not None else "round"

        # lineage: each buffer's recompute= re-runs only what made it,
        # metered against the exchange's recovery budget
        recovered = [0]
        lineage = self._lineage_factory(sid, recovered)

        def adopt_map():
            # the stored shard carries the oob count too; the buffer
            # holds (regrouped, counts)
            t = store.adopt(store_key, map_name, mesh.device)
            return None if t is None else (t[0], t[1])

        # 3. drain round r: slots [r*C, (r+1)*C) of every bucket; the map
        # output is fetched (promoted if it was evicted) and pinned per
        # round, and no reference to it outlives the round
        map_buf = PartitionBuffer(
            (regrouped, counts), ctx=ctx, name=f"shuffle{sid}-map",
            recompute=lineage(lambda: run_map()[:2], "map output",
                              adopt=adopt_map if store is not None
                              else None))
        del regrouped
        dev = counts.device
        offsets = torch.cumsum(counts, 1) - counts
        shard0 = (torch.arange(L, dtype=torch.int64, device=dev)
                  * R)[:, None, None]
        slot = torch.arange(C, dtype=torch.int64, device=dev)

        def drive(r):
            k = r * C + slot
            occ = k < counts[:, :, None]               # [L, P_d, C]
            src = (offsets[:, :, None] + k).clamp(0, max(R - 1, 0))
            idx = (src + shard0).reshape(-1)
            with map_buf.pinned():
                tree = map_buf.get()[0]
                if wire is None:
                    out, occ_t = send_rows(mesh, tree, idx, occ.reshape(-1))
                    return batch_leaves(out), occ_t
                return _send_packed(mesh, tree, idx, occ.reshape(-1),
                                    wire, C)

        def redrive(r):
            # round r depends only on the map output and the static plan:
            # rebuilding it re-runs ONE round (which may recover the map
            # output first)
            def rebuild():
                if not mesh.holds_all:
                    raise ShuffleError(
                        f"shuffle {sid}: round {r} chunk lost and no "
                        "committed copy; a rank cannot re-drive a round "
                        "(a collective) alone")
                return drive(r)
            return rebuild

        def adopt_round(name):
            return lambda: store.adopt(store_key, name, mesh.device)

        lane = get_drain_lane()
        overlapped = [0]

        def rounds():
            # depth 1 on the shared lane: round r+1 is in flight on the
            # lane thread while round r's chunk is wrapped here.  With no
            # lane, one round, or ranks (each round a collective), the
            # rounds run one after another on this thread.
            if lane is None or plan.rounds <= 1 or not mesh.holds_all:
                for r in range(plan.rounds):
                    yield (r, *self._run_round(drive, r))
                return
            owner = getattr(ctx, "task_id", None)
            pending = []
            try:
                for r in range(plan.rounds):
                    pending.append((r, lane.submit(owner, _on_device(
                        dev, lambda rr=r: self._run_round(drive, rr)))))
                    if len(pending) == 2:
                        rr, fut = pending.pop(0)
                        overlapped[0] += 1
                        yield (rr, *fut.result())
                while pending:
                    rr, fut = pending.pop(0)
                    yield (rr, *fut.result())
            finally:
                # the consumer bailed: drop the queued rounds, and let a
                # running one finish before the map output closes (its
                # error, if any, yields to the consumer's own)
                for _, fut in pending:
                    if not fut.cancel():
                        fut.exception()

        chunks = []
        drained = rounds()
        try:
            received = torch.zeros((1,), dtype=torch.int64, device=dev)
            for r, out, occ_t in drained:
                name = _shard_name(mesh, f"{round_tag}-{r}")
                if store is not None:
                    store.put(store_key, name, (out, occ_t))
                received += _occ_rows(occ_t, wire is not None)
                chunks.append(PartitionBuffer(
                    (out, occ_t), ctx=ctx, name=f"shuffle{sid}-round{r}",
                    recompute=lineage(
                        redrive(r), f"round {r} chunk",
                        adopt=adopt_round(name) if store is not None
                        else None)))
                del out, occ_t
            # every shard's grids are the same size: the mesh moved P / L
            # times what this process holds
            bytes_moved = sum(c.nbytes for c in chunks) * P // L

            # 4. account + reassemble; the map output stays open until
            # the output is assembled (a chunk read back during assembly
            # may re-drive its round against it), and a chunk closes once
            # its rows have joined the output
            sent = int(counts_np.sum())
            got = int(mesh.all_reduce(received, "sum").item())
            residual = int(np.maximum(counts_np - plan.rounds * C, 0).sum())
            if residual != 0 or got != sent:
                self.registry.metrics.record_dropped(
                    max(sent - got, 0) + max(residual, 0))
                raise ShuffleError(
                    f"shuffle {sid}: lossless invariant violated "
                    f"(sent={sent} received={got} residual={residual})")
            parts = []
            for c in chunks:
                leaves, occ_v = _unpack_chunk(*c.get(), wire, like_leaves, C)
                c.close()
                parts.append(leaves + [occ_v])
            merged = _concat_rounds(parts, L)
            final_batch = rebatch(like, merged[:-1])
            final_occ = merged[-1]
        finally:
            drained.close()  # drops rounds still queued on the lane
            map_buf.close()
            for c in chunks:
                c.close()
        spilled = _spilled_since(spill_base)

        if dicts:
            # the dictionaries cross once, beside the rounds
            final_batch = reattach_dictionaries(final_batch, dicts)
            bytes_moved += _dict_nbytes(dicts)
        compressed_saved = saved_per_chunk * plan.rounds
        info = ShuffleInfo(
            shuffle_id=sid, rounds=plan.rounds, capacity=C,
            rows_moved=got, bytes_moved=bytes_moved, spilled_bytes=spilled,
            skew_ratio=plan.skew_ratio, oob_rows=oob_total,
            recovered_partitions=recovered[0],
            compressed_bytes_saved=compressed_saved)
        self.registry.record(info)
        return ShuffleResult(
            batch=final_batch, occupancy=final_occ, shuffle_id=sid,
            rounds=plan.rounds, capacity=C, rows_moved=got,
            bytes_moved=bytes_moved, skew_ratio=plan.skew_ratio,
            oob_rows=oob_total, spilled_bytes=spilled,
            recovered_partitions=recovered[0],
            rounds_overlapped=overlapped[0],
            compressed_bytes_saved=compressed_saved)

    def exchange_stream(self, morsels,
                        key_names: Optional[Sequence[str]] = None, ctx=None,
                        round_rows: Optional[int] = None,
                        strict: Optional[bool] = None,
                        store_key: Optional[str] = None) -> ShuffleResult:
        """Morsel-driven exchange: map and route ``morsels`` one at a
        time, draining earlier rounds while later morsels are still
        arriving — bit-identical on delivered rows to :meth:`exchange`
        over the same rows, without materializing the whole map output.

        ``morsels`` yields a morsel or (preferably) a zero-argument replay
        callable returning one (see :class:`~.morsel.MorselSource`); a
        morsel is a row-sharded ``ColumnBatch`` (a rank's own rows on a
        :class:`~..parallel.mesh.ProcessMesh`) or a ``(batch, aux)``
        pair where ``aux`` is the per-row validity (key mode) or the
        partition id array (pid mode, ``key_names=None``).  Encoded
        columns decode per morsel.  On ranks every rank must feed the
        same number of morsels.

        The round capacity is fixed up front and the round schedule is
        re-planned as morsel counts arrive: a round's chunk opens the
        moment a morsel first touches it, round ``r`` drains EARLY once
        every bucket's cumulative count clears ``(r+1) * capacity`` (no
        later morsel can touch it), and the round count is whatever the
        largest bucket needs.  Each morsel costs one host read of its
        count matrix and oob count (``sync_ms``; on ranks, after an
        all-gather of every rank's count row, so every rank plans the
        same drains).  ``ctx`` charges each morsel and round chunk to the
        task's arena; idle round chunks spill under pressure, and a
        scatter or drain pins the chunks it touches.  Replay callables
        are the stream's lineage: a lost or corrupt send chunk re-decodes
        and re-scatters its source morsels instead of holding a second
        copy.

        ``store_key`` commits every drained round (the stream's map
        output arrives morsel by morsel, so the committed grain is the
        received round): a later run of the same stream adopts each
        drained round instead of running its all-to-all.
        """
        compress = _resolve_compress()
        if strict is None:
            strict = bool(config.get("shuffle_strict_pids"))
        _resolve_scatter_engine()
        mesh = self.mesh
        P, L = mesh.size, mesh.local_shards
        if mesh.holds_all and L != P:
            raise ValueError("exchange_stream over one axis of a shard "
                             "mesh: stream each group's rows on its own "
                             "ShardMesh")
        first = 0 if mesh.holds_all else mesh.first_shard
        gather = None if mesh.holds_all else mesh
        sid = self.registry.begin_shuffle()
        spill_base = _spill_snapshot()
        C = plan_stream_capacity(round_rows=round_rows)
        store = store_mod.get_store() if store_key is not None else None
        recv_tag = "recv"
        recovered = [0]
        lineage = self._lineage_factory(sid, recovered)

        cum = np.zeros((P, P), np.int64)
        cum_dev = None        # the local shards' counts on the device
        send_chunks = {}
        # per round, every local scatter into it: (replay, base before it)
        contribs = {}
        recv = []
        like = scatter = wire = like_leaves = None
        saved_per_chunk = 0
        oob_total = 0
        n_morsels = scatters = rounds_overlapped = next_drain = 0
        decode_ms = drain_ms = sync_ms = 0.0

        def run_map(item):
            b, aux = item if isinstance(item, tuple) else (item, None)
            if any(is_encoded(c) for c in b.columns):
                b = materialize_batch(b)
            if key_names is not None:
                aux = _key_pid(b, key_names, aux, P)
            elif aux is None:
                raise ValueError("pid-mode streaming morsels must be "
                                 "(batch, pid) pairs")
            return (b,) + _route_count(aux, P, L)[:3]

        def morsel_leaves(replay):
            b, pid, _counts, _oob = run_map(replay())
            return [x.contiguous() for x in batch_leaves(b)], pid

        def empty_chunk(m_leaves):
            # L * P * C slots per leaf, sender-major then destination
            leaves = [torch.zeros((L * P * C,) + tuple(x.shape[1:]),
                                  dtype=x.dtype, device=x.device)
                      for x in m_leaves]
            occ = torch.zeros((L * P * C,), dtype=torch.bool,
                              device=m_leaves[0].device)
            return leaves, occ

        def rebuild_chunk(rr):
            # re-scatter every contribution recorded for round rr into a
            # fresh chunk, one kernel launch each; the chunk's tensors are
            # new, so the scatter opens the round again first
            def rebuild():
                leaves, occ = empty_chunk(like_leaves)
                scatter.open_round(rr, leaves, occ)
                try:
                    for replay, base in contribs[rr]:
                        m_leaves, m_pid = morsel_leaves(replay)
                        scatter(m_leaves, m_pid, base, rr, rr)
                finally:
                    scatter.release_round(rr)
                return leaves, occ
            return rebuild

        def open_chunk(rr, m_leaves):
            send_chunks[rr] = RoundChunk(
                empty_chunk(m_leaves), ctx=ctx, name=f"shuffle{sid}-send{rr}",
                recompute=lineage(rebuild_chunk(rr),
                                  f"round {rr} send chunk"))
            contribs[rr] = []

        def scatter_morsel(m_leaves, m_pid, lo, hi):
            # the rounds' chunks pinned and promoted, their tensors
            # (re)opened, one launch, then the references dropped so an
            # idle chunk can spill
            with contextlib.ExitStack() as pins:
                for rr in range(lo, hi + 1):
                    chunk = send_chunks[rr]
                    pins.enter_context(chunk.pinned())
                    scatter.open_round(rr, *chunk.get())
                scatter(m_leaves, m_pid, cum_dev, lo, hi)
                for rr in range(lo, hi + 1):
                    scatter.release_round(rr)

        def send(rr):
            chunk = send_chunks[rr]
            with chunk.pinned():
                leaves, occ = chunk.get()
                if wire is None:
                    return ([mesh.all_to_all(x) for x in leaves],
                            mesh.all_to_all(occ))
                rows = L * P
                return ([mesh.all_to_all(
                    x if sp is None else _pack_leaf(x, sp, rows))
                    for x, sp in zip(leaves, wire)],
                    mesh.all_to_all(_pack_leaf(occ, _BIT, rows)))

        def redrain(rr):
            def rebuild():
                if not mesh.holds_all:
                    raise ShuffleError(
                        f"shuffle {sid}: round {rr} received chunk lost "
                        "and no committed copy; a rank cannot re-drain a "
                        "round (a collective) alone")
                return send(rr)
            return rebuild

        def drain_round(rr):
            name = _shard_name(mesh, f"{recv_tag}-{rr}")
            adopted = (store.adopt(store_key, name, mesh.device)
                       if store is not None else None)
            if store is not None and not mesh.holds_all:
                # the all-to-all is collective: a round is adopted only
                # where every rank holds a verified copy
                miss = torch.tensor([int(adopted is None)],
                                    dtype=torch.int64, device=mesh.device)
                if int(mesh.all_reduce(miss, "max").item()):
                    adopted = None
            if adopted is not None:
                out, occ_t = adopted
                self.registry.metrics.record_adopted()
            else:
                out, occ_t = self._run_round(send, rr)
                if store is not None:
                    store.put(store_key, name, (out, occ_t))
            recv.append(PartitionBuffer(
                (out, occ_t), ctx=ctx, name=f"shuffle{sid}-recv{rr}",
                recompute=lineage(
                    redrain(rr), f"round {rr} chunk",
                    adopt=(lambda: store.adopt(store_key, name,
                                               mesh.device))
                    if store is not None else None)))
            # the send chunk stays open behind the received chunk's
            # lineage; no later morsel reaches its round
            scatter.close_round(rr)

        try:
            for item in morsels:
                replay = item if callable(item) else (lambda it=item: it)
                t0 = time.perf_counter()
                b, pid, counts, oob = run_map(replay())
                t1 = time.perf_counter()
                counts_np, oob_n = _host_counts(counts, oob, P, gather)
                t2 = time.perf_counter()
                decode_ms += (t2 - t0) * 1e3
                sync_ms += (t2 - t1) * 1e3
                oob_total += oob_n
                if oob_n and strict:
                    raise ShuffleError(
                        f"shuffle {sid}: {oob_n} out-of-range partition "
                        f"ids (strict mode; ids must lie in [0, {P}])")
                m_leaves = [x.contiguous() for x in batch_leaves(b)]
                if like is None:
                    like = _schema_like(b)
                    like_leaves = batch_leaves(like)
                    scatter = PartitionScatter(m_leaves, L, P, C)
                    cum_dev = torch.zeros((L, P), dtype=torch.int64,
                                          device=pid.device)
                    if compress == "pack":
                        wire = _bool_plan(m_leaves)
                        saved_per_chunk = _plan_saved_bytes(
                            wire, m_leaves, P, C)
                        if wire is not None:
                            recv_tag = "recvp"
                base = cum.copy()
                cum = cum + counts_np
                m_idx = n_morsels
                n_morsels += 1
                mbuf = MorselBuffer(
                    (m_leaves, pid), ctx=ctx,
                    name=f"shuffle{sid}-morsel{m_idx}",
                    recompute=lineage(lambda rp=replay: morsel_leaves(rp),
                                      f"morsel {m_idx} map output"))
                del b
                try:
                    with mbuf.pinned():
                        m_leaves, m_pid = mbuf.get()
                        if m_idx == 0:
                            # round 0 always exists: an all-empty stream
                            # still drains one schema-bearing empty round
                            open_chunk(0, m_leaves)
                        nz = counts_np > 0
                        if nz.any():
                            r_lo = int((base[nz] // C).min())
                            r_hi = int(((cum[nz] - 1) // C).max())
                            for rr in range(r_lo, r_hi + 1):
                                if rr not in send_chunks:
                                    open_chunk(rr, m_leaves)
                            mine = counts_np[first:first + L] > 0
                            if mine.any():
                                # this process's rows: one launch for every
                                # round they touch; cum_dev is their base
                                m_lo = int((base[first:first + L][mine]
                                            // C).min())
                                m_hi = int(((cum[first:first + L][mine] - 1)
                                            // C).max())
                                scatter_morsel(m_leaves, m_pid, m_lo, m_hi)
                                scatters += m_hi - m_lo + 1
                                base_dev = cum_dev.clone()
                                for rr in range(m_lo, m_hi + 1):
                                    contribs[rr].append((replay, base_dev))
                            cum_dev += counts
                finally:
                    mbuf.close()
                # early drain: rounds no future morsel can touch
                t0 = time.perf_counter()
                while (int(cum.min()) >= (next_drain + 1) * C
                       and next_drain in send_chunks):
                    drain_round(next_drain)
                    rounds_overlapped += 1
                    next_drain += 1
                drain_ms += (time.perf_counter() - t0) * 1e3

            if like is None:
                raise ValueError(
                    "exchange_stream needs at least one morsel (the "
                    "stream defines the output schema)")
            rounds = max(1, -(-int(cum.max()) // C))
            t0 = time.perf_counter()
            for rr in range(next_drain, rounds):
                drain_round(rr)
            drain_ms += (time.perf_counter() - t0) * 1e3

            sent = int(cum.sum())
            local = sum(_occ_rows(b.get()[1], wire is not None)
                        for b in recv)
            got = int(mesh.all_reduce(local.reshape(1), "sum").item())
            if got != sent:
                self.registry.metrics.record_dropped(abs(sent - got))
                raise ShuffleError(
                    f"shuffle {sid}: lossless invariant violated "
                    f"(sent={sent} received={got} rounds={rounds})")
            bytes_moved = sum(b.nbytes for b in recv) * P // L
            parts = []
            for b in recv:
                # the send chunks stay open behind the received chunks'
                # lineage until every received chunk has joined
                leaves, occ_v = _unpack_chunk(*b.get(), wire, like_leaves, C)
                b.close()
                parts.append(leaves + [occ_v])
            merged = _concat_rounds(parts, L)
            final_batch = rebatch(like, merged[:-1])
            final_occ = merged[-1]
        finally:
            for c in send_chunks.values():
                c.close()
            for b in recv:
                b.close()
        spilled = _spilled_since(spill_base)

        # the materialized planner over the FINAL counts supplies the skew
        # diagnostics; rounds/capacity record what actually ran
        plan = plan_rounds(cum, round_rows=round_rows)
        compressed_saved = saved_per_chunk * rounds
        # the source's one skip decision counts toward its first exchange
        # only (a reused source would count it again)
        blocks_skipped = int(getattr(morsels, "blocks_skipped", 0))
        blocks_scanned = int(getattr(morsels, "blocks_scanned", 0))
        if getattr(morsels, "_zone_counts_recorded", False):
            blocks_skipped = blocks_scanned = 0
        elif hasattr(morsels, "blocks_skipped"):
            morsels._zone_counts_recorded = True
        info = ShuffleInfo(
            shuffle_id=sid, rounds=rounds, capacity=C, rows_moved=got,
            bytes_moved=bytes_moved, spilled_bytes=spilled,
            skew_ratio=plan.skew_ratio, oob_rows=oob_total,
            recovered_partitions=recovered[0], streamed=True,
            morsels=n_morsels, rounds_overlapped=rounds_overlapped,
            decode_ms=decode_ms, drain_ms=drain_ms,
            compressed_bytes_saved=compressed_saved,
            blocks_skipped=blocks_skipped, blocks_scanned=blocks_scanned,
            scatters=scatters, sync_ms=sync_ms)
        self.registry.record(info)
        return ShuffleResult(
            batch=final_batch, occupancy=final_occ, shuffle_id=sid,
            rounds=rounds, capacity=C, rows_moved=got,
            bytes_moved=bytes_moved, skew_ratio=plan.skew_ratio,
            oob_rows=oob_total, spilled_bytes=spilled,
            recovered_partitions=recovered[0], streamed=True,
            morsels=n_morsels, rounds_overlapped=rounds_overlapped,
            decode_ms=decode_ms, drain_ms=drain_ms, scatters=scatters,
            sync_ms=sync_ms, compressed_bytes_saved=compressed_saved,
            blocks_skipped=blocks_skipped, blocks_scanned=blocks_scanned)

    # -- internals ------------------------------------------------------
    def _lineage_factory(self, sid: int, recovered):
        """The exchange's lineage wrapper: every restore draws on the
        shared ``shuffle_max_recoveries`` budget and is counted live
        (``recovered_partitions``).  ``adopt`` puts the durable tier under
        the rebuild through :func:`~.buffers.store_recompute`: a
        committed, verified store entry restores the buffer without
        re-running it (``adopted_shards``), a miss re-runs it
        (``lineage_rebuilds``)."""
        max_recoveries = int(config.get("shuffle_max_recoveries"))
        metrics = self.registry.metrics

        def lineage(rebuild, what, adopt=None):
            inner = store_recompute(adopt, rebuild,
                                    on_adopt=metrics.record_adopted,
                                    on_rebuild=metrics.record_lineage_rebuild)

            def run():
                if recovered[0] >= max_recoveries:
                    raise ShuffleError(
                        f"shuffle {sid}: {what} lost or corrupt and the "
                        f"recovery budget is exhausted (max_recoveries="
                        f"{max_recoveries}; see shuffle_max_recoveries)")
                recovered[0] += 1
                metrics.record_recovered()
                return inner()
            return run
        return lineage

    def _run_round(self, step, r: int):
        """One retryable round ``step(r)``: arena pressure runs the spill
        ladder, and a transport fault re-drives the round from the intact
        buffers up to ``_IO_RETRIES`` times, then raises."""
        def round_step():
            _io_probe()
            return step(r)

        for attempt in range(_IO_RETRIES + 1):
            try:
                return run_with_retry(round_step)
            except faultinj.ShuffleIOError:
                self.registry.metrics.record_io_failure()
                if attempt == _IO_RETRIES:
                    raise

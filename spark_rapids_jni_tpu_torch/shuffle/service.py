"""The exchange: map -> plan -> drain rounds -> reassemble.

Counterpart of ``spark_rapids_jni_tpu/shuffle/service.py`` over the
port's meshes (:mod:`..parallel.mesh`).  On a
:class:`~..parallel.mesh.ShardMesh` P row shards of one tensor stand in
for the reference's P devices, every per-device step runs over all shards
at once, and the reference's ``lax.all_to_all`` is a transpose of
``[P_s, P_d, C]`` to ``[P_d, P_s, C]``.  On a
:class:`~..parallel.mesh.ProcessMesh` each rank maps its own rows, an
all-gather of the count rows gives every rank the same ``[P, P]`` matrix
and so the same plan, and each round drains through
``all_to_all_single``.  Delivered arrays are bit-identical, shard for
shard, to the reference's on its P-device mesh.

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
* **scatter** (stream, shard mesh only): each morsel lands in its round
  chunks through the partition-scatter kernel
  (:class:`~..ops.kernels.PartitionScatter`, one launch per morsel for
  every round it touches and all shards; the kernel ranks each row
  within its (shard, destination) bucket itself).
* **drain + reassemble + account**: rows received must equal rows sent,
  else :class:`ShuffleError` — ``dropped == 0`` is an invariant.

Buffers are resident (:mod:`.buffers`); spill, task-context charging,
lineage recovery and the durable store are ROADMAP.md queue 1, item 13;
``shuffle_compress='pack'`` is item 12; the ``shuffle_io_round`` fault
probe is item 17.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .. import config
from .._roadmap import not_ported
from ..columnar.column import ColumnBatch
from ..ops.kernels import PartitionScatter
from ..parallel.collectives import _a2a, send_rows
from ..parallel.partition import spark_partition_id
from ..parallel.shuffle import bucket_counts, route_out_of_range
from ..relational.gather import gather_batch
from .buffers import MorselBuffer, PartitionBuffer, RoundChunk, \
    batch_leaves, rebatch
from .planner import plan_rounds, plan_stream_capacity
from .registry import ShuffleInfo, ShuffleRegistry, get_registry

class ShuffleError(RuntimeError):
    """Lossless-invariant violation or strict-mode partition id abuse."""


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
    streamed: bool = False          # produced by exchange_stream
    morsels: int = 0                # morsels mapped (streamed only)
    rounds_overlapped: int = 0      # rounds drained before end-of-stream
    decode_ms: float = 0.0          # cumulative morsel map time (host)
    drain_ms: float = 0.0           # cumulative round drain time (host)
    scatters: int = 0               # (morsel, round) scatters (streamed)
    sync_ms: float = 0.0            # host waits on the per-morsel counts


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
    if compress == "pack":
        raise not_ported("shuffle_compress='pack'", 12)
    return compress


def _no_ctx_store(ctx, store_key) -> None:
    if ctx is not None:
        raise not_ported("charging an exchange to a task context (ctx=)",
                         13)
    if store_key is not None:
        raise not_ported("the persistent shuffle store (store_key=)", 13)


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
        null partition and are counted in ``oob_rows``.
        """
        if (key_names is None) == (pid is None):
            raise ValueError("pass exactly one of key_names / pid")
        batch_leaves(batch)  # every column can cross, or not_ported
        _no_ctx_store(ctx, store_key)
        _resolve_compress()
        if strict is None:
            strict = bool(config.get("shuffle_strict_pids"))
        mesh = self.mesh
        P, L = mesh.size, mesh.local_shards
        R = mesh.shard_rows(batch.num_rows)
        sid = self.registry.begin_shuffle()

        # 1. map: regroup destination-major + the count matrix
        if key_names is not None:
            regrouped, counts, oob = _map_keys(batch, key_names, row_valid,
                                               P, L)
        else:
            regrouped, counts, oob = _map_local(batch, pid, P, L)
        counts_np, oob_total = _host_counts(counts, oob, P, mesh)
        if oob_total and strict:
            raise ShuffleError(
                f"shuffle {sid}: {oob_total} out-of-range partition ids "
                f"(strict mode; ids must lie in [0, {P}])")

        # 2. plan: static (rounds, capacity) from the exact counts
        plan = plan_rounds(counts_np, round_rows=round_rows)
        C = plan.capacity

        # 3. drain round r: slots [r*C, (r+1)*C) of every bucket
        map_buf = PartitionBuffer((regrouped, counts),
                                  name=f"shuffle{sid}-map")
        chunks = []
        try:
            tree, cnts = map_buf.get()
            dev = cnts.device
            offsets = torch.cumsum(cnts, 1) - cnts
            shard0 = (torch.arange(L, dtype=torch.int64, device=dev)
                      * R)[:, None, None]
            slot = torch.arange(C, dtype=torch.int64, device=dev)
            received = torch.zeros((1,), dtype=torch.int64, device=dev)
            for r in range(plan.rounds):
                k = r * C + slot
                occ = k < cnts[:, :, None]            # [L, P_d, C]
                src = (offsets[:, :, None] + k).clamp(0, max(R - 1, 0))
                out, occ_t = send_rows(mesh, tree,
                                       (src + shard0).reshape(-1),
                                       occ.reshape(-1))
                received += occ_t.sum()
                chunks.append(PartitionBuffer(
                    (out, occ_t), name=f"shuffle{sid}-round{r}"))
            # every shard's grids are the same size: the mesh moved P / L
            # times what this process holds
            bytes_moved = sum(c.nbytes for c in chunks) * P // L

            # 4. account + reassemble
            sent = int(counts_np.sum())
            got = int(mesh.all_reduce(received, "sum").item())
            residual = int(np.maximum(counts_np - plan.rounds * C, 0).sum())
            if residual != 0 or got != sent:
                self.registry.metrics.record_dropped(
                    max(sent - got, 0) + max(residual, 0))
                raise ShuffleError(
                    f"shuffle {sid}: lossless invariant violated "
                    f"(sent={sent} received={got} residual={residual})")
            parts = [batch_leaves(c.get()[0]) + [c.get()[1]]
                     for c in chunks]
            merged = _concat_rounds(parts, L)
            final_batch = rebatch(regrouped, merged[:-1])
            final_occ = merged[-1]
        finally:
            map_buf.close()
            for c in chunks:
                c.close()

        info = ShuffleInfo(
            shuffle_id=sid, rounds=plan.rounds, capacity=C,
            rows_moved=got, bytes_moved=bytes_moved, spilled_bytes=0,
            skew_ratio=plan.skew_ratio, oob_rows=oob_total)
        self.registry.record(info)
        return ShuffleResult(
            batch=final_batch, occupancy=final_occ, shuffle_id=sid,
            rounds=plan.rounds, capacity=C, rows_moved=got,
            bytes_moved=bytes_moved, skew_ratio=plan.skew_ratio,
            oob_rows=oob_total)

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
        morsel is a row-sharded ``ColumnBatch`` or a ``(batch, aux)``
        pair where ``aux`` is the per-row validity (key mode) or the
        partition id array (pid mode, ``key_names=None``).

        The round capacity is fixed up front and the round schedule is
        re-planned as morsel counts arrive: a round's chunk opens the
        moment a morsel first touches it, round ``r`` drains EARLY once
        every bucket's cumulative count clears ``(r+1) * capacity`` (no
        later morsel can touch it), and the round count is whatever the
        largest bucket needs.  Each morsel costs one host read of its
        count matrix and oob count (``sync_ms``), which the round
        schedule needs.
        """
        _no_ctx_store(ctx, store_key)
        if not self.mesh.holds_all:
            raise not_ported("exchange_stream over torch.distributed "
                             "ranks", 11)
        _resolve_compress()
        if strict is None:
            strict = bool(config.get("shuffle_strict_pids"))
        _resolve_scatter_engine()
        P = self.mesh.size
        sid = self.registry.begin_shuffle()
        C = plan_stream_capacity(round_rows=round_rows)

        cum = np.zeros((P, P), np.int64)
        cum_dev = None        # the same counts on the device: the base
        send_chunks = {}
        recv = []
        like = scatter = None
        oob_total = 0
        n_morsels = scatters = rounds_overlapped = next_drain = 0
        decode_ms = drain_ms = sync_ms = 0.0

        def run_map(item):
            b, aux = item if isinstance(item, tuple) else (item, None)
            if key_names is not None:
                aux = _key_pid(b, key_names, aux, P)
            elif aux is None:
                raise ValueError("pid-mode streaming morsels must be "
                                 "(batch, pid) pairs")
            return (b,) + _route_count(aux, P)[:3]

        def open_chunk(rr, m_leaves):
            # P * P * C slots per leaf, sender-major then destination
            leaves = [torch.zeros((P * P * C,) + tuple(x.shape[1:]),
                                  dtype=x.dtype, device=x.device)
                      for x in m_leaves]
            occ = torch.zeros((P * P * C,), dtype=torch.bool,
                              device=m_leaves[0].device)
            send_chunks[rr] = RoundChunk((leaves, occ),
                                         name=f"shuffle{sid}-send{rr}")
            scatter.open_round(rr, leaves, occ)

        def drain_round(rr):
            chunk = send_chunks[rr]
            leaves, occ = chunk.get()
            recv.append(PartitionBuffer(
                ([_a2a(x, P) for x in leaves], _a2a(occ, P)),
                name=f"shuffle{sid}-recv{rr}"))
            chunk.close()  # resident: nothing re-drives a drained round
            scatter.close_round(rr)

        try:
            for item in morsels:
                replay = item if callable(item) else (lambda it=item: it)
                t0 = time.perf_counter()
                b, pid, counts, oob = run_map(replay())
                t1 = time.perf_counter()
                counts_np, oob_n = _host_counts(counts, oob, P)
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
                    like = b
                    scatter = PartitionScatter(m_leaves, P, P, C)
                    cum_dev = torch.zeros((P, P), dtype=torch.int64,
                                          device=pid.device)
                base = cum.copy()
                cum = cum + counts_np
                m_idx = n_morsels
                n_morsels += 1
                mbuf = MorselBuffer((m_leaves, pid),
                                    name=f"shuffle{sid}-morsel{m_idx}")
                try:
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
                        # one launch for every round the morsel touches;
                        # cum_dev is this morsel's base until the add
                        scatter(m_leaves, m_pid, cum_dev, r_lo, r_hi)
                        cum_dev += counts
                        scatters += r_hi - r_lo + 1
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
            got = int(sum(b.get()[1].sum() for b in recv).item())
            if got != sent:
                self.registry.metrics.record_dropped(abs(sent - got))
                raise ShuffleError(
                    f"shuffle {sid}: lossless invariant violated "
                    f"(sent={sent} received={got} rounds={rounds})")
            bytes_moved = sum(b.nbytes for b in recv)
            merged = _concat_rounds(
                [list(b.get()[0]) + [b.get()[1]] for b in recv], P)
            final_batch = rebatch(like, merged[:-1])
            final_occ = merged[-1]
        finally:
            for c in send_chunks.values():
                c.close()
            for b in recv:
                b.close()

        # the materialized planner over the FINAL counts supplies the skew
        # diagnostics; rounds/capacity record what actually ran
        plan = plan_rounds(cum, round_rows=round_rows)
        info = ShuffleInfo(
            shuffle_id=sid, rounds=rounds, capacity=C, rows_moved=got,
            bytes_moved=bytes_moved, spilled_bytes=0,
            skew_ratio=plan.skew_ratio, oob_rows=oob_total, streamed=True,
            morsels=n_morsels, rounds_overlapped=rounds_overlapped,
            decode_ms=decode_ms, drain_ms=drain_ms, scatters=scatters,
            sync_ms=sync_ms)
        self.registry.record(info)
        return ShuffleResult(
            batch=final_batch, occupancy=final_occ, shuffle_id=sid,
            rounds=rounds, capacity=C, rows_moved=got,
            bytes_moved=bytes_moved, skew_ratio=plan.skew_ratio,
            oob_rows=oob_total, streamed=True,
            morsels=n_morsels, rounds_overlapped=rounds_overlapped,
            decode_ms=decode_ms, drain_ms=drain_ms, scatters=scatters,
            sync_ms=sync_ms)

"""The port's hand-written kernels, each beside its plain PyTorch version.

Counterpart of ``spark_rapids_jni_tpu/ops/pallas_kernels.py``, all four
kernels:

* :func:`onehot_groupby_columns` — the one-hot group-by over raw columns
  (bucket, counts, int sums mod 2^64, f32x3 float sums and the
  out-of-domain flag in one launch); :func:`onehot_groupby_parts` is the
  reference's contract entry over a built payload
  (``csrc/onehot_groupby.cu``);
* :func:`slot_table_build` — open-addressing insert in synchronous rounds,
  all of them in one cooperative launch (``csrc/slot_table.cu``);
* :func:`slot_table_records` — a built table's slot records (owner and
  its words, one record per slot) and chain bound, once per table;
  :func:`slot_table_probe_records` — the read-only chain walk over them,
  one thread per probe row; :func:`slot_table_probe` is the
  reference's contract entry, both in turn (``csrc/slot_table.cu``);
* :class:`PartitionScatter` — one morsel of the streaming exchange, in
  map order, into the send chunks of every round it touches, every shard
  in one launch (``csrc/partition_scatter.cu``); :func:`partition_scatter`
  is the reference's one-round form over a regrouped morsel, on the same
  kernel.

Each wrapper checks device, dtype, shape and contiguity.  Given CPU
tensors it runs the plain version in this module — the only reason a
wrapper ever runs one.  Given CUDA tensors it launches the kernel on the
current stream, raises if ``cudaGetLastError()`` reports a failed launch,
and adds one to its entry in :data:`launches`.  There is no fallback from
a CUDA tensor to a plain version.

The reference's VMEM size cutoff (``_SLOT_TABLE_MAX_BYTES``) is a TPU
limit and is not carried over: the CUDA tables live in device memory at
every size.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from .._u32 import M32, mul32, to_i32
from . import _build

# launches of each kernel since the last reset_launches(): one per
# wrapper call that went to the CUDA kernel ("onehot_groupby" is the fused
# group-by, "onehot_groupby_parts" the contract entry's payload kernel)
launches: Dict[str, int] = {"onehot_groupby": 0, "onehot_groupby_parts": 0,
                            "slot_table_build": 0, "slot_table_records": 0,
                            "slot_table_probe": 0, "partition_scatter": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "onehot_groupby": {
        "srj_onehot_groupby": (_I, [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I,
                                    _LL, _P]),
        "srj_onehot_smem_limit": (_I, []),
        "srj_onehot_max_block_rows": (_LL, []),
        "srj_onehot_columns": (_I, [_P, _I, _P, _P, ctypes.POINTER(_LL),
                                    ctypes.POINTER(_I), _I, _I, _I, _P, _P,
                                    _P, _LL, _I, _I, _I, _P]),
        "srj_onehot_error_string": (ctypes.c_char_p, [_I]),
    },
    "slot_table": {
        "srj_slot_build": (_I, [ctypes.POINTER(_LL), _I, _P, _P, _P, _P, _P,
                                _P, _P, _P, _I, _I, _I, _I, _P]),
        "srj_slot_records": (_I, [_P, ctypes.POINTER(_LL), _I, _P, _P, _I,
                                  _I, _P]),
        "srj_slot_probe_smem_limit": (_I, []),
        "srj_slot_probe": (_I, [ctypes.POINTER(_LL), _I, _P, _P, _P, _P, _P,
                                _LL, _I, _I, _I, _I, _I, _P]),
        "srj_slot_error_string": (ctypes.c_char_p, [_I]),
    },
    "partition_scatter": {
        "srj_partition_scatter": (_I, [ctypes.POINTER(_LL),
                                       ctypes.POINTER(_LL),
                                       ctypes.POINTER(_I), _I, _P, _P, _P,
                                       _I, _I, _LL, _I, _I, _I, _I, _P]),
        "srj_partition_scatter_error_string": (ctypes.c_char_p, [_I]),
    },
}
_bound: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib(name: str) -> ctypes.CDLL:
    lib = _bound.get(name)
    if lib is None:
        lib = _build.load(name)
        for fn, (res, args) in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.restype = res
            f.argtypes = args
        _bound[name] = lib
    return lib


def _check(rc: int, lib: ctypes.CDLL, errfn: str, what: str) -> None:
    if rc != 0:
        msg = getattr(lib, errfn)(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _dev_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else \
        torch.cuda.current_device()


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _on_cuda(tensors: Sequence[torch.Tensor], what: str) -> bool:
    """True when every tensor is on one CUDA device, False when all are
    on the CPU; anything else raises."""
    devs = {t.device for t in tensors}
    _require(len(devs) == 1, f"{what}: tensors on several devices {devs}")
    dev = devs.pop()
    _require(dev.type in ("cuda", "cpu"),
             f"{what}: unsupported device {dev}")
    return dev.type == "cuda"


# ---------------------------------------------------------------------------
# K1: one-hot group-by
# ---------------------------------------------------------------------------

def onehot_groupby_parts_plain(bucket, int_payload, float_payload,
                               domain: int):
    """Plain version of :func:`onehot_groupby_parts`: ``index_add_`` into
    int64 and float64 (torch's CPU ``int8 @ int8`` would wrap in int8)."""
    mi, mf = int_payload.shape[1], float_payload.shape[1]
    dev = bucket.device
    live = (bucket >= 0) & (bucket < domain)
    idx = bucket[live].to(torch.int64)
    oi = torch.zeros((domain, mi), dtype=torch.int64, device=dev)
    of = torch.zeros((domain, mf), dtype=torch.float64, device=dev)
    oi.index_add_(0, idx, int_payload[live].to(torch.int64))
    of.index_add_(0, idx, float_payload[live].to(torch.float64))
    return oi, of


def onehot_groupby_parts(bucket, int_payload, float_payload, domain: int):
    """Per-bucket column sums without a one-hot.

    ``bucket`` int32[n] in ``[0, domain)``, -1 for dead rows;
    ``int_payload`` int8[n, mi] with ``|x| <= 128``; ``float_payload``
    f32[n, mf].  Returns ``(int64[domain, mi], float64[domain, mf])``:
    int sums exact, float sums f32 per block of rows then f64.
    """
    what = "onehot_groupby_parts"
    domain = int(domain)
    _require(domain >= 1, f"{what}: domain must be >= 1")
    _require(bucket.dtype == torch.int32 and bucket.dim() == 1,
             f"{what}: bucket must be int32[n]")
    n = bucket.shape[0]
    _require(int_payload.dtype == torch.int8 and int_payload.dim() == 2
             and int_payload.shape[0] == n,
             f"{what}: int_payload must be int8[n, mi]")
    _require(float_payload.dtype == torch.float32
             and float_payload.dim() == 2 and float_payload.shape[0] == n,
             f"{what}: float_payload must be float32[n, mf]")
    if not _on_cuda([bucket, int_payload, float_payload], what):
        return onehot_groupby_parts_plain(bucket, int_payload,
                                          float_payload, domain)
    _require(bucket.is_contiguous() and int_payload.is_contiguous()
             and float_payload.is_contiguous(),
             f"{what}: inputs must be contiguous")
    mi, mf = int_payload.shape[1], float_payload.shape[1]
    dev = bucket.device
    oi = torch.zeros((domain, mi), dtype=torch.int64, device=dev)
    of = torch.zeros((domain, mf), dtype=torch.float64, device=dev)
    if n == 0 or mi + mf == 0:
        return oi, of
    lib = _lib("onehot_groupby")
    per_bucket = 4 * (mi + mf)
    dtile = min(domain, lib.srj_onehot_smem_limit() // per_bucket)
    _require(dtile >= 1, f"{what}: {mi + mf} payload columns exceed one "
             "block's shared memory")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # about four blocks per SM, each under the int32-exactness row limit
    rows_per_block = max(1024, -(-n // (4 * sms)))
    rows_per_block = min(rows_per_block, lib.srj_onehot_max_block_rows())
    with torch.cuda.device(dev):
        rc = lib.srj_onehot_groupby(
            bucket.data_ptr(), int_payload.data_ptr(),
            float_payload.data_ptr() if mf else None, oi.data_ptr(),
            of.data_ptr() if mf else None, n, mi, mf, domain, dtile,
            rows_per_block, _stream(bucket))
    _check(rc, lib, "srj_onehot_error_string", what)
    launches["onehot_groupby_parts"] += 1
    return oi, of


_ONEHOT_MAX_COLS = 16


def _dekker_limbs(v: torch.Tensor):
    """Exact 3-way split of f64 values into f32 (hi, mid, lo)."""
    hi = v.to(torch.float32)
    r1 = v - hi.to(torch.float64)
    mid = r1.to(torch.float32)
    lo = (r1 - mid.to(torch.float64)).to(torch.float32)
    return [hi, mid, lo]


def _int_sum_from_limbs(true_limb: torch.Tensor) -> torch.Tensor:
    """``sum_j true_limb[:, j] << 8j`` mod 2^64 in int64.  Each limb is
    masked to the bits that survive its shift first, so every shift is
    exact mod 2^64 and only the final adds wrap."""
    total = torch.zeros(true_limb.shape[:1], dtype=torch.int64,
                        device=true_limb.device)
    for j in range(8):
        x = true_limb[:, j]
        if j:
            x = x & ((1 << (64 - 8 * j)) - 1)
        total = total + (x << (8 * j))
    return total


def onehot_payload(key, key_valid, row_live, cols, int_sums, float_sums,
                   K: int):
    """The reference's one-hot payload over raw columns (the contract
    entry's input): ``(bucket, X8, F, overflow)``.

    ``bucket`` int32[n]: ``clamp(k, 0, K-1)`` for a live non-null key, K
    for a live null key, -1 for a dead row; ``X8`` int8[n, mi]: [0]
    count(*) ones, then each column of ``cols``' validity, then 8 offset
    byte limbs ``b - 128`` per int sum column; ``F`` f32[n, 3 nf]: the
    Dekker limbs of each float sum column; ``overflow``: a live non-null
    key outside ``[0, K)``.
    """
    n = key.shape[0]
    dev = key.device
    live = (torch.ones((n,), dtype=torch.bool, device=dev)
            if row_live is None else row_live)
    k = key.to(torch.int64)
    klive = key_valid & live
    overflow = (klive & ((k < 0) | (k >= K))).any()
    bucket = torch.where(klive, k.clamp(0, K - 1), torch.full_like(k, K))
    bucket = torch.where(live, bucket, torch.full_like(bucket, -1))
    cols8 = [torch.ones((n,), dtype=torch.int8, device=dev)]
    cols8 += [(v & live).to(torch.int8) for _, v in cols]
    for i in int_sums:
        data, valid = cols[i]
        vvalid = valid & live
        v = torch.where(vvalid, data.to(torch.int64), 0)
        for j in range(8):
            byte = (v >> (8 * j)) & 0xFF
            cols8.append(torch.where(vvalid, byte - 128,
                                     torch.zeros_like(byte)).to(torch.int8))
    X8 = torch.stack(cols8, dim=1).contiguous()
    limbs = []
    for i in float_sums:
        data, valid = cols[i]
        v = data.to(torch.float64)
        limbs.extend(_dekker_limbs(torch.where(valid & live, v,
                                               torch.zeros_like(v))))
    F = (torch.stack(limbs, dim=1).contiguous() if limbs else
         torch.zeros((n, 0), dtype=torch.float32, device=dev))
    return bucket.to(torch.int32), X8, F, overflow


def onehot_groupby_columns_plain(key, key_valid, row_live, cols, int_sums,
                                 float_sums, K: int):
    """Plain version of :func:`onehot_groupby_columns`: the reference's
    path — :func:`onehot_payload`, the per-bucket sums of the payload
    (:func:`onehot_groupby_parts_plain`), then each int sum rebuilt from
    its byte limbs."""
    bucket, X8, F, overflow = onehot_payload(key, key_valid, row_live, cols,
                                             int_sums, float_sums, K)
    part, fpart = onehot_groupby_parts_plain(bucket, X8, F, K + 1)
    nc = len(cols)
    ints = [part[:, :1 + nc]]
    for j, i in enumerate(int_sums):
        s = 1 + nc + 8 * j
        true_limb = part[:, s:s + 8] + 128 * part[:, 1 + i:2 + i]
        ints.append(_int_sum_from_limbs(true_limb)[:, None])
    return torch.cat(ints, dim=1), fpart, overflow


def onehot_groupby_columns(key, key_valid, row_live, cols, int_sums,
                           float_sums, K: int):
    """The one-hot group-by over raw columns, in one launch.

    ``key`` int32/int64[n] and ``key_valid`` bool[n]; ``row_live``
    bool[n] or None (every row live); ``cols``: ``(data, validity)`` of
    every referenced column, each counted where non-null; ``int_sums`` /
    ``float_sums``: indices into ``cols`` of the int (bool/int32/int64)
    and float (f64) sum columns; buckets ``[0, K]``, K the null key.
    Returns ``(ints int64[K+1, 1 + nc + ni], floats f64[K+1, 3 nf],
    overflow bool[])``: count(*), the non-null counts and the int sums
    mod 2^64, bit-identical to the reference's limb path; the hi, mid and
    lo limb sums of each float column (f32 per block, then f64: within
    rel 1e-5 of the sum of |x|); ``overflow`` True when a live non-null
    key falls outside ``[0, K)``.
    """
    what = "onehot_groupby_columns"
    K = int(K)
    _require(K >= 1, f"{what}: K must be >= 1")
    n = key.shape[0]
    _require(key.dtype in (torch.int32, torch.int64) and key.dim() == 1,
             f"{what}: key must be int32[n] or int64[n]")
    masks = [key_valid] + ([] if row_live is None else [row_live])
    masks += [v for _, v in cols]
    _require(all(m.dtype == torch.bool and m.shape == (n,) for m in masks),
             f"{what}: validity and row_live must be bool[n]")
    _require(len(cols) <= _ONEHOT_MAX_COLS,
             f"{what}: {len(cols)} columns exceed {_ONEHOT_MAX_COLS}")
    _require(all(0 <= i < len(cols) for i in list(int_sums)
                 + list(float_sums)), f"{what}: sum index out of range")
    for i in int_sums:
        _require(cols[i][0].dtype in (torch.bool, torch.int32, torch.int64)
                 and cols[i][0].shape == (n,),
                 f"{what}: int sum columns must be bool/int32/int64[n]")
    for i in float_sums:
        _require(cols[i][0].dtype == torch.float64
                 and cols[i][0].shape == (n,),
                 f"{what}: float sum columns must be float64[n]")
    tensors = [key] + masks + [cols[i][0] for i in list(int_sums)
                               + list(float_sums)]
    if not _on_cuda(tensors, what):
        return onehot_groupby_columns_plain(key, key_valid, row_live, cols,
                                            int_sums, float_sums, K)
    _require(all(t.is_contiguous() for t in tensors),
             f"{what}: inputs must be contiguous")
    _require(n < 1 << 31, f"{what}: n {n} too large for one launch")
    dev = key.device
    nc, ni, nf = len(cols), len(int_sums), len(float_sums)
    mi = 1 + nc + ni
    oi = torch.zeros((K + 1, mi), dtype=torch.int64, device=dev)
    of = torch.zeros((K + 1, 3 * nf), dtype=torch.float64, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    if n == 0:
        return oi, of, overflow
    lib = _lib("onehot_groupby")
    limit = lib.srj_onehot_smem_limit()
    per_bucket = 8 * ni + 4 * (1 + nc) + 12 * nf  # u64, u32 and f32 partials
    dtile = min(K + 1, limit // per_bucket)
    _require(dtile >= 1, f"{what}: {mi} int and {3 * nf} float partials "
             "exceed one block's shared memory")
    ptrs = (_LL * (nc + 2 * ni + 2 * nf))(
        *[v.data_ptr() for _, v in cols],
        *[cols[i][0].data_ptr() for i in int_sums],
        *[cols[i][1].data_ptr() for i in int_sums],
        *[cols[i][0].data_ptr() for i in float_sums],
        *[cols[i][1].data_ptr() for i in float_sums])
    ibytes = (_I * max(ni, 1))(*[cols[i][0].element_size()
                                 for i in int_sums])
    rc = lib.srj_onehot_columns(
        key.data_ptr(), key.element_size(), key_valid.data_ptr(),
        None if row_live is None else row_live.data_ptr(), ptrs, ibytes,
        nc, ni, nf, oi.data_ptr(), of.data_ptr(), overflow.data_ptr(), n, K,
        dtile, _dev_index(dev), _stream(key))
    _check(rc, lib, "srj_onehot_error_string", what)
    launches["onehot_groupby"] += 1
    return oi, of, overflow


# ---------------------------------------------------------------------------
# K2 / K3: slot table
# ---------------------------------------------------------------------------

_BUILD_MAX_WORDS = 32
_INT32_MAX = (1 << 31) - 1
_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619
_MIX1 = 0x7FEB352D
_MIX2 = 0x846CA68B


def fold_hash(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """u32 hash per row from u32 key words (int64 carrier): FNV-1a, then a
    lowbias32-style finalizer so every word reaches the low bits."""
    h = torch.full(words[0].shape, _FNV_OFFSET, dtype=torch.int64,
                   device=words[0].device)
    for w in words:
        h = mul32(h ^ w, _FNV_PRIME)
    h = h ^ (h >> 16)
    h = mul32(h, _MIX1)
    h = h ^ (h >> 15)
    h = mul32(h, _MIX2)
    return h ^ (h >> 16)


def _check_words(words, n, what):
    _require(len(words) >= 1, f"{what}: need at least one key word")
    for w in words:
        _require(w.dtype == torch.int64 and w.dim() == 1
                 and w.shape[0] == n,
                 f"{what}: key words must be int64[n] u32 lanes")


def slot_table_build_plain(words, live, num_slots: int, max_rounds: int):
    """Plain version of :func:`slot_table_build`: the reference's lax
    formulation, round by round."""
    n = words[0].shape[0]
    S = num_slots
    dev = words[0].device
    rowid = torch.arange(n, dtype=torch.int64, device=dev)
    cand = fold_hash(words) & (S - 1)
    slot = torch.full((n,), S, dtype=torch.int64, device=dev)
    active = live.to(torch.bool).clone()
    owner = torch.full((S,), n, dtype=torch.int64, device=dev)
    rnd = 0
    while rnd < max_rounds and bool(active.any()):
        claim = torch.where(active, rowid, torch.full_like(rowid, n))
        prop = torch.full((S,), n, dtype=torch.int64, device=dev)
        prop.scatter_reduce_(0, cand, claim, reduce="amin")
        owner = torch.where(owner == n, prop, owner)
        o = owner[cand].clamp(0, max(n - 1, 0))
        match = active.clone()
        for w in words:
            match &= w[o] == w
        slot = torch.where(match, cand, slot)
        active &= ~match
        cand = (cand + 1) & (S - 1)
        rnd += 1
    return (owner.to(torch.int32), slot.to(torch.int32), active.any())


def slot_table_build(words: Sequence[torch.Tensor], live: torch.Tensor,
                     num_slots: int, max_rounds: Optional[int] = None):
    """Insert rows keyed by ``words`` into an open-addressed slot table.

    ``words``: u32 key words (int64[n] each); ``live``: bool[n];
    ``num_slots``: a power of two.  Returns ``(owner int32[S], slot
    int32[n], overflow bool[])`` bit-identical to the reference's
    ``build_slot_table``: ``owner`` is the minimum live row id of each
    slot's key (``n`` where empty), ``slot`` is ``S`` for dead or
    unplaced rows, ``overflow`` is True when a live row did not place
    within ``max_rounds`` (default ``S``).
    """
    what = "slot_table_build"
    S = int(num_slots)
    _require(S >= 1 and S & (S - 1) == 0,
             f"num_slots must be a power of two, got {S}")
    n = words[0].shape[0] if words else 0
    _check_words(words, n, what)
    _require(live.dtype == torch.bool and live.shape == (n,),
             f"{what}: live must be bool[n]")
    mr = S if max_rounds is None else int(max_rounds)
    if not _on_cuda(list(words) + [live], what):
        return slot_table_build_plain(words, live, S, mr)
    dev = live.device
    if n == 0 or mr <= 0:  # nothing to place: no launch
        return (torch.full((S,), n, dtype=torch.int32, device=dev),
                torch.full((n,), S, dtype=torch.int32, device=dev),
                live.any())
    W = len(words)
    _require(W <= _BUILD_MAX_WORDS,
             f"{what}: {W} key words exceed the kernel's {_BUILD_MAX_WORDS}")
    _require(S <= 1 << 30 and n < 1 << 31,
             f"{what}: S {S} or n {n} too large for one launch")
    words = [w.contiguous() for w in words]
    live = live.contiguous()
    owner = torch.empty((S,), dtype=torch.int32, device=dev)
    slot = torch.empty((n,), dtype=torch.int32, device=dev)
    cand0 = torch.empty((n,), dtype=torch.int32, device=dev)
    worklists = torch.empty((2 * n,), dtype=torch.int32, device=dev)
    table = torch.empty((S,), dtype=torch.int64, device=dev)
    cnt = torch.empty((3,), dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    ptrs = (_LL * W)(*[w.data_ptr() for w in words])
    lib = _lib("slot_table")
    # one cooperative launch runs every round and stops on the device
    rc = lib.srj_slot_build(ptrs, W, live.data_ptr(), cand0.data_ptr(),
                            worklists.data_ptr(), slot.data_ptr(),
                            owner.data_ptr(), table.data_ptr(),
                            cnt.data_ptr(), overflow.data_ptr(), n, S,
                            min(mr, _INT32_MAX), _dev_index(dev),
                            _stream(live))
    _check(rc, lib, "srj_slot_error_string", what)
    launches["slot_table_build"] += 1
    return owner, slot, overflow


def _walk_plain(S: int, probe_words, live, rounds: int, step):
    """The reference's round-by-round chain walk.  ``step(cand)`` gives
    ``(empty, match)`` of each row's candidate slot; a row stops at an
    empty slot or its first match, or after ``rounds`` rounds."""
    m = probe_words[0].shape[0]
    dev = live.device
    cand = fold_hash(probe_words) & (S - 1)
    slot = torch.full((m,), S, dtype=torch.int64, device=dev)
    found = torch.zeros((m,), dtype=torch.bool, device=dev)
    active = live.to(torch.bool).clone()
    rnd = 0
    while rnd < rounds and bool(active.any()):
        empty, match = step(cand)
        hit = active & match
        slot = torch.where(hit, cand, slot)
        found |= hit
        active &= ~match & ~empty
        cand = (cand + 1) & (S - 1)
        rnd += 1
    return found, slot.to(torch.int32)


def slot_table_probe_plain(owner, build_words, probe_words, live,
                           max_rounds: int):
    """Plain version of :func:`slot_table_probe`: the reference's lax
    chain walk over ``owner`` and the build side's words."""
    S = owner.shape[0]
    n = build_words[0].shape[0]
    owner64 = owner.to(torch.int64)

    def step(cand):
        o = owner64[cand]
        empty = o == n
        oc = o.clamp(0, max(n - 1, 0))
        match = ~empty
        for bw, pw in zip(build_words, probe_words):
            if n:
                match &= bw[oc] == pw
        return empty, match

    return _walk_plain(S, probe_words, live, max_rounds, step)


_MAX_RUN = 1024  # csrc/slot_table.cu kMaxRun


def chain_bound(owner: torch.Tensor, n_build: int) -> int:
    """Exact probe-round bound of a built table: the longest circular run
    of occupied slots plus the empty slot that ends the walk, in
    ``[1, S]`` (``S`` when no slot is empty).  Any probe — hit or miss —
    ends within it, so it is result-identical to the full-table bound."""
    S = owner.shape[0]
    occ = owner != n_build
    occ2 = torch.cat([occ, occ])
    idx = torch.arange(2 * S, dtype=torch.int64, device=owner.device)
    last_empty = torch.cummax(torch.where(occ2, torch.full_like(idx, -1),
                                          idx), 0).values
    run = torch.where(occ2, idx - last_empty, torch.zeros_like(idx))
    longest = min(int(run.max().item()), S)
    return max(1, min(longest + 1, S))


class SlotRecords(NamedTuple):
    """A built table's probe side, from :func:`slot_table_records`.

    ``rec`` int32[S, W + 1]: per slot its owner's row id (``n_build``
    where empty), then the owner's W key words (u32 bits, 0 where empty);
    ``bound`` int32[1]: the walk's round bound, covering the longest
    chain (0 = S: no slot is empty).
    """
    rec: torch.Tensor
    bound: torch.Tensor
    n_build: int
    W: int


def slot_table_records_plain(owner, build_words):
    """Plain version of :func:`slot_table_records`: gathers of the owners'
    words, and the bound from :func:`chain_bound` (S past a run of
    ``_MAX_RUN`` slots, 0 when no slot is empty, as the kernel has it)."""
    S = owner.shape[0]
    n = build_words[0].shape[0]
    W = len(build_words)
    dev = owner.device
    rec = torch.zeros((S, W + 1), dtype=torch.int32, device=dev)
    rec[:, 0] = owner
    if n:
        occ = owner != n
        oc = owner.to(torch.int64).clamp(0, n - 1)
        for j, w in enumerate(build_words):
            rec[:, 1 + j] = to_i32(torch.where(occ, w[oc], 0))
    if bool((owner == n).any()):
        b = chain_bound(owner, n)
        b = b if b <= _MAX_RUN else S
    else:
        b = 0
    return SlotRecords(rec, torch.tensor([b], dtype=torch.int32,
                                         device=dev), n, W)


def slot_table_records(owner: torch.Tensor, build_words) -> SlotRecords:
    """The probe side of a built table, in one launch: one record per
    slot (owner, its words; see :class:`SlotRecords`) and the table's
    chain bound.  Built once per table and kept with it, so a probe
    packs and gathers nothing."""
    what = "slot_table_records"
    S = owner.shape[0]
    _require(S >= 1 and S & (S - 1) == 0 and owner.dtype == torch.int32
             and owner.dim() == 1,
             f"{what}: owner must be int32[S], S a power of two")
    n = build_words[0].shape[0] if build_words else 0
    _check_words(build_words, n, what)
    if not _on_cuda([owner] + list(build_words), what):
        return slot_table_records_plain(owner, build_words)
    W = len(build_words)
    _require(W <= _BUILD_MAX_WORDS,
             f"{what}: {W} key words exceed the kernel's {_BUILD_MAX_WORDS}")
    _require(owner.is_contiguous() and all(w.is_contiguous()
                                           for w in build_words),
             f"{what}: inputs must be contiguous")
    dev = owner.device
    rec = torch.empty((S, W + 1), dtype=torch.int32, device=dev)
    bound = torch.zeros((1,), dtype=torch.int32, device=dev)
    ptrs = (_LL * W)(*[w.data_ptr() for w in build_words])
    lib = _lib("slot_table")
    with torch.cuda.device(dev):
        rc = lib.srj_slot_records(owner.data_ptr(), ptrs, W, rec.data_ptr(),
                                  bound.data_ptr(), S, n, _stream(owner))
    _check(rc, lib, "srj_slot_error_string", what)
    launches["slot_table_records"] += 1
    return SlotRecords(rec, bound, n, W)


def slot_table_probe_records_plain(recs: SlotRecords, probe_words, live,
                                   max_rounds: int):
    """Plain version of :func:`slot_table_probe_records`: the reference's
    round-by-round walk, over the records, to ``min(max_rounds, bound)``
    rounds."""
    rec, n = recs.rec, recs.n_build
    S = rec.shape[0]
    b = int(recs.bound[0].item())
    owner64 = rec[:, 0].to(torch.int64)

    def step(cand):
        empty = owner64[cand] == n
        match = ~empty
        for j, pw in enumerate(probe_words):
            match &= (rec[cand, 1 + j].to(torch.int64) & M32) == pw
        return empty, match

    return _walk_plain(S, probe_words, live, min(int(max_rounds), b or S),
                       step)


def slot_table_probe_records(recs: SlotRecords, probe_words,
                             live: torch.Tensor,
                             max_rounds: Optional[int] = None):
    """Look probe rows' keys up in a table's slot records, in one launch.

    ``probe_words``: the probe side's u32 words (int64[m] each, as
    carried); ``live`` bool[m].  Returns ``(found bool[m], slot
    int32[m])``, bit-identical to the reference's ``probe_slot_table``
    with ``max_rounds`` (default ``S``): the walk runs to
    ``min(max_rounds, recs.bound)`` rounds, and the bound covers the
    longest chain.  One thread walks one probe row; a table whose records
    fit the kernel's shared-memory limit is walked from shared memory.
    """
    what = "slot_table_probe"
    rec = recs.rec
    S = rec.shape[0]
    W = recs.W
    _require(len(probe_words) == W,
             f"{what}: build/probe key arity mismatch")
    m = probe_words[0].shape[0]
    _check_words(probe_words, m, what)
    _require(live.dtype == torch.bool and live.shape == (m,),
             f"{what}: live must be bool[m]")
    mr = S if max_rounds is None else int(max_rounds)
    if not _on_cuda([rec, recs.bound, live] + list(probe_words), what):
        return slot_table_probe_records_plain(recs, probe_words, live, mr)
    _require(m < 1 << 31, f"{what}: m {m} too large for one launch")
    _require(all(t.is_contiguous() for t in [rec, live] + list(probe_words)),
             f"{what}: inputs must be contiguous")
    dev = rec.device
    found = torch.empty((m,), dtype=torch.bool, device=dev)
    slot = torch.empty((m,), dtype=torch.int32, device=dev)
    if m == 0:
        return found, slot
    lib = _lib("slot_table")
    smem = S * (W + 1) * 4 <= lib.srj_slot_probe_smem_limit()
    ptrs = (_LL * W)(*[w.data_ptr() for w in probe_words])
    rc = lib.srj_slot_probe(ptrs, W, live.data_ptr(), rec.data_ptr(),
                            recs.bound.data_ptr(), found.data_ptr(),
                            slot.data_ptr(), m, S, recs.n_build,
                            min(max(mr, 0), _INT32_MAX), int(smem),
                            _dev_index(dev), _stream(live))
    _check(rc, lib, "srj_slot_error_string", what)
    launches["slot_table_probe"] += 1
    return found, slot


def slot_table_probe(owner: torch.Tensor, build_words, probe_words,
                     live: torch.Tensor, max_rounds: Optional[int] = None):
    """Look probe rows' keys up in a built slot table — the reference's
    contract entry.

    ``owner`` int32[S] from :func:`slot_table_build` (sentinel = number of
    build rows); ``build_words`` / ``probe_words`` u32 words of the two
    sides; ``live`` bool[m].  Returns ``(found bool[m], slot int32[m])``
    bit-identical to the reference's ``probe_slot_table`` for the same
    ``max_rounds`` (default ``S``; any bound covering the longest chain,
    e.g. :func:`chain_bound`, gives the same bits).  It builds the
    table's records (:func:`slot_table_records`) and probes them
    (:func:`slot_table_probe_records`); a caller that probes one table
    more than once keeps the records instead.
    """
    what = "slot_table_probe"
    _require(len(build_words) == len(probe_words),
             f"{what}: build/probe key arity mismatch")
    m = probe_words[0].shape[0]
    _check_words(probe_words, m, what)
    _require(live.dtype == torch.bool and live.shape == (m,),
             f"{what}: live must be bool[m]")
    recs = slot_table_records(owner, build_words)
    return slot_table_probe_records(recs, probe_words, live, max_rounds)


# ---------------------------------------------------------------------------
# K4: partition scatter
# ---------------------------------------------------------------------------

_SCATTER_MAX_LEAVES = 64
_SCATTER_MAX_PARTITIONS = 2048


def partition_scatter_plain(chunk_leaves, occ, morsel_leaves, cnts, base,
                            rnd: int, P: int, C: int):
    """Plain version of :func:`partition_scatter`: the reference's lax
    formulation (searchsorted for the destination, then an index_put that
    drops rows outside round ``rnd``), over all shards at once."""
    S = cnts.shape[0]
    M = morsel_leaves[0].shape[0] // S if S and morsel_leaves else 0
    if M == 0:
        return chunk_leaves, occ
    dev = occ.device
    c64 = cnts.to(torch.int64)
    ends = torch.cumsum(c64, 1)
    offs = ends - c64
    i = torch.arange(M, dtype=torch.int64, device=dev)
    d = torch.searchsorted(ends, i.expand(S, M).contiguous(), right=True)
    d_c = d.clamp(max=P - 1)
    k = base.to(torch.int64).gather(1, d_c) + i - offs.gather(1, d_c)
    r0 = int(rnd) * C
    keep = (d < P) & (k >= r0) & (k < r0 + C)
    s_idx = torch.arange(S, dtype=torch.int64, device=dev)[:, None]
    t = ((s_idx * P + d_c) * C + (k - r0))[keep]
    src = (s_idx * M + i)[keep]
    for ch, mo in zip(chunk_leaves, morsel_leaves):
        ch[t] = mo[src]
    occ[t] = True
    return chunk_leaves, occ


def partition_scatter_mapped_plain(rounds, morsel_leaves, pid, base,
                                   P: int, C: int):
    """Plain version of :class:`PartitionScatter`: a stable sort on
    ``(shard, pid)`` ranks each row within its bucket, then an index_put
    per round.  ``rounds`` maps a round to its ``(chunk_leaves, occ)``;
    rows whose round is not in it are not written."""
    S = base.shape[0]
    rows = pid.shape[0]
    M = rows // S
    if M == 0 or not rounds:
        return rounds
    dev = pid.device
    p = pid.to(torch.int64).reshape(S, M)
    live = (p >= 0) & (p < P)
    d = torch.where(live, p, torch.full_like(p, P))
    s_idx = torch.arange(S, dtype=torch.int64, device=dev)[:, None]
    key = (s_idx * (P + 1) + d).reshape(-1)
    perm = torch.sort(key, stable=True).indices
    sk = key[perm]
    rank = torch.empty_like(key)
    rank[perm] = torch.arange(rows, dtype=torch.int64, device=dev) - \
        torch.searchsorted(sk, sk)
    d_c = d.clamp(max=P - 1)
    k = base.to(torch.int64).gather(1, d_c) + rank.reshape(S, M)
    src = s_idx * M + torch.arange(M, dtype=torch.int64, device=dev)
    for r, (leaves, occ) in rounds.items():
        keep = live & (k // C == r)
        t = ((s_idx * P + d_c) * C + (k - r * C))[keep]
        for ch, mo in zip(leaves, morsel_leaves):
            ch[t] = mo[src[keep]]
        occ[t] = True
    return rounds


class PartitionScatter:
    """The map-order partition scatter of one stream: each morsel, as the
    map step leaves it, goes into the send chunks of every round it
    touches in ONE launch (``csrc/partition_scatter.cu``), for all S
    shards.

    Built once per stream from the first morsel's leaves (``S * M`` rows
    each, shard-major): the leaves' dtypes, row shapes, row and element
    sizes, the device and its current stream are fixed here.
    :meth:`open_round` registers a round's chunk (``S * P * C`` rows per
    leaf plus ``occ``) and, on the card, writes its pointers once into a
    device table the kernel reads; a call then passes only the morsel's
    pointers, its ``pid`` and ``base``.

    Row ``i`` of shard ``s`` with ``d = pid[s*M + i]`` in ``[0, P)`` goes
    to ``k = base[s, d] + rank``, ``rank`` its stable position among the
    shard's rows of destination ``d``: round ``k // C``, slot ``(s*P +
    d)*C + k % C``, ``occ`` set.  ``d == P`` rows (dead, padding, out of
    range) drop.  The chunks are bit-identical to regrouping each shard
    destination-major and running the reference's ``partition_scatter``
    once per round.
    """

    def __init__(self, like_leaves: Sequence[torch.Tensor], S: int, P: int,
                 C: int):
        what = "partition_scatter"
        self.S, self.P, self.C = int(S), int(P), int(C)
        _require(self.S >= 1 and self.P >= 1 and self.C >= 1,
                 f"{what}: need S >= 1, P >= 1, C >= 1")
        n = len(like_leaves)
        _require(1 <= n <= _SCATTER_MAX_LEAVES,
                 f"{what}: {n} leaves; the kernel takes 1 to "
                 f"{_SCATTER_MAX_LEAVES}")
        _require(self.P <= _SCATTER_MAX_PARTITIONS,
                 f"{what}: P {self.P} exceeds the kernel's "
                 f"{_SCATTER_MAX_PARTITIONS}")
        self._kinds = [(t.dtype, tuple(t.shape[1:])) for t in like_leaves]
        self.device = like_leaves[0].device
        self.rounds: Dict[int, tuple] = {}
        self._cuda = _on_cuda(list(like_leaves), what)
        if self._cuda:
            self._row_b = (_LL * n)(*[t.element_size() * t.shape[1:].numel()
                                      for t in like_leaves])
            self._elem_b = (_I * n)(*[t.element_size() for t in like_leaves])
            self._leaf_p = (_LL * n)()
            # per round: every leaf's chunk pointer, then occ's
            self._dir = torch.zeros((8, n + 1), dtype=torch.int64,
                                    device=self.device)
            self._dev = _dev_index(self.device)
            self._stream = _stream(like_leaves[0])
            self._lib = _lib("partition_scatter")

    def open_round(self, rr: int, chunk_leaves, occ) -> None:
        what = "partition_scatter"
        rows = self.S * self.P * self.C
        _require(len(chunk_leaves) == len(self._kinds),
                 f"{what}: chunk and morsel leaf counts differ")
        _require(occ.dtype == torch.bool and occ.shape == (rows,),
                 f"{what}: occ must be bool[S * P * C]")
        for ch, (dt, shp) in zip(chunk_leaves, self._kinds):
            _require(ch.dtype == dt and tuple(ch.shape[1:]) == shp
                     and ch.shape[0] == rows,
                     f"{what}: leaf shapes/dtypes do not line up (chunk "
                     f"{tuple(ch.shape)} {ch.dtype}, morsel rows {shp} "
                     f"{dt})")
        tensors = list(chunk_leaves) + [occ]
        _require(all(t.device == self.device for t in tensors),
                 f"{what}: a chunk is not on {self.device}")
        self.rounds[int(rr)] = (list(chunk_leaves), occ)
        if self._cuda:
            _require(all(t.is_contiguous() for t in tensors),
                     f"{what}: chunks must be contiguous")
            cap = self._dir.shape[0]
            if rr >= cap:
                grown = torch.zeros((max(2 * cap, rr + 1),
                                     self._dir.shape[1]), dtype=torch.int64,
                                    device=self.device)
                grown[:cap] = self._dir
                self._dir = grown
            self._dir[rr] = torch.tensor([t.data_ptr() for t in tensors],
                                         dtype=torch.int64)

    def close_round(self, rr: int) -> None:
        """Forget a drained round (no later morsel can reach it)."""
        self.rounds.pop(int(rr), None)

    def __call__(self, morsel_leaves, pid: torch.Tensor, base: torch.Tensor,
                 r_lo: int, r_hi: int) -> None:
        """Scatter one morsel in map order into rounds ``r_lo..r_hi``
        (each open), IN PLACE.  ``pid`` int32[S*M] in ``[0, P]``;
        ``base`` int64[S, P], each bucket's rows before this morsel."""
        what = "partition_scatter"
        S, P = self.S, self.P
        rows = pid.shape[0]
        _require(pid.dtype == torch.int32 and pid.dim() == 1
                 and rows % S == 0,
                 f"{what}: pid must be int32[S * M]")
        _require(base.dtype == torch.int64 and base.shape == (S, P),
                 f"{what}: base must be int64[S, P]")
        _require(len(morsel_leaves) == len(self._kinds)
                 and all(t.shape[0] == rows and t.dtype == dt
                         and tuple(t.shape[1:]) == shp
                         for t, (dt, shp) in zip(morsel_leaves,
                                                 self._kinds)),
                 f"{what}: morsel leaves do not match the stream's")
        r_lo, r_hi = int(r_lo), int(r_hi)
        _require(0 <= r_lo <= r_hi
                 and all(r in self.rounds for r in range(r_lo, r_hi + 1)),
                 f"{what}: rounds {r_lo}..{r_hi} are not all open")
        tensors = list(morsel_leaves) + [pid, base]
        _require(all(t.device == self.device for t in tensors),
                 f"{what}: a tensor is not on {self.device}")
        if not self._cuda:
            partition_scatter_mapped_plain(
                {r: self.rounds[r] for r in range(r_lo, r_hi + 1)},
                morsel_leaves, pid, base, P, self.C)
            return
        _require(all(t.is_contiguous() for t in tensors),
                 f"{what}: inputs must be contiguous")
        M = rows // S
        _require(M < (1 << 31) and r_hi < (1 << 31),
                 f"{what}: M {M} or round {r_hi} too large for one launch")
        if M == 0:
            return
        for j, t in enumerate(morsel_leaves):
            self._leaf_p[j] = t.data_ptr()
        rc = self._lib.srj_partition_scatter(
            self._leaf_p, self._row_b, self._elem_b, len(self._kinds),
            pid.data_ptr(), base.data_ptr(), self._dir.data_ptr(), S, P,
            self.C, M, r_lo, r_hi, self._dev, self._stream)
        _check(rc, self._lib, "srj_partition_scatter_error_string", what)
        launches["partition_scatter"] += 1


def partition_scatter_mapped(rounds, morsel_leaves, pid, base, P: int,
                             C: int):
    """One-shot :class:`PartitionScatter`: ``rounds`` maps each round of
    a contiguous range to its ``(chunk_leaves, occ)``; the morsel's rows
    of those rounds are written IN PLACE.  Returns ``rounds``."""
    keys = sorted(rounds)
    _require(keys and keys == list(range(keys[0], keys[-1] + 1)),
             "partition_scatter: rounds must be a contiguous range")
    sc = PartitionScatter(morsel_leaves, base.shape[0], P, C)
    for r in keys:
        sc.open_round(r, *rounds[r])
    sc(morsel_leaves, pid, base, keys[0], keys[-1])
    return rounds


def partition_scatter(chunk_leaves, occ, morsel_leaves, cnts, base,
                      rnd: int, P: int, C: int):
    """Scatter one REGROUPED morsel into round ``rnd``'s send chunk, IN
    PLACE, for all S shards at once — the reference's form.

    ``morsel_leaves``: S * M rows each (shard-major; each shard's rows
    regrouped destination-major); ``cnts`` / ``base`` int32[S, P]: each
    shard's per-destination counts in this morsel and the cumulative
    counts before it; ``chunk_leaves``: S * P * C rows each (shard, then
    destination, then slot), dtypes and row shapes as the morsel's;
    ``occ`` bool[S * P * C].  Row ``i`` of shard ``s`` goes to partition
    ``d = #{cumsum(cnts[s]) <= i}`` at slot ``k = base[s, d] + i -
    offs[d]``, and is written when ``d < P`` and ``rnd*C <= k <
    (rnd+1)*C``.  Returns ``(chunk_leaves, occ)``, bit-identical to the
    reference's ``partition_scatter`` per shard.  On the card it runs the
    map-order kernel: ``d`` is the row's destination and ``i - offs[d]``
    its stable rank in the bucket.
    """
    what = "partition_scatter"
    P, C, rnd = int(P), int(C), int(rnd)
    _require(P >= 1 and C >= 1 and rnd >= 0,
             f"{what}: need P >= 1, C >= 1, rnd >= 0")
    _require(cnts.dtype == torch.int32 and cnts.dim() == 2
             and cnts.shape[1] == P,
             f"{what}: cnts must be int32[S, P]")
    _require(base.dtype == torch.int32 and base.shape == cnts.shape,
             f"{what}: base must be int32[S, P] like cnts")
    S = cnts.shape[0]
    _require(S >= 1, f"{what}: need at least one shard")
    _require(len(chunk_leaves) == len(morsel_leaves),
             f"{what}: chunk and morsel leaf counts differ")
    _require(occ.dtype == torch.bool and occ.shape == (S * P * C,),
             f"{what}: occ must be bool[S * P * C]")
    rows = morsel_leaves[0].shape[0] if morsel_leaves else 0
    _require(rows % S == 0, f"{what}: morsel rows {rows} not divisible "
             f"by {S} shards")
    for ch, mo in zip(chunk_leaves, morsel_leaves):
        _require(ch.dtype == mo.dtype and ch.shape[1:] == mo.shape[1:]
                 and ch.shape[0] == S * P * C and mo.shape[0] == rows,
                 f"{what}: leaf shapes/dtypes do not line up "
                 f"(chunk {tuple(ch.shape)} {ch.dtype}, morsel "
                 f"{tuple(mo.shape)} {mo.dtype})")
    tensors = [occ, cnts, base] + list(chunk_leaves) + list(morsel_leaves)
    if not _on_cuda(tensors, what):
        return partition_scatter_plain(chunk_leaves, occ, morsel_leaves,
                                       cnts, base, rnd, P, C)
    M = rows // S
    if M == 0:
        return chunk_leaves, occ
    ends = torch.cumsum(cnts.to(torch.int64), 1)
    i = torch.arange(M, dtype=torch.int64, device=occ.device)
    pid = torch.searchsorted(ends, i.expand(S, M).contiguous(), right=True)
    partition_scatter_mapped({rnd: (list(chunk_leaves), occ)},
                             list(morsel_leaves),
                             pid.to(torch.int32).reshape(-1),
                             base.to(torch.int64), P, C)
    return chunk_leaves, occ


__all__ = ["launches", "reset_launches", "fold_hash", "chain_bound",
           "onehot_payload", "onehot_groupby_columns",
           "onehot_groupby_columns_plain",
           "onehot_groupby_parts", "onehot_groupby_parts_plain",
           "slot_table_build", "slot_table_build_plain", "SlotRecords",
           "slot_table_records", "slot_table_records_plain",
           "slot_table_probe_records", "slot_table_probe_records_plain",
           "slot_table_probe", "slot_table_probe_plain",
           "partition_scatter", "partition_scatter_plain",
           "PartitionScatter", "partition_scatter_mapped",
           "partition_scatter_mapped_plain"]

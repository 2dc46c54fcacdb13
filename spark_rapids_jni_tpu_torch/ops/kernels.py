"""The port's hand-written kernels, each beside its plain PyTorch version.

Counterpart of ``spark_rapids_jni_tpu/ops/pallas_kernels.py`` for the three
kernels on the ported path:

* :func:`onehot_groupby_parts` — per-bucket column sums (the one-hot
  group-by, ``csrc/onehot_groupby.cu``);
* :func:`slot_table_build` — open-addressing insert in synchronous rounds
  (``csrc/slot_table.cu``);
* :func:`slot_table_probe` — read-only chain walk (``csrc/slot_table.cu``).

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
from typing import Dict, Optional, Sequence

import torch

from .._u32 import mul32, to_i32
from . import _build

# launches of each kernel since the last reset_launches(): one per
# wrapper call that went to the CUDA kernel
launches: Dict[str, int] = {"onehot_groupby": 0, "slot_table_build": 0,
                            "slot_table_probe": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "onehot_groupby": {
        "srj_onehot_groupby": (_I, [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I,
                                    _LL, _P]),
        "srj_onehot_smem_limit": (_I, []),
        "srj_onehot_max_block_rows": (_LL, []),
        "srj_onehot_error_string": (ctypes.c_char_p, [_I]),
    },
    "slot_table": {
        "srj_slot_init": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
        "srj_slot_round": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _P]),
        "srj_slot_probe": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _P]),
        "srj_slot_error_string": (ctypes.c_char_p, [_I]),
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
    launches["onehot_groupby"] += 1
    return oi, of


# ---------------------------------------------------------------------------
# K2 / K3: slot table
# ---------------------------------------------------------------------------

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
    owner = torch.full((S,), n, dtype=torch.int32, device=dev)
    slot = torch.full((n,), S, dtype=torch.int32, device=dev)
    if n == 0:
        return owner, slot, torch.zeros((), dtype=torch.bool, device=dev)
    if mr <= 0:
        return owner, slot, live.any()
    W = len(words)
    wstack = to_i32(torch.stack(list(words), dim=1)).contiguous()
    live_u8 = live.to(torch.uint8).contiguous()
    cand0 = torch.empty((n,), dtype=torch.int32, device=dev)
    active = torch.empty((n,), dtype=torch.uint8, device=dev)
    prop = torch.full((S,), n, dtype=torch.int32, device=dev)
    lib = _lib("slot_table")
    stream = _stream(live)
    with torch.cuda.device(dev):
        rc = lib.srj_slot_init(wstack.data_ptr(), live_u8.data_ptr(),
                               cand0.data_ptr(), active.data_ptr(),
                               slot.data_ptr(), n, W, S, stream)
        _check(rc, lib, "srj_slot_error_string", what)
        # rounds go out in growing chunks; the host reads the still-active
        # count after each chunk and stops once it is zero (a round with
        # no active row changes nothing: the overshoot is result-identical)
        r, chunk, left = 0, 2, 1
        while r < mr:
            k = min(chunk, mr - r)
            remaining = torch.zeros((k,), dtype=torch.int32, device=dev)
            for j in range(k):
                rc = lib.srj_slot_round(
                    wstack.data_ptr(), cand0.data_ptr(), active.data_ptr(),
                    slot.data_ptr(), owner.data_ptr(), prop.data_ptr(),
                    remaining.data_ptr() + 4 * j, n, W, S, r + j, stream)
                _check(rc, lib, "srj_slot_error_string", what)
            r += k
            left = int(remaining[k - 1].item())
            if left == 0:
                break
            chunk = min(2 * chunk, 32)
    launches["slot_table_build"] += 1
    return owner, slot, torch.tensor(left > 0, device=dev)


def slot_table_probe_plain(owner, build_words, probe_words, live,
                           max_rounds: int):
    """Plain version of :func:`slot_table_probe`: the reference's lax
    chain walk, round by round."""
    S = owner.shape[0]
    n = build_words[0].shape[0]
    m = probe_words[0].shape[0]
    dev = owner.device
    owner64 = owner.to(torch.int64)
    cand = fold_hash(probe_words) & (S - 1)
    slot = torch.full((m,), S, dtype=torch.int64, device=dev)
    found = torch.zeros((m,), dtype=torch.bool, device=dev)
    active = live.to(torch.bool).clone()
    rnd = 0
    while rnd < max_rounds and bool(active.any()):
        o = owner64[cand]
        empty = o == n
        oc = o.clamp(0, max(n - 1, 0))
        match = ~empty
        for bw, pw in zip(build_words, probe_words):
            if n:
                match &= bw[oc] == pw
        hit = active & match
        slot = torch.where(hit, cand, slot)
        found |= hit
        active &= ~match & ~empty
        cand = (cand + 1) & (S - 1)
        rnd += 1
    return found, slot.to(torch.int32)


def slot_table_probe(owner: torch.Tensor, build_words, probe_words,
                     live: torch.Tensor, max_rounds: Optional[int] = None):
    """Look probe rows' keys up in a built slot table.

    ``owner`` int32[S] from :func:`slot_table_build` (sentinel = number of
    build rows); ``build_words`` / ``probe_words`` u32 words of the two
    sides; ``live`` bool[m].  Returns ``(found bool[m], slot int32[m])``
    bit-identical to the reference's ``probe_slot_table`` for the same
    ``max_rounds`` (default ``S``; any bound covering the longest chain,
    e.g. :func:`relational.hashtable.chain_bound`, gives the same bits).
    The owners' key words are gathered once, ``[S, W]``, so each step of
    the in-kernel walk reads one slot's owner and words.
    """
    what = "slot_table_probe"
    S = owner.shape[0]
    _require(S >= 1 and S & (S - 1) == 0 and owner.dtype == torch.int32
             and owner.dim() == 1,
             f"{what}: owner must be int32[S], S a power of two")
    _require(len(build_words) == len(probe_words),
             f"{what}: build/probe key arity mismatch")
    n = build_words[0].shape[0]
    m = probe_words[0].shape[0]
    _check_words(build_words, n, what)
    _check_words(probe_words, m, what)
    _require(live.dtype == torch.bool and live.shape == (m,),
             f"{what}: live must be bool[m]")
    mr = S if max_rounds is None else int(max_rounds)
    if not _on_cuda([owner, live] + list(build_words) + list(probe_words),
                    what):
        return slot_table_probe_plain(owner, build_words, probe_words, live,
                                      mr)
    _require(owner.is_contiguous(), f"{what}: owner must be contiguous")
    dev = owner.device
    W = len(build_words)
    if n:
        oc = owner.to(torch.int64).clamp(0, n - 1)
        slotw = to_i32(torch.stack([w[oc] for w in build_words], dim=1))
    else:  # every slot is empty: all probes miss at their first step
        slotw = torch.zeros((S, W), dtype=torch.int32, device=dev)
    slotw = slotw.contiguous()
    pw = to_i32(torch.stack(list(probe_words), dim=1)).contiguous()
    live_u8 = live.to(torch.uint8).contiguous()
    found = torch.empty((m,), dtype=torch.uint8, device=dev)
    slot = torch.empty((m,), dtype=torch.int32, device=dev)
    if m == 0:
        return found.to(torch.bool), slot
    lib = _lib("slot_table")
    with torch.cuda.device(dev):
        rc = lib.srj_slot_probe(owner.data_ptr(), slotw.data_ptr(),
                                pw.data_ptr(), live_u8.data_ptr(),
                                found.data_ptr(), slot.data_ptr(), m, W, S,
                                n, max(mr, 0), _stream(owner))
    _check(rc, lib, "srj_slot_error_string", what)
    launches["slot_table_probe"] += 1
    return found.to(torch.bool), slot


__all__ = ["launches", "reset_launches", "fold_hash",
           "onehot_groupby_parts", "onehot_groupby_parts_plain",
           "slot_table_build", "slot_table_build_plain",
           "slot_table_probe", "slot_table_probe_plain"]

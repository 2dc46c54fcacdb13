"""The port's one carrier for u32 lanes: int64 tensors holding ``[0, 2**32)``.

torch's ``uint32`` cannot add, shift or ``scatter_reduce``, and int32
cannot shift right logically, which ``fold_hash``'s ``h >> 16`` needs.
So radix words and hashes are int64 values masked to 32 bits, and
products go through :func:`mul32`, which never leaves the int64 range.
Kernels take the low 32 bits as int32 (:func:`to_i32`) and read them as
``uint32_t``.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
SIGN32 = 0x80000000


def mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``(a * b) mod 2**32`` for u32 lanes ``a`` and a u32 constant ``b``,
    with every intermediate below 2**49 (no int64 overflow)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def to_i32(u: torch.Tensor) -> torch.Tensor:
    """u32 lanes (int64 carrier) -> int32 with the same 32 bits."""
    return torch.where(u >= SIGN32, u - (1 << 32), u).to(torch.int32)


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
          "Adaptive round bounds for the slot table: the build bound "
          "follows the load factor and the probe bound is the table's "
          "exact chain_bound.  Off = the historical constants.")


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


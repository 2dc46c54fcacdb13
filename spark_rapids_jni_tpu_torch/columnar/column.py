"""Fixed-width columns and column batches as torch tensors.

Counterpart of ``spark_rapids_jni_tpu/columnar/column.py`` for plain
fixed-width columns: ``data`` is a tensor of the type's torch dtype and
``validity`` a ``bool`` tensor, one lane per row, both on one device.
Like the reference, operators keep static shapes where it matters to
them: filters and joins return padded batches plus a live-row count.

:func:`batch_from_numpy` carries a batch across from host arrays — the
form a reference ``ColumnBatch`` takes after ``np.asarray`` on each
buffer — so the same data can be fed to both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from . import types as T


@dataclasses.dataclass
class Column:
    """Fixed-width column: ``data [n]`` + ``validity bool[n]``."""

    data: torch.Tensor
    validity: torch.Tensor
    dtype: T.SparkType

    @property
    def num_rows(self) -> int:
        return self.data.shape[0]

    def __repr__(self):
        return f"Column({self.dtype!r}, n={self.num_rows}, {self.data.device})"


class ColumnBatch:
    """An ordered, named collection of equal-length columns."""

    def __init__(self, columns: Mapping[str, Column]):
        names = tuple(columns.keys())
        cols = tuple(columns.values())
        if cols:
            n = cols[0].num_rows
            for name, c in zip(names, cols):
                if c.num_rows != n:
                    raise ValueError(
                        f"column {name!r} has {c.num_rows} rows, expected {n}")
        self._names = names
        self._cols = cols

    @property
    def names(self):
        return self._names

    @property
    def columns(self):
        return self._cols

    @property
    def num_rows(self) -> int:
        return self._cols[0].num_rows if self._cols else 0

    def __getitem__(self, name: str) -> Column:
        try:
            return self._cols[self._names.index(name)]
        except ValueError:
            raise KeyError(name) from None

    def select(self, names: Sequence[str]) -> "ColumnBatch":
        return ColumnBatch({n: self[n] for n in names})

    def __repr__(self):
        return f"ColumnBatch({list(self._names)}, n={self.num_rows})"


HostColumn = Tuple[np.ndarray, np.ndarray, Union[str, T.SparkType]]


def batch_from_numpy(cols: Mapping[str, HostColumn],
                     device: Optional[Union[str, torch.device]] = None
                     ) -> ColumnBatch:
    """Build a :class:`ColumnBatch` from ``{name: (data, validity, type)}``.

    ``type`` is a :class:`types.SparkType` or its name (``'int32'``,
    ``'int64'``, ``'float64'``, ``'boolean'``, ``'date'`` — the
    reference type's ``repr``).  ``device=None`` means the GPU; without
    one this raises unless ``device='cpu'`` is passed.
    """
    dev = resolve_device(device)
    out = {}
    for name, (data, validity, typ) in cols.items():
        st = typ if isinstance(typ, T.SparkType) else T.from_name(str(typ))
        # copies: the source may be a read-only view (a reference array)
        d = np.array(data, order="C")
        v = np.array(validity, dtype=np.bool_, order="C")
        if d.ndim != 1 or v.shape != d.shape:
            raise ValueError(f"column {name!r}: data {d.shape} and validity "
                             f"{v.shape} must be equal 1-D shapes")
        out[name] = Column(
            torch.from_numpy(d).to(device=dev, dtype=st.torch_dtype),
            torch.from_numpy(v).to(dev), st)
    return ColumnBatch(out)


def batch_to_numpy(batch: ColumnBatch) -> dict:
    """``{name: (data, validity)}`` host arrays (test and smoke helper)."""
    return {n: (c.data.cpu().numpy(), c.validity.cpu().numpy())
            for n, c in zip(batch.names, batch.columns)}

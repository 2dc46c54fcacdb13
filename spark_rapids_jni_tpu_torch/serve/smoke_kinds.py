"""Two query kinds for holding a fleet's answers against the parent's.

Loaded into every worker with ``FrontDoor(setup=
"spark_rapids_jni_tpu_torch.serve.smoke_kinds")`` (the worker's ``--setup``
hook):

* ``q6_result`` runs the same q6 steps as ``q6_digest`` and returns the
  live groups of every step as one column batch (a ``step`` column, then
  q6's result columns), which crosses the data plane as Arrow IPC; the
  caller holds it group by group against its own ``q6_step`` on the same
  seeds (:func:`step_groups`).  For a loss drill it may first wait
  ``pause_s`` (cancellable) and then cross the fault probe named by
  ``probe``;
* ``kernel_counts`` returns the worker's pid and its kernel wrappers'
  launch counts since it started.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import torch

from .. import faultinj
from .. import pipelines as PL
from ..columnar import types as T
from ..columnar.column import Column, ColumnBatch
from . import worker


def q6_result_batch(parts) -> ColumnBatch:
    """``[(step, result, num_groups), ...]`` -> one batch of every step's
    live groups, stacked, with a leading ``step`` column."""
    names = None
    cols: Dict[str, list] = {}
    steps = []
    for s, res, ng in parts:
        n = int(ng)
        names = names or list(res.names)
        steps.append(torch.full((n,), s, dtype=torch.int32,
                                device=res[names[0]].data.device))
        for name in names:
            c = res[name]
            cols.setdefault(name, []).append((c.data[:n], c.validity[:n],
                                              c.dtype))
    out = {"step": Column(torch.cat(steps),
                          torch.ones(sum(len(x) for x in steps),
                                     dtype=torch.bool,
                                     device=steps[0].device), T.INT32)}
    for name in names or ():
        parts_ = cols[name]
        out[name] = Column(torch.cat([p[0] for p in parts_]),
                           torch.cat([p[1] for p in parts_]), parts_[0][2])
    return ColumnBatch(out)


def step_groups(batch: ColumnBatch, key: str = "k") -> Dict[int, dict]:
    """A ``q6_result`` batch -> ``{step: {key value: {column: value}}}``,
    in :func:`..pipelines.result_groups`' form."""
    step = batch["step"].data.cpu().numpy()
    out: Dict[int, dict] = {}
    for s in sorted(set(step.tolist())):
        rows = torch.from_numpy((step == s).nonzero()[0])
        sub = ColumnBatch({
            n: Column(c.data.cpu()[rows], c.validity.cpu()[rows], c.dtype)
            for n, c in zip(batch.names, batch.columns) if n != "step"})
        out[int(s)] = PL.result_groups(sub, len(rows), key)
    return out


def _qk_q6_result(ctx, params, sess):
    end = time.monotonic() + float(params.get("pause_s", 0.0))
    while time.monotonic() < end:
        sess._check_cancelled()
        time.sleep(0.01)
    if params.get("probe"):
        faultinj.instrument(lambda: None, str(params["probe"]))()
    parts = []
    worker.run_q6(ctx, params, lambda s, res, ng: parts.append((s, res, ng)))
    return q6_result_batch(parts)


def _qk_kernel_counts(ctx, params, sess):
    from ..ops import kernels

    return {"pid": os.getpid(), "launches": dict(kernels.launches)}


def register_query_kinds(register):
    register("q6_result", _qk_q6_result)
    register("kernel_counts", _qk_kernel_counts)

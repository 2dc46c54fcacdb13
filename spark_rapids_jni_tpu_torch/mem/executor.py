"""Task-level execution against the memory arenas.

The reference's plugin drives this contract around every GPU operator
(``RmmSpark.java:402-416``): catch ``GpuRetryOOM`` → make inputs
spillable → ``blockThreadUntilReady`` → retry; catch
``GpuSplitAndRetryOOM`` → halve the input → retry.  This module makes the
same contract a first-class, testable piece of the framework:

* :class:`TaskContext` — registers the current thread for a task on the
  installed arena(s), charges the arena for the batches a step
  materializes, and releases on exit (the per-task device-memory
  accounting of SURVEY.md §2.6).
* :func:`run_with_retry` — the rollback/split ladder as a function.
* :func:`translate_device_oom` — a real ``torch.OutOfMemoryError`` from
  the CUDA caching allocator driven through the same ladder.
* :func:`batch_nbytes` — device footprint of a ColumnBatch or of nested
  columns and tensors.

The spill side of the reference's module (``Spillable``, the spill
store's default ``make_spillable`` and the handles a context adopts and
closes on exit) is ROADMAP item 13b; without it, a ``RetryOOM`` with no
``make_spillable`` parks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import traceback
from typing import Callable, Optional

import torch

from ..columnar.column import ColumnBatch, StructColumn
from .rmm_spark import (
    CpuRetryOOM,
    CpuSplitAndRetryOOM,
    InjectedException,
    RetryOOM,
    RmmSpark,
    SplitAndRetryOOM,
)


def _tensors(obj):
    """Every tensor reachable from ``obj``: a tensor, a dict, list or
    tuple, a :class:`ColumnBatch`, a :class:`StructColumn`, or any other
    column (plain, string, decimal, list, bucketed or encoded: each a
    dataclass of tensors and columns).  Host arrays are not counted."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(obj, ColumnBatch):
        yield from _tensors(obj.columns)
    elif isinstance(obj, StructColumn):
        yield obj.validity
        yield from _tensors(obj.children)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def batch_nbytes(tree) -> int:
    """Total device bytes of every DISTINCT tensor in ``tree``.  A tree
    that holds one tensor twice — a validity mask shared by columns, a
    column reused across struct fields — charges the arena once.

    The key is the tensor's own ``(data_ptr, nbytes)``, not its storage:
    a view shares its base's storage, so the two halves of a split batch
    each charge their own rows, not the whole buffer."""
    total = 0
    seen = set()
    for t in _tensors(tree):
        key = (t.data_ptr(), t.nbytes)
        if key in seen:
            continue
        seen.add(key)
        total += t.nbytes
    return total


_task_tls = threading.local()


def current_task_id() -> Optional[int]:
    """Task id of the innermost active :class:`TaskContext` on this
    thread, or None outside any context."""
    return getattr(_task_tls, "task_id", None)


class TaskContext:
    """``with TaskContext(task_id): ...`` — register + charge + release.

    ``charge(tree)`` draws the tree's byte footprint from the device
    arena (raising the OOM ladder under pressure) and remembers it;
    everything charged and not released is released when the context
    exits, and the task's thread association is dropped (``task_done``
    is the caller's call — a task spans many contexts across operators).
    """

    def __init__(self, task_id: int):
        self.task_id = task_id
        self._charged = 0
        self._lock = threading.Lock()
        self._prev_task_id = None

    def __enter__(self):
        RmmSpark.current_thread_is_dedicated_to_task(self.task_id)
        self._prev_task_id = getattr(_task_tls, "task_id", None)
        _task_tls.task_id = self.task_id
        return self

    def charge(self, tree_or_bytes) -> int:
        n = (tree_or_bytes if isinstance(tree_or_bytes, int)
             else batch_nbytes(tree_or_bytes))
        RmmSpark.allocate(n)
        with self._lock:
            self._charged += n
        return n

    def release(self, nbytes: int):
        RmmSpark.deallocate(nbytes)
        with self._lock:
            self._charged -= nbytes

    def __exit__(self, *exc):
        with self._lock:
            leftover, self._charged = self._charged, 0
        if leftover > 0:
            RmmSpark.deallocate(leftover)
        _task_tls.task_id = self._prev_task_id
        RmmSpark.remove_current_thread_association()
        return False


def is_device_oom(exc: BaseException) -> bool:
    """Is ``exc`` a REAL device allocation failure (the CUDA caching
    allocator's ``torch.OutOfMemoryError``), as opposed to the logical
    arena's OOM family?"""
    return isinstance(exc, torch.OutOfMemoryError)


def translate_device_oom(step: Callable) -> Callable:
    """Execute-boundary adapter: a real CUDA allocation failure inside
    ``step`` is routed through the native alloc-failure protocol (park,
    BUFN-escalate, split decision) and re-raised as the OOM family, so the
    :func:`run_with_retry` ladder treats genuine device-memory exhaustion
    exactly like logical arena pressure.  The reference gets this for
    free by interposing the allocator (SparkResourceAdaptorJni.cpp:
    1731-1798); PyTorch's caching allocator owns the physical buffers
    here, so the translation happens where the error surfaces.

    With no adaptor installed the raw error propagates unchanged.
    """

    @functools.wraps(step)
    def wrapped(*args, **kwargs):
        try:
            return step(*args, **kwargs)
        except Exception as e:
            if not is_device_oom(e) or RmmSpark._adaptor is None:
                raise
            try:
                RmmSpark.device_oom_observed()  # raises the OOM family
            except (MemoryError, InjectedException):
                raise  # RetryOOM/SplitAndRetryOOM/OOMError or injection
            except Exception:
                # protocol unavailable (e.g. thread never registered with
                # the adaptor): surface the REAL device error, not the
                # bookkeeping failure
                raise e
            raise  # pragma: no cover - device_oom_observed always raises

    return wrapped


def _drop_frames(exc: BaseException) -> BaseException:
    """Clear the locals of every finished frame in ``exc``'s traceback
    and in those of the exceptions it chains to.  A failed attempt's
    frames hold its tensors; kept alive by the ladder's last error, they
    would stand in the way of the retry on a real CUDA OOM."""
    seen = set()
    e = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        traceback.clear_frames(e.__traceback__)
        e = e.__cause__ or e.__context__
    return exc


def run_with_retry(
    step: Callable,
    make_spillable: Optional[Callable[[], None]] = None,
    split: Optional[Callable[[], None]] = None,
    max_retries: int = 8,
    cancel_check: Optional[Callable[[], None]] = None,
):
    """Execute ``step()`` under the reference's rollback ladder.

    * :class:`RetryOOM`: call ``make_spillable()`` (free/spill whatever the
      caller can), park in ``block_thread_until_ready`` until the scheduler
      releases this thread, then retry.  When ``make_spillable`` returns
      a truthy freed byte count the retry happens at once WITHOUT
      parking: this thread's own deallocations already fired the
      wake-ups, so parking after them risks waiting for a signal that was
      consumed before the wait began.  With no ``make_spillable`` the
      thread parks.
    * :class:`SplitAndRetryOOM`: call ``split()`` (the caller halves its
      input) and retry immediately — the scheduler guarantees this thread
      is the only one running.

    Real device OOMs (``torch.OutOfMemoryError``) are translated into the
    same ladder via :func:`translate_device_oom`.  Before parking or
    retrying, the failed attempt's frames are cleared, so its tensors go
    back to the caching allocator first.

    ``cancel_check`` (the serving runtime's kill hook) runs before every
    attempt; whatever it raises aborts the ladder immediately, so a
    tenant killed mid-retry never parks again on a dead task.

    Raises the last error when the ladder is exhausted.
    """
    step = translate_device_oom(step)
    last = None
    for _ in range(max_retries):
        if cancel_check is not None:
            cancel_check()
        try:
            result = step()
            if last is not None and RmmSpark._adaptor is not None:
                # the failure streak resolved: reset the adaptor's
                # consecutive-failure count (the 500-retry livelock
                # bound restarts per streak, not per thread lifetime)
                RmmSpark._adaptor.alloc_recovered()
            return result
        except SplitAndRetryOOM as e:
            last = _drop_frames(e)
            if split is None:
                raise
            split()
        except RetryOOM as e:
            last = _drop_frames(e)
            # spill-then-maybe-park, repeated when the PARK ITSELF raises
            # RetryOOM: that inner OOM is a fresh memory signal and must
            # run make_spillable again before the step retries (skipping
            # it would retry into the exact pressure that raised it)
            for _park_attempt in range(max_retries):
                oom = last
                freed = make_spillable() if make_spillable is not None \
                    else None
                if freed:
                    break
                # park on the arena that raised: Cpu* flavors block on
                # the host adaptor, device flavors on the device adaptor
                block = (RmmSpark.cpu_block_thread_until_ready
                         if isinstance(oom, (CpuRetryOOM,
                                             CpuSplitAndRetryOOM))
                         else RmmSpark.block_thread_until_ready)
                try:
                    block()
                    break
                except SplitAndRetryOOM as e2:
                    last = _drop_frames(e2)
                    if split is None:
                        raise
                    split()
                    break
                except RetryOOM as e2:
                    last = _drop_frames(e2)
            else:
                raise last
    raise last


@contextlib.contextmanager
def borrowed_task(task_id: int, shuffle: bool = False):
    """Register the calling thread as a pool thread working for
    ``task_id`` for the duration of the block — the serving runtime's
    shared drain lane brackets each shuffle round with this so the lane
    thread's arena charges are attributed (and deadlock-scanned) under
    the tenant that owns the round.  ``shuffle=True`` grants the
    reference's shuffle-thread priority (outranks every task thread in
    victim selection)."""
    if shuffle:
        RmmSpark.shuffle_thread_working_on_tasks([task_id])
    else:
        RmmSpark.pool_thread_working_on_tasks([task_id])
    prev = getattr(_task_tls, "task_id", None)
    _task_tls.task_id = task_id
    try:
        yield
    finally:
        _task_tls.task_id = prev
        RmmSpark.pool_thread_finished_for_tasks([task_id])

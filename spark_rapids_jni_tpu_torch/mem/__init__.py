"""Per-task memory-pressure scheduler (the SparkResourceAdaptor equivalent).

The native state machine lives in ``native/resource_adaptor.cpp`` (host
C++17, C ABI, built with ``g++`` at first use); this package is the host
facade mirroring the reference's Java surface (``RmmSpark.java``,
``SparkResourceAdaptor.java``, ``ThreadStateRegistry.java``, and the OOM
exception family):

* :class:`SparkResourceAdaptor` — owns the native handle, runs the 100ms
  deadlock watchdog daemon, and routes the native blocked-thread callback
  to :class:`ThreadStateRegistry`.
* :class:`RmmSpark` — the static task/thread registration +
  allocate/deallocate + OOM-injection + metrics API.
* :class:`RetryOOM` / :class:`SplitAndRetryOOM` / … — the exceptions the
  query engine catches to roll back, spill, and retry.
* :mod:`.executor` — :class:`TaskContext`, :func:`run_with_retry` and the
  translation of a real ``torch.OutOfMemoryError`` into the ladder.

The tiered spill store (``Spillable``, ``SpillableStore``,
``SpillFramework`` and their metrics) is ROADMAP item 13b.
"""

from .executor import (  # noqa: F401
    TaskContext,
    batch_nbytes,
    borrowed_task,
    current_task_id,
    is_device_oom,
    run_with_retry,
    translate_device_oom,
)
from .rmm_spark import (  # noqa: F401
    CpuRetryOOM,
    CpuSplitAndRetryOOM,
    InjectedException,
    OOMError,
    RetryOOM,
    RmmSpark,
    SparkResourceAdaptor,
    SplitAndRetryOOM,
    ThreadState,
    ThreadStateRegistry,
    UnknownThreadError,
)

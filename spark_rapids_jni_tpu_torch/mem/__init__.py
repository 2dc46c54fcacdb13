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
* :mod:`.spill` — the tiered spill store (the plugin-side
  SpillableDeviceStore/SpillableHostStore equivalent): a central
  registry with task-aware LRU eviction device -> host -> disk, a
  bounded host tier and per-transition spill metrics; :mod:`.codec`
  frames its disk leaves.
"""

from .executor import (  # noqa: F401
    Spillable,
    TaskContext,
    batch_nbytes,
    borrowed_task,
    current_task_id,
    is_device_oom,
    run_with_retry,
    translate_device_oom,
)
from .spill import (  # noqa: F401
    SpillableHandle,
    SpillableStore,
    SpillFramework,
    SpillMetrics,
    get_framework as get_spill_framework,
    install as install_spill_framework,
    shutdown as shutdown_spill_framework,
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

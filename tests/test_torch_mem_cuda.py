"""PyTorch port: the memory arena's retry ladder under a real CUDA OOM,
and the spill store's device tier on the card.

Needs an NVIDIA GPU (marker ``cuda``) and skips without one; the CPU
tests in ``test_torch_mem_adaptor.py`` and ``test_torch_spill.py`` hold
the arena and the spill store against the JAX package.  This file imports
no JAX (``tests/conftest.py`` does, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mem_cuda.py
"""

import pytest
import torch

from spark_rapids_jni_tpu_torch.mem import (
    RmmSpark, SpillableHandle, TaskContext, install_spill_framework,
    run_with_retry, shutdown_spill_framework)

pytestmark = pytest.mark.cuda
GiB = 1 << 30


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the real CUDA OOM and the "
                    "device memory a spill frees come from the CUDA caching "
                    "allocator (test_torch_mem_adaptor.py and "
                    "test_torch_spill.py cover the CPU side)")
    return torch.device("cuda")


def test_real_cuda_oom_drives_the_ladder(dev):
    """A step that allocates 2 GiB under a limit 1.5 GiB above what the
    process holds: the first attempt hits a real ``torch.OutOfMemoryError``,
    the native protocol sees it (retry metric), parks, is told to split,
    and the step re-runs on two 1 GiB halves."""
    total = torch.cuda.get_device_properties(dev).total_memory
    torch.cuda.empty_cache()
    limit = torch.cuda.memory_reserved(dev) + 3 * GiB // 2
    elems = 2 * GiB  # uint8: a reduction would add its own buffers
    state = {"parts": 1, "attempts": [], "ooms": 0}
    adaptor = RmmSpark.set_event_handler(total)
    try:
        torch.cuda.set_per_process_memory_fraction(limit / total)
        with TaskContext(31):
            def step():
                state["attempts"].append(state["parts"])
                out = 0
                try:
                    for _ in range(state["parts"]):
                        x = torch.ones(elems // state["parts"],
                                       dtype=torch.uint8, device=dev)
                        out += x.numel() * int(x[0]) * int(x[-1])
                        del x
                except torch.OutOfMemoryError:
                    state["ooms"] += 1
                    raise
                return out

            got = run_with_retry(
                step, split=lambda: state.__setitem__("parts",
                                                      state["parts"] * 2))
        RmmSpark.task_done(31)
        assert got == elems
        assert state["attempts"] == [1, 2] and state["ooms"] == 1
        assert adaptor.get_and_reset_num_retry(31) >= 1
        assert adaptor.get_and_reset_num_split_retry(31) >= 1
        assert adaptor.total_allocated() == 0
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        RmmSpark.clear_event_handler()
        torch.cuda.empty_cache()


def test_sync_pool_with_device_counts_cached_memory(dev):
    """The pool follows the card: free memory plus what the caching
    allocator holds unused, plus the arena's own charges."""
    RmmSpark.set_event_handler(1 << 20)
    try:
        x = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        del x  # kept in the caching allocator, not freed
        free, _ = torch.cuda.mem_get_info(dev)
        cached = (torch.cuda.memory_reserved(dev)
                  - torch.cuda.memory_allocated(dev))
        assert cached >= 256 << 20
        new_pool = RmmSpark.sync_pool_with_device()
        assert abs(new_pool - (free + cached)) <= 64 << 20
    finally:
        RmmSpark.clear_event_handler()
        torch.cuda.empty_cache()


def test_spill_frees_device_memory_and_get_restores_placement(dev,
                                                              tmp_path):
    """Spilling a handle that nothing else references lowers
    ``memory_allocated`` by its device bytes (through host to disk), and
    ``get()`` puts every leaf back on the device, dtype and shape it had;
    a CPU leaf in the same tree stays on the CPU."""
    fw = install_spill_framework(spill_dir=str(tmp_path))
    try:
        n = 1 << 22
        tree = {"a": torch.arange(n, dtype=torch.int64, device=dev),
                "b": (torch.arange(n, device=dev) % 3 == 0),
                "c": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
        cuda_bytes = n * 8 + n
        h = SpillableHandle(tree, name="card")
        del tree
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        h.spill()
        h.spill_host()
        assert h.tier == "disk"
        assert before - torch.cuda.memory_allocated(dev) >= cuda_bytes
        got = h.get()
        assert torch.cuda.memory_allocated(dev) - before >= 0
        idx = torch.cuda.current_device()
        for name, dt in (("a", torch.int64), ("b", torch.bool)):
            assert got[name].device == torch.device("cuda", idx)
            assert got[name].dtype == dt and got[name].shape == (n,)
        assert torch.equal(got["a"].cpu(), torch.arange(n))
        assert int(got["b"].sum()) == (n + 2) // 3
        assert got["c"].device.type == "cpu" and got["c"].shape == (2, 3)
        m = fw.metrics.snapshot()
        assert m["device_to_host_bytes"] == cuda_bytes + 24
        h.close()
    finally:
        shutdown_spill_framework()
        torch.cuda.empty_cache()

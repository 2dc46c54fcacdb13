"""spark_rapids_jni_tpu_torch — the PyTorch/CUDA port of ``spark_rapids_jni_tpu``.

The JAX package beside this one is the reference; this package does the
same work with PyTorch tensors on an NVIDIA Hopper GPU, and every Pallas
kernel of the reference on the ported path is a CUDA C++ kernel written
by hand for ``sm_90a`` (``csrc/``, built and bound by :mod:`ops._build`,
wrapped by :mod:`ops.kernels`).

Module names mirror the reference so each counterpart is easy to find
(``columnar/column.py``, ``relational/aggregate.py``, ...).  Inside, the
idiom is PyTorch's: plain functions on tensors that run eagerly on the
device their inputs live on.

Where code runs: entry points (:func:`pipelines.entry`, the data recipes,
:func:`columnar.column.batch_from_numpy`) run on ``cuda`` unless the caller
passes ``device="cpu"``, and raise when there is no GPU.  Nothing moves to
the CPU on its own.  On a CPU tensor a kernel wrapper runs the kernel's
plain PyTorch version — that is how the CPU tests exercise the arithmetic;
on a CUDA tensor it launches the kernel or raises.

u32 lanes (radix words, hashes) are carried as int64 tensors holding
values in ``[0, 2**32)``; kernels receive their low 32 bits as int32.

This package never imports ``jax`` or ``spark_rapids_jni_tpu``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]

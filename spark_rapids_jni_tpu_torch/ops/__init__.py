"""Kernels (CUDA C++ under ``csrc/``, wrapped in :mod:`.kernels`) and the
Spark-exact hash the partitioner needs (:mod:`.hashing`)."""

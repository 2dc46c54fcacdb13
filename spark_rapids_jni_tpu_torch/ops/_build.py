"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is a plain C interface compiled by ``nvcc`` into
``lib<name>.so`` for ``sm_90a`` and loaded with ``ctypes``; pointers come
from ``tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``, both passed as
``ctypes.c_void_p``.  Nothing includes PyTorch's headers, so a source
builds in seconds.

The build happens at first use, into ``_kernels_build/`` next to the
sources (listed in ``.gitignore``).  A library's file name carries a hash
of its source and flags, so an edited source rebuilds and a stale
library is never loaded.  A build that fails raises, with ``nvcc``'s
output in the message.

Host C++ sources with a C ABI (the memory arena's
``mem/native/resource_adaptor.cpp``) are built the same way with ``g++``
(:func:`load_host`): at first use, into ``_kernels_build/``, under a name
that carries the hash of the source and flags.  Several processes may
build one source at once (test workers), so each writes its own
temporary file and renames it into place.

The slot-table build's grid-wide barrier (``cooperative_groups`` grid
sync, launched with ``cudaLaunchCooperativeKernel``) and the partition
scatter's thread-block clusters need no ``-rdc=true`` and no
device-runtime link: the flags below build both (CUDA 12.8's ``nvcc``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_kernels_build")
SOURCES = ("onehot_groupby", "slot_table", "partition_scatter")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# nvcc's output (with -Xptxas -v: registers, shared memory and spills per
# kernel) of the builds this process ran, by source name
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ on a machine with the CUDA toolkit")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{tag[:16]}.so")


def _start(name: str, out: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    build_logs[name] = log
    tmp = f"{out}.{os.getpid()}.tmp"
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(rc={proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a reader never sees a half-written .so


def build_all(names=SOURCES) -> float:
    """Compile every missing library, one ``nvcc`` per source, all started
    together; returns the seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        pending = []
        for name in names:
            out = _lib_path(name)
            if not os.path.exists(out):
                pending.append((name, out, _start(name, out)))
        errors = []
        for name, out, proc in pending:
            try:
                _finish(name, out, proc)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_lib_path(name))
        return _libs[name]


HOST_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
HOST_LIBS = ("-lpthread",)


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the port's host libraries are "
                           "built from their C++ sources at first use")
    return found


def gxx_version() -> str:
    """First line of ``g++ --version``."""
    out = subprocess.run([_gxx(), "--version"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.splitlines()[0] if out.stdout else ""


def _host_lib_path(src: str) -> str:
    with open(src, "rb") as f:
        code = f.read()
    flags = " ".join(HOST_FLAGS + HOST_LIBS).encode()
    tag = hashlib.sha256(code + flags).hexdigest()
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{tag[:16]}.so")


def build_host(src: str) -> str:
    """Compile the host C++ source ``src`` into a shared library unless it
    is built already; returns the library's path.  A failed build raises
    with the compiler's output."""
    out = _host_lib_path(src)
    with _lock:
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.run([_gxx(), *HOST_FLAGS, "-o", tmp, src,
                                   *HOST_LIBS], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError(f"g++ failed on {src} "
                                   f"(rc={proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
    return out


def load_host(src: str) -> ctypes.CDLL:
    """The loaded library built from the host C++ source ``src``."""
    path = build_host(src)
    with _lock:
        if path not in _libs:
            _libs[path] = ctypes.CDLL(path)
        return _libs[path]

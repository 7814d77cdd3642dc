"""Build and load the hand-written CUDA kernels (no JAX counterpart).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``.  Builds happen at first use,
all sources at once (one ``nvcc`` process per source, started together), into
``pose2room_tpu_torch/_build/`` (listed in ``.gitignore``).  A library's file
name carries a hash of its source, the ``csrc/`` headers it includes and the
flags, so an edited source or header rebuilds.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.

``LAUNCHES`` counts kernel launches by name.  Each wrapper adds one right
after its launch, so a caller can zero the counts, drive a path and read
which kernels it went through.
"""

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("stgcn_epilogue", "fps", "stgcn_train_fwd", "stgcn_train_bwd", "stgcn_sparse", "stgcn_graph_gemm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = collections.Counter()

_libs = {}
_lock = threading.Lock()


def reset_launch_counts():
    LAUNCHES.clear()


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _source_files(name):
    """``csrc/<name>.cu`` and every header of ``csrc/`` it includes, directly
    or through another header (quoted includes), in a fixed order."""
    seen, todo = [], [f"{name}.cu"]
    while todo:
        rel = todo.pop(0)
        if rel in seen:
            continue
        seen.append(rel)
        with open(os.path.join(CSRC, rel), "rb") as f:
            found = _INCLUDE.findall(f.read())
        todo.extend(inc.decode() for inc in found
                    if os.path.isfile(os.path.join(CSRC, inc.decode())))
    return seen


def _lib_path(name):
    """The library's path; its name hashes the source, the headers it
    includes and the flags, so an edit to any of them rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for rel in _source_files(name):
        with open(os.path.join(CSRC, rel), "rb") as f:
            h.update(rel.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_all():
    """Compile every source whose library is missing, in parallel.

    Returns {name: ptxas report} for the libraries built by this call.
    Raises RuntimeError naming each source that failed to compile.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SOURCES:
        target = _lib_path(name)
        if os.path.isfile(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, target)
    reports, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
        reports[name] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name):
    """The ctypes handle of kernel library ``name``, building all if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.isfile(path):
                build_all()
            lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib


def timed_build():
    """Build every kernel library now; returns (seconds, ptxas reports)."""
    t0 = time.perf_counter()
    reports = build_all()
    for name in SOURCES:
        load(name)
    return time.perf_counter() - t0, reports


def check(err, name):
    """Raise if a launch reported a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def check_operands(name, expect, device, dtype=torch.float32, align=1):
    """Before a launch: each {what: (tensor, shape)} has that shape, is
    ``dtype``, contiguous, on ``device`` and starts on an ``align``-byte
    boundary; raises ValueError / TypeError."""
    for what, (t, shape) in expect.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {what} is {t.dtype}; the kernel takes {dtype}")
        if t.device != device:
            raise ValueError(f"{name}: {what} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} is not contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{name}: {what} does not start on a {align}-byte boundary")

"""ctypes binding of the host-side oriented-IoU kernel (native/iou.cpp).

Port of the IoU part of pose2room_tpu/native.py.  The framework-neutral
C++ source is built with ``g++`` at first use into
``pose2room_tpu_torch/_build/`` (the file name carries a hash of the source,
so an edited source rebuilds); where no compiler is present the numpy clipper
of ops/boxes.py computes the same matrix.  ``path()`` says which one runs.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from pose2room_tpu_torch.kernels import BUILD_DIR
from pose2room_tpu_torch.ops.boxes import box3d_iou_oriented

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native", "iou.cpp")

_lib = None
_tried = False
_lock = threading.Lock()


def _build():
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    target = os.path.join(BUILD_DIR, f"libp2r_native_{digest}.so")
    if not os.path.isfile(target):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{target}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", SRC, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, target)
    lib = ctypes.CDLL(target)
    ptr = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.oriented_iou_matrix.argtypes = [ptr, ctypes.c_int64, ptr, ctypes.c_int64, ptr]
    lib.oriented_iou_matrix.restype = None
    return lib


def _load():
    """The library, or None where it cannot be built (no g++, no source)."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _build()
            except (OSError, subprocess.CalledProcessError):
                _lib = None
        return _lib


def path():
    """'native' when the C++ library is loaded, else 'numpy'."""
    return "native" if _load() is not None else "numpy"


def oriented_iou_matrix(dets, gts):
    """(n, 8, 3) x (m, 8, 3) corner sets -> (n, m) float64 oriented 3D IoU."""
    dets = np.ascontiguousarray(dets, dtype=np.float64)
    gts = np.ascontiguousarray(gts, dtype=np.float64)
    lib = _load()
    if lib is None:
        return oriented_iou_matrix_numpy(dets, gts)
    out = np.zeros((len(dets), len(gts)), dtype=np.float64)
    lib.oriented_iou_matrix(dets, len(dets), gts, len(gts), out)
    return out


def oriented_iou_matrix_numpy(dets, gts):
    """The numpy path of ``oriented_iou_matrix``, whatever ``path()`` says."""
    dets = np.asarray(dets, dtype=np.float64)
    gts = np.asarray(gts, dtype=np.float64)
    return box3d_iou_oriented(dets[:, None], gts[None, :])[0]

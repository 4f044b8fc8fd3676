"""Host-native (C++) components, bound with ctypes (port of
``openglue_tpu/native``, whose ``nms.cpp`` this package carries a copy of).

The one native piece is the greedy radius NMS of the OpenCV feature
extractors (reference models/features/opencv/base.py:161-182), the hot loop
of dense detection. At its first use ``nms.cpp`` is compiled with
``g++ -O3 -shared -fPIC`` into ``build/native/`` beside the package, under a
name that hashes the source and the flags, so an edited source rebuilds and
an unchanged one is reused. Each process compiles to a file named by its pid
and moves it into place with ``os.replace``, so processes that build at once
never load a half-written library. A failed build or load raises with the
compiler's output; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "nms.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libopenglue_host-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path. Raises
    RuntimeError with the compiler's output when the build fails."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        result = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as err:
        raise RuntimeError(f"the host NMS cannot be built: {' '.join(cmd)}: {err}") from err
    if result.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build the host NMS ({' '.join(cmd)}):\n"
                           f"{result.stdout}{result.stderr}")
    os.replace(tmp, target)
    return target


def load() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.og_nms_radius.restype = ctypes.c_int
            lib.og_nms_radius.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int,
                ctypes.c_float,
                ctypes.POINTER(ctypes.c_ubyte),
            ]
            _lib = lib
    return _lib


def nms_keypoints_native(kpts: np.ndarray, responses: np.ndarray, radius: float) -> np.ndarray:
    """Greedy radius-NMS keep mask [N] bool of keypoints [N, 2] by responses
    [N] (``features.opencv_features.nms_keypoints_scipy``'s semantics, ties
    broken by index). Raises ValueError on input the grid cannot take
    (non-finite coordinates, a negative radius)."""
    kpts = np.ascontiguousarray(kpts, dtype=np.float32)
    responses = np.ascontiguousarray(responses, dtype=np.float32)
    n = kpts.shape[0]
    if kpts.shape != (n, 2) or responses.shape != (n,):
        raise ValueError(f"bad shapes: kpts {kpts.shape}, responses {responses.shape}")
    keep = np.zeros(n, dtype=np.uint8)
    ret = load().og_nms_radius(
        kpts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        responses.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        float(radius),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    if ret < 0:
        raise ValueError(f"the host NMS refused its input ({n} keypoints, radius {radius}): "
                         "non-finite coordinates or a negative radius")
    return keep.astype(bool)

"""Local Affine Frame (LAF) utilities and side-info converters (port of
``openglue_tpu/features/lafs.py``), in numpy: the collate runs them on the
host, on the arrays it builds.

LAFs are [B, N, 2, 3] arrays: the left 2x2 block is the affine shape A, the
last column the keypoint center. A converter turns LAFs into the geometric
side information the positional encoder takes (reference
models/laf_converter.py:22-128).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np


def laf_center(lafs: np.ndarray) -> np.ndarray:
    """Keypoint xy from LAFs: [B, N, 2, 3] -> [B, N, 2]."""
    return lafs[..., :, 2]


def laf_scale(lafs: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """Scale = sqrt(|det A|) (kornia get_laf_scale semantics):
    [B, N, 2, 3] -> [B, N, 1]."""
    A = lafs[..., :2, :2]
    det = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    return np.sqrt(np.abs(det) + eps)[..., None]


def laf_from_keypoints(keypoints: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Identity-shape LAFs from keypoints [B, N, 2] (reference
    superpoint/model.py:120-127 sets A = I)."""
    b, n, _ = keypoints.shape
    eye = np.broadcast_to(np.eye(2, dtype=keypoints.dtype) * scale, (b, n, 2, 2))
    return np.concatenate([eye, keypoints[..., None]], axis=-1)


def laf_log_scale(lafs: np.ndarray) -> np.ndarray:
    """[B, N, 1] log scale (reference laf_converter.py:22-36)."""
    return np.log(laf_scale(lafs))


def laf_sincos_orientation(lafs: np.ndarray) -> np.ndarray:
    """[B, N, 2] flipped first row / scale (reference laf_converter.py:39-54)."""
    return lafs[..., 0, :2][..., ::-1] / laf_scale(lafs)


def laf_affine_geom(lafs: np.ndarray) -> np.ndarray:
    """[B, N, 4] flattened A / scale (reference laf_converter.py:57-72)."""
    A = lafs[..., :2, :2]
    return A.reshape(*A.shape[:-2], 4) / laf_scale(lafs)


class LAFConverter:
    """Concatenate selected LAF -> side-info conversions
    (reference laf_converter.py:75-105)."""

    def __init__(self, functions: Optional[Sequence[Tuple[Callable, int]]] = None):
        self.functions = functions

    def __call__(self, lafs: np.ndarray) -> np.ndarray:
        if not self.functions:
            b, n = lafs.shape[:2]
            return np.zeros((b, n, 0), dtype=lafs.dtype)
        return np.concatenate([fn(lafs) for fn, _ in self.functions], axis=-1)

    @property
    def side_info_dim(self) -> int:
        if not self.functions:
            return 0
        return sum(dim for _, dim in self.functions)


_METHODS = {
    "none": (),
    "rotation": ((laf_sincos_orientation, 2),),
    "scale": ((laf_log_scale, 1),),
    "scale_rotation": ((laf_log_scale, 1), (laf_sincos_orientation, 2)),
    "affine": ((laf_log_scale, 1), (laf_affine_geom, 4)),
}


def get_laf_to_sideinfo_converter(method_name: str = "none") -> LAFConverter:
    """Registry (reference laf_converter.py:108-128)."""
    key = method_name.lower()
    if key not in _METHODS:
        raise NameError(f"Unexpected name for the method: {method_name}")
    return LAFConverter(_METHODS[key] or None)

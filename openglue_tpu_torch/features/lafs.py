"""Local Affine Frame (LAF) utilities and side-info converters (port of
``openglue_tpu/features/lafs.py``). Each function takes a numpy array or a
torch tensor and answers in kind: the collate runs them on the host, on the
arrays it builds, and the online train step on the extractor's tensors on
the device, with no copy between them.

LAFs are [B, N, 2, 3] arrays: the left 2x2 block is the affine shape A, the
last column the keypoint center. A converter turns LAFs into the geometric
side information the positional encoder takes (reference
models/laf_converter.py:22-128).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch


def laf_center(lafs):
    """Keypoint xy from LAFs: [B, N, 2, 3] -> [B, N, 2]."""
    return lafs[..., :, 2]


def laf_scale(lafs, eps: float = 1e-10):
    """Scale = sqrt(|det A|) (kornia get_laf_scale semantics):
    [B, N, 2, 3] -> [B, N, 1]."""
    A = lafs[..., :2, :2]
    det = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    if torch.is_tensor(lafs):
        return torch.sqrt(det.abs() + eps)[..., None]
    return np.sqrt(np.abs(det) + eps)[..., None]


def laf_from_keypoints(keypoints: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Identity-shape LAFs from keypoints [B, N, 2] (reference
    superpoint/model.py:120-127 sets A = I)."""
    b, n, _ = keypoints.shape
    eye = np.broadcast_to(np.eye(2, dtype=keypoints.dtype) * scale, (b, n, 2, 2))
    return np.concatenate([eye, keypoints[..., None]], axis=-1)


def laf_log_scale(lafs):
    """[B, N, 1] log scale (reference laf_converter.py:22-36)."""
    scale = laf_scale(lafs)
    return torch.log(scale) if torch.is_tensor(scale) else np.log(scale)


def laf_sincos_orientation(lafs):
    """[B, N, 2] flipped first row / scale (reference laf_converter.py:39-54)."""
    first_row = lafs[..., 0, :2]
    flipped = first_row.flip(-1) if torch.is_tensor(lafs) else first_row[..., ::-1]
    return flipped / laf_scale(lafs)


def laf_affine_geom(lafs):
    """[B, N, 4] flattened A / scale (reference laf_converter.py:57-72)."""
    A = lafs[..., :2, :2]
    return A.reshape(*A.shape[:-2], 4) / laf_scale(lafs)


class LAFConverter:
    """Concatenate selected LAF -> side-info conversions
    (reference laf_converter.py:75-105)."""

    def __init__(self, functions: Optional[Sequence[Tuple[Callable, int]]] = None):
        self.functions = functions

    def __call__(self, lafs):
        if torch.is_tensor(lafs):
            if not self.functions:
                return lafs.new_zeros((*lafs.shape[:2], 0))
            return torch.cat([fn(lafs) for fn, _ in self.functions], dim=-1)
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

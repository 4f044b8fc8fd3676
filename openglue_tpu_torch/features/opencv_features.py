"""Host-side OpenCV feature extractors (port of
``openglue_tpu/features/opencv_features.py``; reference
models/features/opencv/), numpy and cv2 on the host with the JAX package's
arithmetic.

These run on the host, in the offline feature cacher (reference
README.md:140: OpenCV extractors are cached-extraction-only; the training
path consumes their h5 output through the cached-feature dataset) and in the
serving entry point, which matches their output on the device. Behavior
replicated from the reference:

  * detector thresholds disabled (contrast/edge = -10000) so detection is
    dense and selection is NMS + top-k by response (reference _features.py:10-18);
  * greedy radius NMS over response-sorted keypoints (the reference's
    KD-tree loop, base.py:161-182; here the C++ grid hash of ``native``);
  * cv2.KeyPoint -> LAF with scale = mr_size * size and in-plane rotation
    by -angle (reference base.py:51-92, kornia_moons convention);
  * RootSIFT (L1 -> sqrt) or plain L2 descriptor normalization
    (reference base.py:26-49).

Output is padded to ``max_keypoints`` with a validity mask, the matcher's
shape contract, rather than ragged arrays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def normalize_descriptors(descriptors: np.ndarray, root_norm: bool = True) -> np.ndarray:
    """RootSIFT (L1-normalize then sqrt) or L2 (reference base.py:26-49)."""
    descriptors = descriptors.astype(np.float32)
    if root_norm:
        norm = np.linalg.norm(descriptors, ord=1, axis=1, keepdims=True)
        return np.sqrt(descriptors / np.maximum(norm, 1e-12))
    norm = np.linalg.norm(descriptors, ord=2, axis=1, keepdims=True)
    return descriptors / np.maximum(norm, 1e-12)


def nms_keypoints(kpts: np.ndarray, responses: np.ndarray, radius: float) -> np.ndarray:
    """Greedy radius NMS: accept in response order, suppress all neighbors
    within ``radius`` (reference base.py:161-182). Returns a keep mask.

    Runs the C++ grid-hash kernel (``openglue_tpu_torch.native``), which
    raises when it cannot be built; ``nms_keypoints_scipy`` is its plain
    version."""
    from openglue_tpu_torch import native

    return native.nms_keypoints_native(np.asarray(kpts), np.asarray(responses), radius)


def nms_keypoints_scipy(
    kpts: np.ndarray, responses: np.ndarray, radius: float
) -> np.ndarray:
    """Reference scipy KD-tree implementation (the plain version the tests
    hold the native kernel against)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(kpts)
    # Stable sort with index tiebreak so tie handling matches the native
    # kernel exactly (detectors with quantized responses tie frequently;
    # hosts with and without a C++ toolchain must produce identical masks).
    order = np.argsort(-responses, kind="stable")
    removed = np.zeros(len(kpts), dtype=bool)
    keep = np.zeros(len(kpts), dtype=bool)
    for idx in order:
        if removed[idx]:
            continue
        keep[idx] = True
        removed[tree.query_ball_point(kpts[idx], r=radius)] = True
    return keep


def lafs_from_opencv_keypoints(
    kpts, mr_size: float = 6.0
) -> Tuple[np.ndarray, np.ndarray]:
    """cv2.KeyPoint list -> (lafs [N, 2, 3], responses [N])
    (reference base.py:51-92): scale = mr_size * kp.size, rotation by
    -kp.angle (degrees; -1 sentinel means unoriented -> 0)."""
    xy = np.array([k.pt for k in kpts], np.float32).reshape(-1, 2)
    scales = np.array([mr_size * k.size for k in kpts], np.float32)
    angles = np.array([k.angle for k in kpts], np.float32)
    if np.allclose(angles, -1.0):
        angles = np.zeros_like(scales)
    angles = np.deg2rad(-angles)

    n = xy.shape[0]
    lafs = np.empty((n, 2, 3), np.float32)
    lafs[:, :, 2] = xy
    c, s = scales * np.cos(angles), scales * np.sin(angles)
    lafs[:, 0, 0] = c
    lafs[:, 0, 1] = s
    lafs[:, 1, 0] = -s
    lafs[:, 1, 1] = c
    return lafs, np.array([k.response for k in kpts], np.float32)


class OpenCVFeatures:
    """Detector/descriptor wrapper with NMS + top-k + padding
    (reference OpenCVFeatures, base.py:14-116)."""

    def __init__(
        self,
        features,
        max_keypoints: int = 2048,
        nms_diameter: float = 9.0,
        normalize_desc: bool = True,
        root_norm: bool = True,
        laf_scale_mr_size: float = 6.0,
        pad_to_max: bool = True,
    ):
        self.features = features
        self.max_keypoints = max_keypoints
        self.nms_radius = nms_diameter / 2
        self.normalize_desc = normalize_desc
        self.root_norm = root_norm
        self.laf_scale_mr_size = laf_scale_mr_size
        self.pad_to_max = pad_to_max

    def detect_and_compute(self, image: np.ndarray):
        """uint8 grayscale [H, W] -> (lafs [K, 2, 3], scores [K], desc [K, D],
        mask [K]) padded to max_keypoints when pad_to_max."""
        kpts, descriptors = self.features.detectAndCompute(image, None)
        kpts = list(kpts or [])
        if not kpts:
            d = 128
            k = self.max_keypoints if self.pad_to_max else 0
            return (
                np.zeros((k, 2, 3), np.float32),
                np.zeros((k,), np.float32),
                np.zeros((k, d), np.float32),
                np.zeros((k,), bool),
            )
        descriptors = np.asarray(descriptors, np.float32)
        pts = np.array([k.pt for k in kpts], np.float32)
        responses = np.array([k.response for k in kpts], np.float32)

        if self.nms_radius > 0:
            keep = nms_keypoints(pts, responses, self.nms_radius)
        else:
            keep = np.ones(len(kpts), bool)
        idx = np.flatnonzero(keep)
        if self.max_keypoints > 0 and len(idx) > self.max_keypoints:
            order = np.argsort(-responses[idx])[: self.max_keypoints]
            idx = idx[order]

        kept = [kpts[i] for i in idx]
        lafs, scores = lafs_from_opencv_keypoints(kept, self.laf_scale_mr_size)
        desc = descriptors[idx]
        if self.normalize_desc:
            desc = normalize_descriptors(desc, self.root_norm)

        if not self.pad_to_max:
            return lafs, scores, desc, np.ones(len(idx), bool)
        k = self.max_keypoints
        n = len(idx)
        out_lafs = np.zeros((k, 2, 3), np.float32)
        out_scores = np.zeros((k,), np.float32)
        out_desc = np.zeros((k, desc.shape[1]), np.float32)
        out_mask = np.zeros((k,), bool)
        out_lafs[:n], out_scores[:n], out_desc[:n], out_mask[:n] = lafs, scores, desc, True
        return out_lafs, out_scores, out_desc, out_mask


def sift_create(
    max_keypoints: int = 2048,
    nms_diameter: float = 9.0,
    rootsift: bool = True,
    pad_to_max: bool = True,
) -> OpenCVFeatures:
    """Dense SIFT (thresholds disabled; reference _features.py:10-18)."""
    import cv2

    return OpenCVFeatures(
        cv2.SIFT_create(contrastThreshold=-10000, edgeThreshold=-10000),
        max_keypoints=max_keypoints,
        nms_diameter=nms_diameter,
        normalize_desc=True,
        root_norm=rootsift,
        laf_scale_mr_size=6.0,
        pad_to_max=pad_to_max,
    )

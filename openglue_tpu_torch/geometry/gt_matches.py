"""Ground-truth match generation from geometry (port of
``openglue_tpu/geometry/gt_matches.py``).

Keypoints of each image are reprojected into the other; mutual nearest
neighbours under reprojection error become candidate matches, and distance
thresholds classify them MATCHED (the target index), UNMATCHED (-1) or
IGNORE (-2). ``parity_mode=True`` reproduces the reference's actual behaviour
(its threshold lines are no-ops: mutual => MATCHED at any distance,
non-mutual => UNMATCHED); the default applies the documented thresholds.
Padded keypoints (mask False) are always IGNORE and are never a nearest
neighbour.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from openglue_tpu_torch.core.types import Transformation
from openglue_tpu_torch.geometry.transforms import cdist_sq, reproject_keypoints

UNMATCHED_INDEX = -1
IGNORE_INDEX = -2

# Masked-target sentinel of the squared-distance matrices: +inf dominates any
# real squared error (1e9 would not: a depth-valid reprojection beyond ~31.6k
# px could out-argmin a padded column), and flows through min/argmin/sqrt.
_BIG = float("inf")


def _classify(mutual, nn, sym_dist, min_dist, positive_threshold, negative_threshold):
    """mutual & sym <= pos => MATCHED; mutual & pos < sym <= neg => IGNORE;
    mutual & sym > neg => UNMATCHED; non-mutual & min <= neg => IGNORE;
    non-mutual & min > neg => UNMATCHED."""
    ignore = torch.full_like(nn, IGNORE_INDEX)
    unmatched = torch.full_like(nn, UNMATCHED_INDEX)
    near_miss = torch.where(sym_dist <= negative_threshold, ignore, unmatched)
    mutual_label = torch.where(sym_dist <= positive_threshold, nn, near_miss)
    other_label = torch.where(min_dist <= negative_threshold, ignore, unmatched)
    return torch.where(mutual, mutual_label, other_label)


def generate_gt_matches(
    kpts0: torch.Tensor,
    kpts1: torch.Tensor,
    transformation: Transformation,
    positive_threshold: float,
    negative_threshold: Optional[float] = None,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
    parity_mode: bool = False,
) -> Dict[str, torch.Tensor]:
    """kpts0 [B, N, 2], kpts1 [B, M, 2], masks [B, N] / [B, M] bool ->
    gt_matches0 [B, N], gt_matches1 [B, M] (int32: target index, -1 or -2)."""
    if negative_threshold is None:
        negative_threshold = positive_threshold
    batch, n = kpts0.shape[:2]
    m = kpts1.shape[1]
    device = kpts0.device
    if mask0 is None:
        mask0 = torch.ones(batch, n, dtype=torch.bool, device=device)
    if mask1 is None:
        mask1 = torch.ones(batch, m, dtype=torch.bool, device=device)

    kpts0_t, depth_valid0 = reproject_keypoints(kpts0, transformation)
    kpts1_t, depth_valid1 = reproject_keypoints(kpts1, transformation.inverse())

    # squared distances: sqrt is monotone, so only the row minima need it
    err01 = torch.where(mask1[:, None, :], cdist_sq(kpts0_t, kpts1), _BIG)  # [B, N, M]
    err10 = torch.where(mask0[:, None, :], cdist_sq(kpts1_t, kpts0), _BIG)  # [B, M, N]
    min_dist0 = torch.sqrt(err01.amin(dim=2))
    nn0 = err01.argmin(dim=2)  # best kpt1 for each kpt0 (first on ties)
    min_dist1 = torch.sqrt(err10.amin(dim=2))
    nn1 = err10.argmin(dim=2)

    arange0 = torch.arange(n, device=device)[None, :]
    arange1 = torch.arange(m, device=device)[None, :]
    mutual0 = arange0 == torch.gather(nn1, 1, nn0)
    mutual1 = arange1 == torch.gather(nn0, 1, nn1)

    # symmetric distance of a mutual pair: 0.5 * (d0[i] + d1[nn0[i]])
    sym_dist0 = 0.5 * (min_dist0 + torch.gather(min_dist1, 1, nn0))
    sym_dist1 = 0.5 * (min_dist1 + torch.gather(min_dist0, 1, nn1))

    ignore0 = torch.full_like(nn0, IGNORE_INDEX)
    ignore1 = torch.full_like(nn1, IGNORE_INDEX)
    if parity_mode:
        labels0 = torch.where(mutual0, nn0, torch.full_like(nn0, UNMATCHED_INDEX))
        labels1 = torch.where(mutual1, nn1, torch.full_like(nn1, UNMATCHED_INDEX))
    else:
        labels0 = _classify(mutual0, nn0, sym_dist0, min_dist0, positive_threshold, negative_threshold)
        labels1 = _classify(mutual1, nn1, sym_dist1, min_dist1, positive_threshold, negative_threshold)

    # keypoints with unknown depth are IGNOREd
    labels0 = torch.where(depth_valid0, labels0, ignore0)
    labels1 = torch.where(depth_valid1, labels1, ignore1)

    # a MATCHED keypoint whose nearest neighbour has invalid depth is IGNOREd
    # (the reference's intent; a no-op there, so not in parity mode)
    if not parity_mode:
        nn_valid0 = torch.gather(depth_valid1, 1, nn0)
        nn_valid1 = torch.gather(depth_valid0, 1, nn1)
        labels0 = torch.where((labels0 >= 0) & ~nn_valid0, ignore0, labels0)
        labels1 = torch.where((labels1 >= 0) & ~nn_valid1, ignore1, labels1)

    # padded keypoints never take part in the loss
    labels0 = torch.where(mask0, labels0, ignore0)
    labels1 = torch.where(mask1, labels1, ignore1)
    return {"gt_matches0": labels0.to(torch.int32), "gt_matches1": labels1.to(torch.int32)}

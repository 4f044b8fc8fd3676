"""Evaluation metrics (port of ``openglue_tpu/metrics.py``; reference
utils/metrics.py).

* ``EpipolarDistanceMetric``: precision and matching score at a symmetric
  epipolar-distance threshold (reference AccuracyUsingEpipolarDist,
  utils/metrics.py:10-52). The distances are computed on the batch's device;
  only the counts come to the host.
* ``CameraPoseAUC``: RANSAC essential-matrix pose recovery and the
  pose-error AUC (reference utils/metrics.py:55-141), on the host through
  OpenCV.
* ``HomographyPrecisionMetric``: precision and matching score under a
  ground-truth homography (the homography-pretraining evaluation), counted
  on the batch's device.

Each accumulates and compute; with ``torch.distributed`` initialized, ``sync``
gathers every process's per-pair values first (torchmetrics' dist_sync in the
reference, metrics.py:12-15).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from openglue_tpu_torch.geometry.epipolar import essential_from_Rt, symmetrical_epipolar_distance
from openglue_tpu_torch.geometry.transforms import normalize_with_intrinsics


def _epipolar_counts(kpts0, kpts1, matches0, K0, K1, R, T, threshold: float = 5e-4):
    """Counts of one batch on the device of ``kpts0``: (correct, matched) per
    element, as numpy. matches0: [B, N] index into kpts1 or -1."""
    kpts0 = torch.as_tensor(kpts0)
    kpts1, matches0, K0, K1, R, T = (
        torch.as_tensor(x, device=kpts0.device) for x in (kpts1, matches0, K0, K1, R, T)
    )
    valid = matches0 >= 0
    cols = matches0.clamp(0, kpts1.shape[1] - 1).long()
    mkpts1 = torch.gather(kpts1, 1, cols[..., None].expand(-1, -1, kpts1.shape[-1]))

    pts0 = normalize_with_intrinsics(kpts0, K0)
    pts1 = normalize_with_intrinsics(mkpts1, K1)
    dist = symmetrical_epipolar_distance(pts0, pts1, essential_from_Rt(R, T))

    correct = ((dist < threshold) & valid).sum(dim=1)
    matched = valid.sum(dim=1)
    return correct.cpu().numpy(), matched.cpu().numpy()


class EpipolarDistanceMetric:
    """Precision = correct/matched; Matching Score = correct/detected
    (reference utils/metrics.py:44-52)."""

    def __init__(self, threshold: float = 5e-4):
        self.threshold = threshold
        self.reset()

    def reset(self) -> None:
        self.precisions: List[float] = []
        self.matching_scores: List[float] = []

    def update(self, kpts0, kpts1, matches0, K0, K1, R, T, num_detected=None) -> None:
        """Tensors (on any one device) or numpy arrays; num_detected: [B] valid
        keypoint counts of image0 (defaults to N)."""
        correct, matched = _epipolar_counts(kpts0, kpts1, matches0, K0, K1, R, T, self.threshold)
        if num_detected is None:
            num_detected = np.full(correct.shape, kpts0.shape[1])
        else:
            num_detected = np.asarray(num_detected)
        self.precisions.extend((correct / np.maximum(matched, 1)).tolist())
        self.matching_scores.extend(
            (correct / np.maximum(num_detected, 1)).tolist()
        )

    def sync(self) -> None:
        """Gather the per-pair values of every process; nothing to do in
        one process."""
        self.precisions = _allgather_list(self.precisions)
        self.matching_scores = _allgather_list(self.matching_scores)

    def compute(self) -> Dict[str, float]:
        return {
            f"Precision@{self.threshold}": float(np.mean(self.precisions or [0.0])),
            f"Matching Score@{self.threshold}": float(np.mean(self.matching_scores or [0.0])),
        }


def _allgather_list(values: List[float]) -> List[float]:
    """Every process's list, concatenated in rank order, when
    ``torch.distributed`` is initialized; else ``values``."""
    if not dist.is_initialized():
        return values
    gathered: List[Optional[List[float]]] = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, list(values))
    return [v for part in gathered for v in part]


HOMOGRAPHY_THRESHOLD_PX = 3.0  # a match within this many pixels of H's image is correct


def _homography_counts(kpts0, kpts1, matches0, H, threshold: float):
    """Counts of one batch on the device of ``kpts0``: (correct, matched) per
    element, as numpy; a match is correct where H maps its keypoint of
    image 0 within ``threshold`` pixels of its keypoint of image 1."""
    kpts0 = torch.as_tensor(kpts0)
    kpts1, matches0, H = (torch.as_tensor(x, device=kpts0.device) for x in (kpts1, matches0, H))
    valid = matches0 >= 0
    cols = matches0.clamp(0, kpts1.shape[1] - 1).long()
    mkpts1 = torch.gather(kpts1, 1, cols[..., None].expand(-1, -1, kpts1.shape[-1]))
    ones = torch.ones_like(kpts0[..., :1])
    warped = torch.einsum("bij,bnj->bni", H.to(kpts0.dtype), torch.cat([kpts0, ones], dim=-1))
    warped = warped[..., :2] / (warped[..., 2:3] + 1e-8)
    dist = torch.linalg.vector_norm(warped - mkpts1, dim=-1)
    correct = ((dist < threshold) & valid).sum(dim=1)
    matched = valid.sum(dim=1)
    return correct.cpu().numpy(), matched.cpu().numpy()


class HomographyPrecisionMetric:
    """Reprojection precision under a ground-truth homography (evaluation for
    the homography-pretraining path; the reference disables eval there —
    homography_pretraining.yaml 'evaluation: False' — this goes beyond it)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.precisions: List[float] = []
        self.matching_scores: List[float] = []

    def update(self, kpts0, kpts1, matches0, H, num_detected=None) -> None:
        """Tensors (on any one device) or numpy arrays; num_detected: [B] valid
        keypoint counts of image0 (defaults to N)."""
        correct, matched = _homography_counts(kpts0, kpts1, matches0, H, HOMOGRAPHY_THRESHOLD_PX)
        if num_detected is None:
            num_detected = np.full(correct.shape, kpts0.shape[1])
        else:
            num_detected = np.asarray(num_detected)
        self.precisions.extend((correct / np.maximum(matched, 1)).tolist())
        self.matching_scores.extend((correct / np.maximum(num_detected, 1)).tolist())

    def sync(self) -> None:
        """Gather the per-pair values of every process; nothing to do in
        one process."""
        self.precisions = _allgather_list(self.precisions)
        self.matching_scores = _allgather_list(self.matching_scores)

    def compute(self) -> Dict[str, float]:
        return {
            f"H-Precision@{HOMOGRAPHY_THRESHOLD_PX}px": float(np.mean(self.precisions or [0.0])),
            f"H-Matching Score@{HOMOGRAPHY_THRESHOLD_PX}px": float(np.mean(self.matching_scores or [0.0])),
        }


def rotation_angle_deg(R_est: np.ndarray, R_gt: np.ndarray) -> float:
    cos = (np.trace(R_est.T @ R_gt) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def translation_angle_deg(t_est: np.ndarray, t_gt: np.ndarray, eps=1e-10) -> float:
    t_est = t_est.reshape(-1) / max(np.linalg.norm(t_est), eps)
    t_gt = t_gt.reshape(-1) / max(np.linalg.norm(t_gt), eps)
    cos = abs(float(t_est @ t_gt))  # translation sign is unobservable from E
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def pose_error_from_essential(
    E: np.ndarray,
    inlier_mask: Optional[np.ndarray],
    pts0n: np.ndarray,
    pts1n: np.ndarray,
    R_gt: np.ndarray,
    T_gt: np.ndarray,
) -> float:
    """Decompose a stacked [3k, 3] essential-matrix candidate set and score the
    cheirality-best solution against the GT pose.

    Reference semantics (utils/metrics.py:104-120): for each 3-row E chunk,
    choose the (R, t) decomposition with the most points triangulating in
    front of both cameras, keep the chunk with the MOST such points (strict >,
    first chunk wins ties), and only then compute the pose error — NOT the
    minimum GT error across chunks (that would be oracle selection).
    cv2.recoverPose returns exactly that cheiral-inlier count as its retval
    and already picks the best of the 4 decompositions per chunk.
    """
    import cv2

    E = np.asarray(E, dtype=np.float64)
    best_n = -1
    best_Rt = None
    for i in range(0, E.shape[0], 3):
        n_cheiral, R_est, t_est, _ = cv2.recoverPose(
            E[i : i + 3],
            pts0n.astype(np.float64),
            pts1n.astype(np.float64),
            np.eye(3),
            mask=inlier_mask.copy() if inlier_mask is not None else None,
        )
        if n_cheiral > best_n:
            best_n = n_cheiral
            best_Rt = (R_est, t_est)
    if best_Rt is None:
        return float("inf")
    R_est, t_est = best_Rt
    return max(
        rotation_angle_deg(R_est, R_gt),
        translation_angle_deg(t_est, T_gt),
    )


class CameraPoseAUC:
    """RANSAC pose AUC@{5,10,20}° (reference utils/metrics.py:55-141).

    Per pair: normalized matched keypoints -> cv2.findEssentialMat(RANSAC,
    prob .99999, threshold scaled by mean focal length) -> recoverPose on each
    3-row E chunk, selecting the chunk with the most cheiral points (reference
    metrics.py:104-117) -> pose error = max(∠R, ∠T), inf when <5 matches or E
    estimation fails (reference metrics.py:102/121) -> AUC via trapezoid on
    the sorted error-recall curve.

    ``workers > 1`` runs the per-pair OpenCV RANSAC calls in a thread pool
    (cv2 releases the interpreter lock).
    """

    def __init__(
        self,
        auc_thresholds=(5.0, 10.0, 20.0),
        ransac_thresh_px: float = 0.5,
        workers: int = 8,
    ):
        self.auc_thresholds = tuple(auc_thresholds)
        self.ransac_thresh_px = ransac_thresh_px
        self.workers = workers
        self.reset()

    def reset(self) -> None:
        self.pose_errors: List[float] = []

    def _pose_error_single(self, kpts0, kpts1, matches0, K0, K1, R, T) -> float:
        import cv2

        valid = matches0 >= 0
        if valid.sum() < 5:
            return float("inf")
        pts0 = kpts0[valid]
        pts1 = kpts1[matches0[valid]]
        # normalize to calibrated coords (reference metrics.py:87-90)
        pts0n = (pts0 - K0[:2, 2]) / np.array([K0[0, 0], K0[1, 1]])
        pts1n = (pts1 - K1[:2, 2]) / np.array([K1[0, 0], K1[1, 1]])
        # RANSAC threshold in normalized units: px / mean focal
        # (reference metrics.py:93-94)
        mean_focal = np.mean([K0[0, 0], K0[1, 1], K1[0, 0], K1[1, 1]])
        thresh = self.ransac_thresh_px / mean_focal
        E, inlier_mask = cv2.findEssentialMat(
            pts0n.astype(np.float64),
            pts1n.astype(np.float64),
            np.eye(3),
            method=cv2.RANSAC,
            prob=0.99999,
            threshold=thresh,
        )
        if E is None:
            return float("inf")
        return pose_error_from_essential(E, inlier_mask, pts0n, pts1n, R, T)

    def update(self, kpts0, kpts1, matches0, K0, K1, R, T) -> None:
        kpts0 = np.asarray(kpts0)
        kpts1 = np.asarray(kpts1)
        matches0 = np.asarray(matches0)
        K0 = np.asarray(K0)
        K1 = np.asarray(K1)
        R = np.asarray(R)
        T = np.asarray(T)

        batch = kpts0.shape[0]
        args = [
            (kpts0[b], kpts1[b], matches0[b], K0[b], K1[b], R[b], T[b])
            for b in range(batch)
        ]
        if self.workers > 1 and batch > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=self.workers) as pool:
                errors = list(pool.map(lambda a: self._pose_error_single(*a), args))
        else:
            errors = [self._pose_error_single(*a) for a in args]
        self.pose_errors.extend(errors)

    def sync(self) -> None:
        """Gather the pose errors of every process."""
        self.pose_errors = _allgather_list(self.pose_errors)

    def compute(self) -> Dict[str, float]:
        """Trapezoid AUC on the error-recall curve (reference metrics.py:125-141).

        The recall carried to the threshold endpoint is the recall of the last
        error BELOW the threshold (recall is a step function of the error —
        appending total recall there would inflate the AUC whenever any pair
        exceeds the threshold)."""
        errors = np.sort(np.asarray(self.pose_errors, dtype=np.float64))
        n = len(errors)
        out = {}
        for thr in self.auc_thresholds:
            if n == 0:
                out[f"AUC@{int(thr)}deg"] = 0.0
                continue
            recall = (np.arange(n) + 1) / n
            below = errors <= thr
            r_at_thr = recall[below][-1] if below.any() else 0.0
            e = np.concatenate([[0.0], errors[below], [thr]])
            r = np.concatenate([[0.0], recall[below], [r_at_thr]])
            out[f"AUC@{int(thr)}deg"] = float(np.trapezoid(r, e) / thr)
        return out

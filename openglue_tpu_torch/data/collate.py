"""Fixed-size batching of cached-feature samples into a PairBatch (port of
``openglue_tpu/data/collate.py``; reference
MegaDepthPairsDataModuleFeatures.stack_keypoints_batch,
data/megadepth_datamodule.py:104-168).

Oversized keypoint sets are subsampled randomly (train) or by top score
(val); undersized ones are zero-padded with depth-0 virtual keypoints, which
GT generation ignores; per-keypoint depth is read at the integer keypoint
pixel. A validity mask rides along. The arithmetic is the JAX package's, in
numpy, so the arrays are equal to its arrays bit for bit; the result holds
them as CPU tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from openglue_tpu_torch.core.types import KeypointSet, PairBatch, Transformation
from openglue_tpu_torch.data.bucketing import batch_bucket
from openglue_tpu_torch.features.lafs import LAFConverter


def _select_keypoints(
    lafs: np.ndarray,
    scores: np.ndarray,
    descriptors: np.ndarray,
    depth_map: np.ndarray,
    target: int,
    random: bool,
    rng: np.random.Generator,
):
    """Fixed-size (lafs, scores, descriptors, kpt_depth, mask) of one image."""
    n = lafs.shape[0]
    d = descriptors.shape[1] if descriptors.ndim == 2 else 0
    out_lafs = np.zeros((target, 2, 3), np.float32)
    out_scores = np.zeros((target,), np.float32)
    out_desc = np.zeros((target, d), np.float32)
    out_depth = np.zeros((target,), np.float32)
    out_mask = np.zeros((target,), bool)

    if n > target:
        idx = rng.permutation(n)[:target] if random else np.argsort(-scores)[:target]
        lafs, scores, descriptors = lafs[idx], scores[idx], descriptors[idx]
        n = target
    out_lafs[:n] = lafs
    out_scores[:n] = scores
    out_desc[:n] = descriptors
    out_mask[:n] = True
    if n:
        ys = np.clip(lafs[:, 1, 2].astype(np.int64), 0, depth_map.shape[0] - 1)
        xs = np.clip(lafs[:, 0, 2].astype(np.int64), 0, depth_map.shape[1] - 1)
        out_depth[:n] = depth_map[ys, xs]
    return out_lafs, out_scores, out_desc, out_depth, out_mask


def stack_keypoints_batch(
    samples: Sequence[Dict],
    target_num_keypoints: int,
    random: bool = False,
    laf_converter: Optional[LAFConverter] = None,
    log_response: bool = False,
    rng: Optional[np.random.Generator] = None,
    buckets: Optional[Sequence[int]] = None,
    force_bucket: Optional[int] = None,
) -> PairBatch:
    """Collate cached-feature sample dicts into a PairBatch of CPU tensors.

    side_info (the response and the LAF converter's features, reference
    models/features/utils.py:54-65) is built here on the host.

    ``buckets``: the batch is padded to the smallest bucket that fits its
    largest real keypoint count (capped by target_num_keypoints).
    ``force_bucket``: pad to exactly this bucket (still capped), whatever the
    members' counts; bucket grouping (BucketGroupedIndexBatches) chooses it
    from the pre-crop counts.
    """
    rng = rng or np.random.default_rng()
    laf_converter = laf_converter or LAFConverter()

    if force_bucket is not None:
        target_num_keypoints = min(int(force_bucket), target_num_keypoints)
    elif buckets is not None:
        counts = [s[f"lafs{i}"].shape[0] for s in samples for i in (0, 1)]
        target_num_keypoints = min(batch_bucket(counts, buckets), target_num_keypoints)

    sides = []
    depths = {0: [], 1: []}
    for image_id in (0, 1):
        all_lafs, all_scores, all_desc, all_mask = [], [], [], []
        for s in samples:
            lafs, scores, desc, depth, mask = _select_keypoints(
                s[f"lafs{image_id}"],
                s[f"scores{image_id}"],
                s[f"descriptors{image_id}"],
                s["transformation"][f"depth{image_id}"],
                target_num_keypoints,
                random,
                rng,
            )
            all_lafs.append(lafs)
            all_scores.append(scores)
            all_desc.append(desc)
            all_mask.append(mask)
            depths[image_id].append(depth)
        lafs = np.stack(all_lafs)
        scores = np.stack(all_scores)

        kpts = lafs[:, :, :, 2]  # LAF translation column = keypoint xy
        resp = scores[..., None]
        if log_response:
            resp = np.log(resp + 0.1)
        side_info = np.concatenate([resp, laf_converter(lafs)], axis=-1).astype(np.float32)
        image_size = np.stack([np.asarray(s[f"image{image_id}_size"], np.float32) for s in samples])
        sides.append(KeypointSet(
            keypoints=torch.from_numpy(kpts.astype(np.float32)),
            descriptors=torch.from_numpy(np.stack(all_desc)),
            side_info=torch.from_numpy(side_info),
            mask=torch.from_numpy(np.stack(all_mask)),
            image_size=torch.from_numpy(image_size),
        ))

    stack = lambda key: torch.from_numpy(
        np.stack([s["transformation"][key] for s in samples]).astype(np.float32))
    tf = Transformation(
        kind="3d_reprojection",
        K0=stack("K0"), K1=stack("K1"), R=stack("R"), T=stack("T"),
        depth0=torch.from_numpy(np.stack(depths[0])),
        depth1=torch.from_numpy(np.stack(depths[1])),
    )
    return PairBatch(side0=sides[0], side1=sides[1], transformation=tf)


def cast_for_transfer(batch: PairBatch, dtype: torch.dtype = torch.bfloat16) -> PairBatch:
    """The descriptors and side_info (most of a batch's bytes) in ``dtype``
    for the host-to-device copy, for a model that computes in bf16 and casts
    them on arrival anyway. The geometry (keypoints, depth, K/R/T) stays
    f32: GT generation needs it."""

    def cast_side(s: KeypointSet) -> KeypointSet:
        return KeypointSet(
            keypoints=s.keypoints,
            descriptors=s.descriptors.to(dtype),
            side_info=s.side_info.to(dtype),
            mask=s.mask,
            image_size=s.image_size,
        )

    return PairBatch(cast_side(batch.side0), cast_side(batch.side1), batch.transformation)


def resize_keypoint_axis(batch: PairBatch, n: int) -> PairBatch:
    """Pad (zeros, mask False) or truncate every per-keypoint tensor of a
    PairBatch to ``n`` keypoints: a batch of another bucket's shape made from
    a real batch, so that its values are benign (valid masks, finite
    depths). Per-keypoint depth [B, N] follows the keypoint axis; dense depth
    maps [B, H, W] pass through."""

    def fix(x: torch.Tensor) -> torch.Tensor:
        cur = x.shape[1]
        if cur >= n:
            return x[:, :n]
        return torch.cat([x, x.new_zeros(x.shape[0], n - cur, *x.shape[2:])], dim=1)

    def fix_side(s: KeypointSet) -> KeypointSet:
        return KeypointSet(fix(s.keypoints), fix(s.descriptors), fix(s.side_info), fix(s.mask), s.image_size)

    tf = batch.transformation
    if tf is not None:
        fix_depth = lambda d: fix(d) if d is not None and d.dim() == 2 else d
        tf = Transformation(
            kind=tf.kind, H=tf.H, K0=tf.K0, K1=tf.K1, R=tf.R, T=tf.T,
            depth0=fix_depth(tf.depth0), depth1=fix_depth(tf.depth1),
        )
    return PairBatch(fix_side(batch.side0), fix_side(batch.side1), tf)

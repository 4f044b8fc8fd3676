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

``stack_keypoints_batch_device`` is the collate of the device-resident
descriptor cache (data/device_cache.py): it replays the same selection as
index math and leaves the descriptors out of the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

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
    """Fixed-size (lafs, scores, descriptors, kpt_depth, mask, sel_idx) of
    one image; sel_idx [target] int32 is each output row's input row (0 for
    padding rows, which the mask tells apart), so that a caller keeping the
    descriptors elsewhere replays the selection as a gather."""
    n = lafs.shape[0]
    d = descriptors.shape[1] if descriptors.ndim == 2 else 0
    out_lafs = np.zeros((target, 2, 3), np.float32)
    out_scores = np.zeros((target,), np.float32)
    out_desc = np.zeros((target, d), np.float32)
    out_depth = np.zeros((target,), np.float32)
    out_mask = np.zeros((target,), bool)
    sel_idx = np.zeros((target,), np.int32)

    if n > target:
        idx = rng.permutation(n)[:target] if random else np.argsort(-scores)[:target]
        lafs, scores, descriptors = lafs[idx], scores[idx], descriptors[idx]
        sel_idx[:] = idx
        n = target
    else:
        sel_idx[:n] = np.arange(n, dtype=np.int32)
    out_lafs[:n] = lafs
    out_scores[:n] = scores
    out_desc[:n] = descriptors
    out_mask[:n] = True
    if n:
        ys = np.clip(lafs[:, 1, 2].astype(np.int64), 0, depth_map.shape[0] - 1)
        xs = np.clip(lafs[:, 0, 2].astype(np.int64), 0, depth_map.shape[1] - 1)
        out_depth[:n] = depth_map[ys, xs]
    return out_lafs, out_scores, out_desc, out_depth, out_mask, sel_idx


def _target_keypoints(samples, target_num_keypoints, buckets, force_bucket) -> int:
    """The batch's keypoint axis: ``force_bucket`` (capped), else the
    smallest bucket that fits the largest real count (capped), else the
    target."""
    if force_bucket is not None:
        return min(int(force_bucket), target_num_keypoints)
    if buckets is not None:
        counts = [s[f"lafs{i}"].shape[0] for s in samples for i in (0, 1)]
        return min(batch_bucket(counts, buckets), target_num_keypoints)
    return target_num_keypoints


def _side_tensors(samples, image_id, lafs, scores, mask, laf_converter, log_response):
    """(keypoints, side_info, mask, image_size) tensors of one side."""
    kpts = lafs[:, :, :, 2]  # LAF translation column = keypoint xy
    resp = scores[..., None]
    if log_response:
        resp = np.log(resp + 0.1)
    side_info = np.concatenate([resp, laf_converter(lafs)], axis=-1).astype(np.float32)
    image_size = np.stack([np.asarray(s[f"image{image_id}_size"], np.float32) for s in samples])
    return (torch.from_numpy(kpts.astype(np.float32)), torch.from_numpy(side_info),
            torch.from_numpy(mask), torch.from_numpy(image_size))


def _transformation(samples, depths) -> Transformation:
    stack = lambda key: torch.from_numpy(
        np.stack([s["transformation"][key] for s in samples]).astype(np.float32))
    return Transformation(
        kind="3d_reprojection",
        K0=stack("K0"), K1=stack("K1"), R=stack("R"), T=stack("T"),
        depth0=torch.from_numpy(np.stack(depths[0])),
        depth1=torch.from_numpy(np.stack(depths[1])),
    )


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
    target_num_keypoints = _target_keypoints(samples, target_num_keypoints, buckets, force_bucket)

    sides = []
    depths = {0: [], 1: []}
    for image_id in (0, 1):
        all_lafs, all_scores, all_desc, all_mask = [], [], [], []
        for s in samples:
            lafs, scores, desc, depth, mask, _ = _select_keypoints(
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
        kpts, side_info, mask, image_size = _side_tensors(
            samples, image_id, np.stack(all_lafs), np.stack(all_scores), np.stack(all_mask),
            laf_converter, log_response)
        sides.append(KeypointSet(keypoints=kpts, descriptors=torch.from_numpy(np.stack(all_desc)),
                                 side_info=side_info, mask=mask, image_size=image_size))
    return PairBatch(side0=sides[0], side1=sides[1], transformation=_transformation(samples, depths))


Key = Tuple[str, str]


@dataclasses.dataclass
class DeviceDescBatch:
    """A collated batch whose descriptors live in the device-resident
    descriptor cache (data/device_cache.py) and not in the batch: ``batch``
    holds [B, N, 0] descriptors; ``keys0/1`` name each row's image,
    ``index0/1`` [B, N] int32 give each keypoint's row in that image's block
    (0 for padding rows, whose mask is False), and ``blocks`` maps each key
    to its unfiltered [n, D] f32 block, which the cache copies to the device
    on a miss. ``DeviceDescriptorCache.to_device`` turns it into a device
    PairBatch."""

    batch: PairBatch
    keys0: Sequence[Key]
    keys1: Sequence[Key]
    index0: torch.Tensor
    index1: torch.Tensor
    blocks: Dict[Key, np.ndarray]


def stack_keypoints_batch_device(
    samples: Sequence[Dict],
    target_num_keypoints: int,
    random: bool = False,
    laf_converter: Optional[LAFConverter] = None,
    log_response: bool = False,
    rng: Optional[np.random.Generator] = None,
    buckets: Optional[Sequence[int]] = None,
    force_bucket: Optional[int] = None,
) -> DeviceDescBatch:
    """``stack_keypoints_batch`` for device-cached descriptors: the samples
    come from ``MegaDepthPairsDatasetFeatures(device_descriptors=True)``
    and carry each image's unfiltered descriptor block and the surviving
    rows' indices in it. The collate replays the keypoint selection, with
    the same draws from ``rng``, as index math, and never touches
    descriptor bytes; every other field equals ``stack_keypoints_batch``'s
    on the same samples and draws."""
    rng = rng or np.random.default_rng()
    laf_converter = laf_converter or LAFConverter()
    target_num_keypoints = _target_keypoints(samples, target_num_keypoints, buckets, force_bucket)

    sides, indices, keys, blocks = [], [], [], {}
    depths = {0: [], 1: []}
    for image_id in (0, 1):
        all_lafs, all_scores, all_mask, all_idx, side_keys = [], [], [], [], []
        for s in samples:
            lafs_in = s[f"lafs{image_id}"]
            lafs, scores, _, depth, mask, sel = _select_keypoints(
                lafs_in,
                s[f"scores{image_id}"],
                np.zeros((lafs_in.shape[0], 0), np.float32),
                s["transformation"][f"depth{image_id}"],
                target_num_keypoints,
                random,
                rng,
            )
            orig = s[f"desc_orig_idx{image_id}"]
            # padding rows (mask False) keep index 0: the gather zeroes them
            row_idx = orig[sel] if orig.shape[0] else np.zeros_like(sel)
            key = s[f"desc_key{image_id}"]
            blocks[key] = s[f"descriptors{image_id}"]
            side_keys.append(key)
            all_lafs.append(lafs)
            all_scores.append(scores)
            all_mask.append(mask)
            all_idx.append(row_idx.astype(np.int32))
            depths[image_id].append(depth)
        kpts, side_info, mask, image_size = _side_tensors(
            samples, image_id, np.stack(all_lafs), np.stack(all_scores), np.stack(all_mask),
            laf_converter, log_response)
        sides.append(KeypointSet(keypoints=kpts, descriptors=torch.zeros(len(samples), target_num_keypoints, 0),
                                 side_info=side_info, mask=mask, image_size=image_size))
        indices.append(torch.from_numpy(np.stack(all_idx)))
        keys.append(side_keys)
    return DeviceDescBatch(
        batch=PairBatch(side0=sides[0], side1=sides[1], transformation=_transformation(samples, depths)),
        keys0=keys[0], keys1=keys[1], index0=indices[0], index1=indices[1], blocks=blocks,
    )


def cast_for_transfer(batch, dtype: torch.dtype = torch.bfloat16):
    """The descriptors and side_info (most of a batch's bytes) in ``dtype``
    for the host-to-device copy, for a model that computes in bf16 and casts
    them on arrival anyway. The geometry (keypoints, depth, K/R/T) stays
    f32: GT generation needs it. A DeviceDescBatch casts its light batch
    (the side_info), so that it reaches the device as host mode's does."""
    if isinstance(batch, DeviceDescBatch):
        return dataclasses.replace(batch, batch=cast_for_transfer(batch.batch, dtype))

    def cast_side(s: KeypointSet) -> KeypointSet:
        return KeypointSet(
            keypoints=s.keypoints,
            descriptors=s.descriptors.to(dtype),
            side_info=s.side_info.to(dtype),
            mask=s.mask,
            image_size=s.image_size,
        )

    return PairBatch(cast_side(batch.side0), cast_side(batch.side1), batch.transformation)


def resize_keypoint_axis(batch, n: int):
    """Pad (zeros, mask False) or truncate every per-keypoint tensor of a
    PairBatch to ``n`` keypoints: a batch of another bucket's shape made from
    a real batch, so that its values are benign (valid masks, finite
    depths). Per-keypoint depth [B, N] follows the keypoint axis; dense depth
    maps [B, H, W] pass through. A DeviceDescBatch resizes its batch and its
    [B, N] index tensors (padding rows index 0)."""

    def fix(x: torch.Tensor) -> torch.Tensor:
        cur = x.shape[1]
        if cur >= n:
            return x[:, :n]
        return torch.cat([x, x.new_zeros(x.shape[0], n - cur, *x.shape[2:])], dim=1)

    if isinstance(batch, DeviceDescBatch):
        return dataclasses.replace(batch, batch=resize_keypoint_axis(batch.batch, n),
                                   index0=fix(batch.index0), index1=fix(batch.index1))

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

"""Bucketed padding of a request's keypoint sets (port of ``choose_bucket`` and
``batch_bucket`` of ``openglue_tpu/data/bucketing.py`` and of
``OpenGlueMatcher._to_bucket`` of ``openglue_tpu/cli/inference.py``).

A server keeps a few keypoint counts (buckets) and pads each request to the
smallest that fits, so that sparse images run on smaller graphs while the
shapes stay few.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from openglue_tpu_torch.core.types import KeypointSet


def choose_bucket(count: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= count; the largest bucket if none fits (the set is
    then cut to its top responses)."""
    for b in sorted(buckets):
        if count <= b:
            return b
    return max(buckets)


def batch_bucket(counts: Sequence[int], buckets: Sequence[int]) -> int:
    """Bucket for a whole batch: fit its largest member."""
    return choose_bucket(max(counts) if len(counts) else min(buckets), buckets)


def to_bucket(
    side: KeypointSet, bucket: int, responses: Optional[torch.Tensor] = None
) -> KeypointSet:
    """Trim or zero-pad a KeypointSet to ``bucket`` keypoints. Trimming keeps,
    per element, the valid keypoints of highest ``responses`` [B, N] (default:
    the first side-info channel, the detector response) in that order, invalid
    ones last; padding rows are zeros with mask False."""
    n = side.num_keypoints
    if n == bucket:
        return side
    fields = (side.keypoints, side.descriptors, side.side_info)
    if n > bucket:
        if responses is None:
            responses = side.side_info[..., 0]
        key = torch.where(side.mask, -responses.double(), responses.new_tensor(float("inf")).double())
        order = torch.argsort(key, dim=1, stable=True)[:, :bucket]
        take = lambda t: torch.gather(t, 1, order[..., None].expand(-1, -1, t.shape[-1]))
        kpts, desc, info = (take(t) for t in fields)
        mask = torch.gather(side.mask, 1, order)
    else:
        pad = lambda t: torch.cat([t, t.new_zeros(t.shape[0], bucket - n, *t.shape[2:])], dim=1)
        kpts, desc, info = (pad(t) for t in fields)
        mask = pad(side.mask)
    return KeypointSet(kpts, desc, info, mask, side.image_size)


def pair_to_bucket(side0: KeypointSet, side1: KeypointSet, buckets: Sequence[int]):
    """Both sides of a request padded to the bucket that fits the larger valid
    count, as the request path does before the matcher."""
    counts = [int(side.mask.sum(dim=1).max()) for side in (side0, side1)]
    bucket = batch_bucket(counts, buckets)
    return to_bucket(side0, bucket), to_bucket(side1, bucket)

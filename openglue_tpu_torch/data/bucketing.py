"""Bucketed padding of keypoint sets (port of ``openglue_tpu/data/bucketing.py``
and of ``OpenGlueMatcher._to_bucket`` of ``openglue_tpu/cli/inference.py``).

A server keeps a few keypoint counts (buckets) and pads each request to the
smallest that fits, so that sparse images run on smaller graphs while the
shapes stay few. The trainer groups samples by bucket before it forms
batches (``BucketGroupedIndexBatches``), so that every batch is uniformly
small or large: per-batch bucketing alone pads a whole batch to the bucket
of its largest member.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

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


def iter_bucket_groups(
    items: Iterable,
    key_fn: Callable[[object], int],
    batch_size: int,
    buckets: Sequence[int],
    drop_last: bool = True,
    num_batches: Optional[int] = None,
) -> Iterator[tuple]:
    """Core grouping loop of ``BucketGroupedIndexBatches``: accumulate items in per-bucket buffers, yield ``(bucket, items)`` when a
    buffer fills; at exhaustion merge leftovers largest-bucket-first (mixed
    tail batches carry the bucket of their largest member). Deterministic
    given (items, key_fn).

    Buffered items are bounded by ``len(buckets) * (batch_size - 1)``."""
    buckets = tuple(sorted(buckets))
    buffers: Dict[int, List] = {b: [] for b in buckets}
    emitted = 0

    def done() -> bool:
        return num_batches is not None and emitted >= num_batches

    for item in items:
        if done():
            return
        b = choose_bucket(key_fn(item), buckets)
        buf = buffers[b]
        buf.append(item)
        if len(buf) == batch_size:
            yield b, buf
            emitted += 1
            buffers[b] = []
    # tail: merge leftovers largest-first so mixed batches pad upward only as
    # far as their largest member requires
    leftovers: List[tuple] = []
    for b in reversed(buckets):
        leftovers.extend((b, item) for item in buffers[b])
    while len(leftovers) >= batch_size and not done():
        chunk = leftovers[:batch_size]
        yield max(b for b, _ in chunk), [item for _, item in chunk]
        emitted += 1
        leftovers = leftovers[batch_size:]
    if leftovers and not drop_last and not done():
        yield max(b for b, _ in leftovers), [item for _, item in leftovers]


class BucketGroupedIndexBatches:
    """Bucket grouping computed on indices and cheap counts, identical on
    every process.

    Grouping loaded samples would let each process pick batch shapes from
    its own stream. Here grouping runs on a global
    index stream with a cheap ``count_fn`` (e.g.
    MegaDepthPairsDatasetFeatures.keypoint_count, h5 metadata only), so every
    process computes the same ``(bucket, global_indices)`` schedule; each
    then loads and collates only ``indices[start:stop]`` of its slice.

    Yields ``(local_indices, {"force_bucket": bucket})``, the batch-sampler
    contract of data/loader.py's DataLoader, which runs the collate in its
    worker pool. ``force_bucket`` is needed because post-crop counts on a
    slice can be smaller than the group's bucket.

    One process is the ``local_slice=None`` case: the same schedule, whole
    batches. The bucket key is the pre-crop count, so a crop that drops many
    keypoints can leave a batch one bucket larger than needed.
    """

    def __init__(
        self,
        indices: Iterable[int],
        count_fn: Callable[[int], int],
        batch_size: int,
        buckets: Sequence[int],
        local_slice: Optional[tuple] = None,
        drop_last: bool = True,
        num_batches: Optional[int] = None,
    ):
        self.indices = indices
        self.count_fn = count_fn
        self.batch_size = batch_size
        self.buckets = tuple(sorted(buckets))
        self.local_slice = local_slice
        self.drop_last = drop_last
        self.num_batches = num_batches

    def __iter__(self) -> Iterator[tuple]:
        for bucket, idxs in iter_bucket_groups(
            self.indices,
            self.count_fn,
            self.batch_size,
            self.buckets,
            drop_last=self.drop_last,
            num_batches=self.num_batches,
        ):
            if self.local_slice is None:
                yield idxs, {"force_bucket": bucket}
                continue
            start, stop = self.local_slice
            if len(idxs) < self.batch_size:
                # partial tail (drop_last=False): slices of it would differ
                # in size across processes; every process sees the same
                # len(idxs), so every process drops it
                continue
            yield idxs[start:stop], {"force_bucket": bucket}

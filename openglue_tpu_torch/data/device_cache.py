"""Device-resident descriptor cache for cached-feature training (port of
``openglue_tpu/data/device_cache.py``).

Descriptors are most of a collated batch's bytes (25.2 of 25.6 MB at
B=12, N=1024, D=256 in f32), and each image's descriptors are reused by
every pair it appears in. The cache keeps per-image descriptor blocks in
device memory, and a batch sends only [B, N] row indices:

  host                              device
  ----                              ------
  collate -> selection indices      cache [slots, cap, D]
  miss    -> one [n, D] block       copied into the first n rows of its slot
  batch   -> slots + indices        gather: cache[slots, idx] -> [B, N, D]

The gathered descriptors feed the train step as the ordinary [B, N, D]
descriptor tensors, so the model and the step are unchanged; padding rows
gather row 0 and are set to +0.0, as the host collate's zero padding.

Data parallelism: every process keeps its own cache over the rows it loads
(the JAX package's per-host design, here per process); validation batches
stay local to the process.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from openglue_tpu_torch.core.types import KeypointSet, PairBatch
from openglue_tpu_torch.data.collate import DeviceDescBatch
from openglue_tpu_torch.train.loop import batch_to_device

Key = Tuple[str, str]


class DeviceDescriptorCache:
    """LRU of per-image descriptor blocks in device memory: one preallocated
    ``[slots, cap, dim]`` tensor of ``dtype`` (512 x 2048 x 256 is 512 MiB
    in bf16, 1 GiB in f32). ``dtype`` is the type in which host
    mode would deliver the descriptors (bf16 where the trainer casts them
    for the transfer, else f32), so that a gathered batch equals the host
    batch bit for bit. ``hits``, ``misses`` and ``bytes_copied`` (the
    blocks copied to the device) count what the cache did.

    Stream order: a miss's copy and every gather are queued on the current
    stream behind the steps already queued. A gather copies its rows out of
    the cache into a new tensor, so a later miss that overwrites a slot
    (``prefetch_to_device`` keeps two batches ahead of the step) lands after
    every gather queued before it has read the slot. A miss copies only the
    image's n rows: the rows of a slot past them hold an older image's, and
    no gather reads them (an index is below n; a padding row reads row 0 and
    is masked)."""

    def __init__(self, slots: int, cap: int, dim: int, dtype: torch.dtype = torch.bfloat16, device="cuda"):
        self.slots, self.cap, self.dim = int(slots), int(cap), int(dim)
        self.dtype = dtype
        self.device = torch.device(device)
        self.cache = torch.zeros(self.slots, self.cap, self.dim, dtype=dtype, device=self.device)
        self.slot_of: "OrderedDict[Key, int]" = OrderedDict()  # LRU order: oldest first
        self._free: List[int] = list(range(self.slots))
        self.hits = self.misses = self.bytes_copied = 0

    def _block_for(self, desc: np.ndarray) -> torch.Tensor:
        """A [n, D] f32 block in the storage type, on the host (page-locked
        for a CUDA cache)."""
        n = desc.shape[0]
        if n > self.cap:
            raise ValueError(
                f"image has {n} keypoints but the device cache cap is {self.cap}: raise data.device_cache_cap"
            )
        if desc.ndim != 2 or desc.shape[1] != self.dim:
            raise ValueError(f"descriptor block of shape {desc.shape}, the cache holds [n, {self.dim}]")
        block = torch.empty(n, self.dim, dtype=self.dtype, pin_memory=self.device.type == "cuda")
        block.copy_(torch.from_numpy(np.asarray(desc, np.float32)))  # rounds to nearest even
        return block

    def ensure(self, keys: Sequence[Key], blocks: Dict[Key, np.ndarray]) -> None:
        """Install the images of ``keys`` that are missing, one copy of an
        [n, D] block each, evicting the least recently used, and refresh
        the LRU order. A batch naming more images than there are slots is
        refused: one of its own images would be evicted before its gather.

        The copy of a miss is asynchronous from page-locked memory. The
        block is a fresh tensor of PyTorch's caching host allocator, which
        records the copy's stream and hands the memory out again only once
        the copy has completed, so dropping the block here is safe."""
        unique = len(set(keys))
        if unique > self.slots:
            raise ValueError(
                f"a batch names {unique} images but the device cache has {self.slots} slots: "
                f"raise data.device_descriptor_cache to at least {unique}"
            )
        for key in keys:
            slot = self.slot_of.get(key)
            if slot is not None:
                self.slot_of.move_to_end(key)
                self.hits += 1
                continue
            self.misses += 1
            block = self._block_for(blocks[key])
            slot = self._free.pop() if self._free else self.slot_of.popitem(last=False)[1]
            self.cache[slot, :block.shape[0]].copy_(block, non_blocking=True)
            self.bytes_copied += block.numel() * block.element_size()
            self.slot_of[key] = slot

    def gather(self, keys: Sequence[Key], idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """[B] image keys, [B, N] row indices and [B, N] mask (on the cache's
        device) -> [B, N, D] descriptors in the storage type, masked rows
        +0.0. One advanced-indexing gather reads the B*N rows straight out
        of the cache."""
        slots = torch.tensor([self.slot_of[k] for k in keys], dtype=torch.int64)
        if self.device.type == "cuda":  # a copy from pageable memory would wait for the stream
            slots = slots.pin_memory()
        slots = slots.to(self.device, non_blocking=True)
        rows = self.cache[slots[:, None], idx.long()]
        return rows.masked_fill(~mask[..., None], 0)

    def to_device(self, item):
        """A batch on the cache's device for the train or eval step: a
        ``DeviceDescBatch`` gets its missing blocks installed, its light
        fields and index tensors copied (``train.loop.batch_to_device``) and
        its descriptors gathered; any other batch is copied as it is."""
        if not isinstance(item, DeviceDescBatch):
            return batch_to_device(item, self.device)
        self.ensure([*item.keys0, *item.keys1], item.blocks)
        moved = batch_to_device(item.batch, self.device)
        index0, index1 = (batch_to_device(t, self.device) for t in (item.index0, item.index1))
        d0 = self.gather(item.keys0, index0, moved.side0.mask)
        d1 = self.gather(item.keys1, index1, moved.side1.mask)

        def side(s: KeypointSet, desc: torch.Tensor) -> KeypointSet:
            return KeypointSet(s.keypoints, desc, s.side_info, s.mask, s.image_size)

        return PairBatch(side(moved.side0, d0), side(moved.side1, d1), moved.transformation)

"""Scene-balanced infinite sampling with per-process sharding (port of
``openglue_tpu/data/sampler.py``; reference
data/megadepth_balanced_sampler.py:8-38).

The shard count and index are the world size and rank of ``torch.distributed``
when it is initialized, else 1 and 0. The sampler is a plain generator: pick
a scene uniformly (pair probability ∝ 1/#pairs-in-scene), then a pair
uniformly within the scene.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch.distributed as dist


def process_shard() -> Tuple[int, int]:
    """(number of shards, this process's shard): the world size and rank of
    ``torch.distributed`` when it is initialized, else (1, 0)."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class BalancedSceneSampler:
    """Yields flat dataset indices, scene-balanced, infinite
    (reference megadepth_balanced_sampler.py:25-35)."""

    def __init__(
        self,
        scene_sizes: Dict[str, int],
        seed: int = 0,
        num_shards: Optional[int] = None,
        shard_index: Optional[int] = None,
    ):
        if num_shards is None:
            num_shards, shard_index = process_shard()
        self.scenes: List[str] = [s for s, n in scene_sizes.items() if n > 0]
        if not self.scenes:
            # fail at construction with a diagnosable message instead of a
            # ValueError deep in the loader's feeder thread mid-training
            raise ValueError(
                "BalancedSceneSampler: no scene has any pairs — check the "
                f"scene list against the dataset root (got {len(scene_sizes)} "
                "scenes, all empty or missing pairs.txt)"
            )
        self.sizes = [scene_sizes[s] for s in self.scenes]
        # flat-index offset of each scene (index layout of MegaDepthPairsIndex)
        offsets, off = [], 0
        for s, n in scene_sizes.items():
            offsets.append(off)
            off += n
        self.offsets = {s: o for s, o in zip(scene_sizes, offsets)}
        # per-shard derived seed (reference :11-14 uses rank-offset seeds)
        self.rng = np.random.default_rng(np.random.SeedSequence([seed, shard_index]))

    def __iter__(self) -> Iterator[int]:
        while True:
            scene_idx = int(self.rng.integers(len(self.scenes)))
            scene = self.scenes[scene_idx]
            pair_idx = int(self.rng.integers(self.sizes[scene_idx]))
            yield self.offsets[scene] + pair_idx


class ShardedSequentialSampler:
    """Finite per-host slice for validation: indices i with
    i % num_shards == shard_index (deterministic, no repetition)."""

    def __init__(
        self,
        length: int,
        num_shards: Optional[int] = None,
        shard_index: Optional[int] = None,
    ):
        if num_shards is None:
            num_shards, shard_index = process_shard()
        self.indices = list(range(shard_index, length, num_shards))

    def __iter__(self):
        return iter(self.indices)

    def __len__(self):
        return len(self.indices)

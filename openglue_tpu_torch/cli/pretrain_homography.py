"""Homography pretraining on an image folder (port of
``openglue_tpu/cli/pretrain_homography.py``; reference
pretrain_homography.py): random perspective warps of single images provide
exact GT, thresholds 3/3 px.

Usage:
  python -m openglue_tpu_torch.cli.pretrain_homography \\
      --config configs/homography_pretraining.yaml [--config_override o.yaml] \\
      [--checkpoint dir] [--smoke] [--device cuda|cpu]

The model trains on ``--device`` (default ``cuda``, which must be present).
Under a launcher such as torchrun it trains data-parallel
(``cli/online.py``): ``data.batch_size`` is the global batch, and each
process draws its own rows of it from a stream seeded by its first row, as
the JAX package's hosts do.
"""

from __future__ import annotations

import argparse

import numpy as np

from openglue_tpu_torch.cli import common
from openglue_tpu_torch.cli.online import collate_image_pairs, require_device, run_online_training
from openglue_tpu_torch.data.sampler import process_shard
from openglue_tpu_torch.parallel import local_batch_slice


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", default="configs/homography_pretraining.yaml")
    parser.add_argument("--config_override", default=None)
    parser.add_argument("--checkpoint", default=None, help="resume from this checkpoint dir")
    parser.add_argument("--smoke", action="store_true", help="tiny loop for CI")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = require_device(args.device)
    config = common.load_merged_config(args.config, args.config_override)
    if args.smoke:
        config["train"]["steps_per_epoch"] = 2
        config["train"]["epochs"] = 1

    from openglue_tpu_torch.data.homography import HomographyPairsDataset
    from openglue_tpu_torch.data.loader import DataLoader

    data = config["data"]
    start, stop = local_batch_slice(int(data["batch_size"]))
    batch_size = stop - start
    target_size = tuple(data.get("target_size", (960, 720)))
    offset = int(data.get("warp_offset", 256))
    dataset = HomographyPairsDataset(data["root_path"], target_size=target_size, max_corner_offset=offset,
                                     seed=int(config.get("train.seed", 0)) + start)
    rng = np.random.default_rng(1234 + start)

    def infinite_indices():
        while True:
            yield int(rng.integers(len(dataset)))

    pin = device.type == "cuda"
    loader = DataLoader(dataset, batch_size=batch_size, collate_fn=lambda s: collate_image_pairs(s, pin),
                        sampler=infinite_indices(), num_workers=int(data.get("dataloader_workers", 2)))

    # Optional homography-precision validation (the reference disables eval in
    # pretraining — 'evaluation: False'; enable with train.evaluation: true)
    val_loader_fn = None
    if config.get("train.evaluation", False):
        val_ds = HomographyPairsDataset(data["root_path"], target_size=target_size, max_corner_offset=offset,
                                        color_augmentation=False, seed=999)
        n_val = min(len(val_ds), int(data.get("val_pairs", 32)))
        world, rank = process_shard()  # each process evaluates its share of the pairs
        val_loader_fn = lambda: DataLoader(
            val_ds, batch_size=batch_size, collate_fn=lambda s: collate_image_pairs(s, pin),
            sampler=iter([i % len(val_ds) for i in range(rank, n_val, world)]), num_workers=0,
        )

    state, _, _ = run_online_training(config, loader, val_loader_fn, checkpoint=args.checkpoint, device=device)
    return state


if __name__ == "__main__":
    main()

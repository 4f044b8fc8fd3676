"""Homography pretraining on an image folder (port of
``openglue_tpu/cli/pretrain_homography.py``; reference
pretrain_homography.py): random perspective warps of single images provide
exact GT, thresholds 3/3 px.

Usage:
  python -m openglue_tpu_torch.cli.pretrain_homography \\
      --config configs/homography_pretraining.yaml [--config_override o.yaml] \\
      [--checkpoint dir] [--smoke] [--device cuda|cpu]

The model trains on ``--device`` (default ``cuda``, which must be present).
A data-parallel world above one process is not ported yet (ROADMAP.md
module 10a) and raises.
"""

from __future__ import annotations

import argparse

import numpy as np

from openglue_tpu_torch.cli import common
from openglue_tpu_torch.cli.online import check_world, collate_image_pairs, require_device, run_online_training


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", default="configs/homography_pretraining.yaml")
    parser.add_argument("--config_override", default=None)
    parser.add_argument("--checkpoint", default=None, help="resume from this checkpoint dir")
    parser.add_argument("--smoke", action="store_true", help="tiny loop for CI")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    check_world()
    device = require_device(args.device)
    config = common.load_merged_config(args.config, args.config_override)
    if args.smoke:
        config["train"]["steps_per_epoch"] = 2
        config["train"]["epochs"] = 1

    from openglue_tpu_torch.data.homography import HomographyPairsDataset
    from openglue_tpu_torch.data.loader import DataLoader

    data = config["data"]
    batch_size = int(data["batch_size"])
    target_size = tuple(data.get("target_size", (960, 720)))
    offset = int(data.get("warp_offset", 256))
    dataset = HomographyPairsDataset(data["root_path"], target_size=target_size, max_corner_offset=offset,
                                     seed=int(config.get("train.seed", 0)))
    rng = np.random.default_rng(1234)

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
        val_loader_fn = lambda: DataLoader(
            val_ds, batch_size=batch_size, collate_fn=lambda s: collate_image_pairs(s, pin),
            sampler=iter([i % len(val_ds) for i in range(n_val)]), num_workers=0,
        )

    state, _, _ = run_online_training(config, loader, val_loader_fn, checkpoint=args.checkpoint, device=device)
    return state


if __name__ == "__main__":
    main()

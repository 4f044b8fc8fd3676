"""Online end-to-end MegaDepth training (port of ``openglue_tpu/cli/train.py``;
reference train.py): the device extractor and the matcher in one step.

Usage:
  python -m openglue_tpu_torch.cli.train --config configs/config.yaml \\
      --features_config configs/features_online/superpoint_magicleap.yaml \\
      [--config_override o.yaml] [--checkpoint dir] [--smoke] [--device cuda|cpu]

The model trains on ``--device`` (default ``cuda``, which must be present).
Under a launcher such as torchrun it trains data-parallel
(``cli/online.py``): ``data.batch_size`` is the global batch, each process
samples its rows from its own stream (seeded by its rank) and validates its
share of the pairs.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from openglue_tpu_torch.cli import common
from openglue_tpu_torch.cli.online import collate_image_pairs, require_device, run_online_training
from openglue_tpu_torch.core.config import load_config
from openglue_tpu_torch.parallel import local_batch_slice


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", default="configs/config.yaml")
    parser.add_argument("--config_override", default=None)
    parser.add_argument("--features_config", default="configs/features_online/superpoint_magicleap.yaml")
    parser.add_argument("--checkpoint", default=None, help="resume from this checkpoint dir")
    parser.add_argument("--smoke", action="store_true", help="tiny loop for CI")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = require_device(args.device)
    config = common.load_merged_config(args.config, args.config_override)
    features_config = load_config(args.features_config)
    if args.smoke:
        config["train"]["steps_per_epoch"] = 2
        config["train"]["epochs"] = 1

    from openglue_tpu_torch.data.loader import DataLoader
    from openglue_tpu_torch.data.megadepth import MegaDepthPairsDataset
    from openglue_tpu_torch.data.sampler import BalancedSceneSampler, ShardedSequentialSampler

    data = config["data"]
    root = data["root_path"]

    def read_scene_list(path):
        p = Path(path)
        if not p.is_absolute():
            p = Path(root) / p
        return [s.strip() for s in p.read_text().splitlines() if s.strip()]

    start, stop = local_batch_slice(int(data["batch_size"]))
    batch_size = stop - start
    target_size = tuple(data.get("target_size", (960, 720)))
    workers = int(data.get("dataloader_workers", 2))
    pin = device.type == "cuda"
    collate = lambda samples: collate_image_pairs(samples, pin)
    train_ds = MegaDepthPairsDataset(
        root, read_scene_list(data["train_list_path"]), target_size=target_size, random_crop=True,
        overlap=tuple(data["train_pairs_overlap"]) if data.get("train_pairs_overlap") else None,
    )
    loader = DataLoader(train_ds, batch_size=batch_size, collate_fn=collate,
                        sampler=iter(BalancedSceneSampler(train_ds.index.scene_sizes())), num_workers=workers)
    val_ds = MegaDepthPairsDataset(
        root, read_scene_list(data["val_list_path"]), target_size=target_size, random_crop=False,
        max_pairs_per_scene=data.get("val_max_pairs_per_scene"),
    )
    val_loader_fn = None
    if len(val_ds):
        val_loader_fn = lambda: DataLoader(val_ds, batch_size=batch_size, collate_fn=collate,
                                           sampler=iter(ShardedSequentialSampler(len(val_ds))),
                                           num_workers=workers)
    state, _, _ = run_online_training(config, loader, val_loader_fn, features_config=features_config,
                                      checkpoint=args.checkpoint, device=device)
    return state


if __name__ == "__main__":
    main()

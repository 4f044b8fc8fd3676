"""Standalone evaluation (port of ``openglue_tpu/cli/evaluate.py``): run a
trained matcher over MegaDepth validation pairs and report epipolar precision
/ matching score / pose AUC (the reference's `trainer.validate` path,
matching_module.py:107-131, as a CLI).

The pairs are taken in order (``ShardedSequentialSampler``, each process of
``torch.distributed`` its share when a group is initialized), each batch
padded to the smallest of ``data.buckets`` that fits it; the metrics are
``train.loop.evaluate``'s.

Usage:
  python -m openglue_tpu_torch.cli.evaluate --experiment logs/<name>/<exp> \\
      [--config configs/config_cached.yaml] [--max_pairs 200] [--device cuda|cpu]

The matcher runs on ``--device`` (default ``cuda``, which must be present).
"""

from __future__ import annotations

import argparse
import json
from functools import partial
from pathlib import Path

import torch

from openglue_tpu_torch.cli import common
from openglue_tpu_torch.core.config import load_config


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--experiment", required=True, help="training experiment dir")
    parser.add_argument("--config", default=None, help="data config (defaults to the experiment's)")
    parser.add_argument("--checkpoint_step", type=int, default=None)
    parser.add_argument("--split", default="val", choices=["val", "test"])
    parser.add_argument("--max_pairs", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from openglue_tpu_torch.data.collate import stack_keypoints_batch
    from openglue_tpu_torch.data.loader import DataLoader
    from openglue_tpu_torch.data.megadepth import MegaDepthPairsDatasetFeatures
    from openglue_tpu_torch.data.sampler import ShardedSequentialSampler, process_shard
    from openglue_tpu_torch.features.lafs import get_laf_to_sideinfo_converter
    from openglue_tpu_torch.models.superglue import SuperGlue
    from openglue_tpu_torch.parallel.distributed import initialize
    from openglue_tpu_torch.train.checkpoint import restore_train_state
    from openglue_tpu_torch.train.loop import batch_to_device, evaluate
    from openglue_tpu_torch.train.state import create_train_state
    from openglue_tpu_torch.train.step import make_eval_step

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu to evaluate on the CPU)")
    initialize(device_type=device.type)  # a no-op unless a launcher named a job
    exp = Path(args.experiment)
    config = common.load_merged_config(str(exp / "config.yaml"), args.config)
    features_config = load_config(exp / "features_config.yaml")
    descriptor_dim = int(features_config["descriptor_dim"])

    laf_method = config.get("superglue.laf_to_sideinfo_method", "none")
    laf_converter = get_laf_to_sideinfo_converter(laf_method)
    sg_config = common.superglue_config_from(config, descriptor_dim, laf_converter.side_info_dim)
    model = SuperGlue(sg_config, device=device)

    data = config["data"]
    root = data["root_path"]
    list_key = "val_list_path" if args.split == "val" else "test_list_path"

    def read_scene_list(path):
        p = Path(path)
        if not p.is_absolute():
            p = Path(root) / p
        return [s.strip() for s in p.read_text().splitlines() if s.strip()]

    dataset = MegaDepthPairsDatasetFeatures(
        root, data["features_dir"], read_scene_list(data[list_key]),
        target_size=tuple(data.get("target_size", (960, 720))),
        random_crop=False,
        max_pairs_per_scene=data.get("val_max_pairs_per_scene"),
    )
    length = len(dataset)
    if args.max_pairs is not None:
        length = min(length, args.max_pairs)
    if length == 0:
        raise SystemExit("no evaluation pairs found")
    num_kpts = int(data.get("max_keypoints", 1024))
    # data.buckets: bucketed padding, same contract as the train_cached CLI.
    buckets = data.get("buckets")
    buckets = tuple(int(b) for b in buckets) if buckets else None
    world, _ = process_shard()
    batch_size = max(int(data.get("batch_size", 8)) // world, 1)
    loader = DataLoader(
        dataset,
        batch_size=batch_size,
        collate_fn=partial(
            stack_keypoints_batch,
            target_num_keypoints=num_kpts,
            random=False,
            laf_converter=laf_converter,
            buckets=buckets,
        ),
        sampler=iter(ShardedSequentialSampler(length)),
        num_workers=int(data.get("dataloader_workers", 2)),
        drop_last=False,
    )

    state = create_train_state(model, optimizer=common.optimizer_from(config, model.parameters()))
    restore_train_state(exp / "checkpoints", state, step=args.checkpoint_step)
    eval_step = make_eval_step(float(config.get("inference.match_threshold", 0.2)))
    loop_cfg = common.loop_config_from(config, None)
    metrics = evaluate(state, eval_step, loader, loop_cfg, to_device=partial(batch_to_device, device=device))
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()

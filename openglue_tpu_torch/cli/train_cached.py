"""Cached-feature MegaDepth training (port of ``openglue_tpu/cli/train_cached.py``;
reference train_cached.py).

The features config is read from ``<root>/<features_dir>/config.yaml``, the
contract written by the feature cacher (reference train_cached.py:58-59 /
extract_features.py:103-104).

Usage:
  python -m openglue_tpu_torch.cli.train_cached --config configs/config_cached.yaml \\
      [--config_override my.yaml] [--checkpoint dir] [--smoke] [--device cuda|cpu] [--checkify]

The model trains on ``--device`` (default ``cuda``, which must be present).
Data-parallel training runs one process per device under a launcher that
names the job, such as
``torchrun --nproc_per_node=N -m openglue_tpu_torch.cli.train_cached ...``
(NCCL on cards, gloo with ``--device cpu``): ``data.batch_size`` is the
global batch, each rank loads its rows of it, and every rank takes the step
one process would take on the whole batch.

``data.device_descriptor_cache: S`` (S > 0) keeps each image's descriptors
in a device-resident cache of S slots of ``data.device_cache_cap`` rows
(data/device_cache.py), and a batch carries row indices instead of
descriptors; every process of a data-parallel job keeps its own cache.
``--checkify`` runs the train step under the NaN, division and index checks
of ``debugging.checked`` (slower; one process only, and the bucket warm-up
is skipped).
"""

from __future__ import annotations

import argparse
import itertools
from functools import partial
from pathlib import Path

import torch

from openglue_tpu_torch.cli import common
from openglue_tpu_torch.parallel import data_parallel_world_size, initialize, local_batch_slice


def descriptor_transfer_dtype(config) -> torch.dtype:
    """The type in which descriptors reach the device: bf16 for a model that
    computes in bf16 (``superglue.dtype``) unless ``data.transfer_bf16`` is
    false, f32 otherwise. Host mode casts the batch to it; the device cache
    stores its blocks in it."""
    bf16 = (str(config.get("superglue.dtype") or "") in ("bfloat16", "bf16")
            and bool(config.get("data.transfer_bf16", True)))
    return torch.bfloat16 if bf16 else torch.float32


def build_dataloaders(config, laf_converter, pin_memory: bool = False):
    """(train loader, function making a val loader) of this process from the
    ``data`` section; ``data.batch_size`` is the global batch, of which each
    process of a data-parallel job loads its rows (``local_batch_slice``).
    With bucket grouping every process forms the same grouped schedule from
    one global sampler stream and keeps its slice of each batch, so that the
    global batches are the ones one process forms; without it each process
    samples its own stream (seeded by its rank). Validation is this
    process's share of the pairs, in batches of its share of the batch size.
    ``pin_memory``: the workers put each batch in page-locked memory for a
    non-blocking copy to a CUDA device. With ``data.device_descriptor_cache``
    above 0 the datasets carry descriptor blocks and row indices and the
    collate makes ``DeviceDescBatch``es (data/collate.py)."""
    from openglue_tpu_torch.data.bucketing import BucketGroupedIndexBatches
    from openglue_tpu_torch.data.collate import (
        cast_for_transfer, stack_keypoints_batch, stack_keypoints_batch_device,
    )
    from openglue_tpu_torch.data.loader import DataLoader
    from openglue_tpu_torch.data.megadepth import MegaDepthPairsDatasetFeatures
    from openglue_tpu_torch.data.sampler import BalancedSceneSampler, ShardedSequentialSampler
    from openglue_tpu_torch.train.loop import pin_batch

    data = config["data"]
    root = data["root_path"]

    def read_scene_list(path):
        p = Path(path)
        if not p.is_absolute():
            p = Path(root) / p
        return [s.strip() for s in p.read_text().splitlines() if s.strip()]

    num_kpts = int(data.get("max_keypoints", 1024))
    # data.buckets: each batch is padded to the smallest bucket that fits
    # its largest keypoint count (data/bucketing.py)
    buckets = data.get("buckets")
    buckets = tuple(int(b) for b in buckets) if buckets else None
    # data.bucket_grouping: samples are grouped by bucket before batches are
    # formed, on indices with h5-metadata keypoint counts, so loading and
    # collate both run in the loader's workers
    bucket_grouping = bool(data.get("bucket_grouping")) and buckets is not None
    global_batch = int(data["batch_size"])
    start, stop = local_batch_slice(global_batch)
    batch_size = stop - start
    cache_images = int(data.get("cache_images", 64))
    target_size = tuple(data.get("target_size", (960, 720)))
    device_desc = int(data.get("device_descriptor_cache", 0) or 0) > 0
    train_ds = MegaDepthPairsDatasetFeatures(
        root, data["features_dir"], read_scene_list(data["train_list_path"]),
        target_size=target_size,
        random_crop=True,
        overlap=tuple(data["train_pairs_overlap"]) if data.get("train_pairs_overlap") else None,
        cache_images=cache_images,
        device_descriptors=device_desc,
    )
    val_ds = MegaDepthPairsDatasetFeatures(
        root, data["features_dir"], read_scene_list(data["val_list_path"]),
        target_size=target_size,
        random_crop=False,
        max_pairs_per_scene=data.get("val_max_pairs_per_scene"),
        cache_images=cache_images,
        device_descriptors=device_desc,
    )

    def collate(random):
        base = partial(stack_keypoints_batch_device if device_desc else stack_keypoints_batch,
                       target_num_keypoints=num_kpts, random=random, laf_converter=laf_converter,
                       buckets=buckets)
        # a bf16-compute model casts descriptors to bf16 on arrival: cast
        # them (and side_info) here and the copy to the device halves
        # (data.transfer_bf16); the device cache stores them in that type
        cast = descriptor_transfer_dtype(config) == torch.bfloat16
        if not cast and not pin_memory:
            return base

        def run(samples, **kw):
            batch = base(samples, **kw)
            batch = cast_for_transfer(batch) if cast else batch
            return pin_batch(batch) if pin_memory else batch

        return run

    train_collate, val_collate = collate(True), collate(False)
    workers = int(data.get("dataloader_workers", 2))

    if bucket_grouping:
        global_stream = BalancedSceneSampler(train_ds.index.scene_sizes(), num_shards=1, shard_index=0)
        groups = BucketGroupedIndexBatches(
            iter(global_stream), train_ds.keypoint_count,
            batch_size=global_batch, buckets=buckets, local_slice=(start, stop),
        )
        train_loader = DataLoader(train_ds, batch_size=batch_size, collate_fn=train_collate,
                                  batch_sampler=iter(groups), num_workers=workers)
    else:
        train_loader = DataLoader(train_ds, batch_size=batch_size, collate_fn=train_collate,
                                  sampler=iter(BalancedSceneSampler(train_ds.index.scene_sizes())),
                                  num_workers=workers)

    # validation keeps the trailing partial batch (drop_last=False), grouped
    # or not: the metrics see every pair
    def make_val_loader():
        sampler = iter(ShardedSequentialSampler(len(val_ds)))
        if not bucket_grouping:
            return DataLoader(val_ds, batch_size=batch_size, collate_fn=val_collate,
                              sampler=sampler, num_workers=workers, drop_last=False)
        groups = BucketGroupedIndexBatches(
            sampler, val_ds.keypoint_count, batch_size=batch_size, buckets=buckets, drop_last=False,
        )
        return DataLoader(val_ds, batch_size=batch_size, collate_fn=val_collate,
                          batch_sampler=iter(groups), num_workers=workers, drop_last=False)

    return train_loader, make_val_loader


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", default="configs/config_cached.yaml")
    parser.add_argument("--config_override", default=None)
    parser.add_argument("--checkpoint", default=None, help="resume from this checkpoint dir")
    parser.add_argument("--smoke", action="store_true", help="tiny loop for CI")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--checkify", action="store_true",
                        help="run the train step under NaN, division and index checks (debugging; slower)")
    args = parser.parse_args(argv)
    if args.checkify and data_parallel_world_size() > 1:
        # the JAX package keeps its checkify path to one process (its error
        # reduction is not mesh-aware), and so does the port
        raise ValueError(f"--checkify runs in one process; this job has {data_parallel_world_size()}")

    config = common.load_merged_config(args.config, args.config_override)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu to train on the CPU)")
    initialize(device_type=device.type)  # the job a launcher names, if any
    if args.smoke:
        config["train"]["steps_per_epoch"] = 2
        config["train"]["epochs"] = 1

    # Imported here, at call time, and not at module level: chip_smoke.py's
    # trainer phase replaces make_train_step, make_eval_step,
    # warm_up_buckets and DeviceDescriptorCache in their modules (and
    # loop.evaluate and DataLoader.__iter__, which fit and build_dataloaders
    # look up when they run) to count each step's launches.
    from openglue_tpu_torch.core.config import load_config
    from openglue_tpu_torch.features.lafs import get_laf_to_sideinfo_converter
    from openglue_tpu_torch.models.superglue import SuperGlue
    from openglue_tpu_torch.train.checkpoint import load_weights, restore_train_state
    from openglue_tpu_torch.train.loop import batch_to_device, fit, warm_up_buckets
    from openglue_tpu_torch.train.state import create_train_state
    from openglue_tpu_torch.train.step import make_eval_step, make_train_step

    features_dir = Path(config["data"]["root_path"]) / config["data"]["features_dir"]
    features_config = load_config(features_dir / "config.yaml")
    descriptor_dim = int(features_config["descriptor_dim"])

    laf_converter = get_laf_to_sideinfo_converter(config.get("superglue.laf_to_sideinfo_method", "none"))
    sg_config = common.superglue_config_from(config, descriptor_dim, laf_converter.side_info_dim)
    model = SuperGlue(sg_config, device=device, generator=torch.Generator().manual_seed(0))
    # superglue.weights: warm-start the matcher alone (reference
    # superglue.py:25-27): .pth/.pt is a reference-keyed torch state dict,
    # anything else a save_weights npz tree of either package
    warm_start = config.get("superglue.weights")
    if warm_start:
        if str(warm_start).endswith((".pth", ".pt")):
            sd = torch.load(warm_start, map_location="cpu", weights_only=True)
            model.load_state_dict(sd.get("state_dict", sd))
        else:
            load_weights(warm_start, model)

    log_dir = common.prepare_logging_directory(config, features_config)
    train_loader, val_loader_fn = build_dataloaders(config, laf_converter, pin_memory=device.type == "cuda")
    state = create_train_state(model, optimizer=common.optimizer_from(config, model.parameters()))
    # resume the whole train state: the CLI flag, else the config's top-level
    # `checkpoint:` (reference config_cached_sp_magicleap.yaml:73, train.py:83-85)
    resume_from = args.checkpoint or config.get("checkpoint")
    if resume_from:
        restore_train_state(resume_from, state)

    mesh, _, shard_train_step, _ = common.build_mesh_and_sharding(device.type)
    train_step = shard_train_step(make_train_step(common.loss_config_from(config)), mesh)
    if args.checkify:
        from openglue_tpu_torch.debugging import checked

        train_step = checked(train_step)
    eval_step = make_eval_step(float(config.get("inference.match_threshold", 0.2)))
    to_device = partial(batch_to_device, device=device)
    cache_slots = int(config.get("data.device_descriptor_cache", 0) or 0)
    if cache_slots > 0:
        # this process's cache over the rows it loads; its to_device installs
        # a batch's missing images and gathers its descriptors, for the
        # training, the warm-up and the validation
        from openglue_tpu_torch.data.device_cache import DeviceDescriptorCache

        to_device = DeviceDescriptorCache(cache_slots, cap=int(config.get("data.device_cache_cap", 2048)),
                                          dim=descriptor_dim, dtype=descriptor_transfer_dtype(config),
                                          device=device).to_device

    train_iter = iter(train_loader)
    first = next(train_iter)
    buckets = config.get("data.buckets")
    if buckets and bool(config.get("train.precompile_buckets", True)) and not args.checkify:
        num_kpts = int(config.get("data.max_keypoints", 1024))
        warm_up_buckets(train_step, state, first, sorted({min(int(b), num_kpts) for b in buckets}), to_device)

    loop_cfg = common.loop_config_from(config, log_dir, lr_schedule=state.optimizer.schedule)
    return fit(state, train_step, itertools.chain([first], train_iter), loop_cfg,
               eval_step=eval_step, eval_batches_fn=val_loader_fn, to_device=to_device)


if __name__ == "__main__":
    main()

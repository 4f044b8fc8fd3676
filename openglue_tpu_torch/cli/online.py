"""Shared online-training assembly for train.py / pretrain_homography.py (port
of ``openglue_tpu/cli/online.py``; the reference's train.py and
pretrain_homography.py differ only in the dataset and the GT thresholds).

The model is a ``MatchingModule`` (extractor + matcher) on each process's
device. In a data-parallel job (a launcher such as torchrun names it; the
CLIs call ``parallel.initialize``) each process loads its rows of each global
batch and the step is ``parallel.shard_train_step``'s: every rank takes the
update one process takes on the whole batch, its augmentation drawn for the
whole batch; a fine-tuned extractor's BatchNorms take their statistics over
the global batch (``models.layers.GroupBatchNorm2d``).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from openglue_tpu_torch.cli import common
from openglue_tpu_torch.core.types import Transformation, map_tensors
from openglue_tpu_torch.parallel import initialize


def collate_image_pairs(samples, pin_memory: bool = False):
    """Image-pair sample dicts -> a dict batch of tensors: image0/1 [B, H, W]
    and the ``Transformation`` (perspective or 3d_reprojection). With
    ``pin_memory`` every tensor is page-locked, for a non-blocking copy to a
    CUDA device."""
    def stack(arrays):
        return torch.from_numpy(np.stack(arrays))

    tfs = [s["transformation"] for s in samples]
    kind = tfs[0]["type"]
    names = ("H",) if kind == "perspective" else ("K0", "K1", "R", "T", "depth0", "depth1")
    batch = {
        "image0": stack([s["image0"] for s in samples]),
        "image1": stack([s["image1"] for s in samples]),
        "transformation": Transformation(kind=kind, **{k: stack([t[k] for t in tfs]) for k in names}),
    }
    return map_tensors(batch, lambda t: t.pin_memory()) if pin_memory else batch


def image_batch_to_device(batch, device):
    """The dict batch on ``device``; from pinned memory the copies are queued
    behind the device's running work."""
    return map_tensors(batch, lambda t: t.to(device, non_blocking=True))


def build_matching_module(config, features_config=None, device="cuda"):
    """MatchingModule from the merged config (+ the separate features config
    of the online MegaDepth path): the matcher drawn from
    ``torch.Generator().manual_seed(0)``, the extractor's convolutions too,
    as ``cli.extract_features.build_device_extractor`` draws them."""
    from openglue_tpu_torch.models.matching_module import MatchingModule, MatchingModuleConfig

    module_config = MatchingModuleConfig.from_dict({
        "features": features_config if features_config is not None else config.get("features", {}),
        "laf_to_sideinfo_method": config.get("superglue.laf_to_sideinfo_method", "none"),
        "superglue": dict(config.get("superglue", {})),
        "train": {"finetune_features_extractor": bool(config.get("train.finetune_features_extractor", False))},
    })
    return MatchingModule(module_config, device=device, generator=torch.Generator().manual_seed(0),
                          extractor_generator=torch.Generator().manual_seed(0))


def load_extractor_weights_into(model, weights_path: Optional[str]):
    """Load a torch extractor checkpoint into ``model.extractor``
    (``features.superpoint.load_extractor_weights``); no path, no change.
    Returns ``model``."""
    if weights_path:
        from openglue_tpu_torch.features.superpoint import load_extractor_weights

        device = next(model.superglue.parameters()).device
        load_extractor_weights(model.extractor, weights_path)
        model.extractor.to(device)
    return model


def require_device(device) -> torch.device:
    """``device``, after the job a launcher names, if any, is started on it
    (``parallel.initialize``); a CUDA device must be present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu to train on the CPU)")
    initialize(device_type=device.type)
    return device


def run_online_training(
    config,
    train_loader,
    val_loader_fn: Optional[Callable],
    features_config=None,
    checkpoint: Optional[str] = None,
    device="cuda",
):
    """Build the MatchingModule, its optimizer and steps, and ``fit`` it;
    returns (state, model, log_dir). The experiment directory gets the
    features config (``config['features']`` where no separate one is given)
    as its ``features_config.yaml``, so that ``cli.inference`` serves it."""
    # Imported here, at call time: chip_smoke.py's online phase replaces the
    # step builders in their modules to count and hold each step's launches.
    from openglue_tpu_torch.core.config import Config
    from openglue_tpu_torch.train.checkpoint import restore_train_state
    from openglue_tpu_torch.train.loop import evaluate_online, fit
    from openglue_tpu_torch.train.state import create_train_state, make_online_optimizer
    from openglue_tpu_torch.train.step import make_online_eval_step, make_online_train_step

    device = require_device(device)
    model = build_matching_module(config, features_config, device)
    snapshot = features_config
    if snapshot is None and config.get("features"):
        snapshot = Config(dict(config.get("features")))
    log_dir = common.prepare_logging_directory(config, snapshot)
    load_extractor_weights_into(model, (features_config or config.get("features", {}) or {}).get("weights"))

    optimizer = make_online_optimizer(
        model,
        learning_rate=float(config.get("train.lr", 1e-4)),
        gamma=float(config.get("train.scheduler_gamma", 0.999994)),
        gradient_clip=float(config.get("train.grad_clip", 10.0)),
        finetune_extractor=bool(config.get("train.finetune_features_extractor", False)),
    )
    state = create_train_state(model, optimizer=optimizer)
    if checkpoint:
        restore_train_state(checkpoint, state)

    mesh, _, shard_train_step, _ = common.build_mesh_and_sharding(device.type)
    step = shard_train_step(make_online_train_step(common.loss_config_from(config),
                                                   augmentation=config.get("train.augmentations.name", "none"),
                                                   seed=int(config.get("train.seed", 0))), mesh)
    eval_step = None
    if val_loader_fn is not None:
        eval_step = make_online_eval_step(float(config.get("inference.match_threshold", 0.2)))
    loop_cfg = common.loop_config_from(config, log_dir, lr_schedule=state.optimizer.schedule)
    state = fit(state, step, train_loader, loop_cfg, eval_step=eval_step, eval_batches_fn=val_loader_fn,
                to_device=partial(image_batch_to_device, device=device), evaluate_fn=evaluate_online)
    return state, model, log_dir

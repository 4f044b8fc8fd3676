"""Shared CLI plumbing (port of ``openglue_tpu/cli/common.py``; reference
train.py:22-66, utils/train_utils.py:13-30): config loading and merging, the
experiment's name and logging directory with its config snapshots, and the
model, loss, optimizer and loop settings built from a config's sections,
and the data-parallel mesh of the job (``build_mesh_and_sharding``). Each
takes a ``Config`` or a plain dict."""

from __future__ import annotations

import dataclasses
import datetime
from pathlib import Path
from typing import Any, Iterable, Mapping, Optional

import torch
import torch.distributed as dist

from openglue_tpu_torch import parallel
from openglue_tpu_torch.core.config import Config, load_config, merge_configs, save_config
from openglue_tpu_torch.models.superglue import SuperGlueConfig
from openglue_tpu_torch.parallel.distributed import is_main_process
from openglue_tpu_torch.train.loop import TrainLoopConfig
from openglue_tpu_torch.train.state import ClippedAdam, Schedule, make_lr_schedule, make_optimizer, make_warmup_optimizer
from openglue_tpu_torch.train.step import LossConfig


def load_merged_config(base_path: str, override_path: Optional[str] = None) -> Config:
    """Base YAML + optional override merged (reference train.py:22-27)."""
    base = load_config(base_path)
    if override_path:
        return merge_configs(base, load_config(override_path))
    return base


def experiment_name(config: Config, features_config: Optional[Config]) -> str:
    """`{features}__attn_{...}__laf_{...}__{timestamp}` (reference train.py:33-38)."""
    features = features_config["name"] if features_config else "cached"
    attention = config.get("superglue.attention_gnn.attention", "softmax")
    laf = config.get("superglue.laf_to_sideinfo_method", "none")
    stamp = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    return f"{features}__attn_{attention}__laf_{laf}__{stamp}"


def prepare_logging_directory(config: Config, features_config: Optional[Config] = None) -> Path:
    """The experiment's directory, made with snapshots of the configs by the
    main process (reference utils/train_utils.py:13-30)."""
    root = Path(config.get("logging.root_path", "logs"))
    name = config.get("logging.name", "default")
    stamped = [experiment_name(config, features_config)]
    if dist.is_initialized():  # rank 0's time stamp names the one directory
        dist.broadcast_object_list(stamped, src=0)
    log_dir = root / name / stamped[0]
    if is_main_process():
        log_dir.mkdir(parents=True, exist_ok=True)
        save_config(config, log_dir / "config.yaml")
        if features_config is not None:
            save_config(features_config, log_dir / "features_config.yaml")
    return log_dir


def build_mesh_and_sharding(device_type: str = "cuda"):
    """(mesh, shard_batch, shard_train_step, shard_eval_step): the
    data-parallel mesh of every process of the job (``parallel.make_mesh``)
    and its helpers; the mesh is None in one process, where the step
    helpers return the step as it is."""
    mesh = parallel.make_mesh(device_type=device_type) if dist.is_initialized() else None
    return mesh, parallel.shard_batch, parallel.shard_train_step, parallel.shard_eval_step


def superglue_config_from(
    config: Mapping[str, Any], descriptor_dim: int, side_info_dim: int
) -> SuperGlueConfig:
    """SuperGlueConfig from a config's ``superglue`` section; the decode stats
    are on unless the config turns them off."""
    sg = dict(config.get("superglue", {}))
    sg["descriptor_dim"] = descriptor_dim
    sg.setdefault("decode_stats", True)
    cfg = SuperGlueConfig.from_dict(sg)
    return dataclasses.replace(cfg, side_info_size=side_info_dim + 1)


def loss_config_from(config: Mapping[str, Any]) -> LossConfig:
    """LossConfig from a config's ``train`` section."""
    train = config.get("train", {})
    return LossConfig(
        positive_threshold=float(train.get("gt_positive_threshold", 2.0)),
        negative_threshold=float(train.get("gt_negative_threshold", 7.0)),
        nll_weight=float(train.get("nll_weight", 1.0)),
        metric_weight=float(train.get("metric_weight", 0.0)),
        margin=train.get("margin"),
    )


def favor_redraw_interval(config: Mapping[str, Any]) -> Optional[int]:
    """How often, in steps, the trainer redraws the FAVOR projections
    (``train.step.redraw_favor_projections``): the ``redraw_interval`` of the
    ``superglue.attention_gnn`` section for a FAVOR kind, else None."""
    gnn = config.get("superglue", {}).get("attention_gnn", {}) or {}
    if str(gnn.get("attention", "")).startswith("favor"):
        return gnn.get("redraw_interval")
    return None


def optimizer_from(config: Mapping[str, Any], params: Iterable[torch.Tensor]) -> ClippedAdam:
    """The cached trainer's optimizer from a config's ``train`` section: Adam
    at ``lr`` with the per-step ``scheduler_gamma`` decay (after
    ``warmup_steps`` of linear warmup when set) and ``grad_clip``."""
    train = config.get("train", {})
    kw = dict(
        learning_rate=float(train.get("lr", 1e-4)),
        gamma=float(train.get("scheduler_gamma", 0.999994)),
        gradient_clip=float(train.get("grad_clip", 10.0)),
    )
    warmup_steps = int(train.get("warmup_steps", 0))
    if warmup_steps > 0:
        return make_warmup_optimizer(params, warmup_steps=warmup_steps, **kw)
    return make_optimizer(params, **kw)


def loop_config_from(
    config: Mapping[str, Any], log_dir: Optional[Path], lr_schedule: Optional[Schedule] = None
) -> TrainLoopConfig:
    """TrainLoopConfig from a config's ``train``, ``logging`` and
    ``evaluation`` sections. ``lr_schedule`` is the optimizer's schedule
    (``ClippedAdam.schedule``), logged as the learning rate; by default the
    one ``optimizer_from`` builds from the same config."""
    config = Config(config)
    train = config.get("train", {})
    ev = config.get("evaluation", {}) or {}
    return TrainLoopConfig(
        steps_per_epoch=int(train.get("steps_per_epoch", 1000)),
        max_epochs=int(train.get("epochs", 1)),
        log_every_n_steps=int(config.get("logging.train_logs_steps", 50)),
        favor_redraw_interval=favor_redraw_interval(config),
        checkpoint_dir=str(log_dir / "checkpoints") if log_dir else None,
        log_dir=str(log_dir / "tb") if log_dir else None,
        eval_threshold=float(ev.get("epipolar_dist_threshold", 5e-4)),
        pose_auc_thresholds=tuple(ev.get("camera_auc_thresholds", (5.0, 10.0, 20.0))),
        ransac_thresh_px=float(ev.get("camera_auc_ransac_inliers_threshold", 1.0)),
        wandb_enabled=bool(config.get("logging.wandb", False)),
        wandb_project=str(config.get("logging.wandb_project", "superglue")),
        wandb_run_name=log_dir.name if log_dir else None,
        config_snapshot=config.to_dict(),
        lr_schedule=lr_schedule or make_lr_schedule(
            learning_rate=float(train.get("lr", 1e-4)),
            gamma=float(train.get("scheduler_gamma", 0.999994)),
            warmup_steps=int(train.get("warmup_steps", 0)),
        ),
    )

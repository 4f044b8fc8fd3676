"""Train and eval steps (port of ``openglue_tpu/train/step.py``): the
cached-feature steps and the online steps, which extract the features from
the images first (``models.matching_module.MatchingModule``).

One step: GT match generation from the pair's geometry -> SuperGlue forward
in training mode -> weighted NLL (+ metric) loss -> backward -> clipped Adam
update. The BatchNorm running statistics update during the forward.

A data-parallel state (``state.groups``, set by ``parallel.shard_train_step``)
takes this rank's rows of the global batch; a model with a
``keypoint_group`` (``SuperGlue`` with ``ring_axis``, or on a mesh whose
``model`` axis holds several ranks) this rank's shard of their keypoints
(``parallel.shard_pair_batch_cp``): the GT then comes from the gathered
keypoints of both images (the mutual check needs them all) and keeps this
rank's rows of image 0. The loss is the global one with this rank's share as
its gradient; the parameter gradients are summed over the world (data x
model) before clipping and Adam, so that every rank takes the same step and
the metrics are the global batch's, as the JAX package's ``shard_train_step``
and ``shard_train_step_cp`` with a replicated state do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from openglue_tpu_torch.core.types import PairBatch, superglue_inputs
from openglue_tpu_torch.geometry.gt_matches import generate_gt_matches
from openglue_tpu_torch.losses import criterion
from openglue_tpu_torch.models.matching import decode_from_output
from openglue_tpu_torch.ops.attention import sample_orthogonal_random_matrix
from openglue_tpu_torch.parallel.context_parallel import gather_pair_batch
from openglue_tpu_torch.parallel.distributed import MeshGroups, all_reduce_sum
from openglue_tpu_torch.train.state import TrainState, global_norm


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss and supervision settings (the reference config's ``train`` keys)."""

    positive_threshold: float = 2.0
    negative_threshold: float = 7.0
    nll_weight: float = 1.0
    metric_weight: float = 0.0
    margin: Optional[float] = None
    gt_parity_mode: bool = False


def step_groups(state: TrainState) -> MeshGroups:
    """The groups a step of ``state`` reduces over: ``state.groups``, else
    the model's keypoint group as both the model group and the world."""
    if state.groups is not None:
        return state.groups
    ring = getattr(state.model, "keypoint_group", None)
    return MeshGroups(model=ring, world=ring)


def make_train_step(loss_config: LossConfig) -> Callable[[TrainState, PairBatch], Dict[str, torch.Tensor]]:
    """(state, batch) -> metrics: ``total_loss``, ``nll_loss``,
    ``metric_loss`` and ``grad_norm`` (of the unclipped gradients), as 0-dim
    tensors on the model's device. Updates ``state`` in place."""

    def train_step(state: TrainState, batch: PairBatch) -> Dict[str, torch.Tensor]:
        s0, s1 = batch.side0, batch.side1
        groups = step_groups(state)
        group = groups.model
        whole = batch if group is None else gather_pair_batch(batch, group)
        with torch.no_grad():
            gt = generate_gt_matches(
                whole.side0.keypoints, whole.side1.keypoints, whole.transformation,
                positive_threshold=loss_config.positive_threshold,
                negative_threshold=loss_config.negative_threshold,
                mask0=whole.side0.mask, mask1=whole.side1.mask, parity_mode=loss_config.gt_parity_mode,
            )
        if group is not None:
            n_loc = s0.keypoints.shape[1]
            start = dist.get_rank(group) * n_loc
            gt["gt_matches0"] = gt["gt_matches0"][:, start:start + n_loc]
        model = state.model.train()
        out = model(**superglue_inputs(batch))
        return _apply_loss(state, gt, out, s0.mask, s1.mask, loss_config, groups)

    return train_step


def _apply_loss(state: TrainState, gt: Dict[str, torch.Tensor], out: Dict[str, torch.Tensor],
                mask0: torch.Tensor, mask1: torch.Tensor, loss_config: LossConfig,
                groups: MeshGroups) -> Dict[str, torch.Tensor]:
    """The second half of a training step: the weighted loss of ``out``
    against ``gt``, backward (the gradients summed over the world when there
    is one), the clipped update and the step's metrics."""
    losses = criterion(gt, out, margin=loss_config.margin, mask0=mask0, mask1=mask1, groups=groups)
    total = (loss_config.nll_weight * losses["loss"]
             + loss_config.metric_weight * losses["metric_loss"])
    state.optimizer.zero_grad()
    total.backward()
    if groups.world is not None:
        _sum_gradients(state.optimizer.params, groups.world)
    grad_norm = global_norm([p.grad for p in state.optimizer.params if p.grad is not None])
    state.optimizer.step(grad_norm)
    state.step += 1
    return {
        "total_loss": total.detach(),
        "nll_loss": losses["loss"].detach(),
        "metric_loss": losses["metric_loss"].detach(),
        "grad_norm": grad_norm,
    }


def _sum_gradients(params, group) -> None:
    """Every parameter's gradient summed over the group, in place, in one
    all-reduce (a parameter without a gradient takes zeros)."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), group)
    for p, part in zip(params, torch.split(flat, [g.numel() for g in grads])):
        p.grad = part.view_as(p)


def make_eval_step(match_threshold: float = 0.2) -> Callable[[TrainState, PairBatch], Dict[str, torch.Tensor]]:
    """(state, batch) -> the decoded matches and the scores, in eval mode."""

    def eval_step(state: TrainState, batch: PairBatch) -> Dict[str, torch.Tensor]:
        model = state.model.eval()
        with torch.no_grad():
            out = model(**superglue_inputs(batch))
            matches = decode_from_output(
                out, match_threshold=match_threshold, mask0=batch.side0.mask, mask1=batch.side1.mask,
                group=getattr(model, "keypoint_group", None),
            )
        matches["scores"] = out["scores"]
        return matches

    return eval_step


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The online step's augmentation generator: on ``device``, seeded from
    the loop's seed and the step's number, so that a resumed run draws what
    the uninterrupted one drew."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + int(step)) % 2**63)


def make_online_train_step(
    loss_config: LossConfig,
    augmentation: str = "none",
    seed: int = 0,
) -> Callable[[TrainState, Dict[str, Any]], Dict[str, torch.Tensor]]:
    """The ONLINE step (reference matching_module.py:71-105): device-side
    augmentation of each side -> feature extraction -> GT generation from the
    batch's transformation -> SuperGlue -> loss -> backward -> clipped Adam.
    ``state.model`` is a ``MatchingModule``; the batch a dict with image0/1
    [B, H, W] and a ``Transformation`` on the model's device. Returns the
    metrics of ``make_train_step``. A data-parallel rank draws the
    augmentation of the whole global batch and keeps its rows, as GSPMD
    gives each device its slice of JAX's global draws, so that the global
    batch is the one a single process augments."""
    from openglue_tpu_torch.augmentations import get_augmentation_transform

    augment = get_augmentation_transform(augmentation)

    def train_step(state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        image0, image1 = batch["image0"], batch["image1"]
        groups = step_groups(state)
        local = image0.shape[0]
        rows = (groups.data_rank * local, local * groups.data_size)
        generator = step_generator(seed, state.step, image0.device)
        image0, image1 = augment(generator, image0, rows), augment(generator, image1, rows)
        model = state.model.train()
        out, pair = model(image0, image1)
        s0, s1 = pair.side0, pair.side1
        with torch.no_grad():
            gt = generate_gt_matches(
                s0.keypoints, s1.keypoints, batch["transformation"],
                positive_threshold=loss_config.positive_threshold,
                negative_threshold=loss_config.negative_threshold,
                mask0=s0.mask, mask1=s1.mask, parity_mode=loss_config.gt_parity_mode,
            )
        return _apply_loss(state, gt, out, s0.mask, s1.mask, loss_config, groups)

    return train_step


def make_online_eval_step(match_threshold: float = 0.2) -> Callable[[TrainState, Dict[str, Any]], Dict[str, torch.Tensor]]:
    """The ONLINE eval step: images -> extraction -> matching -> decode
    (reference validation_step with online features). Returns the decoded
    matches plus the extracted keypoints and image 0's mask (the metrics
    need them)."""

    def eval_step(state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        model = state.model.eval()
        with torch.no_grad():
            out, pair = model(batch["image0"], batch["image1"])
            matches = decode_from_output(out, match_threshold=match_threshold,
                                         mask0=pair.side0.mask, mask1=pair.side1.mask)
        matches["keypoints0"] = pair.side0.keypoints
        matches["keypoints1"] = pair.side1.keypoints
        matches["mask0"] = pair.side0.mask
        return matches

    return eval_step


def redraw_favor_projections(state: TrainState, generator: Optional[torch.Generator] = None) -> TrainState:
    """Resample every FAVOR orthogonal projection buffer of the model in
    place (the Performer redraw, every ``favor_redraw_interval`` steps); a
    model of another attention kind is left as it is. Ranks that seed their
    generators alike draw alike."""
    with torch.no_grad():
        for name, buf in state.model.named_buffers():
            if name.endswith("mha.projection"):
                buf.copy_(sample_orthogonal_random_matrix(
                    generator, buf.shape[0], buf.shape[1], dtype=buf.dtype, device=buf.device
                ))
    return state

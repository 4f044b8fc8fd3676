"""Train state: the model (its parameters and buffers) and the optimizer (port
of ``openglue_tpu/train/state.py``).

The optimizer is the JAX package's ``optax.chain(clip_by_global_norm(c),
adam(schedule))``: global-norm gradient clipping, Adam, and a per-step
exponential learning-rate decay, optionally after a linear warmup.

A data-parallel state (``TrainState.replicate``, which
``parallel.shard_train_step`` calls) is the same on every rank: rank 0's
parameters and buffers at its start, then the same update from the summed
gradients at every step, as the JAX package's replicated state is.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Iterable, Optional, Sequence

import torch
from torch import nn

from openglue_tpu_torch.models.layers import set_batch_norm_group
from openglue_tpu_torch.parallel.distributed import MeshGroups, broadcast_from_first

Schedule = Callable[[int], float]


def make_lr_schedule(
    learning_rate: float = 1e-4,
    gamma: float = 0.999994,
    warmup_steps: int = 0,
) -> Schedule:
    """The learning rate of the k-th update (k = 0, 1, ...): optax's
    ``exponential_decay(lr, transition_steps=1, decay_rate=gamma,
    staircase=True)``, lr * gamma**k, after ``warmup_steps`` of
    ``linear_schedule(0, lr, warmup_steps)`` joined at the boundary."""

    def decay(k: int) -> float:
        return learning_rate * gamma**k

    if warmup_steps <= 0:
        return decay

    def schedule(k: int) -> float:
        if k < warmup_steps:
            return (0.0 - learning_rate) * (1.0 - k / warmup_steps) + learning_rate
        return decay(k - warmup_steps)

    return schedule


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax's
    ``global_norm``)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


class ClippedAdam:
    """Global-norm clipping, then Adam with a scheduled learning rate, over a
    fixed list of parameters. optax's Adam defaults (b1 0.9, b2 0.999, eps
    1e-8, eps_root 0) are ``torch.optim.Adam``'s. The scheduler steps after
    the optimizer, so the k-th update (from 0) uses ``schedule(k)``."""

    def __init__(
        self, params: Iterable[torch.Tensor], schedule: Schedule, gradient_clip: Optional[float]
    ):
        self.params: Sequence[torch.Tensor] = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.gradient_clip = gradient_clip
        # base rate 1 scaled by the schedule: the applied rate is schedule(k) exactly
        self.adam = torch.optim.Adam(self.params, lr=1.0)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.adam, schedule)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        """Clip the gradients in place by optax's rule (scale by
        max_norm / norm only when norm >= max_norm), then update. A parameter
        without a gradient takes a zero one, as a JAX gradient tree has."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.gradient_clip is not None:
            if grad_norm is None:
                grad_norm = global_norm(p.grad for p in self.params)
            keep = grad_norm < self.gradient_clip
            for p in self.params:
                p.grad.copy_(torch.where(keep, p.grad, p.grad / grad_norm * self.gradient_clip))
        self.adam.step()
        self.scheduler.step()


def make_optimizer(
    params: Iterable[torch.Tensor],
    learning_rate: float = 1e-4,
    gamma: float = 0.999994,
    gradient_clip: Optional[float] = 10.0,
) -> ClippedAdam:
    """Adam + per-step exponential decay + gradient clipping."""
    return ClippedAdam(params, make_lr_schedule(learning_rate, gamma), gradient_clip)


def make_warmup_optimizer(
    params: Iterable[torch.Tensor],
    learning_rate: float = 1e-4,
    warmup_steps: int = 1000,
    gamma: float = 0.999994,
    gradient_clip: Optional[float] = 10.0,
) -> ClippedAdam:
    """Linear warmup into the per-step exponential decay."""
    return ClippedAdam(params, make_lr_schedule(learning_rate, gamma, warmup_steps), gradient_clip)


def make_online_optimizer(
    model: nn.Module,
    learning_rate: float = 1e-4,
    gamma: float = 0.999994,
    gradient_clip: Optional[float] = 10.0,
    finetune_extractor: bool = False,
) -> ClippedAdam:
    """The optimizer of a ``MatchingModule``: with a frozen extractor only
    the other submodules' parameters are in it, and the global-norm clip
    takes their gradients only, as optax's ``multi_transform`` with the
    extractor's subtree set to zero does (the reference optimizes the
    superglue parameters alone, matching_module.py:133-136); fine-tuning,
    every parameter."""
    params = [p for name, p in model.named_parameters()
              if finetune_extractor or name.split(".", 1)[0] != "extractor"]
    return make_optimizer(params, learning_rate, gamma, gradient_clip)


@dataclasses.dataclass
class TrainState:
    """The model, whose parameters and buffers (the BatchNorm running
    statistics) the step updates, its optimizer, the number of updates
    taken, and the groups of a data-parallel or ring step (None: the
    model's ring group alone, if it has one)."""

    model: nn.Module
    optimizer: ClippedAdam
    step: int = 0
    groups: Optional[MeshGroups] = None

    def replicate(self, groups: MeshGroups) -> "TrainState":
        """Make this the state of one rank of ``groups``' mesh: every
        parameter and buffer broadcast from the world's rank 0 (the Adam
        moments are alike already: restored from one checkpoint, or none),
        every BatchNorm's statistics taken over the world, and the step's
        groups set. Returns the state."""
        if groups.world is not None:
            broadcast_from_first([*self.model.parameters(), *self.model.buffers()], groups.world)
            set_batch_norm_group(self.model, groups.world)
        self.groups = groups
        return self


def create_train_state(
    model: nn.Module,
    learning_rate: float = 1e-4,
    gamma: float = 0.999994,
    gradient_clip: Optional[float] = 10.0,
    optimizer: Optional[ClippedAdam] = None,
) -> TrainState:
    """A train state over ``model`` with ``make_optimizer``'s optimizer unless
    one is given."""
    if optimizer is None:
        optimizer = make_optimizer(model.parameters(), learning_rate, gamma, gradient_clip)
    return TrainState(model=model, optimizer=optimizer)


def clone_train_state(state: TrainState) -> TrainState:
    """An independent copy of ``state``: the model deep-copied, and an
    optimizer over the copy's parameters with the same moments, schedule
    count and step. (``copy.deepcopy`` of the state would not do: the
    scheduler's hook on ``Adam.step`` keeps a reference to the original
    optimizer, so the copy's updates would land on the original.)"""
    model = copy.deepcopy(state.model)
    optimizer = ClippedAdam(model.parameters(), state.optimizer.schedule, state.optimizer.gradient_clip)
    optimizer.adam.load_state_dict(copy.deepcopy(state.optimizer.adam.state_dict()))
    optimizer.scheduler.load_state_dict(state.optimizer.scheduler.state_dict())
    return TrainState(model=model, optimizer=optimizer, step=state.step)

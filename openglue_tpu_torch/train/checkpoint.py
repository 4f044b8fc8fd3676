"""Checkpoints (port of ``openglue_tpu/train/checkpoint.py``; the reference
keeps every epoch's Lightning checkpoint, utils/train_utils.py:33-43, and
warm-starts the matcher from raw weights, superglue.py:25-27).

Two tiers:
  * the whole train state for resuming: ``<directory>/<step>.pt``, written
    with ``torch.save`` and kept for every save. It holds the model's
    ``state_dict`` (parameters, BatchNorm running statistics, FAVOR and
    calibration buffers; for the online trainer the whole ``MatchingModule``,
    extractor and matcher), the Adam moments, the schedule's count and
    ``state.step``;
  * the matcher's weights alone in the JAX package's npz format
    (``save_weights``), so that a file written by either package warm-starts
    the other.

A data-parallel state is the same on every rank, so one file holds it: rank
0 writes it (``train.loop.fit``) and every rank restores the same file. It
does not depend on the world size: a checkpoint written at one world size
resumes at another.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from openglue_tpu_torch.compat.jax_weights import (
    jax_variables_from_state_dict,
    load_npz_tree,
    save_npz_tree,
    superglue_state_dict_from_jax,
)
from openglue_tpu_torch.train.state import TrainState


def checkpoint_path(directory, step: int) -> Path:
    return Path(directory) / f"{int(step)}.pt"


def save_train_state(directory, state: TrainState, step: Optional[int] = None) -> Path:
    """Write the train state as ``<directory>/<step>.pt`` (step defaults to
    ``state.step``); earlier checkpoints stay. Returns the file's path."""
    path = checkpoint_path(directory, state.step if step is None else step)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({
        "step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.adam.state_dict(),
        "scheduler": state.optimizer.scheduler.state_dict(),
    }, path)
    return path


def latest_step(directory) -> Optional[int]:
    """The largest step with a checkpoint under ``directory``, or None."""
    path = Path(directory)
    steps = [int(p.stem) for p in path.glob("*.pt") if p.stem.isdigit()] if path.is_dir() else []
    return max(steps) if steps else None


def _load(directory, step: Optional[int]):
    """(path, payload) of the checkpoint at ``step``, the latest by default."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = checkpoint_path(directory, step)
    return path, torch.load(path, map_location="cpu", weights_only=True)


def restore_train_state(directory, state: TrainState, step: Optional[int] = None) -> TrainState:
    """Load a checkpoint (the latest unless ``step``) into ``state`` in
    place, onto the devices its model is on, and return it."""
    _, payload = _load(directory, step)
    state.model.load_state_dict(payload["model"])
    state.optimizer.adam.load_state_dict(payload["optimizer"])
    state.optimizer.scheduler.load_state_dict(payload["scheduler"])
    state.step = int(payload["step"])
    return state


def restore_model(directory, model: torch.nn.Module, step: Optional[int] = None, prefix: str = "") -> int:
    """Load the model's part of a checkpoint (the latest unless ``step``)
    into ``model`` in place, which is all a server needs; returns the
    checkpoint's step. With ``prefix`` only the entries under it are loaded,
    the prefix taken off: an online trainer's checkpoint holds the whole
    ``MatchingModule``, its matcher under ``superglue.`` and its extractor
    under ``extractor.``. Every parameter and statistic must be there. The
    calibration of an ``int8_static*`` model (its ``act_absmax`` buffers and
    ``int8_calibration`` flag) may be absent, as it is from a model that did
    not quantize: the model then stays uncalibrated, as in the JAX package,
    whose calibration is a collection of its own."""
    path, payload = _load(directory, step)
    state = {k[len(prefix):]: v for k, v in payload["model"].items() if k.startswith(prefix)}
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.endswith((".act_absmax", "int8_calibration._extra_state"))]
    if missing or unexpected:
        raise RuntimeError(f"checkpoint {path} does not fit the model: "
                           f"missing {missing}, unexpected {unexpected}")
    return int(payload["step"])


def save_weights(path, model: torch.nn.Module) -> None:
    """The matcher's weights (parameters and collections) as the JAX
    package's npz tree (``openglue_tpu.train.checkpoint.save_weights``)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    save_npz_tree(path, jax_variables_from_state_dict(model.state_dict(), model.config))


def load_weights(path, model: torch.nn.Module) -> torch.nn.Module:
    """Load an npz tree written by either package's ``save_weights`` into
    ``model`` (every parameter and BatchNorm statistic must be there)."""
    model.load_state_dict(superglue_state_dict_from_jax(load_npz_tree(path), model.config))
    return model

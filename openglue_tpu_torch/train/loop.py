"""Training loop (port of ``openglue_tpu/train/loop.py``; replaces
pl.Trainer, reference train.py:69-85, matching_module.py:71-131).

Each epoch: ``steps_per_epoch`` train steps (reference
limit_train_batches=steps_per_epoch, train.py:77), then a validation sweep
with the epipolar and pose-AUC metrics, then a checkpoint (every epoch kept).
FAVOR projections are redrawn every ``favor_redraw_interval`` steps (reference
utils/lightning_callbacks.py:10-14), from a generator of the same seed on
every rank, so that data-parallel ranks draw the same matrices. Metrics go to
TensorBoard through tensorboardX when it is installed and a log_dir is given,
and to W&B when enabled and installed; only the main process logs and writes
checkpoints, and every rank waits for the checkpoint before it goes on.

Data parallelism: each rank drives the loop with its own loaders (its rows
of each global training batch, its share of the validation pairs, a tail of
any size included); a data-parallel step (``parallel.shard_train_step``)
returns the global batch's metrics on every rank, and the validation metrics
gather every rank's pairs (``metrics.py``'s ``sync``).

The step's metrics are 0-dim tensors on the model's device: they are read
(which waits for the device) only at log steps, and the loop counts steps on
the host. Batch k+1 is copied to the device while step k runs
(``prefetch_to_device``).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch

from openglue_tpu_torch.core.types import PairBatch, map_tensors
from openglue_tpu_torch.data.collate import DeviceDescBatch, resize_keypoint_axis
from openglue_tpu_torch.metrics import CameraPoseAUC, EpipolarDistanceMetric, HomographyPrecisionMetric
from openglue_tpu_torch.parallel.distributed import barrier, is_main_process
from openglue_tpu_torch.train.checkpoint import save_train_state
from openglue_tpu_torch.train.state import TrainState, clone_train_state
from openglue_tpu_torch.train.step import redraw_favor_projections


@dataclasses.dataclass
class TrainLoopConfig:
    steps_per_epoch: int = 1000
    max_epochs: int = 10
    log_every_n_steps: int = 50
    favor_redraw_interval: Optional[int] = None  # steps; None = never
    checkpoint_dir: Optional[str] = None
    log_dir: Optional[str] = None
    # W&B (reference utils/train_utils.py:54-60 logs to TensorBoard and W&B);
    # left out when the wandb package is absent
    wandb_enabled: bool = False
    wandb_project: str = "superglue"
    wandb_run_name: Optional[str] = None
    config_snapshot: Optional[dict] = None  # the run's config, given to W&B
    eval_threshold: float = 5e-4
    pose_auc_thresholds: tuple = (5.0, 10.0, 20.0)
    ransac_thresh_px: float = 0.5
    # the learning rate of step k (reference LearningRateMonitor), logged
    # from the host: the optimizer's own schedule
    lr_schedule: Optional[Callable[[int], float]] = None


class MetricsLogger:
    """TensorBoard and optional W&B logger of the main process (reference
    utils/train_utils.py:54-60). Each backend is imported where it is opened
    and left out when its package is absent."""

    def __init__(
        self,
        log_dir: Optional[str],
        wandb_enabled: bool = False,
        wandb_project: str = "superglue",
        wandb_run_name: Optional[str] = None,
        config_snapshot: Optional[dict] = None,
    ):
        self.writer = None
        self.wandb_run = None
        if not is_main_process():
            return
        if log_dir:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self.writer = SummaryWriter(log_dir)
        if wandb_enabled:
            try:
                import wandb
            except ImportError:
                pass
            else:
                self.wandb_run = wandb.init(
                    project=wandb_project, name=wandb_run_name, config=config_snapshot or {}
                )

    @classmethod
    def from_config(cls, config: TrainLoopConfig) -> "MetricsLogger":
        return cls(
            config.log_dir,
            wandb_enabled=config.wandb_enabled,
            wandb_project=config.wandb_project,
            wandb_run_name=config.wandb_run_name,
            config_snapshot=config.config_snapshot,
        )

    def log(self, tag_values: Dict[str, float], step: int) -> None:
        if self.writer:
            for tag, value in tag_values.items():
                self.writer.add_scalar(tag, value, step)
        if self.wandb_run:
            self.wandb_run.log(dict(tag_values), step=step)

    def close(self) -> None:
        if self.writer:
            self.writer.close()
        if self.wandb_run:
            self.wandb_run.finish()


def pin_batch(batch):
    """The batch in page-locked host memory, so that its copy to a CUDA
    device does not block the host (the loader's workers call this). A view
    whose elements share memory (an expanded tensor) is made whole first. A
    ``DeviceDescBatch`` pins its light fields and index tensors; its
    descriptor blocks stay where they are (the cache copies a block only on
    a miss)."""
    pin = lambda t: t.contiguous().pin_memory()
    if isinstance(batch, DeviceDescBatch):
        return dataclasses.replace(batch, batch=map_tensors(batch.batch, pin), index0=pin(batch.index0),
                                   index1=pin(batch.index1))
    return map_tensors(batch, pin)


def batch_to_device(batch: PairBatch, device) -> PairBatch:
    """The batch on ``device``; from pinned memory the copies are queued
    behind the device's running work and the host goes on."""
    return map_tensors(batch, lambda t: t.to(device, non_blocking=True))


def _update_pose_metrics(epipolar, pose_auc, kpts0, kpts1, matches0, mask0, tf) -> None:
    """One batch into the epipolar counts (on the device) and the RANSAC pose
    AUC (on the host)."""
    detected = mask0.sum(dim=1).cpu().numpy()
    epipolar.update(kpts0, kpts1, matches0, tf.K0, tf.K1, tf.R, tf.T, num_detected=detected)
    pose_auc.update(*(t.cpu().numpy() for t in (kpts0, kpts1, matches0, tf.K0, tf.K1, tf.R, tf.T)))


def evaluate(
    state: TrainState,
    eval_step: Callable,
    eval_batches: Iterable[PairBatch],
    config: TrainLoopConfig,
    to_device: Optional[Callable] = None,
) -> Dict[str, float]:
    """Validation sweep (reference validation_step, matching_module.py:107-131):
    the match decode and the epipolar counts on the device, the RANSAC pose
    AUC on the host."""
    epipolar = EpipolarDistanceMetric(config.eval_threshold)
    pose_auc = CameraPoseAUC(config.pose_auc_thresholds, config.ransac_thresh_px)
    for batch in eval_batches:
        if to_device is not None:
            batch = to_device(batch)
        out = eval_step(state, batch)
        _update_pose_metrics(epipolar, pose_auc, batch.side0.keypoints, batch.side1.keypoints,
                             out["matches0"], batch.side0.mask, batch.transformation)
    epipolar.sync()
    pose_auc.sync()
    return {**epipolar.compute(), **pose_auc.compute()}


def evaluate_online(
    state: TrainState,
    eval_step: Callable,
    eval_batches: Iterable,
    config: TrainLoopConfig,
    to_device: Optional[Callable] = None,
) -> Dict[str, float]:
    """Validation for the ONLINE path (image batches; the keypoints come from
    the eval step's extraction): the epipolar and pose-AUC metrics for
    3d_reprojection batches, the homography precision for perspective ones."""
    epipolar = EpipolarDistanceMetric(config.eval_threshold)
    pose_auc = CameraPoseAUC(config.pose_auc_thresholds, config.ransac_thresh_px)
    homography = HomographyPrecisionMetric()
    for batch in eval_batches:
        if to_device is not None:
            batch = to_device(batch)
        out = eval_step(state, batch)
        tf = batch["transformation"]
        kpts0, kpts1, matches0 = out["keypoints0"], out["keypoints1"], out["matches0"]
        if tf.kind == "3d_reprojection":
            _update_pose_metrics(epipolar, pose_auc, kpts0, kpts1, matches0, out["mask0"], tf)
        elif tf.kind == "perspective":
            homography.update(kpts0, kpts1, matches0, tf.H, num_detected=out["mask0"].sum(dim=1).cpu().numpy())
    epipolar.sync()
    pose_auc.sync()
    homography.sync()
    metrics: Dict[str, float] = {}
    if epipolar.precisions:
        metrics.update({**epipolar.compute(), **pose_auc.compute()})
    if homography.precisions:
        metrics.update(homography.compute())
    return metrics


def prefetch_to_device(batches: Iterable, to_device: Callable, depth: int = 2) -> Iterable:
    """Yield device batches, keeping up to ``depth`` copied ahead of the
    consumer: after a batch is yielded and its step queued, the generator
    pulls and copies the next one while the device works."""
    buf = collections.deque()
    it = iter(batches)

    def fill():
        while len(buf) < depth:
            try:
                buf.append(to_device(next(it)))
            except StopIteration:
                return

    fill()
    while buf:
        yield buf.popleft()
        fill()


def warm_up_buckets(
    step_fn: Callable,
    state: TrainState,
    example_batch: PairBatch,
    bucket_sizes: Sequence[int],
    to_device: Optional[Callable] = None,
) -> None:
    """Warm-up before bucketed training (the port's counterpart of the JAX
    package's per-bucket compile): on a CUDA model, build every kernel; then
    one step per bucket shape, on a batch resized from a real one, taken by a
    copy of the state (``clone_train_state``). ``state`` is left as it was:
    parameters, moments, schedule, step and running statistics."""
    device = next(state.model.parameters()).device
    if device.type == "cuda":
        from openglue_tpu_torch.ops import kernels

        t0 = time.perf_counter()
        kernels.build_all()
        if is_main_process():
            print(f"warm-up: kernels built in {time.perf_counter() - t0:.1f}s", flush=True)
    for n in sorted({int(b) for b in bucket_sizes}):
        t0 = time.perf_counter()
        dummy = resize_keypoint_axis(example_batch, n)
        if to_device is not None:
            dummy = to_device(dummy)
        metrics = step_fn(clone_train_state(state), dummy)
        float(metrics["total_loss"])  # waits for the step
        if is_main_process():
            print(f"warm-up: one step at N={n} on a copy of the state in "
                  f"{time.perf_counter() - t0:.2f}s", flush=True)


def fit(
    state: TrainState,
    train_step: Callable,
    train_batches: Iterable,
    config: TrainLoopConfig,
    eval_step: Optional[Callable] = None,
    eval_batches_fn: Optional[Callable[[], Iterable]] = None,
    to_device: Optional[Callable] = None,
    evaluate_fn: Optional[Callable] = None,
) -> TrainState:
    """Drive training. ``train_batches`` yields host batches (it may be
    infinite); ``to_device`` moves one to the model's device. The step
    updates ``state`` in place; returns it. ``evaluate_fn`` is the
    validation sweep, ``evaluate`` by default (``evaluate_online`` for the
    online path)."""
    logger = MetricsLogger.from_config(config)
    generator = torch.Generator().manual_seed(0)  # the FAVOR redraws
    train_iter = iter(train_batches)
    if to_device is not None:
        train_iter = iter(prefetch_to_device(train_iter, to_device))
    step_idx = int(state.step)

    for epoch in range(config.max_epochs):
        t_epoch = time.time()
        for _ in range(config.steps_per_epoch):
            if config.favor_redraw_interval and step_idx > 0 and step_idx % config.favor_redraw_interval == 0:
                redraw_favor_projections(state, generator)
            metrics = train_step(state, next(train_iter))
            if step_idx % config.log_every_n_steps == 0:
                host_metrics = {k: float(v) for k, v in metrics.items()}
                if config.lr_schedule is not None:
                    host_metrics["lr"] = float(config.lr_schedule(step_idx))
                logger.log({f"train/{k}": v for k, v in host_metrics.items()}, step_idx)
                if is_main_process():
                    print(f"epoch {epoch} step {step_idx}: "
                          + " ".join(f"{k}={v:.4f}" for k, v in host_metrics.items()), flush=True)
            step_idx += 1

        if eval_step is not None and eval_batches_fn is not None:
            t_eval = time.time()
            eval_metrics = (evaluate_fn or evaluate)(state, eval_step, eval_batches_fn(), config, to_device)
            logger.log({f"val/{k}": v for k, v in eval_metrics.items()}, int(state.step))
            if is_main_process():
                print(f"epoch {epoch} val ({time.time() - t_eval:.1f}s): "
                      + " ".join(f"{k}={v:.4f}" for k, v in eval_metrics.items()), flush=True)

        if config.checkpoint_dir:
            if is_main_process():
                path = save_train_state(config.checkpoint_dir, state)
                print(f"epoch {epoch}: checkpoint {path}", flush=True)
            barrier()
        if is_main_process():
            print(f"epoch {epoch} done in {time.time() - t_epoch:.1f}s", flush=True)

    logger.close()
    return state

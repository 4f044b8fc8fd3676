"""One rank of the port's data-parallel runs that
tests/test_torch_data_parallel.py holds against JAX and against one process.
It imports no JAX.

    python -m tests.torch_dp_worker MODE RANK WORLD PORT ROOT

MODE ``data`` (world 2, mesh {"data": 2}): the data-parallel step for one
and three steps, ``local_batch_slice`` and ``shard_eval_step``, a resume
from a world-1 checkpoint and a world-2 checkpoint, ``cli.train_cached`` and
``cli.pretrain_homography`` at world 2 with their batches recorded, the
refusals that stay, a FAVOR redraw, and one online step fine-tuning
SuperPoint with BatchNorms (``bn_*`` inputs). MODE ``ring`` (world 4, mesh
{"data": 2, "model": 2}): one step of the ring model and one of the
all-gather route (the same model without ``ring_axis``) through
``shard_train_step_cp``. Inputs come from ROOT (``inputs.npz``,
``weights.pt``, the configs the test writes); each rank writes
``<mode><rank>.npz`` and, for the CLIs, its batches as ``*.pt``.
"""

import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

from openglue_tpu_torch import parallel
from openglue_tpu_torch.core.types import KeypointSet, PairBatch, Transformation, map_tensors
from openglue_tpu_torch.models.superglue import SuperGlue, SuperGlueConfig
from openglue_tpu_torch.train import state as port_state
from openglue_tpu_torch.train.step import LossConfig, make_eval_step, make_train_step

FIELDS = ("keypoints", "descriptors", "side_info", "mask", "image_size")


def model_batch(data) -> PairBatch:
    """The global pair batch of ``inputs.npz``."""
    sides = [KeypointSet(*[torch.from_numpy(data[f"s{i}_{f}"]) for f in FIELDS]) for i in (0, 1)]
    return PairBatch(*sides, Transformation("perspective", H=torch.from_numpy(data["H"])))


def matcher(config: dict, weights, mesh=None, **changes) -> SuperGlue:
    """The test's matcher with the JAX weights (``weights.pt``)."""
    cfg = SuperGlueConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in config.items()}, **changes)
    model = SuperGlue(cfg, device="cpu", mesh=mesh)
    model.load_state_dict(weights)
    return model


def record_step(out, tag, state, metrics, grads=False, stats=True):
    """A step's metrics, parameters, (gradients) and running statistics."""
    for key, value in metrics.items():
        out[f"{tag}_{key}"] = value.detach().numpy()
    for name, p in state.model.named_parameters():
        out[f"{tag}_param:{name}"] = p.detach().numpy().copy()
        if grads:
            out[f"{tag}_grad:{name}"] = p.grad.numpy().copy()
    if stats:
        for name, b in state.model.named_buffers():
            if "running" in name:
                out[f"{tag}_stat:{name}"] = b.numpy().copy()


@contextlib.contextmanager
def recorded_cli(record):
    """Within the context the CLIs' train steps, validation sweeps, file
    writes and augmentations are recorded into ``record``: ``batches`` and
    ``metrics`` of each train step after the warm-up, ``eval`` (the sweep's
    metrics), ``writes`` (checkpoints and config snapshots) and
    ``augmented`` (each weak_color_aug call's output)."""
    from openglue_tpu_torch import augmentations
    from openglue_tpu_torch.cli import common
    from openglue_tpu_torch.train import loop
    from openglue_tpu_torch.train import step as step_mod

    record.update(batches=[], metrics=[], eval=None, writes=0, augmented=[], warming=False)
    saved = {(loop, "warm_up_buckets"): loop.warm_up_buckets,
             (step_mod, "make_train_step"): step_mod.make_train_step,
             (step_mod, "make_online_train_step"): step_mod.make_online_train_step,
             (loop, "evaluate"): loop.evaluate, (loop, "evaluate_online"): loop.evaluate_online,
             (loop, "save_train_state"): loop.save_train_state, (common, "save_config"): common.save_config}
    real_aug = augmentations.AUGMENTATIONS["weak_color_aug"]

    def steps(real_make):
        def make(*args, **kwargs):
            step = real_make(*args, **kwargs)

            def recorded(state, batch):
                if record["warming"]:
                    return step(state, batch)
                record["batches"].append(map_tensors(batch, torch.clone))
                metrics = step(state, batch)
                record["metrics"].append({k: float(v) for k, v in metrics.items()})
                return metrics

            return recorded

        return make

    def warm_up(*args, **kwargs):
        record["warming"] = True
        try:
            return saved[(loop, "warm_up_buckets")](*args, **kwargs)
        finally:
            record["warming"] = False

    def sweep(real):
        def run(*args, **kwargs):
            record["eval"] = real(*args, **kwargs)
            return record["eval"]

        return run

    def writes(real):
        def write(*args, **kwargs):
            record["writes"] += 1
            return real(*args, **kwargs)

        return write

    def augment(generator, images, rows=None):
        images = real_aug(generator, images, rows)
        record["augmented"].append(images.clone())
        return images

    replacements = {(loop, "warm_up_buckets"): warm_up,
                    (step_mod, "make_train_step"): steps(step_mod.make_train_step),
                    (step_mod, "make_online_train_step"): steps(step_mod.make_online_train_step),
                    (loop, "evaluate"): sweep(loop.evaluate), (loop, "evaluate_online"): sweep(loop.evaluate_online),
                    (loop, "save_train_state"): writes(loop.save_train_state),
                    (common, "save_config"): writes(common.save_config)}
    for (module, name), fn in replacements.items():
        setattr(module, name, fn)
    augmentations.AUGMENTATIONS["weak_color_aug"] = augment
    try:
        yield record
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)
        augmentations.AUGMENTATIONS["weak_color_aug"] = real_aug


def raises(fn, kind, match=""):
    try:
        fn()
    except kind as exc:
        return match in str(exc)
    return False


def data_mode(rank, world, root, config, out):
    from openglue_tpu_torch.cli import pretrain_homography, train_cached
    from openglue_tpu_torch.data import collate
    from openglue_tpu_torch.train.checkpoint import restore_train_state, save_train_state
    from openglue_tpu_torch.train.step import redraw_favor_projections

    mesh = parallel.make_mesh({"data": world}, device_type="cpu")
    data = dict(np.load(root / "inputs.npz"))
    weights = torch.load(root / "weights.pt")
    whole = model_batch(data)
    batch = parallel.shard_batch(whole, mesh)
    step = parallel.shard_train_step(make_train_step(LossConfig()), mesh)

    # ---- one, then three data-parallel steps from the same weights
    state = port_state.create_train_state(matcher(config, weights), learning_rate=1e-3)
    for i in range(3):
        record_step(out, f"dp{i}", state, step(state, batch), grads=i == 0)

    # ---- the batch slice and the evaluation of a whole batch and of a tail
    out["indivisible_raised"] = np.asarray(raises(lambda: parallel.local_batch_slice(5, mesh), ValueError))
    out["slice"] = np.asarray(parallel.local_batch_slice(4, mesh))
    eval_state = port_state.create_train_state(matcher(config, weights))
    eval_step = parallel.shard_eval_step(make_eval_step(0.0), mesh)
    for rows in (4, 1):
        part = map_tensors(whole, lambda t: t[:rows])
        for key, value in eval_step(eval_state, part).items():
            out[f"eval{rows}_{key}"] = value.numpy()

    # ---- a world-1 checkpoint resumed here; this world's written by rank 0
    resumed = port_state.create_train_state(matcher(config, weights), learning_rate=1e-3)
    restore_train_state(root / "ckpt1", resumed)
    record_step(out, "resumed", resumed, step(resumed, batch))
    if parallel.distributed.is_main_process():
        save_train_state(root / "ckpt2", resumed)
    parallel.barrier()

    # ---- a FAVOR redraw, as fit makes it
    favor = port_state.create_train_state(SuperGlue(SuperGlueConfig(
        descriptor_dim=32, num_heads=2, num_stages=1, attention="favor_relu", favor_num_features=16), device="cpu"))
    redraw_favor_projections(favor, torch.Generator().manual_seed(0))
    for name, b in favor.model.named_buffers():
        if name.endswith("mha.projection"):
            out[f"favor:{name}"] = b.numpy()

    # ---- fine-tuning an extractor with BatchNorms: their statistics over the data axis
    from openglue_tpu_torch.models.matching_module import MatchingModule, MatchingModuleConfig
    from openglue_tpu_torch.train.state import make_online_optimizer
    from openglue_tpu_torch.train.step import make_online_train_step

    bn = json.loads((root / "bn_config.json").read_text())
    module = MatchingModule(MatchingModuleConfig.from_dict(bn["module"]), device="cpu")
    module.load_state_dict(torch.load(root / "bn_weights.pt"))
    images = np.load(root / "bn_images.npz")
    online = {"image0": torch.from_numpy(images["image0"]), "image1": torch.from_numpy(images["image1"]),
              "transformation": Transformation("perspective", H=torch.from_numpy(images["H"]))}
    state = port_state.create_train_state(module, optimizer=make_online_optimizer(
        module, learning_rate=bn["lr"], finetune_extractor=True))
    step = parallel.shard_train_step(make_online_train_step(LossConfig(**bn["loss"]), augmentation="none"), mesh)
    record_step(out, "bn", state, step(state, parallel.shard_batch(online, mesh)), grads=True)

    # ---- the cached-feature trainer, then the homography pretraining
    record = {}
    with recorded_cli(record):
        trained = train_cached.main(["--config", str(root / "cached" / "base.yaml"), "--config_override",
                                     str(root / "cached" / "override.yaml"), "--device", "cpu"])
    torch.save(record["batches"], root / f"cached_batches{rank}.pt")
    out["cached_losses"] = np.asarray([m["total_loss"] for m in record["metrics"]])
    out["cached_norms"] = np.asarray([m["grad_norm"] for m in record["metrics"]])
    out["cached_eval_keys"] = np.asarray(sorted(record["eval"]))
    out["cached_eval_values"] = np.asarray([record["eval"][k] for k in sorted(record["eval"])])
    out["cached_writes"] = np.asarray(record["writes"])
    for name, p in trained.model.state_dict().items():
        out[f"cached_final:{name}"] = p.numpy()
    with recorded_cli(record):
        pretrain_homography.main(["--config", str(root / "pretrain" / "cfg.yaml"), "--device", "cpu"])
    torch.save(record["batches"], root / f"pretrain_batches{rank}.pt")
    out["pretrain_augmented"] = torch.stack(record["augmented"]).numpy()
    out["pretrain_losses"] = np.asarray([m["total_loss"] for m in record["metrics"]])
    out["pretrain_norms"] = np.asarray([m["grad_norm"] for m in record["metrics"]])

    # ---- the device-resident descriptor cache against host mode on the same
    # rows (one loader thread, both collates drawing from one seeded
    # generator), and what stays refused
    batches = {}
    for mode in ("host", "device"):
        rng = np.random.default_rng(0)
        real = {name: getattr(collate, name) for name in ("stack_keypoints_batch", "stack_keypoints_batch_device")}
        for name, fn in real.items():
            setattr(collate, name, lambda samples, _fn=fn, **kw: _fn(samples, rng=rng, **kw))
        try:
            with recorded_cli(record):
                trained = train_cached.main(["--config", str(root / "cached" / "base.yaml"), "--config_override",
                                             str(root / "cached" / f"seeded_{mode}.yaml"), "--device", "cpu"])
        finally:
            for name, fn in real.items():
                setattr(collate, name, fn)
        out[f"seeded_{mode}_losses"] = np.asarray([m["total_loss"] for m in record["metrics"]])
        out[f"seeded_{mode}_norms"] = np.asarray([m["grad_norm"] for m in record["metrics"]])
        out[f"seeded_{mode}_eval"] = np.asarray([record["eval"][k] for k in sorted(record["eval"])])
        for name, p in trained.model.state_dict().items():
            out[f"seeded_{mode}_final:{name}"] = p.numpy()
        batches[mode] = record["batches"]
    out["seeded_batches_equal"] = np.asarray(len(batches["host"]) == len(batches["device"]) and all(
        torch.equal(getattr(getattr(a, s), f), getattr(getattr(b, s), f))
        for a, b in zip(batches["host"], batches["device"])
        for s in ("side0", "side1") for f in ("keypoints", "descriptors", "side_info", "mask")))
    base = ["--config", str(root / "cached" / "base.yaml"), "--device", "cpu"]
    out["checkify_raised"] = np.asarray(raises(
        lambda: train_cached.main(base + ["--config_override", str(root / "cached" / "override.yaml"),
                                          "--checkify"]), ValueError, "--checkify runs in one process; this job has 2"))


def ring_mode(rank, world, root, config, out):
    mesh = parallel.make_mesh({"data": 2, "model": world // 2}, device_type="cpu")
    data = dict(np.load(root / "inputs.npz"))
    model = matcher(config, torch.load(root / "weights.pt"), use_pallas=True, ring_axis="model", mesh=mesh)
    state = port_state.create_train_state(model, learning_rate=1e-3)
    step = parallel.shard_train_step_cp(make_train_step(LossConfig()), mesh)
    record_step(out, "ring", state, step(state, model_batch(data)), grads=True)
    model = matcher(config, torch.load(root / "weights.pt"), use_pallas=True, mesh=mesh)
    state = port_state.create_train_state(model, learning_rate=1e-3)
    record_step(out, "gather", state, step(state, model_batch(data)), grads=True)


def main():
    mode, rank, world, port, root = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], Path(sys.argv[5])
    torch.set_num_threads(1)
    assert parallel.initialize(f"tcp://127.0.0.1:{port}", world, rank, device_type="cpu")
    config = json.loads((root / "model.json").read_text())
    out = {}
    {"data": data_mode, "ring": ring_mode}[mode](rank, world, root, config, out)
    np.savez(root / f"{mode}{rank}.npz", **out)
    parallel.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

"""Data parallelism of the port (``openglue_tpu_torch.parallel``'s mesh,
``shard_train_step``, ``shard_train_step_cp`` and the trainers' CLIs at a
world above one process) against the JAX package and against one process.

Two groups of gloo processes are spawned once for the module
(``tests/torch_dp_worker.py``, one thread each) while the JAX references run
in the test process: 2 ranks on a {"data": 2} mesh and 4 ranks on a
{"data": 2, "model": 2} mesh with ``ring_axis``. The global batch holds 4
pairs of 32 keypoints. Bars: the metrics 1e-5 relative, every gradient
``3e-4 + 1e-5 max|g|`` absolute and 1e-4 relative, the BatchNorm running
statistics 1e-5 (tests/test_torch_ring.py's), and parameters equal on every
rank bit for bit.

The CLIs at world 2 are held against the same CLI at world 1 fed the global
batches that the two ranks drew: the cached trainer's random crop and the
homography pairs come from per-process streams (seeded by rank, as in the
JAX package), so the world-1 CLI's own loader would draw other pairs.

The data ranks also take one online step fine-tuning SuperPoint with
BatchNorms (tests/test_torch_online.py's images, 1 of the 2 pairs a rank):
its BatchNorm statistics cover the global batch, as the JAX package's do.
It is held against JAX's one-device step (the losses, the gradient norm, the
matcher's gradients, the running means and variances), against the port's
world-1 step (every gradient) and, for the extractor's gradients, against
the world-1 step in f64, where the port's and JAX's agree (``_f64_steps``):
JAX's f32 step rounds those gradients up to 1.7e-3 away from both."""

import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch
import yaml

from openglue_tpu.core.types import KeypointSet as JaxKeypointSet
from openglue_tpu.core.types import PairBatch as JaxPairBatch
from openglue_tpu.core.types import Transformation as JaxTransformation
from openglue_tpu.models.superglue import SuperGlue as JaxSuperGlue
from openglue_tpu.models.superglue import SuperGlueConfig as JaxConfig
from openglue_tpu.parallel import make_mesh as jax_make_mesh
from openglue_tpu.parallel import shard_batch as jax_shard_batch
from openglue_tpu.parallel import shard_train_step as jax_shard_train_step
from openglue_tpu.train import LossConfig as JaxLossConfig
from openglue_tpu.train import create_train_state as jax_create_train_state
from openglue_tpu.train import make_train_step as jax_make_train_step
from openglue_tpu_torch.cli import pretrain_homography, train_cached
from openglue_tpu_torch.compat.jax_weights import (
    jax_variables_from_state_dict, superglue_grads_from_jax, superglue_state_dict_from_jax,
    superpoint_state_dict_from_jax,
)
from openglue_tpu_torch.core.types import map_tensors
from openglue_tpu_torch.data.fixture import generate_image_fixture
from openglue_tpu_torch.data.synthetic import SyntheticHomographyPairs
from openglue_tpu_torch.models.superglue import SuperGlue, SuperGlueConfig
from openglue_tpu_torch.train import state as port_state
from openglue_tpu_torch.train.checkpoint import restore_train_state, save_train_state
from openglue_tpu_torch.train.state import make_online_optimizer
from openglue_tpu_torch.train.step import LossConfig, make_eval_step, make_online_train_step, make_train_step
from tests.test_cli import SMALL_SUPERGLUE
from tests.test_data import TARGET_CACHED, make_megadepth_fixture
from tests.torch_dp_worker import matcher, model_batch, recorded_cli
from tests import test_torch_online as online_refs

REPO = Path(__file__).resolve().parents[1]
B, KPTS = 4, 32
MODEL = dict(descriptor_dim=32, pe_hidden_layers_sizes=(16,), num_stages=2, num_heads=2, otp_num_iters=10,
             residual=True, decode_stats=True)
STEPS = 3
CACHED = {
    "data": {"features_dir": "features_cache", "train_list_path": "train_list.txt", "val_list_path": "val_list.txt",
             "max_keypoints": 64, "batch_size": 4, "dataloader_workers": 2, "target_size": list(TARGET_CACHED),
             "val_max_pairs_per_scene": 3, "train_pairs_overlap": None, "buckets": [32, 64],
             "device_descriptor_cache": 0},
    "logging": {"name": "t", "train_logs_steps": 1},
    "train": {"epochs": 1, "steps_per_epoch": 2, "lr": 1.0e-3, "gt_positive_threshold": 3, "gt_negative_threshold": 5},
    "superglue": {"positional_encoding": {"hidden_layers_sizes": [16]}, "attention_gnn": {"num_stages": 1},
                  "otp": {"num_iters": 5}},
    # every pair's matches count at random weights, and a loose epipolar bar
    "inference": {"match_threshold": 0.0},
    "evaluation": {"epipolar_dist_threshold": 0.05},
}
PRETRAIN = {
    "data": {"batch_size": 4, "dataloader_workers": 0, "target_size": [128, 96], "warp_offset": 16},
    "logging": {"name": "p", "train_logs_steps": 1},
    "train": {"epochs": 1, "steps_per_epoch": 1, "grad_clip": 10.0, "lr": 1.0e-3, "gt_positive_threshold": 3,
              "gt_negative_threshold": 3, "augmentations": {"name": "weak_color_aug"}},
    "features": {"name": "SuperPointNet", "descriptor_dim": 32,
                 "parameters": {"max_keypoints": 64, "descriptor_dim": 32}, "weights": None},
    "superglue": SMALL_SUPERGLUE,
    "inference": {"match_threshold": 0.0},
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_yaml(path, payload):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(payload))


def _model_batch():
    """A homography batch from the port's generator (seeded), zero-padded
    beyond ragged valid counts, as numpy arrays."""
    batch = SyntheticHomographyPairs(num_keypoints=KPTS, descriptor_dim=MODEL["descriptor_dim"], jitter=0.3).sample(
        torch.Generator().manual_seed(3), B)
    masks = (np.arange(KPTS)[None] < np.asarray([KPTS, 21, 30, KPTS])[:, None],
             np.arange(KPTS)[None] < np.asarray([26, KPTS, KPTS, 17])[:, None])
    out = {"H": np.array(batch.transformation.H)}
    for i, (side, mask) in enumerate(zip((batch.side0, batch.side1), masks)):
        for f in ("keypoints", "descriptors", "side_info"):
            out[f"s{i}_{f}"] = np.array(getattr(side, f)) * mask[..., None]
        out[f"s{i}_mask"] = mask
        out[f"s{i}_image_size"] = np.array(side.image_size)
    return out


def _jax_batch(data):
    sides = [JaxKeypointSet(*[jax.numpy.asarray(data[f"s{i}_{f}"]) for f in (
        "keypoints", "descriptors", "side_info", "mask", "image_size")]) for i in (0, 1)]
    return JaxPairBatch(*sides, JaxTransformation(kind="perspective", H=jax.numpy.asarray(data["H"])))


def _jax_step_record(new_state, metrics, first):
    record = {"metrics": {k: float(v) for k, v in metrics.items()},
              "new": jax.tree_util.tree_map(np.asarray, {
                  "params": new_state.params, "batch_stats": new_state.model_state["batch_stats"]})}
    if first:  # below the clip, Adam's first moment after one update is (1 - b1) * grad
        assert float(metrics["grad_norm"]) < 10.0
        adam = [s for s in jax.tree_util.tree_leaves(
            new_state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)][0]
        record["grads"] = jax.tree_util.tree_map(lambda mu: np.asarray(mu) / np.float32(0.1), adam.mu)
    return record


def _jax_references(data, variables):
    """JAX's data-parallel step on a 2-device mesh for STEPS steps, and its
    one-device step, on the global batch."""
    batch = _jax_batch(data)
    model = JaxSuperGlue(JaxConfig(**MODEL))
    raw = jax_make_train_step(JaxLossConfig())
    mesh = jax_make_mesh({"data": 2}, devices=jax.devices()[:2])
    step = jax_shard_train_step(raw, mesh)
    sharded = jax_shard_batch(batch, mesh)
    state = jax_create_train_state(model.apply, variables, learning_rate=1e-3)
    dp = []
    for i in range(STEPS):
        state, metrics = step(state, sharded)
        dp.append(_jax_step_record(state, metrics, i == 0))
    one, state, step = [], jax_create_train_state(model.apply, variables, learning_rate=1e-3), jax.jit(raw)
    for i in range(STEPS):
        state, metrics = step(state, batch)
        one.append(_jax_step_record(state, metrics, i == 0))
    return dp, one


BN_SIZES = {"1": 64 * 80, "2": 32 * 40, "3": 16 * 20, "4": 8 * 10, "P": 8 * 10, "D": 8 * 10}  # a BatchNorm's map


def _bn_inputs(root):
    """SuperPoint with BatchNorms, fine-tuned, in the online test's
    MatchingModule with JAX's initialization: the port's weights, config
    and images for the ranks. Returns (JAX module, its variables, the port
    module, the images)."""
    jmodel, variables, port, images = online_refs.modules("SuperPointNetBn", finetune=True)
    torch.save(port.state_dict(), root / "bn_weights.pt")
    (root / "bn_config.json").write_text(json.dumps({
        "module": online_refs.config_dict("SuperPointNetBn", True), "loss": online_refs.LOSS, "lr": online_refs.LR}))
    np.savez(root / "bn_images.npz", image0=images[0], image1=images[1], H=images[2])
    return jmodel, variables, port, images


def _jax_bn_reference(jmodel, variables, port, images):
    """JAX's one-device online step on the global batch: metrics, the
    gradients after the clip (Adam's first moment over 1 - b1), the running
    statistics before the step, after the extractor's call on image 0 and
    after the step."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(online_refs.jax_native, "nms_keypoints_native", lambda *args, **kwargs: None)
        new_state, metrics = online_refs._jax_step(jmodel, variables, online_refs.jax_batch(*images), True, False)
        _, first = jmodel.apply(variables, jax.numpy.asarray(images[0]), train=True, method=jmodel.extract,
                                mutable=["batch_stats"])
    mu = _adam_gradients(new_state)
    grads = {f"superglue.{k}": v.numpy() for k, v in superglue_grads_from_jax(
        mu["superglue"], port.config.superglue).items()}
    stats = [jax.tree_util.tree_map(np.asarray, tree["batch_stats"]["extractor"]["backbone"])
             for tree in (variables, first, new_state.model_state)]
    return dict(metrics={k: float(v) for k, v in metrics.items()}, grads=grads, stats=stats)


def _adam_gradients(new_state):
    """The gradients of a JAX online step below the clip: Adam's first
    moment after one update is (1 - b1) * grad."""
    adam = [s for s in jax.tree_util.tree_leaves(
        new_state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    return jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, dict(adam.mu))


def _f64_steps(jmodel, variables, images):
    """The extractor's gradients of the BN fine-tuning's world-1 online step
    in f64, of the port (the module and images in f64) and of JAX (x64), as
    numpy. Two changes make the f64 steps the f32 steps' function: the
    ground truth is computed in f32 on both sides (the test's homography
    shifts by whole pixels onto the 3 px positive threshold, where f64
    rounds other pairs in), and JAX's Sinkhorn takes its marginals in the
    scores' type (it builds them in f32)."""
    from openglue_tpu.ops import sinkhorn as jax_sinkhorn
    from openglue_tpu.train import step as jax_step_module
    from openglue_tpu_torch.features import superpoint as port_superpoint
    from openglue_tpu_torch.train import step as port_step_module

    def jax_f32(t):
        return t.astype(np.float32) if hasattr(t, "dtype") and np.issubdtype(t.dtype, np.floating) else t

    def port_f32(t):
        return t.float() if torch.is_tensor(t) and t.is_floating_point() else t

    log_sinkhorn, jax_gt, port_gt = (jax_sinkhorn.log_sinkhorn, jax_step_module.generate_gt_matches,
                                     port_step_module.generate_gt_matches)
    images64 = [np.asarray(x, np.float64) for x in images]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(online_refs.jax_native, "nms_keypoints_native", lambda *args, **kwargs: None)
        mp.setattr(jax_sinkhorn, "log_sinkhorn", lambda log_a, log_b, M, *args, **kwargs: log_sinkhorn(
            log_a.astype(M.dtype), log_b.astype(M.dtype), M, *args, **kwargs))
        mp.setattr(jax_step_module, "generate_gt_matches", lambda *args, **kwargs: jax_gt(
            *jax.tree_util.tree_map(jax_f32, args), **jax.tree_util.tree_map(jax_f32, kwargs)))
        mp.setattr(port_step_module, "generate_gt_matches", lambda *args, **kwargs: port_gt(
            *[map_tensors(a, port_f32) for a in args], **{k: port_f32(v) for k, v in kwargs.items()}))
        mp.setattr(port_superpoint, "gray_batch", lambda image: (image[:, 0] if image.dim() == 4 else image).double())
        _, _, port, _ = online_refs.modules("SuperPointNetBn", finetune=True)
        port = port.double()
        state = port_state.create_train_state(port, optimizer=make_online_optimizer(
            port, learning_rate=online_refs.LR, finetune_extractor=True))
        make_online_train_step(LossConfig(**online_refs.LOSS), augmentation="none")(
            state, online_refs.port_batch(*images64))
        with jax.enable_x64(True):
            as64 = lambda t: jax.numpy.asarray(t, jax.numpy.float64 if np.issubdtype(t.dtype, np.floating) else t.dtype)
            new_state, _ = online_refs._jax_step(jmodel, jax.tree_util.tree_map(as64, variables),
                                                 online_refs.jax_batch(*images64), True, False)
            mu = _adam_gradients(new_state)
    extractor = superpoint_state_dict_from_jax({"params": mu["extractor"],
                                                "batch_stats": variables["batch_stats"]["extractor"]})
    jax_grads = {f"extractor.{k}": v.numpy() for k, v in extractor.items() if "running" not in k}
    return {n: p.grad.numpy() for n, p in port.named_parameters() if n.startswith("extractor.")}, jax_grads


def _spawn(mode, world, root):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("MASTER_ADDR", None)
    port = _free_port()
    return [subprocess.Popen([sys.executable, "-m", "tests.torch_dp_worker", mode, str(r), str(world), str(port),
                              str(root)], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]


def _cli_fixtures(root):
    """The cached trainer's MegaDepth fixture and configs, and the
    pretraining's image folder and config."""
    cached = root / "cached"
    make_megadepth_fixture(cached, pairs_per_scene=10)
    _write_yaml(cached / "features_cache" / "config.yaml",
                {"name": "OPENCV_SIFT", "descriptor_dim": 32, "parameters": {}})
    (cached / "train_list.txt").write_text("scene_a\nscene_b\n")
    (cached / "val_list.txt").write_text("scene_a\n")
    shutil.copy(REPO / "configs" / "config_cached_sp_magicleap.yaml", cached / "base.yaml")
    override = json.loads(json.dumps(CACHED))
    override["data"]["root_path"] = str(cached)
    override["logging"]["root_path"] = str(root / "logs2")
    _write_yaml(cached / "override.yaml", override)
    override["logging"]["root_path"] = str(root / "logs1")
    _write_yaml(cached / "world1.yaml", override)
    override["data"].update(dataloader_workers=0, device_cache_cap=64)
    override["logging"]["root_path"] = str(root / "logs_seeded")
    _write_yaml(cached / "seeded_host.yaml", override)
    override["data"]["device_descriptor_cache"] = 512
    _write_yaml(cached / "seeded_device.yaml", override)

    pretrain = root / "pretrain"
    generate_image_fixture(pretrain / "images", num_images=3, image_size=(160, 128), seed=2)
    config = json.loads(json.dumps(PRETRAIN))
    config["data"]["root_path"] = str(pretrain / "images")
    config["logging"]["root_path"] = str(root / "logs2")
    _write_yaml(pretrain / "cfg.yaml", config)
    config["logging"]["root_path"] = str(root / "logs1")
    _write_yaml(pretrain / "world1.yaml", config)


def _gathered(root, name):
    """The global batches of a world-2 CLI run: each step's two rank
    batches, concatenated in rank order."""
    ranks = [torch.load(root / f"{name}_batches{r}.pt", weights_only=False) for r in range(2)]
    out = []
    for pair in zip(*ranks):
        leaves = [[], []]
        map_tensors(pair[0], leaves[0].append)
        map_tensors(pair[1], leaves[1].append)
        whole = iter([torch.cat(parts) for parts in zip(*leaves)])
        out.append(map_tensors(pair[0], lambda _: next(whole)))
    return out


def _world1_cli_runs(root):
    """The two CLIs at world 1, in this process, fed the global batches of
    the world-2 runs."""
    runs = {}
    cached_batches = _gathered(root, "cached")
    real_loaders = train_cached.build_dataloaders

    def fed_loaders(*args, **kwargs):
        _, val_fn = real_loaders(*args, **kwargs)
        return iter(cached_batches), val_fn

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_cached, "build_dataloaders", fed_loaders)
        with recorded_cli({}) as record:
            state = train_cached.main(["--config", str(root / "cached" / "base.yaml"), "--config_override",
                                       str(root / "cached" / "world1.yaml"), "--device", "cpu"])
            runs["cached"] = dict(record, state=state)

    pretrain_batches = _gathered(root, "pretrain")
    real_run = pretrain_homography.run_online_training
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pretrain_homography, "run_online_training",
                   lambda config, loader, *a, **k: real_run(config, iter(pretrain_batches), *a, **k))
        with recorded_cli({}) as record:
            pretrain_homography.main(["--config", str(root / "pretrain" / "world1.yaml"), "--device", "cpu"])
            runs["pretrain"] = dict(record)
    return runs


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """(inputs, JAX references, the port's world-1 references, the 2 data
    ranks' and the 4 ring ranks' results)."""
    root = tmp_path_factory.mktemp("data_parallel")
    data = _model_batch()
    cfg = SuperGlueConfig(**MODEL)
    weights = SuperGlue(cfg, device="cpu", generator=torch.Generator().manual_seed(1)).state_dict()
    variables = jax_variables_from_state_dict(weights, cfg)
    np.savez(root / "inputs.npz", **data)
    torch.save(weights, root / "weights.pt")
    (root / "model.json").write_text(json.dumps(MODEL))
    _cli_fixtures(root)
    bn = _bn_inputs(root)

    # a world-1 state one step in, its checkpoint, and the two steps after it
    whole = model_batch(data)
    step = make_train_step(LossConfig())
    world1 = port_state.create_train_state(matcher(MODEL, weights), learning_rate=1e-3)
    step(world1, whole)
    save_train_state(root / "ckpt1", world1)
    world1_next = [{k: float(v) for k, v in step(world1, whole).items()}]
    world1_next.append({k: float(v) for k, v in step(port_state.clone_train_state(world1), whole).items()})

    procs = _spawn("data", 2, root) + _spawn("ring", 4, root)
    try:
        jax_dp, jax_one = _jax_references(data, variables)
        jax_bn = _jax_bn_reference(*bn)
        bn_f64 = _f64_steps(bn[0], bn[1], bn[3])
        logs = [p.communicate(timeout=300)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:  # a rank that failed leaves the others waiting in a collective
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {r}:\n{log[-4000:]}"
    ranks = [dict(np.load(root / f"data{r}.npz")) for r in range(2)]
    ring = [dict(np.load(root / f"ring{r}.npz")) for r in range(4)]
    port_bn = bn[2]
    bn_state = port_state.create_train_state(port_bn, optimizer=make_online_optimizer(
        port_bn, learning_rate=online_refs.LR, finetune_extractor=True))
    bn_world1 = make_online_train_step(LossConfig(**online_refs.LOSS), augmentation="none")(
        bn_state, online_refs.port_batch(*bn[3]))
    return dict(root=root, data=data, weights=weights, jax_dp=jax_dp, jax_one=jax_one, ranks=ranks, ring=ring,
                world1=world1, world1_next=world1_next, cli=_world1_cli_runs(root), jax_bn=jax_bn,
                bn_world1=(bn_world1, port_bn), bn_f64=bn_f64)


def _stats(record, cfg):
    return {k: v.numpy() for k, v in superglue_state_dict_from_jax(record["new"], cfg).items() if "running" in k}


def _hold_step(results, tag, ref, cfg, grads=True, stats_tol=1e-5):
    """Every rank's metrics, gradients and running statistics of step
    ``tag`` against a JAX step record, and the ranks equal bit for bit."""
    for key in ("total_loss", "nll_loss", "grad_norm"):
        for r in results:
            np.testing.assert_allclose(r[f"{tag}_{key}"], ref["metrics"][key], rtol=1e-5, err_msg=key)
    if grads:
        want = superglue_grads_from_jax(ref["grads"], cfg)
        got = {k.split(":", 1)[1]: v for k, v in results[0].items() if k.startswith(f"{tag}_grad:")}
        assert set(got) == set(want)
        for name, value in got.items():
            scale = np.abs(want[name].numpy()).max()
            np.testing.assert_allclose(value, want[name].numpy(), atol=3e-4 + 1e-5 * scale, rtol=1e-4,
                                       err_msg=name)
    want = _stats(ref, cfg)
    stats = {k.split(":", 1)[1]: v for k, v in results[0].items() if k.startswith(f"{tag}_stat:")}
    assert set(stats) == set(want) and len(stats) == 2 * (len(MODEL["pe_hidden_layers_sizes"]) + 2 * MODEL["num_stages"])
    for name, value in stats.items():
        np.testing.assert_allclose(value, want[name], rtol=1e-5, atol=stats_tol, err_msg=name)
    for key, value in results[0].items():
        if key.startswith(f"{tag}_"):
            for r in results[1:]:
                np.testing.assert_array_equal(r[key], value, err_msg=key)


def test_data_parallel_step_matches_jax_data_parallel_step(dp_run):
    """Two ranks on {"data": 2}, each with 2 of the 4 pairs: one step
    (metrics, every gradient, the running statistics) and the next two
    (metrics and statistics) against JAX's shard_train_step on a 2-device
    mesh; parameters, gradients and statistics equal on both ranks after
    every step. From the second step on, the statistics carry Adam's first
    update of the biases ahead of a BatchNorm whose ReLUs are all on: their
    gradient is zero in exact arithmetic, so the rounding of the sum picks
    the sign of a step of about the learning rate, which the loss does not
    see but the running mean does. There the bar is 1e-5 beyond the distance
    between JAX's own one-device and 2-device runs (about 2e-4 after step 2)."""
    cfg = SuperGlueConfig(**MODEL)
    for i, (ref, one) in enumerate(zip(dp_run["jax_dp"], dp_run["jax_one"])):
        a, b = _stats(ref, cfg), _stats(one, cfg)
        jax_drift = 0.0 if i == 0 else max(float(np.abs(a[k] - b[k]).max()) for k in a)
        _hold_step(dp_run["ranks"], f"dp{i}", ref, cfg, grads=i == 0, stats_tol=1e-5 + jax_drift)


def test_data_model_ring_step_matches_jax_single_device_step(dp_run):
    """Four ranks on {"data": 2, "model": 2}: each holds 2 pairs and 16 of
    their 32 keypoints; one ring step through shard_train_step_cp against
    JAX's one-device step on the global batch."""
    _hold_step(dp_run["ring"], "ring", dp_run["jax_one"][0], SuperGlueConfig(**MODEL))


def test_data_model_gather_step_matches_jax_single_device_step(dp_run):
    """The same step on the all-gather route (no ``ring_axis``: K/V
    gathered over the model axis) through shard_train_step_cp."""
    _hold_step(dp_run["ring"], "gather", dp_run["jax_one"][0], SuperGlueConfig(**MODEL))


def test_bn_extractor_fine_tuned_at_world_2(dp_run):
    """One online step fine-tuning SuperPoint with BatchNorms at world 2, one
    image pair a rank: the losses (1e-5) and the gradient norm (1e-4
    relative) of JAX's one-device step on both pairs; the matcher's
    gradients at the f32 step bar against JAX's, and every gradient at that
    bar against the port's world-1 step; the extractor's gradients at that
    bar against the world-1 step in f64, whose port and JAX versions agree
    within 1e-6 and which the port's f32 world-1 step meets within 1e-5
    (JAX's f32 step is up to 1.7e-3 off there); the running means against JAX's
    (1e-5) and the running variances against the value JAX's statistics
    give under the port's formula (torch's unbiased variance, with the
    global count of each call: n / (n - 1) times flax's biased one, two
    extractor calls a step) within 1e-5; every rank the same."""
    ranks, ref = dp_run["ranks"], dp_run["jax_bn"]
    world1, port = dp_run["bn_world1"]
    for r in ranks:
        for key in ("total_loss", "nll_loss"):
            np.testing.assert_allclose(r[f"bn_{key}"], ref["metrics"][key], rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(r["bn_grad_norm"], ref["metrics"]["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(r["bn_grad_norm"], world1["grad_norm"].item(), rtol=1e-4)
    grads = {k.split(":", 1)[1]: v for k, v in ranks[0].items() if k.startswith("bn_grad:")}
    assert len([k for k in grads if k.startswith("extractor.bn")]) == 24
    bar = lambda got, want, name: np.testing.assert_allclose(
        got, want, atol=3e-4 + 1e-5 * np.abs(want).max(), rtol=1e-4, err_msg=name)
    for name, p in port.named_parameters():
        bar(grads[name], p.grad.numpy(), name)
        if name in ref["grads"]:
            bar(grads[name], ref["grads"][name], name)
    port64, jax64 = dp_run["bn_f64"]
    assert set(port64) == set(jax64) == {k for k in grads if k.startswith("extractor.")}
    world1_grads = dict(port.named_parameters())
    for name, want in port64.items():
        np.testing.assert_allclose(want, jax64[name], rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(world1_grads[name].grad.numpy(), want, rtol=0, atol=1e-5, err_msg=name)
        bar(grads[name], want, name)
    before, first, after = ref["stats"]
    for layer, stats in before.items():
        n = 2 * BN_SIZES[layer[2]]  # the images of one side's call, at world 1 and over both ranks
        r0, r1, r2 = (np.float64(s[layer]["var"]) for s in (before, first, after))
        unbiased = n / (n - 1)
        want = 0.9 * (0.9 * r0 + 0.1 * unbiased * (r1 - 0.9 * r0) / 0.1) + 0.1 * unbiased * (r2 - 0.9 * r1) / 0.1
        np.testing.assert_allclose(ranks[0][f"bn_stat:extractor.{layer}.running_var"], want, rtol=0, atol=1e-5,
                                   err_msg=layer)
        np.testing.assert_allclose(ranks[0][f"bn_stat:extractor.{layer}.running_mean"], after[layer]["mean"],
                                   rtol=0, atol=1e-5, err_msg=layer)
    for key, value in ranks[0].items():
        if key.startswith("bn_"):
            np.testing.assert_array_equal(ranks[1][key], value, err_msg=key)


def test_batch_slice_and_evaluation_of_a_tail(dp_run):
    """local_batch_slice cuts by data rank and refuses a batch that does not
    divide; shard_eval_step evaluates a batch of 4 and a tail of 1 (smaller
    than the data axis) as one process does, on both ranks."""
    ranks = dp_run["ranks"]
    assert [tuple(r["slice"]) for r in ranks] == [(0, 2), (2, 4)]
    assert all(bool(r["indivisible_raised"]) for r in ranks)
    state = port_state.create_train_state(matcher(MODEL, dp_run["weights"]))
    whole = model_batch(dp_run["data"])
    for rows in (4, 1):
        ref = make_eval_step(0.0)(state, map_tensors(whole, lambda t: t[:rows]))
        for r in ranks:
            for key in ("matches0", "matches1"):
                np.testing.assert_array_equal(r[f"eval{rows}_{key}"], ref[key].numpy(), err_msg=key)
            np.testing.assert_allclose(r[f"eval{rows}_scores"], ref["scores"].numpy(), rtol=1e-5, atol=1e-5)


def test_checkpoint_resumes_across_world_sizes(dp_run):
    """A world-1 checkpoint resumed at world 2 takes the step world 1 takes;
    the checkpoint rank 0 then writes restores at world 1 equal to the ranks'
    state, and its next step is world 1's."""
    ranks, root = dp_run["ranks"], dp_run["root"]
    for key in ("total_loss", "grad_norm"):
        for r in ranks:
            np.testing.assert_allclose(r[f"resumed_{key}"], dp_run["world1_next"][0][key], rtol=1e-5, err_msg=key)
    restored = restore_train_state(root / "ckpt2", port_state.create_train_state(
        matcher(MODEL, dp_run["weights"]), learning_rate=1e-3))
    assert restored.step == 2
    for name, p in restored.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), ranks[0][f"resumed_param:{name}"], err_msg=name)
    metrics = make_train_step(LossConfig())(restored, model_batch(dp_run["data"]))
    for key in ("total_loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), dp_run["world1_next"][1][key], rtol=1e-5, err_msg=key)


def test_favor_redraw_is_the_same_on_every_rank(dp_run):
    ranks = dp_run["ranks"]
    names = [k for k in ranks[0] if k.startswith("favor:")]
    assert names
    for name in names:
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name], err_msg=name)


def test_train_cached_at_world_2_matches_world_1(dp_run):
    """cli.train_cached at world 2 (global batch 4, 2 steps and a validation
    sweep in which one rank's only batch holds 1 pair): the losses, the
    gradient norms and the validation metrics are world 1's on the same
    global batches; only rank 0 writes files, both ranks end with the same
    parameters, and the checkpoint restores at world 1 equal to them."""
    ranks, world1 = dp_run["ranks"], dp_run["cli"]["cached"]
    for r in ranks:
        np.testing.assert_allclose(r["cached_losses"], [m["total_loss"] for m in world1["metrics"]], rtol=1e-5)
        np.testing.assert_allclose(r["cached_norms"], [m["grad_norm"] for m in world1["metrics"]], rtol=1e-5)
        assert list(r["cached_eval_keys"]) == sorted(world1["eval"])
        np.testing.assert_allclose(r["cached_eval_values"], [world1["eval"][k] for k in sorted(world1["eval"])],
                                   rtol=1e-5, atol=1e-7)
    assert ranks[0]["cached_writes"] == 3 and ranks[1]["cached_writes"] == 0  # 2 configs, 1 checkpoint
    finals = [k for k in ranks[0] if k.startswith("cached_final:")]
    for key in finals:
        np.testing.assert_array_equal(ranks[1][key], ranks[0][key], err_msg=key)
    (experiment,) = (dp_run["root"] / "logs2" / "t").iterdir()
    restored = restore_train_state(experiment / "checkpoints", port_state.clone_train_state(world1["state"]))
    assert restored.step == 2
    for name, value in restored.model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), ranks[0][f"cached_final:{name}"], err_msg=name)


def test_pretrain_homography_at_world_2_matches_world_1(dp_run):
    """cli.pretrain_homography at world 2, one step with weak_color_aug:
    rank r's augmented images are rows 2r:2r+2 of world 1's on the same
    global batch, and the step's metrics are world 1's."""
    ranks, world1 = dp_run["ranks"], dp_run["cli"]["pretrain"]
    augmented = torch.stack(world1["augmented"]).numpy()  # [call, B, H, W]: image 0, then image 1
    for r, res in enumerate(ranks):
        # the same draws; the sharpening's convolution may round with the batch's size
        np.testing.assert_allclose(res["pretrain_augmented"], augmented[:, 2 * r:2 * r + 2], rtol=0, atol=1e-6)
        np.testing.assert_allclose(res["pretrain_losses"], [m["total_loss"] for m in world1["metrics"]], rtol=1e-5)
        np.testing.assert_allclose(res["pretrain_norms"], [m["grad_norm"] for m in world1["metrics"]], rtol=1e-5)


def test_refusals_that_stay_at_world_2(dp_run):
    """At world 2 the device-resident descriptor cache (one per rank, 512
    slots) trains as host mode does on the same rows: the batches the steps
    see, the losses, the gradient norms, the validation and the final
    parameters bit for bit, and the same on both ranks; --checkify is still
    refused there (it is a one-process debugging path)."""
    ranks = dp_run["ranks"]
    for r in ranks:
        assert bool(r["checkify_raised"]) and bool(r["seeded_batches_equal"])
        assert len(r["seeded_device_losses"]) == 2
        for what in ("losses", "norms", "eval"):
            np.testing.assert_array_equal(r[f"seeded_device_{what}"], r[f"seeded_host_{what}"], err_msg=what)
        finals = [k for k in r if k.startswith("seeded_device_final:")]
        assert finals
        for key in finals:
            np.testing.assert_array_equal(r[key], r[key.replace("device", "host", 1)], err_msg=key)
            np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)

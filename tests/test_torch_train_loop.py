"""The port's trainer against the JAX package on the CPU: ``fit``'s logged
losses and ``evaluate``'s metrics from carried weights on one list of
batches, the metrics on planted inputs, the config helpers and the npz
weight files; and, the port alone, the checkpoint round trip, the warm-up,
the refusals and the ``cli.train_cached`` entry point on a fixture."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from openglue_tpu.cli import common as jax_common
from openglue_tpu.core.types import KeypointSet as JaxKeypointSet
from openglue_tpu.core.types import PairBatch as JaxPairBatch
from openglue_tpu.core.types import Transformation as JaxTransformation
from openglue_tpu.geometry import epipolar as jax_epipolar
from openglue_tpu.metrics import CameraPoseAUC as JaxPoseAUC
from openglue_tpu.metrics import EpipolarDistanceMetric as JaxEpipolarMetric
from openglue_tpu.models.superglue import SuperGlue as JaxSuperGlue
from openglue_tpu.train import checkpoint as jax_checkpoint
from openglue_tpu.train import create_train_state as jax_create_train_state
from openglue_tpu.train import loop as jax_loop
from openglue_tpu.train.step import make_eval_step as jax_make_eval_step
from openglue_tpu.train.step import make_train_step as jax_make_train_step
from openglue_tpu.train.step import superglue_inputs as jax_superglue_inputs
from openglue_tpu_torch import metrics, parallel
from openglue_tpu_torch.cli import common, train_cached
from openglue_tpu_torch.compat.jax_weights import superglue_state_dict_from_jax
from openglue_tpu_torch.data.collate import stack_keypoints_batch
from openglue_tpu_torch.data.fixture import generate_megadepth_fixture
from openglue_tpu_torch.data.megadepth import MegaDepthPairsDatasetFeatures
from openglue_tpu_torch.geometry import epipolar
from openglue_tpu_torch.models.superglue import SuperGlue
from openglue_tpu_torch.train import checkpoint, loop
from openglue_tpu_torch.train.state import create_train_state
from openglue_tpu_torch.train.step import make_eval_step, make_train_step
from tests.test_cli import SMALL_SUPERGLUE, write_yaml
from tests.test_data import TARGET_CACHED, make_megadepth_fixture
from tests.test_metrics import synthetic_two_view

REPO = Path(__file__).resolve().parents[1]
DIM, N, B = 32, 64, 4
TRAIN = {"gt_positive_threshold": 2, "gt_negative_threshold": 7, "lr": 1e-3, "scheduler_gamma": 0.999994,
         "grad_clip": 10.0, "nll_weight": 1.0, "metric_weight": 0.0, "margin": None}
CONFIG = {"superglue": SMALL_SUPERGLUE, "train": TRAIN,
          "evaluation": {"epipolar_dist_threshold": 5e-4, "camera_auc_thresholds": [5, 10, 20],
                         "camera_auc_ransac_inliers_threshold": 1.0}}


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    """Batches of the MegaDepth-format fixture (descriptors that agree
    across views, so an untrained matcher decodes real matches), built once:
    3 to train on, 2 to validate on."""
    root = tmp_path_factory.mktemp("fixture")
    stats = generate_megadepth_fixture(root, scenes=2, images_per_scene=5, points_per_scene=120,
                                       image_size=(160, 120), descriptor_dim=DIM, val_scenes=0, seed=3)
    ds = MegaDepthPairsDatasetFeatures(root, "SyntheticSphere_640_480", stats["scenes"], target_size=(160, 120))
    rng = np.random.default_rng(0)
    out = [stack_keypoints_batch([ds[(B * i + j) % len(ds)] for j in range(B)], N, random=True, rng=rng)
           for i in range(5)]
    assert all(b.side0.mask.sum() > B * 20 for b in out)
    return out


def _jax_batch(batch):
    sides = [JaxKeypointSet(**{f: jnp.asarray(getattr(s, f).numpy()) for f in
                               ("keypoints", "descriptors", "side_info", "mask", "image_size")})
             for s in (batch.side0, batch.side1)]
    tf = batch.transformation
    return JaxPairBatch(*sides, JaxTransformation(kind=tf.kind, **{
        f: jnp.asarray(getattr(tf, f).numpy()) for f in ("K0", "K1", "R", "T", "depth0", "depth1")}))


@pytest.fixture(scope="module")
def models(batches):
    """A JAX state and the port's state with its weights carried across."""
    jcfg = jax_common.superglue_config_from(CONFIG, DIM, 0)
    init = jax.jit(lambda key, b: JaxSuperGlue(jcfg).init(key, **jax_superglue_inputs(b)))
    variables = init(jax.random.key(0), _jax_batch(batches[0]))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    cfg = common.superglue_config_from(CONFIG, DIM, 0)
    return jcfg, variables, cfg


def _port_state(models):
    _, variables, cfg = models
    model = SuperGlue(cfg, device="cpu")
    model.load_state_dict(superglue_state_dict_from_jax(variables, cfg))
    return create_train_state(model, optimizer=common.optimizer_from(CONFIG, model.parameters()))


def _logged(module, monkeypatch):
    logged = []
    monkeypatch.setattr(module.MetricsLogger, "log", lambda self, values, step: logged.append((step, values)))
    return logged


def test_fit_logs_the_losses_of_jax_fit(batches, models, monkeypatch):
    """3 steps of fit in each package from carried weights on the same
    batches: the logged total loss of every step within rtol 1e-5 (the
    single-step bar of test_torch_train.py)."""
    jcfg, variables, cfg = models
    jstate = jax_create_train_state(JaxSuperGlue(jcfg).apply, variables, learning_rate=TRAIN["lr"])
    jax_logged = _logged(jax_loop, monkeypatch)
    jax_loop.fit(jstate, jax.jit(jax_make_train_step(jax_common.loss_config_from(CONFIG))),
                 [_jax_batch(b) for b in batches[:3]],
                 jax_loop.TrainLoopConfig(steps_per_epoch=3, max_epochs=1, log_every_n_steps=1))

    state = _port_state(models)
    port_logged = _logged(loop, monkeypatch)
    out = loop.fit(state, make_train_step(common.loss_config_from(CONFIG)), batches[:3],
                   loop.TrainLoopConfig(steps_per_epoch=3, max_epochs=1, log_every_n_steps=1))
    assert out is state and state.step == 3
    assert [s for s, _ in port_logged] == [s for s, _ in jax_logged] == [0, 1, 2]
    for (_, port), (_, ref) in zip(port_logged, jax_logged):
        np.testing.assert_allclose(port["train/total_loss"], ref["train/total_loss"], rtol=1e-5)
        np.testing.assert_allclose(port["train/grad_norm"], ref["train/grad_norm"], rtol=1e-4)


def test_evaluate_matches_jax(batches, models):
    """The validation sweep of both packages from carried weights: the same
    decoded matches, the epipolar precision and matching score exactly, the
    pose AUCs within 1e-6."""
    jcfg, variables, _ = models
    jstate = jax_create_train_state(JaxSuperGlue(jcfg).apply, variables)
    state = _port_state(models)
    # threshold 0: at untrained weights every mutual nearest neighbour counts
    jax_step, port_step = jax.jit(jax_make_eval_step(0.0)), make_eval_step(0.0)
    n_matches = 0
    for batch in batches[3:]:
        ref = np.asarray(jax_step(jstate, _jax_batch(batch))["matches0"])
        port = port_step(state, batch)["matches0"].numpy()
        np.testing.assert_array_equal(port, ref)
        n_matches += int((ref >= 0).sum())
    assert n_matches > 40
    cfg = jax_loop.TrainLoopConfig(ransac_thresh_px=1.0)
    ref = jax_loop.evaluate(jstate, jax_step, [_jax_batch(b) for b in batches[3:]], cfg)
    port = loop.evaluate(state, port_step, batches[3:], loop.TrainLoopConfig(ransac_thresh_px=1.0))
    assert set(port) == set(ref)
    for key, value in ref.items():
        if key.startswith("AUC"):
            np.testing.assert_allclose(port[key], value, rtol=0, atol=1e-6, err_msg=key)
        else:
            assert port[key] == value, key
    assert ref["Precision@0.0005"] > 0.1 and ref["AUC@20deg"] > 0


# ------------------------------------------------------- planted metrics


def _corrupt(kind, kpts0, kpts1):
    n = kpts0.shape[0]
    matches0 = np.arange(n)
    if kind == "shuffled":
        matches0[: n // 2] = np.roll(matches0[: n // 2], 7)
    elif kind == "noisy":
        kpts1 = kpts1 + np.random.default_rng(1).normal(0, 30.0, kpts1.shape)
    elif kind == "few":
        matches0 = np.full(n, -1)
        matches0[:3] = np.arange(3)
    return kpts1, matches0


@pytest.mark.parametrize("kind", ["perfect", "shuffled", "noisy", "few"])
def test_metrics_on_planted_matches_match_jax(kind):
    """Mirrors tests/test_metrics.py:38-132 on both packages."""
    kpts0, kpts1, K, R, T = synthetic_two_view(n=300 if kind != "few" else 10)
    kpts1, matches0 = _corrupt(kind, kpts0, kpts1)
    args = [a[None].astype(np.float32) for a in (kpts0, kpts1)] + [matches0[None]] + [
        a[None].astype(np.float32) for a in (K, K, R, T)]
    port_e, ref_e = metrics.EpipolarDistanceMetric(5e-4), JaxEpipolarMetric(5e-4)
    port_e.update(*[torch.from_numpy(a) for a in args])
    ref_e.update(*args)
    assert port_e.compute() == ref_e.compute()
    port_p, ref_p = metrics.CameraPoseAUC(), JaxPoseAUC()
    port_p.update(*args)
    ref_p.update(*args)
    assert port_p.pose_errors == ref_p.pose_errors and port_p.compute() == ref_p.compute()
    if kind == "perfect":
        assert port_e.compute()["Precision@0.0005"] > 0.99 and port_p.pose_errors[0] < 1.0
    if kind == "few":
        assert port_p.pose_errors == [float("inf")]


def test_symmetrical_epipolar_distance_matches_jax():
    kpts0, kpts1, K, R, T = synthetic_two_view()
    kpts1 = kpts1 + np.random.default_rng(2).normal(0, 2.0, kpts1.shape)
    pts = [((k - K[:2, 2]) / np.array([K[0, 0], K[1, 1]]))[None].astype(np.float32) for k in (kpts0, kpts1)]
    R32, T32 = R[None].astype(np.float32), T[None].astype(np.float32)
    ref_E = jax_epipolar.essential_from_Rt(jnp.asarray(R32), jnp.asarray(T32))
    port_E = epipolar.essential_from_Rt(torch.from_numpy(R32), torch.from_numpy(T32))
    np.testing.assert_allclose(port_E.numpy(), np.asarray(ref_E), rtol=1e-6, atol=1e-7)
    ref = jax_epipolar.symmetrical_epipolar_distance(*map(jnp.asarray, pts), ref_E)
    port = epipolar.symmetrical_epipolar_distance(*map(torch.from_numpy, pts), port_E)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-12)
    assert float(ref.max()) > 1e-6  # the noise moved the points off their lines


def test_pose_error_selects_by_cheirality_like_jax():
    from openglue_tpu.metrics import pose_error_from_essential as jax_pose_error

    kpts0, kpts1, K, R1, T1 = synthetic_two_view(n=100)
    pts0n = (kpts0 - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])
    pts1n = (kpts1 - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])
    y = np.deg2rad(150.0)
    R2 = R1 @ np.array([[np.cos(y), 0, np.sin(y)], [0, 1, 0], [-np.sin(y), 0, np.cos(y)]])
    E = lambda R, T: epipolar.essential_from_Rt(torch.from_numpy(R)[None], torch.from_numpy(T)[None])[0].numpy()
    stack = np.concatenate([E(R2, T1), E(R1, T1)], axis=0)
    for R_gt in (R2, R1):
        port = metrics.pose_error_from_essential(stack, None, pts0n, pts1n, R_gt, T1)
        assert port == jax_pose_error(stack, None, pts0n, pts1n, R_gt, T1)
    assert 140.0 < metrics.pose_error_from_essential(stack, None, pts0n, pts1n, R2, T1) <= 180.0


# ------------------------------------------------------- config and weights


def test_load_merged_config_and_experiment_name_match_jax(tmp_path):
    override = tmp_path / "override.yaml"
    write_yaml(override, {"data": {"device_descriptor_cache": 0, "buckets": [128]},
                          "superglue": {"attention_gnn": {"num_stages": 2}}, "checkpoint": "ckpt"})
    base = REPO / "configs" / "config_cached_sp_magicleap.yaml"
    port = common.load_merged_config(str(base), str(override))
    ref = jax_common.load_merged_config(str(base), str(override))
    assert port.to_dict() == ref.to_dict()
    assert port.superglue.attention_gnn.num_stages == 2 and port.get("superglue.attention_gnn.num_heads") == 4
    assert common.load_merged_config(str(base)).to_dict() == jax_common.load_merged_config(str(base)).to_dict()
    features = {"name": "SuperPointNet"}
    names = common.experiment_name(port, features), jax_common.experiment_name(ref, features)
    stamp = r"__\d{4}-\d\d-\d\d-\d\d-\d\d-\d\d$"
    assert all(re.search(stamp, n) for n in names)
    assert re.sub(stamp, "", names[0]) == re.sub(stamp, "", names[1]) == "SuperPointNet__attn_softmax__laf_none"
    assert re.sub(stamp, "", common.experiment_name(port, None)) == "cached__attn_softmax__laf_none"
    cfg = common.loop_config_from(port, tmp_path)
    jcfg = jax_common.loop_config_from(ref, tmp_path)
    for field in ("steps_per_epoch", "max_epochs", "log_every_n_steps", "checkpoint_dir", "log_dir",
                  "eval_threshold", "pose_auc_thresholds", "ransac_thresh_px", "favor_redraw_interval"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert [cfg.lr_schedule(k) for k in (0, 9)] == pytest.approx([float(jcfg.lr_schedule(k)) for k in (0, 9)])


@pytest.mark.parametrize("attention", ["softmax", "favor_relu"])
def test_weights_npz_cross_loads_with_jax(tmp_path, batches, attention):
    """A JAX-written save_weights npz loads into the port, and the port's
    loads back into the JAX template, both exactly."""
    section = dict(SMALL_SUPERGLUE, attention_gnn=dict(SMALL_SUPERGLUE["attention_gnn"], attention=attention))
    jcfg = jax_common.superglue_config_from({"superglue": section}, DIM, 0)
    variables = JaxSuperGlue(jcfg).init(jax.random.key(4), **jax_superglue_inputs(_jax_batch(batches[0])))
    stats = jax.tree_util.tree_map(lambda v: v + 0.25, variables["batch_stats"])
    variables = jax.tree_util.tree_map(np.asarray, {**variables, "batch_stats": stats})
    jax_checkpoint.save_weights(tmp_path / "jax.npz", variables)
    cfg = common.superglue_config_from({"superglue": section}, DIM, 0)
    model = checkpoint.load_weights(tmp_path / "jax.npz", SuperGlue(cfg, device="cpu"))
    expected = superglue_state_dict_from_jax(variables, cfg)
    assert set(expected) == set(model.state_dict()) - {k for k in model.state_dict() if "num_batches" in k}
    for name, value in expected.items():
        assert torch.equal(model.state_dict()[name], value), name
    checkpoint.save_weights(tmp_path / "port.npz", model)
    back = jax_checkpoint.load_weights(tmp_path / "port.npz", variables)
    flat = jax.tree_util.tree_leaves_with_path(variables)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for (path, ref), value in zip(flat, jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(value, ref, err_msg=jax.tree_util.keystr(path))


# ----------------------------------------------------------- the port alone


def _snapshot(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {i: {k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
             for i, s in state.optimizer.adam.state_dict()["state"].items()},
            state.optimizer.scheduler.state_dict(), state.step)


def _assert_snapshot_equal(a, b):
    assert a[0].keys() == b[0].keys() and a[1].keys() == b[1].keys()
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    for i in a[1]:
        for k in a[1][i]:
            assert torch.equal(torch.as_tensor(a[1][i][k]), torch.as_tensor(b[1][i][k])), (i, k)
    assert a[2] == b[2] and a[3] == b[3]


def test_checkpoint_round_trip_resumes_bit_for_bit(tmp_path, batches, models):
    state = _port_state(models)
    step = make_train_step(common.loss_config_from(CONFIG))
    for batch in batches[:2]:
        step(state, batch)
    path = checkpoint.save_train_state(tmp_path / "ckpts", state)
    assert path.name == "2.pt" and checkpoint.latest_step(tmp_path / "ckpts") == 2
    assert checkpoint.latest_step(tmp_path / "none") is None
    model = SuperGlue(models[2], device="cpu", generator=torch.Generator().manual_seed(7))
    fresh = create_train_state(model, optimizer=common.optimizer_from(CONFIG, model.parameters()))
    restored = checkpoint.restore_train_state(tmp_path / "ckpts", fresh)
    assert restored is fresh and restored.step == 2
    _assert_snapshot_equal(_snapshot(restored), _snapshot(state))
    for batch in batches[2:4]:  # the next two steps agree bit for bit
        assert torch.equal(step(state, batch)["total_loss"], step(restored, batch)["total_loss"])
    _assert_snapshot_equal(_snapshot(restored), _snapshot(state))
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_train_state(tmp_path / "none", fresh)


def test_warm_up_leaves_the_state_bit_equal(batches, models, capsys):
    state = _port_state(models)
    step = make_train_step(common.loss_config_from(CONFIG))
    step(state, batches[0])  # moments and a schedule count to keep
    before = _snapshot(state)
    loop.warm_up_buckets(step, state, batches[1], [16, 32, N])
    _assert_snapshot_equal(_snapshot(state), before)
    assert capsys.readouterr().out.count("warm-up: one step at N=") == 3
    # the state still trains as before the warm-up
    assert torch.isfinite(step(state, batches[2])["total_loss"]) and state.step == 2


def _cli_fixture(tmp_path, extra=None):
    make_megadepth_fixture(tmp_path, pairs_per_scene=10)
    write_yaml(tmp_path / "features_cache" / "config.yaml",
               {"name": "OPENCV_SIFT", "descriptor_dim": 32, "parameters": {}})
    (tmp_path / "train_list.txt").write_text("scene_a\nscene_b\n")
    (tmp_path / "val_list.txt").write_text("scene_a\n")
    override = {
        "data": {"root_path": str(tmp_path), "train_list_path": "train_list.txt", "val_list_path": "val_list.txt",
                 "features_dir": "features_cache", "max_keypoints": 64, "batch_size": 8,
                 "dataloader_workers": 2, "target_size": list(TARGET_CACHED), "val_max_pairs_per_scene": 2,
                 "train_pairs_overlap": None, "buckets": [32, 64], "device_descriptor_cache": 0},
        "logging": {"root_path": str(tmp_path / "logs"), "name": "t", "train_logs_steps": 1},
        "train": {"epochs": 1, "steps_per_epoch": 2, "lr": 1.0e-3, "gt_positive_threshold": 3,
                  "gt_negative_threshold": 5},
        "superglue": {"positional_encoding": {"hidden_layers_sizes": [16]},
                      "attention_gnn": {"num_stages": 1}, "otp": {"num_iters": 5}},
        **(extra or {}),
    }
    write_yaml(tmp_path / "override.yaml", override)
    return ["--config", str(REPO / "configs" / "config_cached_sp_magicleap.yaml"),
            "--config_override", str(tmp_path / "override.yaml")]


def test_train_cached_cli_smoke_on_cpu(tmp_path, capsys):
    """Mirrors tests/test_cli.py::TestTrainCachedCLI.test_smoke on the
    flagship config with an override: trains, validates and checkpoints,
    then resumes from the checkpoint."""
    args = _cli_fixture(tmp_path)
    state = train_cached.main(args + ["--device", "cpu"])
    assert state.step == 2 and state.model.config.use_pallas and next(state.model.parameters()).device.type == "cpu"
    exp_dirs = list((tmp_path / "logs" / "t").iterdir())
    assert len(exp_dirs) == 1
    assert (exp_dirs[0] / "config.yaml").exists() and (exp_dirs[0] / "features_config.yaml").exists()
    assert checkpoint.latest_step(exp_dirs[0] / "checkpoints") == 2
    saved = yaml.safe_load((exp_dirs[0] / "config.yaml").read_text())
    assert saved["data"]["device_descriptor_cache"] == 0 and saved["superglue"]["attention_gnn"]["num_heads"] == 4
    out = capsys.readouterr().out
    assert "warm-up: one step at N=32" in out and "epoch 0 val" in out and "AUC@20deg" in out
    resumed = train_cached.main(args + ["--device", "cpu", "--checkpoint", str(exp_dirs[0] / "checkpoints")])
    assert resumed.step == 4


def test_train_cached_module_runs_and_refuses_a_missing_card(tmp_path):
    """``python -m`` on the CPU trains to its checkpoint; without --device it
    asks for CUDA and raises where there is none."""
    args = _cli_fixture(tmp_path)
    cmd = [sys.executable, "-m", "openglue_tpu_torch.cli.train_cached", *args]
    done = subprocess.run(cmd + ["--device", "cpu", "--smoke"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert list((tmp_path / "logs" / "t").glob("*/checkpoints/2.pt"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cached.main(args)


@pytest.mark.parametrize("extra, argv", [
    ({"data": {"device_descriptor_cache": 512}}, []),
    ({}, ["--checkify"]),
], ids=["device-cache", "checkify"])
def test_train_cached_refuses_what_is_not_ported(tmp_path, monkeypatch, extra, argv):
    """What was refused before it was ported: the flagship's device cache
    (512 slots) now trains; --checkify, which trains in one process
    (tests/test_torch_debugging.py), is refused in a job of two (it stays a
    one-process debugging path)."""
    args = _cli_fixture(tmp_path)
    if argv:
        monkeypatch.delenv("MASTER_ADDR", raising=False)
        monkeypatch.setenv("WORLD_SIZE", "2")
        with pytest.raises(ValueError, match="--checkify runs in one process; this job has 2"):
            train_cached.main(args + argv + ["--device", "cpu"])
        return
    config = yaml.safe_load((tmp_path / "override.yaml").read_text())
    config["data"].update(extra["data"])
    write_yaml(tmp_path / "override.yaml", config)
    state = train_cached.main(args + ["--device", "cpu", "--smoke"])
    assert state.step == 2 and all(torch.isfinite(p).all() for p in state.model.parameters())


def test_train_cached_refuses_data_parallel_worlds(tmp_path, monkeypatch):
    """A data-parallel world trains (tests/test_torch_data_parallel.py), but
    one that WORLD_SIZE names without the address of its rendezvous
    (MASTER_ADDR, as torchrun sets it) is refused."""
    args = _cli_fixture(tmp_path)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert parallel.data_parallel_world_size() == 2
    with pytest.raises(RuntimeError, match="MASTER_ADDR is not set"):
        train_cached.main(args + ["--device", "cpu"])
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert parallel.data_parallel_world_size() == 1


def test_dataset_refuses_device_descriptors(tmp_path):
    """The dataset's device mode (once refused, now the device cache's
    contract): each side carries the image cache's unfiltered block itself,
    its key and the surviving rows' indices in the block, which pick host
    mode's descriptors; every other field is host mode's."""
    make_megadepth_fixture(tmp_path)
    kw = dict(target_size=TARGET_CACHED, random_crop=True, seed=5)
    host = MegaDepthPairsDatasetFeatures(tmp_path, "features_cache", ["scene_a", "scene_b"], **kw)
    device = MegaDepthPairsDatasetFeatures(tmp_path, "features_cache", ["scene_a", "scene_b"],
                                           device_descriptors=True, **kw)
    for i in range(len(host)):
        h, d = host[i], device[i]
        assert set(d) - set(h) == {"desc_key0", "desc_key1", "desc_orig_idx0", "desc_orig_idx1"}
        rec = device.index[i]
        for side, img in ((0, rec.img0), (1, rec.img1)):
            key, idx = d[f"desc_key{side}"], d[f"desc_orig_idx{side}"]
            assert key == (rec.scene, img) and idx.dtype == np.int32
            assert d[f"descriptors{side}"] is device._image_cache[key][2]
            np.testing.assert_array_equal(d[f"descriptors{side}"][idx], h[f"descriptors{side}"])
            for field in ("lafs", "scores"):
                np.testing.assert_array_equal(d[f"{field}{side}"], h[f"{field}{side}"])
        for key in ("K0", "K1", "R", "T", "depth0", "depth1"):
            np.testing.assert_array_equal(d["transformation"][key], h["transformation"][key])


# ------------------------------------------------ chip_smoke's trainer phase


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_trainer_fixture_is_the_examples():
    """The trainer phase writes the fixture with the generator arguments in
    examples/train_e2e_fixture.yaml's header."""
    header = (REPO / "examples" / "train_e2e_fixture.yaml").read_text()
    call = re.search(r"generate_megadepth_fixture\('fixtures/megadepth', (.*?)\)\"", header, re.S).group(1)
    call = ast.parse(f"f({call.replace(chr(92), '').replace('#', '')})").body[0].value
    assert _chip_smoke().TRAINER_FIXTURE == {kw.arg: ast.literal_eval(kw.value) for kw in call.keywords}


def test_chip_smoke_memory_h5_reads_as_io_does(tmp_path):
    """The in-memory store that stands in for data.io's h5 functions on the
    card gives what the files give."""
    from openglue_tpu_torch.data import io

    store = _chip_smoke().MemoryH5()
    rng = np.random.default_rng(0)
    arrays = {"d.h5": (rng.uniform(size=(6, 8)).astype(np.float32), "depth"),
              "s.h5": (np.arange(4, dtype=np.int64), "data"), "o.h5": (rng.normal(size=(3, 2)), "other")}
    for name, (array, key) in arrays.items():
        for save in (io.save_h5, store.save_h5):
            save(tmp_path / name, array, key=key, compression="gzip" if key == "depth" else None)
    for name, (array, key) in arrays.items():
        for k in (key, None):
            got, ref = store.load_h5(tmp_path / name, key=k), io.load_h5(tmp_path / name, key=k)
            np.testing.assert_array_equal(got, ref)
            assert got.dtype == ref.dtype
            assert store.h5_dataset_shape(tmp_path / name, key=k) == io.h5_dataset_shape(tmp_path / name, key=k)
    with pytest.raises(FileNotFoundError):
        store.load_h5(tmp_path / "missing.h5")
    assert store.nbytes() == sum(a.nbytes for a, _ in arrays.values())


@pytest.mark.parametrize("fault", [None, "K4", "K5"])
def test_chip_smoke_holds_every_message_launch_of_a_step(batches, fault):
    """The trainer phase's per-launch check sees every K4 and K5 call of a
    bf16-chain training step on the message route, and fails on a bf16
    launch that lies farther from the f32 computation than its bar allows
    (here a CPU step, whose kernels are their plain versions, with one
    planted fault of 10% in one output)."""
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk

    smoke = _chip_smoke()
    section = dict(SMALL_SUPERGLUE, use_pallas=True, chain_dtype="bfloat16")
    config = dict(CONFIG, superglue=section)
    model = SuperGlue(common.superglue_config_from(config, DIM, 0), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, optimizer=common.optimizer_from(config, model.parameters()))
    held = smoke.HeldMessageKernels(glk)
    forward, backward = glk.message_forward, glk.message_backward
    bf16 = lambda args: torch.bfloat16 in args
    if fault == "K4":
        held.forward_kernel = lambda *a: (lambda msg, attn, lse: (
            msg * 1.1 if bf16(a) else msg, attn, lse))(*forward(*a))
    elif fault == "K5":
        held.backward_kernel = lambda *a: (lambda dxq, dxkv, dw: (
            dxq, dxkv * 1.1 if bf16(a) else dxkv, dw))(*backward(*a))
    step = make_train_step(common.loss_config_from(config))
    layers = 2 * SMALL_SUPERGLUE["attention_gnn"]["num_stages"] * 2
    with smoke.replaced(*held.entries()):
        if fault is None:
            assert torch.isfinite(step(state, batches[0])["total_loss"])
        else:
            what = "msg" if fault == "K4" else "dx_kv"
            with pytest.raises(AssertionError, match=f"{fault} bfloat16 launch 0 at N={N}: distance from f32 "
                                                     f"{what} kernel"):
                step(state, batches[0])
    assert (glk.message_forward, glk.message_backward) == (forward, backward)
    if fault is None:
        # the chain is bf16 into the first stage's self layers, f32 after them
        assert held.launches == {("K4", "bfloat16"): 2, ("K4", "float32"): layers - 2,
                                 ("K5", "bfloat16"): 2, ("K5", "float32"): layers - 2}
        assert {k: v for k, v in held.worst.items() if k[2] == "vs plain"} == {
            (k, t, "vs plain"): 0.0 for k in ("K4", "K5") for t in ("bfloat16", "float32")}
        # kernel and plain are one computation here: each lies as far from f32 as the other
        assert 0 < held.worst[("K4", "bfloat16", "ratio")] < 1 and 0 < held.worst[("K5", "bfloat16", "ratio")] < 1
        assert "K5 bfloat16: 2 launches, worst vs plain 0.000e+00, ratio" in held.line()

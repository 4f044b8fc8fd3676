"""The online trainer's pieces (module 9b) against the JAX package on the CPU,
at the shapes of tests/test_online_training.py: images 64x80 (B=2),
SuperPoint with 64 keypoints and D=64, a matcher of 2 stages. The JAX
initializations are jitted and carried over by ``compat.jax_weights``; where
the JAX side has Pallas kernels they run in interpret mode under forced
dispatch, as its own tests run them.

- the datasets: ``HomographyPairsDataset`` and ``MegaDepthPairsDataset``
  give JAX's samples byte for byte, and ``collate_image_pairs`` its batches;
- ``features_to_keypoint_set`` and the torch LAF converters (every method)
  within 1e-6;
- ``MatchingModule``: the same keypoints (SuperPoint exactly; the DoG SIFT
  and GFTT-HardNet as their own tests hold them, 90% within ``KEYPOINT_PX``,
  tests/test_torch_scale_space.py) and the log-assignment within 1e-4;
- one online step (augmentation "none"), frozen and fine-tuning: loss 1e-5,
  gradient norm 1e-4 relative, updated parameters and statistics 1e-5; the
  frozen extractor's parameters and statistics unchanged bit for bit;
- the eval step's decode, ``HomographyPrecisionMetric`` and
  ``evaluate_online``, on perspective and 3d_reprojection batches.
"""

import dataclasses
import functools

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openglue_tpu import native as jax_native
from openglue_tpu.cli import online as jax_online
from openglue_tpu.core.types import Features as JaxFeatures
from openglue_tpu.core.types import Transformation as JaxTransformation
from openglue_tpu.data.homography import HomographyPairsDataset as JaxHomographyPairs
from openglue_tpu.data.megadepth import MegaDepthPairsDataset as JaxMegaDepthPairs
from openglue_tpu.features import lafs as jlafs
from openglue_tpu.features.prepare import features_to_keypoint_set as jax_features_to_keypoint_set
from openglue_tpu.metrics import HomographyPrecisionMetric as JaxHomographyPrecision
from openglue_tpu.models.matching_module import MatchingModule as JaxMatchingModule
from openglue_tpu.models.matching_module import MatchingModuleConfig as JaxMatchingModuleConfig
from openglue_tpu.ops.pallas import force_fused_dispatch
from openglue_tpu.train import LossConfig as JaxLossConfig
from openglue_tpu.train import create_train_state as jax_create_train_state
from openglue_tpu.train.loop import TrainLoopConfig as JaxTrainLoopConfig
from openglue_tpu.train.loop import evaluate_online as jax_evaluate_online
from openglue_tpu.train.state import make_online_optimizer as jax_make_online_optimizer
from openglue_tpu.train.step import make_online_eval_step as jax_make_online_eval_step
from openglue_tpu.train.step import make_online_train_step as jax_make_online_train_step
from openglue_tpu_torch.cli import online
from openglue_tpu_torch.compat.jax_weights import (
    matching_module_state_dict_from_jax, superglue_grads_from_jax, superpoint_state_dict_from_jax,
)
from openglue_tpu_torch.core.types import Features, Transformation
from openglue_tpu_torch.data.fixture import generate_image_fixture
from openglue_tpu_torch.data.homography import HomographyPairsDataset
from openglue_tpu_torch.data.megadepth import MegaDepthPairsDataset
from openglue_tpu_torch.features import lafs
from openglue_tpu_torch.features.prepare import features_to_keypoint_set
from openglue_tpu_torch.metrics import HomographyPrecisionMetric
from openglue_tpu_torch.models.matching_module import MatchingModule, MatchingModuleConfig
from openglue_tpu_torch.train.loop import TrainLoopConfig, evaluate_online
from openglue_tpu_torch.train.state import create_train_state, make_online_optimizer
from openglue_tpu_torch.train.step import LossConfig, make_online_eval_step, make_online_train_step
from tests.test_data import make_megadepth_fixture
from tests.test_torch_scale_space import KEYPOINT_PX

MATCHER = {
    "positional_encoding": {"hidden_layers_sizes": [32]},
    "attention_gnn": {"num_stages": 2, "num_heads": 4},
    "otp": {"num_iters": 8},
    "residual": True,
}
SUPERPOINT = {"name": "SuperPointNet", "parameters": {"max_keypoints": 64, "descriptor_dim": 64}}
EXTRACTORS = {
    "SuperPointNet": (SUPERPOINT, "none", (64, 80)),
    "SIFT": ({"name": "SIFT", "descriptor_dim": 128, "parameters": {"max_keypoints": 64, "double_image": False}},
             "scale_rotation", (96, 128)),
    "GFTTAffNetHardNet": ({"name": "GFTTAffNetHardNet", "descriptor_dim": 128,
                           "parameters": {"max_keypoints": 32, "descriptor_dim": 128}}, "affine", (96, 128)),
}
SUPERPOINT_BN = {"name": "SuperPointNetBn", "parameters": {"max_keypoints": 64, "descriptor_dim": 64}}
LOSS = dict(positive_threshold=3.0, negative_threshold=5.0)
LR = 1e-3


@pytest.fixture(autouse=True)
def jax_nms_on_its_scipy_path(monkeypatch):
    monkeypatch.setattr(jax_native, "nms_keypoints_native", lambda *args, **kwargs: None)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def image_pairs(h=64, w=80, batch=2, seed=0):
    """tests/test_online_training.py's image pairs: discs, and a shift of
    (3, -2) px as the homography; numpy arrays."""
    rng = np.random.default_rng(seed)
    images0, images1, Hs = [], [], []
    for _ in range(batch):
        img = np.zeros((h, w), np.uint8)
        for _ in range(25):
            x, y = rng.integers(5, w - 5), rng.integers(5, h - 5)
            cv2.circle(img, (int(x), int(y)), int(rng.integers(2, 6)), int(rng.integers(80, 255)), -1)
        H = np.array([[1, 0, 3.0], [0, 1, -2.0], [0, 0, 1]], np.float32)
        images0.append(img.astype(np.float32) / 255.0)
        images1.append(cv2.warpPerspective(img, H, (w, h)).astype(np.float32) / 255.0)
        Hs.append(H)
    return np.stack(images0), np.stack(images1), np.stack(Hs)


def jax_batch(images0, images1, H):
    return {"image0": jnp.asarray(images0), "image1": jnp.asarray(images1),
            "transformation": JaxTransformation(kind="perspective", H=jnp.asarray(H))}


def port_batch(images0, images1, H):
    return {"image0": torch.from_numpy(images0), "image1": torch.from_numpy(images1),
            "transformation": Transformation(kind="perspective", H=torch.from_numpy(H))}


def config_dict(name="SuperPointNet", finetune=False, use_pallas=False):
    features, laf, _ = EXTRACTORS.get(name, (SUPERPOINT_BN, "none", None))
    return {"features": features, "laf_to_sideinfo_method": laf,
            "superglue": dict(MATCHER, use_pallas=use_pallas),
            "train": {"finetune_features_extractor": finetune}}


@functools.lru_cache(maxsize=None)
def _jax_variables(name):
    """The JAX module's jitted initialization from key 0, as numpy."""
    jmodel = JaxMatchingModule(JaxMatchingModuleConfig.from_dict(config_dict(name)))
    images = image_pairs(*_size(name))
    return _np(jax.jit(jmodel.init)(jax.random.key(0), jnp.asarray(images[0]), jnp.asarray(images[1])))


def _size(name):
    return EXTRACTORS.get(name, (None, None, (64, 80)))[2]


def modules(name="SuperPointNet", finetune=False, use_pallas=False):
    """(JAX module, its variables, the port's module with those weights, the
    image pairs) for one extractor."""
    cfg = config_dict(name, finetune, use_pallas)
    jmodel = JaxMatchingModule(JaxMatchingModuleConfig.from_dict(cfg))
    variables = _jax_variables(name)
    config = MatchingModuleConfig.from_dict(cfg)
    port = MatchingModule(config, device="cpu")
    port.load_state_dict(matching_module_state_dict_from_jax(variables, config))
    return jmodel, variables, port, image_pairs(*_size(name))


@functools.lru_cache(maxsize=None)
def _jax_eval_step():
    return jax.jit(jax_make_online_eval_step(0.0))


# ------------------------------------------------------------- the data


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("homography")
    generate_image_fixture(root, num_images=3, image_size=(200, 160), seed=4)
    return root


@pytest.mark.parametrize("color", [True, False])
def test_homography_pairs_are_jax_bytes(image_folder, color):
    kw = dict(target_size=(96, 64), max_corner_offset=16, color_augmentation=color, seed=7)
    port, ref = HomographyPairsDataset(image_folder, **kw), JaxHomographyPairs(image_folder, **kw)
    assert [p.name for p in port.paths] == [p.name for p in ref.paths] and len(port) == 3
    for idx in (0, 2, 0, 1):  # the rng advances: a repeated index draws anew
        got, want = port[idx], ref[idx]
        for key in ("image0", "image1"):
            assert got[key].dtype == np.float32 and got[key].tobytes() == want[key].tobytes()
        assert got["transformation"]["type"] == "perspective"
        assert got["transformation"]["H"].tobytes() == want["transformation"]["H"].tobytes()


def test_megadepth_image_pairs_are_jax_bytes(tmp_path):
    make_megadepth_fixture(tmp_path, with_features=False)
    kw = dict(target_size=(120, 80), random_crop=True, seed=3)
    port = MegaDepthPairsDataset(tmp_path, ["scene_a", "scene_b"], **kw)
    ref = JaxMegaDepthPairs(tmp_path, ["scene_a", "scene_b"], **kw)
    assert len(port) == len(ref) == 6
    for idx in (0, 4, 4, 5):
        got, want = port[idx], ref[idx]
        for key in ("image0", "image1"):
            assert got[key].shape == (80, 120) and got[key].tobytes() == want[key].tobytes()
        for key in ("K0", "K1", "R", "T", "depth0", "depth1"):
            assert got["transformation"][key].tobytes() == want["transformation"][key].tobytes(), key


def test_collate_image_pairs_matches_jax(image_folder, tmp_path):
    make_megadepth_fixture(tmp_path, with_features=False)
    homography = HomographyPairsDataset(image_folder, target_size=(96, 64), max_corner_offset=16)
    megadepth = MegaDepthPairsDataset(tmp_path, ["scene_a"], target_size=(120, 80))
    for samples, kind in (([homography[0], homography[1]], "perspective"),
                          ([megadepth[0], megadepth[1]], "3d_reprojection")):
        got, want = online.collate_image_pairs(samples), jax_online.collate_image_pairs(samples)
        assert got["transformation"].kind == want["transformation"].kind == kind
        for key in ("image0", "image1"):
            np.testing.assert_array_equal(got[key].numpy(), want[key])
        for f in dataclasses.fields(want["transformation"])[1:]:
            value = getattr(want["transformation"], f.name)
            assert (getattr(got["transformation"], f.name) is None) == (value is None), f.name
            if value is not None:
                np.testing.assert_array_equal(getattr(got["transformation"], f.name).numpy(), value)
        moved = online.image_batch_to_device(got, "cpu")
        assert moved["image0"].shape == (2, *samples[0]["image0"].shape)


@pytest.mark.parametrize("method", sorted(jlafs._METHODS))
@pytest.mark.parametrize("log_response", [False, True])
def test_features_to_keypoint_set_matches_jax(method, log_response):
    rng = np.random.default_rng(1)
    A = rng.normal(0, 3, (2, 16, 2, 2)).astype(np.float32)
    lafs_ = np.concatenate([A, rng.uniform(0, 80, (2, 16, 2, 1)).astype(np.float32)], axis=-1)
    responses = rng.uniform(0, 1, (2, 16)).astype(np.float32)
    desc = rng.normal(size=(2, 16, 8)).astype(np.float32)
    mask = rng.uniform(size=(2, 16)) < 0.8
    size = np.array([80.0, 64.0], np.float32)
    want = jax_features_to_keypoint_set(
        JaxFeatures(*map(jnp.asarray, (lafs_, responses, desc, mask))),
        jlafs.get_laf_to_sideinfo_converter(method), jnp.asarray(size), log_response=log_response)
    converter = lafs.get_laf_to_sideinfo_converter(method)
    got = features_to_keypoint_set(Features(*map(torch.from_numpy, (lafs_, responses, desc, mask))),
                                   converter, size, log_response=log_response)
    assert got.side_info.shape[-1] == converter.side_info_dim + 1
    for key in ("keypoints", "descriptors", "side_info", "mask", "image_size"):
        np.testing.assert_allclose(getattr(got, key).numpy(), np.asarray(getattr(want, key)), rtol=0, atol=1e-6,
                                   err_msg=key)
    # the numpy form, which the collate runs, answers the same
    np.testing.assert_allclose(converter(lafs_), got.side_info.numpy()[..., 1:], rtol=0, atol=1e-6)


# ------------------------------------------------------------- the module


def test_config_from_dict_matches_jax():
    cfg = {"features": {"parameters": {"max_keypoints": 128, "descriptor_dim": 128}},
           "laf_to_sideinfo_method": "scale_rotation",
           "superglue": {"descriptor_dim": 999, "attention_gnn": {"num_stages": 3}},
           "train": {"finetune_features_extractor": True}}
    got, want = MatchingModuleConfig.from_dict(cfg), JaxMatchingModuleConfig.from_dict(cfg)
    assert (got.superglue.descriptor_dim, got.superglue.side_info_size, got.superglue.num_stages) == (128, 4, 3)
    assert (got.superglue.descriptor_dim, got.superglue.side_info_size) == (
        want.superglue.descriptor_dim, want.superglue.side_info_size)
    assert (got.extractor_name, got.extractor_params, got.finetune) == (
        want.extractor_name, want.extractor_params, want.finetune)
    with pytest.raises(ValueError, match="requires a device extractor"):
        MatchingModule(MatchingModuleConfig.from_dict({"features": {"name": "OPENCV_SIFT"}}), device="cpu")


def _found_share(got, want, mask_got, mask_want):
    """The share of JAX's valid keypoints that the port found within
    KEYPOINT_PX (tests/test_torch_patch_networks.py's reading)."""
    shares = []
    for g, w, mg, mw in zip(got, want, mask_got, mask_want):
        dist = np.linalg.norm(w[mw][:, None] - g[mg][None], axis=-1)
        shares.append(float((dist.min(1) <= KEYPOINT_PX).mean()))
    return min(shares)


# whether an extractor's keypoints and descriptors agree with JAX's row for
# row, so that the whole forward is held: SuperPoint's do; a DoG keypoint
# moved by 1e-4 px can turn its orientation by a bin, and with it the
# descriptor, and GFTT's top-k breaks ties between symmetric discs apart, so
# for SIFT and GFTT only the matcher on JAX's keypoint sets is held
ROWS_AGREE = {"SuperPointNet": True, "SIFT": False, "GFTTAffNetHardNet": False}
assert set(ROWS_AGREE) == set(EXTRACTORS)


@pytest.mark.parametrize("name", sorted(ROWS_AGREE))
def test_matching_module_forward_matches_jax(name):
    """The extraction (SuperPoint: the same keypoints row for row; the DoG
    SIFT and GFTT: at least 90% of JAX's valid keypoints within KEYPOINT_PX,
    as their own tests hold them, since equal responses of symmetric corners
    round apart), the matcher on JAX's keypoint sets within 1e-4, and, where
    ``rows_agree``, the rows themselves and the whole forward within 1e-4."""
    jmodel, variables, port, (images0, images1, _) = modules(name)
    (want, jpair) = jax.jit(jmodel.apply)(variables, jnp.asarray(images0), jnp.asarray(images1))
    with torch.no_grad():
        got, pair = port.eval()(torch.from_numpy(images0), torch.from_numpy(images1))
    rows_agree = ROWS_AGREE[name]
    for side, jside in ((pair.side0, jpair.side0), (pair.side1, jpair.side1)):
        kpts, jkpts, mask, jmask = (np.asarray(x) for x in (side.keypoints, jside.keypoints, side.mask, jside.mask))
        assert jmask.sum(1).min() > 5 and side.side_info.shape == jside.side_info.shape
        assert _found_share(kpts, jkpts, mask, jmask) >= 0.9
        np.testing.assert_array_equal(side.image_size.numpy(), np.asarray(jside.image_size))
        if rows_agree:
            np.testing.assert_array_equal(mask, jmask)
            np.testing.assert_array_equal(kpts, jkpts)
            np.testing.assert_allclose(side.descriptors.numpy(), np.asarray(jside.descriptors), rtol=0, atol=1e-5)
    if name == "SIFT":
        assert not dict(port.extractor.state_dict())
    if rows_agree:
        np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0, atol=1e-4)
    t = lambda x: torch.from_numpy(np.array(x))
    with torch.no_grad():
        on_jax_sets = port.superglue(**{f"{k}{i}": t(getattr(s, f)) for i, s in enumerate((jpair.side0, jpair.side1))
                                        for k, f in (("kpts", "keypoints"), ("desc", "descriptors"),
                                                     ("side_info", "side_info"), ("image_size", "image_size"),
                                                     ("mask", "mask"))})
    np.testing.assert_allclose(on_jax_sets["scores"].numpy(), np.asarray(want["scores"]), rtol=0, atol=1e-4)


# ------------------------------------------------------------- the steps


def _jax_step(jmodel, variables, batch, finetune, use_pallas):
    tx = jax_make_online_optimizer(variables["params"], learning_rate=LR, finetune_extractor=finetune)
    state = jax_create_train_state(jmodel.apply, variables, tx=tx)
    force_fused_dispatch(use_pallas)
    try:
        return jax.jit(jax_make_online_train_step(JaxLossConfig(**LOSS), augmentation="none"))(
            state, batch, jax.random.key(0))
    finally:
        force_fused_dispatch(False)


def _jax_gradients(new_state, config, finetune):
    """JAX's gradients under the port's names: below the clip, Adam's first
    moment after one update is (1 - b1) * grad."""
    adam = [s for s in jax.tree_util.tree_leaves(
        new_state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    mu = jax.tree_util.tree_map(lambda m: np.asarray(m) / np.float32(0.1), dict(adam.mu))
    grads = {f"superglue.{k}": v for k, v in superglue_grads_from_jax(mu["superglue"], config.superglue).items()}
    if finetune:
        grads.update({f"extractor.{k}": v for k, v in superpoint_state_dict_from_jax({"params": mu["extractor"]}).items()})
    return grads


@pytest.mark.parametrize("finetune,use_pallas", [(False, False), (False, True), (True, False)])
def test_online_step_matches_jax(finetune, use_pallas):
    """Loss 1e-5, gradient norm 1e-4 relative, every gradient at the f32
    bar of tests/test_torch_train.py, the running statistics and the updated
    parameters 1e-5. Adam's first update is lr * g / (|g| + 1e-8), so an
    entry whose gradient is zero in exact arithmetic (a bias ahead of a
    BatchNorm with every ReLU on: |g| about 1e-8 of rounding) moves by the
    sign of its rounding: those entries, |g| < 1e-6 on both sides, each move
    by at most lr either way and are held within 2 lr of JAX's."""
    jmodel, variables, port, images = modules(finetune=finetune, use_pallas=use_pallas)
    new_state, metrics = _jax_step(jmodel, variables, jax_batch(*images), finetune, use_pallas)
    before = {k: v.clone() for k, v in port.extractor.state_dict().items()}
    state = create_train_state(port, optimizer=make_online_optimizer(port, learning_rate=LR,
                                                                     finetune_extractor=finetune))
    got = make_online_train_step(LossConfig(**LOSS), augmentation="none")(state, port_batch(*images))
    assert state.step == 1 and float(metrics["total_loss"]) > 0.1 and float(metrics["grad_norm"]) < 10.0
    np.testing.assert_allclose(got["total_loss"].item(), float(metrics["total_loss"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["grad_norm"].item(), float(metrics["grad_norm"]), rtol=1e-4)
    grads = _jax_gradients(new_state, port.config, finetune)
    params = dict(port.named_parameters())
    assert set(grads) == {k for k, p in params.items() if p.grad is not None}
    for name, g in grads.items():
        scale = np.abs(g.numpy()).max()
        np.testing.assert_allclose(params[name].grad.numpy(), g.numpy(), atol=3e-4 + 1e-5 * scale, rtol=1e-4,
                                   err_msg=name)
    updated = matching_module_state_dict_from_jax(
        _np({"params": new_state.params, **new_state.model_state}), port.config)
    own = port.state_dict()
    assert set(updated) == set(own)
    for key, value in updated.items():
        got_value, want = own[key].numpy(), value.numpy()
        if key in grads:
            unresolved = (np.abs(grads[key].numpy()) < 1e-6) & (np.abs(params[key].grad.numpy()) < 1e-6)
            np.testing.assert_allclose(got_value[~unresolved], want[~unresolved], rtol=0, atol=1e-5, err_msg=key)
            np.testing.assert_allclose(got_value, want, rtol=0, atol=2 * LR + 1e-5, err_msg=key)
        else:
            np.testing.assert_allclose(got_value, want, rtol=0, atol=1e-5, err_msg=key)
    extractor = port.extractor.state_dict()
    if finetune:
        assert not torch.equal(extractor["conv1a.weight"], before["conv1a.weight"])
        assert len(state.optimizer.params) == len(list(port.parameters()))
    else:
        assert all(torch.equal(extractor[k], v) for k, v in before.items())
        assert {id(p) for p in state.optimizer.params} == {id(p) for p in port.superglue.parameters()}


def test_frozen_bn_extractor_keeps_its_statistics():
    """SuperPoint with BatchNorms (JAX's initialization), frozen, with
    weak_color_aug: the extractor's parameters and running statistics
    unchanged bit for bit after a step that updates the matcher (in training
    mode its BatchNorms would move their statistics)."""
    _, _, port, images = modules("SuperPointNetBn")
    before = {k: v.clone() for k, v in port.state_dict().items()}
    state = create_train_state(port, optimizer=make_online_optimizer(port, learning_rate=LR))
    metrics = make_online_train_step(LossConfig(**LOSS), augmentation="weak_color_aug")(state, port_batch(*images))
    after = port.state_dict()
    assert metrics["total_loss"].item() > 0.1
    assert sum("running_mean" in k for k in before if k.startswith("extractor.")) == 12
    for key, value in before.items():
        if key.startswith("extractor."):
            assert torch.equal(after[key], value), key
    assert not torch.equal(after["superglue.dustbin_score"], before["superglue.dustbin_score"])


def test_eval_step_and_evaluate_online_match_jax():
    jmodel, variables, port, images = modules()
    jstate = jax_create_train_state(jmodel.apply, variables)
    state = create_train_state(port, optimizer=make_online_optimizer(port))
    want = _jax_eval_step()(jstate, jax_batch(*images))
    got = make_online_eval_step(0.0)(state, port_batch(*images))
    for key in ("matches0", "matches1", "keypoints0", "keypoints1", "mask0"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["matching_scores0"].numpy(), np.asarray(want["matching_scores0"]),
                               rtol=0, atol=1e-5)
    assert (got["matches0"] >= 0).sum() > 0

    # the metric on the decoded batch, and evaluate_online over perspective batches
    metric, ref = HomographyPrecisionMetric(), JaxHomographyPrecision()
    H = images[2]
    metric.update(got["keypoints0"], got["keypoints1"], got["matches0"], torch.from_numpy(H),
                  num_detected=got["mask0"].sum(1).numpy())
    ref.update(np.asarray(want["keypoints0"]), np.asarray(want["keypoints1"]), np.asarray(want["matches0"]), H,
               num_detected=np.asarray(want["mask0"]).sum(1))
    metric.sync()
    assert metric.compute() == pytest.approx(ref.compute(), abs=1e-6)
    assert metric.precisions == pytest.approx(ref.precisions, abs=1e-6)
    ours = evaluate_online(state, make_online_eval_step(0.0), [port_batch(*images)] * 2, TrainLoopConfig())
    theirs = jax_evaluate_online(jstate, _jax_eval_step(), [jax_batch(*images)] * 2,
                                 JaxTrainLoopConfig())
    assert set(ours) == set(theirs) == {"H-Precision@3.0px", "H-Matching Score@3.0px"}
    for key, value in theirs.items():
        assert ours[key] == pytest.approx(value, abs=1e-6), key


def test_evaluate_online_on_reprojection_batches(tmp_path):
    """3d_reprojection batches (the MegaDepth fixture): the epipolar and
    pose-AUC metrics, as JAX's evaluate_online reports them."""
    make_megadepth_fixture(tmp_path, with_features=False)
    samples = MegaDepthPairsDataset(tmp_path, ["scene_a"], target_size=(80, 64))
    batch = online.collate_image_pairs([samples[0], samples[1]])
    jbatch = jax_online.collate_image_pairs([samples[0], samples[1]])
    jbatch = dict(jbatch, transformation=jax.tree_util.tree_map(jnp.asarray, jbatch["transformation"]))
    jmodel, variables, port, _ = modules()
    jstate = jax_create_train_state(jmodel.apply, variables)
    state = create_train_state(port, optimizer=make_online_optimizer(port))
    config = dict(eval_threshold=1.0, ransac_thresh_px=1.0)
    ours = evaluate_online(state, make_online_eval_step(0.0), [batch], TrainLoopConfig(**config))
    theirs = jax_evaluate_online(jstate, _jax_eval_step(), [jbatch],
                                 JaxTrainLoopConfig(**config))
    assert set(ours) == set(theirs) and "Precision@1.0" in ours
    for key, value in theirs.items():
        assert ours[key] == pytest.approx(value, abs=1e-6), key


def test_step_learns_on_a_fixed_batch():
    """The port alone, frozen SuperPoint with weak_color_aug: the loss of a
    fixed batch falls over 10 steps."""
    _, _, port, images = modules()
    state = create_train_state(port, optimizer=make_online_optimizer(port, learning_rate=1e-3))
    step = make_online_train_step(LossConfig(**LOSS), augmentation="weak_color_aug", seed=3)
    first = step(state, port_batch(*images))["total_loss"].item()
    for _ in range(9):
        last = step(state, port_batch(*images))["total_loss"].item()
    assert last < first and np.isfinite(last)

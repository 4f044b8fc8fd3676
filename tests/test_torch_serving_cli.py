"""The port's serving and evaluation entry points against the JAX package on
the CPU: ``cli.extract_features`` (the same h5 arrays and config.yaml),
``cli.inference.run_inference`` from a JAX experiment and a port experiment
holding the same weights (with and without buckets), ``_to_bucket`` and
``cli.evaluate``; and, the port alone, the warm-up that changes nothing, the
three calibration states of an int8_static matcher, the CLI's files and the
refusals.

The matcher is tests/test_cli.py's SMALL_SUPERGLUE (1 stage, 4 heads) at the
SIFT width D=128, on 320x256 images with at most 256 keypoints. JAX's NMS
runs its scipy path (see tests/test_torch_features.py)."""

import shutil

import cv2
import jax
import numpy as np
import pytest
import torch
import yaml

from openglue_tpu import native as jax_native
from openglue_tpu.cli import common as jax_common
from openglue_tpu.cli import evaluate as jax_evaluate
from openglue_tpu.cli import extract_features as jax_extract
from openglue_tpu.cli import inference as jax_inference
from openglue_tpu.core.config import Config as JaxConfig
from openglue_tpu.data.synthetic import SyntheticHomographyPairs as JaxPairs
from openglue_tpu.models.superglue import SuperGlue as JaxSuperGlue
from openglue_tpu.train import create_train_state as jax_create_train_state
from openglue_tpu.train.checkpoint import save_train_state as jax_save_train_state
from openglue_tpu.train.step import superglue_inputs as jax_superglue_inputs
from openglue_tpu_torch.cli import common, evaluate, extract_features, inference
from openglue_tpu_torch.compat.jax_weights import superglue_state_dict_from_jax
from openglue_tpu_torch.data import io
from openglue_tpu_torch.data.fixture import generate_image_fixture, generate_megadepth_fixture
from openglue_tpu_torch.models.superglue import SuperGlue
from openglue_tpu_torch.train.checkpoint import save_train_state
from openglue_tpu_torch.train.state import create_train_state
from tests.test_cli import SMALL_SUPERGLUE, write_yaml

FEATURES = {"name": "OPENCV_SIFT", "descriptor_dim": 128,
            "parameters": {"max_keypoints": 256, "nms_diameter": 9, "rootsift": True}}
# threshold 0: at random weights no confidence clears the usual 0.2, and the
# mutual nearest neighbours are where the decode has content
CONFIG = {"superglue": SMALL_SUPERGLUE, "inference": {"match_threshold": 0.0}}
TARGET = (320, 240)  # the 400x320 images resize to 320x256 (w, h): not square
# a mild homography: image1 = H(image0)
H = np.array([[0.97, -0.05, 9.0], [0.05, 0.97, -6.0], [2e-5, -1e-5, 1.0]])


@pytest.fixture(autouse=True)
def jax_nms_on_its_scipy_path(monkeypatch):
    monkeypatch.setattr(jax_native, "nms_keypoints_native", lambda *args, **kwargs: None)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("images")
    generate_image_fixture(root / "raw", num_images=1, image_size=(400, 320), seed=3)
    base = cv2.imread(str(root / "raw" / "img0000.jpg"), cv2.IMREAD_GRAYSCALE)
    cv2.imwrite(str(root / "a.png"), base)
    cv2.imwrite(str(root / "b.png"), cv2.warpPerspective(base, H, (400, 320)))
    shutil.rmtree(root / "raw")
    return root


def yaml_config(data):
    return JaxConfig(yaml.safe_load(yaml.safe_dump(data)))


def _jax_checkpoint(directory, config, dim, seed, step):
    """A seeded JAX initialization saved by JAX's save_train_state; returns
    its variables as numpy arrays. It is made as JAX's initialize_matcher
    makes its template (eagerly, from a synthetic pair), which warms the
    operations that function then runs."""
    model = JaxSuperGlue(jax_common.superglue_config_from(config, dim, 0))
    dummy = JaxPairs(num_keypoints=16, descriptor_dim=dim, side_info_dim=1).sample(jax.random.key(0), 1)
    variables = model.init(jax.random.key(seed), **jax_superglue_inputs(dummy))
    jax_save_train_state(directory, jax_create_train_state(model.apply, variables), step=step)
    return jax.tree_util.tree_map(np.asarray, variables)


def _experiment(path, config, checkpoint):
    write_yaml(path / "config.yaml", config)
    write_yaml(path / "features_config.yaml", FEATURES)
    checkpoint(path / "checkpoints")
    return path


def _port_model(config, variables=None):
    cfg = common.superglue_config_from(config, 128, 0)
    model = SuperGlue(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    if variables is not None:
        model.load_state_dict(superglue_state_dict_from_jax(variables, cfg))
    return model


@pytest.fixture(scope="module")
def experiments(tmp_path_factory):
    """A JAX experiment (JAX's save_train_state of a JAX initialization) and
    port experiments holding the same weights, on the composed path and on
    the kernels' plain versions (use_pallas)."""
    root = tmp_path_factory.mktemp("experiments")
    saved = {}
    jax_exp = _experiment(root / "jax", CONFIG, lambda d: saved.update(
        variables=_jax_checkpoint(d, CONFIG, 128, seed=0, step=0)))
    variables = saved["variables"]
    out = {"jax": jax_exp}
    for name, section in (("composed", SMALL_SUPERGLUE), ("kernels", dict(SMALL_SUPERGLUE, use_pallas=True))):
        config = dict(CONFIG, superglue=section)
        model = _port_model(config, variables)
        out[name] = _experiment(root / name, config, lambda d: save_train_state(d, create_train_state(model), step=0))
    return out


def _matches0(result, n):
    m = np.full(n, -1)
    m[result["indices0"]] = result["indices1"]
    return m


def _hold_to_jax(port, ref):
    """scores within 5e-4 (tests/test_torch_superglue.py:118), the decode's
    matches0 agreeing on at least 99% of the keypoints, the keypoints of the
    agreeing matches identical."""
    assert port["scores"].shape == ref["scores"].shape
    np.testing.assert_allclose(port["scores"], ref["scores"], rtol=0, atol=5e-4)
    n = port["scores"].shape[0] - 1
    a, b = _matches0(port, n), _matches0(ref, n)
    assert (a == b).mean() >= 0.99 and (a >= 0).sum() >= 20
    both = np.intersect1d(port["indices0"], ref["indices0"])
    for key in ("keypoints0", "keypoints1", "lafs0", "lafs1"):
        got = port[key][np.isin(port["indices0"], both)]
        want = np.asarray(ref[key])[np.isin(ref["indices0"], both)]
        keep = a[both] == b[both]
        np.testing.assert_array_equal(got[keep], want[keep])


def test_extract_features_main_matches_jax(images, tmp_path):
    feat = tmp_path / "sift.yaml"
    write_yaml(feat, FEATURES)
    for main, out in ((extract_features.main, "port"), (jax_extract.main, "jax")):
        main(["--features_config", str(feat), "--data_dir", str(images), "--output_dir", str(tmp_path / out),
              "--target_size", *map(str, TARGET)])
    port, ref = tmp_path / "port" / "OPENCV_SIFT_320_240", tmp_path / "jax" / "OPENCV_SIFT_320_240"
    assert (port / "config.yaml").read_text() == (ref / "config.yaml").read_text()
    files = sorted(p.name for p in port.iterdir())
    assert files == sorted(p.name for p in ref.iterdir()) and len(files) == 9
    for name in files:
        if name.endswith(".h5"):
            got, want = io.load_h5(port / name), io.load_h5(ref / name)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert io.load_h5(port / "a_size.h5").tolist() == [320, 256]
    assert io.load_h5(port / "a_descriptors.h5").shape == (256, 128)


@pytest.mark.parametrize("path", ["composed", "kernels"])
def test_run_inference_matches_jax(images, experiments, path):
    ref_matcher = jax_inference.initialize_matcher(experiments["jax"], target_size=TARGET)
    matcher = inference.initialize_matcher(experiments[path], target_size=TARGET, device="cpu")
    img = io.read_grayscale(images / "a.png")
    for got, want in zip(matcher.extract(img), ref_matcher.extract(img)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert matcher.extract(img)[-1] == (320, 256)
    ref = jax_inference.run_inference(ref_matcher, images / "a.png", images / "b.png", ransac=False)
    port = inference.run_inference(matcher, images / "a.png", images / "b.png", ransac=False)
    _hold_to_jax(port, ref)

    # MAGSAC keeps the matches that agree with the homography
    kept = inference.run_inference(matcher, images / "a.png", images / "b.png", ransac=True)
    assert len(kept["keypoints0"]) >= 8 and set(kept["indices0"]) <= set(port["indices0"])
    scale = 320 / 400
    S = np.array([[scale, 0, 0.5 * scale - 0.5], [0, scale, 0.5 * scale - 0.5], [0, 0, 1]])
    projected = np.c_[kept["keypoints0"], np.ones(len(kept["keypoints0"]))] @ (S @ H @ np.linalg.inv(S)).T
    error = np.linalg.norm(projected[:, :2] / projected[:, 2:] - kept["keypoints1"], axis=1)
    assert np.median(error) < 3.0


@pytest.mark.parametrize("buckets,expected", [((64, 512), 512), ((64, 128), 128)])
def test_bucketed_inference_matches_jax(images, experiments, buckets, expected):
    ref_matcher = jax_inference.initialize_matcher(experiments["jax"], target_size=TARGET, buckets=buckets)
    matcher = inference.initialize_matcher(experiments["composed"], target_size=TARGET, buckets=buckets,
                                           device="cpu")
    ref = jax_inference.run_inference(ref_matcher, images / "a.png", images / "b.png", ransac=False)
    port = inference.run_inference(matcher, images / "a.png", images / "b.png", ransac=False)
    assert matcher._last_num_keypoints == ref_matcher._last_num_keypoints == expected
    _hold_to_jax(port, ref)


@pytest.mark.parametrize("bucket", [3, 5, 6, 8, 12])
def test_to_bucket_matches_jax(bucket):
    """tests/test_cli.py:518-546's arrays through both packages: trimming
    keeps the valid keypoints of highest response, padding masks out."""
    n = 8
    lafs = np.arange(n * 6, dtype=np.float32).reshape(n, 2, 3)
    scores = np.array([0.9, 0.1, 0.5, 0.7, 0.3, 0.0, 0.0, 0.0], np.float32)
    mask = np.array([1, 1, 1, 1, 1, 0, 0, 0], bool)
    desc = np.tile(np.arange(n, dtype=np.float32)[:, None], (1, 4))
    got = inference.OpenGlueMatcher._to_bucket(lafs, scores, desc, mask, bucket)
    want = jax_inference.OpenGlueMatcher._to_bucket(lafs, scores, desc, mask, bucket)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape[0] == bucket
        np.testing.assert_array_equal(a, b)
    assert got[3].sum() == min(bucket, 5)


def test_precompile_changes_nothing(images, experiments, capsys):
    """The warm-up (the JAX package's precompile) leaves the served result
    bit-equal, the model in eval mode and its state as it was
    (tests/test_cli.py:439-451)."""
    matcher = inference.initialize_matcher(experiments["kernels"], target_size=TARGET, device="cpu",
                                           buckets=(128, 256))
    before = inference.run_inference(matcher, images / "a.png", images / "b.png", ransac=False)
    state = {k: v.clone() for k, v in matcher.model.state_dict().items()}
    matcher.precompile(matcher.buckets)
    assert "one forward at N=128/256" in capsys.readouterr().out
    assert not matcher.model.training
    assert all(torch.equal(v, state[k]) for k, v in matcher.model.state_dict().items())
    after = inference.run_inference(matcher, images / "a.png", images / "b.png", ransac=False)
    assert set(after) == set(before)
    for key in before:
        np.testing.assert_array_equal(after[key], before[key], err_msg=key)


def test_int8_static_calibration_states(images, experiments, tmp_path):
    """A fresh matcher, one restored from a checkpoint without a calibration
    and one restored from a calibrated checkpoint, told apart by the flag
    that ``calibrate`` sets and the state dict carries (not by the absmax
    values): the first two refuse to warm up until their first pair has
    calibrated them; the third serves as the matcher that calibrated."""
    config = dict(CONFIG, superglue=dict(SMALL_SUPERGLUE, use_pallas=True, quantize="int8_static"))
    fresh = inference.OpenGlueMatcher(yaml_config(config), yaml_config(FEATURES), device="cpu", target_size=TARGET)
    assert fresh.static_int8 and fresh.model.int8_calibration.calibrated is False
    with pytest.raises(RuntimeError, match="uncalibrated"):
        fresh.precompile(256)

    exp = tmp_path / "int8"
    shutil.copytree(experiments["kernels"], exp)
    write_yaml(exp / "config.yaml", config)
    served = inference.initialize_matcher(exp, target_size=TARGET, device="cpu")
    assert served.model.int8_calibration.calibrated is False
    with pytest.raises(RuntimeError, match="uncalibrated"):
        served.precompile(256)
    first = inference.run_inference(served, images / "a.png", images / "b.png", ransac=False)
    assert served.model.int8_calibration.calibrated is True
    served.precompile(256)
    second = inference.run_inference(served, images / "a.png", images / "b.png", ransac=False)
    np.testing.assert_array_equal(second["scores"], first["scores"])
    # the static int8 serving against the same weights unquantized
    plain = inference.run_inference(inference.initialize_matcher(experiments["kernels"], target_size=TARGET,
                                                                  device="cpu"),
                                    images / "a.png", images / "b.png", ransac=False)
    agree = (_matches0(second, 256) == _matches0(plain, 256)).mean()
    assert agree >= 0.9

    calibrated = tmp_path / "calibrated"
    shutil.copytree(exp, calibrated)
    save_train_state(calibrated / "checkpoints", create_train_state(served.model), step=1)
    restored = inference.initialize_matcher(calibrated, target_size=TARGET, device="cpu")
    assert restored.model.int8_calibration.calibrated is True
    for layer, ref in zip(restored.model.attention_gnn.layers, served.model.attention_gnn.layers):
        assert torch.equal(layer.module.act_absmax, ref.module.act_absmax)
    restored.precompile(256)
    third = inference.run_inference(restored, images / "a.png", images / "b.png", ransac=False)
    np.testing.assert_array_equal(third["scores"], second["scores"])
    # the fresh matcher's uncalibrated state, saved and restored, stays so
    save_train_state(exp / "checkpoints", create_train_state(fresh.model), step=2)
    assert inference.initialize_matcher(exp, target_size=TARGET, device="cpu").model.int8_calibration.calibrated is False


def test_inference_main_writes_the_matches_and_the_drawing(images, experiments, tmp_path, capsys):
    result = inference.main(["--experiment", str(experiments["composed"]), "--image0", str(images / "a.png"),
                             "--image1", str(images / "b.png"), "--output", str(tmp_path / "m.npz"),
                             "--visualize", str(tmp_path / "m.png"), "--device", "cpu"])
    assert f"{len(result['keypoints0'])} matches" in capsys.readouterr().out
    saved = np.load(tmp_path / "m.npz")
    for key in ("keypoints0", "keypoints1", "confidence"):
        np.testing.assert_array_equal(saved[key], result[key])
    # the CLI's default target size, 960x720: the 400x320 images at 960x768
    assert cv2.imread(str(tmp_path / "m.png")).shape == (768, 1920, 3)


def test_evaluate_main_matches_jax(tmp_path):
    """Both evaluation CLIs on one MegaDepth-format fixture, from a JAX
    experiment and a port experiment with the same weights: the epipolar
    precision and matching score equal, the pose AUCs within 1e-6."""
    root = tmp_path / "megadepth"
    generate_megadepth_fixture(root, scenes=2, images_per_scene=5, points_per_scene=120, image_size=(160, 120),
                               descriptor_dim=32, val_scenes=1, seed=3)
    config = dict(CONFIG, data={
        "root_path": str(root), "features_dir": "SyntheticSphere_640_480",
        "val_list_path": "assets/megadepth_valid.txt", "test_list_path": "assets/megadepth_valid.txt",
        "max_keypoints": 64, "buckets": [32, 64], "batch_size": 4, "dataloader_workers": 0,
        "target_size": [160, 120], "val_max_pairs_per_scene": 8},
        evaluation={"epipolar_dist_threshold": 5e-4, "camera_auc_thresholds": [5, 10, 20],
                    "camera_auc_ransac_inliers_threshold": 1.0})
    features = yaml.safe_load((root / "SyntheticSphere_640_480" / "config.yaml").read_text())
    jax_exp, port_exp = tmp_path / "jax", tmp_path / "port"
    for exp in (jax_exp, port_exp):
        write_yaml(exp / "config.yaml", config)
        write_yaml(exp / "features_config.yaml", features)
    variables = _jax_checkpoint(jax_exp / "checkpoints", config, 32, seed=2, step=5)
    cfg = common.superglue_config_from(config, 32, 0)
    model = SuperGlue(cfg, device="cpu")
    model.load_state_dict(superglue_state_dict_from_jax(variables, cfg))
    save_train_state(port_exp / "checkpoints", create_train_state(
        model, optimizer=common.optimizer_from(config, model.parameters())), step=5)

    ref = jax_evaluate.main(["--experiment", str(jax_exp)])
    port = evaluate.main(["--experiment", str(port_exp), "--checkpoint_step", "5", "--device", "cpu"])
    assert set(port) == set(ref)
    for key, value in ref.items():
        if key.startswith("AUC"):
            np.testing.assert_allclose(port[key], value, rtol=0, atol=1e-6, err_msg=key)
        else:
            assert port[key] == value, key
    assert ref["Precision@0.0005"] > 0.1


def test_refusals(images, experiments, tmp_path):
    online = tmp_path / "online"
    shutil.copytree(experiments["composed"], online)
    write_yaml(online / "config.yaml", dict(CONFIG, features={"name": "SuperPointNet"}))
    with pytest.raises(NotImplementedError, match="online experiment.*module 9b"):
        inference.initialize_matcher(online, device="cpu")
    # the device extractors are served now (tests/test_torch_device_serving.py)
    superpoint = {"name": "SuperPointNet", "descriptor_dim": 256, "parameters": {"max_keypoints": 32}}
    assert inference.OpenGlueMatcher(yaml_config(CONFIG), yaml_config(superpoint), device="cpu").device_extractor
    write_yaml(tmp_path / "sp.yaml", superpoint)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            extract_features.main(["--features_config", str(tmp_path / "sp.yaml"), "--data_dir", str(images),
                                   "--output_dir", str(tmp_path / "out")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            inference.initialize_matcher(experiments["composed"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluate.main(["--experiment", str(experiments["composed"])])

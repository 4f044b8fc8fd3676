"""The slice as a whole on the CPU: the flagship's own flow with a device
extractor, the port against the JAX package. ``cli.extract_features`` with a
SuperPoint features config writes the same h5 arrays as JAX's cacher, and
``OpenGlueMatcher`` extracts the same keypoints, computes the same
log-assignment and returns the same matches as JAX's, from experiments that
hold the same weights. Also the refusals that stay: an online experiment
(module 9b) and ``--device cuda`` without a card.

The extractor is configs/features/superpoint_magicleap.yaml as written
(SuperPoint D=256, 2048 keypoints, NMS 9, border 4, threshold 0.005) with
its ``weights`` set to a JAX initialization carried over by
``compat.jax_weights`` and saved with ``torch.save``, which both packages
load. The matcher is tests/test_cli.py's SMALL_SUPERGLUE at 2 stages and 8
heads of width 32, on the composed path on both sides. The images are
250x190, resized to 160x122 and padded to 160x128 for the extractor, so the
padding band's seam is exercised."""

import shutil
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from openglue_tpu.cli import extract_features as jax_extract
from openglue_tpu.cli import inference as jax_inference
from openglue_tpu.features import superpoint as jsp
from openglue_tpu_torch.cli import common, extract_features, inference
from openglue_tpu_torch.compat.jax_weights import superglue_state_dict_from_jax, superpoint_state_dict_from_jax
from openglue_tpu_torch.data import io
from openglue_tpu_torch.data.fixture import generate_image_fixture
from openglue_tpu_torch.models.superglue import SuperGlue
from openglue_tpu_torch.train.checkpoint import save_train_state
from openglue_tpu_torch.train.state import create_train_state
from tests.test_cli import SMALL_SUPERGLUE, write_yaml
from tests.test_torch_serving_cli import _jax_checkpoint

FEATURES = yaml.safe_load((Path(__file__).resolve().parents[1] / "configs/features/superpoint_magicleap.yaml").read_text())
SP_PARAMS, D = FEATURES["parameters"], FEATURES["descriptor_dim"]
SECTION = dict(SMALL_SUPERGLUE, attention_gnn=dict(SMALL_SUPERGLUE["attention_gnn"], num_stages=2, num_heads=8))
CONFIG = {"superglue": SECTION, "inference": {"match_threshold": 0.0}}
TARGET = (160, 120)
H = np.array([[0.98, -0.04, 6.0], [0.04, 0.98, -4.0], [1e-5, -2e-5, 1.0]])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Two images (a fixture image and its warped copy), the features config
    with its weights file, and a JAX and a port experiment with the same
    matcher weights."""
    root = tmp_path_factory.mktemp("device_serving")
    generate_image_fixture(root / "raw", num_images=1, image_size=(250, 190), seed=5)
    base = cv2.imread(str(root / "raw" / "img0000.jpg"), cv2.IMREAD_GRAYSCALE)
    (root / "images").mkdir()
    cv2.imwrite(str(root / "images" / "a.png"), base)
    cv2.imwrite(str(root / "images" / "b.png"), cv2.warpPerspective(base, H, (250, 190)))
    shutil.rmtree(root / "raw")

    model = jsp.SuperPoint(jsp.SuperPointConfig(**SP_PARAMS))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.key(7), jnp.zeros((1, 64, 64, 1))))
    torch.save(superpoint_state_dict_from_jax(variables), root / "superpoint.pth")
    features = dict(FEATURES, weights=str(root / "superpoint.pth"))
    write_yaml(root / "features.yaml", features)

    experiments = {}
    for name in ("jax", "port"):
        exp = root / name
        write_yaml(exp / "config.yaml", CONFIG)
        write_yaml(exp / "features_config.yaml", features)
        experiments[name] = exp
    jax_variables = _jax_checkpoint(experiments["jax"] / "checkpoints", CONFIG, D, seed=1, step=0)
    cfg = common.superglue_config_from(CONFIG, D, 0)
    port_model = SuperGlue(cfg, device="cpu")
    port_model.load_state_dict(superglue_state_dict_from_jax(jax_variables, cfg))
    save_train_state(experiments["port"] / "checkpoints", create_train_state(port_model), step=0)
    return dict(root=root, images=root / "images", features=root / "features.yaml", experiments=experiments)


def test_extract_features_main_device_branch_matches_jax(setup, tmp_path):
    """The same h5 arrays: every keypoint identical (rows in the same
    order), descriptors within 1e-5, responses within 1e-6, the size; the
    padding band's detections dropped in both."""
    args = ["--features_config", str(setup["features"]), "--data_dir", str(setup["images"]),
            "--target_size", *map(str, TARGET)]
    extract_features.main(args + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    jax_extract.main(args + ["--output_dir", str(tmp_path / "jax")])
    port, ref = tmp_path / "port" / "SuperPointNet_160_120", tmp_path / "jax" / "SuperPointNet_160_120"
    assert (port / "config.yaml").read_text() == (ref / "config.yaml").read_text()
    files = sorted(p.name for p in port.iterdir())
    assert files == sorted(p.name for p in ref.iterdir()) and len(files) == 9
    for base in ("a", "b"):
        lafs, want_lafs = io.load_h5(port / f"{base}_lafs.h5"), io.load_h5(ref / f"{base}_lafs.h5")
        assert lafs.dtype == want_lafs.dtype == np.float32 and 40 <= len(lafs) <= SP_PARAMS["max_keypoints"]
        np.testing.assert_array_equal(lafs, want_lafs)
        assert (lafs[:, 0, 2] < 160).all() and (lafs[:, 1, 2] < 122).all()
        np.testing.assert_allclose(io.load_h5(port / f"{base}_descriptors.h5"),
                                   io.load_h5(ref / f"{base}_descriptors.h5"), rtol=0, atol=1e-5)
        np.testing.assert_allclose(io.load_h5(port / f"{base}_scores.h5"), io.load_h5(ref / f"{base}_scores.h5"),
                                   rtol=0, atol=1e-6)
        assert io.load_h5(port / f"{base}_size.h5").tolist() == io.load_h5(ref / f"{base}_size.h5").tolist() == [160, 122]


def test_match_images_matches_jax(setup):
    """The served pair: the same extracted keypoints (padding rows
    included), and in the 512 bucket log_P within 1e-4 nats on the valid
    entries and identical matches at threshold 0."""
    exps = setup["experiments"]
    ref_matcher = jax_inference.initialize_matcher(exps["jax"], target_size=TARGET, buckets=(512,))
    matcher = inference.initialize_matcher(exps["port"], target_size=TARGET, device="cpu", buckets=(512,))
    assert matcher.device_extractor and isinstance(matcher.extractor, torch.nn.Module)
    img0, img1 = (io.read_grayscale(setup["images"] / f"{n}.png") for n in "ab")
    for img in (img0, img1):
        got, want = matcher.extract(img), ref_matcher.extract(img)
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))  # lafs, every row
        np.testing.assert_array_equal(got[3], np.asarray(want[3]))  # mask: the seam's detections dropped
        np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=0, atol=1e-5)
        assert got[4] == want[4] == (160, 122)
    port = matcher.match_images(img0, img1)
    ref = jax_inference.OpenGlueMatcher.match_images(ref_matcher, img0, img1)
    masks = [inference.OpenGlueMatcher._to_bucket(*matcher.extract(img)[:4], 512)[3] for img in (img0, img1)]
    assert matcher._last_num_keypoints == ref_matcher._last_num_keypoints == 512
    valid = np.append(masks[0], True)[:, None] & np.append(masks[1], True)[None, :]
    np.testing.assert_allclose(port["scores"][valid], np.asarray(ref["scores"])[valid], rtol=0, atol=1e-4)
    for key in ("indices0", "indices1", "keypoints0", "keypoints1"):
        np.testing.assert_array_equal(port[key], np.asarray(ref[key]), err_msg=key)
    assert len(port["indices0"]) >= 5


def test_run_inference_with_ransac_and_buckets(setup):
    """The served path end to end with buckets: the pair lands in the
    smallest bucket that holds both images' valid keypoints, MAGSAC keeps a
    subset of the matches (at random weights few of them agree with one
    epipolar geometry)."""
    buckets = (256, 512, 1024)
    matcher = inference.initialize_matcher(setup["experiments"]["port"], target_size=TARGET, device="cpu",
                                           buckets=buckets)
    plain = inference.run_inference(matcher, setup["images"] / "a.png", setup["images"] / "b.png", ransac=False)
    kept = inference.run_inference(matcher, setup["images"] / "a.png", setup["images"] / "b.png")
    counts = [int(matcher.extract(io.read_grayscale(setup["images"] / f"{n}.png"))[3].sum()) for n in "ab"]
    assert matcher._last_num_keypoints == min(b for b in buckets if b >= max(counts))
    assert set(kept["indices0"]) <= set(plain["indices0"]) and len(plain["indices0"]) >= 8


def test_refusals_that_stay(setup, tmp_path):
    online = tmp_path / "online"
    shutil.copytree(setup["experiments"]["port"], online)
    write_yaml(online / "config.yaml", dict(CONFIG, features={"name": "SuperPointNet"}))
    with pytest.raises(NotImplementedError, match="online experiment.*module 9b"):
        inference.initialize_matcher(online, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            extract_features.main(["--features_config", str(setup["features"]), "--data_dir", str(setup["images"]),
                                   "--output_dir", str(tmp_path / "out")])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            inference.initialize_matcher(setup["experiments"]["port"])
        assert not (tmp_path / "out").exists()


def test_agreement_readings_and_bars():
    """``features/agreement.py``, which holds the card's extractions to the
    CPU's: an identical extraction meets the bars; a keypoint moved past
    KEYPOINT_PX is not found, one whose frame turned by an orientation bin
    is found but not with the same frame, and three descriptors of 288
    moved past DESCRIPTOR_MAX put the share under the 99% bar."""
    from openglue_tpu_torch.features import agreement as agree

    rng = np.random.default_rng(0)
    n = 300
    lafs = np.zeros((n, 2, 3), np.float32)
    lafs[:, :, :2] = 6 * np.eye(2)
    lafs[:, :, 2] = rng.uniform(0, 300, (n, 2))
    ref = (lafs, rng.uniform(0.01, 1, n).astype(np.float32), rng.normal(0, 0.1, (n, 8)).astype(np.float32),
           np.arange(n) < 290)
    same = agree.agreement(ref, ref)
    assert agree.within_bars(same) and same["shared"] == same["frames"] == same["descriptors"] == 1.0
    assert same["descriptor_max"] == 0.0
    got = [a.copy() for a in ref]
    got[0][0, :, 2] += 0.2  # moved
    c, s = np.cos(np.pi / 18), np.sin(np.pi / 18)
    got[0][1, :, :2] = got[0][1, :, :2] @ np.array([[c, -s], [s, c]], np.float32)  # turned by a bin
    got[2][1] += 0.5
    readings = agree.agreement(got, ref)
    assert readings["shared"] == readings["frames"] + 1 / 290 == 289 / 290
    assert readings["descriptor_max"] == 0.0 and readings["turned_descriptor_max"] == pytest.approx(0.5)
    assert agree.within_bars(readings)  # one keypoint of 290 of each kind: within the 99% bars
    got[2][2:5] += 0.01  # descriptors past the bar with their frames the same: 3 of 288
    readings = agree.agreement(got, ref)
    assert readings["descriptors"] == 285 / 288 and readings["descriptor_max"] == pytest.approx(0.01)
    assert not agree.within_bars(readings)
    assert readings["identified"] == 1.0 and agree.within_bars(readings, descriptor_max=False)
    held = np.ones(n, bool)
    held[2:5] = False  # flat patches: their descriptors are not held
    readings = agree.agreement(got, ref, held=held)
    assert readings["held"] == 287 / 290 and readings["descriptors"] == 1.0 and agree.within_bars(readings)
    image = np.zeros((64, 64), np.uint8)
    image[:, 32:] = 200
    lafs = np.zeros((2, 2, 3), np.float32)
    lafs[:, :, :2] = 4 * np.eye(2)
    lafs[:, :, 2] = [[32, 32], [10, 32]]  # on the step; on the flat half
    assert agree.textured(image, lafs, 16).tolist() == [True, False]
    got[2][5:8] = got[2][8:11]  # descriptors that are other keypoints' (whose own tie with them: identified)
    readings = agree.agreement(got, ref)
    assert readings["identified"] == 285 / 288 and not agree.within_bars(readings, descriptor_max=False)

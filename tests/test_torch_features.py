"""The port's host feature extraction against the JAX package on the CPU:
the native NMS against its plain scipy version and JAX's, the OpenCV SIFT
extractor bit for bit, ``prepare_features_output``, the registry, the image
fixture byte for byte and the match drawing; and, the port alone, six
processes building the native NMS at once.

JAX's NMS runs its scipy path here (``openglue_tpu.native`` is patched to
report no library): the JAX package's native library is built by
tests/test_native.py, and building it from this file too would race that
build."""

import subprocess
import sys
import time
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from openglue_tpu import native as jax_native
from openglue_tpu.data.fixture import generate_image_fixture as jax_generate_image_fixture
from openglue_tpu.features import opencv_features as jax_ocv
from openglue_tpu.features.lafs import get_laf_to_sideinfo_converter as jax_converter
from openglue_tpu.features.prepare import prepare_features_output as jax_prepare
from openglue_tpu.visualization import draw_matches as jax_draw_matches
from openglue_tpu_torch import native
from openglue_tpu_torch.data.fixture import generate_image_fixture
from openglue_tpu_torch.features import opencv_features as ocv
from openglue_tpu_torch.features import registry
from openglue_tpu_torch.features.lafs import get_laf_to_sideinfo_converter
from openglue_tpu_torch.features.prepare import prepare_features_output
from openglue_tpu_torch.visualization import draw_matches

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def jax_nms_on_its_scipy_path(monkeypatch):
    monkeypatch.setattr(jax_native, "nms_keypoints_native", lambda *args, **kwargs: None)


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    """One fixture image at the tests' 320x240 serving size."""
    root = tmp_path_factory.mktemp("images")
    generate_image_fixture(root, num_images=1, image_size=(400, 320), seed=1)
    return cv2.resize(cv2.imread(str(root / "img0000.jpg"), cv2.IMREAD_GRAYSCALE), (320, 240))


def _keypoints(case):
    rng = np.random.default_rng(len(case))
    n, extent, radius, ties = case
    kpts = (rng.random((n, 2)) * extent).astype(np.float32)
    if ties == "quantized":  # ORB/FAST-style responses tie constantly
        resp = rng.integers(0, 8, size=n).astype(np.float32)
    elif ties == "duplicates":  # coincident keypoints
        kpts = np.repeat(kpts[: n // 5], 5, axis=0)
        resp = rng.permutation(len(kpts)).astype(np.float32)
    else:
        resp = rng.permutation(n).astype(np.float32) / n
    return kpts, resp, radius


@pytest.mark.parametrize("case", [
    (1, 100.0, 4.5, None),
    (500, 300.0, 4.5, None),
    (5000, 960.0, 4.5, None),
    (3000, 50.0, 9.0, None),  # heavy suppression: a dense cluster
    (2000, 6000.0, 0.8, None),  # sparse: almost nothing suppressed
    (3000, 500.0, 4.5, "quantized"),
    (500, 1000.0, 1.0, "duplicates"),
    (800, 300.0, 0.0, "quantized"),  # radius 0 suppresses exact duplicates only
])
def test_native_nms_equals_its_scipy_version_and_jax(case):
    kpts, resp, radius = _keypoints(case)
    keep = ocv.nms_keypoints(kpts, resp, radius)
    assert keep.dtype == bool and keep.shape == resp.shape and keep.any()
    np.testing.assert_array_equal(keep, ocv.nms_keypoints_scipy(kpts, resp, radius))
    np.testing.assert_array_equal(keep, jax_ocv.nms_keypoints(kpts, resp, radius))


def test_native_nms_refuses_what_its_grid_cannot_take():
    kpts = np.zeros((4, 2), np.float32)
    kpts[0, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        native.nms_keypoints_native(kpts, np.ones(4, np.float32), 1.0)
    with pytest.raises(ValueError, match="bad shapes"):
        native.nms_keypoints_native(np.zeros((4, 3), np.float32), np.ones(4, np.float32), 1.0)


_BUILDER = """
import sys, time
from pathlib import Path
import numpy as np
from openglue_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
go = Path(sys.argv[2])
while not go.exists():
    time.sleep(0.001)
kpts = np.array([[0, 0], [1, 0], [10, 10], [10.5, 10]], np.float32)
keep = native.nms_keypoints_native(kpts, np.array([0.9, 0.5, 0.3, 0.8], np.float32), 2.0)
assert keep.tolist() == [True, False, False, True], keep
print(native.library_path().name)
"""


def test_six_processes_building_the_native_nms_at_once_all_load_it(tmp_path):
    """Each process compiles to a file named by its pid and moves it into
    place, so none can load a half-written library."""
    go = tmp_path / "go"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, str(tmp_path / "build"), str(go)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    time.sleep(1.0)  # every process imported and waiting
    go.touch()
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [err for _, err in outs]
    names = {out.strip() for out, _ in outs}
    assert names == {native.library_path().name}
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(names)  # no temporary left


def test_sift_detect_and_compute_is_bit_equal_to_jax(image):
    port = ocv.sift_create(max_keypoints=256).detect_and_compute(image)
    ref = jax_ocv.sift_create(max_keypoints=256).detect_and_compute(image)
    lafs, scores, desc, mask = port
    assert lafs.shape == (256, 2, 3) and desc.shape == (256, 128) and mask.sum() == 256
    for got, want in zip(port, ref):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_descriptor_normalization_and_lafs_equal_jax():
    d = np.abs(np.random.default_rng(0).normal(size=(10, 128))).astype(np.float32)
    for root in (True, False):
        np.testing.assert_array_equal(ocv.normalize_descriptors(d, root), jax_ocv.normalize_descriptors(d, root))
    kps = [cv2.KeyPoint(10.0, 20.0, 2.0, 90.0, 0.5), cv2.KeyPoint(3.5, 7.25, 4.0, 33.0, 0.1)]
    for got, want in zip(ocv.lafs_from_opencv_keypoints(kps), jax_ocv.lafs_from_opencv_keypoints(kps)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method,log_response", [("none", False), ("scale_rotation", True), ("affine", False)])
def test_prepare_features_output_matches_jax(image, method, log_response):
    lafs, scores, desc, mask = ocv.sift_create(max_keypoints=128).detect_and_compute(image)
    mask = mask.copy()
    mask[100:] = False
    size = np.asarray((320, 240), np.float32)  # (w, h) of a non-square image
    port = prepare_features_output(lafs[None], scores[None], desc[None], get_laf_to_sideinfo_converter(method),
                                   size, mask=mask[None], log_response=log_response, device="cpu")
    ref = jax_prepare(jnp.asarray(lafs[None]), jnp.asarray(scores[None]), jnp.asarray(desc[None]),
                      jax_converter(method), jnp.asarray(size), mask=jnp.asarray(mask[None]),
                      log_response=log_response)
    for field in ("keypoints", "descriptors", "side_info", "mask", "image_size"):
        got, want = getattr(port, field), np.asarray(getattr(ref, field))
        assert got.shape == want.shape and got.device.type == "cpu", field
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6, err_msg=field)
    assert port.image_size.tolist() == [[320.0, 240.0]]


@pytest.mark.parametrize("name", ["SuperPointNet", "SuperPointNetBn", "SIFT", "GFTTAffNetHardNet",
                                  "OPENCVDoGAffNetHardNet"])
def test_registry_refuses_the_unported_extractors_naming_module_9(name):
    with pytest.raises(NotImplementedError, match="module 9"):
        registry.get_feature_extractor(name)
    assert registry.is_device_extractor(name) == (name != "OPENCVDoGAffNetHardNet")


def test_registry_host_sift_and_unknown_names():
    assert registry.get_feature_extractor("OPENCV_SIFT") is ocv.sift_create
    assert not registry.is_device_extractor("OPENCV_SIFT")
    with pytest.raises(ValueError, match="Unknown feature extractor 'nope'"):
        registry.get_feature_extractor("nope")


def test_image_fixture_is_byte_equal_to_jax(tmp_path):
    port = generate_image_fixture(tmp_path / "port", num_images=3, image_size=(320, 256), seed=4)
    ref = jax_generate_image_fixture(tmp_path / "jax", num_images=3, image_size=(320, 256), seed=4)
    assert port == ref
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) == ["img0000.jpg", "img0001.jpg", "img0002.jpg"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_draw_matches_equals_jax(image, tmp_path):
    lafs, scores, _, _ = ocv.sift_create(max_keypoints=64).detect_and_compute(image)
    kpts = lafs[:, :, 2]
    other = image[:200]  # images of two heights
    conf = np.linspace(0, 1, 64, dtype=np.float32)
    kw = dict(lafs0=lafs, lafs1=lafs, max_draw=40)
    port = draw_matches(image, other, kpts, kpts * 0.8, conf, output_path=tmp_path / "m.png", **kw)
    ref = jax_draw_matches(image, other, kpts, kpts * 0.8, conf, **kw)
    assert port.shape == (240, 640, 3)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "m.png")), ref)

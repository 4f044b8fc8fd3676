"""The port's scale-space detector, patch sampling and SIFT descriptor
against the JAX package's on the CPU in f32: LAF patches and their
normalization, the Gaussian blur and the 2x upsample (borders included),
``detect_keypoints`` with the DoG and GFTT responses, the dominant
orientation, ``rotate_lafs``, ``sift_describe_patches`` and the whole DoG
SIFT extractor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglue_tpu.features import patches as jpatches
from openglue_tpu.features import scale_space as jss
from openglue_tpu.features.sift import SIFTFeature as JaxSIFT
from openglue_tpu.features.sift import sift_describe_patches as jax_sift_describe
from openglue_tpu_torch.features import patches, scale_space
from openglue_tpu_torch.features.sift import SIFTFeature, sift_describe_patches

T = torch.from_numpy


def blob_image(centers, sigmas, size=(128, 160)):
    h, w = size
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    for (cx, cy), s in zip(centers, sigmas):
        img += np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * s * s))
    return img


def texture(shape, seed):
    """Faint seeded noise: it breaks the images' symmetries (a symmetric
    blob has voxels whose responses tie in exact arithmetic and rank by
    float rounding) and leaves no flat region (where a response is float
    noise)."""
    return 0.02 * np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def corner_image():
    img = np.zeros((96, 96), np.float32)
    img[30:70, 25:75] = 1.0
    return np.array(jss.gaussian_blur(jnp.asarray(img[None]), 1.5))[0] + texture((96, 96), 7)


def random_lafs(rng, b, n, h, w):
    """LAFs of random centre (some off the image), scale and shape."""
    lafs = np.zeros((b, n, 2, 3), np.float32)
    lafs[..., 0, 2] = rng.uniform(-5, w + 5, (b, n))
    lafs[..., 1, 2] = rng.uniform(-5, h + 5, (b, n))
    lafs[..., :2, :2] = rng.normal(0, 4, (b, n, 2, 2)) + 6 * np.eye(2)
    return lafs


def test_patches_match_jax():
    rng = np.random.default_rng(0)
    image = rng.uniform(0, 1, (2, 40, 56)).astype(np.float32)
    lafs = random_lafs(rng, 2, 12, 40, 56)
    for ps in (8, 19):
        got = patches.extract_laf_patches(T(image), T(lafs), ps)
        want = jpatches.extract_laf_patches(jnp.asarray(image), jnp.asarray(lafs), ps)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    coords = rng.uniform(-3, 60, (2, 7, 5, 2)).astype(np.float32)
    got = patches.bilinear_sample_image(T(image), T(coords))
    for b in range(2):
        want = jpatches.bilinear_sample_image(jnp.asarray(image[b]), jnp.asarray(coords[b]))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), rtol=0, atol=1e-6)
    p = rng.normal(5, 3, (2, 4, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(patches.normalize_patches(T(p)).numpy(),
                               np.asarray(jpatches.normalize_patches(jnp.asarray(p))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("sigma", [0.3, 1.0, 1.6, 2.45])
def test_gaussian_blur_matches_jax(sigma):
    image = np.random.default_rng(1).uniform(0, 1, (2, 30, 44)).astype(np.float32)
    got = scale_space.gaussian_blur(T(image), sigma).numpy()
    want = np.asarray(jss.gaussian_blur(jnp.asarray(image), sigma))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, [0, -1]], want[:, [0, -1]], rtol=0, atol=1e-6)  # the zero padding


def test_double_size_matches_jax_resize_including_borders():
    image = np.random.default_rng(2).uniform(0, 1, (2, 13, 17)).astype(np.float32)
    got = scale_space.double_size(T(image)).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(image), (2, 26, 34), "linear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for edge in (got[:, 0], got[:, -1], got[:, :, 0], got[:, :, -1]):
        assert np.isfinite(edge).all()
    np.testing.assert_allclose(got[:, [0, -1]], want[:, [0, -1]], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, :, [0, -1]], want[:, :, [0, -1]], rtol=0, atol=1e-6)


def test_gftt_response_matches_jax():
    image = np.random.default_rng(3).uniform(0, 1, (1, 24, 30)).astype(np.float32)
    np.testing.assert_allclose(scale_space.gftt_response(T(image)).numpy(),
                               np.asarray(jss.gftt_response(jnp.asarray(image))), rtol=0, atol=1e-6)


def _blobs():
    image = blob_image([(40.3, 41.6), (100.8, 60.2), (70.4, 99.3), (130.1, 30.7)], [3.0, 5.0, 4.0, 2.0])
    return (image + texture(image.shape, 8))[None]


# JAX against itself: jitted and eager, ``detect_keypoints`` places the
# same keypoints up to 1.8e-4 px (DoG, blobs) and 6.1e-4 px (GFTT, weak
# corners; tests/torch_tolerance_evidence.py), because the sub-pixel fit divides by a second difference of the
# responses and so magnifies their rounding, which moves with the summation
# order of the blur. The port's blur (one conv2d per axis) sums in its own
# order: its keypoints are held within KEYPOINT_PX of JAX's, not 1e-4 px.
KEYPOINT_PX = 2e-3


@pytest.mark.parametrize("case", [("dog", "blobs"), ("gftt", "corners"), ("dog", "tiny")])
def test_detect_keypoints_matches_jax(case):
    """Every row, padding included: the same mask, keypoints within
    KEYPOINT_PX, responses within 1e-5."""
    response, name = case
    image = {"blobs": _blobs, "corners": lambda: corner_image()[None],
             "tiny": lambda: np.ones((1, 20, 40), np.float32)}[name]()
    kw = dict(response=response, nms_diameter=9 if response == "dog" else 3)
    got = scale_space.detect_keypoints(T(image), 32, **kw)
    want = jax.jit(lambda im: jss.detect_keypoints(im, 32, **kw))(jnp.asarray(image))
    lafs, scores, valid = (x.numpy() for x in got)
    np.testing.assert_array_equal(valid, np.asarray(want[2]))
    np.testing.assert_allclose(lafs, np.asarray(want[0]), rtol=0, atol=KEYPOINT_PX)
    np.testing.assert_allclose(scores, np.asarray(want[1]), rtol=0, atol=1e-5)
    assert valid.sum() == (0 if name == "tiny" else 32)


def test_orientation_and_rotation_match_jax():
    """On noise, where no two histogram bins tie (on a flat region every
    gradient is float noise and the peak is a coin toss)."""
    rng = np.random.default_rng(4)
    image = rng.uniform(0, 1, (1, 128, 160)).astype(np.float32)
    lafs = random_lafs(rng, 1, 20, 128, 160)
    got = scale_space.dominant_gradient_orientation(T(image), T(lafs))
    want = np.asarray(jss.dominant_gradient_orientation(jnp.asarray(image), jnp.asarray(lafs)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    angles = rng.uniform(-np.pi, np.pi, (1, 20)).astype(np.float32)
    np.testing.assert_allclose(scale_space.rotate_lafs(T(lafs), T(angles)).numpy(),
                               np.asarray(jss.rotate_lafs(jnp.asarray(lafs), jnp.asarray(angles))), rtol=0,
                               atol=1e-5)


def test_orientation_ties_take_the_first_peak():
    """A histogram with two equal peaks: both packages take the lower bin
    (an image whose gradient is one of two directions, in equal amounts)."""
    image = np.zeros((1, 64, 64), np.float32)
    image[0, :, 32:] = 1.0  # one vertical step: gradients along +x only
    lafs = np.array([[[[8.0, 0, 32], [0, 8.0, 32]], [[8.0, 0, 31.5], [0, 8.0, 20]]]], np.float32)
    got = scale_space.dominant_gradient_orientation(T(image), T(lafs)).numpy()
    want = np.asarray(jss.dominant_gradient_orientation(jnp.asarray(image), jnp.asarray(lafs)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rootsift", [True, False])
def test_sift_descriptor_matches_jax(rootsift):
    rng = np.random.default_rng(5)
    p = rng.uniform(0, 1, (3, 4, 41, 41)).astype(np.float32)
    p[0, 0] = 0.5  # a flat patch: no gradient
    got = sift_describe_patches(T(p), rootsift=rootsift).numpy()
    want = np.asarray(jax_sift_describe(jnp.asarray(p), rootsift=rootsift))
    assert got.shape == (3, 4, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", [("noise", False), ("blobs", True)], ids=["noise", "blobs-upright"])
def test_sift_feature_matches_jax(case):
    """The whole DoG SIFT extractor: at least 99% of JAX's valid keypoints
    found within KEYPOINT_PX, their responses within 1e-5 and at least 90%
    of their descriptors within 1e-3 (a keypoint moved by 1e-4 px can move
    its descriptor past 1e-3, or change its orientation histogram's peak:
    JAX jitted and eager disagree past 1e-3 on 5 of the noise image's 64
    keypoints; tests/torch_tolerance_evidence.py)."""
    name, upright = case
    image = np.random.default_rng(6).uniform(0, 1, (1, 64, 96)).astype(np.float32) if name == "noise" else _blobs()
    params = dict(max_keypoints=64, upright=upright)
    with torch.no_grad():
        got = SIFTFeature(**params)(T(image))
    want = jax.tree_util.tree_map(np.asarray, jax.jit(JaxSIFT(**params))(jnp.asarray(image)))
    gk, wk = got.lafs.numpy()[0, :, :, 2], want.lafs[0, :, :, 2]
    gm, wm = got.mask.numpy()[0], want.mask[0]
    dist = np.linalg.norm(wk[:, None] - gk[None], axis=-1) + np.where(gm, 0, np.inf)[None]
    nearest = dist.argmin(1)
    shared = wm & (dist.min(1) <= KEYPOINT_PX)
    assert shared.sum() >= 0.99 * wm.sum() and wm.sum() >= 32
    err = np.abs(got.descriptors.numpy()[0, nearest[shared]] - want.descriptors[0, shared]).max(-1)
    assert (err <= 1e-3).mean() >= 0.9, np.sort(err)[-8:]
    np.testing.assert_allclose(got.responses.numpy()[0, nearest[shared]], want.responses[0, shared],
                               rtol=0, atol=1e-5)

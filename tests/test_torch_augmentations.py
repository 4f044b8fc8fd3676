"""The port's device augmentations against the JAX package's on the CPU. The
port splits each augmentation into a draw and an apply; JAX's draws, made
here with ``jax.random`` from the JAX functions' own keys, go through the
port's apply. Equalize and solarize are exact; sharpness (a 3x3 convolution
that sums in another order) and noise within 1e-6. Also the port's own
draws (deterministic per generator seed, in [0, 1]) and the registry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglue_tpu import augmentations as jaug
from openglue_tpu_torch import augmentations as aug

B, H, W = 4, 32, 40


def _images(seed=0):
    """Uniform pixels, one flat image (a single histogram bin) and a row at
    the solarize threshold exactly."""
    images = np.random.default_rng(seed).uniform(0, 1, (B, H, W)).astype(np.float32)
    images[1] = 0.3
    images[2, 5] = 0.5
    return images


def _jax_masks(key, p):
    return np.array(jax.random.uniform(key, (B,)) < p)


@pytest.fixture(scope="module")
def images():
    return _images()


def test_equalize_is_jax_exactly(images):
    key = jax.random.key(3)
    want = np.asarray(jaug.random_equalize(key, jnp.asarray(images), p=0.6))
    got = aug.equalize(torch.from_numpy(images), torch.from_numpy(_jax_masks(key, 0.6)))
    np.testing.assert_array_equal(got.numpy(), want)
    everything = np.asarray(jaug.random_equalize(key, jnp.asarray(images), p=1.0))
    np.testing.assert_array_equal(aug.equalize(torch.from_numpy(images), torch.ones(B, dtype=torch.bool)).numpy(),
                                  everything)
    assert not np.array_equal(everything, images)


def test_sharpness_matches_jax(images):
    key = jax.random.key(4)
    want = np.asarray(jaug.random_sharpness(key, jnp.asarray(images), p=0.6))
    k_apply, k_factor = jax.random.split(key)
    factor = np.array(jax.random.uniform(k_factor, (B,), minval=0.0, maxval=0.5))
    got = aug.sharpen(torch.from_numpy(images), torch.from_numpy(_jax_masks(k_apply, 0.6)), torch.from_numpy(factor))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the border keeps the original pixels
    np.testing.assert_array_equal(got.numpy()[:, 0], images[:, 0])


def test_solarize_is_jax_exactly(images):
    key = jax.random.key(5)
    want = np.asarray(jaug.random_solarize(key, jnp.asarray(images), p=0.6))
    got = aug.solarize(torch.from_numpy(images), torch.from_numpy(_jax_masks(key, 0.6)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_noise_matches_jax(images):
    key = jax.random.key(6)
    want = np.asarray(jaug.gaussian_noise(key, jnp.asarray(images), p=0.6))
    k_apply, k_noise = jax.random.split(key)
    noise = np.array(jax.random.normal(k_noise, images.shape))
    got = aug.add_noise(torch.from_numpy(images), torch.from_numpy(_jax_masks(k_apply, 0.6)), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weak_color_aug_matches_jax_with_its_draws(images, seed):
    key = jax.random.key(seed)
    want = np.asarray(jax.jit(jaug.weak_color_aug)(key, jnp.asarray(images)))
    k1, k2, k3, k4 = jax.random.split(key, 4)
    k2_apply, k2_factor = jax.random.split(k2)
    k4_apply, k4_noise = jax.random.split(k4)
    t = torch.from_numpy
    draws = {
        "equalize": t(_jax_masks(k1, 0.25)),
        "sharpen": t(_jax_masks(k2_apply, 0.25)),
        "sharpness": t(np.array(jax.random.uniform(k2_factor, (B,), minval=0.0, maxval=0.5))),
        "solarize": t(_jax_masks(k3, 0.25)),
        "noisy": t(_jax_masks(k4_apply, 0.5)),
        "noise": t(np.array(jax.random.normal(k4_noise, images.shape))),
    }
    got = aug.apply_weak_color_aug(t(images), draws)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_port_draws_are_seeded_and_bounded(images):
    x = torch.from_numpy(images)
    first = aug.weak_color_aug(torch.Generator().manual_seed(0), x)
    again = aug.weak_color_aug(torch.Generator().manual_seed(0), x)
    other = aug.weak_color_aug(torch.Generator().manual_seed(1), x)
    assert first.shape == x.shape and torch.equal(first, again) and not torch.equal(first, other)
    assert first.min() >= 0.0 and first.max() <= 1.0
    draws = aug.draw_weak_color_aug(torch.Generator().manual_seed(0), x)
    assert torch.equal(aug.apply_weak_color_aug(x, draws), first)
    assert draws["sharpness"].min() >= 0.0 and draws["sharpness"].max() < 0.5


def test_registry():
    x = torch.full((2, 8, 8), 0.3)
    assert torch.equal(aug.get_augmentation_transform("none")(torch.Generator(), x), x)
    assert aug.get_augmentation_transform("weak_color_aug") is aug.weak_color_aug
    assert sorted(aug.AUGMENTATIONS) == sorted(jaug.AUGMENTATIONS)
    with pytest.raises(ValueError, match="Unknown augmentation 'bogus'"):
        aug.get_augmentation_transform("bogus")

"""The readings behind the device extractors' CPU test tolerances and
``features/agreement.py``'s bars, on the CPU (not collected by pytest):

    JAX_PLATFORMS=cpu python -m tests.torch_tolerance_evidence

1. JAX against itself: ``detect_keypoints`` jitted and eager on
   tests/test_torch_scale_space.py's blob and corner images (the refined
   keypoints' spread, beside the port's distance from each);
2. the whole DoG SIFT, jitted and eager JAX on that file's noise image
   (descriptors past 1e-3);
3. the port's SIFT descriptor on chip_smoke.py's first serving image at the
   960x720 target, its keypoints moved by 1e-4 px (descriptors past 1e-3 on
   textured patches, and the nearest-neighbour identification).

About 2.5 minutes (eager JAX)."""

import tempfile
from pathlib import Path

import tests.conftest  # noqa: F401  (JAX on the CPU with f32 matmuls, as the tests run it)

import jax
import jax.numpy as jnp
import numpy as np
import torch

from openglue_tpu.features import scale_space as jss
from openglue_tpu.features.sift import SIFTFeature as JaxSIFT
from openglue_tpu_torch.cli.extract_features import extract_on_device
from openglue_tpu_torch.data import io
from openglue_tpu_torch.data.fixture import generate_image_fixture
from openglue_tpu_torch.features import agreement
from openglue_tpu_torch.features import scale_space
from openglue_tpu_torch.features.patches import extract_laf_patches
from openglue_tpu_torch.features.sift import SIFTFeature, sift_describe_patches
from tests.test_torch_scale_space import _blobs, corner_image


def detector_spread():
    for response, image in (("dog", _blobs()), ("gftt", corner_image()[None])):
        kw = dict(response=response, nms_diameter=9 if response == "dog" else 3)
        jit = np.asarray(jax.jit(lambda im: jss.detect_keypoints(im, 32, **kw))(jnp.asarray(image))[0])
        eager = np.asarray(jss.detect_keypoints(jnp.asarray(image), 32, **kw)[0])
        port = scale_space.detect_keypoints(torch.from_numpy(image), 32, **kw)[0].numpy()
        px = lambda a, b: float(np.abs(a[..., 2] - b[..., 2]).max())
        print(f"detect_keypoints {response}: JAX jitted vs eager {px(jit, eager):.3e} px; port vs jitted "
              f"{px(port, jit):.3e}, vs eager {px(port, eager):.3e}")


def sift_spread():
    image = np.random.default_rng(6).uniform(0, 1, (1, 64, 96)).astype(np.float32)
    params = dict(max_keypoints=64)
    jit = jax.jit(JaxSIFT(**params))(jnp.asarray(image))
    eager = JaxSIFT(**params)(jnp.asarray(image))
    err = np.abs(np.asarray(jit.descriptors) - np.asarray(eager.descriptors)).max(-1)[0]
    print(f"DoG SIFT, JAX jitted vs eager on the noise image: {(err > 1e-3).sum()} of {err.size} descriptors past "
          f"1e-3 (max {err.max():.3e})")


def sift_shift():
    with tempfile.TemporaryDirectory() as tmp:
        generate_image_fixture(Path(tmp), num_images=1, image_size=(1280, 1024), seed=0)
        image = io.aspect_preserving_resize(io.read_grayscale(Path(tmp) / "img0000.jpg"), (960, 720))
    lafs, _, _, mask = extract_on_device(SIFTFeature(max_keypoints=1024, nms_diameter=9), image, "cpu")
    lafs = lafs[mask]
    textured = agreement.textured(image, lafs, 41)
    img = torch.from_numpy(image.astype(np.float32) / 255.0)[None]
    moved = lafs.copy()
    moved[:, 0, 2] += 1e-4
    a, b = (sift_describe_patches(extract_laf_patches(img, torch.from_numpy(x)[None], 41))[0].numpy()
            for x in (lafs, moved))
    err = np.abs(a - b).max(-1)[textured]
    n = len(lafs)
    ones = np.ones(n, bool)
    readings = agreement.agreement((moved, np.ones(n, np.float32), b, ones), (lafs, np.ones(n, np.float32), a, ones),
                                   held=textured)
    print(f"DoG SIFT on the serving image ({image.shape[1]}x{image.shape[0]}), keypoints moved 1e-4 px: "
          f"{textured.sum()} of {n} on textured patches, {(err <= 1e-3).mean():.3f} of those within 1e-3 "
          f"(max {err.max():.3e}), identified {readings['identified']:.3f}")


if __name__ == "__main__":
    detector_spread()
    sift_spread()
    sift_shift()

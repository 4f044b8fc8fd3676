"""The port's patch networks (HardNet, AffNet, OriNet) and the two
extractors built on them (GFTT-AffNet-HardNet on the device, DoG(OpenCV)-
AffNet-HardNet) against the JAX package's on the CPU in f32, with the JAX
weights carried over by ``compat.jax_weights``; and the other direction:
the JAX package's kornia converters (``hardnet_params_from_torch``,
``affnet_params_from_torch``) read the port's ``state_dict()``.

JAX's NMS runs its scipy path (see tests/test_torch_features.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglue_tpu import native as jax_native
from openglue_tpu.features import affnet as jaff
from openglue_tpu.features import hardnet as jhn
from openglue_tpu.features.dog_affnet_hardnet import DoGAffNetHardNet as JaxDoGAffNetHardNet
from openglue_tpu.features.gftt_hardnet import GFTTAffNetHardNet as JaxGFTT
from openglue_tpu.features.gftt_hardnet import GFTTAffNetHardNetConfig as JaxGFTTConfig
from openglue_tpu_torch.compat import jax_weights
from openglue_tpu_torch.features.affnet import AffNet, OriNet
from openglue_tpu_torch.features.dog_affnet_hardnet import DoGAffNetHardNet
from openglue_tpu_torch.features.gftt_hardnet import GFTTAffNetHardNet, GFTTAffNetHardNetConfig
from openglue_tpu_torch.features.hardnet import HardNet
from openglue_tpu_torch.features.nets import seeded_init_
from tests.test_torch_scale_space import KEYPOINT_PX, corner_image

PATCHES = np.random.default_rng(0).normal(0, 1, (6, 32, 32, 1)).astype(np.float32)


@pytest.fixture(autouse=True)
def jax_nms_on_its_scipy_path(monkeypatch):
    monkeypatch.setattr(jax_native, "nms_keypoints_native", lambda *args, **kwargs: None)


def with_statistics(variables, seed):
    """JAX variables whose BatchNorm statistics are drawn from ``seed``
    (the affine-free BatchNorms are otherwise identities)."""
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(np.asarray, variables)

    def draw(node):
        for key, value in node.items():
            if "mean" in value:
                c = value["mean"].shape[0]
                node[key] = {"mean": rng.normal(0, 0.1, c).astype(np.float32),
                             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
            else:
                draw(value)

    draw(variables["batch_stats"])
    return variables


NETS = {
    "hardnet": (jhn.HardNet, HardNet, jax_weights.hardnet_state_dict_from_jax, jhn.hardnet_params_from_torch),
    "affnet": (jaff.AffNet, AffNet, jax_weights.affnet_state_dict_from_jax, jaff.affnet_params_from_torch),
    "orinet": (jaff.OriNet, OriNet, jax_weights.orinet_state_dict_from_jax, jaff.orinet_params_from_torch),
}


@pytest.mark.parametrize("name", list(NETS))
def test_patch_network_matches_jax(name):
    jax_cls, port_cls, carry, _ = NETS[name]
    model = jax_cls()
    variables = with_statistics(model.init(jax.random.key(1), jnp.asarray(PATCHES)), seed=2)
    port = port_cls().eval()
    port.load_state_dict(carry(variables))
    want = np.asarray(model.apply(variables, jnp.asarray(PATCHES)))
    with torch.no_grad():
        got = port(torch.from_numpy(PATCHES[..., 0])).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(NETS))
def test_jax_kornia_converters_read_the_port_state_dict(name):
    """A seeded port network's ``state_dict()`` through the JAX package's
    converter gives JAX the same network."""
    jax_cls, port_cls, _, convert = NETS[name]
    port = seeded_init_(port_cls(), torch.Generator().manual_seed(3)).eval()
    for m in port.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.1, generator=torch.Generator().manual_seed(4))
    variables = convert(port.state_dict())
    want = np.asarray(jax_cls().apply(variables, jnp.asarray(PATCHES)))
    with torch.no_grad():
        got = port(torch.from_numpy(PATCHES[..., 0])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _shared_rows(got_lafs, got_mask, want_lafs, want_mask):
    """(JAX's valid rows the port finds within KEYPOINT_PX, the port's row
    for each)."""
    dist = np.linalg.norm(want_lafs[:, None, :, 2] - got_lafs[None, :, :, 2], axis=-1)
    dist = dist + np.where(got_mask, 0, np.inf)[None]
    shared = want_mask & (dist.min(1) <= KEYPOINT_PX)
    return shared, dist.argmin(1)


@pytest.mark.parametrize("use_affnet", [True, False])
def test_gftt_affnet_hardnet_matches_jax(use_affnet):
    """End to end on the textured corner image: at least 99% of JAX's
    keypoints within KEYPOINT_PX, their LAF shapes A A^T (rotation-free)
    within 1e-2 relative, at least 90% of their descriptors within 1e-3.
    The keypoints' sub-pixel positions carry the rounding of the blur's
    summation order (see tests/test_torch_scale_space.py): AffNet sees a
    patch moved by up to KEYPOINT_PX (the shapes differ by up to 9e-4
    relative), and a position moved by 1e-4 px can change the dominant
    orientation's peak bin, which turns a LAF and its descriptor."""
    params = dict(max_keypoints=32, use_affnet=use_affnet)
    image = corner_image()[None]
    model = JaxGFTT(JaxGFTTConfig(**params))
    variables = with_statistics(jax.jit(model.init)(jax.random.key(5), jnp.asarray(image)), seed=6)
    port = GFTTAffNetHardNet(GFTTAffNetHardNetConfig(**params)).eval()
    port.load_state_dict(jax_weights.gftt_affnet_hardnet_state_dict_from_jax(variables))
    want = jax.tree_util.tree_map(np.asarray, jax.jit(model.apply)(variables, jnp.asarray(image)))
    with torch.no_grad():
        got = port(torch.from_numpy(image))
    shared, nearest = _shared_rows(got.lafs.numpy()[0], got.mask.numpy()[0], want.lafs[0], want.mask[0])
    assert shared.sum() >= 0.99 * want.mask.sum() and want.mask.sum() >= 16
    i, j = nearest[shared], np.flatnonzero(shared)
    shape = lambda lafs: lafs[..., :2, :2] @ np.swapaxes(lafs[..., :2, :2], -1, -2)
    np.testing.assert_allclose(shape(got.lafs.numpy()[0, i]), shape(want.lafs[0, j]), rtol=1e-2, atol=1e-4)
    err = np.abs(got.descriptors.numpy()[0, i] - want.descriptors[0, j]).max(-1)
    assert (err <= 1e-3).mean() >= 0.9, np.sort(err)[-5:]


def test_dog_affnet_hardnet_matches_jax():
    """The same OpenCV detections, then AffNet, OriNet and HardNet on the
    port's device (the CPU here) with JAX's weights: on every valid row, LAFs
    within 1e-4 relative (OriNet's angle is an atan2 of two small outputs)
    and descriptors within 1e-4 (three networks in a chain: AffNet's shape
    and OriNet's angle move HardNet's patch)."""
    image = (corner_image() * 180 + np.random.default_rng(9).uniform(0, 60, (96, 96))).astype(np.uint8)
    ref = JaxDoGAffNetHardNet(max_keypoints=64, seed=2)
    ref.load_weights(*(with_statistics(v, seed) for seed, v in
                       enumerate((ref.affnet_vars, ref.orinet_vars, ref.hardnet_vars))))
    port = DoGAffNetHardNet(max_keypoints=64, seed=11, device="cpu")
    port.load_weights(jax_weights.affnet_state_dict_from_jax(ref.affnet_vars),
                      jax_weights.orinet_state_dict_from_jax(ref.orinet_vars),
                      jax_weights.hardnet_state_dict_from_jax(ref.hardnet_vars))
    want = ref.detect_and_compute(image)
    got = port.detect_and_compute(image)
    assert got[3].sum() == want[3].sum() >= 16
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[3], want[3])
    valid = want[3]  # a padding row's LAF is zero: its patch is flat, and normalizing it divides by eps
    np.testing.assert_allclose(got[0][valid], want[0][valid], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[2][valid], want[2][valid], rtol=0, atol=1e-4)

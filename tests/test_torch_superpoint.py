"""The port's SuperPoint against the JAX package's on the CPU in f32: the
backbone's maps, the pipeline pieces (depth to space, NMS, selection,
descriptor sampling), the whole extractor plain and with BatchNorms on
structured and noise images, and the weights in both directions (the port's
``state_dict()`` through JAX's torch loader, a third-party
``model_state_dict`` checkpoint through both loaders).

Every network's weights are JAX's initialization carried over by
``compat.jax_weights``; the BatchNorm statistics and affine parameters are
drawn from a seed so that the BN variant is not an identity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglue_tpu.cli.extract_features import build_device_extractor as jax_build_device_extractor
from openglue_tpu.features import superpoint as jsp
from openglue_tpu_torch.compat.jax_weights import superpoint_state_dict_from_jax
from openglue_tpu_torch.features import superpoint as sp
from openglue_tpu_torch.features.nets import seeded_init_

H, W = 64, 96
PARAMS = dict(max_keypoints=48, descriptor_dim=64, nms_kernel=5, remove_borders_size=4, keypoint_threshold=0.005)


def noise_image(seed=0, size=(H, W)):
    return np.random.default_rng(seed).uniform(0, 1, (1, *size)).astype(np.float32)


def structured_image(size=(H, W)):
    """Gaussian blobs and a bright rectangle on a dark ramp (few NMS maxima
    clear the threshold, so the padding rows are part of the output)."""
    h, w = size
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 0.1 * xs / w
    for (cx, cy), s in (((20, 18), 3.0), ((70, 40), 5.0), ((45, 50), 2.5)):
        img = img + np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * s * s))
    img[10:30, 50:80] += 0.6
    return (img / img.max())[None].astype(np.float32)


def _perturbed(variables, seed):
    """JAX variables with every BatchNorm's scale, bias, mean and variance
    drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    for name, stats in variables.get("batch_stats", {}).get("backbone", {}).items():
        c = stats["mean"].shape[0]
        stats["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        stats["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        variables["params"]["backbone"][name] = {"scale": rng.uniform(0.8, 1.2, c).astype(np.float32),
                                                 "bias": rng.normal(0, 0.1, c).astype(np.float32)}
    return variables


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "bn"])
def models(request):
    """(JAX module, its variables, the port's module with the same weights)."""
    bn = request.param
    model = jsp.SuperPoint(jsp.SuperPointConfig(bn=bn, **PARAMS))
    variables = _perturbed(model.init(jax.random.key(3), jnp.zeros((1, H, W, 1))), seed=5)
    port = sp.SuperPoint(sp.SuperPointConfig(bn=bn, **PARAMS)).eval()
    port.load_state_dict(superpoint_state_dict_from_jax(variables))
    return model, variables, port


def _jax_features(model, variables, image):
    return jax.tree_util.tree_map(np.asarray, model.apply(variables, jnp.asarray(image[..., None])))


def _port_features(port, image):
    with torch.no_grad():
        return port(torch.from_numpy(image))


def test_backbone_maps_match_jax(models):
    model, variables, port = models
    image = noise_image(1)
    backbone = jsp.SuperPointBackbone(descriptor_dim=PARAMS["descriptor_dim"], bn=model.config.bn)
    sub = {k: v["backbone"] for k, v in variables.items()}
    desc, scores = backbone.apply(sub, jnp.asarray(image[..., None]))
    with torch.no_grad():
        pdesc, pscores = port.maps(torch.from_numpy(image[:, None]))
    assert pdesc.shape == (1, PARAMS["descriptor_dim"], H // 8, W // 8) and pscores.shape == (1, 64, H // 8, W // 8)
    np.testing.assert_allclose(pdesc.permute(0, 2, 3, 1).numpy(), np.asarray(desc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pscores.permute(0, 2, 3, 1).numpy(), np.asarray(scores), rtol=0, atol=1e-5)


def test_depth_to_space_and_nms_match_jax():
    rng = np.random.default_rng(2)
    cells = rng.uniform(size=(2, 5, 6, 64)).astype(np.float32)
    heat = sp.depth_to_space_scores(torch.from_numpy(cells).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(heat.numpy(), np.asarray(jsp.depth_to_space_scores(jnp.asarray(cells))))
    # plateaus of equal scores keep every tied maximum in both
    scores = np.round(rng.uniform(0, 1, (2, 40, 48)), 1).astype(np.float32)
    for k in (3, 5, 9):
        got = sp.nms2d(torch.from_numpy(scores), k).numpy()
        np.testing.assert_array_equal(got, np.asarray(jsp.nms2d(jnp.asarray(scores), k)))


@pytest.mark.parametrize("k", [5, 40])
def test_select_keypoints_matches_jax_with_ties_and_padding(k):
    """Ties and zero-score padding rows come in JAX's top-k order (the lower
    pixel index first)."""
    scores = np.zeros((2, 32, 40), np.float32)
    scores[0, 10, 10] = scores[0, 12, 30] = scores[0, 20, 5] = 0.5  # equal scores
    scores[0, 2, 2] = 0.9  # inside the border
    scores[1, 8:24:4, 8:32:6] = np.linspace(0.001, 0.02, 16).reshape(4, 4)
    got = sp.select_keypoints(torch.from_numpy(scores), k, threshold=0.005, border=4)
    want = jsp.select_keypoints(jnp.asarray(scores), k, threshold=0.005, border=4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sample_descriptors_matches_jax():
    rng = np.random.default_rng(3)
    desc_map = rng.normal(size=(2, 8, 12, 32)).astype(np.float32)
    kpts = rng.uniform(-2, 100, (2, 30, 2)).astype(np.float32)  # some taps clamp at the border
    kpts[:, :4] = np.round(kpts[:, :4])
    got = sp.sample_descriptors(torch.from_numpy(desc_map).permute(0, 3, 1, 2), torch.from_numpy(kpts))
    want = jsp.sample_descriptors(jnp.asarray(desc_map), jnp.asarray(kpts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    lafs = sp.keypoints_to_lafs(torch.from_numpy(kpts))
    np.testing.assert_array_equal(lafs.numpy(), np.asarray(jsp.keypoints_to_lafs(jnp.asarray(kpts))))


def test_superpoint_matches_jax_on_a_structured_image(models):
    """Identical keypoints, responses and mask, padding rows included: at
    1024 keypoints the NMS maxima run out and zero-score rows fill the rest."""
    model, variables, port = models
    config = dict(PARAMS, max_keypoints=1024, bn=model.config.bn)
    model = jsp.SuperPoint(jsp.SuperPointConfig(**config))
    wide = sp.SuperPoint(sp.SuperPointConfig(**config)).eval()
    wide.load_state_dict(port.state_dict())
    image = structured_image()
    got, want = _port_features(wide, image), _jax_features(model, variables, image)
    assert 20 < want.mask.sum() and (want.responses == 0).sum() > 100  # the output has padding rows
    np.testing.assert_array_equal(got.lafs.numpy(), want.lafs)
    np.testing.assert_array_equal(got.mask.numpy(), want.mask)
    np.testing.assert_allclose(got.responses.numpy(), want.responses, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.descriptors.numpy(), want.descriptors, rtol=0, atol=1e-5)


def _shared(got, want):
    """The share of JAX's valid keypoints that the port finds too, and the
    index pairs of the shared ones."""
    gk, wk = got.lafs.numpy()[0, :, :, 2], want.lafs[0, :, :, 2]
    gm, wm = got.mask.numpy()[0], want.mask[0]
    pairs = [(int(np.flatnonzero(gm & (gk == p).all(1))[0]), j) for j, p in enumerate(wk)
             if wm[j] and (gm & (gk == p).all(1)).any()]
    return len(pairs) / wm.sum(), pairs


def test_superpoint_matches_jax_on_noise(models):
    model, variables, port = models
    for seed in (0, 1):
        image = noise_image(seed)
        got, want = _port_features(port, image), _jax_features(model, variables, image)
        share, pairs = _shared(got, want)
        assert share >= 0.99 and want.mask.sum() >= 20
        i, j = np.array(pairs).T
        np.testing.assert_allclose(got.descriptors.numpy()[0, i], want.descriptors[0, j], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.responses.numpy()[0, i], want.responses[0, j], rtol=0, atol=1e-6)


def _features_config(bn, weights):
    return {"name": "SuperPointNetBn" if bn else "SuperPointNet", "descriptor_dim": PARAMS["descriptor_dim"],
            "parameters": dict(PARAMS), "weights": str(weights)}


@pytest.mark.parametrize("bn", [False, True], ids=["plain", "bn"])
def test_port_weights_load_in_jax_and_in_the_port(bn, tmp_path):
    """A seeded port SuperPoint saved with ``torch.save``: JAX's
    ``build_device_extractor`` (torch checkpoint -> flax) and the port's
    ``build_device_extractor`` load it, and both extract the same features
    (at PyTorch's default initialization the scores are flatter than at
    JAX's, and near-equal scores 1e-8 apart swap ranks with the summation
    order: held by the shared share, as on noise)."""
    from openglue_tpu_torch.cli.extract_features import build_device_extractor

    port = seeded_init_(sp.SuperPoint(sp.SuperPointConfig(bn=bn, **PARAMS)), torch.Generator().manual_seed(4))
    if bn:  # non-trivial statistics
        for m in port.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(6))
    torch.save(port.state_dict(), tmp_path / "sp.pth")
    cfg = _features_config(bn, tmp_path / "sp.pth")
    variables, apply = jax_build_device_extractor(cfg, cfg["weights"])
    loaded = build_device_extractor(cfg, cfg["weights"], "cpu")
    assert all(torch.equal(v, port.state_dict()[k]) for k, v in loaded.state_dict().items())
    image = noise_image(3)
    want = jax.tree_util.tree_map(np.asarray, apply(variables, jnp.asarray(image[..., None])))
    got = _port_features(loaded, image)
    share, pairs = _shared(got, want)
    assert share >= 0.99
    i, j = np.array(pairs).T
    np.testing.assert_allclose(got.descriptors.numpy()[0, i], want.descriptors[0, j], rtol=0, atol=1e-5)


def test_thirdparty_checkpoint_loads_in_both(tmp_path):
    """The pytorch-superpoint layout (``model_state_dict`` with
    ``inc.conv.conv.0`` ... keys) loads through the port's loader as through
    JAX's converter."""
    from openglue_tpu_torch.cli.extract_features import build_device_extractor

    port = seeded_init_(sp.SuperPoint(sp.SuperPointConfig(bn=True, **PARAMS)), torch.Generator().manual_seed(8))
    inverse = {v: k for k, v in _thirdparty_mapping().items()}
    state = {}
    for key, value in port.state_dict().items():
        layer, rest = key.split(".", 1)
        state[f"{inverse.get(layer, layer)}.{rest}"] = value
    assert "inc.conv.conv.0.weight" in state and "down3.mpconv.1.conv.4.running_var" in state
    torch.save({"model_state_dict": state, "epoch": 3}, tmp_path / "third.pth.tar")
    cfg = _features_config(True, tmp_path / "third.pth.tar")
    loaded = build_device_extractor(cfg, cfg["weights"], "cpu")
    assert all(torch.equal(v, port.state_dict()[k]) for k, v in loaded.state_dict().items())
    variables, apply = jax_build_device_extractor(cfg, cfg["weights"])
    image = noise_image(2)
    want = jax.tree_util.tree_map(np.asarray, apply(variables, jnp.asarray(image[..., None])))
    share, _ = _shared(_port_features(loaded, image), want)
    assert share >= 0.99


def _thirdparty_mapping():
    return {f"{block}.{i}": f"{kind}{n + 1}{ab}"
            for n, block in enumerate(["inc.conv.conv", "down1.mpconv.1.conv", "down2.mpconv.1.conv",
                                       "down3.mpconv.1.conv"])
            for i, kind, ab in ((0, "conv", "a"), (1, "bn", "a"), (3, "conv", "b"), (4, "bn", "b"))}


def test_rename_thirdparty_keys_matches_jax():
    from openglue_tpu.compat.torch_weights import rename_thirdparty_superpoint_keys as jax_rename

    keys = {f"{old}.weight": i for i, old in enumerate(_thirdparty_mapping())}
    keys.update({"convPa.bias": -1, "bnDb.running_mean": -2})
    assert sp.rename_thirdparty_superpoint_keys(keys) == jax_rename(keys)

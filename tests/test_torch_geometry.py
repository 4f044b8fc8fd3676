"""The port's training inputs against the JAX package on the CPU: GT match
generation for both transformation kinds and both parity modes, the
transforms it rests on, the losses, and the synthetic pair generators."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglue_tpu import losses as jax_losses
from openglue_tpu.core.types import Transformation as JaxTransformation
from openglue_tpu.data.synthetic import SyntheticHomographyPairs as JaxHomographyPairs
from openglue_tpu.data.synthetic import SyntheticReprojectionPairs as JaxReprojectionPairs
from openglue_tpu.geometry import gt_matches as jax_gt
from openglue_tpu.geometry import transforms as jax_transforms
from openglue_tpu_torch import losses
from openglue_tpu_torch.core.types import Transformation
from openglue_tpu_torch.data.synthetic import SyntheticHomographyPairs, SyntheticReprojectionPairs
from openglue_tpu_torch.geometry import gt_matches, transforms

FIELDS = ("H", "K0", "K1", "R", "T", "depth0", "depth1")


def _pair(kind, seed, n=96):
    """A JAX-generated pair as numpy arrays, with ragged masks and, for the 3D
    kind, a few keypoints of unknown (zero) depth."""
    gen = (JaxHomographyPairs if kind == "perspective" else JaxReprojectionPairs)(
        num_keypoints=n, descriptor_dim=8
    )
    batch = gen.sample(jax.random.key(seed), 2)
    t = {f: np.array(getattr(batch.transformation, f)) for f in FIELDS
         if getattr(batch.transformation, f) is not None}
    if kind == "3d_reprojection":
        t["depth0"][:, :4] = 0.0
        t["depth1"][:, 10:13] = 0.0
    kpts0, kpts1 = np.array(batch.side0.keypoints), np.array(batch.side1.keypoints)
    mask0 = np.arange(n)[None] < np.asarray([n, n - 20])[:, None]
    mask1 = np.arange(n)[None] < np.asarray([n - 9, n])[:, None]
    return kpts0, kpts1, t, mask0, mask1


def _thresholds_are_clear(kpts0, kpts1, t, mask0, mask1, thresholds, margin=1e-2):
    """True when no valid keypoint's nearest-neighbour or symmetric distance
    lies within ``margin`` px of a threshold, so that f32 rounding cannot
    flip a label between two exact implementations."""
    tr = Transformation(t.pop("kind"), **{k: torch.from_numpy(v) for k, v in t.items()})
    k0, k1 = torch.from_numpy(kpts0), torch.from_numpy(kpts1)
    p0, _ = transforms.reproject_keypoints(k0, tr)
    p1, _ = transforms.reproject_keypoints(k1, tr.inverse())
    d0 = torch.where(torch.from_numpy(mask1)[:, None], transforms.cdist_sq(p0, k1), float("inf"))
    d1 = torch.where(torch.from_numpy(mask0)[:, None], transforms.cdist_sq(p1, k0), float("inf"))
    m0, m1 = d0.amin(2).sqrt(), d1.amin(2).sqrt()
    sym = 0.5 * (m0 + torch.gather(m1, 1, d0.argmin(2)))
    valid0 = torch.from_numpy(mask0)
    dists = torch.cat([m0[valid0], m1[torch.from_numpy(mask1)], sym[valid0]])
    return all(((dists - thr).abs() > margin).all() for thr in thresholds)


@pytest.mark.parametrize("parity_mode", [False, True])
@pytest.mark.parametrize("kind,seed", [("perspective", 1), ("3d_reprojection", 8)])
def test_gt_matches_equal_jax(kind, seed, parity_mode):
    kpts0, kpts1, t, mask0, mask1 = _pair(kind, seed)
    # these seeds keep every distance more than 0.01 px off the thresholds
    # (about a third of the seeds do; the rest put a distance within reach of
    # the f32 rounding differences of the two frameworks)
    assert _thresholds_are_clear(kpts0, kpts1, dict(t, kind=kind), mask0, mask1, (2.0, 7.0))
    ref = jax_gt.generate_gt_matches(
        jnp.asarray(kpts0), jnp.asarray(kpts1),
        JaxTransformation(kind=kind, **{k: jnp.asarray(v) for k, v in t.items()}),
        positive_threshold=2.0, negative_threshold=7.0,
        mask0=jnp.asarray(mask0), mask1=jnp.asarray(mask1), parity_mode=parity_mode,
    )
    out = gt_matches.generate_gt_matches(
        torch.from_numpy(kpts0), torch.from_numpy(kpts1),
        Transformation(kind, **{k: torch.from_numpy(v) for k, v in t.items()}),
        positive_threshold=2.0, negative_threshold=7.0,
        mask0=torch.from_numpy(mask0), mask1=torch.from_numpy(mask1), parity_mode=parity_mode,
    )
    for key in ("gt_matches0", "gt_matches1"):
        assert out[key].dtype == torch.int32
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))
    labels = out["gt_matches0"].numpy()
    assert (labels >= 0).sum() > 20 and (labels == -2).any()
    if not parity_mode:
        assert (labels == -1).any()


def test_reprojection_and_inverse_match_jax():
    kpts0, _, t, _, _ = _pair("3d_reprojection", 1)
    depth_map = np.random.default_rng(0).uniform(1, 5, (2, 40, 50)).astype(np.float32)
    t["depth0"] = depth_map  # the dense-map form, gathered at the keypoints
    kp = kpts0 / 20.0  # inside the map, plus one keypoint beyond it
    kp[0, 0] = [80.0, -3.0]
    jt = JaxTransformation(kind="3d_reprojection", **{k: jnp.asarray(v) for k, v in t.items()})
    tt = Transformation("3d_reprojection", **{k: torch.from_numpy(v) for k, v in t.items()})
    for jtr, ttr in ((jt, tt), (jt.inverse(), tt.inverse())):
        ref, ref_valid = jax_transforms.reproject_keypoints(jnp.asarray(kp), jtr)
        out, valid = transforms.reproject_keypoints(torch.from_numpy(kp), ttr)
        # exact f32 coordinate math on both sides: a few ulps of ~1000 px
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    K = torch.from_numpy(t["K0"])
    np.testing.assert_allclose(
        transforms.normalize_with_intrinsics(torch.from_numpy(kp), K).numpy(),
        np.asarray(jax_transforms.normalize_with_intrinsics(jnp.asarray(kp), jnp.asarray(t["K0"]))),
        rtol=1e-6,
    )


def _loss_inputs(seed, batch=2, n=40, m=33, dim=16):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((batch, n + 1, m + 1)).astype(np.float32)
    scores = logits - np.log(np.exp(logits).sum(axis=2, keepdims=True))
    gt0 = rng.integers(-2, m, (batch, n)).astype(np.int32)
    gt1 = rng.integers(-2, n, (batch, m)).astype(np.int32)
    gt0[1, :] = -2  # an element with nothing matched
    desc0 = rng.standard_normal((batch, n, dim)).astype(np.float32)
    desc1 = rng.standard_normal((batch, m, dim)).astype(np.float32)
    mask0 = np.arange(n)[None] < np.asarray([n, 30])[:, None]
    mask1 = np.arange(m)[None] < np.asarray([25, m])[:, None]
    return scores, gt0, gt1, desc0, desc1, mask0, mask1


@pytest.mark.parametrize("margin", [None, 0.3])
def test_criterion_matches_jax(margin):
    scores, gt0, gt1, desc0, desc1, mask0, mask1 = _loss_inputs(5)

    def jax_total(s, d0, d1):
        out = jax_losses.criterion(
            {"gt_matches0": jnp.asarray(gt0), "gt_matches1": jnp.asarray(gt1)},
            {"scores": s, "context_descriptors0": d0, "context_descriptors1": d1},
            margin=margin, mask0=jnp.asarray(mask0), mask1=jnp.asarray(mask1),
        )
        return out["loss"] + out["metric_loss"], out

    (_, ref), ref_grads = jax.value_and_grad(jax_total, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(scores), jnp.asarray(desc0), jnp.asarray(desc1)
    )
    ts, t0, t1 = (torch.from_numpy(x).requires_grad_() for x in (scores, desc0, desc1))
    out = losses.criterion(
        {"gt_matches0": torch.from_numpy(gt0), "gt_matches1": torch.from_numpy(gt1)},
        {"scores": ts, "context_descriptors0": t0, "context_descriptors1": t1},
        margin=margin, mask0=torch.from_numpy(mask0), mask1=torch.from_numpy(mask1),
    )
    (out["loss"] + out["metric_loss"]).backward()
    for key in ("loss", "metric_loss"):
        np.testing.assert_allclose(out[key].item(), float(ref[key]), rtol=1e-6)
    if margin is None:
        assert out["metric_loss"].item() == 0.0
    else:
        assert out["metric_loss"].item() > 0
    for got, want in zip((ts, t0, t1), ref_grads):
        grad = torch.zeros_like(got) if got.grad is None else got.grad  # no metric loss: none
        np.testing.assert_allclose(grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def test_reprojection_pairs_follow_their_transformation():
    gen = SyntheticReprojectionPairs(num_keypoints=64, descriptor_dim=16, jitter=0.0)
    batch = gen.sample(torch.Generator().manual_seed(0), 3)
    t = batch.transformation
    assert t.kind == "3d_reprojection" and t.depth0.shape == (3, 64)
    warped, valid = transforms.reproject_keypoints(batch.side0.keypoints, t)
    assert valid.all()
    close = (warped - batch.side1.keypoints).norm(dim=-1) < 1e-2
    assert close[:, : int(0.7 * 64)].float().mean() > 0.5  # the covisible prefix
    back, _ = transforms.reproject_keypoints(batch.side1.keypoints, t.inverse())
    hit = (back - batch.side0.keypoints).norm(dim=-1) < 1e-2
    assert (hit == close).float().mean() > 0.95
    labels = gt_matches.generate_gt_matches(
        batch.side0.keypoints, batch.side1.keypoints, t, 2.0, 7.0
    )["gt_matches0"]
    assert (labels[:, :40] == torch.arange(40)).float().mean() > 0.5


def test_homography_pairs_carry_a_perspective_transformation():
    batch = SyntheticHomographyPairs(num_keypoints=32, descriptor_dim=8).sample(
        torch.Generator().manual_seed(1), 2
    )
    assert batch.transformation.kind == "perspective"
    H_inv = batch.transformation.inverse().H
    torch.testing.assert_close(batch.transformation.H @ H_inv, torch.eye(3).expand(2, 3, 3),
                               atol=1e-5, rtol=0)

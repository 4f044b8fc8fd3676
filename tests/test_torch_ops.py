"""The port's composed ops (openglue_tpu_torch.ops) against the JAX package's
on the CPU, with the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openglue_tpu.ops import attention as jax_attention
from openglue_tpu.ops import sinkhorn as jax_sinkhorn
from openglue_tpu_torch.ops import attention, sinkhorn


def _masks(rng, batch, n, counts):
    return np.arange(n)[None, :] < np.asarray(counts)[:, None]


@pytest.mark.parametrize(
    "batch,m,n,counts0,counts1",
    [(3, 40, 52, None, None), (2, 40, 52, [40, 25], [37, 52]), (1, 33, 47, [20], [47])],
)
def test_log_optimal_transport_matches_jax(batch, m, n, counts0, counts1):
    rng = np.random.default_rng(0)
    scores = rng.standard_normal((batch, m, n)).astype(np.float32) * 2
    mask0 = None if counts0 is None else _masks(rng, batch, m, counts0)
    mask1 = None if counts1 is None else _masks(rng, batch, n, counts1)
    ref = jax_sinkhorn.log_optimal_transport(
        jnp.asarray(scores), jnp.asarray(0.7), num_iters=15, reg=0.9,
        mask0=None if mask0 is None else jnp.asarray(mask0),
        mask1=None if mask1 is None else jnp.asarray(mask1),
    )
    out = sinkhorn.log_optimal_transport(
        torch.from_numpy(scores), torch.tensor(0.7), num_iters=15, reg=0.9,
        mask0=None if mask0 is None else torch.from_numpy(mask0),
        mask1=None if mask1 is None else torch.from_numpy(mask1),
    )
    # f32 logsumexp chains of 15 iterations: summation order only
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_build_masked_otp_inputs_matches_jax():
    rng = np.random.default_rng(1)
    scores = rng.standard_normal((2, 12, 9)).astype(np.float32)
    mask0 = _masks(rng, 2, 12, [12, 5])
    mask1 = _masks(rng, 2, 9, [3, 9])
    ref = jax_sinkhorn.build_masked_otp_inputs(
        jnp.asarray(scores), jnp.asarray(1.5), 0.5, jnp.asarray(mask0), jnp.asarray(mask1)
    )
    out = sinkhorn.build_masked_otp_inputs(
        torch.from_numpy(scores), torch.tensor(1.5), 0.5, torch.from_numpy(mask0),
        torch.from_numpy(mask1),
    )
    for a, b in zip(out, ref):
        # elementwise f32 arithmetic in the same order: exact up to one rounding
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_augment_scores_matches_jax():
    scores = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    ref = jax_sinkhorn.augment_scores(jnp.asarray(scores), jnp.asarray(-2.0))
    out = sinkhorn.augment_scores(torch.from_numpy(scores), torch.tensor(-2.0))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("with_mask", [False, True])
def test_softmax_attention_matches_jax(with_mask):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 50, 16)).astype(np.float32)
    k = rng.standard_normal((2, 4, 37, 16)).astype(np.float32)
    v = rng.standard_normal((2, 4, 37, 16)).astype(np.float32)
    mask = _masks(rng, 2, 37, [30, 0]) if with_mask else None
    ref, ref_attn = jax_attention.softmax_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask),
    )
    out, attn = attention.softmax_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask),
    )
    # one f32 softmax over <= 37 keys: a few ulps
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)
    np.testing.assert_allclose(attn.numpy(), np.asarray(ref_attn), atol=2e-6)

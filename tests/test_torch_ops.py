"""The port's composed ops (openglue_tpu_torch.ops) against the JAX package's
on the CPU, with the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax
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


def _qkv(rng, n=50, m=37, dh=16):
    q = rng.standard_normal((2, 4, n, dh)).astype(np.float32)
    k = rng.standard_normal((2, 4, m, dh)).astype(np.float32)
    v = rng.standard_normal((2, 4, m, dh)).astype(np.float32)
    return q, k, v


def _maybe(x, convert):
    return None if x is None else convert(x)


@pytest.mark.parametrize("with_mask", [False, True])
def test_softmax_attention_with_lse_matches_jax(with_mask):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng)
    mask = _masks(rng, 2, 37, [30, 12]) if with_mask else None
    ref, ref_lse = jax_attention.softmax_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), _maybe(mask, jnp.asarray))
    out, lse = attention.softmax_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), _maybe(mask, torch.from_numpy))
    # f32 sums over <= 37 keys
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=2e-5)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("name", ["linear_attention", "linear_attention_elu"])
def test_linear_attention_matches_jax(name, with_mask):
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng)
    if name == "linear_attention":  # takes positive feature maps
        q, k = np.abs(q) + 0.1, np.abs(k) + 0.1
    mask = _masks(rng, 2, 37, [30, 12]) if with_mask else None
    ref, none_ref = getattr(jax_attention, name)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), _maybe(mask, jnp.asarray))
    out, none_out = getattr(attention, name)(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), _maybe(mask, torch.from_numpy))
    assert none_ref is None and none_out is None
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("per_head", [False, True])
def test_favor_features_relu_matches_jax(per_head):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 50, 16)).astype(np.float32)
    proj = rng.standard_normal((4, 24, 16) if per_head else (24, 16)).astype(np.float32)
    ref = jax_attention.favor_features_relu(jnp.asarray(x), jnp.asarray(proj))
    out = attention.favor_features_relu(torch.from_numpy(x), torch.from_numpy(proj))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    assert (out > 0).all()


@pytest.mark.parametrize("is_query,with_mask", [(True, False), (False, False), (False, True)])
def test_favor_features_softmax_matches_jax(is_query, with_mask):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 37, 16)).astype(np.float32)
    proj = rng.standard_normal((24, 16)).astype(np.float32)
    mask = _masks(rng, 2, 37, [30, 12]) if with_mask else None
    ref = jax_attention.favor_features_softmax(
        jnp.asarray(x), jnp.asarray(proj), is_query, _maybe(mask, jnp.asarray))
    out = attention.favor_features_softmax(
        torch.from_numpy(x), torch.from_numpy(proj), is_query, _maybe(mask, torch.from_numpy))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    if with_mask:  # the key max is taken over valid keypoints only
        valid = out.numpy()[np.broadcast_to(mask[:, None, :, None], out.shape)]
        assert valid.max() <= 24**-0.5 * (1 + 1e-8) * (1 + 1e-6)


@pytest.mark.parametrize("rows,cols", [(32, 16), (40, 16), (16, 16), (10, 16)])
def test_orthogonal_random_matrix_properties(rows, cols):
    """The draw cannot equal JAX's (another generator), so it is held to what
    defines it: rows orthogonal within each block of ``cols`` rows, row norms
    chi distributed with ``cols`` degrees of freedom, and a seed fixes it."""
    gen = torch.Generator().manual_seed(0)
    w = attention.sample_orthogonal_random_matrix(gen, rows, cols)
    assert w.shape == (rows, cols) and w.dtype == torch.float32
    for start in range(0, rows, cols):
        block = w[start:start + cols]
        unit = block / block.norm(dim=1, keepdim=True)
        gram = unit @ unit.t()
        np.testing.assert_allclose(gram.numpy(), np.eye(len(block)), atol=1e-5)
    norms = w.norm(dim=1)
    assert norms.std() > 0.1  # not normalized: the Gaussian rows' own norms
    assert abs(norms.square().mean().item() - cols) < 0.5 * cols
    again = attention.sample_orthogonal_random_matrix(torch.Generator().manual_seed(0), rows, cols)
    assert torch.equal(w, again)
    other = attention.sample_orthogonal_random_matrix(torch.Generator().manual_seed(1), rows, cols)
    assert not torch.equal(w, other)
    ref = jax_attention.sample_orthogonal_random_matrix(jax.random.key(0), rows, cols)
    assert ref.shape == w.shape

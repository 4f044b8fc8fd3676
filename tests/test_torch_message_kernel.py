"""The port's train-mode attention half (``fused_attention_message`` in
ops/kernels/gnn_layer_kernel.py): its plain forward and backward against the
JAX Pallas message kernels, run in interpret mode on the CPU, forward values
and ``jax.grad`` for x_q, x_kv and all eight weights. The CUDA kernels' own
tests are in test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglue_tpu.ops.pallas import gnn_layer_kernel as jax_glk
from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk


def _case(seed, batch, n, m, dim, counts, same=False):
    """Numpy inputs and weights (torch layout [out, in]; ~1/sqrt(fan_in))."""
    rng = np.random.default_rng(seed)
    x_q = rng.standard_normal((batch, n, dim)).astype(np.float32)
    x_kv = x_q if same else rng.standard_normal((batch, m, dim)).astype(np.float32)
    mask = None if counts is None else np.arange(m)[None] < np.asarray(counts)[:, None]
    weights = []
    for i in range(8):
        if i % 2 == 0:
            weights.append((rng.standard_normal((dim, dim)) / np.sqrt(dim)).astype(np.float32))
        else:
            weights.append(rng.standard_normal(dim).astype(np.float32))
    return x_q, x_kv, mask, weights


def _jax_weights(weights):
    return jax_glk.MessageWeights(*[
        jnp.asarray(w.T) if w.ndim == 2 else jnp.asarray(w)[None] for w in weights
    ])


def _jax_grads(x_q, x_kv, mask, weights, heads, dtype, same, **kw):
    jm = None if mask is None else jnp.asarray(mask)

    def loss(a, b, w):
        out = jax_glk.fused_attention_message(
            a.astype(dtype), (a if same else b).astype(dtype), jm, w, heads,
            interpret=True, compute_dtype=dtype, **kw,
        ).astype(jnp.float32)
        return jnp.sum(out * jnp.cos(out)), out  # a non-trivial cotangent

    (val, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x_q), jnp.asarray(x_kv), _jax_weights(weights)
    )
    wgrads = [np.asarray(g) for g in grads[2]]
    wgrads = [g.T if g.shape[0] != 1 else g[0] for g in wgrads]  # torch layout
    dx = [np.asarray(grads[0])] + ([] if same else [np.asarray(grads[1])])
    return float(val), np.asarray(out), dx, wgrads


def _torch_grads(x_q, x_kv, mask, weights, heads, dtype, same):
    tq = torch.from_numpy(x_q).requires_grad_()
    tkv = tq if same else torch.from_numpy(x_kv).requires_grad_()
    tw = [torch.from_numpy(w).requires_grad_() for w in weights]
    out = glk.fused_attention_message(
        tq.to(dtype), tkv.to(dtype), None if mask is None else torch.from_numpy(mask),
        glk.MessageWeights(*tw), heads, dtype,
    )
    assert out.dtype == dtype
    o = out.float()
    val = (o * torch.cos(o)).sum()
    val.backward()
    dx = [tq.grad.numpy()] + ([] if same else [tkv.grad.numpy()])
    return float(val.detach()), o.detach().numpy(), dx, [w.grad.numpy() for w in tw]


@pytest.mark.parametrize(
    "n,m,dim,heads,counts,same,block_q",
    [
        (72, 56, 64, 4, [40, 56], False, 32),  # masked, unaligned, several query blocks
        (72, 56, 64, 4, None, False, 32),  # unmasked
        (40, 40, 64, 4, [30, 40], True, 32),  # self attention: x_q is x_kv
        (64, 1040, 32, 2, [1000], False, None),  # the large key set
    ],
)
def test_plain_f32_matches_pallas_message_kernels(n, m, dim, heads, counts, same, block_q):
    x_q, x_kv, mask, weights = _case(1, len(counts) if counts else 2, n, m, dim, counts, same)
    ref = _jax_grads(x_q, x_kv, mask, weights, heads, jnp.float32, same, block_q=block_q)
    got = _torch_grads(x_q, x_kv, mask, weights, heads, torch.float32, same)
    # the bar the JAX package holds its own message kernels to against XLA
    # (test_pallas_kernels.py:1126): f32 summation-order noise on large grads
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-6)
    np.testing.assert_allclose(got[1], ref[1], rtol=2e-6, atol=3e-5)
    for a, b in zip(got[2] + got[3], ref[2] + ref[3]):
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=3e-4)


def test_plain_bf16_matches_pallas_message_kernels():
    x_q, x_kv, mask, weights = _case(2, 2, 72, 56, 64, [40, 56])
    ref = _jax_grads(x_q, x_kv, mask, weights, 4, jnp.bfloat16, False, block_q=32)
    got = _torch_grads(x_q, x_kv, mask, weights, 4, torch.bfloat16, False)
    # both round at the same points; f32 accumulation order flips single bf16
    # roundings (2^-8 relative) of q/k/v, P, dS, dQ/dK/dV, which the
    # backward's products carry: 2^-5 of each gradient's largest entry
    # bounds every entry, and the mean error stays far below one ulp
    np.testing.assert_allclose(got[1], ref[1], atol=2.0**-5 * np.abs(ref[1]).max())
    for a, b in zip(got[2] + got[3], ref[2] + ref[3]):
        scale = np.abs(b).max()
        np.testing.assert_allclose(a, b, atol=2.0**-5 * scale + 1e-6)
        assert np.abs(a - b).mean() <= 2.0**-9 * scale + 1e-7


def test_forward_stats_match_pallas_kernel():
    """msg, attn and the per-row LSE that the backward consumes."""
    x_q, x_kv, mask, weights = _case(3, 2, 50, 37, 128, [37, 20])
    msg, attn, lse = jax_glk._message_forward(
        jnp.asarray(x_q), jnp.asarray(x_kv), jnp.asarray(mask, jnp.float32),
        _jax_weights(weights), 2, 32, True, jnp.float32, save_stats=True,
    )
    out = glk.message_forward_plain(
        torch.from_numpy(x_q), torch.from_numpy(x_kv), torch.from_numpy(mask),
        glk.MessageWeights(*map(torch.from_numpy, weights)), 2, torch.float32,
    )
    assert out[2].shape == (2, 2, 50) and out[2].dtype == torch.float32
    np.testing.assert_allclose(out[0].numpy(), np.asarray(msg), atol=3e-5)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(attn)[:, :50], atol=3e-5)
    np.testing.assert_allclose(out[2].numpy(), np.asarray(lse)[:, :, :50], atol=3e-5)


def test_extract_message_weights_are_views_of_the_parameters():
    from openglue_tpu_torch.models.gnn import AttentionalPropagation

    layer = AttentionalPropagation(64, 4)
    w = glk.extract_message_weights(dict(layer.named_parameters()))
    assert w.wq.shape == (64, 64) and w.bo.shape == (64,)
    assert w.wq.data_ptr() == layer.mha.in_proj_q.weight.data_ptr()
    w.wk.sum().backward()
    assert layer.mha.in_proj_k.weight.grad is not None


def test_cpu_tensors_count_no_launch():
    x_q, x_kv, mask, weights = _case(4, 1, 8, 8, 64, [8])
    before = glk.message_counter.count, glk.message_bwd_counter.count
    _torch_grads(x_q, x_kv, mask, weights, 1, torch.float32, False)
    assert (glk.message_counter.count, glk.message_bwd_counter.count) == before

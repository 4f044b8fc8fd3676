"""The port's masked softmax attention (``ops/kernels/attention_kernel.py``)
against the JAX package's ``masked_softmax_attention`` on the CPU: the plain
forward against the Pallas forward kernel, the plain backward and the
autograd Function against ``jax.grad`` through the Pallas backward kernel
(both in interpret mode), masked, unmasked, with N != M and with an element
whose keys are all masked."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglue_tpu.ops.pallas.attention_kernel import masked_softmax_attention as jax_attention
from openglue_tpu_torch.ops import attention as attn_ops
from openglue_tpu_torch.ops import kernels
from openglue_tpu_torch.ops.kernels import attention_kernel as ak

# (N, M, valid key counts of the two batch elements or None). The last case
# masks every key of its first element; its M is a multiple of 128, where the
# JAX forward's padded key axis and the port's M keys are the same set
CASES = [(96, 96, None), (72, 56, (40, 56)), (64, 128, (0, 100))]
IDS = ["unmasked", "masked-n72-m56", "fully-masked-element"]


def _case(n, m, counts, seed=0, heads=4, dh=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, heads, n, dh)).astype(np.float32)
    k = rng.standard_normal((2, heads, m, dh)).astype(np.float32)
    v = rng.standard_normal((2, heads, m, dh)).astype(np.float32)
    mask = None if counts is None else np.arange(m)[None] < np.asarray(counts)[:, None]
    return q, k, v, mask


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("n,m,counts", CASES, ids=IDS)
def test_plain_forward_matches_jax_kernel(n, m, counts):
    q, k, v, mask = _case(n, m, counts)
    ref = jax_attention(_j(q), _j(k), _j(v), _j(mask))
    out, lse = ak.attention_forward_plain(_t(q), _t(k), _t(v), _t(mask))
    # f32, the same formula: summation order only
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    assert lse.shape == (2, 4, n) and lse.dtype == torch.float32
    # the wrapper takes the plain version for CPU tensors and counts no launch
    before = ak.counter.count
    again = ak.masked_softmax_attention(_t(q), _t(k), _t(v), _t(mask))
    assert torch.equal(again, out) and ak.counter.count == before
    # on rows with a valid key the LSE is that of the reference op
    _, ref_lse = attn_ops.softmax_attention_with_lse(_t(q), _t(k), _t(v), _t(mask))
    live = slice(None) if counts is None else torch.tensor(counts) > 0
    torch.testing.assert_close(lse[live], ref_lse[live], atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,m,counts", CASES, ids=IDS)
def test_function_gradients_match_jax_kernel(n, m, counts):
    """dq, dk, dv of the autograd Function (the plain backward on the CPU)
    against jax.grad through the Pallas backward kernel, at the JAX package's
    bar for its fused backward (tests/test_pallas_kernels.py: atol 3e-4)."""
    q, k, v, mask = _case(n, m, counts, seed=1)

    def loss(a, b, c):
        out = jax_attention(a, b, c, _j(mask))
        return jnp.sum(out * jnp.cos(out))  # a non-trivial cotangent

    ref = jax.grad(loss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = ak.masked_softmax_attention(tq, tk, tv, _t(mask))
    (out * torch.cos(out)).sum().backward()
    for name, got, want in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4, err_msg=name)
    if counts is not None and 0 in counts:  # the masked-out element still has a gradient
        assert tq.grad[0].abs().max() > 0 and tv.grad[0].abs().max() > 0


@pytest.mark.parametrize("n,m,counts", CASES, ids=IDS)
def test_plain_backward_is_the_derivative_of_the_forward(n, m, counts):
    """The written-out backward against torch autograd of the reference op
    (f32: 1e-5 of the largest entry). Where every key is masked, autograd of
    the reference's ``where`` passes no gradient to q and k, while the TPU
    kernel (and so the port) returns dS k and dS^T q of the uniform softmax:
    there only dv is compared."""
    q, k, v, mask = _case(n, m, counts, seed=2)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(q.shape).astype(np.float32))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out, _ = attn_ops.softmax_attention(tq, tk, tv, _t(mask))
    want = torch.autograd.grad(out, (tq, tk, tv), g)
    got = ak.attention_backward_plain(_t(q), _t(k), _t(v), _t(mask), g)
    live = torch.ones(2, dtype=torch.bool) if counts is None else torch.tensor(counts) > 0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        rows = slice(None) if name == "dv" else live
        torch.testing.assert_close(a[rows], b[rows], atol=1e-5 * b.abs().max().item(), rtol=0,
                                   msg=lambda s: f"{name}: {s}")


def test_fully_masked_key_set_averages_over_its_own_keys():
    """By design: with every key masked the port averages over the M keys it
    was given (as the JAX XLA reference does); the JAX forward kernel averages
    over its key axis padded to 128 with zero values. Pinned on M = 56."""
    q, k, v, _ = _case(64, 56, None, seed=4)
    mask = np.zeros((2, 56), bool)
    mask[1, :30] = True
    out, _ = ak.attention_forward_plain(_t(q), _t(k), _t(v), _t(mask))
    mean = _t(v)[0].mean(dim=1, keepdim=True).expand(-1, 64, -1)
    torch.testing.assert_close(out[0], mean, atol=1e-6, rtol=0)
    ref = np.asarray(jax_attention(_j(q), _j(k), _j(v), _j(mask)))
    np.testing.assert_allclose(ref[0], mean.numpy() * (56 / 128), atol=1e-6)
    np.testing.assert_allclose(out[1].numpy(), ref[1], atol=1e-5)  # a live element agrees


def test_bf16_rounding_sites_match_jax_kernel():
    """bf16 operands: p is rounded to v's type for P.V, the denominator sums
    the unrounded p, the division comes after. Two ulps of the largest output
    (products of bf16 pairs are exact in f32; the summation order differs)."""
    q, k, v, mask = _case(72, 56, (40, 56), seed=5)
    jq, jk, jv = (_j(x).astype(jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(jax_attention(jq, jk, jv, _j(mask)).astype(jnp.float32))
    tq, tk, tv = (_t(x).bfloat16() for x in (q, k, v))
    out, _ = ak.attention_forward_plain(tq, tk, tv, _t(mask))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2.0**-7 * np.abs(ref).max())
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)).bfloat16()
    grads = ak.attention_backward_plain(tq, tk, tv, _t(mask), g)
    assert all(t.dtype == torch.bfloat16 for t in grads)
    want = ak.attention_backward_plain(tq.float(), tk.float(), tv.float(), _t(mask), g.float())
    for a, b in zip(grads, want):  # against the same operands in f32: the roundings of P, dS and the result
        assert (a.float() - b).abs().max() <= 2.0**-6 * b.abs().max()


@pytest.mark.parametrize("n,m,counts", CASES, ids=IDS)
def test_bf16_forward_matches_jax_kernel(n, m, counts):
    """The wrapper's forward for bf16 operands (the plain version on the
    CPU), with and without the LSE, against the JAX kernel's bf16 output:
    bf16 out, the same bits either way, the same LSE as the f32 forward of
    the same operands, and within one bf16 rounding of the largest entry."""
    q, k, v, mask = _case(n, m, counts, seed=7)
    tq, tk, tv = (_t(x).bfloat16() for x in (q, k, v))
    out, lse = ak.attention_forward(tq, tk, tv, _t(mask))
    bare, none = ak.attention_forward(tq, tk, tv, _t(mask), False)
    assert out.dtype == torch.bfloat16 and none is None and torch.equal(out, bare)
    _, lse32 = ak.attention_forward(tq.float(), tk.float(), tv.float(), _t(mask))
    torch.testing.assert_close(lse, lse32, atol=1e-5, rtol=0)
    jq, jk, jv = (_j(x).astype(jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(jax_attention(jq, jk, jv, _j(mask)).astype(jnp.float32))
    live = slice(None) if counts is None else np.asarray(counts) > 0  # the JAX kernel pads a masked key set
    np.testing.assert_allclose(out.float().numpy()[live], ref[live], atol=2.0**-7 * np.abs(ref).max())


def test_bf16_backward_passes_are_counted_by_the_c_code():
    """The bf16 backward passes (two per backward, from K10 and from K5's bf16
    attention) are counted by the C code where it launches them, in exactly
    the libraries whose source includes attention_backward.cuh. Before the
    libraries are loaded the count reads 0, reading or resetting it builds
    nothing, and a CPU backward takes the plain version and counts nothing."""
    counter = ak.bf16_backward_counter
    assert (counter.header, counter.symbol, counter.which) == (
        "attention_backward.cuh", "og_attention_backward_launches", 0)
    assert kernels.libraries_including("attention_backward.cuh") == ("message_backward", "attention_backward")
    loaded = dict(kernels._libs)
    counter.reset()
    assert counter.count == 0 and kernels._libs == loaded
    q, k, v, mask = (_t(x) for x in _case(40, 24, (24, 10)))
    g = torch.randn(q.shape).bfloat16()
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    out, lse = ak.attention_forward(q, k, v, mask)
    grads = ak.attention_backward(q, k, v, mask, g, out, lse)
    assert all(torch.equal(a, b) for a, b in zip(grads, ak.attention_backward_plain(q, k, v, mask, g)))
    assert counter.count == 0 and kernels._libs == loaded

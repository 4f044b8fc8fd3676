"""The port's eval GNN layer (ops/kernels/gnn_layer_kernel.py): its plain
version against the JAX Pallas layer kernel, run in interpret mode on the
CPU, and against the JAX XLA reference; and the BatchNorm fold. The CUDA
kernel's own test is in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openglue_tpu.ops.pallas import gnn_layer_kernel as jax_glk
from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk


def _weights(dim, seed):
    """Numpy weights in torch layout [out, in]; ~1/sqrt(fan_in) keeps the
    activations O(1)."""
    rng = np.random.default_rng(seed)

    def mat(out, inp):
        return (rng.standard_normal((out, inp)) / np.sqrt(inp)).astype(np.float32)

    def vec(size, scale=1.0, shift=0.0):
        return (shift + scale * rng.standard_normal(size)).astype(np.float32)

    d2 = 2 * dim
    return dict(
        wq=mat(dim, dim), bq=vec(dim), wk=mat(dim, dim), bk=vec(dim),
        wv=mat(dim, dim), bv=vec(dim), wo=mat(dim, dim), bo=vec(dim),
        w1=mat(d2, d2), b1=vec(d2), a1=vec(d2, 0.1, 1.0), c1=vec(d2, 0.1),
        w2=mat(dim, d2), b2=vec(dim),
    )


def _jax_weights(w, dtype):
    mats = {"wq", "wk", "wv", "wo", "w1", "w2"}
    return jax_glk.PropagationWeights(
        **{k: jnp.asarray(v.T).astype(dtype) if k in mats else jnp.asarray(v)[None] for k, v in w.items()}
    )


def _torch_weights(w, dtype):
    mats = {"wq", "wk", "wv", "wo", "w1", "w2"}
    return glk.PropagationWeights(
        **{k: torch.from_numpy(v).to(dtype) if k in mats else torch.from_numpy(v) for k, v in w.items()}
    )


def _run_both(dim, heads, n, m, counts, use_offset, seed, torch_dtype, jax_dtype):
    rng = np.random.default_rng(seed)
    x_q = rng.standard_normal((len(counts), n, dim)).astype(np.float32)
    x_kv = rng.standard_normal((len(counts), m, dim)).astype(np.float32)
    mask = np.arange(m)[None] < np.asarray(counts)[:, None]
    w = _weights(dim, seed + 1)
    jw = _jax_weights(w, jax_dtype)
    jx_q, jx_kv = jnp.asarray(x_q).astype(jax_dtype), jnp.asarray(x_kv).astype(jax_dtype)
    pallas = jax_glk.fused_attention_propagation(
        jx_q, jx_kv, jnp.asarray(mask), jw, num_heads=heads, use_offset=use_offset,
        block_q=32, interpret=True,
    )
    xla = jax_glk.xla_reference_layer(jx_q, jx_kv, jnp.asarray(mask), jw, heads, use_offset)
    out = glk.fused_attention_propagation(
        torch.from_numpy(x_q).to(torch_dtype), torch.from_numpy(x_kv).to(torch_dtype),
        torch.from_numpy(mask), _torch_weights(w, torch_dtype), heads, use_offset,
    )
    assert out.dtype == torch_dtype and out.shape == (len(counts), n, dim)
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    return out.float().numpy(), f32(pallas), f32(xla)


@pytest.mark.parametrize(
    "dim,heads,n,m,counts,use_offset",
    [
        (128, 2, 96, 80, [60, 80], False),  # masks
        (128, 4, 50, 37, [37], True),  # offset, unaligned N and M
        (128, 2, 40, 128, [128, 0], False),  # a fully masked key set
    ],
)
def test_plain_f32_matches_pallas_kernel(dim, heads, n, m, counts, use_offset):
    out, pallas, xla = _run_both(dim, heads, n, m, counts, use_offset, 0, torch.float32, jnp.float32)
    # the bar the JAX package holds its own kernel to (test_pallas_kernels.py:332)
    np.testing.assert_allclose(out, pallas, atol=3e-5)
    np.testing.assert_allclose(out, xla, atol=3e-5)


def test_plain_f32_fully_masked_unaligned_matches_xla_reference():
    """A fully masked key set averages the values of all M keys uniformly. The
    TPU kernel pads M to 128 and averages over the padding too, so at an
    unaligned M the XLA reference is the oracle."""
    out, _, xla = _run_both(128, 2, 30, 37, [0, 20], False, 3, torch.float32, jnp.float32)
    np.testing.assert_allclose(out, xla, atol=3e-5)


@pytest.mark.parametrize("use_offset", [False, True])
def test_plain_bf16_matches_pallas_kernel(use_offset):
    out, pallas, xla = _run_both(128, 2, 70, 90, [90, 41], use_offset, 5, torch.bfloat16, jnp.bfloat16)
    # the Pallas kernel rounds at the same points; f32 accumulation order
    # flips some bf16 roundings (1 ulp = 2^-8 relative), which the FFN carries
    # into the output (|out| < 8, where one ulp is 2^-5): two ulps at most,
    # and the mean error stays far below one
    np.testing.assert_allclose(out, pallas, atol=0.0625)
    assert np.abs(out - pallas).mean() < 1e-3
    # the XLA reference also rounds the logits to bf16 and normalizes before
    # P.V, so it differs more often, by the same few ulps at most
    np.testing.assert_allclose(out, xla, atol=0.0625)


def test_fold_matches_jax():
    rng = np.random.default_rng(7)
    dim = 32

    def dense(out, inp):
        return rng.standard_normal((out, inp)).astype(np.float32), rng.standard_normal(out).astype(np.float32)

    names = {"q_proj": "in_proj_q", "k_proj": "in_proj_k", "v_proj": "in_proj_v", "out_proj": "out_proj"}
    state, mha = {}, {}
    for jname, tname in names.items():
        wt, b = dense(dim, dim)
        state[f"mha.{tname}.weight"], state[f"mha.{tname}.bias"] = torch.from_numpy(wt[:, :, None]), torch.from_numpy(b)
        mha[jname] = {"kernel": jnp.asarray(wt.T), "bias": jnp.asarray(b)}
    w1, b1 = dense(2 * dim, 2 * dim)
    w2, b2 = dense(dim, 2 * dim)
    scale, bias = rng.standard_normal(2 * dim).astype(np.float32), rng.standard_normal(2 * dim).astype(np.float32)
    mean, var = rng.standard_normal(2 * dim).astype(np.float32), rng.random(2 * dim).astype(np.float32) + 0.3
    state.update({
        "fc.0.weight": torch.from_numpy(w1[:, :, None]), "fc.0.bias": torch.from_numpy(b1),
        "fc.2.weight": torch.from_numpy(scale), "fc.2.bias": torch.from_numpy(bias),
        "fc.2.running_mean": torch.from_numpy(mean), "fc.2.running_var": torch.from_numpy(var),
        "fc.3.weight": torch.from_numpy(w2[:, :, None]), "fc.3.bias": torch.from_numpy(b2),
    })
    params = {"mha": mha, "ffn": {
        "dense_0": {"kernel": jnp.asarray(w1.T), "bias": jnp.asarray(b1)},
        "bn_0": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
        "dense_1": {"kernel": jnp.asarray(w2.T), "bias": jnp.asarray(b2)},
    }}
    stats = {"ffn": {"bn_0": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}}
    ref = jax_glk.fold_propagation_weights(params, stats, jnp.float32)
    out = glk.fold_propagation_weights(state, torch.float32)
    for name in glk.PropagationWeights._fields:
        r = np.asarray(getattr(ref, name))
        o = getattr(out, name).numpy()
        r = r.T if r.ndim == 2 and r.shape[0] != 1 else r.reshape(-1)
        # rsqrt vs 1/sqrt: one rounding
        np.testing.assert_allclose(o, r, rtol=1e-6, atol=1e-6, err_msg=name)


def test_cpu_tensor_runs_plain_version_without_counting():
    before = glk.counter.count
    out, _, _ = _run_both(64, 1, 8, 8, [8], False, 9, torch.float32, jnp.float32)
    assert glk.counter.count == before and np.isfinite(out).all()


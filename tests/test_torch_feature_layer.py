"""The port's eval GNN layer with the O(N) attention kinds (linear, FAVOR-relu,
FAVOR-softmax): the plain version against the JAX Pallas layer kernel in
interpret mode and against the JAX XLA reference; the module path (fused
against composed); and the whole SuperGlue forward + decode per kind against
the JAX package. The CUDA kernel's own test is in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openglue_tpu.models import matching as jax_matching
from openglue_tpu.models.superglue import SuperGlue as JaxSuperGlue
from openglue_tpu.models.superglue import SuperGlueConfig as JaxConfig
from openglue_tpu.ops import attention as jax_attention
from openglue_tpu.ops.pallas import force_fused_dispatch
from openglue_tpu.ops.pallas import gnn_layer_kernel as jax_glk
from openglue_tpu_torch.compat.jax_weights import superglue_state_dict_from_jax
from openglue_tpu_torch.models import matching
from openglue_tpu_torch.models.gnn import AttentionalPropagation
from openglue_tpu_torch.models.superglue import SuperGlue, SuperGlueConfig
from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
from test_torch_gnn_layer_kernel import _jax_weights, _torch_weights, _weights
from test_torch_superglue import SMALL, _numpy_inputs

KINDS = ("linear", "favor_relu", "favor_softmax")


def _projection(kind, dh, seed, num_features=None):
    if kind == "linear":
        return None
    proj = jax_attention.sample_orthogonal_random_matrix(
        jax.random.key(seed), num_features or 2 * dh, dh
    )
    return np.array(proj)


def _run_both(kind, dim, heads, n, m, counts, use_offset, seed, torch_dtype, jax_dtype,
              num_features=None):
    rng = np.random.default_rng(seed)
    x_q = rng.standard_normal((len(counts), n, dim)).astype(np.float32)
    x_kv = rng.standard_normal((len(counts), m, dim)).astype(np.float32)
    mask = np.arange(m)[None] < np.asarray(counts)[:, None]
    w = _weights(dim, seed + 1)
    jw = _jax_weights(w, jax_dtype)
    proj = _projection(kind, dim // heads, seed + 2, num_features)
    jproj = None if proj is None else jnp.asarray(proj)
    jx_q, jx_kv = jnp.asarray(x_q).astype(jax_dtype), jnp.asarray(x_kv).astype(jax_dtype)
    pallas = jax_glk.fused_attention_propagation(
        jx_q, jx_kv, jnp.asarray(mask), jw, num_heads=heads, use_offset=use_offset,
        block_q=32, interpret=True, attention_kind=kind, projection=jproj,
    )
    xla = jax_glk.xla_reference_layer(
        jx_q, jx_kv, jnp.asarray(mask), jw, heads, use_offset, kind, jproj
    )
    before = glk.feature_counter.count
    out = glk.fused_attention_propagation(
        torch.from_numpy(x_q).to(torch_dtype), torch.from_numpy(x_kv).to(torch_dtype),
        torch.from_numpy(mask), _torch_weights(w, torch_dtype), heads, use_offset,
        attention_kind=kind, projection=None if proj is None else torch.from_numpy(proj),
    )
    # a CPU tensor takes the plain version: no launch is counted
    assert glk.feature_counter.count == before
    assert out.dtype == torch_dtype and out.shape == (len(counts), n, dim)
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    return out.float().numpy(), f32(pallas), f32(xla)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize(
    "dim,heads,n,m,counts,use_offset",
    [
        (128, 2, 96, 80, [60, 80], False),  # ragged masks
        (128, 4, 50, 37, [37, 11], True),  # offset, dh=32, unaligned N and M
    ],
)
def test_plain_f32_matches_pallas_kernel(kind, dim, heads, n, m, counts, use_offset):
    out, pallas, xla = _run_both(kind, dim, heads, n, m, counts, use_offset, 0, torch.float32, jnp.float32)
    # the bar the JAX package holds its own kernel to (test_pallas_kernels.py:1009)
    np.testing.assert_allclose(out, pallas, atol=3e-5)
    np.testing.assert_allclose(out, xla, atol=3e-5)


def test_plain_f32_favor_num_features():
    out, pallas, _ = _run_both("favor_relu", 128, 2, 40, 64, [64, 30], False, 4, torch.float32,
                               jnp.float32, num_features=48)
    np.testing.assert_allclose(out, pallas, atol=3e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_bf16_matches_pallas_kernel(kind):
    out, pallas, _ = _run_both(kind, 128, 2, 70, 90, [90, 41], False, 5, torch.bfloat16, jnp.bfloat16)
    # the same rounding points; f32 summation order flips single bf16
    # roundings (one ulp is 2^-8 relative) which the FFN carries into the
    # output (|out| < 8, one ulp 2^-5): two ulps at most, far less on average
    np.testing.assert_allclose(out, pallas, atol=0.0625)
    assert np.abs(out - pallas).mean() < 1e-3


@pytest.mark.parametrize("kind", KINDS)
def test_fully_masked_key_set_is_nan_as_in_jax(kind):
    """No valid key leaves the aggregate and the normalizer 0: the element's
    rows are NaN in the JAX kernel and in the port; other elements are not
    touched."""
    out, pallas, _ = _run_both(kind, 128, 2, 40, 128, [128, 0], False, 6, torch.float32, jnp.float32)
    assert np.isnan(pallas[1]).all() and np.isnan(out[1]).all()
    np.testing.assert_allclose(out[0], pallas[0], atol=3e-5)


def test_unknown_kind_and_missing_projection_raise():
    x = torch.zeros(1, 4, 64)
    w = _torch_weights(_weights(64, 0), torch.float32)
    with pytest.raises(ValueError, match="unsupported attention_kind"):
        glk.fused_attention_propagation(x, x, None, w, 1, attention_kind="cosine")
    with pytest.raises(ValueError, match="needs the FAVOR projection"):
        glk.fused_attention_propagation(x, x, None, w, 1, attention_kind="favor_relu")


@pytest.mark.parametrize("kind", KINDS)
def test_module_fused_matches_composed(kind):
    """AttentionalPropagation in eval mode: the fused route (use_pallas) against
    the composed modules, the same weights and projection buffer."""
    torch.manual_seed(0)
    dim, heads, n, m = 128, 2, 60, 45
    gen = torch.Generator().manual_seed(1)
    composed = AttentionalPropagation(dim, heads, attention=kind, generator=gen).eval()
    fused = AttentionalPropagation(dim, heads, attention=kind, use_pallas=True).eval()
    for module in composed.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(gen)
    composed.fc[2].running_mean.normal_(generator=gen)
    composed.fc[2].running_var.uniform_(0.5, 1.5, generator=gen)
    fused.load_state_dict(composed.state_dict())
    x_q = torch.randn(2, n, dim, generator=gen)
    x_kv = torch.randn(2, m, dim, generator=gen)
    kv_mask = torch.arange(m)[None] < torch.tensor([m, 20])[:, None]
    q_mask = torch.ones(2, n, dtype=torch.bool)
    with torch.no_grad():
        ref = composed(x_q, x_kv, q_mask, kv_mask)
        out = fused(x_q, x_kv, q_mask, kv_mask)
    # the JAX package's bar for the same comparison (test_pallas_kernels.py:1068)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=5e-5)


def test_unknown_attention_raises_in_module():
    with pytest.raises(ValueError, match="is not supported; choose from"):
        AttentionalPropagation(64, 1, attention="cosine")


def _jax_model_variables(cfg_kwargs, inputs):
    model = JaxSuperGlue(JaxConfig(**cfg_kwargs))
    variables = model.init(jax.random.key(1), **{k: jnp.asarray(v) for k, v in inputs.items()})
    stats = jax.tree_util.tree_map(
        lambda v: v + 0.3 * jax.random.normal(jax.random.key(9), v.shape) ** 2,
        variables["batch_stats"],
    )
    variables = {**variables, "batch_stats": stats}
    return jax.tree_util.tree_map(np.asarray, dict(variables))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_superglue_forward_matches_jax(kind, use_pallas):
    inputs = _numpy_inputs()
    kwargs = dict(SMALL, attention=kind)
    variables = _jax_model_variables(kwargs, inputs)
    assert ("favor_projections" in variables) == (kind != "linear")
    force_fused_dispatch(use_pallas)
    try:
        ref = JaxSuperGlue(JaxConfig(**kwargs, use_pallas=use_pallas)).apply(
            variables, **{k: jnp.asarray(v) for k, v in inputs.items()}
        )
    finally:
        force_fused_dispatch(False)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    cfg = SuperGlueConfig(**kwargs, use_pallas=use_pallas)
    model = SuperGlue(cfg, device="cpu")
    model.load_state_dict(superglue_state_dict_from_jax(variables, cfg))
    model.eval()
    with torch.no_grad():
        out = model(**{k: torch.from_numpy(np.array(v)) for k, v in inputs.items()})
    # the bar of the softmax forward (test_torch_superglue.py)
    np.testing.assert_allclose(out["scores"].numpy(), ref["scores"], atol=5e-4)
    m0, m1 = torch.from_numpy(inputs["mask0"]), torch.from_numpy(inputs["mask1"])
    port = matching.decode_from_output(out, 0.0, m0, m1)
    jref = jax_matching.decode_from_output(
        {k: jnp.asarray(v) for k, v in ref.items()}, 0.0,
        jnp.asarray(inputs["mask0"]), jnp.asarray(inputs["mask1"]),
    )
    assert (port["matches0"] >= 0).sum() > 0
    agree = (port["matches0"].numpy() == np.asarray(jref["matches0"]))[inputs["mask0"]].mean()
    assert agree >= 0.99

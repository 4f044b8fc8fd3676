"""The port's int8 eval GNN layer (ops/kernels/gnn_layer_int8.py): the weight
quantizer, the plain version against the JAX XLA oracle and the JAX Pallas
kernel in interpret mode in all four modes, the calibration pass, and the
model: calibrate -> serve -> decode agreement. The CUDA kernel's own test is
in test_torch_cuda.py."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openglue_tpu.models import superglue as jax_superglue
from openglue_tpu.models.superglue import SuperGlue as JaxSuperGlue
from openglue_tpu.models.superglue import SuperGlueConfig as JaxConfig
from openglue_tpu.ops.pallas import force_fused_dispatch
from openglue_tpu.ops.pallas import gnn_layer_int8 as jax_gli8
from openglue_tpu.ops.pallas import gnn_layer_kernel as jax_glk
from openglue_tpu_torch.compat.jax_weights import jax_variables_from_state_dict, superglue_state_dict_from_jax
from openglue_tpu_torch.data.synthetic import SyntheticHomographyPairs
from openglue_tpu_torch.models import matching
from openglue_tpu_torch.models.gnn import AttentionalPropagation
from openglue_tpu_torch.models.superglue import SuperGlue, SuperGlueConfig
from openglue_tpu_torch.ops.kernels import gnn_layer_int8 as gli8
from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
from openglue_tpu_torch.train.step import superglue_inputs
from test_torch_gnn_layer_kernel import _jax_weights, _torch_weights, _weights

MODES = {  # quantize mode -> (static, quant_attention)
    "int8": (False, False), "int8_static": (True, False),
    "int8_attn": (False, True), "int8_static_attn": (True, True),
}


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _case(dim=128, heads=4, n=96, m=80, counts=(60, 80), seed=0):
    rng = np.random.default_rng(seed)
    x_q = rng.standard_normal((len(counts), n, dim)).astype(np.float32)
    x_kv = rng.standard_normal((len(counts), m, dim)).astype(np.float32)
    mask = np.arange(m)[None] < np.asarray(counts)[:, None]
    w = _weights(dim, seed + 1)
    jqw = jax_gli8.quantize_propagation_weights(_jax_weights(w, jnp.float32))
    tqw = gli8.quantize_propagation_weights(_torch_weights(w, torch.float32))
    return x_q, x_kv, mask, w, jqw, tqw


def test_quantized_weights_equal_jax_bit_for_bit():
    *_, jqw, tqw = _case()
    for name in gli8.QuantPropagationWeights._fields:
        ref, out = np.asarray(getattr(jqw, name)), getattr(tqw, name).numpy()
        ref = ref.T if ref.shape[0] != 1 else ref.reshape(-1)  # [in, out] -> [out, in]
        assert out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref, err_msg=name)


@pytest.mark.parametrize("use_offset", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_jax_oracle_and_kernel(mode, use_offset):
    static, quant_attention = MODES[mode]
    x_q, x_kv, mask, _, jqw, tqw = _case(seed=2 * use_offset)
    heads = 4
    jx_q, jx_kv, jmask = jnp.asarray(x_q), jnp.asarray(x_kv), jnp.asarray(mask)
    tx_q, tx_kv, tmask = torch.from_numpy(x_q), torch.from_numpy(x_kv), torch.from_numpy(mask)
    jscales = tscales = None
    if static:
        absmax = jax_gli8.reference_activation_absmax(
            jx_q, jx_kv, jmask, jqw, heads, use_offset, quant_attention=quant_attention
        )
        out_absmax = gli8.reference_activation_absmax(
            tx_q, tx_kv, tmask, tqw, heads, use_offset, quant_attention=quant_attention
        )
        assert out_absmax.shape == (8 if quant_attention else 5,)
        # the sites before the attention (kv, xq and k, v, q) see the same
        # integers: equal up to an f32 rounding. The sites after it (attn,
        # cat, h1) inherit the attention's differences: the oracle rounds its
        # bf16 logits and outputs once more, and takes one dynamic q/k/v
        # scale for the whole batch where the port takes one per element
        got, want = out_absmax.numpy(), np.asarray(absmax)
        np.testing.assert_allclose(np.delete(got, [2, 3, 4]), np.delete(want, [2, 3, 4]), rtol=1e-5)
        np.testing.assert_allclose(got[2:5], want[2:5], rtol=1e-2)
        jscales = absmax * (1.1 / 127.0) + 1e-12
        tscales = torch.from_numpy(np.array(jscales))
    oracle = jax_gli8.xla_reference_layer_int8(
        jx_q, jx_kv, jmask, jqw, heads, use_offset, act_scales=jscales,
        quant_attention=quant_attention,
    )
    kernel = jax_gli8.fused_attention_propagation_int8(
        jx_q, jx_kv, jmask, jqw, num_heads=heads, use_offset=use_offset, block_q=32,
        act_scales=jscales, quant_attention=quant_attention,
    )
    before = gli8.counter.count
    out = gli8.fused_attention_propagation_int8(
        tx_q, tx_kv, tmask, tqw, heads, use_offset, act_scales=tscales,
        quant_attention=quant_attention,
    )
    assert gli8.counter.count == before  # a CPU tensor takes the plain version
    out = out.numpy()
    # the JAX package's bar between its kernel and its oracle
    # (test_pallas_kernels.py:595): the bf16 attention rounds differently and
    # flips independent int8 roundings, so the comparison is in norm
    assert _rel(out, np.asarray(kernel)) < 0.015
    assert _rel(out, np.asarray(oracle)) < 0.015
    if static:
        # one calibrated grid shared with JAX: only the bf16 attention's
        # rounding (without quant_attention) and isolated flips remain
        assert _rel(out, np.asarray(kernel)) < 0.006
    if mode == "int8_static_attn":
        # every product is an exact integer product on a shared grid
        assert _rel(out, np.asarray(kernel)) < 1e-3


def test_calibration_absmax_equals_jax_with_f32_attention():
    """With the attention in f32 neither side rounds between the quantized
    products, so all five sites agree up to rare single int8 flips."""
    x_q, x_kv, mask, _, jqw, tqw = _case(seed=4)
    _, want = jax_gli8.xla_reference_layer_int8(
        jnp.asarray(x_q), jnp.asarray(x_kv), jnp.asarray(mask), jqw, 4,
        attn_dtype=jnp.float32, collect_absmax=True,
    )
    _, got = gli8.layer_int8_plain(
        torch.from_numpy(x_q), torch.from_numpy(x_kv), torch.from_numpy(mask), tqw, 4,
        attn_dtype=torch.float32, collect_absmax=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("mode,bar", [("int8", 0.03), ("int8_static", 0.05), ("int8_attn", 0.05),
                                      ("int8_static_attn", 0.05)])
def test_quantization_error_bounded_against_f32_layer(mode, bar):
    static, quant_attention = MODES[mode]
    x_q, _, _, w, _, tqw = _case(seed=3)
    tx = torch.from_numpy(x_q)
    ref = glk.layer_plain(tx, tx, None, _torch_weights(w, torch.float32), 4)
    scales = None
    if static:
        absmax = gli8.reference_activation_absmax(tx, tx, None, tqw, 4, quant_attention=quant_attention)
        scales = absmax * (1.1 / 127.0) + 1e-12
    out = gli8.fused_attention_propagation_int8(
        tx, tx, None, tqw, 4, act_scales=scales, quant_attention=quant_attention
    )
    # the JAX package's bars (test_pallas_kernels.py:611, 725, 795)
    assert _rel(out.numpy(), ref.numpy()) < bar


def test_bf16_input_and_fully_masked_keys():
    """x in bf16 (the bf16 chain) comes back in bf16; a fully masked key set
    averages uniformly, as in the softmax layer, and stays finite."""
    x_q, x_kv, _, _, jqw, tqw = _case(counts=(0, 80), m=128)
    mask = np.arange(128)[None] < np.asarray([0, 128])[:, None]
    out = gli8.fused_attention_propagation_int8(
        torch.from_numpy(x_q).bfloat16(), torch.from_numpy(x_kv).bfloat16(),
        torch.from_numpy(mask), tqw, 4,
    )
    ref = jax_gli8.fused_attention_propagation_int8(
        jnp.asarray(x_q).astype(jnp.bfloat16), jnp.asarray(x_kv).astype(jnp.bfloat16),
        jnp.asarray(mask), jqw, num_heads=4, block_q=32,
    )
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert _rel(out.float().numpy(), np.asarray(ref.astype(jnp.float32))) < 0.015


def test_five_site_scales_with_quant_attention_raise():
    x_q, _, _, _, _, tqw = _case()
    tx = torch.from_numpy(x_q)
    scales5 = torch.full((5,), 0.01)
    with pytest.raises(ValueError, match="8 calibrated activation sites"):
        gli8.fused_attention_propagation_int8(tx, tx, None, tqw, 4, act_scales=scales5, quant_attention=True)
    with pytest.raises(ValueError, match="8 calibrated activation sites"):
        gli8.layer_int8_plain(tx, tx, None, tqw, 4, act_scales=scales5, quant_attention=True)


def _module(quantize, dim=64, heads=4):
    module = AttentionalPropagation(dim, heads, use_pallas=True, quantize=quantize).eval()
    gen = torch.Generator().manual_seed(5)
    for sub in module.modules():
        if hasattr(sub, "reset_parameters"):
            sub.reset_parameters(gen)
    return module


def test_module_calibration_from_the_other_mode_raises():
    """A buffer calibrated under int8_static (5 sites) loaded into an
    int8_static_attn layer must raise, not serve with missing sites."""
    x = torch.randn(2, 40, 64, generator=torch.Generator().manual_seed(0))
    five = _module("int8_static")
    five.calibrating = True
    with torch.no_grad():
        five(x, x)
    assert (five.act_absmax > 0).all() and five.act_absmax.shape == (5,)
    eight = _module("int8_static_attn")
    state = five.state_dict()
    eight.act_absmax = state["act_absmax"].clone()  # what a permissive loader would do
    with pytest.raises(ValueError, match="re-run calibration"):
        with torch.no_grad():
            eight(x, x)
    with pytest.raises(RuntimeError, match="size mismatch"):
        _module("int8_static_attn").load_state_dict(state)


def test_module_refuses_to_serve_uncalibrated():
    x = torch.randn(1, 16, 64, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="uncalibrated"):
        with torch.no_grad():
            _module("int8_static")(x, x)


def test_module_int8_close_to_composed():
    gen = torch.Generator().manual_seed(0)
    n, dim = 512, 64
    composed = AttentionalPropagation(dim, 4).eval()
    for module in composed.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(gen)
    quantized = _module("int8", dim)
    quantized.load_state_dict(composed.state_dict())
    x_q, x_kv = torch.randn(2, n, dim, generator=gen), torch.randn(2, n, dim, generator=gen)
    kv_mask = torch.arange(n)[None] < torch.tensor([400, n])[:, None]
    with torch.no_grad():
        ref = composed(x_q, x_kv, None, kv_mask)
        out = quantized(x_q, x_kv, None, kv_mask)
    # the JAX package's bar (test_pallas_kernels.py:644)
    assert _rel(out.numpy(), ref.numpy()) < 0.03


MODEL = dict(descriptor_dim=64, pe_hidden_layers_sizes=(32,), side_info_size=1, num_stages=2,
             num_heads=4, otp_num_iters=8, residual=True, use_pallas=True)


@pytest.fixture(scope="module")
def served():
    """A 2-stage model at N=512 (the JAX package's decode-agreement setting)
    and its f32 decode."""
    batch = SyntheticHomographyPairs(num_keypoints=512, descriptor_dim=64).sample(
        torch.Generator().manual_seed(0), 2
    )
    inputs = superglue_inputs(batch)
    model = SuperGlue(SuperGlueConfig(**MODEL), device="cpu",
                      generator=torch.Generator().manual_seed(1)).eval()
    with torch.no_grad():
        ref = matching.decode_matches(model(**inputs)["scores"], mask0=inputs["mask0"],
                                      mask1=inputs["mask1"])["matches0"]
    return inputs, model.state_dict(), ref


@pytest.mark.parametrize("mode", ["int8", "int8_static", "int8_static_attn"])
def test_model_calibrate_serve_decode_agreement(served, mode):
    inputs, state, ref = served
    model = SuperGlue(SuperGlueConfig(**MODEL, quantize=mode), device="cpu").eval()
    model.load_state_dict(state, strict=False)
    layers = [layer.module for layer in model.attention_gnn.layers]
    if mode == "int8":
        with pytest.raises(ValueError, match="nothing to calibrate"):
            model.calibrate(**inputs)
    else:
        with pytest.raises(RuntimeError, match="uncalibrated"):
            with torch.no_grad():
                model(**inputs)
        model.calibrate(**inputs)
        sites = 8 if mode.endswith("_attn") else 5
        assert all(l.act_absmax.shape == (sites,) and (l.act_absmax > 0).all() for l in layers)
        assert not any(l.calibrating for l in layers)
    with torch.no_grad():
        out = model(**inputs)["scores"]
    got = matching.decode_matches(out, mask0=inputs["mask0"], mask1=inputs["mask1"])["matches0"]
    # the JAX package's serving-quality bar (test_pallas_kernels.py:683, 847, 895)
    assert (got == ref).float().mean().item() >= 0.97


def test_static_serving_matches_jax_with_its_calibration_carried_across():
    """JAX calibrates (mutable int8_calib) and serves int8_static through its
    Pallas kernel; the port loads params, statistics and the calibration
    vector and serves the same scores."""
    cfg_kwargs = dict(MODEL, quantize="int8_static", decode_stats=True)
    batch = SyntheticHomographyPairs(num_keypoints=128, descriptor_dim=64).sample(
        torch.Generator().manual_seed(3), 2
    )
    inputs = superglue_inputs(batch)
    inputs["mask1"] = torch.arange(128)[None] < torch.tensor([128, 90])[:, None]
    jinputs = {k: jnp.asarray(v.numpy()) for k, v in inputs.items()}
    jmodel = JaxSuperGlue(JaxConfig(**cfg_kwargs))
    force_fused_dispatch(True)
    try:
        variables = JaxSuperGlue(JaxConfig(**dict(cfg_kwargs, quantize=None))).init(
            jax.random.key(1), **jinputs)
        _, calib = jmodel.apply(variables, **jinputs, mutable=["int8_calib"])
        variables = {**variables, **dict(calib)}
        ref = jmodel.apply(variables, **jinputs)
    finally:
        force_fused_dispatch(False)
    cfg = SuperGlueConfig(**cfg_kwargs)
    model = SuperGlue(cfg, device="cpu").eval()
    model.load_state_dict(superglue_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables), cfg))
    first = model.attention_gnn.layers[0].module.act_absmax
    np.testing.assert_array_equal(
        first.numpy(), np.asarray(variables["int8_calib"]["attention_gnn"]["self_0"]["act_absmax"])
    )
    with torch.no_grad():
        out = model(**inputs)
    valid = (torch.cat([inputs["mask0"], torch.ones(2, 1, dtype=torch.bool)], 1)[:, :, None]
             & torch.cat([inputs["mask1"], torch.ones(2, 1, dtype=torch.bool)], 1)[:, None, :]).numpy()
    # 4 int8 layers on one shared grid; bf16 attention rounding flips single
    # int8 roundings, which moves log_P by a few hundredths of a nat at most
    diff = np.abs(out["scores"].numpy() - np.asarray(ref["scores"]))[valid]
    assert diff.max() <= 0.05
    agree = (out["decode_indices0"].numpy() == np.asarray(ref["decode_indices0"]))[inputs["mask0"].numpy()]
    assert agree.mean() >= 0.97


def test_static_calibration_over_several_passes_matches_jax(monkeypatch):
    """Three calibration passes on three batches: JAX applies the model three
    times with ``mutable=["int8_calib"]`` (the running max carried from pass
    to pass), the port calls ``calibrate`` three times. Every layer's
    act_absmax agrees (1e-5 relative: the passes serve through the dynamic
    path, whose roundings feed the next layer's sites), and so does the
    static forward that follows, within the bars of the test above. JAX's
    Sinkhorn runs its plain reference here (the int8 layers run its Pallas
    kernels in interpret mode), which halves the test's compile time."""
    monkeypatch.setattr(jax_superglue, "_pallas_ot_shape", lambda S: False)
    cfg_kwargs = dict(MODEL, num_stages=1, quantize="int8_static", decode_stats=True)
    cfg = SuperGlueConfig(**cfg_kwargs)
    batches = [superglue_inputs(SyntheticHomographyPairs(num_keypoints=32, descriptor_dim=64).sample(
        torch.Generator().manual_seed(seed), 2)) for seed in (5, 6, 7)]
    model = SuperGlue(cfg, device="cpu", generator=torch.Generator().manual_seed(1)).eval()
    variables = jax.tree_util.tree_map(jnp.asarray, jax_variables_from_state_dict(model.state_dict(), cfg))
    jmodel = JaxSuperGlue(JaxConfig(**cfg_kwargs))
    calibrate = jax.jit(lambda v, x: jmodel.apply(v, **x, mutable=["int8_calib"])[1])
    force_fused_dispatch(True)
    try:
        for inputs in batches:
            jinputs = {k: jnp.asarray(v.numpy()) for k, v in inputs.items()}
            variables = {**variables, **dict(calibrate(variables, jinputs))}
            model.calibrate(**inputs)
        ref = jax.jit(jmodel.apply)(variables, **jinputs)
    finally:
        force_fused_dispatch(False)
    names = [f"{kind}_{i}" for i in range(cfg.num_stages) for kind in ("self", "cross")]
    for name, layer in zip(names, model.attention_gnn.layers):
        want = np.asarray(variables["int8_calib"]["attention_gnn"][name]["act_absmax"])
        assert (want > 0).all()
        np.testing.assert_allclose(layer.module.act_absmax.numpy(), want, rtol=1e-5, err_msg=name)
    with torch.no_grad():
        out = model(**inputs)
    mask0, mask1 = inputs["mask0"], inputs["mask1"]
    valid = (torch.cat([mask0, torch.ones(2, 1, dtype=torch.bool)], 1)[:, :, None]
             & torch.cat([mask1, torch.ones(2, 1, dtype=torch.bool)], 1)[:, None, :]).numpy()
    assert np.abs(out["scores"].numpy() - np.asarray(ref["scores"]))[valid].max() <= 0.05
    agree = (out["decode_indices0"].numpy() == np.asarray(ref["decode_indices0"]))[mask0.numpy()]
    assert agree.mean() >= 0.97


@pytest.mark.parametrize("attention,use_pallas,expect", [
    ("softmax", False, True), ("linear", True, True), ("softmax", True, False),
])
def test_quantize_that_cannot_run_warns(attention, use_pallas, expect):
    cfg = SuperGlueConfig(descriptor_dim=64, pe_hidden_layers_sizes=(32,), num_stages=1,
                          otp_num_iters=4, attention=attention, use_pallas=use_pallas, quantize="int8")
    model = SuperGlue(cfg, device="cpu").eval()
    batch = SyntheticHomographyPairs(num_keypoints=32, descriptor_dim=64).sample(
        torch.Generator().manual_seed(0), 1
    )
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.no_grad():
            out = model(**superglue_inputs(batch))
    assert torch.isfinite(out["scores"]).all()
    assert bool([w for w in caught if "int8 serving path" in str(w.message)]) == expect

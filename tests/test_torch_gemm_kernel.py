"""The port's dense GEMMs (ops/kernels/gemm_kernel.py): their plain versions
against the JAX expressions they stand for in the TPU layer kernels
(openglue_tpu/ops/pallas/gnn_layer_kernel.py: ``_dot`` :100 and
``_layer_kernel``'s out projection, concat, ReLU with the folded BatchNorm and
residual :250-258; the weight gradients as ``dot_general`` over the rows,
:690), at small ragged shapes. The CUDA kernels' own tests are in
test_torch_cuda.py.

Tolerances: f32 results to 1e-5 of the largest entry (the summation order
differs); bf16 results to one bf16 ulp of the largest entry (2^-8 of it), since
an f32 sum in another order can move one rounding to bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglue_tpu_torch.ops import kernels
from openglue_tpu_torch.ops.kernels import gemm_kernel as gk

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _dot(a, b):  # gnn_layer_kernel.py::_dot
    return jax.lax.dot_general(a, b, dimension_numbers=(((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)


def _case(rows, n_out, k, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    return dict(a=f(rows, k), w=f(n_out, k, scale=k**-0.5), b=f(n_out), x=f(rows, n_out),
                scale=1.0 + 0.1 * f(n_out), shift=0.1 * f(n_out))


def _jax_gemm(c, epilogue, jdt, use_offset=False):
    """The epilogue lines of _layer_kernel on a . w^T + b (w in torch layout)."""
    y = _dot(jnp.asarray(c["a"]).astype(jdt), jnp.asarray(c["w"].T).astype(jdt)) + jnp.asarray(c["b"])
    x = jnp.asarray(c["x"]).astype(jdt)
    if epilogue == "bias":
        return y.astype(jdt)
    if epilogue == "bias_f32":
        return y
    if epilogue == "concat":
        msg = y.astype(jdt)
        return jnp.concatenate([x - msg, msg] if use_offset else [x, msg], axis=1)
    if epilogue == "relu_affine":
        return (jax.nn.relu(y) * jnp.asarray(c["scale"]) + jnp.asarray(c["shift"])).astype(jdt)
    if epilogue == "relu":
        return jax.nn.relu(y).astype(jdt)
    return (x.astype(jnp.float32) + y).astype(jdt)  # residual


def _close(got: torch.Tensor, want, dtype):
    want = torch.from_numpy(np.array(jnp.asarray(want).astype(jnp.float32)))
    scale = want.abs().max().item()
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0**-8 * scale
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=0)


def _t(arr, dtype):
    return torch.from_numpy(arr).to(dtype)


@pytest.mark.parametrize("rows,n_out,k", [(37, 64, 32), (300, 128, 96)])
@pytest.mark.parametrize("epilogue", gk.EPILOGUES)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_gemm_plain_matches_jax(rows, n_out, k, epilogue, dtype_name):
    dtype, jdt = DTYPES[dtype_name]
    c = _case(rows, n_out, k)
    use_offset = epilogue == "concat" and rows == 300
    before = gk.counter.count
    got = gk.gemm(_t(c["a"], dtype), _t(c["w"], dtype), torch.from_numpy(c["b"]), epilogue,
                  x=_t(c["x"], dtype), scale=torch.from_numpy(c["scale"]), shift=torch.from_numpy(c["shift"]),
                  use_offset=use_offset)
    assert gk.counter.count == before  # a CPU tensor takes the plain version
    want_dtype = torch.float32 if epilogue == "bias_f32" else dtype
    assert got.dtype == want_dtype
    assert got.shape == (rows, 2 * n_out if epilogue == "concat" else n_out)
    _close(got, _jax_gemm(c, epilogue, jdt, use_offset), dtype)


def test_gemm_plain_relu_keeps_nan():
    c = _case(37, 64, 32)
    c["a"][5, 3] = np.nan
    for epilogue in ("relu", "relu_affine"):
        got = gk.gemm_plain(torch.from_numpy(c["a"]), torch.from_numpy(c["w"]), torch.from_numpy(c["b"]), epilogue,
                            scale=torch.from_numpy(c["scale"]), shift=torch.from_numpy(c["shift"]))
        assert torch.isnan(got[5]).all() and torch.isfinite(got[torch.arange(37) != 5]).all()


@pytest.mark.parametrize("k_split", [0, 32])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_gemm_plain_kn_matches_jax(k_split, dtype_name):
    """The input-gradient form: a . w for w stored [k, n_out], with the rows
    of w from k_split on taken from w2 (dx_kv = [dK | dV] [Wk; Wv])."""
    dtype, jdt = DTYPES[dtype_name]
    rng = np.random.default_rng(1)
    rows, n_out, k = 300, 128, 96
    a = rng.standard_normal((rows, k)).astype(np.float32)
    w = (rng.standard_normal((k, n_out)) * k**-0.5).astype(np.float32)
    if k_split:
        got = gk.gemm(_t(a, dtype), _t(w[:k_split], dtype), None, kn=True, w2=_t(w[k_split:], dtype),
                      k_split=k_split)
    else:
        got = gk.gemm(_t(a, dtype), _t(w, dtype), None, kn=True)
    _close(got, _dot(jnp.asarray(a).astype(jdt), jnp.asarray(w).astype(jdt)).astype(jdt), dtype)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_gemm_plain_stacked_weight_matches_jax(dtype_name):
    """The k+v projection: output columns from `split` on take w2 and bias2."""
    dtype, jdt = DTYPES[dtype_name]
    rng = np.random.default_rng(2)
    rows, d, k = 37, 64, 64
    a = rng.standard_normal((rows, k)).astype(np.float32)
    wk, wv = [(rng.standard_normal((d, k)) * k**-0.5).astype(np.float32) for _ in range(2)]
    bk, bv = [rng.standard_normal(d).astype(np.float32) for _ in range(2)]
    got = gk.gemm(_t(a, dtype), _t(wk, dtype), torch.from_numpy(bk), w2=_t(wv, dtype), bias2=torch.from_numpy(bv),
                  split=d)
    want = _dot(jnp.asarray(a).astype(jdt), jnp.asarray(np.concatenate([wk, wv]).T).astype(jdt))
    _close(got, (want + jnp.asarray(np.concatenate([bk, bv]))).astype(jdt), dtype)


@pytest.mark.parametrize("rows", [(37, 300), (300, 300, 37, 1)])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_tn_gemm_plain_matches_jax(rows, dtype_name):
    """The weight gradients x^T y over each problem's rows, f32 out."""
    dtype, jdt = DTYPES[dtype_name]
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((r, 64)).astype(np.float32) for r in rows]
    ys = [rng.standard_normal((r, 128)).astype(np.float32) for r in rows]
    before = gk.tn_counter.count
    got = gk.tn_gemm([_t(x, dtype) for x in xs], [_t(y, dtype) for y in ys])
    assert gk.tn_counter.count == before
    for g, x, y in zip(got, xs, ys):
        assert g.dtype == torch.float32 and g.shape == (64, 128)
        want = jax.lax.dot_general(jnp.asarray(x).astype(jdt), jnp.asarray(y).astype(jdt),
                                   dimension_numbers=(((0,), (0,)), ((), ())), preferred_element_type=jnp.float32)
        _close(g, want, torch.float32)  # f32 sums of products of the same operands


def test_layer_gemm_counts():
    """The f32 GEMMs are counted by the C code where it launches them, in
    every library whose source includes gemm.cuh: the layer kernels (K1, K4,
    K5, K6, K8) and the GEMM entry. Before the libraries are loaded the
    counts read 0, and reading or resetting them builds nothing."""
    assert kernels.libraries_including("gemm.cuh") == (
        "gnn_layer", "message_forward", "message_backward", "gnn_layer_features", "train_half", "gemm")
    assert kernels.libraries_including("tn_gemm.cuh") == ("message_backward", "gemm")
    loaded = dict(kernels._libs)
    gk.counter.reset()
    gk.tn_counter.reset()
    assert (gk.counter.count, gk.tn_counter.count) == (0, 0)
    assert kernels._libs == loaded


def test_bf16_gemm_counts():
    """The bf16 GEMM is counted by the C code too (``bf16_counter``, from the
    same libraries), and so is the bf16 attention (``attention.cuh``: the
    layer kernels that attend and the attention entry); both read 0 before
    the libraries are loaded. A CPU call takes the plain version and counts
    nothing."""
    from openglue_tpu_torch.ops.kernels import attention_kernel as ak

    assert gk.bf16_counter.header == "gemm.cuh" and gk.bf16_counter.which == 2
    assert kernels.libraries_including("attention.cuh") == (
        "gnn_layer", "message_forward", "gnn_layer_int8", "attention", "train_half")
    loaded = dict(kernels._libs)
    gk.bf16_counter.reset()
    ak.bf16_counter.reset()
    assert (gk.bf16_counter.count, ak.bf16_counter.count) == (0, 0)
    assert kernels._libs == loaded
    a, w = torch.randn(5, 64).bfloat16(), torch.randn(64, 64).bfloat16()
    assert torch.equal(gk.gemm(a, w), gk.gemm_plain(a, w))
    assert gk.bf16_counter.count == 0 and kernels._libs == loaded

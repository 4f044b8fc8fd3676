"""The port's CUDA kernels against their plain PyTorch versions on a card.

This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda

Without a card every test skips (the decision is made inside each test).
"""

import pytest
import torch

from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_offset", [False, True])
def test_layer_kernel_matches_plain(dtype, use_offset):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(1)
    dim, d2 = 256, 512

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    w = glk.PropagationWeights(
        r(dim, dim, scale=dim**-0.5).to(dtype), r(dim), r(dim, dim, scale=dim**-0.5).to(dtype), r(dim),
        r(dim, dim, scale=dim**-0.5).to(dtype), r(dim), r(dim, dim, scale=dim**-0.5).to(dtype), r(dim),
        r(d2, d2, scale=d2**-0.5).to(dtype), r(d2), 1.0 + 0.1 * r(d2), 0.1 * r(d2),
        r(dim, d2, scale=d2**-0.5).to(dtype), r(dim),
    )
    x_q = r(2, 300, dim).to(dtype)
    x_kv = r(2, 257, dim).to(dtype)
    mask = torch.arange(257, device=dev)[None] < torch.tensor([200, 0], device=dev)[:, None]
    before = glk.counter.count
    with torch.no_grad():
        out = glk.fused_attention_propagation(x_q, x_kv, mask, w, 4, use_offset)
        ref = glk.layer_plain(x_q, x_kv, mask, w, 4, use_offset)
    torch.cuda.synchronize()
    assert glk.counter.count == before + 1
    # f32: summation order only; bf16: two ulps of the largest output
    # (rounding flips from the online softmax and the accumulation order)
    atol = 1e-4 if dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("k_dtype", [torch.float32, torch.bfloat16])
def test_sinkhorn_kernel_matches_plain(k_dtype):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(0)
    batch, m, n = 3, 300, 277
    scores = torch.randn(batch, m, n, generator=gen, device=dev) * 3
    mask0 = torch.rand(batch, m, generator=gen, device=dev) > 0.2
    mask1 = torch.rand(batch, n, generator=gen, device=dev) > 0.2
    rows, cp = m + 1, sk._round_up(n + 1, sk.COL_ALIGN)
    dust = torch.tensor(1.0, device=dev)
    M_pad = sk.build_padded_otp_matrix(scores, dust, 1.0, mask0, mask1, rows, cp)
    la, lb, _ = sk.otp_marginals(batch, m, n, mask0, mask1, dev)
    la, lb = sk.padded_marginals(la, lb, rows, cp)
    before = sk.counter.count
    u = sk.sinkhorn_scale(M_pad, la, lb, 20, k_dtype)
    assert sk.counter.count == before + 1
    ref = sk.sinkhorn_scale_plain(M_pad, la, lb, 20, k_dtype)
    torch.cuda.synchronize()
    live = la > -1e8  # masked rows sit near -1e9, where one f32 ulp is 64
    # the same f32 recursion and storage rounding; summation order differs
    torch.testing.assert_close(u[live], ref[live], atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_kernels_raise_instead_of_falling_back():
    dev = _cuda()
    M_pad = torch.zeros(1, 9, 12, device=dev)  # 12 columns: not a multiple of 8
    la, lb = torch.zeros(1, 9, device=dev), torch.zeros(1, 12, device=dev)
    with pytest.raises(ValueError):
        sk.sinkhorn_scale(M_pad, la, lb, 3, torch.float32)

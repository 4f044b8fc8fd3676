"""The shape rules around the port's kernels, as plain functions, on the CPU:
the head widths the attention kernels take, and the Sinkhorn backward's route
by column count, with the gradient of the autograd route past the adjoint
kernel's columns held against the JAX package's VJP of the same loop."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openglue_tpu.ops import sinkhorn as jax_sinkhorn
from openglue_tpu_torch.ops import kernels
from openglue_tpu_torch.ops import sinkhorn as sinkhorn_ref
from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk


@pytest.mark.parametrize("head_dim", [32, 64])
def test_head_widths_the_kernels_take(head_dim):
    kernels.require_head_width(head_dim)
    assert kernels.require_heads(4 * head_dim, 4) == head_dim


@pytest.mark.parametrize("dim,heads", [(64, 4), (192, 4), (256, 2), (128, 3)])
def test_other_head_widths_are_refused_by_name(dim, heads):
    with pytest.raises(ValueError, match="heads of width 32 or 64|does not split"):
        kernels.require_heads(dim, heads)


def test_sinkhorn_backward_route_by_column_count():
    assert sk.backward_route(8) == "kernel"
    assert sk.backward_route(sk.ADJOINT_MAX_COLS) == "kernel"
    assert sk.backward_route(sk.ADJOINT_MAX_COLS + sk.COL_ALIGN) == "autograd"
    # N=1024 takes the kernel, N=2048 (the pretraining fixture) the autograd route
    assert sk.backward_route(sk._round_up(1025, sk.COL_ALIGN)) == "kernel"
    assert sk.backward_route(sk._round_up(2049, sk.COL_ALIGN)) == "autograd"


def test_gradient_past_the_adjoint_columns_matches_jax():
    """B=1, m=8, n=1600 (1608 padded columns): the port's log_optimal_transport
    differentiates through the autograd route, counted as such, against
    jax.vjp of the JAX package's log-domain loop on the same inputs."""
    rng = np.random.default_rng(3)
    m, n = 8, 1600
    scores = rng.standard_normal((1, m, n)).astype(np.float32) * 2
    mask0 = np.arange(m)[None] < 6
    mask1 = np.arange(n)[None] < 1500
    g = rng.standard_normal((1, m + 1, n + 1)).astype(np.float32)
    assert sk.backward_route(sk._round_up(n + 1, sk.COL_ALIGN)) == "autograd"

    s = torch.from_numpy(scores).requires_grad_()
    d = torch.tensor(0.7, requires_grad=True)
    before = sk.autograd_counter.count, sk.adjoint_counter.count
    out = sk.log_optimal_transport(s, d, 20, 1.0, torch.from_numpy(mask0), torch.from_numpy(mask1))
    out.backward(torch.from_numpy(g))
    assert (sk.autograd_counter.count - before[0], sk.adjoint_counter.count - before[1]) == (1, 0)

    _, vjp = jax.vjp(
        lambda s_, d_: jax_sinkhorn.log_optimal_transport(s_, d_, 20, 1.0, jnp.asarray(mask0), jnp.asarray(mask1)),
        jnp.asarray(scores), jnp.asarray(0.7, jnp.float32),
    )
    ds, dd = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    # the same f32 loop and its VJP: summation order only
    np.testing.assert_allclose(s.grad.numpy(), ds, rtol=0, atol=1e-5 * np.abs(ds).max())
    # the dustbin's gradient sums the dS of its m + n + 1 entries, which
    # cancel: 1e-5 of the sum of their magnitudes
    S_inner, S_dust, la_inner, la_dust, lb, _ = sinkhorn_ref.build_masked_otp_inputs(
        s.detach(), d.detach(), 1.0, torch.from_numpy(mask0), torch.from_numpy(mask1))
    S_aug = torch.cat([S_inner, S_dust], dim=1).requires_grad_()
    la = torch.cat([la_inner, la_dust[:, None]], dim=1)
    sinkhorn_ref.log_sinkhorn(la, lb, S_aug, 20, 1.0).backward(torch.from_numpy(g))
    terms = torch.cat([S_aug.grad[0, m, :], S_aug.grad[0, :m, n]]).abs().sum().item()
    np.testing.assert_allclose(d.grad.numpy(), dd, rtol=0, atol=1e-5 * terms)

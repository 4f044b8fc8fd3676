"""The port's Sinkhorn backward (the adjoint factors' plain version and the
VJP glue of ops/kernels/sinkhorn_kernel.py) against ``jax.grad`` of the JAX
package's kernel path, whose custom VJP runs the Pallas adjoint kernel in
interpret mode on the CPU. The CUDA kernel's own tests are in
test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglue_tpu.ops.pallas import sinkhorn_kernel as jax_sk
from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk


def _grads(batch, m, n, counts0, counts1, num_iters, seed, dustbin=0.8, reg=1.0):
    rng = np.random.default_rng(seed)
    scores = (rng.standard_normal((batch, m, n)) * 2).astype(np.float32)
    mask0 = None if counts0 is None else np.arange(m)[None] < np.asarray(counts0)[:, None]
    mask1 = None if counts1 is None else np.arange(n)[None] < np.asarray(counts1)[:, None]
    rows = np.ones((batch, m), bool) if mask0 is None else mask0
    cols = np.ones((batch, n), bool) if mask1 is None else mask1
    valid = (np.concatenate([rows, np.ones((batch, 1), bool)], 1)[:, :, None]
             & np.concatenate([cols, np.ones((batch, 1), bool)], 1)[:, None, :])

    def jax_loss(s, d):
        out = jax_sk.log_optimal_transport(
            s, d, num_iters=num_iters, reg=reg, interpret=True,
            mask0=None if mask0 is None else jnp.asarray(mask0),
            mask1=None if mask1 is None else jnp.asarray(mask1),
        )
        return jnp.sum(jnp.where(valid, out, 0.0) ** 2)

    ref = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(scores), jnp.asarray(dustbin))
    s = torch.from_numpy(scores).requires_grad_()
    d = torch.tensor(dustbin, requires_grad=True)
    out = sk.log_optimal_transport(
        s, d, num_iters=num_iters, reg=reg,
        mask0=None if mask0 is None else torch.from_numpy(mask0),
        mask1=None if mask1 is None else torch.from_numpy(mask1),
    )
    (torch.where(torch.from_numpy(valid), out, 0.0) ** 2).sum().backward()
    return (s.grad.numpy(), float(d.grad)), (np.asarray(ref[0]), float(ref[1]))


@pytest.mark.parametrize(
    "batch,m,n,counts0,counts1,num_iters,reg",
    [
        (2, 24, 30, [18, 24], [30, 22], 10, 1.0),  # masked (test_pallas_kernels.py:254)
        (1, 16, 20, None, None, 1, 1.0),  # T = 1: the first adjoint step is the loop
        (2, 33, 41, None, None, 20, 0.7),  # unmasked, the flagship iteration count
    ],
)
def test_gradients_match_pallas_adjoint(batch, m, n, counts0, counts1, num_iters, reg):
    (ds, dd), (ref_ds, ref_dd) = _grads(batch, m, n, counts0, counts1, num_iters, 0, reg=reg)
    # the JAX package's bar for its adjoint kernel against the XLA VJP
    # (test_pallas_kernels.py:279): the same f32 recursion, summation order
    np.testing.assert_allclose(ds, ref_ds, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(dd, ref_dd, rtol=1e-5, atol=1e-4)


def test_masked_entries_get_no_gradient():
    (ds, _), _ = _grads(2, 12, 15, [7, 12], [15, 9], 5, 1)
    assert np.all(ds[0, 7:] == 0) and np.all(ds[1, :, 9:] == 0)
    assert np.abs(ds[0, :7]).max() > 0


def test_adjoint_factors_rebuild_the_cotangent_sums():
    """At T = 1 the factors reproduce the first reverse step exactly: P[0] is
    u, Q[0] = colsum(g) / r, and dm's row sums vanish where a row's mass is
    fixed."""
    rng = np.random.default_rng(2)
    batch, rows, cols = 1, 9, 16
    M = torch.from_numpy(rng.standard_normal((batch, rows, cols)).astype(np.float32))
    la = torch.full((batch, rows), -np.log(20.0), dtype=torch.float32)
    lb = torch.full((batch, cols), -np.log(20.0), dtype=torch.float32)
    g = torch.from_numpy(rng.standard_normal((batch, rows, cols)).astype(np.float32))
    rmax = M.amax(dim=2)
    P, Q = sk.sinkhorn_adjoint(M, la, lb, rmax, g.sum(2), g.sum(1), 1)
    assert P.shape == (batch, 2, rows) and Q.shape == (batch, 2, cols)
    K = torch.exp(M - rmax[:, :, None])
    u = torch.exp(la) / (K @ torch.ones(batch, cols, 1))[..., 0]
    r = (u[:, None, :] @ K)[:, 0]
    torch.testing.assert_close(P[:, 0], u)
    torch.testing.assert_close(Q[:, 0], g.sum(1) / r)
    torch.testing.assert_close(Q[:, 1], torch.ones(batch, cols))


def test_cpu_backward_counts_no_launch():
    before = sk.counter.count, sk.adjoint_counter.count
    _grads(1, 8, 8, None, None, 3, 3)
    assert (sk.counter.count, sk.adjoint_counter.count) == before

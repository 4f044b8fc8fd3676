"""The port's scale-domain Sinkhorn (ops/kernels/sinkhorn_kernel.py) against the
JAX Pallas Sinkhorn kernels, run in interpret mode on the CPU. The CUDA
kernel's own test is in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openglue_tpu.ops import sinkhorn as jax_sinkhorn
from openglue_tpu.ops.pallas import sinkhorn_kernel as jax_sk
from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk


def _inputs(seed, batch, m, n, counts0=None, counts1=None):
    rng = np.random.default_rng(seed)
    scores = (rng.standard_normal((batch, m, n)) * 2).astype(np.float32)
    mask0 = None if counts0 is None else np.arange(m)[None] < np.asarray(counts0)[:, None]
    mask1 = None if counts1 is None else np.arange(n)[None] < np.asarray(counts1)[:, None]
    return scores, mask0, mask1


def _jnp(x):
    return None if x is None else jnp.asarray(x)


def _torch(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize(
    "batch,m,n,counts0,counts1",
    [
        (1, 60, 70, None, None),  # the single-element TPU kernel
        (2, 40, 50, [30, 40], [50, 20]),  # the paired kernel, even B
        (3, 33, 47, [33, 10, 25], [47, 47, 0]),  # odd B; a fully masked side
    ],
)
def test_plain_matches_pallas_kernel(batch, m, n, counts0, counts1):
    scores, mask0, mask1 = _inputs(0, batch, m, n, counts0, counts1)
    ref = jax_sk.log_optimal_transport(
        jnp.asarray(scores), jnp.asarray(1.1), num_iters=15, reg=0.8,
        mask0=_jnp(mask0), mask1=_jnp(mask1), interpret=True,
    )
    out = sk.log_optimal_transport(
        torch.from_numpy(scores), torch.tensor(1.1), num_iters=15, reg=0.8,
        mask0=_torch(mask0), mask1=_torch(mask1),
    )
    assert out.shape == (batch, m + 1, n + 1)
    # the same f32 recursion; only the matvec summation order differs
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_plain_matches_log_domain_reference():
    scores, mask0, mask1 = _inputs(1, 2, 40, 52, [40, 25], [37, 52])
    ref = jax_sinkhorn.log_optimal_transport(
        jnp.asarray(scores), jnp.asarray(0.7), num_iters=10, mask0=_jnp(mask0), mask1=_jnp(mask1)
    )
    out = sk.log_optimal_transport(
        torch.from_numpy(scores), torch.tensor(0.7), num_iters=10,
        mask0=_torch(mask0), mask1=_torch(mask1),
    )
    valid = np.concatenate([mask0, np.ones((2, 1), bool)], 1)[:, :, None] & np.concatenate(
        [mask1, np.ones((2, 1), bool)], 1
    )[:, None, :]
    # the scale-domain and log-domain recursions agree algebraically
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(ref)[valid], atol=1e-5)


def test_bf16_k_matches_blocked_pallas_kernel():
    """bf16 K storage against the JAX streaming kernel's bf16 K (the N=2048
    path), both against the log-domain reference."""
    scores, _, _ = _inputs(2, 2, 60, 70)
    n, m = 60, 70
    S_aug = jax_sinkhorn.augment_scores(jnp.asarray(scores), jnp.asarray(1.1))
    norm = -np.log(np.float32(n + m))
    log_a = np.full((2, n + 1), norm, np.float32)
    log_a[:, -1] += np.log(np.float32(m))
    log_b = np.full((2, m + 1), norm, np.float32)
    log_b[:, -1] += np.log(np.float32(n))
    jax_bf16 = np.asarray(
        jax_sk._log_sinkhorn_blocked(
            jnp.asarray(log_a), jnp.asarray(log_b), S_aug, num_iters=12, reg=1.0,
            interpret=True, r_blk=16, k_dtype=jnp.bfloat16,
        )
    ) - norm
    ref = np.asarray(jax_sinkhorn.log_optimal_transport(jnp.asarray(scores), jnp.asarray(1.1), num_iters=12))
    out = sk.log_optimal_transport(
        torch.from_numpy(scores), torch.tensor(1.1), num_iters=12, k_dtype=torch.bfloat16
    ).numpy()
    # bf16 K (8-bit mantissa, entries in [0, 1]) perturbs u by ~1e-2 nats at
    # most (the JAX package's own bound); decode structure is kept
    for got in (out, jax_bf16):
        np.testing.assert_allclose(got, ref, atol=0.05)
    np.testing.assert_allclose(out, jax_bf16, atol=0.05)
    agree = (out.argmax(axis=2) == jax_bf16.argmax(axis=2)).mean()
    assert agree >= 0.99
    assert (out.argmax(axis=2) == ref.argmax(axis=2)).mean() >= 0.99


@pytest.mark.parametrize("n", [1024, 1280, 2048])
def test_storage_rule_matches_fits_vmem(n):
    rows = cols = n + 1
    assert sk.fits_vmem(rows, cols) == jax_sk.fits_vmem(rows, cols)
    expected = torch.float32 if jax_sk.fits_vmem(rows, cols) else torch.bfloat16
    assert sk.k_storage_dtype(rows, cols) == expected
    assert sk.k_storage_dtype(rows, cols) == (torch.float32 if n == 1024 else torch.bfloat16)


def test_build_padded_otp_matrix_matches_jax():
    scores, mask0, mask1 = _inputs(3, 2, 9, 13, [9, 4], [2, 13])
    ref = jax_sk.build_padded_otp_matrix(
        jnp.asarray(scores), jnp.asarray(0.3), 0.5, _jnp(mask0), _jnp(mask1), 16, 24
    )
    out = sk.build_padded_otp_matrix(
        torch.from_numpy(scores), torch.tensor(0.3), 0.5, _torch(mask0), _torch(mask1), 16, 24
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_cpu_run_does_not_count_a_launch():
    scores, _, _ = _inputs(4, 1, 8, 8)
    before = sk.counter.count
    sk.log_optimal_transport(torch.from_numpy(scores), torch.tensor(1.0), num_iters=3)
    assert sk.counter.count == before


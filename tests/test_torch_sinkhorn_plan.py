"""The launch plan of the on-chip Sinkhorn kernels (K2 forward, K3 adjoint),
on its Python mirror (``sinkhorn_kernel.launch_plan``) with the H100's
cluster capacities: at every shape ``chip_smoke.py`` runs and at the card
tests' shapes, every row is owned by exactly one CTA, no stripe passes a
CTA's on-chip budget, no more CTAs are in flight than the card has SMs, and
the batches that can fill the card do. The card tests hold the mirror
against the C plan (``tests/test_torch_cuda.py``)."""

import pytest
import torch

from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk

F32, BF16 = torch.float32, torch.bfloat16


def _padded(n):
    return sk._round_up(n + 1, sk.COL_ALIGN)


# (batch, rows, padded columns, K's storage): chip_smoke.py's K2 and K3
# shapes, then the card tests'
SMOKE = [
    (16, 1025, _padded(1024), F32),  # serving B=16
    (1, 1025, _padded(1024), F32),  # serving B=1
    (4, 2049, _padded(2048), BF16),  # serving B=4 N=2048, the SIFT shape
    (12, 1025, _padded(1024), F32),  # training B=12: K2 and K3
    (2, 2049, _padded(2048), BF16),  # the pretraining fixture
]
CARD = [
    (1, 2049, _padded(2048), BF16),  # one element over several clusters
    (20, 1025, _padded(1024), F32),  # more than one wave
    (1, 9, _padded(300), F32),  # fewer rows than CTAs
    (2, 864, 1032, F32),  # a stripe exactly at a CTA's shared-memory budget
    (2, 865, 1032, F32),  # one row past it: more CTAs, several clusters
    (3, 301, _padded(277), F32),  # a small batch with masked elements
    (1, 1024, 4096, BF16),  # bf16 K at the fused kernel's 4096 columns
    (1, 1537, 1536, F32),  # the adjoint at its 1536 columns, several clusters
]


def _plan(batch, rows, cols, k_dtype):
    plan = sk.launch_plan(batch, rows, cols, k_dtype)
    assert plan is not None, (batch, rows, cols, k_dtype)
    return plan


@pytest.mark.parametrize("batch,rows,cols,k_dtype", SMOKE + CARD)
def test_every_row_has_one_owner(batch, rows, cols, k_dtype):
    plan = _plan(batch, rows, cols, k_dtype)
    owned = [i for part in range(plan.ctas) for i in plan.rows_of(part, rows)]
    assert sorted(owned) == list(range(rows))
    assert plan.ctas == plan.cs * plan.groups and plan.ctas * plan.rows >= rows


@pytest.mark.parametrize("batch,rows,cols,k_dtype", SMOKE + CARD)
def test_no_stripe_passes_the_on_chip_budget(batch, rows, cols, k_dtype):
    plan = _plan(batch, rows, cols, k_dtype)
    assert plan.smem_bytes <= sk.SMEM_LIMIT
    assert plan.smem_rows * cols * sk._K_BYTES[k_dtype] <= plan.smem_bytes
    assert plan.smem_rows == plan.rows and plan.spill_rows == 0
    assert plan.workspace_bytes == plan.exchange_bytes
    assert plan.exchange_bytes == (2 * plan.slots * plan.groups * cols * 8 if plan.groups > 1 else 0)


@pytest.mark.parametrize("batch,rows,cols,k_dtype", SMOKE + CARD)
def test_no_more_ctas_in_flight_than_sms(batch, rows, cols, k_dtype):
    plan = _plan(batch, rows, cols, k_dtype)
    assert plan.slots * plan.ctas <= sk.H100_SMS
    assert plan.slots <= sk.H100_CLUSTER_CAPS[plan.cs.bit_length() - 1] * plan.cs // plan.ctas
    assert plan.waves == -(-batch // plan.slots)
    # several clusters per element only where every CTA is resident (cooperative)
    assert plan.cooperative == (plan.groups > 1)
    if plan.groups > 1:
        assert plan.grid == plan.slots * plan.ctas


@pytest.mark.parametrize("batch,rows,cols,k_dtype,least", [
    (1, 1025, _padded(1024), F32, 16),
    (4, 2049, _padded(2048), BF16, 100),
    (12, 1025, _padded(1024), F32, 100),
    (16, 1025, _padded(1024), F32, 100),
])
def test_the_plan_fills_the_card(batch, rows, cols, k_dtype, least):
    plan = _plan(batch, rows, cols, k_dtype)
    assert plan.slots * plan.ctas >= least
    assert plan.ctas > 8  # more than the one cluster of 8 CTAs per element before the redesign


def test_the_card_tests_reach_every_branch_of_the_plan():
    plans = {shape: _plan(*shape) for shape in CARD}
    assert any(p.groups > 1 for p in plans.values())  # an element over several clusters
    assert any(p.waves > 1 for p in plans.values())  # elements taken in turn
    assert plans[(1, 9, _padded(300), F32)].ctas > 9  # CTAs that own no row
    full, past = plans[(2, 864, 1032, F32)], plans[(2, 865, 1032, F32)]
    assert full.groups == 1 and full.ctas == 16 and past.groups > 1
    # the budget is tight: one more row would not fit beside the vectors
    assert full.smem_bytes + 1032 * 4 + 12 > sk.SMEM_LIMIT


def test_past_the_cards_on_chip_room_rows_spill_to_device_memory():
    plan = sk.launch_plan(1, 16000, 1032, F32)
    assert plan.spill_rows > 0 and plan.smem_rows + plan.spill_rows == plan.rows
    assert plan.slots * plan.ctas <= sk.H100_SMS
    assert plan.workspace_bytes >= plan.grid * plan.spill_rows * 1032 * 4


def test_a_card_with_no_room_places_nothing():
    assert sk.launch_plan(1, 1025, 1032, F32, sms=132, caps=(0, 0, 0, 0, 0)) is None

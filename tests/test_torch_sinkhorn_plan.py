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


# ----------------------------------------------------------- the wide plan (K2s)

def _widest(k_dtype, start):
    """The widest padded column count from ``start`` up whose square shape
    (one element, C - 7 rows) the wide plan places."""
    cols = start
    while sk.wide_launch_plan(1, cols + 1, cols + 8, k_dtype) is not None:
        cols += 8
    return cols


WIDEST = {BF16: _widest(BF16, 16000), F32: _widest(F32, 10000)}

# (batch, rows, padded columns, K's storage): the wide kernel's shapes in
# chip_smoke.py and the card tests (B=1 and B=4 N=4352, B=1 N=8192 with bf16
# K, f32 K at N=4352, the small shapes past each storage type's fused
# columns), a shape over several clusters with one-level exchange, and the
# widest shape the plan places with bf16 and f32 K
WIDE = [
    (1, 4353, _padded(4352), BF16),
    (4, 4353, _padded(4352), BF16),
    (1, 8193, _padded(8192), BF16),
    (1, 4353, _padded(4352), F32),
    (2, 131, _padded(4400), BF16),
    (2, 41, _padded(1700), F32),
    (2, 1537, _padded(1703), F32),
    (1, WIDEST[BF16] - 7, WIDEST[BF16], BF16),
    (1, WIDEST[F32] - 7, WIDEST[F32], F32),
]


def _wide(batch, rows, cols, k_dtype):
    plan = sk.wide_launch_plan(batch, rows, cols, k_dtype)
    assert plan is not None, (batch, rows, cols, k_dtype)
    return plan


def _tiers(plan, rows):
    """(row, tier) of every row an element's CTAs own: the first
    ``smem_rows`` of a CTA's stripe in shared memory, the rest spilled."""
    owned = []
    for part in range(plan.ctas):
        stripe = plan.rows_of(part, rows)
        owned += [(i, "shared" if k < plan.smem_rows else "spilled") for k, i in enumerate(stripe)]
    return owned


@pytest.mark.parametrize("batch,rows,cols,k_dtype", WIDE)
def test_wide_plan_gives_every_row_one_owner_in_one_tier(batch, rows, cols, k_dtype):
    plan = _wide(batch, rows, cols, k_dtype)
    owned = _tiers(plan, rows)
    assert sorted(i for i, _ in owned) == list(range(rows))
    assert plan.smem_rows + plan.spill_rows == plan.rows and plan.ctas * plan.rows >= rows
    spilled = [i for i, tier in owned if tier == "spilled"]
    assert len(spilled) <= plan.ctas * plan.spill_rows


@pytest.mark.parametrize("batch,rows,cols,k_dtype", WIDE)
def test_wide_plan_keeps_every_tier_in_its_budget(batch, rows, cols, k_dtype):
    plan = _wide(batch, rows, cols, k_dtype)
    kb = sk._K_BYTES[k_dtype]
    assert plan.smem_bytes <= sk.SMEM_LIMIT
    assert plan.smem_bytes == (plan.smem_rows * cols * kb + sk._fixed_smem_bytes(cols) + 12 * plan.rows
                               + plan.ring_bytes)
    # the ring: only where rows spill, two one-row buffers, its mbarriers and reduction slots
    if plan.spill_rows:
        assert plan.stages == 2
        assert plan.ring_bytes == plan.stages * cols * kb + 8 * sk.RING_BARS + 2 * 12 * 4
        # a shared-memory row more would not fit beside the ring
        assert plan.smem_bytes + cols * kb > sk.SMEM_LIMIT
    else:
        assert plan.stages == 0 and plan.ring_bytes == 0
    # the column sums a thread keeps in registers cover the row, in the fewest vectors
    nvec = cols * kb // 16
    assert plan.col_vecs in (2, 4, 8) and plan.col_vecs * sk.STRIPE_THREADS >= nvec
    assert plan.col_vecs == 2 or (plan.col_vecs // 2) * sk.STRIPE_THREADS < nvec
    assert plan.slots * plan.ctas <= sk.H100_SMS and plan.waves == -(-batch // plan.slots)


@pytest.mark.parametrize("batch,rows,cols,k_dtype", WIDE)
def test_wide_plan_workspace_is_the_spilled_tier_and_the_exchange(batch, rows, cols, k_dtype):
    plan = _wide(batch, rows, cols, k_dtype)
    kb = sk._K_BYTES[k_dtype]
    assert plan.workspace_bytes == plan.exchange_bytes + plan.grid * plan.spill_rows * cols * kb
    if plan.exchange_levels == 2:
        # single buffers: every cluster's sums and the next vector, 8 bytes a float
        assert plan.groups > sk.FLAT_MAX_GROUPS
        assert plan.exchange_bytes == plan.slots * (plan.groups + 1) * cols * 8
    elif plan.exchange_levels == 1:
        assert 1 < plan.groups <= sk.FLAT_MAX_GROUPS
        assert plan.exchange_bytes == 2 * plan.slots * plan.groups * cols * 8
    else:
        assert plan.groups == 1 and plan.exchange_bytes == 0
    # the wide plan is K2's layout of CTAs and clusters
    fused = sk.launch_plan(batch, rows, cols, k_dtype)
    assert (plan.cs, plan.groups, plan.ctas, plan.slots, plan.grid, plan.rows) == (
        fused.cs, fused.groups, fused.ctas, fused.slots, fused.grid, fused.rows)


def test_the_wide_shapes_reach_every_branch_of_the_wide_plan():
    plans = {shape: _wide(*shape) for shape in WIDE}
    assert {p.exchange_levels for p in plans.values()} == {0, 1, 2}
    assert {p.col_vecs for p in plans.values()} == {2, 4, 8}
    assert {p.stages for p in plans.values()} == {0, 2}
    assert any(p.waves > 1 for p in plans.values())
    assert any(p.smem_rows == 0 and p.spill_rows > 0 for p in plans.values())  # every row through the ring
    # B=1 N=4352: 66 clusters of 2, 33 rows a CTA, 11 of them past shared
    # memory in K2's plan and 13 once the ring of two rows takes its room;
    # the workspace stays under half of K's 37.9 MB
    wide = plans[(1, 4353, _padded(4352), BF16)]
    fused = sk.launch_plan(1, 4353, _padded(4352), BF16)
    assert (wide.cs, wide.groups, wide.rows, fused.spill_rows, wide.spill_rows) == (2, 66, 33, 11, 13)
    assert wide.workspace_bytes < 4353 * _padded(4352) * 2 // 2
    # one step past the widest shapes: no plan (the older streaming kernel's
    # route); the reach is about 19,000 bf16 and 12,288 f32 columns
    for k_dtype in (BF16, F32):
        assert sk.wide_launch_plan(1, WIDEST[k_dtype] + 1, WIDEST[k_dtype] + 8, k_dtype) is None
    assert 18000 < WIDEST[BF16] < 20000 and WIDEST[F32] == 12288


@pytest.mark.parametrize("batch,rows,cols,k_dtype,route", [
    (1, 4353, _padded(4352), BF16, "wide"),
    (4, 4353, _padded(4352), BF16, "wide"),
    (1, 8193, _padded(8192), BF16, "wide"),
    (2, 41, _padded(1700), F32, "wide"),  # f32 K past its 1536 fused columns
    (1, 1024, 4096, BF16, "fused"),  # at the fused kernel's columns
    (1, 1537, 1536, F32, "fused"),
    (2, 41, 25008, BF16, "stream"),  # past the wide plan's reach: more than 8 vectors a thread
    (1, 19177, 19184, BF16, "wide"),  # the widest square shape the wide plan places (N=19176)
    (1, 19185, 19192, BF16, "stream"),  # chip_smoke.py's shape past the reach: the ring no longer fits
])
def test_the_forward_route_is_chosen_from_the_shape(batch, rows, cols, k_dtype, route):
    assert sk.forward_route(batch, rows, cols, k_dtype) == route
    # the card's plan is asked for only past the fused kernel's columns
    asked = []
    sk.forward_route(batch, rows, cols, k_dtype, plan_of=lambda *shape: asked.append(shape))
    assert bool(asked) == (cols > sk.FUSED_MAX_COLS[k_dtype])

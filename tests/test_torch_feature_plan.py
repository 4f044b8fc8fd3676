"""The feature-kind layer kernel (K6, ``ops/csrc/gnn_layer_features.cu``)
on the CPU: the launch plan of its attention part on its Python mirror
(``gnn_layer_kernel.feature_plan``) at every shape the wrapper accepts, the
wrapper's refusals and their messages (``check_layer_args``), and the error
of the bf16 hi + lo split of KV that the bf16 instance uses for qf . KV. The
card tests hold the mirror against the C plan (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk

# the error of qf . KV with KV split into bf16 hi + lo (split2 in the kernel)
# against the f32 product, as a share of sum_f |T(qf)_f| |KV_fc|
KV_SPLIT_BOUND = 2.0**-16

BATCHES = (1, 2, 4, 16)
KEYS = (1, 63, 64, 65, 700, 1024, 2048, 4352)
QUERIES = (1, 300, 1024, 4352)


def _ranges(plan, m, n, is_bf16):
    """([keys of CTA r], [queries of CTA r]) as (start, end) pairs, r < cluster,
    by the kernel's arithmetic: CTA r takes 64-key chunks [r c, (r + 1) c) of
    the element's and query tiles [r t, (r + 1) t), c and t the plan's
    chunks and query tiles per CTA (``feature_attention``'s c_begin/c_end
    and its query loop's t_end)."""
    chunk, rows = glk.KEY_CHUNK, glk.query_rows(is_bf16)
    keys = [(min(m, r * plan.chunks_per_cta * chunk), min(m, (r + 1) * plan.chunks_per_cta * chunk))
            for r in range(plan.cluster)]
    tile = plan.query_tiles_per_cta * rows
    queries = [(min(n, r * tile), min(n, (r + 1) * tile)) for r in range(plan.cluster)]
    return keys, queries


def _split_kv(kv):
    """KV f32 as the bf16 instance splits it for qf . KV: hi = bf16(KV),
    lo = bf16(KV - hi), each rounded to nearest."""
    hi = kv.to(torch.bfloat16)
    return hi, (kv - hi.float()).to(torch.bfloat16)


def _features(kind, dh):
    return (dh,) if kind == "linear" else tuple(range(16, glk.MAX_FEATURES + 1, 16))


def _plans(kind, is_bf16, dh):
    for num_features in _features(kind, dh):
        for batch in BATCHES:
            for m in KEYS:
                for n in QUERIES:
                    yield (batch, n, m, num_features), glk.feature_plan(batch, 4, n, m, num_features, dh, is_bf16, kind)


@pytest.mark.parametrize("kind", glk.FEATURE_KINDS)
@pytest.mark.parametrize("is_bf16", [True, False])
@pytest.mark.parametrize("dh", [32, 64])
def test_every_key_and_query_has_one_cta(kind, is_bf16, dh):
    for (batch, n, m, num_features), plan in _plans(kind, is_bf16, dh):
        keys, queries = _ranges(plan, m, n, is_bf16)
        for ranges, length in ((keys, m), (queries, n)):
            owned = np.zeros(length, dtype=int)
            for start, end in ranges:
                owned[start:end] += 1
            assert (owned == 1).all(), (batch, n, m, num_features, plan)
        # the CTAs' runs follow one another in rank order
        assert all(keys[r][1] == keys[r + 1][0] for r in range(plan.cluster - 1))


@pytest.mark.parametrize("kind", glk.FEATURE_KINDS)
@pytest.mark.parametrize("is_bf16", [True, False])
@pytest.mark.parametrize("dh", [32, 64])
def test_a_cta_fits_the_card(kind, is_bf16, dh):
    """Shared memory within the 227 KB a block may take, a portable cluster
    (at most 8 CTAs, a power of two), and the warps cover every feature tile."""
    for (batch, n, m, num_features), plan in _plans(kind, is_bf16, dh):
        where = (batch, n, m, num_features, plan)
        assert plan.smem_bytes <= glk.SMEM_CAP, where
        assert plan.cluster in (1, 2, 4, 8), where
        tiles = num_features // 16
        assert 1 <= plan.key_groups <= 4 and plan.tiles_per_warp in (1, 2), where
        assert plan.resident in ((0, 1) if kind == "favor_softmax" else (0,)), where
        warps_per_pass = glk.FEATURE_WARPS // plan.key_groups
        assert tiles <= warps_per_pass * plan.tiles_per_warp and plan.key_groups * min(tiles, 8) <= 8, where


def test_the_serving_shapes_spread_over_the_card():
    """At B=16 the plan puts two CTAs on each (element, head), 128 in all,
    at most one per SM of the H100; B=4 N=2048 and a single pair take
    eight; FAVOR-softmax keeps its bf16 keys resident at each of these."""
    for batch, n, dh, num_features, cluster in ((16, 1024, 64, 128, 2), (16, 1024, 32, 64, 2),
                                                (4, 2048, 64, 128, 8), (1, 1024, 64, 128, 8)):
        plan = glk.feature_plan(batch, 4, n, n, num_features, dh, True, "favor_softmax")
        assert plan.cluster == cluster and batch * 4 * cluster <= glk.H100_SMS and plan.resident == 1
    plan = glk.feature_plan(16, 4, 1024, 1024, 128, 64, True, "favor_relu")
    assert plan.chunks_per_cta == 8 and plan.query_tiles_per_cta == 16 and not plan.resident
    # one key: every CTA but the first has none, and the queries still spread
    plan = glk.feature_plan(1, 4, 1024, 1, 128, 64, True, "favor_relu")
    keys, queries = _ranges(plan, 1, 1024, True)
    assert keys[0] == (0, 1) and all(s == e for s, e in keys[1:]) and all(e > s for s, e in queries)


def _case(dtype=torch.bfloat16, batch=2, n=5, m=7, dim=128):
    d2 = 2 * dim
    mats = lambda *shape: torch.zeros(*shape, dtype=dtype)
    vec = lambda size: torch.zeros(size)
    w = glk.PropagationWeights(mats(dim, dim), vec(dim), mats(dim, dim), vec(dim), mats(dim, dim), vec(dim),
                               mats(dim, dim), vec(dim), mats(d2, d2), vec(d2), vec(d2), vec(d2), mats(dim, d2),
                               vec(dim))
    x_q, x_kv = torch.zeros(batch, n, dim, dtype=dtype), torch.zeros(batch, m, dim, dtype=dtype)
    return dict(x_q=x_q, x_kv=x_kv, kv_mask=torch.ones(batch, m, dtype=torch.bool), w=w, num_heads=4,
                attention_kind="favor_relu", projection=torch.zeros(64, 32))


def _weights(**changes):
    return lambda c: dict(c, w=c["w"]._replace(**{k: v(c) for k, v in changes.items()}))


# (what the case breaks, how, the wrapper's message)
REFUSALS = [
    ("f16 compute type", _weights(wq=lambda c: c["w"].wq.half()), "compute type torch.float16"),
    ("x in another type", lambda c: dict(c, x_q=c["x_q"].float()), "the kernel takes x in its compute type"),
    ("x_kv width", lambda c: dict(c, x_kv=torch.zeros(2, 7, 64, dtype=torch.bfloat16)), "x_kv shape"),
    ("heads that do not split D", lambda c: dict(c, num_heads=3), "does not split into 3 heads"),
    ("heads of width 128", lambda c: dict(c, num_heads=1), "the kernels take heads of width 32 or 64"),
    ("no key", lambda c: dict(c, x_kv=c["x_kv"][:, :0], kv_mask=c["kv_mask"][:, :0]), "empty key set"),
    ("a strided x_q", lambda c: dict(c, x_q=torch.zeros(2, 128, 5, dtype=torch.bfloat16).transpose(1, 2)),
     "x_q and x_kv must be contiguous"),
    ("a weight's shape", _weights(w1=lambda c: c["w"].w1[:, :128].contiguous()), "weight (256, 128)"),
    ("a strided weight", _weights(wo=lambda c: c["w"].wo.t()), "weights: device/contiguity"),
    ("a bias's length", _weights(b2=lambda c: torch.zeros(5)), "bias/affine vectors"),
    ("a bf16 bias", _weights(bq=lambda c: c["w"].bq.bfloat16()), "bias/affine vectors"),
    ("a float mask", lambda c: dict(c, kv_mask=c["kv_mask"].float()), "kv_mask"),
    ("a gradient", lambda c: dict(c, x_q=c["x_q"].float().requires_grad_(), w=c["w"]._replace(
        **{f: getattr(c["w"], f).float() for f in ("wq", "wk", "wv", "wo", "w1", "w2")}),
        x_kv=c["x_kv"].float()), "the layer kernel is forward only"),
    ("a projection of another head width", lambda c: dict(c, projection=torch.zeros(64, 64)),
     "projection must be [F, 32]"),
    ("F not a multiple of 16", lambda c: dict(c, projection=torch.zeros(40, 32)),
     "the kernel takes a multiple of 16 features up to 256, got 40"),
    ("F past 256", lambda c: dict(c, projection=torch.zeros(272, 32)),
     "the kernel takes a multiple of 16 features up to 256, got 272"),
]


@pytest.mark.parametrize("what,change,message", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(what, change, message):
    case = change(_case())
    with pytest.raises(ValueError, match=message.replace("(", r"\(").replace(")", r"\)").replace("[", r"\[")):
        glk.check_layer_args(**case)


def test_the_wrapper_takes_every_kind_it_accepts():
    for kind, projection, features in (("linear", None, 32), ("favor_softmax", torch.zeros(256, 32), 256),
                                       ("favor_relu", torch.zeros(16, 32), 16)):
        case = dict(_case(), attention_kind=kind, projection=projection)
        assert glk.check_layer_args(**case) == (32, features)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 3e4])
def test_the_kv_split_of_the_query_product_is_within_its_bound(scale):
    """qf . KV with KV f32 split into bf16 hi + lo (two bf16 products with
    f32 accumulation, as the bf16 instance computes it) against the product
    with KV in f32, at F = 256: within KV_SPLIT_BOUND (2^-16) of
    sum_f |T(qf)_f| |KV_fc|, the split's own error, plus the f32 sums'."""
    rng = np.random.default_rng(0)
    qf = torch.from_numpy(rng.exponential(size=(512, 256)).astype(np.float32)).to(torch.bfloat16).double()
    kv = torch.from_numpy((rng.standard_normal((256, 64)) * scale).astype(np.float32))
    hi, lo = _split_kv(kv)
    assert ((kv.double() - hi.double() - lo.double()).abs() <= KV_SPLIT_BOUND * kv.double().abs()).all()
    exact = qf @ kv.double()
    split = qf @ hi.double() + qf @ lo.double()
    weight = qf.abs() @ kv.double().abs()
    assert ((split - exact).abs() <= KV_SPLIT_BOUND * weight).all()
    # the same products in f32, as the tensor cores sum them: the split's
    # error stays under the f32 sum's own rounding of 256 terms
    split32 = qf.float() @ hi.float() + qf.float() @ lo.float()
    assert ((split32.double() - exact).abs() <= (KV_SPLIT_BOUND + 256 * 2.0**-24) * weight).all()
    # and far under the bf16 rounding of the layer's attention output
    assert ((split - exact).abs() <= 2.0**-9 * exact.abs() + KV_SPLIT_BOUND * weight).all()

"""How closely one training step on the ``half`` route (or the ``message``
route) agrees with the same step through the kernels' plain versions, batch
by batch, on a CUDA card.

    python3 scripts/half_route_agreement.py --repo DIR [--label NAME] [--seeds 0-10] [--route half] [--brief]
    python3 scripts/half_route_agreement.py --repo DIR --smoke-batch FILE [--label NAME] [--route half]
    python3 scripts/half_route_agreement.py --repo DIR --small-f32 FILE [--label NAME]

Imports ``openglue_tpu_torch`` and ``chip_smoke.py``'s config and helpers
from the checkout DIR. For each seed it draws a B=12 N=1024 batch of
synthetic pairs as ``chip_smoke.py`` does, builds the flagship model on the
route from one weight seed, and runs one step five ways from the same state:
every kernel of the path; every plain version; every kernel but the route's
forward layer kernel (K8 on ``half``, K4 on ``message``) plain; that kernel
plain on its bf16 launches only (the first layer of each image: the chain is
f32 after it); that kernel plain on its f32 launches only. It prints one line
per batch: the loss difference, the relative difference of the unclipped
gradient norm and the gradient cosine of each run against the plain one,
and the three parameters whose gradients differ most between the first run
and the plain one, with their share of the squared difference. Each batch's
line also holds the kernel step and the plain step against an f64 step: the
same weights and batch through the composed path (``use_pallas=False``, no
bf16 chain) with every floating tensor in f64 (``Tensor.float()`` keeps an
f64 tensor f64 for that step), which says which of the two is nearer exact
arithmetic. The last line counts the batches on which the kernel step
leaves ``chip_smoke.py``'s bars against the plain step (loss 1e-3, gradient
norm 1%, cosine 0.999, BatchNorm statistics 1e-3). ``--brief`` runs the
kernel, plain and f64 steps only. Run it for two checkouts in one call to
compare them.

With ``--smoke-batch``, the batch is instead the one that ``chip_smoke.py``'s
routes phase draws when its GEMM phase takes the generator that the later
phases share (as it did before it got a generator of its own). If FILE does
not exist, the script makes it first: it runs DIR's ``chip_smoke.py`` main
with that change, up to the routes phase, saves the batch there and stops
(about two minutes; DIR must have the GEMM phase). Then every run above
takes the saved batch.

With ``--small-f32``, it reproduces instead the f32 step that
``chip_smoke.py``'s routes phase once held on the ``half`` route against the
``message`` route (B=2 N=256, ``chain_dtype`` None, the weights of seed 1;
bars loss 1e-5, gradient norm 1e-4, cosine 0.99999, statistics 1e-5; the
phase now holds each route against f64 on the route's own ReLU gates), on
the batch that phase draws when the K2s phase's three other wide shapes take
the generator that the later phases share (as they did before they got one
of their own). If FILE does not exist, the script makes it first, as
``--smoke-batch`` does (about three minutes). Then it runs that step on both
routes with every kernel, with the route's forward layer kernel plain, with
every kernel plain, and in f64 on the composed path, and prints each
against the ``message`` step with every kernel and against the f64 step.
Then, for the ``message`` step with every kernel, with K4 plain and with
every kernel plain, it prints the FFN ReLU gates that differ from the f64
step's and the parameters whose gradients differ most, and the step against
an f64 step made to take that step's gates. Last it keeps the inputs of
every f32 K4 launch of the ``message`` step and
prints, per launch, how far K4's msg, attn and lse, K8's attn and lse, the
plain f32 version's and msg formed in f64 from K4's attn lie from an f64
evaluation of the same function on those inputs (largest difference over
the largest value).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import torch


def seeds_of(text: str):
    first, _, last = text.partition("-")
    return range(int(first), int(last or first) + 1)


@contextlib.contextmanager
def swapped(pairs):
    saved = [(module, name, getattr(module, name)) for module, name, _ in pairs]
    for module, name, fn in pairs:
        setattr(module, name, fn)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", type=Path, required=True)
    parser.add_argument("--label", default=None)
    parser.add_argument("--seeds", default="0-10")
    parser.add_argument("--smoke-batch", type=Path, default=None)
    parser.add_argument("--route", choices=("half", "message"), default="half")
    parser.add_argument("--brief", action="store_true", help="the kernel, plain and f64 steps only")
    parser.add_argument("--small-f32", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("half_route_agreement: no CUDA card is available", file=sys.stderr)
        return 1
    repo = args.repo.resolve()
    sys.path.insert(0, str(repo))
    import chip_smoke as cs
    if args.small_f32 is not None:
        return small_f32(cs, args.small_f32, args.label or str(repo))
    from openglue_tpu_torch.cli.common import loss_config_from, optimizer_from, superglue_config_from
    from openglue_tpu_torch.data.synthetic import SyntheticHomographyPairs
    from openglue_tpu_torch.models.superglue import SuperGlue
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
    from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk
    from openglue_tpu_torch.train.state import create_train_state
    from openglue_tpu_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = {"superglue": cs.SUPERGLUE_SECTION, "train": cs.TRAIN_SECTION}
    step = make_train_step(loss_config_from(config))
    cfg = superglue_config_from({"superglue": cs.SUPERGLUE_SECTION}, cs.DESCRIPTOR_DIM, cs.SIDE_INFO_DIM)
    base = SuperGlue(cfg, device="cuda", generator=torch.Generator().manual_seed(1), train_route=args.route)

    def state():
        model = SuperGlue(cfg, device="cuda", train_route=args.route)
        model.load_state_dict(base.state_dict())
        return create_train_state(model, optimizer=optimizer_from(config, model.parameters()))

    cfg64 = superglue_config_from({"superglue": dict(cs.SUPERGLUE_SECTION, use_pallas=False, chain_dtype=None)},
                                  cs.DESCRIPTOR_DIM, cs.SIDE_INFO_DIM)

    def state64():
        model = SuperGlue(cfg64, device="cuda").double()
        model.load_state_dict(base.state_dict())
        return create_train_state(model, optimizer=optimizer_from(config, model.parameters()))

    name, kernel_name, plain_fn = {
        "half": ("K8", "train_half_forward", glk.train_half_plain),
        "message": ("K4", "message_forward", glk.message_forward_plain),
    }[args.route]
    kernel_fn = getattr(glk, kernel_name)
    plain = [(glk, "message_backward", glk.message_backward_plain), (glk, kernel_name, plain_fn),
             (sk, "sinkhorn_scale", sk.sinkhorn_scale_plain), (sk, "sinkhorn_adjoint", sk.sinkhorn_adjoint_plain)]

    def plain_in(dtype):
        """The forward layer kernel plain where its compute type (the last
        argument) is ``dtype``."""
        def forward(*a):
            return (plain_fn if a[-1] == dtype else kernel_fn)(*a)
        return [(glk, kernel_name, forward)]

    variants = (("kernels", []), ("plain", plain), (f"{name} plain", [(glk, kernel_name, plain_fn)]),
                (f"{name} bf16 plain", plain_in(torch.bfloat16)), (f"{name} f32 plain", plain_in(torch.float32)))
    first_bf16 = {}

    def mixed(from_plain):
        """K8's bf16 launches with the outputs named in ``from_plain`` (z, or
        attn and lse) taken from its plain version, the rest from the kernel;
        the first such call's arguments are kept for ``z_report``."""
        def forward(*a):
            out = kernel_fn(*a)
            if a[-1] != torch.bfloat16:
                return out
            first_bf16.setdefault("args", clone(a))
            ref = plain_fn(*a)
            return (ref if "z" in from_plain else out)[0], *(ref if "attn" in from_plain else out)[1:]
        return [(glk, kernel_name, forward)]

    if args.route == "half" and not args.brief:
        variants += (("K8 bf16, z plain", mixed(("z",))), ("K8 bf16, attn and lse plain", mixed(("attn",))))
    if args.brief:
        variants = variants[:2]
    label = args.label or str(repo)
    n, batch = cs.MAX_KEYPOINTS, cs.BATCH_SIZE
    if args.smoke_batch is not None:
        if not args.smoke_batch.exists():
            smoke_batch(cs, args.smoke_batch)
        batches = [("chip_smoke.py's routes batch with a shared GEMM generator",
                    torch.load(args.smoke_batch, map_location="cuda", weights_only=False))]
    else:
        batches = []
        for seed in seeds_of(args.seeds):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            counts = lambda: torch.randint(n // 2, n + 1, (batch,), generator=gen, device="cuda").tolist()
            pairs = cs.make_request(SyntheticHomographyPairs, gen, batch, n, counts(), counts())
            batches.append((f"seed {seed}", pairs))
    outside = []
    for what, pairs in batches:
        runs, grads, stats = {}, {}, {}
        for variant, swap in variants:
            st = state()
            with swapped(swap):
                metrics = step(st, pairs)
            runs[variant] = (metrics, cs.flat_grads(st.model))
            grads[variant] = {k: p.grad.double() for k, p in st.model.named_parameters() if p.grad is not None}
            stats[variant] = [b.double() for k, b in st.model.named_buffers() if "running" in k]
        st = state64()
        with cs.f64_floats():
            metrics = step(st, cs.to_f64(pairs))
        runs["f64"] = (metrics, cs.flat_grads(st.model))
        parts = []
        for variant in (variant for variant, _ in variants if variant != "plain"):
            parts.append(f"{variant}: " + distance(runs[variant], runs["plain"]))
        for variant in ("kernels", "plain"):
            parts.append(f"{variant} against f64: " + distance(runs[variant], runs["f64"]))
        bars = distance_values(runs["kernels"], runs["plain"])
        stat = max((x - y).abs().max().item() for x, y in zip(stats["kernels"], stats["plain"]))
        if not (bars[0] <= 1e-3 and bars[1] <= 0.01 and bars[2] >= 0.999 and stat <= 1e-3):
            outside.append(what)
        diff = {k: (grads["kernels"][k] - grads["plain"][k]).pow(2).sum().item() for k in grads["plain"]}
        total = sum(diff.values()) or 1.0
        top = sorted(diff, key=diff.get, reverse=True)[:3]
        parts.append("largest gradient differences (kernels - plain): "
                     + ", ".join(f"{k} {diff[k] / total:.3f}" for k in top))
        print(f"[{label}] {what}, route {args.route}, against the plain step: " + "; ".join(parts), flush=True)
        if first_bf16:
            print(f"[{label}] {what}, the first bf16 layer: " + z_report(glk, *first_bf16.pop("args")), flush=True)
    print(f"[{label}] route {args.route}: {len(outside)} of {len(batches)} batches leave the bars (kernels against "
          f"plain: loss 1e-3, norm 1%, cosine 0.999, stats 1e-3)" + (f": {', '.join(outside)}" if outside else ""),
          flush=True)
    return 0


def distance_values(run, ref):
    """(|loss difference|, relative difference of the gradient norms, gradient
    cosine) of two steps' (metrics, flat gradient)."""
    (m, g), (m_ref, g_ref) = run, ref
    g, g_ref = g.double(), g_ref.double()
    return (abs(m["total_loss"].item() - m_ref["total_loss"].item()),
            abs(m["grad_norm"].item() / m_ref["grad_norm"].item() - 1),
            (g @ g_ref / (g.norm() * g_ref.norm())).item())


def distance(run, ref) -> str:
    loss, norm, cos = distance_values(run, ref)
    return f"loss {loss:.2e}, norm {norm:.2e}, cosine {cos:.6f}"


def clone(args):
    """A copy of a layer call's arguments that the optimizer step leaves as
    they were."""
    copy = lambda t: t.detach().clone() if torch.is_tensor(t) else t
    return [type(a)(*map(copy, a)) if isinstance(a, tuple) else copy(a) for a in args]


def z_report(glk, x_q, x_kv, mask, w, w1, b1, heads, use_offset, dtype):
    """How far z = relu(concat . W1^T + b1) of one layer is from its plain
    version when K8 computes it, and when K4 computes msg and PyTorch the
    rest (the ``message`` route): entries that differ, entries whose sign
    gate (z > 0) differs, and the largest difference over the largest z."""
    def z_of(msg):
        xq = x_q.to(dtype)
        cat = torch.cat([xq - msg if use_offset else xq, msg], dim=-1)
        return torch.relu(glk._dense_f32(cat, w1.to(dtype), b1.float())).to(dtype)

    with torch.no_grad():
        z_ref = glk.train_half_plain(x_q, x_kv, mask, w, w1, b1, heads, use_offset, dtype)[0].float()
        z_k8 = glk.train_half_forward(x_q, x_kv, mask, w, w1, b1, heads, use_offset, dtype)[0].float()
        z_k4 = z_of(glk.message_forward(x_q, x_kv, mask, w, heads, dtype)[0]).float()
        z_plain_msg = z_of(glk.message_forward_plain(x_q, x_kv, mask, w, heads, dtype)[0]).float()
    parts = []
    for name, z in (("K8", z_k8), ("K4 + torch", z_k4), ("plain msg + torch", z_plain_msg)):
        parts.append(f"{name}: {int((z != z_ref).sum())} of {z.numel()} entries differ, "
                     f"{int(((z > 0) != (z_ref > 0)).sum())} gates, largest "
                     f"{((z - z_ref).abs().max() / z_ref.abs().max()).item():.2e}")
    return "; ".join(parts)


class _BatchSaved(Exception):
    pass


def small_f32(cs, path: Path, label: str) -> int:
    """The routes phase's f32 B=2 N=256 step, ``half`` against ``message``,
    on the batch saved in ``path`` (made first where it is missing)."""
    from openglue_tpu_torch.cli.common import loss_config_from, optimizer_from, superglue_config_from
    from openglue_tpu_torch.models.superglue import SuperGlue
    from openglue_tpu_torch.ops.kernels import attention_kernel as ak
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
    from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk
    from openglue_tpu_torch.train.state import create_train_state
    from openglue_tpu_torch.train.step import make_train_step

    if not path.exists():
        shared_k2s_batch(cs, path)
    small = torch.load(path, map_location="cuda", weights_only=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = {"superglue": cs.SUPERGLUE_SECTION, "train": cs.TRAIN_SECTION}
    step = make_train_step(loss_config_from(config))
    section = dict(cs.SUPERGLUE_SECTION, chain_dtype=None)
    cfg = superglue_config_from({"superglue": section}, cs.DESCRIPTOR_DIM, cs.SIDE_INFO_DIM)
    base = SuperGlue(cfg, device="cuda", generator=torch.Generator().manual_seed(1), train_route="half")
    cfg64 = superglue_config_from({"superglue": dict(section, use_pallas=False)}, cs.DESCRIPTOR_DIM,
                                  cs.SIDE_INFO_DIM)

    gates, grads = {}, {}

    def run(route, swap, f64=False, name=None, force=None):
        """One step; ``force``: the FFN pre-activations of another run, whose
        ReLU gates this run takes in place of its own."""
        model = SuperGlue(cfg64 if f64 else cfg, device="cuda", train_route=route)
        model = model.double() if f64 else model
        model.load_state_dict(base.state_dict())
        st = create_train_state(model, optimizer=optimizer_from(config, model.parameters()))
        seen = gates.setdefault(name, [])

        def hook(module, args, out):
            seen.append(args[0].detach().double())
            if force is not None:
                return torch.where(force[len(seen) - 1] > 0, args[0], torch.zeros_like(args[0]))
            return None

        hooks = [m.register_forward_hook(hook) for m in model.attention_gnn.modules() if isinstance(m, torch.nn.ReLU)]
        with swapped(swap), (cs.f64_floats() if f64 else contextlib.nullcontext()):
            metrics = step(st, cs.to_f64(small) if f64 else small)
        for h in hooks:
            h.remove()
        grads[name] = {k: p.grad.double() for k, p in st.model.named_parameters() if p.grad is not None}
        stats = [b.double() for k, b in st.model.named_buffers() if "running" in k]
        return (metrics, cs.flat_grads(st.model)), stats

    plain = [(glk, "message_forward", glk.message_forward_plain),
             (glk, "message_backward", glk.message_backward_plain),
             (glk, "train_half_forward", glk.train_half_plain),
             (sk, "sinkhorn_scale", sk.sinkhorn_scale_plain), (sk, "sinkhorn_adjoint", sk.sinkhorn_adjoint_plain),
             (ak, "attention_forward", ak.attention_forward_plain),
             (ak, "attention_backward", ak.attention_backward_plain)]
    variants = {
        "half": ("half", []),
        "message": ("message", []),
        "half, K8 plain": ("half", [(glk, "train_half_forward", glk.train_half_plain)]),
        "message, K4 plain": ("message", [(glk, "message_forward", glk.message_forward_plain)]),
        "half, every kernel plain": ("half", plain),
        "message, every kernel plain": ("message", plain),
    }
    runs = {name: run(route, swap, name=name) for name, (route, swap) in variants.items()}
    runs["f64"] = run("message", [], f64=True, name="f64")
    ref, ref_stats = runs["message"]
    exact = runs["f64"][0]
    for name, (steps, stats) in runs.items():
        loss, norm, cos = distance_values(steps, ref)
        stat = max((x - y).abs().max().item() for x, y in zip(stats, ref_stats))
        inside = loss <= 1e-5 and norm <= 1e-4 and cos >= 0.99999 and stat <= 1e-5
        print(f"[{label}] f32 B=2 N=256, {name}: against message loss {loss:.2e}, norm {norm:.2e}, cosine "
              f"{cos:.7f}, stats {stat:.2e} ({'inside' if inside else 'outside'} the routes phase's bars); "
              f"against f64 {distance(steps, exact)}; loss {steps[0]['total_loss'].item():.8f}, grad norm "
              f"{steps[0]['grad_norm'].item():.8f}", flush=True)
    for name in ("message", "message, K4 plain", "message, every kernel plain"):
        print(f"[{label}] f32 B=2 N=256, {name} against f64: " + gate_report(gates[name], gates["f64"])
              + "; largest gradient differences: " + grad_report(grads[name], grads["f64"]), flush=True)
        same_gates = run("message", [], f64=True, name=f"f64 on {name}'s gates", force=gates[name])[0]
        print(f"[{label}] f32 B=2 N=256, {name} against the f64 step on its own ReLU gates: "
              f"{distance(runs[name][0], same_gates)}; that f64 step against the f64 step: "
              f"{distance(same_gates, exact)}", flush=True)
    launches = []
    real = glk.message_forward

    def kept(x_q, x_kv, mask, w, heads, dtype):
        if dtype == torch.float32:
            launches.append(clone([x_q, x_kv, mask, w]) + [heads])
        return real(x_q, x_kv, mask, w, heads, dtype)

    run("message", [(glk, "message_forward", kept)])
    for i, (x_q, x_kv, mask, w, heads) in enumerate(launches):
        print(f"[{label}] f32 K4 launch {i}: " + k4_report(cs, glk, x_q, x_kv, mask, w, heads), flush=True)
    return 0


def gate_report(seen, exact) -> str:
    """The FFN ReLU gates (pre-activation > 0) of one step that differ from
    the f64 step's, by layer call: how many, and the largest f64
    pre-activation among them."""
    parts = []
    for i, (z, ref) in enumerate(zip(seen, exact)):
        flips = (z > 0) != (ref > 0)
        if flips.any():
            parts.append(f"call {i}: {int(flips.sum())} (largest |f64 z| {ref[flips].abs().max().item():.2e})")
    return f"{len(seen)} ReLU calls, gates flipped at " + (", ".join(parts) or "none")


def grad_report(got, exact, top=4) -> str:
    diff = {k: (got[k] - exact[k]).pow(2).sum().item() for k in exact}
    total = sum(diff.values()) or 1.0
    return ", ".join(f"{k} {diff[k] / total:.3f}" for k in sorted(diff, key=diff.get, reverse=True)[:top])


def k4_report(cs, glk, x_q, x_kv, mask, w, heads) -> str:
    """How far one f32 K4 launch's outputs lie from an f64 evaluation of the
    same function, beside K8's attn and lse and the plain f32 version's."""
    f32, f64 = torch.float32, torch.float64
    dim = x_q.shape[-1]
    gen = torch.Generator(device=x_q.device).manual_seed(0)
    w1 = torch.randn(2 * dim, 2 * dim, generator=gen, device=x_q.device) * dim**-0.5
    b1 = torch.zeros(2 * dim, device=x_q.device)
    with torch.no_grad():
        k4 = glk.message_forward(x_q, x_kv, mask, w, heads, f32)
        k8 = glk.train_half_forward(x_q, x_kv, mask, w, w1, b1, heads, False, f32)
        plain = glk.message_forward_plain(x_q, x_kv, mask, w, heads, f32)
        w64 = type(w)(*(t.double() for t in w))
        with cs.f64_floats():
            exact = glk.message_forward_plain(x_q.double(), x_kv.double(), mask, w64, heads, f64)
            msg_of_k4_attn = glk._dense_f32(k4[1].double(), w64.wo, w64.bo)

    def rel(a, ref):
        return ((a.double() - ref).abs().max() / ref.abs().max()).item()

    parts = [f"{name}: K4 {rel(k, e):.2e}, plain {rel(p, e):.2e}"
             for name, k, p, e in zip(("msg", "attn", "lse"), k4, plain, exact)]
    parts.append(f"K8 attn {rel(k8[1], exact[1]):.2e}, lse {rel(k8[2], exact[2]):.2e}")
    parts.append(f"msg of K4's attn in f64 {rel(msg_of_k4_attn, exact[0]):.2e}, "
                 f"K4 msg against it {rel(k4[0], msg_of_k4_attn):.2e}")
    return "; ".join(parts)


def shared_k2s_batch(cs, path: Path) -> None:
    """Run ``chip_smoke.py``'s main with the K2s phase's other wide shapes on
    the generator that the later phases share, up to the routes phase; save
    the f32 B=2 N=256 batch that phase draws second to ``path``."""
    from openglue_tpu_torch.data.synthetic import SyntheticHomographyPairs

    phase = cs.streaming_sinkhorn_phase

    def routes_small(gen, card, device="cuda"):  # the routes phase's first two draws
        n = cs.MAX_KEYPOINTS
        counts = lambda: torch.randint(n // 2, n + 1, (cs.BATCH_SIZE,), generator=gen, device=device).tolist()
        cs.make_request(SyntheticHomographyPairs, gen, cs.BATCH_SIZE, n, counts(), counts())
        small = cs.make_request(SyntheticHomographyPairs, gen, 2, 256, [256, 180], [200, 256])
        torch.save(small, path)
        raise _BatchSaved

    cs.streaming_sinkhorn_phase = lambda sk, gen, *a, **kw: phase(sk, gen, *a, extra=gen, **kw)
    cs.routes_phase = routes_small
    try:
        cs.main()
    except _BatchSaved:
        print(f"saved the routes phase's f32 batch to {path}", flush=True)
    else:
        raise RuntimeError("chip_smoke.py's main returned before its routes phase")


def smoke_batch(cs, path: Path) -> None:
    """Run ``chip_smoke.py``'s main with its GEMM phase on the generator that
    the later phases share, up to the routes phase; save the batch that phase
    draws first to ``path``."""
    shared = {}
    lse_phase, gemm_phase = cs.lse_phase, cs.gemm_phase

    def lse_phase_seen(ak, dtype, gen, *a, **kw):  # the phase just before the GEMM phase
        shared["gen"] = gen
        return lse_phase(ak, dtype, gen, *a, **kw)

    def routes_batch(gen, card, device="cuda"):  # the routes phase's first draws
        from openglue_tpu_torch.data.synthetic import SyntheticHomographyPairs

        n = cs.MAX_KEYPOINTS
        counts = lambda: torch.randint(n // 2, n + 1, (cs.BATCH_SIZE,), generator=gen, device=device).tolist()
        batch = cs.make_request(SyntheticHomographyPairs, gen, cs.BATCH_SIZE, n, counts(), counts())
        torch.save(batch, path)
        raise _BatchSaved

    cs.lse_phase = lse_phase_seen
    cs.gemm_phase = lambda gk, gen: gemm_phase(gk, shared["gen"])
    cs.routes_phase = routes_batch
    try:
        cs.main()
    except _BatchSaved:
        print(f"saved the routes phase's batch to {path}", flush=True)
    else:
        raise RuntimeError("chip_smoke.py's main returned before its routes phase")


if __name__ == "__main__":
    sys.exit(main())

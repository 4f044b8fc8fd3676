"""What bounds the bf16 GEMM and the bf16 attention: each kernel timed again
with one part of its work taken out, on a CUDA card; and the bf16 GEMM at
each of its tiles.

    python3 scripts/bf16_ablations.py --repo DIR [--only NAME ...]

For each variant below the script copies DIR's ``openglue_tpu_torch`` under
DIR/build/ablations/<name>, edits one line of a kernel source there (an exact
text replacement that must match once, so a source that moved on fails
loudly instead of timing the wrong thing), builds the attention, GEMM and
layer libraries of the copy, each in a process of its own, and prints one
JSON line per variant, in device ms (``chip_smoke.device_ms``).

An ablation takes one part of a kernel's work out. Its line has K1's
attention alone (B=16 and B=12, N=M=1024, H=4, dh=64, ragged masks), K1's
five bf16 GEMMs alone at B=16 and their sum, and the K1 bf16 layer. The
first line is the unedited copy. The outputs of an ablated kernel are wrong
by design; only the unedited copy is checked against the plain versions. A
part whose removal leaves the time where it was is not what bounds the
kernel; one whose removal cuts the time is, in that share.

A tile variant makes the bf16 launch rule (``gemm.cuh``'s
``bf16_tile_rule``) return one tile wherever n_out allows it (elsewhere the
rule decides). Its line has K1's five GEMMs at 16,384 rows (B=16), 12,288
(B=12), 4,096 (the pretraining fixture's B=2 N=2048, D=128) and 1,024
(B=1): the measurements the rule is set from. The unedited rule's line
comes first. Every tile variant is checked against the plain version.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ATTENTION = "openglue_tpu_torch/ops/csrc/attention.cuh"
GEMM = "openglue_tpu_torch/ops/csrc/gemm.cuh"

# name: (source, text, replacement)
ABLATIONS = {
    "attention: no exp (the scores' exp2 becomes a subtraction)": (
        ATTENTION, "const float pe = exp2_approx(s[i] - row_max[(i >> 1) & 1]);",
        "const float pe = s[i] - row_max[(i >> 1) & 1];"),
    "attention: no S products": (
        ATTENTION, "    wgmma_ss_n128<0>(s, smem_desc(q + 32 * kk",
        "    if (kk < 0) wgmma_ss_n128<0>(s, smem_desc(q + 32 * kk"),
    "attention: no P V products": (
        ATTENTION, "        wgmma_pv<DH>(o, p[kk],", "        if (kk < 0) wgmma_pv<DH>(o, p[kk],"),
    "attention: no turns (the consumers issue S whenever ready)": (
        ATTENTION, "      named_sync(1 + cw, 256);\n", "      if (cw < 0) named_sync(1 + cw, 256);\n"),
    "attention: no mask (the producer writes 0)": (
        ATTENTION, "next[j] = mask_add(mask, b, M, k0 + kHk + lane + 32 * j) * kLog2e;", "next[j] = 0.f;"),
    "attention: ring of 2 stages": (ATTENTION, "kHStages = 3,", "kHStages = 2,"),
    "attention: ring of 4 stages": (ATTENTION, "kHStages = 3,", "kHStages = 4,"),
    "gemm: no epilogue (nothing stored)": (
        GEMM, "if (m0 + r < p.rows) epilogue8<EPI>(", "if (m0 + r < 0) epilogue8<EPI>("),
    "gemm: no products": (
        GEMM, "        wgmma_ss<BN, KN ? 1 : 0>(acc,", "        if (kk < 0) wgmma_ss<BN, KN ? 1 : 0>(acc,"),
    "gemm: no weight loads (A's bytes only)": (
        GEMM, "        for (int j = 0; j < BN / 64; ++j)\n", "        for (int j = 0; j < 0; ++j)\n"),
}
# the bf16 GEMM's tiles: the launch rule returns one tile's width first
RULE = "  const int sms = sm_count(), blocks = (rows + 63) / 64;\n"
TILES = {
    f"tile 64x{bn}": (GEMM, RULE, (f"  if (n_out % {bn} == 0) return {bn};\n" if bn > 64 else "  return 64;\n") + RULE)
    for bn in (256, 128, 64)
}
# the weight-load ablation also expects A's bytes alone
EXTRA = {
    "gemm: no weight loads (A's bytes only)": (
        GEMM, "mbar_arrive_tx(&full[stage], G::stage_bytes);", "mbar_arrive_tx(&full[stage], G::a_bytes);"),
}

WORKER = r'''
import json, sys, torch
sys.path.insert(0, sys.argv[2])  # chip_smoke.py of the checkout
sys.path.insert(0, sys.argv[1])  # the edited package, ahead of the checkout's
import chip_smoke as cs
from openglue_tpu_torch.ops import kernels
kernels.SOURCES = ("attention", "gemm", "gnn_layer")
kernels.build_all()
from openglue_tpu_torch.ops.kernels import attention_kernel as ak, gemm_kernel as gk, gnn_layer_kernel as glk
check = sys.argv[3] == "check"
gen = torch.Generator(device="cuda").manual_seed(0)
r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
out = {}
K1_GEMMS = (("kv", 2, 1, "bias"), ("q", 1, 1, "bias"), ("out+concat", 1, 1, "concat"),
            ("ffn1", 2, 2, "relu_affine"), ("ffn2", 1, 2, "residual"))


def gemms(rows, dim, tag=""):
    for name, n_mul, k_mul, epi in K1_GEMMS:
        n_out, kk = n_mul * dim, k_mul * dim
        a, w, bias = r(rows, kk).bfloat16(), (r(n_out, kk) * kk**-0.5).bfloat16(), r(n_out)
        kw = dict(a=a, w=w, bias=bias, epilogue=epi, x=r(rows, n_out).bfloat16(), scale=1 + 0.1 * r(n_out),
                  shift=0.1 * r(n_out))
        if check:
            o, ref = gk.gemm(**kw), gk.gemm_plain(**kw)
            assert (o.float() - ref.float()).abs().max() <= 2.0**-7 * ref.float().abs().max()
        out[f"gemm {name}{tag}"] = cs.device_ms(lambda: gk.gemm(**kw))


with torch.no_grad():
    if sys.argv[4] == "tiles":
        for rows, dim in ((16384, 256), (12288, 256), (4096, 128), (1024, 256)):
            gemms(rows, dim, f" {rows}x{dim}")
        print(json.dumps(out))
        sys.exit(0)
    for b in (16, 12):
        q = r(b, 1024, 256).bfloat16().view(b, 1024, 4, 64).transpose(1, 2)
        kv = r(b, 1024, 512).bfloat16()
        k, v = (kv[..., i:i + 256].view(b, 1024, 4, 64).transpose(1, 2) for i in (0, 256))
        counts = torch.randint(256, 1025, (b,), generator=gen, device="cuda")
        mask = torch.arange(1024, device="cuda")[None] < counts[:, None]
        if check:
            o, ref = ak.attention_forward(q, k, v, mask, False)[0], ak.attention_forward_plain(q, k, v, mask, False)[0]
            assert (o.float() - ref.float()).abs().max() <= 2.0**-7 * ref.float().abs().max()
        out[f"attention B={b}"] = cs.device_ms(lambda: ak.attention_forward(q, k, v, mask, False))
    gemms(16384, 256)
    out["gemm sum"] = sum(t for n, t in out.items() if n.startswith("gemm"))
    w = cs.layer_weights(glk, torch.bfloat16, gen, 256)
    xq, xkv, mask = cs.layer_inputs(torch.bfloat16, gen, 16, 1024, 256)
    out["K1 layer B=16"] = cs.device_ms(lambda: glk.fused_attention_propagation(xq, xkv, mask, w, 4))
print(json.dumps(out))
'''


def variant(repo: Path, name: str, edits) -> Path:
    """A copy of repo's package under build/ablations with ``edits`` made."""
    root = repo / "build" / "ablations" / "".join(c if c.isalnum() else "_" for c in name)[:48]
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(repo / "openglue_tpu_torch", root / "openglue_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for source, text, replacement in edits:
        path = root / source
        code = path.read_text()
        if code.count(text) != 1:
            raise SystemExit(f"{name}: the text to replace is not in {source} exactly once: {text!r}")
        path.write_text(code.replace(text, replacement))
    return root


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", type=Path, required=True, help="root of the checkout")
    parser.add_argument("--only", nargs="*", default=None,
                        help="ablation and tile names to run (default: all; the unedited runs always)")
    args = parser.parse_args()
    repo = args.repo.resolve()
    wanted = lambda name: args.only is None or name in args.only
    runs = [("unedited", [], "k1", "check")] + [
        (name, [edit] + ([EXTRA[name]] if name in EXTRA else []), "k1", "time")
        for name, edit in ABLATIONS.items() if wanted(name)
    ]
    if any(wanted(name) for name in TILES):
        runs += [("the launch rule", [], "tiles", "check")]
        runs += [(name, [edit], "tiles", "check") for name, edit in TILES.items() if wanted(name)]
    for name, edits, shapes, check in runs:
        root = variant(repo, name, edits)
        done = subprocess.run([sys.executable, "-c", WORKER, str(root), str(repo), check, shapes],
                              capture_output=True, text=True, timeout=600)
        if done.returncode != 0:
            print(json.dumps({"variant": name, "failed": done.stderr[-2000:]}), flush=True)
            return 1
        times = json.loads(done.stdout.strip().splitlines()[-1])
        print(json.dumps({"variant": name, "ms": {k: round(v, 4) for k, v in times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

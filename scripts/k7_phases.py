"""Where K7's s8 GEMMs spend their time, phase by phase, on a CUDA card.

    python3 scripts/k7_phases.py --repo DIR [--modes int8 int8_static ...]

The script copies DIR's ``openglue_tpu_torch`` under DIR/build/k7_phases,
inserts ``%globaltimer`` stamps into the copy's ``ops/csrc/gnn_layer_int8.cu``
(exact text insertions that must match once, so a source that moved on fails
loudly instead of timing the wrong thing), builds the copy and runs one layer
of each mode (B=16 N=M=1024 D=256, bf16 x, a ragged key mask; static scales
calibrated as ``chip_smoke.py`` calibrates them) three times, then reads the
stamps of the last run: consumer warpgroup 0's first thread of every CTA of
every ``gemm_s8`` launch stamps the launch's start, the weight in shared
memory, and per tile A ready (TMA, or quantized on load), the products done
and the epilogue done. It prints one JSON line: the card, and per mode and
GEMM the mean over the CTAs (us) of the weight's load, of each phase summed
over a CTA's tiles (A: the wait for A, or its raw rows and their
quantization; products; epilogue), the CTA's span, and the tiles per CTA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

SLOTS, CTAS, STAMPS = 48, 160, 12  # gemm_s8 instances, CTAs, stamps per CTA (3 + 3 per tile, 3 tiles)

TIMER = """__device__ unsigned long long og_phase_t[%d][%d][%d];
__device__ __forceinline__ unsigned long long og_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
""" % (SLOTS, CTAS, STAMPS)
# appended after the anonymous namespace, so that the symbol is exported
READER = """
extern "C" int og_phases(unsigned long long* out, int reset) {
  if (!reset) return cudaMemcpyFromSymbol(out, og_phase_t, sizeof(og_phase_t));
  void* at = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&at, og_phase_t);
  return err != cudaSuccess ? err : cudaMemset(at, 0, sizeof(og_phase_t));
}
"""

# (text, replacement) in gnn_layer_int8.cu, each matching exactly once
REPLACE = [
    ("namespace {\n\nconstexpr float kEps", "namespace {\n%%TIMER%%\nconstexpr float kEps"),
    ("  const int tiles = (p.rows + kRows - 1) / kRows;\n  // QA: the raw rows",
     "  const int tiles = (p.rows + kRows - 1) / kRows;\n"
     "  const int slot_ = ((EPI * 2 + QA) * 4 + (BN == 256 ? 2 : BN == 128 ? 1 : 0)) % " + str(SLOTS) + ";\n"
     "  const bool stamp_ = threadIdx.x == 128 && blockIdx.x < " + str(CTAS) + ";\n"
     "  unsigned long long* const st_ = og_phase_t[slot_][blockIdx.x < " + str(CTAS) + " ? blockIdx.x : 0];\n"
     "  if (stamp_) st_[0] = og_gtime();\n"
     "  // QA: the raw rows"),
    ("  if constexpr (G::resident) mbar_wait(&w_full[0], 0);\n"
     "  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, par ^= 1) {\n",
     "  if constexpr (G::resident) mbar_wait(&w_full[0], 0);\n  if (stamp_) st_[1] = og_gtime();\n  int it_ = 0;\n"
     "  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, par ^= 1, ++it_) {\n"),
    ("    const uint32_t a = smem_addr(a_s + slot * G::a_bytes);\n",
     "    if (stamp_ && it_ < 3) st_[3 + 3 * it_] = og_gtime();\n    const uint32_t a = smem_addr(a_s + slot * G::a_bytes);\n"),
    ("    const float su = srow_s[slot * kRows + rl];\n",
     "    if (stamp_ && it_ < 3) st_[4 + 3 * it_] = og_gtime();\n    const float su = srow_s[slot * kRows + rl];\n"),
    ("        named_sync(2, 128);  // the staging tile is free again\n      }\n    }\n  }\n}\n",
     "        named_sync(2, 128);  // the staging tile is free again\n      }\n    }\n"
     "    if (stamp_ && it_ < 3) st_[5 + 3 * it_] = og_gtime();\n  }\n  if (stamp_) st_[2] = og_gtime();\n}\n"),
]
NAMES = ["bf16 (kv, q)", "f32 + absmax (kv, q)", "q8 / k8 / V^T (kv, q)", "cat8 (out)", "h18 (ffn1)", "residual (ffn2)"]


def instrument(repo: Path) -> Path:
    dst = repo / "build" / "k7_phases"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(repo / "openglue_tpu_torch", dst / "openglue_tpu_torch")
    src = dst / "openglue_tpu_torch" / "ops" / "csrc" / "gnn_layer_int8.cu"
    text = src.read_text()
    for old, new in REPLACE:
        if text.count(old) != 1:
            raise SystemExit(f"k7_phases: the anchor {old[:60]!r} does not match once in {src}")
        text = text.replace(old, new.replace("%%TIMER%%", TIMER))
    src.write_text(text + READER)
    return dst


def summarize(raw):
    """Per instance: the CTA means of the weight's load, A, products,
    epilogue (summed over a CTA's tiles), span, and tiles per CTA."""
    out = {}
    for slot in range(SLOTS):
        rows = [raw[slot][c] for c in range(CTAS) if raw[slot][c][0]]
        if not rows:
            continue
        phases = {"weight": [], "A": [], "products": [], "epilogue": [], "span": [], "tiles": []}
        for st in rows:
            phases["weight"].append((st[1] - st[0]) / 1e3)
            phases["span"].append((st[2] - st[0]) / 1e3)
            prev, tiles, a, m, e = st[1], 0, 0.0, 0.0, 0.0
            for i in range(3):
                ta, tm, te = st[3 + 3 * i], st[4 + 3 * i], st[5 + 3 * i]
                if not te:
                    break
                a, m, e, prev, tiles = a + (ta - prev) / 1e3, m + (tm - ta) / 1e3, e + (te - tm) / 1e3, te, tiles + 1
            phases["A"].append(a)
            phases["products"].append(m)
            phases["epilogue"].append(e)
            phases["tiles"].append(tiles)
        epi, qa, bn = slot // 8, slot // 4 % 2, (64, 128, 256)[slot % 4]
        out[f"{NAMES[epi]} BN={bn}{' quantized on load' if qa else ''}"] = {
            k: round(statistics.mean(v), 2) for k, v in phases.items()}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", type=Path, required=True)
    parser.add_argument("--modes", nargs="*", default=["int8", "int8_static", "int8_attn", "int8_static_attn"])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k7_phases: no CUDA card is available", file=sys.stderr)
        return 1
    repo = args.repo.resolve()
    copy = instrument(repo)
    sys.path.insert(0, str(copy))
    sys.path.insert(1, str(Path(__file__).resolve().parent))
    from openglue_tpu_torch.ops import kernels
    from openglue_tpu_torch.ops.kernels import gnn_layer_int8 as gli8

    import kernel_times

    kernels.build_all()
    fn = kernels.entry_point("gnn_layer_int8", "og_phases", [ctypes.c_void_p, ctypes.c_int])
    gen = torch.Generator(device="cuda").manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    result = {"card": card}
    buf = (ctypes.c_ulonglong * (SLOTS * CTAS * STAMPS))()
    with torch.no_grad():
        for mode in args.modes:
            layer_args, kw = kernel_times.k7_inputs(gen, mode)
            for _ in range(2):
                gli8.fused_attention_propagation_int8(*layer_args, **kw)
            torch.cuda.synchronize()
            kernels.check(fn(None, 1), "og_phases reset")
            gli8.fused_attention_propagation_int8(*layer_args, **kw)
            torch.cuda.synchronize()
            kernels.check(fn(ctypes.addressof(buf), 0), "og_phases")
            flat = list(buf)
            raw = [[flat[(s * CTAS + c) * STAMPS:(s * CTAS + c + 1) * STAMPS] for c in range(CTAS)]
                   for s in range(SLOTS)]
            result[mode] = summarize(raw)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where K6's attention part spends its time, phase by phase, on a CUDA card.

    python3 scripts/k6_phases.py --repo DIR [--dims 256 128]

The script copies DIR's ``openglue_tpu_torch`` under DIR/build/k6_phases,
inserts ``%globaltimer`` stamps into the copy's
``ops/csrc/gnn_layer_features.cu`` (exact text insertions that must match
once, so a source that moved on fails loudly instead of timing the wrong
thing), builds the copy and runs each kind of K6 (bf16 and f32, B=16
N=M=1024, ragged key masks, F = 2 dh for FAVOR) three times, then reads the
stamps of the last run. It prints one JSON line: the card, and per case the
layer's device ms (the copy, stamps included), the attention launch's span
from its first CTA's start to its last CTA's end, and per phase the mean and
the largest time over the CTAs (us): staging T(proj), FAVOR-softmax's key
pre-pass, the keys, the wait at the cluster barrier, the reduction, the
queries. For each key sweep, thread 0's time in its four steps (the wait for
a chunk, the conversion, issuing the next copies, the products), and for
the query loop warp 0's (the wait for its tile, the A fragments and, for
FAVOR-softmax, the row max, the products, the division and stores). A
timer read after an mma.sync does not wait for it, so the time of the last
products of a step shows in the next step.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import sys
from pathlib import Path

import torch

TIMER = '''__device__ unsigned long long og_phase_t[4096][24];
__device__ __forceinline__ unsigned long long og_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int og_phases(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, og_phase_t, sizeof(og_phase_t));
}
'''

# (anchor, text inserted after it) in gnn_layer_features.cu
AFTER = [
    ("namespace cg = cooperative_groups;\n", TIMER),
    ("  extern __shared__ __align__(16) char smem[];\n",
     "  const int cta_ = blockIdx.y * gridDim.x + blockIdx.x;\n"
     "#define STAMP(k) if (threadIdx.x == 0 && cta_ < 4096) og_phase_t[cta_][k] = og_gtime();\n  STAMP(0)\n"
     "  int sweeps_ = 0;\n"),
]
# (text, replacement)
REPLACE = [
    ("  const float* kb = a.k32 + static_cast<size_t>(b) * M * D + h * DH;\n",
     "  STAMP(1)\n  const float* kb = a.k32 + static_cast<size_t>(b) * M * D + h * DH;\n"),
    ("  // ---- keys: partial KV and ksum of this CTA's chunks, per warp group\n",
     "  STAMP(2)\n  // ---- keys: partial KV and ksum of this CTA's chunks, per warp group\n"),
    ("  __syncthreads();\n  cluster.sync();  // every partial written\n",
     "  __syncthreads();\n  STAMP(3)\n  cluster.sync();  // every partial written\n  STAMP(4)\n"),
    ("  cluster.sync();  // every CTA's KV complete, and no partial read any more: a CTA may leave\n",
     "  cluster.sync();  // every CTA's KV complete, and no partial read any more: a CTA may leave\n  STAMP(5)\n"),
    ("""    for (int c = c_begin; c < c_end; ++c) {
      const int i = c - c_begin;
      cp_async_wait<NV - 2>();
      __syncthreads();  // chunk c has landed; the last chunk's products are done
      if (KIND != kLinear && with_k) {
        convert(c);
        __syncthreads();
      }
      issue(c + NV - 1, i + NV - 1, with_k, with_v);
      body(i, c);
    }
""", """    unsigned long long tw = 0, tc = 0, ti = 0, tb = 0;
    for (int c = c_begin; c < c_end; ++c) {
      const int i = c - c_begin;
      const unsigned long long t0 = og_gtime();
      cp_async_wait<NV - 2>();
      __syncthreads();  // chunk c has landed; the last chunk's products are done
      const unsigned long long t1 = og_gtime();
      if (KIND != kLinear && with_k) {
        convert(c);
        __syncthreads();
      }
      const unsigned long long t2 = og_gtime();
      issue(c + NV - 1, i + NV - 1, with_k, with_v);
      const unsigned long long t3 = og_gtime();
      body(i, c);
      const unsigned long long t4 = og_gtime();
      tw += t1 - t0; tc += t2 - t1; ti += t3 - t2; tb += t4 - t3;
    }
    if (threadIdx.x == 0 && cta_ < 4096 && sweeps_ < 2) {
      og_phase_t[cta_][8 + 4 * sweeps_] = tw; og_phase_t[cta_][9 + 4 * sweeps_] = tc;
      og_phase_t[cta_][10 + 4 * sweeps_] = ti; og_phase_t[cta_][11 + 4 * sweeps_] = tb;
    }
    ++sweeps_;
"""),
    ("""  if (qt < t_end) issue_q(qt, 0);
  for (int buf = 0; qt < t_end; qt += kFeatWarps, buf ^= 1) {
""", """  unsigned long long qa0 = 0, qa1 = 0, qa2 = 0, qa3 = 0, q0, q1, q2, q3;
  if (qt < t_end) issue_q(qt, 0);
  for (int buf = 0; qt < t_end; qt += kFeatWarps, buf ^= 1) {
    q0 = og_gtime();
"""),
    ("""    cp_async_wait<1>();
    __syncwarp();
""", """    cp_async_wait<1>();
    __syncwarp();
    q1 = og_gtime();
"""),
    ("    float o[QH][NT][4] = {}, nrm[QH][2] = {};\n", "    q2 = og_gtime();\n    float o[QH][NT][4] = {}, nrm[QH][2] = {};\n"),
    ("    T* out = a.attn + static_cast<size_t>(b) * N * D + h * DH + 2 * t;\n",
     "    q3 = og_gtime();\n    T* out = a.attn + static_cast<size_t>(b) * N * D + h * DH + 2 * t;\n"),
    ("""    __syncwarp();  // every lane is done with this tile before the next copy into it
  }
}
""", """    __syncwarp();  // every lane is done with this tile before the next copy into it
    const unsigned long long q4 = og_gtime();
    qa0 += q1 - q0; qa1 += q2 - q1; qa2 += q3 - q2; qa3 += q4 - q3;
  }
  if (threadIdx.x == 0 && cta_ < 4096) {
    og_phase_t[cta_][16] = qa0; og_phase_t[cta_][17] = qa1; og_phase_t[cta_][18] = qa2; og_phase_t[cta_][19] = qa3;
  }
  __syncthreads();
  STAMP(6)
}
"""),
]
PHASES = ("proj", "softmax_prepass", "keys", "cluster_wait", "reduce", "queries")


def instrument(repo: Path) -> Path:
    copy = repo / "build" / "k6_phases"
    if copy.exists():
        shutil.rmtree(copy)
    shutil.copytree(repo / "openglue_tpu_torch", copy / "openglue_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = copy / "openglue_tpu_torch" / "ops" / "csrc" / "gnn_layer_features.cu"
    src = path.read_text()
    for anchor, text in AFTER:
        if src.count(anchor) != 1:
            raise SystemExit(f"k6_phases: anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    for old, new in REPLACE:
        if src.count(old) != 1:
            raise SystemExit(f"k6_phases: text not found once: {old[:80]!r}")
        src = src.replace(old, new)
    path.write_text(src)
    return copy


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", type=Path, required=True, help="root of the checkout to profile")
    parser.add_argument("--dims", type=int, nargs="+", default=[256])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k6_phases: no CUDA card is available", file=sys.stderr)
        return 1
    repo = args.repo.resolve()
    copy = instrument(repo)
    sys.path.insert(0, str(copy))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    import kernel_times as kt
    from openglue_tpu_torch.ops import kernels
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk

    kernels.build_all()
    lib = kernels._libs["gnn_layer_features"]
    lib.og_phases.argtypes = [ctypes.c_void_p]
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": kt.card_line(), "cases": {}}
    with torch.no_grad():
        for dim in args.dims:
            for dt in (torch.bfloat16, torch.float32):
                for kind in glk.FEATURE_KINDS:
                    call = kt.k6_inputs(gen, kind, dt, dim=dim)
                    for _ in range(3):
                        glk.fused_attention_propagation(*call)
                    torch.cuda.synchronize()
                    stamps = np.zeros((4096, 24), dtype=np.uint64)
                    kernels.check(lib.og_phases(stamps.ctypes.data), "og_phases")
                    dh, features = dim // 4, (dim // 4 if kind == "linear" else dim // 2)
                    plan = glk.feature_plan(16, 4, 1024, 1024, features, dh, dt == torch.bfloat16, kind)
                    t = stamps[: plan.cluster * 64].astype(np.float64)
                    steps = np.diff(t[:, :7], axis=1) / 1e3
                    ms = statistics.median(kt.device_rounds_ms(lambda call=call: glk.fused_attention_propagation(*call), 5))
                    parts = t[:, 8:20].mean(axis=0) / 1e3
                    out["cases"][f"{kind} {str(dt)[6:]} D={dim}"] = {
                        "layer_ms": ms,
                        "span_us": (t[:, 6].max() - t[:, 0].min()) / 1e3,
                        "phases_us": {name: [steps[:, i].mean(), steps[:, i].max()] for i, name in enumerate(PHASES)},
                        "key_sweeps_us": [dict(zip(("wait", "convert", "issue", "products"), parts[4 * s: 4 * s + 4]))
                                          for s in range(2 if kind == "favor_softmax" else 1)],
                        "queries_warp0_us": dict(zip(("wait", "fragments", "products", "stores"), parts[8:12])),
                    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

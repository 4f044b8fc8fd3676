"""What bounds the on-chip Sinkhorn kernels (K2 forward, K2s wide forward,
K3 adjoint): each timed again with one part of its work taken out, or one
design choice changed, on a CUDA card.

    python3 scripts/sinkhorn_ablations.py --repo DIR [--only NAME ...]

For each variant below the script copies DIR's ``openglue_tpu_torch`` under
DIR/build/ablations/<name>, edits the Sinkhorn sources there (exact text
replacements that must each match once, so a source that moved on fails
loudly instead of timing the wrong thing), builds the two Sinkhorn libraries
of the copy in a process of its own and prints one JSON line per variant:
device ms (``chip_smoke.device_ms``) of K2 at f32 K B=16 and B=1 N=1024, bf16
K B=4 N=2048 and f32 K B=12 N=1024, of K3 at B=12 N=1024 T=20, of K2 at
B=16 N=1024 with 1 and 2 iterations (their difference is one iteration's
time), and of K2s with bf16 K at B=1 N=4352 (also with 1 and 2 iterations)
and B=1 N=8192, each beside the plan it ran. The unedited copy comes first
and is checked against the plain versions; an ablated kernel's outputs are
wrong by design. A part whose removal leaves the time where it was is not
what bounds the kernel; one whose removal cuts the time is, in that share.
The ``k2s:`` variants take K2s apart at N=4352 (66 clusters of 2, 19 rows a
CTA in shared memory and 14 through the ring): its spilled tier, its
exchange, its ring's depth, its cluster size, and K2's engine at the same
shape (the spilled rows read twice per iteration, an exchange that polls
every cluster).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROWS = "openglue_tpu_torch/ops/csrc/sinkhorn_rows.cuh"
FWD = "openglue_tpu_torch/ops/csrc/sinkhorn.cu"

WRAPPER = "openglue_tpu_torch/ops/kernels/sinkhorn_kernel.py"

# K2s's phases, stamped with %globaltimer by thread 0 of each of the first
# 132 CTAs and summed over the calls: the shared rows' rows pass, the sweep
# over the spilled rows, the columns pass, the exchange, and (once per
# element) forming K and the last pass
STAMPS = """
#include <cuda_runtime.h>
__device__ unsigned long long og_phase_ns[132][6];
__device__ __forceinline__ unsigned long long og_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int og_phases(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, og_phase_ns, sizeof(og_phase_ns));
}
"""

ABLATIONS = {
    # the polls for the other clusters' sums (G > 1): one read each, ready or not
    "no polls across clusters": [
        (ROWS, "        } while (!ready);\n", "        } while (false);\n"),
        (ROWS, "      } while (!tagged(a, b, tag));\n", "      } while (false);\n", 2),
    ],
    # the rows pass over shared memory: every row's dot read as 1
    "no rows pass": [
        (ROWS, "    rows_block(ks, n_s, 0, fn);\n",
         "    for (int lr = threadIdx.x; lr < n_s; lr += kStripeThreads) fn(lr, 1.f);\n", 2),
        (ROWS, "      rows_block<2>(ks, n_s, 0, fn);\n",
         "      for (int lr = threadIdx.x; lr < n_s; lr += kStripeThreads) fn(lr, 1.f);\n"),
    ],
    # the columns pass's reads of the stripe: every column sum 0
    "no columns pass reads": [
        (ROWS, "    for (; lr + 4 <= n_s; lr += 4) {\n", "    for (; lr + 4 <= 0; lr += 4) {\n"),
        (ROWS, "    for (; lr < n_s; ++lr) {\n", "    for (; lr < 0; ++lr) {\n"),
    ],
    # K2s's spilled tier: every CTA's spilled rows dropped (no ring, no copy, no dot, no column sums;
    # the shared-memory rows in the rows and columns passes)
    "k2s: no spilled tier": [(ROWS, "    n_o = n - n_s;\n", "    n_o = 0;\n")],
    # the ring's copies: none (the ring's buffers read as they lie)
    "k2s: no ring copies": [
        (ROWS, "      bar_wait(full_bar(b), (q / stages) & 1);\n", ""),
        (ROWS, "    bar_expect(full_bar(b), bytes);\n", ""),
        (ROWS, "    bulk_load(ring + static_cast<size_t>(b) * C, kg + static_cast<size_t>(o) * C, bytes, full_bar(b));\n",
         ""),
    ],
    # K2s's exchange over 66 clusters in one level: every CTA polls every cluster
    "k2s: flat exchange": [(ROWS, "constexpr int kFlatMaxGroups = 8;\n", "constexpr int kFlatMaxGroups = 1 << 20;\n")],
    # a ring of three one-row buffers (two rows in flight while one is read), a row less in shared memory
    "k2s: ring of three": [(ROWS, "    p.stages = 2;\n", "    p.stages = 3;\n")],
    # clusters of 16 only (7 of them, 112 CTAs, 39 rows a CTA, a one-level exchange over 7 clusters)
    "k2s: clusters of 16": [(ROWS, "    for (int i = 4; i >= 1; --i) {\n", "    for (int i = 4; i >= 4; --i) {\n")],
    # the stamps alone (what the variant's line adds is "phases_us": each phase's mean over the CTAs of
    # thread 0's time, per iteration, at B=1 N=4352)
    "k2s: phases (stamped)": [
        (FWD, '#include "sinkhorn_rows.cuh"\n', STAMPS + '#include "sinkhorn_rows.cuh"\n'),
        (FWD, "    st.form_k(Mb);\n", "    unsigned long long tk_ = og_gtime();\n    st.form_k(Mb);\n"),
        (FWD, "    st.ring_prime(total);\n",
         "    st.ring_prime(total);\n    if (threadIdx.x == 0 && blockIdx.x < 132) og_phase_ns[blockIdx.x][4] += og_gtime() - tk_;\n"),
        (FWD, "      st.rows_pass_shared(",
         "      unsigned long long t0_ = og_gtime();\n      st.rows_pass_shared("),
        (FWD, "      st.template sweep<NV>(done, total, [&](int o, float y, const uint4 (&raw)[NV]) {\n",
         "      unsigned long long t1_ = og_gtime();\n"
         "      st.template sweep<NV>(done, total, [&](int o, float y, const uint4 (&raw)[NV]) {\n"),
        (FWD, "      st.template cols_pass_from<NV>(acc);\n",
         "      unsigned long long t2_ = og_gtime();\n      st.template cols_pass_from<NV>(acc);\n"),
        (FWD, "      st.template cols_pass_from<NV>(acc);\n",
         "      st.template cols_pass_from<NV>(acc);\n      unsigned long long t3_ = og_gtime();\n"),
        (FWD, "          });\n    }\n    const auto out = [&](int lr, float y) {\n",
         "          });\n      if (threadIdx.x == 0 && blockIdx.x < 132) {\n"
         "        og_phase_ns[blockIdx.x][0] += t1_ - t0_; og_phase_ns[blockIdx.x][1] += t2_ - t1_;\n"
         "        og_phase_ns[blockIdx.x][2] += t3_ - t2_; og_phase_ns[blockIdx.x][3] += og_gtime() - t3_;\n"
         "      }\n    }\n    unsigned long long tl_ = og_gtime();\n    const auto out = [&](int lr, float y) {\n"),
        (FWD, "    st.ring_seq += static_cast<uint32_t>(total);\n  }\n",
         "    st.ring_seq += static_cast<uint32_t>(total);\n"
         "    if (threadIdx.x == 0 && blockIdx.x < 132) og_phase_ns[blockIdx.x][5] += og_gtime() - tl_;\n  }\n"),
    ],
    # K2's engine at K2s's shapes: spilled rows read from device memory in the rows pass and again in the
    # columns pass, a one-level exchange
    "k2s: K2's engine": [(WRAPPER, "FUSED_MAX_COLS = {torch.float32: 1536, torch.bfloat16: 4096}\n",
                          "FUSED_MAX_COLS = {torch.float32: 1 << 20, torch.bfloat16: 1 << 20}\n")],
}

WORKER = r'''
import json, sys, torch
sys.path.insert(0, sys.argv[2])  # chip_smoke.py of the checkout
sys.path.insert(0, sys.argv[1])  # the edited package, ahead of the checkout's
import chip_smoke as cs
from openglue_tpu_torch.ops import kernels
kernels.SOURCES = ("sinkhorn", "sinkhorn_adjoint")
kernels.build_all()
from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk
check = sys.argv[3] == "check"
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
out, plans, phases = {}, {}, None


def case(batch, n):
    scores = torch.randn(batch, n, n, generator=gen, device=dev) * 4
    mask0 = torch.rand(batch, n, generator=gen, device=dev) > 0.1
    mask1 = torch.rand(batch, n, generator=gen, device=dev) > 0.1
    rows, cp = n + 1, sk._round_up(n + 1, sk.COL_ALIGN)
    M = sk.build_padded_otp_matrix(scores, torch.tensor(1.0, device=dev), 1.0, mask0, mask1, rows, cp)
    la, lb, _ = sk.otp_marginals(batch, n, n, mask0, mask1, dev)
    la, lb = sk.padded_marginals(la, lb, rows, cp)
    return M, la, lb, mask0, mask1


with torch.no_grad():
    for batch, n in ((16, 1024), (1, 1024), (4, 2048), (12, 1024)):
        M, la, lb, _, _ = case(batch, n)
        kd = sk.k_storage_dtype(n + 1, n + 1)
        if check:
            u, ref = sk.sinkhorn_scale(M, la, lb, 20, kd), sk.sinkhorn_scale_plain(M, la, lb, 20, kd)
            assert (u - ref).abs()[la > -1e8].max().item() <= 1e-3
        name = f"K2 {str(kd)[6:]} B={batch} N={n}"
        out[name] = cs.device_ms(lambda: sk.sinkhorn_scale(M, la, lb, 20, kd), 10)
        plans[name] = sk.kernel_plan(batch, *M.shape[1:], kd)[0].__dict__
        if batch == 16:
            for iters in (1, 2):
                out[f"{name} T={iters}"] = cs.device_ms(lambda: sk.sinkhorn_scale(M, la, lb, iters, kd), 10)
    for batch, n in ((1, 4352), (1, 8192)):
        M, la, lb, _, _ = case(batch, n)
        kd = torch.bfloat16
        if check:
            u, ref = sk.sinkhorn_scale(M, la, lb, 20, kd), sk.sinkhorn_scale_plain(M, la, lb, 20, kd)
            assert (u - ref).abs()[la > -1e8].max().item() <= 1e-3
        name = f"K2s bfloat16 B={batch} N={n}"
        out[name] = cs.device_ms(lambda: sk.sinkhorn_scale(M, la, lb, 20, kd), 5)
        wide = sk.forward_route(batch, *M.shape[1:], kd) == "wide"
        plans[name] = (sk.wide_kernel_plan if wide else sk.kernel_plan)(batch, *M.shape[1:], kd)[0].__dict__
        if n == 4352:
            for iters in (1, 2):
                out[f"{name} T={iters}"] = cs.device_ms(lambda: sk.sinkhorn_scale(M, la, lb, iters, kd), 5)
            lib = kernels._libs["sinkhorn"]
            if hasattr(lib, "og_phases"):
                import ctypes
                read = lambda: (lib.og_phases(buf), list(buf))[1]
                buf = (ctypes.c_ulonglong * (132 * 6))()
                torch.cuda.synchronize()
                before = read()
                sk.sinkhorn_scale(M, la, lb, 20, kd)
                torch.cuda.synchronize()
                after = read()
                names = ("rows pass", "sweep", "columns pass", "exchange", "forming K", "last pass")
                ctas = min(132, sk.wide_kernel_plan(batch, *M.shape[1:], kd)[0].grid)
                per = [sum(after[c * 6 + i] - before[c * 6 + i] for c in range(ctas)) / ctas / 1e3
                       for i in range(6)]
                # per iteration; forming K and the last rows pass once per call
                phases = {name: v / (1 if i in (4, 5) else 19) for i, (name, v) in enumerate(zip(names, per))}
        del M
    M, la, lb, mask0, mask1 = case(12, 1024)
    g = torch.zeros_like(M)
    g[:, :, :1025] = torch.randn(12, 1025, 1025, generator=gen, device=dev) * sk.valid_pairs(
        12, 1024, 1024, mask0, mask1, dev)
    rmax = M.amax(dim=2)
    args = (M, la, lb, rmax, g.sum(2), g.sum(1), 20)
    if check:
        (P, Q), (Pr, Qr) = sk.sinkhorn_adjoint(*args), sk.sinkhorn_adjoint_plain(*args)
        prod, ref = torch.bmm(P.transpose(1, 2), Q), torch.bmm(Pr.transpose(1, 2), Qr)
        assert (prod - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    out["K3 B=12 N=1024 T=20"] = cs.device_ms(lambda: sk.sinkhorn_adjoint(*args), 10)
    plans["K3 B=12 N=1024 T=20"] = sk.kernel_plan(12, *M.shape[1:], torch.float32, adjoint=True)[0].__dict__
print(json.dumps({"ms": out, "plans": plans, "phases_us": phases}))
'''


def variant(repo: Path, name: str, edits) -> Path:
    """A copy of repo's package under build/ablations with ``edits`` made."""
    root = repo / "build" / "ablations" / "".join(c if c.isalnum() else "_" for c in name)[:48]
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(repo / "openglue_tpu_torch", root / "openglue_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for source, text, replacement, *count in edits:
        path = root / source
        code = path.read_text()
        if code.count(text) != (count[0] if count else 1):
            raise SystemExit(f"{name}: the text to replace is not in {source} {count[0] if count else 1} time(s): "
                             f"{text!r}")
        path.write_text(code.replace(text, replacement))
    return root


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", type=Path, required=True, help="root of the checkout")
    parser.add_argument("--only", nargs="*", default=None, help="ablation names to run (default: all)")
    args = parser.parse_args()
    repo = args.repo.resolve()
    runs = [("unedited", [], "check")]
    runs += [(name, edits, "time") for name, edits in ABLATIONS.items() if args.only is None or name in args.only]
    for name, edits, check in runs:
        root = variant(repo, name, edits)
        done = subprocess.run([sys.executable, "-c", WORKER, str(root), str(repo), check],
                              capture_output=True, text=True, timeout=600)
        if done.returncode != 0:
            print(json.dumps({"variant": name, "failed": done.stderr[-2000:]}), flush=True)
            if check == "check":
                return 1
            continue
        result = json.loads(done.stdout.strip().splitlines()[-1])
        line = {"variant": name, "ms": {k: round(v, 4) for k, v in result["ms"].items()}}
        if result.get("phases_us"):
            line["phases_us"] = {k: round(v, 3) for k, v in result["phases_us"].items()}
        if check == "check":
            line["plans"] = result["plans"]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

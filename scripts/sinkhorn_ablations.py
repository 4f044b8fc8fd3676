"""What bounds the on-chip Sinkhorn kernels (K2 forward, K3 adjoint): each
timed again with one part of its work taken out, or one design choice
changed, on a CUDA card.

    python3 scripts/sinkhorn_ablations.py --repo DIR [--only NAME ...]

For each variant below the script copies DIR's ``openglue_tpu_torch`` under
DIR/build/ablations/<name>, edits the Sinkhorn sources there (exact text
replacements that must each match once, so a source that moved on fails
loudly instead of timing the wrong thing), builds the two Sinkhorn libraries
of the copy in a process of its own and prints one JSON line per variant:
device ms (``chip_smoke.device_ms``) of K2 at f32 K B=16 and B=1 N=1024, bf16
K B=4 N=2048 and f32 K B=12 N=1024, of K3 at B=12 N=1024 T=20, and of K2 at
B=16 N=1024 with 1 and 2 iterations (their difference is one iteration's
time), each beside the plan it ran. The unedited copy comes first and is
checked against the plain versions; an ablated kernel's outputs are wrong by
design. A part whose removal leaves the time where it was is not what bounds
the kernel; one whose removal cuts the time is, in that share.
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

ABLATIONS = {
    # the polls for the other clusters' sums (G > 1): one read each, ready or not
    "no polls across clusters": [(ROWS, "        } while (!ready);\n", "        } while (false);\n")],
    # the rows pass over shared memory: every row's dot read as 1
    "no rows pass": [
        (ROWS, "    rows_block(ks, n_s, 0, fn);\n",
         "    for (int lr = threadIdx.x; lr < n_s; lr += kStripeThreads) fn(lr, 1.f);\n"),
    ],
    # the columns pass's reads of the stripe: every column sum 0
    "no columns pass reads": [
        (ROWS, "      for (; lr + 4 <= n_s; lr += 4) {\n", "      for (; lr + 4 <= 0; lr += 4) {\n"),
        (ROWS, "      for (; lr < n_s; ++lr) {\n", "      for (; lr < 0; ++lr) {\n"),
    ],
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
out, plans = {}, {}


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
print(json.dumps({"ms": out, "plans": plans}))
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
        if check == "check":
            line["plans"] = result["plans"]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

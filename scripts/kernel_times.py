"""Time the bf16 attention kernels of one checkout of the port on a CUDA card.

    python3 scripts/kernel_times.py --repo DIR [--label NAME] [--rounds 7]

Imports ``openglue_tpu_torch`` from the checkout DIR (its kernels build into
DIR/build/kernels), times the bf16 kernels that attend with heads of width 64
at the shapes of ``chip_smoke.py`` (K1 B=16 N=1024 D=256; K4, K5, K8 B=12
N=1024 D=256; K9, K10 B=12 N=1024 and B=4 N=2048, H=4), and prints one JSON
line: the card (``nvidia-smi`` name and power limit), each kernel's time in ms
as the median of ``--rounds`` rounds of 20 back-to-back calls timed with CUDA
events (every round listed), and the registers and spill bytes per thread
that ``ptxas -v`` reports for the bf16 attention kernels of DIR's sources.

To compare two checkouts on one card, run it in one session in the order
A, B, B, A.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

# the sources whose bf16 attention kernels ptxas reports on, and the kernels
PTXAS_SOURCES = ("gnn_layer", "message_forward", "message_backward", "train_half", "attention", "attention_backward")
PTXAS_KERNELS = ("attention_bf16", "attn_bwd_dq_bf16", "attn_bwd_dkdv_bf16")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rounds_ms(fn, rounds: int, iters: int = 20):
    """Every round's mean device time of ``fn`` in ms over ``iters`` calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return times


def kernel_cases(gen):
    from openglue_tpu_torch.ops.kernels import attention_kernel as ak
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk

    dev, dt = torch.device("cuda"), torch.bfloat16

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def ragged(batch, n, low):
        counts = torch.randint(low, n + 1, (batch,), generator=gen, device=dev)
        return torch.arange(n, device=dev)[None] < counts[:, None]

    cases = {}
    dim, heads = 256, 4
    d2 = 2 * dim
    lw = glk.PropagationWeights(
        r(dim, dim, scale=dim**-0.5).to(dt), r(dim), r(dim, dim, scale=dim**-0.5).to(dt), r(dim),
        r(dim, dim, scale=dim**-0.5).to(dt), r(dim), r(dim, dim, scale=dim**-0.5).to(dt), r(dim),
        r(d2, d2, scale=d2**-0.5).to(dt), r(d2), 1.0 + 0.1 * r(d2), 0.1 * r(d2),
        r(dim, d2, scale=d2**-0.5).to(dt), r(dim),
    )
    xq, xkv, mask = r(16, 1024, dim).to(dt), r(16, 1024, dim).to(dt), ragged(16, 1024, 256)
    cases["K1 B=16 N=1024"] = lambda: glk.fused_attention_propagation(xq, xkv, mask, lw, heads)

    w = glk.MessageWeights(*[r(dim, dim, scale=dim**-0.5) if i % 2 == 0 else r(dim) for i in range(8)])
    mq, mkv, mg, mmask = r(12, 1024, dim).to(dt), r(12, 1024, dim).to(dt), r(12, 1024, dim).to(dt), ragged(12, 1024, 512)
    _, attn, lse = glk.message_forward(mq, mkv, mmask, w, heads, dt)
    cases["K4 B=12 N=1024"] = lambda: glk.message_forward(mq, mkv, mmask, w, heads, dt)
    cases["K5 B=12 N=1024"] = lambda: glk.message_backward(mq, mkv, mmask, w, mg, attn, lse, heads, dt)
    w1, b1 = r(d2, d2, scale=d2**-0.5), r(d2)
    cases["K8 B=12 N=1024"] = lambda: glk.train_half_forward(mq, mkv, mmask, w, w1, b1, heads, False, dt)

    for batch, n in ((12, 1024), (4, 2048)):
        def heads_of():
            return r(batch, n, dim).to(dt).view(batch, n, heads, 64).transpose(1, 2)

        q, k, v, g = heads_of(), heads_of(), heads_of(), heads_of()
        amask = ragged(batch, n, n // 2)
        out, alse = ak.attention_forward(q, k, v, amask)
        cases[f"K9 B={batch} N={n}"] = lambda q=q, k=k, v=v, m=amask: ak.attention_forward(q, k, v, m)
        cases[f"K10 B={batch} N={n}"] = (
            lambda q=q, k=k, v=v, m=amask, g=g, o=out, l=alse: ak.attention_backward(q, k, v, m, g, o, l))
    return cases


def ptxas_usage(repo: Path):
    """{source: {kernel: (registers, spill store bytes, spill load bytes)}}
    for the bf16 attention kernels, from ``nvcc -Xptxas -v``."""
    from openglue_tpu_torch.ops import kernels

    nvcc, cxxfilt = kernels._nvcc(), shutil.which("c++filt")
    csrc, flags = repo / "openglue_tpu_torch" / "ops" / "csrc", [f for f in kernels.NVCC_FLAGS if f != "-shared"]
    scratch = tempfile.mkdtemp(dir=repo / "build")
    procs = {name: subprocess.Popen([nvcc, *flags, "-Xptxas", "-v", "-cubin", "-o", f"{scratch}/{name}.cubin",
                                     str(csrc / f"{name}.cu")],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name in PTXAS_SOURCES}
    usage = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        fn, found = None, {}
        for line in out.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
            if m:
                fn = m.group(1)
                if cxxfilt:
                    fn = subprocess.run([cxxfilt], input=fn, capture_output=True, text=True).stdout.strip()
                continue
            if fn is None or not any(kname in fn for kname in PTXAS_KERNELS):
                continue
            short = re.sub(r"\(.*", "", fn.replace("(anonymous namespace)::", ""))
            entry = found.setdefault(short, [None, None, None])
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                entry[1], entry[2] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                entry[0] = int(m.group(1))
        usage[name] = found if proc.returncode == 0 else {"nvcc failed": out[-2000:]}
    shutil.rmtree(scratch)
    return usage


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", type=Path, required=True, help="root of the checkout to time")
    parser.add_argument("--label", default=None)
    parser.add_argument("--rounds", type=int, default=7)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA card is available", file=sys.stderr)
        return 1
    repo = args.repo.resolve()
    sys.path.insert(0, str(repo))
    from openglue_tpu_torch.ops import kernels

    kernels.build_all()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    with torch.no_grad():
        times = {name: rounds_ms(fn, args.rounds) for name, fn in kernel_cases(gen).items()}
    print(json.dumps({
        "label": args.label or str(repo), "card": card_line(),
        "ms": {name: statistics.median(t) for name, t in times.items()},
        "rounds_ms": times, "ptxas": ptxas_usage(repo),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

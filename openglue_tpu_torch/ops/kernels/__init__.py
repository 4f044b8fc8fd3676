"""Hand-written Hopper kernels of the port and their lazy builder.

Each ``ops/csrc/<name>.cu`` exposes a plain C interface. At the first CUDA
use, every source is compiled with ``nvcc`` for ``sm_90a`` into its own
shared library (all sources at once, one ``nvcc`` process each) under
``build/kernels/`` beside the package, and bound with ``ctypes``. A library
is named after the content hash of its source and of every header under
``ops/csrc/`` that the source includes (directly or through another header),
so an edited source or header rebuilds and an unchanged one is reused.

Every wrapper module keeps a ``LaunchCounter`` that it advances where it
launches its kernel and nowhere else. A kernel that the C code launches from
several entries (the dense GEMMs inside the layer kernels) is counted by the C
code where it launches it, and read through a ``LibraryLaunchCounter``. A
wrapper runs its plain PyTorch version only for a CPU tensor; for a CUDA
tensor it launches the kernel or raises.
There is no shape gate and no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# the head widths the attention kernels are instantiated for (a template
# parameter of every kernel that attends: K1, K4-K11)
HEAD_WIDTHS = (32, 64)

SOURCES = (
    "gnn_layer", "sinkhorn", "sinkhorn_adjoint", "message_forward", "message_backward",
    "gnn_layer_features", "gnn_layer_int8", "attention", "attention_backward", "train_half", "gemm",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[tuple, ctypes._CFuncPtr] = {}
_lock = threading.Lock()
build_seconds: Dict[str, float] = {}


# callables (kernel name, outputs) that ``debugging.checked`` installs while a
# checked function runs: the dispatch mode that checks every aten op cannot
# see inside a kernel launched through ctypes, so each wrapper hands its
# outputs here after the launch
output_checks: list = []


class LaunchCounter:
    """The number of times a wrapper launched its kernel. ``add`` takes the
    launch's outputs for the checks a checked function installs."""

    def __init__(self, name: str = ""):
        self.name = name
        self.count = 0

    def add(self, *outputs: torch.Tensor) -> None:
        self.count += 1
        for check_outputs in output_checks:
            check_outputs(self.name, outputs)

    def reset(self) -> None:
        self.count = 0


class LibraryLaunchCounter:
    """The launches of a kernel that the C code counts where it launches it:
    the sum, over every loaded library whose source includes ``header``, of
    ``symbol(which, reset)``, a C function that returns the library's count
    and with ``reset`` sets it to 0. Reading builds nothing, and reads 0
    before the libraries are loaded."""

    def __init__(self, header: str, symbol: str, which: int):
        self.header, self.symbol, self.which = header, symbol, which

    def _read(self, reset: bool) -> int:
        total = 0
        for name in libraries_including(self.header):
            if name in _libs:
                fn = entry_point(name, self.symbol, [ctypes.c_int, ctypes.c_int], ctypes.c_ulonglong)
                total += fn(self.which, int(reset))
        return total

    @property
    def count(self) -> int:
        return self._read(False)

    def reset(self) -> None:
        self._read(True)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> list:
    """``<name>.cu`` and every header under ``ops/csrc/`` it includes,
    transitively, in a fixed order."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for include in _INCLUDE.findall(path.read_bytes()):
            header = (path.parent / include.decode()).resolve()
            if header.is_file() and CSRC in header.parents:
                todo.append(header)
    return found


@functools.lru_cache(maxsize=None)
def libraries_including(header: str) -> tuple:
    """The sources whose library includes ``ops/csrc/<header>``."""
    path = (CSRC / header).resolve()
    return tuple(name for name in SOURCES if path in source_files(name))


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in source_files(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, float]:
    """Compile every source that has no library yet, all in parallel, and load
    all libraries. Returns the seconds each build took (0.0 when reused)."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return dict(build_seconds)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name in SOURCES:
            target = library_path(name)
            if target.exists():
                build_seconds[name] = 0.0
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                tmp, target, time.perf_counter(),
            )
        failures = []
        for name, (proc, tmp, target, start) in procs.items():
            out, _ = proc.communicate()
            build_seconds[name] = time.perf_counter() - start
            if proc.returncode != 0:
                failures.append(f"{name}.cu:\n{out.decode(errors='replace')}")
            else:
                os.replace(tmp, target)
        if failures:
            raise RuntimeError("nvcc failed\n" + "\n".join(failures))
        for name in SOURCES:
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return dict(build_seconds)


def entry_point(library: str, name: str, argtypes, restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """C function ``name`` of ``ops/csrc/<library>.cu`` (by default returning
    an int status), with its argument types declared (builds on first use)."""
    fn = _entries.get((library, name))
    if fn is None:
        if library not in _libs:
            build_all()
        fn = getattr(_libs[library], name)
        fn.restype = restype
        fn.argtypes = argtypes
        _entries[(library, name)] = fn
    return fn


def check(status: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(message)


def require_head_width(head_dim: int) -> None:
    """Raise unless the kernels are instantiated for heads of width
    ``head_dim``, naming the widths they take."""
    require(
        head_dim in HEAD_WIDTHS,
        f"the kernels take heads of width {' or '.join(map(str, HEAD_WIDTHS))}, got head_dim {head_dim}",
    )


def require_heads(dim: int, num_heads: int) -> int:
    """The head width of a D-wide model with ``num_heads`` heads, or raise
    unless the kernels take it."""
    require(num_heads >= 1 and dim % num_heads == 0, f"D={dim} does not split into {num_heads} heads")
    require_head_width(dim // num_heads)
    return dim // num_heads

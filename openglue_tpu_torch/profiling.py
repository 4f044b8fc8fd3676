"""Profiling and timing utilities (port of ``openglue_tpu/profiling.py``).

* ``trace``: a ``torch.profiler`` context writing a Chrome/Perfetto trace
  file under a directory: CPU activity, plus CUDA activity where a card is
  present.
* ``annotate``: a named range that shows on that timeline
  (``record_function``; on a card also an NVTX range).
* ``device_timeit``: seconds per call of ``fn(x)``, with the JAX version's
  contract: each call's floating inputs perturbed by ``1 + 1e-6 u``, every
  numeric output anchored, and the iteration count grown 8x until the timed
  window passes 50 ms. On CUDA inputs the calls are queued behind
  ``torch.cuda._sleep`` and timed with CUDA events (``device_rounds_ms``), so
  that the window is the card's time and not the host's launch time; on the
  CPU two iteration counts are differenced by ``time.perf_counter``. The JAX
  version runs the calls in a device-side ``fori_loop`` and differences two
  loop counts because its remote TPU's dispatch does not synchronize; a CUDA
  card needs no such workaround, so nothing here corresponds to that loop.
* ``device_ms`` / ``device_rounds_ms``: the queued CUDA-event timing alone,
  in ms per call; ``device_profile`` / ``kernel_rows``: the device time of
  the kernels a function runs (torch.profiler); ``host_profile``: the
  operators by host time.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, List, Optional

import torch
from torch.utils import _pytree as pytree

SLEEP_CYCLES = 40_000_000  # ``torch.cuda._sleep`` ahead of a timed window: about 20 ms of a busy card
WINDOW_S = 0.05  # device_timeit's window must pass this many seconds


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace of the block into a Chrome/Perfetto JSON file
    under ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Timeline annotation: the block's operators and kernels are traced
    under ``name``."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def device_rounds_ms(fn: Callable[[], Any], rounds: int, calls: int = 20) -> List[float]:
    """Every round's device time of ``calls`` back-to-back calls of ``fn``,
    in ms per call, by CUDA events recorded after the card has been held
    busy (``torch.cuda._sleep``) while the host queues every call. A short
    kernel takes the card less time than its launch takes the host, so
    events around calls that start at once would time the host."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return times


def device_ms(fn: Callable[[], Any], calls: int = 20) -> float:
    """Device time of ``calls`` back-to-back calls of ``fn``, in ms per call
    (one round of ``device_rounds_ms``)."""
    return device_rounds_ms(fn, 1, calls)[0]


def _scale_floats(x: Any, s: torch.Tensor) -> Any:
    return pytree.tree_map(lambda a: a * s if torch.is_tensor(a) and a.is_floating_point() else a, x)


def _anchor(out: Any) -> torch.Tensor:
    """The sum of every numeric or bool leaf of ``out``, as one f32 scalar."""
    leaves = [leaf for leaf in pytree.tree_leaves(out) if torch.is_tensor(leaf) or isinstance(leaf, (bool, int, float))]
    if not leaves:
        raise ValueError("fn produced no numeric outputs to anchor timing")
    return sum(leaf.sum().float() if torch.is_tensor(leaf) else float(leaf) for leaf in leaves)


def device_timeit(
    fn: Callable[[Any], Any],
    x: Any,
    iters_low: int = 4,
    iters_high: int = 16,
    perturb: Optional[Callable[[Any, torch.Tensor], Any]] = None,
) -> float:
    """Seconds per call of ``fn(x)``.

    ``x`` is a tree of tensors (lists, tuples, dicts); each call gets
    ``perturb(x, s)`` with ``s = 1 + 1e-6 u`` from a seeded generator (by
    default every floating tensor times ``s``), and every numeric output
    leaf of the call is summed into an anchor, as the JAX version does.
    """
    if perturb is None:
        perturb = _scale_floats
    tensors = [leaf for leaf in pytree.tree_leaves(x) if torch.is_tensor(leaf)]
    device = next((t.device for t in tensors if t.device.type == "cuda"), torch.device("cpu"))
    generator = torch.Generator(device=device).manual_seed(1234)

    def run(n: int) -> Callable[[], torch.Tensor]:
        scales = 1.0 + 1e-6 * torch.rand(n, generator=generator, device=device)

        def calls():
            acc = torch.zeros((), device=device)
            for i in range(n):
                acc = acc + _anchor(fn(perturb(x, scales[i])))
            return acc

        return calls

    def measure(lo: int, hi: int):
        if device.type == "cuda":
            per_call = device_rounds_ms(run(hi), 1, calls=1)[0] / 1e3 / hi
            return per_call, per_call * hi
        times = {}
        for n in (lo, hi):
            calls = run(n)
            float(calls())  # warm
            t0 = time.perf_counter()
            float(calls())
            times[n] = time.perf_counter() - t0
        return (times[hi] - times[lo]) / (hi - lo), times[hi] - times[lo]

    lo, hi = iters_low, iters_high
    for _ in range(5):
        per_call, window = measure(lo, hi)
        if window > WINDOW_S:
            return per_call
        lo, hi = lo * 8, hi * 8
    return per_call


def kernel_rows(prof, top: int = 5):
    """(device ms of the kernels, the ``top`` kernels as (ms, name, calls))
    of a finished torch.profiler run; (None, []) when it saw no kernel. Only
    kernel rows count: a user annotation (such as
    ``Optimizer.step#Adam.step``) carries the device time of the kernels
    inside it again, and copies and memsets are not kernels."""
    rows = []
    for event in prof.key_averages():
        ms = getattr(event, "self_device_time_total", 0.0) / 1e3
        if not str(getattr(event, "device_type", "")).endswith("CUDA") or ms <= 0:
            continue
        annotation = getattr(event, "is_user_annotation", False) or "#" in event.key  # "Optimizer.step#Adam.step"
        if annotation or event.key.startswith(("Memcpy", "Memset")):
            continue
        name = event.key.replace("void ", "").replace("(anonymous namespace)::", "")
        rows.append((ms, name.split("(")[0], event.count))
    rows.sort(reverse=True)
    total = sum(row[0] for row in rows)
    return (total if total > 0 else None), rows[:top]


def device_profile(fn: Callable[[], Any], top: int = 5):
    """Device time of the kernels ``fn`` runs (torch.profiler), in ms, and the
    ``top`` kernels by device time, as ``kernel_rows`` reads them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return kernel_rows(prof, top)


def host_profile(fn: Callable[[], Any], top: int = 6):
    """The ``top`` operators by host (CPU) time that ``fn`` spends outside its
    children, as (ms, name, calls) from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.self_cpu_time_total / 1e3, e.key, e.count) for e in prof.key_averages()]
    return sorted(rows, reverse=True)[:top]

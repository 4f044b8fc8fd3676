"""The port's profiling module on the CPU (``openglue_tpu_torch/profiling.py``),
held to the cases of tests/test_profiling.py: per-call times positive and
growing with the work, integer outputs anchored, a function without
outputs refused, a trace written; and an annotation's name in the
profiler's events."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from openglue_tpu_torch.profiling import annotate, device_timeit, trace


def test_device_timeit_positive_and_scales():
    x = torch.ones(256, 256)
    t_small = device_timeit(lambda a: a @ a, x)
    assert t_small > 0

    big = torch.ones(1024, 1024)
    t_big = device_timeit(lambda a: a @ a, big)
    assert t_big > t_small  # 64x the FLOPs must not be faster


def test_device_timeit_integer_outputs_anchor():
    x = torch.ones(64, 64)
    t = device_timeit(lambda a: torch.argmax(a @ a, dim=1), x)
    assert t > 0


def test_device_timeit_rejects_no_outputs():
    with pytest.raises(ValueError, match="no numeric outputs"):
        device_timeit(lambda a: (), torch.ones(8, 8))


def test_trace_writes_profile(tmp_path):
    with trace(str(tmp_path)):
        torch.ones(32, 32) @ torch.ones(32, 32)
    produced = list(tmp_path.rglob("*"))
    assert produced, "profiler trace produced no files"


def test_annotate_names_the_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("openglue-span"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    assert "openglue-span" in {event.key for event in prof.key_averages()}

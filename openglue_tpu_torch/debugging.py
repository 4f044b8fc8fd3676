"""Numerical-safety checks (port of ``openglue_tpu/debugging.py``; the
reference has no sanitizers).

* ``checked`` runs a function under a ``TorchDispatchMode`` that checks every
  aten op it dispatches, forward and backward (the autograd engine carries
  the mode into the threads it runs the backward on), and raises
  ``CheckError`` at the first violation, naming the op. The checks are the
  JAX package's ``checkify`` checks: a NaN in an op's floating output
  (``"nan"``), a zero divisor of ``div``, ``remainder``, ``fmod`` or
  ``reciprocal`` (``"div"``), and an index out of its axis in an indexing,
  gather or scatter op (``"index"``), which is checked before the op runs.
  The port's CUDA kernels are launched through ctypes, out of the mode's
  sight: each wrapper hands its outputs to the checks after the launch, and
  a NaN there is reported under the kernel's name (K1-K11).
* ``assert_all_finite`` raises if any floating leaf of a tree holds a NaN or
  an infinity.
* ``find_nonfinite`` maps each floating leaf that holds a NaN or an infinity
  to its counts, for post-mortem use.

Tree paths are written as JAX's ``keystr`` writes them: ``['key']`` for a
mapping, ``[i]`` for a sequence, ``.name`` for a dataclass field.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Any, Callable, Dict, Iterator, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

from openglue_tpu_torch.ops import kernels

NAN, DIV, INDEX, USER = "nan", "div", "index", "user"
DEFAULT_CHECKS = frozenset({NAN, DIV, INDEX})
USER_CHECKS = frozenset({USER})


class CheckError(RuntimeError):
    """A check of ``checked`` or ``assert_all_finite`` failed."""


# ops that only allocate or move data: a NaN in their output was made by the
# op that wrote it (or is uninitialized memory), so only computing ops are
# held to the NaN check, as checkify holds only its computing primitives
_MOVES = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "empty_permuted", "resize_",
    "clone", "copy", "copy_", "_to_copy", "detach", "lift_fresh", "lift_fresh_copy", "alias", "_unsafe_view",
    "cat", "stack", "index", "index_select", "gather", "take", "take_along_dim", "slice_scatter",
    "select_scatter", "as_strided_scatter", "diagonal_scatter", "constant_pad_nd", "repeat", "expand_copy",
    "t", "permute", "flip", "roll", "narrow", "split", "split_with_sizes", "unbind", "chunk", "set_",
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros", "new_ones", "new_full",
    "scalar_tensor", "arange", "masked_fill", "masked_fill_", "fill", "fill_", "zero_", "where",
    "_local_scalar_dense", "is_nonzero", "_pin_memory", "record_stream",
}
_DIVIDES = {"div": 1, "div_": 1, "remainder": 1, "remainder_": 1, "fmod": 1, "fmod_": 1,
            "floor_divide": 1, "floor_divide_": 1, "reciprocal": 0, "reciprocal_": 0}
# (position of the index argument, position of the dim argument or None for
# axis 0 of the first argument, whether negative indices wrap)
_INDEXES = {"index_select": (2, 1, False), "gather": (2, 1, False), "scatter": (2, 1, False),
            "scatter_": (2, 1, False), "scatter_add": (2, 1, False), "scatter_add_": (2, 1, False),
            "scatter_reduce": (2, 1, False), "scatter_reduce_": (2, 1, False), "index_add": (2, 1, True),
            "index_add_": (2, 1, True), "index_copy": (2, 1, True), "index_copy_": (2, 1, True),
            "index_fill": (2, 1, True), "index_fill_": (2, 1, True), "embedding": (1, None, False)}


def _tensors(value) -> Iterator[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)


def _has_nan(t: torch.Tensor) -> bool:
    return (t.is_floating_point() or t.is_complex()) and t.numel() > 0 and bool(torch.isnan(t).any())


def _out_of_bounds(index: torch.Tensor, size: int, wraps: bool):
    """The first index outside ``[-size, size)`` (``[0, size)`` unless
    ``wraps``), or None."""
    if index.numel() == 0 or index.dtype == torch.bool:
        return None
    bad = (index < (-size if wraps else 0)) | (index >= size)
    if not bool(bad.any()):
        return None
    return int(index.reshape(-1)[bad.reshape(-1)][0])


class _CheckMode(TorchDispatchMode):
    def __init__(self, errors, seen):
        super().__init__()
        self.errors, self.seen = errors, seen

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        self.seen[name] += 1
        if INDEX in self.errors:
            self._check_indices(func, name, args)
        if DIV in self.errors and name in _DIVIDES:
            divisor = args[_DIVIDES[name]] if len(args) > _DIVIDES[name] else kwargs.get("other")
            zero = bool((divisor == 0).any()) if isinstance(divisor, torch.Tensor) else divisor == 0
            if zero:
                raise CheckError(f"division by zero in {func}")
        out = func(*args, **kwargs)
        if NAN in self.errors and name not in _MOVES and not func.is_view:
            written = [a for a, arg in zip(args, func._schema.arguments)
                       if arg.alias_info is not None and arg.alias_info.is_write]
            for t in [*_tensors(out), *_tensors(written)]:
                if _has_nan(t):
                    raise CheckError(f"nan generated by {func}")
        return out

    def _check_indices(self, func, name, args):
        if name in ("index", "index_put", "index_put_", "_index_put_impl_", "_unsafe_index"):
            found = [(dim, index, args[0].shape[dim]) for dim, index in enumerate(args[1])
                     if isinstance(index, torch.Tensor)]
            wraps = True
        elif name in _INDEXES:
            at, dim_at, wraps = _INDEXES[name]
            if dim_at is None:
                found = [(0, args[at], args[0].shape[0])]
            else:
                dim = args[dim_at] % max(args[0].dim(), 1)
                found = [(dim, args[at], args[0].shape[dim] if args[0].dim() else 1)]
        elif name == "embedding_dense_backward":
            found, wraps = [(0, args[1], args[2])], False
        else:
            return
        for dim, index, size in found:
            bad = _out_of_bounds(index, size, wraps)
            if bad is not None:
                raise CheckError(f"out-of-bounds index in {func}: index {bad} for axis {dim} of size {size}")


def _kernel_output_check(name: str, outputs) -> None:
    with _disable_current_modes():
        for i, t in enumerate(outputs):
            if isinstance(t, torch.Tensor) and _has_nan(t):
                raise CheckError(f"nan generated by the {name} kernel (output {i})")


def checked(fn: Callable, errors=DEFAULT_CHECKS) -> Callable:
    """``fn`` with the checks of ``errors`` (a set of ``"nan"``, ``"div"``,
    ``"index"``, ``"user"``) on every aten op it runs and on the outputs of
    every kernel it launches; the first violation raises ``CheckError``.
    ``"user"`` checks (``assert_all_finite``) raise whether or not they run
    inside ``checked``. The wrapper's ``seen`` counts the aten ops of its
    last call by name (the backward's among them)."""
    errors = frozenset(errors)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        wrapper.seen = collections.Counter()
        hooked = NAN in errors
        if hooked:
            kernels.output_checks.append(_kernel_output_check)
        try:
            with _CheckMode(errors, wrapper.seen):
                return fn(*args, **kwargs)
        finally:
            if hooked:
                kernels.output_checks.remove(_kernel_output_check)

    wrapper.seen = collections.Counter()
    return wrapper


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, value in enumerate(tree):
            yield from _leaves(value, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for field in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, field.name), f"{path}.{field.name}")
    elif hasattr(tree, "_fields"):  # a named tuple
        for field in tree._fields:
            yield from _leaves(getattr(tree, field), f"{path}.{field}")
    elif tree is not None:
        yield path, tree


def _floating(leaf):
    """The leaf as a floating tensor, or None (an integer, boolean or
    non-numeric leaf such as a transformation's kind)."""
    if isinstance(leaf, (str, bytes)):
        return None
    t = torch.as_tensor(leaf)
    return t if t.is_floating_point() else None


def assert_all_finite(tree: Any, name: str = "value") -> None:
    """Raise ``CheckError`` if any floating leaf of ``tree`` holds a NaN or an
    infinity."""
    with _disable_current_modes():
        for path, leaf in _leaves(tree):
            t = _floating(leaf)
            if t is not None and not bool(torch.isfinite(t).all()):
                raise CheckError(f"non-finite values in {name}{path}")


def find_nonfinite(tree: Any) -> Dict[str, Dict[str, int]]:
    """Map of leaf path -> {"nan", "inf", "size"} counts, for the floating
    leaves that hold a NaN or an infinity."""
    report: Dict[str, Dict[str, int]] = {}
    with _disable_current_modes():
        for path, leaf in _leaves(tree):
            t = _floating(leaf)
            if t is None:
                continue
            nan, inf = int(torch.isnan(t).sum()), int(torch.isinf(t).sum())
            if nan or inf:
                report[path] = {"nan": nan, "inf": inf, "size": t.numel()}
    return report

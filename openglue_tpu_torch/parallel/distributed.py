"""Process-group start-up and the collectives that autograd crosses (port of
``openglue_tpu/parallel/distributed.py``; the collectives are what
``lax.ppermute``, ``psum``, ``pmax`` and GSPMD's gathers do in the JAX package).

``initialize`` starts ``torch.distributed`` with NCCL for ``device_type="cuda"``
and gloo for ``"cpu"``, or with the ``backend`` its caller names (gloo on
"cuda" puts several ranks on one card, which NCCL refuses); nothing falls back
from one to the other. The caller gives the address
(``tcp://127.0.0.1:<port>``), the world size and the rank, or a launcher such
as torchrun names the job in the environment (``MASTER_ADDR``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``).

A data x model mesh has three groups (``MeshGroups``): the ``data`` group
(ranks that hold other rows of the global batch), the ``model`` group (ranks
that hold other keypoints of the same rows: the ring) and the whole world,
over which the gradients, the BatchNorm statistics and the loss's value are
summed.

Several ranks on one card run over gloo (NCCL refuses two ranks on one
device). Gloo all-reduces, broadcasts and all-gathers CUDA tensors (it copies
them through the host itself), but its point-to-point send and receive hand
the device pointer to the socket and fail ("writev: Bad address"). So
``_exchange``, the ring's transport, stages CUDA tensors through pinned host
buffers whenever the group's backend is gloo: the one layout that puts two
ranks of a ``model`` axis on one card. NCCL exchanges device memory directly.
``traffic`` counts the bytes each collective of this module sends from this
rank, the staged bytes apart.

The differentiable collectives follow one rule: each rank's loss is its share
of the global loss (the shares sum to it), and each collective's backward is
its transpose: a SUM all-reduce all-reduces the cotangents, an all-gather
keeps this rank's slice of the summed cotangent, a rotation rotates the
cotangent back. The parameter gradients summed over the ranks are then the
global loss's.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist


traffic = collections.Counter()  # bytes sent by this rank: "all_reduce", "all_gather", "exchange", "staged"


def _sent(kind: str, tensors) -> None:
    traffic[kind] += sum(t.numel() * t.element_size() for t in tensors)


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device_type: str = "cuda",
    backend: Optional[str] = None,
) -> bool:
    """Start the default process group: ``backend``, else NCCL on "cuda" and
    gloo on "cpu". Returns True when a group is (or already was) initialized,
    False when nothing names a job (no arguments and no ``MASTER_ADDR``); a
    ``WORLD_SIZE`` above 1 without ``MASTER_ADDR`` raises. On "cuda" the
    process takes the card ``LOCAL_RANK`` (or its rank modulo the cards)."""
    if dist.is_initialized():
        return True
    if init_method is None and world_size is None and "MASTER_ADDR" not in os.environ:
        named = int(os.environ.get("WORLD_SIZE", "1"))
        if named > 1:
            raise RuntimeError(f"WORLD_SIZE={named} names a job of {named} processes, but MASTER_ADDR is not "
                               "set: start the job with a launcher such as torchrun")
        return False
    backend = backend or {"cuda": "nccl", "cpu": "gloo"}[device_type]
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return True


def data_parallel_world_size() -> int:
    """The number of processes the job trains on: ``torch.distributed``'s
    world size when it is initialized, else ``WORLD_SIZE`` as a launcher
    such as torchrun sets it, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def is_main_process() -> bool:
    """Rank 0 of ``torch.distributed`` when it is initialized, else the one
    process: the process that writes logs, configs and checkpoints."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Every process of the job meets here."""
    if dist.is_initialized():
        dist.barrier()


def broadcast_from_first(tensors: Sequence[torch.Tensor], group) -> None:
    """Overwrite each tensor, in place, with its value on the group's first
    rank: one broadcast per dtype and device of flat copies."""
    by_kind = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    src = dist.get_global_rank(group, 0)
    for same in by_kind.values():
        flat = torch.cat([t.detach().reshape(-1) for t in same])
        dist.broadcast(flat, src=src, group=group)
        with torch.no_grad():
            for t, part in zip(same, torch.split(flat, [t.numel() for t in same])):
                t.copy_(part.view_as(t))


@dataclasses.dataclass(frozen=True)
class MeshGroups:
    """The process groups a training step reduces over; each is None where
    it would hold one rank. ``data``: the ranks holding other rows of the
    global batch; ``model``: the ranks holding other keypoints of the same
    rows (the ring); ``world``: every rank of the mesh."""

    data: Optional[Any] = None
    model: Optional[Any] = None
    world: Optional[Any] = None

    @property
    def data_size(self) -> int:
        return 1 if self.data is None else dist.get_world_size(self.data)

    @property
    def data_rank(self) -> int:
        return 0 if self.data is None else dist.get_rank(self.data)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        _sent("all_reduce", [y])
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, on every rank; differentiable
    (JAX's ``psum``)."""
    return _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the group's ranks, detached (JAX's ``pmax``
    under ``stop_gradient``)."""
    y = x.detach().contiguous().clone()
    _sent("all_reduce", [y])
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def all_reduce_min(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise min over the group's ranks, detached."""
    y = x.detach().contiguous().clone()
    _sent("all_reduce", [y])
    dist.all_reduce(y, op=dist.ReduceOp.MIN, group=group)
    return y


class _MaxOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = all_reduce_max(x, group)
        holds = (x == y).to(x.dtype)
        ctx.group = group
        ctx.save_for_backward(holds / all_reduce_sum(holds, group).clamp(min=1.0))
        return y

    @staticmethod
    def backward(ctx, g):
        (share,) = ctx.saved_tensors
        return _AllReduceSum.apply(g, ctx.group) * share, None


def max_over(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the group's ranks, on every rank;
    differentiable as the max of the ranks' values concatenated is: the
    cotangents summed over the ranks go to the rank that holds the maximum
    (shared evenly where several ranks hold it)."""
    return _MaxOver.apply(x, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.length = group, dim, x.shape[dim]
        wire = x.contiguous()
        wire = wire.view(torch.uint8) if wire.dtype == torch.bool else wire
        parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
        _sent("all_gather", [wire])
        dist.all_gather(parts, wire, group=group)
        return torch.cat(parts, dim=dim).view(x.dtype)

    @staticmethod
    def backward(ctx, g):
        total = _AllReduceSum.apply(g, ctx.group)
        start = dist.get_rank(ctx.group) * ctx.length
        return total.narrow(ctx.dim, start, ctx.length), None, None


def all_gather(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order, on every
    rank; differentiable (the backward keeps this rank's slice of the summed
    cotangent). A bool tensor travels as bytes."""
    return _AllGather.apply(x, group, dim)


def _exchange(tensors: Sequence[torch.Tensor], group, shift: int):
    """Send each tensor to the rank ``shift`` ahead in the group and receive
    its counterpart from the rank ``shift`` behind, in one batch. Over gloo
    CUDA tensors travel through pinned host buffers: one copy out before the
    exchange and one copy in after it."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (rank + shift) % size)
    src = dist.get_global_rank(group, (rank - shift) % size)
    sent = [t.contiguous() for t in tensors]
    staged = sent[0].is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in sent]
        for h, t in zip(host, sent):
            h.copy_(t)
        sent = host
        _sent("staged", sent)
    _sent("exchange", sent)
    received = [torch.empty(t.shape, dtype=t.dtype, device=t.device, pin_memory=staged) for t in sent]
    ops = [dist.P2POp(dist.isend, t, dst, group) for t in sent]
    ops += [dist.P2POp(dist.irecv, t, src, group) for t in received]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        received = [r.to(tensors[0].device, non_blocking=True) for r in received]
    return received


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        ctx.floating = [t.is_floating_point() for t in tensors]
        wire = [t if t.is_floating_point() else t.view(torch.uint8) for t in tensors]
        received = _exchange(wire, group, 1)
        out = [r if f else r.view(t.dtype) for r, t, f in zip(received, tensors, ctx.floating)]
        ctx.mark_non_differentiable(*[o for o, f in zip(out, ctx.floating) if not f])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        floating = [g for g, f in zip(grads, ctx.floating) if f]
        back = iter(_exchange(floating, ctx.group, -1))
        return (None, *[next(back) if f else None for f in ctx.floating])


def rotate(group, *tensors: torch.Tensor):
    """Every rank sends its tensors to the next rank of the group and takes
    the previous rank's (JAX's ``ppermute`` with ``j -> j + 1``); a bool
    tensor travels as bytes. Differentiable in the floating tensors: the
    backward rotates their cotangents the other way."""
    return _Rotate.apply(group, *tensors)

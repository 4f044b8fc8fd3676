"""Device mesh over the processes of a ``torch.distributed`` job (port of
``openglue_tpu/parallel/mesh.py``).

Each process drives one device; a mesh names axes over the processes. The
``model`` axis carries keypoint-axis context parallelism (the ring schedule of
``parallel/ring.py``, chosen by ``SuperGlueConfig.ring_axis``). The ``data``
axis keeps its name for the batch axis; data parallelism is not ported yet.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(axis_sizes: Optional[Mapping[str, int]] = None, device_type: str = "cuda") -> DeviceMesh:
    """A mesh over every process of the initialized job (``distributed.
    initialize``). ``axis_sizes`` maps axis name -> size; one axis may be -1
    to take the remaining processes. Default: every process on ``data``.
    ``device_type`` is "cuda" (NCCL) or "cpu" (gloo)."""
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {DATA_AXIS: world}
    names = tuple(axis_sizes)
    sizes = [int(s) for s in axis_sizes.values()]
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = world // max(known, 1)
    if math.prod(sizes) != world:
        raise ValueError(f"Mesh {dict(zip(names, sizes))} needs {math.prod(sizes)} processes, have {world}")
    return init_device_mesh(device_type, tuple(sizes), mesh_dim_names=names)

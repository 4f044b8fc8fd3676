"""Tensor parallelism of the port (``openglue_tpu_torch.parallel.tensor_parallel``)
against the JAX package's (``openglue_tpu/parallel/tensor_parallel.py``,
tests/test_tensor_parallel.py): the shard rules name the tensors JAX's
PartitionSpecs shard, along the same axis once the weights' layout is
carried over; ``shard_params_tp``'s slices put back together are the state
dict; and the TP forward over two gloo processes (spawned once for the
module, one thread each) matches the replicated forward within 1e-5, as the
JAX test holds GSPMD's, and JAX's single-device forward within 2e-4 (the
ring model's bar), with and without ``use_pallas``."""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from openglue_tpu.data.synthetic import SyntheticHomographyPairs as JaxPairs
from openglue_tpu.models.superglue import SuperGlue as JaxSuperGlue
from openglue_tpu.models.superglue import SuperGlueConfig as JaxConfig
from openglue_tpu.parallel.tensor_parallel import matcher_param_pspecs as jax_matcher_param_pspecs
from openglue_tpu.train.step import superglue_inputs as jax_superglue_inputs
from openglue_tpu_torch.compat.jax_weights import jax_variables_from_state_dict, superglue_state_dict_from_jax
from openglue_tpu_torch.models.superglue import SuperGlue, SuperGlueConfig
from openglue_tpu_torch.parallel import tensor_parallel as tp
from openglue_tpu_torch.parallel.mesh import MODEL_AXIS

REPO = Path(__file__).resolve().parents[1]
MODEL = dict(descriptor_dim=64, pe_hidden_layers_sizes=(32,), num_stages=2, num_heads=4, otp_num_iters=8,
             residual=True)
WORLD = 2

_WORKER = textwrap.dedent(
    """
    import sys
    from pathlib import Path
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)

    rank, world, port, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
    from openglue_tpu_torch import parallel
    from openglue_tpu_torch.models.superglue import SuperGlue, SuperGlueConfig
    from openglue_tpu_torch.parallel import tensor_parallel as tp

    assert parallel.initialize(f"tcp://127.0.0.1:{port}", world, rank, device_type="cpu")
    mesh = parallel.make_mesh({"model": world}, device_type="cpu")
    inputs = {k: torch.from_numpy(v) for k, v in np.load(root / "inputs.npz").items()}
    out = {}
    for use_pallas in (False, True):
        model = SuperGlue(SuperGlueConfig(**CONFIG, use_pallas=use_pallas), device="cpu")
        model.load_state_dict(torch.load(root / "weights.pt"))
        tp.shard_model_tp(model.eval(), mesh)
        with torch.no_grad():
            res = tp.tp_forward(model, **inputs)
        for key in ("scores", "context_descriptors0", "context_descriptors1"):
            out[f"{key}_{int(use_pallas)}"] = res[key].numpy()
    for name, t in model.state_dict().items():
        if t.is_floating_point():
            out[f"shard:{name}"] = t.numpy()
    np.savez(root / f"out{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
    """
)


class _Mesh:
    """The parts of a device mesh that ``shard_params_tp`` reads, for one
    rank of a ``model`` axis, without a process group."""

    def __init__(self, size, rank):
        self.mesh_dim_names, self._size, self._rank = (MODEL_AXIS,), size, rank

    def size(self, dim):
        return self._size

    def get_local_rank(self, name):
        return self._rank


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _weights(**changes):
    cfg = SuperGlueConfig(**MODEL, **changes)
    return cfg, SuperGlue(cfg, device="cpu", generator=torch.Generator().manual_seed(1)).state_dict()


def _inputs():
    batch = JaxPairs(num_keypoints=64, descriptor_dim=MODEL["descriptor_dim"]).sample(jax.random.key(0), 2)
    return {k: np.array(v) for k, v in jax_superglue_inputs(batch).items() if k != "train"}


def _markers(specs, tree):
    """Each leaf of ``tree`` as 0 where its spec replicates it, else as
    1 + its index along the sharded axis, broadcast over the others."""
    def mark(spec, leaf):
        shape = np.shape(leaf)
        axes = [i for i, name in enumerate(tuple(spec)) if name is not None]
        if not axes:
            return np.zeros(shape, np.float32)
        view = [1] * len(shape)
        view[axes[0]] = shape[axes[0]]
        return np.broadcast_to(1.0 + np.arange(shape[axes[0]], dtype=np.float32).reshape(view), shape).copy()

    return jax.tree_util.tree_map(mark, specs, tree, is_leaf=lambda x: isinstance(x, P))


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """(inputs, the weights, JAX's single-device forward, the 2 ranks'
    results)."""
    root = tmp_path_factory.mktemp("tensor_parallel")
    inputs = _inputs()
    cfg, weights = _weights()
    np.savez(root / "inputs.npz", **inputs)
    torch.save(weights, root / "weights.pt")
    code = f"CONFIG = {MODEL!r}\n" + _WORKER
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("MASTER_ADDR", None)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(WORLD), str(port), str(root)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(WORLD)]
    try:
        model = JaxSuperGlue(JaxConfig(**MODEL))
        variables = jax_variables_from_state_dict(weights, cfg)
        ref = jax.jit(lambda v, b: model.apply(v, **b)["scores"])(variables, inputs)
        logs = [p.communicate(timeout=300)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:  # a rank that failed leaves the other waiting in a collective
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    ranks = [dict(np.load(root / f"out{r}.npz")) for r in range(WORLD)]
    return inputs, weights, np.asarray(ref), ranks


def test_shard_rules_name_the_tensors_jax_shards():
    """Every tensor of the port's state dict is sharded, and along which
    dimension, as JAX's ``matcher_param_pspecs`` shards its counterpart
    (the BatchNorm statistics as the scale beside them): JAX's specs are
    written into the tensors as markers and carried over by
    ``compat.jax_weights``, which transposes the dense kernels."""
    cfg, weights = _weights()
    variables = jax_variables_from_state_dict(weights, cfg)
    params = _markers(jax_matcher_param_pspecs(variables["params"]), variables["params"])
    stat_specs = jax.tree_util.tree_map(lambda _: P(), variables["batch_stats"])
    for layer, tree in stat_specs["attention_gnn"].items():  # the statistics follow their scale
        scale_spec = jax_matcher_param_pspecs(variables["params"])["attention_gnn"][layer]["ffn"]["bn_0"]["scale"]
        tree["ffn"]["bn_0"] = {"mean": scale_spec, "var": scale_spec}
    stats = _markers(stat_specs, variables["batch_stats"])
    carried = superglue_state_dict_from_jax({"params": params, "batch_stats": stats}, cfg)
    rules = tp.matcher_param_pspecs(weights)
    assert set(rules) == set(carried)
    for name, marker in carried.items():
        varying = [d for d in range(marker.dim()) if marker.shape[d] > 1 and marker.amax(d).ne(marker.amin(d)).any()]
        assert varying == ([] if rules[name] is None else [rules[name]]), name
        assert (rules[name] is None) == (not marker.any().item()), name
    sharded = {name for name, dim in rules.items() if dim is not None}
    assert len(sharded) == 2 * MODEL["num_stages"] * 14  # q, k, v, out, the two denses and the BatchNorm
    assert rules["attention_gnn.layers.0.module.mha.in_proj_q.weight"] == tp.COLUMN
    assert rules["attention_gnn.layers.0.module.mha.out_proj.weight"] == tp.ROW
    assert rules["attention_gnn.layers.0.module.mha.out_proj.bias"] is None
    assert rules["positional_encoding.encoder.0.weight"] is None


@pytest.mark.parametrize("size", [2, 4])
def test_shard_params_tp_slices_put_back_together(size):
    """Each rank's shard holds whole heads and 1/size of the FFN's hidden
    channels; the shards concatenated along the rule's dimension are the
    state dict, and a replicated entry is the same tensor on every rank."""
    _, weights = _weights()
    shards = [tp.shard_params_tp(weights, _Mesh(size, r)) for r in range(size)]
    for name, value in weights.items():
        dim = tp.shard_dim(name)
        if dim is None:
            assert all(s[name] is value for s in shards), name
        else:
            assert torch.equal(torch.cat([s[name] for s in shards], dim), value), name
    q = shards[0]["attention_gnn.layers.1.module.mha.in_proj_q.weight"]
    assert q.shape == (MODEL["descriptor_dim"] // size, MODEL["descriptor_dim"], 1)
    with pytest.raises(ValueError, match="does not divide"):
        tp.shard_params_tp(weights, _Mesh(3, 0))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_tp_forward_matches_the_replicated_forward(tp_run, use_pallas):
    """Two ranks, each with 2 of the 4 heads and half the FFN's hidden
    channels (the attention through the kernel's plain version with
    ``use_pallas``): the log-assignment and the context descriptors within
    1e-5 of the replicated forward (the JAX test's bar), the scores within
    2e-4 of JAX's single-device forward, the same on both ranks."""
    inputs, weights, jax_scores, ranks = tp_run
    model = SuperGlue(SuperGlueConfig(**MODEL, use_pallas=use_pallas), device="cpu")
    model.load_state_dict(weights)
    with torch.no_grad():
        ref = model.eval()(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    for key in ("scores", "context_descriptors0", "context_descriptors1"):
        got = ranks[0][f"{key}_{int(use_pallas)}"]
        np.testing.assert_allclose(got, ref[key].numpy(), atol=1e-5, err_msg=key)
        np.testing.assert_array_equal(ranks[1][f"{key}_{int(use_pallas)}"], got)
    np.testing.assert_allclose(ranks[0][f"scores_{int(use_pallas)}"], jax_scores, atol=2e-4)


def test_tp_model_holds_its_shard_only(tp_run):
    """After ``shard_model_tp`` each rank's model holds its slice of every
    sharded tensor and the whole of every other."""
    _, weights, _, ranks = tp_run
    for r, res in enumerate(ranks):
        for name, value in weights.items():
            if not value.is_floating_point():
                continue
            dim = tp.shard_dim(name)
            want = value if dim is None else value.chunk(WORLD, dim)[r]
            np.testing.assert_array_equal(res[f"shard:{name}"], want.numpy(), err_msg=name)


def test_tp_forward_refuses_a_training_model():
    cfg, weights = _weights()
    model = SuperGlue(cfg, device="cpu")
    with pytest.raises(ValueError, match="eval forward"):
        tp.tp_forward(model.train(), **{k: torch.from_numpy(v) for k, v in _inputs().items()})

"""The cache key of the kernel build (ops/kernels/__init__.py): a library is
named after its source and every header it includes, so that an edited
header rebuilds every library that uses it and no other."""

import shutil

from openglue_tpu_torch.ops import kernels

LAYER_SOURCES = {
    "gnn_layer", "message_forward", "message_backward", "gnn_layer_features", "gnn_layer_int8",
    "attention", "attention_backward", "train_half", "gemm",
}
SINKHORN_SOURCES = {"sinkhorn", "sinkhorn_adjoint"}


def test_every_source_has_its_headers():
    names = {name: {p.name for p in kernels.source_files(name)} for name in kernels.SOURCES}
    assert set(kernels.SOURCES) == LAYER_SOURCES | SINKHORN_SOURCES
    tiles = {"tf32_tiles.cuh", "mma.cuh"}  # the f32 attention's 3xTF32 tiles
    hopper = "hopper.cuh"  # TMA, mbarriers and wgmma of the bf16 GEMM and attention (forward and backward)
    assert names["gnn_layer"] == {"gnn_layer.cu", "attention.cuh", "gemm.cuh", hopper, *tiles}
    assert names["message_backward"] == {
        "message_backward.cu", "attention_backward.cuh", "gemm.cuh", "tn_gemm.cuh", hopper, *tiles
    }
    assert names["attention"] == {"attention.cu", "attention.cuh", hopper, *tiles}
    assert names["attention_backward"] == {"attention_backward.cu", "attention_backward.cuh", hopper, *tiles}
    assert names["train_half"] == {"train_half.cu", "attention.cuh", "gemm.cuh", hopper, *tiles}
    assert names["gnn_layer_features"] == {"gnn_layer_features.cu", "gemm.cuh", hopper, "mma.cuh"}
    assert names["gnn_layer_int8"] == {"gnn_layer_int8.cu", "attention.cuh", hopper, *tiles}
    assert names["sinkhorn_adjoint"] == {"sinkhorn_adjoint.cu", "sinkhorn_rows.cuh"}
    assert names["gemm"] == {"gemm.cu", "gemm.cuh", "tn_gemm.cuh", hopper, "mma.cuh"}  # the dense GEMMs alone


def _names(csrc, monkeypatch):
    monkeypatch.setattr(kernels, "CSRC", csrc)
    return {name: kernels.library_path(name).name for name in kernels.SOURCES}


def test_editing_a_header_renames_exactly_its_libraries(tmp_path, monkeypatch):
    csrc = (tmp_path / "csrc").resolve()
    shutil.copytree(kernels.CSRC, csrc)
    first = _names(csrc, monkeypatch)
    assert _names(csrc, monkeypatch) == first  # unchanged sources keep their libraries

    (csrc / "mma.cuh").write_text((csrc / "mma.cuh").read_text() + "\n// edited\n")
    second = _names(csrc, monkeypatch)
    assert {n for n in first if first[n] != second[n]} == LAYER_SOURCES  # through gemm/attention

    (csrc / "sinkhorn_rows.cuh").write_text((csrc / "sinkhorn_rows.cuh").read_text() + "\n")
    third = _names(csrc, monkeypatch)
    assert {n for n in first if second[n] != third[n]} == SINKHORN_SOURCES


def test_editing_the_hopper_header_renames_exactly_its_libraries(tmp_path, monkeypatch):
    """hopper.cuh (TMA, mbarriers, wgmma) is included by every layer
    library, the bf16 attention backward's too (through
    attention_backward.cuh): an edit to it rebuilds all of them and leaves
    the Sinkhorn kernels' as they were."""
    csrc = (tmp_path / "csrc").resolve()
    shutil.copytree(kernels.CSRC, csrc)
    first = _names(csrc, monkeypatch)
    (csrc / "hopper.cuh").write_text((csrc / "hopper.cuh").read_text() + "\n// edited\n")
    second = _names(csrc, monkeypatch)
    assert {n for n in first if first[n] != second[n]} == LAYER_SOURCES
    kernels.libraries_including.cache_clear()
    try:
        assert set(kernels.libraries_including("hopper.cuh")) == LAYER_SOURCES
    finally:
        kernels.libraries_including.cache_clear()

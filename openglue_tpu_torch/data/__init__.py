"""Data: datasets, loaders, samplers, collates and the synthetic pair
generators (port of ``openglue_tpu/data``)."""

from openglue_tpu_torch.data.synthetic import (
    SyntheticHomographyPairs,
    SyntheticReprojectionPairs,
    random_pair_batch,
)

__all__ = ["SyntheticHomographyPairs", "SyntheticReprojectionPairs", "random_pair_batch"]

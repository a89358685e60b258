"""Model registry: the model named in a config tree
(lidog_tpu/models/registry.py:17-60)."""

from __future__ import annotations

import torch

from lidog_tpu_torch.models.minkunet import MinkUNet34
from lidog_tpu_torch.models.minkunet_bev import MinkUNet34BEV
from lidog_tpu_torch.models.minkunet_ibn import MinkUNet34IBN
from lidog_tpu_torch.models.minkunet_robustnet import MinkUNet34Robust

_MODELS = {"MinkUNet34": MinkUNet34, "MinkUNet34IBN": MinkUNet34IBN,
           "MinkUNet34Robust": MinkUNet34Robust}


def precision_dtype(config):
    """`pipeline.precision` (Lightning's 32 / 16 / 'bf16') -> the compute
    dtype; 16 means bfloat16, as in lidog_tpu."""
    p = str(getattr(config.pipeline, "precision", 32)).lower()
    return (torch.bfloat16 if p in ("16", "bf16", "bfloat16", "b16")
            else torch.float32)


def get_model(config, num_batches: int = 4, generator=None):
    """Build config.model at full width with random weights (from
    `generator`).  The models' bn_momentum is not read: lidog_tpu's norms
    never take it (ROADMAP section 3)."""
    m = config.model
    common = dict(in_channels=m.in_channels, out_channels=m.out_channels,
                  compute_dtype=precision_dtype(config), generator=generator)
    if m.name in _MODELS:
        return _MODELS[m.name](**common)
    if m.name == "MinkUNet34BEV":
        scaling = getattr(m, "scaling_factors", None)
        return MinkUNet34BEV(
            decoder_2d_levels=tuple(getattr(m, "decoder_2d_levels",
                                            ["block8"])),
            scaling_factors=tuple(scaling) if scaling else None,
            binary_seg=getattr(m, "binary_segmentation_layer", False),
            bound_2d=getattr(config.pipeline, "bound_2d", 50.0),
            voxel_size=config.source_dataset.voxel_size,
            num_batches=num_batches, **common)
    raise NotImplementedError(f"unknown model {m.name!r}")

"""MinkUNet34BEV, LiDOG's model: the sparse 3D U-Net plus a dense BEV
decoder per configured level (lidog_tpu/models/minkunet_bev.py:34,44).

In training (`is_train=True`) each level in `decoder_2d_levels` takes its
backbone tap, scatters it into the pooled BEV grid (ops/bev.py, kernels
KI/KJ) and runs an `Encoder2D` head (models/conv2d.py) to BEV logits; the
forward returns (3D logits, {level: BEV logits}).  Otherwise the BEV
branch is skipped and the dict is empty.

Taps (stride, channels at full width): 'bottle' is the block5 output
(8, 256), 'block6' (4, 128), 'block7' (2, 96), 'block8' (1, 96).  A level's
scaling factor s pools with MaxPool(5, int(3 / s), 1).  Parameter names
follow the flax module: `backbone.*` and `encoder2d_{level}.*`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from lidog_tpu_torch.core.sparse import SparseTensor
from lidog_tpu_torch.models.conv2d import Encoder2D
from lidog_tpu_torch.models.minkunet import MinkUNetBackbone, Plan
from lidog_tpu_torch.ops.bev import bev_scatter_pooled, pooled_size

TAP_LEVEL = {"bottle": 3, "block6": 2, "block7": 1, "block8": 0}
# the backbone tap each level reads, and its index into `planes`
_TAP = {"bottle": ("block5", 4), "block6": ("block6", 5),
        "block7": ("block7", 6), "block8": ("block8", 7)}


def bev_head_size(bound: float, voxel_size: float) -> int:
    """Encoder2D's output (= BEV label image) resolution: raster 2 bound /
    voxel -> MaxPool(5, 3, 1) -> two convs k3 s2 p1 (50 m, 0.05 m: 2000 ->
    666 -> 333 -> 167)."""
    pooled = pooled_size(int(round(2 * bound / voxel_size)), 5, 3, 1)
    down1 = (pooled - 1) // 2 + 1
    return (down1 - 1) // 2 + 1


class MinkUNet34BEV(nn.Module):
    """Full width by default; planes/layers/init_dim narrow the backbone
    as in MinkUNet34.  in_channels > 1 needs plans built with
    stem_feature_map=True."""

    def __init__(self, out_channels: int = 7,
                 decoder_2d_levels: Sequence[str] = ("block8",),
                 num_batches: int = 4, voxel_size: float = 0.05,
                 bound_2d: float = 50.0, binary_seg: bool = False,
                 compute_dtype=torch.float32,
                 scaling_factors: Optional[Sequence[float]] = None,
                 init_dim: int = 32,
                 planes: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
                 layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
                 generator: Optional[torch.Generator] = None,
                 in_channels: int = 1):
        super().__init__()
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.backbone = MinkUNetBackbone(
            out_channels=out_channels, compute_dtype=compute_dtype,
            init_dim=init_dim, planes=planes, layers=layers, generator=g,
            in_channels=in_channels)
        self.decoder_2d_levels = tuple(decoder_2d_levels)
        self.num_batches, self.voxel_size = num_batches, voxel_size
        self.bound_2d, self.binary_seg = bound_2d, binary_seg
        self.scales = dict(zip(self.decoder_2d_levels, scaling_factors or ()))
        for lvl in self.decoder_2d_levels:
            setattr(self, f"encoder2d_{lvl}", Encoder2D(
                planes[_TAP[lvl][1]], n_classes=out_channels,
                binary_seg=binary_seg, compute_dtype=compute_dtype,
                generator=g))

    def forward(self, x: SparseTensor, plan: Plan, is_train: bool = False):
        logits, taps = self.backbone(x, plan)
        bev_logits = {}
        if not is_train:
            return logits, bev_logits
        for lvl in self.decoder_2d_levels:
            t = taps[_TAP[lvl][0]]
            bev = bev_scatter_pooled(
                t.coords, t.feats, t.mask, num_batches=self.num_batches,
                voxel_size=self.voxel_size, bound=self.bound_2d,
                pool_stride=int(3 / self.scales.get(lvl, 1.0)))
            head = getattr(self, f"encoder2d_{lvl}")(bev)
            if self.binary_seg:
                # the binary map sits under its own key; the trainers read
                # the label keys only
                bev_logits[lvl], bev_logits[f"{lvl}_binary"] = head
            else:
                bev_logits[lvl] = head
        return logits, bev_logits

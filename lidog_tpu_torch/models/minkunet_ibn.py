"""MinkUNet34IBN, the IBN-Net baseline: encoder stages 1-3 use IBN blocks
(lidog_tpu/models/minkunet_ibn.py:31-106).

`IBNBlock`: conv3 -> BatchNorm and InstanceNorm over the same output,
concatenated to 2 x planes -> ReLU -> conv3 (2 x planes -> planes) -> BN
-> + residual -> ReLU.  Stage 4 and the decoder are MinkUNet34's
BasicBlocks; everything else matches MinkUNet34.  forward(is_seg=False)
returns (logits, the decoder's last features).

The instance norms are ops/norm.py MaskedInstanceNorm (kernels KK/KL).
Module names follow the flax module, without a `backbone.` prefix
(utils/from_jax.py); the instance norms hold no parameters.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from lidog_tpu_torch.core.sparse import SparseTensor
from lidog_tpu_torch.models.minkunet import (BasicBlock, NormReLU, Plan,
                                             SparseConv, SparseConv1x1,
                                             add_decoder, run_blocks,
                                             run_decoder)


class IBNBlock(nn.Module):
    """conv3 -> [BN, IN] -> ReLU -> conv3 -> BN + shortcut -> ReLU; norm2,
    the residual add and the last ReLU are one fused pass."""

    def __init__(self, in_channels: int, planes: int, level: int, generator):
        super().__init__()
        kmap = f"conv3_l{level}"
        self.conv1 = SparseConv(in_channels, planes, kmap, level, level,
                                generator)
        self.norm1 = NormReLU(planes, norm="ibn")
        self.conv2 = SparseConv(2 * planes, planes, kmap, level, level,
                                generator)
        self.norm2 = NormReLU(planes)
        if in_channels != planes:
            self.shortcut_conv = SparseConv1x1(in_channels, planes, generator)
            self.shortcut_norm = NormReLU(planes, relu=False)
        else:
            self.shortcut_conv = None

    def forward(self, x: SparseTensor, plan: Plan) -> SparseTensor:
        y = self.conv2(self.norm1(self.conv1(x, plan)), plan)
        r = x
        if self.shortcut_conv is not None:
            r = self.shortcut_norm(self.shortcut_conv(x))
        return self.norm2(y, res=r)


class MinkUNet34IBN(nn.Module):
    """Full width by default; planes/layers/init_dim narrow it.
    in_channels > 1 needs plans built with stem_feature_map=True."""

    def __init__(self, out_channels: int = 7, compute_dtype=torch.float32,
                 init_dim: int = 32,
                 planes: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
                 layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
                 generator: Optional[torch.Generator] = None,
                 in_channels: int = 1):
        super().__init__()
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.compute_dtype = compute_dtype
        self.layers = tuple(layers)
        self.conv0 = SparseConv(in_channels, init_dim, "stem", 0, 0, g)
        self.norm0 = NormReLU(init_dim)
        ch = init_dim
        skip_ch = [init_dim]
        for s in range(4):
            setattr(self, f"conv{s + 1}",
                    SparseConv(ch, ch, f"down_l{s}", s, s + 1, g))
            setattr(self, f"norm{s + 1}", NormReLU(ch))
            block = IBNBlock if s < 3 else BasicBlock
            for b in range(layers[s]):
                setattr(self, f"block{s + 1}_{b}",
                        block(ch, planes[s], s + 1, g))
                ch = planes[s]
            skip_ch.append(ch)
        ch = add_decoder(self, ch, skip_ch, planes, layers, g)
        self.final = SparseConv1x1(ch, out_channels, g, use_bias=True)

    def forward(self, x: SparseTensor, plan: Plan, is_seg: bool = True):
        x = x.with_feats(x.feats.to(self.compute_dtype))
        enc = self.norm0(self.conv0(x, plan))
        skips = [enc]
        for s in range(4):
            down = getattr(self, f"norm{s + 1}")(
                getattr(self, f"conv{s + 1}")(enc, plan))
            enc = run_blocks(self, down, f"block{s + 1}", self.layers[s],
                             plan)
            skips.append(enc)
        dec = run_decoder(self, enc, skips, plan)
        logits = self.final(dec).feats
        return logits if is_seg else (logits, dec.feats)

"""MinkUNet34Robust, the RobustNet baseline: instance-whitened encoder
features (lidog_tpu/models/minkunet_robustnet.py:38-146).

  * `RobustBlock`: conv3-BN-ReLU-conv3-BN (+ 1x1-BN shortcut) -> + residual
    -> InstanceNorm, with no ReLU inside the block;
  * stem conv -> IN ("in0", tapped) -> ReLU;
  * the first down conv's output is instance-normed into the tap "in1",
    while the network goes on with relu(raw conv output) (:103-105, kept
    as the reference has it);
  * encoder stages 1-3 are RobustBlocks; each stage's output is tapped,
    then ReLU'd before the next stage and the skip; stage 4 and the
    decoder are MinkUNet34's;
  * forward(is_seg=False) returns (logits, [(feats, mask)] of the 5 taps:
    in0, in1, block1, block2, block3) for the IW / IRW whitening loss.

The instance norms are ops/norm.py MaskedInstanceNorm (kernels KK/KL).
Module names follow the flax module, without a `backbone.` prefix, so a
flax tree maps onto the state_dict unchanged (utils/from_jax.py); the
instance norms hold no parameters.
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
from lidog_tpu_torch.ops.norm import MaskedInstanceNorm


class RobustBlock(nn.Module):
    """conv3-BN-ReLU-conv3-BN (+ shortcut) -> add -> IN; norm2's BN and the
    residual add are one fused pass."""

    def __init__(self, in_channels: int, planes: int, level: int, generator):
        super().__init__()
        kmap = f"conv3_l{level}"
        self.conv1 = SparseConv(in_channels, planes, kmap, level, level,
                                generator)
        self.norm1 = NormReLU(planes)
        self.conv2 = SparseConv(planes, planes, kmap, level, level, generator)
        self.norm2 = NormReLU(planes, relu=False)
        if in_channels != planes:
            self.shortcut_conv = SparseConv1x1(in_channels, planes, generator)
            self.shortcut_norm = NormReLU(planes, relu=False)
        else:
            self.shortcut_conv = None
        self.in_out = MaskedInstanceNorm()

    def forward(self, x: SparseTensor, plan: Plan) -> SparseTensor:
        y = self.conv2(self.norm1(self.conv1(x, plan)), plan)
        r = x
        if self.shortcut_conv is not None:
            r = self.shortcut_norm(self.shortcut_conv(x))
        added = self.norm2(y, res=r)
        return added.with_feats(self.in_out(added.feats, added.mask,
                                            added.coords[:, 0]))


def _relu(x: SparseTensor) -> SparseTensor:
    return x.with_feats(torch.relu(x.feats))


class MinkUNet34Robust(nn.Module):
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
        self.in0 = MaskedInstanceNorm()
        self.conv1 = SparseConv(init_dim, init_dim, "down_l0", 0, 1, g)
        self.in1 = MaskedInstanceNorm()
        ch = init_dim
        skip_ch = [init_dim]
        for s in range(4):
            if s:
                setattr(self, f"conv{s + 1}",
                        SparseConv(ch, ch, f"down_l{s}", s, s + 1, g))
                setattr(self, f"norm{s + 1}", NormReLU(ch))
            block = RobustBlock if s < 3 else BasicBlock
            for b in range(layers[s]):
                setattr(self, f"block{s + 1}_{b}",
                        block(ch, planes[s], s + 1, g))
                ch = planes[s]
            skip_ch.append(ch)
        ch = add_decoder(self, ch, skip_ch, planes, layers, g)
        self.final = SparseConv1x1(ch, out_channels, g, use_bias=True)

    def forward(self, x: SparseTensor, plan: Plan, is_seg: bool = True):
        x = x.with_feats(x.feats.to(self.compute_dtype))
        out = self.conv0(x, plan)
        in0 = self.in0(out.feats, out.mask, out.coords[:, 0])
        whitened = [(in0, out.mask)]
        enc = out.with_feats(torch.relu(in0))
        skips = [enc]
        down = self.conv1(enc, plan)
        whitened.append((self.in1(down.feats, down.mask, down.coords[:, 0]),
                         down.mask))
        down = _relu(down)  # the raw down conv output, as the reference
        for s in range(4):
            if s:
                down = getattr(self, f"norm{s + 1}")(
                    getattr(self, f"conv{s + 1}")(enc, plan))
            enc = run_blocks(self, down, f"block{s + 1}", self.layers[s],
                             plan)
            if s < 3:
                whitened.append((enc.feats, enc.mask))
                enc = _relu(enc)
            skips.append(enc)
        dec = run_decoder(self, enc, skips, plan)
        logits = self.final(dec).feats
        return logits if is_seg else (logits, whitened)

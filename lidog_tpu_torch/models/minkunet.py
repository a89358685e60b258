"""MinkUNet34 (sparse 3D U-Net) on either plan, eval and train mode.

Port of lidog_tpu/models/minkunet.py:46-389.  On the zseg ZPlan: the
stem (the occupancy GEMM for one constant input channel, or for
in_channels > 1 the 125-offset gather-GEMM ops/sparse_conv.py
`sparse_conv` over the plan's stem125 map) and the z-fused convs
(ops/zconv.py, autograd ops with the JAX custom backward).  On the
generic UNetPlan (core/plan.py) every conv is `sparse_conv`.  Both: 1x1 convs and
masked BatchNorm fused with ReLU and the residual add (ops/norm.py).
`module.train()` normalises with the batch moments and updates the running
stats; `module.eval()` takes the running stats.

  * stem conv k=5 -> BN -> ReLU at stride 1
  * 4 encoder stages: [down conv k=2 s=2 -> BN -> ReLU -> BasicBlock x L]
  * 4 decoder stages: [transposed conv k=2 s=2 -> BN -> ReLU -> concat skip
    -> BasicBlock x L]
  * 1x1 `final` head with bias -> out_channels logits per voxel

Module and parameter names follow the flax modules, so the flax path
`backbone/block2_0/conv1/kernel` is the key `backbone.block2_0.conv1.kernel`
(utils/from_jax.py).  Conv kernels are [K, Cin, Cout] with offsets in
lexicographic (dx, dy, dz) order, dz fastest.  `compute_dtype` runs the
convs in that dtype with f32 accumulation; parameters stay f32 (their
gradients arrive through the `.to(compute_dtype)` casts) and norms
compute in f32.  The stem occupancy GEMM and the 1x1 convs are
torch.matmul under autograd, as the JAX package leaves them to XLA.
The stem's kernel is [125, in_channels, init_dim] either way, so flax
trees load unchanged; which stem runs follows the plan
(ZSegPlanBuilder(stem_feature_map=...)), as in lidog_tpu.

Every norm updates its running stats with momentum 0.1: the JAX model
takes a `bn_momentum` but never passes it on to its norms
(lidog_tpu/models/minkunet.py:236-248,314,326,350), and the port keeps
that behaviour (ops/norm.py MaskedBatchNorm.MOMENTUM, ROADMAP section 3).

Weight init: Kaiming normal fan-out drawn from an explicit torch.Generator
(lidog_tpu/models/minkunet.py:37-43); BN scale 1, bias 0, running mean 0,
var 1.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from lidog_tpu_torch.core.plan import UNetPlan
from lidog_tpu_torch.core.sparse import SparseTensor, cat
from lidog_tpu_torch.core.zseg import ZPlan
from lidog_tpu_torch.ops.norm import MaskedBatchNorm, MaskedInstanceNorm
from lidog_tpu_torch.ops.sparse_conv import sparse_conv, sparse_conv_1x1
from lidog_tpu_torch.ops.zconv import zconv3, zconv_down, zconv_up


# either plan: the zseg engine's or the generic gather engine's
Plan = Union[ZPlan, UNetPlan]


def _kernel(shape, generator):
    """Kaiming normal, fan_out = K * Cout, gain sqrt(2) (ReLU)."""
    k, _, cout = shape
    std = (2.0 / (k * cout)) ** 0.5
    return nn.Parameter(torch.randn(shape, generator=generator) * std)


class SparseConv(nn.Module):
    """A sparse conv bound to a kernel map of the plan: the stem ('stem'),
    k=3 ('conv3_l{i}'), down ('down_l{i}') or up ('up_l{i}').  On a ZPlan
    the stem is sparse_conv over kmaps["stem125"] where the plan has it,
    else the occupancy GEMM, and the others the z-fused convs; on a
    UNetPlan each is the gather-GEMM sparse_conv over kmaps[kmap], with
    the same parameters."""

    def __init__(self, in_channels: int, out_channels: int, kmap: str,
                 in_level: int, out_level: int, generator):
        super().__init__()
        self.kmap, self.in_level, self.out_level = kmap, in_level, out_level
        k = {"stem": 125, "conv3": 27}.get(kmap.split("_")[0], 8)
        self.kernel = _kernel((k, in_channels, out_channels), generator)

    def forward(self, x: SparseTensor, plan: Plan) -> SparseTensor:
        out_l = plan.level(self.out_level)
        w = self.kernel.to(x.feats.dtype)
        if isinstance(plan, UNetPlan):
            return self._gather_conv(x, plan, out_l, w)
        m = out_l.real
        if self.kmap == "stem" and "stem125" in plan.kmaps:
            # in_channels > 1: the gather-GEMM over source-row maps
            feats = sparse_conv(x.feats, plan.kmaps["stem125"], w,
                                out_mask=m)
        elif self.kmap == "stem":
            # constant-1 input features: out = occupancy [N, 125] @ W[:, 0]
            occ = plan.kmaps["stem_occ"].to(x.feats.dtype)
            feats = (occ.float() @ w[:, 0, :].float()).to(x.feats.dtype)
            feats = feats * m[:, None].to(feats.dtype)
        elif self.kmap.startswith("conv3_"):
            i = self.in_level
            L = plan.level(i)
            feats = zconv3(x.feats, plan.kmaps[f"conv9_l{i}"], L.zup, L.zdn,
                           w, out_mask=m)
        elif self.kmap.startswith("down_"):
            i = self.in_level
            feats = zconv_down(x.feats, plan.kmaps[f"down8_l{i}"],
                               plan.kmaps[f"parent_l{i}"],
                               plan.kmaps[f"off_l{i}"], w, out_mask=m)
        elif self.kmap.startswith("up_"):
            i = self.out_level
            feats = zconv_up(x.feats, plan.kmaps[f"parent_l{i}"],
                             plan.kmaps[f"off_l{i}"],
                             plan.kmaps[f"down8_l{i}"], w, out_mask=m)
        else:
            raise ValueError(f"unknown kmap {self.kmap!r}")
        return SparseTensor(coords=out_l.coords, feats=feats, mask=m,
                            stride=out_l.stride)

    def _gather_conv(self, x, plan, out_l, w):
        """The generic plan: the gather-GEMM over kmaps[self.kmap], with
        the down <-> up partner map as the transpose map of the even
        kernels (lidog_tpu/models/minkunet.py:111-130)."""
        if self.kmap.startswith("down_"):
            nbr_t = plan.kmaps["up_" + self.kmap[5:]]
        elif self.kmap.startswith("up_"):
            nbr_t = plan.kmaps["down_" + self.kmap[3:]]
        else:
            nbr_t = None  # symmetric odd kernel
        feats = sparse_conv(x.feats, plan.kmaps[self.kmap], w, nbr_t=nbr_t,
                            out_mask=out_l.mask)
        return SparseTensor(coords=out_l.coords, feats=feats,
                            mask=out_l.mask, stride=out_l.stride)


class SparseConv1x1(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, generator,
                 use_bias: bool = False):
        super().__init__()
        self.kernel = _kernel((1, in_channels, out_channels), generator)
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)

    def forward(self, x: SparseTensor) -> SparseTensor:
        dt = x.feats.dtype
        feats = sparse_conv_1x1(
            x.feats, self.kernel[0].to(dt),
            None if self.bias is None else self.bias.to(dt), out_mask=x.mask)
        return x.with_feats(feats)


class NormReLU(nn.Module):
    """A norm and an optional ReLU (lidog_tpu/models/minkunet.py:188):
    'bn' is the masked BatchNorm with the residual add and the ReLU in one
    fused pass; 'in' the per-scan instance norm; 'ibn' both over the same
    input, concatenated [BN, IN] to twice the channels (IBN-Net)."""

    def __init__(self, channels: int, relu: bool = True, norm: str = "bn"):
        super().__init__()
        if norm not in ("bn", "in", "ibn"):
            raise ValueError(f"unknown norm {norm!r}")
        self.relu, self.norm = relu, norm
        if norm != "in":
            self.bn = MaskedBatchNorm(channels)
        if norm != "bn":
            self.inorm = MaskedInstanceNorm()

    def forward(self, x: SparseTensor, res: Optional[SparseTensor] = None
                ) -> SparseTensor:
        if self.norm == "bn":
            return x.with_feats(self.bn(
                x.feats, x.mask, None if res is None else res.feats,
                self.relu))
        if res is not None:
            raise ValueError("the residual add is fused into 'bn' only")
        f = self.inorm(x.feats, x.mask, x.coords[:, 0])
        if self.relu:
            f = torch.relu(f)
        if self.norm == "ibn":
            f = torch.cat([self.bn(x.feats, x.mask, None, self.relu), f], -1)
        return x.with_feats(f)


class BasicBlock(nn.Module):
    """conv3-BN-ReLU-conv3-BN + (1x1-conv-BN shortcut) -> ReLU; norm2, the
    residual add and the final ReLU are one fused pass."""

    def __init__(self, in_channels: int, planes: int, level: int, generator):
        super().__init__()
        kmap = f"conv3_l{level}"
        self.conv1 = SparseConv(in_channels, planes, kmap, level, level,
                                generator)
        self.norm1 = NormReLU(planes)
        self.conv2 = SparseConv(planes, planes, kmap, level, level, generator)
        self.norm2 = NormReLU(planes, relu=True)
        if in_channels != planes:
            self.shortcut_conv = SparseConv1x1(in_channels, planes, generator)
            self.shortcut_norm = NormReLU(planes, relu=False)
        else:
            self.shortcut_conv = None

    def forward(self, x: SparseTensor, plan: Plan) -> SparseTensor:
        y = self.norm1(self.conv1(x, plan))
        y = self.conv2(y, plan)
        r = x
        if self.shortcut_conv is not None:
            r = self.shortcut_norm(self.shortcut_conv(x))
        return self.norm2(y, res=r)


def run_blocks(mod, x, name, n, plan):
    """The blocks `{name}_0` .. `{name}_{n-1}` of `mod`, in order."""
    for b in range(n):
        x = getattr(mod, f"{name}_{b}")(x, plan)
    return x


def add_decoder(mod, ch, skip_ch, planes, layers, g):
    """The four decoder stages of every MinkUNet34 variant onto `mod`:
    transposed conv -> BN -> ReLU -> concat skip -> BasicBlocks; returns
    the output width."""
    for d in range(4):
        lvl = 3 - d
        setattr(mod, f"convtr{4 + d}",
                SparseConv(ch, planes[4 + d], f"up_l{lvl}", lvl + 1, lvl, g))
        setattr(mod, f"normtr{4 + d}", NormReLU(planes[4 + d]))
        ch = planes[4 + d] + skip_ch[lvl]
        for b in range(layers[4 + d]):
            setattr(mod, f"block{5 + d}_{b}",
                    BasicBlock(ch, planes[4 + d], lvl, g))
            ch = planes[4 + d]
    return ch


def run_decoder(mod, dec, skips, plan, taps=None):
    """The decoder that add_decoder built, from the encoder's output and
    the skips of levels 0..3; each stage's output lands in `taps` as
    "block5".."block8" when given."""
    for d in range(4):
        lvl = 3 - d
        up = getattr(mod, f"normtr{4 + d}")(
            getattr(mod, f"convtr{4 + d}")(dec, plan))
        dec = run_blocks(mod, cat(up, skips[lvl]), f"block{5 + d}",
                         mod.layers[4 + d], plan)
        if taps is not None:
            taps[f"block{5 + d}"] = dec
    return dec


class MinkUNetBackbone(nn.Module):
    """Shared encoder-decoder, configured by its fields (planes and layers
    may be narrowed, e.g. for tests).  Returns (logits [N0, out_channels]
    in the compute dtype, taps): the taps are the SparseTensors "bottle"
    (the encoder's output, level 4) and "block5".."block8" (each decoder
    stage's output, levels 3..0), as lidog_tpu/models/minkunet.py:340-358
    returns them."""

    def __init__(self, out_channels: int = 7, compute_dtype=torch.float32,
                 init_dim: int = 32,
                 planes: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
                 layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
                 generator: Optional[torch.Generator] = None,
                 in_channels: int = 1):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.compute_dtype = compute_dtype
        self.conv0 = SparseConv(in_channels, init_dim, "stem", 0, 0, g)
        self.norm0 = NormReLU(init_dim)
        ch = init_dim
        skip_ch = [init_dim]
        for s in range(4):
            setattr(self, f"conv{s + 1}",
                    SparseConv(ch, ch, f"down_l{s}", s, s + 1, g))
            setattr(self, f"norm{s + 1}", NormReLU(ch))
            for b in range(layers[s]):
                setattr(self, f"block{s + 1}_{b}",
                        BasicBlock(ch, planes[s], s + 1, g))
                ch = planes[s]
            skip_ch.append(ch)
        ch = add_decoder(self, ch, skip_ch, planes, layers, g)
        self.final = SparseConv1x1(ch, out_channels, g, use_bias=True)
        self.layers = tuple(layers)

    def forward(self, x: SparseTensor, plan: Plan):
        x = x.with_feats(x.feats.to(self.compute_dtype))
        out = self.norm0(self.conv0(x, plan))
        skips = [out]
        enc = out
        for s in range(4):
            down = getattr(self, f"norm{s + 1}")(
                getattr(self, f"conv{s + 1}")(enc, plan))
            enc = run_blocks(self, down, f"block{s + 1}", self.layers[s],
                             plan)
            skips.append(enc)
        taps = {"bottle": enc}
        dec = run_decoder(self, enc, skips, plan, taps)
        return self.final(dec).feats, taps


class MinkUNet34(nn.Module):
    """Reference `MinkUNet34`: full width by default (about 37.85M
    parameters); planes/layers/init_dim narrow it.  in_channels > 1 needs
    plans built with stem_feature_map=True."""

    def __init__(self, out_channels: int = 7, compute_dtype=torch.float32,
                 init_dim: int = 32,
                 planes: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
                 layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
                 generator: Optional[torch.Generator] = None,
                 in_channels: int = 1):
        super().__init__()
        self.backbone = MinkUNetBackbone(
            out_channels=out_channels, compute_dtype=compute_dtype,
            init_dim=init_dim, planes=planes, layers=layers,
            generator=generator, in_channels=in_channels)

    def forward(self, x: SparseTensor, plan: Plan) -> torch.Tensor:
        return self.backbone(x, plan)[0]

"""Dense 2D heads of the LiDOG BEV branch (lidog_tpu/models/conv2d.py:18,
53): `DoubleConv` ((conv 3x3 -> BatchNorm -> ReLU) x 2) and `Encoder2D`
(DoubleConv(C_in -> 256, stride 2) then a 1x1 `out_conv` -> class logits,
with an optional binary head), taking the 666^2 pooled BEV grid to 167^2
logits.

NHWC at the interface, as in JAX.  Parameters keep flax's names and
layout, so a flax tree loads leaf by leaf (utils/from_jax.py): conv
`kernel` [kh, kw, Cin, Cout] (HWIO) and `bias`; BatchNorm params
`scale`/`bias` and buffers `mean`/`var`.

The convs are F.conv2d on the NHWC tensor viewed as a channels_last NCHW
tensor: JAX runs them as plain XLA convolutions, outside any hand-built
kernel.  The BatchNorm is flax's `nn.BatchNorm(momentum=0.9,
epsilon=1e-5)` in plain torch (flax 0.12 `_compute_stats`, `_normalize`):
  * batch statistics over N, H, W in f32: mean = E[x], var = max(E[x^2] -
    E[x]^2, 0), the biased variance;
  * running update r = 0.9 r + 0.1 batch, with that biased variance
    (F.batch_norm's update takes the unbiased one, which flax does not);
  * y = (x - mean) * (rsqrt(var + eps) * scale) + bias in f32, rounded to
    the compute dtype; x is cast to f32 once for the statistics and once
    for the normalisation, as in JAX, so in bf16 their two cotangents are
    rounded apart and summed in bf16, as JAX's are.
Eval mode takes the running statistics.

Weight init (random weights only: trained weights come through
from_jax): conv kernels normal with variance 1 / fan_in (flax's
lecun_normal without its truncation), from an explicit torch.Generator;
biases 0; BatchNorm scale 1, bias 0, mean 0, var 1.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Module):
    """flax nn.Conv on NHWC input: `kernel` [kh, kw, Cin, Cout], optional
    `bias`, padding `pad` on each side.  Computes in `dtype` (input and
    weights cast to it), as flax's Conv with that dtype."""

    def __init__(self, in_channels: int, out_channels: int, size: int,
                 generator: torch.Generator, stride: int = 1, pad: int = 0,
                 use_bias: bool = False):
        super().__init__()
        self.stride, self.pad = stride, pad
        std = (1.0 / (size * size * in_channels)) ** 0.5
        self.kernel = nn.Parameter(torch.randn(
            size, size, in_channels, out_channels, generator=generator) * std)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias \
            else None

    def forward(self, x, dtype):
        w = self.kernel.to(dtype).permute(3, 2, 0, 1)  # OIHW
        y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2),
                     w.contiguous(memory_format=torch.channels_last),
                     None if self.bias is None else self.bias.to(dtype),
                     stride=self.stride, padding=self.pad)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(momentum=0.9, epsilon=1e-5) over the last axis of
    an NHWC tensor; the output in `dtype`."""

    MOMENTUM = 0.9

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x, dtype):
        if self.training:
            xs = x.float()
            mean = xs.mean((0, 1, 2))
            var = torch.clamp_min((xs * xs).mean((0, 1, 2)) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = (x.float() - mean) * (torch.rsqrt(var + self.epsilon)
                                  * self.scale) + self.bias
        return y.to(dtype)


class DoubleConv(nn.Module):
    """(conv 3x3, padding 1, no bias -> BatchNorm -> ReLU) x 2, the convs
    and norms' outputs in compute_dtype."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: torch.Generator, mid_channels: Optional[int] = None,
                 stride: int = 1, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        mid = mid_channels or out_channels
        self.conv0 = Conv2d(in_channels, mid, 3, generator, stride, 1)
        self.bn0 = BatchNorm(mid)
        self.conv1 = Conv2d(mid, out_channels, 3, generator, stride, 1)
        self.bn1 = BatchNorm(out_channels)

    def forward(self, x):
        dt = self.compute_dtype
        x = torch.relu(self.bn0(self.conv0(x, dt), dt))
        return torch.relu(self.bn1(self.conv1(x, dt), dt))


class Encoder2D(nn.Module):
    """[B, H, W, C_in] pooled BEV features -> [B, H/4, W/4, n_classes] f32
    logits (and, with binary_seg, a 2-class map beside them)."""

    def __init__(self, in_channels: int, n_classes: int = 7,
                 binary_seg: bool = False, compute_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.down1 = DoubleConv(in_channels, 256, g, stride=2,
                                compute_dtype=compute_dtype)
        # the head computes in f32 (loss-facing, as the 3D `final`)
        self.out_conv = Conv2d(256, n_classes, 1, g, use_bias=True)
        self.binary_out_conv = (Conv2d(256, 2, 1, g, use_bias=True)
                                if binary_seg else None)

    def forward(self, x):
        x = self.down1(x).float()
        logits = self.out_conv(x, torch.float32)
        if self.binary_out_conv is not None:
            return logits, self.binary_out_conv(x, torch.float32)
        return logits

"""Masked batch normalization (eval) fused with the residual add and ReLU.

Port of lidog_tpu/ops/norm.py:41 `MaskedBatchNorm` on its running-average
path (axis_name=None), plus the ReLU and residual add that follow it in
lidog_tpu/models/minkunet.py:213-214,252:

    y = cast((x - mean) * (rsqrt(var + eps) * scale) + bias) * m
    y = y + res        (optional; in the compute dtype, as in JAX)
    y = relu(y)        (optional)

`bn_act` wraps the hand-written Triton kernel (KD); `bn_act_plain` is its
plain PyTorch version, which the wrapper takes for a tensor on the CPU.
"""

from __future__ import annotations

import torch
from torch import nn

LAUNCHES = {"bn_act": 0}


def bn_act_plain(x, mean, inv, bias, mask, res=None, relu=False):
    """inv = rsqrt(var + eps) * scale (f32, per channel)."""
    y = ((x.float() - mean) * inv + bias).to(x.dtype)
    y = y * mask[:, None].to(y.dtype)
    if res is not None:
        y = y + res
    return torch.relu(y) if relu else y


def bn_act(x, mean, inv, bias, mask, res=None, relu=False):
    """KD: the fused pass as one Triton kernel (the plain version for a
    CPU tensor).

    Replaces lidog_tpu/ops/norm.py:73-76 (eval) with the ReLU and residual
    add of lidog_tpu/models/minkunet.py:213-214,252.  Bound on an H100:
    bytes (read x and res, write y: 2-3 passes over [N, C] in the compute
    dtype; the per-channel vectors stay in cache), no tensor-core work.
    Design: one program per block of rows x all channels (the channel
    count padded to a power of two, masked), the f32 affine in registers,
    the same rounding points as JAX (round the affine result, then add the
    residual in the compute dtype).
    """
    if x.device.type == "cpu":
        return bn_act_plain(x, mean, inv, bias, mask, res, relu)
    if x.device.type != "cuda":
        raise ValueError(f"bn_act: the kernel takes CUDA tensors, got {x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("bn_act: x must be a contiguous [N, C] tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bn_act: float32 or bfloat16 only, got {x.dtype}")
    n, c = x.shape
    for v in (mean, inv, bias):
        if v.dtype != torch.float32 or tuple(v.shape) != (c,) \
                or v.device != x.device or not v.is_contiguous():
            raise ValueError("bn_act: per-channel vectors must be contiguous "
                             f"float32 [{c}] on {x.device}")
    if mask.dtype != torch.bool or tuple(mask.shape) != (n,) \
            or mask.device != x.device or not mask.is_contiguous():
        raise ValueError(f"bn_act: mask must be contiguous bool [{n}]")
    if res is not None and (res.shape != x.shape or res.dtype != x.dtype
                            or res.device != x.device
                            or not res.is_contiguous()):
        raise ValueError("bn_act: res must match x")
    out = torch.empty_like(x)
    if n == 0:
        return out
    import triton

    from lidog_tpu_torch.ops.bn_act_triton import bn_act_kernel

    block_c = triton.next_power_of_2(c)
    block_r = max(1, 4096 // block_c)
    bn_act_kernel[(triton.cdiv(n, block_r),)](
        x, mean, inv, bias, mask.view(torch.uint8),
        x if res is None else res, out, n, c,
        HAS_RES=res is not None, RELU=relu, BLOCK_R=block_r,
        BLOCK_C=block_c, num_warps=4)
    LAUNCHES["bn_act"] += 1
    return out


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of a padded sparse feature matrix,
    eval mode (running averages).  Parameter and buffer names follow the
    flax module: params scale/bias, batch_stats mean/var."""

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, feats, mask, res=None, relu=False):
        inv = torch.rsqrt(self.var + self.epsilon) * self.scale
        return bn_act(feats, self.mean, inv, self.bias, mask, res, relu)

"""Pointwise (kernel 1) sparse convolution (lidog_tpu/ops/sparse_conv.py:258).

A plain feature matmul with f32 accumulation, outside any kernel, as the
JAX version leaves it to XLA."""

from __future__ import annotations


def sparse_conv_1x1(feats, weights, bias=None, *, out_mask=None):
    """feats [N, Cin] @ weights [Cin, Cout] (+ bias, already in the feats
    dtype), rounded to the feats dtype, masked."""
    out = feats.float() @ weights.float()
    if bias is not None:
        out = out + bias.float()
    out = out.to(feats.dtype)
    if out_mask is not None:
        out = out * out_mask[:, None].to(out.dtype)
    return out

"""Padded, fixed-capacity sparse voxel tensor (the `ME.SparseTensor`
analogue).  Port of lidog_tpu/core/sparse.py:22-57: rows beyond `mask` are
padding, and every op masks them."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    """coords int32 [N, 4] (batch, x, y, z); feats [N, C]; mask bool [N]."""

    coords: torch.Tensor
    feats: torch.Tensor
    mask: torch.Tensor
    stride: int = 1

    def with_feats(self, feats: torch.Tensor) -> "SparseTensor":
        return dataclasses.replace(self, feats=feats)


def cat(a: SparseTensor, b: SparseTensor) -> SparseTensor:
    """Feature concat of two tensors on one coordinate set (`ME.cat`)."""
    assert a.stride == b.stride, (a.stride, b.stride)
    assert a.coords.shape == b.coords.shape
    return a.with_feats(torch.cat([a.feats, b.feats], dim=-1))

"""Raw padded points -> training batch, on the device
(lidog_tpu/train/device_pipeline.py:22, 41)."""

from __future__ import annotations

import torch

from lidog_tpu_torch.core.voxelize import quantize, voxelize_device


def device_batch_from_points(points, valid, labels, voxel_size: float,
                             capacity: int, point_feats=None):
    """points float32 [B, P, 3], valid bool [B, P], labels int32 [B, P] ->
    {coords int32 [cap, 4], feats float32 [cap, C], labels int32 [cap]
    (-1 on padding), mask bool [cap]}; each voxel takes the label of its
    representative point (the smallest point index in it), and its
    features: point_feats [B, P, C] where given (a model with in_channels
    C), else one constant channel."""
    b, p, _ = points.shape
    flat = points.reshape(b * p, 3)
    batch_idx = torch.arange(b, dtype=torch.int32,
                             device=points.device).repeat_interleave(p)
    vox = voxelize_device(flat, valid.reshape(b * p), batch_idx, voxel_size,
                          capacity, batch_size=b)
    lab = labels.reshape(b * p)[vox.rep_idx.long()]
    feats = vox.mask[:, None].to(torch.float32)
    if point_feats is not None:
        feats = feats * point_feats.reshape(b * p, -1)[vox.rep_idx.long()]
    return {
        "coords": vox.coords,
        "feats": feats,
        "labels": torch.where(vox.mask, lab, -1).to(torch.int32),
        "mask": vox.mask,
    }


def device_batch_raw(points, valid, labels, voxel_size: float,
                     point_feats=None):
    """The sortless path: raw padded points -> a per-point batch, with no
    sort or unique pass, only the quantization (lidog_tpu/train/
    device_pipeline.py:41-65).  The coords hold duplicates: feed them to a
    ZSegPlanBuilder(assume_unique=False), whose `rep` map picks each
    voxel's representative point for labels and features as
    voxelize_device does.  points float32 [B, P, 3], valid bool [B, P],
    labels int32 [B, P] -> {coords int32 [B*P, 4], feats float32 [B*P, C],
    labels int32 [B*P] (-1 on padding), mask bool [B*P]}; point_feats as
    in device_batch_from_points."""
    b, p, _ = points.shape
    flat = points.reshape(b * p, 3)
    vflat = valid.reshape(b * p)
    disc = quantize(flat, voxel_size)
    batch_idx = torch.arange(b, dtype=torch.int32,
                             device=points.device).repeat_interleave(p)
    coords = torch.cat([batch_idx[:, None], disc], dim=1)
    coords = torch.where(vflat[:, None], coords, 0)
    feats = vflat[:, None].to(torch.float32)
    if point_feats is not None:
        feats = feats * point_feats.reshape(b * p, -1)
    return {
        "coords": coords,
        "feats": feats,
        "labels": torch.where(vflat, labels.reshape(b * p),
                              -1).to(torch.int32),
        "mask": vflat,
    }

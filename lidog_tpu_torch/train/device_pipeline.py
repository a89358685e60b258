"""Raw padded points -> training batch, on the device
(lidog_tpu/train/device_pipeline.py:22)."""

from __future__ import annotations

import torch

from lidog_tpu_torch.core.voxelize import voxelize_device


def device_batch_from_points(points, valid, labels, voxel_size: float,
                             capacity: int):
    """points float32 [B, P, 3], valid bool [B, P], labels int32 [B, P] ->
    {coords int32 [cap, 4], feats float32 [cap, 1], labels int32 [cap]
    (-1 on padding), mask bool [cap]}; each voxel takes the label of its
    representative point (the smallest point index in it)."""
    b, p, _ = points.shape
    flat = points.reshape(b * p, 3)
    batch_idx = torch.arange(b, dtype=torch.int32,
                             device=points.device).repeat_interleave(p)
    vox = voxelize_device(flat, valid.reshape(b * p), batch_idx, voxel_size,
                          capacity)
    lab = labels.reshape(b * p)[vox.rep_idx.long()]
    return {
        "coords": vox.coords,
        "feats": vox.mask[:, None].to(torch.float32),
        "labels": torch.where(vox.mask, lab, -1).to(torch.int32),
        "mask": vox.mask,
    }

"""Serving-path predictor: raw points -> per-point semantic labels.

Port of lidog_tpu/serve.py:27-108,155-170: device voxelize -> zseg plan
-> MinkUNet34 forward -> argmax -> the two inverse-map gathers back onto
the input points (one kernel on the card: LD, ops/labels.py
`label_gather`).  With
sortless=True the per-point voxel cells go straight into a dedup-tolerant
plan (no sort or unique pass), whose `pos` is the per-point inverse map.

Usage:
    pred = Predictor(MinkUNet34(compute_dtype=torch.bfloat16))
    labels = pred(points)            # [B, P] int32, -1 = dropped/invalid

Runs on the card unless the caller passes device="cpu" (the CPU path runs
every op's plain PyTorch version).  Without a card and without a device,
the constructor raises.  The `overflow` property reports capacity drops of
the most recent call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from lidog_tpu_torch.caps import make_zcaps
from lidog_tpu_torch.core.engine import input_tensor
from lidog_tpu_torch.core.voxelize import voxelize_device
from lidog_tpu_torch.core.zseg import ZSegPlanBuilder
from lidog_tpu_torch.ops.labels import label_gather
from lidog_tpu_torch.train.device_pipeline import device_batch_raw
from lidog_tpu_torch.utils.device import resolve_device


class Predictor:
    """Warm end-to-end inference on one device.

    model: a MinkUNet34 (lidog_tpu_torch.models.minkunet) holding its
    weights (e.g. loaded from a flax tree via utils.from_jax).
    """

    def __init__(self, model, batch_size: int = 1, voxel_size: float = 0.05,
                 caps_per_scan: int = 98_304, grid_half: int = 1024,
                 caps: Optional[Tuple[Tuple[int, ...], ...]] = None,
                 device=None, sortless: bool = False):
        self.device = resolve_device(device)
        self.voxel_size = voxel_size
        self.cap_in = caps_per_scan * batch_size
        self.sortless = sortless
        caps_r, caps_a, caps_d = caps or make_zcaps(caps_per_scan)
        self.builder = ZSegPlanBuilder(caps_r, caps_a, num_batches=batch_size,
                                       grid_half=grid_half,
                                       caps_col_dil=caps_d,
                                       assume_unique=not sortless)
        self.model = model.to(self.device).eval()
        self._overflow = None

    @torch.no_grad()
    def forward_voxels(self, points, valid=None):
        """points [B, P, 3] -> (voxelization, plan, logits [N0, C]); the
        voxelization is None on the sortless path."""
        pts = torch.as_tensor(np.asarray(points, np.float32)
                              if not torch.is_tensor(points) else points,
                              dtype=torch.float32, device=self.device)
        b, p, _ = pts.shape
        if valid is None:
            valid = torch.ones(b, p, dtype=torch.bool, device=self.device)
        valid = torch.as_tensor(valid, device=self.device).reshape(b, p)
        if self.sortless:
            vox = None
            batch = device_batch_raw(
                pts, valid, torch.zeros(b, p, dtype=torch.int32,
                                        device=self.device), self.voxel_size)
            coords, mask = batch["coords"], batch["mask"]
        else:
            bidx = torch.arange(b, dtype=torch.int32,
                                device=self.device).repeat_interleave(p)
            vox = voxelize_device(pts.reshape(b * p, 3), valid.reshape(-1),
                                  bidx, self.voxel_size, self.cap_in,
                                  batch_size=b)
            coords, mask = vox.coords, vox.mask
        plan = self.builder(coords, mask)
        logits = self.model(input_tensor(plan, mask[:, None].float()), plan)
        return vox, plan, logits

    @torch.no_grad()
    def __call__(self, points, valid=None):
        """points [B, P, 3] float32 (numpy or torch); returns [B, P] int32
        per-point class ids (-1 where the point was dropped/invalid)."""
        b, p = points.shape[:2]
        vox, plan, logits = self.forward_voxels(points, valid)
        self._overflow = plan.overflow
        return self.labels_of(plan, logits, vox).reshape(b, p)

    @staticmethod
    def labels_of(plan, logits, vox=None):
        """Per-input-row class ids (-1 = dropped/invalid) of one forward:
        the argmax on level-0 real rows, through plan.pos, then (sorted
        path; vox None on the sortless one) through the voxelizer's
        inverse map onto the points (label_gather)."""
        return label_gather(logits, plan.level(0).real, plan.pos,
                            None if vox is None else vox.inverse)

    @property
    def overflow(self):
        """Capacity-drop counters from the most recent call (numpy)."""
        return None if self._overflow is None else self._overflow.cpu().numpy()

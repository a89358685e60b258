"""Collation: per-scan voxelized samples -> one padded sparse batch.

Copy of lidog_tpu/data/collate.py:23 (`collate_padded`) and :89
(`remap_selected_idx`), numpy on the host: batch indices are prepended to
each scan's voxel coords, everything is concatenated and padded to a fixed
capacity with a validity mask.  Kept as a copy so the port imports nothing
of the JAX package; the same samples give the same arrays.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def collate_padded(
    samples: Sequence[Dict[str, np.ndarray]],
    capacity: int,
    suffix: str = "",
    feat_dim: int = 1,
    return_inverse: bool = False,
) -> Dict[str, np.ndarray]:
    """samples: dicts with 'coordinates' [M, 3] int32, 'features' [M, C],
    'sem_labels' [M] int32.  Returns coords/feats/labels/mask padded to
    `capacity` rows; when the scans overflow it, each keeps an evenly
    strided subset of its voxels (counted in 'dropped')."""
    m_total = sum(s["coordinates"].shape[0] for s in samples)
    keep_frac = min(1.0, capacity / max(m_total, 1))

    coords = np.zeros((capacity, 4), np.int32)
    feats = np.zeros((capacity, feat_dim), np.float32)
    labels = np.full((capacity,), -1, np.int32)
    mask = np.zeros((capacity,), bool)

    row = 0
    dropped = 0
    inv_maps = []  # per sample: local voxel idx -> collated row (-1 dropped)
    for b, s in enumerate(samples):
        m = s["coordinates"].shape[0]
        keep = (min(int(m * keep_frac), capacity - row) if keep_frac < 1.0
                else min(m, capacity - row))
        dropped += m - keep
        if keep <= 0:
            inv_maps.append(np.full((m,), -1, np.int32))
            continue
        if keep < m:
            # an evenly strided subset keeps the scene's coverage, and
            # floor(k * m / keep) is strictly increasing, so rows stay
            # distinct (the plan builder needs unique coords)
            sel = np.arange(keep, dtype=np.int64) * m // keep
        else:
            sel = np.arange(m, dtype=np.int64)
        inv = np.full((m,), -1, np.int32)
        inv[sel] = row + np.arange(keep, dtype=np.int32)
        inv_maps.append(inv)
        coords[row:row + keep, 0] = b
        coords[row:row + keep, 1:] = s["coordinates"][sel]
        f = s["features"][sel]
        feats[row:row + keep, :f.shape[1]] = f
        labels[row:row + keep] = s["sem_labels"][sel]
        mask[row:row + keep] = True
        row += keep

    out = {
        f"coords{suffix}": coords,
        f"feats{suffix}": feats,
        f"labels{suffix}": labels,
        f"mask{suffix}": mask,
    }
    out[f"dropped{suffix}"] = np.int32(dropped)
    if return_inverse:
        # per-sample local voxel index -> collated row, for the BEV
        # selected-index remap (data/bev.py); never goes to the device
        out[f"_inv_maps{suffix}"] = inv_maps
    return out


def remap_selected_idx(idx_img: np.ndarray, inv_map: np.ndarray) -> np.ndarray:
    """BEV point-index image of per-scan local voxel indices -> collated
    row indices (-1 where empty or the voxel was dropped to capacity)."""
    return np.where(idx_img >= 0, inv_map[np.maximum(idx_img, 0)],
                    -1).astype(np.int32)

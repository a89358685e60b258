"""BEV label rasterization and the LiDOG preprocessing recipe (numpy).

Copy of the numpy path of lidog_tpu/data/bev.py:35-210 (the C++ twins of
native/voxelizer.cpp, which compute the same arrays, are not ported):

  * `filter_bev_bounds`: keep points inside [-60, 60]^2 x [-10, 8] and
    outside the ego box |x| < 3, |y| < 2;
  * `bev_label_image`: rasterize the voxelized cloud's consensus labels
    into an [S, S] image over [-bound, bound]^2, y flipped, -1 = empty,
    plus the point-index image; points are written in array order (last
    write wins);
  * `consensus_labels`: a voxel's label is its points' common label, else
    ignore;
  * `preprocess_scan_bev`: sub_p sampling and augmentation -> bounds filter
    -> voxelize -> per-level BEV label images;
  * `collate_bev`: padded collation plus the stacked label and
    point-index images, the index images remapped to collated rows.

`augmentations` is any callable (points, rng) -> (points, params), the
protocol of lidog_tpu/data/transforms.py Compose.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np

from lidog_tpu_torch.core.voxelize import voxelize_np
from lidog_tpu_torch.data.collate import collate_padded, remap_selected_idx

GRID_BOUNDS = ((-60.0, 60.0), (-60.0, 60.0), (-10.0, 8.0))
EGO_BOX = ((-3.0, 3.0), (-2.0, 2.0))
Z_RANGE = (-10.0, 8.0)


def filter_bev_bounds(points: np.ndarray) -> np.ndarray:
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    inb = (
        (GRID_BOUNDS[0][0] < x) & (x < GRID_BOUNDS[0][1])
        & (GRID_BOUNDS[1][0] < y) & (y < GRID_BOUNDS[1][1])
        & (GRID_BOUNDS[2][0] < z) & (z < GRID_BOUNDS[2][1])
    )
    ego = (
        (EGO_BOX[0][0] < x) & (x < EGO_BOX[0][1])
        & (EGO_BOX[1][0] < y) & (y < EGO_BOX[1][1])
    )
    return inb & ~ego


def bev_label_image(points: np.ndarray, labels: np.ndarray, img_size: int,
                    bound: float = 50.0):
    """Labeled metric points -> ([S, S] label, [S, S] point index)."""
    h = w = img_size
    gx = 2.0 * bound / img_size
    img_label = -np.ones((h, w), np.int32)
    img_idx = -np.ones((h, w), np.int32)

    valid = labels != -1
    idx = np.arange(points.shape[0])[valid]
    x, y, z = points[valid, 0], points[valid, 1], points[valid, 2]
    lab = labels[valid]
    inb = (
        (-bound < x) & (x < bound) & (-bound < y) & (y < bound)
        & (Z_RANGE[0] < z) & (z < Z_RANGE[1])
    )
    px = np.floor((x[inb] + bound) / gx).astype(np.int64)
    py = np.floor(h - (y[inb] + bound) / gx).astype(np.int64) - 1
    # the reference's y formula maps the top row band to -1, which would
    # wrap to the bottom row; those points are dropped instead
    ok = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    img_label[py[ok], px[ok]] = lab[inb][ok]
    img_idx[py[ok], px[ok]] = idx[inb][ok]
    return img_label, img_idx


def soft_from_hard(img_label: np.ndarray, num_classes: int,
                   eps: float = 0.25) -> np.ndarray:
    """[S, S] hard label image -> [S, S, C] smoothed soft labels (one-hot
    1 -> 1 - eps, 0 -> eps / (C - 1)); empty pixels become all -1."""
    h, w = img_label.shape
    lo = eps / (num_classes - 1)
    soft = np.full((h, w, num_classes), lo, np.float32)
    ys, xs = np.nonzero(img_label >= 0)
    soft[ys, xs, img_label[ys, xs]] = 1.0 - eps
    soft[img_label < 0] = -1.0
    return soft


def consensus_labels(inverse: np.ndarray, labels: np.ndarray, num_voxels: int,
                     ignore_label: int = -1) -> np.ndarray:
    """Per-voxel label: unanimous across the voxel's points, else
    ignore_label."""
    shifted = labels.astype(np.int64) + 10  # make ignore (-1) nonnegative
    lo = np.full(num_voxels, np.iinfo(np.int64).max, np.int64)
    hi = np.full(num_voxels, np.iinfo(np.int64).min, np.int64)
    np.minimum.at(lo, inverse, shifted)
    np.maximum.at(hi, inverse, shifted)
    return np.where(lo == hi, lo - 10, ignore_label).astype(np.int32)


def preprocess_scan_bev(
    points: np.ndarray,
    sem_labels: np.ndarray,
    decoder_2d_levels: Sequence[str] = ("block8",),
    bev_img_sizes: Optional[Dict[str, int]] = None,
    voxel_size: float = 0.05,
    bound_2d: float = 50.0,
    sub_p: float = 0.8,
    augmentations: Optional[Callable] = None,
    rng: Optional[np.random.RandomState] = None,
    train: bool = True,
    soft_bev_labels: bool = False,
    num_classes: int = 7,
) -> Dict[str, np.ndarray]:
    rng = rng or np.random.RandomState()
    bev_img_sizes = bev_img_sizes or {k: 167 for k in decoder_2d_levels}
    pts = points[:, :3]
    labels = sem_labels

    # sub_p sampling is coupled to the presence of augmentations, as in
    # the reference (an empty augmentation list disables sub_p too)
    if train and augmentations is not None:
        if sub_p < 1.0:
            m = max(1, int(sub_p * pts.shape[0]))
            keep = rng.choice(pts.shape[0], m, replace=False)
            pts, labels = pts[keep], labels[keep]
        pts, _ = augmentations(pts, rng)

    inb = filter_bev_bounds(pts)
    pts, labels = pts[inb], labels[inb]

    vox = voxelize_np(pts, voxel_size)
    n_vox = len(vox.coords)
    cons = consensus_labels(vox.inverse, labels, n_vox)
    bev_points = (vox.coords * voxel_size).astype(np.float32)

    bev_labels = {}
    bev_selected_idx = {}
    for key in decoder_2d_levels:
        img, idx = bev_label_image(bev_points, cons, bev_img_sizes[key],
                                   bound_2d)
        bev_labels[key] = (soft_from_hard(img, num_classes)
                           if soft_bev_labels else img)
        bev_selected_idx[key] = idx

    return {
        "coordinates": vox.coords,
        "features": np.ones((n_vox, 1), np.float32),
        "sem_labels": labels[vox.voxel_idx].astype(np.int32),
        "bev_labels": bev_labels,
        "bev_selected_idx": bev_selected_idx,
    }


def collate_bev(
    samples: Sequence[Dict[str, np.ndarray]],
    capacity: int,
    decoder_2d_levels: Sequence[str] = ("block8",),
    suffix: str = "",
) -> Dict[str, np.ndarray]:
    """Padded collation with the stacked per-level BEV label and
    point-index images; local per-scan point indices become collated rows
    (-1 = dropped or empty)."""
    out = collate_padded(samples, capacity, suffix=suffix, return_inverse=True)
    inv = out.pop(f"_inv_maps{suffix}")
    for key in decoder_2d_levels:
        out[f"bev_labels_{key}{suffix}"] = np.stack(
            [s["bev_labels"][key] for s in samples])
        out[f"bev_selected_idx_{key}{suffix}"] = np.stack([
            remap_selected_idx(s["bev_selected_idx"][key], iv)
            for s, iv in zip(samples, inv)])
    return out

"""Synthetic raycast LiDAR scans (numpy), the port's own copy.

Copy of lidog_tpu/data/synthetic.py (SyntheticLidarDataset): a randomized
urban scene (ground, walls, car boxes, person cylinders, vegetation
spheres) raycast with an HDL-64E-like spinning beam pattern, so scans have
the ring structure that sets the voxel-pyramid compression the plan
capacities assume.  Kept as a copy so the port imports nothing of the JAX
package; same seed, same points.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_INF = np.float32(np.inf)


def _ray_dirs(num_beams: int, num_az: int):
    """Unit ray directions [num_beams * num_az, 3] for a spinning scanner.

    Elevations span +2 .. -24.8 deg (HDL-64E-like, the sensor of
    SemanticKITTI; Synth4D's hdl64e layout matches).
    """
    elev = np.deg2rad(np.linspace(2.0, -24.8, num_beams, dtype=np.float64))
    az = np.linspace(0.0, 2 * np.pi, num_az, endpoint=False, dtype=np.float64)
    ce, se = np.cos(elev), np.sin(elev)
    ca, sa = np.cos(az), np.sin(az)
    dx = (ce[:, None] * ca[None, :]).ravel()
    dy = (ce[:, None] * sa[None, :]).ravel()
    dz = np.broadcast_to(se[:, None], (num_beams, num_az)).ravel()
    return np.stack([dx, dy, dz], 1)


class SyntheticLidarDataset:
    """Map-style dataset of synthetic scans; interface mirrors the real
    dataset loaders (dict with points / labels per item).  Returns exactly
    `points_per_scan` points per item (subsampled or jitter-padded)."""

    SENSOR_Z = 0.0
    GROUND_Z = -1.7

    def __init__(
        self,
        num_scans: int = 64,
        points_per_scan: int = 80_000,
        radius: float = 50.0,
        num_classes: int = 7,
        seed: int = 0,
        num_beams: int = 64,
    ):
        self.num_scans = num_scans
        self.points_per_scan = points_per_scan
        self.radius = radius
        self.num_classes = num_classes
        self.seed = seed
        self.num_beams = num_beams
        # ~83% of rays hit something inside the radius in this scene mix.
        self._num_az = max(64, int(points_per_scan / (num_beams * 0.80)))
        self._dirs = _ray_dirs(num_beams, self._num_az)

    def __len__(self) -> int:
        return self.num_scans

    # -- primitive intersectors (rays from the origin) -------------------

    def _hit_ground(self, d):
        dz = d[:, 2]
        t = np.where(dz < -1e-6, self.GROUND_Z / np.minimum(dz, -1e-6), _INF)
        return t.astype(np.float32)

    def _hit_wall(self, d, cx, cy, half_w, h, axis):
        """Vertical rectangle: plane x=cx (axis 0) or y=cy (axis 1)."""
        if axis == 0:
            dn, c, du, cu = d[:, 0], cx, d[:, 1], cy
        else:
            dn, c, du, cu = d[:, 1], cy, d[:, 0], cx
        t = np.where(np.abs(dn) > 1e-6, c / np.where(np.abs(dn) > 1e-6, dn, 1.0), _INF)
        u = t * du
        z = t * d[:, 2]
        ok = (
            (t > 0.5)
            & (np.abs(u - cu) <= half_w)
            & (z >= self.GROUND_Z)
            & (z <= self.GROUND_Z + h)
        )
        return np.where(ok, t, _INF).astype(np.float32)

    def _hit_box(self, d, lo, hi):
        """AABB slab intersection; returns entry t (inf on miss)."""
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / d
            t1 = lo[None, :] * inv
            t2 = hi[None, :] * inv
        tmin = np.minimum(t1, t2).max(axis=1)
        tmax = np.maximum(t1, t2).min(axis=1)
        ok = (tmax >= tmin) & (tmin > 0.5)
        return np.where(ok, tmin, _INF).astype(np.float32)

    def _hit_cylinder(self, d, cx, cy, r, z0, z1):
        dxy2 = d[:, 0] ** 2 + d[:, 1] ** 2
        b = -2.0 * (cx * d[:, 0] + cy * d[:, 1])
        c0 = cx * cx + cy * cy - r * r
        disc = b * b - 4 * dxy2 * c0
        safe = np.maximum(dxy2, 1e-9)
        t = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * safe)
        z = t * d[:, 2]
        ok = (disc > 0) & (t > 0.5) & (z >= z0) & (z <= z1)
        return np.where(ok, t, _INF).astype(np.float32)

    def _hit_sphere(self, d, c, r):
        b = -2.0 * (d @ c)
        c0 = float(c @ c) - r * r
        disc = b * b - 4 * c0
        t = (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0
        ok = (disc > 0) & (t > 0.5)
        return np.where(ok, t, _INF).astype(np.float32)

    # ---------------------------------------------------------------------

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed * 100003 + i)
        r = self.radius
        d = self._dirs

        # Candidate surfaces: (t [R], common-space label 1..7).  Ground gets
        # its radius-banded road/sidewalk/terrain label after the raycast.
        ts = [self._hit_ground(d)]
        labs = [np.zeros(1, np.int32)]  # placeholder, resolved below

        def _place(r_min, r_max):
            """Random center at a sane distance from the sensor."""
            rad = rng.uniform(r_min, r_max)
            th = rng.uniform(0, 2 * np.pi)
            return rad * np.cos(th), rad * np.sin(th)

        # Buildings: 6 wall rectangles (manmade = 6).
        for _ in range(6):
            cx, cy = _place(10.0, r * 0.8)
            w, h = rng.uniform(8, 24), rng.uniform(4, 12)
            ts.append(self._hit_wall(d, cx, cy, w / 2, h, rng.randint(2)))
            labs.append(np.array([6], np.int32))

        # Cars: 8 boxes ~4.5 x 1.8 x 1.5 (car = 1).
        for _ in range(8):
            cx, cy = _place(6.0, r * 0.6)
            lo = np.array([cx - 2.25, cy - 0.9, self.GROUND_Z], np.float64)
            hi = np.array([cx + 2.25, cy + 0.9, self.GROUND_Z + 1.5], np.float64)
            ts.append(self._hit_box(d, lo, hi))
            labs.append(np.array([1], np.int32))

        # Persons: 5 thin cylinders (person = 2).
        for _ in range(5):
            cx, cy = _place(4.0, r * 0.4)
            ts.append(
                self._hit_cylinder(d, cx, cy, 0.25, self.GROUND_Z, self.GROUND_Z + 1.7)
            )
            labs.append(np.array([2], np.int32))

        # Vegetation: 10 canopy spheres (vegetation = 7).
        for _ in range(10):
            cx, cy = _place(8.0, r * 0.8)
            cz = rng.uniform(0.5, 3.0)
            ts.append(self._hit_sphere(d, np.array([cx, cy, cz]), rng.uniform(1.2, 2.5)))
            labs.append(np.array([7], np.int32))

        tstack = np.stack(ts, 0)  # [P, R]
        prim = np.argmin(tstack, axis=0)
        tmin = tstack[prim, np.arange(tstack.shape[1])]

        # Range limit + small range noise (sensor jitter).
        tmin = tmin + rng.normal(0, 0.012, tmin.shape).astype(np.float32)
        pts = np.where(np.isfinite(tmin), tmin, 0.0)[:, None] * d
        rr = np.hypot(pts[:, 0], pts[:, 1])
        hit = np.isfinite(tmin) & (rr <= r) & (tmin > 0.5)

        pts = pts[hit].astype(np.float32)
        prim = prim[hit]
        rr = rr[hit]

        lab_of_prim = np.concatenate(labs)
        sem = lab_of_prim[np.clip(prim - 1, 0, len(lab_of_prim) - 2) + 1]
        # Ground (prim == 0): road / sidewalk / terrain by radius band.
        ground = prim == 0
        sem = np.where(
            ground, np.where(rr < 8, 3, np.where(rr < 18, 4, 5)), sem
        ).astype(np.int32)

        # Exact-size output: subsample or jitter-pad (keeps np.stack users
        # static-shaped, like the padded real-data loaders).
        n = self.points_per_scan
        if len(pts) >= n:
            sel = rng.choice(len(pts), n, replace=False)
            pts, sem = pts[sel], sem[sel]
        else:
            extra = rng.choice(len(pts), n - len(pts), replace=True)
            jit = rng.normal(0, 0.02, (len(extra), 3)).astype(np.float32)
            pts = np.concatenate([pts, pts[extra] + jit])
            sem = np.concatenate([sem, sem[extra]])

        # Common-space labels are 1..7; training uses label-1 with -1 ignore
        # (initialization.py shifts via the learning map).  Emit 0..6 plus a
        # small sprinkle of ignore labels to exercise masking.
        sem = (sem - 1).astype(np.int32)
        ign = rng.rand(len(sem)) < 0.01
        sem[ign] = -1
        perm = rng.permutation(len(pts))
        return {"points": pts[perm], "sem_labels": sem[perm]}


def point_features(points: np.ndarray, channels: int = 4,
                   seed: int = 0) -> np.ndarray:
    """Per-point input features [..., channels] for a model with
    in_channels = channels (1 to 4): the first `channels` of (x, y, z) in
    metres and a remission value drawn from `seed` in [0, 1); one channel
    is the constant occupancy feature 1."""
    if not 1 <= channels <= 4:
        raise ValueError(f"channels must lie in [1, 4], got {channels}")
    lead = points.shape[:-1]
    if channels == 1:
        return np.ones(lead + (1,), np.float32)
    rem = np.random.RandomState(seed).rand(*lead, 1).astype(np.float32)
    return np.concatenate([points[..., :3].astype(np.float32), rem],
                          axis=-1)[..., :channels]


EDGE_GRID_HALF = 64
EDGE_CAPS = ((512,) * 5, (1024,) * 5)  # per-scan (caps_real, caps_aug)
EDGE_CAPS_STARVED = ((512,) * 5, (160, 120, 96, 80, 64))
# y-dilated column caps below what the edge voxels need (~940, 540, 430,
# 220, 64 per scan at levels 0-4): columns past the cap and their voxels
# are dropped and counted (caps_col_dil of ZSegPlanBuilder, with EDGE_CAPS)
EDGE_COL_DIL_STARVED = (640, 256, 200, 100, 40)


def plan_edge_voxels(num_batches: int = 2, seed: int = 0):
    """Voxel cells that drive the zseg plan's sweeps to their edges, for a
    plan of grid_half EDGE_GRID_HALF: (coords int32 [num_batches * 512, 4]
    (batch, x, y, z) unique per scan, mask bool).  Per scan: columns at the
    grid's x and y edges; z at both ends of the plan's range [-224, 224)
    (a stem window around them reaches below 0 and past 447 bits); y
    columns 2 to 7 apart at one x (the y-dilated column slots then run with
    and without gaps); z-runs and random voxels; a few cells outside the
    grid or the z range, which the plan drops.  EDGE_CAPS hold it; with
    EDGE_CAPS_STARVED the augmented rows overflow their caps."""
    rng = np.random.RandomState(seed)
    lo, hi = -EDGE_GRID_HALF, EDGE_GRID_HALF - 1
    zlo, zhi = -224, 223
    zs = (zlo, zlo + 1, zlo + 3, -1, 0, zhi - 3, zhi - 1, zhi)
    rows = []
    for b in range(num_batches):
        cells = [(x, y, z) for x in (lo, lo + 1, hi - 1, hi)
                 for y in (lo, hi - 1, hi) for z in zs[b::2]]
        cells += [(x, y, z) for x in (lo, hi) for y in (lo + 2, hi - 2)
                  for z in (zlo, zhi)]
        cells += [(3 + b, y, z) for y in (-20, -14, -9, -5, -3, 4, 8, 10)
                  for z in (zlo, zlo + 1, -2, -1, 0, zhi)]
        run = rng.randint(lo, hi + 1, (60, 2))
        cells += [(x, y, z) for (x, y), z0 in zip(run, rng.choice(zs, 60))
                  for z in range(int(z0) - 1, int(z0) + 2)]
        cells += [tuple(c) for c in np.stack([
            rng.randint(lo, hi + 1, 120), rng.randint(lo, hi + 1, 120),
            rng.randint(zlo, zhi + 1, 120)], 1)]
        cells += [(hi + 1, 0, 0), (0, lo - 1, 0), (5, 5, zhi + 1),
                  (5, 6, zlo - 1)]
        uniq = np.unique(np.array(cells, np.int32), axis=0)
        rows.append(np.concatenate(
            [np.full((len(uniq), 1), b, np.int32), uniq], 1))
    coords = np.concatenate(rows)
    cap = num_batches * 512
    mask = np.zeros(cap, bool)
    mask[:len(coords)] = True
    return (np.concatenate([coords, np.zeros((cap - len(coords), 4),
                                             np.int32)]), mask)


def plan_edge_voxels_sortless(num_batches: int = 2, seed: int = 0):
    """plan_edge_voxels as sortless input (raw per-point cells for a plan
    with assume_unique=False): each voxel repeated 1-3 times, all rows
    shuffled with the seed; (coords int32 [num_batches * 1536, 4], mask
    bool), pad rows at the end."""
    coords, mask = plan_edge_voxels(num_batches, seed)
    rng = np.random.RandomState(seed + 1)
    rows = np.repeat(coords[mask], rng.randint(1, 4, int(mask.sum())), 0)
    rows = rows[rng.permutation(len(rows))]
    cap = num_batches * 512 * 3
    out_mask = np.zeros(cap, bool)
    out_mask[:len(rows)] = True
    return (np.concatenate([rows, np.zeros((cap - len(rows), 4), np.int32)]),
            out_mask)

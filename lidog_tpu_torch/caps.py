"""Per-level plan capacities (the zseg engine's, and the generic
UNetPlan's pooled ones), and the plan builder of a config.

Own copy of lidog_tpu/cli/common.py:20-57 (`_rup`, `make_caps`,
`make_zcaps`, LEVEL_SHRINK and the ZSEG_* tables) and of its builder
rule (:60-92), so the port imports nothing of the JAX package.
"""

from __future__ import annotations

from lidog_tpu_torch.core.zseg import ZSegPlanBuilder

# the pooled per-level shrink of the voxel count (generic UNetPlan caps)
LEVEL_SHRINK = (1.0, 0.55, 0.3, 0.12, 0.05)
# per-level shrink of the voxel count, ghost-row factor and y-dilated
# column slots per real voxel (measured ring-scan ratios + headroom; see
# the JAX module for their derivation)
ZSEG_SHRINK = (1.0, 0.72, 0.30, 0.13, 0.055)
ZSEG_AUG = (1.55, 1.45, 1.25, 1.25, 1.3)
ZSEG_COL_DIL = (2.7, 1.85, 2.8, 3.0, 3.0)


def _rup(x, m=2048):
    return int(-(-x // m) * m)


def make_caps(batch_size: int, per_scan: int = 131072):
    """Per-level pooled voxel capacities of build_unet_plan (core/plan.py)
    for batch_size scans of per_scan voxels: make_caps(4) = (524288,
    288768, 157696, 63488, 26624)."""
    base = batch_size * per_scan
    return tuple(_rup(base * f) for f in LEVEL_SHRINK)


def make_zcaps(per_scan: int = 131072):
    """(caps_real, caps_aug, caps_col_dil) per-scan capacities."""
    caps_r = tuple(_rup(per_scan * f) for f in ZSEG_SHRINK)
    caps_a = tuple(_rup(per_scan * f * a)
                   for f, a in zip(ZSEG_SHRINK, ZSEG_AUG))
    caps_d = tuple(min(_rup(per_scan * f * d), 5 * r)
                   for f, d, r in zip(ZSEG_SHRINK, ZSEG_COL_DIL, caps_r))
    return caps_r, caps_a, caps_d


def plan_builder(in_channels: int, batch_size: int, caps,
                 **options) -> ZSegPlanBuilder:
    """The zseg plan builder for a model with `in_channels` input channels
    at per-scan caps (caps_real, caps_aug, caps_col_dil): in_channels != 1
    needs the stem's source-row maps (stem_feature_map=True) instead of
    the occupancy matrix.  options (grid_half, assume_unique) go to
    ZSegPlanBuilder."""
    caps_r, caps_a, caps_d = caps
    return ZSegPlanBuilder(caps_r, caps_a, num_batches=batch_size,
                           caps_col_dil=caps_d,
                           stem_feature_map=in_channels != 1, **options)


def make_plan_builder(config, batch_size: int,
                      per_scan: int = 131072) -> ZSegPlanBuilder:
    """The plan builder of `config` at make_zcaps(per_scan)."""
    return plan_builder(config.model.in_channels, batch_size,
                        make_zcaps(per_scan))

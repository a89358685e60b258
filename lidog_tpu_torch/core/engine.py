"""Engine dispatch (lidog_tpu/core/engine.py), ZPlan branch only: the port
has one kernel-map engine, for unique (voxelized) or sortless input."""

from __future__ import annotations

import torch

from lidog_tpu_torch.core.zseg import ZPlan, input_tensor_z


def _zplan(plan) -> ZPlan:
    if not isinstance(plan, ZPlan):
        raise TypeError(f"expected a ZPlan, got {type(plan).__name__}")
    return plan


def input_tensor(plan: ZPlan, feats):
    """Caller-order features -> canonical level-0 SparseTensor."""
    return input_tensor_z(_zplan(plan), feats)


def canon_labels(plan: ZPlan, labels):
    """Per-input-row labels -> (labels in the level-0 row layout, -1 on
    rows without one; the rows that carry a label): lidog_tpu/core/
    engine.py:40-56, the ZPlan branch.  A sortless plan (plan.rep set)
    takes per-point labels and picks the representative point's label by
    gather, voxelize_device's choice."""
    real = _zplan(plan).level(0).real
    if plan.rep is not None:
        hit = (plan.rep >= 0) & real
        lab = torch.where(hit, labels[plan.rep.clamp(min=0).long()]
                          .to(torch.int32), -1)
        return lab, real & (lab >= 0)
    lab = plan.scatter_rows(labels.to(torch.int32), fill=-1)
    return lab, real & (lab >= 0)


def input_to_canon_map(plan: ZPlan):
    """int32 [N_in]: input (collated) row -> level-0 row, -1 where the row
    was dropped or is padding (lidog_tpu/core/engine.py:61, ZPlan
    branch)."""
    return _zplan(plan).pos

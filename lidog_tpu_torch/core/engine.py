"""Engine dispatch (lidog_tpu/core/engine.py), ZPlan branch only: the port
has one kernel-map engine, and unique (voxelized) input."""

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
    engine.py:40-56, the ZPlan branch for unique input."""
    lab = _zplan(plan).scatter_rows(labels.to(torch.int32), fill=-1)
    return lab, plan.level(0).real & (lab >= 0)


def input_to_canon_map(plan: ZPlan):
    """int32 [N_in]: input (collated) row -> level-0 row, -1 where the row
    was dropped or is padding (lidog_tpu/core/engine.py:61, ZPlan
    branch)."""
    return _zplan(plan).pos

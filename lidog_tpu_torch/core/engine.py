"""Engine dispatch (lidog_tpu/core/engine.py:26-73): one call surface over
the two kernel-map engines, the zseg ZPlan (core/zseg.py; unique or
sortless input) and the generic UNetPlan (core/plan.py)."""

from __future__ import annotations

import torch

from lidog_tpu_torch.core.plan import UNetPlan, input_tensor as _input_gather
from lidog_tpu_torch.core.zseg import ZPlan, input_tensor_z


def _plan(plan):
    if not isinstance(plan, (ZPlan, UNetPlan)):
        raise TypeError(f"expected a ZPlan or a UNetPlan, got "
                        f"{type(plan).__name__}")
    return plan


def input_tensor(plan, feats):
    """Caller-order features -> canonical level-0 SparseTensor."""
    if isinstance(_plan(plan), ZPlan):
        return input_tensor_z(plan, feats)
    return _input_gather(plan, feats)


def canon_labels(plan, labels):
    """Per-input-row labels -> (labels in the level-0 row layout, -1 on
    rows without one; the rows that carry a label): lidog_tpu/core/
    engine.py:40-56.  A sortless ZPlan (plan.rep set) takes per-point
    labels and picks the representative point's label by gather,
    voxelize_device's choice."""
    if isinstance(_plan(plan), UNetPlan):
        lab = labels[plan.perm.long()]
        return lab, plan.level(0).mask & (lab >= 0)
    real = plan.level(0).real
    if plan.rep is not None:
        hit = (plan.rep >= 0) & real
        lab = torch.where(hit, labels[plan.rep.clamp(min=0).long()]
                          .to(torch.int32), -1)
        return lab, real & (lab >= 0)
    lab = plan.scatter_rows(labels.to(torch.int32), fill=-1)
    return lab, real & (lab >= 0)


def input_to_canon_map(plan):
    """int32 [N_in]: input (collated) row -> level-0 row, -1 where the row
    was dropped or is padding (lidog_tpu/core/engine.py:61-73)."""
    if isinstance(_plan(plan), ZPlan):
        return plan.pos
    l0 = plan.level(0)
    n0, n_in = l0.coords.shape[0], plan.perm.shape[0]
    slot = torch.where(l0.mask, plan.perm, n_in).long()
    inv = torch.full((n_in + 1,), -1, dtype=torch.int32, device=slot.device)
    inv[slot] = torch.arange(n0, dtype=torch.int32, device=slot.device)
    return inv[:n_in]

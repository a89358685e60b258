"""Engine dispatch (lidog_tpu/core/engine.py:26), ZPlan branch only: the
port has one kernel-map engine."""

from __future__ import annotations

from lidog_tpu_torch.core.zseg import ZPlan, input_tensor_z


def input_tensor(plan: ZPlan, feats):
    """Caller-order features -> canonical level-0 SparseTensor."""
    if not isinstance(plan, ZPlan):
        raise TypeError(f"expected a ZPlan, got {type(plan).__name__}")
    return input_tensor_z(plan, feats)

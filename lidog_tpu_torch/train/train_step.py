"""Train and eval steps (lidog_tpu/train/train_step.py:35-174).

One step: per source, the level-0 input tensor from its plan,
the forward in train mode (batch moments, running-stats update), the
criterion on the labelled rows, the weighted sum of the sources' losses,
the backward through the custom conv and norm backwards, and the
optimizer's update.  Metrics: the loss and an on-device confusion matrix.

The port's state is mutable: TrainState holds the model (its parameters
are `params`, its BatchNorm buffers `batch_stats`), the optimizer (its
moments are the optax state) and the step count, and a step updates
them in place.  Plans are built by the caller (core/zseg.py
ZSegPlanBuilder), or, when a step gets none, by the step itself: the
generic UNetPlan of the batch (core/plan.py build_unet_plan at the
step's pooled `caps`, e.g. caps.make_caps(batch_size)), as lidog_tpu's
step does.  The in-graph plan_fn and the data-parallel step wait for
multi-GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from lidog_tpu_torch.core.engine import canon_labels, input_tensor
from lidog_tpu_torch.core.plan import build_unet_plan
from lidog_tpu_torch.metrics.metrics import confusion_matrix
from lidog_tpu_torch.train.optim import OptimizerSpec, ScheduledOptimizer
from lidog_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: ScheduledOptimizer
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, tx: OptimizerSpec, device=None):
        """Place the model on `device` (the card unless device="cpu"; no
        card and no device raises) and build the optimizer over its
        parameters."""
        model = model.to(resolve_device(device)).train()
        return cls(model=model, optimizer=tx.build(model.parameters()))


def _plan_of(plans, batch, caps, suffix=""):
    """The step's plan of one source: the one passed in, else the batch's
    UNetPlan at `caps`."""
    if plans is not None:
        return plans.get(suffix) if isinstance(plans, dict) else plans
    if caps is None:
        raise ValueError("a step without plans builds the batch's UNetPlan "
                         "and needs caps (caps.make_caps)")
    return build_unet_plan(batch[f"coords{suffix}"], batch[f"mask{suffix}"],
                           caps)


def _forward_loss(model, batch, criterion, num_classes, plan, suffix=""):
    x = input_tensor(plan, batch[f"feats{suffix}"])
    logits = model(x, plan)
    if isinstance(logits, tuple):  # MinkUNet34BEV: (logits, {}) in eval
        logits = logits[0]
    labels_c, valid = canon_labels(plan, batch[f"labels{suffix}"])
    loss = criterion(logits, labels_c, valid)
    cm = confusion_matrix(logits.argmax(-1), labels_c, valid, num_classes)
    return loss, cm


def make_train_step(criterion: Callable, num_classes: int = 7,
                    source_weights: Sequence[float] = (0.5, 0.5),
                    num_sources: int = 1,
                    caps: Optional[Sequence[int]] = None):
    """train_step(state, batch, plans=None) -> (state, {"loss",
    "confusion"}).

    batch: {coords, feats, labels, mask} (device_pipeline), or for
    num_sources > 1 the same keys suffixed "0", "1", ...; plans: the
    batch's plan (a ZPlan or a UNetPlan), or {suffix: plan}, or None: the
    step builds each source's UNetPlan at the pooled per-level `caps`."""
    caps = None if caps is None else tuple(caps)

    def train_step(state: TrainState, batch, plans=None):
        model = state.model.train()
        state.optimizer.zero_grad()
        if num_sources == 1:
            loss, cm = _forward_loss(model, batch, criterion, num_classes,
                                     _plan_of(plans, batch, caps))
        else:
            loss, cm = 0.0, 0
            for s in range(num_sources):
                loss_s, cm_s = _forward_loss(
                    model, batch, criterion, num_classes,
                    _plan_of(plans, batch, caps, str(s)), suffix=str(s))
                loss = loss + source_weights[s] * loss_s
                cm = cm + cm_s
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "confusion": cm}

    return train_step


def make_eval_step(criterion: Callable, num_classes: int = 7,
                   caps: Optional[Sequence[int]] = None):
    """eval_step(state, batch, plan=None) -> {"loss", "confusion"}, with
    the running statistics and no update; plan None builds the batch's
    UNetPlan at `caps`.  The model may return logits or (logits, {}), as
    MinkUNet34BEV does outside training."""
    caps = None if caps is None else tuple(caps)

    @torch.no_grad()
    def eval_step(state: TrainState, batch, plan=None):
        loss, cm = _forward_loss(state.model.eval(), batch, criterion,
                                 num_classes, _plan_of(plan, batch, caps))
        return {"loss": loss, "confusion": cm}

    return eval_step

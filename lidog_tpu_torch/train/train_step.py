"""Train and eval steps (lidog_tpu/train/train_step.py:35-174).

One step: per source, the level-0 input tensor from its prebuilt ZPlan,
the forward in train mode (batch moments, running-stats update), the
criterion on the labelled rows, the weighted sum of the sources' losses,
the backward through the custom conv and norm backwards, and the
optimizer's update.  Metrics: the loss and an on-device confusion matrix.

The port's state is mutable: TrainState holds the model (its parameters
are `params`, its BatchNorm buffers `batch_stats`), the optimizer (its
moments are the optax state) and the step count, and a step updates
them in place.  Plans are built by the caller (core/zseg.py
ZSegPlanBuilder); the in-graph plan_fn and the data-parallel step wait for
multi-GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
from torch import nn

from lidog_tpu_torch.core.engine import canon_labels, input_tensor
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
                    num_sources: int = 1):
    """train_step(state, batch, plans) -> (state, {"loss", "confusion"}).

    batch: {coords, feats, labels, mask} (device_pipeline), or for
    num_sources > 1 the same keys suffixed "0", "1", ...; plans: the
    batch's ZPlan, or {suffix: ZPlan}."""

    def train_step(state: TrainState, batch, plans):
        model = state.model.train()
        state.optimizer.zero_grad()
        if num_sources == 1:
            plan = plans[""] if isinstance(plans, dict) else plans
            loss, cm = _forward_loss(model, batch, criterion, num_classes,
                                     plan)
        else:
            loss, cm = 0.0, 0
            for s in range(num_sources):
                loss_s, cm_s = _forward_loss(model, batch, criterion,
                                             num_classes, plans[str(s)],
                                             suffix=str(s))
                loss = loss + source_weights[s] * loss_s
                cm = cm + cm_s
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "confusion": cm}

    return train_step


def make_eval_step(criterion: Callable, num_classes: int = 7):
    """eval_step(state, batch, plan) -> {"loss", "confusion"}, with the
    running statistics and no update.  The model may return logits or
    (logits, {}), as MinkUNet34BEV does outside training."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch, plan):
        loss, cm = _forward_loss(state.model.eval(), batch, criterion,
                                 num_classes, plan)
        return {"loss": loss, "confusion": cm}

    return eval_step

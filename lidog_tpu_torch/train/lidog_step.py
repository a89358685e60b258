"""LiDOG train step: 3D SoftDICE + per-level BEV DICE with the warm-up gate
(lidog_tpu/train/lidog_step.py:27,45,78).

  * BEV loss = mean over the decoder levels of the BEV criterion on the
    level's BEV logits against the rasterized BEV label image (-1 =
    empty);
  * one source: total = gate * (w0 * sem + w1 * bev) + (1 - gate) * bev;
    two sources: total = sum_s w_s * (gate * sem_s + bev_s); gate = 1 once
    the epoch (step // steps_per_epoch) reaches warmup_epochs, else 0.
    The gate is arithmetic, as in JAX: the sem loss stays in the graph
    with weight 0 during warm-up;
  * metrics: loss, sem_loss, bev_loss (means over the sources), the 3D
    confusion matrix, and proj_iou_{level}{suffix}, the 3D mean IoU over
    the points that the BEV label image selected.

State, optimizer and plans as in train/train_step.py: the caller builds a
ZPlan per source (core/zseg.py ZSegPlanBuilder), or, given none, the step
builds each source's UNetPlan at `caps`, as lidog_tpu's step does.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from lidog_tpu_torch.core.engine import (canon_labels, input_tensor,
                                         input_to_canon_map)
from lidog_tpu_torch.metrics.metrics import confusion_matrix, iou_from_confusion
from lidog_tpu_torch.train.train_step import TrainState, _plan_of


def select_3d_miou(preds_c, labels_c, plan, sel_img, num_classes: int):
    """Mean IoU over present classes of the 3D predictions restricted to
    the points selected into BEV pixels (reference `select_3d` + jaccard).
    sel_img: [B, S, S] collated input rows (-1 empty or dropped), from
    data/collate.py remap_selected_idx."""
    i2c = input_to_canon_map(plan)
    rows = sel_img.reshape(-1).long()
    canon = torch.where(rows >= 0, i2c[rows.clamp(min=0)], -1).long()
    ok = canon >= 0
    p = preds_c[canon.clamp(min=0)]
    lab = labels_c[canon.clamp(min=0)]
    cm = confusion_matrix(p, lab, ok & (lab >= 0), num_classes)
    iou = iou_from_confusion(cm)
    present = (cm.sum(1) > 0).float()
    return (iou * present).sum() / present.sum().clamp(min=1.0)


def _lidog_forward(model, batch, sem_criterion, bev_criterion, decoder_levels,
                   num_classes, plan, suffix=""):
    """-> (sem loss, bev loss, confusion, {proj_iou_*})."""
    x = input_tensor(plan, batch[f"feats{suffix}"])
    logits, bev_logits = model(x, plan, is_train=True)
    labels_c, valid = canon_labels(plan, batch[f"labels{suffix}"])
    sem_loss = sem_criterion(logits, labels_c, valid)
    bev_loss = 0.0
    proj = {}
    preds = logits.argmax(-1)
    for key in decoder_levels:
        lab = batch[f"bev_labels_{key}{suffix}"]
        bev_loss = bev_loss + bev_criterion(bev_logits[key], lab) / len(
            decoder_levels)
        sel = batch.get(f"bev_selected_idx_{key}{suffix}")
        if sel is not None:
            with torch.no_grad():
                proj[f"proj_iou_{key}{suffix}"] = select_3d_miou(
                    preds, labels_c, plan, sel, num_classes)
    cm = confusion_matrix(preds, labels_c, valid, num_classes)
    return sem_loss, bev_loss, cm, proj


def make_lidog_train_step(sem_criterion: Callable, bev_criterion: Callable,
                          decoder_levels: Sequence[str] = ("block8",),
                          num_classes: int = 7,
                          source_weights: Sequence[float] = (0.5, 0.5),
                          num_sources: int = 1, warmup_epochs: int = 0,
                          steps_per_epoch: int = 1,
                          caps: Optional[Sequence[int]] = None):
    """train_step(state, batch, plans=None) -> (state, metrics).

    batch: data/bev.py collate_bev's arrays as tensors (coords, feats,
    labels, mask, bev_labels_{level}, bev_selected_idx_{level}), suffixed
    "0", "1" for two sources; plans: the batch's plan (a ZPlan or a
    UNetPlan), or {suffix: plan}, or None: the step builds each source's
    UNetPlan at the pooled per-level `caps`.  The model is a
    MinkUNet34BEV."""
    w = tuple(source_weights)
    caps = None if caps is None else tuple(caps)

    def train_step(state: TrainState, batch, plans=None):
        model = state.model.train()
        state.optimizer.zero_grad()
        epoch = state.step // max(steps_per_epoch, 1)
        gate = float(epoch >= warmup_epochs)
        cm = 0
        if num_sources == 1:
            sem, bev, cm, proj = _lidog_forward(
                model, batch, sem_criterion, bev_criterion, decoder_levels,
                num_classes, _plan_of(plans, batch, caps))
            total = gate * (w[0] * sem + w[1] * bev) + (1 - gate) * bev
            aux = {"sem_loss": sem.detach(), "bev_loss": bev.detach(), **proj}
        else:
            total, sems, bevs, aux = 0.0, [], [], {}
            for s in range(num_sources):
                sem, bev, cm_s, proj = _lidog_forward(
                    model, batch, sem_criterion, bev_criterion,
                    decoder_levels, num_classes,
                    _plan_of(plans, batch, caps, str(s)), suffix=str(s))
                total = total + w[s] * (gate * sem + bev)
                cm = cm + cm_s
                sems.append(sem.detach())
                bevs.append(bev.detach())
                aux.update(proj)
            aux.update({"sem_loss": sum(sems) / len(sems),
                        "bev_loss": sum(bevs) / len(bevs)})
        total.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": total.detach(), "confusion": cm, **aux}

    return train_step

"""Confusion matrix and per-class IoU (lidog_tpu/metrics/metrics.py:21,33),
computed where the predictions live."""

from __future__ import annotations

import torch


def confusion_matrix(preds, labels, valid, num_classes: int):
    """[C, C] int32 confusion matrix over valid rows; rows = true, columns
    = predicted."""
    preds = preds.reshape(-1).long()
    labels = labels.reshape(-1).long()
    valid = valid.reshape(-1) & (labels >= 0) & (labels < num_classes)
    idx = torch.where(valid, labels * num_classes + preds,
                      num_classes * num_classes)
    counts = torch.bincount(idx, minlength=num_classes * num_classes + 1)
    return counts[:-1].reshape(num_classes, num_classes).to(torch.int32)


def iou_from_confusion(cm):
    """Per-class IoU [C]; 0 where the union is empty."""
    tp = torch.diagonal(cm).float()
    fp = cm.sum(0).float() - tp
    fn = cm.sum(1).float() - tp
    union = tp + fp + fn
    return torch.where(union > 0, tp / union.clamp(min=1.0),
                       torch.zeros_like(union))

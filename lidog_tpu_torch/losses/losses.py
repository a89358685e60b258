"""SoftDICE, the main 3D criterion (lidog_tpu/losses/losses.py:70), and
DICE, LiDOG's BEV criterion (:98).

Masked, in float32: padded and ignored rows contribute zero to every sum,
which is the reference's "drop ignored rows then sum".  Plain PyTorch
under autograd: the JAX package has no kernel here.  Each takes (logits
[..., C], labels [...], valid [...] or None) and returns a scalar.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def _flatten(logits, labels, valid):
    """-> logits [N, C] f32, labels [N], valid [N] (all rows when None)."""
    c = logits.shape[-1]
    if valid is None:
        valid = torch.ones(labels.shape, dtype=torch.bool,
                           device=labels.device)
    return (logits.reshape(-1, c).float(), labels.reshape(-1),
            valid.reshape(-1))


def _one_hot_soft(labels, num_classes: int, eps: float, is_kitti: bool):
    """Smoothed one-hot targets: 1 -> 1-eps, 0 -> eps/(C-1); the KITTI
    variant splits the positive mass between classes 1 (car) and 6
    (manmade) for rows labelled with either (lidog_tpu/losses/
    losses.py:31)."""
    lab = labels.clamp(min=0).long()
    onehot = torch.nn.functional.one_hot(lab, num_classes).float()
    max_val = 1.0 - eps
    soft = torch.where(onehot > 0, max_val, eps / (num_classes - 1))
    if is_kitti:
        special = ((lab == 1) | (lab == 6))[:, None]
        cols = torch.zeros(num_classes, dtype=torch.bool, device=lab.device)
        cols[[1, 6]] = True
        soft = torch.where(special & cols, max_val / 2.0, soft)
    return soft, onehot


def _dice_core(probs, target, target_onehot, valid, powerize: bool,
               use_tmask: bool):
    """Dice over masked rows; returns (iou, per-class iou)
    (lidog_tpu/losses/losses.py:49)."""
    m = valid.float()[:, None]
    probs = probs * m
    target = target * m
    target_onehot = target_onehot * m
    intersection = (probs * target).sum(0)
    if powerize:
        union = (probs * probs).sum(0) + target.sum(0) + 1e-12
    else:
        union = probs.sum(0) + target.sum(0) + 1e-12
    if use_tmask:
        tmask = (target_onehot.sum(0) > 0).float()
    else:
        tmask = torch.ones(probs.shape[1], device=probs.device)
    iou_class = tmask * 2.0 * intersection / union
    iou = iou_class.sum() / (tmask.sum() + 1e-12)
    return iou, iou_class


@dataclasses.dataclass
class SoftDICELoss:
    """Reference SoftDICELoss (lidog_tpu/losses/losses.py:70)."""

    ignore_label: Optional[int] = None
    powerize: bool = True
    use_tmask: bool = True
    neg_range: bool = False
    eps: float = 0.05
    is_kitti: bool = False

    def __call__(self, logits, labels, valid=None, return_class: bool = False):
        logits, labels, valid = _flatten(logits, labels, valid)
        if self.ignore_label is not None:
            valid = valid & (labels != self.ignore_label)
        c = logits.shape[-1]
        soft, onehot = _one_hot_soft(labels, c, self.eps, self.is_kitti)
        probs = torch.softmax(logits, dim=-1)
        iou, iou_class = _dice_core(probs, soft, onehot, valid,
                                    self.powerize, self.use_tmask)
        loss = -iou if self.neg_range else 1.0 - iou
        cls = -iou_class if self.neg_range else 1.0 - iou_class
        return (loss, cls) if return_class else loss


@dataclasses.dataclass
class DICELoss:
    """Reference DICELoss (lidog_tpu/losses/losses.py:98): hard one-hot
    targets, on BEV logits [B, S, S, C] with labels [B, S, S] (-1 =
    empty pixel with ignore_label=-1)."""

    ignore_label: Optional[int] = None
    powerize: bool = False
    use_tmask: bool = False

    def __call__(self, logits, labels, valid=None):
        logits, labels, valid = _flatten(logits, labels, valid)
        if self.ignore_label is not None:
            valid = valid & (labels != self.ignore_label)
        c = logits.shape[-1]
        onehot = torch.nn.functional.one_hot(labels.clamp(min=0).long(),
                                             c).float()
        probs = torch.softmax(logits, dim=-1)
        iou, _ = _dice_core(probs, onehot, onehot, valid, self.powerize,
                            self.use_tmask)
        return 1.0 - iou

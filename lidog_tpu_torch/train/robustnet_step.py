"""RobustNet train step: SoftDICE plus the instance-whitening aux loss
(lidog_tpu/train/robustnet_step.py:24-108).

  * aux = the whitening loss (IW or IRW, losses/losses.py) averaged over
    the model's 5 instance-normed taps, summed over the sources
    UNWEIGHTED (the reference's 0.5 * (aux0 + aux1) is applied through
    aux_weight, :84-88);
  * total = sum_s w_s * sem_s + gate * aux_weight * aux, with w = 1 for
    one source; gate = 1 once the epoch (step // steps_per_epoch)
    reaches cov_stat_epoch, else 0.  The gate is arithmetic, as in JAX:
    the aux loss stays in the graph with weight 0 before that epoch;
  * metrics: loss, the 3D confusion matrix and aux_loss.

State, optimizer and plans as in train/train_step.py: the caller builds a
ZPlan per source (core/zseg.py ZSegPlanBuilder).  The model is a
MinkUNet34Robust.  IBN trains through train_step.make_train_step.
"""

from __future__ import annotations

from typing import Callable, Sequence

from lidog_tpu_torch.core.engine import canon_labels, input_tensor
from lidog_tpu_torch.metrics.metrics import confusion_matrix
from lidog_tpu_torch.train.train_step import TrainState


def robust_forward(model, batch, criterion, whitening_loss, num_classes,
                   plan, suffix=""):
    """-> (sem loss, aux loss, confusion) of one source."""
    x = input_tensor(plan, batch[f"feats{suffix}"])
    logits, whitened = model(x, plan, is_seg=False)
    labels_c, valid = canon_labels(plan, batch[f"labels{suffix}"])
    sem = criterion(logits, labels_c, valid)
    aux = sum(whitening_loss(f, m) for f, m in whitened) / len(whitened)
    cm = confusion_matrix(logits.argmax(-1), labels_c, valid, num_classes)
    return sem, aux, cm


def make_robustnet_train_step(criterion: Callable, whitening_loss: Callable,
                              num_classes: int = 7,
                              source_weights: Sequence[float] = (0.5, 0.5),
                              num_sources: int = 1, cov_stat_epoch: int = 5,
                              aux_weight: float = 0.5,
                              steps_per_epoch: int = 1):
    """train_step(state, batch, plans) -> (state, {"loss", "confusion",
    "aux_loss"}).  batch and plans as in train_step.make_train_step."""

    def train_step(state: TrainState, batch, plans):
        model = state.model.train()
        state.optimizer.zero_grad()
        epoch = state.step // max(steps_per_epoch, 1)
        gate = float(epoch >= cov_stat_epoch)
        suffixes = [""] if num_sources == 1 else [str(s) for s in
                                                 range(num_sources)]
        total, aux_total, cm = 0.0, 0.0, 0
        for s, suf in enumerate(suffixes):
            plan = plans[suf] if isinstance(plans, dict) else plans
            sem, aux, cm_s = robust_forward(model, batch, criterion,
                                            whitening_loss, num_classes,
                                            plan, suf)
            total = total + (1.0 if num_sources == 1
                             else source_weights[s]) * sem
            aux_total = aux_total + aux
            cm = cm + cm_s
        total = total + gate * aux_weight * aux_total
        total.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": total.detach(), "confusion": cm,
                       "aux_loss": aux_total.detach()}

    return train_step

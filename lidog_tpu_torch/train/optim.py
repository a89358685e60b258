"""Optimizers and per-epoch LR schedules (lidog_tpu/train/optim.py).

Adam (b1 0.9, b2 0.999, eps 1e-8) or SGD with nesterov momentum, with
torch's coupled L2 weight decay (grad += wd * param before the moments),
and an optional schedule stepped once per epoch: ExponentialLR(0.99),
CosineAnnealingLR(T_max=10) or CyclicLR(triangular2, base lr/1e4,
step_size_up 5).  The update is torch.optim.Adam / SGD(nesterov=True),
with the lr set from the schedule before each step; together they compute
what the JAX package's optax chain computes (add_decayed_weights ->
scale_by_adam | trace(nesterov) -> scale_by_learning_rate(schedule)), and
the schedule reads the number of steps taken, as optax's count does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch


def make_schedule(name: Optional[str], lr: float,
                  steps_per_epoch: int) -> Callable[[int], float]:
    """step -> learning rate (lidog_tpu/train/optim.py:22)."""
    if name is None:
        return lambda step: lr

    def epoch_of(step):
        return float(step // max(steps_per_epoch, 1))

    if name == "ExponentialLR":
        return lambda step: lr * 0.99 ** epoch_of(step)
    if name == "CosineAnnealingLR":
        return lambda step: lr * 0.5 * (1 + math.cos(math.pi * epoch_of(step)
                                                     / 10.0))
    if name == "CyclicLR":
        base, step_up = lr / 10000.0, 5.0

        def sched(step):
            e = epoch_of(step)
            cycle = math.floor(e / (2 * step_up))
            x = abs(e / step_up - 2 * cycle - 1)
            return base + (lr - base) * max(1 - x, 0.0) / 2.0 ** cycle

        return sched
    raise NotImplementedError(f"unknown scheduler {name!r}")


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What make_optimizer returns: the optimizer's settings, to be built
    over a model's parameters (the counterpart of an optax
    GradientTransformation)."""

    name: str = "Adam"
    lr: float = 1e-3
    scheduler: Optional[str] = None
    steps_per_epoch: int = 1
    weight_decay: float = 0.0
    momentum: float = 0.9

    def build(self, params) -> "ScheduledOptimizer":
        return ScheduledOptimizer(self, params)


class ScheduledOptimizer:
    """A torch optimizer whose lr follows the spec's schedule.  `count` is
    the number of steps taken (optax's schedule count)."""

    def __init__(self, spec: OptimizerSpec, params):
        params = list(params)
        if spec.name == "Adam":
            self.opt = torch.optim.Adam(params, lr=spec.lr, betas=(0.9, 0.999),
                                        eps=1e-8,
                                        weight_decay=spec.weight_decay)
        elif spec.name == "SGD":
            self.opt = torch.optim.SGD(params, lr=spec.lr,
                                       momentum=spec.momentum, nesterov=True,
                                       weight_decay=spec.weight_decay)
        else:
            raise NotImplementedError(f"unknown optimizer {spec.name!r}")
        self.schedule = make_schedule(spec.scheduler, spec.lr,
                                      spec.steps_per_epoch)
        self.count = 0

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def step(self):
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1


def make_optimizer(name: str = "Adam", lr: float = 1e-3,
                   scheduler: Optional[str] = None, steps_per_epoch: int = 1,
                   weight_decay: float = 0.0,
                   momentum: float = 0.9) -> OptimizerSpec:
    """lidog_tpu/train/optim.py:50, as an OptimizerSpec."""
    if name not in ("Adam", "SGD"):
        raise NotImplementedError(f"unknown optimizer {name!r}")
    make_schedule(scheduler, lr, steps_per_epoch)  # rejects unknown names
    return OptimizerSpec(name, lr, scheduler, steps_per_epoch, weight_decay,
                         momentum)

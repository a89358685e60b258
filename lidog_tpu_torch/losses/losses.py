"""SoftDICE, the main 3D criterion (lidog_tpu/losses/losses.py:70),
DICE, LiDOG's BEV criterion (:98), and the IW / IRW whitening losses of
RobustNet (:234, :249).

Masked, in float32: padded and ignored rows contribute zero to every sum,
which is the reference's "drop ignored rows then sum".  SoftDICE and DICE
are plain PyTorch under autograd (the JAX package has no kernel there);
each takes (logits [..., C], labels [...], valid [...] or None) and
returns a scalar.  IW and IRW take (feats [N, C], mask [N]) and run on
two hand-written Triton kernels (losses/whiten_triton.py): KM
`whitening_fwd` and KN `whitening_bwd`; each `*_plain` function is the
plain PyTorch version its wrapper takes for a tensor on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from lidog_tpu_torch.ops.norm import check_rows, reduce_split

LAUNCHES = {"whitening_fwd": 0, "whitening_bwd": 0}


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


def _offdiag_consts(c: int, relax_denom: float):
    """IRW's num_off = C (C - 1) / 2 and margin = floor(num_off /
    relax_denom) (0 without a relax_denom)."""
    num_off = c * (c - 1) / 2.0
    return num_off, (math.floor(num_off / relax_denom) if relax_denom
                     else 0.0)


def whitening_rows_plain(x, mask):
    """Per row s = sum_{c < c'} |f_c f_c'| = ((sum |f|)^2 - sum f^2) / 2
    of f = x * m (lidog_tpu/losses/losses.py:211), and n = max(rows, 2)
    [1]."""
    m = mask.float()
    f = x.float() * m[:, None]
    a = f.abs().sum(1)
    s = 0.5 * (a * a - (f * f).sum(1))
    return s, m.sum().clamp(min=2.0).reshape(1)


def whitening_fwd_plain(x, mask, irw=False, relax_denom=2.0):
    """Returns (loss, s, n): IW = sum s / ((n - 1) n), or IRW = sum max((s
    / (n - 1) - margin) / num_off, 0) / n."""
    s, n = whitening_rows_plain(x, mask)
    if irw:
        num_off, margin = _offdiag_consts(x.shape[1], relax_denom)
        loss = ((s / (n - 1.0) - margin) / num_off).clamp(min=0.0).sum() / n
    else:
        loss = s.sum() / ((n - 1.0) * n)
    return loss.reshape(()), s, n


def whitening_bwd_plain(dl, x, mask, s, n, irw=False, relax_denom=2.0):
    """dx = m * w * (sgn(f) sum |f| - f) with w = dL/ds per row; sgn(f) =
    +1 at f >= 0 (JAX's |x|'), and IRW's max gate 1/2 at a tie, as JAX's
    autodiff gives them."""
    m = mask.float()
    f = x.float() * m[:, None]
    a = f.abs().sum(1)
    if irw:
        num_off, margin = _offdiag_consts(x.shape[1], relax_denom)
        t = (s / (n - 1.0) - margin) / num_off
        gate = torch.where(t > 0, 1.0, torch.where(t == 0, 0.5, 0.0))
        w = dl / n * gate / num_off / (n - 1.0)
    else:
        w = (dl / ((n - 1.0) * n)).expand(s.shape)
    sgn = torch.where(f >= 0, 1.0, -1.0)
    return ((sgn * a[:, None] - f) * (w * m)[:, None]).to(x.dtype)


def whitening_fwd(x, mask, irw=False, relax_denom=2.0):
    """KM: the IW / IRW loss (the plain version for a CPU tensor).  Returns
    (loss [], s [N], n [1]) as whitening_fwd_plain.

    Replaces lidog_tpu/losses/losses.py:211 (_per_row_offdiag_abs) with
    :234 (IWLoss) or :249 (IRWLoss).  Bound on an H100: bytes (x read
    once; s written and read back once, 4 bytes a row against 2C or 4C of
    x), no tensor-core work.  Design: (1) one program per contiguous slab
    of rows computes each row's |f| and f^2 sums in registers (a row is
    one block line), writes s and its program's sum of s and of the mask;
    (2) one program sums the partials in order into n and, for IW, the
    loss; for IRW, whose hinge needs n first, it walks s once more.  No
    float atomics: the loss does not depend on the programs' order.
    """
    if x.device.type == "cpu":
        return whitening_fwd_plain(x, mask, irw, relax_denom)
    check_rows("whitening_fwd", x, mask, None, ())
    import triton

    from lidog_tpu_torch.losses.whiten_triton import (
        whiten_finalize_kernel, whiten_rows_kernel)

    n, c = x.shape
    block_c = triton.next_power_of_2(c)
    block_r = max(1, 4096 // block_c)
    rows, progs = reduce_split(n, block_r)
    f32 = dict(dtype=torch.float32, device=x.device)
    s = torch.empty(n, **f32)
    ps, pcnt = torch.empty(progs, **f32), torch.empty(progs, **f32)
    whiten_rows_kernel[(progs,)](x, mask.view(torch.uint8), s, ps, pcnt, n, c,
                                 ROWS=rows, BLOCK_R=block_r, BLOCK_C=block_c,
                                 num_warps=4)
    num_off, margin = _offdiag_consts(c, relax_denom)
    loss, nv = torch.empty((), **f32), torch.empty(1, **f32)
    whiten_finalize_kernel[(1,)](s, ps, pcnt, progs, n, loss, nv,
                                 float(num_off), float(margin), IRW=irw,
                                 BLOCK_P=1024, BLOCK_R=1024, num_warps=4)
    LAUNCHES["whitening_fwd"] += 1
    return loss, s, nv


def whitening_bwd(dl, x, mask, s, n, irw=False, relax_denom=2.0):
    """KN: the backward of the IW / IRW loss (the plain version for a CPU
    tensor): dx from the upstream scalar dl.

    Replaces JAX's autodiff of lidog_tpu/losses/losses.py:211-265.  Bound
    on an H100: bytes (x and s read, dx written once).  Design: one
    program per block of rows recomputes each row's sum |f| in registers
    and writes dx in one pass; dl and n are read on the device, so the
    backward never waits for the host.
    """
    if x.device.type == "cpu":
        return whitening_bwd_plain(dl, x, mask, s, n, irw, relax_denom)
    check_rows("whitening_bwd", x, mask, None, ())
    import triton

    from lidog_tpu_torch.losses.whiten_triton import whiten_bwd_kernel

    n_rows, c = x.shape
    block_c = triton.next_power_of_2(c)
    block_r = max(1, 4096 // block_c)
    num_off, margin = _offdiag_consts(c, relax_denom)
    dx = torch.empty_like(x)
    if n_rows:
        whiten_bwd_kernel[(triton.cdiv(n_rows, block_r),)](
            x, mask.view(torch.uint8), s, n, dl.float().contiguous(), dx,
            n_rows, c, float(num_off), float(margin), IRW=irw,
            BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4)
    LAUNCHES["whitening_bwd"] += 1
    return dx


class _Whitening(torch.autograd.Function):
    """IW / IRW: KM forward, KN backward; the grad of feats."""

    @staticmethod
    def forward(ctx, x, mask, irw, relax_denom):
        loss, s, n = whitening_fwd(x, mask, irw, relax_denom)
        ctx.save_for_backward(x, mask, s, n)
        ctx.irw, ctx.relax_denom = irw, relax_denom
        return loss

    @staticmethod
    def backward(ctx, dl):
        x, mask, s, n = ctx.saved_tensors
        dx = whitening_bwd(dl, x, mask, s, n, ctx.irw, ctx.relax_denom)
        return dx, None, None, None


@dataclasses.dataclass
class IWLoss:
    """Instance whitening loss (lidog_tpu/losses/losses.py:234), the
    reference's effective math on [N, C] sparse features: the per-row
    outer products abs-summed over the strict upper triangle, divided by
    (n - 1) n over the n masked rows."""

    def __call__(self, feats, mask):
        return _Whitening.apply(feats, mask, False, 0.0)


@dataclasses.dataclass
class IRWLoss:
    """Instance relaxed whitening loss (lidog_tpu/losses/losses.py:249):
    per row max((s / (n - 1) - margin) / num_off, 0), averaged over the
    n masked rows."""

    relax_denom: float = 2.0

    def __call__(self, feats, mask):
        return _Whitening.apply(feats, mask, True, self.relax_denom)

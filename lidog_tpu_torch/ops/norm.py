"""Masked batch normalization fused with the residual add and ReLU, and
masked instance normalization.

Port of lidog_tpu/ops/norm.py:41 `MaskedBatchNorm` (axis_name=None), plus
the ReLU and residual add that follow it in
lidog_tpu/models/minkunet.py:213-214,252:

    y = cast((x - mean) * (rsqrt(var + eps) * scale) + bias) * m
    y = y + res        (optional; in the compute dtype, as in JAX)
    y = relu(y)        (optional)

Eval mode takes the running mean/var.  Train mode takes the masked batch
moments (`_masked_moments:24`: f32 sums over the rows of the mask, biased
variance clamped at 0, count clamped at 1) and updates the running stats
with the unbiased variance (:61-71); its gradient is JAX's autodiff of the
same expression, for feats, scale, bias and res, zero on rows outside the
mask.

`MaskedInstanceNorm` ports lidog_tpu/ops/norm.py:79: each scan of the
batch (segment coords[:, 0]; masked rows go to an extra padding segment)
is normalised with its own per-channel masked moments, with no
parameters and no running statistics, so eval mode is the same pass:

    y = cast((f - mean[seg]) * rsqrt(var[seg] + eps) * m),   f = x * m

Its gradient is JAX's autodiff of the same expression.

Five hand-written Triton kernels (ops/bn_act_triton.py): KD `bn_act`
(the fused normalising pass), KG `bn_train_fwd` (moments and running
update, then KD), KH `bn_train_bwd`, KK `instance_norm_fwd` and KL
`instance_norm_bwd`.  Each `*_plain` function is the plain PyTorch
version its wrapper takes for a tensor on the CPU.
"""

from __future__ import annotations

import torch
from torch import nn

LAUNCHES = {"bn_act": 0, "bn_train_fwd": 0, "bn_train_bwd": 0,
            "instance_norm_fwd": 0, "instance_norm_bwd": 0}

# KG/KH column reductions: about eight programs per SM of an H100
_REDUCE_PROGRAMS = 8 * 132
# KK/KL segmented reductions: two programs per SM, so that the [P, S, C]
# partials stay small against the rows they sum
_SEGMENT_PROGRAMS = 2 * 132
# the static bound on the scans of a batch (lidog_tpu/ops/norm.py:90)
NUM_BATCHES = 16


def bn_act_plain(x, mean, inv, bias, mask, res=None, relu=False):
    """inv = rsqrt(var + eps) * scale (f32, per channel)."""
    y = ((x.float() - mean) * inv + bias).to(x.dtype)
    y = y * mask[:, None].to(y.dtype)
    if res is not None:
        y = y + res
    return torch.relu(y) if relu else y


def bn_act(x, mean, inv, bias, mask, res=None, relu=False):
    """KD: the fused pass as one Triton kernel (the plain version for a
    CPU tensor).

    Replaces lidog_tpu/ops/norm.py:73-76 (eval) with the ReLU and residual
    add of lidog_tpu/models/minkunet.py:213-214,252.  Bound on an H100:
    bytes (read x and res, write y: 2-3 passes over [N, C] in the compute
    dtype; the per-channel vectors stay in cache), no tensor-core work.
    Design: one program per block of rows x all channels (the channel
    count padded to a power of two, masked), the f32 affine in registers,
    the same rounding points as JAX (round the affine result, then add the
    residual in the compute dtype).
    """
    if x.device.type == "cpu":
        return bn_act_plain(x, mean, inv, bias, mask, res, relu)
    check_rows("bn_act", x, mask, res, (mean, inv, bias))
    n, c = x.shape
    out = torch.empty_like(x)
    if n == 0:
        return out
    import triton

    from lidog_tpu_torch.ops.bn_act_triton import bn_act_kernel

    block_c = triton.next_power_of_2(c)
    block_r = max(1, 4096 // block_c)
    bn_act_kernel[(triton.cdiv(n, block_r),)](
        x, mean, inv, bias, mask.view(torch.uint8),
        x if res is None else res, out, n, c,
        HAS_RES=res is not None, RELU=relu, BLOCK_R=block_r,
        BLOCK_C=block_c, num_warps=4)
    LAUNCHES["bn_act"] += 1
    return out


def bn_train_fwd_plain(x, mask, scale, bias, run_mean, run_var, momentum,
                      eps, res=None, relu=False):
    """Train-mode forward: returns (y, mean, var_raw, inv, count) and
    updates run_mean/run_var in place.  var_raw is the unclamped biased
    variance (its sign gates the backward), inv = rsqrt(max(var_raw, 0) +
    eps) * scale, count [1] the clamped row count."""
    m = mask.float()[:, None]
    f = x.float() * m
    count = m.sum().clamp(min=1.0)
    mean = f.sum(0) / count
    var_raw = (f * f).sum(0) / count - mean * mean
    var = var_raw.clamp(min=0.0)
    unbiased = var * count / (count - 1.0).clamp(min=1.0)
    run_mean.copy_((1 - momentum) * run_mean + momentum * mean)
    run_var.copy_((1 - momentum) * run_var + momentum * unbiased)
    inv = torch.rsqrt(var + eps) * scale
    y = bn_act_plain(x, mean, inv, bias, mask, res, relu)
    return y, mean, var_raw, inv, count.reshape(1)


def bn_train_bwd_plain(dy, y, x, mask, scale, mean, var_raw, inv, count, eps,
                       has_res, relu):
    """Backward of the train-mode pass: (dx, dscale, dbias, dres).  y is
    the forward's output (read only for the ReLU gate)."""
    g = torch.where(y > 0, dy, torch.zeros_like(dy)) if relu else dy
    keep = mask[:, None]
    gf = (g * keep.to(g.dtype)).float()
    xf = x.float()
    s1 = gf.sum(0)
    s2 = (gf * (xf - mean)).sum(0)
    ve = var_raw.clamp(min=0.0) + eps
    rstd = torch.rsqrt(ve)
    dvar = s2 * scale * (-0.5 * rstd / ve)
    # max(var_raw, 0): JAX's balanced gradient, 1/2 each side at a tie
    dvar = dvar * torch.where(var_raw > 0, 1.0,
                              torch.where(var_raw == 0, 0.5, 0.0))
    dmean = -(s1 * inv) - 2.0 * mean * dvar
    a, b = dmean / count, 2.0 * dvar / count
    # the cotangents of x's two f32 casts (normalising pass, moments),
    # each rounded to x's dtype and summed in it, as JAX does
    dx = (gf * inv).to(x.dtype) + (keep.float() * (a + b * xf)).to(x.dtype)
    return dx, s2 * rstd, s1, (g if has_res else None)


def check_rows(name, x, mask, res, vecs):
    """The checks the norm and whitening kernels share: x [N, C] contiguous
    f32/bf16 on a card, mask bool [N], res like x, vecs f32 [C]."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous [N, C] tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: float32 or bfloat16 only, got {x.dtype}")
    n, c = x.shape
    for v in vecs:
        if v.dtype != torch.float32 or tuple(v.shape) != (c,) \
                or v.device != x.device or not v.is_contiguous():
            raise ValueError(f"{name}: per-channel vectors must be contiguous "
                             f"float32 [{c}] on {x.device}")
    if mask.dtype != torch.bool or tuple(mask.shape) != (n,) \
            or mask.device != x.device or not mask.is_contiguous():
        raise ValueError(f"{name}: mask must be contiguous bool [{n}]")
    if res is not None and (res.shape != x.shape or res.dtype != x.dtype
                            or res.device != x.device
                            or not res.is_contiguous()):
        raise ValueError(f"{name}: res must match x")


def reduce_split(n, block_r, programs=_REDUCE_PROGRAMS):
    """Rows per program (a power of two, a multiple of block_r) and the
    program count of a column reduction over about `programs` slabs."""
    import triton

    rows = max(block_r, triton.next_power_of_2(
        triton.cdiv(max(n, 1), programs)))
    return rows, max(1, triton.cdiv(n, rows))


def bn_train_fwd(x, mask, scale, bias, run_mean, run_var, momentum, eps,
                 res=None, relu=False):
    """KG: train-mode moments, running update and the fused normalising
    pass (the plain version for a CPU tensor).  Returns (y, mean, var_raw,
    inv, count) as bn_train_fwd_plain.

    Replaces lidog_tpu/ops/norm.py:24-38 (_masked_moments) and :61-76.
    Bound on an H100: bytes (x read twice: once for the moments, once by
    the normalising pass; res read and y written once), no tensor-core
    work.  Design: (1) one program per contiguous slab of rows sums the
    masked values, their squares and the mask into f32 partials per
    program, so the result does not depend on which program runs first;
    (2) one program per block of channels sums the partials in order,
    applies JAX's clamps, updates the running stats in place and writes
    mean, var_raw and inv; (3) KD (bn_act) normalises.
    """
    if x.device.type == "cpu":
        return bn_train_fwd_plain(x, mask, scale, bias, run_mean, run_var,
                                  momentum, eps, res, relu)
    check_rows("bn_train_fwd", x, mask, res,
                (scale, bias, run_mean, run_var))
    import triton

    from lidog_tpu_torch.ops.bn_act_triton import (
        bn_stats_kernel, bn_train_finalize_kernel)

    n, c = x.shape
    block_c = triton.next_power_of_2(c)
    block_r = max(1, 4096 // block_c)
    rows, progs = reduce_split(n, block_r)
    f32 = dict(dtype=torch.float32, device=x.device)
    psum, psq = torch.empty(progs, c, **f32), torch.empty(progs, c, **f32)
    pcnt = torch.empty(progs, **f32)
    bn_stats_kernel[(progs,)](x, mask.view(torch.uint8), psum, psq, pcnt, n,
                              c, ROWS=rows, BLOCK_R=block_r, BLOCK_C=block_c,
                              num_warps=4)
    mean, var_raw, inv = (torch.empty(c, **f32) for _ in range(3))
    count = torch.empty(1, **f32)
    fin_c = min(block_c, 128)
    bn_train_finalize_kernel[(triton.cdiv(c, fin_c),)](
        psum, psq, pcnt, progs, scale, run_mean, run_var, mean, var_raw, inv,
        count, c, float(momentum), float(eps), BLOCK_P=4096 // fin_c,
        BLOCK_C=fin_c, num_warps=4)
    LAUNCHES["bn_train_fwd"] += 1
    y = bn_act(x, mean, inv, bias, mask, res, relu)
    return y, mean, var_raw, inv, count


def bn_train_bwd(dy, y, x, mask, scale, mean, var_raw, inv, count, eps,
                 has_res, relu):
    """KH: the backward of the train-mode pass (the plain version for a
    CPU tensor).  Returns (dx, dscale, dbias, dres or None).

    Replaces JAX's autodiff of lidog_tpu/ops/norm.py:24-76 with the ReLU
    and residual add after it (JAX has no custom VJP here).  Bound on an
    H100: bytes (dy, y and x read twice, dx and dres written once).
    Design: (1) per-program f32 partials of sum(g) and sum(g * (x -
    mean)) over masked rows, g = dy through the ReLU gate; (2) per channel
    block, the partials summed in order into dbias, dscale and the two
    coefficients of the moment term; (3) one elementwise pass writes dres
    = g and dx = round(g * inv) + round(mask * (a + b * x)).
    """
    if dy.device.type == "cpu":
        return bn_train_bwd_plain(dy, y, x, mask, scale, mean, var_raw, inv,
                                  count, eps, has_res, relu)
    check_rows("bn_train_bwd", x, mask, dy, (scale, mean, var_raw, inv))
    if relu:
        check_rows("bn_train_bwd", x, mask, y, ())
    import triton

    from lidog_tpu_torch.ops.bn_act_triton import (
        bn_bwd_apply_kernel, bn_bwd_finalize_kernel, bn_bwd_reduce_kernel)

    n, c = x.shape
    block_c = triton.next_power_of_2(c)
    block_r = max(1, 4096 // block_c)
    rows, progs = reduce_split(n, block_r)
    f32 = dict(dtype=torch.float32, device=x.device)
    ps1, ps2 = torch.empty(progs, c, **f32), torch.empty(progs, c, **f32)
    y_arg = y if relu else x
    bn_bwd_reduce_kernel[(progs,)](dy, y_arg, x, mask.view(torch.uint8), mean,
                                   ps1, ps2, n, c, RELU=relu, ROWS=rows,
                                   BLOCK_R=block_r, BLOCK_C=block_c,
                                   num_warps=4)
    dscale, dbias, a, b = (torch.empty(c, **f32) for _ in range(4))
    fin_c = min(block_c, 128)
    bn_bwd_finalize_kernel[(triton.cdiv(c, fin_c),)](
        ps1, ps2, progs, scale, mean, var_raw, inv, count, dscale, dbias, a,
        b, c, float(eps), BLOCK_P=4096 // fin_c, BLOCK_C=fin_c, num_warps=4)
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if has_res else None
    if n:
        bn_bwd_apply_kernel[(triton.cdiv(n, block_r),)](
            dy, y_arg, x, mask.view(torch.uint8), inv, a, b, dx,
            dx if dres is None else dres, n, c, HAS_RES=has_res, RELU=relu,
            BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4)
    LAUNCHES["bn_train_bwd"] += 1
    return dx, dscale, dbias, dres


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode MaskedBatchNorm (+ residual, ReLU): KG forward, KH
    backward; grads for feats, scale, bias and res."""

    @staticmethod
    def forward(ctx, x, scale, bias, res, mask, run_mean, run_var, momentum,
                eps, relu):
        y, mean, var_raw, inv, count = bn_train_fwd(
            x, mask, scale, bias, run_mean, run_var, momentum, eps, res, relu)
        ctx.save_for_backward(x, y if relu else None, mask, scale, mean,
                              var_raw, inv, count)
        ctx.eps, ctx.relu, ctx.has_res = eps, relu, res is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, mask, scale, mean, var_raw, inv, count = ctx.saved_tensors
        dx, dscale, dbias, dres = bn_train_bwd(
            dy.contiguous(), y, x, mask, scale, mean, var_raw, inv, count,
            ctx.eps, ctx.has_res, ctx.relu)
        return dx, dscale, dbias, dres, None, None, None, None, None, None


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of a padded sparse feature matrix:
    batch moments and a running update in train mode, the running
    averages in eval mode.  Parameter and buffer names follow the flax
    module: params scale/bias, batch_stats mean/var."""

    # the running-stats momentum of every norm of the JAX model, which
    # never passes its bn_momentum on (ROADMAP section 3)
    MOMENTUM = 0.1

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, feats, mask, res=None, relu=False):
        if self.training:
            return _BatchNormTrain.apply(feats, self.scale, self.bias, res,
                                         mask, self.mean, self.var,
                                         self.MOMENTUM, self.epsilon, relu)
        inv = torch.rsqrt(self.var + self.epsilon) * self.scale
        return bn_act(feats, self.mean, inv, self.bias, mask, res, relu)


def _segments(mask, batch_idx, num_batches):
    """seg = batch_idx on the rows of the mask, num_batches (the padding
    segment) elsewhere."""
    return torch.where(mask, batch_idx.long(),
                       torch.full_like(batch_idx, num_batches).long())


def _segment_sum(values, seg, num_segments):
    """f32 sums per segment, accumulated in f64 and rounded once: a plain
    f32 index_add_ adds a scan's ~10^5 rows one after another into one
    value (a relative error of ~1e-5 at full size, more than the kernels'
    blocked sums make), so the reference sums exactly."""
    out = torch.zeros((num_segments,) + values.shape[1:], dtype=torch.float64,
                      device=values.device)
    return out.index_add_(0, seg, values.double()).float()


def instance_norm_fwd_plain(x, mask, batch_idx, num_batches=NUM_BATCHES,
                            eps=1e-5):
    """Returns (y, mean, var_raw, rstd, count): per segment [S, C] f32
    (S = num_batches + 1) the mean, the unclamped biased variance and
    rsqrt(max(var_raw, 0) + eps); count [S] clamped at 1."""
    ns = num_batches + 1
    m = mask.float()[:, None]
    f = x.float() * m
    seg = _segments(mask, batch_idx, num_batches)
    count = _segment_sum(m[:, 0], seg, ns).clamp(min=1.0)
    mean = _segment_sum(f, seg, ns) / count[:, None]
    var_raw = _segment_sum(f * f, seg, ns) / count[:, None] - mean * mean
    rstd = torch.rsqrt(var_raw.clamp(min=0.0) + eps)
    y = ((f - mean[seg]) * rstd[seg] * m).to(x.dtype)
    return y, mean, var_raw, rstd, count


def instance_norm_bwd_plain(dy, x, mask, batch_idx, mean, var_raw, rstd,
                            count, eps=1e-5):
    """dx of the instance norm: m * (g * rstd + a + b * f) per segment,
    with g = dy in f32, a = dmean / count and b = 2 dvar / count (JAX's
    tie rule at var_raw == 0), rounded once to x's dtype."""
    num_batches = mean.shape[0] - 1
    m = mask.float()[:, None]
    g = dy.float() * m
    f = x.float() * m
    seg = _segments(mask, batch_idx, num_batches)
    s1 = _segment_sum(g, seg, num_batches + 1)
    s2 = _segment_sum(g * (f - mean[seg]), seg, num_batches + 1)
    ve = var_raw.clamp(min=0.0) + eps
    dvar = s2 * (-0.5 * rstd / ve)
    # max(var_raw, 0): JAX's balanced gradient, 1/2 each side at a tie
    dvar = dvar * torch.where(var_raw > 0, 1.0,
                              torch.where(var_raw == 0, 0.5, 0.0))
    dmean = -(s1 * rstd) - 2.0 * mean * dvar
    a, b = dmean / count[:, None], 2.0 * dvar / count[:, None]
    return ((g * rstd[seg] + a[seg] + b[seg] * f) * m).to(x.dtype)


def _check_segments(name, x, mask, batch_idx, dy=None):
    check_rows(name, x, mask, dy, ())
    if batch_idx.dtype != torch.int32 or batch_idx.dim() != 1 \
            or batch_idx.shape[0] != x.shape[0] \
            or batch_idx.device != x.device:
        raise ValueError(f"{name}: batch_idx must be int32 [{x.shape[0]}] on "
                         f"{x.device}")


def instance_norm_fwd(x, mask, batch_idx, num_batches=NUM_BATCHES,
                      eps=1e-5):
    """KK: the segmented masked instance norm (the plain version for a
    CPU tensor).  Returns (y, mean, var_raw, rstd, count) as
    instance_norm_fwd_plain.

    Replaces lidog_tpu/ops/norm.py:79-104 (MaskedInstanceNorm: three
    segment_sums, then the gathered normalising pass).  Bound on an H100:
    bytes (x read twice, y written once; the [S, C] statistics stay in
    cache), no tensor-core work.  Design: (1) one program per contiguous
    slab of rows finds the segments of its real rows (rows of a scan sit
    together in a plan level, so usually one or two), and for each sums
    f, f * f and the count into f32 partials [P, S, C], so the result does
    not depend on which program runs first (no float atomics); (2) one
    program per (segment, channel block) sums the partials in order and
    applies JAX's clamps; (3) one elementwise pass gathers each row's
    segment statistics and normalises.
    """
    if x.device.type == "cpu":
        return instance_norm_fwd_plain(x, mask, batch_idx, num_batches, eps)
    _check_segments("instance_norm_fwd", x, mask, batch_idx)
    import triton

    from lidog_tpu_torch.ops.bn_act_triton import (
        in_apply_kernel, in_finalize_kernel, in_stats_kernel)

    n, c = x.shape
    ns = num_batches + 1
    block_c = triton.next_power_of_2(c)
    block_r = max(1, 4096 // block_c)
    rows, progs = reduce_split(n, block_r, _SEGMENT_PROGRAMS)
    f32 = dict(dtype=torch.float32, device=x.device)
    psum, psq = torch.zeros(progs, ns, c, **f32), torch.zeros(progs, ns, c,
                                                              **f32)
    pcnt = torch.zeros(progs, ns, **f32)
    mask_u8 = mask.view(torch.uint8)
    bstride = batch_idx.stride(0)
    in_stats_kernel[(progs,)](x, mask_u8, batch_idx, bstride, psum, psq,
                              pcnt, n, c, S=ns, ROWS=rows, BLOCK_R=block_r,
                              BLOCK_C=block_c, num_warps=4)
    mean, var_raw, rstd = (torch.empty(ns, c, **f32) for _ in range(3))
    count = torch.empty(ns, **f32)
    fin_c = min(block_c, 128)
    in_finalize_kernel[(ns, triton.cdiv(c, fin_c))](
        psum, psq, pcnt, progs, mean, var_raw, rstd, count, c, float(eps),
        S=ns, BLOCK_P=4096 // fin_c, BLOCK_C=fin_c, num_warps=4)
    y = torch.empty_like(x)
    if n:
        in_apply_kernel[(triton.cdiv(n, block_r),)](
            x, mask_u8, batch_idx, bstride, mean, rstd, y, n, c, S=ns,
            BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4)
    LAUNCHES["instance_norm_fwd"] += 1
    return y, mean, var_raw, rstd, count


def instance_norm_bwd(dy, x, mask, batch_idx, mean, var_raw, rstd, count,
                      eps=1e-5):
    """KL: the backward of the instance norm (the plain version for a CPU
    tensor).  Returns dx.

    Replaces JAX's autodiff of lidog_tpu/ops/norm.py:79-104.  Bound on an
    H100: bytes (dy and x read twice, dx written once).  Design: (1) per
    program and segment of its slab, f32 partials of sum(g) and sum(g *
    (f - mean)) over the real rows; (2) per (segment, channel block), the
    partials summed in order into the two coefficients of the moment
    term; (3) one elementwise pass writes dx = m * (g * rstd + a + b * f),
    zero on masked rows.
    """
    if dy.device.type == "cpu":
        return instance_norm_bwd_plain(dy, x, mask, batch_idx, mean, var_raw,
                                       rstd, count, eps)
    _check_segments("instance_norm_bwd", x, mask, batch_idx, dy)
    import triton

    from lidog_tpu_torch.ops.bn_act_triton import (
        in_bwd_apply_kernel, in_bwd_finalize_kernel, in_bwd_reduce_kernel)

    n, c = x.shape
    ns = mean.shape[0]
    block_c = triton.next_power_of_2(c)
    block_r = max(1, 4096 // block_c)
    rows, progs = reduce_split(n, block_r, _SEGMENT_PROGRAMS)
    f32 = dict(dtype=torch.float32, device=x.device)
    ps1, ps2 = torch.zeros(progs, ns, c, **f32), torch.zeros(progs, ns, c,
                                                             **f32)
    mask_u8 = mask.view(torch.uint8)
    bstride = batch_idx.stride(0)
    in_bwd_reduce_kernel[(progs,)](dy, x, mask_u8, batch_idx, bstride, mean,
                                   ps1, ps2, n, c, S=ns, ROWS=rows,
                                   BLOCK_R=block_r, BLOCK_C=block_c,
                                   num_warps=4)
    a, b = torch.empty(ns, c, **f32), torch.empty(ns, c, **f32)
    fin_c = min(block_c, 128)
    in_bwd_finalize_kernel[(ns, triton.cdiv(c, fin_c))](
        ps1, ps2, progs, mean, var_raw, rstd, count, a, b, c, float(eps),
        S=ns, BLOCK_P=4096 // fin_c, BLOCK_C=fin_c, num_warps=4)
    dx = torch.empty_like(x)
    if n:
        in_bwd_apply_kernel[(triton.cdiv(n, block_r),)](
            dy, x, mask_u8, batch_idx, bstride, rstd, a, b, dx, n, c, S=ns,
            BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4)
    LAUNCHES["instance_norm_bwd"] += 1
    return dx


class _InstanceNorm(torch.autograd.Function):
    """MaskedInstanceNorm: KK forward, KL backward; the grad of feats."""

    @staticmethod
    def forward(ctx, x, mask, batch_idx, num_batches, eps):
        y, mean, var_raw, rstd, count = instance_norm_fwd(
            x, mask, batch_idx, num_batches, eps)
        ctx.save_for_backward(x, mask, batch_idx, mean, var_raw, rstd, count)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = instance_norm_bwd(dy.contiguous(), *ctx.saved_tensors, ctx.eps)
        return dx, None, None, None, None


class MaskedInstanceNorm(nn.Module):
    """Per-scan normalisation of the rows of the mask, no parameters (the
    IBN and RobustNet norms).  batch_idx: int32 [N], coords[:, 0] of the
    level, below NUM_BATCHES; the masked rows form one more, padding,
    segment."""

    EPSILON = 1e-5

    def forward(self, feats, mask, batch_idx):
        return _InstanceNorm.apply(feats, mask, batch_idx, NUM_BATCHES,
                                   self.EPSILON)

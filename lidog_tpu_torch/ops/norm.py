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

Five hand-written kernels in CUDA C++: in csrc/masked_bn.cu KD `bn_act`
(the fused normalising pass), KG `bn_train_fwd` (moments and running
update in one launch, then KD) and KH `bn_train_bwd` (two launches); in
csrc/instance_norm.cu KK `instance_norm_fwd` and KL `instance_norm_bwd`
(two launches each).  All five walk rows by `bn_split` and share
csrc/masked_rows.cuh.  Each `*_plain` function is the plain PyTorch
version its wrapper takes for a tensor on the CPU.
"""

from __future__ import annotations

from collections import namedtuple

import torch
from torch import nn

from lidog_tpu_torch.ops import _cuda
from lidog_tpu_torch.ops._wrap import DTYPES, ptr

LAUNCHES = {"bn_act": 0, "bn_train_fwd": 0, "bn_train_bwd": 0,
            "instance_norm_fwd": 0, "instance_norm_bwd": 0}

# KD, KG and KH (csrc/masked_bn.cu): threads a block at most and the
# blocks a launch aims at on an H100's 132 SMs, for the two reductions
# (one large block a SM: one wave at their register counts, and the block
# that finishes last reads every block's partials) and for the streaming
# passes (KD, KH's apply: small blocks, several a SM, each at least
# BN_APPLY_STEPS steps, the rows a thread loads at once); the thread caps
# are the source's MAX_THREADS and MAX_APPLY_THREADS
BN_REDUCE_THREADS = 512
BN_REDUCE_BLOCKS = 132
BN_APPLY_THREADS = 128
BN_APPLY_BLOCKS = 16 * 132
BN_APPLY_STEPS = 4
# KM's column reductions (losses/losses.py): about eight programs per SM
_REDUCE_PROGRAMS = 8 * 132
# the static bound on the scans of a batch (lidog_tpu/ops/norm.py:90)
NUM_BATCHES = 16
# KK and KL (csrc/instance_norm.cu): segments a launch takes at most (one
# bit each in a block's word; the source's MAX_SEGMENTS)
IN_MAX_SEGMENTS = 32


def bn_act_plain(x, mean, inv, bias, mask, res=None, relu=False):
    """inv = rsqrt(var + eps) * scale (f32, per channel)."""
    y = ((x.float() - mean) * inv + bias).to(x.dtype)
    y = y * mask[:, None].to(y.dtype)
    if res is not None:
        y = y + res
    return torch.relu(y) if relu else y


def bn_act(x, mean, inv, bias, mask, res=None, relu=False):
    """KD (csrc/masked_bn.cu bn_act, one launch; the plain version for a
    CPU tensor).

    Replaces lidog_tpu/ops/norm.py:73-76 (eval) with the ReLU and residual
    add of lidog_tpu/models/minkunet.py:213-214,252.  Bound on an H100:
    bytes (read x and res, write y: 2-3 passes over [N, C] in the compute
    dtype; the per-channel vectors stay in cache), no tensor-core work.
    Design: each thread owns one 16-byte group of channels (bn_split) and
    walks a block's contiguous run of rows; the f32 affine in registers,
    the same rounding points as JAX (round the affine result, mask, then
    add the residual in f32 and round once at the store).
    """
    if x.device.type == "cpu":
        return bn_act_plain(x, mean, inv, bias, mask, res, relu)
    check_rows("bn_act", x, mask, res, (mean, inv, bias))
    n, c = x.shape
    out = torch.empty_like(x)
    if n == 0:
        return out
    sp = bn_split(n, c, x.element_size(),
                  _aligned(x, res, out, mean, inv, bias))
    _cuda.call("bn_act", x.data_ptr(), mean.data_ptr(), inv.data_ptr(),
               bias.data_ptr(), mask.data_ptr(), ptr(res), out.data_ptr(), n,
               c, *_split_args(sp), int(relu), DTYPES[x.dtype])
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
    program count of a column reduction over about `programs` slabs
    (KM)."""
    import triton

    rows = max(block_r, triton.next_power_of_2(
        triton.cdiv(max(n, 1), programs)))
    return rows, max(1, triton.cdiv(n, rows))


BnSplit = namedtuple("BnSplit",
                     "vec groups gpb lanes threads steps blocks chunks")


def bn_split(n, c, element_size, aligned=True, reduce=False):
    """The split of KD, KG and KH (csrc/masked_bn.cu) over [n, c] rows of
    element_size bytes, for a reduction (KG's moments, KH's sums) or a
    streaming pass: each thread owns `vec` channels (16 bytes when a row
    is a multiple of 16 bytes and the tensors and per-channel vectors are
    16-byte aligned, else 1); a block covers `gpb` of the row's `groups`
    channel groups (`chunks` such chunks, more than one only past a
    block's threads) and `lanes` rows a step (a power of two, threads =
    gpb * lanes <= BN_REDUCE_THREADS or BN_APPLY_THREADS), `steps` steps
    of one contiguous run of rows (at least BN_APPLY_STEPS in a streaming
    pass); about BN_REDUCE_BLOCKS or BN_APPLY_BLOCKS such runs, or fewer
    (never an empty run, one when n is 0)."""
    cap = BN_REDUCE_THREADS if reduce else BN_APPLY_THREADS
    blocks = BN_REDUCE_BLOCKS if reduce else BN_APPLY_BLOCKS
    vec = 16 // element_size if aligned and (c * element_size) % 16 == 0 \
        else 1
    groups = c // vec
    gpb = min(groups, cap)
    chunks = -(-groups // gpb)
    lanes = 1
    while gpb * lanes * 2 <= cap:
        lanes *= 2
    total = -(-n // lanes)  # row steps
    steps = max(1, -(-total // max(1, min(blocks, total))))
    if not reduce:
        steps = max(steps, BN_APPLY_STEPS)
    return BnSplit(vec, groups, gpb, lanes, gpb * lanes, steps,
                   max(1, -(-total // steps)), chunks)


def _split_args(sp):
    return sp.vec, sp.gpb, sp.lanes, sp.steps, sp.blocks, sp.chunks


def _aligned(*tensors):
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


_TICKETS = {}


def _ticket(device):
    """The int32 ticket of KG's and KH's last-block finish on `device`:
    zeroed once here, left at 0 by every launch (one stream)."""
    t = _TICKETS.get(device)
    if t is None:
        t = _TICKETS[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


def _per_channel(c):
    """Offsets of per-channel vectors in a workspace: c rounded up to 4
    floats, so that each vector and what follows starts 16-byte aligned."""
    return -(-c // 4) * 4


def _layout(*sizes):
    """The float offsets of consecutive regions of `sizes` floats in one
    f32 workspace, each starting 16-byte aligned, and the workspace's
    size."""
    offs, at = [], 0
    for n in sizes:
        offs.append(at)
        at += _per_channel(n)
    return offs, at


def _bn_train_stats(x, mask, scale, run_mean, run_var, momentum, eps):
    """KG's moments (csrc/masked_bn.cu bn_train_stats, one launch): updates
    run_mean and run_var in place and returns (mean, var_raw, inv, count)
    as bn_train_fwd_plain does, views of one workspace that also holds the
    blocks' partials."""
    n, c = x.shape
    sp = bn_split(n, c, x.element_size(), _aligned(x), reduce=True)
    cp = _per_channel(c)
    ws = torch.empty(3 * cp + 4 + sp.blocks * (2 * c + 1),
                     dtype=torch.float32, device=x.device)
    base, part = ws.data_ptr(), 3 * cp + 4
    _cuda.call("bn_train_stats", x.data_ptr(), mask.data_ptr(),
               scale.data_ptr(), run_mean.data_ptr(), run_var.data_ptr(),
               base + 4 * part, base + 4 * (part + sp.blocks * c),
               base + 4 * (part + 2 * sp.blocks * c), base, base + 4 * cp,
               base + 8 * cp, base + 12 * cp, _ticket(x.device).data_ptr(),
               n, c, *_split_args(sp), float(momentum), float(eps),
               DTYPES[x.dtype])
    return ws[:c], ws[cp:cp + c], ws[2 * cp:2 * cp + c], ws[3 * cp:3 * cp + 1]


def bn_train_fwd(x, mask, scale, bias, run_mean, run_var, momentum, eps,
                 res=None, relu=False):
    """KG: train-mode moments, running update and the fused normalising
    pass (the plain version for a CPU tensor).  Returns (y, mean, var_raw,
    inv, count) as bn_train_fwd_plain.

    Replaces lidog_tpu/ops/norm.py:24-38 (_masked_moments) and :61-76.
    Bound on an H100: bytes (x, res read and y written once; the kernels
    read x twice), no tensor-core work.  Design (csrc/masked_bn.cu): (1)
    bn_train_stats: each block sums the masked values, their squares and
    the mask over its run of rows into f32 partials; the block that
    finishes last sums the partials in block order, applies JAX's clamps,
    updates the running stats in place and writes mean, var_raw, inv and
    count, so the result does not depend on which block runs first; (2)
    KD (bn_act) normalises.  Two launches a call.
    """
    if x.device.type == "cpu":
        return bn_train_fwd_plain(x, mask, scale, bias, run_mean, run_var,
                                  momentum, eps, res, relu)
    check_rows("bn_train_fwd", x, mask, res,
               (scale, bias, run_mean, run_var))
    mean, var_raw, inv, count = _bn_train_stats(x, mask, scale, run_mean,
                                                run_var, momentum, eps)
    LAUNCHES["bn_train_fwd"] += 1
    y = bn_act(x, mean, inv, bias, mask, res, relu)
    return y, mean, var_raw, inv, count


def _bn_bwd_reduce(dy, y, x, mask, scale, mean, var_raw, inv, count, eps,
                   has_res, relu):
    """KH's sums (csrc/masked_bn.cu bn_bwd_reduce, one launch): returns
    (dscale, dbias, a, b, dres or None), the per-channel vectors views of
    one workspace; dres = g (dy through the ReLU gate) when has_res."""
    n, c = x.shape
    dres = torch.empty_like(x) if has_res else None
    sp = bn_split(n, c, x.element_size(), _aligned(dy, y, x, dres, mean),
                  reduce=True)
    cp = _per_channel(c)
    ws = torch.empty(4 * cp + 2 * sp.blocks * c, dtype=torch.float32,
                     device=x.device)
    base, part = ws.data_ptr(), 4 * cp
    _cuda.call("bn_bwd_reduce", dy.data_ptr(), ptr(y) if relu else None,
               x.data_ptr(), mask.data_ptr(), scale.data_ptr(),
               mean.data_ptr(), var_raw.data_ptr(), inv.data_ptr(),
               count.data_ptr(), ptr(dres), base + 4 * part,
               base + 4 * (part + sp.blocks * c), base, base + 4 * cp,
               base + 8 * cp, base + 12 * cp, _ticket(x.device).data_ptr(),
               n, c, *_split_args(sp), int(relu), float(eps),
               DTYPES[x.dtype])
    return (ws[:c], ws[cp:cp + c], ws[2 * cp:2 * cp + c],
            ws[3 * cp:3 * cp + c], dres)


def bn_train_bwd(dy, y, x, mask, scale, mean, var_raw, inv, count, eps,
                 has_res, relu):
    """KH: the backward of the train-mode pass (the plain version for a
    CPU tensor).  Returns (dx, dscale, dbias, dres or None).

    Replaces JAX's autodiff of lidog_tpu/ops/norm.py:24-76 with the ReLU
    and residual add after it (JAX has no custom VJP here).  Bound on an
    H100: bytes (dy, y and x read, dx and dres written once).  Design
    (csrc/masked_bn.cu): (1) bn_bwd_reduce: per-block f32 partials of
    sum(g * m) and sum(g * m * (x - mean)), g = dy through the ReLU gate
    (written as dres when there is a residual); the block that finishes
    last sums them in block order into dbias, dscale and the two
    coefficients of the moment term; (2) bn_bwd_apply writes dx =
    round(g * m * inv) + round(m * (a + b * x)), reading g from dres when
    there is one.  Two launches a call.
    """
    if dy.device.type == "cpu":
        return bn_train_bwd_plain(dy, y, x, mask, scale, mean, var_raw, inv,
                                  count, eps, has_res, relu)
    check_rows("bn_train_bwd", x, mask, dy, (scale, mean, var_raw, inv))
    if relu:
        check_rows("bn_train_bwd", x, mask, y, ())
    if count.dtype != torch.float32 or tuple(count.shape) != (1,) \
            or count.device != x.device:
        raise ValueError(f"bn_train_bwd: count must be float32 [1] on "
                         f"{x.device}")
    dscale, dbias, a, b, dres = _bn_bwd_reduce(
        dy, y, x, mask, scale, mean, var_raw, inv, count, eps, has_res, relu)
    n, c = x.shape
    dx = torch.empty_like(x)
    if n:
        # g from dres (already through the gate), or from dy and y
        g, gate = (dres, None) if has_res else (dy, y if relu else None)
        sp = bn_split(n, c, x.element_size(),
                      _aligned(g, gate, x, dx, inv, a, b))
        _cuda.call("bn_bwd_apply", g.data_ptr(), ptr(gate), x.data_ptr(),
                   mask.data_ptr(), inv.data_ptr(), a.data_ptr(),
                   b.data_ptr(), dx.data_ptr(), n, c, *_split_args(sp),
                   DTYPES[x.dtype])
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


InPlan = namedtuple("InPlan", "sums apply args fwd bwd")
_IN_PLANS = {}


def _in_plan(n, c, element_size, aligned, ns):
    """KK's and KL's launch plan for [n, c] rows and ns segments, kept per
    shape (a call's host time is most of its time at the small levels):
    the splits of the two launches (the sums take bn_split's reduction,
    the streaming pass its streaming split), their arguments as the C
    entry points take them, and the (float offsets, size) of KK's
    workspace (mean, var_raw and rstd [3, S, c], count [S]; psum, psq
    [blocks, S, c], the row counts [blocks, S], the bit words [blocks])
    and of KL's (ps1, ps2, the bit words; a, b [S, c])."""
    key = (n, c, element_size, aligned, ns, BN_REDUCE_BLOCKS,
           BN_APPLY_BLOCKS)
    plan = _IN_PLANS.get(key)
    if plan is None:
        sums = bn_split(n, c, element_size, aligned, reduce=True)
        apply = bn_split(n, c, element_size, aligned)
        sc, part = ns * c, sums.blocks * ns * c
        if len(_IN_PLANS) >= 64:
            _IN_PLANS.clear()
        plan = _IN_PLANS[key] = InPlan(
            sums, apply, (*_split_args(sums), *_split_args(apply)),
            _layout(3 * sc, ns, part, part, sums.blocks * ns, sums.blocks),
            _layout(part, part, sums.blocks, sc, sc))
    return plan


def _in_segments(name, ns):
    if not 1 <= ns <= IN_MAX_SEGMENTS:
        raise ValueError(f"{name}: the kernel takes 1 to {IN_MAX_SEGMENTS} "
                         f"segments (num_batches + 1), got {ns}")


def instance_norm_fwd(x, mask, batch_idx, num_batches=NUM_BATCHES,
                      eps=1e-5):
    """KK: the segmented masked instance norm (the plain version for a
    CPU tensor).  Returns (y, mean, var_raw, rstd, count) as
    instance_norm_fwd_plain.

    Replaces lidog_tpu/ops/norm.py:79-104 (MaskedInstanceNorm: three
    segment_sums, then the gathered normalising pass).  Bound on an H100:
    bytes (x read twice, y written once; the [S, C] statistics stay in
    cache), no tensor-core work.  Design (csrc/instance_norm.cu, one C
    call, two launches, no fill): (1) each block of bn_split's reduction
    finds the segments of its run's real rows (one or two in a plan
    level, where a scan's rows are contiguous), sums f, f * f and the
    count of each into f32 partials and writes a bit word of the segments
    it wrote; the block that draws the last ticket sums each segment's
    partials in a fixed order, applies JAX's clamps and writes the
    statistics, so the result does not depend on which block finishes
    first; (2) a streaming pass normalises each row with its segment's
    statistics, kept in registers.
    """
    if x.device.type == "cpu":
        return instance_norm_fwd_plain(x, mask, batch_idx, num_batches, eps)
    _check_segments("instance_norm_fwd", x, mask, batch_idx)
    ns = num_batches + 1
    _in_segments("instance_norm_fwd", ns)
    n, c = x.shape
    plan = _in_plan(n, c, x.element_size(), _aligned(x), ns)
    offs, size = plan.fwd
    ws = torch.empty(size, dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    base, sc = ws.data_ptr(), ns * c
    _cuda.call("instance_norm_fwd", x.data_ptr(), mask.data_ptr(),
               batch_idx.data_ptr(), y.data_ptr(),
               *(base + 4 * o for o in offs[2:]), base, base + 4 * sc,
               base + 8 * sc, base + 4 * offs[1],
               _ticket(x.device).data_ptr(), n, c, batch_idx.stride(0), ns,
               *plan.args, float(eps), DTYPES[x.dtype])
    LAUNCHES["instance_norm_fwd"] += 1
    mean, var_raw, rstd = (ws.as_strided((ns, c), (c, 1), i * sc)
                           for i in range(3))
    return y, mean, var_raw, rstd, ws.as_strided((ns,), (1,), offs[1])


def instance_norm_bwd(dy, x, mask, batch_idx, mean, var_raw, rstd, count,
                      eps=1e-5):
    """KL: the backward of the instance norm (the plain version for a CPU
    tensor).  Returns dx.

    Replaces JAX's autodiff of lidog_tpu/ops/norm.py:79-104.  Bound on an
    H100: bytes (dy and x read twice, dx written once).  Design
    (csrc/instance_norm.cu, one C call, two launches, no fill): (1) as
    KK's sums, per segment of a block's real rows f32 partials of sum(g)
    and sum(g * (f - mean)); the last block sums them in a fixed order
    into the two coefficients of the moment term (JAX's 1/2 at var_raw ==
    0);
    (2) a streaming pass writes dx = m * (g * rstd + a + b * f), rounded
    once.
    """
    if dy.device.type == "cpu":
        return instance_norm_bwd_plain(dy, x, mask, batch_idx, mean, var_raw,
                                       rstd, count, eps)
    _check_segments("instance_norm_bwd", x, mask, batch_idx, dy)
    n, c = x.shape
    ns = mean.shape[0]
    _in_segments("instance_norm_bwd", ns)
    for v in (mean, var_raw, rstd, count):
        if v.dtype != torch.float32 or v.device != x.device \
                or not v.is_contiguous() \
                or tuple(v.shape) != ((ns,) if v is count else (ns, c)):
            raise ValueError(f"instance_norm_bwd: the statistics must be "
                             f"contiguous float32 [{ns}, {c}] (count [{ns}]) "
                             f"on {x.device}")
    plan = _in_plan(n, c, x.element_size(), _aligned(dy, x, mean, rstd), ns)
    offs, size = plan.bwd
    ws = torch.empty(size, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    base = ws.data_ptr()
    _cuda.call("instance_norm_bwd", dy.data_ptr(), x.data_ptr(),
               mask.data_ptr(), batch_idx.data_ptr(), mean.data_ptr(),
               var_raw.data_ptr(), rstd.data_ptr(), count.data_ptr(),
               dx.data_ptr(), *(base + 4 * o for o in offs),
               _ticket(x.device).data_ptr(), n, c, batch_idx.stride(0), ns,
               *plan.args, float(eps), DTYPES[x.dtype])
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

"""The instance-norm kernels, in Triton: KK (the segmented masked
instance norm) and KL (its backward).  The BatchNorm kernels KD, KG and KH
are CUDA C++ (csrc/masked_bn.cu).

Imported only by the launching functions in lidog_tpu_torch.ops.norm when
they run on a card: this module needs the `triton` package.  The design
notes are on the wrappers (ops/norm.py: instance_norm_fwd,
instance_norm_bwd).
"""

import triton
import triton.language as tl


@triton.jit
def _slab_segments(mask_ptr, bidx_ptr, bidx_stride, n, lo_row, S: tl.constexpr,
                   ROWS: tl.constexpr, BLOCK_R: tl.constexpr):
    """The least and the greatest segment of the real rows in the slab
    [lo_row, lo_row + ROWS), within [0, S); (S, -1) when it has none.
    A row whose batch index lies outside [0, S) falls in no segment."""
    lo = lo_row * 0 + S
    hi = lo_row * 0 - 1
    for r0 in range(0, ROWS, BLOCK_R):
        rows = lo_row + r0 + tl.arange(0, BLOCK_R)
        live = (rows < n) & (tl.load(mask_ptr + rows, mask=rows < n,
                                     other=0) != 0)
        seg = tl.load(bidx_ptr + rows.to(tl.int64) * bidx_stride, mask=live,
                      other=0)
        lo = tl.minimum(lo, tl.min(tl.where(live, seg, S), axis=0))
        hi = tl.maximum(hi, tl.max(tl.where(live, seg, -1), axis=0))
    return tl.maximum(lo, 0), tl.minimum(hi, S - 1)


@triton.jit
def in_stats_kernel(x_ptr, mask_ptr, bidx_ptr, bidx_stride, psum_ptr, psq_ptr,
                    pcnt_ptr, n, c, S: tl.constexpr, ROWS: tl.constexpr,
                    BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
    """KK pass 1: program p's sums of f, f * f and the row count per
    segment over its ROWS rows, into partials [P, S, C] (zero-filled:
    segments without a real row in the slab, the padding one among them,
    stay 0)."""
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK_C)
    cm = cols < c
    lo, hi = _slab_segments(mask_ptr, bidx_ptr, bidx_stride, n, pid * ROWS,
                            S, ROWS, BLOCK_R)
    for s in range(lo, hi + 1):
        acc = tl.zeros([BLOCK_C], tl.float32)
        acc_sq = tl.zeros([BLOCK_C], tl.float32)
        cnt = tl.zeros([BLOCK_R], tl.float32)
        for r0 in range(0, ROWS, BLOCK_R):
            rows = pid * ROWS + r0 + tl.arange(0, BLOCK_R)
            rm = rows < n
            keep = tl.load(mask_ptr + rows, mask=rm, other=0) != 0
            seg = tl.load(bidx_ptr + rows.to(tl.int64) * bidx_stride,
                          mask=rm & keep, other=-1)
            sel = rm & keep & (seg == s)
            offs = rows[:, None].to(tl.int64) * c + cols[None, :]
            f = tl.load(x_ptr + offs, mask=sel[:, None] & cm[None, :],
                        other=0.0).to(tl.float32)
            acc += tl.sum(f, axis=0)
            acc_sq += tl.sum(f * f, axis=0)
            cnt += sel.to(tl.float32)
        out = (pid * S + s) * c + cols
        tl.store(psum_ptr + out, acc, mask=cm)
        tl.store(psq_ptr + out, acc_sq, mask=cm)
        tl.store(pcnt_ptr + pid * S + s, tl.sum(cnt, axis=0))


@triton.jit
def in_finalize_kernel(psum_ptr, psq_ptr, pcnt_ptr, p, mean_ptr, varraw_ptr,
                       rstd_ptr, count_ptr, c, eps, S: tl.constexpr,
                       BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
    """KK pass 2, per (segment, channel block): the partials summed in
    program order, JAX's clamps (count >= 1, variance >= 0), and the
    segment's mean, unclamped variance and rsqrt(var + eps)."""
    s = tl.program_id(0)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    cm = cols < c
    acc = tl.zeros([BLOCK_C], tl.float32)
    acc_sq = tl.zeros([BLOCK_C], tl.float32)
    cnt = tl.zeros([BLOCK_P], tl.float32)
    for p0 in range(0, p, BLOCK_P):
        pr = p0 + tl.arange(0, BLOCK_P)
        pm = pr < p
        offs = (pr[:, None] * S + s) * c + cols[None, :]
        m2 = pm[:, None] & cm[None, :]
        acc += tl.sum(tl.load(psum_ptr + offs, mask=m2, other=0.0), axis=0)
        acc_sq += tl.sum(tl.load(psq_ptr + offs, mask=m2, other=0.0), axis=0)
        cnt += tl.load(pcnt_ptr + pr * S + s, mask=pm, other=0.0)
    count = tl.maximum(tl.sum(cnt, axis=0), 1.0)
    mean = acc / count
    var_raw = acc_sq / count - mean * mean
    out = s * c + cols
    tl.store(mean_ptr + out, mean, mask=cm)
    tl.store(varraw_ptr + out, var_raw, mask=cm)
    tl.store(rstd_ptr + out, 1.0 / tl.sqrt(tl.maximum(var_raw, 0.0) + eps),
             mask=cm)
    if tl.program_id(1) == 0:
        tl.store(count_ptr + s, count)


@triton.jit
def in_apply_kernel(x_ptr, mask_ptr, bidx_ptr, bidx_stride, mean_ptr,
                    rstd_ptr, out_ptr, n, c, S: tl.constexpr,
                    BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
    """KK pass 3: y = (f - mean[seg]) * rstd[seg] * m, rounded to x's
    dtype; masked rows read the padding segment and give 0."""
    rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.arange(0, BLOCK_C)
    rm = rows < n
    cm = cols < c
    m2 = rm[:, None] & cm[None, :]
    keep = tl.load(mask_ptr + rows, mask=rm, other=0) != 0
    seg = tl.load(bidx_ptr + rows.to(tl.int64) * bidx_stride, mask=rm & keep,
                  other=0)
    seg = tl.minimum(tl.maximum(tl.where(keep, seg, S - 1), 0), S - 1)
    offs = rows[:, None].to(tl.int64) * c + cols[None, :]
    stat = seg[:, None] * c + cols[None, :]
    kf = keep.to(tl.float32)[:, None]
    f = tl.load(x_ptr + offs, mask=m2, other=0.0).to(tl.float32) * kf
    mean = tl.load(mean_ptr + stat, mask=m2, other=0.0)
    rstd = tl.load(rstd_ptr + stat, mask=m2, other=0.0)
    y = (f - mean) * rstd * kf
    tl.store(out_ptr + offs, y.to(out_ptr.dtype.element_ty), mask=m2)


@triton.jit
def in_bwd_reduce_kernel(dy_ptr, x_ptr, mask_ptr, bidx_ptr, bidx_stride,
                         mean_ptr, ps1_ptr, ps2_ptr, n, c, S: tl.constexpr,
                         ROWS: tl.constexpr, BLOCK_R: tl.constexpr,
                         BLOCK_C: tl.constexpr):
    """KL pass 1: per program and segment, sum g and g * (f - mean[seg])
    over the slab's real rows (g = dy in f32), into partials [P, S, C]
    (zero-filled)."""
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK_C)
    cm = cols < c
    lo, hi = _slab_segments(mask_ptr, bidx_ptr, bidx_stride, n, pid * ROWS,
                            S, ROWS, BLOCK_R)
    for s in range(lo, hi + 1):
        mean = tl.load(mean_ptr + s * c + cols, mask=cm, other=0.0)
        s1 = tl.zeros([BLOCK_C], tl.float32)
        s2 = tl.zeros([BLOCK_C], tl.float32)
        for r0 in range(0, ROWS, BLOCK_R):
            rows = pid * ROWS + r0 + tl.arange(0, BLOCK_R)
            rm = rows < n
            keep = tl.load(mask_ptr + rows, mask=rm, other=0) != 0
            seg = tl.load(bidx_ptr + rows.to(tl.int64) * bidx_stride,
                          mask=rm & keep, other=-1)
            sel = rm & keep & (seg == s)
            offs = rows[:, None].to(tl.int64) * c + cols[None, :]
            m2 = sel[:, None] & cm[None, :]
            g = tl.load(dy_ptr + offs, mask=m2, other=0.0).to(tl.float32)
            f = tl.load(x_ptr + offs, mask=m2, other=0.0).to(tl.float32)
            s1 += tl.sum(g, axis=0)
            s2 += tl.sum(tl.where(m2, g * (f - mean[None, :]), 0.0), axis=0)
        out = (pid * S + s) * c + cols
        tl.store(ps1_ptr + out, s1, mask=cm)
        tl.store(ps2_ptr + out, s2, mask=cm)


@triton.jit
def in_bwd_finalize_kernel(ps1_ptr, ps2_ptr, p, mean_ptr, varraw_ptr,
                           rstd_ptr, count_ptr, a_ptr, b_ptr, c, eps,
                           S: tl.constexpr, BLOCK_P: tl.constexpr,
                           BLOCK_C: tl.constexpr):
    """KL pass 2, per (segment, channel block): the coefficients of dx's
    moment term, dx = m * (g * rstd + a + b * f)."""
    s = tl.program_id(0)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    cm = cols < c
    s1 = tl.zeros([BLOCK_C], tl.float32)
    s2 = tl.zeros([BLOCK_C], tl.float32)
    for p0 in range(0, p, BLOCK_P):
        pr = p0 + tl.arange(0, BLOCK_P)
        offs = (pr[:, None] * S + s) * c + cols[None, :]
        m2 = (pr < p)[:, None] & cm[None, :]
        s1 += tl.sum(tl.load(ps1_ptr + offs, mask=m2, other=0.0), axis=0)
        s2 += tl.sum(tl.load(ps2_ptr + offs, mask=m2, other=0.0), axis=0)
    st = s * c + cols
    count = tl.load(count_ptr + s)
    mean = tl.load(mean_ptr + st, mask=cm, other=0.0)
    var_raw = tl.load(varraw_ptr + st, mask=cm, other=0.0)
    rstd = tl.load(rstd_ptr + st, mask=cm, other=0.0)
    ve = tl.maximum(var_raw, 0.0) + eps
    dvar = s2 * (-0.5 * rstd / ve)
    # max(var_raw, 0): JAX's balanced gradient, 1/2 each side at a tie
    dvar = dvar * tl.where(var_raw > 0.0, 1.0,
                           tl.where(var_raw == 0.0, 0.5, 0.0))
    dmean = -(s1 * rstd) - 2.0 * mean * dvar
    tl.store(a_ptr + st, dmean / count, mask=cm)
    tl.store(b_ptr + st, 2.0 * dvar / count, mask=cm)


@triton.jit
def in_bwd_apply_kernel(dy_ptr, x_ptr, mask_ptr, bidx_ptr, bidx_stride,
                        rstd_ptr, a_ptr, b_ptr, dx_ptr, n, c, S: tl.constexpr,
                        BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
    """KL pass 3: dx = m * (g * rstd[seg] + a[seg] + b[seg] * f), summed
    in f32 and rounded once to x's dtype (x's one f32 cast)."""
    rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.arange(0, BLOCK_C)
    rm = rows < n
    cm = cols < c
    m2 = rm[:, None] & cm[None, :]
    keep = tl.load(mask_ptr + rows, mask=rm, other=0) != 0
    seg = tl.load(bidx_ptr + rows.to(tl.int64) * bidx_stride, mask=rm & keep,
                  other=0)
    seg = tl.minimum(tl.maximum(tl.where(keep, seg, S - 1), 0), S - 1)
    offs = rows[:, None].to(tl.int64) * c + cols[None, :]
    stat = seg[:, None] * c + cols[None, :]
    kf = keep.to(tl.float32)[:, None]
    g = tl.load(dy_ptr + offs, mask=m2, other=0.0).to(tl.float32) * kf
    f = tl.load(x_ptr + offs, mask=m2, other=0.0).to(tl.float32) * kf
    rstd = tl.load(rstd_ptr + stat, mask=m2, other=0.0)
    a = tl.load(a_ptr + stat, mask=m2, other=0.0)
    b = tl.load(b_ptr + stat, mask=m2, other=0.0)
    dx = (g * rstd + a + b * f) * kf
    tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=m2)

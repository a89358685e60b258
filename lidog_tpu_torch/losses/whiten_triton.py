"""The whitening-loss kernels, in Triton: KM (the per-row off-diagonal
sums and the IW / IRW scalar) and KN (its backward).

Imported only by the launching functions in lidog_tpu_torch.losses.losses
when they run on a card: this module needs the `triton` package.  The
design notes are on the wrappers (losses/losses.py: whitening_fwd,
whitening_bwd).
"""

import triton
import triton.language as tl


@triton.jit
def whiten_rows_kernel(x_ptr, mask_ptr, s_ptr, ps_ptr, pcnt_ptr, n, c,
                       ROWS: tl.constexpr, BLOCK_R: tl.constexpr,
                       BLOCK_C: tl.constexpr):
    """KM pass 1: per row s = ((sum |f|)^2 - sum f^2) / 2 (0 on masked
    rows) into s [N]; per program the sum of s and the row count."""
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK_C)
    cm = cols < c
    acc = tl.zeros([BLOCK_R], tl.float32)
    cnt = tl.zeros([BLOCK_R], tl.float32)
    for r0 in range(0, ROWS, BLOCK_R):
        rows = pid * ROWS + r0 + tl.arange(0, BLOCK_R)
        rm = rows < n
        keep = tl.load(mask_ptr + rows, mask=rm, other=0).to(tl.float32)
        offs = rows[:, None].to(tl.int64) * c + cols[None, :]
        f = tl.load(x_ptr + offs, mask=rm[:, None] & cm[None, :],
                    other=0.0).to(tl.float32) * keep[:, None]
        a = tl.sum(tl.abs(f), axis=1)
        b = tl.sum(f * f, axis=1)
        s = 0.5 * (a * a - b)
        tl.store(s_ptr + rows, s, mask=rm)
        acc += s
        cnt += keep
    tl.store(ps_ptr + pid, tl.sum(acc, axis=0))
    tl.store(pcnt_ptr + pid, tl.sum(cnt, axis=0))


@triton.jit
def whiten_finalize_kernel(s_ptr, ps_ptr, pcnt_ptr, p, n, loss_ptr, nv_ptr,
                           num_off, margin, IRW: tl.constexpr,
                           BLOCK_P: tl.constexpr, BLOCK_R: tl.constexpr):
    """KM pass 2, one program: n = max(rows, 2), then IW = sum s / ((n - 1)
    n), or IRW = sum max((s / (n - 1) - margin) / num_off, 0) / n over
    every row (masked rows have s = 0)."""
    cnt = tl.zeros([BLOCK_P], tl.float32)
    tot = tl.zeros([BLOCK_P], tl.float32)
    for p0 in range(0, p, BLOCK_P):
        pr = p0 + tl.arange(0, BLOCK_P)
        cnt += tl.load(pcnt_ptr + pr, mask=pr < p, other=0.0)
        tot += tl.load(ps_ptr + pr, mask=pr < p, other=0.0)
    nv = tl.maximum(tl.sum(cnt, axis=0), 2.0)
    if IRW:
        acc = tl.zeros([BLOCK_R], tl.float32)
        for r0 in range(0, n, BLOCK_R):
            rows = r0 + tl.arange(0, BLOCK_R)
            s = tl.load(s_ptr + rows, mask=rows < n, other=0.0)
            per = tl.maximum((s / (nv - 1.0) - margin) / num_off, 0.0)
            acc += tl.where(rows < n, per, 0.0)
        loss = tl.sum(acc, axis=0) / nv
    else:
        loss = tl.sum(tot, axis=0) / ((nv - 1.0) * nv)
    tl.store(loss_ptr, loss)
    tl.store(nv_ptr, nv)


@triton.jit
def whiten_bwd_kernel(x_ptr, mask_ptr, s_ptr, nv_ptr, dl_ptr, dx_ptr, n, c,
                      num_off, margin, IRW: tl.constexpr,
                      BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
    """KN: dx = m * w * (sgn(f) * sum |f| - f) per row, with w = dL/ds
    (for IRW gated by JAX's max rule: 1 above 0, 1/2 at 0) and sgn(f) =
    +1 at f >= 0, as JAX's |x|' is."""
    rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.arange(0, BLOCK_C)
    rm = rows < n
    cm = cols < c
    m2 = rm[:, None] & cm[None, :]
    keep = tl.load(mask_ptr + rows, mask=rm, other=0).to(tl.float32)
    offs = rows[:, None].to(tl.int64) * c + cols[None, :]
    f = tl.load(x_ptr + offs, mask=m2, other=0.0).to(tl.float32) \
        * keep[:, None]
    a = tl.sum(tl.abs(f), axis=1)
    nv = tl.load(nv_ptr)
    dl = tl.load(dl_ptr)
    if IRW:
        s = tl.load(s_ptr + rows, mask=rm, other=0.0)
        t = (s / (nv - 1.0) - margin) / num_off
        gate = tl.where(t > 0.0, 1.0, tl.where(t == 0.0, 0.5, 0.0))
        w = dl / nv * gate / num_off / (nv - 1.0)
    else:
        w = tl.zeros([BLOCK_R], tl.float32) + dl / ((nv - 1.0) * nv)
    sgn = tl.where(f >= 0.0, 1.0, -1.0)
    dx = (sgn * a[:, None] - f) * (w * keep)[:, None]
    tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=m2)

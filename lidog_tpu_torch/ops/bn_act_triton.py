"""KD, the fused BatchNorm(eval) + residual + ReLU pass, as a Triton kernel.

Imported only by lidog_tpu_torch.ops.norm.bn_act when it launches on a
card: this module needs the `triton` package.  The design note is on
bn_act (ops/norm.py).
"""

import triton
import triton.language as tl


@triton.jit
def bn_act_kernel(x_ptr, mean_ptr, inv_ptr, bias_ptr, mask_ptr, res_ptr,
                  out_ptr, n, c, HAS_RES: tl.constexpr, RELU: tl.constexpr,
                  BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.arange(0, BLOCK_C)
    rm = rows < n
    cm = cols < c
    m2 = rm[:, None] & cm[None, :]
    offs = rows[:, None].to(tl.int64) * c + cols[None, :]
    x = tl.load(x_ptr + offs, mask=m2, other=0.0).to(tl.float32)
    mean = tl.load(mean_ptr + cols, mask=cm, other=0.0)
    inv = tl.load(inv_ptr + cols, mask=cm, other=0.0)
    bias = tl.load(bias_ptr + cols, mask=cm, other=0.0)
    keep = tl.load(mask_ptr + rows, mask=rm, other=0).to(tl.float32)
    y = (x - mean[None, :]) * inv[None, :] + bias[None, :]
    # round to the compute dtype first (JAX's astype), then mask; the
    # residual add rounds once more at the store, as a bf16 add does
    y = y.to(out_ptr.dtype.element_ty).to(tl.float32) * keep[:, None]
    if HAS_RES:
        y = y + tl.load(res_ptr + offs, mask=m2, other=0.0).to(tl.float32)
    if RELU:
        y = tl.maximum(y, 0.0)
    tl.store(out_ptr + offs, y.to(out_ptr.dtype.element_ty), mask=m2)

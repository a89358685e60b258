"""What the kernel wrappers of ops/ share: the dtype codes of the C
interfaces, the checks a wrapper makes before it launches, the split of
the two-pass weight-gradient kernels into chunks, and the row gather and
mask of the plain versions.
"""

from __future__ import annotations

import torch

# the dtype code every C entry point takes as its last int
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gather_rows(u, idx):
    """u [n, C]; idx [m] (-1 or out of range = miss -> zero row)."""
    hit = (idx >= 0) & (idx < u.shape[0])
    return u[idx.clamp(0, u.shape[0] - 1).long()] * hit[:, None].to(u.dtype)


def masked(out, mask):
    return out if mask is None else out * mask[:, None].to(out.dtype)


def check(name, x, w):
    """x [N, Cin] and w [..., Cout] for a tensor-core kernel: CUDA, one of
    DTYPES, widths in multiples of 32, contiguous and 16-byte aligned."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"{name}: x and w must share float32 or bfloat16, "
                         f"got {x.dtype} and {w.dtype}")
    cin, cout = x.shape[1], w.shape[-1]
    if cin % 32 or cout % 32:
        raise ValueError(f"{name}: widths must be multiples of 32, got "
                         f"{cin} -> {cout}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: x and w must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name}: x and w must be 16-byte aligned")


def int_map(name, t, shape, device):
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: map must be contiguous int32 {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} {t.device}")


def flag(name, t, n, device):
    if t is None:
        return
    if t.dtype != torch.bool or tuple(t.shape) != (n,) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: flags must be contiguous bool [{n}] on "
                         f"{device}")


def ptr(t):
    return None if t is None else t.data_ptr()


# pass 1 of the weight-gradient kernels (csrc/wgrad.cuh) aims at about
# eight blocks per SM of an H100 (132 SMs)
WGRAD_BLOCKS = 8 * 132


def wgrad_chunks(rows, k, cin, cout):
    """The split of `rows` into (chunks, rows per chunk), the rows per
    chunk a multiple of 32."""
    bn = 64 if cout % 64 == 0 else 32
    tiles = k * (cin // 32) * (cout // bn)
    steps = -(-rows // 32)
    chunks = max(1, min(steps, -(-WGRAD_BLOCKS // tiles)))
    rpc = -(-steps // chunks) * 32
    return max(1, -(-rows // rpc)), rpc

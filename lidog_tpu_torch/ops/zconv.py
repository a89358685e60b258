"""Column-fused (z-fused) sparse convolution, forward.

Port of lidog_tpu/ops/zconv.py: `zconv3` (:308, k=3 on an augmented level:
9 xy gathers, the 3 z taps as shifts), `zconv_down` (:530, k=2 s=2, 8-tap
gather-GEMM over the coarse rows) and `zconv_up` (:584, transposed: one
parent gather + per-row weight select).

Each op has a plain PyTorch version (`*_plain`) and a hand-written CUDA
kernel (csrc/, see each source's note).  The kernel wrapper (`*_fwd`)
takes the plain version for a tensor on the CPU and launches the kernel
for a CUDA tensor, raising on what the kernel does not take; nothing
falls back.

Maps are global rows that never leave their scan's segment (the plan
guarantees it), so one global gather equals the JAX per-segment gather.

Numerics: the plain versions keep the JAX rounding points, so they match
JAX tightly in f32 and within a bf16 bound in bf16: zconv3 rounds each
per-offset projection u9 to the compute dtype before the f32 sum
(zconv.py:205-213), zconv_up rounds the selected product (:445-447), and
zconv_down rounds once.  The zconv3 kernel sums gather-first in f32 and
skips the per-offset rounding, so on bf16 it differs from the plain
version by about 1e-2 relative.
"""

from __future__ import annotations

import torch

from lidog_tpu_torch.ops import _cuda

LAUNCHES = {"zconv3_fwd": 0, "zconv_down_fwd": 0, "zconv_up_fwd": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _gather_rows(u, idx):
    """u [n, C]; idx [m] (-1 or out of range = miss -> zero row)."""
    hit = (idx >= 0) & (idx < u.shape[0])
    return u[idx.clamp(0, u.shape[0] - 1).long()] * hit[:, None].to(u.dtype)


def _shift_next(x, zup):
    """x[j+1] where row j+1 is the z+1 cell of the same column, else 0."""
    nxt = torch.cat([x[1:], torch.zeros_like(x[:1])], dim=0)
    return nxt * zup[:, None].to(x.dtype)


def _shift_prev(x, zdn):
    prv = torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)
    return prv * zdn[:, None].to(x.dtype)


def _masked(out, mask):
    return out * mask[:, None].to(out.dtype)


# ---------------------------------------------------------------------------
# Plain versions (any device)
# ---------------------------------------------------------------------------


def zconv3_plain(x, nbr9, zup, zdn, wf, out_mask):
    """x [Na, Cin]; nbr9 [9, Na]; wf [9, 3*Cin, Cout] -> [Na, Cout]."""
    xc = torch.cat([_shift_prev(x, zdn), x, _shift_next(x, zup)], dim=1)
    u9 = torch.einsum("nc,dck->dnk", xc.float(), wf.float()).to(x.dtype)
    acc = u9[4].float()
    for d in range(9):
        if d != 4:
            acc = acc + _gather_rows(u9[d], nbr9[d]).float()
    return _masked(acc.to(x.dtype), out_mask)


def zconv_down_plain(x, nbr8, w8, out_mask):
    """x fine [Naf, Cin]; nbr8 [8, Nac] -> coarse [Nac, Cout]."""
    g8 = torch.stack([_gather_rows(x, nbr8[k]) for k in range(8)])
    out = torch.einsum("dnc,dck->nk", g8.float(), w8.float())
    return _masked(out.to(x.dtype), out_mask)


def zconv_up_plain(x, parent, off, w8, out_mask):
    """x coarse [Nac, Cin]; parent/off [Naf] -> fine [Naf, Cout]."""
    g = _gather_rows(x, parent).float()
    out = torch.zeros(parent.shape[0], w8.shape[2], dtype=x.dtype,
                      device=x.device)
    for o in range(w8.shape[0]):
        rows = (off == o).nonzero()[:, 0]
        out[rows] = (g[rows] @ w8[o].float()).to(x.dtype)
    return _masked(out, out_mask)


# ---------------------------------------------------------------------------
# Kernel wrappers (plain version on the CPU, the kernel on a card)
# ---------------------------------------------------------------------------


def _check(name, x, w, *, rows=None):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
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


def _int_map(name, t, shape, device):
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: map must be contiguous int32 {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} {t.device}")


def _flag(name, t, n, device):
    if t.dtype != torch.bool or tuple(t.shape) != (n,) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: flags must be contiguous bool [{n}] on "
                         f"{device}")


def zconv3_fwd(x, nbr9, zup, zdn, wf, out_mask):
    """KA (csrc/zconv3_fwd.cu).  x [Na, Cin]; wf [9, 3*Cin, Cout]."""
    if x.device.type == "cpu":
        return zconv3_plain(x, nbr9, zup, zdn, wf, out_mask)
    name = "zconv3_fwd"
    _check(name, x, wf)
    na, cin = x.shape
    if tuple(wf.shape[:2]) != (9, 3 * cin):
        raise ValueError(f"{name}: wf must be [9, {3 * cin}, Cout], got "
                         f"{tuple(wf.shape)}")
    _int_map(name, nbr9, (9, na), x.device)
    for f in (zup, zdn, out_mask):
        _flag(name, f, na, x.device)
    out = torch.empty(na, wf.shape[2], dtype=x.dtype, device=x.device)
    if na:
        _cuda.call(name, x.data_ptr(), nbr9.data_ptr(), zup.data_ptr(),
                   zdn.data_ptr(), wf.data_ptr(), out_mask.data_ptr(),
                   out.data_ptr(), na, cin, wf.shape[2], _DTYPES[x.dtype])
        LAUNCHES[name] += 1
    return out


def zconv_down_fwd(x, nbr8, w8, out_mask):
    """KB (csrc/zconv_down_fwd.cu).  x fine [Naf, Cin]; w8 [8, Cin, Cout]."""
    if x.device.type == "cpu":
        return zconv_down_plain(x, nbr8, w8, out_mask)
    name = "zconv_down_fwd"
    _check(name, x, w8)
    n_in, cin = x.shape
    n_out = nbr8.shape[1]
    if tuple(w8.shape[:2]) != (8, cin):
        raise ValueError(f"{name}: w8 must be [8, {cin}, Cout]")
    _int_map(name, nbr8, (8, n_out), x.device)
    _flag(name, out_mask, n_out, x.device)
    out = torch.empty(n_out, w8.shape[2], dtype=x.dtype, device=x.device)
    if n_out:
        _cuda.call(name, x.data_ptr(), nbr8.data_ptr(), w8.data_ptr(),
                   out_mask.data_ptr(), out.data_ptr(), n_in, n_out, cin,
                   w8.shape[2], _DTYPES[x.dtype])
        LAUNCHES[name] += 1
    return out


def zconv_up_fwd(x, parent, off, w8, out_mask):
    """KC (csrc/zconv_up_fwd.cu).  x coarse [Nac, Cin]; parent/off [Naf]."""
    if x.device.type == "cpu":
        return zconv_up_plain(x, parent, off, w8, out_mask)
    name = "zconv_up_fwd"
    _check(name, x, w8)
    n_in, cin = x.shape
    n_out = parent.shape[0]
    if tuple(w8.shape[:2]) != (8, cin):
        raise ValueError(f"{name}: w8 must be [8, {cin}, Cout]")
    _int_map(name, parent, (n_out,), x.device)
    _int_map(name, off, (n_out,), x.device)
    _flag(name, out_mask, n_out, x.device)
    out = torch.empty(n_out, w8.shape[2], dtype=x.dtype, device=x.device)
    if n_out:
        _cuda.call(name, x.data_ptr(), parent.data_ptr(), off.data_ptr(),
                   w8.data_ptr(), out_mask.data_ptr(), out.data_ptr(), n_in,
                   n_out, cin, w8.shape[2], _DTYPES[x.dtype])
        LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# Public ops (JAX signatures)
# ---------------------------------------------------------------------------


def zconv3(x, nbr9, zup, zdn, weights, *, out_mask):
    """k=3 column-fused conv.  weights [27, Cin, Cout] in lexicographic
    (dx, dy, dz) order, dz fastest; out_mask is the level's real mask."""
    k, cin, cout = weights.shape
    assert k == 27, "zconv3 is the k=3 hypercube primitive"
    wf = weights.reshape(9, 3 * cin, cout).contiguous()
    return zconv3_fwd(x, nbr9, zup, zdn, wf, out_mask)


def zconv_down(x, nbr8, weights, *, out_mask):
    """k=2 s=2 strided conv.  weights [8, Cin, Cout], {0,s}^3 offsets."""
    return zconv_down_fwd(x, nbr8, weights.contiguous(), out_mask)


def zconv_up(x, parent, off, weights, *, out_mask):
    """Transposed k=2 s=2 conv.  weights [8, Cin, Cout]."""
    return zconv_up_fwd(x, parent, off, weights.contiguous(), out_mask)

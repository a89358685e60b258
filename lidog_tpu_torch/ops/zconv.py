"""Column-fused (z-fused) sparse convolution, forward and backward.

Port of lidog_tpu/ops/zconv.py: `zconv3` (:308, k=3 on an augmented level:
9 xy gathers, the 3 z taps as shifts), `zconv_down` (:530, k=2 s=2, 8-tap
gather-GEMM over the coarse rows), `zconv_up` (:584, transposed: one
parent gather + per-row weight select) and `zconv_full` (:410, the
K-offset gather-GEMM of the in_channels > 1 stem over a symmetric
source-row map), each a `torch.autograd.Function` with the custom
backward of the JAX version (`_zconv3_bwd:231`, `_zdown_bwd:505`,
`_zup_bwd:561`, `_zfull_bwd:373`).

Each kernel has a plain PyTorch version (`*_plain`) and a hand-written CUDA
kernel (csrc/, see each source's note):

  KA zconv3_fwd      KE zconv3_bwd_dx     KF zconv3_wgrad
  KB zconv_down_fwd  (also zconv_up's dx, with transposed weights)
  KC zconv_up_fwd    (also zconv_down's dx, with transposed weights)
  KF zconv_down_wgrad, zconv_up_wgrad
  KO zconv_full_fwd  (also zconv_full's dx, with W reversed and transposed)
  KP zconv_full_wgrad

The kernel wrapper (named after the C function) takes the plain version
for a tensor on the CPU and launches the kernel for a CUDA tensor, raising
on what the kernel does not take; nothing falls back.

Maps are global rows that never leave their scan's segment (the plan
guarantees it), so one global gather equals the JAX per-segment gather.

Numerics: the plain versions keep the JAX rounding points, so they match
JAX tightly in f32 and within a bf16 bound in bf16: zconv3 rounds each
per-offset projection u9 to the compute dtype before the f32 sum
(zconv.py:205-213), zconv_up rounds the selected product (:445-447), and
zconv_down rounds once; in the backward the gathered cotangent rows are in
the compute dtype, zconv3's dxc is rounded before the z fold `_zcat_t`
(:274), and dW is summed in f32 and rounded once to the weight's dtype.
The zconv3 kernels sum gather-first in f32 and skip the intermediate
roundings (u9, dxc), so on bf16 they differ from the plain versions by
about 1e-2 relative.  zconv_full rounds once after its f32 sum (:362-365,
:391-396), as its kernels do.
"""

from __future__ import annotations

import torch

from lidog_tpu_torch.ops import _cuda

LAUNCHES = {"zconv3_fwd": 0, "zconv_down_fwd": 0, "zconv_up_fwd": 0,
            "zconv3_bwd_dx": 0, "zconv3_wgrad": 0, "zconv_down_wgrad": 0,
            "zconv_up_wgrad": 0, "zconv_full_fwd": 0, "zconv_full_wgrad": 0}
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
    return out if mask is None else out * mask[:, None].to(out.dtype)


def _zcat(x, zup, zdn):
    """[Na, 3*Cin] = [x_prev | x | x_next] (z taps -1, 0, +1)."""
    return torch.cat([_shift_prev(x, zdn), x, _shift_next(x, zup)], dim=1)


def _zcat_t(d3, zup, zdn):
    """Transpose of _zcat (lidog_tpu/ops/zconv.py:116): fold a [Na, 3*Cin]
    cotangent back onto x rows, in its dtype."""
    cin = d3.shape[1] // 3
    dp = d3[:, :cin] * zdn[:, None].to(d3.dtype)
    dn = d3[:, 2 * cin:] * zup[:, None].to(d3.dtype)
    zero = torch.zeros_like(dp[:1])
    return (d3[:, cin:2 * cin] + torch.cat([dp[1:], zero], dim=0)
            + torch.cat([zero, dn[:-1]], dim=0))


# ---------------------------------------------------------------------------
# Plain versions (any device)
# ---------------------------------------------------------------------------


def zconv3_plain(x, nbr9, zup, zdn, wf, out_mask):
    """x [Na, Cin]; nbr9 [9, Na]; wf [9, 3*Cin, Cout] -> [Na, Cout]."""
    xc = _zcat(x, zup, zdn)
    u9 = torch.einsum("nc,dck->dnk", xc.float(), wf.float()).to(x.dtype)
    acc = u9[4].float()
    for d in range(9):
        if d != 4:
            acc = acc + _gather_rows(u9[d], nbr9[d]).float()
    return _masked(acc.to(x.dtype), out_mask)


def zconv_down_plain(x, nbr8, w8, out_mask, src_mask=None):
    """x fine [Naf, Cin]; nbr8 [8, Nac] -> coarse [Nac, Cout].  A row s of
    x with src_mask[s] false reads as zero; out_mask None keeps every
    row."""
    x = _masked(x, src_mask)
    g8 = torch.stack([_gather_rows(x, nbr8[k]) for k in range(8)])
    out = torch.einsum("dnc,dck->nk", g8.float(), w8.float())
    return _masked(out.to(x.dtype), out_mask)


def zconv_up_plain(x, parent, off, w8, out_mask, src_mask=None):
    """x coarse [Nac, Cin]; parent/off [Naf] -> fine [Naf, Cout] (src_mask
    and out_mask as in zconv_down_plain)."""
    x = _masked(x, src_mask)
    g = _gather_rows(x, parent).float()
    out = torch.zeros(parent.shape[0], w8.shape[2], dtype=x.dtype,
                      device=x.device)
    for o in range(w8.shape[0]):
        rows = (off == o).nonzero()[:, 0]
        out[rows] = (g[rows] @ w8[o].float()).to(x.dtype)
    return _masked(out, out_mask)


def zconv3_bwd_dx_plain(dout, nbr9, zup, zdn, wf, dout_mask):
    """dx of zconv3 (lidog_tpu/ops/zconv.py:243-274): dxc = sum_e
    gather(dout, nbr9[e]) @ wf[8-e]^T summed in f32, rounded, then folded
    onto x rows by _zcat_t.  dout [Na, Cout] is read through the forward's
    output mask -> dx [Na, Cin]."""
    d = _masked(dout, dout_mask)
    wt = wf.flip(0).transpose(1, 2).float()  # [9, Cout, 3*Cin]
    acc = d.float() @ wt[4]
    for e in range(9):
        if e != 4:
            acc = acc + _gather_rows(d, nbr9[e]).float() @ wt[e]
    return _zcat_t(acc.to(dout.dtype), zup, zdn)


def zconv3_wgrad_plain(x, dout, nbr9, zup, zdn, dout_mask):
    """dW of zconv3 (lidog_tpu/ops/zconv.py:268-295): dW[8-e] =
    zcat(x)^T @ gather(dout, nbr9[e]) in f32 -> [9, 3*Cin, Cout] (the
    [27, Cin, Cout] layout), rounded to x's dtype."""
    d = _masked(dout, dout_mask)
    xc = _zcat(x, zup, zdn).float()
    dw = torch.stack([
        xc.T @ (d if o == 4 else _gather_rows(d, nbr9[8 - o])).float()
        for o in range(9)])
    return dw.to(x.dtype)


def _onehot_dw(a, g, off):
    """dW[o] = a^T @ (g masked to off == o) in f32, o < 8 (lidog_tpu/ops/
    zconv.py:455)."""
    a, g = a.float(), g.float()
    return torch.stack([(a * (off == o)[:, None]).T @ g for o in range(8)])


def zconv_down_wgrad_plain(x, dout, parent, off, dout_mask):
    """dW of zconv_down (lidog_tpu/ops/zconv.py:512-517): x fine [Naf,
    Cin], dout coarse [Nac, Cout] -> [8, Cin, Cout] in x's dtype."""
    g = _gather_rows(_masked(dout, dout_mask), parent)
    return _onehot_dw(x, g, off).to(x.dtype)


def zconv_up_wgrad_plain(x, dout, parent, off, dout_mask):
    """dW of zconv_up (lidog_tpu/ops/zconv.py:565-571): x coarse [Nac,
    Cin], dout fine [Naf, Cout] -> [8, Cin, Cout] in x's dtype."""
    g = _gather_rows(x, parent)
    return _onehot_dw(g, _masked(dout, dout_mask), off).to(x.dtype)


def zconv_full_plain(x, nbr, w, out_mask, src_mask=None):
    """out[i] = sum_o x[nbr[o, i]] @ w[o] (lidog_tpu/ops/zconv.py:342-365):
    x [Na, Cin]; nbr [K, Na]; w [K, Cin, Cout]; summed in f32, rounded
    once.  A row s of x with src_mask[s] false reads as zero (the dx use,
    on the forward's output mask); out_mask None keeps every row."""
    x = _masked(x, src_mask)
    acc = x.new_zeros(nbr.shape[1], w.shape[2], dtype=torch.float32)
    for o in range(w.shape[0]):
        acc += _gather_rows(x, nbr[o]).float() @ w[o].float()
    return _masked(acc.to(x.dtype), out_mask)


def zconv_full_wgrad_plain(x, dout, nbr, dout_mask):
    """dW of zconv_full (lidog_tpu/ops/zconv.py:373-403): dW[o] = sum_i
    x[i]^T dout[nbr[K-1-o, i]] in f32 (the transpose-reuse form on the
    symmetric map) -> [K, Cin, Cout], rounded to x's dtype."""
    d = _masked(dout, dout_mask)
    k = nbr.shape[0]
    xf = x.float()
    return torch.stack([xf.T @ _gather_rows(d, nbr[k - 1 - o]).float()
                        for o in range(k)]).to(x.dtype)


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
    if t is None:
        return
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


def _ptr(t):
    return None if t is None else t.data_ptr()


def zconv_down_fwd(x, nbr8, w8, out_mask, src_mask=None):
    """KB (csrc/zconv_down_fwd.cu).  x fine [Naf, Cin]; w8 [8, Cin, Cout].
    Also zconv_up's dx: x the fine cotangent, w8 transposed, src_mask the
    fine output mask, out_mask None."""
    if x.device.type == "cpu":
        return zconv_down_plain(x, nbr8, w8, out_mask, src_mask)
    name = "zconv_down_fwd"
    _check(name, x, w8)
    n_in, cin = x.shape
    n_out = nbr8.shape[1]
    if tuple(w8.shape[:2]) != (8, cin):
        raise ValueError(f"{name}: w8 must be [8, {cin}, Cout]")
    _int_map(name, nbr8, (8, n_out), x.device)
    _flag(name, out_mask, n_out, x.device)
    _flag(name, src_mask, n_in, x.device)
    out = torch.empty(n_out, w8.shape[2], dtype=x.dtype, device=x.device)
    if n_out:
        _cuda.call(name, x.data_ptr(), nbr8.data_ptr(), w8.data_ptr(),
                   _ptr(out_mask), _ptr(src_mask), out.data_ptr(), n_in,
                   n_out, cin, w8.shape[2], _DTYPES[x.dtype])
        LAUNCHES[name] += 1
    return out


def zconv_up_fwd(x, parent, off, w8, out_mask, src_mask=None):
    """KC (csrc/zconv_up_fwd.cu).  x coarse [Nac, Cin]; parent/off [Naf].
    Also zconv_down's dx: x the coarse cotangent, w8 transposed, src_mask
    the coarse output mask, out_mask None."""
    if x.device.type == "cpu":
        return zconv_up_plain(x, parent, off, w8, out_mask, src_mask)
    name = "zconv_up_fwd"
    _check(name, x, w8)
    n_in, cin = x.shape
    n_out = parent.shape[0]
    if tuple(w8.shape[:2]) != (8, cin):
        raise ValueError(f"{name}: w8 must be [8, {cin}, Cout]")
    _int_map(name, parent, (n_out,), x.device)
    _int_map(name, off, (n_out,), x.device)
    _flag(name, out_mask, n_out, x.device)
    _flag(name, src_mask, n_in, x.device)
    out = torch.empty(n_out, w8.shape[2], dtype=x.dtype, device=x.device)
    if n_out:
        _cuda.call(name, x.data_ptr(), parent.data_ptr(), off.data_ptr(),
                   w8.data_ptr(), _ptr(out_mask), _ptr(src_mask),
                   out.data_ptr(), n_in, n_out, cin, w8.shape[2],
                   _DTYPES[x.dtype])
        LAUNCHES[name] += 1
    return out


def zconv3_bwd_dx(dout, nbr9, zup, zdn, wf, dout_mask):
    """KE (csrc/zconv3_bwd_dx.cu).  dout [Na, Cout]; wf [9, 3*Cin, Cout]
    -> dx [Na, Cin]."""
    if dout.device.type == "cpu":
        return zconv3_bwd_dx_plain(dout, nbr9, zup, zdn, wf, dout_mask)
    name = "zconv3_bwd_dx"
    na, cout = dout.shape
    cin = wf.shape[1] // 3
    if tuple(wf.shape) != (9, 3 * cin, cout):
        raise ValueError(f"{name}: wf must be [9, 3*Cin, {cout}], got "
                         f"{tuple(wf.shape)}")
    # wt[e][t] = wf[8-e][t]^T: [9, 3, Cout, Cin], the kernel's weight layout
    wt = wf.reshape(9, 3, cin, cout).flip(0).transpose(2, 3).contiguous()
    _check(name, dout, wt)
    _int_map(name, nbr9, (9, na), dout.device)
    for f in (zup, zdn, dout_mask):
        _flag(name, f, na, dout.device)
    dx = torch.empty(na, cin, dtype=dout.dtype, device=dout.device)
    if na:
        _cuda.call(name, dout.data_ptr(), nbr9.data_ptr(), zup.data_ptr(),
                   zdn.data_ptr(), wt.data_ptr(), _ptr(dout_mask),
                   dx.data_ptr(), na, cout, cin, _DTYPES[dout.dtype])
        LAUNCHES[name] += 1
    return dx


# pass 1 of KF aims at about eight blocks per SM of an H100 (132 SMs)
_WGRAD_BLOCKS = 8 * 132


def _wgrad_chunks(rows, k, cin, cout):
    """KF's split of `rows` into (chunks, rows per chunk), the rows per
    chunk a multiple of 32."""
    bn = 64 if cout % 64 == 0 else 32
    tiles = k * (cin // 32) * (cout // bn)
    steps = -(-rows // 32)
    chunks = max(1, min(steps, -(-_WGRAD_BLOCKS // tiles)))
    rpc = -(-steps // chunks) * 32
    return max(1, -(-rows // rpc)), rpc


def _wgrad(name, k, x, dout, dout_mask, rows, maps, sizes):
    """Launch one KF entry point; maps are its int32/bool map tensors and
    sizes its leading row counts, in the order of its C signature."""
    _check(name, x, dout)
    cin, cout = x.shape[1], dout.shape[1]
    _flag(name, dout_mask, dout.shape[0], x.device)
    dw = torch.empty(k, cin, cout, dtype=x.dtype, device=x.device)
    if rows == 0:
        return dw.zero_()
    chunks, rpc = _wgrad_chunks(rows, k, cin, cout)
    partial = torch.empty(chunks, k, cin, cout, dtype=torch.float32,
                          device=x.device)
    _cuda.call(name, x.data_ptr(), dout.data_ptr(),
               *[m.data_ptr() for m in maps], _ptr(dout_mask),
               partial.data_ptr(), dw.data_ptr(), *sizes, cin, cout, chunks,
               rpc, _DTYPES[x.dtype])
    LAUNCHES[name] += 1
    return dw


def zconv3_wgrad(x, dout, nbr9, zup, zdn, dout_mask):
    """KF, zconv3 (csrc/zconv_wgrad.cu).  x [Na, Cin], dout [Na, Cout] ->
    dW [27, Cin, Cout] (= [9, 3*Cin, Cout]) in x's dtype."""
    if x.device.type == "cpu":
        return zconv3_wgrad_plain(x, dout, nbr9, zup, zdn, dout_mask)
    name = "zconv3_wgrad"
    na = x.shape[0]
    if dout.shape[0] != na:
        raise ValueError(f"{name}: x and dout must have the same rows")
    _int_map(name, nbr9, (9, na), x.device)
    for f in (zup, zdn):
        _flag(name, f, na, x.device)
    dw = _wgrad(name, 27, x, dout, dout_mask, na, (nbr9, zup, zdn), (na,))
    return dw.reshape(9, 3 * x.shape[1], dout.shape[1])


def zconv_down_wgrad(x, dout, parent, off, dout_mask):
    """KF, zconv_down (csrc/zconv_wgrad.cu).  x fine [Naf, Cin], dout
    coarse [Nac, Cout] -> dW [8, Cin, Cout] in x's dtype."""
    if x.device.type == "cpu":
        return zconv_down_wgrad_plain(x, dout, parent, off, dout_mask)
    name = "zconv_down_wgrad"
    n_fine = x.shape[0]
    for m in (parent, off):
        _int_map(name, m, (n_fine,), x.device)
    return _wgrad(name, 8, x, dout, dout_mask, n_fine, (parent, off),
                  (n_fine, dout.shape[0]))


def zconv_up_wgrad(x, dout, parent, off, dout_mask):
    """KF, zconv_up (csrc/zconv_wgrad.cu).  x coarse [Nac, Cin], dout fine
    [Naf, Cout] -> dW [8, Cin, Cout] in x's dtype."""
    if x.device.type == "cpu":
        return zconv_up_wgrad_plain(x, dout, parent, off, dout_mask)
    name = "zconv_up_wgrad"
    n_fine = dout.shape[0]
    for m in (parent, off):
        _int_map(name, m, (n_fine,), x.device)
    return _wgrad(name, 8, x, dout, dout_mask, n_fine, (parent, off),
                  (x.shape[0], n_fine))


# the widths KO and KP take (csrc/zconv_full.cu)
FULL_MAX_WIDTH = 64


def _check_full(name, x, w):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"{name}: x and w must share float32 or bfloat16, "
                         f"got {x.dtype} and {w.dtype}")
    cin, cout = x.shape[1], w.shape[-1]
    if not (1 <= cin <= FULL_MAX_WIDTH and 1 <= cout <= FULL_MAX_WIDTH):
        raise ValueError(f"{name}: widths must lie in [1, {FULL_MAX_WIDTH}], "
                         f"got {cin} -> {cout}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: x and w must be contiguous")


def zconv_full_fwd(x, nbr, w, out_mask, src_mask=None):
    """KO (csrc/zconv_full.cu).  x [Na, Cin]; nbr [K, Nout]; w [K, Cin,
    Cout] -> [Nout, Cout].  Also zconv_full's dx: x the cotangent, w
    reversed and transposed, src_mask the forward's output mask, out_mask
    None."""
    if x.device.type == "cpu":
        return zconv_full_plain(x, nbr, w, out_mask, src_mask)
    name = "zconv_full_fwd"
    _check_full(name, x, w)
    n_in, cin = x.shape
    k, n_out = nbr.shape
    if tuple(w.shape[:2]) != (k, cin):
        raise ValueError(f"{name}: w must be [{k}, {cin}, Cout], got "
                         f"{tuple(w.shape)}")
    _int_map(name, nbr, (k, n_out), x.device)
    _flag(name, out_mask, n_out, x.device)
    _flag(name, src_mask, n_in, x.device)
    out = torch.empty(n_out, w.shape[2], dtype=x.dtype, device=x.device)
    if n_out:
        _cuda.call(name, x.data_ptr(), nbr.data_ptr(), w.data_ptr(),
                   _ptr(out_mask), _ptr(src_mask), out.data_ptr(), n_in,
                   n_out, k, cin, w.shape[2], _DTYPES[x.dtype])
        LAUNCHES[name] += 1
    return out


# pass 1 of KP: chunks of 4,096 rows per offset block.  The centre offset
# (and dz = +-1) hits nearly every row, so the blocks of the dense offsets
# set the kernel's time: short chunks spread them over many blocks (at the
# training plan's level 0: 120 chunks, a 7.7 MB f32 partial for 4 -> 32)
_FULL_ROWS_PER_CHUNK = 4096


def _full_chunks(rows):
    chunks = min(max(1, -(-rows // _FULL_ROWS_PER_CHUNK)), 1024)
    return chunks, -(-rows // chunks)


def zconv_full_wgrad(x, dout, nbr, dout_mask):
    """KP (csrc/zconv_full.cu).  x [Na, Cin], dout [Na, Cout]; nbr [K, Na]
    -> dW [K, Cin, Cout] in x's dtype."""
    if x.device.type == "cpu":
        return zconv_full_wgrad_plain(x, dout, nbr, dout_mask)
    name = "zconv_full_wgrad"
    _check_full(name, x, dout)
    na, cin = x.shape
    k = nbr.shape[0]
    cout = dout.shape[1]
    if dout.shape[0] != na:
        raise ValueError(f"{name}: x and dout must have the same rows")
    _int_map(name, nbr, (k, na), x.device)
    _flag(name, dout_mask, na, x.device)
    dw = torch.empty(k, cin, cout, dtype=x.dtype, device=x.device)
    if na == 0:
        return dw.zero_()
    chunks, rpc = _full_chunks(na)
    partial = torch.empty(chunks, k, cin, cout, dtype=torch.float32,
                          device=x.device)
    _cuda.call(name, x.data_ptr(), dout.data_ptr(), nbr.data_ptr(),
               _ptr(dout_mask), partial.data_ptr(), dw.data_ptr(), na, k,
               cin, cout, chunks, rpc, _DTYPES[x.dtype])
    LAUNCHES[name] += 1
    return dw


# ---------------------------------------------------------------------------
# Autograd ops: the forward kernel, and the backward kernels of the JAX
# custom VJPs.  Each saves x (not zcat(x) or a gather), as JAX's residuals
# do (lidog_tpu/ops/zconv.py:228,502,558).
# ---------------------------------------------------------------------------


class _ZConv3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, nbr9, zup, zdn, wf, out_mask):
        ctx.save_for_backward(x, nbr9, zup, zdn, wf, out_mask)
        return zconv3_fwd(x, nbr9, zup, zdn, wf, out_mask)

    @staticmethod
    def backward(ctx, dout):
        x, nbr9, zup, zdn, wf, m = ctx.saved_tensors
        dout = dout.to(x.dtype).contiguous()
        dx = dwf = None
        if ctx.needs_input_grad[0]:
            dx = zconv3_bwd_dx(dout, nbr9, zup, zdn, wf, m)
        if ctx.needs_input_grad[4]:
            dwf = zconv3_wgrad(x, dout, nbr9, zup, zdn, m)
        return dx, None, None, None, dwf, None


class _ZConvDown(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, nbr8, parent, off, w8, out_mask):
        ctx.save_for_backward(x, parent, off, w8, out_mask)
        return zconv_down_fwd(x, nbr8, w8, out_mask)

    @staticmethod
    def backward(ctx, dout):
        """dx[j] = dout[parent[j]] @ W[off[j]]^T (KC), dW (KF)."""
        x, parent, off, w8, m = ctx.saved_tensors
        dout = dout.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = zconv_up_fwd(dout, parent, off,
                              w8.transpose(1, 2).contiguous(), None,
                              src_mask=m)
        if ctx.needs_input_grad[4]:
            dw = zconv_down_wgrad(x, dout, parent, off, m)
        return dx, None, None, None, dw, None


class _ZConvUp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, parent, off, nbr8, w8, out_mask):
        ctx.save_for_backward(x, parent, off, nbr8, w8, out_mask)
        return zconv_up_fwd(x, parent, off, w8, out_mask)

    @staticmethod
    def backward(ctx, dout):
        """dx[I] = sum_k dout[nbr8[k, I]] @ W[k]^T (KB), dW (KF)."""
        x, parent, off, nbr8, w8, m = ctx.saved_tensors
        dout = dout.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = zconv_down_fwd(dout, nbr8, w8.transpose(1, 2).contiguous(),
                                None, src_mask=m)
        if ctx.needs_input_grad[4]:
            dw = zconv_up_wgrad(x, dout, parent, off, m)
        return dx, None, None, None, dw, None


class _ZConvFull(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, nbr, w, out_mask):
        ctx.save_for_backward(x, nbr, w, out_mask)
        return zconv_full_fwd(x, nbr, w, out_mask)

    @staticmethod
    def backward(ctx, dout):
        """dx = the same gather-GEMM with W[::-1]^T over the symmetric map
        (KO), dW (KP); dx only where the input needs it (the stem's
        features do not)."""
        x, nbr, w, m = ctx.saved_tensors
        dout = dout.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = zconv_full_fwd(dout, nbr, w.flip(0).transpose(1, 2)
                                .contiguous(), None, src_mask=m)
        if ctx.needs_input_grad[2]:
            dw = zconv_full_wgrad(x, dout, nbr, m)
        return dx, None, dw, None


# ---------------------------------------------------------------------------
# Public ops (JAX signatures)
# ---------------------------------------------------------------------------


def zconv3(x, nbr9, zup, zdn, weights, *, out_mask):
    """k=3 column-fused conv.  weights [27, Cin, Cout] in lexicographic
    (dx, dy, dz) order, dz fastest; out_mask is the level's real mask."""
    k, cin, cout = weights.shape
    assert k == 27, "zconv3 is the k=3 hypercube primitive"
    wf = weights.reshape(9, 3 * cin, cout).contiguous()
    return _ZConv3.apply(x, nbr9, zup, zdn, wf, out_mask)


def zconv_down(x, nbr8, parent, off_id, weights, *, out_mask):
    """k=2 s=2 strided conv: x fine [Naf, Cin]; nbr8 [8, Nac]; parent and
    off_id [Naf] (the backward's partner maps); weights [8, Cin, Cout],
    {0,s}^3 offsets."""
    return _ZConvDown.apply(x, nbr8, parent, off_id, weights.contiguous(),
                            out_mask)


def zconv_up(x, parent, off_id, nbr8, weights, *, out_mask):
    """Transposed k=2 s=2 conv: x coarse [Nac, Cin]; parent and off_id
    [Naf]; nbr8 the down map of this level pair [8, Nac] (the backward's
    partner map); weights [8, Cin, Cout]."""
    return _ZConvUp.apply(x, parent, off_id, nbr8, weights.contiguous(),
                          out_mask)


def zconv_full(x, nbr, weights, *, out_mask):
    """K-offset symmetric sparse conv over a source-row map (the general
    in_channels stem; K = 125 for the k=5 hypercube): x [Na, Cin]; nbr
    [K, Na], the row of (coord + offset_o) or -1; weights [K, Cin, Cout]
    in lexicographic (dx, dy, dz) order, dz fastest (the occupancy stem's
    layout, so parameters interchange)."""
    k = weights.shape[0]
    assert nbr.shape[0] == k, (tuple(nbr.shape), tuple(weights.shape))
    assert k % 2 == 1, "symmetric odd-hypercube maps only (transpose-reuse)"
    return _ZConvFull.apply(x, nbr, weights.contiguous(), out_mask)

"""Column-fused (z-fused) sparse convolution, forward and backward.

Port of lidog_tpu/ops/zconv.py: `zconv3` (:308, k=3 on an augmented level:
9 xy gathers, the 3 z taps as shifts), `zconv_down` (:530, k=2 s=2, 8-tap
gather-GEMM over the coarse rows), `zconv_up` (:584, transposed: one
parent gather + per-row weight select), each a `torch.autograd.Function`
with the custom backward of the JAX version (`_zconv3_bwd:231`,
`_zdown_bwd:505`, `_zup_bwd:561`).  `zconv_full` (:410), the in_channels
> 1 stem's K-offset gather-GEMM over a symmetric source-row map, is the
generic op ops/sparse_conv.py `sparse_conv` (its kernels KO/KP live
there).

Each kernel has a plain PyTorch version (`*_plain`) and a hand-written CUDA
kernel (csrc/, see each source's note):

  KA zconv3_fwd      KE zconv3_bwd_dx     (both over zconv3_mma.cuh; their
                                          blocking: zconv3_tiles)
  KF zconv3_wgrad (zconv3_wgrad.cu; its blocking: zconv3_wgrad_split)
  KB zconv_down_fwd  (also zconv_up's dx, with transposed weights)
  KC zconv_up_fwd    (also zconv_down's dx, with transposed weights)
                     (both over gather_gemm.cuh; its blocking:
                     _wrap.gather_gemm_tiles)
  KF zconv_down_wgrad, zconv_up_wgrad (zconv_wgrad.cu over wgrad.cuh's
                     one-hot kernel; its split: _wrap.wgrad_split)

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
about 1e-2 relative.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidog_tpu_torch.ops import _cuda
from lidog_tpu_torch.ops._wrap import (DTYPES, SMS, check, flag,
                                       gather_rows, int_map, masked, on_card,
                                       ptr, wgrad_split)

LAUNCHES = {"zconv3_fwd": 0, "zconv_down_fwd": 0, "zconv_up_fwd": 0,
            "zconv3_bwd_dx": 0, "zconv3_wgrad": 0, "zconv_down_wgrad": 0,
            "zconv_up_wgrad": 0}


def _shift_next(x, zup):
    """x[j+1] where row j+1 is the z+1 cell of the same column, else 0."""
    nxt = torch.cat([x[1:], torch.zeros_like(x[:1])], dim=0)
    return nxt * zup[:, None].to(x.dtype)


def _shift_prev(x, zdn):
    prv = torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)
    return prv * zdn[:, None].to(x.dtype)


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
            acc = acc + gather_rows(u9[d], nbr9[d]).float()
    return masked(acc.to(x.dtype), out_mask)


def zconv_down_plain(x, nbr8, w8, out_mask, src_mask=None):
    """x fine [Naf, Cin]; nbr8 [8, Nac] -> coarse [Nac, Cout].  A row s of
    x with src_mask[s] false reads as zero; out_mask None keeps every
    row."""
    x = masked(x, src_mask)
    g8 = torch.stack([gather_rows(x, nbr8[k]) for k in range(8)])
    out = torch.einsum("dnc,dck->nk", g8.float(), w8.float())
    return masked(out.to(x.dtype), out_mask)


def zconv_up_plain(x, parent, off, w8, out_mask, src_mask=None):
    """x coarse [Nac, Cin]; parent/off [Naf] -> fine [Naf, Cout] (src_mask
    and out_mask as in zconv_down_plain)."""
    x = masked(x, src_mask)
    g = gather_rows(x, parent).float()
    out = torch.zeros(parent.shape[0], w8.shape[2], dtype=x.dtype,
                      device=x.device)
    for o in range(w8.shape[0]):
        rows = (off == o).nonzero()[:, 0]
        out[rows] = (g[rows] @ w8[o].float()).to(x.dtype)
    return masked(out, out_mask)


def zconv3_bwd_dx_plain(dout, nbr9, zup, zdn, wf, dout_mask):
    """dx of zconv3 (lidog_tpu/ops/zconv.py:243-274): dxc = sum_e
    gather(dout, nbr9[e]) @ wf[8-e]^T summed in f32, rounded, then folded
    onto x rows by _zcat_t.  dout [Na, Cout] is read through the forward's
    output mask -> dx [Na, Cin]."""
    d = masked(dout, dout_mask)
    wt = wf.flip(0).transpose(1, 2).float()  # [9, Cout, 3*Cin]
    acc = d.float() @ wt[4]
    for e in range(9):
        if e != 4:
            acc = acc + gather_rows(d, nbr9[e]).float() @ wt[e]
    return _zcat_t(acc.to(dout.dtype), zup, zdn)


def zconv3_wgrad_plain(x, dout, nbr9, zup, zdn, dout_mask):
    """dW of zconv3 (lidog_tpu/ops/zconv.py:268-295): dW[8-e] =
    zcat(x)^T @ gather(dout, nbr9[e]) in f32 -> [9, 3*Cin, Cout] (the
    [27, Cin, Cout] layout), rounded to x's dtype."""
    d = masked(dout, dout_mask)
    xc = _zcat(x, zup, zdn).float()
    dw = torch.stack([
        xc.T @ (d if o == 4 else gather_rows(d, nbr9[8 - o])).float()
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
    g = gather_rows(masked(dout, dout_mask), parent)
    return _onehot_dw(x, g, off).to(x.dtype)


def zconv_up_wgrad_plain(x, dout, parent, off, dout_mask):
    """dW of zconv_up (lidog_tpu/ops/zconv.py:565-571): x coarse [Nac,
    Cin], dout fine [Naf, Cout] -> [8, Cin, Cout] in x's dtype."""
    g = gather_rows(x, parent)
    return _onehot_dw(g, masked(dout, dout_mask), off).to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers (plain version on the CPU, the kernel on a card)
# ---------------------------------------------------------------------------


def zconv3_fwd(x, nbr9, zup, zdn, wf, out_mask):
    """KA (csrc/zconv3_fwd.cu).  x [Na, Cin]; wf [9, 3*Cin, Cout]."""
    if x.device.type == "cpu":
        return zconv3_plain(x, nbr9, zup, zdn, wf, out_mask)
    name = "zconv3_fwd"
    check(name, x, wf)
    na, cin = x.shape
    if tuple(wf.shape[:2]) != (9, 3 * cin):
        raise ValueError(f"{name}: wf must be [9, {3 * cin}, Cout], got "
                         f"{tuple(wf.shape)}")
    int_map(name, nbr9, (9, na), x.device)
    for f in (zup, zdn, out_mask):
        flag(name, f, na, x.device)
    out = torch.empty(na, wf.shape[2], dtype=x.dtype, device=x.device)
    if na:
        _cuda.call(name, x.data_ptr(), nbr9.data_ptr(), zup.data_ptr(),
                   zdn.data_ptr(), wf.data_ptr(), out_mask.data_ptr(),
                   out.data_ptr(), na, cin, wf.shape[2], DTYPES[x.dtype])
        LAUNCHES[name] += 1
    return out


def zconv_down_fwd(x, nbr8, w8, out_mask, src_mask=None):
    """KB (csrc/zconv_down_fwd.cu).  x fine [Naf, Cin]; w8 [8, Cin, Cout].
    Also zconv_up's dx: x the fine cotangent, w8 transposed, src_mask the
    fine output mask, out_mask None."""
    if x.device.type == "cpu":
        return zconv_down_plain(x, nbr8, w8, out_mask, src_mask)
    name = "zconv_down_fwd"
    check(name, x, w8)
    n_in, cin = x.shape
    n_out = nbr8.shape[1]
    if tuple(w8.shape[:2]) != (8, cin):
        raise ValueError(f"{name}: w8 must be [8, {cin}, Cout]")
    int_map(name, nbr8, (8, n_out), x.device)
    flag(name, out_mask, n_out, x.device)
    flag(name, src_mask, n_in, x.device)
    out = torch.empty(n_out, w8.shape[2], dtype=x.dtype, device=x.device)
    if n_out:
        _cuda.call(name, x.data_ptr(), nbr8.data_ptr(), w8.data_ptr(),
                   ptr(out_mask), ptr(src_mask), out.data_ptr(), n_in,
                   n_out, cin, w8.shape[2], DTYPES[x.dtype])
        LAUNCHES[name] += 1
    return out


def zconv_up_fwd(x, parent, off, w8, out_mask, src_mask=None):
    """KC (csrc/zconv_up_fwd.cu).  x coarse [Nac, Cin]; parent/off [Naf].
    Also zconv_down's dx: x the coarse cotangent, w8 transposed, src_mask
    the coarse output mask, out_mask None."""
    if x.device.type == "cpu":
        return zconv_up_plain(x, parent, off, w8, out_mask, src_mask)
    name = "zconv_up_fwd"
    check(name, x, w8)
    n_in, cin = x.shape
    n_out = parent.shape[0]
    if tuple(w8.shape[:2]) != (8, cin):
        raise ValueError(f"{name}: w8 must be [8, {cin}, Cout]")
    int_map(name, parent, (n_out,), x.device)
    int_map(name, off, (n_out,), x.device)
    flag(name, out_mask, n_out, x.device)
    flag(name, src_mask, n_in, x.device)
    out = torch.empty(n_out, w8.shape[2], dtype=x.dtype, device=x.device)
    if n_out:
        _cuda.call(name, x.data_ptr(), parent.data_ptr(), off.data_ptr(),
                   w8.data_ptr(), ptr(out_mask), ptr(src_mask),
                   out.data_ptr(), n_in, n_out, cin, w8.shape[2],
                   DTYPES[x.dtype])
        LAUNCHES[name] += 1
    return out


def dx_weights(wf):
    """KE's weight layout: wt[e][t] = wf[8-e][t]^T, [9, 3, Cout, Cin], from
    wf [9, 3*Cin, Cout]."""
    cin, cout = wf.shape[1] // 3, wf.shape[2]
    return wf.reshape(9, 3, cin, cout).flip(0).transpose(2, 3).contiguous()


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
    wt = dx_weights(wf)
    check(name, dout, wt)
    int_map(name, nbr9, (9, na), dout.device)
    for f in (zup, zdn, dout_mask):
        flag(name, f, na, dout.device)
    dx = torch.empty(na, cin, dtype=dout.dtype, device=dout.device)
    if na:
        _cuda.call(name, dout.data_ptr(), nbr9.data_ptr(), zup.data_ptr(),
                   zdn.data_ptr(), wt.data_ptr(), ptr(dout_mask),
                   dx.data_ptr(), na, cout, cin, DTYPES[dout.dtype])
        LAUNCHES[name] += 1
    return dx


class Z3Tiles(NamedTuple):
    """The blocking of KA (csrc/zconv3_fwd.cu) and KE (zconv3_bwd_dx.cu),
    which their C launchers choose in the same way (csrc/zconv3_mma.cuh)."""
    bm: int  # output rows of a block
    threads: int  # of a block
    per_sm: int  # blocks an SM holds by registers (the launch bounds)
    bn: int  # output columns of a block: all of the width up to 128
    bk: int  # K elements a ring stage (the last of an offset may be short)
    stages: int  # of the cp.async ring
    halo: int  # gathered rows past each end of the block's rows (KE's z taps)
    grid: tuple  # (row blocks, column blocks)
    smem: int  # dynamic shared memory of a block, bytes


def zconv3_tiles(kernel: str, rows: int, cin: int, cout: int,
                 dtype=torch.bfloat16) -> Z3Tiles:
    """KA's (kernel "fwd": K = 3 Cin, output Cout) or KE's ("dx": K =
    Cout, output Cin) blocking for a level of `rows` rows.  BN: the widest
    of 128, 96, 64 and 32 that divides the output width.  BM: 128 rows if
    that makes at least 4 waves of two blocks on each of an H100's 132
    SMs, else 64; 2 BM threads (bf16: warps of 32 x BN/2 mma tiles, f32:
    8 x BN/16 register tiles), held by registers to 512 threads an SM
    (KA at BN <= 64: 1024).  The ring: K elements a stage, KA 64 in bf16
    and 32 in f32, KE 32 in bf16, 8 in f32 (16 at BN <= 64; the last chunk
    of an offset may be short); 3 stages, but 2 in bf16 at BN 128 and in
    KA at BN <= 64, and 4 in KE's f32 above BN 64.  A stage holds A (the
    gathered rows, BM or, in KE, BM + 2 of them, each padded by 16 bytes)
    and B (the weight rows, one slab in KA, one per z tap in KE, padded by
    16 bytes); then the block's source table (9 words per gathered row)
    and KA's live-row order (2 bytes a row) or KE's z-mask bytes."""
    if kernel not in ("fwd", "dx"):
        raise ValueError(f"zconv3_tiles: kernel is 'fwd' or 'dx', got "
                         f"{kernel}")
    if cin % 32 or cout % 32:
        raise ValueError(f"zconv3_tiles: widths must be multiples of 32, got "
                         f"{cin} -> {cout}")
    esz = torch.finfo(dtype).bits // 8
    epv = 16 // esz
    width = cout if kernel == "fwd" else cin
    bn = next(b for b in (128, 96, 64, 32) if width % b == 0)
    bm = 128 if -(-rows // 128) * (width // bn) >= 4 * 2 * SMS else 64
    narrow = bn <= 64
    stages = (2 if bn == 128 else 3) if esz == 2 else 3
    per_sm = 256 // bm
    if kernel == "fwd":
        bk, halo = (64 if esz == 2 else 32), 0
        if narrow:
            stages, per_sm = 2, 512 // bm
        ring = bm * (bk + epv) + bk * (bn + epv)
        table = 9 * bm * 4 + 2 * bm
    else:
        halo = 1
        bk = 32 if esz == 2 else 16 if narrow else 8
        stages = stages if esz == 2 else 3 if narrow else 4
        ring = (bm + 2) * (bk + epv) + 3 * bk * (bn + epv)
        table = 9 * (bm + 2) * 4 + bm
    return Z3Tiles(bm, 2 * bm, per_sm, bn, bk, stages, halo,
                   (-(-rows // bm), width // bn),
                   stages * ring * esz + table)


def _wgrad(name, k, x, dout, dout_mask, rows, maps, sizes):
    """Launch one KF entry point; maps are its int32/bool map tensors and
    sizes its leading row counts, in the order of its C signature."""
    check(name, x, dout)
    cin, cout = x.shape[1], dout.shape[1]
    flag(name, dout_mask, dout.shape[0], x.device)
    dw = torch.empty(k, cin, cout, dtype=x.dtype, device=x.device)
    if rows == 0:
        return dw.zero_()
    sp = wgrad_split("onehot", rows, k, cin, cout, x.dtype)
    partial = torch.empty(sp.partial, dtype=torch.float32, device=x.device)
    _cuda.call(name, x.data_ptr(), dout.data_ptr(),
               *[m.data_ptr() for m in maps], ptr(dout_mask),
               partial.data_ptr(), dw.data_ptr(), *sizes, cin, cout,
               sp.chunks, sp.rows_per_chunk, DTYPES[x.dtype])
    LAUNCHES[name] += 1
    return dw


# csrc/zconv3_wgrad.cu: warps per block at most (an SM's registers hold 12
# such warps); an H100's shared memory (bytes) per SM
ZW_MAX_WARPS, SM_SMEM = 12, 233_472
ZW_SLABS = (128, 96, 64, 32)


def zw_rows(dtype) -> int:
    """Level rows per step of csrc/zconv3_wgrad.cu: 128 in bf16, 64 in
    f32."""
    return 128 if torch.finfo(dtype).bits == 16 else 64


class ZWSplit(NamedTuple):
    """The tiling of KF's zconv3 kernel (csrc/zconv3_wgrad.cu)."""
    bm: int  # Cin columns of a block
    bn: int  # Cout columns of a block
    ks: int  # warps sharing each 32 x 32 tile, each on rows / ks rows of
    #          every step (bf16: on every ks-th of its 32-row lists)
    chunks: int  # blocks per (xy offset, slab pair); chunk c takes the
    #              steps c, c + chunks, ...
    rows: int  # level rows per step (zw_rows)
    steps: int  # steps covering the level's rows
    rows_per_chunk: int  # at most ceil(steps / chunks) steps
    halo: int  # window rows on each side of a step (the z taps)
    partial: tuple  # the f32 partial sums [chunks * ks, 27, Cin, Cout]


def zw_smem(bm: int, bn: int, dtype) -> int:
    """Shared memory of one block (csrc/zconv3_wgrad.cu smem_bytes): the
    3-stage ring of x windows (a 1024-byte aligned box of 64-byte rows per
    64 bytes of the Cin slab) and G rows (16 bytes of row pad), 32 bytes
    of barriers, 8 map slices, the mask words, and the step's tap bytes
    and row lists."""
    esz, rk = torch.finfo(dtype).bits // 8, zw_rows(dtype)
    xbox = -(-(rk + 2) * 64 // 1024) * 1024
    return (3 * (bm * esz // 64 * xbox + rk * (bn + 16 // esz) * esz) + 32
            + 8 * 6 * rk + 3 * 4 * rk + 3 * rk + rk // 32 * 4)


def zconv3_wgrad_split(rows: int, cin: int, cout: int,
                       dtype=torch.bfloat16) -> ZWSplit:
    """The slabs, warps per tile and chunks that minimise a step-count
    model of the kernel's time: waves of resident blocks x steps per block
    x (a warp's share of a tile-step, 1 / ks, plus a fixed cost for the
    step's loads and barriers: 1.0 in bf16, whose tile-steps are tensor-
    core work, 0.5 in f32), with 0.2% per chunk for the partial sums.
    (On an H100 at L2 64 -> 64, bf16 ran faster with 64 x 64 slabs and 2
    warps a tile than with 32 x 32 and 4, f32 the other way round.)
    Blocks hold at most 12 warps; an SM holds 12 warps (their registers)
    and what its shared memory allows."""
    rk = zw_rows(dtype)
    fixed = 1.0 if rk == 128 else 0.5
    steps = -(-rows // rk)
    best = None
    for bm in (s for s in ZW_SLABS if cin % s == 0):
        for bn in (s for s in ZW_SLABS if cout % s == 0):
            tiles = (bm // 32) * (bn // 32)
            smem = zw_smem(bm, bn, dtype)
            for ks in (1, 2, 4, 8) if rk == 64 else (1, 2, 4):
                warps = tiles * ks
                if warps > ZW_MAX_WARPS or smem > 227 * 1024:
                    continue
                per_sm = max(1, min(ZW_MAX_WARPS // warps,
                                    SM_SMEM // (smem + 1024)))
                slots, per_chunk = SMS * per_sm, 9 * (cin // bm) * (cout // bn)
                for waves_aim in range(1, 9):
                    chunks = max(1, min(max(steps, 1),
                                        waves_aim * slots // per_chunk))
                    waves = -(-per_chunk * chunks // slots)
                    est = (waves * -(-steps // chunks) * (1 / ks + fixed)
                           * (1 + 0.002 * chunks * ks))
                    key = (est, -warps)
                    if best is None or key < best[0]:
                        best = (key, bm, bn, ks, chunks)
    if best is None:
        raise ValueError(f"zconv3_wgrad: widths must be multiples of 32, got "
                         f"{cin} -> {cout}")
    _, bm, bn, ks, chunks = best
    return ZWSplit(bm, bn, ks, chunks, rk, steps, -(-steps // chunks) * rk, 1,
                   (chunks * ks, 27, cin, cout))


def zconv3_wgrad(x, dout, nbr9, zup, zdn, dout_mask):
    """KF, zconv3 (csrc/zconv3_wgrad.cu).  x [Na, Cin], dout [Na, Cout] ->
    dW [27, Cin, Cout] (= [9, 3*Cin, Cout]) in x's dtype."""
    if x.device.type == "cpu":
        return zconv3_wgrad_plain(x, dout, nbr9, zup, zdn, dout_mask)
    name = "zconv3_wgrad"
    check(name, x, dout)
    na, cin = x.shape
    cout = dout.shape[1]
    if dout.shape[0] != na:
        raise ValueError(f"{name}: x and dout must have the same rows")
    int_map(name, nbr9, (9, na), x.device)
    for f in (zup, zdn, dout_mask):
        flag(name, f, na, x.device)
    on_card(name, nbr9, zup, zdn, *([] if dout_mask is None else [dout_mask]))
    dw = torch.empty(27, cin, cout, dtype=x.dtype, device=x.device)
    if na == 0:
        return dw.zero_().reshape(9, 3 * cin, cout)
    sp = zconv3_wgrad_split(na, cin, cout, x.dtype)
    partial = torch.empty(sp.partial, dtype=torch.float32, device=x.device)
    _cuda.call(name, x.data_ptr(), dout.data_ptr(), nbr9.data_ptr(),
               zup.data_ptr(), zdn.data_ptr(), ptr(dout_mask),
               partial.data_ptr(), dw.data_ptr(), na, cin, cout, sp.bm, sp.bn,
               sp.ks, sp.chunks, DTYPES[x.dtype])
    LAUNCHES[name] += 1
    return dw.reshape(9, 3 * cin, cout)


def zconv_down_wgrad(x, dout, parent, off, dout_mask):
    """KF, zconv_down (csrc/zconv_wgrad.cu).  x fine [Naf, Cin], dout
    coarse [Nac, Cout] -> dW [8, Cin, Cout] in x's dtype."""
    if x.device.type == "cpu":
        return zconv_down_wgrad_plain(x, dout, parent, off, dout_mask)
    name = "zconv_down_wgrad"
    n_fine = x.shape[0]
    for m in (parent, off):
        int_map(name, m, (n_fine,), x.device)
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
        int_map(name, m, (n_fine,), x.device)
    return _wgrad(name, 8, x, dout, dout_mask, n_fine, (parent, off),
                  (x.shape[0], n_fine))


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


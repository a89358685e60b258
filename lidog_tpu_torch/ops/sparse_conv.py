"""Sparse convolution as gather-GEMM over precomputed kernel maps (K21).

Port of lidog_tpu/ops/sparse_conv.py:107-274: every conv of MinkUNet34 on
a UNetPlan (core/plan.py), the k=5 stem, the k=3 convs, the k=2 s=2 down
convs and the transposed up convs, is

    out[i] = out_mask[i] * sum_k x[nbr[k, i]] @ W[k]      (nbr -1: zero row)

summed in f32 and rounded once to x's dtype.  `sparse_conv` is a
torch.autograd.Function with lidog_tpu's scatter-free backward: dIn is
the same gather-GEMM over the transpose map with W[::-1]^T, and dW[k] =
x^T @ gather(dout, ...) over that map in f32, rounded to the weight's
dtype.  lidog_tpu's offset grouping (`_group_size`/`_pad_group`, which
pads the contraction toward the MXU's 128) changes only the f32
summation order and is not carried over.

Kernels (csrc/sparse_conv.cu; each wrapper takes its plain version for a
CPU tensor and launches its kernel, or raises, for a CUDA tensor):

  LA sparse_conv_fwd    the gather-GEMM (also dIn, over the transpose map;
                        csrc/gather_gemm.cuh)
  LB sparse_conv_wgrad  dW, two deterministic passes (csrc/wgrad.cuh's
                        grouped kernel: 9 or 8 offsets a block)

  KO zconv_full_fwd    the same function for any K, widths up to 64
  KP zconv_full_wgrad  its dW over a symmetric map (csrc/zconv_full.cu)

LA and LB take K = 27 or 8 at widths that are multiples of 32; the
wrappers send every other conv to KO / KP.  On the main path that is the
stem (K = 125, Cin = 1 or in_channels, Cout = 32), on either plan
(lidog_tpu/ops/zconv.py:410 `zconv_full` computes the same function over
the ZPlan's stem125 map); its input takes no grad.

`sparse_conv_1x1` is the pointwise conv (lidog_tpu/ops/sparse_conv.py:258):
a plain feature matmul with f32 accumulation, outside any kernel, as the
JAX version leaves it to XLA.
"""

from __future__ import annotations

import torch

from lidog_tpu_torch.ops import _cuda
from lidog_tpu_torch.ops._wrap import (DTYPES, check, flag, gather_rows,
                                       int_map, masked, ptr, wgrad_split)

LAUNCHES = {"sparse_conv_fwd": 0, "sparse_conv_wgrad": 0,
            "zconv_full_fwd": 0, "zconv_full_wgrad": 0}
# the offset counts LA and LB are built for
KERNEL_OFFSETS = (27, 8)
# the widths KO and KP take
FULL_MAX_WIDTH = 64


# ---------------------------------------------------------------------------
# Plain versions (any device)
# ---------------------------------------------------------------------------


def sparse_conv_plain(x, nbr, w, out_mask=None, src_mask=None):
    """out[i] = out_mask[i] * sum_k x[nbr[k, i]] @ w[k]: a loop over the
    offsets of gather + f32 matmul, rounded once to x's dtype.  x [N_in,
    Cin]; nbr [K, N_out]; w [K, Cin, Cout].  A row s of x with src_mask[s]
    false reads as zero (dIn reads the cotangent through the forward's
    output mask); out_mask None keeps every row."""
    x = masked(x, src_mask)
    acc = x.new_zeros(nbr.shape[1], w.shape[2], dtype=torch.float32)
    for o in range(w.shape[0]):
        acc += gather_rows(x, nbr[o]).float() @ w[o].float()
    return masked(acc.to(x.dtype), out_mask)


def sparse_conv_wgrad_plain(x, dout, tmap, dout_mask=None, *, reverse):
    """dW[k] = x^T @ gather(dout, T[k]) summed in f32, rounded to x's dtype
    -> [K, Cin, Cout], where T[k] = tmap[K-1-k] when `reverse` (tmap the
    forward's own symmetric map) and tmap[k] otherwise (tmap the partner
    map of a down or up conv).  dout is read through dout_mask."""
    d = masked(dout, dout_mask)
    xf = x.float()
    k = tmap.shape[0]
    rows = [tmap[k - 1 - o] if reverse else tmap[o] for o in range(k)]
    return torch.stack([xf.T @ gather_rows(d, r).float()
                        for r in rows]).to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers (plain version on the CPU, the kernel on a card)
# ---------------------------------------------------------------------------


def _on_la(k, cin, cout):
    """LA / LB take K in KERNEL_OFFSETS at widths in multiples of 32; KO /
    KP take every other conv."""
    return k in KERNEL_OFFSETS and cin % 32 == 0 and cout % 32 == 0


def _check_full(name, x, w):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"{name}: x and w must share float32 or bfloat16, "
                         f"got {x.dtype} and {w.dtype}")
    cin, cout = x.shape[1], w.shape[-1]
    if not (1 <= cin <= FULL_MAX_WIDTH and 1 <= cout <= FULL_MAX_WIDTH):
        raise ValueError(f"{name}: widths must lie in [1, {FULL_MAX_WIDTH}], "
                         f"got {cin} -> {cout}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: x and w must be contiguous")


def zconv_full_fwd(x, nbr, w, out_mask=None, src_mask=None):
    """KO (csrc/zconv_full.cu): sparse_conv_fwd's function for any K at
    widths up to 64."""
    if x.device.type == "cpu":
        return sparse_conv_plain(x, nbr, w, out_mask, src_mask)
    name = "zconv_full_fwd"
    _check_full(name, x, w)
    n_in, cin = x.shape
    k, n_out = nbr.shape
    if tuple(w.shape[:2]) != (k, cin):
        raise ValueError(f"{name}: w must be [{k}, {cin}, Cout], got "
                         f"{tuple(w.shape)}")
    int_map(name, nbr, (k, n_out), x.device)
    flag(name, out_mask, n_out, x.device)
    flag(name, src_mask, n_in, x.device)
    out = torch.empty(n_out, w.shape[2], dtype=x.dtype, device=x.device)
    if n_out:
        _cuda.call(name, x.data_ptr(), nbr.data_ptr(), w.data_ptr(),
                   ptr(out_mask), ptr(src_mask), out.data_ptr(), n_in,
                   n_out, k, cin, w.shape[2], DTYPES[x.dtype])
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


def zconv_full_wgrad(x, dout, nbr, dout_mask=None):
    """KP (csrc/zconv_full.cu): sparse_conv_wgrad's function over a
    symmetric map (reverse=True), for any K at widths up to 64.  x [Na,
    Cin], dout [Na, Cout]; nbr [K, Na] -> dW [K, Cin, Cout] in x's
    dtype."""
    if x.device.type == "cpu":
        return sparse_conv_wgrad_plain(x, dout, nbr, dout_mask, reverse=True)
    name = "zconv_full_wgrad"
    _check_full(name, x, dout)
    na, cin = x.shape
    k = nbr.shape[0]
    cout = dout.shape[1]
    if dout.shape[0] != na:
        raise ValueError(f"{name}: x and dout must have the same rows")
    int_map(name, nbr, (k, na), x.device)
    flag(name, dout_mask, na, x.device)
    dw = torch.empty(k, cin, cout, dtype=x.dtype, device=x.device)
    if na == 0:
        return dw.zero_()
    chunks, rpc = _full_chunks(na)
    partial = torch.empty(chunks, k, cin, cout, dtype=torch.float32,
                          device=x.device)
    _cuda.call(name, x.data_ptr(), dout.data_ptr(), nbr.data_ptr(),
               ptr(dout_mask), partial.data_ptr(), dw.data_ptr(), na, k,
               cin, cout, chunks, rpc, DTYPES[x.dtype])
    LAUNCHES[name] += 1
    return dw


def sparse_conv_fwd(x, nbr, w, out_mask=None, src_mask=None):
    """LA (csrc/sparse_conv.cu), or KO where LA does not take the conv.
    x [N_in, Cin]; nbr [K, N_out]; w [K, Cin, Cout] -> [N_out, Cout] in
    x's dtype.  Also dIn: x the cotangent, nbr the transpose map, w the
    transposed (and for a symmetric map reversed) weights, src_mask the
    forward's output mask, out_mask None."""
    if x.device.type == "cpu":
        return sparse_conv_plain(x, nbr, w, out_mask, src_mask)
    n_in, cin = x.shape
    k, n_out = nbr.shape
    if not _on_la(k, cin, w.shape[-1]):
        return zconv_full_fwd(x, nbr, w, out_mask, src_mask)
    name = "sparse_conv_fwd"
    check(name, x, w)
    if tuple(w.shape[:2]) != (k, cin):
        raise ValueError(f"{name}: w must be [{k}, {cin}, Cout], got "
                         f"{tuple(w.shape)}")
    int_map(name, nbr, (k, n_out), x.device)
    flag(name, out_mask, n_out, x.device)
    flag(name, src_mask, n_in, x.device)
    out = torch.empty(n_out, w.shape[2], dtype=x.dtype, device=x.device)
    if n_out:
        _cuda.call(name, x.data_ptr(), nbr.data_ptr(), w.data_ptr(),
                   ptr(out_mask), ptr(src_mask), out.data_ptr(), n_in,
                   n_out, k, cin, w.shape[2], DTYPES[x.dtype])
        LAUNCHES[name] += 1
    return out


def sparse_conv_wgrad(x, dout, tmap, dout_mask=None, *, reverse):
    """LB (csrc/sparse_conv.cu), or KP where LB does not take the conv (a
    symmetric map only, reverse=True).  x [N_in, Cin]; dout [N_out,
    Cout]; tmap [K, N_in] rows of dout -> dW [K, Cin, Cout] in x's dtype
    (see sparse_conv_wgrad_plain)."""
    if x.device.type == "cpu":
        return sparse_conv_wgrad_plain(x, dout, tmap, dout_mask,
                                       reverse=reverse)
    name = "sparse_conv_wgrad"
    n_in, cin = x.shape
    n_out, cout = dout.shape
    k = tmap.shape[0]
    if not _on_la(k, cin, cout):
        if not reverse:
            raise ValueError(f"{name}: K {k} at widths {cin} -> {cout} takes "
                             "KP, which needs a symmetric map")
        return zconv_full_wgrad(x, dout, tmap, dout_mask)
    check(name, x, dout)
    int_map(name, tmap, (k, n_in), x.device)
    flag(name, dout_mask, n_out, x.device)
    dw = torch.empty(k, cin, cout, dtype=x.dtype, device=x.device)
    if n_in == 0:
        return dw.zero_()
    sp = wgrad_split("group", n_in, k, cin, cout, x.dtype)
    partial = torch.empty(sp.partial, dtype=torch.float32, device=x.device)
    _cuda.call(name, x.data_ptr(), dout.data_ptr(), tmap.data_ptr(),
               ptr(dout_mask), partial.data_ptr(), dw.data_ptr(), n_in,
               n_out, k, int(reverse), cin, cout, sp.chunks,
               sp.rows_per_chunk, DTYPES[x.dtype])
    LAUNCHES[name] += 1
    return dw


# ---------------------------------------------------------------------------
# The autograd op and the public functions (JAX signatures)
# ---------------------------------------------------------------------------


class _SparseConv(torch.autograd.Function):
    """Saves x (no gather), as lidog_tpu's residuals do.  The backward
    runs over tmap: with `reverse` it is the forward's symmetric map and
    dIn = sum_k dout[nbr[k]] @ W[K-1-k]^T, dW[k] = x^T dout[nbr[K-1-k]];
    otherwise tmap is the partner map (down <-> up) and dIn = sum_k
    dout[tmap[k]] @ W[k]^T, dW[k] = x^T dout[tmap[k]]: lidog_tpu's
    reversed partner table with W[::-1]^T, with both reversals cancelled."""

    @staticmethod
    def forward(ctx, x, nbr, w, tmap, out_mask, reverse):
        ctx.save_for_backward(x, w, tmap, out_mask)
        ctx.reverse = reverse
        return sparse_conv_fwd(x, nbr, w, out_mask)

    @staticmethod
    def backward(ctx, dout):
        x, w, tmap, m = ctx.saved_tensors
        dout = dout.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt = (w.flip(0) if ctx.reverse else w).transpose(1, 2)
            dx = sparse_conv_fwd(dout, tmap, wt.contiguous(), None,
                                 src_mask=m)
        if ctx.needs_input_grad[2]:
            dw = sparse_conv_wgrad(x, dout, tmap, m, reverse=ctx.reverse)
        return dx, None, dw, None, None, None


def sparse_conv(feats, nbr_idx, weights, *, nbr_t=None, out_mask=None):
    """Apply a sparse convolution (lidog_tpu/ops/sparse_conv.py:196-255).

    feats [N_in, Cin] (padding rows zero); nbr_idx [K, N_out], the row of
    feats per offset or -1; weights [K, Cin, Cout] in the offsets' order;
    nbr_t [K, N_in], the transpose map: required for even kernels (the
    down <-> up partner map of the plan), for odd (symmetric) kernels the
    map itself when None; out_mask [N_out] bool zeroes padded output rows.
    Returns [N_out, Cout] in feats' dtype; the input grad is skipped when
    feats takes none (the stem)."""
    k = weights.shape[0]
    if nbr_t is None:
        if k % 2 == 0:
            raise ValueError("nbr_t is required for even (strided/"
                             "transposed) kernels")
        tmap, reverse = nbr_idx, True
    else:
        tmap, reverse = nbr_t, False
    return _SparseConv.apply(feats, nbr_idx, weights.contiguous(),
                             tmap.contiguous(), out_mask, reverse)


def sparse_conv_1x1(feats, weights, bias=None, *, out_mask=None):
    """feats [N, Cin] @ weights [Cin, Cout] (+ bias, already in the feats
    dtype), rounded to the feats dtype, masked."""
    out = feats.float() @ weights.float()
    if bias is not None:
        out = out + bias.float()
    out = out.to(feats.dtype)
    if out_mask is not None:
        out = out * out_mask[:, None].to(out.dtype)
    return out

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
  KP zconv_full_wgrad  its dW over a symmetric map (csrc/zconv_full.cu;
                       `full_fwd_route` states which of KO's three forms
                       takes a call, `full_tiles` the lane tiling of the
                       hit lists, `full_wgrad_split` KP's chunks,
                       `full_offset_order` the order its blocks are
                       issued in)

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

from typing import NamedTuple

from lidog_tpu_torch.ops import _cuda
from lidog_tpu_torch.ops._wrap import (DTYPES, check, flag, gather_rows,
                                       int_map, masked, ptr, wgrad_split)

LAUNCHES = {"sparse_conv_fwd": 0, "sparse_conv_wgrad": 0,
            "zconv_full_fwd": 0, "zconv_full_wgrad": 0}
# the offset counts LA and LB are built for
KERNEL_OFFSETS = (27, 8)
# the widths KO and KP take
FULL_MAX_WIDTH = 64
# csrc/zconv_full.cu's blocking: KO's output rows a warp tile (lane =
# row) and offsets whose map entries it loads at once; KP's warps a block
# and 32-row steps a warp loads at once
FULL_FWD_ROWS, FULL_FWD_GROUP = 32, 16
# KO's tensor-core form (bf16): warps a block, offsets a map group
FULL_MMA_WARPS, FULL_MMA_GROUP = 4, 16
# KO's f32 row form: warps a block, offsets a map group (a warp's stash of
# group x 33 entries sits beside W)
FULL_ROWS_WARPS, FULL_ROWS_GROUP = 16, 16
FULL_ROWS_STASH = FULL_ROWS_WARPS * FULL_ROWS_GROUP * 33 * 4
# the dynamic shared memory a block may use (an H100's 227 KB)
FULL_SMEM = 227 * 1024
FULL_WGRAD_WARPS, FULL_WGRAD_STEPS = 16, 8
# KP's rows a chunk: 16 warps x 512 rows (at the training plan's level 0:
# 60 chunks, a 3.8 MB f32 partial for 4 -> 32)
FULL_WGRAD_ROWS = 8192
FULL_WGRAD_MAX_CHUNKS = 1024


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


class FullTiles(NamedTuple):
    """The lane tiling of KO and KP (csrc/zconv_full.cu `tiles_of`): lane
    = (q, c), c < ct output columns (a power of two, at most 32; nc = 2
    column sets above 32 columns: c and c + 32), q < 32 // ct slices of
    a_slice input channels each, taken ab (1, 4 or 16) at a time in
    `passes` passes."""
    ct: int
    nc: int
    a_slice: int
    ab: int
    passes: int

    @property
    def q(self):
        return 32 // self.ct


def full_tiles(cin, cout):
    """KO's and KP's lane tiling at Cin -> Cout (see FullTiles)."""
    ct = 1
    while ct < cout and ct < 32:
        ct *= 2
    a_slice = -(-cin // (32 // ct))
    ab = 1 if a_slice == 1 else 4 if a_slice <= 4 else 16
    return FullTiles(ct, -(-cout // ct), a_slice, ab, -(-a_slice // ab))


def full_fwd_route(cin, cout, k, dtype):
    """The form of KO that takes a call (csrc/zconv_full.cu
    zconv_full_fwd): "mma", the tensor cores (bf16 at Cin in (1, 2, 4, 8,
    16) and Cout in [17, 64], where W's fragments, one 8-byte word a lane,
    n8 tile and k-step of 16 / Cin offsets with Cout padded to 32 or 64,
    and the warps' map stashes fit in a block's shared memory); "rows", a
    lane an output row (f32 at Cin in (1, 2, 4) and Cout <= 32, W in
    shared memory); else "cores", the hit lists of full_tiles."""
    if dtype == torch.bfloat16 and cin in (1, 2, 4, 8, 16) and 17 <= cout <= 64:
        nt = 8 if cout > 32 else 4
        steps = -(-k // FULL_MMA_GROUP) * (FULL_MMA_GROUP * cin // 16)
        pitch = 36 if cin == 1 else 40
        if steps * nt * 32 * 8 + FULL_MMA_WARPS * FULL_MMA_GROUP * pitch * 4 \
                <= FULL_SMEM:
            return "mma"
    if dtype == torch.float32 and cin in (1, 2, 4) and cout <= 32 \
            and k * cin * 32 * 4 + FULL_ROWS_STASH <= FULL_SMEM:
        return "rows"
    return "cores"


class FullWgradSplit(NamedTuple):
    """KP's blocks: `chunks` chunks of `rows_per_chunk` rows for each of
    the K offsets, each chunk's rows cut into FULL_WGRAD_WARPS runs of
    `rows_per_warp` (a multiple of 32; the last runs may be short or
    empty); one f32 partial [Cin, Cout] a (chunk, offset)."""
    chunks: int
    rows_per_chunk: int
    rows_per_warp: int


def full_wgrad_split(rows):
    """KP's chunks at `rows` rows: chunks of FULL_WGRAD_ROWS, at most
    FULL_WGRAD_MAX_CHUNKS (then longer chunks).  The wrapper passes chunks
    and rows_per_chunk to the C side, which cuts rows_per_warp from them
    the same way."""
    chunks = min(max(1, -(-rows // FULL_WGRAD_ROWS)), FULL_WGRAD_MAX_CHUNKS)
    rpc = max(1, -(-rows // chunks))
    rpw = -(-rpc // (32 * FULL_WGRAD_WARPS)) * 32
    return FullWgradSplit(chunks, rpc, rpw)


def full_offset_order(k):
    """The offsets in the order KP's blocks are issued: the centre (k //
    2), then one below, one above, two below, ...: on the stem's map
    ((dx, dy, dz) order, dz fastest) the dense offsets come first."""
    return [k // 2 - (r + 1) // 2 if r % 2 else k // 2 + r // 2
            for r in range(k)]


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
    sp = full_wgrad_split(na)
    partial = torch.empty(sp.chunks, k, cin, cout, dtype=torch.float32,
                          device=x.device)
    _cuda.call(name, x.data_ptr(), dout.data_ptr(), nbr.data_ptr(),
               ptr(dout_mask), partial.data_ptr(), dw.data_ptr(), na, k,
               cin, cout, sp.chunks, sp.rows_per_chunk, DTYPES[x.dtype])
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

"""Sparse voxels -> pooled dense BEV feature image, in one fused scatter.

Port of lidog_tpu/ops/bev.py:31 (`bev_scatter_pooled`) with its custom
backward: each voxel's features are scatter-maxed straight into the pooled
output cells its dense pixel reaches through the MaxPool(window, stride,
pad) window (at most 2 per axis for window 5, stride 3; 1 when the stride
is >= the window), into a grid that starts at zero, so the 2000^2 dense
raster never exists.  Geometry (bound 50 m, voxel 0.05 m): pixel_x = x +
1000, pixel_y = 1999 - (y + 1000); pooled output i covers pixels [3i - 1,
3i + 3]; 666 outputs per axis.

The backward routes each cell's cotangent to every row that ties the
cell's maximum (`_psm_bwd:115`), summed in f32 over the candidates in
order and rounded once; a row whose value is 0 wins a cell whose maximum
is 0.  JAX's `segmented_rows` only chose the memory plan of that
backward, with the same result, so there is one backward here.

Two hand-written CUDA kernels (csrc/bev_scatter_max.cu): KI
`bev_scatter_max` (forward) and KJ `bev_scatter_max_bwd`.  Each `*_plain`
function is the plain PyTorch version its wrapper takes for a tensor on
the CPU; on a card the wrapper launches the kernel or raises.
"""

from __future__ import annotations

import torch

from lidog_tpu_torch.ops import _cuda
from lidog_tpu_torch.ops._wrap import DTYPES

LAUNCHES = {"bev_scatter_max": 0, "bev_scatter_max_bwd": 0}


def pooled_size(grid: int, window: int, stride: int, pad: int) -> int:
    return (grid + 2 * pad - window) // stride + 1


def candidates(coords, mask, nb, grid, out_hw, window, stride, pad):
    """Per candidate j (j = dy * cands + dx): the flat output cell of each
    row, (b * out_hw + iy) * out_hw + ix, and whether it is live -> (cell
    int64 [K, N], live bool [K, N]).  A row takes part when its mask is
    set, its pixel lies on the grid and 0 <= b < nb."""
    half = grid // 2
    b = coords[:, 0].long()
    px = coords[:, 1].long() + half
    py = (grid - 1) - (coords[:, 2].long() + half)
    ok = (mask & (px >= 0) & (px < grid) & (py >= 0) & (py < grid)
          & (b >= 0) & (b < nb))
    back = window - 1 - pad

    def axis(p):  # pooled outputs lo..hi reach pixel p
        lo = -torch.div(back - p, stride, rounding_mode="floor")
        return lo, torch.div(p + pad, stride, rounding_mode="floor")

    ylo, yhi = axis(py)
    xlo, xhi = axis(px)
    cands = -(-window // stride)
    cells, lives = [], []
    for dy in range(cands):
        for dx in range(cands):
            iy, ix = ylo + dy, xlo + dx
            live = (ok & (iy <= yhi) & (ix <= xhi) & (iy >= 0) & (iy < out_hw)
                    & (ix >= 0) & (ix < out_hw))
            cells.append(torch.where(live, (b * out_hw + iy) * out_hw + ix, 0))
            lives.append(live)
    return torch.stack(cells), torch.stack(lives)


def bev_scatter_max_plain(feats, coords, mask, nb, grid, out_hw, window, stride,
                          pad):
    """feats [N, C] -> [nb, out_hw, out_hw, C]: the max over the live
    candidates landing on each cell, and 0 (only values > 0 can beat the
    zero start; -0.0 and NaN read as 0)."""
    c = feats.shape[1]
    cells, live = candidates(coords, mask, nb, grid, out_hw, window, stride,
                             pad)
    fz = torch.where(feats > 0, feats, torch.zeros_like(feats))
    out = torch.zeros(nb * out_hw * out_hw, c, dtype=feats.dtype,
                      device=feats.device)
    for j in range(cells.shape[0]):
        out.scatter_reduce_(0, cells[j][:, None].expand(-1, c),
                            fz * live[j][:, None].to(fz.dtype), "amax",
                            include_self=True)
    return out.view(nb, out_hw, out_hw, c)


def bev_scatter_max_bwd_plain(feats, coords, mask, out, dout, nb, grid, out_hw,
                              window, stride, pad):
    """dfeats [N, C]: the cotangent of every cell a row ties, summed in f32
    over the candidates in order (lidog_tpu/ops/bev.py:115-152)."""
    c = feats.shape[1]
    cells, live = candidates(coords, mask, nb, grid, out_hw, window, stride,
                             pad)
    out_f, dout_f = out.reshape(-1, c), dout.reshape(-1, c)
    acc = torch.zeros(feats.shape, dtype=torch.float32, device=feats.device)
    for j in range(cells.shape[0]):
        won = (feats == out_f[cells[j]]) & live[j][:, None]
        acc = acc + torch.where(won, dout_f[cells[j]].float(), 0.0)
    return acc.to(feats.dtype)


def _check(name, feats, coords, mask, grids=()):
    if feats.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{feats.device}")
    if feats.dtype not in DTYPES or feats.dim() != 2 \
            or not feats.is_contiguous():
        raise ValueError(f"{name}: feats must be a contiguous float32 or "
                         f"bfloat16 [N, C] tensor")
    n, c = feats.shape
    if feats.dtype == torch.bfloat16 and (c % 2 or feats.data_ptr() % 4):
        raise ValueError(f"{name}: bfloat16 feats need an even channel count "
                         f"and 4-byte alignment, got C = {c}")
    if coords.dtype != torch.int32 or tuple(coords.shape) != (n, 4) \
            or coords.device != feats.device or not coords.is_contiguous() \
            or coords.data_ptr() % 16:
        raise ValueError(f"{name}: coords must be contiguous 16-byte aligned "
                         f"int32 [{n}, 4] on {feats.device}")
    if mask.dtype != torch.bool or tuple(mask.shape) != (n,) \
            or mask.device != feats.device or not mask.is_contiguous():
        raise ValueError(f"{name}: mask must be contiguous bool [{n}]")
    for g in grids:
        if g.dtype != feats.dtype or g.device != feats.device \
                or not g.is_contiguous() or g.data_ptr() % 4:
            raise ValueError(f"{name}: the grids must be contiguous, aligned "
                             f"and of feats' dtype")


def bev_scatter_max(feats, coords, mask, nb, grid, out_hw, window, stride,
                    pad):
    """KI (csrc/bev_scatter_max.cu): the forward, zero-fill included (the
    plain version for a CPU tensor)."""
    if feats.device.type == "cpu":
        return bev_scatter_max_plain(feats, coords, mask, nb, grid, out_hw,
                                     window, stride, pad)
    name = "bev_scatter_max"
    _check(name, feats, coords, mask)
    n, c = feats.shape
    out = torch.empty(nb, out_hw, out_hw, c, dtype=feats.dtype,
                      device=feats.device)
    _cuda.call("bev_scatter_max_fwd", feats.data_ptr(), coords.data_ptr(),
               mask.data_ptr(), out.data_ptr(), n, c, nb, grid, out_hw, window,
               stride, pad, DTYPES[feats.dtype])
    LAUNCHES[name] += 1
    return out


def bev_scatter_max_bwd(feats, coords, mask, out, dout, nb, grid, out_hw,
                        window, stride, pad):
    """KJ (csrc/bev_scatter_max.cu): the backward (the plain version for a
    CPU tensor)."""
    if feats.device.type == "cpu":
        return bev_scatter_max_bwd_plain(feats, coords, mask, out, dout, nb,
                                         grid, out_hw, window, stride, pad)
    name = "bev_scatter_max_bwd"
    _check(name, feats, coords, mask, (out, dout))
    n, c = feats.shape
    if tuple(out.shape) != (nb, out_hw, out_hw, c) or dout.shape != out.shape:
        raise ValueError(f"{name}: out and dout must be [{nb}, {out_hw}, "
                         f"{out_hw}, {c}]")
    dfeats = torch.empty_like(feats)
    _cuda.call("bev_scatter_max_bwd", feats.data_ptr(), coords.data_ptr(),
               mask.data_ptr(), out.data_ptr(), dout.data_ptr(),
               dfeats.data_ptr(), n, c, nb, grid, out_hw, window, stride, pad,
               DTYPES[feats.dtype])
    LAUNCHES[name] += 1
    return dfeats


class _PooledScatterMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, coords, mask, geom):
        out = bev_scatter_max(feats, coords, mask, *geom)
        ctx.save_for_backward(feats, coords, mask, out)
        ctx.geom = geom
        return out

    @staticmethod
    def backward(ctx, dout):
        feats, coords, mask, out = ctx.saved_tensors
        dfeats = bev_scatter_max_bwd(feats, coords, mask, out,
                                     dout.to(out.dtype).contiguous(),
                                     *ctx.geom)
        return dfeats, None, None, None


def bev_scatter_pooled(coords, feats, mask, num_batches: int,
                       voxel_size: float = 0.05, bound: float = 50.0,
                       pool_window: int = 5, pool_stride: int = 3,
                       pool_pad: int = 1):
    """coords int32 [N, 4] raw grid coords (stride-1 units); feats [N, C];
    mask [N] -> [B, H_out, W_out, C] pooled BEV features, H_out =
    (grid + 2 pad - window) // stride + 1 with grid = 2 bound / voxel_size
    (2000 -> 666 for the defaults)."""
    grid = int(round(2 * bound / voxel_size))
    geom = (num_batches, grid, pooled_size(grid, pool_window, pool_stride,
                                           pool_pad),
            pool_window, pool_stride, pool_pad)
    return _PooledScatterMax.apply(feats.contiguous(), coords.contiguous(),
                                   mask.contiguous(), geom)

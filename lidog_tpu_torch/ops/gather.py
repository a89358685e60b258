"""Window gathers: the kernels of the gather and DMA probes (probes/).

Each wrapper takes its plain version for CPU tensors and launches its
kernel, or raises, for CUDA tensors:

  LE window_row_gather  out[t] = win[idx[t]]            csrc/window_gather.cu
  LF window_lane_gather out[c, t] = win[c, idx[t]]      csrc/window_gather.cu
  LG window_copy        out[t * tile + i] = feats[ws[t] + i], i < tile
                                                        csrc/window_copy.cu
  LH lane_gather_sum    out[c, l] = sum over r, in order, of
                        win[c, 128 r + idx[c, 128 r + l]]  csrc/window_gather.cu

They port the Pallas probes P1 (benchmarks/micro/micro_gather.py:71
q2_pallas_vmem_gather), P4 (benchmarks/micro/micro_bisect.py:23 t1_dma,
:54 gather_case) and P5 (benchmarks/micro_lanegather.py:29 main).  An
index outside the window (LH: outside its 128-lane chunk) and a copied row
outside feats read as zero.  LE, LF and LG take float32 and bfloat16
(they copy bits); LH takes float32, as P5 does.  Every kernel is bitwise
equal to its plain version.  The size limits (a block's shared memory,
the grid) are the C entry points', which refuse other sizes with
cudaErrorInvalidValue.
"""

from __future__ import annotations

import torch

from lidog_tpu_torch.ops import _cuda
from lidog_tpu_torch.ops._wrap import DTYPES, on_card

LAUNCHES = {"window_row_gather": 0, "window_lane_gather": 0,
            "window_copy": 0, "lane_gather_sum": 0}
LANES = 128


# ---------------------------------------------------------------------------
# Plain versions (any device)
# ---------------------------------------------------------------------------


def _take(src, idx, dim):
    """src gathered along dim at idx (broadcast to src's other dim), zero
    where idx lies outside [0, src.shape[dim])."""
    n = src.shape[dim]
    hit = (idx >= 0) & (idx < n)
    got = torch.gather(src, dim, idx.clamp(0, n - 1).long())
    return torch.where(hit, got, torch.zeros((), dtype=src.dtype,
                                             device=src.device))


def window_row_gather_plain(win, idx):
    """win [W, C], idx [T] -> [T, C]: win[idx]."""
    return _take(win, idx[:, None].expand(-1, win.shape[1]), 0)


def window_lane_gather_plain(win, idx):
    """win [C, W], idx [T] -> [C, T]: win[c, idx[t]]."""
    return _take(win, idx[None].expand(win.shape[0], -1), 1)


def window_rows(ws, tile):
    """The rows LG copies: [tiles * tile] int64, ws[t] + i for i < tile."""
    return (ws.long()[:, None]
            + torch.arange(tile, device=ws.device)).reshape(-1)


def window_copy_plain(feats, ws, tile):
    """feats [N, C], ws [T] int32 -> [T * tile, C]: the tile rows at each
    window start, zero outside feats."""
    return window_row_gather_plain(feats, window_rows(ws, tile))


def lane_gather_sum_plain(win, idx):
    """win, idx [C, 128 R] -> [C, 128]: the R chunks' lane gathers added
    in f32 in chunk order (as the kernel and P5 add them; a torch.sum over
    the gathered chunks would add in another order)."""
    acc = torch.zeros(win.shape[0], LANES, dtype=torch.float32,
                      device=win.device)
    for r in range(win.shape[1] // LANES):
        sl = slice(r * LANES, (r + 1) * LANES)
        acc = acc + _take(win[:, sl], idx[:, sl], 1)
    return acc


# ---------------------------------------------------------------------------
# Kernel wrappers (plain version on the CPU, the kernel on a card)
# ---------------------------------------------------------------------------


def _check(name, tensors, checks):
    on_card(name, *tensors)
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"{name}: {msg}")


def window_row_gather(win, idx):
    """LE (csrc/window_gather.cu) for CUDA tensors, the plain version for
    CPU tensors.  win [W, C] float32 or bfloat16, idx [T] int32."""
    if win.device.type == "cpu":
        return window_row_gather_plain(win, idx)
    name = "window_row_gather"
    _check(name, (win, idx), [
        (win.dtype in DTYPES, "win must be float32 or bfloat16"),
        (idx.dtype == torch.int32 and idx.dim() == 1, "idx must be int32 [T]"),
    ])
    w, c = win.shape
    out = torch.empty(idx.shape[0], c, dtype=win.dtype, device=win.device)
    if idx.numel() and c:
        _cuda.call(name, win.data_ptr(), idx.data_ptr(), out.data_ptr(), w,
                   idx.shape[0], c * win.element_size())
        LAUNCHES[name] += 1
    return out


def window_lane_gather(win, idx):
    """LF (csrc/window_gather.cu) for CUDA tensors, the plain version for
    CPU tensors.  win [C, W] float32 or bfloat16, idx [T] int32."""
    if win.device.type == "cpu":
        return window_lane_gather_plain(win, idx)
    name = "window_lane_gather"
    _check(name, (win, idx), [
        (win.dtype in DTYPES, "win must be float32 or bfloat16"),
        (idx.dtype == torch.int32 and idx.dim() == 1, "idx must be int32 [T]"),
    ])
    c, w = win.shape
    t = idx.shape[0]
    out = torch.empty(c, t, dtype=win.dtype, device=win.device)
    if t and c:
        _cuda.call(name, win.data_ptr(), idx.data_ptr(), out.data_ptr(), c,
                   w, t, win.element_size())
        LAUNCHES[name] += 1
    return out


def window_copy(feats, ws, tile):
    """LG (csrc/window_copy.cu) for CUDA tensors, the plain version for
    CPU tensors.  feats [N, C] float32 or bfloat16, ws [T] int32 ->
    [T * tile, C]."""
    if feats.device.type == "cpu":
        return window_copy_plain(feats, ws, tile)
    name = "window_copy"
    _check(name, (feats, ws), [
        (feats.dtype in DTYPES, "feats must be float32 or bfloat16"),
        (ws.dtype == torch.int32 and ws.dim() == 1, "ws must be int32 [T]"),
    ])
    n, c = feats.shape
    out = torch.empty(ws.shape[0] * tile, c, dtype=feats.dtype,
                      device=feats.device)
    if ws.numel():
        _cuda.call(name, feats.data_ptr(), ws.data_ptr(), out.data_ptr(), n,
                   ws.shape[0], tile, c * feats.element_size())
        LAUNCHES[name] += 1
    return out


def lane_gather_sum(win, idx):
    """LH (csrc/window_gather.cu) for CUDA tensors, the plain version for
    CPU tensors.  win [C, 128 R] float32, idx [C, 128 R] int32 -> [C, 128]
    float32."""
    if win.device.type == "cpu":
        return lane_gather_sum_plain(win, idx)
    name = "lane_gather_sum"
    c, width = win.shape
    _check(name, (win, idx), [
        (win.dtype == torch.float32, "win must be float32"),
        (idx.dtype == torch.int32 and tuple(idx.shape) == (c, width),
         f"idx must be int32 [{c}, {width}]"),
        (width % LANES == 0, f"a row of {width} lanes is no multiple of "
         f"{LANES}"),
    ])
    out = torch.empty(c, LANES, dtype=torch.float32, device=win.device)
    if c:
        _cuda.call(name, win.data_ptr(), idx.data_ptr(), out.data_ptr(), c,
                   width // LANES)
        LAUNCHES[name] += 1
    return out

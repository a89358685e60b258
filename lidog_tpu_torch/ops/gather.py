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
equal to its plain version.  LE and LF gather straight from the window
in device memory (`row_gather_split` and `lane_gather_split` state their
blocking); LH stages a channel row in shared memory.  The size limits
(LE's 16-byte rows, LF's channel blocks, LH's and LG's shared memory)
are the C entry points', which refuse other sizes with
cudaErrorInvalidValue.
"""

from __future__ import annotations

import torch

from lidog_tpu_torch.ops import _cuda
from lidog_tpu_torch.ops._wrap import DTYPES, on_card

LAUNCHES = {"window_row_gather": 0, "window_lane_gather": 0,
            "window_copy": 0, "lane_gather_sum": 0}
LANES = 128
# csrc/window_gather.cu's blocking of LE and LF (kThreads, kRowVecs,
# kLaneChannels there)
GATHER_THREADS = 128
ROW_VECTORS = 2
LANE_CHANNELS = 4


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


def row_gather_split(t, row_bytes):
    """LE's blocking of t rows of row_bytes (a multiple of 16): (g,
    blocks).  g threads a row, the fewest powers of two up to 32 that
    hold ROW_VECTORS of the row's 16-byte vectors each: thread j of row
    t's group is thread t g + j of the grid and owns vectors j, j + g, ...;
    blocks of GATHER_THREADS threads."""
    v_row = row_bytes // 16
    g = 1
    while g < 32 and g * ROW_VECTORS < v_row:
        g *= 2
    return g, -(-t * g // GATHER_THREADS)


def lane_gather_split(c, t):
    """LF's grid for out [c, t]: (t blocks of GATHER_THREADS threads,
    channel blocks of LANE_CHANNELS), thread i of block (x, y) taking t =
    x GATHER_THREADS + i and channels y LANE_CHANNELS + k."""
    return -(-t // GATHER_THREADS), -(-c // LANE_CHANNELS)


def _window_args(name, win, idx, win_name="win", idx_name="idx"):
    """Raise unless win is float32 or bfloat16 and idx int32 [T], both on
    one card, contiguous and 16-byte aligned."""
    on_card(name, win, idx)
    if win.dtype not in DTYPES:
        raise ValueError(f"{name}: {win_name} must be float32 or bfloat16")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"{name}: {idx_name} must be int32 [T]")


def window_row_gather(win, idx):
    """LE (csrc/window_gather.cu) for CUDA tensors, the plain version for
    CPU tensors.  win [W, C] float32 or bfloat16, idx [T] int32."""
    if win.is_cpu:
        return window_row_gather_plain(win, idx)
    _window_args("window_row_gather", win, idx)
    w, c = win.shape
    t = idx.shape[0]
    out = torch.empty(t, c, dtype=win.dtype, device=win.device)
    if t and c:
        _cuda.call("window_row_gather", win.data_ptr(), idx.data_ptr(),
                   out.data_ptr(), w, t, c * win.element_size())
        LAUNCHES["window_row_gather"] += 1
    return out


def window_lane_gather(win, idx):
    """LF (csrc/window_gather.cu) for CUDA tensors, the plain version for
    CPU tensors.  win [C, W] float32 or bfloat16, idx [T] int32."""
    if win.is_cpu:
        return window_lane_gather_plain(win, idx)
    _window_args("window_lane_gather", win, idx)
    c, w = win.shape
    t = idx.shape[0]
    out = torch.empty(c, t, dtype=win.dtype, device=win.device)
    if t and c:
        _cuda.call("window_lane_gather", win.data_ptr(), idx.data_ptr(),
                   out.data_ptr(), c, w, t, win.element_size())
        LAUNCHES["window_lane_gather"] += 1
    return out


def window_copy(feats, ws, tile):
    """LG (csrc/window_copy.cu) for CUDA tensors, the plain version for
    CPU tensors.  feats [N, C] float32 or bfloat16, ws [T] int32 ->
    [T * tile, C]."""
    if feats.is_cpu:
        return window_copy_plain(feats, ws, tile)
    _window_args("window_copy", feats, ws, "feats", "ws")
    n, c = feats.shape
    out = torch.empty(ws.shape[0] * tile, c, dtype=feats.dtype,
                      device=feats.device)
    if ws.numel():
        _cuda.call("window_copy", feats.data_ptr(), ws.data_ptr(),
                   out.data_ptr(), n, ws.shape[0], tile,
                   c * feats.element_size())
        LAUNCHES["window_copy"] += 1
    return out


def lane_gather_sum(win, idx):
    """LH (csrc/window_gather.cu) for CUDA tensors, the plain version for
    CPU tensors.  win [C, 128 R] float32, idx [C, 128 R] int32 -> [C, 128]
    float32."""
    if win.is_cpu:
        return lane_gather_sum_plain(win, idx)
    name = "lane_gather_sum"
    c, width = win.shape
    on_card(name, win, idx)
    if win.dtype != torch.float32:
        raise ValueError(f"{name}: win must be float32")
    if idx.dtype != torch.int32 or idx.shape != win.shape:
        raise ValueError(f"{name}: idx must be int32 [{c}, {width}]")
    if width % LANES:
        raise ValueError(f"{name}: a row of {width} lanes is no multiple of "
                         f"{LANES}")
    out = torch.empty(c, LANES, dtype=torch.float32, device=win.device)
    if c:
        _cuda.call(name, win.data_ptr(), idx.data_ptr(), out.data_ptr(), c,
                   width // LANES)
        LAUNCHES[name] += 1
    return out

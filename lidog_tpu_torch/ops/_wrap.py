"""What the kernel wrappers of ops/ share: the dtype codes of the C
interfaces, the checks a wrapper makes before it launches, the blocking
of the gather-GEMM and the split of the two-pass weight-gradient kernels
(csrc/gather_gemm.cuh, csrc/wgrad.cuh), and the row gather and mask of
the plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# the dtype code every C entry point takes as its last int
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gather_rows(u, idx):
    """u [n, C]; idx [m] (-1 or out of range = miss -> zero row)."""
    hit = (idx >= 0) & (idx < u.shape[0])
    return u[idx.clamp(0, u.shape[0] - 1).long()] * hit[:, None].to(u.dtype)


def masked(out, mask):
    return out if mask is None else out * mask[:, None].to(out.dtype)


def on_card(name, *tensors):
    """Raise unless every tensor lies on the first one's CUDA device,
    contiguous and 16-byte aligned."""
    first = tensors[0]
    if not first.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{first.device}")
    dev = first.get_device()
    for t in tensors:
        if t.get_device() != dev or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous on "
                             f"{first.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


def check(name, x, w):
    """x [N, Cin] and w [..., Cout] for a tensor-core kernel: CUDA, one of
    DTYPES, widths in multiples of 32, contiguous and 16-byte aligned."""
    on_card(name, x, w)
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"{name}: x and w must share float32 or bfloat16, "
                         f"got {x.dtype} and {w.dtype}")
    cin, cout = x.shape[1], w.shape[-1]
    if cin % 32 or cout % 32:
        raise ValueError(f"{name}: widths must be multiples of 32, got "
                         f"{cin} -> {cout}")


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


# an H100's SMs
SMS = 132


def col_tile(width):
    """Output columns of a gather-GEMM block (csrc/zconv3_mma.cuh
    z3::col_tile): the widest of 128, 96, 64 and 32 that divides the width
    (a multiple of 32)."""
    return next(b for b in (128, 96, 64, 32) if width % b == 0)


class GGTiles(NamedTuple):
    """The blocking of the gather-GEMMs (csrc/gather_gemm.cuh: KB and LA
    gathering, KC one-hot), which their C launcher chooses in the same
    way."""
    bm: int  # gathering: output rows of a block; one-hot: rows of a tile
    threads: int  # of a block
    bn: int  # output columns of a block: all of the width up to 128
    bk: int  # gathering: K elements a ring stage (of the live offsets'
    #          columns end to end); one-hot: Cin (a source whole)
    stages: int  # gathering: of the cp.async ring; one-hot: tiles in flight
    group: int  # gathering: rows whose k steps are skipped together (a
    #             warp's 32 in bf16, a thread's 8 in f32)
    rows: int  # one-hot: rows a block scans (0: gathering)
    grid: tuple  # gathering: (row blocks, column blocks); one-hot:
    #              (row ranges, offsets, column blocks)
    smem: int  # dynamic shared memory of a block, bytes


# an H100 block's shared memory, bytes; the one-hot kernel's row range
SMEM_MAX = 232_448
ONEHOT_ROWS = 1024


def gather_gemm_tiles(rows, noff, cin, cout, onehot=False,
                      dtype=torch.bfloat16):
    """KB's / LA's (`onehot` False: up to `noff` sources a row) or KC's
    (`onehot`: one offset and source a row) blocking for `rows` output
    rows; BN: col_tile(cout) (the grid's last dimension).  Gathering: BM
    128 rows if that makes at least 4 waves of two blocks on each of an
    H100's 132 SMs, else 64, 2 BM threads; K elements a stage 64 in bf16,
    32 in f32; a 3-stage ring (2 at BN 128 and in 64-row blocks) of the
    gathered rows (BM, each padded by 16 bytes) and the weight rows (BK x
    BN, padded by 16 bytes), then the source table (noff words a row), the
    live offsets (32 words) and 2 bytes a row; with noff <= 8 the live
    rows sorted by the set of offsets they have a source at.  One-hot: a
    block per (ONEHOT_ROWS rows, offset, column tile) holding the slab
    w[o] (Cin x BN, rows padded by 16 bytes), row tiles of 128 rows with
    two in flight, else 64 with two, else 64 with one (the first that
    fits SMEM_MAX less 1 KB; each row of Cin padded by 16 bytes), and the
    range's list (8 bytes a row)."""
    if cin % 32 or cout % 32:
        raise ValueError(f"gather_gemm_tiles: widths must be multiples of "
                         f"32, got {cin} -> {cout}")
    esz = torch.finfo(dtype).bits // 8
    epv = 16 // esz
    bn = col_tile(cout)
    if onehot:
        def smem(bm, nbuf):
            return (cin * (bn + epv) + nbuf * bm * (cin + epv)) * esz \
                + ONEHOT_ROWS * 8

        bm, nbuf = next(((b, n) for b, n in ((128, 2), (64, 2), (64, 1))
                         if smem(b, n) <= SMEM_MAX - 1024), (64, 1))
        return GGTiles(bm, 2 * bm, bn, cin, nbuf, 0, ONEHOT_ROWS,
                       (-(-rows // ONEHOT_ROWS), noff, cout // bn),
                       smem(bm, nbuf))
    bk = 64 if esz == 2 else 32
    bm = 128 if -(-rows // 128) * (cout // bn) >= 4 * 2 * SMS else 64
    stages = 2 if bn == 128 or bm == 64 else 3
    smem = (stages * (bm * (bk + epv) + bk * (bn + epv)) * esz
            + noff * bm * 4 + 32 * 4 + 2 * bm)
    return GGTiles(bm, 2 * bm, bn, bk, stages, 32 if esz == 2 else 8, 0,
                   (-(-rows // bm), cout // bn), smem)


class WGSplit(NamedTuple):
    """The split of the weight-gradient kernels (csrc/wgrad.cuh): "onehot"
    (KF down / up) and "group" (LB)."""
    bm: int  # Cin columns of a dW tile
    bn: int  # Cout columns of a dW tile
    group: int  # offsets a block serves, one warp each
    rows_step: int  # rows a warp multiplies at a time (a ring stage)
    blocks: int  # per chunk: tiles x (K / group)
    chunks: int  # blocks per (tile, group); chunk c takes rows c * rpc ..
    rows_per_chunk: int  # a multiple of 32
    partial: tuple  # the f32 partial sums [chunks, K, Cin, Cout]


# pass 1's blocks at which the chunking aims: two waves of one 256-thread
# one-hot block an SM, four of two grouped blocks an SM
WGRAD_BLOCKS = {"onehot": 2 * SMS, "group": 4 * SMS}


def wgrad_split(kind, rows, k, cin, cout, dtype=torch.bfloat16):
    """The dW tiles, offset groups and row chunks of csrc/wgrad.cuh for a
    level of `rows` rows.  onehot (K = 8): a block is 8 warps, one per
    offset, each gathering its own offset's rows in 16-row stages; Cout
    tile col_tile(cout) in bf16, 64 or 32 in f32.  group (LB, K = 27 or
    8): 9 (of 27) or 8 offsets a block, one warp each, sharing 32-row
    steps of x; Cout tile 64 or 32 in bf16, 32 in f32.  Both: Cin tiles of
    32; chunks of a multiple of 32 rows, as many as bring the blocks to
    WGRAD_BLOCKS (at most one per 32 rows)."""
    if cin % 32 or cout % 32:
        raise ValueError(f"wgrad_split: widths must be multiples of 32, got "
                         f"{cin} -> {cout}")
    bf16 = torch.finfo(dtype).bits == 16
    if kind == "onehot":
        if k != 8:
            raise ValueError(f"wgrad_split: the one-hot maps have 8 offsets, "
                             f"got {k}")
        group, step = 8, 16
        bn = col_tile(cout) if bf16 else 64 if cout % 64 == 0 else 32
    elif kind == "group":
        if k not in (27, 8):
            raise ValueError(f"wgrad_split: LB takes K 27 or 8, got {k}")
        group, step = (9 if k == 27 else 8), 32
        bn = 64 if bf16 and cout % 64 == 0 else 32
    else:
        raise ValueError(f"wgrad_split: kind is 'onehot' or 'group', got "
                         f"{kind}")
    blocks = (cin // 32) * (cout // bn) * (k // group)
    steps = max(1, -(-rows // 32))
    chunks = max(1, min(steps, -(-WGRAD_BLOCKS[kind] // blocks)))
    rpc = -(-steps // chunks) * 32
    chunks = max(1, -(-rows // rpc))
    return WGSplit(32, bn, group, step, blocks, chunks, rpc,
                   (chunks, k, cin, cout))

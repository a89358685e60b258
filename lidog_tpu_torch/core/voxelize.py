"""Voxelization (`ME.utils.sparse_quantize` equivalent), host and device.

`voxelize_np` is a copy of the numpy path of lidog_tpu/core/voxelize.py:38
(one scan on the host, for the BEV preprocessing of data/bev.py; the C++
twin of the JAX package is not ported).

`voxelize_device` ports lidog_tpu/core/voxelize.py:71-118: quantize
metric points to voxel cells (`quantize`), keep one representative point
per voxel (the smallest original index), and emit the voxels in canonical
(batch, x, y, z) order into fixed-capacity padded arrays.  Outputs are
bitwise equal to the JAX version.  After quantization it is kernel LC
(K1, csrc/voxelize.cu: a stable LSD radix sort of the packed key's live
bits, Onesweep passes with a decoupled look-back, and a first-flag
compaction) through the wrapper `voxelize_cells`, which takes its plain
version `voxelize_plain` for CPU tensors.

The JAX version lexsorts (index, lo, hi); the plain version's one stable
sort of the combined 62-bit key (hi << 31 | lo) gives the same
permutation: ties keep input order, i.e. the smallest index first.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidog_tpu_torch.core import keys
from lidog_tpu_torch.ops import _cuda


class VoxelizedNP(NamedTuple):
    coords: np.ndarray  # int32 [M, 3]
    voxel_idx: np.ndarray  # int64 [M] representative point index
    inverse: np.ndarray  # int64 [P] point -> voxel index


def voxelize_np(points: np.ndarray, voxel_size: float) -> VoxelizedNP:
    """Quantize one scan on the host: unique voxel coords sorted
    lexicographically by (x, y, z), the representative (smallest) point
    index of each voxel, and the point -> voxel map."""
    disc = np.floor(points[:, :3] / voxel_size).astype(np.int32)
    h = (((disc[:, 0].astype(np.int64) + keys.COORD_HALF)
          << (2 * keys.COORD_BITS))
         | ((disc[:, 1].astype(np.int64) + keys.COORD_HALF) << keys.COORD_BITS)
         | (disc[:, 2].astype(np.int64) + keys.COORD_HALF))
    order = np.lexsort((np.arange(h.shape[0]), h))
    h_sorted = h[order]
    first = np.empty(h.shape[0], dtype=bool)
    if h.shape[0]:
        first[0] = True
        np.not_equal(h_sorted[1:], h_sorted[:-1], out=first[1:])
    uniq_pos = np.cumsum(first) - 1
    voxel_idx = order[first]
    inverse = np.empty(h.shape[0], dtype=np.int64)
    inverse[order] = uniq_pos
    return VoxelizedNP(disc[voxel_idx], voxel_idx, inverse)


def quantize(points, voxel_size: float):
    """Voxel cells int32 of float32 points [..., 3]: floor(x * (1 / voxel))
    with the reciprocal taken in float32.  lidog_tpu's callers jit the
    division with a constant voxel size, which XLA folds into this
    multiply (x / 0.05 and x * float32(1 / 0.05) floor apart at y = 4.2);
    voxelize_np and the native voxelizer divide."""
    inv = float(np.float32(1) / np.float32(voxel_size))
    return torch.floor(points * inv).to(torch.int32)


class VoxelizedDevice(NamedTuple):
    coords: torch.Tensor  # int32 [cap, 4] (batch, x, y, z), canonical order
    mask: torch.Tensor  # bool [cap]
    rep_idx: torch.Tensor  # int32 [cap] representative point index (or 0)
    inverse: torch.Tensor  # int32 [P] point -> voxel slot (-1 invalid/overflow)
    num_voxels: torch.Tensor  # int32 scalar
    overflow: torch.Tensor  # int32 scalar, voxels dropped to capacity
    # int32 scalar: 1 when a valid point's batch id is not below the batch
    # size in effect (the caller's, or MAX_BATCH), else 0 (a field of the
    # port's own; lidog_tpu's VoxelizedDevice ends at overflow)
    batch_breach: torch.Tensor


LAUNCHES = {"voxelize": 0}
# csrc/voxelize.cu: keys per tile, bits per LSD pass, radix digits
_TILE, _RADIX_BITS = 4096, 9
_RADIX = 1 << _RADIX_BITS
MAX_BATCH = 1 << 17  # keys.pack's batch field


class VoxelPasses(NamedTuple):
    """LC's pass plan for P points, which csrc/voxelize.cu runs."""
    passes: int  # stable LSD passes of _RADIX_BITS bits
    invalid_key: int  # the sort key of an invalid point
    tiles: int  # 4,096-key tiles
    work_ints: int  # the int32 work area: digit totals, tile counters, the
    #                 contract flag, look-back words


def _check_batch_size(batch_size) -> None:
    if not 1 <= batch_size <= MAX_BATCH:
        raise ValueError(f"voxelize: batch_size must lie in [1, 2^17], "
                         f"got {batch_size}")


def voxelize_passes(p: int, batch_size: int) -> VoxelPasses:
    """A valid point's sort key is c = hi * 2^26 + lo (keys.pack's words;
    39 bits of coordinates above the batch id).  With batch ids in [0, B)
    an invalid point sorts at B << 39, after every valid key, so the key
    has 39 + bit_length(B) live bits: 5 passes up to B = 63, 7 at most."""
    _check_batch_size(batch_size)
    inv = batch_size << 39
    passes = -(-inv.bit_length() // _RADIX_BITS)
    tiles = -(-p // _TILE)
    work = passes * _RADIX + passes + 2 + passes * tiles * _RADIX + tiles
    return VoxelPasses(passes, inv, tiles, work)


def voxelize_plain(disc, valid, batch_idx, capacity: int) -> VoxelizedDevice:
    """The voxelization of cells disc int32 [P, 3] with valid bool [P] and
    batch_idx int32 [P]: the plain version of LC (sort, first flags,
    cumsum slots, scatters); batch_breach flags a valid point whose batch
    id is past keys.pack's batch field (voxelize_cells raises first for a
    smaller batch size that the caller gave)."""
    dev = disc.device
    p = disc.shape[0]
    coords4 = torch.cat([batch_idx[:, None].to(torch.int32), disc], dim=1)
    hi, lo = keys.pack(coords4, valid)
    order = keys.sort_by_key(hi, lo)
    hi_s, lo_s = hi[order], lo[order]
    valid_s = hi_s != keys.INVALID_KEY
    prev_ne = torch.ones(p, dtype=torch.bool, device=dev)
    prev_ne[1:] = (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])
    first = valid_s & prev_ne
    uniq_pos = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    num_voxels = first.sum(dtype=torch.int32)
    in_cap = uniq_pos < capacity

    slot = torch.where(first & in_cap, uniq_pos,
                       torch.full_like(uniq_pos, capacity)).long()
    coords_out = torch.zeros(capacity + 1, 4, dtype=torch.int32, device=dev)
    coords_out[slot] = coords4[order]
    rep_out = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
    rep_out[slot] = order.to(torch.int32)
    mask = (torch.arange(capacity, dtype=torch.int32, device=dev)
            < torch.clamp(num_voxels, max=capacity))
    coords_out = torch.where(mask[:, None], coords_out[:capacity], 0)

    inv_sorted = torch.where(valid_s & in_cap, uniq_pos,
                             torch.full_like(uniq_pos, -1))
    inverse = torch.full((p,), -1, dtype=torch.int32, device=dev)
    inverse[order] = inv_sorted
    overflow = torch.clamp(num_voxels - capacity, min=0)
    breach = (valid & (batch_idx >= MAX_BATCH)).any().to(torch.int32)
    return VoxelizedDevice(coords_out, mask, rep_out[:capacity], inverse,
                           num_voxels, overflow, breach)


def voxelize_cells(disc, valid, batch_idx, capacity: int, *,
                   batch_size=None) -> VoxelizedDevice:
    """LC (csrc/voxelize.cu) for CUDA tensors, voxelize_plain for CPU
    tensors; arguments as voxelize_plain's.  batch_size B states that the
    batch id of every valid point lies below B (a negative one marks the
    point invalid, as keys.pack does); the key then has 39 + bit_length(B)
    live bits, which the sort's passes cover (voxelize_passes).  Left out,
    B is MAX_BATCH, keys.pack's whole batch field (7 passes on the card,
    where a small B takes 5).  A valid point whose batch id is B or more
    breaks the contract: a given batch_size makes the CPU raise; otherwise
    batch_breach comes out 1, and on the card, which cannot sort such a
    key, the voxels are not meaningful.  overflow is lidog_tpu's, max(num
    - capacity, 0), on both.  One call launches a memset, the key kernel,
    the passes and the compaction in order."""
    if disc.device.type == "cpu":
        if batch_size is not None:
            _check_batch_size(batch_size)
            if bool((valid & (batch_idx >= batch_size)).any()):
                raise ValueError(f"voxelize: a valid point's batch id is "
                                 f"not below batch_size {batch_size}")
        return voxelize_plain(disc, valid, batch_idx, capacity)
    name = "voxelize"
    dev = disc.device
    p = disc.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev}")
    for t, dt, shape, what in ((disc, torch.int32, (p, 3), "disc int32 [P, 3]"),
                               (valid, torch.bool, (p,), "valid bool [P]"),
                               (batch_idx, torch.int32, (p,),
                                "batch_idx int32 [P]")):
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous on {dev}")
    if capacity <= 0:
        raise ValueError(f"{name}: capacity must be positive")
    plan = voxelize_passes(p, MAX_BATCH if batch_size is None
                           else batch_size)
    coords = torch.empty(capacity, 4, dtype=torch.int32, device=dev)
    mask = torch.empty(capacity, dtype=torch.bool, device=dev)
    rep = torch.empty(capacity, dtype=torch.int32, device=dev)
    inverse = torch.empty(p, dtype=torch.int32, device=dev)
    stats = torch.empty(3, dtype=torch.int32, device=dev)
    num, overflow, breach = stats[0], stats[1], stats[2]
    if p == 0:
        for t in (coords, mask, rep, stats):
            t.zero_()
        return VoxelizedDevice(coords, mask, rep, inverse, num, overflow,
                               breach)
    # one scratch allocation: the work area (16-byte aligned), the [2, P]
    # u64 key and [2, P] int32 index ping-pong buffers
    work = -(-plan.work_ints // 4) * 4
    scratch = torch.empty(work + 6 * p, dtype=torch.int32, device=dev)
    base = scratch.data_ptr()
    _cuda.call(name, disc.data_ptr(), valid.data_ptr(), batch_idx.data_ptr(),
               base + 4 * work, base + 4 * work + 16 * p, base,
               coords.data_ptr(), mask.data_ptr(), rep.data_ptr(),
               inverse.data_ptr(), num.data_ptr(), overflow.data_ptr(),
               breach.data_ptr(), p, capacity, plan.passes, plan.invalid_key,
               work)
    LAUNCHES[name] += 1
    return VoxelizedDevice(coords, mask, rep, inverse, num, overflow, breach)


def voxelize_device(points, valid, batch_idx, voxel_size: float,
                    capacity: int, *, batch_size=None) -> VoxelizedDevice:
    """points float32 [P, 3], valid bool [P], batch_idx int32 [P] below
    batch_size, which may be left out (see voxelize_cells)."""
    disc = quantize(points[:, :3], voxel_size)
    return voxelize_cells(disc, valid.contiguous(),
                          batch_idx.to(torch.int32).contiguous(), capacity,
                          batch_size=batch_size)

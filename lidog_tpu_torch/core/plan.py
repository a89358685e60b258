"""Generic coordinate pyramid and kernel-map builder (the UNetPlan).

Port of lidog_tpu/core/plan.py:40-208.  From the batched stride-1 voxel
coordinates it builds, on the device and with static shapes, the
canonical (lex-sorted, padded) coordinate set of every stride level (1,
2, 4, 8, 16) and every kernel map MinkUNet34 needs: the k=5 stem and the
k=3 maps at each level, the k=2 s=2 down maps between adjacent levels and
the transposed up maps (each fine row's one parent, bucketed by its
offset in the parent cell).  Every sparse conv on this plan is the
gather-GEMM of ops/sparse_conv.py.  Every field is bitwise equal to
lidog_tpu's builder.

The build is plain torch (sort, cumsum, scatter), as lidog_tpu leaves it
to XLA.  The joins of `_query_map` go through keys.merge_lookup in chunks
of at most ~4M queries, as lidog_tpu's do: the stem map at the training
caps is 125 x 524,288 queries, whose unchunked join would hold GBs of
int64 keys and permutations.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Tuple

import numpy as np
import torch

from lidog_tpu_torch.core import keys
from lidog_tpu_torch.core.sparse import SparseTensor

NUM_LEVELS = 5  # strides 1, 2, 4, 8, 16
STEM_KERNEL = 5
MAX_QUERIES_PER_JOIN = 4_000_000


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    coords: torch.Tensor  # int32 [N, 4], canonical order
    mask: torch.Tensor  # bool [N]
    hi: torch.Tensor  # int32 [N] sorted packed keys
    lo: torch.Tensor  # int32 [N]
    stride: int = 1


@dataclasses.dataclass(frozen=True)
class UNetPlan:
    levels: Tuple[LevelPlan, ...]
    perm: torch.Tensor  # int32 [N0]: canonical row -> caller row
    kmaps: Dict[str, torch.Tensor]  # int32 [K, N_out] rows of the input level
    overflow: torch.Tensor  # int32 [NUM_LEVELS]: voxels dropped per level

    def level(self, i: int) -> LevelPlan:
        return self.levels[i]


def _offsets(kernel_size: int, stride: int) -> np.ndarray:
    """Hypercube offsets in raw-coordinate units, in itertools.product
    order (dz fastest), so weights interchange with the ZPlan model.  Odd
    kernels are centred ({-r..r} per axis), the even kernel 2 is {0, s}."""
    if kernel_size % 2 == 1:
        r = kernel_size // 2
        rng = range(-r, r + 1)
    else:
        assert kernel_size == 2
        rng = (0, 1)
    offs = np.array(list(itertools.product(rng, rng, rng)), dtype=np.int32)
    return offs * np.int32(stride)


def _query_map(level_in: LevelPlan, out_coords, out_mask, offsets):
    """nbr[k, i] = row of (out_coords[i] + offsets[k]) in level_in, or -1;
    the offsets' queries go through merge_lookup in joins of at most
    ~MAX_QUERIES_PER_JOIN rows."""
    k = offsets.shape[0]
    n = out_coords.shape[0]
    dev = out_coords.device
    chunk = max(1, min(k, MAX_QUERIES_PER_JOIN // max(n, 1)))
    parts = []
    for start in range(0, k, chunk):
        offs = torch.from_numpy(offsets[start:start + chunk]).to(dev)
        kc = offs.shape[0]
        q = out_coords[None, :, 1:4] + offs[:, None, :]  # [kc, N, 3]
        b = out_coords[None, :, :1].expand(kc, n, 1)
        qc = torch.cat([b, q], dim=-1).reshape(-1, 4)
        qh, ql = keys.pack(qc, out_mask[None, :].expand(kc, n).reshape(-1))
        idx = keys.merge_lookup(level_in.hi, level_in.lo, qh, ql)
        parts.append(idx.reshape(kc, n))
    return torch.cat(parts, dim=0)  # [K, N_out]


def _unique_compact(hi, lo, coords, cap: int):
    """Sort by key (ties in row order), flag first occurrences, compact
    into a [cap] bucket: (coords, mask, hi, lo, overflow)."""
    dev = hi.device
    order = keys.sort_by_key(hi, lo)
    hi_s, lo_s = hi[order], lo[order]
    valid_s = hi_s != keys.INVALID_KEY
    prev_ne = torch.ones_like(valid_s)
    prev_ne[1:] = (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])
    first = valid_s & prev_ne
    uniq_pos = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    num = first.sum(dtype=torch.int32)
    slot = torch.where(first & (uniq_pos < cap), uniq_pos,
                       torch.full_like(uniq_pos, cap)).long()
    coords_out = torch.zeros(cap + 1, 4, dtype=torch.int32, device=dev)
    coords_out[slot] = coords[order]
    mask = (torch.arange(cap, dtype=torch.int32, device=dev)
            < torch.clamp(num, max=cap))
    coords_out = torch.where(mask[:, None], coords_out[:cap], 0)
    hi_out, lo_out = keys.pack(coords_out, mask)
    return coords_out, mask, hi_out, lo_out, torch.clamp(num - cap, min=0)


def _floor_align(xyz, s: int):
    return torch.div(xyz, s, rounding_mode="floor") * s


def build_unet_plan(coords, mask, caps: Tuple[int, ...]) -> UNetPlan:
    """The coordinate pyramid and kernel maps of MinkUNet34 (its k=5 stem
    and 5 levels, lidog_tpu's defaults).

    coords: int32 [N, 4] batched stride-1 voxel coords (any row order);
    mask: bool [N]; caps: per-level capacities, caps[0] == N."""
    if len(caps) != NUM_LEVELS or caps[0] != coords.shape[0]:
        raise ValueError(f"caps must hold {NUM_LEVELS} capacities, the "
                         f"first the input's {coords.shape[0]} rows; got "
                         f"{tuple(caps)}")
    dev = coords.device
    coords = coords.to(torch.int32)

    # level 0: the input rows in canonical order
    hi0, lo0 = keys.pack(coords, mask)
    perm = keys.sort_by_key(hi0, lo0)
    hi0, lo0 = hi0[perm], lo0[perm]
    mask0 = hi0 != keys.INVALID_KEY
    coords0 = torch.where(mask0[:, None], coords[perm], 0)
    levels = [LevelPlan(coords0, mask0, hi0, lo0, stride=1)]
    overflow = [torch.zeros((), dtype=torch.int32, device=dev)]

    # coarser levels: floor-aligned parent coords, unique, compact
    for i in range(1, NUM_LEVELS):
        s = 1 << i
        prev = levels[i - 1]
        pcoords = torch.cat([prev.coords[:, :1],
                             _floor_align(prev.coords[:, 1:4], s)], dim=1)
        phi, plo = keys.pack(pcoords, prev.mask)
        c, m, h, l, ov = _unique_compact(phi, plo, pcoords, caps[i])
        levels.append(LevelPlan(c, m, h, l, stride=s))
        overflow.append(ov)

    kmaps: Dict[str, torch.Tensor] = {}
    kmaps["stem"] = _query_map(levels[0], levels[0].coords, levels[0].mask,
                               _offsets(STEM_KERNEL, 1))
    for i in range(NUM_LEVELS):
        kmaps[f"conv3_l{i}"] = _query_map(levels[i], levels[i].coords,
                                          levels[i].mask, _offsets(3, 1 << i))
    for i in range(NUM_LEVELS - 1):
        kmaps[f"down_l{i}"] = _query_map(levels[i], levels[i + 1].coords,
                                         levels[i + 1].mask,
                                         _offsets(2, 1 << i))
    # up maps: each fine row's parent at level i+1, in the row of its
    # offset in the parent cell (so the up conv is the same gather-GEMM)
    for i in range(NUM_LEVELS - 1):
        fine, coarse = levels[i], levels[i + 1]
        parent_xyz = _floor_align(fine.coords[:, 1:4], 1 << (i + 1))
        pcoords = torch.cat([fine.coords[:, :1], parent_xyz], dim=1)
        ph, pl = keys.pack(pcoords, fine.mask)
        parent_idx = keys.merge_lookup(coarse.hi, coarse.lo, ph, pl)
        d = torch.div(fine.coords[:, 1:4] - parent_xyz, 1 << i,
                      rounding_mode="floor")  # each axis in {0, 1}
        off_id = d[:, 0] * 4 + d[:, 1] * 2 + d[:, 2]
        k_ids = torch.arange(8, dtype=torch.int32, device=dev)[:, None]
        kmaps[f"up_l{i}"] = torch.where(
            (off_id[None, :] == k_ids) & fine.mask[None, :],
            parent_idx[None, :], -1).to(torch.int32)

    return UNetPlan(levels=tuple(levels), perm=perm.to(torch.int32),
                    kmaps=kmaps, overflow=torch.stack(overflow))


def input_tensor(plan: UNetPlan, feats) -> SparseTensor:
    """Caller-order features [N0, C] as the canonical level-0 tensor."""
    l0 = plan.level(0)
    f = feats[plan.perm.long()]
    f = f * l0.mask[:, None].to(f.dtype)
    return SparseTensor(coords=l0.coords, feats=f, mask=l0.mask, stride=1)

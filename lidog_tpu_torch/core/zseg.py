"""Segmented z-fused plan: per-scan segments + ghost-augmented levels.

Port of lidog_tpu/core/zseg.py (ZLevel, ZPlan, the column-table sweeps and
ZSegPlanBuilder with the occupancy or the feature stem, for unique or
sortless input).  Every ZPlan field is bitwise equal to the JAX builder's.

Per level the plan holds the augmented coordinate set (real voxels plus
ghost rows at z-gaps that are nonzero gather targets of the column-fused
conv, ops/zconv.py) in segmented canonical order: scan b owns rows
[b*capA, (b+1)*capA).  Kernel maps: conv9 (k=3, 9 xy taps), down8 +
parent/off (k=2 s=2 pair), and the fused 5x5x5 stem occupancy, or for
in_channels > 1 the stem's 125 source-row maps (`stem125`).

On the card the whole build runs as hand-written kernels.  Per level the
column tables (csrc/zseg_tables.cu): KV (`column_grid`, the y-dilated
column grid and slot stamps), KW (`real_words`, the real z-bit words), KX
(`assemble_aug`, the aug words and per-scan starts) and KY (`emit_rows`,
the level's rows and maps); then the sweeps downstream of them: KT
(`pos3_lookup`), KU (`_build_packed`, the packed y-neighbourhood table), KR
(`stem_conv9_packed`) and KS (`conv9_packed`) in csrc/zseg_sweeps.cu, and
KQ (`stem_feat125_packed`, csrc/stem_feat125.cu).  Each wrapper takes its
plain version (`*_plain`) for CPU tensors; on CUDA tensors the builder
launches only these kernels and the fills of its own buffers, with no
host sync (the overflow terms are summed on the device).

What the JAX version shaped around the TPU is not carried over, only its
results: the 512 B wide-row grid lookup (GRID_ROW_W), the per-scan
lax.map segmenting and LIDOG_TPU_SEG_LOOKUP.  Here a grid lookup is one
int32 gather, and the sweeps run over all segments at once; a row's
segment is its index // segment capacity, so no map reaches another scan.

The column grid, the real words (`real16`: 14 words and 2 zero pad
words a slot), the aug words (`aug16`), the packed y-neighbourhood table
and the own-column positions (`pos3`) are int32, as lidog_tpu's, their
words the uint32 bits read as int32, every table row a multiple of 16
bytes (the packed rows padded to a multiple of 8 words).  The plain
versions widen a fetched row to int64 words holding uint32 values
(core/bitgrid.py); internal index arithmetic is int64; outputs are cast
to the JAX dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from lidog_tpu_torch.core.bitgrid import (
    U32, ZC, ZWORDS, _cell_of, _compress_even_bits, _rank_from_row,
    _word_at, popcount32,
)
from lidog_tpu_torch.core.sparse import SparseTensor
from lidog_tpu_torch.ops import _cuda

NUM_LEVELS = 5
ZMAX = ZWORDS * 32
LAUNCHES = {"stem_feat125": 0, "stem_conv9_packed": 0, "conv9_packed": 0,
            "pos3_lookup": 0, "build_packed": 0, "column_grid": 0,
            "real_words": 0, "assemble_aug": 0, "emit_rows": 0}
# KU's and KX's launches by plan level (counted beside LAUNCHES)
LEVEL_LAUNCHES = {"build_packed": [0] * NUM_LEVELS,
                  "assemble_aug": [0] * NUM_LEVELS}


@dataclasses.dataclass(frozen=True)
class ZLevel:
    coords: torch.Tensor  # int32 [B*capA, 4] augmented, segmented order
    real: torch.Tensor  # bool [B*capA] real voxels (the op/loss mask)
    valid: torch.Tensor  # bool [B*capA] real | ghost rows
    zup: torch.Tensor  # bool [B*capA] row j+1 is (same column, z+s)
    zdn: torch.Tensor  # bool [B*capA]
    stride: int = 1


@dataclasses.dataclass(frozen=True)
class ZPlan:
    levels: Tuple[ZLevel, ...]
    # conv9_l{i} [9, B*capA_i]; down8_l{i} [8, B*capA_{i+1}];
    # parent_l{i}, off_l{i} [B*capA_i]; stem_occ [B*capA_0, 125] bf16, or
    # (feature stem) stem125 [125, B*capA_0] int32 source rows
    kmaps: Dict[str, torch.Tensor]
    pos: torch.Tensor  # int32 [N_in] input row -> level-0 row (-1 drop)
    overflow: torch.Tensor  # int32 [1 + NUM_LEVELS]
    # sortless input only: int32 [B*capA_0], the representative (minimum)
    # input row of each level-0 row, -1 on ghost/pad rows
    rep: Optional[torch.Tensor] = None
    num_batches: int = 1

    def level(self, i: int) -> ZLevel:
        return self.levels[i]

    def scatter_rows(self, values, fill=0):
        """Scatter per-input-row values into the level-0 augmented layout
        (`fill` elsewhere; lidog_tpu/core/zseg.py:93)."""
        return _scatter_rows(self.pos, values, self.levels[0].coords.shape[0],
                             fill)


# ---------------------------------------------------------------------------
# Column tables (lidog_tpu/core/zseg.py:106-423)
# ---------------------------------------------------------------------------


def _cumsum_excl_axis1(x2d):
    """Exclusive int64 cumsum along axis 1."""
    x = x2d.long()
    return torch.cumsum(x, dim=1) - x


def _grid_lookup(grid_flat, b, gx, gy, ok, g: int):
    """Dense-grid column id (int64) of cell (b, gx, gy), -1 where not
    ok."""
    flat = torch.where(ok, (b.long() * g + gx) * g + gy, 0)
    return torch.where(ok, grid_flat[flat].long(), -1)


def _zdil_words(u):
    """z+-1 dilation of z-bit word rows on the last axis (LSB first)."""
    z = torch.zeros_like(u[..., :1])
    up = ((u << 1) & U32) | torch.cat([z, u[..., :-1] >> 31], dim=-1)
    dn = (u >> 1) | torch.cat([(u[..., 1:] << 31) & U32, z], dim=-1)
    return up | dn


_HALF = ZWORDS // 2
_I1 = [2 * k - _HALF for k in range(ZWORDS)]


def _zpair_words(u):
    """Coarsen z-bit word rows one level: pairwise bit OR + ZC recentering."""
    comp = _compress_even_bits(u | (u >> 1))
    cols = []
    for i1 in _I1:
        lo = comp[..., i1] if 0 <= i1 < ZWORDS else torch.zeros_like(comp[..., 0])
        hi = (comp[..., i1 + 1] if 0 <= i1 + 1 < ZWORDS
              else torch.zeros_like(comp[..., 0]))
        cols.append(lo | (hi << 16))
    return torch.stack(cols, dim=-1)


def _rows_or_miss(table, idx):
    """table [cap, R]; idx [n] (-1 / out of range = miss -> zero row)."""
    cap = table.shape[0]
    hit = (idx >= 0) & (idx < cap)
    return table[idx.clamp(0, cap - 1)] * hit[:, None].to(table.dtype)


def _wrap32(x):
    """int64 values -> int32 by their low 32 bits (two's complement): the
    int32 tables hold uint32 words and int32 sums as lidog_tpu's do."""
    return (((x + 2**31) & U32) - 2**31).to(torch.int32)


def _u32(t):
    """An int32 table's rows widened to int64, each word as its uint32
    value (the starts and counts, which are >= 0, keep theirs)."""
    return t.long() & U32


REAL_W = 16  # words of a real-word row: ZWORDS and 2 zero pad words


def _real16(words):
    """int64 [slots, ZWORDS] uint32 values -> the int32 real-word table
    [slots, REAL_W] (lidog_tpu's real16: the pad words 0)."""
    pad = words.new_zeros(words.shape[0], REAL_W - ZWORDS)
    return _wrap32(torch.cat([words, pad], dim=1))


def _pack_bxy(b, gx, gy):
    return (b.long() << 24) | (gx.long() << 12) | gy.long()


def _unpack_bxy(p):
    return p >> 24, (p >> 12) & 4095, p & 4095


def _grid_from_has(has2, num_batches: int, ccap: int):
    """has2 [B, g*g] 0/1 -> (cid_grid [B*g*g] int32 of GLOBAL segmented
    column ids or -1, lidog_tpu's dtype; column overflow scalar)."""
    cloc = _cumsum_excl_axis1(has2)
    ncols = cloc[:, -1] + has2[:, -1].long()
    base = (torch.arange(num_batches, device=has2.device) * ccap)[:, None]
    cid_grid = torch.where((has2 > 0) & (cloc < ccap), cloc + base, -1)
    col_over = torch.clamp(ncols - ccap, min=0).sum()
    return cid_grid.reshape(-1).to(torch.int32), col_over


def _dilate_y(has2, g: int, r: int):
    """OR the has-grid over gy-r..gy+r (gy is the minor axis)."""
    h = has2.reshape(has2.shape[0], g, g)
    out = h.clone()
    for d in range(1, r + 1):
        out[:, :, :-d] |= h[:, :, d:]
        out[:, :, d:] |= h[:, :, :-d]
    return out.reshape(has2.shape[0], g * g)


def _y_adjacency(col_bxy, col_valid):
    """adj[s]: slot s+1 is (same b, gx, gy+1)."""
    nxt = (col_bxy[1:] == col_bxy[:-1] + 1) & col_valid[1:] & col_valid[:-1]
    return torch.cat([nxt, nxt.new_zeros(1)])


def _shift_up(x, adj):
    """Row of slot s+1 (the gy+1 cell), masked by adjacency."""
    nx = torch.cat([x[1:], torch.zeros_like(x[:1])], dim=0)
    return nx * adj[:, None].to(x.dtype)


def _shift_dn(x, adj):
    adn = torch.cat([adj.new_zeros(1), adj[:-1]])
    pv = torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)
    return pv * adn[:, None].to(x.dtype)


def column_grid_plain(coords, valid, num_batches: int, grid_half: int,
                      level: int, ccap: int, r: int, *, overflow,
                      cap_real: int = -1):
    """The y-dilated column set of a level's source rows (plain version of
    KV: lidog_tpu/core/zseg.py:271-300 and __call__:863-914).

    coords int32 [N, 4] (raw, or a finer level's rows: only coords >> level
    is read), valid bool [N]; the level's cells g x g, g = 2*grid_half >>
    level, dilated along gy by +-r.  Returns (grid_d int32 [B*g*g] GLOBAL
    segmented column id or -1, vox_cid int64 [N] each row's column or -1,
    col_bxy int64 [B*ccap] packed (b, gx, gy) of each slot (0 where empty),
    col_valid bool [B*ccap]).  Adds the rows lost to the column cap and the
    columns past it to overflow[1 + level], and with cap_real >= 0 (unique
    level-0 input) the real voxels past cap_real per scan to
    overflow[0]."""
    B, dev = num_batches, coords.device
    g = (2 * grid_half) >> level
    b_, gx, gy, bz, inb = _cell_of(coords, grid_half, level)
    b_, gx, gy = b_.long(), gx.long(), gy.long()
    ok = valid & inb
    gxc = gx.clamp(0, g - 1)
    gyc = gy.clamp(0, g - 1)
    bsafe = torch.where(ok, b_, 0)
    if cap_real >= 0:
        # overflow[0]: level-0 real voxels beyond caps_real[0]
        nreal_b = torch.zeros(B + 1, dtype=torch.long, device=dev)
        nreal_b.index_add_(0, torch.where(ok, b_, B), torch.ones_like(b_))
        overflow[0] += torch.clamp(nreal_b[:B] - cap_real, min=0).sum().to(
            torch.int32)
    cells = B * g * g
    has = torch.zeros(cells + 1, dtype=torch.int8, device=dev)
    has[torch.where(ok, (bsafe * g + gxc) * g + gyc, cells)] = 1
    has_d = _dilate_y(has[:cells].reshape(B, g * g), g, r)
    grid_d, col_over_d = _grid_from_has(has_d, B, ccap)
    # one lookup per voxel: an occupied column's whole +-r y-window
    # is dilated and contiguous, so slot of (gx, gy+dy) is cid + dy
    vox_cid = _grid_lookup(grid_d, bsafe, gxc, gyc, ok, g)
    sink = B * ccap
    col_bxy = torch.full((sink + 1,), -1, dtype=torch.long, device=dev)
    pack0 = _pack_bxy(bsafe, gxc, gyc)
    seg0 = bsafe * ccap
    for dy in range(-r, r + 1):
        gyn = gyc + dy
        okn = (ok & (gyn >= 0) & (gyn < g) & (vox_cid >= 0)
               & (vox_cid + dy >= seg0) & (vox_cid + dy < seg0 + ccap))
        col_bxy[torch.where(okn, vox_cid + dy, sink)] = pack0 + dy
    col_bxy = col_bxy[:sink]
    col_valid = col_bxy >= 0
    col_bxy = col_bxy.clamp(min=0)
    vox_drop = (ok & (vox_cid < 0)).sum()
    overflow[1 + level] += (vox_drop + col_over_d).to(torch.int32)
    return grid_d, vox_cid, col_bxy, col_valid


def real_words_plain(level: int, num_batches: int, ccap: int, grid_half: int,
                     *, overflow, coords=None, valid=None, vox_cid=None,
                     unique: bool = True, cap_real: int = 0, col_bxy=None,
                     col_valid=None, fine_grid=None, fine_real=None):
    """The real z-bit words of each column slot (plain version of KW,
    lidog_tpu/core/zseg.py:916-979, _zpair_words:234): int32 [B*ccap,
    REAL_W], lidog_tpu's real16 (the uint32 bits of ZWORDS words read as
    int32, then 2 zero pad words).

    Level 0 stamps the source rows (coords, valid, their vox_cid): unique
    input scatter-adds the bits; sortless input (unique=False) sets them
    idempotently and adds the deduped voxels past cap_real per scan to
    overflow[0].  Levels 1-4 OR the 4 child columns of each slot (col_bxy,
    col_valid) in the finer level's tables (fine_grid, fine_real) and
    coarsen the words one z level; fine_real is the finer level's int32
    table."""
    B, dev = num_batches, (coords if level == 0 else col_bxy).device
    sink = B * ccap
    if level == 0:
        _, _, _, bz, inb = _cell_of(coords, grid_half, 0)
        bz = bz.long()
        ok = valid & inb
        if unique:
            # scatter-add voxel bits: unique (b, x, y, z) => add == OR
            word = (bz >> 5).clamp(0, ZWORDS - 1)
            bit = torch.where(ok, 1 << (bz & 31), 0)
            cslot = torch.where(vox_cid >= 0, vox_cid, sink)
            real_w = torch.zeros(sink + 1, ZWORDS, dtype=torch.long,
                                 device=dev)
            real_w.index_put_((cslot, word), bit, accumulate=True)
            return _real16(real_w[:sink] & U32)
        # sortless input: an idempotent per-z byte stamp, then 32 bytes
        # -> one word, one bit position at a time (no int64 copy of the
        # whole stamp)
        cslot = torch.where(ok & (vox_cid >= 0), vox_cid, sink)
        zbytes = torch.zeros(sink + 1, ZMAX, dtype=torch.int8, device=dev)
        zbytes[cslot, bz.clamp(0, ZMAX - 1)] = 1
        zbytes = zbytes[:sink].reshape(sink, ZWORDS, 32)
        real_w = torch.zeros(sink, ZWORDS, dtype=torch.long, device=dev)
        for k in range(32):
            real_w |= zbytes[:, :, k].long() << k
        # overflow[0] on the deduped voxel count
        nreal_b = popcount32(real_w).sum(-1).reshape(B, ccap).sum(1)
        overflow[0] += torch.clamp(nreal_b - cap_real, min=0).sum().to(
            torch.int32)
        return _real16(real_w)
    # coarse real words from the fine table: 4 child column fetches +
    # pairwise z OR
    f_g = (2 * grid_half) >> (level - 1)
    bC, gxC, gyC = _unpack_bxy(col_bxy)
    acc = torch.zeros(sink, ZWORDS, dtype=torch.long, device=dev)
    for cx in (0, 1):
        for cy in (0, 1):
            gxf = 2 * gxC + cx
            gyf = 2 * gyC + cy
            okf = col_valid & (gxf < f_g) & (gyf < f_g)
            cidf = _grid_lookup(fine_grid, bC, gxf.clamp(0, f_g - 1),
                                gyf.clamp(0, f_g - 1), okf, f_g)
            acc = acc | _u32(_rows_or_miss(fine_real, cidf)[:, :ZWORDS])
    return _real16(_zpair_words(acc))


def assemble_aug_plain(real_w, col_bxy, col_valid, grid_d, num_batches: int,
                       g: int, ccap: int, cap_a: int, *, level: int,
                       overflow):
    """Ghost/aug words per dilated slot: 2 x-neighbour fetches + y shifts
    (plain version of KX, lidog_tpu/core/zseg.py:335).

    real_w is the int32 real-word table [B*ccap, REAL_W] (KW's).
    ghost = zdil(own) & ~own & OR(3x3 neighbourhood real words).  Returns
    (aug16 int32 [B*ccap, ZWORDS+2] = words + GLOBAL start + count, aug
    rows per scan int64 [B]); adds the rows past cap_a to
    overflow[1 + level]."""
    b, gx, gy = _unpack_bxy(col_bxy)
    own = _u32(real_w[:, :ZWORDS])
    adj = _y_adjacency(col_bxy, col_valid)
    yor3 = own | _shift_up(own, adj) | _shift_dn(own, adj)
    nb_or = yor3
    for dx in (-1, 1):
        gxn = gx + dx
        okn = col_valid & (gxn >= 0) & (gxn < g)
        cidn = _grid_lookup(grid_d, b, gxn.clamp(0, g - 1), gy, okn, g)
        nb_or = nb_or | _rows_or_miss(yor3, cidn)
    aug = own | (_zdil_words(own) & ~own & nb_or)
    aug = aug * col_valid[:, None].long()
    popc = popcount32(aug).sum(-1)
    popc2 = popc.reshape(num_batches, ccap)
    counts_b = popc2.sum(1)
    seg = torch.arange(num_batches, device=aug.device)[:, None] * cap_a
    start = (_cumsum_excl_axis1(popc2) + seg).reshape(-1)
    aug16 = _wrap32(torch.cat([aug, start[:, None], popc[:, None]], dim=1))
    overflow[1 + level] += torch.clamp(counts_b - cap_a, min=0).sum().to(
        torch.int32)
    return aug16, counts_b


def _build_packed_plain(real_w, aug16, col_bxy, col_valid,
                        num_batches: int, ccap: int, cap_a: int, r: int,
                        aug_r: int = 1, level: int = 0):
    """Per-slot y-neighbourhood row, built by validated slot shifts (plain
    version of KU, lidog_tpu/core/zseg.py:378) from the int32 real-word
    table (KW's) and aug16 (KX's): int32 [B*ccap, packed_width(r, aug_r)]
    of [real words of gy-r..gy+r | (aug words +
    LOCAL start) of gy-aug_r..gy+aug_r | zeros to a multiple of 8 words].
    r < 0 leaves out the real slabs (the conv9 sweep of levels > 0); the
    feature-stem sweep (stem_feat125_packed) passes aug_r = r.
    aug_r <= max(r, 1): a neighbour column within the dilation radius sits
    exactly dy consecutive slots away.  `level` (the plan level) only
    names the kernel wrapper's per-level count."""
    b = torch.arange(num_batches * ccap, device=real_w.device) // ccap
    real = _u32(real_w[:, :ZWORDS])
    m_aug = aug16[:, :ZWORDS + 1].long()
    m_aug[:, ZWORDS] += torch.where(col_valid, -b * cap_a, 0)
    adj = _y_adjacency(col_bxy, col_valid)

    def at_dy(x, dy):
        out = x
        for _ in range(abs(dy)):
            out = _shift_up(out, adj) if dy > 0 else _shift_dn(out, adj)
        return out

    assert aug_r <= max(r, 1), "aug shifts must stay within the dilation"
    slabs = [at_dy(real, dy) for dy in range(-r, r + 1)]
    slabs += [at_dy(m_aug, dy) for dy in range(-aug_r, aug_r + 1)]
    width = packed_width(r, aug_r)
    pad = width - sum(t.shape[1] for t in slabs)
    slabs.append(m_aug.new_zeros(m_aug.shape[0], pad))
    return _wrap32(torch.cat(slabs, dim=1))


def packed_width(r: int, aug_r: int) -> int:
    """Words of a packed row: the real and aug slabs, padded to a multiple
    of 8 (lidog_tpu's _build_packed pad)."""
    w = max(2 * r + 1, 0) * ZWORDS + (2 * aug_r + 1) * (ZWORDS + 1)
    return -(-w // 8) * 8


_KU_MAX_R = 4  # KU's largest shift (csrc/zseg_sweeps.cu MAX_R)


def _build_packed(real_w, aug16, col_bxy, col_valid, num_batches: int,
                  ccap: int, cap_a: int, r: int, aug_r: int = 1,
                  level: int = 0):
    """KU (csrc/zseg_sweeps.cu) for CUDA tensors, the plain version for CPU
    tensors; arguments as the plain version's."""
    if real_w.device.type == "cpu":
        return _build_packed_plain(real_w, aug16, col_bxy, col_valid,
                                   num_batches, ccap, cap_a, r, aug_r)
    name = "build_packed"
    dev = _require_cuda(name, real_w, aug16, col_bxy, col_valid)
    slots = num_batches * ccap
    width = packed_width(r, aug_r)
    _require(name, (
        (r >= -1 and 0 <= aug_r <= max(r, 1) and max(r, aug_r) <= _KU_MAX_R,
         f"needs r >= -1 and 0 <= aug_r <= max(r, 1) <= {_KU_MAX_R}, got "
         f"{r}, {aug_r}"),
        _real_ok(real_w, slots),
        (aug16.dtype == torch.int32
         and tuple(aug16.shape) == (slots, ZWORDS + 2),
         f"aug16 must be int32 [{slots}, {ZWORDS + 2}]"),
        (col_bxy.dtype == torch.int64 and tuple(col_bxy.shape) == (slots,),
         f"col_bxy must be int64 [{slots}]"),
        (col_valid.dtype == torch.bool and tuple(col_valid.shape) == (slots,),
         f"col_valid must be bool [{slots}]"),
        (0 <= level < NUM_LEVELS, f"level must lie in [0, {NUM_LEVELS})"),
    ))
    _require(name, ((slots * width < 2**31, "table too large for int32 "
                     "indices"),))
    out = torch.empty(slots, width, dtype=torch.int32, device=dev)
    if slots:
        _cuda.call(name, real_w.data_ptr(), aug16.data_ptr(),
                   col_bxy.data_ptr(), col_valid.data_ptr(), out.data_ptr(),
                   slots, ccap, cap_a, r, aug_r, width)
        LAUNCHES[name] += 1
        LEVEL_LAUNCHES[name][level] += 1
    return out


def _real_ok(real_w, slots=None, name="real_w"):
    """(ok, message) of a kernel's check of an int32 real-word table
    [slots, REAL_W] (any number of slots where slots is None)."""
    ok = (real_w.dtype == torch.int32 and real_w.dim() == 2
          and real_w.shape[1] == REAL_W
          and (slots is None or real_w.shape[0] == slots))
    return ok, f"{name} must be int32 [{slots or 'slots'}, {REAL_W}]"


def _bit_at(words, bz):
    """Bit bz of [..., ZWORDS] words (0/1 int64)."""
    return (_word_at(words, bz >> 5) >> (bz & 31).long()) & 1


def _rank_in_slab(words, startv, bz, ok):
    """Aug-slab rank: position = start + rank of bit bz, -1 on miss."""
    okz = ok & (bz >= 0) & (bz < ZMAX)
    rank, exists = _rank_from_row(words, bz.clamp(0, ZMAX - 1))
    return torch.where(okz & exists, startv + rank, -1)


def _sweep_rows(cid_grid, packed, coords, valid, g, ccap, nb, grid_half,
                level, dxs):
    """Per query row (segment-aligned, [B*cap_q]) and each dx, the fetched
    packed row of column (gx+dx, gy) and whether it exists."""
    n = coords.shape[0]
    bq = torch.arange(n, device=coords.device) // (n // nb)
    gx0 = (coords[:, 1] >> level) + (grid_half >> level)
    gy0 = (coords[:, 2] >> level) + (grid_half >> level)
    bz0 = ((coords[:, 3] >> level) + ZC).long()
    for dx in dxs:
        gxn = gx0 + dx
        okc = valid & (gxn >= 0) & (gxn < g)
        cid = _grid_lookup(cid_grid, bq, gxn, gy0, okc, g)
        cid = torch.where(cid >= 0, cid - bq * ccap, -1)
        hit = okc & (cid >= 0) & (cid < ccap)
        row = _u32(packed[bq * ccap + cid.clamp(0, ccap - 1)])
        yield dx, bz0, hit, row


def _aug_ranks(row, aug_off, bz0, hit, cap_a):
    """The three dy ranks (dy = -1, 0, 1) of one fetched packed row."""
    out = []
    for dyi in range(3):
        off = aug_off + (ZWORDS + 1) * dyi
        idx = _rank_in_slab(row[:, off:off + ZWORDS], row[:, off + ZWORDS],
                            bz0, hit)
        out.append(torch.where((idx >= 0) & (idx < cap_a), idx, -1))
    return out


def _globalize(c9, nb, cap_a):
    """Local segment ranks [9, B*cap] -> global rows (-1 stays)."""
    seg = torch.arange(c9.shape[1], device=c9.device) // (c9.shape[1] // nb)
    return torch.where(c9 >= 0, c9 + seg * cap_a, -1).to(torch.int32)


def stem_conv9_plain(cid_grid, packed, coords, valid, g: int, ccap: int,
                     cap_a: int, r: int, nb: int, grid_half: int = 0,
                     level: int = 0):
    """Fused stem occupancy + conv9 sweep, plain version of KR
    (lidog_tpu/core/zseg.py:446).

    Returns (occ [N, (2r+1)^3] bf16 in (dx, dy, dz) order, dz fastest;
    conv9 [9, N] global rows)."""
    aug_off = (2 * r + 1) * ZWORDS
    occ_all, ranks = [], []
    for dx, bz0, hit, row in _sweep_rows(
            cid_grid, packed, coords, valid, g, ccap, nb, grid_half, level,
            range(-r, r + 1)):
        # the 2r+1 dz bits span at most two adjacent words: shift the
        # window into the low bits once per slab, then mask per dz
        lo_i = bz0 - r
        wlo = lo_i >> 5
        shl = lo_i & 31
        for dyi in range(2 * r + 1):
            slab = row[:, ZWORDS * dyi:ZWORDS * (dyi + 1)]
            w0 = _word_at(slab, wlo)
            w1 = _word_at(slab, wlo + 1)
            win = (w0 >> shl) | torch.where(shl == 0, 0,
                                            (w1 << (32 - shl)) & U32)
            for k in range(2 * r + 1):
                bz = lo_i + k
                okz = hit & (bz >= 0) & (bz < ZMAX)
                occ_all.append(torch.where(okz, (win >> k) & 1, 0))
        if abs(dx) <= 1:
            ranks += _aug_ranks(row, aug_off, bz0, hit, cap_a)
    occ = torch.stack(occ_all, dim=1).to(torch.bfloat16)
    return occ, _globalize(torch.stack(ranks, dim=0), nb, cap_a)


def conv9_plain(cid_grid, packed, coords, valid, g: int, ccap: int,
                cap_a: int, nb: int, grid_half: int = 0, level: int = 0):
    """conv9 kernel map from the aug-only packed table: 3 fetches per row
    (plain version of KS, lidog_tpu/core/zseg.py:631)."""
    ranks = []
    for _, bz0, hit, row in _sweep_rows(
            cid_grid, packed, coords, valid, g, ccap, nb, grid_half, level,
            (-1, 0, 1)):
        ranks += _aug_ranks(row, 0, bz0, hit, cap_a)
    return _globalize(torch.stack(ranks, dim=0), nb, cap_a)


def stem_feat125_plain(cid_grid, packed, coords, valid, g: int, ccap: int,
                       cap_a: int, r: int, nb: int, grid_half: int = 0,
                       level: int = 0):
    """Feature-stem sweep, plain version (lidog_tpu/core/zseg.py:540): the
    source row of every (dx, dy, dz) neighbour in the (2r+1)^3 window.

    Needs the packed table built with aug_r = r.  Per (dx, dy) column one
    rank at bz and 2r single-bit reads resolve all 2r+1 z positions:
    rank(bz+d) = rank(bz) + bits in [bz, bz+d), and symmetrically below.
    Returns (nbr [(2r+1)^3, N], conv9 [9, N]) int32 global rows (-1 miss)
    in (dx, dy, dz) order, dz fastest."""
    aug_off = (2 * r + 1) * ZWORDS
    nbrs, c9 = [], []
    for dx, bz0, hit, row in _sweep_rows(
            cid_grid, packed, coords, valid, g, ccap, nb, grid_half, level,
            range(-r, r + 1)):
        for dyi in range(2 * r + 1):
            off = aug_off + (ZWORDS + 1) * dyi
            words, startv = row[:, off:off + ZWORDS], row[:, off + ZWORDS]
            rank0, ex0 = _rank_from_row(words, bz0.clamp(0, ZMAX - 1))
            bit = {0: ex0.long()}
            for d in range(1, r + 1):
                bit[d] = _bit_at(words, (bz0 + d).clamp(0, ZMAX - 1))
                bit[-d] = _bit_at(words, (bz0 - d).clamp(0, ZMAX - 1))
            rank = {0: rank0.long()}
            for d in range(1, r + 1):
                rank[d] = rank[d - 1] + bit[d - 1]
                rank[-d] = rank[-(d - 1)] - bit[-d]
            for dz in range(-r, r + 1):
                bzd = bz0 + dz
                okz = hit & (bzd >= 0) & (bzd < ZMAX) & (bit[dz] == 1)
                idx = startv + rank[dz]
                nbrs.append(torch.where(okz & (idx >= 0) & (idx < cap_a),
                                        idx, -1))
                if abs(dx) <= 1 and abs(dyi - r) <= 1 and dz == 0:
                    c9.append(nbrs[-1])
    return (_globalize(torch.stack(nbrs, dim=0), nb, cap_a),
            _globalize(torch.stack(c9, dim=0), nb, cap_a))


def _require_cuda(name, *tensors):
    """The CUDA device of a kernel's input tensors; ValueError unless all
    lie contiguous on it."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous on {dev}")
    return dev


def _require(name, checks):
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"{name}: {msg}")


def _require_rows(name, coords, valid):
    n = coords.shape[0]
    _require(name, (
        (coords.dtype == torch.int32 and tuple(coords.shape) == (n, 4),
         "coords must be int32 [N, 4]"),
        (valid.dtype == torch.bool and tuple(valid.shape) == (n,),
         "valid must be bool [N]"),
        (coords.data_ptr() % 16 == 0, "coords must be 16-byte aligned"),
    ))
    return n


def _require_sweep(name, cid_grid, packed, coords, valid, g, ccap, nb,
                   min_width):
    """The checks of a packed-table sweep's inputs (KQ, KR, KS); returns
    the device and the table's width."""
    dev = _require_cuda(name, cid_grid, packed, coords, valid)
    n = _require_rows(name, coords, valid)
    width = packed.shape[1] if packed.dim() == 2 else 0
    _require(name, (
        (n % nb == 0, f"rows {n} are not {nb} equal segments"),
        (cid_grid.dtype == torch.int32 and tuple(cid_grid.shape)
         == (nb * g * g,), "cid_grid must be int32 [nb*g*g]"),
        (packed.dtype == torch.int32 and packed.dim() == 2
         and packed.shape[0] == nb * ccap and width >= min_width,
         f"packed must be int32 [nb*ccap, >= {min_width}]"),
    ))
    return dev, width


def stem_feat125_packed(cid_grid, packed, coords, valid, g: int, ccap: int,
                        cap_a: int, r: int, nb: int, grid_half: int = 0,
                        level: int = 0):
    """KQ (csrc/stem_feat125.cu) for CUDA tensors, the plain version for
    CPU tensors; arguments as the plain version's (the k=5 stem only: r =
    2 on the card)."""
    if coords.device.type == "cpu":
        return stem_feat125_plain(cid_grid, packed, coords, valid, g, ccap,
                                  cap_a, r, nb, grid_half, level)
    name = "stem_feat125"
    aug_off = (2 * r + 1) * ZWORDS
    dev, width = _require_sweep(name, cid_grid, packed, coords, valid, g,
                                ccap, nb, aug_off + (2 * r + 1) * (ZWORDS + 1))
    _require(name, ((r == STEM_R, f"r must be {STEM_R}, got {r}"),))
    n = coords.shape[0]
    nbr = torch.empty((2 * r + 1) ** 3, n, dtype=torch.int32, device=dev)
    conv9 = torch.empty(9, n, dtype=torch.int32, device=dev)
    if n:
        _cuda.call(name, cid_grid.data_ptr(), packed.data_ptr(),
                   coords.data_ptr(), valid.data_ptr(), nbr.data_ptr(),
                   conv9.data_ptr(), n, nb, g, ccap, cap_a, grid_half, level,
                   width, aug_off)
        LAUNCHES[name] += 1
    return nbr, conv9


def stem_conv9_packed(cid_grid, packed, coords, valid, g: int, ccap: int,
                      cap_a: int, r: int, nb: int, grid_half: int = 0,
                      level: int = 0):
    """KR (csrc/zseg_sweeps.cu) for CUDA tensors, the plain version for
    CPU tensors; arguments as the plain version's (the k=5 stem only: r =
    2 on the card; the table's real slabs, then 3 aug slabs)."""
    if coords.device.type == "cpu":
        return stem_conv9_plain(cid_grid, packed, coords, valid, g, ccap,
                                cap_a, r, nb, grid_half, level)
    name = "stem_conv9_packed"
    aug_off = (2 * r + 1) * ZWORDS
    dev, width = _require_sweep(name, cid_grid, packed, coords, valid, g,
                                ccap, nb, aug_off + 3 * (ZWORDS + 1))
    _require(name, ((r == STEM_R, f"r must be {STEM_R}, got {r}"),))
    n = coords.shape[0]
    occ = torch.empty(n, (2 * r + 1) ** 3, dtype=torch.bfloat16, device=dev)
    conv9 = torch.empty(9, n, dtype=torch.int32, device=dev)
    if n:
        _cuda.call(name, cid_grid.data_ptr(), packed.data_ptr(),
                   coords.data_ptr(), valid.data_ptr(), occ.data_ptr(),
                   conv9.data_ptr(), n, nb, g, ccap, cap_a, grid_half, level,
                   width, aug_off)
        LAUNCHES[name] += 1
    return occ, conv9


def conv9_packed(cid_grid, packed, coords, valid, g: int, ccap: int,
                 cap_a: int, nb: int, grid_half: int = 0, level: int = 0):
    """KS (csrc/zseg_sweeps.cu) for CUDA tensors, the plain version for
    CPU tensors; arguments as the plain version's."""
    if coords.device.type == "cpu":
        return conv9_plain(cid_grid, packed, coords, valid, g, ccap, cap_a,
                           nb, grid_half, level)
    name = "conv9_packed"
    dev, width = _require_sweep(name, cid_grid, packed, coords, valid, g,
                                ccap, nb, 3 * (ZWORDS + 1))
    n = coords.shape[0]
    conv9 = torch.empty(9, n, dtype=torch.int32, device=dev)
    if n:
        _cuda.call(name, cid_grid.data_ptr(), packed.data_ptr(),
                   coords.data_ptr(), valid.data_ptr(), conv9.data_ptr(), n,
                   nb, g, ccap, cap_a, grid_half, level, width)
        LAUNCHES[name] += 1
    return conv9


def pos3_plain(aug16, coords, valid, g: int, cap_a: int, grid_half: int,
               level: int, cid):
    """Own-column (z-s, z, z+s) aug positions per query row, given each
    row's column id (plain version of KT, lidog_tpu/core/zseg.py:682).
    Returns [3, n] int32 (-1 miss), as lidog_tpu's."""
    gh = grid_half
    bq = coords[:, 0].long()
    gx0 = (coords[:, 1] >> level) + (gh >> level)
    gy0 = (coords[:, 2] >> level) + (gh >> level)
    bz0 = ((coords[:, 3] >> level) + ZC).long()
    ok = valid & (gx0 >= 0) & (gx0 < g) & (gy0 >= 0) & (gy0 < g)
    cid = torch.where(ok, cid, -1)
    hit = cid >= 0
    row = _u32(_rows_or_miss(aug16, cid))
    words = row[:, :ZWORDS]
    startv = row[:, ZWORDS]
    seg_base = bq * cap_a
    rank0, ex0 = _rank_from_row(words, bz0.clamp(0, ZMAX - 1))
    bit_m1 = _bit_at(words, (bz0 - 1).clamp(0, ZMAX - 1))
    bit_p1 = _bit_at(words, (bz0 + 1).clamp(0, ZMAX - 1))
    outs = []
    for dz, rank, ex in ((-1, rank0 - bit_m1, bit_m1 == 1),
                         (0, rank0, ex0),
                         (1, rank0 + ex0.long(), bit_p1 == 1)):
        bzd = bz0 + dz
        okz = hit & (bzd >= 0) & (bzd < ZMAX) & ex
        idx = startv + rank
        okr = okz & (idx >= 0) & ((idx - seg_base) < cap_a)
        outs.append(torch.where(okr, idx, -1))
    return torch.stack(outs, dim=0).to(torch.int32)


def pos3_lookup(aug16, coords, valid, g: int, cap_a: int, grid_half: int,
                level: int, cid):
    """KT (csrc/zseg_sweeps.cu) for CUDA tensors, the plain version for CPU
    tensors; arguments as the plain version's."""
    if coords.device.type == "cpu":
        return pos3_plain(aug16, coords, valid, g, cap_a, grid_half, level,
                          cid)
    name = "pos3_lookup"
    dev = _require_cuda(name, aug16, coords, valid, cid)
    n = _require_rows(name, coords, valid)
    _require(name, (
        (aug16.dtype == torch.int32 and aug16.dim() == 2
         and aug16.shape[1] == ZWORDS + 2,
         f"aug16 must be int32 [slots, {ZWORDS + 2}]"),
        (cid.dtype == torch.int64 and tuple(cid.shape) == (n,),
         "cid must be int64 [N]"),
    ))
    out = torch.empty(3, n, dtype=torch.int32, device=dev)
    if n:
        _cuda.call(name, aug16.data_ptr(), coords.data_ptr(),
                   valid.data_ptr(), cid.data_ptr(), out.data_ptr(), n,
                   aug16.shape[0], g, cap_a, grid_half, level)
        LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# Column-table kernels KV-KY (csrc/zseg_tables.cu): each wrapper takes its
# plain version for CPU tensors, launches its kernel for CUDA tensors (one
# count per call; the kernel's steps run in order on the current stream)
# and raises on any other device.  Overflow terms are added on the device
# into the plan's int32 overflow vector.
# ---------------------------------------------------------------------------

_KX_TILE = 256  # KX's slots per tile (csrc/zseg_tables.cu KX_TILE)
_KV_TILE_WORDS = 1024  # KV's most bit words a row-pass tile (KV_TILE_WORDS)
_KV_BLOCKS = 264  # KV's row-pass tiles wanted a launch: two per H100 SM
_SCAN_EPOCHS = 2**30 - 1  # KV's look-back tags cycle through 1 .. this
_REP_NONE = 2**31 - 1  # KY's rep of a row no input row maps to, before -1
# Kernel scratch kept on each device between launches (the port launches
# on one stream, so each launch sees the previous one's finished state):
# (name, device) -> a tensor that is zero between launches (KV's bit grid,
# KX's look-back state, KY's real flags); device -> KV's tile counter and
# real-row counts, the host's count of the tiles issued, the last epoch
# and the look-back words (stale words carry an earlier epoch); device ->
# KY's two packed-row tables, the rows each holds from its last launch,
# and the one the next launch fills.
_SCRATCH = {}
_KV_TICKETS = {}
_KY_ROWS = {}


def column_grid_tiles(g: int, nb: int, tile_words: int = _KV_TILE_WORDS,
                      blocks: int = _KV_BLOCKS):
    """KV's row-pass blocking at a level of g x g cells and nb scans
    (csrc/zseg_tables.cu grid_rows_kernel): (W, rows_per_tile,
    tiles_per_scan) -- the bit words of a (b, gx) row, ceil(g / 32); the
    whole rows of a tile, as many as give `blocks` tiles a launch but at
    most tile_words words (the kernel's KV_TILE_WORDS) and at least one
    row; and the tiles of a scan's g rows."""
    w = -(-g // 32)
    rows = max(1, min(tile_words // w, nb * g // blocks))
    return w, rows, -(-g // rows)


def _zeroed(name: str, device, n: int, dtype=torch.int64):
    """A kernel's scratch of at least n elements on `device`: zeroed here
    when first made or grown, and left zeroed by every launch that uses
    it."""
    t = _SCRATCH.get((name, device))
    if t is None or t.numel() < n:
        t = _SCRATCH[(name, device)] = torch.zeros(max(n, 1), dtype=dtype,
                                                   device=device)
    return t


def _kv_tickets(device, nb: int, tiles: int):
    """KV's row-pass state for a launch of nb * tiles tiles on `device`:
    (counts int64 [1 + nb], the tile counter's value before the launch,
    as an int32, the launch's epoch, its look-back words int64 [nb *
    tiles]).  The counter runs on from launch to launch (mod 2^32) and
    the look-back words are never reset: this launch's carry its epoch."""
    t = _KV_TICKETS.get(device)
    if t is None or t[0].numel() < 1 + nb:
        t = _KV_TICKETS[device] = [torch.zeros(1 + nb, dtype=torch.int64,
                                               device=device), 0, 0, None]
    counts, base, epoch, status = t
    if status is None or status.numel() < nb * tiles:
        status = t[3] = torch.zeros(nb * tiles, dtype=torch.int64,
                                    device=device)
    t[1] = (base + nb * tiles) % 2**32
    t[2] = epoch % _SCAN_EPOCHS + 1
    return counts, base - 2**32 if base >= 2**31 else base, t[2], status


def _ky_rows(device, n_a: int):
    """KY's packed-row tables for a launch of n_a rows on `device`: (the
    zeroed table this launch fills, the other table, which this launch
    clears, and its rows to clear)."""
    r = _KY_ROWS.get(device)
    if r is None or r[0][0].numel() < n_a:
        r = _KY_ROWS[device] = [
            [torch.zeros(max(n_a, 1), dtype=torch.int32, device=device)
             for _ in range(2)], [0, 0], 0]
    tables, dirty, cur = r
    other = 1 - cur
    stale_n = dirty[other]
    dirty[other], dirty[cur], r[2] = 0, n_a, other
    return tables[cur], tables[other], stale_n


def scratch_left_zero(device):
    """The names of the kernel scratch on `device` that breaks its
    invariant between launches (empty when all is well): each zeroed
    scratch, KV's real-row counts and the KY table that the next launch
    fills must be all zero."""
    bad = [name for (name, dev), t in _SCRATCH.items()
           if dev == device and bool(t.any())]
    t = _KV_TICKETS.get(device)
    if t is not None and bool(t[0][1:].any()):
        bad.append("column_grid real-row counts")
    r = _KY_ROWS.get(device)
    if r is not None and bool(r[0][r[2]].any()):
        bad.append("emit_rows packed rows")
    return bad


def _require_overflow(name, overflow, dev):
    _require(name, ((overflow.device == dev and overflow.dtype == torch.int32
                     and tuple(overflow.shape) == (1 + NUM_LEVELS,),
                     f"overflow must be int32 [{1 + NUM_LEVELS}] on {dev}"),))


def _require_slots(name, col_bxy, col_valid, slots):
    _require(name, (
        (col_bxy.dtype == torch.int64 and tuple(col_bxy.shape) == (slots,),
         f"col_bxy must be int64 [{slots}]"),
        (col_valid.dtype == torch.bool and tuple(col_valid.shape) == (slots,),
         f"col_valid must be bool [{slots}]"),
    ))


def _require_level(name, num_batches, g, level, *caps):
    _require(name, (
        (0 <= level < NUM_LEVELS, f"level must lie in [0, {NUM_LEVELS})"),
        (num_batches >= 1 and g >= 1 and all(c >= 1 for c in caps),
         "needs num_batches, g and the caps >= 1"),
        (num_batches * g * g < 2**31
         and all(num_batches * c * (ZWORDS + 2) < 2**31 for c in caps),
         "grid or tables too large for int32 sizes"),
    ))


def column_grid(coords, valid, num_batches: int, grid_half: int, level: int,
                ccap: int, r: int, *, overflow, cap_real: int = -1):
    """KV (csrc/zseg_tables.cu) for CUDA tensors, the plain version for CPU
    tensors; arguments as the plain version's."""
    if coords.device.type == "cpu":
        return column_grid_plain(coords, valid, num_batches, grid_half, level,
                                 ccap, r, overflow=overflow,
                                 cap_real=cap_real)
    name = "column_grid"
    dev = _require_cuda(name, coords, valid)
    n = _require_rows(name, coords, valid)
    g = (2 * grid_half) >> level
    _require_level(name, num_batches, g, level, ccap)
    _require_overflow(name, overflow, dev)
    _require(name, ((0 <= r <= 31 and 2 * r + 1 <= g, f"bad radius {r}"),
                    (g <= 32768, "g must be <= 32768 (a row of bit words "
                     "in one tile)")))
    slots, cells = num_batches * ccap, num_batches * g * g
    w, rows_per_tile, tiles_per_scan = column_grid_tiles(g, num_batches)
    grid_d = torch.empty(cells, dtype=torch.int32, device=dev)
    vox_cid = torch.empty(n, dtype=torch.int64, device=dev)
    # col_bxy int64 and col_valid bool, zeroed by one fill
    cols = torch.zeros(slots * 9, dtype=torch.uint8, device=dev)
    col_bxy = cols[:slots * 8].view(torch.int64)
    col_valid = cols[slots * 8:].view(torch.bool)
    bits = _zeroed("column_grid bits", dev, num_batches * g * w,
                   torch.int32)
    counts, base, epoch, status = _kv_tickets(dev, num_batches,
                                              tiles_per_scan)
    _cuda.call(name, coords.data_ptr(), valid.data_ptr(), grid_d.data_ptr(),
               vox_cid.data_ptr(), col_bxy.data_ptr(), col_valid.data_ptr(),
               bits.data_ptr(), counts.data_ptr(), status.data_ptr(),
               overflow.data_ptr(), n, num_batches, grid_half, level, ccap, r,
               cap_real, rows_per_tile, base, epoch)
    LAUNCHES[name] += 1
    return grid_d, vox_cid, col_bxy, col_valid


def real_words(level: int, num_batches: int, ccap: int, grid_half: int, *,
               overflow, coords=None, valid=None, vox_cid=None,
               unique: bool = True, cap_real: int = 0, col_bxy=None,
               col_valid=None, fine_grid=None, fine_real=None):
    """KW (csrc/zseg_tables.cu) for CUDA tensors, the plain version for CPU
    tensors; arguments as the plain version's."""
    tables = ((coords, valid, vox_cid) if level == 0
              else (col_bxy, col_valid, fine_grid, fine_real))
    kw = dict(overflow=overflow, coords=coords, valid=valid, vox_cid=vox_cid,
              unique=unique, cap_real=cap_real, col_bxy=col_bxy,
              col_valid=col_valid, fine_grid=fine_grid, fine_real=fine_real)
    if tables[0].device.type == "cpu":
        return real_words_plain(level, num_batches, ccap, grid_half, **kw)
    name = "real_words"
    dev = _require_cuda(name, *tables)
    _require_level(name, num_batches, (2 * grid_half) >> level, level, ccap)
    _require_overflow(name, overflow, dev)
    slots = num_batches * ccap
    n, fine_slots = 0, 0
    if level == 0:
        n = _require_rows(name, coords, valid)
        _require(name, ((vox_cid.dtype == torch.int64
                         and tuple(vox_cid.shape) == (n,),
                         "vox_cid must be int64 [N]"),))
    else:
        _require_slots(name, col_bxy, col_valid, slots)
        f_g = (2 * grid_half) >> (level - 1)
        fine_slots = fine_real.shape[0] if fine_real.dim() == 2 else 0
        _require(name, (
            (fine_grid.dtype == torch.int32
             and tuple(fine_grid.shape) == (num_batches * f_g * f_g,),
             "fine_grid must be int32 [B*g_fine^2]"),
            _real_ok(fine_real, name="fine_real"),
        ))
    # level 0: zeroed by the kernel's first step, as is nreal
    real_w = torch.empty(slots, REAL_W, dtype=torch.int32, device=dev)
    nreal = (torch.empty(num_batches, dtype=torch.int64, device=dev)
             if level == 0 and not unique else None)  # scratch
    ptr = [t.data_ptr() if t is not None else None
           for t in (coords, valid, vox_cid, col_bxy, col_valid, fine_grid,
                     fine_real, real_w, nreal)]
    _cuda.call(name, *ptr, overflow.data_ptr(), n, fine_slots, num_batches,
               ccap, grid_half, level, int(unique), cap_real)
    LAUNCHES[name] += 1
    return real_w


def assemble_aug(real_w, col_bxy, col_valid, grid_d, num_batches: int,
                 g: int, ccap: int, cap_a: int, *, level: int, overflow):
    """KX (csrc/zseg_tables.cu) for CUDA tensors, the plain version for CPU
    tensors; arguments as the plain version's."""
    if real_w.device.type == "cpu":
        return assemble_aug_plain(real_w, col_bxy, col_valid, grid_d,
                                  num_batches, g, ccap, cap_a, level=level,
                                  overflow=overflow)
    name = "assemble_aug"
    dev = _require_cuda(name, real_w, col_bxy, col_valid, grid_d)
    slots = num_batches * ccap
    _require_level(name, num_batches, g, level, ccap, cap_a)
    _require_overflow(name, overflow, dev)
    _require_slots(name, col_bxy, col_valid, slots)
    _require(name, (
        _real_ok(real_w, slots),
        (grid_d.dtype == torch.int32
         and tuple(grid_d.shape) == (num_batches * g * g,),
         "grid_d must be int32 [B*g*g]"),
    ))
    tiles = num_batches * -(-ccap // _KX_TILE)
    aug16 = torch.empty(slots, ZWORDS + 2, dtype=torch.int32, device=dev)
    counts_b = torch.empty(num_batches, dtype=torch.int64, device=dev)
    _cuda.call(name, real_w.data_ptr(), col_bxy.data_ptr(),
               col_valid.data_ptr(), grid_d.data_ptr(), aug16.data_ptr(),
               counts_b.data_ptr(), _zeroed("assemble_aug state", dev,
                                            tiles + 1).data_ptr(),
               overflow.data_ptr(), num_batches, g, ccap, cap_a, level)
    LAUNCHES[name] += 1
    LEVEL_LAUNCHES[name][level] += 1
    return aug16, counts_b


def emit_rows(pos3, coords, valid, counts_b, num_batches: int, cap_a: int,
              grid_half: int, level: int, rep: bool = False):
    """KY (csrc/zseg_tables.cu) for CUDA tensors, the plain version for CPU
    tensors; arguments as the plain version's."""
    if coords.device.type == "cpu":
        return emit_rows_plain(pos3, coords, valid, counts_b, num_batches,
                               cap_a, grid_half, level, rep)
    name = "emit_rows"
    dev = _require_cuda(name, pos3, coords, valid, counts_b)
    n = _require_rows(name, coords, valid)
    _require_level(name, num_batches, (2 * grid_half) >> level, level, cap_a)
    _require(name, (
        (pos3.dtype == torch.int32 and tuple(pos3.shape) == (3, n),
         "pos3 must be int32 [3, N]"),
        (counts_b.dtype == torch.int64
         and tuple(counts_b.shape) == (num_batches,),
         "counts_b must be int64 [B]"),
        (not rep or level == 0, "rep is a level-0 output"),
    ))
    n_a = num_batches * cap_a
    coords_a = torch.empty(n_a, 4, dtype=torch.int32, device=dev)
    real_a, valid_a, zup, zdn = (torch.empty(n_a, dtype=torch.bool,
                                             device=dev) for _ in range(4))
    # the scattered rows' packed words and real flags
    packed_a, stale, stale_n = _ky_rows(dev, n_a)
    flag_a = _zeroed("emit_rows flags", dev, n_a, torch.bool)
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    off = map8 = None
    if level:
        off = torch.empty(n, dtype=torch.int32, device=dev)
        map8 = torch.full((8, n_a), -1, dtype=torch.int32, device=dev)
    elif rep:
        map8 = torch.full((n_a,), _REP_NONE, dtype=torch.int32, device=dev)
    _cuda.call(name, pos3.data_ptr(), coords.data_ptr(), valid.data_ptr(),
               counts_b.data_ptr(), coords_a.data_ptr(), real_a.data_ptr(),
               valid_a.data_ptr(), zup.data_ptr(), zdn.data_ptr(),
               packed_a.data_ptr(), stale.data_ptr(), flag_a.data_ptr(),
               pos.data_ptr(), None if off is None else off.data_ptr(),
               None if map8 is None else map8.data_ptr(), n, num_batches,
               cap_a, grid_half, level, int(rep), stale_n)
    LAUNCHES[name] += 1
    rows = (coords_a, real_a, valid_a, zup, zdn, pos)
    if level:
        return rows + (off, map8)
    return rows + ((map8,) if rep else ())


def _seg_valid_mask(counts, num_batches: int, seg_cap: int):
    """valid[b*cap + r] = r < min(counts[b], cap)."""
    r = torch.arange(seg_cap, device=counts.device)[None, :]
    return (r < counts.clamp(max=seg_cap)[:, None]).reshape(-1)


def _scatter_rows(pos, values, cap: int, fill=0):
    slot = torch.where((pos >= 0) & (pos < cap), pos, cap)
    out = values.new_full((cap + 1,) + tuple(values.shape[1:]), fill)
    out[slot] = values
    return out[:cap]


def _scatter_flag(pos, flag, cap: int):
    slot = torch.where((pos >= 0) & (pos < cap) & flag, pos, cap)
    out = torch.zeros(cap + 1, dtype=torch.bool, device=pos.device)
    out[slot] = True
    return out[:cap]


def _z_adjacency(coords, valid, stride: int):
    """zup[j]: row j+1 is (same batch, x, y, z+stride) and both valid."""
    same_col = (coords[1:, :3] == coords[:-1, :3]).all(dim=1)
    zplus = coords[1:, 3] == coords[:-1, 3] + stride
    adj = same_col & zplus & valid[1:] & valid[:-1]
    f = adj.new_zeros(1)
    return torch.cat([adj, f]), torch.cat([f, adj])


def emit_rows_plain(pos3, coords, valid, counts_b, num_batches: int,
                    cap_a: int, grid_half: int, level: int,
                    rep: bool = False):
    """A level's augmented rows from its source rows' (z-1, z, z+1) aug
    positions (plain version of KY, lidog_tpu/core/zseg.py:1004-1026,
    1049-1100, 735-770): each candidate scattered as one packed
    gxgy << 9 | bz and decoded per row.

    pos3 int32 [3, N] (KT's), coords/valid the source rows, counts_b int64
    [B] the aug rows per scan.  Returns (coords int32 [B*cap_a, 4], real,
    valid, zup, zdn bool [B*cap_a]) and, at level 0, pos int32 [N] (+ rep
    int32 [B*cap_a], the smallest input row of each row, with rep=True),
    above it the pair maps to the finer level whose rows are the sources:
    parent, off int32 [N] and down8 int32 [8, B*cap_a]."""
    B, gh, i = num_batches, grid_half, level
    dev = coords.device
    g = (2 * gh) >> i
    n_a = B * cap_a
    _, gx, gy, bz, _ = _cell_of(coords, gh, i)
    gxc = gx.long().clamp(0, g - 1)
    gyc = gy.long().clamp(0, g - 1)
    # one packed int per candidate: gxgy << 9 | bz (uint32 wrap kept, as
    # in the JAX version)
    packed0 = ((gxc * g + gyc) << 9) | bz.long().clamp(0, ZMAX - 1)
    cand_p = torch.cat([packed0 - 1, packed0, packed0 + 1]) & U32
    packed_a = _scatter_rows(pos3.reshape(-1), cand_p, n_a)
    gxgy = packed_a >> 9
    ax = (torch.div(gxgy, g, rounding_mode="floor") - (gh >> i)) << i
    ay = ((gxgy % g) - (gh >> i)) << i
    az = ((packed_a & 511) - ZC) << i
    ab = torch.arange(n_a, device=dev) // cap_a
    coords_a = torch.stack([ab, ax, ay, az], dim=1).to(torch.int32)
    real_a = _scatter_flag(pos3[1], valid, n_a)
    valid_a = _seg_valid_mask(counts_b, B, cap_a)
    coords_a = torch.where(valid_a[:, None], coords_a, 0)
    real_a = real_a & valid_a
    zup, zdn = _z_adjacency(coords_a, valid_a, 1 << i)
    rows = (coords_a, real_a, valid_a, zup, zdn)
    if i == 0:
        pos_in = torch.where(valid, pos3[1], -1).to(torch.int32)
        if not rep:
            return rows + (pos_in,)
        # the representative input row of each level-0 row: the minimum
        # input index (voxelize_device's pick)
        big = 2**31 - 1
        pslot = torch.where(pos_in >= 0, pos_in.long(), n_a)
        rep_in = torch.full((n_a + 1,), big, dtype=torch.int32, device=dev)
        rep_in.scatter_reduce_(
            0, pslot, torch.arange(pos_in.shape[0], dtype=torch.int32,
                                   device=dev), reduce="amin")
        rep_in = torch.where(rep_in[:n_a] == big, -1, rep_in[:n_a])
        return rows + (pos_in, rep_in)
    # strided pair maps between level i-1 (fine, the sources) and i
    # (coarse): parent per fine row is pos3's dz=0 lookup; down8 is its
    # transpose (each real fine row is the unique child of its parent at
    # its offset)
    pxyz = (coords[:, 1:4] >> i) << i
    parent = pos3[1]
    d = (coords[:, 1:4] - pxyz) >> (i - 1)
    offv = d[:, 0] * 4 + d[:, 1] * 2 + d[:, 2]
    down8 = torch.full((8, n_a + 1), -1, dtype=torch.int32, device=dev)
    pslot = torch.where(parent >= 0, parent, n_a)
    down8[offv.clamp(0, 7).long(), pslot] = torch.arange(
        parent.shape[0], dtype=torch.int32, device=dev)
    return rows + (parent.to(torch.int32), offv.to(torch.int32),
                   down8[:, :n_a].contiguous())


STEM_R = 2  # the k=5 stem's radius (125 occupancy columns)


class ZSegPlanBuilder:
    """Build a ZPlan from batched stride-1 voxel coords in any row order
    (lidog_tpu/core/zseg.py:773 with the default k=5 stem and column caps
    = caps_real).

    caps_real / caps_aug: per-scan row capacities per level.
    caps_col_dil: per-scan y-dilated column capacities (default: the safe
    (2r+1) x caps_real bound).
    stem_feature_map: emit the stem's source-row maps kmaps["stem125"]
    (in_channels > 1, ops/sparse_conv.py) instead of the occupancy
    matrix kmaps["stem_occ"] (constant input features).
    assume_unique=False: sortless input, raw per-point voxel cells with
    duplicates.  The column tables dedup them: the level-0 bits are
    stamped idempotently per z byte and packed to words, overflow[0]
    counts the deduped voxels, `pos` maps every point, and the plan
    carries `rep`, the smallest input row of each level-0 row (the
    representative that voxelize_device picks).
    """

    def __init__(self, caps_real, caps_aug, num_batches: int,
                 grid_half: int = 1024, caps_col_dil=None,
                 stem_feature_map: bool = False, assume_unique: bool = True):
        assert len(caps_real) == NUM_LEVELS and len(caps_aug) == NUM_LEVELS
        self.caps_real = tuple(int(c) for c in caps_real)
        self.caps_aug = tuple(int(c) for c in caps_aug)
        self.num_batches = num_batches
        self.grid_half = grid_half
        self.stem_feature_map = stem_feature_map
        self.assume_unique = assume_unique
        if caps_col_dil is None:
            caps_col_dil = tuple((2 * (STEM_R if i == 0 else 1) + 1) * c
                                 for i, c in enumerate(self.caps_real))
        self.caps_col_dil = tuple(int(c) for c in caps_col_dil)

    def __call__(self, coords, mask) -> ZPlan:
        B = self.num_batches
        overflow = torch.zeros(1 + NUM_LEVELS, dtype=torch.int32,
                               device=coords.device)
        kmaps: Dict[str, torch.Tensor] = {}
        levels = []
        t = None  # the previous level's tables
        for i in range(NUM_LEVELS):
            t = self._level(i, coords, mask, t, overflow)
            levels.append(t.level)
            args, kwargs = self._packed_args(i, t)
            args, kwargs = self._sweep_args(i, t, _build_packed(*args,
                                                                **kwargs))
            sweep, names = self._sweep(i)
            maps = sweep(*args, **kwargs)
            del args  # the packed table
            kmaps.update(zip(names, maps if i == 0 else (maps,)))
            if i == 0:
                pos_in = t.extra[0]
                rep_in = None if self.assume_unique else t.extra[1]
            else:
                kmaps[f"parent_l{i-1}"], kmaps[f"off_l{i-1}"], \
                    kmaps[f"down8_l{i-1}"] = t.extra
        return ZPlan(levels=tuple(levels), kmaps=kmaps, pos=pos_in,
                     overflow=overflow, rep=rep_in, num_batches=B)

    def table_inputs(self, coords, mask):
        """Yield (level, wrapper name, args, kwargs) of each column-table
        call of this builder's plan of (coords, mask), as the builder
        makes them: per level column_grid (KV), real_words (KW),
        assemble_aug (KX) and emit_rows (KY).  Each `overflow` argument is
        a copy of the plan's running overflow vector at that call."""
        overflow = torch.zeros(1 + NUM_LEVELS, dtype=torch.int32,
                               device=coords.device)
        t = None
        for i in range(NUM_LEVELS):
            calls = []
            t = self._level(i, coords, mask, t, overflow, calls)
            for name, args, kwargs in calls:
                yield i, name, args, kwargs

    def sweep_inputs(self, coords, mask):
        """Yield (level, wrapper name, args, kwargs) of each kernel sweep of
        this builder's plan of (coords, mask), as the builder makes them:
        per level pos3_lookup (KT), _build_packed (KU), then over that
        table stem_conv9_packed (KR; stem_feat125_packed, KQ, with
        stem_feature_map) at level 0, else conv9_packed (KS)."""
        overflow = torch.zeros(1 + NUM_LEVELS, dtype=torch.int32,
                               device=coords.device)
        t = None
        for i in range(NUM_LEVELS):
            t = self._level(i, coords, mask, t, overflow)
            yield (i, "pos3_lookup") + t.pos3_inputs
            args, kwargs = self._packed_args(i, t)
            yield i, "_build_packed", args, kwargs
            yield (i, self._sweep(i)[0].__name__) + self._sweep_args(
                i, t, _build_packed(*args, **kwargs))

    def stem_inputs(self, coords, mask):
        """(args, kwargs) of the level-0 stem sweep of this builder's plan
        of (coords, mask): stem_feat125_packed's with stem_feature_map,
        else stem_conv9_packed's."""
        for _, name, args, kwargs in self.sweep_inputs(coords, mask):
            if name.startswith("stem"):
                return args, kwargs

    def _sweep(self, i: int):
        """Level i's sweep over its packed table and the kmaps it gives."""
        if i:
            return conv9_packed, (f"conv9_l{i}",)
        if self.stem_feature_map:
            return stem_feat125_packed, ("stem125", "conv9_l0")
        return stem_conv9_packed, ("stem_occ", "conv9_l0")

    def _packed_args(self, i: int, t: "_LevelTables"):
        """(args, kwargs) of level i's packed table (_build_packed): the
        stem's real and aug slabs at level 0, the aug slabs above."""
        r, aug_r = -1, 1
        if i == 0:
            r, aug_r = STEM_R, STEM_R if self.stem_feature_map else 1
        return ((t.real_w, t.aug16, t.col_bxy, t.col_valid, self.num_batches,
                 self.caps_col_dil[i], self.caps_aug[i], r),
                dict(aug_r=aug_r, level=i))

    def _sweep_args(self, i: int, t: "_LevelTables", packed):
        """(args, kwargs) of level i's sweep over its packed table: the
        stem's at level 0, conv9_packed's above."""
        tail = (STEM_R, self.num_batches) if i == 0 else (self.num_batches,)
        return ((t.grid_d, packed, t.level.coords, t.level.valid, t.g,
                 self.caps_col_dil[i], self.caps_aug[i]) + tail,
                dict(grid_half=self.grid_half, level=i))

    def _level(self, i: int, coords, mask, prev: Optional["_LevelTables"],
               overflow, calls: Optional[list] = None) -> "_LevelTables":
        """Level i's rows and column tables: from the input (coords, mask)
        at level 0, else from the previous level's rows (only coords >> i
        is read) and tables; adds the level's overflow terms to
        `overflow`.  With `calls`, appends (name, args, kwargs) of each
        column-table call to it."""
        B, gh = self.num_batches, self.grid_half
        capA = self.caps_aug[i]
        ccap_d = self.caps_col_dil[i]
        g = (2 * gh) >> i

        def table(fn, *args, **kwargs):
            if calls is not None:
                kw = {k: v.clone() if k == "overflow" else v
                      for k, v in kwargs.items()}
                calls.append((fn.__name__, args, kw))
            return fn(*args, **kwargs)

        if i == 0:
            src_coords, src_valid = coords, mask
        else:
            src_coords, src_valid = prev.level.coords, prev.level.real
        cap_real = (self.caps_real[0] if i == 0 and self.assume_unique
                    else -1)
        grid_d, vox_cid, col_bxy, col_valid = table(
            column_grid, src_coords, src_valid, B, gh, i, ccap_d,
            STEM_R if i == 0 else 1, overflow=overflow, cap_real=cap_real)
        if i == 0:
            real_w = table(real_words, 0, B, ccap_d, gh, overflow=overflow,
                           coords=src_coords, valid=src_valid,
                           vox_cid=vox_cid, unique=self.assume_unique,
                           cap_real=self.caps_real[0])
        else:
            real_w = table(real_words, i, B, ccap_d, gh, overflow=overflow,
                           col_bxy=col_bxy, col_valid=col_valid,
                           fine_grid=prev.grid_d, fine_real=prev.real_w)
        aug16, counts_b = table(assemble_aug, real_w, col_bxy, col_valid,
                                grid_d, B, g, ccap_d, capA, level=i,
                                overflow=overflow)
        pos3_inputs = ((aug16, src_coords, src_valid, g, capA, gh, i),
                       dict(cid=vox_cid))
        pos3 = pos3_lookup(*pos3_inputs[0], **pos3_inputs[1])
        rows = table(emit_rows, pos3, src_coords, src_valid, counts_b, B,
                     capA, gh, i, rep=i == 0 and not self.assume_unique)
        return _LevelTables(
            level=ZLevel(*rows[:5], stride=1 << i), g=g, grid_d=grid_d,
            real_w=real_w, aug16=aug16, col_bxy=col_bxy, col_valid=col_valid,
            pos3_inputs=pos3_inputs, extra=rows[5:])


class _LevelTables(NamedTuple):
    """One level of the plan build: its rows, the y-dilated column grid
    and tables of its g x g plane, the (args, kwargs) of its pos3 lookup,
    and its further maps (emit_rows' outputs after the level's rows: pos
    [and rep] at level 0, parent, off and down8 to the finer level
    above)."""
    level: ZLevel
    g: int
    grid_d: torch.Tensor
    real_w: torch.Tensor
    aug16: torch.Tensor
    col_bxy: torch.Tensor
    col_valid: torch.Tensor
    pos3_inputs: tuple
    extra: tuple


def input_tensor_z(plan: ZPlan, feats) -> SparseTensor:
    """Caller-order features [N_in, C] -> the level-0 augmented layout
    (ghost/pad rows zero).  Unique input: one scatter via plan.pos.
    Sortless input: a gather via plan.rep, which picks the representative
    row's features (a scatter of duplicate positions would depend on the
    write order)."""
    l0 = plan.level(0)
    if plan.rep is None:
        f = plan.scatter_rows(feats)
    else:
        hit = plan.rep >= 0
        f = feats[plan.rep.clamp(min=0).long()] * hit[:, None].to(feats.dtype)
    f = f * l0.real[:, None].to(f.dtype)
    return SparseTensor(coords=l0.coords, feats=f, mask=l0.real, stride=1)

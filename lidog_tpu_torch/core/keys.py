"""Packed (batch, x, y, z) coordinate keys and sorted-array lookup.

Port of lidog_tpu/core/keys.py:30-166.  Layout (two int32 words):

    hi = (batch << 13) | (x + 4096)
    lo = ((y + 4096) << 13) | (z + 4096)

Coordinates lie in [-4096, 4095] per axis; invalid or out-of-range rows get
(INVALID_KEY, INVALID_KEY) so they sort after every valid key.

The lookups return int32 rows bitwise equal to lidog_tpu's, -1 for a miss
and for an INVALID_KEY query.  lidog_tpu lexsorts (hi, lo) pairs; torch
has no lexsort, so here one stable sort of the combined 62-bit key
`(hi << 31) | lo` (both words are non-negative) gives the same
permutation, ties in input order.
"""

from __future__ import annotations

import math

import torch

COORD_BITS = 13
COORD_HALF = 1 << (COORD_BITS - 1)  # 4096
COORD_MIN = -COORD_HALF
COORD_MAX = COORD_HALF - 1
INVALID_KEY = 2**31 - 1


def pack(coords: torch.Tensor, valid: torch.Tensor):
    """int32 coords [N, 4] (b, x, y, z) + bool valid [N] -> (hi, lo) int32."""
    b, x, y, z = coords.unbind(1)
    in_range = (
        (x >= COORD_MIN) & (x <= COORD_MAX)
        & (y >= COORD_MIN) & (y <= COORD_MAX)
        & (z >= COORD_MIN) & (z <= COORD_MAX)
        & (b >= 0)
    )
    ok = valid & in_range
    xc = x.clamp(COORD_MIN, COORD_MAX)
    yc = y.clamp(COORD_MIN, COORD_MAX)
    zc = z.clamp(COORD_MIN, COORD_MAX)
    bc = b.clamp(min=0)
    hi = (bc << COORD_BITS) | (xc + COORD_HALF)
    lo = ((yc + COORD_HALF) << COORD_BITS) | (zc + COORD_HALF)
    inv = torch.full_like(hi, INVALID_KEY)
    return (torch.where(ok, hi, inv).to(torch.int32),
            torch.where(ok, lo, inv).to(torch.int32))


def combined(hi, lo):
    """int64 (hi << 31) | lo: orders like the (hi, lo) pair."""
    return (hi.to(torch.int64) << 31) | lo.to(torch.int64)


def lex_less(ah, al, bh, bl):
    """(ah, al) < (bh, bl) lexicographically, elementwise."""
    return (ah < bh) | ((ah == bh) & (al < bl))


def sort_by_key(hi, lo):
    """A permutation sorting rows by (hi, lo) ascending, stably."""
    return torch.sort(combined(hi, lo), stable=True).indices


def lower_bound(sorted_hi, sorted_lo, q_hi, q_lo):
    """For each query the first index i with sorted[i] >= query (n when
    every element is smaller): lidog_tpu's fixed-step binary search."""
    n = sorted_hi.shape[0]
    steps = max(1, int(math.ceil(math.log2(n + 1))) + 1)
    lo_b = torch.zeros(q_hi.shape, dtype=torch.int32, device=q_hi.device)
    hi_b = torch.full(q_hi.shape, n, dtype=torch.int32, device=q_hi.device)
    for _ in range(steps):
        active = lo_b < hi_b
        mid = lo_b + ((hi_b - lo_b) >> 1)
        mid_c = mid.clamp(0, max(n - 1, 0)).long()
        less = lex_less(sorted_hi[mid_c], sorted_lo[mid_c], q_hi, q_lo)
        lo_b = torch.where(active & less, mid + 1, lo_b)
        hi_b = torch.where(active & ~less, mid, hi_b)
    return lo_b


def merge_lookup(sorted_hi, sorted_lo, q_hi, q_lo):
    """Row of each query key in a lex-sorted key table, or -1: the
    sort-merge join of lidog_tpu/core/keys.py:115-149.  A stable sort of
    [table; queries] puts a table row before the queries with its key
    (lidog_tpu's tag tiebreak), and the last table row seen is carried
    onto the queries behind it; one gather verifies the key.

    lidog_tpu carries it with a running max of the table positions.  The
    table is sorted, so the stable sort keeps its rows in position order
    and that max is the count of table rows seen, less one: a cumsum here
    (torch's CUDA cummax scans a 1-D tensor in one block)."""
    n, q = sorted_hi.shape[0], q_hi.shape[0]
    dev = q_hi.device
    hi = torch.cat([sorted_hi, q_hi])
    lo = torch.cat([sorted_lo, q_lo])
    order = sort_by_key(hi, lo)
    run = torch.cumsum(order < n, 0, dtype=torch.int32) - 1
    cand = run.clamp(0, max(n - 1, 0)).long()
    hi_s, lo_s = hi[order], lo[order]
    hit = ((run >= 0) & (sorted_hi[cand] == hi_s) & (sorted_lo[cand] == lo_s)
           & (hi_s != INVALID_KEY))
    out = torch.empty(n + q, dtype=torch.int32, device=dev)
    out[order] = torch.where(hit, cand.to(torch.int32), -1)
    return out[n:]


def lookup(sorted_hi, sorted_lo, q_hi, q_lo, q_valid=None):
    """Row of each query key in a lex-sorted key table, or -1, by binary
    search (lidog_tpu/core/keys.py:152-166)."""
    n = sorted_hi.shape[0]
    pos = lower_bound(sorted_hi, sorted_lo, q_hi, q_lo)
    pos_c = pos.clamp(0, max(n - 1, 0))
    hit = ((pos < n) & (sorted_hi[pos_c.long()] == q_hi)
           & (sorted_lo[pos_c.long()] == q_lo) & (q_hi != INVALID_KEY))
    if q_valid is not None:
        hit = hit & q_valid
    return torch.where(hit, pos_c, -1).to(torch.int32)

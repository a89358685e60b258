"""Packed (batch, x, y, z) coordinate keys.

Port of lidog_tpu/core/keys.py:30-60.  Layout (two int32 words):

    hi = (batch << 13) | (x + 4096)
    lo = ((y + 4096) << 13) | (z + 4096)

Coordinates lie in [-4096, 4095] per axis; invalid or out-of-range rows get
(INVALID_KEY, INVALID_KEY) so they sort after every valid key.
"""

from __future__ import annotations

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

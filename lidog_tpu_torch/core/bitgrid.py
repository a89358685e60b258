"""z-bitmask column words: the bit helpers the zseg plan uses.

Port of lidog_tpu/core/bitgrid.py:35-65, 87-96, 299-320.  A column's
z-occupancy is a 448-bit mask in ZWORDS 32-bit words (LSB first); the
canonical row of a voxel is start + popcount(bits below z).

The JAX version computes in uint32 with logical shifts and population
counts.  PyTorch has neither a uint32 right shift nor a popcount, so every
word here is an int64 holding a uint32 value (0 <= w < 2**32); shifts that
could carry past bit 31 are masked with U32, and popcount32 is a SWAR
count.  Word tables never leave the plan builder, so no int32 round trip
is needed.
"""

from __future__ import annotations

import torch

ZWORDS = 14  # 448 z bits (see lidog_tpu/core/bitgrid.py:35)
ZC = ZWORDS * 16  # z bit-center (multiple of 32)
U32 = 0xFFFFFFFF


def _cell_of(coords, grid_half: int, level: int):
    """coords int32 [N, 4] raw -> (b, gx, gy, bz, in_bounds)."""
    g = (2 * grid_half) >> level
    b = coords[:, 0]
    gx = (coords[:, 1] >> level) + (grid_half >> level)
    gy = (coords[:, 2] >> level) + (grid_half >> level)
    bz = (coords[:, 3] >> level) + ZC
    ok = (
        (gx >= 0) & (gx < g) & (gy >= 0) & (gy < g)
        & (bz >= 0) & (bz < ZWORDS * 32)
    )
    return b, gx, gy, bz, ok


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 words holding uint32 values (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _compress_even_bits(t: torch.Tensor) -> torch.Tensor:
    """Even-position bits of each uint32 word -> its low 16 bits."""
    x = t & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    x = (x | (x >> 8)) & 0x0000FFFF
    return x


def _word_at(words: torch.Tensor, widx: torch.Tensor) -> torch.Tensor:
    """words [..., ZWORDS]; widx [...] -> the selected word, 0 where widx is
    outside [0, ZWORDS) (the one-hot select of the JAX version)."""
    inb = (widx >= 0) & (widx < ZWORDS)
    w = torch.gather(words, -1, widx.clamp(0, ZWORDS - 1).long()[..., None])
    return torch.where(inb, w[..., 0], 0)


def _rank_from_row(words: torch.Tensor, bz: torch.Tensor):
    """Rank of bit bz within [..., ZWORDS] words, and whether it is set."""
    word = bz >> 5
    ib = (bz & 31).long()
    widx = torch.arange(ZWORDS, device=words.device)
    pc = popcount32(words)
    below_words = torch.where(widx < word[..., None], pc, 0).sum(-1)
    w = _word_at(words, word)
    mask_below = (1 << ib) - 1
    in_word = popcount32(w & mask_below)
    exists = ((w >> ib) & 1) == 1
    return (below_words + in_word).to(torch.int32), exists

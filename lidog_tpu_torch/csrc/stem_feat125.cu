// KQ: the feature-stem sweep of the zseg plan: the source row of every
// (dx, dy, dz) neighbour in the 5x5x5 window of each level-0 row, and the
// level-0 conv9 map.
//
// Replaces lidog_tpu/core/zseg.py:540-628 (stem_feat125_packed).  Inputs
// are the plan builder's own tables: the dense cell -> column id grid
// (int32 GLOBAL segmented column ids, -1 empty) and the packed
// y-neighbourhood table built with aug_r = r (int32, as lidog_tpu's: the
// uint32 bit words read as int32; per row, after the real slabs at
// aug_off, 2r+1 slabs of ZWORDS aug words + the LOCAL start row, for dy =
// -r..r).  For query row
// i of scan b (rows are segment-aligned: b = i / (N / nb)) and each dx:
//
//   cid  = grid[b, gx+dx, gy] - b*ccap      (hit: valid, in the grid, a column)
//   per dy: words, start = the dy slab of packed[b*ccap + cid]
//     rank0 = rank of bit bz (bz clipped to [0, 448)), bit[0] its bit
//     bit[+-d] = bit at clip(bz +- d) (d = 1..r)
//     rank[d] = rank[d-1] + bit[d-1];  rank[-d] = rank[-(d-1)] - bit[-d]
//     nbr[(dx, dy, dz), i] = start + rank[dz] + b*cap_a where hit, bz+dz
//       in [0, 448), bit[dz] set and 0 <= start + rank[dz] < cap_a; else -1
//   conv9[(dx, dy), i] = nbr[(dx, dy, 0), i] for |dx|, |dy| <= 1
//
// which is lidog_tpu's integer arithmetic step for step (its row-blocked
// grid lookup, GRID_ROW_W, reads the same cell; its bit reads at clipped
// positions are masked afterwards by the unclipped range), so the maps are
// bitwise equal.
//
// Bound on an H100: bytes.  The outputs (134 int32 per row: 263 MB at the
// training plan's 491,520 rows) dominate; the inputs it must read are the
// grid cells and packed rows the rows look up (neighbouring rows share
// them).
//
// Design: one thread per (row, dx): one grid read, then one packed row
// (5 slabs of 15 words) read and resolved with __popc; stores of the 25
// (dy, dz) entries are coalesced across the block's rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ZWORDS = 14;
constexpr int ZC = ZWORDS * 16;
constexpr int ZMAX = ZWORDS * 32;
constexpr int R = 2;
constexpr int D = 2 * R + 1;
constexpr int NT = 128;

__device__ __forceinline__ unsigned word_at(const unsigned (&w)[ZWORDS], int widx) {
  unsigned v = 0;
#pragma unroll
  for (int q = 0; q < ZWORDS; ++q) v = (q == widx) ? w[q] : v;
  return v;
}

__device__ __forceinline__ int bit_at(const unsigned (&w)[ZWORDS], int bz) {
  const int z = min(max(bz, 0), ZMAX - 1);
  return (int)((word_at(w, z >> 5) >> (z & 31)) & 1u);
}

__global__ void __launch_bounds__(NT)
stem_feat125_kernel(const int* __restrict__ grid, const int* __restrict__ packed,
                    const int4* __restrict__ coords, const uint8_t* __restrict__ valid,
                    int* __restrict__ nbr, int* __restrict__ conv9, int n, int cap_q, int g,
                    int ccap, int cap_a, int grid_half, int level, int width, int aug_off) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  const int dxi = blockIdx.y;
  const int dx = dxi - R;
  const int b = i / cap_q;
  const int4 c = coords[i];
  const int gh = grid_half >> level;
  const int gx0 = (c.y >> level) + gh;
  const int gy0 = (c.z >> level) + gh;
  const int bz0 = (c.w >> level) + ZC;
  const int gxn = gx0 + dx;
  long long cid = -1;
  if (valid[i] && gxn >= 0 && gxn < g && gy0 >= 0 && gy0 < g) {
    const int v = grid[((long long)b * g + gxn) * g + gy0];
    cid = v >= 0 ? v - (long long)b * ccap : -1;
  }
  const bool hit = cid >= 0 && cid < ccap;
  const int* row = packed + ((long long)b * ccap + (hit ? cid : 0)) * width + aug_off;
  const int seg = b * cap_a;
  const int bzc = min(max(bz0, 0), ZMAX - 1);

#pragma unroll
  for (int dyi = 0; dyi < D; ++dyi) {
    int out[D];
#pragma unroll
    for (int q = 0; q < D; ++q) out[q] = -1;
    if (hit) {
      const int* slab = row + (ZWORDS + 1) * dyi;
      unsigned w[ZWORDS];
#pragma unroll
      for (int q = 0; q < ZWORDS; ++q) w[q] = (unsigned)slab[q];
      const long long start = (long long)slab[ZWORDS];
      const int wi = bzc >> 5, ib = bzc & 31;
      int below = 0;
#pragma unroll
      for (int q = 0; q < ZWORDS; ++q) below += (q < wi) ? __popc(w[q]) : 0;
      const unsigned ws = word_at(w, wi);
      int bit[D], rank[D];
      rank[R] = below + __popc(ws & (ib > 0 ? (1u << ib) - 1u : 0u));
      bit[R] = (int)((ws >> ib) & 1u);
#pragma unroll
      for (int d = 1; d <= R; ++d) {
        bit[R + d] = bit_at(w, bz0 + d);
        bit[R - d] = bit_at(w, bz0 - d);
      }
#pragma unroll
      for (int d = 1; d <= R; ++d) {
        rank[R + d] = rank[R + d - 1] + bit[R + d - 1];
        rank[R - d] = rank[R - d + 1] - bit[R - d];
      }
#pragma unroll
      for (int q = 0; q < D; ++q) {
        const int bzd = bz0 + q - R;
        const long long idx = start + rank[q];
        if (bzd >= 0 && bzd < ZMAX && bit[q] == 1 && idx >= 0 && idx < cap_a)
          out[q] = (int)idx + seg;
      }
    }
#pragma unroll
    for (int q = 0; q < D; ++q) nbr[(size_t)((dxi * D + dyi) * D + q) * n + i] = out[q];
    if (dx >= -1 && dx <= 1 && dyi >= R - 1 && dyi <= R + 1)
      conv9[(size_t)((dx + 1) * 3 + (dyi - R + 1)) * n + i] = out[R];
  }
}
}  // namespace

// Returns a cudaError_t (0 = launched).
extern "C" int stem_feat125(const void* grid, const void* packed, const void* coords,
                            const void* valid, void* nbr, void* conv9, int n, int nb, int g,
                            int ccap, int cap_a, int grid_half, int level, int width,
                            int aug_off, void* stream) {
  if (n < 0 || nb < 1 || n % nb != 0 || g < 1 || ccap < 1 || cap_a < 1 || level < 0 ||
      aug_off < 0 || width < aug_off + D * (ZWORDS + 1) ||
      reinterpret_cast<uintptr_t>(coords) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const dim3 blocks((n + NT - 1) / NT, D);
  stem_feat125_kernel<<<blocks, NT, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(grid), static_cast<const int*>(packed),
      static_cast<const int4*>(coords), static_cast<const uint8_t*>(valid),
      static_cast<int*>(nbr), static_cast<int*>(conv9), n, n / nb, g, ccap, cap_a, grid_half,
      level, width, aug_off);
  return (int)cudaGetLastError();
}

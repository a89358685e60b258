// KR, KS, KT, KU: the zseg plan's query sweeps, everything downstream of
// the column tables (core/zseg.py: the cell -> column id grid, the real
// and aug z-bit words per y-dilated column slot, the slots' packed (b, gx,
// gy) and validity).
//
//   KU build_packed       replaces lidog_tpu/core/zseg.py:378 (_build_packed)
//   KR stem_conv9_packed  replaces lidog_tpu/core/zseg.py:446 (stem_conv9_packed)
//   KS conv9_packed       replaces lidog_tpu/core/zseg.py:631 (conv9_packed)
//   KT pos3_lookup        replaces lidog_tpu/core/zseg.py:682 (pos3_lookup)
//
// Each output is bitwise equal to the plain version in core/zseg.py: the
// integer steps are the plain version's one for one (z-bit words are
// uint32 values in int32 tables, as in lidog_tpu: the real words (real16
// [slots, 16]: 14 words, 2 zero pad words), the aug words (aug16 [slots,
// 16]: words, GLOBAL start, count) and the packed table; ranks are __popc
// counts).
//
//   KU: per slot s: the words of the rows dy slots away (dy = -r..r real
//       slabs of ZWORDS words, then dy = -aug_r..aug_r aug slabs of ZWORDS
//       words + the LOCAL start row, start - b*cap_a where the source slot
//       is valid), where every slot pair between s and s+dy is y-adjacent
//       (same b, gx and gy+1, both valid), else 0; then zeros up to a
//       multiple of 8 words (lidog_tpu's pad).
//   KR: per level-0 row and dx = -2..2: the column (gx+dx, gy) through the
//       grid (the row's segment is row / (N / nb); only gx+dx is range
//       checked), then per dy the 5 z bits around bz from the real slab,
//       shifted into one window word (lo = bz-2 may be negative: arithmetic
//       >> 5, & 31 on the two's complement; words outside [0, ZWORDS) read
//       0; bits outside [0, ZMAX) are 0) -> occ bf16 [N, 125] in (dx, dy,
//       dz) order; and for |dx|, |dy| <= 1 the aug rank of bz -> conv9.
//   KS: the conv9 ranks of KR at levels 1-4 from the aug-only table.
//   KT: per source row: its own column's aug row (segment from coords[:, 0],
//       gx and gy range checked), the ranks at z-s, z, z+s from one rank
//       and two bit reads (rank(z+s) = rank(z) + bit(z), rank(z-s) =
//       rank(z) - bit(z-s)); -1 where the bit is clear, z is outside the
//       column or the row falls past the segment's cap_a rows -> pos3 int32
//       [3, n], as lidog_tpu's.
//
// Bound on an H100: bytes.  KU reads the real words and aug16 (int32, 50
// MB each at the training plan's level 0) and writes its table (377 MB
// there: 786,432 slots x 120 int32); KR writes 134 x 2-4 bytes per row; KS
// and KT read a grid cell or a column id and a table row per (row, dx)
// and write 9 or 3 int32 per row.
//
// Design: KU a block per KU_TILE consecutive slots: the tile's source rows
// and a halo of R = max(r, aug_r) slots each side are staged once in
// shared memory (coalesced loads; the local start fixed there once per aug
// row), each slot's dy adjacency becomes one bitmask, and every thread
// owns one 16-byte column group of the rows, which it writes for a run of
// the tile's rows (32-bit indices, no division in that loop; a warp's
// stores are one contiguous span).  KR/KS one thread per (row, dx): one
// grid read, one table row read with __popc ranks; KR stages its occupancy
// bits for 64 rows in shared memory and stores them as one contiguous
// span.  KT one thread per source row (each load and store of a warp
// contiguous but the aug16 row's): the row's coords, valid flag and
// column id, then its aug16 row as 4 16-byte loads, its bits read in one
// unrolled pass with constant indices (the row stays in registers).
#include <cuda_runtime.h>
#include <stdint.h>

#include "zseg_rows.cuh"

namespace {

constexpr int SLAB = ZWORDS + 1;  // aug slab: words + start
constexpr int ROWS = 64;           // KR/KS rows per block
constexpr int STEM_R = 2;
constexpr int STEM_K = (2 * STEM_R + 1) * (2 * STEM_R + 1) * (2 * STEM_R + 1);
constexpr uint16_t BF16_ONE = 0x3F80;
constexpr int MAX_R = 4;             // KU's largest shift (core/zseg.py _KU_MAX_R)
constexpr int KU_TILE = 128;         // KU's slots per block
constexpr int KU_THREADS = 256;
constexpr int STAGE = 2 * ZWORDS + 1;  // a staged slot: real words | aug words + start
constexpr int KT_THREADS = 256;

// start + rank of bit bz in an aug slab (words, start), or -1 where the
// row missed, bz is outside [0, ZMAX), the bit is clear or the position
// is outside [0, cap_a) (core/zseg.py _rank_in_slab, _aug_ranks).
__device__ __forceinline__ long long slab_rank(const int* slab, int bz, bool hit,
                                               int cap_a) {
  if (!hit || bz < 0 || bz >= ZMAX) return -1;
  const int wi = bz >> 5, ib = bz & 31;
  int below = 0;
  for (int q = 0; q < wi; ++q) below += __popc((unsigned)slab[q]);
  const unsigned w = (unsigned)slab[wi];
  if (!((w >> ib) & 1u)) return -1;
  const long long idx = (long long)slab[ZWORDS] + below + __popc(w & ((1u << ib) - 1u));
  return (idx >= 0 && idx < cap_a) ? idx : -1;
}

// KR (STEM, DXR = 2) and KS (DXR = 1): block (ROWS, 2*DXR+1), thread (row, dx).
template <int DXR, bool STEM>
__global__ void __launch_bounds__(ROWS*(2 * DXR + 1))
sweep_kernel(const int* __restrict__ grid, const int* __restrict__ packed,
             const int4* __restrict__ coords, const uint8_t* __restrict__ valid,
             uint16_t* __restrict__ occ, int* __restrict__ conv9, int n, int nb, int g, int ccap,
             int cap_a, int grid_half, int level, int width, int aug_off) {
  __shared__ __align__(16) uint16_t tile[STEM ? ROWS * STEM_K : 2];
  const int i = blockIdx.x * ROWS + threadIdx.x;
  const int dxi = threadIdx.y;
  const int dx = dxi - DXR;
  if (i < n) {
    const int b = i / (n / nb);
    const int4 c = coords[i];
    const int gh = grid_half >> level;
    const int gx0 = (c.y >> level) + gh;
    const int gy0 = (c.z >> level) + gh;
    const int bz0 = (c.w >> level) + ZC;
    const int gxn = gx0 + dx;
    long long cid = -1;
    if (valid[i] && gxn >= 0 && gxn < g) {
      // gy0 is not range checked (as in the plain version): a level's rows
      // lie inside its grid; the read is guarded all the same
      const long long flat = ((long long)b * g + gxn) * g + gy0;
      if (flat >= 0 && flat < (long long)nb * g * g) {
        const int v = grid[flat];
        cid = v >= 0 ? v - (long long)b * ccap : -1;
      }
    }
    const bool hit = cid >= 0 && cid < ccap;
    const int* row = packed + ((long long)b * ccap + (hit ? cid : 0)) * width;
    if (STEM) {
      const int lo = bz0 - STEM_R;
      const int wlo = lo >> 5;  // arithmetic shift
      const int shl = lo & 31;
      uint16_t* t = tile + threadIdx.x * STEM_K + dxi * (2 * STEM_R + 1) * (2 * STEM_R + 1);
#pragma unroll
      for (int dyi = 0; dyi < 2 * STEM_R + 1; ++dyi) {
        const int* slab = row + ZWORDS * dyi;
        const unsigned w0 = (hit && wlo >= 0 && wlo < ZWORDS) ? (unsigned)slab[wlo] : 0u;
        const unsigned w1 =
            (hit && wlo + 1 >= 0 && wlo + 1 < ZWORDS) ? (unsigned)slab[wlo + 1] : 0u;
        const unsigned win = (w0 >> shl) | (shl == 0 ? 0u : (w1 << (32 - shl)));
#pragma unroll
        for (int k = 0; k < 2 * STEM_R + 1; ++k) {
          const int bz = lo + k;
          const bool on = hit && bz >= 0 && bz < ZMAX && ((win >> k) & 1u);
          t[dyi * (2 * STEM_R + 1) + k] = on ? BF16_ONE : 0;
        }
      }
    }
    if (dx >= -1 && dx <= 1) {
      const long long seg = (long long)b * cap_a;
#pragma unroll
      for (int dyi = 0; dyi < 3; ++dyi) {
        const long long idx = slab_rank(row + aug_off + SLAB * dyi, bz0, hit, cap_a);
        conv9[(size_t)((dx + 1) * 3 + dyi) * n + i] = idx >= 0 ? (int)(idx + seg) : -1;
      }
    }
  }
  if (STEM) {  // the block's rows of occ are one contiguous span
    __syncthreads();
    const int r0 = blockIdx.x * ROWS;
    const int nrows = min(ROWS, n - r0);
    const int count = nrows * STEM_K;  // bf16 values; r0 * STEM_K is even
    const int tid = threadIdx.y * ROWS + threadIdx.x;
    const int nthreads = ROWS * (2 * DXR + 1);
    uint32_t* dst = reinterpret_cast<uint32_t*>(occ + (size_t)r0 * STEM_K);
    const uint32_t* src = reinterpret_cast<const uint32_t*>(tile);
    for (int q = tid; q < count / 2; q += nthreads) dst[q] = src[q];
    if ((count & 1) && tid == 0) occ[(size_t)r0 * STEM_K + count - 1] = tile[count - 1];
  }
}

// KT: one source row a thread; its coords, valid flag and column id are
// loaded before its aug16 row (4 16-byte loads).
__global__ void __launch_bounds__(KT_THREADS)
pos3_kernel(const int4* __restrict__ aug16, int slots, const int4* __restrict__ coords,
            const uint8_t* __restrict__ valid, const long long* __restrict__ cid,
            int* __restrict__ out, int n, int g, int cap_a, int grid_half, int level) {
  const int i = blockIdx.x * KT_THREADS + threadIdx.x;
  if (i >= n) return;
  const int gh = grid_half >> level;
  const int4 c = coords[i];
  const bool valid_i = valid[i];
  const long long v = cid[i];
  const int gx0 = (c.y >> level) + gh, gy0 = (c.z >> level) + gh;
  const bool ok = valid_i && gx0 >= 0 && gx0 < g && gy0 >= 0 && gy0 < g;
  // a hit (cid >= 0) past the table reads a zero row (the plain version's
  // miss row); cd: its slot, -1 for no row, -2 for a zero row
  const int cd = !ok || v < 0 ? -1 : v < slots ? (int)v : -2;
  int4 w[4];  // the aug16 row: words 0-13, start, count
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = cd >= 0 ? aug16[cd * 4 + k] : make_int4(0, 0, 0, 0);
  const unsigned wd[ZWORDS] = {
      (unsigned)w[0].x, (unsigned)w[0].y, (unsigned)w[0].z, (unsigned)w[0].w,
      (unsigned)w[1].x, (unsigned)w[1].y, (unsigned)w[1].z, (unsigned)w[1].w,
      (unsigned)w[2].x, (unsigned)w[2].y, (unsigned)w[2].z, (unsigned)w[2].w,
      (unsigned)w[3].x, (unsigned)w[3].y};
  const long long start = w[3].z;  // 0 on a miss
  const bool hit = cd != -1;
  const int bz0 = (c.w >> level) + ZC;
  // the words holding bits bz0 and bz0 -+ 1 (each z clamped into the
  // column) and the rank of bz0, in one pass over the words with only
  // constant indices (no local-memory copy of the row)
  const int z0 = min(max(bz0, 0), ZMAX - 1), zm = min(max(bz0 - 1, 0), ZMAX - 1),
            zp = min(max(bz0 + 1, 0), ZMAX - 1);
  unsigned v0 = 0, vm = 0, vp = 0;
  int rank0 = 0;
#pragma unroll
  for (int q = 0; q < ZWORDS; ++q) {
    const unsigned x = wd[q];
    v0 = q == (z0 >> 5) ? x : v0;
    vm = q == (zm >> 5) ? x : vm;
    vp = q == (zp >> 5) ? x : vp;
    rank0 += __popc(q < (z0 >> 5) ? x : q == (z0 >> 5) ? (x & ((1u << (z0 & 31)) - 1u)) : 0u);
  }
  const int ex0 = (v0 >> (z0 & 31)) & 1u, bm1 = (vm >> (zm & 31)) & 1u,
            bp1 = (vp >> (zp & 31)) & 1u;
  const long long seg_base = (long long)c.x * cap_a;
  const int rank[3] = {rank0 - bm1, rank0, rank0 + ex0};
  const int ex[3] = {bm1, ex0, bp1};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int bzd = bz0 + d - 1;
    const long long idx = start + rank[d];
    const bool okr = hit && bzd >= 0 && bzd < ZMAX && ex[d] == 1 && idx >= 0 &&
                     (idx - seg_base) < cap_a;
    out[(size_t)d * n + i] = okr ? (int)idx : -1;
  }
}

// KU: one block per KU_TILE slots.  Dynamic shared memory: the staged
// rows [KU_TILE + 2R][STAGE] (words as uint32), each staged slot's
// adjacency to the next, and each tile slot's dy mask (bit dy + R).
__global__ void __launch_bounds__(KU_THREADS)
build_packed_kernel(const int* __restrict__ real_w, const int* __restrict__ aug16,
                    const long long* __restrict__ bxy, const uint8_t* __restrict__ cvalid,
                    int* __restrict__ out, int slots, int ccap, int cap_a, int r, int aug_r,
                    int width) {
  extern __shared__ unsigned sm[];
  const int R = max(r, aug_r);
  const int span = KU_TILE + 2 * R;
  unsigned* mask_s = sm + span * STAGE;             // [KU_TILE]
  uint8_t* adj_s = reinterpret_cast<uint8_t*>(mask_s + KU_TILE);  // [span]
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * KU_TILE;
  const int u0 = s0 - R;  // the slot of staged row 0
  const int nrows = min(KU_TILE, slots - s0);
  // stage the real words (16-byte quarters of real16 rows, a contiguous
  // span; the pad words are not staged)
  if (r >= 0) {
    for (int k = tid; k < span * 4; k += KU_THREADS) {
      const int i = k >> 2;
      stage_real16(sm + i * STAGE, reinterpret_cast<const int4*>(real_w), u0 + i, slots, k & 3);
    }
  }
  // the aug words and the start (16-byte loads of aug16 rows), the start
  // made local once per staged row; the adjacency of each staged slot
  for (int k = tid; k < span * 4; k += KU_THREADS) {
    const int i = k >> 2, c = k & 3;
    const int u = u0 + i;
    int4 v = make_int4(0, 0, 0, 0);
    if (u >= 0 && u < slots) {
      v = reinterpret_cast<const int4*>(aug16)[(size_t)u * 4 + c];
      if (c == 3 && cvalid[u])  // word 14, the start: int32 wrap as lidog_tpu's
        v.z = (int)((unsigned)v.z - (unsigned)((u / ccap) * cap_a));
    }
    unsigned* dst = sm + i * STAGE + ZWORDS + 4 * c;
    dst[0] = (unsigned)v.x;
    dst[1] = (unsigned)v.y;
    dst[2] = (unsigned)v.z;
    if (c < 3) dst[3] = (unsigned)v.w;  // word 15 (the count) is not a slab word
  }
  for (int i = tid; i < span; i += KU_THREADS) {
    const int u = u0 + i;
    adj_s[i] = u >= 0 && u + 1 < slots && cvalid[u] && cvalid[u + 1] && bxy[u + 1] == bxy[u] + 1;
  }
  __syncthreads();
  // each tile slot's dy mask: dy is taken where every pair between is adjacent
  for (int t = tid; t < nrows; t += KU_THREADS) {
    const int c = t + R;
    unsigned m = 1u << R;
    bool ok = true;
    for (int dy = 1; dy <= R; ++dy) {
      ok = ok && adj_s[c + dy - 1];
      m |= ok ? 1u << (R + dy) : 0u;
    }
    ok = true;
    for (int dy = 1; dy <= R; ++dy) {
      ok = ok && adj_s[c - dy];
      m |= ok ? 1u << (R - dy) : 0u;
    }
    mask_s[t] = m;
  }
  __syncthreads();
  // this thread's 16-byte column group: each word's staged offset from the
  // slot's row and its dy bit (-1: padding)
  const int w4 = width >> 2;
  const int rstep = KU_THREADS / w4;
  if (tid >= rstep * w4) return;
  const int c4 = tid % w4, row0 = tid / w4;
  const int nreal = r >= 0 ? (2 * r + 1) * ZWORDS : 0;
  const int naug = (2 * aug_r + 1) * SLAB;
  int off[4], bit[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = 4 * c4 + e;
    int dy = 0, col = 0;
    bit[e] = -1;
    if (j < nreal) {
      dy = j / ZWORDS - r;
      col = j % ZWORDS;
      bit[e] = dy + R;
    } else if (j < nreal + naug) {
      dy = (j - nreal) / SLAB - aug_r;
      col = ZWORDS + (j - nreal) % SLAB;
      bit[e] = dy + R;
    }
    off[e] = (R + dy) * STAGE + col;
  }
  int* dst = out + s0 * width + 4 * c4;
  for (int t = row0; t < nrows; t += rstep) {
    const unsigned m = mask_s[t];
    const unsigned* src = sm + t * STAGE;
    int v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = (bit[e] >= 0 && ((m >> bit[e]) & 1u)) ? (int)src[off[e]] : 0;
    *reinterpret_cast<int4*>(dst + t * width) = make_int4(v[0], v[1], v[2], v[3]);
  }
}

cudaStream_t as_stream(void* stream) { return reinterpret_cast<cudaStream_t>(stream); }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Each function returns a cudaError_t (0 = launched).

// KR: occ bf16 [n, 125] (raw bits), conv9 int32 [9, n] from the int32
// grid [nb*g*g] and the int32 packed table [nb*ccap, width] with 5 real
// slabs and 3 aug slabs at aug_off.
extern "C" int stem_conv9_packed(const void* grid, const void* packed, const void* coords,
                                 const void* valid, void* occ, void* conv9, int n, int nb, int g,
                                 int ccap, int cap_a, int grid_half, int level, int width,
                                 int aug_off, void* stream) {
  if (n < 0 || nb < 1 || n % nb != 0 || g < 1 || ccap < 1 || cap_a < 1 || level < 0 ||
      aug_off < (2 * STEM_R + 1) * ZWORDS || width < aug_off + 3 * SLAB || !aligned16(coords) ||
      reinterpret_cast<uintptr_t>(occ) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const dim3 block(ROWS, 2 * STEM_R + 1);
  sweep_kernel<STEM_R, true><<<(n + ROWS - 1) / ROWS, block, 0, as_stream(stream)>>>(
      static_cast<const int*>(grid), static_cast<const int*>(packed),
      static_cast<const int4*>(coords), static_cast<const uint8_t*>(valid),
      static_cast<uint16_t*>(occ), static_cast<int*>(conv9), n, nb, g, ccap, cap_a, grid_half,
      level, width, aug_off);
  return (int)cudaGetLastError();
}

// KS: conv9 int32 [9, n] from the aug-only int32 packed table [nb*ccap,
// width].
extern "C" int conv9_packed(const void* grid, const void* packed, const void* coords,
                            const void* valid, void* conv9, int n, int nb, int g, int ccap,
                            int cap_a, int grid_half, int level, int width, void* stream) {
  if (n < 0 || nb < 1 || n % nb != 0 || g < 1 || ccap < 1 || cap_a < 1 || level < 0 ||
      width < 3 * SLAB || !aligned16(coords))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const dim3 block(ROWS, 3);
  sweep_kernel<1, false><<<(n + ROWS - 1) / ROWS, block, 0, as_stream(stream)>>>(
      static_cast<const int*>(grid), static_cast<const int*>(packed),
      static_cast<const int4*>(coords), static_cast<const uint8_t*>(valid), nullptr,
      static_cast<int*>(conv9), n, nb, g, ccap, cap_a, grid_half, level, width, 0);
  return (int)cudaGetLastError();
}

// KT: out int32 [3, n] from aug16 int32 [slots, 16] (16-byte aligned) and
// each row's column id (int64).
extern "C" int pos3_lookup(const void* aug16, const void* coords, const void* valid,
                           const void* cid, void* out, int n, int slots, int g, int cap_a,
                           int grid_half, int level, void* stream) {
  if (n < 0 || slots < 0 || (long long)slots * AUG16 >= 0x7FFFFFFFLL || g < 1 || cap_a < 1 ||
      level < 0 || !aligned16(coords) || !aligned16(aug16) || (long long)n * 3 >= 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  pos3_kernel<<<(n + KT_THREADS - 1) / KT_THREADS, KT_THREADS, 0, as_stream(stream)>>>(
      static_cast<const int4*>(aug16), slots, static_cast<const int4*>(coords),
      static_cast<const uint8_t*>(valid), static_cast<const long long*>(cid),
      static_cast<int*>(out), n, g, cap_a, grid_half, level);
  return (int)cudaGetLastError();
}

// KU: out int32 [slots, width] from real_w int32 [slots, 16] and aug16
// int32 [slots, 16] (both 16-byte aligned), col_bxy int64 and col_valid
// bool [slots];
// width = max(2r+1, 0)*14 + (2*aug_r+1)*15 rounded up to a multiple of 8.
extern "C" int build_packed(const void* real_w, const void* aug16, const void* col_bxy,
                            const void* col_valid, void* out, int slots, int ccap, int cap_a,
                            int r, int aug_r, int width, void* stream) {
  const int w = (r >= 0 ? (2 * r + 1) * ZWORDS : 0) + (2 * aug_r + 1) * SLAB;
  if (slots < 0 || ccap < 1 || cap_a < 1 || r < -1 || aug_r < 0 || aug_r > max(r, 1) ||
      max(r, aug_r) > MAX_R || width != (w + 7) / 8 * 8 || !aligned16(aug16) ||
      !aligned16(real_w) || !aligned16(out) || (long long)slots * width >= 0x7FFFFFFFLL ||
      (long long)slots * REAL_W >= 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  if (slots == 0) return 0;
  const int R = max(r, aug_r);
  const int span = KU_TILE + 2 * R;
  const size_t smem = (size_t)span * STAGE * 4 + KU_TILE * 4 + span;
  build_packed_kernel<<<(slots + KU_TILE - 1) / KU_TILE, KU_THREADS, smem, as_stream(stream)>>>(
      static_cast<const int*>(real_w), static_cast<const int*>(aug16),
      static_cast<const long long*>(col_bxy), static_cast<const uint8_t*>(col_valid),
      static_cast<int*>(out), slots, ccap, cap_a, r, aug_r, width);
  return (int)cudaGetLastError();
}

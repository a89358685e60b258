// KV, KW, KX, KY: the zseg plan's column tables, everything upstream of
// the query sweeps (csrc/zseg_sweeps.cu) per level of the plan build.
//
//   KV column_grid   replaces lidog_tpu/core/zseg.py:271 (_column_grid),
//                    :288 (_grid_from_has), :300 (_dilate_y), :106
//                    (_cumsum_excl_axis1), :129 (_grid_lookup, K3,
//                    inlined) and the column stamp of __call__:863-914
//   KW real_words    replaces __call__:916-979 and :234 (_zpair_words)
//   KX assemble_aug  replaces :335 (_assemble_aug) with :316-333, :223, :256
//   KY emit_rows     replaces __call__:1004-1026, 1049-1100 and :735-770
//
// Each output is bitwise equal to its plain version in core/zseg.py
// (column_grid_plain, real_words_plain, assemble_aug_plain,
// emit_rows_plain): the integer steps are the plain version's one for one.
// z-bit words are uint32 values held in int64 tables; counts and scans are
// integer sums, exact in any order; overflow terms are added with int32
// atomics, which wrap as the plain version's int64 sum cast to int32 does.
//
//   KV: (1) one thread per source row stamps its cell's has flag (an
//       idempotent byte store) and, on unique level-0 input, counts the
//       scan's real rows; (2) one block per (b, gx) row of g cells dilates
//       the row along gy by +-r in shared memory (never across gx rows),
//       in place, and counts it; (3) one block per scan: the exclusive
//       scan of its g row counts, the columns past ccap and the real rows
//       past cap_real into overflow; (4) one block per row: the in-row
//       scan, grid = cloc + b*ccap where dilated and cloc < ccap, else -1;
//       (5) one thread per source row: its column id (vox_cid), the rows
//       lost to the cap into overflow, and the 2r+1 slot stamps of packed
//       (b, gx, gy+dy) under the segment guard.  Every writer of a slot
//       writes the same value (the slot is the column of that cell).
//   KW: level 0, unique input: atomicAdd of the bit on the word's low 32
//       bits (the plain scatter-add mod 2^32); sortless input: atomicOr,
//       counting the bits that were new per scan, then one block adds the
//       deduped voxels past cap_real to overflow[0].  Levels 1-4: one
//       thread per slot ORs its 4 child columns' words in the finer level's
//       tables and coarsens them (_zpair_words).
//   KX: (1) one thread per slot: yor3 = own | y-adjacent slots' words
//       (uint32 scratch); (2) one block per 256 slots of a scan: own words,
//       the two x-neighbours' yor3 through the grid, ghost words, popcount,
//       the block's popcount sum; (3) one block per scan: the exclusive
//       scan of the block sums, counts_b and the rows past cap_a into
//       overflow; (4) the in-block scan: global start = block offset +
//       prefix + b*cap_a.
//   KY: (1) one thread per source row: its 3 candidates' packed
//       gxgy << 9 | bz (uint32 wrap) scattered to their aug rows, the real
//       flag, and pos (+ rep by atomicMin) at level 0, parent, off and the
//       down8 transpose above; (2) one thread per aug row decodes rows
//       j-1, j, j+1: coords, valid, real &= valid, zup and zdn.
//
// Every step is a separate launch on the caller's stream, so each reads
// the previous step's complete output.  Device-wide scans are reduce-then-
// scan with a warp-shuffle block scan; no library scan.
//
// Bound on an H100: bytes.  KV writes the int64 grid (B*g*g*8: 134 MB at
// the training plan's level 0), the others their tables and rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ZWORDS = 14;
constexpr int ZC = ZWORDS * 16;
constexpr int ZMAX = ZWORDS * 32;
constexpr int AUG16 = ZWORDS + 2;  // aug16 row: words + start + count
constexpr int NUM_LEVELS = 5;
constexpr int THREADS = 256;      // per-thread launches; KX's slots per block
constexpr int SCAN_THREADS = 1024;
constexpr int REP_NONE = 0x7FFFFFFF;

// core/bitgrid.py _cell_of + the row's ok flag.
struct Cell {
  int b, gx, gy, bz;
  bool ok;
};

__device__ __forceinline__ Cell cell_of(int4 c, bool valid, int grid_half, int level) {
  const int g = (2 * grid_half) >> level;
  Cell r;
  r.b = c.x;
  r.gx = (c.y >> level) + (grid_half >> level);  // arithmetic shifts
  r.gy = (c.z >> level) + (grid_half >> level);
  r.bz = (c.w >> level) + ZC;
  r.ok = valid && r.gx >= 0 && r.gx < g && r.gy >= 0 && r.gy < g && r.bz >= 0 && r.bz < ZMAX;
  return r;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// Exclusive prefix of v over the block (blockDim.x a multiple of 32);
// *total gets the block's sum.  Every thread of the block must call it.
template <typename T>
__device__ T block_exclusive_scan(T v, T* total) {
  __shared__ T warp_sum[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nwarps ? warp_sum[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sum[lane] = w;  // inclusive prefixes of the warp sums
  }
  __syncthreads();
  const T before = (warp > 0 ? warp_sum[warp - 1] : T(0)) + x - v;
  *total = warp_sum[nwarps - 1];
  __syncthreads();  // warp_sum is reused by the next call
  return before;
}

// Exclusive scan of in[0, n) into out (may alias in), plus base; returns
// the sum.  One block; every thread must call it.
__device__ long long block_scan_span(const long long* in, long long* out, long long n,
                                     long long base) {
  long long carry = base;
  for (long long k0 = 0; k0 < n; k0 += blockDim.x) {
    const long long k = k0 + threadIdx.x;
    const long long v = k < n ? in[k] : 0;
    long long tot;
    const long long ex = block_exclusive_scan(v, &tot);
    if (k < n) out[k] = carry + ex;
    carry += tot;
  }
  return carry - base;
}

// Add, per warp, the flags of its threads to counter[key] (one atomic per
// distinct key among the flagged threads).  Every thread of the warp must
// call it.
template <typename T>
__device__ __forceinline__ void warp_count(bool flag, long long key, T* counter) {
  const unsigned flagged = __ballot_sync(0xffffffffu, flag);
  if (!flag) return;
  const unsigned same = __match_any_sync(flagged, key);
  if ((int)(__ffs(same) - 1) == (int)(threadIdx.x & 31))
    atomicAdd(counter + key, (T)__popc(same));
}

// KV (1): has flags; real rows per scan on unique level-0 input.
__global__ void has_kernel(const int4* __restrict__ coords, const uint8_t* __restrict__ valid,
                           int8_t* __restrict__ has, unsigned long long* __restrict__ nreal,
                           int n, int nb, int grid_half, int level, bool count_real) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = (2 * grid_half) >> level;
  bool ok = false;
  int b = 0;
  if (i < n) {
    const Cell c = cell_of(coords[i], valid[i], grid_half, level);
    ok = c.ok && c.b >= 0 && c.b < nb;
    b = c.b;
    if (ok) has[((long long)c.b * g + c.gx) * g + c.gy] = 1;
  }
  if (count_real) warp_count(ok, ok ? b : 0, nreal);
}

// KV (2): one block per (b, gx) row: dilate along gy by +-r, count.
__global__ void dilate_kernel(int8_t* __restrict__ has, long long* __restrict__ row_count, int g,
                              int r) {
  extern __shared__ int8_t row_s[];
  int8_t* h = has + (long long)blockIdx.x * g;
  for (int k = threadIdx.x; k < g; k += blockDim.x) row_s[k] = h[k];
  __syncthreads();
  long long cnt = 0;
  for (int k = threadIdx.x; k < g; k += blockDim.x) {
    int8_t v = 0;
    for (int d = -r; d <= r; ++d) {
      const int q = k + d;
      if (q >= 0 && q < g) v |= row_s[q];
    }
    h[k] = v;
    cnt += v;
  }
  long long tot;
  block_exclusive_scan(cnt, &tot);
  if (threadIdx.x == 0) row_count[blockIdx.x] = tot;
}

// KV (3): one block per scan: row offsets; column and real-row overflow.
__global__ void row_scan_kernel(const long long* __restrict__ row_count,
                                long long* __restrict__ row_off,
                                const unsigned long long* __restrict__ nreal,
                                int* __restrict__ overflow, int g, int ccap, int level,
                                int cap_real) {
  const long long b = blockIdx.x;
  const long long ncols = block_scan_span(row_count + b * g, row_off + b * g, g, 0);
  if (threadIdx.x == 0) {
    atomicAdd(overflow + 1 + level, (int)max(ncols - ccap, 0LL));
    if (cap_real >= 0) atomicAdd(overflow, (int)max((long long)nreal[b] - cap_real, 0LL));
  }
}

// KV (4): one block per (b, gx) row: column ids.
__global__ void grid_kernel(const int8_t* __restrict__ has, const long long* __restrict__ row_off,
                            long long* __restrict__ grid, int g, int ccap) {
  const long long row = blockIdx.x;
  const long long base = (row / g) * ccap;
  const int8_t* h = has + row * g;
  long long* out = grid + row * g;
  long long carry = row_off[row];
  for (int k0 = 0; k0 < g; k0 += blockDim.x) {
    const int k = k0 + threadIdx.x;
    const long long v = k < g ? h[k] : 0;
    long long tot;
    const long long cloc = carry + block_exclusive_scan(v, &tot);
    if (k < g) out[k] = (v > 0 && cloc < ccap) ? cloc + base : -1;
    carry += tot;
  }
}

// KV (5): one thread per source row: vox_cid, dropped rows, slot stamps.
__global__ void stamp_kernel(const int4* __restrict__ coords, const uint8_t* __restrict__ valid,
                             const long long* __restrict__ grid, long long* __restrict__ vox_cid,
                             long long* __restrict__ col_bxy, uint8_t* __restrict__ col_valid,
                             int* __restrict__ overflow, int n, int nb, int grid_half, int level,
                             int ccap, int r) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = (2 * grid_half) >> level;
  const long long cells = (long long)nb * g * g, slots = (long long)nb * ccap;
  bool drop = false;
  if (i < n) {
    const Cell c = cell_of(coords[i], valid[i], grid_half, level);
    const int gxc = clampi(c.gx, 0, g - 1), gyc = clampi(c.gy, 0, g - 1);
    const long long bsafe = c.ok ? c.b : 0;
    long long cid = -1;
    if (c.ok) {
      const long long flat = (bsafe * g + gxc) * g + gyc;
      if (flat >= 0 && flat < cells) cid = grid[flat];
    }
    vox_cid[i] = cid;
    drop = c.ok && cid < 0;
    if (cid >= 0) {
      const long long pack0 = (long long)(((unsigned long long)bsafe << 24) |
                                          ((unsigned long long)gxc << 12) | (unsigned long long)gyc);
      const long long seg0 = bsafe * ccap;
      for (int dy = -r; dy <= r; ++dy) {
        const int gyn = gyc + dy;
        const long long slot = cid + dy;
        if (gyn >= 0 && gyn < g && slot >= seg0 && slot < seg0 + ccap && slot >= 0 &&
            slot < slots) {
          const long long v = pack0 + dy;
          col_bxy[slot] = v > 0 ? v : 0;
          col_valid[slot] = v >= 0;
        }
      }
    }
  }
  warp_count(drop, 1 + level, overflow);
}

// KW, level 0: the source rows' bits.
__global__ void real_bits_kernel(const int4* __restrict__ coords, const uint8_t* __restrict__ valid,
                                 const long long* __restrict__ vox_cid,
                                 long long* __restrict__ real_w,
                                 unsigned long long* __restrict__ nreal, int n, int grid_half,
                                 int ccap, long long slots, bool unique) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool fresh = false;
  long long b = 0;
  if (i < n) {
    const long long cid = vox_cid[i];
    const Cell c = cell_of(coords[i], valid[i], grid_half, 0);
    if (c.ok && cid >= 0 && cid < slots) {
      const int word = clampi(c.bz >> 5, 0, ZWORDS - 1);
      const unsigned bit = 1u << (c.bz & 31);
      // the word's low 32 bits (little endian); the high ones stay 0
      unsigned* w = reinterpret_cast<unsigned*>(real_w + cid * ZWORDS + word);
      if (unique) {
        atomicAdd(w, bit);
      } else {
        fresh = !(atomicOr(w, bit) & bit);
        b = cid / ccap;
      }
    }
  }
  if (!unique) warp_count(fresh, fresh ? b : 0, nreal);
}

// KW, sortless level 0: the deduped voxels past cap_real into overflow[0].
__global__ void real_over_kernel(const unsigned long long* __restrict__ nreal,
                                 int* __restrict__ overflow, int nb, int cap_real) {
  if (threadIdx.x != 0) return;
  long long over = 0;
  for (int b = 0; b < nb; ++b) over += max((long long)nreal[b] - cap_real, 0LL);
  atomicAdd(overflow, (int)over);
}

// core/bitgrid.py _compress_even_bits.
__device__ __forceinline__ unsigned compress_even(unsigned x) {
  x &= 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  x = (x | (x >> 8)) & 0x0000FFFFu;
  return x;
}

// KW, levels 1-4: one thread per slot: 4 child fetches, then _zpair_words.
__global__ void coarsen_kernel(const long long* __restrict__ col_bxy,
                               const uint8_t* __restrict__ col_valid,
                               const long long* __restrict__ fine_grid,
                               const long long* __restrict__ fine_real,
                               long long* __restrict__ real_w, long long slots,
                               long long fine_slots, int nb, int grid_half, int level) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= slots) return;
  const int f_g = (2 * grid_half) >> (level - 1);
  const long long fine_cells = (long long)nb * f_g * f_g;
  const long long p = col_bxy[s];
  const long long bC = p >> 24, gxC = (p >> 12) & 4095, gyC = p & 4095;
  const bool v = col_valid[s];
  unsigned acc[ZWORDS];
#pragma unroll
  for (int q = 0; q < ZWORDS; ++q) acc[q] = 0u;
#pragma unroll
  for (int cx = 0; cx < 2; ++cx) {
#pragma unroll
    for (int cy = 0; cy < 2; ++cy) {
      const long long gxf = 2 * gxC + cx, gyf = 2 * gyC + cy;
      if (!(v && gxf < f_g && gyf < f_g)) continue;
      const long long flat = (bC * f_g + gxf) * f_g + gyf;
      if (flat < 0 || flat >= fine_cells) continue;
      const long long cidf = fine_grid[flat];
      if (cidf < 0 || cidf >= fine_slots) continue;  // a miss: a zero row
#pragma unroll
      for (int q = 0; q < ZWORDS; ++q) acc[q] |= (unsigned)fine_real[cidf * ZWORDS + q];
    }
  }
  unsigned comp[ZWORDS];
#pragma unroll
  for (int q = 0; q < ZWORDS; ++q) comp[q] = compress_even(acc[q] | (acc[q] >> 1));
#pragma unroll
  for (int k = 0; k < ZWORDS; ++k) {  // word k = comp[2k-7] | comp[2k-6] << 16
    const int lo = 2 * k - ZWORDS / 2, hi = lo + 1;
    const unsigned wl = (lo >= 0 && lo < ZWORDS) ? comp[lo] : 0u;
    const unsigned wh = (hi >= 0 && hi < ZWORDS) ? comp[hi] : 0u;
    real_w[s * ZWORDS + k] = (long long)(wl | (wh << 16));
  }
}

// slot u+1 is (same b, gx, gy+1) and both are valid (_y_adjacency).
__device__ __forceinline__ bool y_adjacent(const long long* bxy, const uint8_t* cvalid,
                                           long long u, long long slots) {
  return u >= 0 && u + 1 < slots && cvalid[u] && cvalid[u + 1] && bxy[u + 1] == bxy[u] + 1;
}

// KX (1): yor3 per slot.
__global__ void yor3_kernel(const long long* __restrict__ real_w,
                            const long long* __restrict__ col_bxy,
                            const uint8_t* __restrict__ col_valid, unsigned* __restrict__ yor3,
                            long long slots) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= slots) return;
  const bool up = y_adjacent(col_bxy, col_valid, s, slots);
  const bool dn = y_adjacent(col_bxy, col_valid, s - 1, slots);
#pragma unroll
  for (int q = 0; q < ZWORDS; ++q) {
    unsigned w = (unsigned)real_w[s * ZWORDS + q];
    if (up) w |= (unsigned)real_w[(s + 1) * ZWORDS + q];
    if (dn) w |= (unsigned)real_w[(s - 1) * ZWORDS + q];
    yor3[s * ZWORDS + q] = w;
  }
}

// KX (2): grid (chunks, nb): aug words and popcount per slot, block sums.
__global__ void aug_kernel(const long long* __restrict__ real_w,
                           const long long* __restrict__ col_bxy,
                           const uint8_t* __restrict__ col_valid,
                           const long long* __restrict__ grid, const unsigned* __restrict__ yor3,
                           long long* __restrict__ aug16, long long* __restrict__ chunk_sum,
                           int nb, int g, int ccap) {
  const long long b = blockIdx.y;
  const int local = blockIdx.x * THREADS + threadIdx.x;
  const long long slots = (long long)nb * ccap, cells = (long long)nb * g * g;
  const long long s = b * ccap + local;
  long long popc = 0;
  if (local < ccap) {
    const long long p = col_bxy[s];
    const bool v = col_valid[s];
    const long long bb = p >> 24, gx = (p >> 12) & 4095, gy = p & 4095;
    unsigned own[ZWORDS], nb_or[ZWORDS];
#pragma unroll
    for (int q = 0; q < ZWORDS; ++q) {
      own[q] = (unsigned)real_w[s * ZWORDS + q];
      nb_or[q] = yor3[s * ZWORDS + q];
    }
#pragma unroll
    for (int dx = -1; dx <= 1; dx += 2) {
      const long long gxn = gx + dx;
      if (!(v && gxn >= 0 && gxn < g)) continue;
      const long long flat = (bb * g + gxn) * g + gy;
      if (flat < 0 || flat >= cells) continue;
      const long long cidn = grid[flat];
      if (cidn < 0 || cidn >= slots) continue;
#pragma unroll
      for (int q = 0; q < ZWORDS; ++q) nb_or[q] |= yor3[cidn * ZWORDS + q];
    }
#pragma unroll
    for (int q = 0; q < ZWORDS; ++q) {
      // zdil: z +- 1, carrying bit 31 of word q-1 into bit 0 of word q and back
      const unsigned up = (own[q] << 1) | (q > 0 ? own[q - 1] >> 31 : 0u);
      const unsigned dn = (own[q] >> 1) | (q + 1 < ZWORDS ? own[q + 1] << 31 : 0u);
      const unsigned a = v ? (own[q] | ((up | dn) & ~own[q] & nb_or[q])) : 0u;
      aug16[s * AUG16 + q] = (long long)a;
      popc += __popc(a);
    }
    aug16[s * AUG16 + ZWORDS + 1] = popc;
  }
  long long tot;
  block_exclusive_scan(popc, &tot);
  if (threadIdx.x == 0) chunk_sum[b * gridDim.x + blockIdx.x] = tot;
}

// KX (3): one block per scan: block offsets, counts_b, aug-row overflow.
__global__ void chunk_scan_kernel(long long* __restrict__ chunk, long long* __restrict__ counts_b,
                                  int* __restrict__ overflow, int nchunks, int cap_a, int level) {
  const long long b = blockIdx.x;
  const long long total = block_scan_span(chunk + b * nchunks, chunk + b * nchunks, nchunks, 0);
  if (threadIdx.x == 0) {
    counts_b[b] = total;
    atomicAdd(overflow + 1 + level, (int)max(total - cap_a, 0LL));
  }
}

// KX (4): grid (chunks, nb): global start of each slot's aug rows.
__global__ void start_kernel(long long* __restrict__ aug16, const long long* __restrict__ chunk,
                             int ccap, int cap_a) {
  const long long b = blockIdx.y;
  const int local = blockIdx.x * THREADS + threadIdx.x;
  const long long s = b * ccap + local;
  const long long popc = local < ccap ? aug16[s * AUG16 + ZWORDS + 1] : 0;
  long long tot;
  const long long ex = block_exclusive_scan(popc, &tot);
  if (local < ccap) aug16[s * AUG16 + ZWORDS] = chunk[b * gridDim.x + blockIdx.x] + ex + b * cap_a;
}

// KY (1): one thread per source row.
__global__ void scatter_rows_kernel(const long long* __restrict__ pos3,
                                    const int4* __restrict__ coords,
                                    const uint8_t* __restrict__ valid,
                                    long long* __restrict__ packed_a, uint8_t* __restrict__ real_a,
                                    int* __restrict__ pos, int* __restrict__ off,
                                    int* __restrict__ map8, int n, long long n_a, int grid_half,
                                    int level, bool rep) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int g = (2 * grid_half) >> level;
  const int4 cr = coords[i];
  const Cell c = cell_of(cr, true, grid_half, level);
  const long long gxc = clampi(c.gx, 0, g - 1), gyc = clampi(c.gy, 0, g - 1);
  const long long packed0 = ((gxc * g + gyc) << 9) | clampi(c.bz, 0, ZMAX - 1);
#pragma unroll
  for (int d = 0; d < 3; ++d) {  // candidates z-1, z, z+1
    const long long p = pos3[(long long)d * n + i];
    if (p >= 0 && p < n_a) packed_a[p] = (packed0 + d - 1) & 0xFFFFFFFFLL;
  }
  const long long p1 = pos3[(long long)n + i];
  const bool vi = valid[i];
  if (vi && p1 >= 0 && p1 < n_a) real_a[p1] = 1;
  if (level == 0) {
    const int pin = vi ? (int)p1 : -1;
    pos[i] = pin;
    if (rep && pin >= 0 && pin < n_a) atomicMin(map8 + pin, i);
    return;
  }
  // the fine row's offset in its parent: bit (level-1) of x, y, z
  const int lowmask = (1 << level) - 1;
  const int offv = ((cr.y & lowmask) >> (level - 1)) * 4 + ((cr.z & lowmask) >> (level - 1)) * 2 +
                   ((cr.w & lowmask) >> (level - 1));
  pos[i] = (int)p1;
  off[i] = offv;
  if (p1 >= 0 && p1 < n_a) map8[(long long)clampi(offv, 0, 7) * n_a + p1] = i;
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// The decoded row j of KY (2): coords and valid.
__device__ __forceinline__ bool decode_row(long long j, const long long* packed_a,
                                           const long long* counts_b, int cap_a, int g,
                                           int grid_half, int level, int4* out) {
  const long long b = j / cap_a;
  const long long cnt = counts_b[b];
  const bool v = (j - b * cap_a) < (cnt < cap_a ? cnt : (long long)cap_a);
  if (!v) {
    *out = make_int4(0, 0, 0, 0);
    return false;
  }
  const long long p = packed_a[j];
  const long long gxgy = p >> 9;
  const long long q = floor_div(gxgy, g);
  const long long gh = grid_half >> level;
  const long long ax = (long long)((unsigned long long)(q - gh) << level);
  const long long ay = (long long)((unsigned long long)(gxgy - q * g - gh) << level);
  const long long az = (long long)((unsigned long long)((p & 511) - ZC) << level);
  *out = make_int4((int)b, (int)ax, (int)ay, (int)az);
  return true;
}

// row j+1 is (same b, x, y, z + stride) and both rows are valid.
__device__ __forceinline__ bool z_adjacent(int4 a, bool va, int4 b, bool vb, int stride) {
  return va && vb && a.x == b.x && a.y == b.y && a.z == b.z &&
         b.w == (int)((unsigned)a.w + (unsigned)stride);
}

// KY (2): one thread per aug row.
__global__ void decode_kernel(const long long* __restrict__ packed_a,
                              const long long* __restrict__ counts_b, int4* __restrict__ coords_a,
                              uint8_t* __restrict__ real_a, uint8_t* __restrict__ valid_a,
                              uint8_t* __restrict__ zup, uint8_t* __restrict__ zdn,
                              int* __restrict__ rep, long long n_a, int cap_a, int grid_half,
                              int level) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_a) return;
  const int g = (2 * grid_half) >> level;
  int4 c, cp, cn;
  const bool v = decode_row(j, packed_a, counts_b, cap_a, g, grid_half, level, &c);
  coords_a[j] = c;
  valid_a[j] = v;
  real_a[j] = real_a[j] && v;
  bool up = false, dn = false;
  if (j + 1 < n_a) {
    const bool vn = decode_row(j + 1, packed_a, counts_b, cap_a, g, grid_half, level, &cn);
    up = z_adjacent(c, v, cn, vn, 1 << level);
  }
  if (j > 0) {
    const bool vp = decode_row(j - 1, packed_a, counts_b, cap_a, g, grid_half, level, &cp);
    dn = z_adjacent(cp, vp, c, v, 1 << level);
  }
  zup[j] = up;
  zdn[j] = dn;
  if (rep != nullptr && rep[j] == REP_NONE) rep[j] = -1;
}

cudaStream_t as_stream(void* stream) { return reinterpret_cast<cudaStream_t>(stream); }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

unsigned blocks_of(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

bool level_ok(int nb, int grid_half, int level) {
  const int g = level >= 0 && level < NUM_LEVELS ? (2 * grid_half) >> level : 0;
  return nb >= 1 && g >= 1 && (long long)nb * g * g < 0x7FFFFFFFLL;
}

}  // namespace

// Each function returns a cudaError_t (0 = launched).

// KV: grid int64 [nb*g*g], vox_cid int64 [n], col_bxy int64 [nb*ccap] and
// col_valid bool [nb*ccap] (both zeroed by the caller); scratch: has int8
// [nb*g*g] (zeroed), row_tab int64 [2, nb*g], nreal int64 [nb] (zeroed);
// overflow int32 [6].  cap_real >= 0: unique level-0 input.
extern "C" int column_grid(const void* coords, const void* valid, void* grid, void* vox_cid,
                           void* col_bxy, void* col_valid, void* has, void* row_tab, void* nreal,
                           void* overflow, int n, int nb, int grid_half, int level, int ccap, int r,
                           int cap_real, void* stream) {
  if (n < 0 || !level_ok(nb, grid_half, level) || ccap < 1 || r < 0 || !aligned16(coords))
    return (int)cudaErrorInvalidValue;
  const int g = (2 * grid_half) >> level;
  if (g > 32768 || 2 * r + 1 > g) return (int)cudaErrorInvalidValue;
  cudaStream_t st = as_stream(stream);
  const int rows = nb * g;
  long long* row_count = static_cast<long long*>(row_tab);
  long long* row_off = row_count + rows;
  int* ov = static_cast<int*>(overflow);
  if (n > 0)
    has_kernel<<<blocks_of(n), THREADS, 0, st>>>(
        static_cast<const int4*>(coords), static_cast<const uint8_t*>(valid),
        static_cast<int8_t*>(has), static_cast<unsigned long long*>(nreal), n, nb, grid_half,
        level, cap_real >= 0);
  dilate_kernel<<<rows, THREADS, g, st>>>(static_cast<int8_t*>(has), row_count, g, r);
  row_scan_kernel<<<nb, SCAN_THREADS, 0, st>>>(row_count, row_off,
                                               static_cast<const unsigned long long*>(nreal), ov,
                                               g, ccap, level, cap_real);
  grid_kernel<<<rows, THREADS, 0, st>>>(static_cast<const int8_t*>(has), row_off,
                                        static_cast<long long*>(grid), g, ccap);
  if (n > 0)
    stamp_kernel<<<blocks_of(n), THREADS, 0, st>>>(
        static_cast<const int4*>(coords), static_cast<const uint8_t*>(valid),
        static_cast<const long long*>(grid), static_cast<long long*>(vox_cid),
        static_cast<long long*>(col_bxy), static_cast<uint8_t*>(col_valid), ov, n, nb, grid_half,
        level, ccap, r);
  return (int)cudaGetLastError();
}

// KW: real_w int64 [nb*ccap, 14] (zeroed by the caller at level 0).  Level
// 0 reads coords, valid, vox_cid (n rows; unique or sortless, nreal int64
// [nb] zeroed); levels 1-4 read col_bxy, col_valid and the finer level's
// fine_grid int64 [nb*(2g)^2] and fine_real int64 [fine_slots, 14].
extern "C" int real_words(const void* coords, const void* valid, const void* vox_cid,
                          const void* col_bxy, const void* col_valid, const void* fine_grid,
                          const void* fine_real, void* real_w, void* nreal, void* overflow, int n,
                          int fine_slots, int nb, int ccap, int grid_half, int level, int unique,
                          int cap_real, void* stream) {
  if (n < 0 || fine_slots < 0 || !level_ok(nb, grid_half, level) || ccap < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = as_stream(stream);
  const long long slots = (long long)nb * ccap;
  if (level == 0) {
    if (!aligned16(coords)) return (int)cudaErrorInvalidValue;
    if (n > 0)
      real_bits_kernel<<<blocks_of(n), THREADS, 0, st>>>(
          static_cast<const int4*>(coords), static_cast<const uint8_t*>(valid),
          static_cast<const long long*>(vox_cid), static_cast<long long*>(real_w),
          static_cast<unsigned long long*>(nreal), n, grid_half, ccap, slots, unique != 0);
    if (!unique)
      real_over_kernel<<<1, 32, 0, st>>>(static_cast<const unsigned long long*>(nreal),
                                         static_cast<int*>(overflow), nb, cap_real);
  } else {
    coarsen_kernel<<<blocks_of(slots), THREADS, 0, st>>>(
        static_cast<const long long*>(col_bxy), static_cast<const uint8_t*>(col_valid),
        static_cast<const long long*>(fine_grid), static_cast<const long long*>(fine_real),
        static_cast<long long*>(real_w), slots, fine_slots, nb, grid_half, level);
  }
  return (int)cudaGetLastError();
}

// KX: aug16 int64 [nb*ccap, 16], counts_b int64 [nb]; scratch yor3 int32
// [nb*ccap, 14], chunk int64 [nb * ceil(ccap / 256)].
extern "C" int assemble_aug(const void* real_w, const void* col_bxy, const void* col_valid,
                            const void* grid, void* aug16, void* counts_b, void* yor3, void* chunk,
                            void* overflow, int nb, int g, int ccap, int cap_a, int level,
                            void* stream) {
  if (nb < 1 || g < 1 || ccap < 1 || cap_a < 1 || level < 0 || level >= NUM_LEVELS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = as_stream(stream);
  const long long slots = (long long)nb * ccap;
  const int nchunks = (ccap + THREADS - 1) / THREADS;
  const dim3 grid2(nchunks, nb);
  unsigned* y3 = static_cast<unsigned*>(yor3);
  long long* a16 = static_cast<long long*>(aug16);
  long long* ch = static_cast<long long*>(chunk);
  yor3_kernel<<<blocks_of(slots), THREADS, 0, st>>>(static_cast<const long long*>(real_w),
                                                    static_cast<const long long*>(col_bxy),
                                                    static_cast<const uint8_t*>(col_valid), y3,
                                                    slots);
  aug_kernel<<<grid2, THREADS, 0, st>>>(
      static_cast<const long long*>(real_w), static_cast<const long long*>(col_bxy),
      static_cast<const uint8_t*>(col_valid), static_cast<const long long*>(grid), y3, a16, ch,
      nb, g, ccap);
  chunk_scan_kernel<<<nb, SCAN_THREADS, 0, st>>>(ch, static_cast<long long*>(counts_b),
                                                 static_cast<int*>(overflow), nchunks, cap_a,
                                                 level);
  start_kernel<<<grid2, THREADS, 0, st>>>(a16, ch, ccap, cap_a);
  return (int)cudaGetLastError();
}

// KY: coords_a int32 [nb*cap_a, 4]; real_a (zeroed by the caller),
// valid_a, zup, zdn bool [nb*cap_a]; scratch packed_a int64 [nb*cap_a]
// (zeroed); pos int32 [n] (level 0: pos, else parent); level > 0: off
// int32 [n] and map8 = down8 int32 [8, nb*cap_a] (filled with -1); level 0
// with rep: map8 = rep int32 [nb*cap_a] (filled with 0x7FFFFFFF).
extern "C" int emit_rows(const void* pos3, const void* coords, const void* valid,
                         const void* counts_b, void* coords_a, void* real_a, void* valid_a,
                         void* zup, void* zdn, void* packed_a, void* pos, void* off, void* map8,
                         int n, int nb, int cap_a, int grid_half, int level, int rep,
                         void* stream) {
  if (n < 0 || !level_ok(nb, grid_half, level) || cap_a < 1 || (rep && level != 0) ||
      !aligned16(coords) || !aligned16(coords_a))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = as_stream(stream);
  const long long n_a = (long long)nb * cap_a;
  if (n > 0)
    scatter_rows_kernel<<<blocks_of(n), THREADS, 0, st>>>(
        static_cast<const long long*>(pos3), static_cast<const int4*>(coords),
        static_cast<const uint8_t*>(valid), static_cast<long long*>(packed_a),
        static_cast<uint8_t*>(real_a), static_cast<int*>(pos), static_cast<int*>(off),
        static_cast<int*>(map8), n, n_a, grid_half, level, rep != 0);
  decode_kernel<<<blocks_of(n_a), THREADS, 0, st>>>(
      static_cast<const long long*>(packed_a), static_cast<const long long*>(counts_b),
      static_cast<int4*>(coords_a), static_cast<uint8_t*>(real_a),
      static_cast<uint8_t*>(valid_a), static_cast<uint8_t*>(zup), static_cast<uint8_t*>(zdn),
      rep ? static_cast<int*>(map8) : nullptr, n_a, cap_a, grid_half, level);
  return (int)cudaGetLastError();
}

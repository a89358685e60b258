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
// z-bit words are uint32 values, held in int64 real-word tables and in the
// int32 aug16 rows (words, GLOBAL start, count: lidog_tpu's dtype); counts
// and scans are integer sums, exact in any order; overflow terms are added
// with int32 atomics, which wrap as the plain version's int64 sum cast to
// int32 does.
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
//   KX: one launch; a block per tile of KX_TILE slots of one scan, taken
//       in order from a tile counter: the tile's real words and those of
//       one slot each side are staged in shared memory (coalesced), where
//       each slot's yor3 (own | y-adjacent slots' words) is formed; for a
//       slot whose own words are not 0 (else its aug words are 0 whatever
//       its neighbours hold) and that is valid, the two x-neighbours'
//       slots through the grid, compacted into a list of (slot, dx)
//       pairs, whose yor3 a half-warp each rebuilds from their three real
//       rows (random, whole-row reads; every load of KX_PAIRS pairs
//       issued before any is used, since at the small levels a few blocks
//       run and each round trip adds to the launch); ghost words,
//       popcount, the block scan, and the tile's offset in its scan by a
//       decoupled look-back over the scan's earlier tiles (a 64-bit status
//       word per tile); the scan's last tile writes counts_b and adds the
//       rows past cap_a to overflow; global start = offset + prefix +
//       b*cap_a; the tile's rows leave through a swizzled shared-memory
//       tile as 16-byte stores.  The last block to finish resets the
//       status words and counters, which the wrapper zeroes once.
//   KY: (1) one thread per source row: its 3 candidates' packed
//       gxgy << 9 | bz (uint32 wrap) scattered to their aug rows, the real
//       flag, and pos (+ rep by atomicMin) at level 0, parent, off and the
//       down8 transpose above; (2) one thread per aug row decodes rows
//       j-1, j, j+1: coords, valid, real &= valid, zup and zdn.
//
// Every step is a separate launch on the caller's stream, so each reads
// the previous step's complete output.  KV's scans are reduce-then-scan
// with a warp-shuffle block scan, KX's a single pass with look-back; no
// library scan.
//
// Bound on an H100: bytes.  KV writes the int64 grid (B*g*g*8: 134 MB at
// the training plan's level 0), the others their tables and rows (KX
// reads the int64 real words, 88 MB there, and writes aug16, 50 MB).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ZWORDS = 14;
constexpr int ZC = ZWORDS * 16;
constexpr int ZMAX = ZWORDS * 32;
constexpr int AUG16 = ZWORDS + 2;  // aug16 row: words + start + count
constexpr int NUM_LEVELS = 5;
constexpr int THREADS = 256;      // per-thread launches
constexpr int KX_TILE = 256;      // KX's slots per tile = threads per block
constexpr int KX_ROW = ZWORDS + 1;  // KX's shared-memory row stride (odd)
constexpr int KX_PAIRS = 4;       // KX's neighbour fetches in flight per half-warp
// KX's look-back status word: flag << 62 | the tile's sum (0 = not yet
// published), the flag AGG (the tile alone) or PREFIX (with every earlier
// tile of its scan)
constexpr unsigned long long KX_AGG = 1ULL << 62, KX_PREFIX = 2ULL << 62,
                             KX_VALUE = (1ULL << 62) - 1;
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

__device__ __forceinline__ unsigned long long ld_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// KX: one block per tile (see the top).  state: [nb * tiles_per_scan]
// status words, then the tile and finish counters (two uint32); all 0 on
// entry and on exit.
__global__ void __launch_bounds__(KX_TILE)
aug_kernel(const long long* __restrict__ real_w, const long long* __restrict__ bxy,
           const uint8_t* __restrict__ cvalid, const long long* __restrict__ grid,
           int* __restrict__ aug16, long long* __restrict__ counts_b, int* __restrict__ overflow,
           unsigned long long* __restrict__ state, int nb, int g, int ccap, int cap_a, int level,
           int tiles_per_scan) {
  // the staged real words of the tile's slots and one each side (row i is
  // slot s0 - 1 + i), later the output tile [KX_TILE][16] int32
  __shared__ __align__(16) unsigned own_s[KX_TILE * AUG16];
  __shared__ unsigned nbr_s[KX_TILE * KX_ROW];  // yor3 of the 3x3 neighbourhood
  __shared__ long long bxy_s[KX_TILE + 2];
  __shared__ uint8_t val_s[KX_TILE + 2];
  // the (slot, dx) pairs whose x-neighbour slot is looked up: 2 t + d, and
  // that neighbour's slot
  __shared__ int pair_s[2 * KX_TILE], pcid_s[2 * KX_TILE];
  __shared__ int s_tile, s_last;
  __shared__ long long s_before;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int total = nb * tiles_per_scan;
  unsigned* counters = reinterpret_cast<unsigned*>(state + total);
  if (tid == 0) s_tile = (int)atomicAdd(counters, 1u);  // tiles start in order
  __syncthreads();
  const int tile = s_tile;
  const int b = tile / tiles_per_scan, k = tile - b * tiles_per_scan;
  const int slots = nb * ccap;
  const int s0 = b * ccap + k * KX_TILE;
  const int n_in = min(KX_TILE, ccap - k * KX_TILE);
  const long long cells = (long long)nb * g * g;
  for (int i = tid; i < n_in + 2; i += KX_TILE) {
    const int u = s0 - 1 + i;
    const bool in = u >= 0 && u < slots;
    bxy_s[i] = in ? bxy[u] : 0;
    val_s[i] = in ? cvalid[u] : 0;
  }
  {
    const long long e0 = (long long)(s0 - 1) * ZWORDS, end = (long long)slots * ZWORDS;
    for (int e = tid; e < (n_in + 2) * ZWORDS; e += KX_TILE) {
      const int i = e / ZWORDS, q = e - i * ZWORDS;
      own_s[i * KX_ROW + q] = (e0 + e >= 0 && e0 + e < end) ? (unsigned)real_w[e0 + e] : 0u;
    }
  }
  __syncthreads();
  // per slot: its own yor3 and its x-neighbours' slots
  int cid[2] = {-1, -1};
  if (tid < n_in) {
    const int c = tid + 1;
    const bool up = val_s[c] && val_s[c + 1] && bxy_s[c + 1] == bxy_s[c] + 1;
    const bool dn = val_s[c - 1] && val_s[c] && bxy_s[c] == bxy_s[c - 1] + 1;
    unsigned any = 0;
#pragma unroll
    for (int q = 0; q < ZWORDS; ++q) {
      const unsigned w = own_s[c * KX_ROW + q];
      any |= w;
      nbr_s[tid * KX_ROW + q] = w | (up ? own_s[(c + 1) * KX_ROW + q] : 0u) |
                                (dn ? own_s[(c - 1) * KX_ROW + q] : 0u);
    }
    const long long p = bxy_s[c];
    const long long bb = p >> 24, gx = (p >> 12) & 4095, gy = p & 4095;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const long long gxn = gx + 2 * d - 1;
      if (val_s[c] && any != 0u && gxn >= 0 && gxn < g) {
        const long long flat = (bb * g + gxn) * g + gy;
        if (flat >= 0 && flat < cells) {
          const long long cn = grid[flat];
          if (cn >= 0 && cn < slots) cid[d] = (int)cn;
        }
      }
    }
  }
  // the pairs with a neighbour, compacted in slot order
  int npairs;
  {
    const int k0 = (cid[0] >= 0) + (cid[1] >= 0);
    int at = block_exclusive_scan(k0, &npairs);
#pragma unroll
    for (int d = 0; d < 2; ++d)
      if (cid[d] >= 0) {
        pair_s[at] = 2 * tid + d;
        pcid_s[at++] = cid[d];
      }
  }
  __syncthreads();
  // the x-neighbours' yor3: a half-warp per pair, a lane per word, KX_PAIRS
  // pairs in flight (every load issued before any is used)
  {
    const int hw = tid >> 4, hl = tid & 15;
    const bool word = hl < ZWORDS;
    for (int p0 = hw; p0 < npairs; p0 += 16 * KX_PAIRS) {
      long long pc[KX_PAIRS], pu[KX_PAIRS], pd[KX_PAIRS];
      uint8_t vc[KX_PAIRS], vu[KX_PAIRS], vd[KX_PAIRS];
      unsigned w0[KX_PAIRS], wu[KX_PAIRS], wd[KX_PAIRS];
#pragma unroll
      for (int j = 0; j < KX_PAIRS; ++j) {
        const int p = p0 + 16 * j;
        const int cn = p < npairs ? pcid_s[p] : -1;
        const bool here = cn >= 0, up = here && cn + 1 < slots, dn = here && cn >= 1;
        const long long* row = real_w + (long long)(here ? cn : 0) * ZWORDS + hl;
        pc[j] = here ? bxy[cn] : 0;
        pu[j] = up ? bxy[cn + 1] : 0;
        pd[j] = dn ? bxy[cn - 1] : 0;
        vc[j] = here ? cvalid[cn] : 0;
        vu[j] = up ? cvalid[cn + 1] : 0;
        vd[j] = dn ? cvalid[cn - 1] : 0;
        w0[j] = here && word ? (unsigned)row[0] : 0u;
        wu[j] = up && word ? (unsigned)row[ZWORDS] : 0u;
        wd[j] = dn && word ? (unsigned)row[-ZWORDS] : 0u;
      }
#pragma unroll
      for (int j = 0; j < KX_PAIRS; ++j) {
        const int p = p0 + 16 * j;
        if (p >= npairs || !word) continue;
        const bool upn = vc[j] && vu[j] && pu[j] == pc[j] + 1;
        const bool dnn = vc[j] && vd[j] && pd[j] + 1 == pc[j];
        const unsigned acc = w0[j] | (upn ? wu[j] : 0u) | (dnn ? wd[j] : 0u);
        atomicOr(&nbr_s[(pair_s[p] >> 1) * KX_ROW + hl], acc);
      }
    }
  }
  __syncthreads();
  // ghost words and popcount per slot
  unsigned a[ZWORDS];
  long long popc = 0;
  {
    const int c = tid + 1;
    const bool v = tid < n_in && val_s[c];
#pragma unroll
    for (int q = 0; q < ZWORDS; ++q) {
      const unsigned o = tid < n_in ? own_s[c * KX_ROW + q] : 0u;
      const unsigned om = (q > 0 && tid < n_in) ? own_s[c * KX_ROW + q - 1] : 0u;
      const unsigned op = (q + 1 < ZWORDS && tid < n_in) ? own_s[c * KX_ROW + q + 1] : 0u;
      // zdil: z +- 1, carrying bit 31 of word q-1 into bit 0 of word q and back
      const unsigned upw = (o << 1) | (om >> 31);
      const unsigned dnw = (o >> 1) | (op << 31);
      a[q] = v ? (o | ((upw | dnw) & ~o & nbr_s[tid * KX_ROW + q])) : 0u;
      popc += __popc(a[q]);
    }
  }
  long long tile_sum;
  const long long excl = block_exclusive_scan(popc, &tile_sum);  // (its barriers end own_s's reads)
  if (warp == 0) {  // decoupled look-back over the scan's earlier tiles, 32 at a time
    unsigned long long* st = state + (size_t)b * tiles_per_scan;
    long long before = 0;
    if (lane == 0) st_status(st + k, (k == 0 ? KX_PREFIX : KX_AGG) | (unsigned long long)tile_sum);
    for (int p = k - 1; p >= 0;) {
      const int q = p - lane;
      const unsigned long long w = q >= 0 ? ld_status(st + q) : KX_PREFIX;
      const unsigned pm = __ballot_sync(0xffffffffu, (w & KX_PREFIX) != 0);
      const unsigned zm = __ballot_sync(0xffffffffu, w == 0);
      const int first_p = pm ? __ffs(pm) - 1 : 32, first_z = zm ? __ffs(zm) - 1 : 32;
      const int upto = min(first_p + 1, first_z);  // lanes summed this round
      long long add = lane < upto ? (long long)(w & KX_VALUE) : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) add += __shfl_xor_sync(0xffffffffu, add, o);
      before += add;
      if (first_p < first_z) break;
      p -= upto;
    }
    if (lane == 0) {
      if (k > 0) st_status(st + k, KX_PREFIX | (unsigned long long)(before + tile_sum));
      s_before = before;
      if (k == tiles_per_scan - 1) {
        const long long cnt = before + tile_sum;
        counts_b[b] = cnt;
        atomicAdd(overflow + 1 + level, (int)max(cnt - cap_a, 0LL));
      }
    }
  }
  __syncthreads();
  // the output tile: 16-byte chunk c of row t at chunk (c ^ ((t >> 1) & 3))
  // of its row, so that 8 consecutive rows' stores hit distinct banks
  int4* out_s = reinterpret_cast<int4*>(own_s);
  if (tid < n_in) {
    const int start = (int)(s_before + excl + (long long)b * cap_a);  // int32 wrap
    const int sw = (tid >> 1) & 3;
    out_s[tid * 4 + (0 ^ sw)] = make_int4((int)a[0], (int)a[1], (int)a[2], (int)a[3]);
    out_s[tid * 4 + (1 ^ sw)] = make_int4((int)a[4], (int)a[5], (int)a[6], (int)a[7]);
    out_s[tid * 4 + (2 ^ sw)] = make_int4((int)a[8], (int)a[9], (int)a[10], (int)a[11]);
    out_s[tid * 4 + (3 ^ sw)] = make_int4((int)a[12], (int)a[13], start, (int)popc);
  }
  __syncthreads();
  int4* dst = reinterpret_cast<int4*>(aug16) + (size_t)s0 * 4;
  for (int e = tid; e < n_in * 4; e += KX_TILE) {
    const int t = e >> 2;
    dst[e] = out_s[t * 4 + ((e & 3) ^ ((t >> 1) & 3))];
  }
  // the last block to finish leaves the state zeroed for the next launch
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counters + 1, 1u) == (unsigned)(total - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = tid; i < total; i += KX_TILE) state[i] = 0;
  if (tid == 0) {
    counters[0] = 0;
    counters[1] = 0;
  }
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

// KX: aug16 int32 [nb*ccap, 16] (16-byte aligned), counts_b int64 [nb];
// state: int64 [nb * ceil(ccap / KX_TILE) + 1], zero on entry and left
// zero (the look-back words and the two tile counters).
extern "C" int assemble_aug(const void* real_w, const void* col_bxy, const void* col_valid,
                            const void* grid, void* aug16, void* counts_b, void* state,
                            void* overflow, int nb, int g, int ccap, int cap_a, int level,
                            void* stream) {
  if (nb < 1 || g < 1 || ccap < 1 || cap_a < 1 || level < 0 || level >= NUM_LEVELS ||
      (long long)nb * ccap * AUG16 >= 0x7FFFFFFFLL || !aligned16(aug16))
    return (int)cudaErrorInvalidValue;
  const int tiles_per_scan = (ccap + KX_TILE - 1) / KX_TILE;
  aug_kernel<<<nb * tiles_per_scan, KX_TILE, 0, as_stream(stream)>>>(
      static_cast<const long long*>(real_w), static_cast<const long long*>(col_bxy),
      static_cast<const uint8_t*>(col_valid), static_cast<const long long*>(grid),
      static_cast<int*>(aug16), static_cast<long long*>(counts_b), static_cast<int*>(overflow),
      static_cast<unsigned long long*>(state), nb, g, ccap, cap_a, level, tiles_per_scan);
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

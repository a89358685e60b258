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
// z-bit words are uint32 values, held in the int32 real-word rows (real16:
// 14 words, 2 zero pad words) and aug16 rows (words, GLOBAL start, count),
// 64 bytes a slot, as lidog_tpu's; the column grid is int32, as
// lidog_tpu's; counts and scans are integer sums,
// exact in any order; overflow terms are added with int32 atomics, which
// wrap as the plain version's int64 sum cast to int32 does.
//
//   KV: (1) one thread per source row sets its cell's bit in a bit grid,
//       one bit per cell, each (b, gx) row padded to W = ceil(g/32) words
//       (one atomicOr per run of a warp's rows on one word), and on unique level-0
//       input counts the scan's real rows; (2) one pass over whole rows:
//       a block per tile of rows of one scan, taken in order from a tile
//       counter, loads the tile's words (and clears them), dilates each
//       word along gy by +-r with shifts that carry bits from the row's
//       neighbour words (never across rows), popcounts them, block-scans
//       the counts and finds the tile's offset in its scan by a decoupled
//       look-back over the scan's earlier tiles; the scan's last tile adds
//       the columns past ccap and the real rows past cap_real to overflow;
//       grid = cloc + b*ccap where dilated and cloc < ccap, else -1,
//       written as 16-byte stores of 4 cells.  The wrapper picks the rows
//       a tile (core/zseg.py column_grid_tiles: ~2 tiles an SM, whole rows
//       of at most KV_TILE_WORDS words).  Nothing is reset at the end: the
//       tile counter runs on from launch to launch (the wrapper passes
//       its value before the launch) and the look-back words carry the
//       launch's epoch, so that an earlier launch's words read as not yet
//       published; (3) one thread per source row: its column id
//       (vox_cid), the rows lost to the cap into overflow, and the 2r+1
//       slot stamps of packed (b, gx, gy+dy) under the segment guard, by
//       the first row of each run of a column's rows in a warp.  Every writer of a slot writes
//       the same value (the slot is the column of that cell).  A grid-side
//       write of the slot stamps would differ where the plain version
//       leaves a dilated slot unstamped (its voxel's own column past
//       ccap), so they stay here.
//   KW: level 0: the table zeroed with 16-byte stores (and the sortless
//       scan counts), then one thread per source row: unique input
//       atomicAdd of the bit on its word (the plain scatter-add mod 2^32);
//       sortless input atomicOr, counting the bits that were new per scan,
//       then one block adds the deduped voxels past cap_real to
//       overflow[0].  Levels 1-4: a group of 4 lanes per slot, lane q
//       owning the 16-byte quarter q (words 4q .. 4q+3) of the row: lane q
//       looks up child column q (cx = q >> 1, cy = q & 1) in the finer
//       level's grid and shuffles its id to the group, every lane reads
//       its quarter of the 4 child rows (4 independent 16-byte loads; a
//       warp's loads cover whole 64-byte rows) and ORs them, compresses
//       each word's pairs (_zpair_words' bit step) to 16 bits, packs its 4
//       halves into 2 words, and takes from lanes 2q-2, 2q-1 and 2q of
//       the group the 5 packed words whose 16-bit shifted pairs are its
//       output words (word k = comp[2k-7] | comp[2k-6] << 16, the ZC
//       recentring); a warp's 16-byte stores cover 8 whole rows.
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
//       gxgy << 9 | bz (uint32 wrap, lidog_tpu's int32 cand_p) and the real
//       flag scattered to their aug rows of two scratch tables, and pos (+
//       rep by atomicMin) at level 0, parent, off and the down8 transpose
//       above; (2) a block per tile of KY_TILE aug rows of one scan decodes
//       each row once into shared memory (with one row each side), in
//       32-bit arithmetic (division by g a shift where g is a power of
//       two): coords as 16-byte stores, valid, real &= valid, zup and zdn
//       from the neighbours in shared memory.  The real flags are cleared
//       by the block that reads them; the packed rows go to one of two
//       tables in turn, and each launch clears the other one (the rows the
//       previous launch filled), so that no block clears a row that a
//       neighbouring block still reads and no launch needs a fill.
//
// Every step is a separate launch on the caller's stream, so each reads
// the previous step's complete output.  KV's and KX's scans are single
// passes with look-back; no library scan.
//
// Bound on an H100: bytes.  KV writes the int32 grid (B*g*g*4: 67 MB at
// the training plan's level 0), the others their tables and rows (KW
// writes the int32 real words, 50 MB there with the pad words, which KX
// reads back; KX writes aug16, 50 MB).
#include <cuda_runtime.h>
#include <stdint.h>

#include "zseg_rows.cuh"

namespace {

constexpr int KW_LANES = 4;        // KW coarsening: lanes a slot, a 16-byte quarter each
constexpr int NUM_LEVELS = 5;
constexpr int THREADS = 256;      // per-thread launches
constexpr int KX_TILE = 256;      // KX's slots per tile = threads per block
constexpr int KX_ROW = ZWORDS + 1;  // KX's shared-memory row stride (odd)
constexpr int KX_PAIRS = 4;       // KX's neighbour fetches in flight per half-warp
constexpr int KV_THREADS = 256;   // KV's row pass: threads per block
constexpr int KV_WORDS = 4;       // bit words per thread, consecutive
// bit words per row-pass tile: whole rows of at most 1024 words (g <= 32768)
constexpr int KV_TILE_WORDS = KV_THREADS * KV_WORDS;
constexpr int KY_TILE = 256;      // KY's aug rows per decode block = threads per block
// a look-back status word (KV, KX): flag << 62 | the sum, published when
// its flag is AGG (the tile alone) or PREFIX (with every earlier tile of
// its scan).  KX's words are reset by its last block; KV never resets its
// words but tags them with the launch's epoch, epoch << 32 | a sum below
// 2^32, and reads another epoch's word as not yet published.
constexpr unsigned long long SCAN_AGG = 1ULL << 62, SCAN_PREFIX = 2ULL << 62,
                             SCAN_FLAGS = 3ULL << 62, SCAN_SUM = SCAN_AGG - 1,
                             SCAN_SUM32 = 0xFFFFFFFFULL;
constexpr unsigned SCAN_EPOCHS = 0x3FFFFFFFu;
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

__device__ __forceinline__ unsigned long long ld_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// KV: tile k's offset in its scan by a decoupled look-back over the
// scan's earlier tiles (status words st[0, k)), 32 at a time; publishes
// tile k's sum, then its inclusive prefix, under `epoch` (KX's aug_kernel
// runs the same look-back on words that its last block resets).  Warp 0
// calls it; every lane returns the offset.  The tiles must start in order
// (a tile waits only on earlier ones).
__device__ long long scan_lookback(unsigned long long* st, int k, long long tile_sum,
                                   unsigned epoch) {
  const int lane = threadIdx.x & 31;
  const unsigned long long tag = (unsigned long long)epoch << 32;
  long long before = 0;
  if (lane == 0)
    st_status(st + k, (k == 0 ? SCAN_PREFIX : SCAN_AGG) | tag | (unsigned long long)tile_sum);
  for (int p = k - 1; p >= 0;) {
    const int q = p - lane;
    unsigned long long w = q >= 0 ? ld_status(st + q) : SCAN_PREFIX | tag;
    if ((w & ~SCAN_FLAGS & ~SCAN_SUM32) != tag) w = 0;  // an earlier launch's word
    const unsigned pm = __ballot_sync(0xffffffffu, (w & SCAN_PREFIX) != 0);
    const unsigned zm = __ballot_sync(0xffffffffu, w == 0);
    const int first_p = pm ? __ffs(pm) - 1 : 32, first_z = zm ? __ffs(zm) - 1 : 32;
    const int upto = min(first_p + 1, first_z);  // lanes summed this round
    long long add = lane < upto ? (long long)(w & SCAN_SUM32) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) add += __shfl_xor_sync(0xffffffffu, add, o);
    before += add;
    if (first_p < first_z) break;
    p -= upto;
  }
  if (lane == 0 && k > 0)
    st_status(st + k, SCAN_PREFIX | tag | (unsigned long long)(before + tile_sum));
  return before;
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

// Whether this lane starts a run of consecutive ok lanes of its warp with
// equal keys.  Every thread of the warp must call it.
__device__ __forceinline__ bool run_start(bool ok, unsigned key) {
  const unsigned prev = __shfl_up_sync(0xffffffffu, key, 1);
  const int prev_ok = __shfl_up_sync(0xffffffffu, (int)ok, 1);
  return ok && ((threadIdx.x & 31) == 0 || !prev_ok || prev != key);
}

// Add, per run of consecutive ok lanes with equal keys, the run's length
// to counter[key] (one atomic a run: a sorted warp's keys make few runs).
// Every thread of the warp must call it.
__device__ __forceinline__ void run_count(bool ok, unsigned key,
                                          unsigned long long* counter) {
  const bool lead = run_start(ok, key);
  const unsigned ends = __ballot_sync(0xffffffffu, lead || !ok);
  if (lead) {
    const int lane = threadIdx.x & 31;
    const unsigned after = lane == 31 ? 0u : ends & (0xffffffffu << (lane + 1));
    atomicAdd(counter + key, (unsigned long long)((after ? __ffs(after) - 1 : 32) - lane));
  }
}

// KV (1): one thread per source row: its cell's bit in the row-padded
// bit grid (bits[(b*g + gx) * W + gy/32], bit gy%32; one atomicOr per run
// of lanes on one word, the run's bits ORed by shuffles); real rows per
// scan on unique level-0 input.
__global__ void bit_stamp_kernel(const int4* __restrict__ coords,
                                 const uint8_t* __restrict__ valid, unsigned* __restrict__ bits,
                                 unsigned long long* __restrict__ nreal, int n, int nb,
                                 int grid_half, int level, int W, bool count_real) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int g = (2 * grid_half) >> level;
  bool ok = false;
  int b = 0;
  unsigned word = 0xffffffffu, bit = 0u;
  if (i < n) {
    const Cell c = cell_of(coords[i], valid[i], grid_half, level);
    ok = c.ok && c.b >= 0 && c.b < nb;
    if (ok) {
      b = c.b;
      word = ((unsigned)c.b * g + c.gx) * (unsigned)W + (c.gy >> 5);
      bit = 1u << (c.gy & 31);
    }
  }
  // each lane ORs the bits of the later lanes on its word (any order: a
  // word's bits may reach more than one atomicOr, which is idempotent)
  unsigned acc = bit;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_down_sync(0xffffffffu, acc, o);
    const unsigned wy = __shfl_down_sync(0xffffffffu, word, o);
    if (lane + o < 32 && wy == word) acc |= y;
  }
  if (run_start(ok, word)) atomicOr(bits + word, acc);
  if (count_real) run_count(ok, (unsigned)b, nreal);
}

// KV (2): one block per tile of whole (b, gx) rows of one scan (see the
// top).  counts: the tile counter (uint32; this launch's tiles are its
// values base .. base + nb * tiles_per_scan - 1), then [nb] real-row
// counts (0 on entry, reset by each scan's last tile); status: [nb *
// tiles_per_scan] look-back words, this launch's tagged with `epoch` and
// never reset; the bit words are 0 on entry and on exit (each block
// clears those it read).
__global__ void __launch_bounds__(KV_THREADS)
grid_rows_kernel(unsigned* __restrict__ bits, int* __restrict__ grid,
                 unsigned long long* __restrict__ counts, unsigned long long* __restrict__ status,
                 int* __restrict__ overflow, int nb, int g, int gshift, int W, int wshift,
                 int rows_per_tile, int tiles_per_scan, int ccap, int r, int level, int cap_real,
                 unsigned base, unsigned epoch) {
  __shared__ __align__(16) unsigned word_s[KV_TILE_WORDS];  // has, then dilated words
  __shared__ __align__(16) int pre_s[KV_TILE_WORDS];  // tile columns before each word
  __shared__ int s_tile;
  __shared__ long long s_before;
  const int tid = threadIdx.x;
  unsigned long long* nreal = counts + 1;
  if (tid == 0)  // tiles start in order
    s_tile = (int)(atomicAdd(reinterpret_cast<unsigned*>(counts), 1u) - base);
  __syncthreads();
  const int tile = s_tile;
  const int b = tile / tiles_per_scan, k = tile - b * tiles_per_scan;
  const int row0 = k * rows_per_tile;
  const int nrows = min(rows_per_tile, g - row0);
  const int nwords = nrows * W;
  unsigned* src = bits + ((size_t)b * g + row0) * W;
  for (int e = tid; e < nwords; e += KV_THREADS) {
    const unsigned v = src[e];
    word_s[e] = v;
    if (v) src[e] = 0u;  // the bit grid is left zero for the next call
  }
  __syncthreads();
  // the dilation of words 4t .. 4t+3 along gy by +-r (neighbour words of
  // the same row only; bits past g masked in the row's last word)
  unsigned d[KV_WORDS];
  int cnt = 0;
  const unsigned tail = (g & 31) ? (1u << (g & 31)) - 1u : 0xffffffffu;
#pragma unroll
  for (int j = 0; j < KV_WORDS; ++j) {
    const int e = KV_WORDS * tid + j;
    d[j] = 0u;
    if (e < nwords) {
      const int wi = wshift >= 0 ? e & (W - 1) : e % W;
      const unsigned x = word_s[e];
      const unsigned px = wi > 0 ? word_s[e - 1] : 0u, nx = wi < W - 1 ? word_s[e + 1] : 0u;
      unsigned v = x;
      for (int s = 1; s <= r; ++s)
        v |= (x >> s) | (nx << (32 - s)) | (x << s) | (px >> (32 - s));
      d[j] = wi == W - 1 ? v & tail : v;
      cnt += __popc(d[j]);
    }
  }
  int tile_sum;
  int excl = block_exclusive_scan(cnt, &tile_sum);  // (its barriers end word_s's reads)
#pragma unroll
  for (int j = 0; j < KV_WORDS; ++j) {
    const int e = KV_WORDS * tid + j;
    if (e < nwords) {
      word_s[e] = d[j];
      pre_s[e] = excl;
      excl += __popc(d[j]);
    }
  }
  if (tid < 32) {
    const long long before =
        scan_lookback(status + (size_t)b * tiles_per_scan, k, (long long)tile_sum, epoch);
    if (tid == 0) {
      s_before = before;
      if (k == tiles_per_scan - 1) {  // the scan's column and real-row overflow
        atomicAdd(overflow + 1 + level, (int)max(before + tile_sum - ccap, 0LL));
        if (cap_real >= 0) {
          atomicAdd(overflow, (int)max((long long)nreal[b] - cap_real, 0LL));
          nreal[b] = 0;
        }
      }
    }
  }
  __syncthreads();
  // grid = cloc + b*ccap where dilated and cloc < ccap, else -1
  const int before = (int)s_before, seg = b * ccap;
  int* out = grid + ((size_t)b * g + row0) * g;
  if ((g & 3) == 0) {  // 16-byte stores: 4 cells of one word
    const int per_row = g >> 2, chunks = nrows * per_row;
    int4* out4 = reinterpret_cast<int4*>(out);
    for (int q = tid; q < chunks; q += KV_THREADS) {
      const int row = gshift >= 2 ? q >> (gshift - 2) : q / per_row;
      const int col = (q - row * per_row) << 2;
      const int e = row * W + (col >> 5), bit = col & 31;
      const unsigned w = word_s[e];
      int c = before + pre_s[e] + __popc(w & ((1u << bit) - 1u));
      int o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool on = (w >> (bit + u)) & 1u;
        o[u] = on && c < ccap ? c + seg : -1;
        c += on;
      }
      out4[q] = make_int4(o[0], o[1], o[2], o[3]);
    }
  } else {
    for (int q = tid; q < nrows * g; q += KV_THREADS) {
      const int row = q / g, col = q - row * g;
      const int e = row * W + (col >> 5), bit = col & 31;
      const unsigned w = word_s[e];
      const int c = before + pre_s[e] + __popc(w & ((1u << bit) - 1u));
      out[q] = ((w >> bit) & 1u) && c < ccap ? c + seg : -1;
    }
  }
}

// KV (3): one thread per source row: vox_cid, dropped rows, slot stamps
// (the rows of one column write the same stamps: the first of each run of
// a column's rows in a warp writes them).
__global__ void stamp_kernel(const int4* __restrict__ coords, const uint8_t* __restrict__ valid,
                             const int* __restrict__ grid, long long* __restrict__ vox_cid,
                             long long* __restrict__ col_bxy, uint8_t* __restrict__ col_valid,
                             int* __restrict__ overflow, int n, int nb, int grid_half, int level,
                             int ccap, int r) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = (2 * grid_half) >> level;
  const long long cells = (long long)nb * g * g, slots = (long long)nb * ccap;
  bool drop = false;
  long long cid = -1, bsafe = 0;
  int gxc = 0, gyc = 0;
  if (i < n) {
    const Cell c = cell_of(coords[i], valid[i], grid_half, level);
    gxc = clampi(c.gx, 0, g - 1);
    gyc = clampi(c.gy, 0, g - 1);
    bsafe = c.ok ? c.b : 0;
    if (c.ok) {
      const long long flat = (bsafe * g + gxc) * g + gyc;
      if (flat >= 0 && flat < cells) cid = grid[flat];
    }
    vox_cid[i] = cid;
    drop = c.ok && cid < 0;
  }
  if (run_start(cid >= 0, (unsigned)cid)) {
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
  const unsigned drops = __ballot_sync(0xffffffffu, drop);
  if ((threadIdx.x & 31) == 0 && drops) atomicAdd(overflow + 1 + level, __popc(drops));
}

// KW, level 0: the table (int4 [slots * 4]) and the sortless scan
// counts zeroed before the bits are stamped.
__global__ void real_zero_kernel(int4* __restrict__ real4, int n4,
                                 unsigned long long* __restrict__ nreal, int nb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) real4[i] = make_int4(0, 0, 0, 0);
  if (nreal != nullptr && i < nb) nreal[i] = 0ULL;  // nb <= slots < n4
}

// KW, level 0: the source rows' bits.
__global__ void real_bits_kernel(const int4* __restrict__ coords, const uint8_t* __restrict__ valid,
                                 const long long* __restrict__ vox_cid,
                                 unsigned* __restrict__ real_w,
                                 unsigned long long* __restrict__ nreal, int n, int grid_half,
                                 int ccap, int slots, bool unique) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool fresh = false;
  int b = 0;
  if (i < n) {
    const long long cid = vox_cid[i];
    const Cell c = cell_of(coords[i], valid[i], grid_half, 0);
    if (c.ok && cid >= 0 && cid < slots) {
      const int word = clampi(c.bz >> 5, 0, ZWORDS - 1);
      const unsigned bit = 1u << (c.bz & 31);
      unsigned* w = real_w + (int)cid * REAL_W + word;
      if (unique) {
        atomicAdd(w, bit);
      } else {
        fresh = !(atomicOr(w, bit) & bit);
        b = (int)cid / ccap;
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

// KW, levels 1-4: KW_LANES lanes per slot (see the top): 4 child fetches,
// then _zpair_words.  Sizes below 2^31 (the wrapper's checks): 32-bit
// indices.
__global__ void coarsen_kernel(const long long* __restrict__ col_bxy,
                               const uint8_t* __restrict__ col_valid,
                               const int* __restrict__ fine_grid,
                               const int4* __restrict__ fine_real,
                               int4* __restrict__ real_w, int slots, int fine_slots, int nb,
                               int grid_half, int level) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = t / KW_LANES, q = threadIdx.x % KW_LANES;
  const bool in = s < slots;  // every lane takes part in the shuffles
  const int f_g = (2 * grid_half) >> (level - 1);
  // lane q's child column (cx, cy) = (q >> 1, q & 1) through the fine grid
  int cidf = -1;
  if (in && col_valid[s]) {
    const long long p = col_bxy[s];
    const int bC = (int)(p >> 24), gxf = 2 * (int)((p >> 12) & 4095) + (q >> 1),
              gyf = 2 * (int)(p & 4095) + (q & 1);
    if (gxf < f_g && gyf < f_g && bC >= 0 && bC < nb) {
      const int c = fine_grid[(bC * f_g + gxf) * f_g + gyf];
      if (c >= 0 && c < fine_slots) cidf = c;  // else a miss: a zero row
    }
  }
  // the group's 4 child ids, then this lane's quarter of each child row
  int4 v[KW_LANES];
#pragma unroll
  for (int j = 0; j < KW_LANES; ++j) {
    const int c = __shfl_sync(0xffffffffu, cidf, j, KW_LANES);
    v[j] = c >= 0 ? fine_real[c * (REAL_W / 4) + q] : make_int4(0, 0, 0, 0);
  }
  unsigned a[4];
  a[0] = (unsigned)(v[0].x | v[1].x | v[2].x | v[3].x);
  a[1] = (unsigned)(v[0].y | v[1].y | v[2].y | v[3].y);
  a[2] = (unsigned)(v[0].z | v[1].z | v[2].z | v[3].z);
  a[3] = (unsigned)(v[0].w | v[1].w | v[2].w | v[3].w);
  if (q == KW_LANES - 1) a[2] = a[3] = 0u;  // words 14, 15: no z bits
  // comp of words 4q .. 4q+3, two 16-bit halves a packed word
  unsigned c[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = compress_even(a[e] | (a[e] >> 1));
  const unsigned p0 = c[0] | (c[1] << 16), p1 = c[2] | (c[3] << 16);
  // out word 4q+e = comp[8q+2e-7] | comp[8q+2e-6] << 16: comps 8q-8 .. 8q
  // are packed words p0, p1 of lanes 2q-2 and 2q-1 and p0 of lane 2q (0
  // outside the group: comps below 0 or above 13)
  unsigned w[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const int src = 2 * q - 2 + (j >> 1);
    const unsigned x = __shfl_sync(0xffffffffu, (j & 1) ? p1 : p0, src & (KW_LANES - 1),
                                   KW_LANES);
    w[j] = src >= 0 && src < KW_LANES ? x : 0u;
  }
  if (in)
    real_w[s * (REAL_W / 4) + q] =
        make_int4((int)__funnelshift_r(w[0], w[1], 16), (int)__funnelshift_r(w[1], w[2], 16),
                  (int)__funnelshift_r(w[2], w[3], 16), (int)__funnelshift_r(w[3], w[4], 16));
}

// KX: one block per tile (see the top).  state: [nb * tiles_per_scan]
// status words, then the tile and finish counters (two uint32); all 0 on
// entry and on exit.
__global__ void __launch_bounds__(KX_TILE)
aug_kernel(const int* __restrict__ real_w, const long long* __restrict__ bxy,
           const uint8_t* __restrict__ cvalid, const int* __restrict__ grid,
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
  // 16-byte quarters of the staged rows (the pad words are not staged)
  for (int e = tid; e < (n_in + 2) * 4; e += KX_TILE) {
    const int i = e >> 2;
    stage_real16(own_s + i * KX_ROW, reinterpret_cast<const int4*>(real_w), s0 - 1 + i, slots,
                 e & 3);
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
          const int cn = grid[flat];
          if (cn >= 0 && cn < slots) cid[d] = cn;
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
        const int* row = real_w + (here ? cn : 0) * REAL_W + hl;
        pc[j] = here ? bxy[cn] : 0;
        pu[j] = up ? bxy[cn + 1] : 0;
        pd[j] = dn ? bxy[cn - 1] : 0;
        vc[j] = here ? cvalid[cn] : 0;
        vu[j] = up ? cvalid[cn + 1] : 0;
        vd[j] = dn ? cvalid[cn - 1] : 0;
        w0[j] = here && word ? (unsigned)row[0] : 0u;
        wu[j] = up && word ? (unsigned)row[REAL_W] : 0u;
        wd[j] = dn && word ? (unsigned)row[-REAL_W] : 0u;
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
    if (lane == 0)
      st_status(st + k, (k == 0 ? SCAN_PREFIX : SCAN_AGG) | (unsigned long long)tile_sum);
    for (int p = k - 1; p >= 0;) {
      const int q = p - lane;
      const unsigned long long w = q >= 0 ? ld_status(st + q) : SCAN_PREFIX;
      const unsigned pm = __ballot_sync(0xffffffffu, (w & SCAN_PREFIX) != 0);
      const unsigned zm = __ballot_sync(0xffffffffu, w == 0);
      const int first_p = pm ? __ffs(pm) - 1 : 32, first_z = zm ? __ffs(zm) - 1 : 32;
      const int upto = min(first_p + 1, first_z);  // lanes summed this round
      long long add = lane < upto ? (long long)(w & SCAN_SUM) : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) add += __shfl_xor_sync(0xffffffffu, add, o);
      before += add;
      if (first_p < first_z) break;
      p -= upto;
    }
    if (lane == 0) {
      if (k > 0) st_status(st + k, SCAN_PREFIX | (unsigned long long)(before + tile_sum));
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


// KY (1): one thread per source row: its candidates' packed words and
// the real flag into the scratch rows, and the level's row maps.
__global__ void scatter_rows_kernel(const int* __restrict__ pos3,
                                    const int4* __restrict__ coords,
                                    const uint8_t* __restrict__ valid,
                                    unsigned* __restrict__ packed_a, uint8_t* __restrict__ flag_a,
                                    int* __restrict__ pos, int* __restrict__ off,
                                    int* __restrict__ map8, int n, int n_a, int grid_half,
                                    int level, bool rep) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int g = (2 * grid_half) >> level;
  const int4 cr = coords[i];
  const Cell c = cell_of(cr, true, grid_half, level);
  // gxgy << 9 | bz, mod 2^32 (lidog_tpu's uint32 wrap)
  const unsigned packed0 = (((unsigned)clampi(c.gx, 0, g - 1) * (unsigned)g +
                             (unsigned)clampi(c.gy, 0, g - 1)) << 9) |
                           (unsigned)clampi(c.bz, 0, ZMAX - 1);
  int p[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {  // candidates z-1, z, z+1
    const int q = pos3[(size_t)d * n + i];
    p[d] = q >= 0 && q < n_a ? q : -1;
    if (p[d] >= 0) packed_a[p[d]] = packed0 + d - 1;
  }
  const bool vi = valid[i];
  if (vi && p[1] >= 0) flag_a[p[1]] = 1;
  if (level == 0) {
    const int pin = vi ? pos3[n + i] : -1;
    pos[i] = pin;
    if (rep && pin >= 0 && pin < n_a) atomicMin(map8 + pin, i);
    return;
  }
  // the fine row's offset in its parent: bit (level-1) of x, y, z
  const int lowmask = (1 << level) - 1;
  const int offv = ((cr.y & lowmask) >> (level - 1)) * 4 + ((cr.z & lowmask) >> (level - 1)) * 2 +
                   ((cr.w & lowmask) >> (level - 1));
  pos[i] = pos3[n + i];
  off[i] = offv;
  if (p[1] >= 0) map8[(size_t)clampi(offv, 0, 7) * n_a + p[1]] = i;
}

// row j+1 is (same b, x, y, z + stride) and both rows are valid.
__device__ __forceinline__ bool z_adjacent(int4 a, bool va, int4 b, bool vb, int stride) {
  return va && vb && a.x == b.x && a.y == b.y && a.z == b.z &&
         b.w == (int)((unsigned)a.w + (unsigned)stride);
}

// KY (2): one block per tile of KY_TILE aug rows of one scan: each row
// decoded once into shared memory (one row each side within the scan),
// the flags from there.  The scratch is left zero for a later launch: a
// block clears the real flags of its rows, and the launch clears `stale`,
// the other of the two packed-row tables, which the previous launch
// filled (each launch reads one table and clears the other, so that no
// block clears a row that another block still reads).
__global__ void __launch_bounds__(KY_TILE)
decode_kernel(const unsigned* __restrict__ packed_a, unsigned* __restrict__ stale, int stale_n,
              uint8_t* __restrict__ flag_a, const long long* __restrict__ counts_b,
              int4* __restrict__ coords_a, uint8_t* __restrict__ real_a,
              uint8_t* __restrict__ valid_a, uint8_t* __restrict__ zup, uint8_t* __restrict__ zdn,
              int* __restrict__ rep, int cap_a, int tiles_per_scan, int g, int gshift,
              int grid_half, int level) {
  __shared__ int4 c_s[KY_TILE + 2];  // row i is the scan's row k*KY_TILE - 1 + i
  __shared__ uint8_t v_s[KY_TILE + 2];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / tiles_per_scan, k = blockIdx.x - b * tiles_per_scan;
  const int loc0 = k * KY_TILE, nr = min(KY_TILE, cap_a - loc0);
  const int j0 = b * cap_a + loc0;
  const long long cnt = counts_b[b];
  const int lim = (int)(cnt < cap_a ? cnt : (long long)cap_a);
  const unsigned gh = grid_half >> level;
  // rows tid and (threads 0, 1) KY_TILE + tid: every load issued first
  const uint8_t f = tid < nr ? flag_a[j0 + tid] : 0;
  unsigned p[2];
  bool v[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = tid + h * KY_TILE, loc = loc0 - 1 + i;
    v[h] = i < nr + 2 && loc >= 0 && loc < lim;
    p[h] = v[h] ? packed_a[j0 - 1 + i] : 0u;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = tid + h * KY_TILE;
    if (i >= nr + 2) continue;
    int4 c = make_int4(0, 0, 0, 0);
    if (v[h]) {
      const unsigned gxgy = p[h] >> 9;
      const unsigned q = gshift >= 0 ? gxgy >> gshift : gxgy / (unsigned)g;
      const unsigned rem = gxgy - q * (unsigned)g;
      c = make_int4(b, (int)((q - gh) << level), (int)((rem - gh) << level),
                    (int)(((p[h] & 511u) - (unsigned)ZC) << level));
    }
    c_s[i] = c;
    v_s[i] = v[h];
  }
  for (int j = blockIdx.x * KY_TILE + tid; j < stale_n; j += gridDim.x * KY_TILE) stale[j] = 0u;
  __syncthreads();
  if (tid < nr) {
    const int j = j0 + tid, i = tid + 1;
    const bool vi = v_s[i];
    const int stride = 1 << level;
    coords_a[j] = c_s[i];
    valid_a[j] = vi;
    if (f) flag_a[j] = 0;
    real_a[j] = f && vi;
    zup[j] = z_adjacent(c_s[i], vi, c_s[i + 1], v_s[i + 1], stride);
    zdn[j] = z_adjacent(c_s[i - 1], v_s[i - 1], c_s[i], vi, stride);
    if (rep != nullptr && rep[j] == REP_NONE) rep[j] = -1;
  }
}

cudaStream_t as_stream(void* stream) { return reinterpret_cast<cudaStream_t>(stream); }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

unsigned blocks_of(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

bool level_ok(int nb, int grid_half, int level) {
  const int g = level >= 0 && level < NUM_LEVELS ? (2 * grid_half) >> level : 0;
  return nb >= 1 && g >= 1 && (long long)nb * g * g < 0x7FFFFFFFLL;
}

int log2_exact(int v) {  // log2(v) for a power of two, else -1
  return v > 0 && (v & (v - 1)) == 0 ? __builtin_ctz((unsigned)v) : -1;
}

}  // namespace

// Each function returns a cudaError_t (0 = launched).

// KV: grid int32 [nb*g*g], vox_cid int64 [n], col_bxy int64 [nb*ccap] and
// col_valid bool [nb*ccap] (both zeroed by the caller); scratch: bits
// uint32 [nb*g*W], W = ceil(g / 32), zero on entry and left zero; counts
// int64 [1 + nb], the row pass's tile counter (its value before this
// launch: base) and the real-row counts (zero on entry and left zero);
// status int64 [nb * tiles_per_scan], tiles_per_scan = ceil(g /
// rows_per_tile), the look-back words of this launch, tagged with epoch
// (1 .. 2^30 - 1, not the last launch's); overflow int32 [6].  cap_real >=
// 0: unique level-0 input.
extern "C" int column_grid(const void* coords, const void* valid, void* grid, void* vox_cid,
                           void* col_bxy, void* col_valid, void* bits, void* counts, void* status,
                           void* overflow, int n, int nb, int grid_half, int level, int ccap, int r,
                           int cap_real, int rows_per_tile, int base, int epoch, void* stream) {
  if (n < 0 || !level_ok(nb, grid_half, level) || ccap < 1 || r < 0 || r > 31 ||
      !aligned16(coords) || !aligned16(grid) || epoch < 1 || (unsigned)epoch > SCAN_EPOCHS)
    return (int)cudaErrorInvalidValue;
  const int g = (2 * grid_half) >> level;
  const int W = (g + 31) / 32;
  if (g > 32768 || 2 * r + 1 > g || rows_per_tile < 1 || rows_per_tile * W > KV_TILE_WORDS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = as_stream(stream);
  const int tiles_per_scan = (g + rows_per_tile - 1) / rows_per_tile;
  int* ov = static_cast<int*>(overflow);
  unsigned long long* counts64 = static_cast<unsigned long long*>(counts);
  if (n > 0)
    bit_stamp_kernel<<<blocks_of(n), THREADS, 0, st>>>(
        static_cast<const int4*>(coords), static_cast<const uint8_t*>(valid),
        static_cast<unsigned*>(bits), counts64 + 1, n, nb, grid_half, level, W, cap_real >= 0);
  grid_rows_kernel<<<nb * tiles_per_scan, KV_THREADS, 0, st>>>(
      static_cast<unsigned*>(bits), static_cast<int*>(grid), counts64,
      static_cast<unsigned long long*>(status), ov, nb, g, log2_exact(g), W, log2_exact(W),
      rows_per_tile, tiles_per_scan, ccap, r, level, cap_real, (unsigned)base, (unsigned)epoch);
  if (n > 0)
    stamp_kernel<<<blocks_of(n), THREADS, 0, st>>>(
        static_cast<const int4*>(coords), static_cast<const uint8_t*>(valid),
        static_cast<const int*>(grid), static_cast<long long*>(vox_cid),
        static_cast<long long*>(col_bxy), static_cast<uint8_t*>(col_valid), ov, n, nb, grid_half,
        level, ccap, r);
  return (int)cudaGetLastError();
}

// KW: real_w int32 [nb*ccap, 16] (16-byte aligned; level 0 zeroed here
// first).  Level 0 reads coords, valid, vox_cid (n rows; unique or
// sortless, nreal int64 [nb] scratch, zeroed here too); levels 1-4 read
// col_bxy, col_valid and the finer level's fine_grid int32 [nb*(2g)^2] and
// fine_real int32 [fine_slots, 16] (16-byte aligned).
extern "C" int real_words(const void* coords, const void* valid, const void* vox_cid,
                          const void* col_bxy, const void* col_valid, const void* fine_grid,
                          const void* fine_real, void* real_w, void* nreal, void* overflow, int n,
                          int fine_slots, int nb, int ccap, int grid_half, int level, int unique,
                          int cap_real, void* stream) {
  if (n < 0 || fine_slots < 0 || !level_ok(nb, grid_half, level) || ccap < 1 ||
      (long long)nb * ccap * REAL_W >= 0x7FFFFFFFLL || !aligned16(real_w))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = as_stream(stream);
  const int slots = nb * ccap;
  if (level == 0) {
    if (!aligned16(coords) || (!unique && nreal == nullptr)) return (int)cudaErrorInvalidValue;
    const int n4 = slots * (REAL_W / 4);
    real_zero_kernel<<<blocks_of(n4), THREADS, 0, st>>>(
        static_cast<int4*>(real_w), n4,
        unique ? nullptr : static_cast<unsigned long long*>(nreal), nb);
    if (n > 0)
      real_bits_kernel<<<blocks_of(n), THREADS, 0, st>>>(
          static_cast<const int4*>(coords), static_cast<const uint8_t*>(valid),
          static_cast<const long long*>(vox_cid), static_cast<unsigned*>(real_w),
          static_cast<unsigned long long*>(nreal), n, grid_half, ccap, slots, unique != 0);
    if (!unique)
      real_over_kernel<<<1, 32, 0, st>>>(static_cast<const unsigned long long*>(nreal),
                                         static_cast<int*>(overflow), nb, cap_real);
  } else {
    if (!level_ok(nb, grid_half, level - 1) || (long long)fine_slots * REAL_W >= 0x7FFFFFFFLL ||
        !aligned16(fine_real))
      return (int)cudaErrorInvalidValue;
    coarsen_kernel<<<blocks_of((long long)slots * KW_LANES), THREADS, 0, st>>>(
        static_cast<const long long*>(col_bxy), static_cast<const uint8_t*>(col_valid),
        static_cast<const int*>(fine_grid), static_cast<const int4*>(fine_real),
        static_cast<int4*>(real_w), slots, fine_slots, nb, grid_half, level);
  }
  return (int)cudaGetLastError();
}

// KX: real_w int32 [nb*ccap, 16] (KW's, 16-byte aligned); grid int32
// [nb*g*g]; aug16 int32 [nb*ccap, 16] (16-byte aligned),
// counts_b int64 [nb];
// state: int64 [nb * ceil(ccap / KX_TILE) + 1], zero on entry and left
// zero (the look-back words and the two tile counters).
extern "C" int assemble_aug(const void* real_w, const void* col_bxy, const void* col_valid,
                            const void* grid, void* aug16, void* counts_b, void* state,
                            void* overflow, int nb, int g, int ccap, int cap_a, int level,
                            void* stream) {
  if (nb < 1 || g < 1 || ccap < 1 || cap_a < 1 || level < 0 || level >= NUM_LEVELS ||
      (long long)nb * ccap * AUG16 >= 0x7FFFFFFFLL || !aligned16(aug16) || !aligned16(real_w))
    return (int)cudaErrorInvalidValue;
  const int tiles_per_scan = (ccap + KX_TILE - 1) / KX_TILE;
  aug_kernel<<<nb * tiles_per_scan, KX_TILE, 0, as_stream(stream)>>>(
      static_cast<const int*>(real_w), static_cast<const long long*>(col_bxy),
      static_cast<const uint8_t*>(col_valid), static_cast<const int*>(grid),
      static_cast<int*>(aug16), static_cast<long long*>(counts_b), static_cast<int*>(overflow),
      static_cast<unsigned long long*>(state), nb, g, ccap, cap_a, level, tiles_per_scan);
  return (int)cudaGetLastError();
}

// KY: from pos3 int32 [3, n] (KT's) and counts_b int64 [nb]: coords_a
// int32 [nb*cap_a, 4]; real_a, valid_a, zup, zdn bool
// [nb*cap_a]; scratch: packed_a uint32 [nb*cap_a] and flag_a bool
// [nb*cap_a], zero on entry, flag_a left zero; stale uint32 [stale_n], the
// packed rows of an earlier launch, cleared here; pos int32 [n] (level 0:
// pos, else parent); level > 0: off int32 [n] and map8 = down8 int32 [8,
// nb*cap_a] (filled with -1); level 0 with rep: map8 = rep int32
// [nb*cap_a] (filled with 0x7FFFFFFF).
extern "C" int emit_rows(const void* pos3, const void* coords, const void* valid,
                         const void* counts_b, void* coords_a, void* real_a, void* valid_a,
                         void* zup, void* zdn, void* packed_a, void* stale, void* flag_a, void* pos,
                         void* off, void* map8, int n, int nb, int cap_a, int grid_half, int level,
                         int rep, int stale_n, void* stream) {
  if (n < 0 || stale_n < 0 || !level_ok(nb, grid_half, level) || cap_a < 1 ||
      (rep && level != 0) || (long long)nb * cap_a >= 0x7FFFFFFFLL || !aligned16(coords) ||
      !aligned16(coords_a))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = as_stream(stream);
  const int n_a = nb * cap_a, g = (2 * grid_half) >> level;
  const int tiles_per_scan = (cap_a + KY_TILE - 1) / KY_TILE;
  if (n > 0)
    scatter_rows_kernel<<<blocks_of(n), THREADS, 0, st>>>(
        static_cast<const int*>(pos3), static_cast<const int4*>(coords),
        static_cast<const uint8_t*>(valid), static_cast<unsigned*>(packed_a),
        static_cast<uint8_t*>(flag_a), static_cast<int*>(pos), static_cast<int*>(off),
        static_cast<int*>(map8), n, n_a, grid_half, level, rep != 0);
  decode_kernel<<<nb * tiles_per_scan, KY_TILE, 0, st>>>(
      static_cast<const unsigned*>(packed_a), static_cast<unsigned*>(stale), stale_n,
      static_cast<uint8_t*>(flag_a), static_cast<const long long*>(counts_b),
      static_cast<int4*>(coords_a), static_cast<uint8_t*>(real_a), static_cast<uint8_t*>(valid_a),
      static_cast<uint8_t*>(zup), static_cast<uint8_t*>(zdn),
      rep ? static_cast<int*>(map8) : nullptr, cap_a, tiles_per_scan, g, log2_exact(g),
      grid_half, level);
  return (int)cudaGetLastError();
}

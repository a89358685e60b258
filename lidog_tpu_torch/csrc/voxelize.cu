// LC: the device voxelizer after quantization (K1).
//
// Replaces lidog_tpu/core/voxelize.py:81-118 (`voxelize_device`: lexsort of
// the packed keys, first flags, cumsum slots, the coords / rep scatters and
// the inverse map), which the port's plain version does with torch.sort,
// cumsum and scatters (core/voxelize.py voxelize_plain, ~95 launches).
// Outputs are bitwise equal to it, overflow included.
//
// Input: the voxel cells disc int32 [P, 3] (core/voxelize.py quantize),
// valid bool [P], batch int32 [P].  Output: coords int32 [cap, 4] (batch,
// x, y, z of each voxel's first point, canonical order), mask bool [cap],
// rep int32 [cap] (that point's index), inverse int32 [P] (point -> voxel
// slot, -1 when invalid or beyond cap), num_voxels and overflow (int32).
//
// Steps, all on the current stream, no host sync:
//  1. vox_keys: keys.pack's (hi, lo) per point, as the plain version's
//     int32 arithmetic; the sort key c = hi * 2^26 + lo orders exactly as
//     the plain (hi << 31) | lo (lo < 2^26 on every valid key), invalid
//     points get c = 2^57, above every valid key; stored as the unsigned
//     u = c ^ 2^63.  It also writes pass 0's per-block digit counts.
//  2. vox_scatter x 6: a stable LSD radix sort of u, 11 bits per pass.  A
//     block owns a 4,096-key tile; its digit offsets are the digit's
//     exclusive start (a scan of the pass's digit totals) plus the counts
//     of the earlier tiles; keys are ranked within the tile in order (each
//     warp owns 512 consecutive keys: the warps' digit counts, summed
//     over the earlier warps, then __match_any_sync among equal digits 32
//     keys at a time), so equal keys keep input order.  Scattering pass p also counts pass
//     p+1's digits per destination tile (warp-aggregated int atomics:
//     order-free, so deterministic).  A pass whose digit is the same on
//     every key (the totals say so) is the identity and only copies: the
//     sort does work on the key's live bits only, the 39 coordinate bits
//     and the batch bits in use (plus the invalid bit when a point is
//     invalid).
//  3. vox_flags: first flags (valid and not equal to the previous key) and
//     their count per tile (warp ballots).
//  4. vox_compact: each tile's exclusive start (the earlier tiles' counts),
//     each warp's within it, and ballots of its flags give every sorted
//     point its voxel slot
//     (the plain cumsum - 1); it scatters coords, rep, inverse, and fills
//     the mask and the rows from num_voxels to cap, num_voxels, overflow.
//
// Bound on an H100: bytes (the points' fields read once, the outputs
// written once; 0.005 ms for 4 x 100k points), far below what the passes
// over 12-byte (key, index) pairs and the launches cost: the kernel is
// bound by its launches and passes.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int TILE = 4096;  // keys per block
constexpr int RADIX_BITS = 11;
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int NPASS = 6;  // 66 bits >= the 64-bit key
constexpr int DPT = RADIX / THREADS;  // digits per thread (8: two int4 loads)
constexpr int KPW = TILE / NWARPS;    // keys per warp (512)
// vox_scatter: run, next_hist (int [RADIX] each), warp_sums (16 ints) and
// the warps' 16-bit digit offsets [NWARPS][RADIX]
constexpr int SCATTER_SMEM = (2 * RADIX + 16) * 4 + NWARPS * RADIX * 2;
constexpr int COORD_BITS = 13;
constexpr int COORD_HALF = 1 << (COORD_BITS - 1);
constexpr int INVALID = 0x7fffffff;
constexpr long long C_INVALID = 1LL << 57;
constexpr unsigned long long SIGN = 1ULL << 63;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int digit(unsigned long long u, int pass) {
  return (int)((u >> (RADIX_BITS * pass)) & (RADIX - 1));
}

__device__ __forceinline__ bool key_valid(unsigned long long u) {
  const long long c = (long long)(u ^ SIGN);
  return c != C_INVALID && (c >> 26) != INVALID;
}

// Exclusive scan of one int per thread over the block; *total gets the sum.
__device__ int block_scan_excl(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < NWARPS ? warp_sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, wi, o);
      if (lane >= o) wi += t;
    }
    if (lane < NWARPS) warp_sums[lane] = wi - w;
    if (lane == NWARPS - 1) warp_sums[NWARPS] = wi;
  }
  __syncthreads();
  const int excl = warp_sums[warp] + incl - v;
  *total = warp_sums[NWARPS];
  __syncthreads();  // warp_sums is free again
  return excl;
}

__global__ void __launch_bounds__(THREADS)
vox_keys(const int* __restrict__ disc, const uint8_t* __restrict__ valid,
         const int* __restrict__ batch, unsigned long long* __restrict__ keys,
         int* __restrict__ idx, int* __restrict__ counts, int* __restrict__ totals, int n) {
  __shared__ int hist[RADIX];
  for (int d = threadIdx.x; d < RADIX; d += THREADS) hist[d] = 0;
  __syncthreads();
  const int begin = blockIdx.x * TILE;
  const int end = min(n, begin + TILE);
  for (int i = begin + threadIdx.x; i < end; i += THREADS) {
    const int b = batch[i];
    const int x = disc[3 * (size_t)i], y = disc[3 * (size_t)i + 1], z = disc[3 * (size_t)i + 2];
    const int lo_c = -COORD_HALF, hi_c = COORD_HALF - 1;
    const bool ok = valid[i] && x >= lo_c && x <= hi_c && y >= lo_c && y <= hi_c && z >= lo_c &&
                    z <= hi_c && b >= 0;
    // keys.pack in int32, wrapping as the plain version's shifts do
    const int hi = (int)(((unsigned)max(b, 0) << COORD_BITS) | (unsigned)(x + COORD_HALF));
    const int lo = (int)(((unsigned)(y + COORD_HALF) << COORD_BITS) | (unsigned)(z + COORD_HALF));
    const long long c = ok ? (long long)hi * (1LL << 26) + lo : C_INVALID;
    const unsigned long long u = (unsigned long long)c ^ SIGN;
    keys[i] = u;
    idx[i] = i;
    atomicAdd(&hist[digit(u, 0)], 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < RADIX; d += THREADS) {
    counts[(size_t)blockIdx.x * RADIX + d] = hist[d];
    if (hist[d]) atomicAdd(&totals[d], hist[d]);
  }
}

// One stable LSD pass: keys_in/idx_in -> keys_out/idx_out by digit `pass`.
// counts: [NPASS][nblocks][RADIX], totals: [NPASS][RADIX] (pass p+1's
// rows zero on entry: this kernel adds them).  Each warp ranks its own
// KPW consecutive keys of the tile: the warps' digit counts, an exclusive
// sum over the warps per digit, then per 32 keys a __match_any_sync
// among equal digits (rank = the equal lanes before it), in order.
// Dynamic shared memory: SCATTER_SMEM bytes.
__global__ void __launch_bounds__(THREADS)
vox_scatter(const unsigned long long* __restrict__ keys_in, const int* __restrict__ idx_in,
            unsigned long long* __restrict__ keys_out, int* __restrict__ idx_out,
            int* __restrict__ counts, int* __restrict__ totals, int n, int nblocks, int pass) {
  extern __shared__ __align__(16) int smem[];
  int* run = smem;                      // [RADIX] the tile's first slot per digit
  int* next_hist = run + RADIX;         // [RADIX] pass p+1's digits in this tile
  int* warp_sums = next_hist + RADIX;   // [NWARPS + 1]
  unsigned short* woff = reinterpret_cast<unsigned short*>(warp_sums + 16);  // [NWARPS][RADIX]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* tot = totals + (size_t)pass * RADIX;
  // the digits' exclusive starts; a pass whose digit is constant is the identity
  int mine[DPT], sum = 0;
  bool constant = false;
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    mine[j] = tot[tid * DPT + j];
    constant |= mine[j] == n;
    sum += mine[j];
  }
  int total;
  int start = block_scan_excl(sum, warp_sums, &total);
  const bool identity = __syncthreads_or(constant);
  int before[DPT] = {};
  if (!identity) {  // plus the counts of the earlier tiles, 4 tiles per step
    const int* cnt = counts + (size_t)pass * nblocks * RADIX + tid * DPT;
    int b = 0;
    for (; b + 4 <= (int)blockIdx.x; b += 4) {
      int4 v[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4* row = reinterpret_cast<const int4*>(cnt + (size_t)(b + q) * RADIX);
        v[2 * q] = row[0];
        v[2 * q + 1] = row[1];
      }
#pragma unroll
      for (int q = 0; q < 8; q += 2) {
        before[0] += v[q].x; before[1] += v[q].y; before[2] += v[q].z; before[3] += v[q].w;
        before[4] += v[q + 1].x; before[5] += v[q + 1].y; before[6] += v[q + 1].z;
        before[7] += v[q + 1].w;
      }
    }
    for (; b < (int)blockIdx.x; ++b) {
      const int4* row = reinterpret_cast<const int4*>(cnt + (size_t)b * RADIX);
      const int4 lo4 = row[0], hi4 = row[1];
      before[0] += lo4.x; before[1] += lo4.y; before[2] += lo4.z; before[3] += lo4.w;
      before[4] += hi4.x; before[5] += hi4.y; before[6] += hi4.z; before[7] += hi4.w;
    }
  }
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    run[tid * DPT + j] = start + before[j];
    start += mine[j];
    next_hist[tid * DPT + j] = 0;
  }
  for (int v = tid; v < NWARPS * RADIX / 2; v += THREADS) reinterpret_cast<int*>(woff)[v] = 0;
  __syncthreads();
  const unsigned lt = (1u << lane) - 1;
  const int wbegin = blockIdx.x * TILE + warp * KPW;
  unsigned short* my_off = woff + warp * RADIX;
  if (!identity) {
    // this warp's digit counts
    for (int s = wbegin; s < wbegin + KPW; s += 32) {
      const int i = s + lane;
      const int d = i < n ? digit(keys_in[i], pass) : -1 - lane;
      const unsigned peers = __match_any_sync(FULL, d);
      if (i < n && lane == __ffs(peers) - 1) my_off[d] += (unsigned short)__popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // per digit, exclusive over the warps: each warp's first slot in the tile
    for (int d = tid; d < RADIX; d += THREADS) {
      int acc = 0;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        const int c = woff[w * RADIX + d];
        woff[w * RADIX + d] = (unsigned short)acc;
        acc += c;
      }
    }
    __syncthreads();
  }
  const bool has_next = pass + 1 < NPASS;
  int* cnt_next = counts + (size_t)(pass + 1) * nblocks * RADIX;
  for (int s = wbegin; s < wbegin + KPW; s += 32) {
    const int i = s + lane;
    const bool have = i < n;
    const unsigned long long u = have ? keys_in[i] : 0ULL;
    int pos = i;
    if (!identity) {
      const int d = have ? digit(u, pass) : -1 - lane;
      const unsigned peers = __match_any_sync(FULL, d);
      if (have) pos = run[d] + my_off[d] + __popc(peers & lt);
      __syncwarp();
      if (have && lane == __ffs(peers) - 1) my_off[d] += (unsigned short)__popc(peers);
      __syncwarp();
    }
    if (have) {
      keys_out[pos] = u;
      idx_out[pos] = idx_in[i];
    }
    if (has_next) {
      // pass p+1's count of (destination tile, digit), warp-aggregated
      const int dn = have ? digit(u, pass + 1) : 0;
      const int slot = have ? (pos / TILE) * RADIX + dn : -1 - lane;
      const unsigned peers = __match_any_sync(FULL, slot);
      if (have && lane == __ffs(peers) - 1) {
        atomicAdd(&cnt_next[slot], __popc(peers));
        atomicAdd(&next_hist[dn], __popc(peers));
      }
    }
  }
  __syncthreads();
  if (has_next) {
    for (int d = tid; d < RADIX; d += THREADS)
      if (next_hist[d]) atomicAdd(&totals[(size_t)(pass + 1) * RADIX + d], next_hist[d]);
  }
}

__device__ __forceinline__ int first_flag(const unsigned long long* keys, int i, int n) {
  if (i >= n) return 0;
  const unsigned long long u = keys[i];
  return key_valid(u) && (i == 0 || keys[i - 1] != u);
}

// The first flags of one warp's KPW keys of the tile.
__device__ int warp_flag_count(const unsigned long long* keys, int wbegin, int n) {
  int c = 0;
  for (int s = wbegin; s < wbegin + KPW; s += 32)
    c += __popc(__ballot_sync(FULL, first_flag(keys, s + (threadIdx.x & 31), n)));
  return c;
}

__global__ void __launch_bounds__(THREADS)
vox_flags(const unsigned long long* __restrict__ keys, int* __restrict__ block_count, int n) {
  __shared__ int s_count;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  const int c = warp_flag_count(keys, blockIdx.x * TILE + (threadIdx.x >> 5) * KPW, n);
  if ((threadIdx.x & 31) == 0) atomicAdd(&s_count, c);
  __syncthreads();
  if (threadIdx.x == 0) block_count[blockIdx.x] = s_count;
}

__global__ void __launch_bounds__(THREADS)
vox_compact(const unsigned long long* __restrict__ keys, const int* __restrict__ idx,
            const int* __restrict__ disc, const int* __restrict__ batch,
            const int* __restrict__ block_count, int nblocks, int n, int cap,
            int* __restrict__ coords, uint8_t* __restrict__ mask, int* __restrict__ rep,
            int* __restrict__ inverse, int* __restrict__ num_out, int* __restrict__ overflow_out) {
  __shared__ int warp_count[NWARPS];
  __shared__ int s_base, s_num;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) s_base = s_num = 0;
  __syncthreads();
  int base = 0, num = 0;
  for (int b = tid; b < nblocks; b += THREADS) {
    const int c = block_count[b];
    num += c;
    if (b < (int)blockIdx.x) base += c;
  }
  atomicAdd(&s_base, base);
  atomicAdd(&s_num, num);
  // each warp's first slot: the tile's start plus the earlier warps' flags
  const int wbegin = blockIdx.x * TILE + warp * KPW;
  const int wc = warp_flag_count(keys, wbegin, n);
  if (lane == 0) warp_count[warp] = wc;
  __syncthreads();
  num = s_num;
  int running = s_base;
  for (int w = 0; w < warp; ++w) running += warp_count[w];
  const int numc = min(num, cap);
  const unsigned lt = (1u << lane) - 1;
  for (int s = wbegin; s < wbegin + KPW; s += 32) {
    const int i = s + lane;
    const int f = first_flag(keys, i, n);
    const unsigned ball = __ballot_sync(FULL, f);
    const int uniq = running + __popc(ball & lt) + f - 1;  // the plain cumsum - 1
    if (i < n) {
      const int id = idx[i];
      const bool in_cap = uniq < cap;
      inverse[id] = key_valid(keys[i]) && in_cap ? uniq : -1;
      if (f && in_cap) {
        int4 row = make_int4(batch[id], disc[3 * (size_t)id], disc[3 * (size_t)id + 1],
                             disc[3 * (size_t)id + 2]);
        reinterpret_cast<int4*>(coords)[uniq] = row;
        rep[uniq] = id;
      }
    }
    running += __popc(ball);
  }
  // the mask, and the rows no voxel fills
  for (int j = blockIdx.x * THREADS + tid; j < cap; j += gridDim.x * THREADS) {
    mask[j] = j < numc;
    if (j >= numc) {
      reinterpret_cast<int4*>(coords)[j] = make_int4(0, 0, 0, 0);
      rep[j] = 0;
    }
  }
  if (blockIdx.x == 0 && tid == 0) {
    *num_out = num;
    *overflow_out = max(num - cap, 0);
  }
}

}  // namespace

// keys: [2, n] u64 and idx: [2, n] int32 ping-pong buffers; counts: int32
// [NPASS, nblocks, RADIX] followed by totals [NPASS, RADIX], all zero;
// block_count: int32 [nblocks]; nblocks = ceil(n / TILE).  Returns a
// cudaError_t (0 = launched).
extern "C" int voxelize(const void* disc, const void* valid, const void* batch, void* keys,
                        void* idx, void* counts, void* block_count, void* coords, void* mask,
                        void* rep, void* inverse, void* num_voxels, void* overflow, int n,
                        int cap, void* stream) {
  if (n <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int nblocks = (n + TILE - 1) / TILE;
  unsigned long long* k = static_cast<unsigned long long*>(keys);
  int* ix = static_cast<int*>(idx);
  int* cnt = static_cast<int*>(counts);
  int* tot = cnt + (size_t)NPASS * nblocks * RADIX;
  vox_keys<<<nblocks, THREADS, 0, st>>>(static_cast<const int*>(disc),
                                        static_cast<const uint8_t*>(valid),
                                        static_cast<const int*>(batch), k, ix, cnt, tot, n);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(vox_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SCATTER_SMEM);
  if (err != 0) return err;
  for (int p = 0; p < NPASS; ++p) {
    const int src = p % 2, dst = 1 - src;
    vox_scatter<<<nblocks, THREADS, SCATTER_SMEM, st>>>(k + (size_t)src * n, ix + (size_t)src * n,
                                             k + (size_t)dst * n, ix + (size_t)dst * n, cnt, tot,
                                             n, nblocks, p);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  // NPASS is even: the sorted keys are back in buffer 0
  int* bc = static_cast<int*>(block_count);
  vox_flags<<<nblocks, THREADS, 0, st>>>(k, bc, n);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  // enough blocks for the tiles and for the mask's cap rows
  const int cblocks = std::max(nblocks, std::min((cap + THREADS - 1) / THREADS, 1024));
  vox_compact<<<cblocks, THREADS, 0, st>>>(
      k, ix, static_cast<const int*>(disc), static_cast<const int*>(batch), bc, nblocks, n, cap,
      static_cast<int*>(coords), static_cast<uint8_t*>(mask), static_cast<int*>(rep),
      static_cast<int*>(inverse), static_cast<int*>(num_voxels), static_cast<int*>(overflow));
  return (int)cudaGetLastError();
}

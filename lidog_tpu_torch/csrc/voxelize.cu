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
// slot, -1 when invalid or beyond cap), num_voxels, overflow (max(num -
// cap, 0), as lidog_tpu's) and batch_breach (int32, 1 when the batch-size
// contract below is broken, else 0).
//
// The sort key: keys.pack's (hi, lo) per point, as the plain version's
// int32 arithmetic; c = hi * 2^26 + lo orders exactly as the plain
// (hi << 31) | lo (lo < 2^26 on every valid key).  The caller names its
// batch size B (the batch ids of valid points lie below B) and its pass
// plan (core/voxelize.py voxelize_passes): invalid points get c = c_inv =
// B << 39, above every valid key, and npass passes of 9 bits cover the
// key's 39 + bit_length(B) live bits (5 up to B = 63).  Stored as u = c ^
// 2^63; the passes sort its low 9 * npass bits.  A valid point with batch
// id B or more would have a key the passes cannot sort: vox_keys flags it
// and batch_breach comes out as 1 (the voxels are then not meaningful).
//
// Launches, all on the current stream, no host sync (7 kernels and one
// memset at B <= 63):
//  0. a memset of the work area (digit totals, tile counters, the
//     contract flag, the look-back status words);
//  1. vox_keys: the keys, every pass's digit totals (a digit's total does
//     not depend on the order), the contract flag, and zeros in the cap
//     rows of coords, rep and mask (the rows no voxel fills keep them);
//  2. vox_pass x npass: one stable LSD pass each, "Onesweep" style.  A
//     block takes the next 4,096-key tile (an atomic tile counter, so a
//     tile's predecessors are running), holds 8 keys per thread in
//     registers, counts its digits (shared-memory atomics) and publishes
//     the counts at once, then ranks the keys by digit in input order
//     (each warp owns 256 consecutive keys: __match_any_sync among equal
//     digits per 32 keys, warp-private digit counts, then an exclusive sum
//     over the warps) and finds the counts of all earlier tiles by a
//     decoupled look-back (a status word per tile and digit: aggregate or
//     inclusive prefix; one digit per thread, 32 predecessors read per
//     round), then scatters keys and point indices to digit start +
//     earlier tiles + rank.  O(tiles x radix) work per pass.  Digits of 9
//     bits, one per thread, rather than 11 (4 per thread): one more pass,
//     but a look-back round covers 32 predecessors, not 8.  The key
//     kernel and the passes ask for one L1 / shared memory split, so the
//     SMs do not reconfigure between them;
//  3. vox_compact: first flags (valid and not equal to the previous key),
//     each tile's voxel start by a look-back over the tiles' flag counts
//     (one warp, 32 predecessors at a time), every point's slot (the
//     plain cumsum - 1), the coords, rep, mask and inverse scatters (all
//     gathers issued before the scan); the last tile writes num_voxels,
//     overflow and batch_breach (the contract flag).
//
// Bound on an H100: bytes (the points' fields read once, the outputs
// written once; 0.005 ms for 4 x 100k points), far below what the passes
// over 12-byte (key, index) pairs and the launches cost: the kernel is
// bound by its launches and the passes' latency.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int ITEMS = 8;               // keys per thread
constexpr int TILE = THREADS * ITEMS;  // keys per block (4096)
constexpr int KPW = TILE / NWARPS;     // keys per warp (256)
constexpr int RADIX_BITS = 9;
constexpr int RADIX = 1 << RADIX_BITS; // one digit per thread
constexpr int MAX_PASS = 7;            // batch ids below 2^17: 56 live bits
constexpr int LOOKBACK = 32;           // predecessors read per round
// vox_pass: run (int [RADIX]), warp_sums (32 ints), the warps' 16-bit
// digit counts [NWARPS][RADIX]
constexpr int PASS_SMEM = (RADIX + 32) * 4 + NWARPS * RADIX * 2;
constexpr int COORD_BITS = 13;
constexpr int COORD_HALF = 1 << (COORD_BITS - 1);
constexpr int INVALID = 0x7fffffff;
constexpr unsigned long long SIGN = 1ULL << 63;
constexpr unsigned FULL = 0xffffffffu;
// a look-back status word: flag << 30 | count (0 = not yet published)
constexpr unsigned AGG = 1u << 30, PREFIX = 2u << 30, COUNT = (1u << 30) - 1;

__device__ __forceinline__ unsigned ld_status(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_status(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ bool key_valid(unsigned long long u, long long c_inv) {
  const long long c = (long long)(u ^ SIGN);
  return c != c_inv && (c >> 26) != INVALID;
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

// The next tile of a pass (tiles are taken in order, so every earlier tile
// is running or done and will publish its status).
__device__ int take_tile(int* counter, int* s_tile) {
  if (threadIdx.x == 0) *s_tile = atomicAdd(counter, 1);
  __syncthreads();
  return *s_tile;
}

// Dynamic shared memory: npass * RADIX ints.
__global__ void __launch_bounds__(THREADS)
vox_keys(const int* __restrict__ disc, const uint8_t* __restrict__ valid,
         const int* __restrict__ batch, unsigned long long* __restrict__ keys,
         int* __restrict__ totals, int* __restrict__ coords, uint8_t* __restrict__ mask,
         int* __restrict__ rep, int* __restrict__ bad, int n, int cap, long long c_inv,
         int npass) {
  extern __shared__ int hist[];  // [npass][RADIX]
  for (int d = threadIdx.x; d < npass * RADIX; d += THREADS) hist[d] = 0;
  __syncthreads();
  const long long nbatch = c_inv >> 39;  // B
  bool broken = false;  // a valid point at batch id B or more
  const int begin = blockIdx.x * TILE + threadIdx.x;
  int b[ITEMS], x[ITEMS], y[ITEMS], z[ITEMS];
  bool v[ITEMS];
#pragma unroll
  for (int s = 0; s < ITEMS; ++s) {  // every load first
    const int i = begin + s * THREADS;
    const bool have = i < n;
    b[s] = have ? batch[i] : 0;
    x[s] = have ? disc[3 * (size_t)i] : 0;
    y[s] = have ? disc[3 * (size_t)i + 1] : 0;
    z[s] = have ? disc[3 * (size_t)i + 2] : 0;
    v[s] = have && valid[i];
  }
#pragma unroll
  for (int s = 0; s < ITEMS; ++s) {
    const int i = begin + s * THREADS;
    if (i >= n) break;
    const int lo_c = -COORD_HALF, hi_c = COORD_HALF - 1;
    const bool ok = v[s] && x[s] >= lo_c && x[s] <= hi_c && y[s] >= lo_c && y[s] <= hi_c &&
                    z[s] >= lo_c && z[s] <= hi_c && b[s] >= 0;
    broken |= v[s] && b[s] >= nbatch;
    // keys.pack in int32, wrapping as the plain version's shifts do
    const int hi =
        (int)(((unsigned)max(b[s], 0) << COORD_BITS) | (unsigned)(x[s] + COORD_HALF));
    const int lo =
        (int)(((unsigned)(y[s] + COORD_HALF) << COORD_BITS) | (unsigned)(z[s] + COORD_HALF));
    const long long c = ok ? (long long)hi * (1LL << 26) + lo : c_inv;
    const unsigned long long u = (unsigned long long)c ^ SIGN;
    keys[i] = u;
    for (int p = 0; p < npass; ++p)
      atomicAdd(&hist[p * RADIX + (int)((u >> (RADIX_BITS * p)) & (RADIX - 1))], 1);
  }
  if (broken) *bad = 1;
  __syncthreads();
  for (int d = threadIdx.x; d < npass * RADIX; d += THREADS)
    if (hist[d]) atomicAdd(&totals[d], hist[d]);
  // the cap rows start empty; vox_compact fills the voxels' rows
  for (int j = blockIdx.x * THREADS + threadIdx.x; j < cap; j += gridDim.x * THREADS) {
    reinterpret_cast<int4*>(coords)[j] = make_int4(0, 0, 0, 0);
    rep[j] = 0;
    mask[j] = 0;
  }
}

// One stable LSD pass by the digit at `shift`: keys_in/idx_in ->
// keys_out/idx_out (idx_in null: the point index itself).  totals: this
// pass's digit totals; status: [tiles][RADIX] look-back words (a warp
// reads one predecessor's words of 32 consecutive digits as one line), zero
// on entry; counter: this pass's tile counter, zero on entry.  Dynamic
// shared memory: PASS_SMEM bytes.
__global__ void __launch_bounds__(THREADS)
vox_pass(const unsigned long long* __restrict__ keys_in, const int* __restrict__ idx_in,
         unsigned long long* __restrict__ keys_out, int* __restrict__ idx_out,
         const int* __restrict__ totals, unsigned* __restrict__ status, int* counter, int n,
         int shift) {
  extern __shared__ __align__(16) int smem[];
  int* run = smem;                     // [RADIX] the tile's count, then first slot, per digit
  int* warp_sums = run + RADIX;        // [NWARPS + 1]
  unsigned short* woff = reinterpret_cast<unsigned short*>(warp_sums + 32);  // [NWARPS][RADIX]
  __shared__ int s_tile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int v = tid; v < NWARPS * RADIX / 8; v += THREADS)
    reinterpret_cast<uint4*>(woff)[v] = make_uint4(0, 0, 0, 0);
  run[tid] = 0;
  const int tile = take_tile(counter, &s_tile);  // (its barrier also covers woff, run)

  // this warp's KPW consecutive keys, 32 per item
  const int wbegin = tile * TILE + warp * KPW;
  unsigned long long u[ITEMS];
  int id[ITEMS], d[ITEMS], pre[ITEMS];
#pragma unroll
  for (int s = 0; s < ITEMS; ++s) {
    const int i = wbegin + s * 32 + lane;
    const bool have = i < n;
    u[s] = have ? keys_in[i] : 0ULL;
    id[s] = have ? (idx_in != nullptr ? idx_in[i] : i) : 0;
    d[s] = have ? (int)((u[s] >> shift) & (RADIX - 1)) : -1 - lane;  // unmatched
  }
  // the tile's digit counts first (shared-memory atomics), published as
  // aggregates before the ranking, so later tiles' look-backs can use them
#pragma unroll
  for (int s = 0; s < ITEMS; ++s)
    if (d[s] >= 0) atomicAdd(&run[d[s]], 1);
  __syncthreads();
  const int cnt = run[tid];
  unsigned* mine = status + (size_t)tile * RADIX + tid;
  st_status(mine, (tile == 0 ? PREFIX : AGG) | cnt);
  // the digits' starts (a scan of the totals) while the keys arrive
  int total;
  const int start = block_scan_excl(totals[tid], warp_sums, &total);
  // rank within the warp: pre[s] = this digit's keys before this one
  const unsigned lt = (1u << lane) - 1;
  unsigned short* my = woff + warp * RADIX;
#pragma unroll
  for (int s = 0; s < ITEMS; ++s) {
    const unsigned peers = __match_any_sync(FULL, d[s]);
    const int leader = __ffs(peers) - 1;
    int old = 0;
    if (d[s] >= 0 && lane == leader) {
      old = my[d[s]];
      my[d[s]] = (unsigned short)(old + __popc(peers));
    }
    pre[s] = __shfl_sync(FULL, old, leader) + __popc(peers & lt);
    __syncwarp();
  }
  __syncthreads();
  // this thread's digit: each warp's first rank in the tile
  for (int w = 0, acc = 0; w < NWARPS; ++w) {
    const int c = woff[w * RADIX + tid];
    woff[w * RADIX + tid] = (unsigned short)acc;
    acc += c;
  }
  // decoupled look-back: sum the earlier tiles' counts, 32 per round
  int excl = 0;
  for (int pos = tile - 1; pos >= 0;) {
    unsigned v[LOOKBACK];
#pragma unroll
    for (int k = 0; k < LOOKBACK; ++k)
      v[k] = pos - k >= 0 ? ld_status(status + (size_t)(pos - k) * RADIX + tid)
                          : PREFIX;  // (before tile 0: nothing)
    bool stop = false, done = false;
    int adv = 0;
#pragma unroll
    for (int k = 0; k < LOOKBACK; ++k) {
      if (stop) continue;
      if (v[k] == 0) {  // not published yet: read it again next round
        stop = true;
        continue;
      }
      excl += (int)(v[k] & COUNT);
      ++adv;
      if (v[k] & PREFIX) done = stop = true;
    }
    if (done) break;
    pos -= adv;
  }
  if (tile > 0) st_status(mine, PREFIX | (excl + cnt));
  run[tid] = start + excl;
  __syncthreads();
#pragma unroll
  for (int s = 0; s < ITEMS; ++s) {
    if (d[s] < 0) continue;
    const int p = run[d[s]] + my[d[s]] + pre[s];
    keys_out[p] = u[s];
    idx_out[p] = id[s];
  }
}

// The first flags of one thread's ITEMS consecutive sorted keys, the
// tiles' voxel starts by look-back, and the scatters.  Every load (keys,
// point indices, and the fields of the points that start a voxel) is
// issued before the scan and the look-back.  cstatus: [tiles] look-back
// words, zero on entry; bad: vox_keys' contract flag.
__global__ void __launch_bounds__(THREADS)
vox_compact(const unsigned long long* __restrict__ keys, const int* __restrict__ idx,
            const int* __restrict__ disc, const int* __restrict__ batch,
            unsigned* __restrict__ cstatus, int* counter, const int* __restrict__ bad, int n,
            int cap, long long c_inv,
            int* __restrict__ coords, uint8_t* __restrict__ mask, int* __restrict__ rep,
            int* __restrict__ inverse, int* __restrict__ num_out, int* __restrict__ overflow_out,
            int* __restrict__ breach_out) {
  __shared__ int warp_sums[32];
  __shared__ int s_tile, s_base;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = take_tile(counter, &s_tile);
  const int tiles = (n + TILE - 1) / TILE;
  const int base = tile * TILE + tid * ITEMS;
  unsigned long long u[ITEMS];
  int id[ITEMS];
  const unsigned long long first_prev = base > 0 && base - 1 < n ? keys[base - 1] : 0ULL;
#pragma unroll
  for (int s = 0; s < ITEMS; ++s) {
    const int i = base + s;
    u[s] = i < n ? keys[i] : 0ULL;
    id[s] = i < n ? idx[i] : 0;
  }
  bool f[ITEMS], valid[ITEMS];
  int count = 0;
#pragma unroll
  for (int s = 0; s < ITEMS; ++s) {
    const int i = base + s;
    const unsigned long long prev = s == 0 ? first_prev : u[s - 1];
    valid[s] = i < n && key_valid(u[s], c_inv);
    f[s] = valid[s] && (i == 0 || prev != u[s]);
    count += f[s];
  }
  int4 row[ITEMS];
#pragma unroll
  for (int s = 0; s < ITEMS; ++s)
    row[s] = f[s] ? make_int4(batch[id[s]], disc[3 * (size_t)id[s]],
                              disc[3 * (size_t)id[s] + 1], disc[3 * (size_t)id[s] + 2])
                  : make_int4(0, 0, 0, 0);
  int tile_count;
  const int excl = block_scan_excl(count, warp_sums, &tile_count);
  if (warp == 0) {  // look-back over the earlier tiles' counts, 32 at a time
    int before = 0;
    if (lane == 0) st_status(cstatus + tile, (tile == 0 ? PREFIX : AGG) | tile_count);
    for (int p = tile - 1; p >= 0;) {
      const int q = p - lane;
      const unsigned w = q >= 0 ? ld_status(cstatus + q) : PREFIX;
      const unsigned pm = __ballot_sync(FULL, (w & PREFIX) != 0);
      const unsigned zm = __ballot_sync(FULL, w == 0);
      const int first_p = pm ? __ffs(pm) - 1 : 32, first_z = zm ? __ffs(zm) - 1 : 32;
      const int upto = min(first_p + 1, first_z);  // lanes summed this round
      int add = lane < upto ? (int)(w & COUNT) : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) add += __shfl_xor_sync(FULL, add, o);
      before += add;
      if (first_p < first_z) break;
      p -= upto;
    }
    if (lane == 0) {
      if (tile > 0) st_status(cstatus + tile, PREFIX | (before + tile_count));
      s_base = before;
      if (tile == tiles - 1) {
        const int num = before + tile_count;
        *num_out = num;
        *overflow_out = max(num - cap, 0);
        *breach_out = *bad;
      }
    }
  }
  __syncthreads();
  int running = s_base + excl;
#pragma unroll
  for (int s = 0; s < ITEMS; ++s) {
    if (base + s >= n) break;
    running += f[s];
    const int uniq = running - 1;  // the plain cumsum - 1
    const bool in_cap = uniq < cap;
    inverse[id[s]] = valid[s] && in_cap ? uniq : -1;
    if (f[s] && in_cap) {
      reinterpret_cast<int4*>(coords)[uniq] = row[s];
      rep[uniq] = id[s];
      mask[uniq] = 1;
    }
  }
}

}  // namespace

// keys: [2, n] u64 and idx: [2, n] int32 ping-pong buffers; work: int32
// [work_ints], any contents (zeroed here).  npass and c_inv: the caller's
// pass plan (core/voxelize.py voxelize_passes; c_inv = B << 39 below 2^(9
// * npass)); work_ints must cover the work area of (n, npass).  Returns a
// cudaError_t (0 = launched).
extern "C" int voxelize(const void* disc, const void* valid, const void* batch, void* keys,
                        void* idx, void* work, void* coords, void* mask, void* rep,
                        void* inverse, void* num_voxels, void* overflow, void* batch_breach,
                        int n, int cap,
                        int npass, long long c_inv, int work_ints, void* stream) {
  const int tiles = (n + TILE - 1) / TILE;
  // work: totals [npass][RADIX], counters [npass + 1], the contract flag,
  // pass status [npass][tiles][RADIX], compact status [tiles]
  const size_t need =
      (size_t)npass * RADIX + npass + 2 + (size_t)npass * tiles * RADIX + tiles;
  if (n <= 0 || cap <= 0 || npass < 1 || npass > MAX_PASS || c_inv <= 0 ||
      (c_inv & ((1LL << 39) - 1)) != 0 || (c_inv >> (RADIX_BITS * npass)) != 0 ||
      work_ints < 0 || (size_t)work_ints < need)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int* tot = static_cast<int*>(work);
  int* counters = tot + npass * RADIX;
  int* bad = counters + npass + 1;
  unsigned* status = reinterpret_cast<unsigned*>(bad + 1);
  unsigned* cstatus = status + (size_t)npass * tiles * RADIX;
  int err = (int)cudaMemsetAsync(work, 0, need * 4, st);
  if (err != 0) return err;
  unsigned long long* k = static_cast<unsigned long long*>(keys);
  int* ix = static_cast<int*>(idx);
  const int hist_smem = npass * RADIX * 4;
  static bool configured = false;  // the kernels' attributes, once per process
  if (!configured) {
    err = (int)cudaFuncSetAttribute(vox_keys, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    MAX_PASS * RADIX * 4);
    if (err != 0) return err;
    err = (int)cudaFuncSetAttribute(vox_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    PASS_SMEM);
    if (err != 0) return err;
    // one L1 / shared memory split for the key kernel and the passes, so
    // the SMs do not reconfigure between those launches (about 4 us each)
    for (const void* fn : {(const void*)vox_keys, (const void*)vox_pass}) {
      err = (int)cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                      (int)cudaSharedmemCarveoutMaxShared);
      if (err != 0) return err;
    }
    configured = true;
  }
  vox_keys<<<tiles, THREADS, hist_smem, st>>>(
      static_cast<const int*>(disc), static_cast<const uint8_t*>(valid),
      static_cast<const int*>(batch), k, tot, static_cast<int*>(coords),
      static_cast<uint8_t*>(mask), static_cast<int*>(rep), bad, n, cap, c_inv, npass);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  for (int p = 0; p < npass; ++p) {
    const int src = p % 2, dst = 1 - src;
    vox_pass<<<tiles, THREADS, PASS_SMEM, st>>>(
        k + (size_t)src * n, p == 0 ? nullptr : ix + (size_t)src * n, k + (size_t)dst * n,
        ix + (size_t)dst * n, tot + p * RADIX, status + (size_t)p * tiles * RADIX, counters + p,
        n, RADIX_BITS * p);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int out = npass % 2;  // the buffer the last pass wrote
  vox_compact<<<tiles, THREADS, 0, st>>>(
      k + (size_t)out * n, ix + (size_t)out * n, static_cast<const int*>(disc),
      static_cast<const int*>(batch), cstatus, counters + npass, bad, n, cap, c_inv,
      static_cast<int*>(coords), static_cast<uint8_t*>(mask), static_cast<int*>(rep),
      static_cast<int*>(inverse), static_cast<int*>(num_voxels), static_cast<int*>(overflow),
      static_cast<int*>(batch_breach));
  return (int)cudaGetLastError();
}

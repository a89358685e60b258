// KO and KP: the K-offset gather-GEMM of the in_channels > 1 stem
// (zconv_full) and its weight gradient.
//
// Replaces lidog_tpu/ops/zconv.py:342-404 (_zfull_core, _zfull_bwd):
//
//   KO  out[i] = m[i] * sum_{o < K} x[nbr[o, i]] @ W[o]        [N, Cout]
//       (a -1 entry, an entry >= n_in, or a source row s with
//       src_mask[s] == 0, is a zero row).  zconv_full's dx is KO too: the
//       cotangent through the same symmetric map with W[::-1] transposed
//       to [K, Cout, Cin] and the forward's output mask as src_mask.
//   KP  dW[o] = sum_i x[i]^T dout[nbr[K-1-o, i]]                 [K, Cin, Cout]
//       (dout read through the forward's output mask).  This is
//       lidog_tpu's own form: it gathers dout through the reversed offset
//       (the transpose of offset o on a symmetric map) and reads x rows in
//       order, so it needs no symmetry of the map to match the reference.
//
// Both sum in f32 and round once to the input type, as JAX does
// (preferred_element_type=f32, then astype).  Any Cin and Cout in [1, 64]
// are taken (the stem: Cin = in_channels, 4 in the smoke run, or 1 on the
// generic plan, Cout = 32; dx: 32 -> 4).
//
// Bound on an H100: bytes.  The int32 map [K, N] is read once: at the
// training plan's level 0 (491,520 rows, K = 125) it is 245.8 MB against
// ~35 MB of features, 0.084 ms at 3.35 TB/s.  8.2 million of its 61.4
// million entries hit (26 a real row; the dz = 0 offsets are the dense
// ones), so besides the map's stream the work is 8.2 million row gathers
// (x is 3.9 MB in bf16 and stays in L2) and Cin x Cout multiply-adds a
// hit, far below the card's rate.  The first version (a thread a row over
// all 125 offsets, one dependent map load then one gather each, W staged
// again by each of 3,840 blocks) ran at 8-13% of the bound.  On the card
// what bounds these kernels is how many gathers are in flight and the
// instructions spent a hit, not the multiply-adds: on an H100 80GB HBM3
// at 700 W the map alone streams at ~2.7 TB/s (lane = row, coalesced,
// evict-first `__ldcs`), and a form that handles one hit at a time per
// warp costs 60-90 ps a hit.
//
// KO has three forms; ops/sparse_conv.py full_fwd_route states which
// takes a call.  All stage W once per persistent block in dynamic shared
// memory and load the map tile of a warp's 32 output rows as lane = row,
// the next group of offsets in flight while the current one is used:
//   - "mma", bf16 at Cin in (1, 2, 4, 8, 16), Cout in [17, 64]: every
//     (row, offset) pair of the tile goes through m16n8k16 products, the
//     gathers written straight into the A fragments (a miss reads 0), 32
//     per lane in flight (full_fwd_mma_kernel).  The stems' forwards.
//   - "rows", f32 at Cin in (1, 2, 4), Cout <= 32: a lane owns 4 rows x 8
//     columns of f32 sums and walks every offset in order, skipping those
//     no row of the tile hits (full_fwd_rows_kernel).
//   - "cores", every other shape (KO as dx, 32 -> 4, among them): hit
//     lists on the CUDA cores (full_fwd_kernel, below).
//
// The lane tiling of the hit lists (ops/sparse_conv.py full_tiles states
// it): lane = (q, c) with CT = the power of two >= Cout (at most 32)
// output columns c and Q = 32 / CT slices q of the input channels, AS =
// ceil(Cin / Q) channels a slice, taken AB at a time (AB = 1, 4 or 16;
// `passes` = ceil(AS / AB)); a lane owns columns c and, above 32 columns,
// c + 32 (NC = 2).
//
// KO "cores".  W staged as f32 in the lanes' order (each lane's AB weights
// of an offset in 16-byte words), as many warps (8 to 24) as fit beside
// it; where W does not fit (Cin x Cout near 64 x 64) the lanes read it
// from L2.  Each warp walks tiles of 32 output rows:
//   1. The map entries of the tile, KO_GROUP offsets at a time (src_mask,
//      where given, is applied here).
//   2. The hits are compacted into the warp's list in shared memory, in
//      (row, offset) order (a warp scan of the rows' counts).
//   3. The list is consumed U hits at a time: the U x-row gathers of a
//      batch are issued before any multiply-add (vector loads where every
//      lane's slice is aligned, a template path without branches); each
//      lane multiplies its AB channels by its W words into the row's f32
//      sum in registers, added into its slot of the tile's sums in shared
//      memory at the row's end.
//   4. The Q slots of each column meet by a fixed pairwise tree, and the
//      tile (32 x Cout values, one contiguous run of the output) is written
//      through the output mask in 16-byte stores.
// Every row's sum runs in a fixed order (offset group, pass, offset, then
// the slices' tree), whatever warp takes the tile.
//
// KP design: no shared-memory read per multiply-add.  A block is (offset
// o, chunk of rows), 16 warps, each over its own run of the chunk's rows.
// The hardware hands the 60 x 125 blocks (at L0) to SMs as they free up,
// so a block of a dense offset holds its SM longer and the SMs stay
// balanced by hits, not by rows; the offsets nearest the centre index
// (the centre and its dz neighbours, among the densest) are issued first,
// so the last blocks are light ones.  A warp loads the map entries of 8
// steps of 32 rows at once (lane = row), drops the entries onto masked
// dout rows, compacts the hits into its list by ballots (a hit's x row of
// 4, 8 or 16 bytes copied by cp.async into a slot beside its entry), then
// walks the list U hits at a time, all gathers of a batch in flight
// first: lane (q, c) reads dout[s][c] (one coalesced row a hit), x[i][its
// AB channels] (a broadcast read of the slot, or of global memory for
// other widths) and keeps dW[o][its channels][c] in registers, AB x NC
// multiply-adds a hit straight from registers.  The block adds its
// warps' tiles in warp order and writes one f32 partial [chunk, o]; a
// second launch sums the partials over the chunks in order and rounds (2
// launches a call, as before).  Bitwise repeatable: every sum has a fixed
// order.  Tried on the card and dropped (PERF.md §6): KP on the tensor
// cores (dW^T = G^T X, 16 hits a k-step, the fragments gathered from
// global memory: slower, the 2-byte gathers of the A fragments cost more
// than the multiply-adds they replace) and all
// of a warp's x rows staged, hit or not (slower where offsets are sparse,
// which most are).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "zconv3_mma.cuh"

namespace {

constexpr int MAXW = 64;                 // widest Cin / Cout taken
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_LIMIT = 227 * 1024;   // dynamic shared memory a block may use
constexpr int KO_MAX_WARPS = 24;         // KO: warps a block, at most
constexpr int KO_MIN_WARPS = 8;          // ... at least (else W stays in L2)
constexpr int KO_ROWS = 32;              // output rows a warp tile (lane = row)
constexpr int KO_GROUP = 16;             // offsets whose map entries load at once
constexpr int KO_CAP = 32 * KO_GROUP;    // hits a warp's list
constexpr int KM_WARPS = 4;              // KO's tensor-core form: warps a block
constexpr int KM_GROUP = 16;             // offsets whose map entries load at once
constexpr int KM_BATCH = 4;              // k-steps whose gathers are in flight at once
constexpr int KR_WARPS = 16;             // KO's f32 row form: warps a block
constexpr int KR_GROUP = 16;             // offsets whose map entries load at once
constexpr int KR_BATCH = 2;              // offsets whose gathers are in flight at once
constexpr int KP_WARPS = 16;             // KP: warps a block
constexpr int KP_THREADS = 32 * KP_WARPS;
constexpr int KP_STEPS = 8;              // 32-row steps whose map entries load at once
constexpr int KP_CAP = 32 * KP_STEPS;    // hits a warp's list

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N values of T as raw 32-bit words (bf16: two a word, low half first)
template <typename T, int N>
struct Pack {
  static constexpr int BYTES = N * (int)sizeof(T);
  static constexpr int WORDS = (BYTES + 3) / 4;
  uint32_t w[WORDS];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < WORDS; ++j) w[j] = 0u;
  }
  __device__ __forceinline__ float get(int j) const {  // j known after unrolling
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[j]);
    } else {
      const uint32_t v = w[j >> 1];
      return __uint_as_float((j & 1) ? (v & 0xffff0000u) : (v << 16));
    }
  }
  // src[0, valid) (the rest zero; valid may be <= 0).  VEC: valid == N and
  // src is aligned to min(16, BYTES): one vector load per 16 bytes.
  template <bool VEC>
  __device__ __forceinline__ void load(const T* src, int valid) {
    if constexpr (VEC) {
      if constexpr (BYTES >= 16) {
#pragma unroll
        for (int j = 0; j < BYTES / 16; ++j) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + j);
          w[4 * j] = v.x, w[4 * j + 1] = v.y, w[4 * j + 2] = v.z, w[4 * j + 3] = v.w;
        }
      } else if constexpr (BYTES == 8) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
        w[0] = v.x, w[1] = v.y;
      } else if constexpr (BYTES == 4) {
        w[0] = __ldg(reinterpret_cast<const unsigned int*>(src));
      } else {
        w[0] = __ldg(reinterpret_cast<const unsigned short*>(src));
      }
    } else {
      zero();
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j < valid) {
          if constexpr (sizeof(T) == 4)
            w[j] = __ldg(reinterpret_cast<const unsigned int*>(src) + j);
          else
            w[j >> 1] |= (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(src) + j)
                         << (16 * (j & 1));
        }
      }
    }
  }
};

// N values of T from shared memory, as Pack::load reads global memory.
template <typename T, int N, bool VEC>
__device__ __forceinline__ void load_shared(Pack<T, N>& p, const T* src, int valid) {
  constexpr int BYTES = Pack<T, N>::BYTES;
  if constexpr (VEC) {
    if constexpr (BYTES >= 16) {
#pragma unroll
      for (int j = 0; j < BYTES / 16; ++j) {
        const uint4 v = reinterpret_cast<const uint4*>(src)[j];
        p.w[4 * j] = v.x, p.w[4 * j + 1] = v.y, p.w[4 * j + 2] = v.z, p.w[4 * j + 3] = v.w;
      }
    } else if constexpr (BYTES == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(src);
      p.w[0] = v.x, p.w[1] = v.y;
    } else if constexpr (BYTES == 4) {
      p.w[0] = *reinterpret_cast<const unsigned int*>(src);
    } else {
      p.w[0] = *reinterpret_cast<const unsigned short*>(src);
    }
  } else {
    p.zero();
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < valid) {
        if constexpr (sizeof(T) == 4)
          p.w[j] = reinterpret_cast<const unsigned int*>(src)[j];
        else
          p.w[j >> 1] |= (uint32_t)reinterpret_cast<const unsigned short*>(src)[j]
                         << (16 * (j & 1));
      }
    }
  }
}

// `bytes` (4, 8 or 16) global -> shared, asynchronously (cp.async)
__device__ __forceinline__ void cp_row(void* dst, const void* src, int bytes) {
  const unsigned d = z3::smem_u32(dst);
  if (bytes == 16)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// hits whose gathers a lane keeps in flight at once (larger batches, 8 or
// 16, and two batches in flight, were slower on the card)
template <typename T, int AB>
struct Batch {
  static constexpr int U = Pack<T, AB>::WORDS <= 2 ? 4 : 2;
};

// The channels [a0, a0 + valid) of a lane's pass: may it load them with
// vector loads (every row start and a0 aligned to the pack's 16 bytes or
// less)?  The kernels take the vector path where every lane may.
template <typename T, int AB>
__device__ __forceinline__ bool vec_ok(int cin, int a0, int valid) {
  constexpr int VB = Pack<T, AB>::BYTES < 16 ? Pack<T, AB>::BYTES : 16;
  return valid == AB && (cin * (int)sizeof(T)) % VB == 0 && (a0 * (int)sizeof(T)) % VB == 0;
}

// ---------------------------------------------------------------- KO

// One pass (channels [i0, i0 + AB) of every lane's slice, a0 the first of
// this lane's) over a warp's list of n hits {source row, (offset << 5) |
// tile row}: each hit's products, summed from 0 in channel order, are
// added into the row's f32 sum of this lane's slot.
// Add a row's f32 sums of this lane's slot into the tile.
template <int NC>
__device__ __forceinline__ void ko_flush(float (&acc)[NC], float* orow) {
#pragma unroll
  for (int m = 0; m < NC; ++m) {
    orow[32 * m] += acc[m];
    acc[m] = 0.0f;
  }
}

// A batch of U hits from the list at b: their entries and x gathers.
template <typename T, int AB, bool VEC>
__device__ __forceinline__ void ko_fetch(int2 (&ent)[Batch<T, AB>::U], Pack<T, AB> (&xv)[Batch<T, AB>::U],
                                         const T* __restrict__ x, const int2* list, int n, int b,
                                         int cin, int a0, int valid) {
#pragma unroll
  for (int u = 0; u < Batch<T, AB>::U; ++u) ent[u] = list[min(b + u, n - 1)];
#pragma unroll
  for (int u = 0; u < Batch<T, AB>::U; ++u)
    xv[u].template load<VEC>(x + (size_t)ent[u].x * cin + a0, valid);
}

// The products of a fetched batch: each hit's AB channels times the
// lane's W words into the row's f32 sum in registers, added into the
// lane's slot of the tile at a row change.
template <typename T, int AB, int NC, bool STAGED>
__device__ __forceinline__ void ko_use(const int2 (&ent)[Batch<T, AB>::U],
                                       const Pack<T, AB> (&xv)[Batch<T, AB>::U],
                                       const T* __restrict__ w, const float* ws, int n, int b,
                                       float* os, int lane, int c, int cin, int cout, int a0,
                                       int valid, int i0, int groups, float (&acc)[NC],
                                       int& cur) {
  constexpr int V = AB < 4 ? AB : 4;
#pragma unroll
  for (int u = 0; u < Batch<T, AB>::U; ++u) {
    if (b + u >= n) break;
    const int o = ent[u].y >> 5, r = ent[u].y & 31;
    if (r != cur) {
      if (cur >= 0) ko_flush<NC>(acc, os + cur * 32 * NC + lane);
      cur = r;
    }
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      if constexpr (STAGED) {
        const float* wp = ws + ((size_t)(o * NC + m) * groups + i0 / V) * 32 * V + lane * V;
#pragma unroll
        for (int gq = 0; gq < AB / V; ++gq) {
          if constexpr (V == 4) {
            const float4 wv = *reinterpret_cast<const float4*>(wp + gq * 32 * 4);
            acc[m] = fmaf(xv[u].get(4 * gq), wv.x, acc[m]);
            acc[m] = fmaf(xv[u].get(4 * gq + 1), wv.y, acc[m]);
            acc[m] = fmaf(xv[u].get(4 * gq + 2), wv.z, acc[m]);
            acc[m] = fmaf(xv[u].get(4 * gq + 3), wv.w, acc[m]);
          } else {
            acc[m] = fmaf(xv[u].get(gq), wp[gq * 32], acc[m]);
          }
        }
      } else {  // W from global memory (L2)
        const int col = c + 32 * m;
        if (col < cout) {
          const T* wp = w + ((size_t)o * cin + a0) * cout + col;
#pragma unroll
          for (int j = 0; j < AB; ++j)
            if (j < valid) acc[m] = fmaf(xv[u].get(j), to_f32(__ldg(wp + (size_t)j * cout)), acc[m]);
        }
      }
    }
  }
}

// One pass (channels [i0, i0 + AB) of every lane's slice, a0 the first of
// this lane's) over a warp's list of n hits {source row, (offset << 5) |
// tile row} in (row, offset) order, U hits at a time.
template <typename T, int AB, int NC, bool VEC, bool STAGED>
__device__ __forceinline__ void ko_pass(const T* __restrict__ x, const T* __restrict__ w,
                                        const float* ws, const int2* list, int n, float* os,
                                        int lane, int c, int cin, int cout, int a0, int valid,
                                        int i0, int groups) {
  constexpr int U = Batch<T, AB>::U;
  float acc[NC];
#pragma unroll
  for (int m = 0; m < NC; ++m) acc[m] = 0.0f;
  int cur = -1;
  int2 ent[U];
  Pack<T, AB> xv[U];
  for (int b = 0; b < n; b += U) {
    ko_fetch<T, AB, VEC>(ent, xv, x, list, n, b, cin, a0, valid);
    ko_use<T, AB, NC, STAGED>(ent, xv, w, ws, n, b, os, lane, c, cin, cout, a0, valid, i0,
                              groups, acc, cur);
  }
  if (cur >= 0) ko_flush<NC>(acc, os + cur * 32 * NC + lane);
}

template <typename T, int AB, int NC>
__global__ void __launch_bounds__(32 * KO_MAX_WARPS, 1)
full_fwd_kernel(const T* __restrict__ x, const int* __restrict__ nbr, const T* __restrict__ w,
                const uint8_t* __restrict__ out_mask, const uint8_t* __restrict__ src_mask,
                T* __restrict__ out, int n_in, int n_out, int k, int cin, int cout, int ct,
                int aslice, int passes, int staged) {
  constexpr int V = AB < 4 ? AB : 4;
  constexpr int OSW = 32 * NC;  // a tile row's slots: lane (q, c) owns slot lane (+ 32)
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int groups = passes * AB / V;
  const size_t wfloats = staged ? (size_t)k * NC * groups * 32 * V : 0;
  const float* ws = reinterpret_cast<const float*>(smem);
  int2* list = reinterpret_cast<int2*>(smem + wfloats * 4) + warp * KO_CAP;
  float* os = reinterpret_cast<float*>(smem + wfloats * 4 + (size_t)warps * KO_CAP * 8) +
              warp * KO_ROWS * OSW;

  if (staged) {  // W once: ws[o][m][g][lane][V] = W[o][q * aslice + g * V + v][c + 32 m]
    float* wst = reinterpret_cast<float*>(smem);
    for (size_t v = threadIdx.x; v < wfloats; v += blockDim.x) {
      const int e = (int)(v % V);
      size_t rest = v / V;
      const int ln = (int)(rest % 32);
      rest /= 32;
      const int g = (int)(rest % groups);
      rest /= groups;
      const int m = (int)(rest % NC), o = (int)(rest / NC);
      const int lq = ln / ct, i = g * V + e;
      const int a = lq * aslice + i, col = ln - lq * ct + 32 * m;
      wst[v] = i < aslice && a < cin && col < cout
                   ? to_f32(w[((size_t)o * cin + a) * cout + col])
                   : 0.0f;
    }
    __syncthreads();
  }

  const int q = lane / ct, c = lane - q * ct;
  const int tiles = (n_out + KO_ROWS - 1) / KO_ROWS;
  for (int t = blockIdx.x * warps + warp; t < tiles; t += gridDim.x * warps) {
    const int row0 = t * KO_ROWS, row = row0 + lane;
    __syncwarp();  // the previous tile is written out
    for (int v = lane; v < KO_ROWS * OSW / 4; v += 32)
      reinterpret_cast<float4*>(os)[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int og = 0; og < k; og += KO_GROUP) {
      // the map entries of the tile's 32 rows at KO_GROUP offsets: one
      // coalesced 128-byte load an offset, all in flight at once
      int e[KO_GROUP];
      bool hit[KO_GROUP];
#pragma unroll
      for (int m = 0; m < KO_GROUP; ++m)
        e[m] = og + m < k && row < n_out ? __ldcs(nbr + (size_t)(og + m) * n_out + row) : -1;
#pragma unroll
      for (int m = 0; m < KO_GROUP; ++m) hit[m] = e[m] >= 0 && e[m] < n_in;
      if (src_mask != nullptr) {
#pragma unroll
        for (int m = 0; m < KO_GROUP; ++m)
          hit[m] = hit[m] && __ldg(src_mask + e[m]) != 0;
      }
      // hits in (row, offset) order: a warp scan of the rows' counts
      unsigned hb = 0;
#pragma unroll
      for (int m = 0; m < KO_GROUP; ++m) hb |= (unsigned)hit[m] << m;
      const int cnt = __popc(hb);
      int pos = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, pos, d);
        if (lane >= d) pos += y;
      }
      const int n = __shfl_sync(FULL, pos, 31);
      pos -= cnt;
      __syncwarp();  // the previous group's passes have read the list
#pragma unroll
      for (int m = 0; m < KO_GROUP; ++m)
        if (hb >> m & 1u) list[pos++] = make_int2(e[m], ((og + m) << 5) | lane);
      __syncwarp();
      for (int p = 0; p < passes; ++p) {
        const int i0 = p * AB, a0 = q * aslice + i0;
        const int valid = min(AB, min(aslice - i0, cin - a0));
        const bool vec = __all_sync(FULL, vec_ok<T, AB>(cin, a0, valid));
        if (staged) {
          if (vec)
            ko_pass<T, AB, NC, true, true>(x, w, ws, list, n, os, lane, c, cin, cout, a0, valid,
                                           i0, groups);
          else
            ko_pass<T, AB, NC, false, true>(x, w, ws, list, n, os, lane, c, cin, cout, a0,
                                            valid, i0, groups);
        } else {
          if (vec)
            ko_pass<T, AB, NC, true, false>(x, w, ws, list, n, os, lane, c, cin, cout, a0,
                                            valid, i0, groups);
          else
            ko_pass<T, AB, NC, false, false>(x, w, ws, list, n, os, lane, c, cin, cout, a0,
                                             valid, i0, groups);
        }
      }
    }
    // the slices' sums of each (row, column) meet by a fixed tree (q, q + h)
    for (int h = 1; h * ct < 32; h *= 2) {
      __syncwarp();
      for (int v = lane; v < KO_ROWS * (32 / (2 * h)); v += 32) {
        const int r = v / (32 / (2 * h)), j = v - r * (32 / (2 * h));
        const int qq = (j / ct) * 2 * h, cc = j - (j / ct) * ct;
        os[r * OSW + qq * ct + cc] += os[r * OSW + (qq + h) * ct + cc];
      }
    }
    __syncwarp();  // every row's sums are in the tile
    // the tile: 32 x Cout values from out + row0 * Cout, 16 bytes a store
    constexpr int VE = 16 / (int)sizeof(T);
    const int total = min(KO_ROWS, n_out - row0) * cout;
    T* dst = out + (size_t)row0 * cout;
    const int nvec = total / VE;
    for (int v = lane; v < nvec; v += 32) {
      uint32_t wd[4];
#pragma unroll
      for (int j = 0; j < VE; j += 2) {
        float f[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int el = v * VE + j + hh, r = el / cout, col = el - r * cout;
          f[hh] = out_mask == nullptr || out_mask[row0 + r] ? os[r * OSW + col] : 0.0f;
        }
        if constexpr (sizeof(T) == 4) {
          wd[j] = __float_as_uint(f[0]);
          wd[j + 1] = __float_as_uint(f[1]);
        } else {
          const __nv_bfloat162 b2 = __floats2bfloat162_rn(f[0], f[1]);
          wd[j >> 1] = *reinterpret_cast<const uint32_t*>(&b2);
        }
      }
      reinterpret_cast<uint4*>(dst)[v] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
    for (int el = nvec * VE + lane; el < total; el += 32) {
      const int r = el / cout, col = el - r * cout;
      dst[el] = from_f32<T>(out_mask == nullptr || out_mask[row0 + r] ? os[r * OSW + col] : 0.0f);
    }
  }
}

// ------------------------------------------------- KO on the tensor cores

// bf16 at Cin = CP in (1, 2, 4, 8, 16): out[32 rows] = A [32, K * CP] x
// Wf [K * CP, Cout] as m16n8k16 products, the K dimension (offset,
// channel) cut into k-steps of 16 / CP offsets; A is gathered straight
// into the fragments (a miss reads 0), W sits in shared memory in
// fragment order (one 8-byte read a lane, n8 tile and k-step).  All
// (row, offset) pairs are multiplied, hit or not: at the stem's ~13%
// density that is ~5x fewer instructions than a hit at a time.  The sums
// of a k-step are the tensor core's, in k-step order.
template <int CP>
struct Km {
  static constexpr int OPK = 16 / CP;                 // offsets a k-step
  static constexpr int STEPS = KM_GROUP / OPK;        // k-steps a map group
  static constexpr int BATCH = STEPS < KM_BATCH ? STEPS : KM_BATCH;
  static constexpr int PITCH = CP == 1 ? 36 : 40;     // stash words an offset (no bank conflicts)
};

template <int CP>
__device__ __forceinline__ uint32_t km_pair(const __nv_bfloat16* __restrict__ x, const int* st,
                                            int o0, int row, int ch, int cin) {
  // the A values (kk, kk + 1) of one row: CP >= 2: channels ch, ch + 1 of
  // offset o0; CP == 1: channel 0 of offsets o0 and o0 + 1
  if constexpr (CP == 1) {
    const int s0 = st[o0 * Km<CP>::PITCH + row], s1 = st[(o0 + 1) * Km<CP>::PITCH + row];
    const uint32_t lo = s0 >= 0 ? __ldg(reinterpret_cast<const unsigned short*>(x) + s0) : 0u;
    const uint32_t hi = s1 >= 0 ? __ldg(reinterpret_cast<const unsigned short*>(x) + s1) : 0u;
    return lo | hi << 16;
  } else {
    const int s0 = st[o0 * Km<CP>::PITCH + row];
    return s0 >= 0 ? __ldg(reinterpret_cast<const unsigned int*>(x + (size_t)s0 * cin + ch)) : 0u;
  }
}

template <int CP, int NT>
__global__ void __launch_bounds__(32 * KM_WARPS, 1)
full_fwd_mma_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ nbr,
                    const __nv_bfloat16* __restrict__ w, const uint8_t* __restrict__ out_mask,
                    const uint8_t* __restrict__ src_mask, __nv_bfloat16* __restrict__ out,
                    int n_in, int n_out, int k, int cout) {
  using K = Km<CP>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int groups = (k + KM_GROUP - 1) / KM_GROUP;
  const int ksteps = groups * K::STEPS;
  uint2* wf = reinterpret_cast<uint2*>(smem);  // [k-step][n8 tile][lane]
  int* st = reinterpret_cast<int*>(smem + (size_t)ksteps * NT * 32 * 8) +
            warp * KM_GROUP * K::PITCH;

  // W once, in fragment order: b0 = (kk 2t, 2t + 1; col 8j + g), b1 = kk + 8
  for (int v = threadIdx.x; v < ksteps * NT * 32; v += blockDim.x) {
    const int ln = v & 31, j = (v >> 5) % NT, p = (v >> 5) / NT;
    const int col = 8 * j + (ln >> 2);
    uint32_t b[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t pair = 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kk = 2 * (ln & 3) + 8 * h + e;
        const int o = p * K::OPK + kk / CP, a = kk % CP;
        const __nv_bfloat16 v16 =
            o < k && col < cout ? w[((size_t)o * CP + a) * cout + col] : __float2bfloat16(0.0f);
        pair |= (uint32_t)(*reinterpret_cast<const unsigned short*>(&v16)) << (16 * e);
      }
      b[h] = pair;
    }
    wf[v] = make_uint2(b[0], b[1]);
  }
  __syncthreads();

  const int tiles = (n_out + 31) / 32;
  for (int tile = blockIdx.x * KM_WARPS + warp; tile < tiles; tile += gridDim.x * KM_WARPS) {
    const int row0 = tile * 32, row = row0 + lane;
    float acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;
    int e[KM_GROUP];
#pragma unroll
    for (int m = 0; m < KM_GROUP; ++m)  // the first group's entries
      e[m] = m < k && row < n_out ? __ldcs(nbr + (size_t)m * n_out + row) : -1;
    for (int gi = 0; gi < groups; ++gi) {
      __syncwarp();  // the previous group's stash is read
#pragma unroll
      for (int m = 0; m < KM_GROUP; ++m) {
        int s = e[m] >= 0 && e[m] < n_in ? e[m] : -1;
        if (src_mask != nullptr && s >= 0 && !__ldg(src_mask + s)) s = -1;
        st[m * K::PITCH + lane] = s;
      }
      __syncwarp();
      const int og = (gi + 1) * KM_GROUP;  // the next group's entries, in flight meanwhile
#pragma unroll
      for (int m = 0; m < KM_GROUP; ++m)
        e[m] = og + m < k && row < n_out ? __ldcs(nbr + (size_t)(og + m) * n_out + row) : -1;
      for (int b0 = 0; b0 < K::STEPS; b0 += K::BATCH) {
        uint32_t a[K::BATCH][2][4];
#pragma unroll
        for (int bs = 0; bs < K::BATCH; ++bs)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) {  // a0: (g, kk 2t), a1: (g + 8, 2t), a2: (g, 2t + 8), a3
              const int kk = 2 * t + 8 * (q >> 1), r = 16 * i + g + 8 * (q & 1);
              a[bs][i][q] = km_pair<CP>(x, st, (b0 + bs) * K::OPK + kk / CP, r, kk % CP, CP);
            }
#pragma unroll
        for (int bs = 0; bs < K::BATCH; ++bs) {
          const uint2* wp = wf + ((size_t)(gi * K::STEPS + b0 + bs) * NT) * 32 + lane;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint2 bb = wp[j * 32];
            z3::mma_bf16(acc[0][j], a[bs][0], bb.x, bb.y);
            z3::mma_bf16(acc[1][j], a[bs][1], bb.x, bb.y);
          }
        }
      }
    }
    // c0, c1: (row 16 i + g, cols 8 j + 2 t, + 1); c2, c3: row + 8
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row0 + 16 * i + g + 8 * hh;
        if (r >= n_out) continue;
        const bool keep = out_mask == nullptr || out_mask[r] != 0;
        __nv_bfloat16* orow = out + (size_t)r * cout;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = 8 * j + 2 * t;
          const float v0 = keep ? acc[i][j][2 * hh] : 0.0f, v1 = keep ? acc[i][j][2 * hh + 1] : 0.0f;
          if ((cout & 1) == 0 && col + 1 < cout) {
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (col < cout) orow[col] = __float2bfloat16_rn(v0);
            if (col + 1 < cout) orow[col + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
  }
}

// ------------------------------------------------- KO, f32 rows

// f32 at Cin = C in (1, 2, 4) and Cout <= 32: a warp owns 32 output rows,
// a lane 4 rows x 8 columns of their f32 sums in registers, and walks every
// offset in order; the tile's map entries are stashed in shared memory
// (loaded coalesced, lane = row), W[o] is read as 16-byte words that the
// 8 lanes of a column group share, and an offset that no row of the tile
// hits is skipped.  Every other (row, offset) pair is multiplied, a miss
// as zeros: at the stem's ~13% density that costs fewer issue slots than
// the hit lists' per-hit bookkeeping.  (A first form, a lane a row and
// all 32 columns, read W[o] as 32 broadcast words a channel: slower.)
template <int C>
__global__ void __launch_bounds__(32 * KR_WARPS, 1)
full_fwd_rows_kernel(const float* __restrict__ x, const int* __restrict__ nbr,
                     const float* __restrict__ w, const uint8_t* __restrict__ out_mask,
                     const uint8_t* __restrict__ src_mask, float* __restrict__ out, int n_in,
                     int n_out, int k, int cout) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);  // [K][C][32], 0 past Cout
  for (int v = threadIdx.x; v < k * C * 32; v += blockDim.x) {
    const int col = v & 31, a = (v >> 5) % C, o = (v >> 5) / C;
    ws[v] = col < cout ? w[((size_t)o * C + a) * cout + col] : 0.0f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = lane >> 2, cg = lane & 3;  // rows 4 rg .. 4 rg + 3, columns 8 cg .. 8 cg + 7
  int* st = reinterpret_cast<int*>(smem + (size_t)k * C * 32 * 4) + warp * KR_GROUP * 33;
  const int tiles = (n_out + 31) / 32;
  for (int tile = blockIdx.x * KR_WARPS + warp; tile < tiles; tile += gridDim.x * KR_WARPS) {
    const int row = tile * 32 + lane;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) acc[i][cc] = 0.0f;
    int e[KR_GROUP];
#pragma unroll
    for (int m = 0; m < KR_GROUP; ++m)
      e[m] = m < k && row < n_out ? __ldcs(nbr + (size_t)m * n_out + row) : -1;
    for (int og = 0; og < k; og += KR_GROUP) {
      __syncwarp();  // the previous group's stash is read
      unsigned any = 0;  // the offsets that some row of the tile hits
#pragma unroll
      for (int m = 0; m < KR_GROUP; ++m) {
        bool hit = e[m] >= 0 && e[m] < n_in;
        if (src_mask != nullptr) hit = hit && __ldg(src_mask + e[m]) != 0;
        st[m * 33 + lane] = hit ? e[m] : -1;
        any |= (unsigned)__any_sync(FULL, hit) << m;
      }
      __syncwarp();
      const int on = og + KR_GROUP;  // the next group's entries, in flight meanwhile
#pragma unroll
      for (int m = 0; m < KR_GROUP; ++m)
        e[m] = on + m < k && row < n_out ? __ldcs(nbr + (size_t)(on + m) * n_out + row) : -1;
#pragma unroll
      for (int b = 0; b < KR_GROUP; b += KR_BATCH) {
        float xv[KR_BATCH][4][C];
#pragma unroll
        for (int j = 0; j < KR_BATCH; ++j)  // the batch's gathers, then its products
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int s = st[(b + j) * 33 + 4 * rg + i];
            if constexpr (C == 4) {
              const float4 v = s >= 0 ? __ldg(reinterpret_cast<const float4*>(x) + s)
                                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              xv[j][i][0] = v.x, xv[j][i][1] = v.y, xv[j][i][2] = v.z, xv[j][i][3] = v.w;
            } else if constexpr (C == 2) {
              const float2 v = s >= 0 ? __ldg(reinterpret_cast<const float2*>(x) + s)
                                      : make_float2(0.0f, 0.0f);
              xv[j][i][0] = v.x, xv[j][i][1] = v.y;
            } else {
              xv[j][i][0] = s >= 0 ? __ldg(x + s) : 0.0f;
            }
          }
#pragma unroll
        for (int j = 0; j < KR_BATCH; ++j) {
          const int o = og + b + j;
          if (o >= k) break;
          if (!(any >> (b + j) & 1u)) continue;  // no row of the tile hits
          const float* wr = ws + (size_t)o * C * 32 + 8 * cg;
#pragma unroll
          for (int a = 0; a < C; ++a) {
            const float4 w0 = *reinterpret_cast<const float4*>(wr + a * 32);
            const float4 w1 = *reinterpret_cast<const float4*>(wr + a * 32 + 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float xa = xv[j][i][a];
              acc[i][0] = fmaf(xa, w0.x, acc[i][0]), acc[i][1] = fmaf(xa, w0.y, acc[i][1]);
              acc[i][2] = fmaf(xa, w0.z, acc[i][2]), acc[i][3] = fmaf(xa, w0.w, acc[i][3]);
              acc[i][4] = fmaf(xa, w1.x, acc[i][4]), acc[i][5] = fmaf(xa, w1.y, acc[i][5]);
              acc[i][6] = fmaf(xa, w1.z, acc[i][6]), acc[i][7] = fmaf(xa, w1.w, acc[i][7]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tile * 32 + 4 * rg + i;
      if (r >= n_out) continue;
      const bool keep = out_mask == nullptr || out_mask[r] != 0;
      float* orow = out + (size_t)r * cout;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c0 = 8 * cg + 4 * h;
        if ((cout & 3) == 0) {
          if (c0 < cout)
            *reinterpret_cast<float4*>(orow + c0) =
                keep ? make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                                   acc[i][4 * h + 3])
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            if (c0 + cc < cout) orow[c0 + cc] = keep ? acc[i][4 * h + cc] : 0.0f;
        }
      }
    }
  }
}

// ---------------------------------------------------------------- KP

// A warp's list of n hits {dout row, row - r0}: AB x NC multiply-adds a
// hit into the lane's dW tile, U hits' gathers in flight at once.
template <typename T, int AB, int NC, bool VEC, bool XL>
__device__ __forceinline__ void kp_batches(const T* __restrict__ x, const unsigned char* xl,
                                           const T* __restrict__ dout, const int2* list, int n,
                                           int r0, int c, int cin, int cout, int a0, int valid,
                                           float (&acc)[AB][NC]) {
  constexpr int U = Batch<T, AB>::U;
  for (int b = 0; b < n; b += U) {
    int2 ent[U];
    Pack<T, AB> xv[U];
    float dv[U][NC];
#pragma unroll
    for (int u = 0; u < U; ++u) ent[u] = list[min(b + u, n - 1)];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // every gather of the batch, then the products
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const int col = c + 32 * m;
        dv[u][m] = col < cout ? to_f32(__ldg(dout + (size_t)ent[u].x * cout + col)) : 0.0f;
      }
      if constexpr (XL)  // the hit's x row, copied beside its list entry
        load_shared<T, AB, VEC>(
            xv[u], reinterpret_cast<const T*>(xl + (size_t)min(b + u, n - 1) * 16) + a0, valid);
      else
        xv[u].template load<VEC>(x + (size_t)(r0 + ent[u].y) * cin + a0, valid);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (b + u >= n) break;
#pragma unroll
      for (int i = 0; i < AB; ++i) {
        const float xi = xv[u].get(i);
#pragma unroll
        for (int m = 0; m < NC; ++m) acc[i][m] = fmaf(xi, dv[u][m], acc[i][m]);
      }
    }
  }
}

template <typename T, int AB, int NC>
__global__ void __launch_bounds__(KP_THREADS, AB * NC > 8 ? 1 : 2)
full_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                  const int* __restrict__ nbr, const uint8_t* __restrict__ dout_mask,
                  float* __restrict__ partial, int na, int k, int cin, int cout, int chunks,
                  int rpc, int ct, int aslice) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // blocks in order of the offset's distance from the centre (its rank),
  // then by chunk: centre, centre - 1, centre + 1, centre - 2, ...
  const int rank = blockIdx.x / chunks, chunk = blockIdx.x - rank * chunks;
  const int o = (rank & 1) ? k / 2 - (rank + 1) / 2 : k / 2 + rank / 2;
  const int* map = nbr + (size_t)(k - 1 - o) * na;  // dW[o] reads offset K-1-o
  const int q = lane / ct, c = lane - q * ct;
  const int i0 = blockIdx.y * AB, a0 = q * aslice + i0;
  const int valid = min(AB, min(aslice - i0, cin - a0));
  const bool vec = __all_sync(FULL, vec_ok<T, AB>(cin, a0, valid));
  int2* list = reinterpret_cast<int2*>(smem) + warp * KP_CAP;
  // x rows of 4, 8 or 16 bytes: a hit's row is copied (cp.async) into a
  // 16-byte slot beside its list entry as the list is written, so the
  // batches read it from shared memory instead of gathering it
  const int rb = cin * (int)sizeof(T);
  const bool stage = rb == 4 || rb == 8 || rb == 16;
  unsigned char* xl = smem + KP_WARPS * KP_CAP * 8 + warp * KP_CAP * 16;
  const int rpw = ((rpc + KP_WARPS - 1) / KP_WARPS + 31) & ~31;  // rows a warp
  const int c_end = min(na, chunk * rpc + rpc);
  const int w_begin = chunk * rpc + warp * rpw;
  const int w_end = min(c_end, w_begin + rpw);
  float acc[AB][NC];
#pragma unroll
  for (int i = 0; i < AB; ++i)
#pragma unroll
    for (int m = 0; m < NC; ++m) acc[i][m] = 0.0f;

  for (int r0 = w_begin; r0 < w_end; r0 += 32 * KP_STEPS) {
    int e[KP_STEPS];
    bool hit[KP_STEPS];
#pragma unroll
    for (int st = 0; st < KP_STEPS; ++st) {  // every map load of the steps in flight
      const int r = r0 + 32 * st + lane;
      e[st] = r < w_end ? __ldcs(map + r) : -1;
    }
#pragma unroll
    for (int st = 0; st < KP_STEPS; ++st) hit[st] = e[st] >= 0 && e[st] < na;
    if (dout_mask != nullptr) {  // a masked dout row adds nothing
#pragma unroll
      for (int st = 0; st < KP_STEPS; ++st)
        hit[st] = hit[st] && __ldg(dout_mask + e[st]) != 0;
    }
    int n = 0;
    __syncwarp();  // the previous steps' list and x rows are read
#pragma unroll
    for (int st = 0; st < KP_STEPS; ++st) {  // hits in row order
      const unsigned bal = __ballot_sync(FULL, hit[st]);
      if (hit[st]) {
        const int pos = n + __popc(bal & ((1u << lane) - 1u));
        list[pos] = make_int2(e[st], 32 * st + lane);
        if (stage)
          cp_row(xl + (size_t)pos * 16,
                 reinterpret_cast<const unsigned char*>(x) + (size_t)(r0 + 32 * st + lane) * rb,
                 rb);
      }
      n += __popc(bal);
    }
    if (stage) {
      z3::cp_commit();
      z3::cp_wait<0>();
    }
    __syncwarp();
    if (stage) {
      if (vec)
        kp_batches<T, AB, NC, true, true>(x, xl, dout, list, n, r0, c, cin, cout, a0, valid,
                                          acc);
      else
        kp_batches<T, AB, NC, false, true>(x, xl, dout, list, n, r0, c, cin, cout, a0, valid,
                                           acc);
    } else {
      if (vec)
        kp_batches<T, AB, NC, true, false>(x, xl, dout, list, n, r0, c, cin, cout, a0, valid,
                                           acc);
      else
        kp_batches<T, AB, NC, false, false>(x, xl, dout, list, n, r0, c, cin, cout, a0, valid,
                                            acc);
    }
  }
  // the block's tile: its warps' tiles added in warp order
  __syncthreads();  // every list is read (red takes their place)
  float* red = reinterpret_cast<float*>(smem);  // [warp][AB][NC][lane]
#pragma unroll
  for (int i = 0; i < AB; ++i)
#pragma unroll
    for (int m = 0; m < NC; ++m) red[((warp * AB + i) * NC + m) * 32 + lane] = acc[i][m];
  __syncthreads();
  for (int v = threadIdx.x; v < AB * NC * 32; v += KP_THREADS) {
    const int ln = v & 31, m = (v >> 5) % NC, i = (v >> 5) / NC;
    float s = 0.0f;
    for (int wp = 0; wp < KP_WARPS; ++wp) s += red[((wp * AB + i) * NC + m) * 32 + ln];
    const int lq = ln / ct, a = lq * aslice + i0 + i, col = ln - lq * ct + 32 * m;
    if (i0 + i < aslice && a < cin && col < cout)
      partial[(((size_t)chunk * k + o) * cin + a) * cout + col] = s;
  }
}

template <typename T>
__global__ void full_wgrad_sum_kernel(const float* __restrict__ partial, T* __restrict__ dw,
                                      int chunks, size_t total) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int c = 0; c < chunks; ++c) s += partial[(size_t)c * total + i];
    dw[i] = from_f32<T>(s);
  }
}

// ---------------------------------------------------------------- host

// ops/sparse_conv.py full_tiles: the lane tiling of both kernels
struct Tiles {
  int ct, nc, aslice, ab, passes;
};

Tiles tiles_of(int cin, int cout) {
  Tiles t;
  t.ct = 1;
  while (t.ct < cout && t.ct < 32) t.ct <<= 1;
  t.nc = (cout + t.ct - 1) / t.ct;
  const int q = 32 / t.ct;
  t.aslice = (cin + q - 1) / q;
  t.ab = t.aslice == 1 ? 1 : t.aslice <= 4 ? 4 : 16;
  t.passes = (t.aslice + t.ab - 1) / t.ab;
  return t;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// opt in to SMEM_LIMIT bytes once per kernel; the blocks an SM holds at
// `smem` bytes and `threads` threads, kept for the last pair asked
template <typename F>
int prepare(F kernel, int threads, int smem, bool& configured, int& last_key, int& blocks) {
  if (!configured) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != 0) return err;
    configured = true;
  }
  const int key = smem * 32 + threads / 32;
  if (key != last_key) {
    const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                                       smem);
    if (err != 0) return err;
    last_key = key;
  }
  return 0;
}

// KO's block: as many warps (8 to 24) as fit beside W; W stays in L2
// where 8 warps would not fit beside it
template <typename T, int AB, int NC>
int launch_fwd(const void* x, const void* nbr, const void* w, const void* out_mask,
               const void* src_mask, void* out, int n_in, int n_out, int k, int cin, int cout,
               const Tiles& t, cudaStream_t st) {
  static bool configured = false;
  static int last_key = -1, per_sm = 0;
  constexpr int V = AB < 4 ? AB : 4;
  const size_t per_warp = (size_t)KO_CAP * 8 + (size_t)KO_ROWS * 32 * NC * 4;
  const size_t wbytes = (size_t)k * NC * (t.passes * AB / V) * 32 * V * 4;
  const bool staged = wbytes + KO_MIN_WARPS * per_warp <= (size_t)SMEM_LIMIT;
  const size_t room = SMEM_LIMIT - (staged ? wbytes : 0);
  const int warps = (int)std::min<size_t>(KO_MAX_WARPS, room / per_warp);
  const int smem = (int)((staged ? wbytes : 0) + warps * per_warp);
  auto kernel = full_fwd_kernel<T, AB, NC>;
  int err = prepare(kernel, 32 * warps, smem, configured, last_key, per_sm);
  if (err != 0) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (n_out + KO_ROWS - 1) / KO_ROWS;
  const int blocks = std::min((tiles + warps - 1) / warps, per_sm * sm_count());
  kernel<<<blocks, 32 * warps, smem, st>>>(
      static_cast<const T*>(x), static_cast<const int*>(nbr), static_cast<const T*>(w),
      static_cast<const uint8_t*>(out_mask), static_cast<const uint8_t*>(src_mask),
      static_cast<T*>(out), n_in, n_out, k, cin, cout, t.ct, t.aslice, t.passes, (int)staged);
  return (int)cudaGetLastError();
}

template <int CP, int NT>
int launch_mma(const void* x, const void* nbr, const void* w, const void* out_mask,
               const void* src_mask, void* out, int n_in, int n_out, int k, int cout,
               size_t smem, cudaStream_t st) {
  static bool configured = false;
  static int last_key = -1, per_sm = 0;
  auto kernel = full_fwd_mma_kernel<CP, NT>;
  int err = prepare(kernel, 32 * KM_WARPS, (int)smem, configured, last_key, per_sm);
  if (err != 0) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (n_out + 31) / 32;
  const int blocks = std::min((tiles + KM_WARPS - 1) / KM_WARPS, per_sm * sm_count());
  kernel<<<blocks, 32 * KM_WARPS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(nbr),
      static_cast<const __nv_bfloat16*>(w), static_cast<const uint8_t*>(out_mask),
      static_cast<const uint8_t*>(src_mask), static_cast<__nv_bfloat16*>(out), n_in, n_out, k,
      cout);
  return (int)cudaGetLastError();
}

template <int C>
int launch_rows(const void* x, const void* nbr, const void* w, const void* out_mask,
                const void* src_mask, void* out, int n_in, int n_out, int k, int cout,
                cudaStream_t st) {
  static bool configured = false;
  static int last_key = -1, per_sm = 0;
  const size_t smem = (size_t)k * C * 32 * 4 + (size_t)KR_WARPS * KR_GROUP * 33 * 4;
  if (smem > (size_t)SMEM_LIMIT) return -1;
  auto kernel = full_fwd_rows_kernel<C>;
  int err = prepare(kernel, 32 * KR_WARPS, (int)smem, configured, last_key, per_sm);
  if (err != 0) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (n_out + 31) / 32;
  const int blocks = std::min((tiles + KR_WARPS - 1) / KR_WARPS, per_sm * sm_count());
  kernel<<<blocks, 32 * KR_WARPS, smem, st>>>(
      static_cast<const float*>(x), static_cast<const int*>(nbr), static_cast<const float*>(w),
      static_cast<const uint8_t*>(out_mask), static_cast<const uint8_t*>(src_mask),
      static_cast<float*>(out), n_in, n_out, k, cout);
  return (int)cudaGetLastError();
}

// KO's f32 row form takes Cin in (1, 2, 4) and Cout <= 32 where W fits in
// shared memory.  Returns -1 where it does not take the shape.
int fwd_rows(const void* x, const void* nbr, const void* w, const void* out_mask,
             const void* src_mask, void* out, int n_in, int n_out, int k, int cin, int cout,
             cudaStream_t st) {
  if (cout > 32) return -1;
  switch (cin) {
    case 1: return launch_rows<1>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cout, st);
    case 2: return launch_rows<2>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cout, st);
    case 4: return launch_rows<4>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cout, st);
    default: return -1;
  }
}

// KO's tensor-core form takes bf16 at Cin in (1, 2, 4, 8, 16) and Cout in
// [17, 64] where W's fragments and the warps' stashes fit in shared
// memory; the CUDA cores take every other shape.  Returns -1 where it
// does not take the shape.
template <int CP>
int mma_nt(const void* x, const void* nbr, const void* w, const void* out_mask,
           const void* src_mask, void* out, int n_in, int n_out, int k, int cout,
           cudaStream_t st) {
  const int nt = cout > 32 ? 8 : 4;
  const size_t groups = (k + KM_GROUP - 1) / KM_GROUP;
  const size_t smem = groups * Km<CP>::STEPS * nt * 32 * 8 +
                      (size_t)KM_WARPS * KM_GROUP * Km<CP>::PITCH * 4;
  if (smem > (size_t)SMEM_LIMIT) return -1;
  if (nt == 8)
    return launch_mma<CP, 8>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cout, smem, st);
  return launch_mma<CP, 4>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cout, smem, st);
}

int fwd_mma(const void* x, const void* nbr, const void* w, const void* out_mask,
            const void* src_mask, void* out, int n_in, int n_out, int k, int cin, int cout,
            cudaStream_t st) {
  if (cout <= 16) return -1;
  switch (cin) {
    case 1: return mma_nt<1>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cout, st);
    case 2: return mma_nt<2>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cout, st);
    case 4: return mma_nt<4>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cout, st);
    case 8: return mma_nt<8>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cout, st);
    case 16: return mma_nt<16>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cout, st);
    default: return -1;
  }
}

template <typename T, int AB, int NC>
int launch_wgrad(const void* x, const void* dout, const void* nbr, const void* dout_mask,
                 float* partial, int na, int k, int cin, int cout, int chunks, int rpc,
                 const Tiles& t, cudaStream_t st) {
  static bool configured = false;
  static int last_key = -1, per_sm = 0;
  const int rb = cin * (int)sizeof(T);  // rows of 4, 8 or 16 bytes: copied beside the list
  const int xl = rb == 4 || rb == 8 || rb == 16 ? 16 : 0;
  const int smem = std::max(KP_WARPS * KP_CAP * (8 + xl), KP_WARPS * AB * NC * 32 * 4);
  auto kernel = full_wgrad_kernel<T, AB, NC>;
  int err = prepare(kernel, KP_THREADS, smem, configured, last_key, per_sm);
  if (err != 0) return err;
  const dim3 grid((unsigned)chunks * k, t.passes);
  kernel<<<grid, KP_THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dout), static_cast<const int*>(nbr),
      static_cast<const uint8_t*>(dout_mask), partial, na, k, cin, cout, chunks, rpc, t.ct,
      t.aslice);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
int fwd_ab(const void* x, const void* nbr, const void* w, const void* out_mask,
           const void* src_mask, void* out, int n_in, int n_out, int k, int cin, int cout,
           const Tiles& t, cudaStream_t st) {
  if (t.ab == 1)
    return launch_fwd<T, 1, NC>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cin, cout,
                                t, st);
  if (t.ab == 4)
    return launch_fwd<T, 4, NC>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cin, cout,
                                t, st);
  return launch_fwd<T, 16, NC>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cin, cout,
                               t, st);
}

template <typename T>
int fwd_t(const void* x, const void* nbr, const void* w, const void* out_mask,
          const void* src_mask, void* out, int n_in, int n_out, int k, int cin, int cout,
          cudaStream_t st) {
  const Tiles t = tiles_of(cin, cout);
  if (t.nc == 2)
    return fwd_ab<T, 2>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cin, cout, t, st);
  return fwd_ab<T, 1>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cin, cout, t, st);
}

template <typename T, int NC>
int wgrad_ab(const void* x, const void* dout, const void* nbr, const void* dout_mask,
             float* partial, int na, int k, int cin, int cout, int chunks, int rpc,
             const Tiles& t, cudaStream_t st) {
  if (t.ab == 1)
    return launch_wgrad<T, 1, NC>(x, dout, nbr, dout_mask, partial, na, k, cin, cout, chunks,
                                  rpc, t, st);
  if (t.ab == 4)
    return launch_wgrad<T, 4, NC>(x, dout, nbr, dout_mask, partial, na, k, cin, cout, chunks,
                                  rpc, t, st);
  return launch_wgrad<T, 16, NC>(x, dout, nbr, dout_mask, partial, na, k, cin, cout, chunks,
                                 rpc, t, st);
}

template <typename T>
int wgrad_t(const void* x, const void* dout, const void* nbr, const void* dout_mask,
            float* partial, void* dw, int na, int k, int cin, int cout, int chunks, int rpc,
            cudaStream_t st) {
  const Tiles t = tiles_of(cin, cout);
  int err = t.nc == 2 ? wgrad_ab<T, 2>(x, dout, nbr, dout_mask, partial, na, k, cin, cout,
                                       chunks, rpc, t, st)
                      : wgrad_ab<T, 1>(x, dout, nbr, dout_mask, partial, na, k, cin, cout,
                                       chunks, rpc, t, st);
  if (err != 0) return err;
  const size_t total = (size_t)k * cin * cout;
  const int sum_blocks = (int)std::min<size_t>((total + 255) / 256, 4096);
  full_wgrad_sum_kernel<T><<<sum_blocks, 256, 0, st>>>(partial, static_cast<T*>(dw), chunks,
                                                       total);
  return (int)cudaGetLastError();
}

bool widths_ok(int cin, int cout) {
  return cin >= 1 && cin <= MAXW && cout >= 1 && cout <= MAXW;
}
}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
// One launch (KO).  Offsets are packed with the tile row into an int32
// (offset << 3), so K is at most 2^28.
extern "C" int zconv_full_fwd(const void* x, const void* nbr, const void* w, const void* out_mask,
                              const void* src_mask, void* out, int n_in, int n_out, int k,
                              int cin, int cout, int dtype, void* stream) {
  if (n_in < 0 || n_out < 0 || k < 1 || k >= (1 << 28) || !widths_ok(cin, cout) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n_out == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const int err = fwd_mma(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cin, cout, st);
    if (err >= 0) return err;
    return fwd_t<__nv_bfloat16>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cin, cout,
                                st);
  }
  const int err = fwd_rows(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cin, cout, st);
  if (err >= 0) return err;
  return fwd_t<float>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cin, cout, st);
}

// Two launches (KP's partial tiles, then their sum over the chunks).
// partial: f32 [chunks, K, Cin, Cout], every entry written; rpc rows a
// chunk (ops/sparse_conv.py full_wgrad_split).
extern "C" int zconv_full_wgrad(const void* x, const void* dout, const void* nbr,
                                const void* dout_mask, void* partial, void* dw, int na, int k,
                                int cin, int cout, int chunks, int rpc, int dtype, void* stream) {
  if (na < 0 || k < 1 || !widths_ok(cin, cout) || chunks < 1 || rpc < 1 ||
      (size_t)chunks * rpc < (size_t)na || (size_t)chunks * k > 0x7fffffffu ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  if (dtype == 1)
    return wgrad_t<__nv_bfloat16>(x, dout, nbr, dout_mask, part, dw, na, k, cin, cout, chunks,
                                  rpc, st);
  return wgrad_t<float>(x, dout, nbr, dout_mask, part, dw, na, k, cin, cout, chunks, rpc, st);
}

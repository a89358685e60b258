// Gather-GEMM template of the strided sparse conv forwards KB
// (zconv_down_fwd.cu) and KC (zconv_up_fwd.cu), which are also the
// backward dx of each other with transposed weights; wgrad.cuh includes
// it.  (The zconv3 forward and dx, KA and KE, have their own blocking:
// zconv3_mma.cuh.)
//
//   out[i, :] = mask[i] * sum_{o < NOFF} sum_{t < NTAPS} x[src(o, t, i), :] @ w[o, t]
//
// where src(o, t, i) is a row of x or -1 (a zero row), given by a Map
// policy.  w is [NOFF * NTAPS * cin, cout] row-major (the JAX layout
// [K, Cin, Cout] with K = NOFF * NTAPS).  Accumulation is f32; the output
// is rounded once to the input type.  A null `mask` keeps every row; a
// non-null `src_mask` turns a source row s with src_mask[s] == 0 into a
// zero row (the backward passes reuse a forward kernel on a cotangent
// that the forward's output mask zeroes).
//
// Design (first version: right and simple, no pipelining).  One block of
// 128 threads owns a BM = 64 row x BN (64 or 32) column output tile.  For
// each (offset, tap) it resolves the 64 source rows once into shared
// memory, skips the pair when no row of the tile has a source (a
// block-uniform vote), then walks cin in BK = 32 chunks: the 64 gathered
// rows (16-byte vector loads, one row is one contiguous 64/128-byte run)
// and the BK x BN weight slab go to shared memory, and the tile is
// multiplied there.  bf16 uses the tensor cores through WMMA 16x16x16
// fragments (four warps, f32 accumulators in registers); f32 uses a 4 x
// BN/8 register micro-tile of FMAs.  The epilogue stages the f32 tile in
// shared memory and writes masked, rounded rows.
//
// Bound on an H100: the gather of sources and the weight reads are bytes;
// the MMAs are operations.  At the main path's widths (cin, cout >= 32)
// the tile's operations are far below the 989 TFLOP/s bf16 peak's reach
// of its bytes, so the kernel is bound by the bytes it gathers and by
// gather latency, which this version does not hide (no cp.async ring).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace lidog {

constexpr int BM = 64;
constexpr int BK = 32;
constexpr int NT = 128;

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The f32 tile staged for the epilogue: BM x (BN + 4) floats.
template <typename T, int BN>
struct MmaTile;

template <int BN>
struct MmaTile<__nv_bfloat16, BN> {
  static constexpr int WN = BN / 32;  // warps across columns
  static constexpr int WM = 4 / WN;   // warps across rows
  static constexpr int FM = BM / (16 * WM);
  static constexpr int FN = 2;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[FM][FN];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.0f);
  }
  __device__ void step(const __nv_bfloat16* As, int ap, const __nv_bfloat16* Bs, int bp) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
    const int wm = warp / WN, wn = warp % WN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * FM * 16 + i * 16) * ap + kk, ap);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * bp + wn * 32 + j * 16, bp);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  __device__ void store(float* Cs, int cp) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
    const int wm = warp / WN, wn = warp % WN;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(Cs + (wm * FM * 16 + i * 16) * cp + wn * 32 + j * 16,
                                acc[i][j], cp, wmma::mem_row_major);
  }
};

template <int BN>
struct MmaTile<float, BN> {
  static constexpr int TM = 4;
  static constexpr int TN = BN / 8;  // 16 row groups x 8 column groups = 128 threads
  float acc[TM][TN];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  }
  __device__ void step(const float* As, int ap, const float* Bs, int bp) {
    const int r0 = (threadIdx.x / 8) * TM, c0 = (threadIdx.x % 8) * TN;
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[(r0 + i) * ap + k];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k * bp + c0 + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __device__ void store(float* Cs, int cp) {
    const int r0 = (threadIdx.x / 8) * TM, c0 = (threadIdx.x % 8) * TN;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) Cs[(r0 + i) * cp + c0 + j] = acc[i][j];
  }
};

template <typename T, int BN, class Map>
__global__ void __launch_bounds__(NT)
gather_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const uint8_t* __restrict__ mask, const uint8_t* __restrict__ src_mask,
                   T* __restrict__ out, Map map,
                   int n_in, int n_out, int cin, int cout) {
  constexpr int EPV = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int AP = BK + EPV;         // padded row pitches (16-byte multiples)
  constexpr int BP = BN + EPV;
  constexpr int CP = BN + 4;
  constexpr int VA = BK / EPV;  // vectors per gathered row chunk
  constexpr int VB = BN / EPV;  // vectors per weight row chunk
  __shared__ __align__(128) T As[BM * AP];
  __shared__ __align__(128) T Bs[BK * BP];
  __shared__ __align__(128) float Cs[BM * CP];
  __shared__ int src[BM];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  MmaTile<T, BN> tile;
  tile.zero();

  for (int o = 0; o < Map::NOFF; ++o) {
    for (int t = 0; t < Map::NTAPS; ++t) {
      int s = -1;
      if (tid < BM && m0 + tid < n_out) {
        s = map.src(o, t, m0 + tid);
        if (s >= n_in || (s >= 0 && src_mask != nullptr && !src_mask[s])) s = -1;
      }
      __syncthreads();  // the previous pair's loads have read src
      if (tid < BM) src[tid] = s;
      if (!__syncthreads_or(s >= 0)) continue;
      const T* wk = w + ((size_t)(o * Map::NTAPS + t) * cin) * cout + n0;
      for (int c0 = 0; c0 < cin; c0 += BK) {
        for (int v = tid; v < BM * VA; v += NT) {
          const int r = v / VA, q = v % VA;
          const int sr = src[r];
          uint4 val = make_uint4(0, 0, 0, 0);
          if (sr >= 0) val = *reinterpret_cast<const uint4*>(x + (size_t)sr * cin + c0 + q * EPV);
          *reinterpret_cast<uint4*>(As + r * AP + q * EPV) = val;
        }
        for (int v = tid; v < BK * VB; v += NT) {
          const int r = v / VB, q = v % VB;
          *reinterpret_cast<uint4*>(Bs + r * BP + q * EPV) =
              *reinterpret_cast<const uint4*>(wk + (size_t)(c0 + r) * cout + q * EPV);
        }
        __syncthreads();
        tile.step(As, AP, Bs, BP);
        __syncthreads();
      }
    }
  }
  tile.store(Cs, CP);
  __syncthreads();
  for (int v = tid; v < BM * BN; v += NT) {
    const int r = v / BN, c = v % BN;
    const int row = m0 + r;
    if (row < n_out)
      out[(size_t)row * cout + n0 + c] =
          from_f32<T>(mask == nullptr || mask[row] ? Cs[r * CP + c] : 0.0f);
  }
}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
template <class Map>
int launch_gather_gemm(const void* x, const void* w, const void* mask, const void* src_mask,
                       void* out, Map map, int n_in, int n_out, int cin, int cout, int dtype,
                       void* stream) {
  if (n_out <= 0 || cin <= 0 || cin % BK != 0 || cout % 32 != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const bool bn64 = cout % 64 == 0;
  const dim3 grid((n_out + BM - 1) / BM, cout / (bn64 ? 64 : 32));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const uint8_t* sm = static_cast<const uint8_t*>(src_mask);
#define LIDOG_LAUNCH(T, BN)                                                                 \
  gather_gemm_kernel<T, BN, Map><<<grid, NT, 0, st>>>(                                     \
      static_cast<const T*>(x), static_cast<const T*>(w), m, sm, static_cast<T*>(out), map, \
      n_in, n_out, cin, cout)
  if (dtype == 1) {
    if (bn64) LIDOG_LAUNCH(__nv_bfloat16, 64); else LIDOG_LAUNCH(__nv_bfloat16, 32);
  } else {
    if (bn64) LIDOG_LAUNCH(float, 64); else LIDOG_LAUNCH(float, 32);
  }
#undef LIDOG_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace lidog

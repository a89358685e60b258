// Two-pass deterministic weight-gradient template shared by the sparse
// convs' dW kernels: KF (zconv_wgrad.cu) and LB (sparse_conv.cu).
//
//   dW[k] = sum over rows r of A_k(r)^T (outer) G_k(r)      [K, Cin, Cout]
//
// where a Map policy gives, per (k, r), the source row of A (a_src) and of
// G (g_src), or -1 (no contribution); G is read through g_mask.  Summed
// in f32 and rounded once to the input type.
//
// Design: a reduction over every row of a level, in two passes so that the
// result is deterministic (blocks run in no order; atomics would sum in a
// different order on every run).  Pass 1: block (tile, k, chunk) owns a
// 32 (Cin) x BN (Cout) tile of dW[k] and a contiguous chunk of rows; it
// walks the chunk 32 rows at a time, resolves the 32 A and G source rows
// once into shared memory, skips a step no row contributes to (a block
// vote), gathers the rows (16-byte vector loads) into shared memory and
// accumulates A^T G there: bf16 through WMMA 16x16x16 (A read col-major,
// f32 accumulators), f32 through a register micro-tile of FMAs.  It writes
// its f32 tile to partial[chunk, k].  Pass 2 sums partial over the chunks
// in order and rounds.  The wrapper sizes the chunks so that pass 1 has
// about eight blocks per SM; partial holds chunks x K x Cin x Cout floats.
#pragma once

#include <algorithm>

#include "gather_gemm.cuh"

namespace lidog {

constexpr int WM = 32;  // Cin rows of a dW tile
constexpr int RK = 32;  // level rows per step

template <typename T, int BN>
struct WTile;

template <int BN>
struct WTile<__nv_bfloat16, BN> {
  // 2 x 2 warps over the 32 x BN tile; each warp 16 x BN/2
  static constexpr int FN = BN / 32;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[FN];

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < FN; ++j) nvcuda::wmma::fill_fragment(acc[j], 0.0f);
  }
  // As: [RK rows][WM cin] (read as the col-major WM x RK matrix A^T);
  // Gs: [RK rows][BN cout]
  __device__ void step(const __nv_bfloat16* As, int ap, const __nv_bfloat16* Gs, int gp) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
    const int wm = warp / 2, wn = warp % 2;
#pragma unroll
    for (int kk = 0; kk < RK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
      wmma::load_matrix_sync(a, As + kk * ap + wm * 16, ap);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Gs + kk * gp + wn * (BN / 2) + j * 16, gp);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  __device__ void store(float* Cs, int cp) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
    const int wm = warp / 2, wn = warp % 2;
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + wm * 16 * cp + wn * (BN / 2) + j * 16, acc[j], cp,
                              wmma::mem_row_major);
  }
};

template <int BN>
struct WTile<float, BN> {
  // 8 row groups x 16 column groups = 128 threads
  static constexpr int TM = WM / 8;
  static constexpr int TN = BN / 16;
  float acc[TM][TN];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  }
  __device__ void step(const float* As, int ap, const float* Gs, int gp) {
    const int r0 = (threadIdx.x / 16) * TM, c0 = (threadIdx.x % 16) * TN;
#pragma unroll 8
    for (int k = 0; k < RK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k * ap + r0 + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Gs[k * gp + c0 + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __device__ void store(float* Cs, int cp) {
    const int r0 = (threadIdx.x / 16) * TM, c0 = (threadIdx.x % 16) * TN;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) Cs[(r0 + i) * cp + c0 + j] = acc[i][j];
  }
};

template <typename T, int BN, class Map>
__global__ void __launch_bounds__(NT)
wgrad_kernel(const T* __restrict__ a, const T* __restrict__ g, const uint8_t* __restrict__ g_mask,
             float* __restrict__ partial, Map map, int n_a, int n_g, int rows, int rpc, int cin,
             int cout) {
  constexpr int EPV = 16 / sizeof(T);
  constexpr int AP = WM + EPV;
  constexpr int GP = BN + EPV;
  constexpr int CP = BN + 4;
  constexpr int VA = WM / EPV;
  constexpr int VG = BN / EPV;
  __shared__ __align__(128) T As[RK * AP];
  __shared__ __align__(128) T Gs[RK * GP];
  __shared__ __align__(128) float Cs[WM * CP];
  __shared__ int sa[RK], sg[RK];

  const int tid = threadIdx.x;
  const int tiles_n = cout / BN;
  const int c0 = (blockIdx.x / tiles_n) * WM;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  const int k = blockIdx.y;
  const int chunk = blockIdx.z;
  const int r_begin = chunk * rpc;
  const int r_end = min(rows, r_begin + rpc);
  WTile<T, BN> tile;
  tile.zero();

  for (int r0 = r_begin; r0 < r_end; r0 += RK) {
    int ia = -1, ig = -1;
    if (tid < RK && r0 + tid < r_end) {
      ia = map.a_src(k, r0 + tid);
      ig = map.g_src(k, r0 + tid);
      if (ia >= n_a) ia = -1;
      if (ig >= n_g || (ig >= 0 && g_mask != nullptr && !g_mask[ig])) ig = -1;
      if (ia < 0 || ig < 0) ia = ig = -1;
    }
    __syncthreads();  // the previous step has read sa/sg and the tiles
    if (tid < RK) {
      sa[tid] = ia;
      sg[tid] = ig;
    }
    if (!__syncthreads_or(ia >= 0)) continue;
    for (int v = tid; v < RK * VA; v += NT) {
      const int r = v / VA, q = v % VA;
      const int s = sa[r];
      uint4 val = make_uint4(0, 0, 0, 0);
      if (s >= 0) val = *reinterpret_cast<const uint4*>(a + (size_t)s * cin + c0 + q * EPV);
      *reinterpret_cast<uint4*>(As + r * AP + q * EPV) = val;
    }
    for (int v = tid; v < RK * VG; v += NT) {
      const int r = v / VG, q = v % VG;
      const int s = sg[r];
      uint4 val = make_uint4(0, 0, 0, 0);
      if (s >= 0) val = *reinterpret_cast<const uint4*>(g + (size_t)s * cout + n0 + q * EPV);
      *reinterpret_cast<uint4*>(Gs + r * GP + q * EPV) = val;
    }
    __syncthreads();
    tile.step(As, AP, Gs, GP);
  }
  tile.store(Cs, CP);
  __syncthreads();
  float* out = partial + ((size_t)chunk * Map::K + k) * cin * cout;
  for (int v = tid; v < WM * BN; v += NT) {
    const int r = v / BN, c = v % BN;
    out[(size_t)(c0 + r) * cout + n0 + c] = Cs[r * CP + c];
  }
}

template <typename T>
__global__ void wgrad_sum_kernel(const float* __restrict__ partial, T* __restrict__ dw,
                                 int chunks, size_t total) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int c = 0; c < chunks; ++c) s += partial[(size_t)c * total + i];
    dw[i] = from_f32<T>(s);
  }
}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
template <class Map>
int launch_wgrad(const void* a, const void* g, const void* g_mask, void* partial, void* dw,
                 Map map, int n_a, int n_g, int rows, int chunks, int rpc, int cin, int cout,
                 int dtype, void* stream) {
  if (rows < 0 || chunks < 1 || rpc < RK || rpc % RK != 0 || (size_t)chunks * rpc < (size_t)rows ||
      cin <= 0 || cin % WM != 0 || cout <= 0 || cout % 32 != 0 || chunks > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const bool bn64 = cout % 64 == 0;
  const dim3 grid((cin / WM) * (cout / (bn64 ? 64 : 32)), Map::K, chunks);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* gm = static_cast<const uint8_t*>(g_mask);
  float* part = static_cast<float*>(partial);
  const size_t total = (size_t)Map::K * cin * cout;
  const int sum_blocks = (int)std::min<size_t>((total + 255) / 256, 4096);
#define LIDOG_WGRAD(T, BN)                                                                  \
  wgrad_kernel<T, BN, Map><<<grid, NT, 0, st>>>(static_cast<const T*>(a),                  \
                                                static_cast<const T*>(g), gm, part, map,   \
                                                n_a, n_g, rows, rpc, cin, cout)
  if (dtype == 1) {
    if (bn64) LIDOG_WGRAD(__nv_bfloat16, 64); else LIDOG_WGRAD(__nv_bfloat16, 32);
  } else {
    if (bn64) LIDOG_WGRAD(float, 64); else LIDOG_WGRAD(float, 32);
  }
#undef LIDOG_WGRAD
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (dtype == 1)
    wgrad_sum_kernel<__nv_bfloat16><<<sum_blocks, 256, 0, st>>>(
        part, static_cast<__nv_bfloat16*>(dw), chunks, total);
  else
    wgrad_sum_kernel<float><<<sum_blocks, 256, 0, st>>>(part, static_cast<float*>(dw), chunks,
                                                        total);
  return (int)cudaGetLastError();
}

}  // namespace lidog

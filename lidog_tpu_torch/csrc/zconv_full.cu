// KO and KP: the K-offset gather-GEMM of the in_channels > 1 stem
// (zconv_full) and its weight gradient.
//
// Replaces lidog_tpu/ops/zconv.py:342-404 (_zfull_core, _zfull_bwd):
//
//   KO  out[i] = m[i] * sum_{o < K} x[nbr[o, i]] @ W[o]        [N, Cout]
//       (a -1 entry, or a source row s with src_mask[s] == 0, is a zero
//       row).  zconv_full's dx is KO too: the cotangent through the same
//       symmetric map with W[::-1] transposed to [K, Cout, Cin] and the
//       forward's output mask as src_mask.
//   KP  dW[o] = sum_i x[i]^T dout[nbr[K-1-o, i]]                 [K, Cin, Cout]
//       (dout read through the forward's output mask).  This is
//       lidog_tpu's own form: it gathers dout through the reversed offset
//       (the transpose of offset o on a symmetric map) and reads x rows in
//       order, so it needs no symmetry of the map to match the reference.
//
// Both sum in f32 and round once to the input type, as JAX does
// (preferred_element_type=f32, then astype).
//
// Widths are small and arbitrary (the stem: Cin = in_channels, 4 in the
// tests and the smoke run, Cout = 32; dx: 32 -> 4), so the gather-GEMM
// template of the other convs (widths in multiples of 32, tensor cores)
// does not fit.  Any Cin and Cout in [1, 64] are taken.
//
// Bound on an H100: bytes.  At the training plan's level 0 (491,520 rows,
// K = 125) the int32 map alone is 245.8 MB, read once, against ~30 MB of
// features; the multiply-adds (Cin x Cout per hit) are far below the
// card's rate.
//
// KO design: one thread per output row and a tile of CT output columns
// (CT = 4, 8, 16 or 32, the smallest that covers Cout, or 32), its f32
// sums in registers.  W is staged in shared memory as f32 in blocks of
// offsets (at most 32 KB at a time, so no opt-in above 48 KB is needed
// for Cin x Cout up to 64 x 64), read as broadcast float4s.  Each offset's
// map row is read coalesced across the block's threads; each hit gathers
// one x row of Cin values.
//
// KP design: deterministic, in two passes (no float atomics).  Pass 1:
// block (chunk, o) walks a contiguous chunk of rows, RS = 1024 rows at a
// time: each thread reads 4 map entries (all in flight at once), and the
// hits (most entries miss: a row has ~8 of 125 neighbours) are compacted
// in row order with warp ballots; only the hit rows' x rows and gathered
// dout rows are staged in shared memory as f32, RB at a time, and each
// thread accumulates its entries of the Cin x Cout tile over them.  It
// writes its f32 tile to partial[chunk, o].  Pass 2 sums partial over the
// chunks in order and rounds.  The centre offset (and dz = +-1) hits
// nearly every row, so the blocks of the dense offsets set the time: the
// wrapper cuts the rows into short chunks (4,096) to spread them over
// many blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int MAXW = 64;            // widest Cin / Cout taken
constexpr int FT = 128;             // KO threads per block
constexpr int WS_FLOATS = 8192;     // KO's W stage: 32 KB
constexpr int WT = 256;             // KP threads per block
constexpr int RPT = 4;              // KP map entries per thread and step
constexpr int RS = WT * RPT;        // KP rows per step
constexpr int RB = 64;              // KP hit rows staged at a time
constexpr int EPT = MAXW * MAXW / WT;  // KP entries per thread, at most

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

template <typename T, int CT>
__global__ void __launch_bounds__(FT)
full_fwd_kernel(const T* __restrict__ x, const int* __restrict__ nbr, const T* __restrict__ w,
                const uint8_t* __restrict__ out_mask, const uint8_t* __restrict__ src_mask,
                T* __restrict__ out, int n_in, int n_out, int k, int cin, int cout, int oc) {
  __shared__ __align__(16) float ws[WS_FLOATS];
  const int i = blockIdx.x * FT + threadIdx.x;
  const int c0 = blockIdx.y * CT;
  const bool live = i < n_out;
  float acc[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) acc[c] = 0.0f;

  for (int o0 = 0; o0 < k; o0 += oc) {
    const int on = min(oc, k - o0);
    __syncthreads();  // the previous block of offsets is read
    // ws[(ol * cin + kk) * CT + c] = W[o0 + ol, kk, c0 + c] (0 past Cout)
    for (int v = threadIdx.x; v < on * cin * CT; v += FT) {
      const int c = v % CT, rest = v / CT;
      const int col = c0 + c;
      ws[v] = col < cout ? to_f32(w[((size_t)o0 * cin + rest) * cout + col]) : 0.0f;
    }
    __syncthreads();
    if (!live) continue;
    for (int ol = 0; ol < on; ++ol) {
      const int s = nbr[(size_t)(o0 + ol) * n_out + i];
      if (s < 0 || s >= n_in || (src_mask != nullptr && !src_mask[s])) continue;
      const T* xr = x + (size_t)s * cin;
      const float* wo = ws + ol * cin * CT;
      for (int kk = 0; kk < cin; ++kk) {
        const float xv = to_f32(xr[kk]);
        const float4* wr = reinterpret_cast<const float4*>(wo + kk * CT);
#pragma unroll
        for (int c4 = 0; c4 < CT / 4; ++c4) {
          const float4 w4 = wr[c4];
          acc[4 * c4 + 0] = fmaf(xv, w4.x, acc[4 * c4 + 0]);
          acc[4 * c4 + 1] = fmaf(xv, w4.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(xv, w4.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(xv, w4.w, acc[4 * c4 + 3]);
        }
      }
    }
  }
  if (!live) return;
  const bool keep = out_mask == nullptr || out_mask[i] != 0;
#pragma unroll
  for (int c = 0; c < CT; ++c)
    if (c0 + c < cout) out[(size_t)i * cout + c0 + c] = from_f32<T>(keep ? acc[c] : 0.0f);
}

template <typename T>
__global__ void __launch_bounds__(WT)
full_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dout, const int* __restrict__ nbr,
                  const uint8_t* __restrict__ dout_mask, float* __restrict__ partial, int na,
                  int k, int cin, int cout, int rpc) {
  __shared__ float xs[RB * MAXW];
  __shared__ float gs[RB * MAXW];
  __shared__ int hit_row[RS], hit_src[RS];
  __shared__ int warp_hits[RPT * (WT / 32)];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x;
  const int o = blockIdx.y;
  const int* map = nbr + (size_t)(k - 1 - o) * na;  // dW[o] reads offset K-1-o
  const int r_begin = chunk * rpc;
  const int r_end = min(na, r_begin + rpc);
  const int ne = cin * cout;
  float acc[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) acc[j] = 0.0f;

  for (int r0 = r_begin; r0 < r_end; r0 += RS) {
    // RPT map entries per thread (rows r0 + i * WT + tid), all in flight
    int g[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r0 + i * WT + tid;
      g[i] = r < r_end ? map[r] : -1;
    }
    unsigned ballot[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (g[i] >= na || (g[i] >= 0 && dout_mask != nullptr && !dout_mask[g[i]])) g[i] = -1;
      ballot[i] = __ballot_sync(0xffffffffu, g[i] >= 0);
    }
    // compact this step's hits, in row order, into hit_row / hit_src
    __syncthreads();  // the previous step has read hit_row, hit_src
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) warp_hits[i * (WT / 32) + warp] = __popc(ballot[i]);
    }
    __syncthreads();
    int hits = 0;
    int base[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      base[i] = hits;
#pragma unroll
      for (int w = 0; w < WT / 32; ++w) {
        base[i] += w < warp ? warp_hits[i * (WT / 32) + w] : 0;
        hits += warp_hits[i * (WT / 32) + w];
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (g[i] >= 0) {
        const int pos = base[i] + __popc(ballot[i] & ((1u << lane) - 1u));
        hit_row[pos] = r0 + i * WT + tid;
        hit_src[pos] = g[i];
      }
    }
    __syncthreads();
    for (int q0 = 0; q0 < hits; q0 += RB) {
      const int m = min(RB, hits - q0);
      for (int v = tid; v < m * cin; v += WT)
        xs[v] = to_f32(x[(size_t)hit_row[q0 + v / cin] * cin + v % cin]);
      for (int v = tid; v < m * cout; v += WT)
        gs[v] = to_f32(dout[(size_t)hit_src[q0 + v / cout] * cout + v % cout]);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < EPT; ++j) {
        const int e = tid + j * WT;
        if (e < ne) {
          const int a = e / cout, b = e % cout;
          float sum = acc[j];
          for (int q = 0; q < m; ++q) sum = fmaf(xs[q * cin + a], gs[q * cout + b], sum);
          acc[j] = sum;
        }
      }
      __syncthreads();  // xs and gs are read
    }
  }
  float* dst = partial + ((size_t)chunk * k + o) * ne;
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int e = tid + j * WT;
    if (e < ne) dst[e] = acc[j];
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

template <typename T, int CT>
void launch_fwd(const void* x, const void* nbr, const void* w, const void* out_mask,
                const void* src_mask, void* out, int n_in, int n_out, int k, int cin,
                int cout, cudaStream_t st) {
  const int oc = std::max(1, WS_FLOATS / (cin * CT));
  const dim3 grid((n_out + FT - 1) / FT, (cout + CT - 1) / CT);
  full_fwd_kernel<T, CT><<<grid, FT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int*>(nbr), static_cast<const T*>(w),
      static_cast<const uint8_t*>(out_mask), static_cast<const uint8_t*>(src_mask),
      static_cast<T*>(out), n_in, n_out, k, cin, cout, oc);
}

template <typename T>
void launch_fwd_t(const void* x, const void* nbr, const void* w, const void* out_mask,
                  const void* src_mask, void* out, int n_in, int n_out, int k, int cin,
                  int cout, cudaStream_t st) {
  if (cout > 16)
    launch_fwd<T, 32>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cin, cout, st);
  else if (cout > 8)
    launch_fwd<T, 16>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cin, cout, st);
  else if (cout > 4)
    launch_fwd<T, 8>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cin, cout, st);
  else
    launch_fwd<T, 4>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cin, cout, st);
}

bool widths_ok(int cin, int cout) {
  return cin >= 1 && cin <= MAXW && cout >= 1 && cout <= MAXW;
}
}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int zconv_full_fwd(const void* x, const void* nbr, const void* w, const void* out_mask,
                              const void* src_mask, void* out, int n_in, int n_out, int k,
                              int cin, int cout, int dtype, void* stream) {
  if (n_in < 0 || n_out < 0 || k < 1 || !widths_ok(cin, cout) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n_out == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch_fwd_t<__nv_bfloat16>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cin, cout,
                                st);
  else
    launch_fwd_t<float>(x, nbr, w, out_mask, src_mask, out, n_in, n_out, k, cin, cout, st);
  return (int)cudaGetLastError();
}

extern "C" int zconv_full_wgrad(const void* x, const void* dout, const void* nbr,
                                const void* dout_mask, void* partial, void* dw, int na, int k,
                                int cin, int cout, int chunks, int rpc, int dtype, void* stream) {
  if (na < 0 || k < 1 || k > 65535 || !widths_ok(cin, cout) || chunks < 1 || rpc < 1 ||
      (size_t)chunks * rpc < (size_t)na || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(chunks, k);
  float* part = static_cast<float*>(partial);
  const uint8_t* dm = static_cast<const uint8_t*>(dout_mask);
  const int* map = static_cast<const int*>(nbr);
  const size_t total = (size_t)k * cin * cout;
  const int sum_blocks = (int)std::min<size_t>((total + 255) / 256, 4096);
  if (dtype == 1) {
    full_wgrad_kernel<__nv_bfloat16><<<grid, WT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dout), map, dm,
        part, na, k, cin, cout, rpc);
  } else {
    full_wgrad_kernel<float><<<grid, WT, 0, st>>>(static_cast<const float*>(x),
                                                  static_cast<const float*>(dout), map, dm, part,
                                                  na, k, cin, cout, rpc);
  }
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (dtype == 1)
    full_wgrad_sum_kernel<__nv_bfloat16><<<sum_blocks, 256, 0, st>>>(
        part, static_cast<__nv_bfloat16*>(dw), chunks, total);
  else
    full_wgrad_sum_kernel<float><<<sum_blocks, 256, 0, st>>>(part, static_cast<float*>(dw),
                                                             chunks, total);
  return (int)cudaGetLastError();
}

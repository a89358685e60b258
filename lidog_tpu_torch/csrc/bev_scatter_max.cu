// KI / KJ: the pooled BEV scatter-max of LiDOG's BEV branch and its
// backward.
//
// Replace lidog_tpu/ops/bev.py:93 (_pooled_scatter_max) and :115 (_psm_bwd),
// with the per-row candidate geometry of bev_scatter_pooled:31.  A voxel row
// n with coords (b, x, y, z) sits on dense pixel (px, py) = (x + grid/2,
// grid - 1 - (y + grid/2)); pooled output i covers dense pixels
// [i*stride - pad, i*stride - pad + window), so per axis the row reaches the
// outputs ceil((p - (window - 1 - pad)) / stride) .. floor((p + pad) / stride)
// inside [0, out_hw): at most ceil(window / stride) of them (2 for window 5,
// stride 3).  Candidate j = dy * cands + dx.  A row is live when its mask is
// set, its pixel lies on the grid and 0 <= b < nb.
//
//   KI  out[b, iy, ix, c] = max(0, max over live (n, j) landing there of
//                               feats[n, c])
//   KJ  dfeats[n, c] = sum_j [live_j(n) and feats[n, c] == out[cell_j(n), c]]
//                            * dout[cell_j(n), c]
//       summed in f32 for j = 0, 1, ... in order and rounded once: every
//       row that ties the cell's maximum gets the cell's whole cotangent,
//       and a row whose value is 0 wins a cell whose maximum is 0.
//
// Instead of the four [K, N] index tensors that JAX stacks, each thread
// derives its row's candidates from coords and mask.
//
// Bound on an H100: bytes.  KI writes the whole pooled grid ([4, 666, 666,
// 96] bf16, 340 MB, zero-filled as part of the op) and reads feats once;
// KJ reads feats, the touched cells of out and dout, and writes dfeats.
//
// KI design: the output starts at +0, so only values > 0 can win.  For
// IEEE values >= +0 the bit pattern orders like the value, so f32 takes a
// signed-integer atomicMax on the bits (a fire-and-forget RED.MAX).  bf16
// has no atomic max: one thread owns a channel pair and updates the 32-bit
// word that holds it with an atomicCAS loop that takes the max of both
// halves as unsigned 16-bit numbers (stored values are all >= +0).  Values
// that are not > 0 (negatives, -0.0, +0, NaN) are skipped, so -0.0 never
// replaces the +0 start value and ReLU zeros cost no atomic.  Max is order
// free: the result does not depend on the order the atomics land in.
//
// KJ design: a pure gather, one thread per (row, channel): no atomics,
// deterministic.  Both kernels are memory-bound streaming passes; the
// zero-fill is a cudaMemsetAsync on the same stream, before KI.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Geom {
  int nb, grid, out_hw, window, stride, pad, cands;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// The row's batch and candidate ranges; false when the row is not live.
__device__ __forceinline__ bool row_range(const int* coords, const uint8_t* mask, long row,
                                          const Geom& g, int& b, int& ylo, int& yhi, int& xlo,
                                          int& xhi) {
  if (!mask[row]) return false;
  const int4 c = reinterpret_cast<const int4*>(coords)[row];
  const int half = g.grid / 2;
  const int px = c.y + half;
  const int py = (g.grid - 1) - (c.z + half);
  b = c.x;
  if (b < 0 || b >= g.nb || px < 0 || px >= g.grid || py < 0 || py >= g.grid) return false;
  const int back = g.window - 1 - g.pad;
  ylo = -floor_div(-(py - back), g.stride);
  yhi = floor_div(py + g.pad, g.stride);
  xlo = -floor_div(-(px - back), g.stride);
  xhi = floor_div(px + g.pad, g.stride);
  return true;
}

// Flat cell (b * out_hw + iy) * out_hw + ix of candidate (dy, dx), or -1.
__device__ __forceinline__ long cell_of(const Geom& g, int b, int ylo, int yhi, int xlo, int xhi,
                                        int dy, int dx) {
  const int iy = ylo + dy, ix = xlo + dx;
  if (iy > yhi || ix > xhi || iy < 0 || iy >= g.out_hw || ix < 0 || ix >= g.out_hw) return -1;
  return ((long)b * g.out_hw + iy) * g.out_hw + ix;
}

__global__ void scatter_max_f32(const float* __restrict__ feats, const int* __restrict__ coords,
                                const uint8_t* __restrict__ mask, float* out, long n, int c,
                                Geom g) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * c) return;
  const long row = t / c;
  const int ch = (int)(t - row * c);
  const float v = feats[t];
  if (!(v > 0.f)) return;
  int b, ylo, yhi, xlo, xhi;
  if (!row_range(coords, mask, row, g, b, ylo, yhi, xlo, xhi)) return;
  for (int dy = 0; dy < g.cands; ++dy)
    for (int dx = 0; dx < g.cands; ++dx) {
      const long cell = cell_of(g, b, ylo, yhi, xlo, xhi, dy, dx);
      if (cell >= 0) atomicMax(reinterpret_cast<int*>(out + cell * c + ch), __float_as_int(v));
    }
}

__global__ void scatter_max_bf16(const uint32_t* __restrict__ feats,
                                 const int* __restrict__ coords, const uint8_t* __restrict__ mask,
                                 uint32_t* out, long n, int c, Geom g) {
  const int cp = c / 2;  // channel pairs per row
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * cp) return;
  const long row = t / cp;
  const int pair = (int)(t - row * cp);
  const uint32_t w = feats[t];
  // a half that is not > 0 takes the bits of +0: it can never win
  const float lo = __bfloat162float(__ushort_as_bfloat16((unsigned short)(w & 0xFFFFu)));
  const float hi = __bfloat162float(__ushort_as_bfloat16((unsigned short)(w >> 16)));
  const uint32_t vlo = lo > 0.f ? (w & 0xFFFFu) : 0u;
  const uint32_t vhi = hi > 0.f ? (w >> 16) : 0u;
  if ((vlo | vhi) == 0u) return;
  int b, ylo, yhi, xlo, xhi;
  if (!row_range(coords, mask, row, g, b, ylo, yhi, xlo, xhi)) return;
  for (int dy = 0; dy < g.cands; ++dy)
    for (int dx = 0; dx < g.cands; ++dx) {
      const long cell = cell_of(g, b, ylo, yhi, xlo, xhi, dy, dx);
      if (cell < 0) continue;
      uint32_t* addr = out + cell * cp + pair;
      uint32_t old = *reinterpret_cast<volatile uint32_t*>(addr);
      while (true) {
        const uint32_t nlo = max(old & 0xFFFFu, vlo);
        const uint32_t nhi = max(old >> 16, vhi);
        const uint32_t nw = nlo | (nhi << 16);
        if (nw == old) break;
        const uint32_t prev = atomicCAS(addr, old, nw);
        if (prev == old) break;
        old = prev;
      }
    }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void scatter_max_bwd(const T* __restrict__ feats, const int* __restrict__ coords,
                                const uint8_t* __restrict__ mask, const T* __restrict__ out,
                                const T* __restrict__ dout, T* __restrict__ dfeats, long n, int c,
                                Geom g) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * c) return;
  const long row = t / c;
  const int ch = (int)(t - row * c);
  float acc = 0.f;
  int b, ylo, yhi, xlo, xhi;
  if (row_range(coords, mask, row, g, b, ylo, yhi, xlo, xhi)) {
    const float v = to_f(feats[t]);
    for (int dy = 0; dy < g.cands; ++dy)
      for (int dx = 0; dx < g.cands; ++dx) {
        const long cell = cell_of(g, b, ylo, yhi, xlo, xhi, dy, dx);
        if (cell < 0) continue;
        const long o = cell * c + ch;
        if (v == to_f(out[o])) acc += to_f(dout[o]);
      }
  }
  store(dfeats + t, acc);
}

Geom make_geom(int nb, int grid, int out_hw, int window, int stride, int pad) {
  return Geom{nb, grid, out_hw, window, stride, pad, (window + stride - 1) / stride};
}

constexpr int kThreads = 256;

unsigned blocks_for(long work) { return (unsigned)((work + kThreads - 1) / kThreads); }

}  // namespace

// KI.  feats [n, c] (dtype 0 f32, 1 bf16; c even for bf16), coords int32
// [n, 4], mask bool [n] -> out [nb, out_hw, out_hw, c], zero-filled here.
extern "C" int bev_scatter_max_fwd(const void* feats, const void* coords, const void* mask,
                                   void* out, int n, int c, int nb, int grid, int out_hw,
                                   int window, int stride, int pad, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g = make_geom(nb, grid, out_hw, window, stride, pad);
  const size_t esz = dtype == 1 ? 2 : 4;
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)nb * out_hw * out_hw * c * esz, s);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaGetLastError();
  const int* co = static_cast<const int*>(coords);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (dtype == 1) {
    const long work = (long)n * (c / 2);
    scatter_max_bf16<<<blocks_for(work), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(feats), co, m, static_cast<uint32_t*>(out), n, c, g);
  } else {
    const long work = (long)n * c;
    scatter_max_f32<<<blocks_for(work), kThreads, 0, s>>>(
        static_cast<const float*>(feats), co, m, static_cast<float*>(out), n, c, g);
  }
  return (int)cudaGetLastError();
}

// KJ.  out and dout [nb, out_hw, out_hw, c] like feats -> dfeats [n, c].
extern "C" int bev_scatter_max_bwd(const void* feats, const void* coords, const void* mask,
                                   const void* out, const void* dout, void* dfeats, int n, int c,
                                   int nb, int grid, int out_hw, int window, int stride, int pad,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g = make_geom(nb, grid, out_hw, window, stride, pad);
  if (n == 0) return (int)cudaGetLastError();
  const long work = (long)n * c;
  const int* co = static_cast<const int*>(coords);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    scatter_max_bwd<T><<<blocks_for(work), kThreads, 0, s>>>(
        static_cast<const T*>(feats), co, m, static_cast<const T*>(out),
        static_cast<const T*>(dout), static_cast<T*>(dfeats), n, c, g);
  } else {
    scatter_max_bwd<float><<<blocks_for(work), kThreads, 0, s>>>(
        static_cast<const float*>(feats), co, m, static_cast<const float*>(out),
        static_cast<const float*>(dout), static_cast<float*>(dfeats), n, c, g);
  }
  return (int)cudaGetLastError();
}

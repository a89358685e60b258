// LE, LF, LH: gathers from a window staged in shared memory (the probes'
// VMEM gathers, lidog_tpu_torch/probes/).
//
//   LE window_row_gather   out[t, :] = win[idx[t], :]          win [W, C]
//      replaces benchmarks/micro/micro_gather.py:83,110 q2_pallas_vmem_gather
//      (P1 a/b: jnp.take axis 0, the index in SMEM or VMEM) and
//      benchmarks/micro/micro_bisect.py:73 gather_case (P4 sublane)
//   LF window_lane_gather  out[c, t] = win[c, idx[t]]              win [C, W]
//      replaces micro_gather.py:135 (P1 c: take_along_axis axis 1) and
//      micro_bisect.py:87 gather_case (P4 lane)
//   LH lane_gather_sum     out[c, l] = sum over r < R, in order, of
//                          win[c, 128 r + idx[c, 128 r + l]]   win, idx [C, 128 R]
//      replaces benchmarks/micro_lanegather.py:48 main (P5)
//
// An index outside [0, W) (LH: outside [0, 128)) reads a zero, as the
// plain versions in ops/gather.py do.  All three copy bits: LE and LF move
// 16-byte vectors or single elements, LH adds f32 in the plain version's
// order, so each is bitwise equal to its plain version.
//
// Bound on an H100: bytes (the window, the index and the output once each:
// about 1 MB for P1, under 10 us everywhere at the probes' shapes), so a
// launch costs more than the work.  The design is the simple one: the
// TPU kept the whole window in VMEM (up to 3 MB); a block has at most
// 227 KB, so LE stages a column slab [W, Cs] of the window (Cs so that
// the slab fits 200 KB) and each block of a slab writes out[t, slab] for
// a range of t; LF stages a few channel rows [R, W] and gathers along
// them; LH stages one channel row (R x 512 bytes) per block and each of
// 128 threads walks the R chunks of its lane.  Sharing one window across
// a cluster through distributed shared memory is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kSmemBudget = 200 * 1024;  // of the 227 KB a block may use
constexpr int kThreads = 256;
constexpr int kWave = 132;  // SMs of an H100

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// LE: grid (slabs, t ranges).  Block (s, j) stages the slab of 16-byte
// column vectors [s * vs, s * vs + nv) of every window row, then writes
// those vectors of out[t] for t in its range.
__global__ void window_rows_kernel(const uint4* __restrict__ win, const int* __restrict__ idx,
                                   uint4* __restrict__ out, int w, int t_count, int v_row,
                                   int vs, int t_per_block) {
  extern __shared__ uint4 slab[];  // [w, nv]
  const int v0 = blockIdx.x * vs;
  const int nv = min(vs, v_row - v0);
  for (int i = threadIdx.x; i < w * nv; i += blockDim.x) {
    const int r = i / nv;
    cp_async16(&slab[i], &win[(size_t)r * v_row + v0 + (i - r * nv)]);
  }
  cp_async_wait_all();
  __syncthreads();
  const int t0 = blockIdx.y * t_per_block;
  const int t1 = min(t0 + t_per_block, t_count);
  for (int i = threadIdx.x; i < (t1 - t0) * nv; i += blockDim.x) {
    const int k = i / nv, v = i - k * nv;
    const int s = idx[t0 + k];
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s >= 0 && s < w) val = slab[s * nv + v];
    out[(size_t)(t0 + k) * v_row + v0 + v] = val;
  }
}

// LF: grid (channel groups, t ranges).  Block (g, j) stages channel rows
// [g * rows, g * rows + nr) whole, then each thread gathers its t's from
// every staged row (writes coalesced along t).
template <typename E>
__global__ void window_lanes_kernel(const E* __restrict__ win, const int* __restrict__ idx,
                                    E* __restrict__ out, int c, int w, int t_count, int rows,
                                    int t_per_block) {
  extern __shared__ uint4 staged[];
  const E* row = reinterpret_cast<const E*>(staged);
  const int c0 = blockIdx.x * rows;
  const int nr = min(rows, c - c0);
  const int v_row = (int)(w * sizeof(E) / 16);
  const uint4* src = reinterpret_cast<const uint4*>(win + (size_t)c0 * w);
  for (int i = threadIdx.x; i < nr * v_row; i += blockDim.x) cp_async16(&staged[i], &src[i]);
  cp_async_wait_all();
  __syncthreads();
  const int t0 = blockIdx.y * t_per_block;
  const int t1 = min(t0 + t_per_block, t_count);
  for (int t = t0 + threadIdx.x; t < t1; t += blockDim.x) {
    const int s = idx[t];
    for (int r = 0; r < nr; ++r) {
      out[(size_t)(c0 + r) * t_count + t] = (s >= 0 && s < w) ? row[(size_t)r * w + s] : E(0);
    }
  }
}

// LH: one block of 128 threads per channel row.
__global__ void lane_sum_kernel(const float* __restrict__ win, const int* __restrict__ idx,
                                float* __restrict__ out, int reps) {
  extern __shared__ uint4 staged[];
  const float* row = reinterpret_cast<const float*>(staged);
  const int c = blockIdx.x;
  const size_t width = (size_t)reps * 128;
  const uint4* src = reinterpret_cast<const uint4*>(win + c * width);
  for (int i = threadIdx.x; i < reps * 32; i += blockDim.x) cp_async16(&staged[i], &src[i]);
  cp_async_wait_all();
  __syncthreads();
  const int l = threadIdx.x;
  const int* ix = idx + c * width;
  float acc = 0.0f;
  for (int r = 0; r < reps; ++r) {
    const int s = ix[r * 128 + l];
    acc = acc + ((s >= 0 && s < 128) ? row[r * 128 + s] : 0.0f);
  }
  out[(size_t)c * 128 + l] = acc;
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// t ranges of at least 32 rows, about one wave of blocks in all
int t_ranges(int t_count, int groups) {
  const int most = (t_count + 31) / 32;
  return std::max(1, std::min(most, kWave / std::max(groups, 1)));
}

}  // namespace

// LE.  win [w, row_bytes / 16] 16-byte vectors (any dtype), idx [t] int32,
// out [t, row_bytes / 16].  row_bytes a multiple of 16, w x 16 bytes within
// the shared-memory budget.  Returns a cudaError_t (0 = launched).
extern "C" int window_row_gather(const void* win, const void* idx, void* out, int w, int t,
                                 int row_bytes, void* stream) {
  if (w <= 0 || t <= 0 || row_bytes <= 0 || row_bytes % 16 || w > kSmemBudget / 16)
    return (int)cudaErrorInvalidValue;
  const int v_row = row_bytes / 16;
  const int vs = std::min(v_row, kSmemBudget / (w * 16));
  const int slabs = (v_row + vs - 1) / vs;
  const int ranges = t_ranges(t, slabs);
  const int per = (t + ranges - 1) / ranges;
  const size_t smem = (size_t)w * vs * 16;
  cudaError_t err = allow_smem((const void*)window_rows_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  window_rows_kernel<<<dim3(slabs, (t + per - 1) / per), kThreads, smem,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(win), static_cast<const int*>(idx), static_cast<uint4*>(out), w,
      t, v_row, vs, per);
  return (int)cudaGetLastError();
}

// LF.  win [c, w] of elem_bytes (4: float32, 2: bfloat16), idx [t] int32,
// out [c, t].  w x elem_bytes a multiple of 16 within the shared-memory
// budget.
extern "C" int window_lane_gather(const void* win, const void* idx, void* out, int c, int w,
                                  int t, int elem_bytes, void* stream) {
  const int row_bytes = w * elem_bytes;
  if (c <= 0 || w <= 0 || t <= 0 || (elem_bytes != 4 && elem_bytes != 2) ||
      w > kSmemBudget / elem_bytes || row_bytes % 16)
    return (int)cudaErrorInvalidValue;
  const int rows = std::max(1, std::min(c, 48 * 1024 / row_bytes));
  const int groups = (c + rows - 1) / rows;
  const int ranges = t_ranges(t, groups);
  const int per = (t + ranges - 1) / ranges;
  const size_t smem = (size_t)rows * row_bytes;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(groups, (t + per - 1) / per);
  cudaError_t err;
  if (elem_bytes == 4) {
    err = allow_smem((const void*)window_lanes_kernel<uint32_t>, smem);
    if (err != cudaSuccess) return (int)err;
    window_lanes_kernel<uint32_t><<<grid, kThreads, smem, st>>>(
        static_cast<const uint32_t*>(win), static_cast<const int*>(idx),
        static_cast<uint32_t*>(out), c, w, t, rows, per);
  } else {
    err = allow_smem((const void*)window_lanes_kernel<uint16_t>, smem);
    if (err != cudaSuccess) return (int)err;
    window_lanes_kernel<uint16_t><<<grid, kThreads, smem, st>>>(
        static_cast<const uint16_t*>(win), static_cast<const int*>(idx),
        static_cast<uint16_t*>(out), c, w, t, rows, per);
  }
  return (int)cudaGetLastError();
}

// LH.  win [c, 128 reps] float32, idx [c, 128 reps] int32, out [c, 128].
extern "C" int lane_gather_sum(const void* win, const void* idx, void* out, int c, int reps,
                               void* stream) {
  if (c <= 0 || reps <= 0 || reps > kSmemBudget / 512) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)reps * 512;
  cudaError_t err = allow_smem((const void*)lane_sum_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  lane_sum_kernel<<<c, 128, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(win), static_cast<const int*>(idx), static_cast<float*>(out),
      reps);
  return (int)cudaGetLastError();
}

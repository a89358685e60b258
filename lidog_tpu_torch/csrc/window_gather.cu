// LE, LF, LH: the probes' window gathers (lidog_tpu_torch/probes/).
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
// Bound on an H100: bytes (the window rows or elements the index names,
// the index and the output once each: about 0.4 MB for P1, under 2 us
// everywhere at the probes' shapes), so a launch and two dependent trips
// to L2 (the index, then the window) cost more than the work.  The TPU
// kept the whole window in VMEM; here a window of at most 2 MB sits in
// the 50 MB L2 after its first read, and staging it in shared memory
// would copy far more than the gather reads.  So LE and LF gather
// straight from the window in device memory, with several independent
// loads a thread in flight before any store:
//   LE: g threads a row (the fewest powers of two, at most 32, that hold
//       kRowVecs = 2 of the row's 16-byte vectors each: more warps with
//       fewer loads behind each index read beat 4 vectors a thread on an
//       H100); the group's first thread reads idx[t] and shuffles it to
//       the group, and a warp moves g consecutive vectors of each of its
//       32 / g rows at a time.
//   LF: a thread per t and kLaneChannels channels; idx[t] read once, the
//       stores coalesced along t; the grid covers t blocks x channel
//       blocks, so that P1's 512 lanes still make 96 blocks.
//   LH stages one channel row (R x 512 bytes) per block, and each of 128
//   threads walks the R chunks of its lane.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kSmemBudget = 200 * 1024;  // LH's channel row, of the 227 KB a block may use
constexpr int kThreads = 128;           // LE's and LF's blocks (ops/gather.py GATHER_THREADS)
constexpr int kRowVecs = 2;             // LE: 16-byte vectors a thread holds (ROW_VECTORS)
constexpr int kLaneChannels = 4;        // LF: channels a thread gathers (LANE_CHANNELS)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// LE: a group of g = 2^g_log2 threads a row (groups never straddle a
// warp).  The group's first thread reads idx[t] and shuffles it to the
// group; thread j of the group owns the row's vectors j, j + g, ...: it
// issues kRowVecs loads before their stores, so a warp reads and writes
// g consecutive 16-byte vectors of each of its 32 / g rows at a time.
__global__ void window_rows_kernel(const uint4* __restrict__ win, const int* __restrict__ idx,
                                   uint4* __restrict__ out, int w, int t_count, int v_row,
                                   int g_log2) {
  const int g = 1 << g_log2;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int t = (int)(gid >> g_log2);
  const int j = (int)(gid & (g - 1));
  int s = 0;
  if (j == 0 && t < t_count) s = idx[t];
  s = __shfl_sync(0xffffffffu, s, (int)(threadIdx.x & 31) & ~(g - 1));
  if (t >= t_count) return;
  const bool hit = s >= 0 && s < w;
  const uint4* src = win + (size_t)(hit ? s : 0) * v_row;
  uint4* dst = out + (size_t)t * v_row;
  for (int v0 = j; v0 < v_row; v0 += kRowVecs * g) {
    uint4 val[kRowVecs];
#pragma unroll
    for (int k = 0; k < kRowVecs; ++k) {
      const int v = v0 + k * g;
      val[k] = (hit && v < v_row) ? __ldg(src + v) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kRowVecs; ++k) {
      const int v = v0 + k * g;
      if (v < v_row) dst[v] = val[k];
    }
  }
}

// LF: grid (t blocks, channel blocks).  A thread reads idx[t] once and
// gathers win[c, idx[t]] for kLaneChannels channels, all loads before the
// stores, which a warp makes along 32 consecutive t of each channel row.
template <typename E>
__global__ void window_lanes_kernel(const E* __restrict__ win, const int* __restrict__ idx,
                                    E* __restrict__ out, int c, int w, int t_count) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= t_count) return;
  const int s = idx[t];
  const bool hit = s >= 0 && s < w;
  const int c0 = blockIdx.y * kLaneChannels;
  E val[kLaneChannels];
#pragma unroll
  for (int k = 0; k < kLaneChannels; ++k)
    val[k] = (hit && c0 + k < c) ? __ldg(win + (size_t)(c0 + k) * w + s) : E(0);
#pragma unroll
  for (int k = 0; k < kLaneChannels; ++k)
    if (c0 + k < c) out[(size_t)(c0 + k) * t_count + t] = val[k];
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

}  // namespace

// LE.  win [w, row_bytes / 16] 16-byte vectors (any dtype), idx [t] int32,
// out [t, row_bytes / 16].  row_bytes a multiple of 16.  Returns a
// cudaError_t (0 = launched).
extern "C" int window_row_gather(const void* win, const void* idx, void* out, int w, int t,
                                 int row_bytes, void* stream) {
  if (w <= 0 || t <= 0 || row_bytes <= 0 || row_bytes % 16) return (int)cudaErrorInvalidValue;
  const int v_row = row_bytes / 16;
  int g_log2 = 0;  // the fewest threads, at most 32, that hold kRowVecs vectors each
  while (g_log2 < 5 && (kRowVecs << g_log2) < v_row) ++g_log2;
  const long long blocks = (((long long)t << g_log2) + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  window_rows_kernel<<<(unsigned)blocks, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(win), static_cast<const int*>(idx), static_cast<uint4*>(out), w,
      t, v_row, g_log2);
  return (int)cudaGetLastError();
}

// LF.  win [c, w] of elem_bytes (4: float32, 2: bfloat16), idx [t] int32,
// out [c, t].  At most 65,535 blocks of kLaneChannels channels.
extern "C" int window_lane_gather(const void* win, const void* idx, void* out, int c, int w,
                                  int t, int elem_bytes, void* stream) {
  if (c <= 0 || w <= 0 || t <= 0 || (elem_bytes != 4 && elem_bytes != 2) ||
      (c + kLaneChannels - 1) / kLaneChannels > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((t + kThreads - 1) / kThreads, (c + kLaneChannels - 1) / kLaneChannels);
  if (elem_bytes == 4) {
    window_lanes_kernel<uint32_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(win), static_cast<const int*>(idx),
        static_cast<uint32_t*>(out), c, w, t);
  } else {
    window_lanes_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint16_t*>(win), static_cast<const int*>(idx),
        static_cast<uint16_t*>(out), c, w, t);
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

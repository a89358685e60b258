// LG: the windowed async copy, with one 1-D TMA bulk copy per block.
//
//   out[t * tile + i, :] = feats[ws[t] + i, :]   for i < tile
//   (a row outside [0, n) reads as zero)
//
// Replaces benchmarks/micro/micro_bisect.py:46 t1_dma (P4): the TPU DMAs a
// window of WIN rows at ws[t] into VMEM and keeps its first TILE rows (at
// N 65,536, TILE 512, WIN 2048, ws[t] = min(512 t, N - 2048), so tiles t >=
// 124 all copy feats[63488:64000]).  Only the kept rows matter here: a
// 2048-row bf16 window of 96 channels (384 KB) does not fit a block's
// shared memory, its 512 kept rows (96 KB) do.
//
// Design: block (j, t) copies rows [j * chunk, j * chunk + chunk) of tile t
// (chunk rows within 96 KB: the whole 512-row tile in bf16 at 96
// channels, half of it in f32), so two blocks fit an SM.  One thread
// arms an mbarrier with the chunk's byte count and issues
// cp.async.bulk.shared::cluster.global for the rows that lie inside feats
// (the rows are contiguous bytes, 16-byte aligned); every thread waits on
// the barrier, then the block stores the chunk to out in 16-byte vectors,
// zeros where the source row lies outside feats.
//
// Bound on an H100: bytes (the kept rows read once, out written once:
// 25 MB at the probe's shape, 7.5 us at 3.35 TB/s).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kChunkBytes = 96 * 1024;
constexpr int kThreads = 256;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool barrier_done(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__global__ void window_copy_kernel(const uint8_t* __restrict__ feats, const int* __restrict__ ws,
                                   uint8_t* __restrict__ out, int n, int tile, int row_bytes,
                                   int chunk) {
  extern __shared__ __align__(128) uint4 buf[];
  __shared__ __align__(8) uint64_t bar;
  const int t = blockIdx.y;
  const int r0 = blockIdx.x * chunk;
  const int rows = min(chunk, tile - r0);
  const long long start = (long long)ws[t] + r0;
  const long long lo = max(start, 0LL);
  const long long hi = min(start + rows, (long long)n);
  const int have = hi > lo ? (int)(hi - lo) : 0;
  const int skip = have ? (int)(lo - start) : 0;
  const unsigned b = smem_addr(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (have) {
      const unsigned bytes = (unsigned)have * (unsigned)row_bytes;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(buf)),
          "l"(feats + lo * row_bytes), "r"(bytes), "r"(b)
          : "memory");
    } else {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(b) : "memory");
    }
  }
  while (!barrier_done(b, 0)) {
  }
  const int v_row = row_bytes / 16;
  uint4* dst = reinterpret_cast<uint4*>(out + ((size_t)t * tile + r0) * row_bytes);
  for (int i = threadIdx.x; i < rows * v_row; i += blockDim.x) {
    const int k = i / v_row - skip;
    dst[i] = (k >= 0 && k < have) ? buf[(size_t)k * v_row + i % v_row] : make_uint4(0u, 0u, 0u, 0u);
  }
}

}  // namespace

// feats [n, row_bytes] (any dtype; row_bytes a multiple of 16 and at most
// 96 KB), ws [tiles] int32, out [tiles * tile, row_bytes].  Returns a
// cudaError_t (0 = launched).
extern "C" int window_copy(const void* feats, const void* ws, void* out, int n, int tiles,
                           int tile, int row_bytes, void* stream) {
  if (n <= 0 || tiles <= 0 || tiles > 65535 || tile <= 0 || row_bytes <= 0 ||
      row_bytes % 16 || row_bytes > kChunkBytes)
    return (int)cudaErrorInvalidValue;
  const int chunk = std::min(tile, kChunkBytes / row_bytes);
  const size_t smem = (size_t)chunk * row_bytes;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute((const void*)window_copy_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_copy_kernel<<<dim3((tile + chunk - 1) / chunk, tiles), kThreads, smem,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(feats), static_cast<const int*>(ws),
      static_cast<uint8_t*>(out), n, tile, row_bytes, chunk);
  return (int)cudaGetLastError();
}

// LD: the serving path's per-point labels (K15), one launch.
//
// Replaces lidog_tpu/serve.py:92-105 (the port's Predictor.labels_of
// plain version): argmax of the logits on level-0 real rows, through the
// plan's input-row -> level-0 row map `pos`, and on the sorted path
// through the voxelizer's point -> voxel map `inverse`:
//
//   row = pos[inverse[p]] (sorted) or pos[p] (sortless)
//   out[p] = argmax_c logits[row, c]  if every step hits and real[row], else -1
//
// The argmax takes the first maximum (and the first NaN, which compares
// above every number), as torch.argmax does.  One thread per point; the
// chain's gathers and one C-wide row read are all it does.
//
// Bound on an H100: bytes (inverse and out per point, pos per voxel, one
// logits row per labelled voxel; 0.001 ms for 100k points), far below a
// launch: the kernel is bound by its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void label_gather_kernel(const T* __restrict__ logits, const uint8_t* __restrict__ real,
                                    const int* __restrict__ pos, const int* __restrict__ inverse,
                                    int* __restrict__ out, int n_rows, int c, int n_in,
                                    int n_out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_out) return;
  int label = -1;
  const int v = inverse == nullptr ? p : inverse[p];
  if (v >= 0 && v < n_in) {
    const int row = pos[v];
    if (row >= 0 && row < n_rows && real[row]) {
      const T* lg = logits + (size_t)row * c;
      float best = as_float(lg[0]);
      label = 0;
      for (int j = 1; j < c; ++j) {
        const float x = as_float(lg[j]);
        if (best == best && (x > best || x != x)) {
          best = x;
          label = j;
        }
      }
    }
  }
  out[p] = label;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; inverse null on the sortless path
// (n_out == n_in).  Returns a cudaError_t (0 = launched).
extern "C" int label_gather(const void* logits, const void* real, const void* pos,
                            const void* inverse, void* out, int n_rows, int c, int n_in,
                            int n_out, int dtype, void* stream) {
  if (n_out <= 0 || c <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int threads = 256, blocks = (n_out + threads - 1) / threads;
  const uint8_t* r = static_cast<const uint8_t*>(real);
  const int* ps = static_cast<const int*>(pos);
  const int* inv = static_cast<const int*>(inverse);
  int* o = static_cast<int*>(out);
  if (dtype == 1)
    label_gather_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), r, ps, inv, o, n_rows, c, n_in, n_out);
  else
    label_gather_kernel<float><<<blocks, threads, 0, st>>>(static_cast<const float*>(logits), r,
                                                           ps, inv, o, n_rows, c, n_in, n_out);
  return (int)cudaGetLastError();
}

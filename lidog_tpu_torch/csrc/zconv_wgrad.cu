// KF: weight gradients of the strided sparse convs (zconv_down, zconv_up);
// zconv3's form has its own kernel, zconv3_wgrad.cu.
//
// Replaces the dW halves of lidog_tpu/ops/zconv.py _onehot_dw:455 as used
// by _zdown_bwd:505 and _zup_bwd:561 (dW[o] = A^T @ (G masked to off ==
// o)):
//
//   dW[k] = sum over rows r of A_k(r)^T (outer) G_k(r)      [K, Cin, Cout]
//
//   down   (K = 8):  A = x[r], G = dout[parent[r]], only where off[r] == k
//   up     (K = 8):  A = x[parent[r]], G = dout[r], only where off[r] == k
//
// with dout read through the forward's output mask.  The output is in the
// JAX layout, summed in f32 and rounded once to the weight's dtype, as JAX
// does (preferred_element_type=f32, then astype).
//
// Bound on an H100: bytes at the main path's widths (every row of x and
// dout is read, K x Cin x Cout is small), operations only where Cin and
// Cout are both >= 256.
//
// Design: the two-pass deterministic reduction of wgrad.cuh, with one Map
// policy per conv below.
#include "wgrad.cuh"

namespace {
using namespace lidog;

struct DownWMap {  // rows: fine; A = fine x, G = coarse dout
  static constexpr int K = 8;
  const int* parent;
  const int* off;
  __device__ int a_src(int k, int r) const { return off[r] == k ? r : -1; }
  __device__ int g_src(int k, int r) const { return off[r] == k ? parent[r] : -1; }
};

struct UpWMap {  // rows: fine; A = coarse x, G = fine dout
  static constexpr int K = 8;
  const int* parent;
  const int* off;
  __device__ int a_src(int k, int r) const { return off[r] == k ? parent[r] : -1; }
  __device__ int g_src(int k, int r) const { return off[r] == k ? r : -1; }
};
}  // namespace

extern "C" int zconv_down_wgrad(const void* x, const void* dout, const void* parent,
                                const void* off, const void* dout_mask, void* partial, void* dw,
                                int n_fine, int n_coarse, int cin, int cout, int chunks, int rpc,
                                int dtype, void* stream) {
  DownWMap map{static_cast<const int*>(parent), static_cast<const int*>(off)};
  return launch_wgrad(x, dout, dout_mask, partial, dw, map, n_fine, n_coarse, n_fine, chunks, rpc,
                      cin, cout, dtype, stream);
}

extern "C" int zconv_up_wgrad(const void* x, const void* dout, const void* parent,
                              const void* off, const void* dout_mask, void* partial, void* dw,
                              int n_coarse, int n_fine, int cin, int cout, int chunks, int rpc,
                              int dtype, void* stream) {
  UpWMap map{static_cast<const int*>(parent), static_cast<const int*>(off)};
  return launch_wgrad(x, dout, dout_mask, partial, dw, map, n_coarse, n_fine, n_fine, chunks, rpc,
                      cin, cout, dtype, stream);
}

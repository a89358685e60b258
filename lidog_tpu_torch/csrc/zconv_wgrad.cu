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
// Design: the one-hot weight gradient of wgrad.cuh (one pass over the
// fine rows: each row gathered once per dW tile and added only to its own
// offset's sums, by the warp of that offset), with one Map policy per conv
// below, and the deterministic two-pass sum.
#include "wgrad.cuh"

namespace {
using namespace lidog;

struct DownWMap {  // rows: fine; A = fine x, G = coarse dout
  static constexpr int K = 8;
  const int* parent;
  const int* off;
  __device__ int pick(int r, int& a, int& g) const {
    a = r;
    g = parent[r];
    return off[r];
  }
};

struct UpWMap {  // rows: fine; A = coarse x, G = fine dout
  static constexpr int K = 8;
  const int* parent;
  const int* off;
  __device__ int pick(int r, int& a, int& g) const {
    a = parent[r];
    g = r;
    return off[r];
  }
};
}  // namespace

extern "C" int zconv_down_wgrad(const void* x, const void* dout, const void* parent,
                                const void* off, const void* dout_mask, void* partial, void* dw,
                                int n_fine, int n_coarse, int cin, int cout, int chunks, int rpc,
                                int dtype, void* stream) {
  DownWMap map{static_cast<const int*>(parent), static_cast<const int*>(off)};
  return launch_onehot_wgrad(x, dout, dout_mask, partial, dw, map, n_fine, n_coarse, n_fine,
                             chunks, rpc, cin, cout, dtype, stream);
}

extern "C" int zconv_up_wgrad(const void* x, const void* dout, const void* parent,
                              const void* off, const void* dout_mask, void* partial, void* dw,
                              int n_coarse, int n_fine, int cin, int cout, int chunks, int rpc,
                              int dtype, void* stream) {
  UpWMap map{static_cast<const int*>(parent), static_cast<const int*>(off)};
  return launch_onehot_wgrad(x, dout, dout_mask, partial, dw, map, n_coarse, n_fine, n_fine,
                             chunks, rpc, cin, cout, dtype, stream);
}

// KF: weight gradients of the three sparse convs (zconv3, zconv_down,
// zconv_up).
//
// Replaces the dW halves of lidog_tpu/ops/zconv.py: _zconv3_bwd:268-273
// (dW[8-e] = zcat(x)^T @ gather(dout, nbr9[e])) and _onehot_dw:455 as used
// by _zdown_bwd:505 and _zup_bwd:561 (dW[o] = A^T @ (G masked to off == o)).
// One form covers all three:
//
//   dW[k] = sum over rows r of A_k(r)^T (outer) G_k(r)      [K, Cin, Cout]
//
//   zconv3 (K = 27, k = 3*o + t):  A = x[r-1]*zdn[r] | x[r] | x[r+1]*zup[r]
//                                  (z tap t), G = dout[nbr9[8-o, r]]
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

struct Conv3WMap {
  static constexpr int K = 27;
  const int* nbr9;  // [9, na]
  const uint8_t* zup;
  const uint8_t* zdn;
  int na;
  __device__ int a_src(int k, int r) const {
    const int t = k % 3;
    if (t == 0) return zdn[r] ? r - 1 : -1;
    if (t == 2) return zup[r] ? r + 1 : -1;
    return r;
  }
  __device__ int g_src(int k, int r) const {
    const int e = 8 - k / 3;
    return (e == 4) ? r : nbr9[(size_t)e * na + r];
  }
};

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

extern "C" int zconv3_wgrad(const void* x, const void* dout, const void* nbr9, const void* zup,
                            const void* zdn, const void* dout_mask, void* partial, void* dw,
                            int na, int cin, int cout, int chunks, int rpc, int dtype,
                            void* stream) {
  Conv3WMap map{static_cast<const int*>(nbr9), static_cast<const uint8_t*>(zup),
                static_cast<const uint8_t*>(zdn), na};
  return launch_wgrad(x, dout, dout_mask, partial, dw, map, na, na, na, chunks, rpc, cin, cout,
                      dtype, stream);
}

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

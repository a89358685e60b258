// LA, LB: the generic sparse conv (K21), gather-GEMM over [K, N] kernel maps.
//
// Replaces lidog_tpu/ops/sparse_conv.py:78-191: the custom-VJP `_conv_core`
// forward (`_gemm_scan`) and `_conv_core_bwd`, which every conv of
// MinkUNet34 on the generic UNetPlan runs (k=3: K = 27; k=2 s=2 down and
// transposed up: K = 8).  Also the op of the Pallas prototypes
// benchmarks/micro/micro_gather.py:246 (q3_windowed_vs_xla) and
// micro_gather2.py:93,198 (27-tap windowed gather-GEMM).
//
// LA sparse_conv_fwd:
//   out[i] = m[i] * sum_{k < K} x[nbr[k, i]] @ w[k]          (-1: zero row)
// summed in f32 and rounded once to x's type, as JAX's f32 accumulation of
// every offset group followed by one astype.  The same kernel computes
// dIn over the transpose map (x the cotangent read through src_mask = the
// forward's output mask, w the transposed weights W[::-1]^T of a
// symmetric map or W^T of the down <-> up partner map, m null).
//
// LB sparse_conv_wgrad:
//   dW[k] = sum_r x[r]^T dout[T[k, r]]     T[k] = tmap[K-1-k] (reverse) or tmap[k]
// lidog_tpu's dW[K-1-k'] = x^T @ gather(dout, nbr_t_rev[k']) with the offset
// reversal folded into the index: for a symmetric map tmap is the forward
// map itself and reverse = 1; for the down <-> up pair tmap is the partner
// map, whose reversal the JAX version pre-applies and then undoes.  f32,
// rounded once to the weight's type; deterministic (two passes, no float
// atomics).
//
// Bound on an H100: at the main path's widths the gathered rows are bytes
// (every map entry reads one 64-1024 byte row), and the MMAs (2 K N Cin
// Cout) operations; at 96-256 channels the bf16 products sit far below the
// 989 TFLOP/s peak's reach of those bytes, so both kernels are bound by
// the bytes they gather and by each K stage's serial work.  Design: the
// shared gather-GEMM (gather_gemm.cuh: all of Cout up to 128 a block, each
// row's sources resolved once, one K loop over (live offset, Cin chunk)
// through a cp.async ring, mma.sync) and the grouped weight gradient
// (wgrad.cuh: a block serves 9 of the 27 offsets, or all 8, with one warp
// each, so an x row is read once per group and dW tile).  The stem's K =
// 125 and narrow widths go through KO/KP (zconv_full.cu).
#include "gather_gemm.cuh"
#include "wgrad.cuh"

namespace {
using namespace lidog;

template <int K>
struct NbrMap {
  static constexpr int NOFF = K;
  static constexpr bool ONEHOT = false;
  const int* nbr;  // [K, n_out]
  int n_out;
  __device__ int src(int o, int row) const { return nbr[(size_t)o * n_out + row]; }
};

template <int KK>
struct TransposeWMap {  // rows: the conv's input rows; A = x[r], G = dout
  static constexpr int K = KK;
  const int* tmap;  // [K, n_in] rows of dout
  int n_in;
  int reverse;
  __device__ int g_src(int k, int r) const {
    return tmap[(size_t)(reverse ? K - 1 - k : k) * n_in + r];
  }
};
}  // namespace

extern "C" int sparse_conv_fwd(const void* x, const void* nbr, const void* w, const void* mask,
                               const void* src_mask, void* out, int n_in, int n_out, int k,
                               int cin, int cout, int dtype, void* stream) {
  const int* m = static_cast<const int*>(nbr);
  if (k == 27)
    return launch_gather_gemm(x, w, mask, src_mask, out, NbrMap<27>{m, n_out}, n_in, n_out, cin,
                              cout, dtype, stream);
  if (k == 8)
    return launch_gather_gemm(x, w, mask, src_mask, out, NbrMap<8>{m, n_out}, n_in, n_out, cin,
                              cout, dtype, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int sparse_conv_wgrad(const void* x, const void* dout, const void* tmap,
                                 const void* dout_mask, void* partial, void* dw, int n_in,
                                 int n_out, int k, int reverse, int cin, int cout, int chunks,
                                 int rpc, int dtype, void* stream) {
  const int* t = static_cast<const int*>(tmap);
  if (k == 27)
    return launch_group_wgrad(x, dout, dout_mask, partial, dw, TransposeWMap<27>{t, n_in, reverse},
                              n_in, n_out, n_in, chunks, rpc, cin, cout, dtype, stream);
  if (k == 8)
    return launch_group_wgrad(x, dout, dout_mask, partial, dw, TransposeWMap<8>{t, n_in, reverse},
                              n_in, n_out, n_in, chunks, rpc, cin, cout, dtype, stream);
  return (int)cudaErrorInvalidValue;
}

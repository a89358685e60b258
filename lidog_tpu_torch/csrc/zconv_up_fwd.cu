// KC: forward of the transposed k=2 s=2 sparse conv (zconv_up).
//
// Replaces lidog_tpu/ops/zconv.py:548-553 (_zup_core forward, the
// one-hot per-row weight select of _onehot_matmuls:437).
//
//   out[j] = m[j] * x[parent[j]] @ w8[off[j]]     (0 where parent < 0)
//
// Per-row weight select through the shared gather-GEMM's one-hot map
// (gather_gemm.cuh): a block sorts its rows by offset, gathers each row's
// parent once, in the stages of its own offset, and multiplies it once, by
// w8[off]; the other offsets' rows of the fragments a segment touches are
// zero-filled.  Each row's product is summed in f32 and rounded once,
// which equals the JAX version's rounding of the selected product.
//
// Bound on an H100: bytes (x rows gathered once each per child, the fine
// output written once); the weight slabs of the 8 offsets, read by every
// block from L2, are the largest copy of a stage at narrow widths.
//
// The backward of zconv_down launches this kernel too (lidog_tpu/ops/
// zconv.py:505-516, `_onehot_matmuls(dout[parent], off, W, transpose=True)`):
// x is then the coarse cotangent, w8 the transposed weights, src_mask the
// coarse output mask and mask null (dx is not masked).
#include "gather_gemm.cuh"

namespace {
struct UpMap {
  static constexpr int NOFF = 8;
  static constexpr bool ONEHOT = true;
  const int* parent;  // [n_out]
  const int* off;     // [n_out]
  __device__ int pick(int row, int& s) const {
    s = parent[row];
    return off[row];
  }
};
}  // namespace

extern "C" int zconv_up_fwd(const void* x, const void* parent, const void* off, const void* w8,
                            const void* mask, const void* src_mask, void* out, int n_in,
                            int n_out, int cin, int cout, int dtype, void* stream) {
  UpMap map{static_cast<const int*>(parent), static_cast<const int*>(off)};
  return lidog::launch_gather_gemm(x, w8, mask, src_mask, out, map, n_in, n_out, cin, cout, dtype,
                                   stream);
}

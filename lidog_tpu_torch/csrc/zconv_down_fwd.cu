// KB: forward of the k=2 s=2 strided sparse conv (zconv_down).
//
// Replaces lidog_tpu/ops/zconv.py:466-497 (_down_loop / _zdown_core
// forward).
//
//   out[I] = m[I] * sum_{k < 8} x[nbr8[k, I]] @ w8[k]
//
// x is the fine level [n_in, cin], out the coarse level [n_out, cout]; a -1
// map entry is a zero row.  The shared gather-GEMM (gather_gemm.cuh) with
// eight gathering offsets; f32 accumulation, one rounding, as in JAX.
//
// Bound on an H100: bytes (each fine row is read once, by its parent, and
// each coarse row written once).  A coarse row has 1-2 of its 8 children
// on the main path's levels, so the products of the 8 offsets over a
// tile's rows are ~5x the live ones; a warp skips an offset only when
// none of its 32 rows has that child.
//
// The backward of zconv_up launches this kernel too (lidog_tpu/ops/
// zconv.py:561-568, `_down_loop(dout, nbr8, W^T)`): x is then the fine
// cotangent, w8 the transposed weights, src_mask the fine output mask and
// mask null (dx is not masked).
#include "gather_gemm.cuh"

namespace {
struct DownMap {
  static constexpr int NOFF = 8;
  static constexpr bool ONEHOT = false;
  const int* nbr8;  // [8, n_out]
  int n_out;
  __device__ int src(int o, int row) const { return nbr8[(size_t)o * n_out + row]; }
};
}  // namespace

extern "C" int zconv_down_fwd(const void* x, const void* nbr8, const void* w8, const void* mask,
                              const void* src_mask, void* out, int n_in, int n_out, int cin,
                              int cout, int dtype, void* stream) {
  DownMap map{static_cast<const int*>(nbr8), n_out};
  return lidog::launch_gather_gemm(x, w8, mask, src_mask, out, map, n_in, n_out, cin, cout, dtype,
                                   stream);
}

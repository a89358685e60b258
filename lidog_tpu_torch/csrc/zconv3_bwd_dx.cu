// KE: input gradient of the k=3 column-fused sparse conv (zconv3).
//
// Replaces the dx half of lidog_tpu/ops/zconv.py:231-274 (_zconv3_bwd):
// there dxc = sum_e gather(dout, nbr9[e]) @ wf[8-e]^T is formed as a
// [Na, 3*Cin] intermediate and folded onto x rows by _zcat_t:116.  Here the
// fold is done gather-first, so neither the [8, Na, Cout] stack of gathered
// rows nor dxc is written:
//
//   dx[j] = sum_{e < 9} (  dout[nbr9[e, j]]     @ wf[8-e][1]^T
//                        + zdn[j+1] dout[nbr9[e, j+1]] @ wf[8-e][0]^T
//                        + zup[j-1] dout[nbr9[e, j-1]] @ wf[8-e][2]^T )
//
// (wf[d][t] is the Cin x Cout block of z tap t = z-1, z, z+1; nbr9[4, j] is
// row j itself.)  The 3x3 xy offset set is symmetric, so offset e's gather
// is the transpose of offset 8-e's, as in JAX.  dout is read through the
// forward's output mask (src_mask) and dx is not masked, as in JAX.
//
// Bound on an H100: like KA, the gathered rows of dout and the weight
// reads (bytes); its MMAs are far below the tensor cores' reach at these
// widths.  Design: the shared gather-GEMM (gather_gemm.cuh) with a Map
// policy of 9 xy offsets x 3 z taps over the pre-transposed weights
// wt[e][t] = wf[8-e][t]^T ([9, 3, Cout, Cin]); each (offset, tap) pair is
// one gathered operand, all 27 summed in f32 and rounded once.  JAX rounds
// dxc to the compute dtype before the fold, so in bf16 the two differ by
// about one rounding.
#include "gather_gemm.cuh"

namespace {
struct Conv3DxMap {
  static constexpr int NOFF = 9;
  static constexpr int NTAPS = 3;
  const int* nbr9;  // [9, na]
  const uint8_t* zup;
  const uint8_t* zdn;
  int na;
  __device__ int src(int e, int t, int j) const {
    int r = j;
    if (t == 0) {  // dprev[j+1] lands on row j when row j+1's z-1 is row j
      r = j + 1;
      if (r >= na || !zdn[r]) return -1;
    } else if (t == 2) {  // dnext[j-1] lands on row j
      r = j - 1;
      if (r < 0 || !zup[r]) return -1;
    }
    return (e == 4) ? r : nbr9[(size_t)e * na + r];
  }
};
}  // namespace

extern "C" int zconv3_bwd_dx(const void* dout, const void* nbr9, const void* zup,
                             const void* zdn, const void* wt, const void* dout_mask, void* dx,
                             int na, int cout, int cin, int dtype, void* stream) {
  Conv3DxMap map{static_cast<const int*>(nbr9), static_cast<const uint8_t*>(zup),
                 static_cast<const uint8_t*>(zdn), na};
  return lidog::launch_gather_gemm(dout, wt, nullptr, dout_mask, dx, map, na, na, cout, cin,
                                   dtype, stream);
}

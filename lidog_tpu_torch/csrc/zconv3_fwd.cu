// KA: forward of the k=3 column-fused sparse conv (zconv3).
//
// Replaces lidog_tpu/ops/zconv.py:180-223 (_zconv3_core forward) and the
// Pallas prototype benchmarks/micro/micro_windowconv.py:113 (make_windowed),
// which compute the same op.
//
//   out[i] = m[i] * sum_{d < 9} zcat(x)[nbr9[d, i]] @ wf[d]
//   zcat(x)[j] = [x[j-1] * zdn[j], x[j], x[j+1] * zup[j]]
//
// nbr9[4, i] is row i itself (the centre xy offset), and a -1 entry is a
// zero row.  Gather-first: each (xy offset, z tap) pair is one gathered
// operand of the shared gather-GEMM (gather_gemm.cuh), so the 27 taps cost
// 27 row gathers of x and no [9, Na, Cout] intermediate.  The JAX version
// rounds each per-offset projection to the compute dtype before its f32
// sum; this kernel keeps the whole sum in f32.
#include "gather_gemm.cuh"

namespace {
struct Conv3Map {
  static constexpr int NOFF = 9;
  static constexpr int NTAPS = 3;
  const int* nbr9;  // [9, na]
  const uint8_t* zup;
  const uint8_t* zdn;
  int na;
  __device__ int src(int o, int t, int row) const {
    const int n = (o == 4) ? row : nbr9[(size_t)o * na + row];
    if (n < 0) return -1;
    if (t == 0) return zdn[n] ? n - 1 : -1;
    if (t == 2) return zup[n] ? n + 1 : -1;
    return n;
  }
};
}  // namespace

extern "C" int zconv3_fwd(const void* x, const void* nbr9, const void* zup, const void* zdn,
                          const void* wf, const void* mask, void* out, int na, int cin,
                          int cout, int dtype, void* stream) {
  Conv3Map map{static_cast<const int*>(nbr9), static_cast<const uint8_t*>(zup),
               static_cast<const uint8_t*>(zdn), na};
  return lidog::launch_gather_gemm(x, wf, mask, nullptr, out, map, na, na, cin, cout, dtype,
                                   stream);
}

// KE: input gradient of the k=3 column-fused sparse conv (zconv3).
//
// Replaces the dx half of lidog_tpu/ops/zconv.py:231-274 (_zconv3_bwd):
// there dxc = sum_e gather(dout, nbr9[e]) @ wf[8-e]^T is formed as a
// [Na, 3*Cin] intermediate and folded onto x rows by _zcat_t:116.  Here the
// fold is done gather-first, so neither the [8, Na, Cout] stack of gathered
// rows nor dxc is written:
//
//   dx[j] = sum_{e < 9} (  G_e(j) @ wt[e][1]
//                        + zdn[j+1] G_e(j+1) @ wt[e][0]
//                        + zup[j-1] G_e(j-1) @ wt[e][2] )
//   G_e(r) = d(s), s = (e == 4 ? r : nbr9[e, r]),  d(s) = dout[s] * dout_mask[s]
//
// (wt[e][t] = wf[8-e][t]^T, [Cout, Cin], the Cin x Cout block of z tap t =
// z-1, z, z+1 transposed; rows r and sources s outside [0, Na) are zero.)
// The 3x3 xy offset set is symmetric, so offset e's gather is the
// transpose of offset 8-e's, as in JAX.  dout is read through the
// forward's output mask and dx is not masked, as in JAX.  JAX rounds dxc
// to the compute dtype before the fold; this kernel sums all in f32 and
// rounds once, so in bf16 the two differ by about one rounding.
//
// Bound on an H100: like KA, bytes (dout, the maps, the weights and dx
// once); the products are below the tensor cores' reach of those bytes.
// As in KA, the time goes to each stage's serial work, not to the gather
// of dout rows (an ablation that dropped every copy kept the time).
//
// Design (zconv3_mma.cuh has the shared pieces).  A block owns BM output
// rows j = m0 .. m0 + BM - 1 (128, or 64 on small levels) and BN columns,
// all of Cin up to 128 (Cin 192 to 384: two or three column tiles).  The
// three taps of offset e read G_e at rows j + 1, j and j - 1, so for each
// e the block gathers the BM + 2 rows G_e(m0 - 1 .. m0 + BM) once, and
// the taps read that tile at three row shifts: ldmatrix takes one row
// address per lane, so a shift costs nothing.  The z masks zdn[j+1] (tap
// 0) and zup[j-1] (tap 2), with the level's ends, are ANDed into the A
// fragments of each output row.  The block first resolves the 9 x (BM +
// 2) sources (-1 where the map misses or the dout mask is 0: a
// zero-filled row, no read) into shared memory and skips the offsets with
// no source.  The rest is one K loop over (live offset e, chunk of Cout:
// 32 elements in bf16, 8 in f32; the last one may be short): the chunk of
// the gathered rows (16-byte cp.async pieces) and of the three weight
// slabs wt[e][t], through a cp.async ring (bf16: 3 stages, 2 at BN 128;
// f32: 4), three MMAs (one per tap) per k16 step; a warp (bf16) or
// thread (f32) whose rows have no source for an offset skips its
// products.  bf16: mma.sync m16n8k16 from ldmatrix fragments, f32 sums in
// registers; f32: a register tile of FMAs whose taps share each thread's
// 10 A rows (the z masks predicate the FMAs of a row's tap).
#include "zconv3_mma.cuh"

namespace {

// the ring: K elements a stage and stages (bf16: 2 stages at BN 128, for
// more blocks an SM; f32: 16 elements in 3 stages at BN <= 64)
constexpr int kBKBf16 = 32, kStagesBf16 = 3, kStagesWide = 2, kBKF32 = 8, kStagesF32 = 4,
              kBKF32Narrow = 16, kStagesF32Narrow = 3;

template <typename T, int BN, int BM>
struct Dx {
  static constexpr int NT = 2 * BM, EPV = z3::kEPV<T>, ROWS = BM + 2;
  static constexpr int BK = z3::kBf16<T> ? kBKBf16 : BN <= 64 ? kBKF32Narrow : kBKF32;
  static constexpr int STAGES = z3::kBf16<T> ? (BN == 128 ? kStagesWide : kStagesBf16)
                                             : BN <= 64 ? kStagesF32Narrow : kStagesF32;
  static constexpr int AP = BK + EPV, BP = BN + EPV;
  static constexpr int A_EL = ROWS * AP, B_EL = 3 * BK * BP;
  static constexpr size_t SMEM =
      (size_t)STAGES * (A_EL + B_EL) * sizeof(T) + 9 * ROWS * 4 + BM;
};

template <typename T, int BN, int BM>
__global__ void __launch_bounds__(2 * BM, 256 / BM)
zconv3_bwd_dx_kernel(const T* __restrict__ dout, const int* __restrict__ nbr9,
                     const uint8_t* __restrict__ zup, const uint8_t* __restrict__ zdn,
                     const T* __restrict__ wt, const uint8_t* __restrict__ dmask,
                     T* __restrict__ dx, int na, int cout, int cin) {
  using F = Dx<T, BN, BM>;
  constexpr int NT = F::NT, ROWS = F::ROWS, EPV = F::EPV, BK = F::BK, AP = F::AP, BP = F::BP,
                STAGES = F::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [STAGES][ROWS][AP]
  T* Bs = As + STAGES * F::A_EL;       // [STAGES][3][BK][BP]
  int* tab = reinterpret_cast<int*>(Bs + STAGES * F::B_EL);  // [9][ROWS] sources
  uint8_t* zm = reinterpret_cast<uint8_t*>(tab + 9 * ROWS);  // [BM] bit 0: tap 0, bit 2: tap 2
  __shared__ unsigned s_live;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (tid == 0) s_live = 0;
  __syncthreads();
  // G_e rows w = 0 .. BM + 1 are level rows r = m0 - 1 + w
  unsigned live = 0;
  for (int v = tid; v < 9 * ROWS; v += NT) {
    const int e = v / ROWS, r = m0 - 1 + (v - e * ROWS);
    int s = -1;
    if (r >= 0 && r < na) {
      s = e == 4 ? r : nbr9[(size_t)e * na + r];
      if (s < 0 || s >= na || (dmask != nullptr && !dmask[s])) s = -1;
    }
    tab[v] = s;
    if (s >= 0) live |= 1u << e;
  }
  for (int i = tid; i < BM; i += NT) {
    const int j = m0 + i;
    zm[i] = (j + 1 < na && zdn[j + 1] ? 1 : 0) | (j >= 1 && j - 1 < na && zup[j - 1] ? 4 : 0);
  }
  live = __reduce_or_sync(0xffffffffu, live);
  if ((tid & 31) == 0 && live) atomicOr(&s_live, live);
  __syncthreads();
  live = s_live;
  const int kcn = (cout + BK - 1) / BK;  // K chunks per offset (the last may be short)
  const int nq = __popc(live) * kcn;
  auto offset = [&](int q) {  // the xy offset of stage q
    unsigned m = live;
    for (int j = q / kcn; j > 0; --j) m &= m - 1;
    return __ffs(m) - 1;
  };
  // bit e: some tile row of w0 .. w0 + n - 1 has a source at offset e
  auto rows_live = [&](int w0, int n) {
    unsigned bits = 0;
    for (int w = w0; w < w0 + n; ++w)
#pragma unroll
      for (int e = 0; e < 9; ++e) bits |= (tab[e * ROWS + w] >= 0 ? 1u : 0u) << e;
    return bits;
  };

  auto issue = [&](int q) {
    if (q >= nq) return;
    const int e = offset(q), k0 = (q % kcn) * BK;
    T* A = As + (q % STAGES) * F::A_EL;
    const int* te = tab + e * ROWS;
    for (int v = tid; v < ROWS * (BK / EPV); v += NT) {
      const int w = v / (BK / EPV), pc = v % (BK / EPV), k = k0 + pc * EPV;
      const bool ok = te[w] >= 0 && k < cout;
      z3::cp16(A + w * AP + pc * EPV, ok ? dout + (size_t)te[w] * cout + k : dout, ok ? 16 : 0);
    }
    T* B = Bs + (q % STAGES) * F::B_EL;
    const T* wk = wt + (size_t)e * 3 * cout * cin + n0;
    for (int v = tid; v < 3 * BK * (BN / EPV); v += NT) {
      const int tr = v / (BN / EPV), pc = v % (BN / EPV);  // tr = t * BK + r
      const int t = tr / BK, k = k0 + tr - t * BK;
      z3::cp16(B + tr * BP + pc * EPV,
               wk + ((size_t)t * cout + (k < cout ? k : 0)) * cin + pc * EPV, k < cout ? 16 : 0);
    }
  };

  for (int s = 0; s < STAGES - 1; ++s) {
    issue(s);
    z3::cp_commit();
  }
  if constexpr (z3::kBf16<T>) {
    const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1, lane = tid & 31, g = lane >> 2;
    // the warp's 34 tile rows wm * 32 .. wm * 32 + 33
    const unsigned wlive = __reduce_or_sync(
        0xffffffffu, rows_live(wm * 32 + lane, 1) | (lane < 2 ? rows_live(wm * 32 + 32 + lane, 1)
                                                              : 0u));
    // the z masks of this lane's rows (g and g + 8 of each m16 fragment)
    unsigned lo0[2], hi0[2], lo2[2], hi2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int a = zm[wm * 32 + i * 16 + g], b = zm[wm * 32 + i * 16 + g + 8];
      lo0[i] = a & 1 ? ~0u : 0u;
      hi0[i] = b & 1 ? ~0u : 0u;
      lo2[i] = a & 4 ? ~0u : 0u;
      hi2[i] = b & 4 ? ~0u : 0u;
    }
    z3::TileBf16<BN> acc;
    acc.zero();
    for (int q = 0; q < nq; ++q) {
      z3::cp_wait<STAGES - 2>();
      __syncthreads();  // stage q landed for every thread; stage q - 1 is free
      issue(q + STAGES - 1);
      z3::cp_commit();
      if (!((wlive >> offset(q)) & 1)) continue;
      // output row i reads tile row i + 2 - t for tap t
      const T* A = As + (q % STAGES) * F::A_EL + wm * 32 * AP;
      const T* B = Bs + (q % STAGES) * F::B_EL + wn * (BN / 2);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        acc.template k16<true>(A + 2 * AP + kk, AP, B + kk * BP, BP, lo0, hi0);
        acc.template k16<false>(A + AP + kk, AP, B + (BK + kk) * BP, BP, nullptr, nullptr);
        acc.template k16<true>(A + kk, AP, B + (2 * BK + kk) * BP, BP, lo2, hi2);
      }
    }
    acc.store([&](int r, int col, float v0, float v1) {
      const int row = m0 + wm * 32 + r;
      if (row < na)
        *reinterpret_cast<__nv_bfloat162*>(dx + (size_t)row * cin + n0 + wn * (BN / 2) + col) =
            __floats2bfloat162_rn(v0, v1);
    });
  } else {
    const int ty = tid >> 4, tx = tid & 15;
    const unsigned tlive = rows_live(ty * 8, 10);
    unsigned ok0 = 0, ok2 = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ok0 |= (zm[ty * 8 + i] & 1u) << i;
      ok2 |= ((zm[ty * 8 + i] >> 2) & 1u) << i;
    }
    z3::TileF32<BN> acc;
    acc.zero();
    for (int q = 0; q < nq; ++q) {
      z3::cp_wait<STAGES - 2>();
      __syncthreads();
      issue(q + STAGES - 1);
      z3::cp_commit();
      if (!((tlive >> offset(q)) & 1)) continue;
      const float* A = reinterpret_cast<const float*>(As + (q % STAGES) * F::A_EL) + ty * 8 * AP;
      const float* B = reinterpret_cast<const float*>(Bs + (q % STAGES) * F::B_EL) + 2 * tx;
#pragma unroll
      for (int k = 0; k < BK; k += 2)
        acc.template step<3>(A + k, AP, B + k * BP, BK * BP, BP, ok0, ok2);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + ty * 8 + i;
      if (row >= na) continue;
#pragma unroll
      for (int p = 0; p < BN / 32; ++p)
        *reinterpret_cast<float2*>(dx + (size_t)row * cin + n0 + 2 * tx + 32 * p) =
            make_float2(acc.c[i][p][0], acc.c[i][p][1]);
    }
  }
  z3::cp_wait<0>();
}

template <typename T, int BN, int BM>
int launch(const void* dout, const int* nbr9, const uint8_t* zup, const uint8_t* zdn,
           const void* wt, const uint8_t* dmask, void* dx, int na, int cout, int cin,
           cudaStream_t st) {
  using F = Dx<T, BN, BM>;
  static bool configured = false;  // once per instantiation and process
  if (!configured) {
    const int err = (int)cudaFuncSetAttribute(zconv3_bwd_dx_kernel<T, BN, BM>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)F::SMEM);
    if (err != 0) return err;
    configured = true;
  }
  const dim3 grid((na + BM - 1) / BM, cin / BN);
  zconv3_bwd_dx_kernel<T, BN, BM><<<grid, F::NT, F::SMEM, st>>>(
      static_cast<const T*>(dout), nbr9, zup, zdn, static_cast<const T*>(wt), dmask,
      static_cast<T*>(dx), na, cout, cin);
  return (int)cudaGetLastError();
}

template <typename T, int BN>
int launch_rows(const void* dout, const int* nbr9, const uint8_t* zup, const uint8_t* zdn,
                const void* wt, const uint8_t* dmask, void* dx, int na, int cout, int cin,
                cudaStream_t st) {
  if (z3::row_tile(na, cin / BN) == 128)
    return launch<T, BN, 128>(dout, nbr9, zup, zdn, wt, dmask, dx, na, cout, cin, st);
  return launch<T, BN, 64>(dout, nbr9, zup, zdn, wt, dmask, dx, na, cout, cin, st);
}

template <typename T>
int launch_width(const void* dout, const int* nbr9, const uint8_t* zup, const uint8_t* zdn,
                 const void* wt, const uint8_t* dmask, void* dx, int na, int cout, int cin,
                 cudaStream_t st) {
  switch (z3::col_tile(cin)) {
    case 128: return launch_rows<T, 128>(dout, nbr9, zup, zdn, wt, dmask, dx, na, cout, cin, st);
    case 96: return launch_rows<T, 96>(dout, nbr9, zup, zdn, wt, dmask, dx, na, cout, cin, st);
    case 64: return launch_rows<T, 64>(dout, nbr9, zup, zdn, wt, dmask, dx, na, cout, cin, st);
    default: return launch_rows<T, 32>(dout, nbr9, zup, zdn, wt, dmask, dx, na, cout, cin, st);
  }
}

}  // namespace

// dout [na, cout], nbr9 int32 [9, na], zup / zdn / dout_mask bool [na]
// (dout_mask may be null: every row read), wt [9, 3, cout, cin] (wt[e][t] =
// wf[8-e][t]^T), dx [na, cin]; cin and cout multiples of 32.  dtype: 0 =
// float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int zconv3_bwd_dx(const void* dout, const void* nbr9, const void* zup,
                             const void* zdn, const void* wt, const void* dout_mask, void* dx,
                             int na, int cout, int cin, int dtype, void* stream) {
  if (na <= 0 || cin <= 0 || cin % 32 != 0 || cout <= 0 || cout % 32 != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* nb = static_cast<const int*>(nbr9);
  const auto* zu = static_cast<const uint8_t*>(zup);
  const auto* zd = static_cast<const uint8_t*>(zdn);
  const auto* dm = static_cast<const uint8_t*>(dout_mask);
  if (dtype == 1)
    return launch_width<__nv_bfloat16>(dout, nb, zu, zd, wt, dm, dx, na, cout, cin, st);
  return launch_width<float>(dout, nb, zu, zd, wt, dm, dx, na, cout, cin, st);
}

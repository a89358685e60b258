// KA: forward of the k=3 column-fused sparse conv (zconv3).
//
// Replaces lidog_tpu/ops/zconv.py:180-223 (_zconv3_core forward) and the
// Pallas prototype benchmarks/micro/micro_windowconv.py:113 (make_windowed),
// which compute the same op.
//
//   out[i] = m[i] * sum_{d < 9} zcat(x)[n_d(i)] @ wf[d]
//   zcat(x)[n] = [x[n-1] * zdn[n], x[n], x[n+1] * zup[n]]
//
// n_4(i) = i, n_d(i) = nbr9[d, i] otherwise; a source outside [0, Na) is a
// zero row, and so are x[-1] and x[Na].  The JAX version rounds each
// per-offset projection to the compute dtype before its f32 sum; this
// kernel keeps the whole sum in f32 and rounds once.
//
// Bound on an H100: bytes at the main path's widths (x, the maps, wf and
// out once); the products are ~2 x 3 Cin x Cout operations per live (row,
// offset), below the tensor cores' reach of those bytes.  Each live (row,
// offset) gathers the run x[n-1] | x[n] | x[n+1], 3 Cin contiguous
// elements, mostly from L2; but the time goes to each K stage's serial
// work (the copies' issue, the barrier, the ldmatrix / MMA chain), which
// larger stages amortize, not to those bytes.
//
// Design (zconv3_mma.cuh has the shared pieces).  A block owns BM rows
// (128, or 64 on small levels) and BN output columns, all of Cout up to
// 128 (Cout 256: two column tiles), so the gather is not repeated across
// column tiles.  It first puts its rows whose output mask is set first,
// in order (a block-wide ballot scan; the rest only get zeros written),
// and resolves for each of them and the 9 xy offsets the source row n
// and the taps that count (tap 0 when n > 0 and zdn[n], tap 1, tap 2 when
// n + 1 < Na and zup[n]) into one word, in shared memory.  Offsets that
// no live row has a source for are skipped.  The rest is one K loop over
// (live offset d, chunk of the 3 Cin run: 64 elements in bf16, 32 in f32;
// the last one may be short): the chunk of each live row's run (16-byte
// cp.async pieces, each zero-filled where its own tap does not count)
// multiplied by the same rows of wf[d] ([3 Cin, Cout], contiguous),
// through a cp.async ring (3 stages; 2 in bf16 at BN 128 and at BN <= 64,
// so that more blocks fit an SM), so the next chunks' gathers overlap the
// current one's products: 9 index resolutions and 9 gathered runs per
// row, where the first version made 27 x (Cout / 32).  (Ablations on an
// H100 found the time in the per-stage work, not in the gathers:
// 64-element chunks beat 32-element ones by a third, and wgmma from the
// same tiles was no faster than mma.sync.)  Because the live rows come
// first, the products cover only them: a warp (bf16) or thread (f32) past
// the live rows, or whose rows have none of a stage's (offset, taps),
// skips its products.  bf16: mma.sync m16n8k16 from ldmatrix fragments,
// f32 sums in registers; f32: a register tile of FMAs.  The epilogue
// writes each live row rounded once, and zeros in the others.
#include "zconv3_mma.cuh"

namespace {

// the ring: K elements a stage and stages, and the threads an SM holds by
// registers (the launch bounds): 2 stages in bf16 at BN 128 and in narrow
// blocks (BN <= 64), which hold 8 blocks an SM, for more blocks in flight
constexpr int kBKBf16 = 64, kStagesBf16 = 3, kStagesWide = 2, kBKF32 = 32, kStagesF32 = 3;
constexpr int kStagesNarrow = 2, kThreadsNarrow = 1024;

template <typename T, int BN, int BM>
struct Fwd {
  static constexpr bool BF16 = z3::kBf16<T>, NARROW = BN <= 64;
  static constexpr int NT = 2 * BM, MINB = (NARROW ? kThreadsNarrow : 512) / NT;
  static constexpr int EPV = z3::kEPV<T>;
  static constexpr int BK = BF16 ? kBKBf16 : kBKF32;
  static constexpr int STAGES = NARROW ? kStagesNarrow
                                : BF16 ? (BN == 128 ? kStagesWide : kStagesBf16)
                                       : kStagesF32;
  static constexpr int AP = BK + EPV, BP = BN + EPV;
  static constexpr int A_EL = BM * AP, B_EL = BK * BP;
  static constexpr size_t SMEM =
      (size_t)STAGES * (A_EL + B_EL) * sizeof(T) + 9 * BM * 4 + BM * 2;
};

template <typename T, int BN, int BM>
__global__ void __launch_bounds__(Fwd<T, BN, BM>::NT, Fwd<T, BN, BM>::MINB)
zconv3_fwd_kernel(const T* __restrict__ x, const int* __restrict__ nbr9,
                  const uint8_t* __restrict__ zup, const uint8_t* __restrict__ zdn,
                  const T* __restrict__ wf, const uint8_t* __restrict__ mask, T* __restrict__ out,
                  int na, int cin, int cout) {
  using F = Fwd<T, BN, BM>;
  constexpr int NT = F::NT, EPV = F::EPV, BK = F::BK, AP = F::AP, BP = F::BP, ST = F::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [ST] A tiles, rows in live order
  T* Bs = As + ST * F::A_EL;           // [ST] B tiles
  int* tab = reinterpret_cast<int*>(Bs + ST * F::B_EL);  // [9][BM] by live rank
  uint8_t* rowof = reinterpret_cast<uint8_t*>(tab + 9 * BM);  // [BM] live rank -> row
  uint8_t* live_row = rowof + BM;                              // [BM] row -> live?
  __shared__ int s_warp[BM / 32];
  __shared__ unsigned s_live;

  const int tid = threadIdx.x, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, k3 = 3 * cin;
  // the live rows (output mask set, inside the level), in order
  const bool me = tid < BM && m0 + tid < na && (mask == nullptr || mask[m0 + tid]);
  const unsigned ballot = __ballot_sync(0xffffffffu, me);
  if (tid < BM && lane == 0) s_warp[tid >> 5] = __popc(ballot);
  if (tid == 0) s_live = 0;
  __syncthreads();
  int nlive = 0, rank = 0;
#pragma unroll
  for (int w = 0; w < BM / 32; ++w) {
    rank += w < (tid >> 5) ? s_warp[w] : 0;
    nlive += s_warp[w];
  }
  if (tid < BM) {
    live_row[tid] = me;
    if (me) rowof[rank + __popc(ballot & ((1u << lane) - 1))] = (uint8_t)tid;
  }
  __syncthreads();
  // the table: n << 3 | tap bits (bit t: tap t counts), 0 = no source
  unsigned live = 0;
  for (int v = tid; v < 9 * BM; v += NT) {
    const int d = v / BM, r = v - d * BM;
    int e = 0;
    if (r < nlive) {
      const int row = m0 + rowof[r];
      const int n = d == 4 ? row : nbr9[(size_t)d * na + row];
      if (n >= 0 && n < na)
        e = n << 3 | 2 | (n > 0 && zdn[n] ? 1 : 0) | (n + 1 < na && zup[n] ? 4 : 0);
    }
    tab[v] = e;
    if (e) live |= 1u << d;
  }
  live = __reduce_or_sync(0xffffffffu, live);
  if (lane == 0 && live) atomicOr(&s_live, live);
  __syncthreads();
  live = s_live;
  const int kcn = (k3 + BK - 1) / BK;  // K chunks per offset (the last may be short)
  const int nq = __popc(live) * kcn;
  // stage q: offset d, first K element k0 of wf[d]'s 3 Cin rows, and the
  // chunk's taps as bits 3 d + t
  auto stage = [&](int q, int& d, int& k0) {
    const int di = q / kcn;
    unsigned m = live;
    for (int j = 0; j < di; ++j) m &= m - 1;
    d = __ffs(m) - 1;
    k0 = (q - di * kcn) * BK;
    const int t0 = k0 / cin, t1 = (min(k0 + BK, k3) - 1) / cin;
    return ((2u << t1) - (1u << t0)) << (3 * d);
  };
  // bit 3 d + t: some live rank of r0 .. r0 + n - 1 has tap t of offset d
  auto ranks_live = [&](int r0, int n) {
    unsigned bits = 0;
    for (int r = r0; r < min(r0 + n, nlive); ++r)
#pragma unroll
      for (int d = 0; d < 9; ++d) bits |= (unsigned)(tab[d * BM + r] & 7) << (3 * d);
    return bits;
  };

  auto issue = [&](int q) {
    if (q >= nq) return;
    int d, k0;
    stage(q, d, k0);
    T* A = As + (q % ST) * F::A_EL;
    const int* td = tab + d * BM;
    for (int v = tid; v < nlive * (BK / EPV); v += NT) {
      const int r = v / (BK / EPV), pc = v % (BK / EPV), k = k0 + pc * EPV;
      const int t = k >= cin ? (k >= 2 * cin ? 2 : 1) : 0;
      const bool ok = k < k3 && ((td[r] >> t) & 1);
      // element k of the run that starts at x[n - 1]
      z3::cp16(A + r * AP + pc * EPV, ok ? x + ((long long)((td[r] >> 3) - 1) * cin + k) : x,
               ok ? 16 : 0);
    }
    T* B = Bs + (q % ST) * F::B_EL;
    const T* wk = wf + (size_t)d * k3 * cout + n0;
    for (int v = tid; v < BK * (BN / EPV); v += NT) {
      const int r = v / (BN / EPV), pc = v % (BN / EPV), k = k0 + r;
      z3::cp16(B + r * BP + pc * EPV, wk + (size_t)(k < k3 ? k : 0) * cout + pc * EPV,
               k < k3 ? 16 : 0);
    }
  };

  for (int s = 0; s < ST - 1; ++s) {
    issue(s);
    z3::cp_commit();
  }
  if constexpr (z3::kBf16<T>) {
    const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
    const unsigned wlive = __reduce_or_sync(0xffffffffu, ranks_live(wm * 32 + lane, 1));
    z3::TileBf16<BN> acc;
    acc.zero();
    for (int q = 0; q < nq; ++q) {
      z3::cp_wait<ST - 2>();
      __syncthreads();  // stage q landed for every thread; stage q - 1 is free
      issue(q + ST - 1);
      z3::cp_commit();
      int d, k0;
      if (!(wlive & stage(q, d, k0))) continue;
      const T* A = As + (q % ST) * F::A_EL + wm * 32 * AP;
      const T* B = Bs + (q % ST) * F::B_EL + wn * (BN / 2);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16)  // (none past the offset's 3 Cin rows)
        if (k0 + kk < k3) acc.template k16<false>(A + kk, AP, B + kk * BP, BP, nullptr, nullptr);
    }
    acc.store([&](int r, int col, float v0, float v1) {
      const int rr = wm * 32 + r;
      if (rr < nlive)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(m0 + rowof[rr]) * cout + n0 +
                                           wn * (BN / 2) + col) = __floats2bfloat162_rn(v0, v1);
    });
  } else {
    constexpr int TM = z3::TileF32<BN>::TM;
    const int ty = tid >> 4, tx = tid & 15;
    const unsigned tlive = ranks_live(ty * TM, TM);
    z3::TileF32<BN> acc;
    acc.zero();
    for (int q = 0; q < nq; ++q) {
      z3::cp_wait<ST - 2>();
      __syncthreads();
      issue(q + ST - 1);
      z3::cp_commit();
      int d, k0;
      if (!(tlive & stage(q, d, k0))) continue;
      const float* A = reinterpret_cast<const float*>(As + (q % ST) * F::A_EL) + ty * TM * AP;
      const float* B = reinterpret_cast<const float*>(Bs + (q % ST) * F::B_EL) + 2 * tx;
#pragma unroll
      for (int k = 0; k < BK; k += 4) acc.template step<1>(A + k, AP, B + k * BP, 0, BP, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int rr = ty * TM + i;
      if (rr >= nlive) break;
#pragma unroll
      for (int p = 0; p < BN / 32; ++p)
        *reinterpret_cast<float2*>(out + (size_t)(m0 + rowof[rr]) * cout + n0 + 2 * tx + 32 * p) =
            make_float2(acc.c[i][p][0], acc.c[i][p][1]);
    }
  }
  // zeros in the rows that are not live
  for (int v = tid; v < BM * (BN / EPV); v += NT) {
    const int i = v / (BN / EPV), pc = v % (BN / EPV);
    if (m0 + i < na && !live_row[i])
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + i) * cout + n0 + pc * EPV) =
          make_uint4(0, 0, 0, 0);
  }
  z3::cp_wait<0>();
}

template <typename T, int BN, int BM>
int launch(const void* x, const int* nbr9, const uint8_t* zup, const uint8_t* zdn, const void* wf,
           const uint8_t* mask, void* out, int na, int cin, int cout, cudaStream_t st) {
  using F = Fwd<T, BN, BM>;
  static bool configured = false;  // once per instantiation and process
  if (!configured) {
    const int err = (int)cudaFuncSetAttribute(zconv3_fwd_kernel<T, BN, BM>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)F::SMEM);
    if (err != 0) return err;
    configured = true;
  }
  const dim3 grid((na + BM - 1) / BM, cout / BN);
  zconv3_fwd_kernel<T, BN, BM><<<grid, F::NT, F::SMEM, st>>>(
      static_cast<const T*>(x), nbr9, zup, zdn, static_cast<const T*>(wf), mask,
      static_cast<T*>(out), na, cin, cout);
  return (int)cudaGetLastError();
}

template <typename T, int BN>
int launch_rows(const void* x, const int* nbr9, const uint8_t* zup, const uint8_t* zdn,
                const void* wf, const uint8_t* mask, void* out, int na, int cin, int cout,
                cudaStream_t st) {
  if (z3::row_tile(na, cout / BN) == 128)
    return launch<T, BN, 128>(x, nbr9, zup, zdn, wf, mask, out, na, cin, cout, st);
  return launch<T, BN, 64>(x, nbr9, zup, zdn, wf, mask, out, na, cin, cout, st);
}

template <typename T>
int launch_width(const void* x, const int* nbr9, const uint8_t* zup, const uint8_t* zdn,
                 const void* wf, const uint8_t* mask, void* out, int na, int cin, int cout,
                 cudaStream_t st) {
  switch (z3::col_tile(cout)) {
    case 128: return launch_rows<T, 128>(x, nbr9, zup, zdn, wf, mask, out, na, cin, cout, st);
    case 96: return launch_rows<T, 96>(x, nbr9, zup, zdn, wf, mask, out, na, cin, cout, st);
    case 64: return launch_rows<T, 64>(x, nbr9, zup, zdn, wf, mask, out, na, cin, cout, st);
    default: return launch_rows<T, 32>(x, nbr9, zup, zdn, wf, mask, out, na, cin, cout, st);
  }
}

}  // namespace

// x [na, cin], nbr9 int32 [9, na], zup / zdn / mask bool [na] (mask may be
// null: every row kept), wf [9, 3 cin, cout], out [na, cout]; cin and cout
// multiples of 32, na below 2^28.  dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t (0 = launched).
extern "C" int zconv3_fwd(const void* x, const void* nbr9, const void* zup, const void* zdn,
                          const void* wf, const void* mask, void* out, int na, int cin,
                          int cout, int dtype, void* stream) {
  if (na <= 0 || na >= (1 << 28) || cin <= 0 || cin % 32 != 0 || cout <= 0 || cout % 32 != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* nb = static_cast<const int*>(nbr9);
  const auto* zu = static_cast<const uint8_t*>(zup);
  const auto* zd = static_cast<const uint8_t*>(zdn);
  const auto* m = static_cast<const uint8_t*>(mask);
  if (dtype == 1)
    return launch_width<__nv_bfloat16>(x, nb, zu, zd, wf, m, out, na, cin, cout, st);
  return launch_width<float>(x, nb, zu, zd, wf, m, out, na, cin, cout, st);
}

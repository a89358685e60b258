// Gather-GEMM templates of the strided sparse conv forwards KB
// (zconv_down_fwd.cu) and KC (zconv_up_fwd.cu), which are also the
// backward dx of each other with transposed weights, and of the generic
// sparse conv LA (sparse_conv.cu).  (The zconv3 forward and dx, KA and
// KE, have their own kernels over the same pieces: zconv3_mma.cuh.)
//
//   out[i, :] = mask[i] * sum_{o < NOFF} x[src(o, i), :] @ w[o]
//
// where src(o, i) is a row of x or -1 (a zero row), given by a Map
// policy.  w is [NOFF * cin, cout] row-major (the JAX layout [K, Cin,
// Cout]).  Accumulation is f32; the output is rounded once to the input
// type.  A null `mask` keeps every row; a non-null `src_mask` turns a
// source row s with src_mask[s] == 0 into a zero row (the backward passes
// reuse a forward kernel on a cotangent that the forward's output mask
// zeroes).  Two kinds of map, one kernel each:
//
//   gathering (Map::ONEHOT false; KB's nbr8, LA's K = 27 / 8 maps): up to
//     NOFF sources a row, src(o, i): gather_gemm_kernel;
//   one-hot (Map::ONEHOT true; KC): one offset and one source a row,
//     pick(i, s) -> o (or -1: a zero row), i.e. out[i] = x[s] @ w[o]:
//     onehot_gemm_kernel.
//
// Bound on an H100: the gathered rows and the output are bytes, the
// products operations; at the main path's widths (32-256 channels) the
// bf16 products of the live (row, offset) pairs sit far below the tensor
// cores' reach of those bytes.  What holds the kernels back, as it holds
// KA and KE (zconv3_mma.cuh), is each K stage's serial work (the copies'
// issue, the barrier, the wait for the gathers, the ldmatrix / mma
// chain), the latency of dependent map reads, and, at the deep levels'
// wide channels, the weight slabs each block reads from L2.
//
// Gathering (KA's design, zconv3_fwd.cu, without the z taps).  A block
// owns BM rows (128, or 64 on small levels: z3::row_tile) and BN output
// columns, all of Cout up to 128 (Cout 256: two column tiles;
// z3::col_tile), so the sources are resolved and gathered once, not once
// per 32 or 64 columns; 2 BM threads.  It first puts the rows whose
// output mask is set first, in order (a ballot scan; the others are only
// written as zeros), and resolves each one's source at each offset (NOFF
// words a row, in shared memory; a thread's map reads all in flight
// together with the mask read, then the source-mask reads); offsets that
// no live row has a source for are dropped.  With at most 8 offsets (KB;
// LA's K = 8) the live rows are then sorted by the set of offsets they
// have a source at.  One K loop runs over the live offsets' Cin columns
// laid end to end ((o, c) -> j cin + c, j: o's rank among the live
// offsets), in chunks of 64 (bf16) or 32 (f32) elements, through a
// cp.async ring (3 stages, 2 at BN 128 and in 64-row blocks): a chunk
// holds the rows' 16-byte pieces of one or two offsets (a narrow Cin
// packs two offsets into a stage; a missing source is zero-filled and
// reads no memory) and the matching rows of w.  A warp
// (bf16, its 32 rows) or thread (f32, its 8) skips the k16 / k4 steps of
// an offset none of its rows has a source at.  bf16: mma.sync m16n8k16
// from ldmatrix fragments into an f32 register tile (z3::TileBf16: warps
// of 32 rows x BN/2); f32: a register tile of FMAs (z3::TileF32: threads
// of 8 rows x BN/16).  The epilogue writes each live row rounded once and
// zeros in the block's other rows.
//
// One-hot (weight-stationary).  Each row takes one product, so the rows
// of one offset can be served apart: block (range of 1024 rows, offset o,
// column tile of BN) loads the slab w[o][:, tile] once into shared memory
// (cp.async, while it scans), finds the range's rows that are live
// (mask set, parent inside x and not src_mask-dead) at offset o (ballots,
// in row order), gathers their whole sources in tiles of BM rows
// (cp.async, two tiles in flight where they fit) and multiplies each tile
// by the resident slab (the same tiles as above), writing each product
// to its row.  The offset-0 blocks write zeros in the range's rows that
// no block serves.  So each row is gathered once and multiplied once,
// and a slab is read from L2 once per 1024 rows, not all 8 slabs once per
// block of rows.  ops/_wrap.py gather_gemm_tiles states both blockings
// for the tests.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "zconv3_mma.cuh"

namespace lidog {

// K elements a stage (bf16, f32); gathering ring stages (2 at BN 128, two
// blocks an SM, and in 64-row blocks, which small levels need many of in
// flight at once); one-hot: fine rows a block's range
constexpr int kGGBKBf16 = 64, kGGBKF32 = 32, kGGStages = 3, kGGStagesWide = 2, kOHRange = 1024;
constexpr int kSmemMax = 232448;  // an H100 block's shared memory

template <typename T, int BN, int BM>
struct GG {
  static constexpr bool BF16 = z3::kBf16<T>;
  // blocks an SM by registers: gathering 512 threads; one-hot 1024 in
  // narrow bf16 blocks (BN <= 64: a 32 x BN/2 tile a warp), else 512
  static constexpr int NT = 2 * BM, MINB = 512 / NT;
  static constexpr int OH_MINB = (BF16 && BN <= 64 ? 1024 : 512) / NT;
  static constexpr int EPV = z3::kEPV<T>;
  static constexpr int BK = BF16 ? kGGBKBf16 : kGGBKF32;
  static constexpr int AP = BK + EPV, BP = BN + EPV;
  static constexpr int A_EL = BM * AP, B_EL = BK * BP;
  static constexpr int ST = BN == 128 || BM == 64 ? kGGStagesWide : kGGStages;
  // the gathering kernel's shared memory for NOFF offsets
  static constexpr size_t smem(int noff) {
    return (size_t)ST * (A_EL + B_EL) * sizeof(T) + (size_t)noff * BM * 4 + 32 * 4 + 2 * BM;
  }
  // the one-hot kernel's: the slab, nbuf row tiles, the range's list
  static constexpr size_t onehot_smem(int cin, int nbuf) {
    return ((size_t)cin * BP + (size_t)nbuf * BM * (cin + EPV)) * sizeof(T) + kOHRange * 8;
  }
};

constexpr uint8_t kNotLive = 0xff;  // the live rank of a row that is not live

// The epilogue: live row rr (< nlive) of the tile is output row m0 +
// rowof[rr]; the block's rows that are not live (rank_of kNotLive) get
// zeros.
template <typename T, int BN, int BM, class Tile>
__device__ __forceinline__ void gg_store(const Tile& acc, T* out, const uint8_t* rowof,
                                         const uint8_t* rank_of, int nlive, int m0, int n0,
                                         int n_out, int cout) {
  constexpr int EPV = z3::kEPV<T>, NT = 2 * BM;
  const int tid = threadIdx.x;
  if constexpr (z3::kBf16<T>) {
    const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
    acc.store([&](int r, int col, float v0, float v1) {
      const int rr = wm * 32 + r;
      if (rr < nlive)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(m0 + rowof[rr]) * cout + n0 +
                                           wn * (BN / 2) + col) = __floats2bfloat162_rn(v0, v1);
    });
  } else {
    constexpr int TM = z3::TileF32<BN>::TM;
    const int ty = tid >> 4, tx = tid & 15;
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
  for (int v = tid; v < BM * (BN / EPV); v += NT) {
    const int i = v / (BN / EPV), pc = v % (BN / EPV);
    if (m0 + i < n_out && rank_of[i] == kNotLive)
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + i) * cout + n0 + pc * EPV) =
          make_uint4(0, 0, 0, 0);
  }
}

template <typename T, int BN, int BM, class Map>
__global__ void __launch_bounds__(GG<T, BN, BM>::NT, GG<T, BN, BM>::MINB)
gather_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const uint8_t* __restrict__ mask, const uint8_t* __restrict__ src_mask,
                   T* __restrict__ out, Map map, int n_in, int n_out, int cin, int cout) {
  using F = GG<T, BN, BM>;
  constexpr int NT = F::NT, EPV = F::EPV, BK = F::BK, AP = F::AP, BP = F::BP, ST = F::ST;
  constexpr int NOFF = Map::NOFF, NW = BM / 32;
  static_assert(NOFF <= 32, "offsets are bits of one word");
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [ST] A tiles, rows in live order
  T* Bs = As + ST * F::A_EL;           // [ST] B tiles
  int* tab = reinterpret_cast<int*>(Bs + ST * F::B_EL);  // [NOFF][BM] sources by live rank
  int* offs = tab + NOFF * BM;                           // [32] the live offsets in order
  uint8_t* rowof = reinterpret_cast<uint8_t*>(offs + 32);  // [BM] live rank -> row
  uint8_t* rank_of = rowof + BM;                           // [BM] row -> live rank
  __shared__ int s_warp[NW];
  __shared__ unsigned s_live;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // every row's source at each offset (thread t reads table words t, t +
  // NT, ...: all its map reads in flight together with the mask read), the
  // live rows (output mask set, inside the level) in order, then the
  // sources' mask reads and the table by live rank (-1: no source)
  constexpr int PER = (NOFF * BM + NT - 1) / NT;  // table words a thread
  int sv[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int v = tid + i * NT, k = v / BM, r = v - k * BM;
    sv[i] = -1;
    if (v < NOFF * BM && m0 + r < n_out) sv[i] = map.src(k, m0 + r);
  }
  const bool me = tid < BM && m0 + tid < n_out && (mask == nullptr || mask[m0 + tid]);
  const unsigned ballot = __ballot_sync(0xffffffffu, me);
  if (tid < BM && lane == 0) s_warp[warp] = __popc(ballot);
  if (tid == 0) s_live = 0;
  __syncthreads();
  int rank = 0, nlive = 0;
#pragma unroll
  for (int v = 0; v < NW; ++v) {
    rank += v < warp ? s_warp[v] : 0;
    nlive += s_warp[v];
  }
  if (tid < BM) {
    rank += __popc(ballot & ((1u << lane) - 1));
    rank_of[tid] = me ? (uint8_t)rank : kNotLive;
    if (me) rowof[rank] = (uint8_t)tid;
  }
  uint8_t ok[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    ok[i] = sv[i] >= 0 && sv[i] < n_in;
    if (ok[i] && src_mask != nullptr) ok[i] = src_mask[sv[i]];
  }
  __syncthreads();
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int v = tid + i * NT, k = v / BM, r = v - k * BM;
    if (v < NOFF * BM && rank_of[r] != kNotLive) {
      tab[k * BM + rank_of[r]] = ok[i] ? sv[i] : -1;
      bits |= (ok[i] ? 1u : 0u) << k;
    }
  }
  bits = __reduce_or_sync(0xffffffffu, bits);
  if (lane == 0 && bits) atomicOr(&s_live, bits);
  __syncthreads();
  const unsigned live = s_live;
  if (tid < NOFF && ((live >> tid) & 1)) offs[__popc(live & ((1u << tid) - 1))] = tid;
  if constexpr (NOFF <= 8) {
    // live rows sorted by the set of offsets they have a source at (a
    // counting sort over 256 keys; the order within a key is any), so
    // that rows with the same offsets share warps (bf16) and threads
    // (f32), which skip the offsets none of their rows has (KB: 1-2 of a
    // coarse row's 8 children exist)
    __shared__ int s_bin[256];
    for (int v = tid; v < 256; v += NT) s_bin[v] = 0;
    __syncthreads();
    int src[NOFF], key = 0, row = 0;
    if (tid < nlive) {
#pragma unroll
      for (int k = 0; k < NOFF; ++k) {
        src[k] = tab[k * BM + tid];
        key |= (src[k] >= 0 ? 1 : 0) << k;
      }
      row = rowof[tid];
      atomicAdd(&s_bin[key], 1);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the 256 counts, 8 a lane
      int c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = s_bin[lane * 8 + j];
        sum += c[j];
      }
      int incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      int start = incl - sum;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s_bin[lane * 8 + j] = start;
        start += c[j];
      }
    }
    __syncthreads();
    if (tid < nlive) {
      const int p = atomicAdd(&s_bin[key], 1);
#pragma unroll
      for (int k = 0; k < NOFF; ++k) tab[k * BM + p] = src[k];
      rowof[p] = (uint8_t)row;
    }
  }
  __syncthreads();
  // the live offsets' columns end to end, in chunks of BK (the last may be
  // short; cin is a multiple of 32, so a k16 / k4 step is of one offset)
  const int kl = __popc(live) * cin, nq = (kl + BK - 1) / BK;
  // bit k: some live rank of r0 .. r0 + n - 1 has a source at offset k
  auto offsets_of = [&](int r0, int n) {
    unsigned b = 0;
    for (int r = r0; r < min(r0 + n, nlive); ++r)
      for (int k = 0; k < NOFF; ++k) b |= (tab[k * BM + r] >= 0 ? 1u : 0u) << k;
    return b;
  };

  // a chunk holds at most two offsets (cin >= 32 >= BK / 2): bit 0 / 1 of
  // the result, whether `mine` (offset bits) has the first / second, which
  // begins at chunk element kb
  auto stage_use = [&](int q, unsigned mine, int& kb) {
    const int j = q * BK / cin;
    kb = (j + 1) * cin - q * BK;
    const unsigned second =
        kb < BK && q * BK + kb < kl ? ((mine >> offs[j + 1]) & 1) << 1 : 0u;
    return ((mine >> offs[j]) & 1) | second;
  };
  auto issue = [&](int q) {
    if (q >= nq) return;
    const int k0 = q * BK, kv = min(BK, kl - k0) / EPV;  // the chunk's pieces of a row
    T* A = As + (q % ST) * F::A_EL;
    for (int v = tid; v < nlive * kv; v += NT) {
      const int r = v / kv, pc = v - r * kv, k = k0 + pc * EPV, j = k / cin;
      const int s = tab[offs[j] * BM + r];
      z3::cp16(A + r * AP + pc * EPV, s >= 0 ? x + ((size_t)s * cin + k - j * cin) : x,
               s >= 0 ? 16 : 0);
    }
    T* B = Bs + (q % ST) * F::B_EL;
    for (int v = tid; v < kv * EPV * (BN / EPV); v += NT) {
      const int r = v / (BN / EPV), pc = v % (BN / EPV), k = k0 + r, j = k / cin;
      z3::cp16(B + r * BP + pc * EPV,
               w + ((size_t)offs[j] * cin + k - j * cin) * cout + n0 + pc * EPV, 16);
    }
  };

  for (int s = 0; s < ST - 1; ++s) {
    issue(s);
    z3::cp_commit();
  }
  if constexpr (F::BF16) {
    const int wm = warp >> 1, wn = warp & 1;
    const unsigned wlive = __reduce_or_sync(0xffffffffu, offsets_of(wm * 32 + lane, 1));
    z3::TileBf16<BN> acc;
    acc.zero();
    for (int q = 0; q < nq; ++q) {
      z3::cp_wait<ST - 2>();
      __syncthreads();  // stage q landed for every thread; stage q - 1 is free
      issue(q + ST - 1);
      z3::cp_commit();
      const T* A = As + (q % ST) * F::A_EL + wm * 32 * AP;
      const T* B = Bs + (q % ST) * F::B_EL + wn * (BN / 2);
      int kb;
      const unsigned use = stage_use(q, wlive, kb);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16)
        if (q * BK + kk < kl && ((use >> (kk < kb ? 0 : 1)) & 1))
          acc.template k16<false>(A + kk, AP, B + kk * BP, BP, nullptr, nullptr);
    }
    gg_store<T, BN, BM>(acc, out, rowof, rank_of, nlive, m0, n0, n_out, cout);
  } else {
    constexpr int TM = z3::TileF32<BN>::TM;
    const int ty = tid >> 4, tx = tid & 15;
    const unsigned tlive = offsets_of(ty * TM, TM);
    z3::TileF32<BN> acc;
    acc.zero();
    for (int q = 0; q < nq; ++q) {
      z3::cp_wait<ST - 2>();
      __syncthreads();
      issue(q + ST - 1);
      z3::cp_commit();
      const float* A = reinterpret_cast<const float*>(As + (q % ST) * F::A_EL) + ty * TM * AP;
      const float* B = reinterpret_cast<const float*>(Bs + (q % ST) * F::B_EL) + 2 * tx;
      int kb;
      const unsigned use = stage_use(q, tlive, kb);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 4)
        if (q * BK + kk < kl && ((use >> (kk < kb ? 0 : 1)) & 1))
          acc.template step<1>(A + kk, AP, B + kk * BP, 0, BP, 0, 0);
    }
    gg_store<T, BN, BM>(acc, out, rowof, rank_of, nlive, m0, n0, n_out, cout);
  }
  z3::cp_wait<0>();
}

template <typename T, int BN, int BM, class Map>
__global__ void __launch_bounds__(GG<T, BN, BM>::NT, GG<T, BN, BM>::OH_MINB)
onehot_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const uint8_t* __restrict__ mask, const uint8_t* __restrict__ src_mask,
                   T* __restrict__ out, Map map, int n_in, int n_out, int cin, int cout,
                   int nbuf) {
  using F = GG<T, BN, BM>;
  constexpr int NT = F::NT, EPV = F::EPV, BP = F::BP, NW = NT / 32;
  constexpr int RPT = kOHRange / NT;  // the range's rows a thread scans
  extern __shared__ __align__(16) unsigned char smem[];
  T* W = reinterpret_cast<T*>(smem);  // [cin][BP] the slab of w[o]
  const int xp = cin + EPV;
  T* A = W + (size_t)cin * BP;  // [nbuf][BM][xp] the tiles' sources
  int2* lst = reinterpret_cast<int2*>(A + (size_t)nbuf * BM * xp);  // (row, source) in row order
  __shared__ int s_cnt[RPT][NW];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int o = blockIdx.y, n0 = blockIdx.z * BN, r0 = blockIdx.x * kOHRange;
  // the slab (cp.async group 0)
  for (int v = tid; v < cin * (BN / EPV); v += NT) {
    const int r = v / (BN / EPV), pc = v % (BN / EPV);
    z3::cp16(W + r * BP + pc * EPV, w + ((size_t)o * cin + r) * cout + n0 + pc * EPV, 16);
  }
  z3::cp_commit();
  // the range's rows: their offsets and sources (all reads in flight
  // together), then the source masks
  int k[RPT], src[RPT];
  uint8_t m[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + i * NT + tid;
    k[i] = -1;
    m[i] = 0;
    if (r < n_out) {
      k[i] = map.pick(r, src[i]);
      m[i] = mask == nullptr ? 1 : mask[r];
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = m[i] && k[i] >= 0 && k[i] < Map::NOFF && src[i] >= 0 && src[i] < n_in;
    if (m[i] && src_mask != nullptr) m[i] = src_mask[src[i]];
  }
  // row r0 + i NT + tid is this block's if it is live (m) at offset o; it
  // keeps row order: pass i, then warp, then lane
  unsigned ball[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    ball[i] = __ballot_sync(0xffffffffu, m[i] && k[i] == o);
    if (lane == 0) s_cnt[i][warp] = __popc(ball[i]);
  }
  __syncthreads();
  int n = 0;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if ((ball[i] >> lane) & 1) {
      int p = n + __popc(ball[i] & ((1u << lane) - 1));
      for (int v = 0; v < warp; ++v) p += s_cnt[i][v];
      lst[p] = make_int2(r0 + i * NT + tid, src[i]);
    }
    for (int v = 0; v < NW; ++v) n += s_cnt[i][v];
  }
  // the rows that no block's product reaches (not live, or an offset
  // outside 0 .. NOFF - 1) are written as zeros, by the offset-0 blocks
  if (o == 0) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r0 + i * NT + tid;
      if (r < n_out && !m[i])
        for (int pc = 0; pc < BN / EPV; ++pc)
          *reinterpret_cast<uint4*>(out + (size_t)r * cout + n0 + pc * EPV) =
              make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();
  // tiles of BM of the block's rows: sources gathered whole (cp.async), nbuf
  // tiles in flight, each multiplied by the resident slab
  const int ntiles = (n + BM - 1) / BM, cv = cin / EPV;
  auto issue = [&](int t) {
    if (t < ntiles) {
      T* At = A + (size_t)(t % nbuf) * BM * xp;
      const int rows = min(BM, n - t * BM);
      for (int v = tid; v < rows * cv; v += NT) {
        const int p = v / cv, pc = v - p * cv;
        z3::cp16(At + (size_t)p * xp + pc * EPV,
                 x + ((size_t)lst[t * BM + p].y * cin + pc * EPV), 16);
      }
    }
    z3::cp_commit();
  };
  for (int t = 0; t < nbuf; ++t) issue(t);
  for (int t = 0; t < ntiles; ++t) {
    if (nbuf == 2) z3::cp_wait<1>(); else z3::cp_wait<0>();
    __syncthreads();  // tile t (and the slab) landed for every thread
    const T* At = A + (size_t)(t % nbuf) * BM * xp;
    const int nt = min(BM, n - t * BM);
    const int2* lt = lst + t * BM;
    if constexpr (F::BF16) {
      const int wm = warp >> 1, wn = warp & 1;
      z3::TileBf16<BN> acc;
      acc.zero();
      if (wm * 32 < nt)
        for (int kk = 0; kk < cin; kk += 16)
          acc.template k16<false>(At + (size_t)wm * 32 * xp + kk, xp, W + kk * BP + wn * (BN / 2),
                                  BP, nullptr, nullptr);
      acc.store([&](int r, int col, float v0, float v1) {
        const int rr = wm * 32 + r;
        if (rr < nt)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)lt[rr].x * cout + n0 + wn * (BN / 2) +
                                             col) = __floats2bfloat162_rn(v0, v1);
      });
    } else {
      constexpr int TM = z3::TileF32<BN>::TM;
      const int ty = tid >> 4, tx = tid & 15;
      z3::TileF32<BN> acc;
      acc.zero();
      if (ty * TM < nt)
        for (int kk = 0; kk < cin; kk += 4)
          acc.template step<1>(reinterpret_cast<const float*>(At) + (size_t)ty * TM * xp + kk, xp,
                               reinterpret_cast<const float*>(W) + kk * BP + 2 * tx, 0, BP, 0, 0);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int rr = ty * TM + i;
        if (rr >= nt) break;
#pragma unroll
        for (int p = 0; p < BN / 32; ++p)
          *reinterpret_cast<float2*>(out + (size_t)lt[rr].x * cout + n0 + 2 * tx + 32 * p) =
              make_float2(acc.c[i][p][0], acc.c[i][p][1]);
      }
    }
    __syncthreads();  // tile t's buffer is free
    issue(t + nbuf);
  }
  z3::cp_wait<0>();
}

template <class Kernel>
int gg_smem_attr(Kernel kernel, size_t bytes, size_t& configured) {
  if (bytes <= configured) return 0;
  const int err =
      (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == 0) configured = bytes;
  return err;
}

template <typename T, int BN, int BM, class Map>
int launch_gg_tile(const void* x, const void* w, const uint8_t* mask, const uint8_t* src_mask,
                   void* out, const Map& map, int n_in, int n_out, int cin, int cout,
                   cudaStream_t st) {
  using F = GG<T, BN, BM>;
  const size_t bytes = F::smem(Map::NOFF);
  static size_t configured = 0;  // per instantiation and process: the largest size so far
  const int err = gg_smem_attr(gather_gemm_kernel<T, BN, BM, Map>, bytes, configured);
  if (err != 0) return err;
  const dim3 grid((n_out + BM - 1) / BM, cout / BN);
  gather_gemm_kernel<T, BN, BM, Map><<<grid, F::NT, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), mask, src_mask, static_cast<T*>(out),
      map, n_in, n_out, cin, cout);
  return (int)cudaGetLastError();
}

template <typename T, int BN, int BM, class Map>
int launch_onehot_tile(const void* x, const void* w, const uint8_t* mask, const uint8_t* src_mask,
                       void* out, const Map& map, int n_in, int n_out, int cin, int cout,
                       int nbuf, cudaStream_t st) {
  using F = GG<T, BN, BM>;
  const size_t bytes = F::onehot_smem(cin, nbuf);
  static size_t configured = 0;
  const int err = gg_smem_attr(onehot_gemm_kernel<T, BN, BM, Map>, bytes, configured);
  if (err != 0) return err;
  const dim3 grid((n_out + kOHRange - 1) / kOHRange, Map::NOFF, cout / BN);
  onehot_gemm_kernel<T, BN, BM, Map><<<grid, F::NT, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), mask, src_mask, static_cast<T*>(out),
      map, n_in, n_out, cin, cout, nbuf);
  return (int)cudaGetLastError();
}

template <typename T, int BN, class Map>
int launch_gg_rows(const void* x, const void* w, const uint8_t* mask, const uint8_t* src_mask,
                   void* out, const Map& map, int n_in, int n_out, int cin, int cout,
                   cudaStream_t st) {
  if constexpr (Map::ONEHOT) {
    // row tiles of 128 with two in flight, else 64 with two, else 64 with
    // one: the first whose slab and tiles fit a block's shared memory
    // (less what the kernel declares itself)
    constexpr size_t room = kSmemMax - 1024;
    if (GG<T, BN, 128>::onehot_smem(cin, 2) <= room)
      return launch_onehot_tile<T, BN, 128>(x, w, mask, src_mask, out, map, n_in, n_out, cin,
                                            cout, 2, st);
    const int nbuf = GG<T, BN, 64>::onehot_smem(cin, 2) <= room ? 2 : 1;
    if (GG<T, BN, 64>::onehot_smem(cin, nbuf) > room) return (int)cudaErrorInvalidValue;
    return launch_onehot_tile<T, BN, 64>(x, w, mask, src_mask, out, map, n_in, n_out, cin, cout,
                                         nbuf, st);
  } else {
    // 128-row blocks where they make 4 waves of two blocks an SM, else 64
    if (z3::row_tile(n_out, cout / BN) == 128)
      return launch_gg_tile<T, BN, 128>(x, w, mask, src_mask, out, map, n_in, n_out, cin, cout,
                                        st);
    return launch_gg_tile<T, BN, 64>(x, w, mask, src_mask, out, map, n_in, n_out, cin, cout, st);
  }
}

// x [n_in, cin], w [NOFF, cin, cout], mask [n_out] / src_mask [n_in] bool
// (either may be null), out [n_out, cout]; cin and cout multiples of 32.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
template <class Map>
int launch_gather_gemm(const void* x, const void* w, const void* mask, const void* src_mask,
                       void* out, Map map, int n_in, int n_out, int cin, int cout, int dtype,
                       void* stream) {
  if (n_out <= 0 || n_in < 0 || cin <= 0 || cin % 32 != 0 || cout <= 0 || cout % 32 != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const uint8_t*>(mask);
  const auto* sm = static_cast<const uint8_t*>(src_mask);
#define LIDOG_GG(T, BN) launch_gg_rows<T, BN>(x, w, m, sm, out, map, n_in, n_out, cin, cout, st)
  const int bn = z3::col_tile(cout);
  if (dtype == 1)
    return bn == 128  ? LIDOG_GG(__nv_bfloat16, 128)
           : bn == 96 ? LIDOG_GG(__nv_bfloat16, 96)
           : bn == 64 ? LIDOG_GG(__nv_bfloat16, 64)
                      : LIDOG_GG(__nv_bfloat16, 32);
  return bn == 128  ? LIDOG_GG(float, 128)
         : bn == 96 ? LIDOG_GG(float, 96)
         : bn == 64 ? LIDOG_GG(float, 64)
                    : LIDOG_GG(float, 32);
#undef LIDOG_GG
}

}  // namespace lidog

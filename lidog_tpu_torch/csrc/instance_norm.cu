// KK and KL: the masked instance norm and its backward (the per-scan norm
// of RobustNet and IBN-Net).
//
// Replace lidog_tpu/ops/norm.py:79-104 MaskedInstanceNorm and JAX's
// autodiff of it.  A row's segment is its batch id (coords[:, 0]) on the
// rows of the mask and the padding segment S - 1 elsewhere; f = x * m:
//
//   KK instance_norm_fwd  per segment and channel the f32 sums of f and
//                         f * f and the row count (clamped at 1); mean, the
//                         unclamped biased variance var_raw and rstd =
//                         rsqrt(max(var_raw, 0) + eps); then
//                         y = round((f - mean[seg]) * rstd[seg] * m)
//   KL instance_norm_bwd  g = dy in f32; per segment the sums of g and
//                         g * (f - mean[seg]), then a = dmean / count and
//                         b = 2 dvar / count (JAX's gradient of max(var_raw,
//                         0): 1/2 at a tie); then
//                         dx = round((g * rstd[seg] + a[seg] + b[seg] * f) * m)
//
// round() is to x's dtype (bf16 or f32), once.  The sums take the real rows
// only (a masked row's f and g are 0), so the sums' kernels read no masked
// row.  A real row whose batch id lies outside [0, S) falls in no
// segment's sums, and the streaming passes normalise it with segment 0's
// or S - 1's statistics (its id clamped).
//
// Bound on an H100: bytes.  KK reads x (the sums its real rows, the
// streaming pass every row) and writes y; KL reads dy and x twice and
// writes dx; both read the mask and the batch ids.  The [S, C] statistics
// stay in cache.
//
// Design: two launches a call, no fill, on masked_rows.cuh's split (the
// sums one 512-thread block a SM, the streaming pass 128-thread blocks).
// (1) The sums: a block first finds the segment of each row of its run
// (kept as a byte in shared memory: STASH_ROWS rows, more are read again
// from the mask and batch ids) and the segments of its real rows, one bit
// each in a word (at most MAX_SEGMENTS).  In a plan level the rows of a
// scan are contiguous, so that is usually one segment, two at a scan
// boundary.  Then, per segment in increasing order, every thread sums its
// rows of that segment (its lane's rows in order, U_STATS or U_BWD rows'
// loads in flight), the lane tree sums over the lanes, and the block
// writes that segment's f32 partials [blocks, S, C] (KK also its int32
// row count).  It writes its bit word and draws the ticket.  The block
// that draws the last one sums each segment's partials over the blocks
// whose bit is set, in a fixed order: G lanes a (segment, channel group),
// lane q taking the blocks q, q + G, ... in order, then a shuffle tree
// over the G lanes (finish_segments); it finishes the statistics (KK) or
// the coefficients (KL) and resets the ticket.  No partial is read that
// this launch did not write, so nothing is zero-filled, and no sum
// depends on the order in which blocks finish: a result is bitwise the
// same from run to run.  (2) The streaming pass: each thread keeps in
// registers the statistics of the padding segment and of its rows'
// current segment, and loads another segment's only where its rows cross
// into it.
#include "masked_rows.cuh"

namespace {

// segments a launch takes at most: one bit each in a block's word
// (ops/norm.py IN_MAX_SEGMENTS)
constexpr int MAX_SEGMENTS = 32;
// a sums block's rows whose segments it keeps in shared memory, and the
// sums' blocks at most (the last block keeps their bit words there)
constexpr int STASH_ROWS = 8192;
constexpr int MAX_SUM_BLOCKS = 1024;
// the streaming passes' blocks a SM, which bounds their registers (two
// segments' statistics a thread)
constexpr int MIN_APPLY_BLOCKS = 4;
// rows whose loads a thread issues together: finding a sums block's
// segments, in KK's and KL's sums (two arrays: fewer, in 128 registers)
// and in the streaming passes; blocks whose partials a lane of the last
// block loads together
constexpr int U_SEG = 8;
constexpr int U_STATS = 8;
constexpr int U_BWD = 4;
constexpr int U_APPLY = 4;
constexpr int U_FIN = 4;
// a row outside every segment's sums: masked, or a batch id outside [0, S)
constexpr uint8_t NO_SEG = 0xff;

// The OR of v over the block's threads, as every thread sees it (every
// thread must call it).
__device__ __forceinline__ unsigned block_or(unsigned v) {
  __shared__ unsigned word;
  if (threadIdx.x == 0) word = 0;
  __syncthreads();
  const int base = threadIdx.x & ~31;
  const unsigned warp =
      blockDim.x - base >= 32 ? 0xffffffffu : (1u << (blockDim.x - base)) - 1u;
  v = __reduce_or_sync(warp, v);
  if ((threadIdx.x & 31) == 0 && v) atomicOr(&word, v);
  __syncthreads();
  const unsigned out = word;
  __syncthreads();  // every thread has read word before another call resets it
  return out;
}

// Row r's segment for the sums: its batch id on a real row whose id lies
// in [0, segs), else NO_SEG.
__device__ __forceinline__ uint8_t sum_seg(const uint8_t* __restrict__ mask,
                                           const int* __restrict__ bidx, int bstride, int r,
                                           int segs) {
  const int g = bidx[(size_t)r * bstride];
  return mask[r] && (unsigned)g < (unsigned)segs ? (uint8_t)g : NO_SEG;
}

// A sums block's rows [r0, r1) and their segments: kept in shared memory
// when the run fits STASH_ROWS, else read again from the mask and ids.
struct Rows {
  const uint8_t* mask;
  const int* bidx;
  int bstride, segs, r0, r1;
  uint8_t* stash;  // null: not kept

  __device__ __forceinline__ uint8_t seg(int r) const {
    return stash != nullptr ? stash[r - r0] : sum_seg(mask, bidx, bstride, r, segs);
  }
};

// Finds the segment of each row of the block's run (every thread taking
// every blockDim.x-th row, kept in `stash` when it fits) and returns the
// bit word of the segments met, as every thread sees it.
__device__ __forceinline__ unsigned block_segments(Rows& rows, uint8_t* stash) {
  rows.stash = rows.r1 - rows.r0 <= STASH_ROWS ? stash : nullptr;
  unsigned bits = 0;
  for (int r = rows.r0 + threadIdx.x; r < rows.r1; r += U_SEG * blockDim.x) {
    uint8_t g[U_SEG];
#pragma unroll
    for (int u = 0; u < U_SEG; ++u) {  // U_SEG rows' reads in flight
      const int q = r + u * blockDim.x;
      g[u] = q < rows.r1 ? sum_seg(rows.mask, rows.bidx, rows.bstride, q, rows.segs) : NO_SEG;
    }
#pragma unroll
    for (int u = 0; u < U_SEG; ++u) {
      const int q = r + u * blockDim.x;
      if (rows.stash != nullptr && q < rows.r1) rows.stash[q - rows.r0] = g[u];
      if (g[u] != NO_SEG) bits |= 1u << g[u];
    }
  }
  return block_or(bits);  // its barriers also publish the stash
}

// Calls load(r, slot) for the rows r, r + stride, ... below r1 of segment
// sg, then use(slot) for each of them in order, UR rows' loads in flight
// together.
template <int UR, typename Row, typename Load, typename Use>
__device__ __forceinline__ void walk_segment(const Rows& rows, int r, int stride, int sg,
                                             Load load, Use use) {
  Row row[UR];
  for (; r < rows.r1; r += UR * stride) {
    bool on[UR];
#pragma unroll
    for (int u = 0; u < UR; ++u) {
      const int q = r + u * stride;
      on[u] = q < rows.r1 && rows.seg(q) == sg;
    }
#pragma unroll
    for (int u = 0; u < UR; ++u)
      if (on[u]) load(r + u * stride, row[u]);
#pragma unroll
    for (int u = 0; u < UR; ++u)
      if (on[u]) use(row[u]);
  }
}

// The last block's start: every block's bit word into bits_sh, each
// segment's row count summed into cnt_sh (KK's; KL passes no pcnt and no
// cnt_sh; ints, exact), and the bit word of every segment met, as every
// thread sees it.
__device__ __forceinline__ unsigned gather_bits(const int* pbits, const int* pcnt, int segs,
                                                unsigned* bits_sh, int* cnt_sh) {
  if (cnt_sh != nullptr)
    for (int i = threadIdx.x; i < MAX_SEGMENTS; i += blockDim.x) cnt_sh[i] = 0;
  __syncthreads();
  unsigned all = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x) {
    const unsigned w = __ldcg(pbits + b);
    bits_sh[b] = w;
    all |= w;
    if (pcnt != nullptr)
      for (unsigned rest = w; rest != 0; rest &= rest - 1) {
        const int sg = __ffs(rest) - 1;
        atomicAdd(&cnt_sh[sg], __ldcg(pcnt + b * segs + sg));
      }
  }
  return block_or(all);  // its barriers also complete bits_sh and cnt_sh
}

// The last block's sums of segment sg over F channels from ch: the NP
// partial arrays [gridDim.x, segs, c] (p[i] the i-th) of the blocks b = q,
// q + G, q + 2 G, ... whose bit word has sg, added in that order, U_FIN
// blocks' loads in flight.
template <int F, int NP>
__device__ __forceinline__ void sum_blocks(const float* const (&p)[NP],
                                           const unsigned* bits_sh, int sg, int segs, int c,
                                           int ch, int q, int G, float (&acc)[NP][F]) {
  for (int b0 = q; b0 < (int)gridDim.x; b0 += U_FIN * G) {
    float v[U_FIN][NP][F];
    bool on[U_FIN];
#pragma unroll
    for (int u = 0; u < U_FIN; ++u) {
      const int b = b0 + u * G;
      on[u] = b < (int)gridDim.x && ((bits_sh[b] >> sg) & 1);
      if (on[u])
#pragma unroll
        for (int i = 0; i < NP; ++i) ldcg<F>(p[i] + ((size_t)b * segs + sg) * c + ch, v[u][i]);
    }
#pragma unroll
    for (int u = 0; u < U_FIN; ++u)
      if (on[u])
#pragma unroll
        for (int i = 0; i < NP; ++i)
#pragma unroll
          for (int f = 0; f < F; ++f) acc[i][f] += v[u][i][f];
  }
}

// The lanes the last block gives one (segment, group of F channels) of
// the sums: the largest power of two up to 32 with nset * units * G at
// most the block's full warps' threads.
__device__ __forceinline__ int finish_lanes(int nset, int units, int threads) {
  int G = 1;
  while (G < 32 && nset * units * G * 2 <= threads) G *= 2;
  return G;
}

// Runs fin(sg, ch, sums) in the last block for every segment and every
// group of F channels from ch; sums [NP][F] are the segment's partials
// over the blocks whose bit word has it (0 for a segment no block met).
// Each segment met and channel group takes G consecutive lanes of one
// warp: lane q sums the blocks q, q + G, ... in order (sum_blocks), and
// the G sums are added pairwise by shuffles (lane q takes lane q + h for
// h = 1, 2, ..., G / 2), so the order is fixed.
template <int F, int NP, typename Fin>
__device__ __forceinline__ void finish_segments(const float* const (&p)[NP],
                                                const unsigned* bits_sh, unsigned all, int segs,
                                                int c, Fin fin) {
  const int units = c / F, lane = threadIdx.x & 31;
  const int threads = blockDim.x & ~31;  // the full warps
  const int G = finish_lanes(__popc(all), units, threads);
  const int work = __popc(all) * units * G;
  if ((int)threadIdx.x < threads) {
    for (int w0 = threadIdx.x - lane; w0 < work; w0 += threads) {  // warp-uniform
      const int it = w0 + lane, q = it % G, item = it / G;
      const bool on = it < work;
      const int rank = item / units, ch = (item - rank * units) * F;
      unsigned left = all;  // the rank-th segment met
      for (int i = 0; i < rank; ++i) left &= left - 1;
      const int sg = __ffs(left) - 1;
      float acc[NP][F];
#pragma unroll
      for (int i = 0; i < NP; ++i)
#pragma unroll
        for (int f = 0; f < F; ++f) acc[i][f] = 0.f;
      if (on) sum_blocks<F, NP>(p, bits_sh, sg, segs, c, ch, q, G, acc);
      for (int h = 1; h < G; h *= 2)
#pragma unroll
        for (int i = 0; i < NP; ++i)
#pragma unroll
          for (int f = 0; f < F; ++f) {
            const float o = __shfl_down_sync(0xffffffffu, acc[i][f], h);
            if (q % (2 * h) == 0) acc[i][f] += o;
          }
      if (on && q == 0) fin(sg, ch, acc);
    }
  }
  for (int i = threadIdx.x; i < segs * units; i += blockDim.x) {  // the segments no block met
    const int sg = i / units;
    if (!((all >> sg) & 1)) {
      float zero[NP][F];
#pragma unroll
      for (int k = 0; k < NP; ++k)
#pragma unroll
        for (int f = 0; f < F; ++f) zero[k][f] = 0.f;
      fin(sg, (i - sg * units) * F, zero);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS) in_stats_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ mask, const int* __restrict__ bidx,
    float* __restrict__ psum, float* __restrict__ psq, int* __restrict__ pcnt,
    int* __restrict__ pbits, float* __restrict__ mean_out, float* __restrict__ var_out,
    float* __restrict__ rstd_out, float* __restrict__ count_out, int* __restrict__ ticket,
    Split s, int bstride, int segs, float eps) {
  extern __shared__ float sm[];  // [2 V][blockDim.x]
  __shared__ int cnt_sh[MAX_SEGMENTS];
  __shared__ uint8_t stash[STASH_ROWS];
  const Coord k = coord<V>(s);
  constexpr int E = per_word<T, V>;
  for (int i = threadIdx.x; i < MAX_SEGMENTS; i += blockDim.x) cnt_sh[i] = 0;
  Rows rows{mask, bidx, bstride, segs, k.r0, k.r1, nullptr};
  const unsigned bits = block_segments(rows, stash);
  for (unsigned rest = bits; rest != 0; rest &= rest - 1) {
    const int sg = __ffs(rest) - 1;
    float acc[2 * V];  // sums of f, then of f * f
#pragma unroll
    for (int i = 0; i < 2 * V; ++i) acc[i] = 0.f;
    int cnt = 0;
    if (k.live) {
      walk_segment<U_STATS, Raw<T, V>>(
          rows, k.r0 + k.j, s.lanes, sg,
          [&](int r, Raw<T, V>& w) { w = ld<T, V>(x + (size_t)r * s.c + k.c0); },
          [&](const Raw<T, V>& w) {
#pragma unroll
            for (int i = 0; i < V / E; ++i) {
              float f[E];
              get<T, V>(w, i, f);
#pragma unroll
              for (int e = 0; e < E; ++e) {
                acc[i * E + e] += f[e];
                acc[V + i * E + e] += f[e] * f[e];
              }
            }
            ++cnt;
          });
    }
    // the segment's rows: counted by the first group of chunk 0 (int, exact)
    if (blockIdx.y == 0 && threadIdx.x % s.gpb == 0) atomicAdd(&cnt_sh[sg], cnt);
    lane_tree(sm, acc, s.lanes, s.gpb);
    if (k.j == 0 && k.live) {
      const size_t o = ((size_t)blockIdx.x * segs + sg) * s.c + k.c0;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        psum[o + v] = acc[v];
        psq[o + v] = acc[V + v];
      }
    }
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    for (unsigned rest = bits; rest != 0; rest &= rest - 1) {
      const int sg = __ffs(rest) - 1;
      pcnt[blockIdx.x * segs + sg] = cnt_sh[sg];
    }
    pbits[blockIdx.x] = (int)bits;
  }
  if (!last_block(ticket)) return;

  // the last block: the row counts, then every segment's statistics
  __shared__ unsigned bits_sh[MAX_SUM_BLOCKS];
  const unsigned all = gather_bits(pbits, pcnt, segs, bits_sh, cnt_sh);
  const float* const parts[2] = {psum, psq};
  constexpr int F = V == 1 ? 1 : 4;
  finish_segments<F, 2>(parts, bits_sh, all, segs, s.c,
                        [&](int sg, int ch, const float (&acc)[2][F]) {
                          const float count = fmaxf((float)cnt_sh[sg], 1.f);
#pragma unroll
                          for (int f = 0; f < F; ++f) {
                            const size_t o = (size_t)sg * s.c + ch + f;
                            const float mean = acc[0][f] / count;
                            // Σf²/count - mean² with both products rounded,
                            // as the plain version (no fused multiply-add:
                            // var_raw's sign gates the backward)
                            const float var_raw =
                                __fsub_rn(acc[1][f] / count, __fmul_rn(mean, mean));
                            mean_out[o] = mean;
                            var_out[o] = var_raw;
                            rstd_out[o] = 1.f / sqrtf(relu0(var_raw) + eps);
                          }
                        });
  for (int sg = threadIdx.x; sg < segs; sg += blockDim.x)
    count_out[sg] = fmaxf((float)cnt_sh[sg], 1.f);
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS) in_bwd_reduce_kernel(
    const T* __restrict__ dy, const T* __restrict__ x, const uint8_t* __restrict__ mask,
    const int* __restrict__ bidx, const float* __restrict__ mean,
    const float* __restrict__ var_raw, const float* __restrict__ rstd,
    const float* __restrict__ count, float* __restrict__ ps1, float* __restrict__ ps2,
    int* __restrict__ pbits, float* __restrict__ a_out, float* __restrict__ b_out,
    int* __restrict__ ticket, Split s, int bstride, int segs, float eps) {
  extern __shared__ float sm[];  // [2 V][blockDim.x]
  __shared__ uint8_t stash[STASH_ROWS];
  const Coord k = coord<V>(s);
  constexpr int E = per_word<T, V>;
  Rows rows{mask, bidx, bstride, segs, k.r0, k.r1, nullptr};
  const unsigned bits = block_segments(rows, stash);
  for (unsigned rest = bits; rest != 0; rest &= rest - 1) {
    const int sg = __ffs(rest) - 1;
    float acc[2 * V];  // sums of g, then of g * (f - mean)
#pragma unroll
    for (int i = 0; i < 2 * V; ++i) acc[i] = 0.f;
    if (k.live) {
      float mu[V];
      ldv<V>(mean + (size_t)sg * s.c + k.c0, mu);
      struct Row {
        Raw<T, V> dy, x;
      };
      walk_segment<U_BWD, Row>(
          rows, k.r0 + k.j, s.lanes, sg,
          [&](int r, Row& w) {
            const size_t o = (size_t)r * s.c + k.c0;
            w.dy = ld<T, V>(dy + o);
            w.x = ld<T, V>(x + o);
          },
          [&](const Row& w) {
#pragma unroll
            for (int i = 0; i < V / E; ++i) {
              float g[E], f[E];
              get<T, V>(w.dy, i, g);
              get<T, V>(w.x, i, f);
#pragma unroll
              for (int e = 0; e < E; ++e) {
                const int v = i * E + e;
                acc[v] += g[e];
                acc[V + v] += g[e] * (f[e] - mu[v]);
              }
            }
          });
    }
    lane_tree(sm, acc, s.lanes, s.gpb);
    if (k.j == 0 && k.live) {
      const size_t o = ((size_t)blockIdx.x * segs + sg) * s.c + k.c0;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        ps1[o + v] = acc[v];
        ps2[o + v] = acc[V + v];
      }
    }
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) pbits[blockIdx.x] = (int)bits;
  if (!last_block(ticket)) return;

  // the last block: every segment's coefficients
  __shared__ unsigned bits_sh[MAX_SUM_BLOCKS];
  const unsigned all = gather_bits(pbits, nullptr, segs, bits_sh, nullptr);
  const float* const parts[2] = {ps1, ps2};
  constexpr int F = V == 1 ? 1 : 4;
  finish_segments<F, 2>(
      parts, bits_sh, all, segs, s.c, [&](int sg, int ch, const float (&acc)[2][F]) {
        const float cnt = count[sg];
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const size_t o = (size_t)sg * s.c + ch + f;
          const float s1 = acc[0][f], s2 = acc[1][f], vr = var_raw[o], rs = rstd[o];
          const float ve = relu0(vr) + eps;
          // max(var_raw, 0): JAX's balanced gradient, 1/2 each side at a tie
          const float dvar = s2 * (-0.5f * rs / ve) * (vr > 0.f ? 1.f : vr == 0.f ? 0.5f : 0.f);
          const float dmean = __fsub_rn(-__fmul_rn(s1, rs), __fmul_rn(2.f * mean[o], dvar));
          a_out[o] = dmean / cnt;
          b_out[o] = 2.f * dvar / cnt;
        }
      });
}

// The per-segment vectors of NS [segs, c] f32 arrays (q[i] the i-th) that a
// streaming-pass thread keeps: the padding segment's, and those of the
// segment its rows are in.
template <int V, int NS>
struct SegCache {
  float pad[NS][V], cur[NS][V];
  int at;

  __device__ __forceinline__ void load(const float* const (&q)[NS], int sg, const Split& s,
                                       int c0, float (&o)[NS][V]) {
#pragma unroll
    for (int i = 0; i < NS; ++i) ldv<V>(q[i] + (size_t)sg * s.c + c0, o[i]);
  }
  __device__ __forceinline__ SegCache(const float* const (&q)[NS], int last, const Split& s,
                                      int c0) {
    load(q, last, s, c0, pad);
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v) cur[i][v] = pad[i][v];
    at = last;
  }
  // segment sg's vectors (sg >= 0: a real row's) or the padding one's
  __device__ __forceinline__ void seek(const float* const (&q)[NS], int sg, const Split& s,
                                       int c0) {
    if (sg >= 0 && sg != at) {
      load(q, sg, s, c0, cur);
      at = sg;
    }
  }
};

// a row's segment for the streaming passes: -1 (the padding one) on a
// masked row, else its batch id clamped to [0, last]
__device__ __forceinline__ int apply_seg(uint8_t m, int g, int last) {
  return m ? min(max(g, 0), last) : -1;
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_APPLY_THREADS, MIN_APPLY_BLOCKS)
    in_apply_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                    const int* __restrict__ bidx, const float* __restrict__ mean,
                    const float* __restrict__ rstd, T* __restrict__ y, Split s, int bstride,
                    int segs) {
  const Coord k = coord<V>(s);
  if (!k.live) return;
  constexpr int E = per_word<T, V>;
  const float* const q[2] = {mean, rstd};
  SegCache<V, 2> sc(q, segs - 1, s, k.c0);
  struct Row {
    Raw<T, V> x;
    int seg;
  };
  walk_rows<U_APPLY, Row>(
      k.r0 + k.j, k.r1, s.lanes,
      [&](int r, Row& w) {
        w.x = ld<T, V>(x + (size_t)r * s.c + k.c0);
        w.seg = apply_seg(mask[r], bidx[(size_t)r * bstride], segs - 1);
      },
      [&](int r, const Row& w) {
        sc.seek(q, w.seg, s, k.c0);
        const bool real = w.seg >= 0;
        const float m = real ? 1.f : 0.f;
        Raw<T, V> out;
#pragma unroll
        for (int i = 0; i < V / E; ++i) {
          float xv[E], t[E];
          get<T, V>(w.x, i, xv);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int v = i * E + e;
            const float mu = real ? sc.cur[0][v] : sc.pad[0][v];
            const float rs = real ? sc.cur[1][v] : sc.pad[1][v];
            t[e] = (xv[e] * m - mu) * rs * m;
          }
          put<T, V>(out, i, t);
        }
        st<T, V>(y + (size_t)r * s.c + k.c0, out);
      });
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_APPLY_THREADS, MIN_APPLY_BLOCKS)
    in_bwd_apply_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                        const uint8_t* __restrict__ mask, const int* __restrict__ bidx,
                        const float* __restrict__ rstd, const float* __restrict__ a_in,
                        const float* __restrict__ b_in, T* __restrict__ dx, Split s, int bstride,
                        int segs) {
  const Coord k = coord<V>(s);
  if (!k.live) return;
  constexpr int E = per_word<T, V>;
  const float* const q[3] = {rstd, a_in, b_in};
  SegCache<V, 3> sc(q, segs - 1, s, k.c0);
  struct Row {
    Raw<T, V> dy, x;
    int seg;
  };
  walk_rows<U_APPLY, Row>(
      k.r0 + k.j, k.r1, s.lanes,
      [&](int r, Row& w) {
        const size_t o = (size_t)r * s.c + k.c0;
        w.dy = ld<T, V>(dy + o);
        w.x = ld<T, V>(x + o);
        w.seg = apply_seg(mask[r], bidx[(size_t)r * bstride], segs - 1);
      },
      [&](int r, const Row& w) {
        sc.seek(q, w.seg, s, k.c0);
        const bool real = w.seg >= 0;
        const float m = real ? 1.f : 0.f;
        Raw<T, V> out;
#pragma unroll
        for (int i = 0; i < V / E; ++i) {
          float g[E], f[E], t[E];
          get<T, V>(w.dy, i, g);
          get<T, V>(w.x, i, f);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int v = i * E + e;
            const float rs = real ? sc.cur[0][v] : sc.pad[0][v];
            const float av = real ? sc.cur[1][v] : sc.pad[1][v];
            const float bv = real ? sc.cur[2][v] : sc.pad[2][v];
            // rounded where the plain version rounds (no fused multiply-add):
            // at a one-row scan a = -(g * rstd) and dx is exactly 0
            t[e] = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(g[e] * m, rs), av),
                                       __fmul_rn(bv, f[e] * m)),
                             m);
          }
          put<T, V>(out, i, t);
        }
        st<T, V>(dx + (size_t)r * s.c + k.c0, out);
      });
}

// The common checks of both entry points: the two splits (the sums' and
// the streaming pass's, each as bn_split chose it) and the segments.
bool in_ok(int n, int c, int bstride, int segs, const int (&rs)[6], const int (&as)[6], int dtype,
           std::initializer_list<const void*> sum_rows,
           std::initializer_list<const void*> apply_rows) {
  return segs >= 1 && segs <= MAX_SEGMENTS && bstride >= 0 && rs[4] <= MAX_SUM_BLOCKS &&
         split_ok(n, c, rs[0], rs[1], rs[2], rs[3], rs[4], rs[5], dtype, MAX_THREADS, sum_rows) &&
         split_ok(n, c, as[0], as[1], as[2], as[3], as[4], as[5], dtype, MAX_APPLY_THREADS,
                  apply_rows);
}

}  // namespace

// Both entry points take: n, c (x [n, c], contiguous; dtype 0 = float32,
// 1 = bfloat16), mask bool [n], bidx int32 with row r's batch id at
// bidx[r * bstride] (a column of coords), segs = S (num_batches + 1, at
// most 32); the sums' split (vec, gpb, lanes, steps, blocks, chunks; at
// most 512 threads and MAX_SUM_BLOCKS blocks) and the streaming pass's (at
// most 128 threads), each as ops/norm.py bn_split chose it; the partials
// [blocks, S, c] f32 and the bit words int32 [blocks] of the sums' split,
// which need no fill; the ticket (int32 [1], 0 on entry and exit, KG's).
// Each launches the sums, then the streaming pass (none when n is 0), and
// returns a cudaError_t (0 = launched; 1 = a split, a pointer's alignment
// or segs was refused).

// KK.  y [n, c] out; psum, psq the partials, pcnt int32 [blocks, S] the
// row counts; mean, var_raw, rstd f32 [S, c] and count f32 [S] out.
extern "C" int instance_norm_fwd(const void* x, const void* mask, const void* bidx, void* y,
                                 void* psum, void* psq, void* pcnt, void* pbits, void* mean,
                                 void* var_raw, void* rstd, void* count, void* ticket, int n,
                                 int c, int bstride, int segs, int vec, int gpb, int lanes,
                                 int steps, int blocks, int chunks, int avec, int agpb,
                                 int alanes, int asteps, int ablocks, int achunks, float eps,
                                 int dtype, void* stream) {
  const int rs[6] = {vec, gpb, lanes, steps, blocks, chunks};
  const int as[6] = {avec, agpb, alanes, asteps, ablocks, achunks};
  if (!in_ok(n, c, bstride, segs, rs, as, dtype, {x, psum, psq}, {x, y, mean, rstd}))
    return (int)cudaErrorInvalidValue;
  const Split s{n, c, gpb, lanes, steps}, a{n, c, agpb, alanes, asteps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dispatch(dtype, vec, [&](auto tag, auto vc) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(vc)::value;
    const int threads = gpb * lanes;
    in_stats_kernel<T, V><<<dim3(blocks, chunks), threads, 2 * V * threads * 4, st>>>(
        static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
        static_cast<const int*>(bidx), static_cast<float*>(psum), static_cast<float*>(psq),
        static_cast<int*>(pcnt), static_cast<int*>(pbits), static_cast<float*>(mean),
        static_cast<float*>(var_raw), static_cast<float*>(rstd), static_cast<float*>(count),
        static_cast<int*>(ticket), s, bstride, segs, eps);
  });
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return (int)err;
  dispatch(dtype, avec, [&](auto tag, auto vc) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(vc)::value;
    in_apply_kernel<T, V><<<dim3(ablocks, achunks), agpb * alanes, 0, st>>>(
        static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
        static_cast<const int*>(bidx), static_cast<const float*>(mean),
        static_cast<const float*>(rstd), static_cast<T*>(y), a, bstride, segs);
  });
  return (int)cudaGetLastError();
}

// KL.  dy [n, c]; mean, var_raw, rstd f32 [S, c] and count f32 [S] from KK;
// dx [n, c] out; ps1, ps2 the partials; a, b f32 [S, c] (the coefficients,
// between the two launches).
extern "C" int instance_norm_bwd(const void* dy, const void* x, const void* mask,
                                 const void* bidx, const void* mean, const void* var_raw,
                                 const void* rstd, const void* count, void* dx, void* ps1,
                                 void* ps2, void* pbits, void* a, void* b, void* ticket, int n,
                                 int c, int bstride, int segs, int vec, int gpb, int lanes,
                                 int steps, int blocks, int chunks, int avec, int agpb,
                                 int alanes, int asteps, int ablocks, int achunks, float eps,
                                 int dtype, void* stream) {
  const int rs[6] = {vec, gpb, lanes, steps, blocks, chunks};
  const int as[6] = {avec, agpb, alanes, asteps, ablocks, achunks};
  if (!in_ok(n, c, bstride, segs, rs, as, dtype, {dy, x, ps1, ps2, mean},
             {dy, x, dx, rstd, a, b}))
    return (int)cudaErrorInvalidValue;
  const Split s{n, c, gpb, lanes, steps}, sa{n, c, agpb, alanes, asteps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dispatch(dtype, vec, [&](auto tag, auto vc) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(vc)::value;
    const int threads = gpb * lanes;
    in_bwd_reduce_kernel<T, V><<<dim3(blocks, chunks), threads, 2 * V * threads * 4, st>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
        static_cast<const int*>(bidx), static_cast<const float*>(mean),
        static_cast<const float*>(var_raw), static_cast<const float*>(rstd),
        static_cast<const float*>(count), static_cast<float*>(ps1), static_cast<float*>(ps2),
        static_cast<int*>(pbits), static_cast<float*>(a), static_cast<float*>(b),
        static_cast<int*>(ticket), s, bstride, segs, eps);
  });
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return (int)err;
  dispatch(dtype, avec, [&](auto tag, auto vc) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(vc)::value;
    in_bwd_apply_kernel<T, V><<<dim3(ablocks, achunks), agpb * alanes, 0, st>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
        static_cast<const int*>(bidx), static_cast<const float*>(rstd),
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<T*>(dx), sa,
        bstride, segs);
  });
  return (int)cudaGetLastError();
}

// KI / KJ: the pooled BEV scatter-max of LiDOG's BEV branch and its
// backward.
//
// Replace lidog_tpu/ops/bev.py:93 (_pooled_scatter_max) and :115 (_psm_bwd),
// with the per-row candidate geometry of bev_scatter_pooled:31.  A voxel row
// n with coords (b, x, y, z) sits on dense pixel (px, py) = (x + grid/2,
// grid - 1 - (y + grid/2)); pooled output i covers dense pixels
// [i*stride - pad, i*stride - pad + window), so per axis the row reaches the
// outputs ceil((p - (window - 1 - pad)) / stride) .. floor((p + pad) / stride)
// inside [0, out_hw): at most cands = ceil(window / stride) of them (2 for
// window 5, stride 3).  Candidate j = dy * cands + dx.  A row is live when
// its mask is set, its pixel lies on the grid, 0 <= b < nb, and it reaches
// at least one output.
//
//   KI  out[b, iy, ix, c] = max(0, max over live (n, j) landing there of
//                               feats[n, c])
//   KJ  dfeats[n, c] = sum_j [live_j(n) and feats[n, c] == out[cell_j(n), c]]
//                            * dout[cell_j(n), c]
//       summed in f32 for j = 0, 1, ... in order and rounded once: every
//       row that ties the cell's maximum gets the cell's whole cotangent,
//       and a row whose value is 0 wins a cell whose maximum is 0.
//
// What bounds them on an H100: bytes.  KI writes the whole pooled grid
// ([4, 666, 666, 96] bf16, 340.65 MB, zero-filled as part of the op: the
// consumer, Encoder2D, reads it dense) and reads feats, coords and mask
// once: 0.132 ms at 3.35 TB/s, three quarters of it the fill.  KJ reads
// feats and the touched cells of out and dout, and writes dfeats: 0.072 ms.
// What held them back instead (PERF.md §6): each block's geometry, a
// chain of dependent loads (the mask byte, then coords) and divisions ahead
// of a barrier, and, in KI, a per-lane walk of branches; not the
// reductions.
//
// The design.  A block of TILE threads takes TILE consecutive rows, and
// each thread works out one row's geometry into shared memory (32-bit
// arithmetic; a row that is not live reads its mask byte and nothing else):
// TILE rows' chains in flight a block.  Thread t then takes the block's
// tasks t, t + TILE, ...  A task is one chunk of a run of rows: 16 bytes
// (8 bf16 or 4 f32) when a row is a multiple of 16 bytes and every pointer
// 16-byte aligned, else 4 bytes (a bf16 pair or one f32), so no channel
// count is refused.
//
// KI: a task walks a run of RUN_ROWS_BF16 or RUN_ROWS_F32 consecutive rows,
// loaded first.  A row's cells sit in slots (iy % cands, ix % cands), which
// its cells never share; the geometry pass writes each row's cell per slot
// once (int32).  The task keeps in registers the running max of the cell
// each slot holds: a row that reaches the held cell, or is not live, merges
// into it; otherwise the held cell is flushed with one reduction and the
// row's cell taken up.  All of it without branches: selects, and a
// reduction predicated in the instruction.  The rows come in canonical order
// (per scan, lex-sorted by x, y, z), so the rows of one column and the
// neighbouring y columns that share a pooled cell merge before one
// reduction, and no later row of the run reaches a flushed cell.  Values
// that are not > 0 (negatives, -0.0, NaN) first become +0: every stored
// value is then >= +0 and not NaN, for which the bits order like the
// values.  So the bf16 flush is one fire-and-forget vector max reduction
// of 16 bytes (red.global.max.noftz.v4.bf16x2; a 4-byte chunk: .v2.bf16),
// and the f32 one a signed-integer max reduction on each nonzero word
// (ptxas takes no vector form of a 32-bit max: `python -m
// lidog_tpu_torch.ablate_bev --probe`), so f32 holds its cells over twice
// the rows.  Max is order free: the result is the CAS loop's, bit for bit.
// A chunk whose values are all +0 issues nothing.  Above MAX_CANDS cells per
// axis (pool stride 1), or on a grid of 2^31 cells or more, each live (row,
// candidate) reduces directly.
//
// KJ: a task is one chunk of one row.  It reads the chunk of feats, then at
// each live candidate, unrolled so that every gather is in flight before
// the first sum, the chunk of out and of dout, adds the tying terms in f32
// in order j and stores one chunk of dfeats.  Rows that are not live store
// zeros and read nothing else.  No atomics; deterministic.
//
// The zero fill is a cudaMemsetAsync on the same stream before KI's
// scatter, at the card's memory rate: a kernel of 16-byte stores was ~1%
// (about 0.001 ms) faster in every ablation run and was not kept, so that
// the fill stays one path (the profiler's `Memset`).
//
// Built with -DBEV_COUNT_REDUCTIONS (`python -m lidog_tpu_torch.ablate_bev
// --count`), KI also counts its flushes and the reductions they issue.
//
// Dropped (PERF.md §6): the bf16 atomicCAS loop (two dependent L2 round
// trips at 4-byte grain a cell); a thread a channel pair that redid its
// row's geometry after a 64-bit division; blocks of 21 runs whose geometry
// fell to a few threads, and a walk of branches on 64-bit cell ids (the
// first design); runs of 8 rows in bf16, of 4 or 16 in f32; tiles of 128
// or 512 rows; the next task's rows loaded during the walk; two KJ tasks
// unrolled; a fill kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <initializer_list>

namespace {

constexpr int TILE = 256;     // rows a block, one thread a row's geometry
constexpr int RUN_ROWS_BF16 = 4;  // KI: consecutive rows a task walks, bf16
constexpr int RUN_ROWS_F32 = 8;   // and f32 (4 atomics a chunk: hold longer)
constexpr int MAX_CANDS = 3;  // KI holds, KJ unrolls, up to this many per axis
constexpr int DEAD = -2;      // KI's slot cell of a row that is not live

struct Geom {
  int nb, grid, out_hw, window, stride, pad, cands;
};

// The work split (test_bev_blocked_model models it): `words` 32-bit words
// a chunk, `chunks` a row; a block of TILE threads takes TILE rows,
// `runs` runs of `run_rows` rows, and its `tasks` = runs * chunks (run,
// chunk) pairs, thread t the tasks t, t + TILE, ...
struct Split {
  int words, chunks, runs, tasks;
  unsigned blocks;
};

Split make_split(int n, int c, int esz, bool wide, int run_rows) {
  Split s;
  s.words = wide ? 4 : 1;
  s.chunks = c * esz / (4 * s.words);
  s.runs = TILE / run_rows;
  s.tasks = s.runs * s.chunks;
  s.blocks = (unsigned)((n + TILE - 1) / TILE);
  return s;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// A row's geometry: (b, first iy, first ix, ny | nx << 16), or b = -1 when
// the row is not live.
__device__ __forceinline__ int4 row_geo(const int* __restrict__ coords,
                                        const uint8_t* __restrict__ mask, int row, int n,
                                        const Geom& g) {
  const int4 dead = make_int4(-1, 0, 0, 0);
  if (row >= n || !__ldg(mask + row)) return dead;
  const int4 c = __ldg(reinterpret_cast<const int4*>(coords) + row);
  const int half = g.grid / 2;
  const int px = c.y + half;
  const int py = (g.grid - 1) - (c.z + half);
  if (c.x < 0 || c.x >= g.nb || px < 0 || px >= g.grid || py < 0 || py >= g.grid) return dead;
  const int back = g.window - 1 - g.pad;
  const int ylo = max(-floor_div(back - py, g.stride), 0);
  const int yhi = min(floor_div(py + g.pad, g.stride), g.out_hw - 1);
  const int xlo = max(-floor_div(back - px, g.stride), 0);
  const int xhi = min(floor_div(px + g.pad, g.stride), g.out_hw - 1);
  if (ylo > yhi || xlo > xhi) return dead;
  return make_int4(c.x, ylo, xlo, (yhi - ylo + 1) | ((xhi - xlo + 1) << 16));
}

// The block's TILE rows, one a thread, into shared memory.
__device__ __forceinline__ void tile_geo(int4* geo, const int* __restrict__ coords,
                                         const uint8_t* __restrict__ mask, int row0, int n,
                                         const Geom& g) {
  geo[threadIdx.x] = row_geo(coords, mask, row0 + threadIdx.x, n, g);
  __syncthreads();
}

__device__ __forceinline__ long long first_cell(const int4& q, int out_hw) {
  return ((long long)q.x * out_hw + q.y) * out_hw + q.z;
}

template <int W>
struct Chunk {
  uint32_t w[W];
};

template <int W>
__device__ __forceinline__ Chunk<W> load(const uint32_t* p) {
  Chunk<W> v;
  if constexpr (W == 4) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    v.w[0] = q.x, v.w[1] = q.y, v.w[2] = q.z, v.w[3] = q.w;
  } else {
    v.w[0] = __ldg(p);
  }
  return v;
}

template <int W>
__device__ __forceinline__ Chunk<W> zero_chunk() {
  Chunk<W> v;
#pragma unroll
  for (int i = 0; i < W; ++i) v.w[i] = 0u;
  return v;
}

// Values that are not > 0 take the bits of +0: > 0 is the bits 1 .. +inf.
template <bool BF16, int W>
__device__ __forceinline__ Chunk<W> positive(Chunk<W> v) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (BF16) {
      const uint32_t lo = v.w[i] & 0xFFFFu, hi = v.w[i] >> 16;
      v.w[i] = (lo - 1u < 0x7F80u ? lo : 0u) | (hi - 1u < 0x7F80u ? hi << 16 : 0u);
    } else {
      v.w[i] = v.w[i] - 1u < 0x7F800000u ? v.w[i] : 0u;
    }
  }
  return v;
}

// a = keep ? max(a, b) : b, for chunks of values >= +0, not NaN (the max
// of their bits).
template <bool BF16, int W>
__device__ __forceinline__ void merge_or_set(Chunk<W>& a, const Chunk<W>& b, bool keep) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint32_t m = BF16 ? __vmaxu2(a.w[i], b.w[i]) : max(a.w[i], b.w[i]);
    a.w[i] = keep ? m : b.w[i];
  }
}

template <int W>
__device__ __forceinline__ bool nonzero(const Chunk<W>& v) {
  uint32_t any = 0u;
#pragma unroll
  for (int i = 0; i < W; ++i) any |= v.w[i];
  return any != 0u;
}

#ifdef BEV_COUNT_REDUCTIONS
// [0] chunks flushed, [1] reduction instructions issued
__device__ unsigned long long bev_counts[2];
#endif

// One reduction of a chunk into the grid at p when `on` (nothing for a
// chunk of +0), predicated in the instruction: no branch.
template <bool BF16, int W>
__device__ __forceinline__ void flush(uint32_t* p, const Chunk<W>& v, bool on) {
#ifdef BEV_COUNT_REDUCTIONS
  if (on) {
    unsigned long long issued = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) issued += v.w[i] != 0u;
    atomicAdd(&bev_counts[0], 1ull);
    atomicAdd(&bev_counts[1], BF16 ? (unsigned long long)(issued != 0) : issued);
  }
#endif
  if constexpr (BF16 && W == 4) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.u32 p, %5, 0;\n"
        " @p red.global.max.noftz.v4.bf16x2 [%0], {%1, %2, %3, %4};\n}" ::"l"(p),
        "r"(v.w[0]), "r"(v.w[1]), "r"(v.w[2]), "r"(v.w[3]), "r"((uint32_t)(on && nonzero(v)))
        : "memory");
  } else if constexpr (BF16) {
    const unsigned short lo = (unsigned short)(v.w[0] & 0xFFFFu);
    const unsigned short hi = (unsigned short)(v.w[0] >> 16);
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.u32 p, %3, 0;\n"
        " @p red.global.max.noftz.v2.bf16 [%0], {%1, %2};\n}" ::"l"(p),
        "h"(lo), "h"(hi), "r"((uint32_t)(on && v.w[0] != 0u))
        : "memory");
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i)
      asm volatile(
          "{\n .reg .pred p;\n setp.ne.u32 p, %2, 0;\n"
          " @p red.global.max.s32 [%0], %1;\n}" ::"l"(p + i),
          "r"(v.w[i]), "r"((uint32_t)(on && v.w[i] != 0u))
          : "memory");
  }
}

// The R rows of task t's run, chunk t % chunks: +0 for a row that is not
// live, which loads nothing.
template <bool BF16, int W, int R>
__device__ __forceinline__ void load_run(Chunk<W> (&v)[R], const uint32_t* __restrict__ feats,
                                         const int* slot, int row0, int t, int chunks,
                                         int words) {
  const int run = t / chunks;
  const int col = (t - run * chunks) * W;
#pragma unroll
  for (int i = 0; i < R; ++i)
    v[i] = slot[run * R + i] != DEAD
               ? positive<BF16>(load<W>(feats + (size_t)(row0 + run * R + i) * words + col))
               : zero_chunk<W>();
}

// KI, cells held.  slot[k * TILE + r]: the cell of tile row r in slot k
// (iy % CANDS, ix % CANDS), -1 when the row reaches none there, DEAD for a
// row that is not live.  Cells fit 31 bits (the launcher checks).
template <bool BF16, int W, int CANDS, int R>
__global__ void __launch_bounds__(TILE)
    scatter_max_held_kernel(const uint32_t* __restrict__ feats, const int* __restrict__ coords,
                            const uint8_t* __restrict__ mask, uint32_t* out, int n, int words,
                            Geom g, Split s) {
  constexpr int K = CANDS * CANDS;
  extern __shared__ int slot[];
  const int row0 = blockIdx.x * TILE;
  {
    const int4 q = row_geo(coords, mask, row0 + threadIdx.x, n, g);
    const int base = (q.x * g.out_hw + q.y) * g.out_hw + q.z;
    const int ny = q.w & 0xFFFF, nx = q.w >> 16;
    const int ry = q.y % CANDS, rx = q.z % CANDS;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int dy = (k / CANDS - ry + CANDS) % CANDS, dx = (k % CANDS - rx + CANDS) % CANDS;
      slot[k * TILE + threadIdx.x] =
          q.x < 0 ? DEAD : dy < ny && dx < nx ? base + dy * g.out_hw + dx : -1;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < s.tasks; t += TILE) {
    const int run = t / s.chunks;
    const int col = (t - run * s.chunks) * W;
    const int r0 = run * R;
    Chunk<W> v[R];
    load_run<BF16>(v, feats, slot, row0, t, s.chunks, words);
    int held[K];  // the cell of each slot, or -1
    Chunk<W> hv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) held[k] = -1, hv[k] = zero_chunk<W>();
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        // a row that is not live keeps every slot (its chunk is +0)
        const int cell = slot[k * TILE + r0 + i];
        const bool keep = cell == held[k] || cell == DEAD;
        flush<BF16>(out + (size_t)(unsigned)held[k] * words + col, hv[k], !keep && held[k] >= 0);
        merge_or_set<BF16>(hv[k], v[i], keep);
        held[k] = keep ? held[k] : cell;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      flush<BF16>(out + (size_t)(unsigned)held[k] * words + col, hv[k], held[k] >= 0);
  }
}

// KI, each live (row, candidate) reduced directly: above MAX_CANDS cells per
// axis, or a grid of 2^31 cells or more.
template <bool BF16, int W, int R>
__global__ void __launch_bounds__(TILE)
    scatter_max_direct_kernel(const uint32_t* __restrict__ feats, const int* __restrict__ coords,
                              const uint8_t* __restrict__ mask, uint32_t* out, int n, int words,
                              Geom g, Split s) {
  __shared__ int4 geo[TILE];
  const int row0 = blockIdx.x * TILE;
  tile_geo(geo, coords, mask, row0, n, g);
  for (int t = threadIdx.x; t < s.tasks; t += TILE) {
    const int run = t / s.chunks;
    const int col = (t - run * s.chunks) * W;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = run * R + i;
      const int4 q = geo[r];
      if (q.x < 0) continue;
      const Chunk<W> v = positive<BF16>(load<W>(feats + (size_t)(row0 + r) * words + col));
      const long long base = first_cell(q, g.out_hw);
      const int ny = q.w & 0xFFFF, nx = q.w >> 16;
      for (int dy = 0; dy < ny; ++dy)
        for (int dx = 0; dx < nx; ++dx)
          flush<BF16>(out + (size_t)(base + (long long)dy * g.out_hw + dx) * words + col, v,
                      true);
    }
  }
}

// The E values of a chunk as f32, and back (rounded to nearest even once).
template <bool BF16, int W>
__device__ __forceinline__ void to_f32(const Chunk<W>& v, float* f) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (BF16) {
      f[2 * i] = __uint_as_float(v.w[i] << 16);
      f[2 * i + 1] = __uint_as_float(v.w[i] & 0xFFFF0000u);
    } else {
      f[i] = __uint_as_float(v.w[i]);
    }
  }
}

template <bool BF16, int W>
__device__ __forceinline__ void store(uint32_t* p, const float* f) {
  Chunk<W> v;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (BF16) {
      v.w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i])) |
               ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1])) << 16);
    } else {
      v.w[i] = __float_as_uint(f[i]);
    }
  }
  if constexpr (W == 4)
    *reinterpret_cast<uint4*>(p) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  else
    *p = v.w[0];
}

// The tying terms of one cell's chunk of out (o) and dout (d) added to acc.
template <bool BF16, int W>
__device__ __forceinline__ void add_ties(const float* f, const Chunk<W>& o, const Chunk<W>& d,
                                         float* acc) {
  constexpr int E = BF16 ? 2 * W : W;
  float of[E], df[E];
  to_f32<BF16>(o, of);
  to_f32<BF16>(d, df);
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (f[e] == of[e]) acc[e] += df[e];
}

// KJ: a task is one chunk of one row (runs of one row).  Up to MAX_CANDS
// cells per axis the candidates are unrolled, so that every gather of the
// row is in flight before the first sum; above it they are walked in a loop.
template <bool BF16, int W, int CANDS>
__global__ void __launch_bounds__(TILE)
    scatter_max_bwd_kernel(const uint32_t* __restrict__ feats, const int* __restrict__ coords,
                           const uint8_t* __restrict__ mask, const uint32_t* __restrict__ out,
                           const uint32_t* __restrict__ dout, uint32_t* __restrict__ dfeats, int n,
                           int words, Geom g, Split s) {
  constexpr int E = BF16 ? 2 * W : W;
  __shared__ int4 geo[TILE];
  const int row0 = blockIdx.x * TILE;
  tile_geo(geo, coords, mask, row0, n, g);
  const int tasks = n - row0 >= TILE ? s.tasks : (n - row0) * s.chunks;
#pragma unroll 1
  for (int t = threadIdx.x; t < tasks; t += TILE) {
    const int r = t / s.chunks;
    const int row = row0 + r;
    const int col = (t - r * s.chunks) * W;
    const int4 q = geo[r];
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    if (q.x >= 0) {
      float f[E];
      to_f32<BF16>(load<W>(feats + (size_t)row * words + col), f);
      const long long base = first_cell(q, g.out_hw);
      const int ny = q.w & 0xFFFF, nx = q.w >> 16;
      if constexpr (CANDS > 0) {
        constexpr int K = CANDS * CANDS;
        Chunk<W> o[K], d[K];
#pragma unroll
        for (int j = 0; j < K; ++j)
          if (j / CANDS < ny && j % CANDS < nx) {
            const size_t at =
                (size_t)(base + (long long)(j / CANDS) * g.out_hw + j % CANDS) * words + col;
            o[j] = load<W>(out + at);
            d[j] = load<W>(dout + at);
          }
#pragma unroll
        for (int j = 0; j < K; ++j)  // candidate order j
          if (j / CANDS < ny && j % CANDS < nx) add_ties<BF16>(f, o[j], d[j], acc);
      } else {
        for (int dy = 0; dy < ny; ++dy)
          for (int dx = 0; dx < nx; ++dx) {  // candidate order j
            const size_t at = (size_t)(base + (long long)dy * g.out_hw + dx) * words + col;
            add_ties<BF16>(f, load<W>(out + at), load<W>(dout + at), acc);
          }
      }
    }
    store<BF16, W>(dfeats + (size_t)row * words + col, acc);
  }
}

Geom make_geom(int nb, int grid, int out_hw, int window, int stride, int pad) {
  return Geom{nb, grid, out_hw, window, stride, pad, (window + stride - 1) / stride};
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

template <bool BF16, int W>
cudaError_t launch_fwd(const void* feats, const int* co, const uint8_t* m, void* out, int n,
                       int c, const Geom& g, cudaStream_t st) {
  constexpr int R = BF16 ? RUN_ROWS_BF16 : RUN_ROWS_F32;
  const Split s = make_split(n, c, BF16 ? 2 : 4, W == 4, R);
  const int words = c * (BF16 ? 2 : 4) / 4;
  auto f = static_cast<const uint32_t*>(feats);
  auto o = static_cast<uint32_t*>(out);
  const bool held = g.cands <= MAX_CANDS && (long long)g.nb * g.out_hw * g.out_hw < INT_MAX;
  const size_t smem = (size_t)g.cands * g.cands * TILE * sizeof(int);
  switch (held ? g.cands : 0) {
    case 1:
      scatter_max_held_kernel<BF16, W, 1, R><<<s.blocks, TILE, smem, st>>>(f, co, m, o, n, words, g,
                                                                        s);
      break;
    case 2:
      scatter_max_held_kernel<BF16, W, 2, R><<<s.blocks, TILE, smem, st>>>(f, co, m, o, n, words, g,
                                                                        s);
      break;
    case 3:
      scatter_max_held_kernel<BF16, W, 3, R><<<s.blocks, TILE, smem, st>>>(f, co, m, o, n, words, g,
                                                                        s);
      break;
    default:
      scatter_max_direct_kernel<BF16, W, R><<<s.blocks, TILE, 0, st>>>(f, co, m, o, n, words, g, s);
  }
  return cudaGetLastError();
}

template <bool BF16, int W>
cudaError_t launch_bwd(const void* feats, const int* co, const uint8_t* m, const void* out,
                       const void* dout, void* dfeats, int n, int c, const Geom& g,
                       cudaStream_t st) {
  const Split s = make_split(n, c, BF16 ? 2 : 4, W == 4, 1);
  const int words = c * (BF16 ? 2 : 4) / 4;
  auto f = static_cast<const uint32_t*>(feats);
  auto o = static_cast<const uint32_t*>(out);
  auto d = static_cast<const uint32_t*>(dout);
  auto df = static_cast<uint32_t*>(dfeats);
  switch (g.cands > MAX_CANDS ? 0 : g.cands) {
    case 1:
      scatter_max_bwd_kernel<BF16, W, 1><<<s.blocks, TILE, 0, st>>>(f, co, m, o, d, df, n, words,
                                                                    g, s);
      break;
    case 2:
      scatter_max_bwd_kernel<BF16, W, 2><<<s.blocks, TILE, 0, st>>>(f, co, m, o, d, df, n, words,
                                                                    g, s);
      break;
    case 3:
      scatter_max_bwd_kernel<BF16, W, 3><<<s.blocks, TILE, 0, st>>>(f, co, m, o, d, df, n, words,
                                                                    g, s);
      break;
    default:
      scatter_max_bwd_kernel<BF16, W, 0><<<s.blocks, TILE, 0, st>>>(f, co, m, o, d, df, n, words,
                                                                    g, s);
  }
  return cudaGetLastError();
}

}  // namespace

// KI.  feats [n, c] (dtype 0 f32, 1 bf16; c even for bf16), coords int32
// [n, 4], mask bool [n] -> out [nb, out_hw, out_hw, c], zero-filled here.
extern "C" int bev_scatter_max_fwd(const void* feats, const void* coords, const void* mask,
                                   void* out, int n, int c, int nb, int grid, int out_hw,
                                   int window, int stride, int pad, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g = make_geom(nb, grid, out_hw, window, stride, pad);
  const int esz = dtype == 1 ? 2 : 4;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)nb * out_hw * out_hw * c * esz, s);
  if (err != cudaSuccess) return (int)err;
  if (n == 0 || c == 0) return (int)cudaGetLastError();
  const int* co = static_cast<const int*>(coords);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const bool wide = (c * esz) % 16 == 0 && aligned16({feats, out});
  if (dtype == 1)
    err = wide ? launch_fwd<true, 4>(feats, co, m, out, n, c, g, s)
               : launch_fwd<true, 1>(feats, co, m, out, n, c, g, s);
  else
    err = wide ? launch_fwd<false, 4>(feats, co, m, out, n, c, g, s)
               : launch_fwd<false, 1>(feats, co, m, out, n, c, g, s);
  return (int)err;
}

// KJ.  out and dout [nb, out_hw, out_hw, c] like feats -> dfeats [n, c].
extern "C" int bev_scatter_max_bwd(const void* feats, const void* coords, const void* mask,
                                   const void* out, const void* dout, void* dfeats, int n, int c,
                                   int nb, int grid, int out_hw, int window, int stride, int pad,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g = make_geom(nb, grid, out_hw, window, stride, pad);
  if (n == 0 || c == 0) return (int)cudaGetLastError();
  const int esz = dtype == 1 ? 2 : 4;
  const int* co = static_cast<const int*>(coords);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const bool wide = (c * esz) % 16 == 0 && aligned16({feats, out, dout, dfeats});
  cudaError_t err;
  if (dtype == 1)
    err = wide ? launch_bwd<true, 4>(feats, co, m, out, dout, dfeats, n, c, g, s)
               : launch_bwd<true, 1>(feats, co, m, out, dout, dfeats, n, c, g, s);
  else
    err = wide ? launch_bwd<false, 4>(feats, co, m, out, dout, dfeats, n, c, g, s)
               : launch_bwd<false, 1>(feats, co, m, out, dout, dfeats, n, c, g, s);
  return (int)err;
}

#ifdef BEV_COUNT_REDUCTIONS
// The counts since the last call (chunks flushed, reductions issued); zeroes them.
extern "C" int bev_take_counts(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, bev_counts, sizeof(bev_counts));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[2] = {0ull, 0ull};
  return (int)cudaMemcpyToSymbol(bev_counts, zero, sizeof(zero));
}
#endif

// KF, zconv3 form: the weight gradient of the k=3 column-fused sparse conv.
//
// Replaces lidog_tpu/ops/zconv.py:268-273 (_zconv3_bwd dW, one batched
// einsum of zcat(x)^T with the 9 stacked gathers of dout):
//
//   dW[3*o + t] = sum over rows r of A_t(r)^T (outer) G_o(r)      [27, Cin, Cout]
//
//   A_0(r) = zdn[r] ? x[r-1] : 0,  A_1(r) = x[r],  A_2(r) = zup[r] ? x[r+1] : 0
//   G_o(r) = d(nbr9[8-o, r]) (o != 4), d(r) (o == 4),  d(s) = dout[s] * dout_mask[s]
//
// (nbr9 = -1 or out of range: no contribution), summed in f32 and rounded
// once to x's dtype, as JAX does (preferred_element_type=f32, then astype).
//
// Bound on an H100: bytes at the main path's widths (x and dout read once,
// 27 x Cin x Cout written once); the sparse products (~5 of the 27 (o, t)
// pairs per row exist) stay below the tensor cores' reach of those bytes.
//
// Design.  The 27 offsets are 9 xy neighbours x 3 z taps, and the three
// taps of one xy offset share G_o and read consecutive rows of x.  A block
// owns one xy offset o, a Cin slab of BM and a Cout slab of BN columns
// (multiples of 32), and a strided set of RK-row steps (128 rows in bf16,
// 64 in f32; step s = c, c + chunks, ...: every block sees rows from the
// whole level, so padding rows do not idle a few blocks).  Its warps hold
// the f32 sums of 32 x 32 tiles for all three taps in registers for the
// whole run; KS warps share each tile, each taking RK / KS rows of every
// step (narrow slabs get more warps), and write their own partial sums.
// Per step the block gathers the G_o rows once into shared memory, in
// 16-byte cp.async pieces spread over its threads, and loads the window
// of the RK + 2 x rows r0-1 .. r0+RK once, as 2-D TMA boxes of 64 bytes
// of columns (cp.async.bulk.tensor, 64-byte swizzle, rows outside the
// level zero-filled), which complete on the stage's mbarrier.  (The TMA
// unit takes one request at a time: a bulk copy per window row made a
// step's copies cost more than its MMAs, and one per G row held back the
// narrow f32 slabs.)  The window feeds the three taps as row-shifted
// views.  The z masks, the level's ends and the dout mask are folded
// into one tap byte per row; each 32-row list of a step puts its live
// rows first, so that rows which contribute nothing cost no MMA (ldmatrix
// takes a row address per lane: the 16-row blocks gather their rows from
// the tiles as they stand), and the tap bits zero a live row's dead taps
// in the A fragments.  bf16: mma.sync m16n8k16, A = the x window
// transposed and B = the G tile, both by ldmatrix.trans, f32
// accumulators; f32: a 4 x 8 register tile of FMAs per lane and tap, dead
// rows skipped.  The ring: the step's map slice (nbr9, zdn, zup;
// cp.async) four steps ahead, the dout-mask words and G rows (cp.async)
// and the x window (TMA) two steps ahead, three stages; one lane per warp
// arrives on a stage's barrier with its warp's bytes.  Each warp writes
// its f32 [3, 32, 32] tiles to partial[c * KS + k]; a second kernel sums
// partial in order and rounds, so the result does not depend on the
// blocks' order.  The wrapper (ops/zconv.py zconv3_wgrad_split) picks BM,
// BN, KS and chunks.
#include <cuda.h>  // CUtensorMap (the encoder is taken from the driver at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// level rows per step: 128 in bf16, 64 in f32 (its tiles take twice the
// shared memory); the x window holds rows r0 - 1 .. r0 + RK
template <typename T>
constexpr int kRows = sizeof(T) == 2 ? 128 : 64;
constexpr int STAGES = 3;  // G / x / mask-word ring
constexpr int META = 8;    // map-slice ring (four steps ahead)
constexpr int MAX_WARPS = 12;

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, of which the first `bytes` are read
// and the rest zero-filled
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// TMA: one box of a 2-D tensor map (rows outside the tensor read as zero)
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map, int col, int row,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// The x window of a stage: boxes of 64-byte rows (32 bf16 / 16 f32
// columns each), written by the TMA with the 64-byte swizzle (the 16-byte
// chunk c of row w sits at chunk c ^ ((w >> 1) & 3)), so the 8 rows an
// ldmatrix or a lane group reads fall in distinct banks.  Box b of a stage
// starts at b * XBOX bytes.
template <int RK>
constexpr int kXBox = ((RK + 2) * 64 + 1023) / 1024 * 1024;
template <typename T>
__device__ __forceinline__ const T* xrow(const unsigned char* X, int w, int col) {
  constexpr int EPB = 64 / sizeof(T);  // elements per box row
  const int b = col / EPB, byte = (col % EPB) * (int)sizeof(T);
  return reinterpret_cast<const T*>(X + b * kXBox<kRows<T>> + w * 64 +
                                    (((byte >> 4) ^ ((w >> 1) & 3)) << 4) + (byte & 15));
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned& r0, unsigned& r1, unsigned& r2, unsigned& r3,
                                          const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's three [32 x 32] tap tiles.
template <typename T>
struct Acc;

template <>
struct Acc<__nv_bfloat16> {
  float c[3][2][4][4];  // tap, m16 tile, n8 tile, fragment
  __device__ void zero() {
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[t][i][j][e] = 0.0f;
  }
  // One step.  G: [RK][gp], X: the x window (xrow; window row w = level
  // row r0 - 1 + w).  The step's rows come as RK / 32 lists of 32 (lrow: the
  // row, ltap: its tap byte, bit t = tap t's A row is live), each with its
  // live rows first (lcnt of them); this warp takes the lists kgrp, kgrp +
  // ks, ... and runs 16-row blocks up to each list's count, so rows that
  // contribute nothing cost no MMA.  ldmatrix takes a row address per lane,
  // so the blocks gather their rows from the tiles as they stand.
  __device__ void step(const __nv_bfloat16* G, int gp, const unsigned char* X,
                       const uint8_t*, const uint8_t* lrow, const uint8_t* ltap,
                       const int* lcnt, int m0, int n0, int kgrp, int ks) {
    constexpr int RK = kRows<__nv_bfloat16>;
    const int lane = threadIdx.x & 31, tig = lane & 3;
    for (int w = kgrp; w < RK / 32; w += ks) {
      const uint8_t* rows = lrow + 32 * w;
      const uint8_t* tb = ltap + 32 * w;
      const int n = lcnt[w];
      for (int kk = 0; kk < n; kk += 16) {
        const uint4 tw = *reinterpret_cast<const uint4*>(tb + kk);  // the 16 rows' bytes
        const unsigned any = tw.x | tw.y | tw.z | tw.w;
        const unsigned live_taps = (any | (any >> 8) | (any >> 16) | (any >> 24)) & 7;
        const int kr = kk + 2 * tig;
        const unsigned t0 = tb[kr], t1 = tb[kr + 1], t8 = tb[kr + 8], t9 = tb[kr + 9];
        const int rb = rows[kk + (lane & 7) + ((lane >> 3) & 1) * 8];  // this lane's B row
        const int ra = rows[kk + (lane & 7) + (lane >> 4) * 8];        // and A row
        unsigned b[4][2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int col = n0 + p * 16 + (lane >> 4) * 8;
          ldsm_x4_t(b[2 * p][0], b[2 * p][1], b[2 * p + 1][0], b[2 * p + 1][1],
                    G + rb * gp + col);
        }
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          if (!((live_taps >> t) & 1)) continue;
          const unsigned lo =
              (((t0 >> t) & 1) ? 0xffffu : 0u) | (((t1 >> t) & 1) ? 0xffff0000u : 0u);
          const unsigned hi =
              (((t8 >> t) & 1) ? 0xffffu : 0u) | (((t9 >> t) & 1) ? 0xffff0000u : 0u);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            unsigned a[4];
            const int col = m0 + i * 16 + ((lane >> 3) & 1) * 8;
            ldsm_x4_t(a[0], a[1], a[2], a[3], xrow<__nv_bfloat16>(X, ra + t, col));
            a[0] &= lo;
            a[1] &= lo;
            a[2] &= hi;
            a[3] &= hi;
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(c[t][i][j], a, b[j][0], b[j][1]);
          }
        }
      }
    }
  }
  // partial [3][cin][cout] at the tile's (ci, co)
  __device__ void store(float* out, int cin, int cout, int m0, int n0) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* p = out + ((size_t)t * cin + m0 + i * 16 + g) * cout + n0 + j * 8 + 2 * tig;
          *reinterpret_cast<float2*>(p) = make_float2(c[t][i][j][0], c[t][i][j][1]);
          *reinterpret_cast<float2*>(p + 8 * (size_t)cout) =
              make_float2(c[t][i][j][2], c[t][i][j][3]);
        }
  }
};

template <>
struct Acc<float> {
  float c[3][4][8];  // tap, 4 Cin rows, 8 Cout columns of this lane
  __device__ void zero() {
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) c[t][i][j] = 0.0f;
  }
  // One step: rows [kgrp, kgrp + 1) * RK / ks, skipping rows whose tap
  // byte (tap: [RK], dense) is 0.
  __device__ void step(const float* G, int gp, const unsigned char* X, const uint8_t* tap,
                       const uint8_t*, const uint8_t*, const int*, int m0, int n0, int kgrp,
                       int ks) {
    constexpr int RK = kRows<float>;
    const int k0 = kgrp * (RK / ks), k1 = k0 + RK / ks;
    const int lane = threadIdx.x & 31;
    const int mi = m0 + (lane >> 2) * 4, nj = n0 + (lane & 3) * 8;
#pragma unroll 2
    for (int k = k0; k < k1; ++k) {
      const unsigned tk = tap[k];  // warp-uniform
      if (tk == 0) continue;
      const float4 b0 = *reinterpret_cast<const float4*>(G + k * gp + nj);
      const float4 b1 = *reinterpret_cast<const float4*>(G + k * gp + nj + 4);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        if (!((tk >> t) & 1)) continue;
        const float4 av = *reinterpret_cast<const float4*>(xrow<float>(X, k + t, mi));
        const float a[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) c[t][i][j] = fmaf(a[i], b[j], c[t][i][j]);
      }
    }
  }
  __device__ void store(float* out, int cin, int cout, int m0, int n0) const {
    const int lane = threadIdx.x & 31;
    const int mi = m0 + (lane >> 2) * 4, nj = n0 + (lane & 3) * 8;
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* p = out + ((size_t)t * cin + mi + i) * cout + nj;
        *reinterpret_cast<float4*>(p) = make_float4(c[t][i][0], c[t][i][1], c[t][i][2], c[t][i][3]);
        *reinterpret_cast<float4*>(p + 4) =
            make_float4(c[t][i][4], c[t][i][5], c[t][i][6], c[t][i][7]);
      }
  }
};

// One step's map slice: source rows of G (o != 4) and the z flags.
template <int RK>
struct Meta {
  int src[RK];
  uint8_t zdn[RK];
  uint8_t zup[RK];
};

// Shared memory of one block: the x window ring (swizzled boxes, first,
// 1024-byte aligned), the G ring (rows padded by 16 bytes), the stage
// barriers, the map-slice ring, the dout-mask words and the current step's
// tap bytes and row lists.
__host__ __device__ constexpr size_t pitch(int width, int esz) {  // elements
  return (size_t)width + 16 / esz;
}
template <typename T>
size_t smem_bytes(int bm, int bn) {
  constexpr int RK = kRows<T>, esz = sizeof(T);
  return STAGES * ((size_t)(bm * esz / 64) * kXBox<RK> + RK * pitch(bn, esz) * esz) + 32 +
         META * sizeof(Meta<RK>) + STAGES * RK * sizeof(unsigned) + 3 * RK + RK / 32 * 4;
}

template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
zconv3_wgrad_kernel(const __grid_constant__ CUtensorMap xmap, const T* __restrict__ dout,
                    const int* __restrict__ nbr9, const uint8_t* __restrict__ zup,
                    const uint8_t* __restrict__ zdn, const uint8_t* __restrict__ dmask,
                    float* __restrict__ partial, int na, int cin, int cout, int bm, int bn,
                    int ks, int chunks) {
  constexpr int RK = kRows<T>, WIN = RK + 2, XBOX = kXBox<RK>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int gp = (int)pitch(bn, sizeof(T)), nbox = bm * (int)sizeof(T) / 64;
  unsigned char* Xs = smem;  // [STAGES][nbox][XBOX]
  T* Gs = reinterpret_cast<T*>(Xs + (size_t)STAGES * nbox * XBOX);
  uint64_t* bar = reinterpret_cast<uint64_t*>(Gs + (size_t)STAGES * RK * gp);
  Meta<RK>* meta = reinterpret_cast<Meta<RK>*>(bar + 4);  // (32 bytes of barriers)
  unsigned* mw = reinterpret_cast<unsigned*>(meta + META);  // [STAGES][RK]
  uint8_t* tap = reinterpret_cast<uint8_t*>(mw + STAGES * RK);  // [RK] dense
  uint8_t* lrow = tap + RK;   // [RK / 32][32] the rows, live ones first
  uint8_t* ltap = lrow + RK;  // their tap bytes
  int* lcnt = reinterpret_cast<int*>(ltap + RK);  // [RK / 32] live rows per list

  const int tid = threadIdx.x, nthreads = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int nslabs = cout / bn, mslabs = cin / bm;
  const int o = blockIdx.x / (mslabs * nslabs);
  const int ci0 = (blockIdx.x / nslabs) % mslabs * bm;
  const int co0 = blockIdx.x % nslabs * bn;
  const int c = blockIdx.y;
  const int steps = (na + RK - 1) / RK;
  const int nq = c < steps ? (steps - c + chunks - 1) / chunks : 0;
  // this warp's tile and its share of each step's rows
  const int tiles = (bm / 32) * (bn / 32);
  const int tile = warp % tiles, kgrp = warp / tiles;
  const int m0 = (tile / (bn / 32)) * 32, n0 = (tile % (bn / 32)) * 32;
  const int* nrow = nbr9 + (size_t)(8 - o) * na;
  const int g_pieces = bn * (int)sizeof(T) / 16;  // 16-byte pieces of a G row

  auto row0 = [&](int q) { return (c + q * chunks) * RK; };
  // source row of G for row r0 + j of step q (meta slice q must be in place)
  auto src_of = [&](int q, int j) {
    const int r = row0(q) + j;
    if (q >= nq || r >= na) return -1;
    const int s = (o == 4) ? r : meta[q % META].src[j];
    return (s >= 0 && s < na) ? s : -1;
  };
  auto issue_meta = [&](int q) {  // the map slice of step q
    if (q >= nq) return;
    Meta<RK>& m = meta[q % META];
    const int r0 = row0(q);
    if (o != 4)
      for (int j = tid; j < RK; j += nthreads)
        cp4(&m.src[j], nrow + min(r0 + j, na - 1), r0 + j < na ? 4 : 0);
    // 16-byte chunks of the flags, read up to the level's last row
    for (int v = tid; v < 2 * (RK / 16); v += nthreads) {
      const int r = r0 + (v % (RK / 16)) * 16;
      const bool up = v >= RK / 16;
      cp16((up ? m.zup : m.zdn) + r - r0, (up ? zup : zdn) + (r < na ? r : 0),
           r < na ? min(16, na - r) : 0);
    }
  };
  // by cp.async the dout-mask words (the aligned word holding mask[s],
  // read up to the mask's end) and the G rows in 16-byte pieces (zero for
  // a row with no source); by TMA, if any row has a source, the x window,
  // one tensor box per 64 bytes of the Cin slab (rows outside the level
  // read as zero).  One lane per warp arrives on the stage's barrier with
  // the warp's bytes.
  auto issue_data = [&](int q, bool live) {
    if (q >= nq) return;
    const int st = q % STAGES;
    if (dmask != nullptr)
      for (int j = tid; j < RK; j += nthreads) {
        const int s = src_of(q, j);
        cp4(&mw[st * RK + j], dmask + (s >= 0 ? s & ~3 : 0), s >= 0 ? min(4, na - (s & ~3)) : 0);
      }
    auto* G = reinterpret_cast<unsigned char*>(Gs + (size_t)st * RK * gp);
    for (int v = tid; v < RK * g_pieces; v += nthreads) {
      const int j = v / g_pieces, k = v - j * g_pieces;
      const int s = src_of(q, j);
      cp16(G + (size_t)j * gp * sizeof(T) + 16 * k,
           reinterpret_cast<const unsigned char*>(dout + (size_t)max(s, 0) * cout + co0) + 16 * k,
           s >= 0 ? 16 : 0);
    }
    unsigned char* X = Xs + (size_t)st * nbox * XBOX;
    const unsigned bytes = __reduce_add_sync(0xffffffffu, live && tid < nbox ? WIN * 64 : 0);
    if (lane == 0) mbar_arrive_tx(&bar[st], bytes);
    if (live && tid < nbox)
      tensor_copy(X + tid * XBOX, &xmap, ci0 + tid * (64 / (int)sizeof(T)), row0(q) - 1, &bar[st]);
  };
  // whether any of this thread's rows of step q has a source
  auto my_live = [&](int q) {
    bool any = false;
    for (int j = tid; j < RK; j += nthreads) any |= src_of(q, j) >= 0;
    return any;
  };

  Acc<T> acc;
  acc.zero();
  // prologue: zero the x ring (a window row of a step with no source is
  // never loaded; its products are masked, so it only has to be finite),
  // the barriers (one arrival per warp), the map slices 0-3, then the data
  // of steps 0 and 1.  After this no thread writes the x ring but the TMA,
  // so the loop needs no proxy fence.
  for (int v = tid; v < STAGES * nbox * XBOX / 16; v += nthreads)
    reinterpret_cast<uint4*>(smem)[v] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(&bar[s])),
                   "r"(nthreads / 32)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  for (int q = 0; q < 4; ++q) issue_meta(q);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  for (int q = 0; q < 2; ++q) {
    issue_data(q, __syncthreads_or(my_live(q)));
    cp_commit();
  }
  for (int q = 0; q < nq; ++q) {
    const int st = q % STAGES;
    cp_wait<1>();  // the G rows and mask words of step q, slice q + 2 (this thread's copies)
    mbar_wait(&bar[st], (q / STAGES) & 1);  // the x window of step q
    __syncthreads();  // ... everyone's; and step q - 1's compute is done
    for (int w = warp; w < RK / 32; w += nthreads / 32) {  // the tap bytes and lists
      const int j = 32 * w + lane;
      const int s = src_of(q, j);
      unsigned b = 0;
      if (s >= 0 && (dmask == nullptr || ((mw[st * RK + j] >> (8 * (s & 3))) & 0xff))) {
        const Meta<RK>& m = meta[q % META];
        const int r = row0(q) + j;
        b = 2u | (m.zdn[j] && r > 0 ? 1u : 0u) | (m.zup[j] && r + 1 < na ? 4u : 0u);
      }
      tap[j] = (uint8_t)b;
      const unsigned live = __ballot_sync(0xffffffffu, b != 0), lt = (1u << lane) - 1;
      const int cnt = __popc(live);
      const int slot = b ? __popc(live & lt) : cnt + __popc(~live & lt);
      lrow[32 * w + slot] = (uint8_t)j;
      ltap[32 * w + slot] = (uint8_t)b;
      if (lane == 0) lcnt[w] = cnt;
    }
    issue_meta(q + 4);
    const bool live = __syncthreads_or(my_live(q + 2));  // also publishes tap
    issue_data(q + 2, live);
    cp_commit();
    acc.step(Gs + (size_t)st * RK * gp, gp, Xs + (size_t)st * nbox * XBOX, tap, lrow, ltap, lcnt,
             m0, n0, kgrp, ks);
  }
  cp_wait<0>();
  acc.store(partial + ((size_t)(c * ks + kgrp) * 27 + 3 * o) * cin * cout, cin, cout, ci0 + m0,
            co0 + n0);
}

template <typename T>
__global__ void zconv3_wgrad_sum(const float* __restrict__ partial, T* __restrict__ dw, int parts,
                                 size_t total) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int c = 0; c < parts; ++c) s += partial[(size_t)c * total + i];
    dw[i] = from_f32<T>(s);
  }
}

bool slab_ok(int width, int slab) {
  return slab >= 32 && slab <= 128 && slab % 32 == 0 && width % slab == 0;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

template <typename T>
int launch(const void* x, const void* dout, const int* nbr9, const uint8_t* zup,
           const uint8_t* zdn, const uint8_t* dmask, float* partial, void* dw, int na, int cin,
           int cout, int bm, int bn, int ks, int chunks, cudaStream_t st) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  // x [na, cin] as a 2-D tensor; a box is 64 bytes of columns by the window's rows
  CUtensorMap xmap;
  const cuuint64_t dims[2] = {(cuuint64_t)cin, (cuuint64_t)na};
  const cuuint64_t strides[1] = {(cuuint64_t)cin * sizeof(T)};
  const cuuint32_t box[2] = {64 / (cuuint32_t)sizeof(T), (cuuint32_t)kRows<T> + 2};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&xmap,
             sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<void*>(x), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(bm, bn);
  static bool configured = false;  // once per process: all a block may take
  if (!configured) {
    const int err = (int)cudaFuncSetAttribute(
        zconv3_wgrad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != 0) return err;
    configured = true;
  }
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid(9 * (cin / bm) * (cout / bn), chunks);
  const int warps = (bm / 32) * (bn / 32) * ks;
  zconv3_wgrad_kernel<T><<<grid, warps * 32, smem, st>>>(
      xmap, static_cast<const T*>(dout), nbr9, zup, zdn, dmask, partial, na, cin, cout, bm, bn,
      ks, chunks);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const size_t total = (size_t)27 * cin * cout;
  const int blocks = (int)std::min<size_t>((total + 255) / 256, 4096);
  zconv3_wgrad_sum<T><<<blocks, 256, 0, st>>>(partial, static_cast<T*>(dw), chunks * ks, total);
  return (int)cudaGetLastError();
}

}  // namespace

// partial: f32 [chunks * ks, 27, cin, cout]; dw: [27, cin, cout] in x's
// dtype.  bm / bn: the Cin / Cout slab of a block (32, 64, 96 or 128,
// dividing the width); ks: warps per 32 x 32 tile (1, 2, 4, or 8 in f32), with
// (bm / 32) * (bn / 32) * ks <= 12 warps.  dtype: 0 = float32, 1 =
// bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int zconv3_wgrad(const void* x, const void* dout, const void* nbr9, const void* zup,
                            const void* zdn, const void* dout_mask, void* partial, void* dw,
                            int na, int cin, int cout, int bm, int bn, int ks, int chunks,
                            int dtype, void* stream) {
  const int warps = (bm / 32) * (bn / 32) * ks;
  if (na <= 0 || !slab_ok(cin, bm) || !slab_ok(cout, bn) || (ks != 1 && ks != 2 && ks != 4 &&
      (ks != 8 || dtype == 1)) || warps > MAX_WARPS || chunks < 1 || chunks > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* nb = static_cast<const int*>(nbr9);
  const auto* zu = static_cast<const uint8_t*>(zup);
  const auto* zd = static_cast<const uint8_t*>(zdn);
  const auto* dm = static_cast<const uint8_t*>(dout_mask);
  float* part = static_cast<float*>(partial);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dout, nb, zu, zd, dm, part, dw, na, cin, cout, bm, bn, ks,
                                 chunks, st);
  return launch<float>(x, dout, nb, zu, zd, dm, part, dw, na, cin, cout, bm, bn, ks, chunks, st);
}

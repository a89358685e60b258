// What the zconv3 forward (KA, zconv3_fwd.cu) and input gradient (KE,
// zconv3_bwd_dx.cu) share: the block shape, the cp.async ring's copies,
// the tensor-core fragments (ldmatrix, mma.sync m16n8k16 bf16 with f32
// sums) and the f32 register tile.  The strided and generic gather-GEMMs
// (gather_gemm.cuh: KB, KC, LA) use the same block shape, ring pieces and
// tiles, and their weight gradients (wgrad.cuh: KF's down/up forms, LB)
// the ring pieces and fragments.
//
// Both kernels are gather-GEMMs whose output block owns BM rows (128, or
// 64 where 128-row blocks would make fewer than 4 waves of the card) and
// BN columns (all of the output width up to 128), with 2 BM threads.
// bf16: the warps BM/32 across rows x 2 across columns, each a 32 x BN/2
// tile of m16n8 fragments.  f32: 16 across rows x 16 across columns, each
// 8 consecutive rows x the column pairs 2 tx + 32 p, 2 tx + 32 p + 1 (a
// half-warp reads 128 consecutive bytes of a weight row).  Each stage of
// the ring holds one K chunk of the gathered rows (A, a row pitch of the
// chunk plus 16 bytes, so that the 8 rows an ldmatrix reads fall in
// distinct banks) and of the weights (B, [BK][BN + 16 bytes]).  The
// tensor-core work, not the gathers, bounds these kernels on an H100 (an
// ablation that dropped all the copies of A or B left their times as
// they were; dropping the MMAs halved them), so the blocking aims at
// fewer MMAs and ldmatrix reads per useful row.  ops/zconv.py
// zconv3_tiles states the same choices for the tests.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace z3 {

constexpr int SMS = 132;  // an H100's SMs

template <typename T>
constexpr bool kBf16 = sizeof(T) == 2;
template <typename T>
constexpr int kEPV = 16 / (int)sizeof(T);  // elements per 16-byte piece

// rows per block: 128 when that gives at least 4 waves of two blocks an
// SM, else 64 (four blocks an SM)
__host__ __device__ constexpr int row_tile(int rows, int col_tiles) {
  return (rows + 127) / 128 * col_tiles >= 4 * 2 * SMS ? 128 : 64;
}

// output columns per block: the widest of 128, 96, 64 and 32 that divides
// the width (a multiple of 32)
__host__ __device__ constexpr int col_tile(int width) {
  return width % 128 == 0 ? 128 : width % 96 == 0 ? 96 : width % 64 == 0 ? 64 : 32;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, of which the first `bytes` (16 or 0) are read
// and the rest zero-filled
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's 32 x BN/2 tile of f32 sums (bf16 operands).
template <int BN>
struct TileBf16 {
  static constexpr int NJ = BN / 16;  // n8 fragments across the warp's columns
  float c[2][NJ][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] = 0.0f;
  }
  // One k16 step.  A: the warp's first A row at the step's column (pitch
  // ap elements); B: the step's first weight row at the warp's first column
  // (pitch bp).  With MASK, lo[i] / hi[i] are ANDed into the A fragments of
  // rows g and g + 8 of m16 fragment i (all ones keeps the row, zero drops
  // it).
  template <bool MASK>
  __device__ __forceinline__ void k16(const __nv_bfloat16* A, int ap, const __nv_bfloat16* B,
                                      int bp, const unsigned* lo, const unsigned* hi) {
    const int lane = threadIdx.x & 31;
    unsigned a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ldsm_x4(a[i], A + (i * 16 + (lane & 15)) * ap + (lane >> 4) * 8);
      if (MASK) {
        a[i][0] &= lo[i];
        a[i][2] &= lo[i];
        a[i][1] &= hi[i];
        a[i][3] &= hi[i];
      }
    }
#pragma unroll
    for (int p = 0; p < NJ / 2; ++p) {
      unsigned b[4];
      ldsm_x4_t(b, B + (lane & 15) * bp + p * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(c[i][2 * p], a[i], b[0], b[1]);
        mma_bf16(c[i][2 * p + 1], a[i], b[2], b[3]);
      }
    }
  }
  // put(r, col, v0, v1): the sums of the warp tile's row r and columns col,
  // col + 1
  template <class Put>
  __device__ __forceinline__ void store(Put put) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          put(i * 16 + g + 8 * h, j * 8 + 2 * tig, c[i][j][2 * h], c[i][j][2 * h + 1]);
  }
};

// A thread's 8 x BN/16 tile of f32 sums: rows r0 .. r0 + 7, the column
// pairs 2 tx + 32 p, 2 tx + 32 p + 1.
template <int BN>
struct TileF32 {
  static constexpr int TM = 8, TP = BN / 32;
  float c[TM][TP][2];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int p = 0; p < TP; ++p) c[i][p][0] = c[i][p][1] = 0.0f;
  }
  // KV k steps (4 for one tap, 2 for three) of one or three taps.  A: the
  // thread's first A row at the step's column (pitch ap); tap t reads A
  // rows SHIFT - t .. SHIFT - t + 7 of it (SHIFT 0: one tap) against the
  // weight rows at B + t * bt (pitch bp, at the thread's first column); bit
  // i of ok0 / ok2: whether taps 0 and 2 count for row i.
  template <int TAPS>
  __device__ __forceinline__ void step(const float* A, int ap, const float* B, int bt, int bp,
                                       unsigned ok0, unsigned ok2) {
    constexpr int SHIFT = TAPS == 1 ? 0 : 2, NA = TM + SHIFT, KV = TAPS == 1 ? 4 : 2;
    float a[NA][KV];
#pragma unroll
    for (int u = 0; u < NA; ++u) {
      if constexpr (KV == 4) {
        const float4 v = *reinterpret_cast<const float4*>(A + u * ap);
        a[u][0] = v.x;
        a[u][1] = v.y;
        a[u][2] = v.z;
        a[u][3] = v.w;
      } else {
        const float2 v = *reinterpret_cast<const float2*>(A + u * ap);
        a[u][0] = v.x;
        a[u][1] = v.y;
      }
    }
#pragma unroll
    for (int kk = 0; kk < KV; ++kk)
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        float2 b[TP];
#pragma unroll
        for (int p = 0; p < TP; ++p)
          b[p] = *reinterpret_cast<const float2*>(B + t * bt + kk * bp + 32 * p);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          // (a predicate on the row's FMAs, not a select of its operand)
          if (TAPS == 3 && ((t == 0 && !((ok0 >> i) & 1)) || (t == 2 && !((ok2 >> i) & 1))))
            continue;
          const float av = a[i + SHIFT - t][kk];
#pragma unroll
          for (int p = 0; p < TP; ++p) {
            c[i][p][0] = fmaf(av, b[p].x, c[i][p][0]);
            c[i][p][1] = fmaf(av, b[p].y, c[i][p][1]);
          }
        }
      }
  }
};

}  // namespace z3

// Weight-gradient templates of the strided and generic sparse convs: KF's
// down and up forms (zconv_wgrad.cu) and LB (sparse_conv.cu).
//
//   dW[k] = sum over rows r of A_k(r)^T (outer) G_k(r)      [K, Cin, Cout]
//
// summed in f32 and rounded once to the input type.  Two kinds of map:
//
//   one-hot (KF down / up, K = 8): each fine row r has one offset and one
//     (A, G) source pair, pick(r, a, g) -> k (or -1: no contribution);
//   grouped (LB, K = 27 or 8): A_k(r) = x[r] for every k, and G_k(r) =
//     dout[g_src(k, r)] (-1: no contribution).
//
// G is read through g_mask; a source outside its tensor is no
// contribution.
//
// Bound on an H100: bytes at the main path's widths (each A and G row read
// once, K x Cin x Cout written once); the products of the live rows stay
// below the tensor cores' reach of those bytes.  Both designs gather a
// row once per block that needs its columns, not once per offset.
//
// Both are reductions over every row of a level, so they run in two
// passes and the result does not depend on the blocks' order (no float
// atomics): pass 1, block (tile, [group,] chunk) sums a contiguous chunk
// of rows into f32 registers and writes them to partial[chunk, k]
// ([chunks, K, Cin, Cout]); pass 2 sums partial over the chunks in order
// and rounds.  A dW tile is 32 Cin columns x BNS Cout columns (ops/_wrap.py
// wgrad_split states the same split and picks the chunks).
//
// One-hot design.  A block owns one dW tile of all 8 offsets; warp k holds
// offset k's f32 sums in registers.  Each warp walks the block's chunk of
// fine rows 128 at a time (its map and mask reads two such superwindows
// ahead of their use), keeps the rows of its own offset (ballots; in row
// order, so the sums are repeatable) in a circular list, and gathers
// their A and G rows (16-byte cp.async pieces) into its own cp.async ring
// of 16-row stages (3 in bf16, 2 in f32), so the next rows' gathers and
// map reads overlap the current products, with no block barrier.  Every
// row is gathered once per tile and multiplied once, into its own
// offset's sums.  (The offsets are balanced to
// ~5% at L0 and L1, where the time is; at L2 and L3 the four dz = 1
// offsets hold ~80% of the rows.)  bf16: mma.sync m16n8k16, A^T and G
// both by ldmatrix.trans, one k16 step a stage; f32: a lane's 8 x BNS/8
// register tile of FMAs.
//
// Grouped design (LB).  A block owns one dW tile of a group of G offsets
// (9 of 27, or all 8), one warp each, and a chunk of rows in 32-row
// steps through a 2-stage block ring: the step's x rows (contiguous) are
// copied once into the stage and shared by the group's warps, so an x row
// is read once per group and tile, not once per offset; warp k gathers
// its own G rows dout[g_src(k, r)] (zero-filled
// where there is none; the map and mask reads run two and one steps
// ahead) and skips a 16-row half whose G rows are all missing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "zconv3_mma.cuh"

namespace lidog {

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int kWSlab = 32;  // Cin columns of a dW tile

// A warp's f32 sums of a 32 (Cin) x BNS (Cout) dW tile.
template <typename T, int BNS>
struct WarpW;

template <int BNS>
struct WarpW<__nv_bfloat16, BNS> {
  static constexpr int NJ = BNS / 8;  // n8 fragments
  float c[2][NJ][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] = 0.0f;
  }
  // 16 rows: A [16][ap] and G [16][gp] at the tile's first columns; the
  // rows are the contraction (A read transposed)
  __device__ __forceinline__ void k16(const __nv_bfloat16* A, int ap, const __nv_bfloat16* G,
                                      int gp) {
    const int lane = threadIdx.x & 31;
    unsigned a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      z3::ldsm_x4_t(a[i], A + ((lane & 7) + (lane >> 4) * 8) * ap + i * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int p = 0; p < NJ / 2; ++p) {
      unsigned b[4];
      z3::ldsm_x4_t(b, G + ((lane & 7) + ((lane >> 3) & 1) * 8) * gp + p * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        z3::mma_bf16(c[i][2 * p], a[i], b[0], b[1]);
        z3::mma_bf16(c[i][2 * p + 1], a[i], b[2], b[3]);
      }
    }
  }
  // out: the tile's first element of a [Cin, Cout] partial
  __device__ void store(float* out, int cout) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float* p = out + (size_t)(i * 16 + g) * cout + j * 8 + 2 * tig;
        *reinterpret_cast<float2*>(p) = make_float2(c[i][j][0], c[i][j][1]);
        *reinterpret_cast<float2*>(p + 8 * (size_t)cout) = make_float2(c[i][j][2], c[i][j][3]);
      }
  }
};

template <int BNS>
struct WarpW<float, BNS> {
  static constexpr int TN = BNS / 8;  // a lane: Cin rows 8 (lane / 8) .., Cout lane % 8 + 8 t
  float c[8][TN];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int t = 0; t < TN; ++t) c[i][t] = 0.0f;
  }
  // one level row: A and G at the tile's first columns
  __device__ __forceinline__ void row(const float* A, const float* G) {
    const int lane = threadIdx.x & 31;
    const float4 a0 = *reinterpret_cast<const float4*>(A + (lane >> 3) * 8);
    const float4 a1 = *reinterpret_cast<const float4*>(A + (lane >> 3) * 8 + 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      const float b = G[(lane & 7) + 8 * t];
#pragma unroll
      for (int i = 0; i < 8; ++i) c[i][t] = fmaf(a[i], b, c[i][t]);
    }
  }
  __device__ void store(float* out, int cout) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int t = 0; t < TN; ++t)
        out[(size_t)((lane >> 3) * 8 + i) * cout + (lane & 7) + 8 * t] = c[i][t];
  }
};

// The one-hot kernel's shape: 8 warps (one per offset), each with a ring
// of ST stages of RW rows and a circular list of its pending rows; the
// rows are scanned SW windows of 32 at a time.
template <typename T, int BNS>
struct OneHotW {
  static constexpr int K = 8, NT = 32 * K, RW = 16, SW = 4;
  static constexpr int ST = z3::kBf16<T> ? 3 : 2;
  static constexpr int EPV = z3::kEPV<T>;
  static constexpr int AP = kWSlab + EPV, GP = BNS + EPV;
  static constexpr int LCAP = 256;  // pending (A, G) source pairs (> RW + 32 SW)
  static constexpr size_t WARP_BYTES = (size_t)ST * RW * (AP + GP) * sizeof(T) + LCAP * 8;
  static constexpr size_t SMEM = K * WARP_BYTES;
};

template <typename T, int BNS, class Map>
__global__ void __launch_bounds__(256, 1)
onehot_wgrad_kernel(const T* __restrict__ a, const T* __restrict__ g,
                    const uint8_t* __restrict__ g_mask, float* __restrict__ partial, Map map,
                    int n_a, int n_g, int rows, int rpc, int cin, int cout) {
  using F = OneHotW<T, BNS>;
  constexpr int ST = F::ST, RW = F::RW, SW = F::SW, AP = F::AP, GP = F::GP, EPV = F::EPV;
  constexpr int VA = kWSlab / EPV, VG = BNS / EPV, LM = F::LCAP - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, wk = threadIdx.x >> 5;  // the warp's offset
  T* As = reinterpret_cast<T*>(smem + wk * F::WARP_BYTES);
  T* Gs = As + ST * RW * AP;
  int2* lst = reinterpret_cast<int2*>(Gs + ST * RW * GP);  // entries head .. tail - 1 (mod)
  const int tiles_n = cout / BNS;
  const int m0 = (blockIdx.x / tiles_n) * kWSlab, n0 = (blockIdx.x % tiles_n) * BNS;
  const int chunk = blockIdx.y;
  const int r_end = min(rows, (chunk + 1) * rpc);
  const unsigned lt = (1u << lane) - 1;
  int head = 0, tail = 0;

  // The rows are scanned a superwindow (SW windows of 32) at a time, two
  // ahead of their use so that the map and mask loads are in flight while
  // the warp gathers and multiplies: the next superwindow's offsets,
  // sources and keep bits (its mask bytes read), and the one after's
  // offsets and sources (being read).
  int sw = chunk * rpc;  // the next superwindow's first row
  int nk[SW], na[SW], ng[SW], fk[SW], fa[SW], fg[SW];
  uint8_t nm[SW];
  // offsets and sources of rows r0 + 32 j + lane (-1: none, or not this
  // warp's offset, or a source outside its tensor)
  // (no value a read returns is used before the next advance)
  auto fetch = [&](int r0, int (&k)[SW], int (&sa)[SW], int (&sg)[SW]) {
#pragma unroll
    for (int j = 0; j < SW; ++j) {
      const int r = r0 + 32 * j + lane;
      k[j] = -1;
      if (r < r_end) k[j] = map.pick(r, sa[j], sg[j]);
    }
  };
  // the next superwindow's rows kept (this warp's offset, sources inside
  // their tensors) and their mask bytes
  auto masks = [&]() {
#pragma unroll
    for (int j = 0; j < SW; ++j) {
      nm[j] = nk[j] == wk && na[j] >= 0 && na[j] < n_a && ng[j] >= 0 && ng[j] < n_g;
      if (nm[j] && g_mask != nullptr) nm[j] = g_mask[ng[j]];
    }
  };
  fetch(sw, nk, na, ng);
  fetch(sw + 32 * SW, fk, fa, fg);
  masks();
  // append the next superwindow's rows of offset wk (in row order) to the
  // list and move the scan on
  auto advance = [&]() {
#pragma unroll
    for (int j = 0; j < SW; ++j) {
      const bool ok = nm[j];
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (ok) lst[(tail + __popc(m & lt)) & LM] = make_int2(na[j], ng[j]);
      tail += __popc(m);
    }
    sw += 32 * SW;
#pragma unroll
    for (int j = 0; j < SW; ++j) {
      nk[j] = fk[j];
      na[j] = fa[j];
      ng[j] = fg[j];
    }
    fetch(sw + 32 * SW, fk, fa, fg);
    masks();
  };

  // Fill the list to a stage's rows (or the chunk's end), then gather its
  // first min(pending, RW) entries into stage `slot` (the rest of the
  // stage zero-filled) and commit a cp.async group (an empty one when
  // there is nothing left).  Returns whether the stage has rows.
  auto issue = [&](int slot) {
    while (tail - head < RW && sw < r_end) advance();
    __syncwarp();
    const int n = min(tail - head, RW);
    if (n > 0) {
      T* A = As + slot * RW * AP;
      T* G = Gs + slot * RW * GP;
      for (int v = lane; v < RW * VA; v += 32) {
        const int rr = v / VA, pc = v % VA;
        const bool ok = rr < n;
        z3::cp16(A + rr * AP + pc * EPV,
                 ok ? a + ((size_t)lst[(head + rr) & LM].x * cin + m0 + pc * EPV) : a,
                 ok ? 16 : 0);
      }
      for (int v = lane; v < RW * VG; v += 32) {
        const int rr = v / VG, pc = v % VG;
        const bool ok = rr < n;
        z3::cp16(G + rr * GP + pc * EPV,
                 ok ? g + ((size_t)lst[(head + rr) & LM].y * cout + n0 + pc * EPV) : g,
                 ok ? 16 : 0);
      }
      head += n;
    }
    z3::cp_commit();
    __syncwarp();  // every lane has read the issued entries before they are overwritten
    return n > 0;
  };

  WarpW<T, BNS> acc;
  acc.zero();
  int issued = 0;
  for (int s = 0; s < ST - 1; ++s) issued += issue(issued % ST);
  for (int done = 0; done < issued; ++done) {
    z3::cp_wait<ST - 2>();
    __syncwarp();  // stage `done` landed for every lane; stage done - 1 is free
    issued += issue(issued % ST);
    const int slot = done % ST;
    if constexpr (z3::kBf16<T>) {
      acc.k16(As + slot * RW * AP, AP, Gs + slot * RW * GP, GP);
    } else {
#pragma unroll 4
      for (int rr = 0; rr < RW; ++rr)
        acc.row(As + (slot * RW + rr) * AP, Gs + (slot * RW + rr) * GP);
    }
  }
  z3::cp_wait<0>();
  acc.store(partial + (((size_t)chunk * F::K + wk) * cin + m0) * cout + n0, cout);
}

// The grouped kernel's shape: G warps (one per offset of a group), a
// 2-stage block ring of RK-row steps, each stage the shared x rows and
// each warp's G rows.
template <typename T, int BNS, int G>
struct GroupW {
  static constexpr int NT = 32 * G, RK = 32, ST = 2;
  static constexpr int EPV = z3::kEPV<T>;
  static constexpr int AP = kWSlab + EPV, GP = BNS + EPV;
  static constexpr int A_EL = RK * AP, G_EL = G * RK * GP;
  static constexpr size_t SMEM = (size_t)ST * (A_EL + G_EL) * sizeof(T) + ST * G * 4;
};

template <typename T, int BNS, int G, class Map>
__global__ void __launch_bounds__(32 * G)
group_wgrad_kernel(const T* __restrict__ a, const T* __restrict__ g,
                   const uint8_t* __restrict__ g_mask, float* __restrict__ partial, Map map,
                   int n_a, int n_g, int rows, int rpc, int cin, int cout) {
  using F = GroupW<T, BNS, G>;
  constexpr int ST = F::ST, RK = F::RK, AP = F::AP, GP = F::GP, EPV = F::EPV, NT = F::NT;
  constexpr int VA = kWSlab / EPV, VG = BNS / EPV;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [ST] x rows
  T* Gs = As + ST * F::A_EL;           // [ST][G] G rows
  unsigned* s_rows = reinterpret_cast<unsigned*>(Gs + ST * F::G_EL);  // [ST][G] live bits
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int k = (int)blockIdx.y * G + w;  // the warp's offset
  const int tiles_n = cout / BNS;
  const int m0 = (blockIdx.x / tiles_n) * kWSlab, n0 = (blockIdx.x % tiles_n) * BNS;
  const int chunk = blockIdx.z;
  const int r_begin = chunk * rpc, r_end = min(rows, r_begin + rpc);
  const int nsteps = r_end > r_begin ? (r_end - r_begin + RK - 1) / RK : 0;

  // lane l's G source in step q (row r_begin + q RK + l): its map entry
  // read two steps ahead of the step's copies and its mask byte one step
  // ahead, so that neither read waits in the issue
  // (no value a read returns is used before the next issue)
  auto entry = [&](int q) {
    const int r = r_begin + q * RK + lane;
    int t = -1;
    if (q < nsteps && r < r_end) t = map.g_src(k, r);
    return t;
  };
  auto mask_of = [&](int t) {
    uint8_t m = t >= 0 && t < n_g;
    if (m && g_mask != nullptr) m = g_mask[t];
    return m;
  };
  int t_cur = entry(0), t_next = entry(1);
  uint8_t m_cur = mask_of(t_cur);
  // (called with q = 0, 1, 2, ... in turn)
  auto issue = [&](int q) {
    if (q >= nsteps) return;
    const int r0 = r_begin + q * RK, slot = q % ST;
    T* A = As + slot * F::A_EL;
    for (int v = tid; v < RK * VA; v += NT) {
      const int rr = v / VA, pc = v % VA;
      const bool ok = r0 + rr < r_end;
      z3::cp16(A + rr * AP + pc * EPV, ok ? a + ((size_t)(r0 + rr) * cin + m0 + pc * EPV) : a,
               ok ? 16 : 0);
    }
    const int s = m_cur ? t_cur : -1;
    t_cur = t_next;
    m_cur = mask_of(t_cur);
    t_next = entry(q + 2);
    const unsigned bits = __ballot_sync(0xffffffffu, s >= 0);
    if (lane == 0) s_rows[slot * G + w] = bits;
    T* Gw = Gs + slot * F::G_EL + w * RK * GP;
    for (int v = lane; v < RK * VG; v += 32) {  // (RK * VG is a multiple of 32)
      const int rr = v / VG, pc = v % VG;
      const int sr = __shfl_sync(0xffffffffu, s, rr);
      z3::cp16(Gw + rr * GP + pc * EPV, sr >= 0 ? g + ((size_t)sr * cout + n0 + pc * EPV) : g,
               sr >= 0 ? 16 : 0);
    }
  };

  WarpW<T, BNS> acc;
  acc.zero();
  for (int s = 0; s < ST - 1; ++s) {
    issue(s);
    z3::cp_commit();
  }
  for (int q = 0; q < nsteps; ++q) {
    z3::cp_wait<ST - 2>();
    __syncthreads();  // step q landed for every thread; step q - 1 is free
    issue(q + ST - 1);
    z3::cp_commit();
    const int slot = q % ST;
    const unsigned bits = s_rows[slot * G + w];
    const T* A = As + slot * F::A_EL;
    const T* Gw = Gs + slot * F::G_EL + w * RK * GP;
    if constexpr (z3::kBf16<T>) {
#pragma unroll
      for (int h = 0; h < RK / 16; ++h)
        if ((bits >> (16 * h)) & 0xffffu) acc.k16(A + 16 * h * AP, AP, Gw + 16 * h * GP, GP);
    } else {
      for (int rr = 0; rr < RK; ++rr)
        if ((bits >> rr) & 1) acc.row(A + rr * AP, Gw + rr * GP);
    }
  }
  z3::cp_wait<0>();
  acc.store(partial + (((size_t)chunk * Map::K + k) * cin + m0) * cout + n0, cout);
}

// Pass 2: dw = sum over chunks of partial, rounded once.  (Map names the
// conv the pass belongs to in a profile.)
template <typename T, class Map>
__global__ void wgrad_sum_kernel(const float* __restrict__ partial, T* __restrict__ dw,
                                 int chunks, size_t total) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int c = 0; c < chunks; ++c) s += partial[(size_t)c * total + i];
    dw[i] = from_f32<T>(s);
  }
}

template <typename T, class Map>
int launch_wgrad_sum(float* partial, void* dw, int chunks, int cin, int cout, cudaStream_t st) {
  const size_t total = (size_t)Map::K * cin * cout;
  const int blocks = (int)std::min<size_t>((total + 255) / 256, 4096);
  wgrad_sum_kernel<T, Map><<<blocks, 256, 0, st>>>(partial, static_cast<T*>(dw), chunks, total);
  return (int)cudaGetLastError();
}

template <class Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T, int BNS, class Map>
int launch_onehot_tile(const void* a, const void* g, const uint8_t* gm, float* part, void* dw,
                       const Map& map, int n_a, int n_g, int rows, int chunks, int rpc, int cin,
                       int cout, cudaStream_t st) {
  using F = OneHotW<T, BNS>;
  static bool configured = false;  // once per instantiation and process
  if (!configured) {
    const int err = set_smem(onehot_wgrad_kernel<T, BNS, Map>, F::SMEM);
    if (err != 0) return err;
    configured = true;
  }
  const dim3 grid((cin / kWSlab) * (cout / BNS), chunks);
  onehot_wgrad_kernel<T, BNS, Map><<<grid, F::NT, F::SMEM, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(g), gm, part, map, n_a, n_g, rows, rpc,
      cin, cout);
  const int err = (int)cudaGetLastError();
  return err != 0 ? err : launch_wgrad_sum<T, Map>(part, dw, chunks, cin, cout, st);
}

template <typename T, int BNS, int G, class Map>
int launch_group_tile(const void* a, const void* g, const uint8_t* gm, float* part, void* dw,
                      const Map& map, int n_a, int n_g, int rows, int chunks, int rpc, int cin,
                      int cout, cudaStream_t st) {
  using F = GroupW<T, BNS, G>;
  static bool configured = false;
  if (!configured) {
    const int err = set_smem(group_wgrad_kernel<T, BNS, G, Map>, F::SMEM);
    if (err != 0) return err;
    configured = true;
  }
  const dim3 grid((cin / kWSlab) * (cout / BNS), Map::K / G, chunks);
  group_wgrad_kernel<T, BNS, G, Map><<<grid, F::NT, F::SMEM, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(g), gm, part, map, n_a, n_g, rows, rpc,
      cin, cout);
  const int err = (int)cudaGetLastError();
  return err != 0 ? err : launch_wgrad_sum<T, Map>(part, dw, chunks, cin, cout, st);
}

inline bool wgrad_args_ok(int rows, int chunks, int rpc, int cin, int cout, int dtype) {
  return rows >= 0 && chunks >= 1 && chunks <= 65535 && rpc >= 32 && rpc % 32 == 0 &&
         (long long)chunks * rpc >= rows && (long long)chunks * rpc < (1ll << 31) && cin > 0 &&
         cin % kWSlab == 0 && cout > 0 && cout % 32 == 0 &&
         (dtype == 0 || dtype == 1);
}

// KF down / up: a [n_a, cin] and g [n_g, cout] read through the map's
// (a, g) pairs over `rows` fine rows, in `chunks` chunks of `rpc` rows (a
// multiple of 32); partial [chunks, 8, cin, cout] f32, dw [8, cin, cout].
// Cout tiles: bf16 all of Cout up to 128 (z3::col_tile), f32 64 or 32.
// Returns a cudaError_t (0 = launched).
template <class Map>
int launch_onehot_wgrad(const void* a, const void* g, const void* g_mask, void* partial,
                        void* dw, Map map, int n_a, int n_g, int rows, int chunks, int rpc,
                        int cin, int cout, int dtype, void* stream) {
  if (!wgrad_args_ok(rows, chunks, rpc, cin, cout, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* gm = static_cast<const uint8_t*>(g_mask);
  float* part = static_cast<float*>(partial);
#define LIDOG_ONEHOT(T, BNS)                                                                \
  launch_onehot_tile<T, BNS>(a, g, gm, part, dw, map, n_a, n_g, rows, chunks, rpc, cin, cout, \
                             st)
  if (dtype == 1) {
    switch (z3::col_tile(cout)) {
      case 128: return LIDOG_ONEHOT(__nv_bfloat16, 128);
      case 96: return LIDOG_ONEHOT(__nv_bfloat16, 96);
      case 64: return LIDOG_ONEHOT(__nv_bfloat16, 64);
      default: return LIDOG_ONEHOT(__nv_bfloat16, 32);
    }
  }
  return cout % 64 == 0 ? LIDOG_ONEHOT(float, 64) : LIDOG_ONEHOT(float, 32);
#undef LIDOG_ONEHOT
}

// LB: a = x [rows, cin] (A_k(r) = x[r]), g = dout [n_g, cout] through
// map.g_src; K = 27 in groups of 9 offsets, K = 8 in one group; Cout tiles
// bf16 64 or 32, f32 32; otherwise as launch_onehot_wgrad.
template <class Map>
int launch_group_wgrad(const void* a, const void* g, const void* g_mask, void* partial,
                       void* dw, Map map, int n_a, int n_g, int rows, int chunks, int rpc,
                       int cin, int cout, int dtype, void* stream) {
  constexpr int G = Map::K % 9 == 0 ? 9 : 8;
  static_assert(Map::K % G == 0, "K is 27 or 8");
  if (!wgrad_args_ok(rows, chunks, rpc, cin, cout, dtype) || rows > n_a)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* gm = static_cast<const uint8_t*>(g_mask);
  float* part = static_cast<float*>(partial);
#define LIDOG_GROUP(T, BNS)                                                                  \
  launch_group_tile<T, BNS, G>(a, g, gm, part, dw, map, n_a, n_g, rows, chunks, rpc, cin, cout, \
                               st)
  if (dtype == 1)
    return cout % 64 == 0 ? LIDOG_GROUP(__nv_bfloat16, 64) : LIDOG_GROUP(__nv_bfloat16, 32);
  return LIDOG_GROUP(float, 32);
#undef LIDOG_GROUP
}

}  // namespace lidog

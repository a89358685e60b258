// What the masked row-wise norms share: KD, KG, KH (masked_bn.cu, the
// masked BatchNorm) and KK, KL (instance_norm.cu, the masked instance
// norm).  Each walks [n, c] rows of bf16 or f32 by the split that
// ops/norm.py bn_split chooses: a thread owns one group of V channels (16
// bytes of the element type: 8 bf16 or 4 f32; V = 1 when a row is not a
// multiple of 16 bytes) for the whole launch; threads (lane j, group g) =
// (threadIdx / gpb, threadIdx % gpb); a block walks one contiguous run of
// `lanes * steps` rows, `lanes` rows a step; blockIdx.y picks the row's
// chunk of gpb groups (only rows wider than a block's threads take more
// than one).  The entry points check the split with split_ok.
//
// Here: the 16-byte loads and stores and their conversion word by word,
// the row walk with several rows' loads in flight, the pairwise tree over
// a block's lanes, and the last-block hand-over of the one-launch
// reductions (an atomicAdd ticket, one int32 per device, zeroed once by
// the wrapper and reset by the block that draws the last ticket: that
// holds while the port launches these kernels on one stream, as it does).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

// Threads a block at most: the reductions take large blocks, one a SM
// (fewer partials for the last block); the streaming passes small ones,
// several a SM (ops/norm.py BN_REDUCE_THREADS / BN_APPLY_THREADS mirror
// these)
constexpr int MAX_THREADS = 512;
constexpr int MAX_APPLY_THREADS = 128;

struct Split {
  int n, c, gpb, lanes, steps;
};

template <typename T>
struct Tag {
  using type = T;
};

// V values of T as loaded: one 16-byte word, or one value
template <typename T, int V>
using Raw = std::conditional_t<V == 1, T, uint4>;

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> ld(const T* p) {
  if constexpr (V == 1)
    return *p;
  else
    return *reinterpret_cast<const uint4*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void st(T* p, const Raw<T, V>& r) {
  if constexpr (V == 1)
    *p = r;
  else
    *reinterpret_cast<uint4*>(p) = r;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// v rounded to T and back (JAX's astype to the compute dtype)
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (std::is_same_v<T, float>)
    return v;
  else
    return __bfloat162float(__float2bfloat16_rn(v));
}

// max(v, 0) that keeps a NaN, as jnp.maximum and torch.clamp do
__device__ __forceinline__ float relu0(float v) { return v < 0.f ? 0.f : v; }

// V per-channel f32 at p (16-byte aligned when V > 1)
template <int V>
__device__ __forceinline__ void ldv(const float* p, float (&o)[V]) {
  if constexpr (V == 1) {
    o[0] = *p;
  } else {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      o[4 * i] = t.x;
      o[4 * i + 1] = t.y;
      o[4 * i + 2] = t.z;
      o[4 * i + 3] = t.w;
    }
  }
}

// V f32 partials at p through L2 (another block wrote them)
template <int V>
__device__ __forceinline__ void ldcg(const float* p, float* o) {
  if constexpr (V == 1) {
    o[0] = __ldcg(p);
  } else {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 t = __ldcg(reinterpret_cast<const float4*>(p) + i);
      o[4 * i] = t.x;
      o[4 * i + 1] = t.y;
      o[4 * i + 2] = t.z;
      o[4 * i + 3] = t.w;
    }
  }
}

// This thread's place in the split: its channel group g (first channel
// c0), lane j, whether the group exists, and its block's rows [r0, r1).
struct Coord {
  int g, c0, j, r0, r1;
  bool live;
};

template <int V>
__device__ __forceinline__ Coord coord(const Split& s) {
  Coord k;
  k.j = threadIdx.x / s.gpb;
  k.g = blockIdx.y * s.gpb + threadIdx.x % s.gpb;
  k.c0 = k.g * V;
  k.live = k.c0 < s.c;
  const int rows = s.lanes * s.steps;  // split_ok: blocks * rows < 2^31
  k.r0 = blockIdx.x * rows;
  k.r1 = min(k.r0 + rows, s.n);
  return k;
}

// Calls load(r, slot) for the next UR of the rows r, r + stride, ...
// below r1, then use(r, slot) for each in order, and so on: UR rows'
// loads are in flight together (the last batch too), and the rows are
// used in increasing order.
template <int UR, typename Row, typename Load, typename Use>
__device__ __forceinline__ void walk_rows(int r, int r1, int stride, Load load, Use use) {
  Row row[UR];
  for (; r < r1; r += UR * stride) {
#pragma unroll
    for (int u = 0; u < UR; ++u)
      if (r + u * stride < r1) load(r + u * stride, row[u]);
#pragma unroll
    for (int u = 0; u < UR; ++u)
      if (r + u * stride < r1) use(r + u * stride, row[u]);
  }
}

// Sums NV values of every thread over the block's lanes by a pairwise tree
// in shared memory (sm: NV * blockDim.x floats): lane j adds lane j + h
// for h = lanes / 2, ..., 1.  On return the threads of lane 0 hold the
// sums in v; every thread of the block must call it.
template <int NV>
__device__ __forceinline__ void lane_tree(float* sm, float (&v)[NV], int lanes, int gpb) {
  const int t = threadIdx.x, n = blockDim.x;
#pragma unroll
  for (int i = 0; i < NV; ++i) sm[i * n + t] = v[i];
  __syncthreads();
  for (int h = lanes / 2; h > 0; h >>= 1) {
    if (t < h * gpb) {
#pragma unroll
      for (int i = 0; i < NV; ++i) sm[i * n + t] += sm[i * n + t + h * gpb];
    }
    __syncthreads();
  }
  if (t < gpb) {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = sm[i * n + t];
  }
  __syncthreads();
}

// The reductions' hand-over: each thread's partial writes are made
// visible, then one thread draws the block's ticket.  True in the block
// that drew the last one (every thread of it), which resets the ticket.
__device__ __forceinline__ bool last_block(int* ticket) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1) == (int)(gridDim.x * gridDim.y) - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
  if (threadIdx.x == 0) *ticket = 0;  // no other block touches it again
  return true;
}

// Channels of one 32-bit word of a Raw (2 bf16 or 1 f32; the value
// itself when V is 1): the kernels convert a Raw word by word
template <typename T, int V>
constexpr int per_word = V == 1 || std::is_same_v<T, float> ? 1 : 2;

// word i of r as floats
template <typename T, int V>
__device__ __forceinline__ void get(const Raw<T, V>& r, int i, float (&o)[per_word<T, V>]) {
  if constexpr (V == 1) {
    o[0] = to_f(r);
  } else {
    const uint32_t w = reinterpret_cast<const uint32_t*>(&r)[i];
    if constexpr (std::is_same_v<T, float>) {
      o[0] = __uint_as_float(w);
    } else {
      o[0] = __uint_as_float(w << 16);
      o[1] = __uint_as_float(w & 0xffff0000u);
    }
  }
}

// word i of r from floats, rounded to T
template <typename T, int V>
__device__ __forceinline__ void put(Raw<T, V>& r, int i, const float (&v)[per_word<T, V>]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same_v<T, float>)
      r = v[0];
    else
      r = __float2bfloat16_rn(v[0]);
  } else if constexpr (std::is_same_v<T, float>) {
    reinterpret_cast<uint32_t*>(&r)[i] = __float_as_uint(v[0]);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);
    reinterpret_cast<__nv_bfloat162*>(&r)[i] = h;
  }
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The split as bn_split chose it, checked: vec 1 or 16 bytes of the dtype
// (then every row pointer and per-channel vector 16-byte aligned), lanes a power of two, at most
// max_threads threads, the chunks covering the row's groups and the blocks
// every row, no chunk and no block empty.
bool split_ok(int n, int c, int vec, int gpb, int lanes, int steps, int blocks, int chunks,
              int dtype, int max_threads, std::initializer_list<const void*> rows) {
  if (dtype != 0 && dtype != 1) return false;
  const int wide = dtype == 1 ? 8 : 4;
  if (n < 0 || c < 1 || (vec != 1 && vec != wide) || c % vec != 0) return false;
  if (gpb < 1 || lanes < 1 || (lanes & (lanes - 1)) != 0 || gpb * lanes > max_threads)
    return false;
  const int groups = c / vec;
  if (chunks < 1 || chunks > 65535 || (long long)chunks * gpb < groups ||
      (long long)(chunks - 1) * gpb >= groups)
    return false;
  const long long per_block = (long long)lanes * steps;
  if (steps < 1 || blocks < 1 || per_block * blocks < n || per_block * blocks > INT_MAX ||
      (n > 0 && per_block * (blocks - 1) >= n))
    return false;
  if (vec > 1)
    for (const void* p : rows)
      if (!aligned16(p)) return false;
  return true;
}

// Runs f(Tag<T>, integral_constant<V>) for the dtype (0 f32, 1 bf16) and vec.
template <typename F>
void dispatch(int dtype, int vec, F f) {
  if (dtype == 1) {
    if (vec == 1)
      f(Tag<__nv_bfloat16>{}, std::integral_constant<int, 1>{});
    else
      f(Tag<__nv_bfloat16>{}, std::integral_constant<int, 8>{});
  } else {
    if (vec == 1)
      f(Tag<float>{}, std::integral_constant<int, 1>{});
    else
      f(Tag<float>{}, std::integral_constant<int, 4>{});
  }
}

}  // namespace

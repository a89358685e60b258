// KD, KG and KH: the masked BatchNorm's normalising pass, its train-mode
// moments and its backward, each fused with the residual add and ReLU.
//
// Replace lidog_tpu/ops/norm.py:41 MaskedBatchNorm (axis_name None) with
// the residual add and ReLU of lidog_tpu/models/minkunet.py:213-214,252:
//
//   KD bn_act          y = relu(round(round((x - mean) * inv + bias) * m + res))
//                      (norm.py:73-76; inv = rsqrt(var + eps) * scale)
//   KG bn_train_stats  the masked moments (_masked_moments:24-38: f32 sums
//                      of f = x * m and f * f, count clamped at 1, biased
//                      variance clamped at 0), the running update with the
//                      unbiased variance (:61-71), and mean, var_raw, inv;
//                      then KD normalises
//   KH bn_bwd_reduce   JAX's autodiff of the same: g = dy through the ReLU
//                      gate, sums of g * m and g * m * (x - mean), then
//                      dscale, dbias and the moment term's coefficients a, b
//      bn_bwd_apply    dx = round(g * m * inv) + round(m * (a + b * x))
//
// round() is to the compute dtype (bf16 or f32), as JAX's astype and its
// sum of the two converted cotangents of x.  Every row is read, masked or
// not: the mask multiplies, as in JAX, so a NaN on a masked row reaches
// the sums there too.
//
// Bound on an H100: bytes.  KG reads x and res and writes y once; KH reads
// dy, y (ReLU) and x and writes dx and dres (residual) once; KD reads x and
// res and writes y.  The per-channel vectors are a few KB.
//
// Design.  A thread owns one group of V channels (16 bytes of the element
// type: 8 bf16 or 4 f32; V = 1 when a row is not a multiple of 16 bytes)
// for the whole launch and loads that group's per-channel vectors once.
// Threads (lane j, group g) = (threadIdx / gpb, threadIdx % gpb): a block
// walks one contiguous run of `lanes * steps` rows, `lanes` rows a step,
// every thread 16 bytes of each of its rows, 4 or 8 rows' loads in flight
// before their arithmetic.  blockIdx.y picks the row's chunk of gpb groups
// (only rows wider than a block's threads take more than one).  ops/norm.py
// bn_split chooses the split; the entry points check it.  The split, the
// loads, the lane tree and the last-block hand-over are masked_rows.cuh's.
//
// The two reductions (KG's moments, KH's sums) take one launch each: every
// block sums its rows per lane in row order, then over its lanes by a
// pairwise tree in shared memory, and writes its f32 partials; it then
// issues a fence and draws a ticket (atomicAdd).  The block that draws the
// last ticket sums all partials by the same lane walk and tree in block
// index order (reads through L2, __ldcg), finishes each channel (JAX's
// clamps; KG updates run_mean and run_var in place, once) and resets the
// ticket to 0.  So no sum depends on the order in which blocks finish: a
// result is bitwise the same from run to run.  The ticket is one int32 per
// device, zeroed once by the wrapper; that holds while the port launches
// these kernels on one stream, as it does.  KH's reduction also writes
// dres = g when there is a residual, and its apply pass then reads g from
// dres instead of dy and y.
#include "masked_rows.cuh"

namespace {

// The streaming passes (KD, KH's apply) run MIN_*_BLOCKS blocks a SM,
// which bounds their registers: at the small levels a launch is one or
// two waves of short blocks, and blocks resident at once set its time.
constexpr int MIN_ACT_BLOCKS = 6;
constexpr int MIN_APPLY_BLOCKS = 5;  // 6 spills in the gated pass
// rows whose loads a thread issues together, per kernel
constexpr int U_ACT = 4;
constexpr int U_MOMENTS = 8;
constexpr int U_REDUCE = 4;
constexpr int U_APPLY = 4;
constexpr int U_TAIL = 4;

// The partials of every block, summed per channel group by the block's
// lane walk (lane j takes blocks j, j + lanes, ... in order) and lane tree:
// NP partial arrays of [gridDim.x, c] f32 (p[i] the i-th), V channels each
// at c0.  On return the threads of lane 0 hold the sums.
template <int V, int NP>
__device__ __forceinline__ void sum_partials(float* sm, const float* const (&p)[NP],
                                             const Split& s, int c0, bool live,
                                             float (&acc)[NP * V]) {
#pragma unroll
  for (int i = 0; i < NP * V; ++i) acc[i] = 0.f;
  if (live) {
    struct Row {
      float v[NP * V];
    };
    walk_rows<U_TAIL, Row>(
        threadIdx.x / s.gpb, gridDim.x, s.lanes,
        [&](int b, Row& w) {
#pragma unroll
          for (int i = 0; i < NP; ++i) ldcg<V>(p[i] + (size_t)b * s.c + c0, w.v + i * V);
        },
        [&](int, const Row& w) {
#pragma unroll
          for (int i = 0; i < NP * V; ++i) acc[i] += w.v[i];
        });
  }
  lane_tree(sm, acc, s.lanes, s.gpb);
}

template <typename T, int V, bool RES>
__global__ void __launch_bounds__(MAX_APPLY_THREADS, MIN_ACT_BLOCKS)
    bn_act_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                  const float* __restrict__ inv, const float* __restrict__ bias,
                  const uint8_t* __restrict__ mask, const T* __restrict__ res,
                  T* __restrict__ out, Split s, int relu) {
  const Coord k = coord<V>(s);
  if (!k.live) return;
  constexpr int E = per_word<T, V>;
  float mu[V], iv[V], bs[V];
  ldv<V>(mean + k.c0, mu);
  ldv<V>(inv + k.c0, iv);
  ldv<V>(bias + k.c0, bs);
  struct Row {
    Raw<T, V> x, res;
    float m;
  };
  walk_rows<U_ACT, Row>(
      k.r0 + k.j, k.r1, s.lanes,
      [&](int r, Row& w) {
        const size_t o = (size_t)r * s.c + k.c0;
        w.x = ld<T, V>(x + o);
        if constexpr (RES) w.res = ld<T, V>(res + o);
        w.m = mask[r];
      },
      [&](int r, const Row& w) {
        Raw<T, V> y;
#pragma unroll
        for (int i = 0; i < V / E; ++i) {
          float xv[E], rv[E], t[E];
          get<T, V>(w.x, i, xv);
          if constexpr (RES) get<T, V>(w.res, i, rv);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int v = i * E + e;
            t[e] = rnd<T>((xv[e] - mu[v]) * iv[v] + bs[v]) * w.m;
            if constexpr (RES) t[e] += rv[e];
            if (relu) t[e] = relu0(t[e]);
          }
          put<T, V>(y, i, t);
        }
        st<T, V>(out + (size_t)r * s.c + k.c0, y);
      });
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS) bn_moments_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ mask, const float* __restrict__ scale,
    float* __restrict__ run_mean, float* __restrict__ run_var, float* __restrict__ psum,
    float* __restrict__ psq, int* __restrict__ pcnt, float* __restrict__ mean_out,
    float* __restrict__ var_out, float* __restrict__ inv_out, float* __restrict__ count_out,
    int* __restrict__ ticket, Split s, float momentum, float eps) {
  extern __shared__ float sm[];  // [2 V][blockDim.x]
  __shared__ int cnt_sh;
  const Coord k = coord<V>(s);
  constexpr int E = per_word<T, V>;
  if (threadIdx.x == 0) cnt_sh = 0;
  __syncthreads();
  float acc[2 * V];  // sums of f, then of f * f
#pragma unroll
  for (int i = 0; i < 2 * V; ++i) acc[i] = 0.f;
  int cnt = 0;
  if (k.live) {
    struct Row {
      Raw<T, V> x;
      float m;
    };
    walk_rows<U_MOMENTS, Row>(
        k.r0 + k.j, k.r1, s.lanes,
        [&](int r, Row& w) {
          w.x = ld<T, V>(x + (size_t)r * s.c + k.c0);
          w.m = mask[r];
        },
        [&](int, const Row& w) {
#pragma unroll
          for (int i = 0; i < V / E; ++i) {
            float xv[E];
            get<T, V>(w.x, i, xv);
#pragma unroll
            for (int e = 0; e < E; ++e) {
              const float f = xv[e] * w.m;
              acc[i * E + e] += f;
              acc[V + i * E + e] += f * f;
            }
          }
          cnt += w.m != 0.f;
        });
  }
  // the rows of the mask: counted by the first group of chunk 0 (int, exact)
  if (blockIdx.y == 0 && threadIdx.x % s.gpb == 0) atomicAdd(&cnt_sh, cnt);
  lane_tree(sm, acc, s.lanes, s.gpb);
  if (k.j == 0 && k.live) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      psum[(size_t)blockIdx.x * s.c + k.c0 + v] = acc[v];
      psq[(size_t)blockIdx.x * s.c + k.c0 + v] = acc[V + v];
    }
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) pcnt[blockIdx.x] = cnt_sh;
  if (!last_block(ticket)) return;

  // the last block: the count, then each chunk's channels
  if (threadIdx.x == 0) cnt_sh = 0;
  __syncthreads();
  int ct = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x) ct += __ldcg(pcnt + b);
  atomicAdd(&cnt_sh, ct);
  __syncthreads();
  const float count = fmaxf((float)cnt_sh, 1.f);
  const float* const parts[2] = {psum, psq};
  for (int y = 0; y < (int)gridDim.y; ++y) {
    const int c0 = (y * s.gpb + threadIdx.x % s.gpb) * V;
    const bool live = c0 < s.c;
    sum_partials<V, 2>(sm, parts, s, c0, live, acc);
    if (threadIdx.x < s.gpb && live) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int ch = c0 + v;
        const float mean = acc[v] / count;
        // Σf²/count - mean² with both products rounded, as the plain
        // version (no fused multiply-add: var_raw's sign gates the
        // backward)
        const float var_raw = __fsub_rn(acc[V + v] / count, __fmul_rn(mean, mean));
        const float var = relu0(var_raw);
        const float unbiased = var * count / fmaxf(count - 1.f, 1.f);
        run_mean[ch] = (1.f - momentum) * run_mean[ch] + momentum * mean;
        run_var[ch] = (1.f - momentum) * run_var[ch] + momentum * unbiased;
        mean_out[ch] = mean;
        var_out[ch] = var_raw;
        inv_out[ch] = scale[ch] / sqrtf(var + eps);
      }
    }
  }
  if (threadIdx.x == 0) *count_out = count;
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS) bn_bwd_reduce_kernel(
    const T* __restrict__ dy, const T* __restrict__ y, const T* __restrict__ x,
    const uint8_t* __restrict__ mask, const float* __restrict__ scale,
    const float* __restrict__ mean, const float* __restrict__ var_raw,
    const float* __restrict__ inv, const float* __restrict__ count_in, T* __restrict__ dres,
    float* __restrict__ ps1, float* __restrict__ ps2, float* __restrict__ dscale,
    float* __restrict__ dbias, float* __restrict__ a_out, float* __restrict__ b_out,
    int* __restrict__ ticket, Split s, int relu, float eps) {
  extern __shared__ float sm[];  // [2 V][blockDim.x]
  const Coord k = coord<V>(s);
  constexpr int E = per_word<T, V>;
  float acc[2 * V];  // sums of g * m, then of g * m * (x - mean)
#pragma unroll
  for (int i = 0; i < 2 * V; ++i) acc[i] = 0.f;
  if (k.live) {
    float mu[V];
    ldv<V>(mean + k.c0, mu);
    struct Row {
      Raw<T, V> dy, y, x;
      float m;
    };
    walk_rows<U_REDUCE, Row>(
        k.r0 + k.j, k.r1, s.lanes,
        [&](int r, Row& w) {
          const size_t o = (size_t)r * s.c + k.c0;
          w.dy = ld<T, V>(dy + o);
          if (relu) w.y = ld<T, V>(y + o);
          w.x = ld<T, V>(x + o);
          w.m = mask[r];
        },
        [&](int r, const Row& w) {
          Raw<T, V> gr;  // g, for dres
#pragma unroll
          for (int i = 0; i < V / E; ++i) {
            float g[E], yv[E], xv[E];
            get<T, V>(w.dy, i, g);
            if (relu) {
              get<T, V>(w.y, i, yv);
#pragma unroll
              for (int e = 0; e < E; ++e) g[e] = yv[e] > 0.f ? g[e] : 0.f;
            }
            put<T, V>(gr, i, g);
            get<T, V>(w.x, i, xv);
#pragma unroll
            for (int e = 0; e < E; ++e) {
              const int v = i * E + e;
              const float gm = g[e] * w.m;
              acc[v] += gm;
              acc[V + v] += gm * (xv[e] - mu[v]);
            }
          }
          if (dres != nullptr) st<T, V>(dres + (size_t)r * s.c + k.c0, gr);
        });
  }
  lane_tree(sm, acc, s.lanes, s.gpb);
  if (k.j == 0 && k.live) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      ps1[(size_t)blockIdx.x * s.c + k.c0 + v] = acc[v];
      ps2[(size_t)blockIdx.x * s.c + k.c0 + v] = acc[V + v];
    }
  }
  if (!last_block(ticket)) return;

  const float count = *count_in;
  const float* const parts[2] = {ps1, ps2};
  for (int yc = 0; yc < (int)gridDim.y; ++yc) {
    const int c0 = (yc * s.gpb + threadIdx.x % s.gpb) * V;
    const bool live = c0 < s.c;
    sum_partials<V, 2>(sm, parts, s, c0, live, acc);
    if (threadIdx.x < s.gpb && live) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int ch = c0 + v;
        const float s1 = acc[v], s2 = acc[V + v], vr = var_raw[ch];
        const float ve = relu0(vr) + eps;
        const float rstd = 1.f / sqrtf(ve);
        // max(var_raw, 0): JAX's balanced gradient, 1/2 each side at a tie
        const float dvar =
            s2 * scale[ch] * (-0.5f * rstd / ve) * (vr > 0.f ? 1.f : vr == 0.f ? 0.5f : 0.f);
        const float dmean = -(s1 * inv[ch]) - 2.f * mean[ch] * dvar;
        dbias[ch] = s1;
        dscale[ch] = s2 * rstd;
        a_out[ch] = dmean / count;
        b_out[ch] = 2.f * dvar / count;
      }
    }
  }
}

// g from dy through the ReLU gate (y given), or as KH's reduction wrote
// it into dres (y null)
template <typename T, int V, bool GATE>
__global__ void __launch_bounds__(MAX_APPLY_THREADS, MIN_APPLY_BLOCKS)
    bn_bwd_apply_kernel(const T* __restrict__ g_in, const T* __restrict__ y,
                        const T* __restrict__ x, const uint8_t* __restrict__ mask,
                        const float* __restrict__ inv, const float* __restrict__ a_in,
                        const float* __restrict__ b_in, T* __restrict__ dx, Split s) {
  const Coord k = coord<V>(s);
  if (!k.live) return;
  constexpr int E = per_word<T, V>;
  float iv[V], av[V], bv[V];
  ldv<V>(inv + k.c0, iv);
  ldv<V>(a_in + k.c0, av);
  ldv<V>(b_in + k.c0, bv);
  struct Row {
    Raw<T, V> g, y, x;
    float m;
  };
  walk_rows<U_APPLY, Row>(
      k.r0 + k.j, k.r1, s.lanes,
      [&](int r, Row& w) {
        const size_t o = (size_t)r * s.c + k.c0;
        w.g = ld<T, V>(g_in + o);
        if constexpr (GATE) w.y = ld<T, V>(y + o);
        w.x = ld<T, V>(x + o);
        w.m = mask[r];
      },
      [&](int r, const Row& w) {
        Raw<T, V> d;
#pragma unroll
        for (int i = 0; i < V / E; ++i) {
          float g[E], yv[E], xv[E], t[E];
          get<T, V>(w.g, i, g);
          if constexpr (GATE) get<T, V>(w.y, i, yv);
          get<T, V>(w.x, i, xv);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int v = i * E + e;
            float gv = g[e];
            if constexpr (GATE) gv = yv[e] > 0.f ? gv : 0.f;
            // the cotangents of x's two f32 casts (the normalising pass,
            // the moments), each rounded to x's dtype, then summed in it
            t[e] = rnd<T>(gv * w.m * iv[v]) + rnd<T>(w.m * (av[v] + bv[v] * xv[e]));
          }
          put<T, V>(d, i, t);
        }
        st<T, V>(dx + (size_t)r * s.c + k.c0, d);
      });
}

}  // namespace

// The split arguments of every entry point (ops/norm.py bn_split): vec
// (channels a thread owns: 1, or 16 bytes of the dtype), gpb (channel
// groups a block covers), lanes (rows a step, a power of two; threads =
// gpb * lanes <= 512 in the reductions, 128 in KD and the apply pass),
// steps (steps a block), blocks and chunks (the grid: row runs x channel
// chunks).  dtype: 0 = float32, 1 = bfloat16.  mask
// bool [n]; per-channel vectors f32 [c].  Each returns a cudaError_t (0 =
// launched; 1 = the split or a pointer's alignment was refused).

// KD.  x, res (null: none), out [n, c].
extern "C" int bn_act(const void* x, const void* mean, const void* inv, const void* bias,
                      const void* mask, const void* res, void* out, int n, int c, int vec,
                      int gpb, int lanes, int steps, int blocks, int chunks, int relu,
                      int dtype, void* stream) {
  if (!split_ok(n, c, vec, gpb, lanes, steps, blocks, chunks, dtype, MAX_APPLY_THREADS,
                {x, res, out, mean, inv, bias}))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const Split s{n, c, gpb, lanes, steps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dispatch(dtype, vec, [&](auto tag, auto vc) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(vc)::value;
    auto kernel = res != nullptr ? bn_act_kernel<T, V, true> : bn_act_kernel<T, V, false>;
    kernel<<<dim3(blocks, chunks), gpb * lanes, 0, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(mean),
        static_cast<const float*>(inv), static_cast<const float*>(bias),
        static_cast<const uint8_t*>(mask), static_cast<const T*>(res), static_cast<T*>(out), s,
        relu);
  });
  return (int)cudaGetLastError();
}

// KG's moments.  x [n, c]; run_mean, run_var updated in place; psum, psq
// f32 [blocks, c] and pcnt int32 [blocks] the partials; mean, var_raw,
// inv f32 [c] and count f32 [1] out; ticket int32 [1], 0 on entry and exit.
extern "C" int bn_train_stats(const void* x, const void* mask, const void* scale,
                              void* run_mean, void* run_var, void* psum, void* psq, void* pcnt,
                              void* mean, void* var_raw, void* inv, void* count, void* ticket,
                              int n, int c, int vec, int gpb, int lanes, int steps, int blocks,
                              int chunks, float momentum, float eps, int dtype, void* stream) {
  if (!split_ok(n, c, vec, gpb, lanes, steps, blocks, chunks, dtype, MAX_THREADS,
                {x, psum, psq}))
    return (int)cudaErrorInvalidValue;
  const Split s{n, c, gpb, lanes, steps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dispatch(dtype, vec, [&](auto tag, auto vc) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(vc)::value;
    const int threads = gpb * lanes;
    bn_moments_kernel<T, V><<<dim3(blocks, chunks), threads, 2 * V * threads * 4, st>>>(
        static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
        static_cast<const float*>(scale), static_cast<float*>(run_mean),
        static_cast<float*>(run_var), static_cast<float*>(psum), static_cast<float*>(psq),
        static_cast<int*>(pcnt), static_cast<float*>(mean), static_cast<float*>(var_raw),
        static_cast<float*>(inv), static_cast<float*>(count), static_cast<int*>(ticket), s,
        momentum, eps);
  });
  return (int)cudaGetLastError();
}

// KH's sums.  dy, x [n, c]; y [n, c] read when relu; dres [n, c] (null:
// no residual) written with g; scale, mean, var_raw, inv f32 [c] and
// count f32 [1] from KG; ps1, ps2 f32 [blocks, c] the partials; dscale,
// dbias, a, b f32 [c] out; ticket as KG's.
extern "C" int bn_bwd_reduce(const void* dy, const void* y, const void* x, const void* mask,
                             const void* scale, const void* mean, const void* var_raw,
                             const void* inv, const void* count, void* dres, void* ps1,
                             void* ps2, void* dscale, void* dbias, void* a, void* b,
                             void* ticket, int n, int c, int vec, int gpb, int lanes, int steps,
                             int blocks, int chunks, int relu, float eps, int dtype,
                             void* stream) {
  if (!split_ok(n, c, vec, gpb, lanes, steps, blocks, chunks, dtype, MAX_THREADS,
                {dy, relu ? y : nullptr, x, dres, ps1, ps2, mean}) ||
      (relu && y == nullptr))
    return (int)cudaErrorInvalidValue;
  const Split s{n, c, gpb, lanes, steps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dispatch(dtype, vec, [&](auto tag, auto vc) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(vc)::value;
    const int threads = gpb * lanes;
    bn_bwd_reduce_kernel<T, V><<<dim3(blocks, chunks), threads, 2 * V * threads * 4, st>>>(
        static_cast<const T*>(dy), static_cast<const T*>(y), static_cast<const T*>(x),
        static_cast<const uint8_t*>(mask), static_cast<const float*>(scale),
        static_cast<const float*>(mean), static_cast<const float*>(var_raw),
        static_cast<const float*>(inv), static_cast<const float*>(count),
        static_cast<T*>(dres), static_cast<float*>(ps1), static_cast<float*>(ps2),
        static_cast<float*>(dscale), static_cast<float*>(dbias), static_cast<float*>(a),
        static_cast<float*>(b), static_cast<int*>(ticket), s, relu, eps);
  });
  return (int)cudaGetLastError();
}

// KH's apply pass.  g [n, c]: dy (then y [n, c] gives the ReLU gate, or
// null: no ReLU) or the dres that bn_bwd_reduce wrote (y null); x [n, c];
// inv, a, b f32 [c]; dx [n, c] out.
extern "C" int bn_bwd_apply(const void* g, const void* y, const void* x, const void* mask,
                            const void* inv, const void* a, const void* b, void* dx, int n,
                            int c, int vec, int gpb, int lanes, int steps, int blocks,
                            int chunks, int dtype, void* stream) {
  if (!split_ok(n, c, vec, gpb, lanes, steps, blocks, chunks, dtype, MAX_APPLY_THREADS,
                {g, y, x, dx, inv, a, b}))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const Split s{n, c, gpb, lanes, steps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dispatch(dtype, vec, [&](auto tag, auto vc) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(vc)::value;
    auto kernel =
        y != nullptr ? bn_bwd_apply_kernel<T, V, true> : bn_bwd_apply_kernel<T, V, false>;
    kernel<<<dim3(blocks, chunks), gpb * lanes, 0, st>>>(
        static_cast<const T*>(g), static_cast<const T*>(y), static_cast<const T*>(x),
        static_cast<const uint8_t*>(mask), static_cast<const float*>(inv),
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<T*>(dx), s);
  });
  return (int)cudaGetLastError();
}

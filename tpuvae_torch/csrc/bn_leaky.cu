// Training-mode BatchNorm2d + LeakyReLU(0.01) of the conv trunks, forward
// and backward, in flax's op order (tpuvae_torch/models/layers.py
// _flax_batch_norm, _flax_normalize, then F.leaky_relu):
//   mean = sum(x) / n, raw = sum(x^2) / n - mean^2, var = max(raw, 0)
//   scale = rsqrt(var + eps) * gamma
//   pre = (x - mean) * scale + beta,  y = pre > 0 ? pre : 0.01 pre
// over the n = N H W pixels of each channel, and the running statistics
// moved by keep * r + momentum * batch (biased variance).
//
// Replaces no Pallas kernel: the JAX package leaves these passes to XLA,
// which fuses them.  Op by op in PyTorch they were ~35 strided ATen passes
// a layer, forward and backward, over ten trunk layers of 97 M elements a
// batch of 32.  Every one of the four kernels is bound by bytes on the
// H100 (a few flops an element): the design is about the bytes.
//   A  stats:      reads x; per-channel sums -> mean, var, raw; moves the
//                  running statistics.
//   B  norm:       reads x, writes y = leaky(pre).  With statistics given
//                  (kernel 6 gathered them), B alone is the forward.
//   C  grad_sums:  reads g and x, recomputes the mask pre > 0 from x (no
//                  full-size tensor is saved), sums g' = g * slope(pre) and
//                  g' (x - mean) per channel -> d gamma, d beta and the
//                  coefficients of D (or d mean, d var when given).
//   D  grad_input: reads g and x, writes dx = scale g' + b (x - mean) + c.
// Four passes forward (x twice, y once; the bound counts x once: 8 bytes an
// element) and five backward (12 bytes an element).
//
// Layout.  A thread owns V consecutive channels of one pixel: V = 4 (16-byte
// loads and stores) where every tensor's channel axis is contiguous, its
// pixel strides are multiples of 4 and its data 16-byte aligned -- the
// trunks' channels-last activations and the decoder's cut view
// y[:, :, :2h, :2w] of a (2h+1) x (2w+1) output; V = 1 on any other
// strides (correct, not fast).  The kernels take each tensor's strides: the
// caller copies nothing.  A CTA of 256 threads is `lanes` channel vectors
// (a power of two, at most 32: a warp reads 512 contiguous bytes at C >=
// 128) by `rows` pixels; channel groups of lanes x V channels are gridDim.x,
// and the pixel axis is cut into gridDim.y contiguous chunks, enough CTAs to
// fill the card at every layer (ops/bn_leaky.py plan()).  Each thread has
// four loads in flight.  B and D walk their chunk backwards: the bytes A
// (C) read last are the likeliest to be in L2 still.
//
// Sums: fp32, each thread over its pixels, then the CTA's rows in a fixed
// tree, one partial row per CTA in global memory; the CTA that finishes its
// channel group last (an integer ticket taken after a fence, as kernel 6)
// adds the partial rows in a fixed order and finalises.  No float atomics:
// two runs, and a CUDA graph's replay against the eager call, give the same
// bits.  The last CTA sets its ticket back to 0.  The pre-activation is
// computed with explicit round-to-nearest intrinsics (no contraction), so
// that B, C and D see the same pre > 0 mask bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 4;        // ops/bn_leaky.py CTAS_PER_SM: all resident
constexpr int kUnroll = 4;
constexpr float kSlope = 0.01f;

// Element strides; every offset a tensor's elements take fits in 32 bits
// (make_geo checks), which keeps the address arithmetic in 32-bit registers
struct Strides {
  int n, c, h, w;
};

// q = n / d for 0 <= n < 2^31 by a multiply-high and a shift (the round-up
// method of Granlund and Montgomery, as PyTorch's IntDivider)
struct FastDiv {
  unsigned d, m, s;
};

FastDiv make_div(unsigned d) {
  unsigned s = 0;
  while (s < 32 && (1u << s) < d) ++s;
  const uint64_t one = 1;
  const uint64_t m = ((one << 32) * ((one << s) - d)) / d + 1;
  return {d, static_cast<unsigned>(m), s};
}

__device__ __forceinline__ unsigned fast_div(const FastDiv& f, unsigned n) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

struct Geo {
  int C, H, W, P;          // P = N H W pixels
  FastDiv fw, fh;
  int lanes, rows;         // lanes x rows = kThreads
  int chunk;               // pixels per CTA along gridDim.y
};

template <int V>
struct Lane {
  int c0, r;
  bool active;
};

template <int V>
__device__ __forceinline__ Lane<V> lane_of(const Geo& g) {
  const int l = threadIdx.x & (g.lanes - 1);
  const int c0 = (blockIdx.x * g.lanes + l) * V;
  return {c0, static_cast<int>(threadIdx.x) / g.lanes, c0 < g.C};
}

struct Pix {
  int n, h, w;
};

__device__ __forceinline__ Pix pix_of(const Geo& g, int p) {
  const int row = static_cast<int>(fast_div(g.fw, static_cast<unsigned>(p)));
  const int n = static_cast<int>(fast_div(g.fh, static_cast<unsigned>(row)));
  return {n, row - n * g.H, p - row * g.W};
}

__device__ __forceinline__ int at(const Strides& s, const Pix& q) {
  return q.n * s.n + q.h * s.h + q.w * s.w;
}

template <int V>
__device__ __forceinline__ void load(const float* base, int off, int sc,
                                     float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(base + off);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = base[off + k * sc];
  }
}

// The same through L2 only (__ldcg): the partial rows other CTAs wrote
template <int V>
__device__ __forceinline__ void load_cg(const float* base, int off,
                                        float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(base + off));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldcg(base + off);
  }
}

template <int V>
__device__ __forceinline__ void store(float* base, int off, int sc,
                                      const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(base + off) = make_float4(v[0], v[1], v[2],
                                                         v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) base[off + k * sc] = v[k];
  }
}

// rsqrt(var + eps) as the plain version computes it on the CPU (1 / sqrt,
// each rounded to nearest), and scale = rstd * gamma
__device__ __forceinline__ float rstd_of(float var, float eps) {
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
}

__device__ __forceinline__ float pre_act(float x, float mean, float scale,
                                         float beta) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), scale), beta);
}

// Per-channel constants of an active thread's V channels.
template <int V>
struct Chan {
  float mean[V], scale[V], beta[V];
};

template <int V>
__device__ __forceinline__ Chan<V> chan_of(const Lane<V>& ln, const float* mean,
                                           const float* var,
                                           const float* gamma,
                                           const float* beta, float eps) {
  Chan<V> c;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ch = ln.c0 + k;
    c.mean[k] = mean[ch];
    c.scale[k] = __fmul_rn(rstd_of(var[ch], eps), gamma[ch]);
    c.beta[k] = beta[ch];
  }
  return c;
}

// The pixels a thread visits: its CTA's chunk [begin, end), rows apart, in
// groups of kUnroll (B and D take the groups from the last).
struct Walk {
  int begin, end, step, groups;
};

template <int V>
__device__ __forceinline__ Walk walk_of(const Geo& g, const Lane<V>& ln) {
  const int begin = blockIdx.y * g.chunk;
  const int end = min(g.P, begin + g.chunk);
  const int step = g.rows * kUnroll;
  const int span = end - begin - ln.r;
  return {begin + ln.r, end, step, span > 0 ? (span + step - 1) / step : 0};
}

// Adds a and b (V each) over the CTA's rows in a fixed tree; row 0 ends
// with the CTA's sums.  `red` holds 2 kThreads V floats.
template <int V>
__device__ __forceinline__ void rows_sum(float (&a)[V], float (&b)[V],
                                         const Geo& g, float* red) {
  const int t = threadIdx.x;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < V; ++k) {
    red[t * V + k] = a[k];
    red[(kThreads + t) * V + k] = b[k];
  }
  __syncthreads();
  const int r = t / g.lanes;
  for (int half = g.rows / 2; half > 0; half /= 2) {
    if (r < half) {
      const int o = t + half * g.lanes;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        red[t * V + k] += red[o * V + k];
        red[(kThreads + t) * V + k] += red[(kThreads + o) * V + k];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    a[k] = red[t * V + k];
    b[k] = red[(kThreads + t) * V + k];
  }
}

// The CTA's sums of a and b into its partial row of `part` (2, G, C); then
// in the CTA that finishes its channel group last, the totals over the
// group's CTAs, added in CTA order, in row 0's a and b.  Returns whether
// this CTA is that last one.
template <int V>
__device__ bool group_sums(float (&a)[V], float (&b)[V], const Lane<V>& ln,
                           const Geo& g, float* red, float* part,
                           int* tickets) {
  __shared__ bool last;
  rows_sum<V>(a, b, g, red);
  const int G = gridDim.y;
  if (ln.r == 0 && ln.active) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      part[blockIdx.y * g.C + ln.c0 + k] = a[k];
      part[(G + blockIdx.y) * g.C + ln.c0 + k] = b[k];
    }
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(tickets + blockIdx.x, 1) == G - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0;
#pragma unroll
  for (int k = 0; k < V; ++k) a[k] = b[k] = 0.f;
  if (ln.active) {
    // row r adds partial rows r, r + rows, ... in order; four in flight
#pragma unroll 4
    for (int q = ln.r; q < G; q += g.rows) {
      float pa[V], pb[V];
      load_cg<V>(part, q * g.C + ln.c0, pa);
      load_cg<V>(part, (G + q) * g.C + ln.c0, pb);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        a[k] += pa[k];
        b[k] += pb[k];
      }
    }
  }
  rows_sum<V>(a, b, g, red);
  return true;
}

// ---- A: statistics -----------------------------------------------------------
template <int V>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    stats_kernel(const float* __restrict__ x, Strides sx, Geo g,
                 float* __restrict__ part, int* __restrict__ tickets,
                 float* __restrict__ stats, float* __restrict__ run_mean,
                 float* __restrict__ run_var, long long* __restrict__ batches,
                 float keep, float momentum) {
  __shared__ float red[2 * kThreads * V];
  const Lane<V> ln = lane_of<V>(g);
  const Walk wk = walk_of<V>(g, ln);
  const int cx = ln.c0 * sx.c;
  float s[V] = {}, ss[V] = {};
  if (ln.active) {
    for (int i = 0; i < wk.groups; ++i) {
      float v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = wk.begin + i * wk.step + u * g.rows;
        if (p < wk.end) {
          load<V>(x, at(sx, pix_of(g, p)) + cx, sx.c, v[u]);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) v[u][k] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          s[k] += v[u][k];
          ss[k] = fmaf(v[u][k], v[u][k], ss[k]);
        }
      }
    }
  }
  if (!group_sums<V>(s, ss, ln, g, red, part, tickets)) return;
  if (ln.r != 0 || !ln.active) return;
  const float n = static_cast<float>(g.P);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ch = ln.c0 + k;
    const float mean = __fdiv_rn(s[k], n);
    const float raw = __fsub_rn(__fdiv_rn(ss[k], n), __fmul_rn(mean, mean));
    const float var = raw < 0.f ? 0.f : raw;
    stats[ch] = mean;
    stats[g.C + ch] = var;
    stats[2 * g.C + ch] = raw;
    run_mean[ch] = __fadd_rn(__fmul_rn(run_mean[ch], keep),
                             __fmul_rn(momentum, mean));
    run_var[ch] = __fadd_rn(__fmul_rn(run_var[ch], keep),
                            __fmul_rn(momentum, var));
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && batches != nullptr) *batches += 1;
}

// ---- B: normalise + LeakyReLU --------------------------------------------------
template <int V>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    norm_kernel(const float* __restrict__ x, Strides sx, float* __restrict__ y,
                Strides sy, Geo g, const float* __restrict__ mean,
                const float* __restrict__ var, const float* __restrict__ gamma,
                const float* __restrict__ beta, float eps) {
  const Lane<V> ln = lane_of<V>(g);
  if (!ln.active) return;
  const Chan<V> cs = chan_of<V>(ln, mean, var, gamma, beta, eps);
  const Walk wk = walk_of<V>(g, ln);
  const int cx = ln.c0 * sx.c, cy = ln.c0 * sy.c;
  for (int i = wk.groups - 1; i >= 0; --i) {
    float v[kUnroll][V];
    int oy[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = wk.begin + i * wk.step + u * g.rows;
      oy[u] = -1;
      if (p < wk.end) {
        const Pix q = pix_of(g, p);
        load<V>(x, at(sx, q) + cx, sx.c, v[u]);
        oy[u] = at(sy, q) + cy;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (oy[u] < 0) continue;
      float o[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float pre = pre_act(v[u][k], cs.mean[k], cs.scale[k], cs.beta[k]);
        o[k] = pre > 0.f ? pre : __fmul_rn(pre, kSlope);
      }
      store<V>(y, oy[u], sy.c, o);
    }
  }
}

// ---- C: the backward's per-channel sums -----------------------------------------
// back (6, C): d gamma, d beta, b, c of D, d mean, d var.  d mean and d var
// are the partial derivatives through the normalisation alone; with batch
// statistics (given == 0) they fold into b and c, through the clamp
// var = max(raw, 0) (no variance gradient where raw < 0, as clamp_min's).
template <int V>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    grad_sums_kernel(const float* __restrict__ gy, Strides sg,
                     const float* __restrict__ x, Strides sx, Geo g,
                     const float* __restrict__ mean,
                     const float* __restrict__ var,
                     const float* __restrict__ raw,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, float eps, int given,
                     float* __restrict__ part, int* __restrict__ tickets,
                     float* __restrict__ back) {
  __shared__ float red[2 * kThreads * V];
  const Lane<V> ln = lane_of<V>(g);
  const Walk wk = walk_of<V>(g, ln);
  const int cx = ln.c0 * sx.c, cg = ln.c0 * sg.c;
  float s0[V] = {}, s1[V] = {};
  if (ln.active) {
    const Chan<V> cs = chan_of<V>(ln, mean, var, gamma, beta, eps);
    for (int i = 0; i < wk.groups; ++i) {
      float v[kUnroll][V], d[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = wk.begin + i * wk.step + u * g.rows;
        if (p < wk.end) {
          const Pix q = pix_of(g, p);
          load<V>(x, at(sx, q) + cx, sx.c, v[u]);
          load<V>(gy, at(sg, q) + cg, sg.c, d[u]);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) v[u][k] = d[u][k] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xm = __fsub_rn(v[u][k], cs.mean[k]);
          const float pre = __fadd_rn(__fmul_rn(xm, cs.scale[k]), cs.beta[k]);
          const float gp = pre > 0.f ? d[u][k] : __fmul_rn(d[u][k], kSlope);
          s0[k] += gp;
          s1[k] = fmaf(gp, xm, s1[k]);
        }
      }
    }
  }
  if (!group_sums<V>(s0, s1, ln, g, red, part, tickets)) return;
  if (ln.r != 0 || !ln.active) return;
  const float n = static_cast<float>(g.P);
  const int C = g.C;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ch = ln.c0 + k;
    const float rstd = rstd_of(var[ch], eps);
    const float scale = __fmul_rn(rstd, gamma[ch]);
    const float dmean = -__fmul_rn(scale, s0[k]);
    const float dvar = __fmul_rn(__fmul_rn(-0.5f, s1[k]),
                                 __fmul_rn(scale, __fmul_rn(rstd, rstd)));
    float b = 0.f, c = 0.f;
    if (!given) {
      const float gv = raw[ch] >= 0.f ? dvar : 0.f;
      b = __fdiv_rn(__fmul_rn(2.f, gv), n);
      c = __fdiv_rn(dmean, n);
    }
    back[ch] = __fmul_rn(s1[k], rstd);
    back[C + ch] = s0[k];
    back[2 * C + ch] = b;
    back[3 * C + ch] = c;
    back[4 * C + ch] = dmean;
    back[5 * C + ch] = dvar;
  }
}

// ---- D: the input's gradient ------------------------------------------------------
template <int V>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    grad_input_kernel(const float* __restrict__ gy, Strides sg,
                      const float* __restrict__ x, Strides sx,
                      float* __restrict__ dx, Strides sd, Geo g,
                      const float* __restrict__ mean,
                      const float* __restrict__ var,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, float eps,
                      const float* __restrict__ back) {
  const Lane<V> ln = lane_of<V>(g);
  if (!ln.active) return;
  const Chan<V> cs = chan_of<V>(ln, mean, var, gamma, beta, eps);
  float cb[V], cc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    cb[k] = back[2 * g.C + ln.c0 + k];
    cc[k] = back[3 * g.C + ln.c0 + k];
  }
  const Walk wk = walk_of<V>(g, ln);
  const int cx = ln.c0 * sx.c, cg = ln.c0 * sg.c, cd = ln.c0 * sd.c;
  for (int i = wk.groups - 1; i >= 0; --i) {
    float v[kUnroll][V], d[kUnroll][V];
    int od[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = wk.begin + i * wk.step + u * g.rows;
      od[u] = -1;
      if (p < wk.end) {
        const Pix q = pix_of(g, p);
        load<V>(x, at(sx, q) + cx, sx.c, v[u]);
        load<V>(gy, at(sg, q) + cg, sg.c, d[u]);
        od[u] = at(sd, q) + cd;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (od[u] < 0) continue;
      float o[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xm = __fsub_rn(v[u][k], cs.mean[k]);
        const float pre = __fadd_rn(__fmul_rn(xm, cs.scale[k]), cs.beta[k]);
        const float gp = pre > 0.f ? d[u][k] : __fmul_rn(d[u][k], kSlope);
        o[k] = __fadd_rn(__fadd_rn(__fmul_rn(cs.scale[k], gp),
                                   __fmul_rn(cb[k], xm)),
                         cc[k]);
      }
      store<V>(dx, od[u], sd.c, o);
    }
  }
}

// ---- host side ------------------------------------------------------------------
// dims: N, C, H, W; plan: V, lanes, groups, ctas, chunk (ops/bn_leaky.py
// plan()); each tensor's strides in elements (N, C, H, W).
bool make_geo(const long long* dims, const int* plan, Geo* g, dim3* grid) {
  const long long N = dims[0], C = dims[1], H = dims[2], W = dims[3];
  const int vec = plan[0], lanes = plan[1], groups = plan[2], ctas = plan[3],
            chunk = plan[4];
  const long long P = N * H * W;
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || P > 2147483647LL ||
      C > 2147483647LL / 6)
    return false;
  if ((vec != 1 && vec != 4) || (vec == 4 && C % 4) || lanes <= 0 ||
      lanes > 32 || (lanes & (lanes - 1)) || groups <= 0 || groups > 65535 ||
      static_cast<long long>(groups) * lanes * vec < C ||
      static_cast<long long>(groups - 1) * lanes * vec >= C || ctas <= 0 ||
      ctas > 65535 || chunk <= 0 ||
      static_cast<long long>(ctas) * chunk < P ||
      static_cast<long long>(ctas - 1) * chunk >= P ||
      2LL * ctas * C > 2147483647LL)
    return false;
  *g = {static_cast<int>(C), static_cast<int>(H), static_cast<int>(W),
        static_cast<int>(P), make_div(static_cast<unsigned>(W)),
        make_div(static_cast<unsigned>(H)), lanes, kThreads / lanes, chunk};
  *grid = dim3(groups, ctas);
  return true;
}

// A tensor's strides, if every offset of its elements fits in 32 bits.
bool strides_of(const long long* dims, const long long* s, Strides* out) {
  long long last = 0;
  for (int d = 0; d < 4; ++d) {
    if (s[d] < 0) return false;
    last += (dims[d] - 1) * s[d];
  }
  if (last > 2147483647LL) return false;
  *out = {static_cast<int>(s[0]), static_cast<int>(s[1]),
          static_cast<int>(s[2]), static_cast<int>(s[3])};
  return true;
}

// V = 4 needs a contiguous channel axis, pixel strides that are multiples
// of 4 and a 16-byte aligned base
bool vec_ok(const void* p, const long long* s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s[1] == 1 &&
         s[0] % 4 == 0 && s[2] % 4 == 0 && s[3] % 4 == 0;
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

template <int V>
void launch_stats(dim3 grid, cudaStream_t st, const float* x, Strides sx,
                  const Geo& g, float* part, int* tickets, float* stats,
                  float* run_mean, float* run_var, long long* batches,
                  float keep, float momentum) {
  stats_kernel<V><<<grid, kThreads, 0, st>>>(x, sx, g, part, tickets, stats,
                                             run_mean, run_var, batches, keep,
                                             momentum);
}

template <int V>
void launch_norm(dim3 grid, cudaStream_t st, const float* x, Strides sx,
                 float* y, Strides sy, const Geo& g, const float* mean,
                 const float* var, const float* gamma, const float* beta,
                 float eps) {
  norm_kernel<V><<<grid, kThreads, 0, st>>>(x, sx, y, sy, g, mean, var, gamma,
                                            beta, eps);
}

template <int V>
void launch_grad_sums(dim3 grid, cudaStream_t st, const float* gy, Strides sg,
                      const float* x, Strides sx, const Geo& g,
                      const float* mean, const float* var, const float* raw,
                      const float* gamma, const float* beta, float eps,
                      int given, float* part, int* tickets, float* back) {
  grad_sums_kernel<V><<<grid, kThreads, 0, st>>>(gy, sg, x, sx, g, mean, var,
                                                 raw, gamma, beta, eps, given,
                                                 part, tickets, back);
}

template <int V>
void launch_grad_input(dim3 grid, cudaStream_t st, const float* gy,
                       Strides sg, const float* x, Strides sx, float* dx,
                       Strides sd, const Geo& g, const float* mean,
                       const float* var, const float* gamma,
                       const float* beta, float eps, const float* back) {
  grad_input_kernel<V><<<grid, kThreads, 0, st>>>(
      gy, sg, x, sx, dx, sd, g, mean, var, gamma, beta, eps, back);
}

}  // namespace

// x (N, C, H, W) at strides sx -> stats (3, C): mean, var, raw; moves
// run_mean / run_var and adds 1 to *batches (if not null).  part: scratch
// of 2 * ctas * C floats; tickets: `groups` ints that are 0 (and are 0
// again when the kernel ends).
extern "C" int tpuvae_bn_leaky_stats(const void* x, const long long* sx,
                                     const long long* dims, const int* plan,
                                     void* part, void* tickets, void* stats,
                                     void* run_mean, void* run_var,
                                     void* batches, float keep, float momentum,
                                     void* stream) {
  Geo g;
  dim3 grid;
  Strides tx;
  if (!make_geo(dims, plan, &g, &grid) || !strides_of(dims, sx, &tx) ||
      (plan[0] == 4 && !vec_ok(x, sx)))
    return invalid();
  (plan[0] == 4 ? launch_stats<4> : launch_stats<1>)(
      grid, static_cast<cudaStream_t>(stream), static_cast<const float*>(x),
      tx, g, static_cast<float*>(part), static_cast<int*>(tickets),
      static_cast<float*>(stats), static_cast<float*>(run_mean),
      static_cast<float*>(run_var), static_cast<long long*>(batches), keep,
      momentum);
  return static_cast<int>(cudaGetLastError());
}

// y = leaky((x - mean) * rsqrt(var + eps) * gamma + beta) at strides sy.
extern "C" int tpuvae_bn_leaky_norm(const void* x, const long long* sx,
                                    void* y, const long long* sy,
                                    const long long* dims, const int* plan,
                                    const void* mean, const void* var,
                                    const void* gamma, const void* beta,
                                    float eps, void* stream) {
  Geo g;
  dim3 grid;
  Strides tx, ty;
  if (!make_geo(dims, plan, &g, &grid) || !strides_of(dims, sx, &tx) ||
      !strides_of(dims, sy, &ty) ||
      (plan[0] == 4 && !(vec_ok(x, sx) && vec_ok(y, sy))))
    return invalid();
  (plan[0] == 4 ? launch_norm<4> : launch_norm<1>)(
      grid, static_cast<cudaStream_t>(stream), static_cast<const float*>(x),
      tx, static_cast<float*>(y), ty, g, static_cast<const float*>(mean),
      static_cast<const float*>(var), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), eps);
  return static_cast<int>(cudaGetLastError());
}

// The backward's sums from g (strides sg) and x -> back (6, C); raw may be
// null when given != 0.  part and tickets as for the statistics.
extern "C" int tpuvae_bn_leaky_grad_sums(
    const void* gy, const long long* sg, const void* x, const long long* sx,
    const long long* dims, const int* plan, const void* mean, const void* var,
    const void* raw, const void* gamma, const void* beta, float eps,
    int given, void* part, void* tickets, void* back, void* stream) {
  Geo g;
  dim3 grid;
  Strides tg, tx;
  if (!make_geo(dims, plan, &g, &grid) || !strides_of(dims, sg, &tg) ||
      !strides_of(dims, sx, &tx) || (!given && raw == nullptr) ||
      (plan[0] == 4 && !(vec_ok(x, sx) && vec_ok(gy, sg))))
    return invalid();
  (plan[0] == 4 ? launch_grad_sums<4> : launch_grad_sums<1>)(
      grid, static_cast<cudaStream_t>(stream), static_cast<const float*>(gy),
      tg, static_cast<const float*>(x), tx, g,
      static_cast<const float*>(mean), static_cast<const float*>(var),
      static_cast<const float*>(raw), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), eps, given, static_cast<float*>(part),
      static_cast<int*>(tickets), static_cast<float*>(back));
  return static_cast<int>(cudaGetLastError());
}

// dx (strides sd) = scale g' + b (x - mean) + c, with b, c from back.
extern "C" int tpuvae_bn_leaky_grad_input(
    const void* gy, const long long* sg, const void* x, const long long* sx,
    void* dx, const long long* sd, const long long* dims, const int* plan,
    const void* mean, const void* var, const void* gamma, const void* beta,
    float eps, const void* back, void* stream) {
  Geo g;
  dim3 grid;
  Strides tg, tx, td;
  if (!make_geo(dims, plan, &g, &grid) || !strides_of(dims, sg, &tg) ||
      !strides_of(dims, sx, &tx) || !strides_of(dims, sd, &td) ||
      (plan[0] == 4 &&
       !(vec_ok(x, sx) && vec_ok(gy, sg) && vec_ok(dx, sd))))
    return invalid();
  (plan[0] == 4 ? launch_grad_input<4> : launch_grad_input<1>)(
      grid, static_cast<cudaStream_t>(stream), static_cast<const float*>(gy),
      tg, static_cast<const float*>(x), tx, static_cast<float*>(dx), td, g,
      static_cast<const float*>(mean), static_cast<const float*>(var),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), eps,
      static_cast<const float*>(back));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpuvae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// GaitSet stage tail: 2x2 max pool + leaky ReLU + set max over T, forward
// and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _tail_kernel of benchmarks/proto_tail.py:38
// (launched by tail() at :75), which reads the conv output once and writes
// the pooled per-frame stream and its running max over T.  The TPU kernel
// is forward only; stage_tail_bwd is its gradient, which the train step needs.
//
// Semantics, for x (B*T, C, H, W) NCHW contiguous, float32 or bfloat16:
//   p[n,c,i,j] = max of x[n, c, 2i:2i+2, 2j:2j+2]   (VALID: an odd H or W
//                drops its last row / column)
//   q          = p * alpha, rounded to the dtype (bf16: in float, then rounded)
//   a          = max(p, q)                              (B*T, C, H/2, W/2)
//   s[b]       = max over t of a[b*T + t]               (B, C, H/2, W/2)
// Max propagates NaN, as torch.maximum and torch.amax do.  The forward is
// bitwise equal to the plain chain (ops/pooling.py:stage_tail) in both dtypes.
//
// The backward follows the rounding order of torch's autograd formulas for
// that chain (tools/autograd/derivatives.yaml), one rounding to the dtype per
// torch op, with __f*_rn so that nothing is contracted into an FMA:
//   amax over T:  G    = g_a + (g_s / n) * [a == s],  n = #t with a == s
//   maximum:      g_p  = p == q ? G / 2 : (p < q ? 0 : G)
//                 g_q  = p == q ? G / 2 : (p > q ? 0 : G)
//   mul:          P    = g_p + g_q * alpha
//   2x2 amax:     dx   = (P / m) * [x == p],  m = #window elements == p
// so ties split evenly, both in the window and over T, and p == 0 gives
// G/2 + (G/2) * alpha: the JAX package's CPU rule (ugaitnet_tpu/ops/pooling.py
// reshape + max), not F.max_pool2d's one-element routing.  Rows and columns
// an odd extent drops get 0 (the wrapper zero-fills dx for them).
//
// What bounds it on an H100 (SXM, 700 W): bytes.  There is one compare or
// multiply per element moved, so at 3.35 TB/s the flagship's stage 1 (x of
// (3000, 32, 64, 64) float32, 1.57 GB) needs 1.98 GB moved forward (x, a and
// s), 0.59 ms, and 3.93 GB backward (x, a, g_a read, dx written, s and g_s),
// 1.18 ms; stage 2 (3000, 64, 32, 32) half of each; bfloat16 half again.
// The design moves each of those bytes once:
//
//   stage_tail_fwd_kernel
//       One thread per (b, c, output row i, V output columns): V = 2 for
//       float32, 4 for bfloat16, so each input row segment it reads is one
//       16-byte load and each a / s segment one 8-byte store, neighbouring
//       threads on neighbouring addresses.  The thread loops over the T
//       frames of its clip (the TPU kernel's sequential t grid axis), writes
//       a for each frame and keeps the running max in registers; s is
//       written once.  No shared memory: nothing is reused across threads.
//   stage_tail_bwd_kernel
//       The same tiling.  Pass 1 reads a over T (a quarter of x's bytes) and
//       counts the frames that hold the set max; pass 2 reads x and g_a,
//       recomputes p, q and a from x in registers (bitwise the forward's),
//       and writes the thread's 2 x 2V block of dx with two 16-byte stores
//       a frame.  Every dx element has one writer: no atomics, deterministic.
//       p and q are never stored, which saves the plain chain's two saved
//       quarter-size tensors per stage.
// Shapes whose W is not a multiple of 2V, or pointers not 16-byte aligned,
// take the same kernels with scalar, bounds-checked loads and stores.
// Build without --use_fast_math: the compares and the rounding rely on IEEE
// float32 without flush-to-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// NaN-propagating max (torch.maximum / torch.amax)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <typename T>
struct Elt;

template <>
struct Elt<float> {
  static constexpr int kV = 2;  // output columns a thread: 16-byte row loads
  __device__ static float get(float v) { return v; }
  __device__ static float put(float v) { return v; }
  __device__ static float rnd(float v) { return v; }
};

template <>
struct Elt<__nv_bfloat16> {
  static constexpr int kV = 4;
  __device__ static float get(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 put(float v) { return __float2bfloat16_rn(v); }
  __device__ static float rnd(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// Load 2V consecutive elements of an input row from column 2*oj0 into r.
// VEC: one 16-byte load; otherwise scalar loads of the windows whose output
// column is < wo (the others are left 0 and never used).
template <typename T, bool VEC>
__device__ __forceinline__ void load_row(const T* row, int oj0, int wo,
                                         float (&r)[2 * Elt<T>::kV]) {
  constexpr int V = Elt<T>::kV;
  if (VEC) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + 2 * oj0);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < 2 * V; ++k) r[k] = Elt<T>::get(e[k]);
  } else {
#pragma unroll
    for (int k = 0; k < 2 * V; ++k)
      r[k] = oj0 + k / 2 < wo ? Elt<T>::get(row[2 * oj0 + k]) : 0.f;
  }
}

// V consecutive output elements from column oj0: one 8-byte access with VEC.
template <typename T, bool VEC>
__device__ __forceinline__ void load_out(const T* row, int oj0, int wo,
                                         float (&r)[Elt<T>::kV]) {
  constexpr int V = Elt<T>::kV;
  if (VEC) {
    const uint2 u = *reinterpret_cast<const uint2*>(row + oj0);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int v = 0; v < V; ++v) r[v] = Elt<T>::get(e[v]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      r[v] = oj0 + v < wo ? Elt<T>::get(row[oj0 + v]) : 0.f;
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_out(T* row, int oj0, int wo,
                                          const float (&r)[Elt<T>::kV]) {
  constexpr int V = Elt<T>::kV;
  if (VEC) {
    uint2 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int v = 0; v < V; ++v) e[v] = Elt<T>::put(r[v]);
    *reinterpret_cast<uint2*>(row + oj0) = u;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (oj0 + v < wo) row[oj0 + v] = Elt<T>::put(r[v]);
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_row(T* row, int oj0, int wo,
                                          const float (&r)[2 * Elt<T>::kV]) {
  constexpr int V = Elt<T>::kV;
  if (VEC) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int k = 0; k < 2 * V; ++k) e[k] = Elt<T>::put(r[k]);
    *reinterpret_cast<uint4*>(row + 2 * oj0) = u;
  } else {
#pragma unroll
    for (int k = 0; k < 2 * V; ++k)
      if (oj0 + k / 2 < wo) row[2 * oj0 + k] = Elt<T>::put(r[k]);
  }
}

// The work item of a thread: clip b, channel c, output row oi, output
// columns oj0 .. oj0 + V - 1.
struct Item {
  int b, c, oi, oj0;
};

__device__ __forceinline__ Item item_of(long long idx, int C, int ho,
                                        int groups, int V) {
  Item it;
  const long long per_c = (long long)ho * groups;
  it.b = static_cast<int>(idx / (C * per_c));
  long long r = idx - (long long)it.b * C * per_c;
  it.c = static_cast<int>(r / per_c);
  r -= (long long)it.c * per_c;
  it.oi = static_cast<int>(r / groups);
  it.oj0 = static_cast<int>(r - (long long)it.oi * groups) * V;
  return it;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
stage_tail_fwd_kernel(const T* __restrict__ x, T* __restrict__ a,
                      T* __restrict__ s, int B, int nt, int C, int H, int W,
                      float alpha) {
  constexpr int V = Elt<T>::kV;
  const int ho = H / 2, wo = W / 2, groups = (wo + V - 1) / V;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)B * C * ho * groups) return;
  const Item it = item_of(idx, C, ho, groups, V);
  const long long frame = (long long)C * H * W, oframe = (long long)C * ho * wo;
  const T* xp = x + ((long long)it.b * nt * C + it.c) * H * W +
                (long long)(2 * it.oi) * W;
  T* ap = a + ((long long)it.b * nt * C + it.c) * ho * wo + (long long)it.oi * wo;
  float run[V];
  for (int t = 0; t < nt; ++t, xp += frame, ap += oframe) {
    float r0[2 * V], r1[2 * V], out[V];
    load_row<T, VEC>(xp, it.oj0, wo, r0);
    load_row<T, VEC>(xp + W, it.oj0, wo, r1);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float p = nan_max(nan_max(r0[2 * v], r0[2 * v + 1]),
                              nan_max(r1[2 * v], r1[2 * v + 1]));
      const float q = Elt<T>::rnd(__fmul_rn(p, alpha));
      out[v] = nan_max(p, q);
      run[v] = t == 0 ? out[v] : nan_max(run[v], out[v]);
    }
    store_out<T, VEC>(ap, it.oj0, wo, out);
  }
  store_out<T, VEC>(s + ((long long)it.b * C + it.c) * ho * wo +
                        (long long)it.oi * wo,
                    it.oj0, wo, run);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
stage_tail_bwd_kernel(const T* __restrict__ x, const T* __restrict__ a,
                      const T* __restrict__ s, const T* __restrict__ ga,
                      const T* __restrict__ gs, T* __restrict__ dx, int B,
                      int nt, int C, int H, int W, float alpha) {
  constexpr int V = Elt<T>::kV;
  using E = Elt<T>;
  const int ho = H / 2, wo = W / 2, groups = (wo + V - 1) / V;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)B * C * ho * groups) return;
  const Item it = item_of(idx, C, ho, groups, V);
  const long long frame = (long long)C * H * W, oframe = (long long)C * ho * wo;
  const long long so = ((long long)it.b * C + it.c) * ho * wo + (long long)it.oi * wo;
  const long long ao = ((long long)it.b * nt * C + it.c) * ho * wo +
                       (long long)it.oi * wo;
  const long long xo = ((long long)it.b * nt * C + it.c) * H * W +
                       (long long)(2 * it.oi) * W;
  float sv[V], gsv[V];
  load_out<T, VEC>(s + so, it.oj0, wo, sv);
  load_out<T, VEC>(gs + so, it.oj0, wo, gsv);

  // pass 1: the frames that hold the set max
  int n[V];
#pragma unroll
  for (int v = 0; v < V; ++v) n[v] = 0;
  const T* ap = a + ao;
  for (int t = 0; t < nt; ++t, ap += oframe) {
    float av[V];
    load_out<T, VEC>(ap, it.oj0, wo, av);
#pragma unroll
    for (int v = 0; v < V; ++v) n[v] += av[v] == sv[v];
  }
  float share[V];  // g_s / n, rounded as torch's division
#pragma unroll
  for (int v = 0; v < V; ++v)
    share[v] = E::rnd(__fdiv_rn(gsv[v], static_cast<float>(n[v])));

  // pass 2: dx, frame by frame
  const T* xp = x + xo;
  const T* gp_ = ga + ao;
  T* dp = dx + xo;
  for (int t = 0; t < nt; ++t, xp += frame, gp_ += oframe, dp += frame) {
    float r0[2 * V], r1[2 * V], gav[V];
    load_row<T, VEC>(xp, it.oj0, wo, r0);
    load_row<T, VEC>(xp + W, it.oj0, wo, r1);
    load_out<T, VEC>(gp_, it.oj0, wo, gav);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float x00 = r0[2 * v], x01 = r0[2 * v + 1];
      const float x10 = r1[2 * v], x11 = r1[2 * v + 1];
      const float p = nan_max(nan_max(x00, x01), nan_max(x10, x11));
      const float q = E::rnd(__fmul_rn(p, alpha));
      const float av = nan_max(p, q);
      // amax over T: g_a + (g_s / n) * mask
      const float mask_t = av == sv[v] ? 1.f : 0.f;
      const float g =
          E::rnd(__fadd_rn(gav[v], E::rnd(__fmul_rn(share[v], mask_t))));
      // maximum(p, q)
      const float half = E::rnd(__fmul_rn(g, 0.5f));
      float g_p = p == q ? half : g;
      float g_q = p == q ? half : g;
      if (p < q) g_p = 0.f;
      if (p > q) g_q = 0.f;
      // q = alpha * p, then the two paths into p
      const float gpt = E::rnd(__fadd_rn(g_p, E::rnd(__fmul_rn(g_q, alpha))));
      // 2x2 amax: (P / m) * mask
      const int m = (x00 == p) + (x01 == p) + (x10 == p) + (x11 == p);
      const float sh = E::rnd(__fdiv_rn(gpt, static_cast<float>(m)));
      r0[2 * v] = E::rnd(__fmul_rn(sh, x00 == p ? 1.f : 0.f));
      r0[2 * v + 1] = E::rnd(__fmul_rn(sh, x01 == p ? 1.f : 0.f));
      r1[2 * v] = E::rnd(__fmul_rn(sh, x10 == p ? 1.f : 0.f));
      r1[2 * v + 1] = E::rnd(__fmul_rn(sh, x11 == p ? 1.f : 0.f));
    }
    store_row<T, VEC>(dp, it.oj0, wo, r0);
    store_row<T, VEC>(dp + W, it.oj0, wo, r1);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
bool vec_ok(int W, const void* x16, const void* y16, const void* o8a,
            const void* o8b, const void* o8c, const void* o8d) {
  return W % (2 * Elt<T>::kV) == 0 && aligned(x16, 16) && aligned(y16, 16) &&
         aligned(o8a, 8) && aligned(o8b, 8) && aligned(o8c, 8) && aligned(o8d, 8);
}

long long blocks_for(int B, int C, int H, int W, int V) {
  const long long items = (long long)B * C * (H / 2) * ((W / 2 + V - 1) / V);
  return (items + kThreads - 1) / kThreads;
}

template <typename T>
int launch_fwd(const void* x, void* a, void* s, int B, int nt, int C, int H,
               int W, float alpha, cudaStream_t st) {
  const long long blocks = blocks_for(B, C, H, W, Elt<T>::kV);
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  T* at = static_cast<T*>(a);
  T* sp = static_cast<T*>(s);
  if (vec_ok<T>(W, x, x, a, s, a, s))
    stage_tail_fwd_kernel<T, true><<<(unsigned)blocks, kThreads, 0, st>>>(
        xt, at, sp, B, nt, C, H, W, alpha);
  else
    stage_tail_fwd_kernel<T, false><<<(unsigned)blocks, kThreads, 0, st>>>(
        xt, at, sp, B, nt, C, H, W, alpha);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* a, const void* s, const void* ga,
               const void* gs, void* dx, int B, int nt, int C, int H, int W,
               float alpha, cudaStream_t st) {
  const long long blocks = blocks_for(B, C, H, W, Elt<T>::kV);
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* at = static_cast<const T*>(a);
  const T* sp = static_cast<const T*>(s);
  const T* gat = static_cast<const T*>(ga);
  const T* gst = static_cast<const T*>(gs);
  T* dxt = static_cast<T*>(dx);
  if (vec_ok<T>(W, x, dx, a, s, ga, gs))
    stage_tail_bwd_kernel<T, true><<<(unsigned)blocks, kThreads, 0, st>>>(
        xt, at, sp, gat, gst, dxt, B, nt, C, H, W, alpha);
  else
    stage_tail_bwd_kernel<T, false><<<(unsigned)blocks, kThreads, 0, st>>>(
        xt, at, sp, gat, gst, dxt, B, nt, C, H, W, alpha);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward: x (B*nt, C, H, W) -> a (B*nt, C, H/2, W/2) and s (B, C, H/2, W/2),
// all of one dtype (0: float32, 1: bfloat16), contiguous.  Returns a
// cudaError_t.
int stage_tail_fwd(const void* x, void* a, void* s, int dtype, int B, int nt,
                   int C, int H, int W, float alpha, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(x, a, s, B, nt, C, H, W, alpha, st);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, a, s, B, nt, C, H, W, alpha, st);
  return cudaErrorInvalidValue;
}

// Backward: dx from x, the forward's a and s, and the gradients g_a (a's
// shape) and g_s (s's shape).  dx's dropped rows / columns (odd H or W) are
// not written.  Returns a cudaError_t.
int stage_tail_bwd(const void* x, const void* a, const void* s, const void* ga,
                   const void* gs, void* dx, int dtype, int B, int nt, int C,
                   int H, int W, float alpha, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(x, a, s, ga, gs, dx, B, nt, C, H, W, alpha, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, a, s, ga, gs, dx, B, nt, C, H, W,
                                     alpha, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"

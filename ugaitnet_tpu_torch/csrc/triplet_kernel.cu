// Batch-all triplet loss: forward and analytic backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of ugaitnet_tpu/ops/pallas/triplet_kernel.py:
//   triplet_fwd: triplet_fwd_kernel
//     <- _fwd_kernel (:159) and, for 128 < B <= 512, _fwd_kernel_grid (:264)
//   triplet_bwd: triplet_rows_kernel, then triplet_finish_kernel
//     <- _bwd_kernel (:187) and _bwd_kernel_grid (:280) + _grid_bwd_finish (:327)
// One code path serves every batch size: nothing here is tied to the TPU's
// (8, 128) tiles, so there is no 128-padding, no -1 label padding and no
// one-hot selector matmul.  Labels are dense ids >= 0 and every row is real.
//
// Semantics (per part p, batch B, dim D; x[p] is (B, D)):
//   d[i,j]   = guarded sqrt(|xi|^2 + |xj|^2 - 2 xi.xj)   (0 where d2 <= 0, and
//              exactly 0 on the diagonal, as in the plain version)
//   t(a,j,k) = (margin + d[a,j]) - d[a,k]   for lab[j] == lab[a] (j == a included)
//                                           and lab[k] != lab[a]
//   active   = t > 0;  loss_p = sum(t over active) / count (0 if count is 0)
//   g[a,m]   = #active(a, j=m, .) - #active(a, ., k=m), times scale_p
//   dx[i]    = sum_j (g[i,j] + g[j,i]) / d[i,j] * (xi - xj)   (0 where d == 0)
//
// Launch geometry (tile sizes, grids, dynamic shared memory) is chosen in
// Python by ops/cuda/triplet_kernel.py:plan and passed in; the constants
// below are mirrored there.  Every launch is on the caller's stream, with no
// allocation and no synchronisation; each entry point returns
// cudaGetLastError().  Build without --use_fast_math: the hinge comparisons
// and the symmetric distances rely on IEEE float32 without flush-to-zero.
//
// What bounds them on an H100 (SXM, 700 W) at the flagship (P, B, D) =
// (62, 120, 256): 7.6 MB of embeddings (2.3 us at 3.35 TB/s), the symmetric
// half of the Gram products, 0.23 GFLOP (3.4 us at the 67 TFLOP/s float32
// rate outside the tensor cores), and the backward's W.x products, 0.46
// GFLOP (6.8 us).  Both are bound by float32 operations.  The design:
//
//   triplet_fwd_kernel
//       One CTA of 256 threads per (part, tile of TA = 8 RM anchors).
//       cp.async streams the anchors' rows and all B rows of x[p] through
//       shared memory in D-chunks of 32, double-buffered, 128 columns a
//       pass.  Each thread keeps an RM x 4 register tile of the Gram
//       product; its lanes are laid out 8 (rows) x 4 (columns), so every
//       float4 shared load is one wavefront for 4 RM FMAs a value.  Row
//       norms are computed once per row.  d is bitwise symmetric: every dot
//       product accumulates its k terms with fmaf in one order
//       (fmaf(u, v, c) == fmaf(v, u, c)), every norm the same way, and
//       d2 = (|xi|^2 + |xj|^2) - 2 xi.xj is rounded step by step (no
//       contraction); d[i,i] is set to 0.  The TA rows of d stay in shared
//       memory (and go to dist for the backward).  Hinge: one warp per
//       anchor holds its negatives' distances in registers (4 a lane per
//       pass of 128), walks its positives (a ballot over the labels) and
//       counts t = fl(margin + d[a,j]) - d[a,k] > 0.  One (sum, count)
//       partial per CTA, reduced by shuffles in a fixed order: no atomics,
//       the result is deterministic.  Each CTA computes its rows in full
//       (twice the bound's symmetric half), so the hinge needs no second
//       pass over d.
//   triplet_rows_kernel
//       One CTA per (part, tile of anchors); cp.async stages the tile's d
//       rows and the labels in shared memory.  One warp per anchor, its
//       negatives' distances in registers as in the forward: for each
//       positive j the lanes apply the forward's comparison to their
//       negatives, __popc(__ballot) counts the active ones (g[a,j] > 0) and
//       each lane counts its own negatives' in registers (g[a,k] < 0).
//       O(K * B / 32) warp steps per anchor with K ids per label, the
//       forward hinge's cost, with no serial loop over global memory.
//       g = count * scale_p is written coalesced.
//   triplet_finish_kernel
//       dx_i = sum_j W_ij (x_i - x_j), W_ij = (g_ij + g_ji) / d_ij, which has
//       no rowsum(W) x_i - W x cancellation, tiled like a product: one CTA
//       per (part, TI = 8 RM rows, 128 columns).  The CTA builds its W rows
//       in shared memory from coalesced reads of g rows, then of g columns
//       (g[j, i0:i0+TI] and, as d is symmetric, d[j, i0:i0+TI]), several
//       loads in flight a thread; cp.async streams x[p]'s column chunk
//       through shared memory once per CTA, 32 rows a stage, double-
//       buffered.  Each thread keeps x_i and an RM x 4 accumulator tile in
//       registers, lanes 8 (rows) x 4 (columns): one float4 and RM scalar
//       shared loads, one wavefront each, per 8 RM float operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // every kernel: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 32;         // fwd: D-chunk of a stage
constexpr int kKS = kKC + 4;    // fwd: shared row stride (16-byte rows; float4
                                // reads of 8 consecutive rows hit 32 banks)
constexpr int kCB = 128;        // fwd: columns of the Gram product per pass
constexpr int kJC = 32;         // finish: x rows per stage
constexpr int kDC = 128;        // finish: columns per CTA (32 lanes x 4)
constexpr int kNV = 4;          // hinges: negatives a lane holds in registers
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stage a (rows x 4*nv) block of x[p] (rows r0.., columns c0..) into shared
// memory with row stride `stride` floats, zero-filling rows >= B and
// columns >= D.  vec: 16-byte copies (D, the strides and x 16-byte aligned);
// otherwise 4-byte copies.
__device__ __forceinline__ void stage_x(float* dst, int stride, const float* xp,
                                        long long rs, int r0, int rows, int c0,
                                        int nv, int B, int D, bool vec) {
  if (vec) {
    for (int t = threadIdx.x; t < rows * nv; t += kThreads) {
      const int r = t / nv, c = c0 + 4 * (t % nv), row = r0 + r;
      const bool ok = row < B && c < D;
      const float* src = ok ? xp + row * rs + c : xp;
      cp_async16(dst + r * stride + 4 * (t % nv), src, ok ? 16 : 0);
    }
  } else {
    const int nc = 4 * nv;
    for (int t = threadIdx.x; t < rows * nc; t += kThreads) {
      const int r = t / nc, c = c0 + t % nc, row = r0 + r;
      const bool ok = row < B && c < D;
      const float* src = ok ? xp + row * rs + c : xp;
      cp_async4(dst + r * stride + t % nc, src, ok ? 4 : 0);
    }
  }
}

// Stage n contiguous 4-byte words; vec: 16-byte copies (n % 4 == 0, both
// pointers 16-byte aligned).
__device__ __forceinline__ void stage_words(void* dst, const void* src, int n,
                                            bool vec) {
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  if (vec) {
    for (int t = threadIdx.x; t < n / 4; t += kThreads)
      cp_async16(d + 16 * t, s + 16 * t, 16);
  } else {
    for (int t = threadIdx.x; t < n; t += kThreads)
      cp_async4(d + 4 * t, s + 4 * t, 4);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// Shared memory: stages [2][(TA + kCB) * kKS], d rows [TA][B], norms [B],
// labels [B], warp partials [2][kWarps]  (plan: fwd_smem_bytes).
template <int RM>
__global__ void __launch_bounds__(kThreads)
triplet_fwd_kernel(const float* __restrict__ x, const int* __restrict__ labels,
                   float* __restrict__ dist, float* __restrict__ sums,
                   int* __restrict__ counts, int B, int D, long long part_stride,
                   long long row_stride, float margin, int vec) {
  constexpr int TA = kWarps * RM;
  constexpr int kStage = (TA + kCB) * kKS;
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  float* drow = stage + 2 * kStage;
  float* sq = drow + TA * B;
  int* lab = reinterpret_cast<int*>(sq + B);
  float* red_s = reinterpret_cast<float*>(lab + B);
  int* red_c = reinterpret_cast<int*>(red_s + kWarps);

  const int p = blockIdx.y, a0 = blockIdx.x * TA;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int lr = lane >> 2, lc = lane & 3;   // 8 x 4 lanes over (rows, columns)
  const float* xp = x + p * part_stride;
  const int nK = (D + kKC - 1) / kKC, nC = (B + kCB - 1) / kCB, nS = nK * nC;

  auto load = [&](int s) {
    float* buf = stage + (s & 1) * kStage;
    const int c0 = (s / nK) * kCB, k0 = (s % nK) * kKC;
    stage_x(buf, kKS, xp, row_stride, a0, TA, k0, kKC / 4, B, D, vec);
    stage_x(buf + TA * kKS, kKS, xp, row_stride, c0, kCB, k0, kKC / 4, B, D, vec);
    cp_async_commit();
  };

  load(0);
  for (int t = threadIdx.x; t < B; t += kThreads) lab[t] = labels[t];

  // ---- Gram product: warp w owns the pass's columns 16 w .. 16 w + 15 and
  // all TA rows; lane (lr, lc) the rows lr + 8 m and the columns
  // 16 w + lc + 4 q.  Each float4 load then touches 8 (rows) or 4 (columns)
  // distinct shared rows: one wavefront, against 4 RM FMAs per value.
  float acc[RM][4];
  float sqc = 0.f;   // lanes 0-15: the norm of column 16 w + lane
  for (int s = 0; s < nS; ++s) {
    if (s + 1 < nS) {
      load(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kc = s % nK;
    if (kc == 0) {
#pragma unroll
      for (int m = 0; m < RM; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][q] = 0.f;
      sqc = 0.f;
    }
    const float* A = stage + (s & 1) * kStage;
    const float* C = A + TA * kKS;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 4) {
      float4 a[RM], b[4];
#pragma unroll
      for (int m = 0; m < RM; ++m)
        a[m] = *reinterpret_cast<const float4*>(A + (lr + 8 * m) * kKS + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        b[q] = *reinterpret_cast<const float4*>(C + (16 * w + lc + 4 * q) * kKS + kk);
#pragma unroll
      for (int m = 0; m < RM; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float v = acc[m][q];
          v = fmaf(a[m].x, b[q].x, v);
          v = fmaf(a[m].y, b[q].y, v);
          v = fmaf(a[m].z, b[q].z, v);
          v = fmaf(a[m].w, b[q].w, v);
          acc[m][q] = v;
        }
    }
    if (lane < 16) {      // column norms, in the dot products' k order
      const float* cr = C + (16 * w + lane) * kKS;
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 4) {
        const float4 b = *reinterpret_cast<const float4*>(cr + kk);
        sqc = fmaf(b.x, b.x, sqc);
        sqc = fmaf(b.y, b.y, sqc);
        sqc = fmaf(b.z, b.z, sqc);
        sqc = fmaf(b.w, b.w, sqc);
      }
    }
    if (kc == nK - 1) {   // this column block is complete: park its dots
      const int c0 = (s / nK) * kCB + 16 * w;
#pragma unroll
      for (int m = 0; m < RM; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = c0 + lc + 4 * q;
          if (col < B) drow[(lr + 8 * m) * B + col] = acc[m][q];
        }
      if (lane < 16 && c0 + lane < B) sq[c0 + lane] = sqc;
    }
    __syncthreads();      // the buffer is refilled by the next iteration
  }

  // ---- dots -> guarded distances, in shared memory and to dist
  const int nrows = min(TA, B - a0);
  for (int r = w; r < nrows; r += kWarps) {
    const int a = a0 + r;
    float* dout = dist + ((long long)p * B + a) * B;
    for (int j = lane; j < B; j += 32) {
      float d2 = __fsub_rn(__fadd_rn(sq[a], sq[j]), __fmul_rn(2.f, drow[r * B + j]));
      d2 = (a == j) ? 0.f : fmaxf(d2, 0.f);   // the diagonal is identically 0
      const float d = d2 > 0.f ? sqrtf(d2) : 0.f;
      drow[r * B + j] = d;
      dout[j] = d;
    }
  }
  __syncthreads();

  // ---- hinge: one warp per anchor, lanes over the negatives
  float s_sum = 0.f;
  int s_cnt = 0;
  for (int r = w; r < nrows; r += kWarps) {
    const int la = lab[a0 + r];
    const float* da = drow + r * B;
    for (int k0 = 0; k0 < B; k0 += 32 * kNV) {   // negatives in registers
      float dv[kNV];
      bool neg[kNV];
#pragma unroll
      for (int v = 0; v < kNV; ++v) {
        const int k = k0 + 32 * v + lane;
        neg[v] = k < B && lab[k] != la;
        dv[v] = neg[v] ? da[k] : 0.f;
      }
      for (int j0 = 0; j0 < B; j0 += 32) {
        unsigned pos = __ballot_sync(kFull, j0 + lane < B && lab[j0 + lane] == la);
        while (pos) {
          const int j = j0 + __ffs(pos) - 1;
          pos &= pos - 1;
          const float base = margin + da[j];
#pragma unroll
          for (int v = 0; v < kNV; ++v) {
            const float t = base - dv[v];
            if (neg[v] && t > 0.f) {
              s_sum += t;
              ++s_cnt;
            }
          }
        }
      }
    }
  }
  s_sum = warp_sum(s_sum);
  s_cnt = warp_sum(s_cnt);
  if (lane == 0) {
    red_s[w] = s_sum;
    red_c[w] = s_cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bs = 0.f;
    int bc = 0;
    for (int i = 0; i < kWarps; ++i) {
      bs += red_s[i];
      bc += red_c[i];
    }
    sums[(long long)p * gridDim.x + blockIdx.x] = bs;
    counts[(long long)p * gridDim.x + blockIdx.x] = bc;
  }
}

// Shared memory: d rows [ta][B], labels [B], counts [ta][B]
// (plan: rows_smem_bytes).
__global__ void __launch_bounds__(kThreads)
triplet_rows_kernel(const float* __restrict__ dist, const int* __restrict__ labels,
                    const float* __restrict__ scale, float* __restrict__ g, int B,
                    int ta, float margin, int vec) {
  extern __shared__ float4 smem4[];
  float* drows = reinterpret_cast<float*>(smem4);
  int* lab = reinterpret_cast<int*>(drows + ta * B);
  int* cnt = lab + B;
  const int p = blockIdx.y, a0 = blockIdx.x * ta;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nrows = min(ta, B - a0);
  const long long row0 = (long long)p * B + a0;
  stage_words(drows, dist + row0 * B, nrows * B, vec);
  stage_words(lab, labels, B, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const float sc = scale[p];
  for (int r = w; r < nrows; r += kWarps) {
    const int la = lab[a0 + r];
    const float* da = drows + r * B;
    int* ca = cnt + r * B;
    for (int k0 = 0; k0 < B; k0 += 32 * kNV) {   // negatives in registers
      float dv[kNV];
      bool neg[kNV];
      int nc[kNV];
#pragma unroll
      for (int v = 0; v < kNV; ++v) {
        const int k = k0 + 32 * v + lane;
        neg[v] = k < B && lab[k] != la;
        dv[v] = neg[v] ? da[k] : 0.f;
        nc[v] = 0;
      }
      for (int j0 = 0; j0 < B; j0 += 32) {
        unsigned pos = __ballot_sync(kFull, j0 + lane < B && lab[j0 + lane] == la);
        while (pos) {
          const int j = j0 + __ffs(pos) - 1;
          pos &= pos - 1;
          const float base = margin + da[j];
          int c = 0;
#pragma unroll
          for (int v = 0; v < kNV; ++v) {
            const bool act = neg[v] && base - dv[v] > 0.f;
            c += __popc(__ballot_sync(kFull, act));   // j as the positive
            nc[v] += act;                             // k as the negative
          }
          if (lane == 0) ca[j] = k0 == 0 ? c : ca[j] + c;
        }
      }
#pragma unroll
      for (int v = 0; v < kNV; ++v)
        if (neg[v]) ca[k0 + 32 * v + lane] = -nc[v];
    }
    __syncwarp();
    float* grow = g + (row0 + r) * B;
    for (int m = lane; m < B; m += 32) grow[m] = (float)ca[m] * sc;
  }
}

// Shared memory: x stages [2][kJC][kDC], W rows [TI][B | 1]
// (plan: finish_smem_bytes).
template <int RM>
__global__ void __launch_bounds__(kThreads)
triplet_finish_kernel(const float* __restrict__ x, const float* __restrict__ dist,
                      const float* __restrict__ g, float* __restrict__ dx, int B, int D,
                      long long part_stride, long long row_stride, int vec) {
  constexpr int TI = kWarps * RM;
  constexpr int kStage = kJC * kDC;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* wt = xs + 2 * kStage;
  const int ws = B | 1;                     // odd stride: column writes spread
  const int i0 = blockIdx.x * TI, c0 = blockIdx.y * kDC, p = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const float* xp = x + p * part_stride;
  const float* gp = g + (long long)p * B * B;
  const float* dp = dist + (long long)p * B * B;
  const int nJ = (B + kJC - 1) / kJC;

  auto load = [&](int s) {
    stage_x(xs + (s & 1) * kStage, kDC, xp, row_stride, s * kJC, kJC, c0,
            kDC / 4, B, D, vec);
    cp_async_commit();
  };
  load(0);

  // W rows, while the first stage is in flight: g rows (coalesced in j),
  // then g columns and d (coalesced in i; d is bitwise symmetric).  Warp w
  // takes rows w, w + 8, ... in the first pass and columns j = w, w + 8, ...
  // in the second, kLoads of them at a time so their loads overlap.
  constexpr int kLoads = 4;
  for (int r0 = w; r0 < TI; r0 += kWarps * kLoads) {
    float v[kLoads][kNV];   // kNV: up to 128 columns per pass
    for (int j0 = 0; j0 < B; j0 += 32 * kNV) {
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
#pragma unroll
        for (int q = 0; q < kNV; ++q) {
          const int i = i0 + r0 + kWarps * u, j = j0 + 32 * q + lane;
          v[u][q] = (r0 + kWarps * u < TI && i < B && j < B)
                        ? gp[(long long)i * B + j] : 0.f;
        }
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
#pragma unroll
        for (int q = 0; q < kNV; ++q) {
          const int r = r0 + kWarps * u, j = j0 + 32 * q + lane;
          if (r < TI && j < B) wt[r * ws + j] = v[u][q];
        }
    }
  }
  __syncthreads();
  for (int jb = 0; jb < B; jb += kWarps * kLoads) {
    float gv[kLoads], dv[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = jb + w + kWarps * u, i = i0 + lane;
      const bool ok = j < B && lane < TI && i < B;
      gv[u] = ok ? gp[(long long)j * B + i] : 0.f;
      dv[u] = ok ? dp[(long long)j * B + i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = jb + w + kWarps * u;
      if (j < B && lane < TI && i0 + lane < B)
        wt[lane * ws + j] = (wt[lane * ws + j] + gv[u]) *
                            (dv[u] > 0.f ? 1.f / dv[u] : 0.f);
    }
  }

  // lane (lr, lc) owns rows lr + 8 m and the columns 16 w + 4 lc .. + 3: each
  // float4 of x touches 4 distinct shared rows and each W load 8, one
  // wavefront apiece
  const int lr = lane >> 2, lc = lane & 3, cl = 16 * w + 4 * lc;
  float xi[RM][4], acc[RM][4];
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int i = i0 + lr + 8 * m;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = c0 + cl + q;
      xi[m][q] = (i < B && col < D) ? xp[i * row_stride + col] : 0.f;
      acc[m][q] = 0.f;
    }
  }

  for (int s = 0; s < nJ; ++s) {
    if (s + 1 < nJ) {
      load(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xt = xs + (s & 1) * kStage;
    const int j0 = s * kJC, jn = min(kJC, B - j0);
#pragma unroll 8
    for (int jj = 0; jj < jn; ++jj) {
      const float4 xj = *reinterpret_cast<const float4*>(xt + jj * kDC + cl);
#pragma unroll
      for (int m = 0; m < RM; ++m) {
        const float wv = wt[(lr + 8 * m) * ws + j0 + jj];
        acc[m][0] = fmaf(wv, xi[m][0] - xj.x, acc[m][0]);
        acc[m][1] = fmaf(wv, xi[m][1] - xj.y, acc[m][1]);
        acc[m][2] = fmaf(wv, xi[m][2] - xj.z, acc[m][2]);
        acc[m][3] = fmaf(wv, xi[m][3] - xj.w, acc[m][3]);
      }
    }
    __syncthreads();      // the buffer is refilled by the next iteration
  }

#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int i = i0 + lr + 8 * m;
    if (i >= B) continue;
    float* out = dx + p * part_stride + i * row_stride;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = c0 + cl + q;
      if (col < D) out[col] = acc[m][q];
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

extern "C" {

// Forward: writes dist (P, B, B) and one partial per CTA, sums (P, grid_x)
// fp32 and counts (P, grid_x) int32.  x[p, i, k] is at x + p * part_stride +
// i * row_stride + k.  ta (8, 16 or 32), grid_x = ceil(B / ta) and smem come
// from plan().  Returns a cudaError_t.
int triplet_fwd(const float* x, const int* labels, float* dist, float* sums,
                int* counts, int P, int B, int D, long long part_stride,
                long long row_stride, float margin, int ta, int grid_x,
                int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = D % 4 == 0 && part_stride % 4 == 0 && row_stride % 4 == 0 &&
                  aligned16(x);
  const dim3 grid(grid_x, P);
  if (ta == 8) {
    cudaError_t err = allow_smem(triplet_fwd_kernel<1>, smem);
    if (err != cudaSuccess) return err;
    triplet_fwd_kernel<1><<<grid, kThreads, smem, s>>>(
        x, labels, dist, sums, counts, B, D, part_stride, row_stride, margin, vec);
  } else if (ta == 16) {
    cudaError_t err = allow_smem(triplet_fwd_kernel<2>, smem);
    if (err != cudaSuccess) return err;
    triplet_fwd_kernel<2><<<grid, kThreads, smem, s>>>(
        x, labels, dist, sums, counts, B, D, part_stride, row_stride, margin, vec);
  } else if (ta == 32) {
    cudaError_t err = allow_smem(triplet_fwd_kernel<4>, smem);
    if (err != cudaSuccess) return err;
    triplet_fwd_kernel<4><<<grid, kThreads, smem, s>>>(
        x, labels, dist, sums, counts, B, D, part_stride, row_stride, margin, vec);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Backward: from the forward's dist and the per-part scale (P,)
// (upstream / (count_p * P), 0 where count_p is 0) writes the scaled
// distance gradient g (P, B, B) and dx in x's layout.  rows_ta /
// rows_grid_x / rows_smem and ti (8, 16 or 32) / fin_grid_x / fin_grid_y /
// fin_smem come from plan().  Returns a cudaError_t.
int triplet_bwd(const float* x, const int* labels, const float* dist,
                const float* scale, float* g, float* dx, int P, int B, int D,
                long long part_stride, long long row_stride, float margin,
                int rows_ta, int rows_grid_x, int rows_smem, int ti,
                int fin_grid_x, int fin_grid_y, int fin_smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_vec = B % 4 == 0 && aligned16(dist) && aligned16(labels);
  cudaError_t err = allow_smem(triplet_rows_kernel, rows_smem);
  if (err != cudaSuccess) return err;
  triplet_rows_kernel<<<dim3(rows_grid_x, P), kThreads, rows_smem, s>>>(
      dist, labels, scale, g, B, rows_ta, margin, rows_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int vec = D % 4 == 0 && part_stride % 4 == 0 && row_stride % 4 == 0 &&
                  aligned16(x);
  const dim3 grid(fin_grid_x, fin_grid_y, P);
  if (ti == 8) {
    err = allow_smem(triplet_finish_kernel<1>, fin_smem);
    if (err != cudaSuccess) return err;
    triplet_finish_kernel<1><<<grid, kThreads, fin_smem, s>>>(
        x, dist, g, dx, B, D, part_stride, row_stride, vec);
  } else if (ti == 16) {
    err = allow_smem(triplet_finish_kernel<2>, fin_smem);
    if (err != cudaSuccess) return err;
    triplet_finish_kernel<2><<<grid, kThreads, fin_smem, s>>>(
        x, dist, g, dx, B, D, part_stride, row_stride, vec);
  } else if (ti == 32) {
    err = allow_smem(triplet_finish_kernel<4>, fin_smem);
    if (err != cudaSuccess) return err;
    triplet_finish_kernel<4><<<grid, kThreads, fin_smem, s>>>(
        x, dist, g, dx, B, D, part_stride, row_stride, vec);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"

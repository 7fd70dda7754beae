// Batch-all triplet loss: forward and analytic backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of ugaitnet_tpu/ops/pallas/triplet_kernel.py:
//   triplet_fwd  <- _fwd_kernel (:159)  and, for 128 < B <= 512, _fwd_kernel_grid (:264)
//   triplet_bwd  <- _bwd_kernel (:187)  and _bwd_kernel_grid (:280) + _grid_bwd_finish (:327)
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
// Launches (all on the caller's stream, no allocation, no synchronisation):
//   dist_kernel    grid (B/16, B/16, P): 16x16 tiles of d, x rows staged in
//                  shared memory; |xi|^2, |xj|^2 and xi.xj accumulate in the
//                  same FMA order, so d is exactly symmetric.
//   fwd_kernel     grid (B, P): one block per (part, anchor) loops over the
//                  same-label j (uniform branch) and the k of its threads, and
//                  writes one (sum, count) partial.  No atomics: the result is
//                  deterministic.  The mean over anchors and parts is a torch
//                  reduction outside, as _combine is XLA outside the Pallas call.
//   grow_kernel    grid (B, P): one block per (part, anchor) writes the scaled
//                  g row; thread m counts the triplets in which m is the
//                  positive (loop over k) or the negative (loop over j).
//   finish_kernel  grid (B, P): one block per (part, row i) stages W[i, :] in
//                  shared memory in tiles, then each thread owns feature
//                  columns and sums W[i,j] (xi - xj) over j.  This form has
//                  no rowsum(W) xi - W x cancellation, and W[i,i] is 0.
//
// What bounds it on an H100 at the flagship (P, B, D) = (62, 120, 256):
// 7.6 MB of embeddings read (2.3 us at 3.35 TB/s), 0.46 GFLOP of distance
// products (6.8 us at the 67 TFLOP/s fp32 rate outside the tensor cores) and
// 8.2 M valid (a, p, n) triplets of a few fp32 operations each (< 1 us).
// The bound is operations: a few microseconds per pass.  This first version
// is plain CUDA cores in fp32 and makes no use of wgmma or TMA.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;       // dist_kernel output tile and D chunk
constexpr int kThreads = 128;   // fwd / grow block size
constexpr int kFinishThreads = 256;
constexpr int kWTile = 1024;    // W entries staged per pass in finish_kernel

__global__ void dist_kernel(const float* __restrict__ x, float* __restrict__ dist,
                            int B, int D, long long part_stride, long long row_stride) {
  __shared__ float xa[kTile][kTile + 1];
  __shared__ float xb[kTile][kTile + 1];
  const int p = blockIdx.z;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int ty = threadIdx.y, tx = threadIdx.x;
  const float* xp = x + p * part_stride;
  float dot = 0.f, sqa = 0.f, sqb = 0.f;
  for (int k0 = 0; k0 < D; k0 += kTile) {
    const int k = k0 + tx;
    const int ia = i0 + ty, jb = j0 + ty;
    xa[ty][tx] = (ia < B && k < D) ? xp[ia * row_stride + k] : 0.f;
    xb[ty][tx] = (jb < B && k < D) ? xp[jb * row_stride + k] : 0.f;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile; ++kk) {
      const float a = xa[ty][kk], b = xb[tx][kk];
      dot = fmaf(a, b, dot);
      sqa = fmaf(a, a, sqa);
      sqb = fmaf(b, b, sqb);
    }
    __syncthreads();
  }
  const int i = i0 + ty, j = j0 + tx;
  if (i < B && j < B) {
    // (|xi|^2 + |xj|^2) - 2 xi.xj with no FMA contraction, as the plain form
    float d2 = __fsub_rn(__fadd_rn(sqa, sqb), __fmul_rn(2.f, dot));
    d2 = (i == j) ? 0.f : fmaxf(d2, 0.f);   // the diagonal is identically 0
    dist[((long long)p * B + i) * B + j] = d2 > 0.f ? sqrtf(d2) : 0.f;
  }
}

__device__ __forceinline__ float block_sum_f(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;  // valid in thread 0 only
}

__device__ __forceinline__ int block_sum_i(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;  // valid in thread 0 only
}

__global__ void fwd_kernel(const float* __restrict__ dist, const int* __restrict__ labels,
                           float* __restrict__ sums, int* __restrict__ counts,
                           int B, float margin) {
  __shared__ float red_f[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  const int a = blockIdx.x, p = blockIdx.y;
  const float* drow = dist + ((long long)p * B + a) * B;
  const int la = labels[a];
  float s = 0.f;
  int c = 0;
  for (int j = 0; j < B; ++j) {
    if (labels[j] != la) continue;          // uniform across the block
    const float base = margin + drow[j];
    for (int k = threadIdx.x; k < B; k += blockDim.x) {
      if (labels[k] == la) continue;
      const float t = base - drow[k];
      if (t > 0.f) { s += t; ++c; }
    }
  }
  const float bs = block_sum_f(s, red_f);
  const int bc = block_sum_i(c, red_i);
  if (threadIdx.x == 0) {
    sums[(long long)p * B + a] = bs;
    counts[(long long)p * B + a] = bc;
  }
}

__global__ void grow_kernel(const float* __restrict__ dist, const int* __restrict__ labels,
                            const float* __restrict__ scale, float* __restrict__ g,
                            int B, float margin) {
  const int a = blockIdx.x, p = blockIdx.y;
  const float* drow = dist + ((long long)p * B + a) * B;
  float* grow = g + ((long long)p * B + a) * B;
  const int la = labels[a];
  const float sc = scale[p];
  for (int m = threadIdx.x; m < B; m += blockDim.x) {
    const float dm = drow[m];
    int n = 0;
    if (labels[m] == la) {                  // m as the positive j
      const float base = margin + dm;
      for (int k = 0; k < B; ++k)
        if (labels[k] != la && base - drow[k] > 0.f) ++n;
    } else {                                // m as the negative k
      for (int j = 0; j < B; ++j)
        if (labels[j] == la && (margin + drow[j]) - dm > 0.f) --n;
    }
    grow[m] = (float)n * sc;
  }
}

__global__ void finish_kernel(const float* __restrict__ x, const float* __restrict__ dist,
                              const float* __restrict__ g, float* __restrict__ dx,
                              int B, int D, long long part_stride, long long row_stride) {
  __shared__ float w[kWTile];
  const int i = blockIdx.x, p = blockIdx.y;
  const float* xp = x + p * part_stride;
  const float* gp = g + (long long)p * B * B;
  const float* drow = dist + ((long long)p * B + i) * B;
  const float* xi = xp + i * row_stride;
  float* out = dx + p * part_stride + i * row_stride;
  // columns owned by this thread: c0, c0 + blockDim, ... (at most 4 live)
  constexpr int kCols = 4;
  float acc[kCols];
  float xiv[kCols];
  for (int cb = 0; cb < D; cb += kCols * kFinishThreads) {
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int col = cb + q * kFinishThreads + threadIdx.x;
      acc[q] = 0.f;
      xiv[q] = col < D ? xi[col] : 0.f;
    }
    for (int j0 = 0; j0 < B; j0 += kWTile) {
      const int nj = min(kWTile, B - j0);
      __syncthreads();
      for (int t = threadIdx.x; t < nj; t += blockDim.x) {
        const int j = j0 + t;
        const float dij = drow[j];
        w[t] = (gp[(long long)i * B + j] + gp[(long long)j * B + i]) *
               (dij > 0.f ? 1.f / dij : 0.f);
      }
      __syncthreads();
      for (int t = 0; t < nj; ++t) {
        const float wij = w[t];
        if (wij == 0.f) continue;           // uniform across the block
        const float* xj = xp + (j0 + t) * row_stride;
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const int col = cb + q * kFinishThreads + threadIdx.x;
          if (col < D) acc[q] = fmaf(wij, xiv[q] - xj[col], acc[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int col = cb + q * kFinishThreads + threadIdx.x;
      if (col < D) out[col] = acc[q];
    }
  }
}

}  // namespace

extern "C" {

// Forward: writes dist (P, B, B) and the per-(part, anchor) partials
// sums (P, B) fp32 and counts (P, B) int32.  x[p, i, k] is at
// x + p * part_stride + i * row_stride + k.  Returns a cudaError_t.
int triplet_fwd(const float* x, const int* labels, float* dist, float* sums,
                int* counts, int P, int B, int D, long long part_stride,
                long long row_stride, float margin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = (B + kTile - 1) / kTile;
  dist_kernel<<<dim3(nt, nt, P), dim3(kTile, kTile), 0, s>>>(
      x, dist, B, D, part_stride, row_stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fwd_kernel<<<dim3(B, P), kThreads, 0, s>>>(dist, labels, sums, counts, B, margin);
  return cudaGetLastError();
}

// Backward: from the forward's dist and the per-part scale (P,)
// (upstream / (count_p * P), 0 where count_p is 0) writes the scaled
// distance gradient g (P, B, B) and dx in x's layout.  Returns a cudaError_t.
int triplet_bwd(const float* x, const int* labels, const float* dist,
                const float* scale, float* g, float* dx, int P, int B, int D,
                long long part_stride, long long row_stride, float margin,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  grow_kernel<<<dim3(B, P), kThreads, 0, s>>>(dist, labels, scale, g, B, margin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finish_kernel<<<dim3(B, P), kFinishThreads, 0, s>>>(
      x, dist, g, dx, B, D, part_stride, row_stride);
  return cudaGetLastError();
}

}  // extern "C"

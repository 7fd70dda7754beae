// Two probes of the card, for Hopper (sm_90a).  No model path calls them;
// they measure what the conv stack's kernels are held against.
//
//   mm_fwd_kernel replaces the Pallas TPU kernel _mm_kernel
//   (benchmarks/proto_mm.py:33, launched by _mm_call at :55, pallas_call
//   :57), the dense GEMM ceiling at the conv stack's K:
//       y (M, 128) = bf16_rn( x[:, :Kw] (M, Kw) @ w (Kw, 128) ),
//   w the prototype's (nb, 128, 128) blocks, which are (Kw = 128 nb, 128)
//   row-major; x (M, K) with K >= Kw.  As in the prototype, whose kernel
//   loops over K // 128 blocks, a K that is not a multiple of 128 (its
//   576) leaves x's last K - Kw columns unread.  bf16 operands, float32
//   accumulation, one rounding.  At the
//   prototype's M = 262,144 and K = 1,152 on an H100 (SXM, 700 W): reading x
//   (604 MB) takes 0.180 ms at 3.35 TB/s (0.200 ms with w and y), against
//   77.3 GFLOP, 0.078 ms at 989 dense bf16 TFLOP/s: bytes bound it.
//   One CTA of 256 threads computes 128 rows x 128 columns with the conv
//   kernel's mma.sync tile code (mma_tile.cuh: 8 warps of 64 x 32), staging
//   32-wide K chunks of x ([m][k]) and w ([k][n], read by ldmatrix.trans)
//   with 16-byte copies; rows past M are zero and never stored.
//
//   scale2_kernel replaces _copy_kernel (benchmarks/proto_mm.py:72,
//   pallas_call :85), the HBM copy probe: y = x * 2 over a contiguous bf16
//   tensor (the prototype's (T*32*32*32, B) batch-minor view), rounded as
//   torch rounds x * 2 (exactly: doubling a bf16 is exact, or inf).  Bytes
//   bound it: one read and one write, 2 x 209.7 MB for the prototype's
//   (128, 25, 32, 32, 32) tensor, 0.125 ms at 3.35 TB/s.  Each thread moves
//   8 values (16 bytes) at a time, grid-stride; a tail or an unaligned
//   pointer takes scalar loads.
//
// Each launcher returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;       // rows a CTA
constexpr int kN = 128;        // output columns (the prototype's width)
constexpr int kKC = 32;        // K a stage
constexpr int kAS = kKC + 8;   // [m][k] stride in bf16 (80 bytes)
constexpr int kBS = kN + 8;    // [k][n] stride in bf16 (272 bytes)
constexpr int WM = 2, WN = 4;  // warps: each 64 rows x 32 columns
constexpr int MT = kBM / WM / 16, NT = kN / WN / 8;

__global__ void __launch_bounds__(kThreads)
    mm_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w,
                  __nv_bfloat16* __restrict__ y, long long M, int K,
                  int ldx) {
  __shared__ __align__(16) __nv_bfloat16 sa[kBM * kAS];
  __shared__ __align__(16) __nv_bfloat16 sb[kKC * kBS];
  const long long m0 = (long long)blockIdx.x * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % WM, wn = warp / WM;
  const uint32_t sa_lane =
      mma_tile::smem_addr(sa) +
      2 * ((wm * (kBM / WM) + mma_tile::a_row(lane)) * kAS +
           mma_tile::a_k(lane));
  const uint32_t sb_lane =
      mma_tile::smem_addr(sb) +
      2 * (mma_tile::b_rows_kn(lane) * kBS + wn * (kN / WN) +
           mma_tile::b_n_kn(lane));

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  for (int k0 = 0; k0 < K; k0 += kKC) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBM * (kKC / 8); i += kThreads) {
      const int r = i >> 2, q = i & 3;
      const long long m = m0 + r;
      *reinterpret_cast<uint4*>(sa + r * kAS + q * 8) =
          m < M ? *reinterpret_cast<const uint4*>(x + m * ldx + k0 + q * 8)
                : zero4;
    }
    for (int i = threadIdx.x; i < kKC * (kN / 8); i += kThreads) {
      const int r = i >> 4, q = i & 15;
      *reinterpret_cast<uint4*>(sb + r * kBS + q * 8) =
          *reinterpret_cast<const uint4*>(w + (long long)(k0 + r) * kN + q * 8);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      uint32_t a_addr[MT], b_addr[NT / 2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        a_addr[mt] = sa_lane + 2 * (mt * 16 * kAS + ks * 16);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)
        b_addr[j] = sb_lane + 2 * (ks * 16 * kBS + j * 16);
      mma_tile::warp_k16<MT, NT, true>(acc, a_addr, b_addr);
    }
  }

  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const long long m = m0 + wm * (kBM / WM) + mt * 16 + g;
      const int col = wn * (kN / WN) + nt * 8 + 2 * q;
      if (m < M)
        *reinterpret_cast<__nv_bfloat162*>(y + m * kN + col) =
            __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
      if (m + 8 < M)
        *reinterpret_cast<__nv_bfloat162*>(y + (m + 8) * kN + col) =
            __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

__device__ __forceinline__ __nv_bfloat16 twice(__nv_bfloat16 v) {
  return __float2bfloat16_rn(__bfloat162float(v) * 2.f);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    scale2_kernel(const __nv_bfloat16* __restrict__ x,
                  __nv_bfloat16* __restrict__ y, long long n) {
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (kVec) {
    const long long nv = n / 8;
    for (; i < nv; i += stride) {
      uint4 v = reinterpret_cast<const uint4*>(x)[i];
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k) e[k] = twice(e[k]);
      reinterpret_cast<uint4*>(y)[i] = v;
    }
    i = nv * 8 + blockIdx.x * (long long)kThreads + threadIdx.x;
  }
  for (; i < n; i += stride) y[i] = twice(x[i]);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// x (M, ldx), w (K, 128), y (M, 128): bf16, contiguous, 16-byte aligned;
// K a positive multiple of 128, ldx >= K a multiple of 8.
int mm_fwd(const void* x, const void* w, void* y, long long M, int K, int ldx,
           void* stream) {
  if (M < 1 || K < 128 || K % 128 || ldx < K || ldx % 8 || !aligned16(x) ||
      !aligned16(w) || !aligned16(y))
    return cudaErrorInvalidValue;
  const long long blocks = (M + kBM - 1) / kBM;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  mm_fwd_kernel<<<(unsigned)blocks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y), M,
      K, ldx);
  return cudaGetLastError();
}

// y = x * 2 over n contiguous bf16 values
int scale2(const void* x, void* y, long long n, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const bool vec = aligned16(x) && aligned16(y);
  const long long items = vec ? n / 8 + 1 : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  const long long cap = 8LL * (sms > 0 ? sms : 132);
  if (blocks > cap) blocks = cap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xt = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* yt = static_cast<__nv_bfloat16*>(y);
  if (vec)
    scale2_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(xt, yt, n);
  else
    scale2_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(xt, yt, n);
  return cudaGetLastError();
}

}  // extern "C"

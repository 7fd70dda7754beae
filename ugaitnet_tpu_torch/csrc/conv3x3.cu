// 3x3 "SAME" convolution, bfloat16 in and out with float32 accumulation,
// forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels _p1_kernel (benchmarks/proto_conv.py:50,
// launched by p1_conv at :64, pallas_call :67: a_conv6's shape, 16x16,
// 128 -> 128 channels, on a zero-padded 19x19 row-major frame) and
// _p2_kernel (:135, p2_conv :152, pallas_call :154: a_conv2's shape, 64x64,
// 32 -> 32 channels, four width phases packed into 128 lanes).  Both compute
// one function at two shapes, so one kernel serves both.  The TPU layouts
// are lane tricks and are not carried over; _p2_kernel's edge taps also
// read the neighbouring row at the first and last column group, so it is
// wrong on the border columns, and this kernel is exact on every row and
// column.
//
// Semantics, for x (N, Ci, H, W) and w (Co, Ci, 3, 3), both bfloat16 and
// contiguous (the port's NCHW frame stream, read as it is):
//   y[n, co, i, j] = bf16_rn( sum over ci, di, dj of
//                      x[n, ci, i + di - 1, j + dj - 1] * w[co, ci, di, dj] )
// with x = 0 outside the frame: bf16 x bf16 products are exact in float32,
// the sum is float32 (in the tensor cores' order), rounded once to nearest
// even.  y is (N, Co, H, W) contiguous, the layout the stage tail takes.
// Any N, Ci, Co, H, W >= 1.
//
// What bounds it on an H100 (SXM, 700 W), at the flagship encode batch
// N = B 128 x T 25 = 3,200 frames:
//   a_conv6 (Ci = Co = 128, 16x16): 241.6 GFLOP, 0.244 ms at 989 dense bf16
//       TFLOP/s, against 0.419 GB moved (x read, y written), 0.125 ms at
//       3.35 TB/s: operations bound it.
//   a_conv2 (Ci = Co = 32, 64x64): the same 241.6 GFLOP against 1.68 GB,
//       0.501 ms: bytes bound it.
// This first kernel is simple and right (mma.sync, synchronous staging);
// wgmma, TMA and warp specialisation are later work.
//
//   conv3x3_pack_kernel
//       Lays the weights out as wp (9, Co_pad, Ci_pad), tap-major, each
//       (tap, co) row holding Ci_pad input channels (zero past Co and Ci),
//       so that a stage copies them with 16-byte loads.
//   conv3x3_fwd_kernel
//       Implicit GEMM: M = output pixels, N = output channels, K = 9 taps
//       x Ci.  One CTA of 256 threads (8 warps) computes 128 output pixels
//       (a tile of TR rows x TW columns of one frame, TR x TW <= 128) for BN
//       (32, 64 or 128) output channels.  Per stage of 32 input channels it
//       stages into shared memory the zero-haloed input band, (TR + 2) x
//       (TW + 2) pixels by 32 channels, pixel-major (each pixel's channels
//       contiguous: the NCHW stream is transposed on the way in, two
//       channels to a 32-bit store), and that stage's weights (9 taps x BN
//       x 32).  a_conv6 (16x16) takes 8 whole rows of a frame, a_conv2
//       (64x64) 2 rows.  Each warp then runs 9 taps x 2 k16 steps of
//       mma.sync m16n8k16 on its (128 / WM) x (BN / WN) tile, A and B by
//       ldmatrix; a tap is a shift of the band's pixel address, so no im2col
//       buffer exists.  Rows of 40 bf16 (80 bytes) keep ldmatrix free of bank
//       conflicts.  The float32 sums are rounded to bf16 (round to nearest
//       even) into shared memory and written out channel by channel, so
//       neighbouring threads store neighbouring pixels.  Pixels past the
//       frame, channels past Ci and Co are zero in shared memory and never
//       stored.  The CTA's N tile is the fastest grid index, so the CTAs
//       that share a band run together and read it from L2.
// Launch geometry (TR, TW, BN, shared memory) is chosen in Python
// (ops/cuda/conv3x3.py:plan) and checked here.  Each launcher returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;       // output pixels a CTA
constexpr int kKC = 32;        // input channels a stage
constexpr int kKS = kKC + 8;   // shared row stride in bf16 (80 bytes)
constexpr int kOS = kBM + 8;   // output staging row stride in bf16

__global__ void conv3x3_pack_kernel(const __nv_bfloat16* __restrict__ w,
                                    __nv_bfloat16* __restrict__ wp, int Ci,
                                    int Co, int co_pad, int ci_pad) {
  const long long total = 9LL * co_pad * ci_pad;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int ci = (int)(i % ci_pad);
    const long long r = i / ci_pad;
    const int co = (int)(r % co_pad), tap = (int)(r / co_pad);
    wp[i] = (co < Co && ci < Ci) ? w[((long long)co * Ci + ci) * 9 + tap]
                                 : __float2bfloat16_rn(0.f);
  }
}

// WM x WN warps; each warp an (kBM / WM) x (BN / WN) tile of (pixels,
// output channels).  At least 2 CTAs an SM: at most 128 registers a thread
// (ptxas: 125, 107 and 78 for BN = 128, 64, 32, no spills; left to itself
// it gave BN = 32 64 registers and a spill)
template <int BN, int WM, int WN>
__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ wp,
                       __nv_bfloat16* __restrict__ y, int Ci, int Co, int H,
                       int W, int TR, int TW, int tiles_w,
                       int tiles_per_frame, int n_tiles_n, int co_pad,
                       int ci_pad) {
  static_assert(WM * WN * 32 == kThreads, "8 warps");
  constexpr int MT = kBM / WM / 16;
  constexpr int NT = BN / WN / 8;
  static_assert(MT >= 1 && NT >= 2 && NT % 2 == 0, "warp tile");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(smem);  // [9][BN][kKS]
  __nv_bfloat16* sx = sw + 9 * BN * kKS;                // [band px][kKS]

  const int BW = TW + 2;
  const int band_px = (TR + 2) * BW;
  const int npx = TR * TW;
  const int tile = blockIdx.x / n_tiles_n;
  const int n0 = (blockIdx.x - tile * n_tiles_n) * BN;
  const int n = tile / tiles_per_frame;
  const int t = tile - n * tiles_per_frame;
  const int row0 = (t / tiles_w) * TR;
  const int col0 = (t - (t / tiles_w) * tiles_w) * TW;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % WM, wn = warp / WM;
  // the band pixel of this lane's A row in each m tile (tap (0, 0)); rows
  // past the tile's pixels read pixel npx - 1 and are never stored
  int a_px[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    int m = wm * (kBM / WM) + mt * 16 + mma_tile::a_row(lane);
    m = m < npx ? m : npx - 1;
    const int r = m / TW;
    a_px[mt] = r * BW + (m - r * TW);
  }
  const uint32_t sx_lane = mma_tile::smem_addr(sx) + 2 * mma_tile::a_k(lane);
  const uint32_t sw_lane =
      mma_tile::smem_addr(sw) +
      2 * ((wn * (BN / WN) + mma_tile::b_rows_nk(lane)) * kKS +
           mma_tile::b_k_nk(lane));

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const long long hw = (long long)H * W;
  const __nv_bfloat16* xn = x + (long long)n * Ci * hw;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int c0 = 0; c0 < Ci; c0 += kKC) {
    const int kc = Ci - c0 < kKC ? Ci - c0 : kKC;
    __syncthreads();  // the previous stage's reads are done
    // the stage's weights: 9 x BN rows of 32 bf16, 4 x 16 bytes each
    for (int i = threadIdx.x; i < 9 * BN * 4; i += kThreads) {
      const int q = i & 3, row = i >> 2;  // row = tap * BN + co
      const int tap = row / BN, co = row - tap * BN;
      const uint4 v = *reinterpret_cast<const uint4*>(
          wp + ((long long)tap * co_pad + n0 + co) * ci_pad + c0 + q * 8);
      *reinterpret_cast<uint4*>(sw + row * kKS + q * 8) = v;
    }
    // the zero-haloed band, two channels to a 32-bit store
    for (int i = threadIdx.x; i < (kKC / 2) * band_px; i += kThreads) {
      const int pr = i / band_px, px = i - pr * band_px;
      const int br = px / BW, bc = px - br * BW;
      const int ih = row0 - 1 + br, iw = col0 - 1 + bc;
      const int ci = 2 * pr;
      __nv_bfloat162 v;
      v.x = zero;
      v.y = zero;
      if (ih >= 0 && ih < H && iw >= 0 && iw < W && ci < kc) {
        const __nv_bfloat16* src = xn + (c0 + ci) * hw + (long long)ih * W + iw;
        v.x = src[0];
        if (ci + 1 < kc) v.y = src[hw];
      }
      *reinterpret_cast<__nv_bfloat162*>(sx + px * kKS + ci) = v;
    }
    __syncthreads();
    const int ksteps = (kc + 15) / 16;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * BW + tap % 3;
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t a_addr[MT], b_addr[NT / 2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          a_addr[mt] = sx_lane + 2 * ((a_px[mt] + shift) * kKS + ks * 16);
#pragma unroll
        for (int j = 0; j < NT / 2; ++j)
          b_addr[j] = sw_lane + 2 * ((tap * BN + j * 16) * kKS + ks * 16);
        mma_tile::warp_k16<MT, NT, false>(acc, a_addr, b_addr);
      }
    }
  }

  // round to bf16 into [BN][kOS] (the weight buffer, 720 B per channel,
  // holds it), then store channel rows of contiguous pixels
  __syncthreads();
  __nv_bfloat16* so = sw;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int m = wm * (kBM / WM) + mt * 16 + g;
      const int co = wn * (BN / WN) + nt * 8 + 2 * q;
      so[co * kOS + m] = __float2bfloat16_rn(acc[mt][nt][0]);
      so[(co + 1) * kOS + m] = __float2bfloat16_rn(acc[mt][nt][1]);
      so[co * kOS + m + 8] = __float2bfloat16_rn(acc[mt][nt][2]);
      so[(co + 1) * kOS + m + 8] = __float2bfloat16_rn(acc[mt][nt][3]);
    }
  __syncthreads();
  for (int i = threadIdx.x; i < BN * kBM; i += kThreads) {
    const int col = i / kBM, m = i - col * kBM;
    const int co = n0 + col;
    if (m >= npx || co >= Co) continue;
    const int r = m / TW;
    const int oh = row0 + r, ow = col0 + (m - r * TW);
    if (oh >= H || ow >= W) continue;
    y[((long long)n * Co + co) * hw + (long long)oh * W + ow] =
        so[col * kOS + m];
  }
}

template <int BN, int WM, int WN>
int launch(const __nv_bfloat16* x, const __nv_bfloat16* wp, __nv_bfloat16* y,
           int N, int Ci, int Co, int H, int W, int TR, int TW, int smem,
           cudaStream_t st) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_per_frame = ((H + TR - 1) / TR) * tiles_w;
  const int n_tiles_n = (Co + BN - 1) / BN;
  const long long blocks = (long long)N * tiles_per_frame * n_tiles_n;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem != (9 * BN + (TR + 2) * (TW + 2)) * kKS * 2)
    return cudaErrorInvalidValue;
  auto kernel = conv3x3_fwd_kernel<BN, WM, WN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, smem, st>>>(
      x, wp, y, Ci, Co, H, W, TR, TW, tiles_w, tiles_per_frame, n_tiles_n,
      n_tiles_n * BN, (Ci + kKC - 1) / kKC * kKC);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// x (N, Ci, H, W), w (Co, Ci, 3, 3), y (N, Co, H, W): bf16, contiguous.
// wp: scratch of 9 * roundup(Co, BN) * roundup(Ci, 32) bf16, 16-byte aligned.
// TR x TW <= 128 is the CTA's pixel tile, BN in {32, 64, 128} its output
// channels, smem its dynamic shared memory in bytes.
int conv3x3_fwd(const void* x, const void* w, void* wp, void* y, int N,
                int Ci, int Co, int H, int W, int TR, int TW, int BN,
                int smem, void* stream) {
  if (N < 1 || Ci < 1 || Co < 1 || H < 1 || W < 1 || TR < 1 || TW < 1 ||
      TR * TW > kBM || !aligned16(wp))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int co_pad = (Co + BN - 1) / BN * BN;
  const int ci_pad = (Ci + kKC - 1) / kKC * kKC;
  const long long total = 9LL * co_pad * ci_pad;
  const int pack_blocks = (int)((total + kThreads - 1) / kThreads);
  conv3x3_pack_kernel<<<pack_blocks, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(wp),
      Ci, Co, co_pad, ci_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const __nv_bfloat16* xt = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wpt = static_cast<const __nv_bfloat16*>(wp);
  __nv_bfloat16* yt = static_cast<__nv_bfloat16*>(y);
  switch (BN) {
    case 32:
      return launch<32, 4, 2>(xt, wpt, yt, N, Ci, Co, H, W, TR, TW, smem, st);
    case 64:
      return launch<64, 4, 2>(xt, wpt, yt, N, Ci, Co, H, W, TR, TW, smem, st);
    case 128:
      return launch<128, 2, 4>(xt, wpt, yt, N, Ci, Co, H, W, TR, TW, smem,
                               st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"

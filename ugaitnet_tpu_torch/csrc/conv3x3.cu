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
//
// Two kernels of one implicit GEMM (M = output pixels, N = output
// channels, K = 9 taps x Ci), chosen by shape in ops/cuda/conv3x3.py:plan:
//
//   conv3x3_fwd_kernel, the Hopper variant, for W in {16, 32, 64} (a
//   whole frame row is one TMA box row of 32, 64 or 128 bytes) and
//   weights that fit beside the ring (both flagship shapes, their TP
//   halves Ci 64 and Ci 16, the tiny config's).  One persistent CTA an SM
//   keeps the weights of BN output channels resident and walks tiles of
//   TR whole rows of a frame (TR x W = 64 MT pixels: 8 x 16, 4 x 32, 4 x
//   64 with BN 32, 2 x 64 with BN 64).  384 threads in three warpgroups:
//     - the producer (warpgroup 2): one thread loads the CTA's weights
//       once (9 x nch TMA boxes of [BN][CC], swizzled, on one mbarrier),
//       then keeps the ring of raw band stages full: a stage is one
//       cp.async.bulk.tensor.4d box (W, TR + 2, CC, 1) of the NCHW stream
//       at (0, row0 - 1, c0, n), the tile's rows with their halo rows and
//       CC input channels, channel-major; halo rows above and below the
//       frame and channels past Ci arrive as zeros (the box's out-of-bounds
//       fill), so the ragged edges cost nothing.  Each consumer has its
//       own half of the ring (a full and an empty mbarrier a stage), which
//       the producer fills in turn, stage by stage.
//     - two consumers (warpgroups 0 and 1), which take the CTA's tiles in
//       turn, each with its own band buffer.  Per stage a consumer first
//       transposes the raw stage into its pixel-major band ([(TR + 2) x
//       (W + 2) pixels][CC + 8 channels], zero columns left and right: the
//       frame's border) with ldmatrix.trans + stmatrix, 16 pixels x 16
//       channels at a time, and releases the raw stage; then runs 9 taps x
//       CC / 16 k16 steps of wgmma.mma_async m64nBNk16 over its MT m64
//       tiles with A from registers: each warp loads its 16 pixels' A
//       fragment by ldmatrix at the band address shifted by the tap ((di
//       (W + 2) + dj) pixels), so a tap is only an address shift and no
//       im2col buffer exists; B is the tap's resident weights through a
//       shared-memory descriptor.  A sits in NB register buffers (3 at MT
//       = 2, 2 at MT = 4): the next step's ldmatrix runs while NB - 1
//       steps' products are in flight (wait_group NB - 1).
//     - the epilogue: the consumer rounds its sums to bf16 into its band
//       buffer as the NCHW box (W, TR, BN) (stmatrix.trans: a register
//       pair of one pixel and two channels lands as two channel rows) and
//       one thread stores it with one cp.async.bulk.tensor.4d, which clips
//       the rows past H and the channels past Co.  The producer has the
//       next tiles' bands in flight meanwhile.
//   Where Co > BN (a_conv6: Co 128, BN 64) the Co tiles are split across
//   neighbouring CTAs: CTA b keeps the weights of Co tile b % n_co and
//   walks tiles b / n_co + k (grid / n_co), so the CTAs of one tile run
//   together and read its band from L2 once HBM has delivered it (a_conv6:
//   2 x 1.25 x 210 MB of L2 reads, against the 1.9 GB of weight re-reads
//   of the first kernel).
//
//   Shared memory (bytes; 1,024 of alignment slack, 232,448 at most):
//     weights  9 x nch x BN x CC x 2       a_conv6 147,456  a_conv2 18,432
//     ring     stages x (TR+2) x CC x W x 2    4 x 10,240     4 x 24,576
//     2 bands  max((TR+2)(W+2)(CC+8) 2, TR BN W 2), 1 KB-aligned
//                                           2 x 16,384     2 x 31,744
//     total with 9 mbarriers                222,280        181,320
//   a_conv6: BN 64 (two Co tiles), TR 8, CC 32 (4 stages a tile, 2 k16
//   steps each), MT 2.  a_conv2: BN 32, TR 4, CC 32 (1 stage a tile), MT 4
//   (halo rows 6 / 4 = 1.5x the band's bytes, read from L2).
//
//   The trouble spots, and what each choice cost:
//     - a tap is a one-pixel shift of the band, which a wgmma descriptor
//       cannot express on a swizzled layout: A comes from registers by
//       ldmatrix (the register-A form of wgmma), per-lane addresses; the
//       price is one ldmatrix.x4 per warp and m64 tile per k16 step.
//     - the NCHW stream lands channel-major: a transpose in shared memory
//       by the consumer warps per stage (ldmatrix.trans 16-byte rows of 8
//       pixels, stmatrix 16-byte rows of 8 channels), one read and one
//       write of each band byte against the taps' 9 ldmatrix reads of it;
//       three column-shifted copies of the band would have cost 3x the
//       ring and 3x the L2 reads, and 4-byte transposing stores (the
//       general variant) 4x the store instructions.  Pixel rows of CC + 8
//       channels (48 or 80 bytes, an odd number of 16-byte units) keep the
//       taps' ldmatrix free of bank conflicts; the transposing ldmatrix
//       reads 8 channel rows (swizzled rows of W x 2 bytes) with 2-way
//       conflicts, the epilogue's stmatrix.trans 4- to 8-way.
//     - TMA's limits: box rows of 32, 64 or 128 bytes and 16-byte strides,
//       so W in {16, 32, 64}; every other shape (the ragged (3, 7, 5, 5),
//       (4, 12, 9, 20), (1, 33, 17, 130)) takes the general variant, and
//       so does an x that does not start on a 16-byte boundary (a view at
//       an odd offset), which the general variant reads element by
//       element.  The boxes keep the tensors' natural dimension order (W,
//       H, C, N).
//     - the tensor maps are encoded per call through the driver entry
//       point (hopper.cuh); an encode that fails returns its error.
//     - registers: __launch_bounds__(384, 1) gives every thread 168, and
//       ptxas holds the consumer to them: MT x BN / 2 accumulators + NB x
//       MT x 4 A registers must fit, so MT 4 only with BN 32 (MT 4 with BN
//       64 spilled 336 bytes), and 2 A buffers there (3 spilled 60).
//     - the weights are packed per call (conv3x3_pack_kernel, [tap][co]
//       [ci], zero past Co and Ci) inside the timed call, as the serving
//       path pays it.
//
//   conv3x3_general_kernel, every other shape: the first port's kernel
//   (mma.sync m16n8k16 via mma_tile.cuh, synchronous staging).  One CTA
//   of 256 threads computes 128 output pixels (TR rows x TW columns of one
//   frame) for BN (32, 64 or 128) output channels; per stage of 32 input
//   channels it stages the zero-haloed band pixel-major (two channels to a
//   32-bit store) and that stage's weights, and runs 9 taps x 2 k16 steps,
//   a tap again a shift of the band's pixel address for ldmatrix.  Rows of
//   40 bf16 (80 bytes) keep ldmatrix free of bank conflicts; the sums are
//   rounded into shared memory and written channel by channel.
//
// Launch geometry (variant, TR, TW, BN, CC, stages, grid, shared memory)
// is chosen in Python (ops/cuda/conv3x3.py:plan) and checked here.  The
// launcher returns cudaGetLastError() (0 on success) or a tensor-map error
// (hopper.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
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

// The general variant.  WM x WN warps; each warp an (kBM / WM) x (BN /
// WN) tile of (pixels, output channels).  At least 2 CTAs an SM: at most 128 registers a thread
// (ptxas: 125, 107 and 78 for BN = 128, 64, 32, no spills; left to itself
// it gave BN = 32 64 registers and a spill)
template <int BN, int WM, int WN>
__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_general_kernel(const __nv_bfloat16* __restrict__ x,
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
        mma_tile::warp_k16<MT, NT>(acc, a_addr, b_addr);
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
int launch_general(const __nv_bfloat16* x, const __nv_bfloat16* wp,
                   __nv_bfloat16* y, int N, int Ci, int Co, int H, int W,
                   int TR, int TW, int smem, cudaStream_t st) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_per_frame = ((H + TR - 1) / TR) * tiles_w;
  const int n_tiles_n = (Co + BN - 1) / BN;
  const long long blocks = (long long)N * tiles_per_frame * n_tiles_n;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem != (9 * BN + (TR + 2) * (TW + 2)) * kKS * 2)
    return cudaErrorInvalidValue;
  auto kernel = conv3x3_general_kernel<BN, WM, WN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, smem, st>>>(
      x, wp, y, Ci, Co, H, W, TR, TW, tiles_w, tiles_per_frame, n_tiles_n,
      n_tiles_n * BN, (Ci + kKC - 1) / kKC * kKC);
  return cudaGetLastError();
}


// ---- the Hopper variant ----------------------------------------------------
namespace hv {

constexpr int kThreads = 384;      // 2 consumer warpgroups + 1 producer
constexpr int kSmemMax = 232448;

// The launch geometry and the shared-memory layout (byte offsets from the
// 1 KB-aligned base), filled by layout().
struct Geo {
  int W, TR, nch, n_co, tiles, tiles_h, stages;
  int raw_off, raw_stride, raw_tx;  // the ring: one stage's box bytes
  int buf_off, buf_stride;          // the consumers' band buffers
  int bar_off, w_tx;                // mbarriers; resident weight bytes
  int pm_w, ps;                     // band pixels a row; bytes a pixel
  int xmask;                        // swizzle mask of W x 2-byte rows
};

inline int align1k(int v) { return (v + 1023) & ~1023; }

// Fills g's layout for BN output channels and CC = 16 KS input channels a
// stage; returns the dynamic shared memory in bytes.
inline int layout(Geo& g, int BN, int CC) {
  const int pm = (g.TR + 2) * (g.W + 2) * (CC + 8) * 2;
  const int out = g.TR * BN * g.W * 2;
  g.w_tx = 9 * g.nch * BN * CC * 2;
  g.raw_tx = (g.TR + 2) * CC * g.W * 2;
  g.raw_off = align1k(g.w_tx);
  g.raw_stride = align1k(g.raw_tx);
  g.buf_off = g.raw_off + g.stages * g.raw_stride;
  g.buf_stride = align1k(pm > out ? pm : out);
  g.bar_off = g.buf_off + 2 * g.buf_stride;
  g.pm_w = g.W + 2;
  g.ps = (CC + 8) * 2;
  g.xmask = g.W == 16 ? 1 : g.W == 32 ? 3 : 7;
  return 1024 + g.bar_off + 8 * (2 * g.stages + 1);
}

}  // namespace hv

// BN output channels, MT m64 tiles of pixels a consumer tile, KS k16 steps
// a stage (CC = 16 KS input channels).
template <int BN, int MT, int KS>
__global__ void __launch_bounds__(hv::kThreads, 1)
    conv3x3_fwd_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tw,
                       const __grid_constant__ CUtensorMap ty,
                       const hv::Geo g) {
  using namespace hopper;
  constexpr int CC = 16 * KS;
  constexpr int ND = BN / 2;   // accumulator registers of an m64 x BN tile
  // A register buffers: 3 where the registers allow (MT = 2), else 2
  constexpr int NB = MT >= 4 ? 2 : 3;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.bar_off);
  uint64_t* empty = full + g.stages;
  uint64_t* wbar = empty + g.stages;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int co_tile = blockIdx.x % g.n_co;
  const int walk0 = blockIdx.x / g.n_co, walk = gridDim.x / g.n_co;
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);   // the 4 warps of the consuming warpgroup
    }
    mbar_init(wbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    if (tid == 0) {
      mbar_expect_tx(wbar, g.w_tx);
      for (int tap = 0; tap < 9; ++tap)
        for (int ch = 0; ch < g.nch; ++ch)
          tma_load_3d(smem + (tap * g.nch + ch) * (BN * CC * 2), &tw, wbar,
                      ch * CC, co_tile * BN, tap);
      // consumer c's tiles are k = c, c + 2, ... of the CTA's walk, and its
      // stages the ring's half c: fill the two halves in turn, stage by
      // stage, so that neither consumer waits on the other's tile
      const int sc = g.stages / 2;
      int gsc[2] = {0, 0};
      for (int t0 = walk0; t0 < g.tiles; t0 += 2 * walk)
        for (int ch = 0; ch < g.nch; ++ch)
          for (int c = 0; c < 2; ++c) {
            const int t = t0 + c * walk;
            if (t >= g.tiles) break;
            const int n = t / g.tiles_h, row0 = (t - n * g.tiles_h) * g.TR;
            const int gs = gsc[c]++, s = c * sc + gs % sc;
            mbar_wait(&empty[s], ((gs / sc) & 1) ^ 1);
            mbar_expect_tx(&full[s], g.raw_tx);
            tma_load_4d(smem + g.raw_off + s * g.raw_stride, &tx, &full[s],
                        0, row0 - 1, ch * CC, n);
          }
    }
  } else {
    // ---- consumers: warpgroup wg takes the CTA's tiles k = wg, wg + 2 ..
    const int warp = tid >> 5, lane = tid & 31;
    const int W = g.W, TR = g.TR;
    unsigned char* buf = smem + g.buf_off + wg * g.buf_stride;
    const uint32_t buf_u = smem_u32(buf);
    const uint32_t w_u = smem_u32(smem);
    // this lane's A row in each m64 tile: its pixel at tap (0, 0)
    uint32_t a_base[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int p = mt * 64 + warp * 16 + (lane & 15);
      const int i = p / W, j = p - (p / W) * W;
      a_base[mt] = buf_u + (i * g.pm_w + j) * g.ps + (lane >> 4) * 16;
    }
    const int m4 = lane >> 3, k8 = lane & 7;   // ldmatrix / stmatrix roles
    mbar_wait(wbar, 0);
    float acc[MT][ND];
    const int sc = g.stages / 2;
    int gs = 0;   // this consumer's stages so far, in its half of the ring
    for (int t = walk0 + wg * walk; t < g.tiles; t += 2 * walk) {
      const int n = t / g.tiles_h, row0 = (t - n * g.tiles_h) * TR;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < ND; ++i) acc[mt][i] = 0.f;
        fence_acc(acc[mt]);
      }
      for (int ch = 0; ch < g.nch; ++ch, ++gs) {
        const int s = wg * sc + gs % sc;
        mbar_wait(&full[s], (gs / sc) & 1);
        // the previous tile's store has read the buffer, and every warp
        // is past its reads of the band
        if (ch == 0 && tid == 0) tma_store_wait_read();
        wg_sync(1 + wg);
        if (ch == 0)   // the zero columns left and right of the band
          for (int i = tid; i < (TR + 2) * 2 * (CC / 8); i += 128) {
            const int c16 = i % (CC / 8), side = (i / (CC / 8)) & 1;
            const int r = i / (2 * (CC / 8));
            *reinterpret_cast<uint4*>(
                buf + (r * g.pm_w + side * (W + 1)) * g.ps + c16 * 16) =
                make_uint4(0, 0, 0, 0);
          }
        // transpose the raw stage ([ci][r][px], swizzled rows of W x 2
        // bytes) into the band ([r][1 + px][ci]), 16 x 16 at a time
        const uint32_t raw_u = smem_u32(smem + g.raw_off + s * g.raw_stride);
        const int pbs = W >> 4;
        for (int u = warp; u < (TR + 2) * pbs * KS; u += 4) {
          const int cb = u % KS, pb = (u / KS) % pbs, r = u / (KS * pbs);
          const int px = pb * 16 + (m4 >> 1) * 8, ci = cb * 16 + (m4 & 1) * 8;
          uint32_t v[4];
          ldsm_x4_t(v, raw_u + swz((((ci + k8) * (TR + 2) + r) * W + px) * 2,
                                   g.xmask));
          stsm_x4(buf_u + (r * g.pm_w + 1 + px + k8) * g.ps + ci * 2, v[0],
                  v[1], v[2], v[3]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
        wg_sync(1 + wg);   // the band is whole
        // 9 taps x KS k16 steps; A in NB register buffers, so that NB - 1
        // steps' products are in flight while the next step's A loads
        uint32_t a[NB][MT][4];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const uint32_t toff = ((tap / 3) * g.pm_w + tap % 3) * g.ps;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            const int b = (tap * KS + ks) % NB;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              ldsm_x4(a[b][mt], a_base[mt] + toff + ks * 32);
            wgmma_fence();
            const uint64_t db =
                desc(w_u + (tap * g.nch + ch) * (BN * CC * 2) + ks * 32,
                     16 * CC, KS == 1 ? 3 : 2);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) wgmma_rs(acc[mt], a[b][mt], db);
            wgmma_commit();
            wgmma_wait<NB - 1>();
            // the step NB - 1 back is complete: its buffer is free
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                asm volatile("" : "+r"(a[(b + 1) % NB][mt][e])::"memory");
          }
        }
        // the next stage starts on buffer 0: where 9 KS steps do not end
        // on buffer NB - 1, buffer 0 may still be read
        if ((9 * KS) % NB) wgmma_wait<0>();
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);

      // epilogue: bf16 into the buffer as the box (W, TR, BN) of y, rows
      // of W x 2 bytes swizzled, then one TMA store
      wg_sync(1 + wg);   // every warp is past its reads of the band
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nb = 0; nb < BN / 8; nb += 2) {
          const int co = (nb + (m4 >> 1)) * 8 + k8;
          const int p = mt * 64 + warp * 16 + (m4 & 1) * 8;
          const int i = p / W, j = p - (p / W) * W;
          stsm_x4_t(buf_u + swz(((co * TR + i) * W + j) * 2, g.xmask),
                    pack_bf16(acc[mt][nb * 4 + 0], acc[mt][nb * 4 + 1]),
                    pack_bf16(acc[mt][nb * 4 + 2], acc[mt][nb * 4 + 3]),
                    pack_bf16(acc[mt][nb * 4 + 4], acc[mt][nb * 4 + 5]),
                    pack_bf16(acc[mt][nb * 4 + 6], acc[mt][nb * 4 + 7]));
        }
      fence_proxy_async();
      wg_sync(1 + wg);
      if (tid == 0) {
        tma_store_4d(&ty, buf, 0, row0, co_tile * BN, n);
        tma_store_commit();
      }
    }
    if (tid == 0) tma_store_wait();
  }
}

template <int BN, int MT, int KS>
int launch_hopper(const void* x, const void* wp, void* y, int N, int Ci,
                  int Co, int H, int W, int TR, int stages, int grid,
                  int smem, cudaStream_t st) {
  using namespace hopper;
  constexpr int CC = 16 * KS;
  hv::Geo g;
  g.W = W;
  g.TR = TR;
  g.nch = (Ci + CC - 1) / CC;
  g.n_co = (Co + BN - 1) / BN;
  g.tiles_h = (H + TR - 1) / TR;
  const long long tiles = (long long)N * g.tiles_h;
  g.tiles = (int)tiles;
  g.stages = stages;
  if ((W != 16 && W != 32 && W != 64) || TR * W != 64 * MT ||
      tiles > 0x7fffffffLL || stages < 2 || stages % 2 ||
      hv::layout(g, BN, CC) != smem || smem > hv::kSmemMax || grid < 1 ||
      grid % g.n_co || grid > tiles * g.n_co)
    return cudaErrorInvalidValue;
  const uint64_t hw2 = (uint64_t)H * W * 2;
  CUtensorMap tx, tw, ty;
  {
    const uint64_t dims[4] = {(uint64_t)W, (uint64_t)H, (uint64_t)Ci,
                              (uint64_t)N};
    const uint64_t strides[3] = {(uint64_t)W * 2, hw2, hw2 * Ci};
    const uint32_t box[4] = {(uint32_t)W, (uint32_t)TR + 2, CC, 1};
    const int e = encode(&tx, x, 4, dims, strides, box, swizzle_for(W * 2));
    if (e) return e;
  }
  {
    const int ci_pad = g.nch * CC, co_pad = g.n_co * BN;
    const uint64_t dims[3] = {(uint64_t)ci_pad, (uint64_t)co_pad, 9};
    const uint64_t strides[2] = {(uint64_t)ci_pad * 2,
                                 (uint64_t)ci_pad * co_pad * 2};
    const uint32_t box[3] = {CC, BN, 1};
    const int e = encode(&tw, wp, 3, dims, strides, box, swizzle_for(CC * 2));
    if (e) return e;
  }
  {
    const uint64_t dims[4] = {(uint64_t)W, (uint64_t)H, (uint64_t)Co,
                              (uint64_t)N};
    const uint64_t strides[3] = {(uint64_t)W * 2, hw2, hw2 * Co};
    const uint32_t box[4] = {(uint32_t)W, (uint32_t)TR, BN, 1};
    const int e = encode(&ty, y, 4, dims, strides, box, swizzle_for(W * 2));
    if (e) return e;
  }
  auto kernel = conv3x3_fwd_kernel<BN, MT, KS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, hv::kThreads, smem, st>>>(tx, tw, ty, g);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// x (N, Ci, H, W), w (Co, Ci, 3, 3), y (N, Co, H, W): bf16, contiguous;
// x and y 16-byte aligned for the Hopper variant (its TMA boxes).  wp:
// scratch for the packed weights, 9 x co_pad x ci_pad bf16 (co_pad = Co
// rounded up to BN, ci_pad = Ci rounded up to CC), 16-byte aligned.
//   variant 0, general: TR x TW <= 128 the CTA's pixel tile, BN in {32, 64,
//     128}, CC = 32; stages and grid unused.
//   variant 1, Hopper: TW = W in {16, 32, 64}, TR x W in {64, 128, 256},
//     BN in {32, 64}, CC in {16, 32}, `stages` ring stages, `grid`
//     persistent CTAs (a multiple of Co / BN rounded up).
// smem: the dynamic shared memory in bytes, as plan() computes it.
int conv3x3_fwd(const void* x, const void* w, void* wp, void* y, int N,
                int Ci, int Co, int H, int W, int variant, int TR, int TW,
                int BN, int CC, int stages, int grid, int smem,
                void* stream) {
  if (N < 1 || Ci < 1 || Co < 1 || H < 1 || W < 1 || TR < 1 || TW < 1 ||
      !aligned16(wp))
    return cudaErrorInvalidValue;
  if (variant == 0 && (TR * TW > kBM || CC != kKC))
    return cudaErrorInvalidValue;
  if (variant == 1 && (TW != W || (CC != 16 && CC != 32) || !aligned16(x) ||
                       !aligned16(y)))
    return cudaErrorInvalidValue;
  if (variant != 0 && variant != 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int co_pad = (Co + BN - 1) / BN * BN;
  const int ci_pad = (Ci + CC - 1) / CC * CC;
  const long long total = 9LL * co_pad * ci_pad;
  const int pack_blocks = (int)((total + kThreads - 1) / kThreads);
  conv3x3_pack_kernel<<<pack_blocks, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(wp),
      Ci, Co, co_pad, ci_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (variant == 1) {
    const int mt = TR * W / 64;
#define CONV_HOPPER(BN_, MT_, KS_)                                          \
  if (BN == BN_ && mt == MT_ && CC == 16 * KS_)                             \
    return launch_hopper<BN_, MT_, KS_>(x, wp, y, N, Ci, Co, H, W, TR,      \
                                        stages, grid, smem, st);
    CONV_HOPPER(32, 2, 1)
    CONV_HOPPER(32, 2, 2)
    CONV_HOPPER(32, 4, 1)
    CONV_HOPPER(32, 4, 2)
    CONV_HOPPER(64, 2, 1)
    CONV_HOPPER(64, 2, 2)
#undef CONV_HOPPER
    return cudaErrorInvalidValue;
  }
  const __nv_bfloat16* xt = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wpt = static_cast<const __nv_bfloat16*>(wp);
  __nv_bfloat16* yt = static_cast<__nv_bfloat16*>(y);
  switch (BN) {
    case 32:
      return launch_general<32, 4, 2>(xt, wpt, yt, N, Ci, Co, H, W, TR, TW,
                                      smem, st);
    case 64:
      return launch_general<64, 4, 2>(xt, wpt, yt, N, Ci, Co, H, W, TR, TW,
                                      smem, st);
    case 128:
      return launch_general<128, 2, 4>(xt, wpt, yt, N, Ci, Co, H, W, TR, TW,
                                       smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"

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
//   accumulation, one rounding to nearest even.
//
//   Bound.  At the prototype's M = 262,144 and K = 1,152 on an H100 (SXM,
//   700 W): reading x (604 MB) takes 0.180 ms at 3.35 TB/s (0.200 ms with
//   w and y), against 77.3 GFLOP, 0.078 ms at 989 dense bf16 TFLOP/s:
//   bytes bound it, at every K of the prototype (576, 1,152, 2,304).
//
//   Design.  mm_pack_kernel first lays w out K-major, wt (128, Kw), so
//   that both operands of wgmma are K-major tiles a TMA box fills with the
//   128-byte swizzle (295 KB at Kw = 1,152, inside the timed call).  Then
//   one persistent CTA an SM (grid = min(SMs, tiles)) walks 256-row tiles
//   t = blockIdx.x, + gridDim.x, ...; 384 threads in three warpgroups
//   (__launch_bounds__(384, 1): 168 registers a thread):
//     - warpgroup 2, the producer: one thread keeps a ring of kStages = 3
//       stages full, each x [256][64] (32 KB) and wt [128][64] (16 KB) by
//       two cp.async.bulk.tensor.2d loads on the stage's `full` mbarrier,
//       after waiting on its `empty` one;
//     - warpgroups 0 and 1, the consumers: each owns 128 rows of the tile,
//       two float32 accumulators of m64 x n128 (128 registers a thread),
//       and runs wgmma.mma_async m64n128k16 with both operands from shared
//       memory (4 k16 steps a stage, the descriptor's start advanced 32
//       bytes a step), one commit group a stage; it waits for the group
//       before last and then releases that group's stage (one arrival a
//       warp, 8 a stage), so the next stage's products are issued before
//       the previous ones finish;
//     - the epilogue: each consumer rounds its 128 x 128 sums to bf16 into
//       its own 32 KB staging buffer (stmatrix, 128-byte swizzle) and one
//       thread stores it with two cp.async.bulk.tensor.2d stores, which
//       clip the rows past M; the next tile's loads are already in flight
//       (the producer runs ahead by the ring), and its stores wait only
//       until the previous ones have read the buffer.
//   Shared memory: 3 x 48 KB ring + 2 x 32 KB staging + 6 mbarriers,
//   214,064 bytes with the 1 KB alignment slack (of 232,448).  Rows past M
//   read as zero (the box's out-of-bounds fill) and are never stored, so
//   any M >= 1 takes the same path.  The wt tile is read from L2 once per
//   256 rows of x, half of x's bytes: the 256-row tile halves that against
//   128.  A 2-CTA cluster multicasting the wt halves (the other half of
//   the L2 reads) was built and timed on an H100 SXM at 700 W: slower at
//   every K, so it is not used.
//
//   scale2 replaces _copy_kernel (benchmarks/proto_mm.py:72, pallas_call
//   :85), the HBM copy probe: y = x * 2 over n contiguous bf16 values (the
//   prototype's (T*32*32*32, B) batch-minor view of a (128, 25, 32, 32,
//   32) tensor, n = 104,857,600), rounded as torch rounds x * 2 (exactly:
//   doubling a bf16 is exact, or inf), so the result is bitwise x * 2.
//
//   Bound.  One read and one write of each value: 2 x 209.7 MB at the
//   prototype's n, 0.1252 ms at 3.35 TB/s (H100 SXM, 700 W); 1 operation
//   a value is nothing beside it.  So the kernel has to keep enough bytes
//   in flight, in both directions, to hold HBM busy.
//
//   Design: scale2_plan (ops/cuda/probes.py) chooses the variant.
//     - scale2_kernel<true> (the vec variant: x and y at the same offset
//       from a 16-byte boundary, with a whole chunk after it): one 16-byte
//       chunk a thread, 256 a CTA, one pass (no grid-stride loop, no
//       persistent CTAs), each thread one ld.global.nc.L1::no_allocate
//       load and one st.global.cs store.  The resident CTAs of all SMs so
//       stream one window of the tensor, the access torch's own
//       elementwise kernel makes.  The < 8 values before the first 16-byte
//       boundary and after the last whole chunk go singly in CTA 0.  The
//       earlier kernel, persistent CTAs (at most 8 an SM) in a grid-stride
//       loop, was 7-10 % slower than torch's x * 2 on an H100; this one
//       ties with it (PERF.md).
//     - scale2_kernel<false> (the scalar variant: x and y at different
//       offsets, which no 16-byte access serves both, or no whole chunk):
//       one value a thread.
//   A ring of cp.async.bulk loads and stores through shared memory (one
//   producer thread, mbarriers, the stage released after wait_group.read)
//   was built and timed on an H100 SXM at 700 W: over persistent CTAs it
//   was 1.09x x * 2, and at one stage a CTA it tied with the vec variant,
//   which needs no shared memory and no barrier; so it is not used.

// Each launcher returns cudaGetLastError() (0 on success), or an error of
// the tensor-map encoder (hopper.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kCopyThreads = 256;   // scale2: chunks (or values) a CTA

namespace mm {
constexpr int kThreads = 384;   // 2 consumer warpgroups + 1 producer
constexpr int kBM = 256;        // rows a tile
constexpr int kBK = 64;         // K a stage (one 128-byte swizzle row)
constexpr int kN = 128;         // output columns (the prototype's width)
constexpr int kStages = 3;
constexpr int kXBytes = kBM * kBK * 2;          // 32,768
constexpr int kWBytes = kN * kBK * 2;           // 16,384
constexpr int kStageBytes = kXBytes + kWBytes;  // 49,152
constexpr int kOutBytes = 128 * kN * 2;         // a consumer's staging
constexpr int kOutOff = kStages * kStageBytes;
constexpr int kBarOff = kOutOff + 2 * kOutBytes;
constexpr int kSmem = 1024 + kBarOff + 2 * kStages * 8;   // 214,064 + slack
}  // namespace mm

__global__ void mm_pack_kernel(const __nv_bfloat16* __restrict__ w,
                               __nv_bfloat16* __restrict__ wt, int kw) {
  const long long total = (long long)kw * mm::kN;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int k = (int)(i % kw), n = (int)(i / kw);
    wt[i] = w[(long long)k * mm::kN + n];
  }
}

__global__ void __launch_bounds__(mm::kThreads, 1)
    mm_fwd_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap ty, int tiles,
                  int nkb) {
  using namespace mm;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    if (tid == 0) {
      int g = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x)
        for (int kb = 0; kb < nkb; ++kb, ++g) {
          const int s = g % kStages;
          mbar_wait(&empty[s], ((g / kStages) & 1) ^ 1);
          unsigned char* st = smem + s * kStageBytes;
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load_2d(st, &tx, &full[s], kb * kBK, t * kBM);
          tma_load_2d(st + kXBytes, &tw, &full[s], kb * kBK, 0);
        }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 128 wg .. 128 wg + 127 ----
    const int warp = tid >> 5, lane = tid & 31;
    unsigned char* out = smem + kOutOff + wg * kOutBytes;
    const uint32_t out_u32 = smem_u32(out);
    float acc[2][64];
    int g = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[mt][i] = 0.f;
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      int prev = -1;
      for (int kb = 0; kb < nkb; ++kb, ++g) {
        const int s = g % kStages;
        mbar_wait(&full[s], (g / kStages) & 1);
        const uint32_t xa = smem_u32(smem + s * kStageBytes) +
                            wg * 128 * 128;   // 128-byte rows
        const uint32_t wa = smem_u32(smem + s * kStageBytes + kXBytes);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / 16; ++k) {
          const uint64_t db = desc(wa + 32 * k, 1024, 1);
          wgmma_ss(acc[0], desc(xa + 32 * k, 1024, 1), db);
          wgmma_ss(acc[1], desc(xa + 64 * 128 + 32 * k, 1024, 1), db);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (prev >= 0) {   // the previous stage's products are done
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = s;
      }
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);

      // epilogue: bf16 into the staging buffer ([2 column halves][128
      // rows][64 columns], 128-byte swizzle), then two TMA stores
      if (tid == 0) tma_store_wait_read();
      wg_sync(1 + wg);
      const int m = lane >> 3, k8 = lane & 7;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nb = 0; nb < 16; nb += 2) {
          const int row = mt * 64 + warp * 16 + (m & 1) * 8 + k8;
          const int col = (nb + (m >> 1)) * 8;
          const uint32_t o = (col >> 6) * (128 * 128) +
                             swz(row * 128 + (col & 63) * 2, 7);
          stsm_x4(out_u32 + o,
                  pack_bf16(acc[mt][nb * 4 + 0], acc[mt][nb * 4 + 1]),
                  pack_bf16(acc[mt][nb * 4 + 2], acc[mt][nb * 4 + 3]),
                  pack_bf16(acc[mt][nb * 4 + 4], acc[mt][nb * 4 + 5]),
                  pack_bf16(acc[mt][nb * 4 + 6], acc[mt][nb * 4 + 7]));
        }
      fence_proxy_async();
      wg_sync(1 + wg);
      if (tid == 0) {
        tma_store_2d(&ty, out, 0, t * kBM + wg * 128);
        tma_store_2d(&ty, out + 128 * 128, 64, t * kBM + wg * 128);
        tma_store_commit();
      }
    }
    if (tid == 0) tma_store_wait();
  }
}

__device__ __forceinline__ __nv_bfloat16 twice(__nv_bfloat16 v) {
  return __float2bfloat16_rn(__bfloat162float(v) * 2.f);
}

__device__ __forceinline__ void twice8(uint4& v) {
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int k = 0; k < 8; ++k) e[k] = twice(e[k]);
}

__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void st_stream(uint4* p, const uint4& v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// kVec: the values [head, head + 8 chunks) as 16-byte chunks (x + head and
// y + head on a 16-byte boundary), one a thread, the head and tail values
// in CTA 0; else one value a thread (head = chunks = 0).
template <bool kVec>
__global__ void __launch_bounds__(kCopyThreads)
    scale2_kernel(const __nv_bfloat16* __restrict__ x,
                  __nv_bfloat16* __restrict__ y, long long n, int head,
                  long long chunks) {
  const long long i = (long long)blockIdx.x * kCopyThreads + threadIdx.x;
  if (!kVec) {
    if (i < n) y[i] = twice(x[i]);
    return;
  }
  if (i < chunks) {
    uint4 v = ld_stream(reinterpret_cast<const uint4*>(x + head) + i);
    twice8(v);
    st_stream(reinterpret_cast<uint4*>(y + head) + i, v);
  }
  if (blockIdx.x == 0) {
    const long long t0 = head + 8 * chunks;
    const int t = threadIdx.x;
    if (t < head) y[t] = twice(x[t]);
    if (t >= 32 && t - 32 < n - t0) y[t0 + t - 32] = twice(x[t0 + t - 32]);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// x (M, ldx), w (K, 128), y (M, 128): bf16, contiguous, 16-byte aligned;
// K a positive multiple of 128, ldx >= K a multiple of 8; wt: scratch of
// K * 128 bf16, 16-byte aligned; grid: persistent CTAs, 1 .. ceil(M /
// 256).
int mm_fwd(const void* x, const void* w, void* wt, void* y, long long M,
           int K, int ldx, int grid, void* stream) {
  using mm::kBK;
  using mm::kBM;
  using mm::kN;
  using mm::kSmem;
  const long long tiles = (M + kBM - 1) / kBM;
  if (M < 1 || M > 0x7fffffffLL || K < 128 || K % 128 || ldx < K ||
      ldx % 8 || grid < 1 || grid > tiles || !aligned16(x) ||
      !aligned16(w) || !aligned16(wt) || !aligned16(y))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mm_pack_kernel<<<(K * kN + 255) / 256, 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(wt),
      K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap tx, tw, ty;
  {
    const uint64_t dims[2] = {(uint64_t)ldx, (uint64_t)M};
    const uint64_t strides[1] = {(uint64_t)ldx * 2};
    const uint32_t box[2] = {kBK, kBM};
    const int e = encode(&tx, x, 2, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
    if (e) return e;
  }
  {
    const uint64_t dims[2] = {(uint64_t)K, (uint64_t)kN};
    const uint64_t strides[1] = {(uint64_t)K * 2};
    const uint32_t box[2] = {kBK, kN};
    const int e = encode(&tw, wt, 2, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
    if (e) return e;
  }
  {
    const uint64_t dims[2] = {(uint64_t)kN, (uint64_t)M};
    const uint64_t strides[1] = {(uint64_t)kN * 2};
    const uint32_t box[2] = {64, 128};
    const int e = encode(&ty, y, 2, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
    if (e) return e;
  }
  err = cudaFuncSetAttribute(mm_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return err;
  mm_fwd_kernel<<<grid, mm::kThreads, kSmem, st>>>(tx, tw, ty, (int)tiles,
                                                   K / kBK);
  return cudaGetLastError();
}

// y = x * 2 over n contiguous bf16 values: vec with x + head and y + head
// on a 16-byte boundary, 0 <= head < 8, head + 8 chunks <= n < head + 8
// chunks + 8, else (scalar) head = chunks = 0; grid = ceil(chunks / 256)
// CTAs (vec), else ceil(n / 256)
int scale2(const void* x, void* y, long long n, int vec, int head,
           long long chunks, int grid, void* stream) {
  const __nv_bfloat16* xt = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* yt = static_cast<__nv_bfloat16*>(y);
  const long long tail = n - head - 8 * chunks;
  const long long want = ((vec ? chunks : n) + kCopyThreads - 1) /
                         kCopyThreads;
  const bool body = vec ? head >= 0 && head <= 7 && chunks >= 1 &&
                              tail >= 0 && tail <= 7 &&
                              aligned16(xt + head) && aligned16(yt + head)
                        : head == 0 && chunks == 0;
  if (n < 1 || !body || grid != want) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    scale2_kernel<true><<<grid, kCopyThreads, 0, st>>>(xt, yt, n, head,
                                                       chunks);
  else
    scale2_kernel<false><<<grid, kCopyThreads, 0, st>>>(xt, yt, n, 0, 0);
  return cudaGetLastError();
}

}  // extern "C"

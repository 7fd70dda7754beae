// Weight and bias gradient of a VALID strided 3D convolution, float32 FFMA on
// the CUDA cores, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this gradient to XLA.  It
// was added because cuDNN sends the weight gradient of the 3D CNN's first
// conv (models/branches.py:Conv3DBranch.conv0: Ci = 2 optical-flow or 1 gray
// channels, 3 x 5 x 5 taps, stride 1 x 2 x 2, input the NDHWC view of the
// clip) to its direct, grouped kernel wgrad2d_grouped_direct_kernel, which
// took ~140 ms of a ~254 ms train step on an H100.
//
// Semantics, for x (N, Ci, T, H, W) and gy (N, Co, To, Ho, Wo), both float32
// in any strides (nothing is copied), To = (T - kT) / st + 1 and so on:
//   dW[co,ci,a,b,c] = sum_{n,t,h,w} gy[n,co,t,h,w] x[n,ci,st t+a,sh h+b,sw w+c]
//   db[co]          = sum_{n,t,h,w} gy[n,co,t,h,w]
// as one GEMM: dW' (Co x P+1) = gy' (Co x Q) . cols (Q x P+1), Q = N To Ho Wo
// positions, P = Ci kT kH kW taps, cols the im2col of x with a last column
// of ones, whose product is db.  dW is written in (co, ci, a, b, c) order,
// the weight's OIDHW layout.
//
// What bounds it on an H100 (SXM, 700 W): operations.  At the 3D CNN's cell
// (N = 120, 25 x 60 x 60 in, 23 x 28 x 28 out, Co = 64) the two branches
// need 2 x 64 x 18,032 x 120 x (151 + 76) = 62.6 GFLOP, 0.93 ms at 67 TFLOP/s
// of FFMA, and read 1.24 GB (gy twice 554 MB, x 86 + 43 MB), 0.37 ms at
// 3.35 TB/s.  The output is tiny (64 x 151 + 64 x 76 floats) and the sum is
// 2.16 M terms deep, so the design splits the sum, not the output:
//
//   conv3d_wgrad_kernel
//       A persistent grid, as many CTAs as fit on the card at once, each
//       taking an equal run of chunks of KB = 32 consecutive positions (n, t,
//       h, w).  A CTA holds the whole 64-output x (P+1)-tap tile of its
//       output-channel block in registers: 8 x npg threads, each 8 outputs
//       (co = cg + 8 i) x 8 taps (p = pg + npg j), 64 accumulators.  For each
//       chunk it gathers the gy tile (64 x KB) and the im2col tile
//       ((P+1) x KB) into shared memory with cp.async copies, a warp's lane
//       one position: 4 bytes for x (masked positions zero-filled), 16
//       bytes for gy where the chunk's positions are contiguous in it (as in
//       the NCDHW gradient cuDNN hands the first conv), double-buffered so
//       that the next chunk's gathers fly while this chunk's FFMAs run.  Both tiles are stored
//       position-minor, so a thread reads 4 positions of a row with one
//       16-byte load: 16 loads per 256 FFMAs.  Rows are KB + 4 floats apart,
//       so a warp's 8 outputs rows (A) or 4 taps rows (B) fall in distinct
//       banks.  Each accumulator sums its chunks' positions in order.
//   conv3d_wgrad_reduce_kernel
//       One thread per (co, tap): the CTAs' partial sums from scratch memory
//       in CTA order.  No atomics: two runs give the same bits.
//
// Measured on an H100 at the cell: 1.78 + 1.05 ms (OF + gray), 33 % of the
// FFMA peak, against 129 + 57 ms for cuDNN's kernel.  For the OF conv the
// FFMA loop alone (no gathers) takes 1.28 ms and the gathers alone 0.53:
// the two add up rather than overlap, which is where the next gain lies.
//
// Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int KB = 32;        // positions a chunk
constexpr int RS = KB + 4;    // floats between rows of a tile
constexpr int CO_TILE = 64;   // output channels a CTA
constexpr int TT = 8;         // taps a thread (and outputs a thread)
constexpr int MAX_TAPS = 255; // P: ops/cuda/conv3d_wgrad.py:MAX_TAPS too
constexpr int MAX_THREADS = TT * ((MAX_TAPS + 1 + TT - 1) / TT);   // 256

struct Args {
  const float* x;
  const float* gy;
  float* part;                // [grid][Co][P + 1]
  long long sx[5];            // x strides: n, ci, t, h, w
  long long sg[5];            // gy strides: n, co, t, h, w
  int Co, To, Ho, Wo, kT, kH, kW, st, sh, sw;
  int Ci, P, npg;             // taps P = Ci kT kH kW; 8 npg >= P + 1 columns
  long long Q;                // positions N To Ho Wo
  int chunks;                 // ceil(Q / KB)
  int gy_pos_minor;           // gy's w stride is 1: lanes walk positions
  int gy_vec;                 // gy's offsets rise with the position, and its
                              // rows are 16-byte aligned
};

size_t smem_bytes(int npg) {
  const size_t pp = (size_t)TT * npg;
  return sizeof(float) * 2 * (CO_TILE + pp) * RS     // A and B tiles, twice
         + sizeof(long long) * 2 * 2 * KB              // position offsets
         + sizeof(long long) * pp;                     // tap offsets of x
}

// 4 bytes global -> shared, asynchronously; `bytes` 0 writes a zero
__device__ __forceinline__ void cp4(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// 16 bytes global -> shared, asynchronously, not kept in L1
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// at most 128 registers a thread: 3 CTAs of 152 threads (the optical-flow
// conv) on an SM
__global__ void __launch_bounds__(MAX_THREADS, 2)
conv3d_wgrad_kernel(const Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pp = TT * g.npg;
  float* As = reinterpret_cast<float*>(smem);           // [2][CO_TILE][RS]
  float* Bs = As + 2 * CO_TILE * RS;                     // [2][pp][RS]
  long long* posx = reinterpret_cast<long long*>(Bs + 2 * pp * RS);  // [2][KB]
  long long* posg = posx + 2 * KB;                       // [2][KB]
  long long* tapx = posg + 2 * KB;                       // [pp]

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid % 32, warp = tid / 32, nwarps = nthr / 32;
  const int cg = tid % TT, pg = tid / TT;
  const int co0 = blockIdx.y * CO_TILE;
  const int nco = min(CO_TILE, g.Co - co0);

  // constant parts of both buffers: the ones column (db), zero columns
  // past it, zero rows past the last output channel
  for (int e = tid; e < 2 * pp * RS; e += nthr) {
    const int p = (e / RS) % pp;
    if (p >= g.P) Bs[e] = p == g.P ? 1.0f : 0.0f;
  }
  for (int e = tid; e < 2 * CO_TILE * RS; e += nthr)
    if ((e / RS) % CO_TILE >= nco) As[e] = 0.0f;
  for (int p = tid; p < g.P; p += nthr) {
    int r = p;
    const int c = r % g.kW; r /= g.kW;
    const int b = r % g.kH; r /= g.kH;
    const int a = r % g.kT;
    const int ci = r / g.kT;
    tapx[p] = ci * g.sx[1] + a * g.sx[2] + b * g.sx[3] + c * g.sx[4];
  }

  const int c0 = static_cast<long long>(blockIdx.x) * g.chunks / gridDim.x;
  const int c1 = (blockIdx.x + 1LL) * g.chunks / gridDim.x;

  auto positions = [&](int buf, int chunk) {
    for (int k = tid; k < KB; k += nthr) {
      const long long q = static_cast<long long>(chunk) * KB + k;
      long long ox = 0, og = 0;     // past the end: in bounds, never read
      if (q < g.Q) {
        long long n, t, h, w;
        if (g.Q <= 0x7fffffffLL) {   // 32-bit division where it suffices
          unsigned r = static_cast<unsigned>(q);
          w = r % g.Wo; r /= g.Wo;
          h = r % g.Ho; r /= g.Ho;
          t = r % g.To;
          n = r / g.To;
        } else {
          long long r = q;
          w = r % g.Wo; r /= g.Wo;
          h = r % g.Ho; r /= g.Ho;
          t = r % g.To;
          n = r / g.To;
        }
        ox = n * g.sx[0] + t * g.st * g.sx[2] + h * g.sh * g.sx[3] +
             w * g.sw * g.sx[4];
        og = n * g.sg[0] + t * g.sg[2] + h * g.sg[3] + w * g.sg[4];
      }
      posx[buf * KB + k] = ox;
      posg[buf * KB + k] = og;
    }
  };

  // the chunk's tiles: a full warp's lane copies the lane's position of
  // every row the warp takes (its offsets and its mask loaded once); the
  // threads of a last, partial warp copy nothing.  Where gy's positions are
  // not its fastest axis, or the CTA has no full warp, every thread copies
  // elements in turn
  auto gather = [&](int buf, int chunk) {
    const long long q0 = static_cast<long long>(chunk) * KB;
    float* A = As + buf * CO_TILE * RS;
    float* B = Bs + buf * pp * RS;
    if (warp < nwarps) {
      const int ok = q0 + lane < g.Q ? 4 : 0;
      const float* xk = g.x + posx[buf * KB + lane];
      const float* gk = g.gy + posg[buf * KB + lane] + co0 * g.sg[1];
      const long long g0 = posg[buf * KB];
      if (g.gy_vec && q0 + KB <= g.Q &&
          posg[buf * KB + KB - 1] - g0 == KB - 1 && (g0 & 3) == 0) {
        // the chunk's positions are contiguous in gy: 16 bytes a lane,
        // 8 lanes a row, 4 rows a warp
        const float* g4 = g.gy + g0 + (lane % 8) * 4 + co0 * g.sg[1];
        for (int co = 4 * warp + lane / 8; co < nco; co += 4 * nwarps)
          cp16(A + co * RS + (lane % 8) * 4, g4 + co * g.sg[1]);
      } else if (g.gy_pos_minor) {
        for (int co = warp; co < nco; co += nwarps)
          cp4(A + co * RS + lane, gk + co * g.sg[1], ok);
      }
#pragma unroll 4
      for (int p = warp; p < g.P; p += nwarps)
        cp4(B + p * RS + lane, xk + tapx[p], ok);
    }
    if (nwarps == 0 || !g.gy_pos_minor)
      for (int e = tid; e < nco * KB; e += nthr) {
        const int co = e % nco, k = e / nco;
        cp4(A + co * RS + k, g.gy + posg[buf * KB + k] + (co0 + co) * g.sg[1],
            q0 + k < g.Q ? 4 : 0);
      }
    if (nwarps == 0)   // fewer than 32 threads: at most 23 taps
      for (int e = tid; e < g.P * KB; e += nthr) {
        const int k = e % KB, p = e / KB;
        cp4(B + p * RS + k, g.x + posx[buf * KB + k] + tapx[p],
            q0 + k < g.Q ? 4 : 0);
      }
    cp_commit();
  };

  float acc[TT][TT];
#pragma unroll
  for (int i = 0; i < TT; ++i)
#pragma unroll
    for (int j = 0; j < TT; ++j) acc[i][j] = 0.0f;

  if (c0 < c1) {
    positions(0, c0);
    __syncthreads();
    gather(0, c0);
  }
  for (int c = c0; c < c1; ++c) {
    const int buf = (c - c0) & 1;
    const bool next = c + 1 < c1;
    if (next) positions(buf ^ 1, c + 1);
    // the offsets are visible, and every thread is done with buf ^ 1
    __syncthreads();
    if (next) {
      gather(buf ^ 1, c + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();   // every thread's copies of this chunk have landed
    const float* A = As + buf * CO_TILE * RS + cg * RS;
    const float* B = Bs + buf * pp * RS + pg * RS;
#pragma unroll 1
    for (int k = 0; k < KB; k += 4) {
      float4 b[TT];
#pragma unroll
      for (int j = 0; j < TT; ++j)
        b[j] = *reinterpret_cast<const float4*>(B + j * g.npg * RS + k);
#pragma unroll
      for (int i = 0; i < TT; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(A + i * TT * RS + k);
#pragma unroll
        for (int j = 0; j < TT; ++j) {
          float s = acc[i][j];
          s = fmaf(a.x, b[j].x, s);
          s = fmaf(a.y, b[j].y, s);
          s = fmaf(a.z, b[j].z, s);
          s = fmaf(a.w, b[j].w, s);
          acc[i][j] = s;
        }
      }
    }
  }

  // this CTA's partial sums: [blockIdx.x][co][p], p <= P
  const int cols = g.P + 1;
  float* out = g.part + (size_t)blockIdx.x * g.Co * cols;
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    const int co = cg + TT * i;
    if (co >= nco) continue;
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      const int p = pg + g.npg * j;
      if (p < cols) out[(size_t)(co0 + co) * cols + p] = acc[i][j];
    }
  }
}

// dW (Co x P) and db (Co) from the partial sums of `grid` CTAs, in order
__global__ void conv3d_wgrad_reduce_kernel(const float* __restrict__ part,
                                           float* __restrict__ dw,
                                           float* __restrict__ db, int grid,
                                           int Co, int P) {
  const int cols = P + 1;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= Co * cols) return;
  float s = 0.0f;
  for (int b = 0; b < grid; ++b) s += part[(size_t)b * Co * cols + e];
  const int co = e / cols, p = e % cols;
  if (p < P) dw[co * P + p] = s;
  else db[co] = s;
}

// Whether gy's offset rises with the position q (w fastest, then h, t, n),
// across every wrap: each axis's stride passes the reach of those inside it.
// Then a chunk whose last offset lies KB - 1 past its first is contiguous.
bool rising(const long long* sg, int N, int To, int Ho, int Wo) {
  if (sg[4] != 1) return false;
  long long reach = Wo - 1;             // from w's first offset to its last
  const long long size[3] = {Ho, To, N}, stride[3] = {sg[3], sg[2], sg[0]};
  for (int i = 0; i < 3; ++i)
    if (size[i] > 1) {
      if (stride[i] <= reach) return false;
      reach += (size[i] - 1) * stride[i];
    }
  return true;
}

int set_smem(int npg, size_t* bytes) {
  *bytes = smem_bytes(npg);
  return cudaFuncSetAttribute(conv3d_wgrad_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

}  // namespace

extern "C" {

// The launch plan for N To Ho Wo positions, Co outputs and P taps on the
// current device: `grid` CTAs, as many of conv3d_wgrad_kernel as fit on the
// card at once (never more than the chunks of KB positions), and the floats
// of scratch (`part`) they need.  Returns a cudaError_t.
int conv3d_wgrad_plan(int N, int Co, int To, int Ho, int Wo, int P,
                      int* grid, long long* part_floats) {
  const long long chunks = ((long long)N * To * Ho * Wo + KB - 1) / KB;
  if (N < 1 || Co < 1 || To < 1 || Ho < 1 || Wo < 1 || P < 1 ||
      P > MAX_TAPS || chunks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int npg = (P + 1 + TT - 1) / TT;
  size_t bytes;
  int rc = set_smem(npg, &bytes);
  if (rc != cudaSuccess) return rc;
  int per_sm = 0, dev = 0, sms = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, conv3d_wgrad_kernel, TT * npg, bytes);
  if (rc != cudaSuccess) return rc;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  *grid = static_cast<int>(std::min<long long>(chunks, 1LL * sms * per_sm));
  *part_floats = (long long)*grid * Co * (P + 1);
  return cudaSuccess;
}

// dW (Co, Ci, kT, kH, kW) and db (Co), contiguous float32, from x and gy as
// described at the top; sx / sg their five strides in elements.  `part`
// holds grid x Co x (P + 1) floats, `grid` as conv3d_wgrad_plan gives it.
// Launches both kernels on `stream`; returns a cudaError_t.
int conv3d_wgrad(const void* x, const long long* sx, const void* gy,
                 const long long* sg, void* part, void* dw, void* db, int N,
                 int Ci, int Co, int To, int Ho, int Wo, int kT, int kH,
                 int kW, int st, int sh, int sw, int grid, void* stream) {
  Args g;
  g.x = static_cast<const float*>(x);
  g.gy = static_cast<const float*>(gy);
  g.part = static_cast<float*>(part);
  for (int i = 0; i < 5; ++i) {
    g.sx[i] = sx[i];
    g.sg[i] = sg[i];
  }
  g.Co = Co; g.To = To; g.Ho = Ho; g.Wo = Wo;
  g.kT = kT; g.kH = kH; g.kW = kW; g.st = st; g.sh = sh; g.sw = sw;
  g.Ci = Ci;
  g.P = Ci * kT * kH * kW;
  g.npg = (g.P + 1 + TT - 1) / TT;
  g.Q = (long long)N * To * Ho * Wo;
  const long long chunks = (g.Q + KB - 1) / KB;
  if (chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  g.chunks = static_cast<int>(chunks);
  g.gy_pos_minor = sg[4] == 1;
  g.gy_vec = g.gy_pos_minor && rising(sg, N, To, Ho, Wo) && sg[1] % 4 == 0 &&
             reinterpret_cast<uintptr_t>(gy) % 16 == 0;
  if (N < 1 || Co < 1 || To < 1 || Ho < 1 || Wo < 1 || g.P < 1 ||
      g.P > MAX_TAPS || grid < 1 || grid > g.chunks)
    return cudaErrorInvalidValue;
  size_t bytes;
  int rc = set_smem(g.npg, &bytes);
  if (rc != cudaSuccess) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 blocks(grid, (Co + CO_TILE - 1) / CO_TILE);
  conv3d_wgrad_kernel<<<blocks, TT * g.npg, bytes, s>>>(g);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  const int outs = Co * (g.P + 1);
  conv3d_wgrad_reduce_kernel<<<(outs + 255) / 256, 256, 0, s>>>(
      g.part, static_cast<float*>(dw), static_cast<float*>(db), grid, Co,
      g.P);
  return cudaGetLastError();
}

}  // extern "C"

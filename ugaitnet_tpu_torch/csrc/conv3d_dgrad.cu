// Input gradient of a VALID strided 3D convolution, float32 FFMA on the
// CUDA cores, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this gradient to XLA.  It
// was added because cuDNN sends the input gradient of the 3D CNN's strided
// 3 x 3 x 3 convs (models/branches.py:Conv3DBranch.conv1, Ci 64 -> Co 128,
// stride 1 x 2 x 2; conv2, 128 -> 256, stride 2 x 2 x 2) to its direct,
// non-GEMM engine convolveNd_dgrad_float_engine: 12.1 + 2.7 ms a branch on
// an H100, ~30 ms of a ~118 ms train step, about a quarter of the FFMA peak.
//
// Semantics, for gy (N, Co, To, Ho, Wo) and W (Co, Ci, kT, kH, kW), float32,
// gy and dx in any strides:
//   dx[n,ci,t,h,w] = sum gy[n,co,t',h',w'] W[co,ci,a,b,c]
// over every (co, a, b, c, t', h', w') with t = st t' + a, h = sh h' + b,
// w = sw w' + c.  Positions that no output reads (conv1's last row and
// column) get zero.
//
// What bounds it on an H100 (SXM, 700 W): operations.  At the 3D CNN's cell
// (N = 120) conv1 needs 2 x 120 x 3,549 x 128 x 1,728 = 188.4 GFLOP a
// branch, 2.81 ms at 67 TFLOP/s of FFMA, and moves ~0.77 GB, 0.23 ms at
// 3.35 TB/s; conv2 76.4 GFLOP, 1.14 ms.  Hopper has no tensor-core path that
// keeps float32, so the design is an FFMA implicit GEMM:
//
//   Stride phases.  dx splits by the phase (t mod st, h mod sh, w mod sw)
//       of its position.  Within a phase, dx position (u, v, z) (t = st u +
//       pt, ...) reads gy at (u - i, v - j, z - k) through tap (a, b, c) =
//       (pt + st i, ph + sh j, pw + sw k), and only those taps: a dense
//       stride-1 GEMM with no zero taps.  Rows are the phase's positions
//       (n, u, v, z), in that order, columns Ci, depth Co x the phase's
//       taps (conv1: 4 phases of 12, 6, 6, 3 taps; conv2: 8 phases).
//   Runs.  Along t and h a phase's positions split into runs that read
//       one interval of taps: the middle run reads them all, and each
//       position before it or after it (the border, where some taps fall
//       off the output) is a run of its own.  A CTA's rows come from one t
//       run and one h run, so it multiplies only by taps that some of its
//       rows read; along w it skips the taps no z of its tile reads.  At
//       conv1 that is 1.08x the exact work (1.27x for whole phases), at
//       conv2 1.12x (1.32x): the rest is w's border and the tiles' last
//       rows.  Rows whose run reads no tap get zero.
//   Tiles.  A CTA of 128 threads owns 128 rows x 64 input channels, 8 x 8
//       accumulators a thread (rows in two runs of 4, columns in two runs of
//       4, so that every shared read is one 16-byte load a lane, broadcast
//       across the warp).
//   The ring.  The depth runs in chunks of 16 output channels of one tap.
//       A 4-stage ring of cp.async copies keeps three chunks in flight while
//       the FFMAs of the fourth run (conv3d_wgrad.cu gathers and multiplies
//       in turn, and reaches a third of the peak): a lane
//       copies its row's 16 values (4 bytes each; gy's rows run along w', so
//       a warp's 32 rows are mostly consecutive floats) and the weights come
//       packed once a call by conv3d_dgrad_pack_kernel as [tap][co][ci]
//       (padded with zeros to 16 and 64), 16 bytes a copy.
//   Order and writes.  CTAs run by phase row (t and h phase), run pair,
//       then w phase and input-channel block, tiles fastest: neighbouring
//       CTAs read the same taps' weights and neighbouring rows of gy (on an
//       H100 this beat interleaving the phases, whose writes share L2
//       sectors, by 2 % at conv1 and 20 % at conv3).  The CTA stages its
//       128 x 64 tile through shared memory and writes it a channel at a
//       time, a lane a row: a warp's stores cover consecutive w of its
//       phase.
//   No atomics.  Each dx element is summed by one thread in a fixed order
//       (taps, then output channels) and written once: two runs give the
//       same bits.
//
// Measured on an H100 at the cell (N = 120, one branch): conv1 5.2 ms,
// conv2 2.25, conv3 0.66, conv4 0.20, against cuDNN's 12.0, 2.72, 0.84 and
// 0.54 (conv4's an implicit GEMM); conv5 (15 tiles of dx, 8 CTAs) 0.079
// against 0.045, so ops/cuda/conv3d_dgrad.py leaves it to cuDNN.  At conv1
// ~40 TFLOP/s, 60 % of the peak: the FFMA loop bounds it (without the
// copies it takes 5.05 ms).
//
// Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // rows (dx positions of a phase) a CTA
constexpr int BN = 64;         // input channels a CTA
constexpr int BK = 16;         // output channels a chunk, of one tap
constexpr int STAGES = 4;
constexpr int THREADS = 128;
constexpr int CS = BM + 4;     // floats between channels of the staged tile
constexpr int STAGE_FLOATS = BK * BM + BK * BN;
static_assert(BK * BN / 4 % THREADS == 0, "B copies: whole rounds");
static_assert(BM == THREADS, "a thread's row");
constexpr size_t SMEM_BYTES =
    sizeof(float) * (STAGE_FLOATS * STAGES > BN * CS ? STAGE_FLOATS * STAGES
                                                      : BN * CS);

struct Args {
  const float* gy;
  const float* wp;            // [kT kH kW][Co_pad][Ci_pad]
  float* dx;
  long long sg[5];            // gy strides: n, co, t, h, w
  long long sd[5];            // dx strides: n, ci, t, h, w
  int N, Ci, Co, T, H, W, To, Ho, Wo, kT, kH, kW, st, sh, sw;
  int Ci_pad, Co_pad;
};

// 4 bytes global -> shared, asynchronously; `bytes` 0 writes a zero
__device__ __forceinline__ void cp4(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

// 16 bytes global -> shared, asynchronously, not kept in L1
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

// positions p0 + s q < n, q >= 0
__host__ __device__ __forceinline__ int count(int n, int p0, int s) {
  return n > p0 ? (n - p0 + s - 1) / s : 0;
}

// A run of a phase's positions along one axis that every tap of one
// interval [lo, lo + n) reaches, and no other
struct Run {
  int start, len, lo, n;
};

// One axis of a phase (offset p, stride s, kernel k; X input and O output
// positions) cut into runs: position u reads taps q in
// [max(0, u - O + 1), min(nq - 1, u)], which is the whole [0, nq) in the
// middle run [nq - 1, O) and changes at every position before it and after
// it (single-position runs; those past every output read no tap)
struct Axis {
  int U, nq, O, a, mid_lo, mid_hi, mid, tail, runs;
  __host__ __device__ Axis(int X, int p, int s, int k, int O_) {
    U = count(X, p, s);
    nq = count(k, p, s);
    O = O_;
    a = imax(0, imin(nq - 1, U));
    mid_lo = imax(0, nq - 1);
    mid_hi = imin(O, U);
    mid = mid_hi > mid_lo;
    tail = mid ? mid_hi : a;
    runs = a + mid + imax(0, U - tail);
  }
  __host__ __device__ Run at(int r) const {
    Run g;
    if (r < a) {
      g.start = r; g.len = 1;
    } else if (mid && r == a) {
      g.start = mid_lo; g.len = mid_hi - mid_lo;
    } else {
      g.start = tail + r - a - mid; g.len = 1;
    }
    g.lo = imax(0, g.start - O + 1);
    g.n = imax(0, imin(nq - 1, g.start) - g.lo + 1);
    return g;
  }
};

// CTAs of one (t run, h run) of a phase row (pt, ph): the runs' rows for
// the phase column with the most positions, in tiles of BM, for each
// column pw and input-channel block
__host__ __device__ __forceinline__ long long group_ctas(
    const Run& rt, const Run& rh, int N, int Zmax, int sw, int CB) {
  const long long rows = static_cast<long long>(N) * rt.len * rh.len * Zmax;
  return (rows + BM - 1) / BM * sw * CB;
}

// at most 168 registers a thread: 3 CTAs an SM (at 4, 128 registers spill)
__global__ void __launch_bounds__(THREADS, 3)
conv3d_dgrad_kernel(const Args g) {
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int CB = g.Ci_pad / BN;
  const int Zmax = count(g.W, 0, g.sw);
  // this CTA's group: phase row (pt, ph) and the t and h runs, in order
  long long idx = blockIdx.x;
  int pt = 0, ph = 0;
  Run rt{}, rh{};
  bool found = false;
  for (int q = 0; q < g.st * g.sh && !found; ++q) {
    const Axis at(g.T, q / g.sh, g.st, g.kT, g.To);
    const Axis ah(g.H, q % g.sh, g.sh, g.kH, g.Ho);
    for (int a = 0; a < at.runs && !found; ++a) {
      const Run ra = at.at(a);
      for (int b = 0; b < ah.runs && !found; ++b) {
        const Run rb = ah.at(b);
        const long long ctas = group_ctas(ra, rb, g.N, Zmax, g.sw, CB);
        if (idx < ctas) {
          found = true;
          pt = q / g.sh; ph = q % g.sh; rt = ra; rh = rb;
        } else {
          idx -= ctas;
        }
      }
    }
  }
  // within the group: tiles fastest, then the input-channel block, then
  // the phase column
  const long long tiles = group_ctas(rt, rh, g.N, Zmax, 1, 1);
  const long long tile = idx % tiles;
  idx /= tiles;
  const int cb = static_cast<int>(idx % CB);
  const int pw = static_cast<int>(idx / CB);
  const int Z = count(g.W, pw, g.sw);
  const long long M = static_cast<long long>(g.N) * rt.len * rh.len * Z;
  const long long m0 = tile * BM;
  if (m0 >= M) return;        // past this column's rows: the whole CTA

  // this thread's row: the A copies and the dx writes
  const long long m = m0 + tid;
  const bool row_ok = m < M;
  int n = 0, u = 0, v = 0, z = 0;
  if (row_ok) {
    unsigned r = static_cast<unsigned>(m);   // M < 2^31 (conv3d_dgrad)
    z = r % Z; r /= Z;
    v = rh.start + r % rh.len; r /= rh.len;
    u = rt.start + r % rt.len;
    n = r / rt.len;
  }
  // the taps: exact along t and h (the runs'), along w those that reach
  // some z of the tile (its rows' z, all of them once it wraps a row)
  const long long m1 = (M < m0 + BM ? M : m0 + BM) - 1;
  const bool one_row = m0 / Z == m1 / Z;
  const int zlo = one_row ? static_cast<int>(m0 % Z) : 0;
  const int zhi = one_row ? static_cast<int>(m1 % Z) : Z - 1;
  const int i0 = rt.lo, ni = rt.n, j0 = rh.lo, nj = rh.n;
  const int k0 = imax(0, zlo - (g.Wo - 1));
  const int nk = imax(0, imin(count(g.kW, pw, g.sw) - 1, zhi) - k0 + 1);
  const int CC = g.Co_pad / BK;
  const int chunks = ni * nj * nk * CC;

  const long long gbase = n * g.sg[0] + u * g.sg[2] + v * g.sg[3] +
                          z * g.sg[4];
  // the gather's tap, cached: its row offset in gy, whether the row reads
  // one there, its flat tap index in the packed weights
  int cur = -1, wtap = 0;
  bool a_ok = false;
  long long a_off = 0;

  auto gather = [&](int chunk, int stage) {
    const int tap = chunk / CC;
    const int co0 = (chunk - tap * CC) * BK;
    if (tap != cur) {
      cur = tap;
      const int i = i0 + tap / (nj * nk), j = j0 + (tap / nk) % nj;
      const int k = k0 + tap % nk;
      const int tu = u - i, tv = v - j, tz = z - k;
      a_ok = row_ok && tu >= 0 && tu < g.To && tv >= 0 && tv < g.Ho &&
             tz >= 0 && tz < g.Wo;
      a_off = gbase - i * g.sg[2] - j * g.sg[3] - k * g.sg[4];
      wtap = ((pt + g.st * i) * g.kH + ph + g.sh * j) * g.kW + pw + g.sw * k;
    }
    float* As = smem + stage * STAGE_FLOATS;     // [BK][BM]
    float* Bs = As + BK * BM;                    // [BK][BN]
    const float* src = g.gy + (a_ok ? a_off + co0 * g.sg[1] : 0);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const bool ok = a_ok && co0 + kk < g.Co;
      cp4(As + kk * BM + tid, ok ? src : g.gy, ok ? 4 : 0);
      src += g.sg[1];
    }
    const float* wsrc = g.wp +
        (static_cast<long long>(wtap) * g.Co_pad + co0) * g.Ci_pad + cb * BN;
#pragma unroll
    for (int q = 0; q < BK * BN / 4 / THREADS; ++q) {
      const int e = tid + q * THREADS;
      const int kk = e / (BN / 4), c4 = e % (BN / 4);
      cp16(Bs + kk * BN + c4 * 4, wsrc + kk * g.Ci_pad + c4 * 4);
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int ra = (warp % 2) * 64 + (lane % 8) * 4;   // rows ra.., ra + 32..
  const int ca = (warp / 2) * 32 + (lane / 8) * 4;   // columns ca.., ca + 16..
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks) gather(s, s);
    cp_commit();
  }
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    cp_wait<STAGES - 2>();
    // chunk c has landed for every thread, and every thread is done with
    // the stage the next gather overwrites
    __syncthreads();
    const int next = c + STAGES - 1;
    if (next < chunks) gather(next, next % STAGES);
    cp_commit();
    const float* As = smem + (c % STAGES) * STAGE_FLOATS;
    const float* Bs = As + BK * BM;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + kk * BM + ra);
      const float4 a1 =
          *reinterpret_cast<const float4*>(As + kk * BM + ra + 32);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * BN + ca);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Bs + kk * BN + ca + 16);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_wait<0>();
  __syncthreads();            // every thread is done with the ring

  // the tile through shared memory, [column][row]
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = ca + (j / 4) * 16 + j % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(smem + col * CS + ra + 32 * h) =
          make_float4(acc[4 * h][j], acc[4 * h + 1][j], acc[4 * h + 2][j],
                      acc[4 * h + 3][j]);
  }
  __syncthreads();
  if (!row_ok) return;
  float* out = g.dx + n * g.sd[0] + (pt + g.st * u) * g.sd[2] +
               (ph + g.sh * v) * g.sd[3] + (pw + g.sw * z) * g.sd[4] +
               cb * BN * g.sd[1];
  const int cols = min(BN, g.Ci - cb * BN);
#pragma unroll 4
  for (int col = 0; col < cols; ++col) out[col * g.sd[1]] = smem[col * CS + tid];
}

// wp[tap][co][ci] = W[co][ci][tap] for co < Co, ci < Ci, else 0; W contiguous
__global__ void conv3d_dgrad_pack_kernel(const float* __restrict__ w,
                                         float* __restrict__ wp, int Co,
                                         int Ci, int taps, int Co_pad,
                                         int Ci_pad) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (e >= static_cast<long long>(taps) * Co_pad * Ci_pad) return;
  const int ci = e % Ci_pad;
  const int co = (e / Ci_pad) % Co_pad;
  const int tap = e / (static_cast<long long>(Ci_pad) * Co_pad);
  wp[e] = co < Co && ci < Ci
              ? w[(static_cast<long long>(co) * Ci + ci) * taps + tap]
              : 0.0f;
}

int padded(int x, int to) { return (x + to - 1) / to * to; }

}  // namespace

extern "C" {

// Floats of the packed weights (scratch) for Co outputs, Ci inputs and
// `taps` = kT kH kW.
long long conv3d_dgrad_packed_floats(int Ci, int Co, int taps) {
  return static_cast<long long>(taps) * padded(Co, BK) * padded(Ci, BN);
}

// dx (N, Ci, T, H, W) from gy (N, Co, To, Ho, Wo) and W (Co, Ci, kT, kH,
// kW), the last contiguous, as described at the top; sg / sd the five
// strides of gy and dx in elements.  `wp` holds
// conv3d_dgrad_packed_floats(Ci, Co, kT kH kW) floats.  Launches the pack
// and the kernel on `stream`; returns a cudaError_t.
int conv3d_dgrad(const void* gy, const long long* sg, const void* w,
                 void* wp, void* dx, const long long* sd, int N, int Ci,
                 int Co, int T, int H, int W, int kT, int kH, int kW, int st,
                 int sh, int sw, void* stream) {
  Args g;
  g.gy = static_cast<const float*>(gy);
  g.wp = static_cast<const float*>(wp);
  g.dx = static_cast<float*>(dx);
  for (int i = 0; i < 5; ++i) {
    g.sg[i] = sg[i];
    g.sd[i] = sd[i];
  }
  g.N = N; g.Ci = Ci; g.Co = Co; g.T = T; g.H = H; g.W = W;
  g.kT = kT; g.kH = kH; g.kW = kW; g.st = st; g.sh = sh; g.sw = sw;
  if (N < 1 || Ci < 1 || Co < 1 || kT < 1 || kH < 1 || kW < 1 || st < 1 ||
      sh < 1 || sw < 1 || T < kT || H < kH || W < kW)
    return cudaErrorInvalidValue;
  g.To = (T - kT) / st + 1;
  g.Ho = (H - kH) / sh + 1;
  g.Wo = (W - kW) / sw + 1;
  g.Ci_pad = padded(Ci, BN);
  g.Co_pad = padded(Co, BK);
  // rows of a phase fit 31 bits; the grid's CTAs too
  const long long positions = static_cast<long long>(N) * T * H * W;
  long long ctas = 0;
  for (int q = 0; q < st * sh; ++q) {
    const Axis at(T, q / sh, st, kT, g.To), ah(H, q % sh, sh, kH, g.Ho);
    for (int a = 0; a < at.runs; ++a)
      for (int b = 0; b < ah.runs; ++b)
        ctas += group_ctas(at.at(a), ah.at(b), N, count(W, 0, sw), sw,
                           g.Ci_pad / BN);
  }
  if (positions > 0x7fffffffLL || ctas > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int taps = kT * kH * kW;
  const long long packed = conv3d_dgrad_packed_floats(Ci, Co, taps);
  conv3d_dgrad_pack_kernel<<<static_cast<unsigned>((packed + 255) / 256), 256,
                             0, s>>>(static_cast<const float*>(w),
                                     static_cast<float*>(wp), Co, Ci, taps,
                                     g.Co_pad, g.Ci_pad);
  int rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  rc = cudaFuncSetAttribute(conv3d_dgrad_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(SMEM_BYTES));
  if (rc != cudaSuccess) return rc;
  conv3d_dgrad_kernel<<<static_cast<unsigned>(ctas), THREADS, SMEM_BYTES,
                        s>>>(g);
  return cudaGetLastError();
}

}  // extern "C"

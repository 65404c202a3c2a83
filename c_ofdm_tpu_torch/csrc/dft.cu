// K4: the DFT y[m, :] = scale · x[m, :] · W with W[j, k] = exp(sign · 2πi ·
// jk / n) (sign -1: FFTW forward, +1: unnormalised backward), complex64 in
// and out, float32 arithmetic throughout (no TF32, no bf16, no fast math).
//
// Replaces the Pallas TPU kernel c_ofdm_tpu/ops/pallas_fft.py:41
// _dft_kernel (launched by _dft_planes_call, public dft_pallas), reached
// under fft_backend="pallas": on the TPU it splits x into re/im float32
// planes and runs 4 real [tile_b, n] x [n, n] MXU dots per grid step with
// both twiddle planes resident in VMEM.  Here x is read interleaved as
// float2, in place, at any row stride (the receiver's CP-stripped symbol
// view has stride 640); y is written contiguous.
//
// Bound at the flagship step's shapes (B = 256; the stock config, and
// the 1536-point LTE geometry with CP 108).  The function is a DFT: x read
// and y written once at 3.35 TB/s, against an FFT's 5·M·n·log2(n) FLOPs
// at 67 TFLOP/s (the H100 SXM's float32 non-tensor rate, NVIDIA data
// sheet):
//   TX  [2048, 512], sign +1:  16.8 MB ->  5.0 us;  47 MFLOP -> 0.7 us
//   RX  [2304, 512], sign -1:  18.9 MB ->  5.6 us;  53 MFLOP -> 0.8 us
//   TX  [2048, 1536], sign +1: 50.3 MB -> 15.0 us; 166 MFLOP -> 2.5 us
//   RX  [2304, 1536], sign -1: 56.6 MB -> 16.9 us; 187 MFLOP -> 2.8 us
// and at DVB-T2's 16K and 32K FFT sizes (B = 64 and 32 frames, CP 1/8):
//   TX  [128, 16384] / [64, 32768], sign +1: 33.6 MB -> 10.0 us
//   RX  [192, 16384] / [96, 32768], sign -1: 50.3 MB -> 15.0 us
//   (5·M·n·log2 n: 367 / 393 MFLOP a step -> 5.5 / 5.9 us)
// and at LTE 5G broadcast's 0.37 kHz numerology (3GPP TS 36.211 Rel-16:
// an 82944-point FFT, CP 9216; B = 16 frames):
//   TX  [32, 82944], sign +1: 42.5 MB -> 12.7 us
//   RX  [48, 82944], sign -1: 63.7 MB -> 19.0 us
//   (542 MFLOP a step -> 8.1 us)
// and at the same numerology sampled at 61.44 Msps (a 165888-point FFT,
// CP 18432; B = 8 frames):
//   TX  [16, 165888], sign +1: 42.5 MB -> 12.7 us
//   RX  [24, 165888], sign -1: 63.7 MB -> 19.0 us
//   (575 MFLOP a step -> 8.6 us); the four-step route moves the rows'
//   bytes twice (x to the workspace, the workspace to y), so half the
//   bound is its ceiling
// and, for the chirp route, which no path runs, at [2304, 4099]: 151.1 MB
// -> 45.1 us
// An FFT does 5·log2(n) / 16 = 2.8 FLOP per byte moved at n = 512 (3.3 at
// 1536), far below the card's float32 ridge of 67e12 / 3.35e12 = 20
// FLOP/B, so the bytes bound it and the FLOPs hide under the memory time.
// The Bluestein route does two m-point FFTs per row (at n = 509, m = 1024:
// 4.5x an FFT's FLOPs), still under the ridge.  Tensor cores
// are not used: a product on them would only add work (a dense or
// Cooley-Tukey GEMM does O(n) or O(sqrt n) FLOPs per point, not O(log n))
// to a kernel whose arithmetic already costs less than its memory traffic.
//
// Seven routes, chosen by n alone (ops/dft.py::_route):
//
// * radix, n a power of two from 16 to 8192 (the stock and wideband
//   geometries): a Stockham (self-sorting) FFT with each row in shared
//   memory, fft_kernel<log2 n> below.  n / 8 threads per row, 8 points per
//   thread; ceil(log2(n) / 3) passes: one of radix 2^(log2 n mod 3, or 3)
//   first, then radix 8, butterflies in registers.  Thread t always holds
//   the points t + k·n/8 (k = 0..7): the first pass reads them from x (a
//   warp reads consecutive addresses, float2 loads, so any 8-byte-aligned
//   row stride works) and the last pass writes them to y in natural order,
//   times scale, so the ceil(log2 n / 3) - 1 exchanges between passes are
//   the only shared-memory traffic.  The exchange is in place (read,
//   barrier, write, barrier) with an XOR swizzle of the block's index
//   (i ^ ((i >> 3) & 15)) that keeps the stride-n/8 reads and the
//   expand(j, Ns, R) writes of a half-warp in distinct bank pairs (at
//   n = 512 every exchange is conflict-free).  Blocks are 256 threads (n /
//   8 above n = 2048), ROWS = 256 / (n / 8) rows each, the last block's
//   rows masked; n = 8192 is one row of 1024 threads in 64 KB of dynamic
//   shared memory.  Twiddles are read from a table of n complex float32
//   values exp(sign · 2πi · k / n), computed in float64 on the host and
//   rounded once (ops/dft.py::fft_twiddles); pass (R, Ns) multiplies
//   point r of butterfly j by tw[(j mod Ns) · r · n / (Ns · R)].  The
//   plain version with the same passes, indices and table is
//   ops/dft.py::dft_radix_ref.
// * mixed, every other 7-smooth n = 2^a·3^b·5^c·7^d from 16 to 8192 (LTE's
//   1536, ModemConfig's fft_size = 500): mixed_fft_kernel below, the same
//   Stockham scheme with a plan chosen at run time, not a template per n.
//   The plan (ops/dft.py::_mixed_radices: 8s, then 4 or 2, then 3s, 5s and
//   7s; 1536 = 8·8·8·3) comes by value, 4 bits a radix in one 64-bit word.
//   T = ceil(n / 8) threads per row; pass (R, Ns) runs the n / R
//   butterflies j = t + b·T, b < ceil(8 / R), the last ones masked, on the
//   points j + r·n/R, with the radix route's twiddle rule (integral, since
//   Ns·R divides n) and the radix-3/5/7 butterflies' cos/sin(2πq/R)
//   computed in double and rounded once.  The twiddles are the radix
//   route's table, gathered once per (n, sign) into an r-major block per
//   pass (ops/dft.py::mixed_twiddles), so a warp's loads of point r's
//   twiddles are contiguous: at n = 1536, ~190 L1 wavefronts per row
//   where the table's scattered tw[(j mod Ns)·r·n/(Ns·R)] takes ~1360,
//   more than the 576 of the shared-memory exchanges.  The first pass
//   reads x and the last writes y (both at consecutive addresses, the
//   stride-1644 RX view read in place); between passes each butterfly
//   reads one of the row's two shared-memory buffers and writes the other,
//   swizzled as above, each row padded to a multiple of 16 points (1536 and
//   6144: every exchange conflict-free), one barrier per pass.  Rows per
//   block max(1, 256 / T); 2 x 12 KB per row at n = 1536, 128 KB at most.
//   Plain version: ops/dft.py::dft_mixed_ref.
// * cluster, every 7-smooth n from 8193 to 131072 that splits as n = c·L
//   with c a 7-smooth block count from 3 to 16 and L <= 8192 (DVB-T2's 16K
//   and 32K, LTE 5G broadcast's 82944, 12288, 3^9 = 19683):
//   cluster_fft_kernel<c, points> below, a four-step FFT with one row per
//   thread block cluster of c blocks, the row held in the cluster's
//   distributed shared memory.  Block r loads the L points x[c·i + r] (all
//   c blocks of a cluster read the same lines at once, so the HBM sees each
//   byte once; the L2 sends each block whole sectors, up to 4x the bytes
//   it uses) and runs the mixed route's passes on them in its own shared
//   memory (two buffers of L points; 8 points a thread up to L = 4096, 16
//   above, so that at most 512 threads hold a block and two blocks of up
//   to 110.6 KB fit an SM); after a cluster barrier, block q reads the c
//   values X_r[k1] of its slice of k1 from the c blocks' shared memory
//   (map_shared_rank), multiplies X_r[k1] by exp(sign·2πi·r·k1/n) (a
//   float64 table rounded once, ops/dft.py::cluster_twiddles), runs the
//   c-point butterfly in registers and writes y[k1 + L·k2] in c contiguous
//   runs, times scale.  The butterfly is the mixed passes' own for c in
//   {3, 4, 5, 7, 8}; a composite c = a·b (6, 9, 10, 12, 14, 15, 16)
//   runs b a-point DFTs, rotates their outputs by exp(sign·2πi·m2·k1/c)
//   (exactly where that is ±1 or ±i, else by a float32 constant) and runs
//   a b-point DFTs (dft_two).  x and y move once; each point crosses the
//   SM-to-SM network once.  The split (ops/dft.py::_cluster_split) takes
//   the least c with L <= 4096, else the least with L <= 8192: 16384 = 4 x
//   4096, 32768 = 8 x 4096, 65536 = 16 x 4096, 19683 = 9 x 2187, 82944 =
//   12 x 6912.  Blocks of L = 4096 points (512 threads, 64 KB, compiled for
//   3 to an SM) were the fastest of the splits timed on the H100 at the
//   16K and 32K steps' shapes, and 12 x 6912 beat 16 x 5184 at 82944
//   (PERF.md section 6 records the other splits).  Clusters of more than
//   8 blocks are the H100's non-portable sizes; a cluster sits in one GPC
//   (16-18 SMs), so the card holds 16 clusters of 12 blocks of 6912 points
//   at once (7 at 8 points a thread, one 864-thread block an SM), and a
//   step of 48 rows takes waves.  What bounds the route at these sizes is
//   not the bytes: each wave of rows pays the load, the passes (latency-
//   and instruction-bound at one or two blocks an SM), two cluster
//   barriers and the exchange in turn.  Launched with cudaLaunchKernelEx
//   and a cluster dimension (capturable in a CUDA graph);
//   c_ofdm_cluster_prepare allows the non-portable sizes, sets the dynamic
//   shared memory limit (and, for 16-point blocks, the largest shared
//   memory carveout) and checks with cudaOccupancyMaxActiveClusters that a
//   cluster fits.  Plain version: ops/dft.py::dft_cluster_ref.
// * fourstep, every other 7-smooth n = N1·N2 with both factors from 16 to
//   8192 (7^6 = 117649, 165888 = 2^11·3^4, every 7-smooth n with such a
//   split from 131073 to 8192²): two launches through a workspace z [rows,
//   n] that the wrapper allocates.  With j = N2·j1 + j2 and k = k1 +
//   N1·k2, launch 1 (fourstep_cols_reg_kernel<A, B> for N1 = A·B <= 64,
//   one column a thread in registers; else fourstep_cols_kernel, 16-64
//   columns a block through the mixed passes in shared memory) reads the
//   columns x[N2·j1 + j2] with a warp on consecutive columns, takes the
//   N1-point DFTs, multiplies X1[k1, j2] by exp(sign·2πi·j2·k1/n) (a
//   float64 table rounded once, ops/dft.py::fourstep_twiddles) and writes
//   z[k1·N2 + j2]; launch 2 (fourstep_rows_kernel) runs the mixed passes
//   along z's contiguous rows, four rows k1 a block, and writes
//   y[k1 + N1·k2] times scale in runs of 4 points (32 bytes, whole L2
//   sectors) at stride N1.  The split (ops/dft.py::_fourstep_split) takes
//   the largest N1 of the register kernel: 165888 = 64 x 2592 was the
//   fastest of the splits and row groups timed on the H100 (PERF.md
//   section 6 records the others).  What bounds the route: the bytes twice
//   over, and launch 2's mixed passes (instruction- and latency-bound at
//   one 648-thread block an SM).  Plain version:
//   ops/dft.py::dft_fourstep_ref.
// * bluestein, every other n from 16 to 4096 (primes such as 509): the
//   chirp-z transform in one kernel, bluestein_kernel<log2 m> below, one
//   row per block of m / 8 threads, m the power of two >= 2n - 1 (and
//   >= 64).  With c_k = exp(sign·πi·(k² mod 2n)/n), y_k = scale·c_k·Σ_j
//   (x_j·c_j)·conj(c_{k-j}): x·c goes zero-padded into the radix route's
//   m-point FFT (sign -1, its device functions), which ends with thread t
//   holding point t + k·m/8 in natural order; those are the points the
//   backward FFT's first pass takes, so the product with the filter's
//   spectrum (m complex64, computed in float64 on the host and rounded
//   once) is made in registers and the backward m-point FFT (sign +1)
//   starts at once; its first n points times c and scale/m are y.  x and
//   y move once; 2·(ceil(log2 m / 3) - 1) exchanges in m·8 bytes of
//   shared memory (64 KB at m = 8192).  Plain version:
//   ops/dft.py::dft_bluestein_ref.
// * chirp, every other n up to 2^25 (non-7-smooth n above 4096, such as
//   the prime 4099): Bluestein's algorithm over the FFT routes, its steps
//   as launches on the caller's stream (ops/dft.py::_chirp): x·c
//   zero-padded to m points (chirp_pre_kernel), the forward m-point FFT on
//   m's route kernel (m the least 7-smooth length >= 2n - 1 that the
//   radix, mixed, cluster or four-step route takes: 4099 -> 8232 on the
//   cluster route, 131071 -> 262144 on the four-step one), the product
//   with the filter's spectrum (fused into the four-step's launch-2 stores
//   where m is on that route, else chirp_product_kernel), the backward FFT,
//   and the first n points times c and scale/m (chirp_post_kernel).  The
//   chirp is exp(sign·πi·(k² mod 2n)/n) with k² mod 2n exact in int64 on
//   the host.  Plain version: ops/dft.py::dft_chirp_ref.
// * dense, n < 16 only, where a DFT of at most 15 points as a matrix is
//   the right algorithm: the complex GEMM dft_kernel below against W as two
//   float32 planes [n, n] (times scale, built once per (n, sign, scale) by
//   the wrapper).  Its own floor is 8·M·n² FLOPs on the float32 CUDA cores,
//   so it is no route for the sizes the other kernels take.  A block
//   computes a 64 x 64 tile of y with 256 threads, each holding 4 x 4
//   complex accumulators; the contraction runs in chunks of 16 staged in
//   shared memory, each chunk summed apart and then added to the
//   accumulators (about the plain version's 4-GEMM accuracy, at 127
//   registers).  Ragged rows, columns and chunks are zero-filled on load
//   and masked on store.
//
// Interface: plain C, loaded with ctypes (c_ofdm_tpu_torch/ops/_kernels.py).
// Each launch goes on the caller's stream, does not synchronise and
// allocates nothing; each function returns cudaGetLastError() after the
// launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // output rows and columns per block
constexpr int kChunk = 16;     // contraction depth staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = 2;        // keeps float4 reads of x aligned

__global__ void __launch_bounds__(kThreads)
dft_kernel(const float2* __restrict__ x, int64_t ldx,
           const float* __restrict__ wr, const float* __restrict__ wi,
           float2* __restrict__ y, int64_t m, int n) {
  __shared__ __align__(16) float2 xs[kChunk][kTile + kPad];
  __shared__ __align__(16) float wrs[kChunk][kTile];
  __shared__ __align__(16) float wis[kChunk][kTile];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int col0 = blockIdx.x * kTile;

  float acc_r[4][4];
  float acc_i[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc_r[i][j] = 0.f;
      acc_i[i][j] = 0.f;
    }
  }

  for (int k0 = 0; k0 < n; k0 += kChunk) {
    // x[row0 .. +64, k0 .. +16]: 16 consecutive elements of a row per
    // 16 threads, stored transposed (xs[k][row])
#pragma unroll
    for (int r = 0; r < kTile * kChunk / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      const int i = idx / kChunk;
      const int kk = idx % kChunk;
      const int64_t row = row0 + i;
      const int k = k0 + kk;
      float2 v = make_float2(0.f, 0.f);
      if (row < m && k < n) v = x[row * ldx + k];
      xs[kk][i] = v;
    }
    // W[k0 .. +16, col0 .. +64]: 64 consecutive floats of a plane row
#pragma unroll
    for (int r = 0; r < kTile * kChunk / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      const int kk = idx / kTile;
      const int j = idx % kTile;
      const int k = k0 + kk;
      const int col = col0 + j;
      float a = 0.f;
      float b = 0.f;
      if (k < n && col < n) {
        const int64_t off = static_cast<int64_t>(k) * n + col;
        a = wr[off];
        b = wi[off];
      }
      wrs[kk][j] = a;
      wis[kk][j] = b;
    }
    __syncthreads();

    // this chunk's products are summed apart and then added to the
    // accumulators: the rounding error grows with n / kChunk partial sums
    // instead of with 2n terms in one running sum
    float part_r[4][4];
    float part_i[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        part_r[i][j] = 0.f;
        part_i[i][j] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 x01 = *reinterpret_cast<const float4*>(&xs[kk][4 * ty]);
      const float4 x23 = *reinterpret_cast<const float4*>(&xs[kk][4 * ty + 2]);
      const float4 war = *reinterpret_cast<const float4*>(&wrs[kk][4 * tx]);
      const float4 wai = *reinterpret_cast<const float4*>(&wis[kk][4 * tx]);
      const float xr[4] = {x01.x, x01.z, x23.x, x23.z};
      const float xi[4] = {x01.y, x01.w, x23.y, x23.w};
      const float ar[4] = {war.x, war.y, war.z, war.w};
      const float ai[4] = {wai.x, wai.y, wai.z, wai.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          part_r[i][j] = fmaf(xr[i], ar[j], part_r[i][j]);
          part_r[i][j] = fmaf(-xi[i], ai[j], part_r[i][j]);
          part_i[i][j] = fmaf(xr[i], ai[j], part_i[i][j]);
          part_i[i][j] = fmaf(xi[i], ar[j], part_i[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc_r[i][j] += part_r[i][j];
        acc_i[i][j] += part_i[i][j];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = row0 + 4 * ty + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + 4 * tx + j;
      if (col < n) {
        y[row * n + col] = make_float2(acc_r[i][j], acc_i[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------- radix

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a · (s·i), exact
__device__ __forceinline__ float2 mul_si(float2 a, float s) {
  return make_float2(-s * a.y, s * a.x);
}

__device__ __forceinline__ void dft2(float2& a, float2& b) {
  const float2 t = a;
  a = cadd(t, b);
  b = csub(t, b);
}

// y_k = Σ_m a_m · exp(s·2πi·mk/4), in place
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3, float s) {
  dft2(a0, a2);
  dft2(a1, a3);
  a3 = mul_si(a3, s);
  dft2(a0, a1);
  dft2(a2, a3);
  const float2 t = a1;   // (a0, a2, a1, a3) now hold (y0, y1, y2, y3)
  a1 = a2;
  a2 = t;
}

// radix-8 as two radix-4 halves and the exp(s·2πi·k/8) products
__device__ __forceinline__ void dft8(float2 (&v)[8], float s) {
  constexpr float kC = 0.70710678118654752440f;   // cos(π/4)
  dft4(v[0], v[2], v[4], v[6], s);
  dft4(v[1], v[3], v[5], v[7], s);
  v[3] = make_float2(kC * (v[3].x - s * v[3].y), kC * (v[3].y + s * v[3].x));
  v[5] = mul_si(v[5], s);
  v[7] = make_float2(kC * (-v[7].x - s * v[7].y), kC * (s * v[7].x - v[7].y));
  float2 y[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    y[k] = cadd(v[2 * k], v[2 * k + 1]);
    y[k + 4] = csub(v[2 * k], v[2 * k + 1]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = y[k];
}

template <int R>
__device__ __forceinline__ void dft_small(float2 (&u)[R], float s) {
  if constexpr (R == 2) {
    dft2(u[0], u[1]);
  } else if constexpr (R == 4) {
    dft4(u[0], u[1], u[2], u[3], s);
  } else {
    dft8(u, s);
  }
}

template <int LOG2N>
struct Radix {
  static constexpr int kN = 1 << LOG2N;
  static constexpr int kT = kN / 8;                      // threads per row
  static constexpr int kThreads = kT > 256 ? kT : 256;   // per block
  static constexpr int kRows = kThreads / kT;            // rows per block
  static constexpr int kFirst = 1 << (LOG2N % 3 == 0 ? 3 : LOG2N % 3);
  static constexpr int kSmem = kRows * kN * static_cast<int>(sizeof(float2));
};

// the block's shared-memory index of point i (row-major over the block's
// rows): a bijection on every power-of-two range of 16 or more points
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 3) & 15); }

// One pass (radix R, sub-transforms of Ns points done) on the thread's 8
// points t + k·n/8: butterfly b = 0 .. 8/R - 1 is j = t + b·n/8 and takes
// the points k = b + (8/R)·r, r = 0 .. R - 1.
template <int LOG2N, int R, int NS>
__device__ __forceinline__ void butterflies(float2 (&v)[8], int t,
                                            const float2* __restrict__ tw,
                                            float s) {
  constexpr int kT = Radix<LOG2N>::kT;
  constexpr int kB = 8 / R;
  constexpr int kStep = (1 << LOG2N) / (NS * R);
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    float2 u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = v[b + kB * r];
    if constexpr (NS > 1) {
      const int jm = (t + b * kT) % NS;
#pragma unroll
      for (int r = 1; r < R; ++r) u[r] = cmul(u[r], __ldg(tw + jm * r * kStep));
    }
    dft_small<R>(u, s);
#pragma unroll
    for (int r = 0; r < R; ++r) v[b + kB * r] = u[r];
  }
}

// where point k of the thread goes after pass (R, NS): expand(j, Ns, R) +
// r·Ns, with j and r as in butterflies
template <int LOG2N, int R, int NS>
__device__ __forceinline__ int dest(int t, int k) {
  constexpr int kT = Radix<LOG2N>::kT;
  constexpr int kB = 8 / R;
  const int j = t + (k % kB) * kT;
  return (j / NS) * NS * R + j % NS + (k / kB) * NS;
}

// The radix-8 passes from Ns = NS on: read the thread's points from shared
// memory, butterfly, and unless this is the last pass write them back for
// the next.  After the last pass (NS · 8 = n) v[k] is y[t + k·n/8].
template <int LOG2N, int NS>
__device__ __forceinline__ void radix8_passes(float2 (&v)[8], int t, int base,
                                              float2* __restrict__ buf,
                                              const float2* __restrict__ tw,
                                              float s) {
  constexpr int kN = 1 << LOG2N;
  constexpr int kT = Radix<LOG2N>::kT;
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = buf[swz(base + t + k * kT)];
  butterflies<LOG2N, 8, NS>(v, t, tw, s);
  if constexpr (NS * 8 < kN) {
    __syncthreads();   // every thread has read before any overwrites
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      buf[swz(base + dest<LOG2N, 8, NS>(t, k))] = v[k];
    }
    __syncthreads();
    radix8_passes<LOG2N, NS * 8>(v, t, base, buf, tw, s);
  }
}

template <int LOG2N>
__global__ void __launch_bounds__(Radix<LOG2N>::kThreads)
fft_kernel(const float2* __restrict__ x, int64_t ldx,
           const float2* __restrict__ tw, float2* __restrict__ y, int64_t m,
           float s, float scale) {
  using S = Radix<LOG2N>;
  extern __shared__ __align__(16) float2 buf[];
  const int t = threadIdx.x % S::kT;
  const int lr = threadIdx.x / S::kT;
  const int base = lr * S::kN;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * S::kRows + lr;
  const bool live = row < m;

  float2 v[8];
  if (live) {
    const float2* xr = x + row * ldx + t;
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __ldg(xr + k * S::kT);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = make_float2(0.f, 0.f);
  }
  butterflies<LOG2N, S::kFirst, 1>(v, t, tw, s);   // no twiddles at Ns = 1
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    buf[swz(base + dest<LOG2N, S::kFirst, 1>(t, k))] = v[k];
  }
  __syncthreads();
  radix8_passes<LOG2N, S::kFirst>(v, t, base, buf, tw, s);
  if (live) {
    float2* yr = y + row * S::kN + t;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      yr[k * S::kT] = make_float2(v[k].x * scale, v[k].y * scale);
    }
  }
}

template <int LOG2N>
int launch_fft(const float2* x, int64_t ldx, const float2* tw, float2* y,
               int64_t m, float s, float scale, cudaStream_t stream) {
  using S = Radix<LOG2N>;
  const int64_t blocks = (m + S::kRows - 1) / S::kRows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fft_kernel<LOG2N><<<static_cast<unsigned>(blocks), S::kThreads, S::kSmem,
                      stream>>>(x, ldx, tw, y, m, s, scale);
  return static_cast<int>(cudaGetLastError());
}

// Lets fft_kernel<LOG2N> take its dynamic shared memory where that is
// more than the 48 KB a launch gets by default (n = 8192: 64 KB).  A
// function attribute, set once per process, device and size by the wrapper
// (ops/dft.py::_prepare) before the first launch, outside any CUDA-graph
// capture, so that a launch is only the launch and cudaGetLastError.
template <int LOG2N>
int prepare_fft() {
  using S = Radix<LOG2N>;
  if (S::kSmem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fft_kernel<LOG2N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmem));
}


// ---------------------------------------------------------------- mixed

// cos and sin of 2π·q/R for the odd radices, computed in double and rounded
// once to float (the values of ops/dft.py::_odd_roots); R and q are
// constants wherever the butterflies below are unrolled, so this folds.
__device__ __forceinline__ float2 root(int radix, int q) {
  switch (radix * 8 + q) {
    case 3 * 8 + 1: return make_float2(-0.5f, 0.866025388f);
    case 3 * 8 + 2: return make_float2(-0.5f, -0.866025388f);
    case 5 * 8 + 1: return make_float2(0.309017003f, 0.95105654f);
    case 5 * 8 + 2: return make_float2(-0.809017003f, 0.587785244f);
    case 5 * 8 + 3: return make_float2(-0.809017003f, -0.587785244f);
    case 5 * 8 + 4: return make_float2(0.309017003f, -0.95105654f);
    case 7 * 8 + 1: return make_float2(0.623489797f, 0.781831503f);
    case 7 * 8 + 2: return make_float2(-0.222520933f, 0.974927902f);
    case 7 * 8 + 3: return make_float2(-0.90096885f, 0.433883727f);
    case 7 * 8 + 4: return make_float2(-0.90096885f, -0.433883727f);
    case 7 * 8 + 5: return make_float2(-0.222520933f, -0.974927902f);
    case 7 * 8 + 6: return make_float2(0.623489797f, -0.781831503f);
    default: return make_float2(1.f, 0.f);
  }
}

// y_p = Σ_m u_m · exp(s·2πi·mp/R) for R = 3, 5, 7, in place: with
// a_k = u_k + u_{R-k} and b_k = u_k - u_{R-k}, y_0 = u_0 + Σ a_k and
// y_p, y_{R-p} = u_0 + Σ_k cos(2πkp/R)·a_k ± s·i·Σ_k sin(2πkp/R)·b_k
template <int R>
__device__ __forceinline__ void dft_odd(float2 (&u)[R], float s) {
  constexpr int kH = (R - 1) / 2;
  float2 a[kH];
  float2 b[kH];
  float2 y0 = u[0];
#pragma unroll
  for (int k = 0; k < kH; ++k) {
    a[k] = cadd(u[k + 1], u[R - 1 - k]);
    b[k] = csub(u[k + 1], u[R - 1 - k]);
    y0 = cadd(y0, a[k]);
  }
  float2 y[R];
  y[0] = y0;
#pragma unroll
  for (int p = 1; p <= kH; ++p) {
    float2 re = u[0];
    float2 im = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 1; k <= kH; ++k) {
      const float2 w = root(R, k * p % R);
      re = make_float2(re.x + w.x * a[k - 1].x, re.y + w.x * a[k - 1].y);
      im = make_float2(im.x + w.y * b[k - 1].x, im.y + w.y * b[k - 1].y);
    }
    const float2 rot = mul_si(im, s);
    y[p] = cadd(re, rot);
    y[R - p] = csub(re, rot);
  }
#pragma unroll
  for (int k = 0; k < R; ++k) u[k] = y[k];
}

template <int R>
__device__ __forceinline__ void dft_any(float2 (&u)[R], float s) {
  if constexpr (R == 3 || R == 5 || R == 7) {
    dft_odd<R>(u, s);
  } else {
    dft_small<R>(u, s);
  }
}

// cos and sin of 2π·q/R for the rotations inside the composite butterflies
// (q/R in lowest terms: the R and q that Split's factorisations need),
// computed in double and rounded once (the values of ops/dft.py::_root);
// R = 3, 5, 7 are root's.  Folds as root does.
__device__ __forceinline__ float2 turn(int radix, int q) {
  switch (radix * 16 + q) {
    case 6 * 16 + 1: return make_float2(0.5f, 0.866025388f);
    case 8 * 16 + 1: return make_float2(0.707106769f, 0.707106769f);
    case 8 * 16 + 3: return make_float2(-0.707106769f, 0.707106769f);
    case 9 * 16 + 1: return make_float2(0.766044438f, 0.642787635f);
    case 9 * 16 + 2: return make_float2(0.173648179f, 0.98480773f);
    case 9 * 16 + 4: return make_float2(-0.939692616f, 0.342020154f);
    case 10 * 16 + 1: return make_float2(0.809017003f, 0.587785244f);
    case 10 * 16 + 3: return make_float2(-0.309017003f, 0.95105654f);
    case 12 * 16 + 1: return make_float2(0.866025388f, 0.5f);
    case 14 * 16 + 1: return make_float2(0.90096885f, 0.433883727f);
    case 14 * 16 + 3: return make_float2(0.222520933f, 0.974927902f);
    case 14 * 16 + 5: return make_float2(-0.623489797f, 0.781831503f);
    case 15 * 16 + 1: return make_float2(0.91354543f, 0.406736642f);
    case 15 * 16 + 2: return make_float2(0.669130623f, 0.74314481f);
    case 15 * 16 + 4: return make_float2(-0.104528464f, 0.994521916f);
    case 15 * 16 + 8: return make_float2(-0.978147626f, -0.207911685f);
    case 16 * 16 + 1: return make_float2(0.923879504f, 0.382683426f);
    case 16 * 16 + 3: return make_float2(0.382683426f, 0.923879504f);
    case 16 * 16 + 9: return make_float2(-0.923879504f, -0.382683426f);
    default: return root(radix, q);
  }
}

__host__ __device__ constexpr int gcd_of(int a, int b) {
  return b == 0 ? a : gcd_of(b, a % b);
}

// a · exp(s·2πi·q/R): exact where q/R is 0, 1/2, 1/4 or 3/4 (mod 1), else
// times the float32 root (ops/dft.py::_rotate)
__device__ __forceinline__ float2 rotate(float2 a, int radix, int q,
                                         float s) {
  q %= radix;
  const int g = gcd_of(q, radix);
  radix /= g;
  q /= g;
  if (q == 0) return a;
  if (radix == 2) return make_float2(-a.x, -a.y);
  if (radix == 4) return mul_si(a, q == 1 ? s : -s);
  const float2 w = turn(radix, q);
  return cmul(a, make_float2(w.x, s * w.y));
}

// c = A·B for the composite butterflies (ops/dft.py::_BUTTERFLY_FACTORS)
template <int C> struct Split;
template <> struct Split<6> { static constexpr int A = 2, B = 3; };
template <> struct Split<9> { static constexpr int A = 3, B = 3; };
template <> struct Split<10> { static constexpr int A = 2, B = 5; };
template <> struct Split<12> { static constexpr int A = 4, B = 3; };
template <> struct Split<14> { static constexpr int A = 2, B = 7; };
template <> struct Split<15> { static constexpr int A = 3, B = 5; };
template <> struct Split<16> { static constexpr int A = 4, B = 4; };

// y_k = Σ_m u_m · exp(s·2πi·mk/C) for a composite C = A·B, in place, in
// registers: with m = B·m1 + m2 and k = k1 + A·k2, the A-point DFTs over
// m1 for each m2, output k1 rotated by exp(s·2πi·m2·k1/C), then the
// B-point DFTs over m2 for each k1 (ops/dft.py::_dft_two)
template <int C>
__device__ __forceinline__ void dft_two(float2 (&u)[C], float s) {
  constexpr int kA = Split<C>::A;
  constexpr int kB = Split<C>::B;
  float2 z[C];   // z[m2·A + k1]
#pragma unroll
  for (int m2 = 0; m2 < kB; ++m2) {
    float2 a[kA];
#pragma unroll
    for (int m1 = 0; m1 < kA; ++m1) a[m1] = u[kB * m1 + m2];
    dft_any<kA>(a, s);
#pragma unroll
    for (int k1 = 0; k1 < kA; ++k1) {
      z[m2 * kA + k1] = rotate(a[k1], C, m2 * k1, s);
    }
  }
#pragma unroll
  for (int k1 = 0; k1 < kA; ++k1) {
    float2 b[kB];
#pragma unroll
    for (int m2 = 0; m2 < kB; ++m2) b[m2] = z[m2 * kA + k1];
    dft_any<kB>(b, s);
#pragma unroll
    for (int k2 = 0; k2 < kB; ++k2) u[k1 + kA * k2] = b[k2];
  }
}

// The cluster kernel's C-point butterfly: a radix of the mixed passes, or
// two factors of them
template <int C>
__device__ __forceinline__ void dft_cluster(float2 (&u)[C], float s) {
  if constexpr (C == 2 || C == 3 || C == 4 || C == 5 || C == 7 || C == 8) {
    dft_any<C>(u, s);
  } else {
    dft_two<C>(u, s);
  }
}

// What a mixed_fft_kernel launch needs to know of its row length, passed by
// value: radices[i] = (plan >> 4i) & 15, passes of them.
struct MixedPlan {
  int n;         // points per row
  int t;         // threads per row, ceil(n / 8)
  int rows;      // rows per block
  int stride;    // shared-memory points per row: n rounded up to 16
  int passes;
  uint64_t plan;
  int xs;        // the first pass's input stride where XS is 0 (1 else)
};

// The row's shared-memory slot of point i: the radix route's swizzle, a
// bijection on each aligned run of 16 points, so on the padded row.
__device__ __forceinline__ int mswz(int i) { return i ^ ((i >> 3) & 15); }

// One pass (radix R, sub-transforms of ns points done) of one row: the
// thread's butterflies j = t + b·T, b < ceil(PT / R) (PT points a thread,
// T = ceil(n / PT) threads a row), the last ones masked,
// each read (from x in the first pass, point i at xr[i·XS], or at
// xr[i·p.xs] where XS is 0, else from the row's buffer ``in``),
// twiddled, transformed in registers and written to expand(j, ns, R) +
// r·ns (in the row's other buffer ``out``, or in y times scale in the last
// pass).  ``tw`` is this pass's block of the twiddle table, r-major:
// tw[(r - 1)·ns + j mod ns] = exp(sign·2πi·(j mod ns)·r/(ns·R)), so a
// warp's load of point r's twiddles is contiguous.  The buffers alternate,
// so one barrier per pass suffices.  Only the first pass's loop is
// unrolled, to keep all of the thread's loads from x in flight; unrolled
// in every pass (twiddle loads hoisted too), the kernel spills under the
// 64-register cap of 1024-thread blocks.
template <int R, bool FIRST, int XS, int PT>
__device__ __forceinline__ void mixed_pass(
    const MixedPlan& p, int ns, bool last, bool live, int t,
    const float2* __restrict__ xr, const float2* __restrict__ in,
    float2* __restrict__ out, const float2* __restrict__ tw,
    float2* __restrict__ yr, float s, float scale) {
  constexpr int kB = (PT + R - 1) / R;
  const int nb = p.n / R;
#pragma unroll (FIRST ? kB : 1)
  for (int b = 0; b < kB; ++b) {
    const int j = t + b * p.t;
    if (live && j < nb) {
      float2 u[R];
      if constexpr (FIRST && XS > 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) u[r] = __ldg(xr + (j + r * nb) * XS);
      } else if constexpr (FIRST) {
        // a runtime stride (the four-step's columns): the column's first
        // point and the step between its points
        const float2* col = xr + j * p.xs;
        const int step = nb * p.xs;
#pragma unroll
        for (int r = 0; r < R; ++r) u[r] = __ldg(col + r * step);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) u[r] = in[mswz(j + r * nb)];
        const int jm = j % ns;
#pragma unroll
        for (int r = 1; r < R; ++r) {
          u[r] = cmul(u[r], __ldg(tw + (r - 1) * ns + jm));
        }
      }
      dft_any<R>(u, s);
      const int base = (j / ns) * ns * R + j % ns;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (last) {
          yr[base + r * ns] = make_float2(u[r].x * scale, u[r].y * scale);
        } else {
          out[mswz(base + r * ns)] = u[r];
        }
      }
    }
  }
  if (!last) __syncthreads();
}

template <int R, int XS, int PT>
__device__ __forceinline__ void mixed_pass(
    const MixedPlan& p, int ns, bool first, bool last, bool live, int t,
    const float2* __restrict__ xr, const float2* __restrict__ in,
    float2* __restrict__ out, const float2* __restrict__ tw,
    float2* __restrict__ yr, float s, float scale) {
  if (first) {
    mixed_pass<R, true, XS, PT>(p, ns, last, live, t, xr, in, out, tw, yr,
                                s, scale);
  } else {
    mixed_pass<R, false, XS, PT>(p, ns, last, live, t, xr, in, out, tw, yr,
                                 s, scale);
  }
}

// Every pass of p's plan on one row: its points xr[i·XS], the row's two
// buffers rb, the plan's twiddle table tw; the last pass writes y times
// scale (yr), or with KEEP the row's buffer rb + ((passes - 1) & 1)·stride
// in natural order under mswz, followed by a barrier.
template <int XS, int PT, bool KEEP>
__device__ __forceinline__ void mixed_passes(
    const MixedPlan& p, bool live, int t, const float2* __restrict__ xr,
    float2* __restrict__ rb, const float2* __restrict__ tw,
    float2* __restrict__ yr, float s, float scale) {
  int ns = 1;
  for (int i = 0; i < p.passes; ++i) {
    const int radix = static_cast<int>((p.plan >> (4 * i)) & 15);
    const bool first = i == 0;
    const bool last = !KEEP && i + 1 == p.passes;
    const float2* in = rb + ((i + 1) & 1) * p.stride;
    float2* out = rb + (i & 1) * p.stride;
    const float2* ptw = tw;
    if (!first) tw += (radix - 1) * ns;   // the next pass's block
    switch (radix) {
      case 8: mixed_pass<8, XS, PT>(p, ns, first, last, live, t, xr, in,
                                    out, ptw, yr, s, scale); break;
      case 4: mixed_pass<4, XS, PT>(p, ns, first, last, live, t, xr, in,
                                    out, ptw, yr, s, scale); break;
      case 2: mixed_pass<2, XS, PT>(p, ns, first, last, live, t, xr, in,
                                    out, ptw, yr, s, scale); break;
      case 3: mixed_pass<3, XS, PT>(p, ns, first, last, live, t, xr, in,
                                    out, ptw, yr, s, scale); break;
      case 5: mixed_pass<5, XS, PT>(p, ns, first, last, live, t, xr, in,
                                    out, ptw, yr, s, scale); break;
      default: mixed_pass<7, XS, PT>(p, ns, first, last, live, t, xr, in,
                                     out, ptw, yr, s, scale); break;
    }
    ns *= radix;
  }
}

__global__ void __launch_bounds__(1024)
mixed_fft_kernel(const float2* __restrict__ x, int64_t ldx,
                 const float2* __restrict__ tw, float2* __restrict__ y,
                 int64_t m, MixedPlan p, float s, float scale) {
  extern __shared__ __align__(16) float2 mbuf[];
  const int t = threadIdx.x % p.t;
  const int lr = threadIdx.x / p.t;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * p.rows + lr;
  const bool live = row < m;
  const float2* xr = x + (live ? row : 0) * ldx;
  float2* yr = y + (live ? row : 0) * p.n;
  float2* rb = mbuf + 2 * lr * p.stride;   // the row's two buffers
  mixed_passes<1, 8, false>(p, live, t, xr, rb, tw, yr, s, scale);
}

constexpr int kMixedMaxSmem = 2 * 8192 * static_cast<int>(sizeof(float2));

// MixedPlan for a row of n points from the plan word (4 bits a radix,
// passes of them), `points` points a thread, one row per block of at most
// 1024 threads when one_row; cudaErrorInvalidValue unless the radices are
// all in {2, 3, 4, 5, 7, 8}, multiply to n and n is from 16 to 8192.
int make_plan(long long n, unsigned long long plan, int passes, bool one_row,
              int points, MixedPlan* p) {
  if (n < 16 || n > 8192 || passes < 2 || passes > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long prod = 1;
  for (int i = 0; i < passes; ++i) {
    const int r = static_cast<int>((plan >> (4 * i)) & 15);
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7 && r != 8) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    prod *= r;
  }
  if (prod != n || (passes < 16 && (plan >> (4 * passes)) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p->n = static_cast<int>(n);
  p->t = (p->n + points - 1) / points;
  p->rows = p->t >= 256 || one_row ? 1 : 256 / p->t;
  p->stride = (p->n + 15) / 16 * 16;
  p->passes = passes;
  p->plan = plan;
  p->xs = 1;
  return 0;
}

// ------------------------------------------------------------- cluster

// Points a thread of the cluster kernel takes for blocks of L points: 8
// up to 4096 (at most 512 threads, 64 KB of shared memory), else 16 (at
// most 512 threads for up to 128 KB), so that two such blocks fit an SM:
// with 8 (864 threads at L = 6912) the registers held one block an SM and
// the card ran only 7 clusters of 12 at once.
int cluster_points(long long L) { return L > 4096 ? 16 : 8; }

// Blocks per SM the cluster kernel of C blocks a cluster and PT points a
// thread is compiled for (the register cap 65536 / (512·blocks)):
// uncapped, the 8-point kernel takes more registers than the 42 a thread
// that 3 blocks allow, so they fit only 2 to an SM where their 64 KB of
// shared memory allows 3; capped for 3 (40 registers, no spills at C <=
// 8) the 16K and 32K steps ran faster on the H100.  Above 8 blocks the
// butterfly holds 18-32 floats of u alone, and 16-point blocks take up to
// 128 KB of shared memory: those are compiled for 2 (64 registers).
__host__ __device__ constexpr int cluster_min_blocks(int c, int pt) {
  return pt == 8 && c <= 8 ? 3 : 2;
}

// One row of n = C·L points per cluster of C blocks (cluster rank q =
// blockIdx.x mod C, row blockIdx.x / C), L·8 bytes per buffer, two buffers
// a block.  With x index C·i + r and y index k1 + L·k2 (i, k1 < L;
// r, k2 < C):  y[k1 + L·k2] = Σ_r exp(s·2πi·r·k2/C) · exp(s·2πi·r·k1/n) ·
// X_r[k1],  X_r the L-point DFT of x[C·i + r].  Block r computes X_r in its
// shared memory (the mixed kernel's passes, first pass reading x at stride
// C); after a cluster barrier block q reads, for its k1 in [q·S, q·S + S)
// (S = ceil(L / C)), the C values X_r[k1] from the C blocks' shared memory
// (distributed shared memory), multiplies X_r[k1] by ctw[(r - 1)·L + k1] =
// exp(s·2πi·r·k1/n), runs the C-point butterfly and writes y[k1 + L·k2]
// times scale: C runs of S consecutive points.  A second cluster barrier
// keeps every block's buffers alive until no block reads them.
template <int C, int PT>
__global__ void __launch_bounds__(512, cluster_min_blocks(C, PT))
cluster_fft_kernel(const float2* __restrict__ x, int64_t ldx,
                   const float2* __restrict__ tw,
                   const float2* __restrict__ ctw, float2* __restrict__ y,
                   MixedPlan p, float s, float scale) {
  extern __shared__ __align__(16) float2 mbuf[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int64_t row = static_cast<int64_t>(blockIdx.x) / C;
  const int t = threadIdx.x;
  const int L = p.n;
  mixed_passes<C, PT, true>(p, true, t, x + row * ldx + q, mbuf, tw, nullptr,
                            s, 1.f);
  const float2* fin = mbuf + ((p.passes - 1) & 1) * p.stride;
  cluster.sync();   // every block's X_r is in its shared memory

  const int span = (L + C - 1) / C;
  const int k_end = min((q + 1) * span, L);
  float2* yr = y + row * L * C;
  for (int k1 = q * span + t; k1 < k_end; k1 += p.t) {
    float2 u[C];
    const int at = mswz(k1);
    u[0] = *cluster.map_shared_rank(fin + at, 0);
#pragma unroll
    for (int r = 1; r < C; ++r) {
      u[r] = cmul(*cluster.map_shared_rank(fin + at, r),
                  __ldg(ctw + (r - 1) * L + k1));
    }
    dft_cluster<C>(u, s);
#pragma unroll
    for (int k2 = 0; k2 < C; ++k2) {
      yr[k1 + k2 * L] = make_float2(u[k2].x * scale, u[k2].y * scale);
    }
  }
  cluster.sync();   // no block leaves while another reads its buffers
}

using ClusterKernel = void (*)(const float2*, int64_t, const float2*,
                               const float2*, float2*, MixedPlan, float,
                               float);

// The instance for c blocks a cluster and `points` points a thread (8 or
// 16, cluster_points); null for a c that ops/dft.py::CLUSTER_SPLITS does
// not name.
template <int C>
ClusterKernel cluster_kernel_of(int points) {
  if (points == 8) return cluster_fft_kernel<C, 8>;
  return cluster_fft_kernel<C, 16>;
}

ClusterKernel cluster_kernel(int c, int points) {
  switch (c) {
    case 3: return cluster_kernel_of<3>(points);
    case 4: return cluster_kernel_of<4>(points);
    case 5: return cluster_kernel_of<5>(points);
    case 6: return cluster_kernel_of<6>(points);
    case 7: return cluster_kernel_of<7>(points);
    case 8: return cluster_kernel_of<8>(points);
    case 9: return cluster_kernel_of<9>(points);
    case 10: return cluster_kernel_of<10>(points);
    case 12: return cluster_kernel_of<12>(points);
    case 14: return cluster_kernel_of<14>(points);
    case 15: return cluster_kernel_of<15>(points);
    case 16: return cluster_kernel_of<16>(points);
    default: return nullptr;
  }
}

cudaLaunchConfig_t cluster_config(const MixedPlan& p, int c, unsigned blocks,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(p.t);
  cfg.dynamicSmemBytes = 2 * p.stride * sizeof(float2);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// ------------------------------------------------------------ bluestein

// One row per block of m / 8 threads, m = 2^LOG2M >= 2n - 1.  chirp [n]
// holds c, filt [m] the forward spectrum of h, tw_f / tw_i the m-point
// tables of sign -1 / +1; post = scale / m.
template <int LOG2M>
__global__ void __launch_bounds__(Radix<LOG2M>::kT)
bluestein_kernel(const float2* __restrict__ x, int64_t ldx,
                 const float2* __restrict__ chirp,
                 const float2* __restrict__ filt,
                 const float2* __restrict__ tw_f,
                 const float2* __restrict__ tw_i, float2* __restrict__ y,
                 int n, float post) {
  using S = Radix<LOG2M>;
  extern __shared__ __align__(16) float2 buf[];
  const int t = threadIdx.x;
  const int64_t row = blockIdx.x;
  const float2* xr = x + row * ldx;

  // a = x·c, zero-padded to m points: the forward FFT's first pass
  float2 v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = t + k * S::kT;
    v[k] = i < n ? cmul(__ldg(xr + i), __ldg(chirp + i))
                 : make_float2(0.f, 0.f);
  }
  butterflies<LOG2M, S::kFirst, 1>(v, t, tw_f, -1.f);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    buf[swz(dest<LOG2M, S::kFirst, 1>(t, k))] = v[k];
  }
  __syncthreads();
  radix8_passes<LOG2M, S::kFirst>(v, t, 0, buf, tw_f, -1.f);

  // v[k] = A[t + k·m/8]: times the filter's spectrum, then the backward
  // FFT, whose first pass takes these same points
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = cmul(v[k], __ldg(filt + t + k * S::kT));
  butterflies<LOG2M, S::kFirst, 1>(v, t, tw_i, 1.f);
  __syncthreads();   // every read of the forward's last pass before a write
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    buf[swz(dest<LOG2M, S::kFirst, 1>(t, k))] = v[k];
  }
  __syncthreads();
  radix8_passes<LOG2M, S::kFirst>(v, t, 0, buf, tw_i, 1.f);

  // v[k] = z[t + k·m/8] = m·(a ⊛ h): y = z·c·scale/m
  float2* yr = y + row * n;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = t + k * S::kT;
    if (i < n) {
      const float2 w = cmul(v[k], __ldg(chirp + i));
      yr[i] = make_float2(w.x * post, w.y * post);
    }
  }
}

template <int LOG2M>
int launch_bluestein(const float2* x, int64_t ldx, const float2* chirp,
                     const float2* filt, const float2* tw_f,
                     const float2* tw_i, float2* y, int64_t rows, int n,
                     float post, cudaStream_t stream) {
  using S = Radix<LOG2M>;
  if (rows > 0x7fffffffLL || 2 * n - 1 > S::kN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bluestein_kernel<LOG2M><<<static_cast<unsigned>(rows), S::kT,
                            S::kN * sizeof(float2), stream>>>(
      x, ldx, chirp, filt, tw_f, tw_i, y, n, post);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of bluestein_kernel<LOG2M> above 48 KB (m =
// 8192: 64 KB), set once per process, device and m (ops/dft.py::_prepare),
// outside any capture, as prepare_fft.
template <int LOG2M>
int prepare_bluestein() {
  constexpr int kSmem = (1 << LOG2M) * static_cast<int>(sizeof(float2));
  if (kSmem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      bluestein_kernel<LOG2M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem));
}

// ------------------------------------------------------------- fourstep

// Points a thread of a four-step launch takes for `rows` rows (or columns)
// of n points a block: 8 while the block stays within 1024 threads, else 16
// (ops/dft.py::_fourstep_points).
int fourstep_points(long long n, int rows) {
  return rows * ((n + 7) / 8) <= 1024 ? 8 : 16;
}

// Shared memory of a four-step block of `rows` rows of plan p: each row's
// two buffers and one float2 of padding, so that the same point of 16
// neighbouring rows falls in 16 distinct bank pairs.
size_t fourstep_smem(const MixedPlan& p, int rows) {
  return static_cast<size_t>(rows) * (2 * p.stride + 1) * sizeof(float2);
}

// Launch 1 of the four-step route for n = N1·N2, j = N2·j1 + j2 and
// k = k1 + N1·k2 (p the plan of N1, p.xs = N2): block b holds `cols`
// adjacent columns j2 of row b / ceil(N2 / cols), thread (t, lr) =
// (threadIdx.x / cols, threadIdx.x mod cols) the column j2 = first + lr, so
// a warp's loads of one point read consecutive columns (32 x 8 bytes where
// cols >= 32, whole 128-byte lines where cols >= 16).  The mixed passes run
// the N1-point DFT down each column in the column's two shared-memory
// buffers (its first pass reads x[row·ldx + N2·j1 + j2] in place); then
// X1[k1, j2] times ftw[(k1 - 1)·N2 + j2] = exp(s·2πi·j2·k1/n) (k1 > 0) is
// written to the workspace z[row, k1·N2 + j2], a warp's stores again on
// consecutive columns.  Ragged columns past N2 are masked.
template <int PT>
__global__ void __launch_bounds__(1024)
fourstep_cols_kernel(const float2* __restrict__ x, int64_t ldx,
                     const float2* __restrict__ tw,
                     const float2* __restrict__ ftw, float2* __restrict__ z,
                     MixedPlan p, int n2, int cols, float s) {
  extern __shared__ __align__(16) float2 mbuf[];
  const int lr = threadIdx.x % cols;
  const int t = threadIdx.x / cols;
  const int per_row = (n2 + cols - 1) / cols;
  const int64_t row = blockIdx.x / per_row;
  const int j2 = static_cast<int>(blockIdx.x % per_row) * cols + lr;
  const bool live = j2 < n2;
  const int n1 = p.n;
  float2* rb = mbuf + lr * (2 * p.stride + 1);
  mixed_passes<0, PT, true>(p, live, t, x + row * ldx + (live ? j2 : 0), rb,
                            tw, nullptr, s, 1.f);
  if (!live) return;
  const float2* fin = rb + ((p.passes - 1) & 1) * p.stride;
  float2* zr = z + row * n1 * static_cast<int64_t>(n2) + j2;
  for (int k1 = t; k1 < n1; k1 += p.t) {
    float2 v = fin[mswz(k1)];
    if (k1 > 0) v = cmul(v, __ldg(ftw + (k1 - 1) * n2 + j2));
    zr[k1 * n2] = v;
  }
}

// Launch 1 for a column length N1 = A·B with A, B in {2, 3, 4, 5, 7, 8}
// and N1 <= 64 (ops/dft.py::_FOURSTEP_REG): one column a thread, a block of
// 128 neighbouring columns, all N1 points of the column in registers, no
// shared memory and no barrier.  The thread loads x[row·ldx + N2·j1 + j2]
// for every j1 at once (a warp's loads of one j1: 32 consecutive columns),
// then with j1 = B·m1 + m2 and k1 = ka + A·kb: the A-point DFTs over m1 for
// each m2, output ka rotated by tw[m2·ka] = exp(s·2πi·m2·ka/N1) (the
// N1-point table, float64 rounded once), the B-point DFTs over m2 for each
// ka, and X1[k1] times ftw[(k1 - 1)·N2 + j2] (k1 > 0) stored to the
// workspace z[row, k1·N2 + j2].
template <int A, int B>
__global__ void __launch_bounds__(128)
fourstep_cols_reg_kernel(const float2* __restrict__ x, int64_t ldx,
                         const float2* __restrict__ tw,
                         const float2* __restrict__ ftw,
                         float2* __restrict__ z, int n2, float s) {
  constexpr int kN = A * B;
  const int per_row = (n2 + 127) / 128;
  const int64_t row = blockIdx.x / per_row;
  const int j2 = static_cast<int>(blockIdx.x % per_row) * 128 + threadIdx.x;
  if (j2 >= n2) return;
  const float2* xr = x + row * ldx + j2;
  float2 u[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) u[j] = __ldg(xr + j * n2);
#pragma unroll
  for (int m2 = 0; m2 < B; ++m2) {
    float2 a[A];
#pragma unroll
    for (int m1 = 0; m1 < A; ++m1) a[m1] = u[B * m1 + m2];
    dft_any<A>(a, s);
#pragma unroll
    for (int ka = 0; ka < A; ++ka) {
      u[B * ka + m2] = m2 * ka == 0 ? a[ka]
                                    : cmul(a[ka], __ldg(tw + m2 * ka));
    }
  }
#pragma unroll
  for (int ka = 0; ka < A; ++ka) {
    float2 b[B];
#pragma unroll
    for (int m2 = 0; m2 < B; ++m2) b[m2] = u[B * ka + m2];
    dft_any<B>(b, s);
#pragma unroll
    for (int kb = 0; kb < B; ++kb) u[B * ka + kb] = b[kb];
  }
  float2* zr = z + row * kN * static_cast<int64_t>(n2) + j2;
#pragma unroll
  for (int kb = 0; kb < B; ++kb) {
#pragma unroll
    for (int ka = 0; ka < A; ++ka) {
      const int k1 = ka + A * kb;
      float2 v = u[B * ka + kb];
      if (k1 > 0) v = cmul(v, __ldg(ftw + (k1 - 1) * n2 + j2));
      zr[k1 * n2] = v;
    }
  }
}

using FourstepReg = void (*)(const float2*, int64_t, const float2*,
                             const float2*, float2*, int, float);

// The register kernel of N1 (the factors of ops/dft.py::_FOURSTEP_REG);
// null for an N1 it is not built for.
FourstepReg reg_kernel(long long n1) {
  switch (n1) {
    case 20: return fourstep_cols_reg_kernel<4, 5>;
    case 21: return fourstep_cols_reg_kernel<3, 7>;
    case 24: return fourstep_cols_reg_kernel<3, 8>;
    case 25: return fourstep_cols_reg_kernel<5, 5>;
    case 28: return fourstep_cols_reg_kernel<4, 7>;
    case 32: return fourstep_cols_reg_kernel<4, 8>;
    case 35: return fourstep_cols_reg_kernel<5, 7>;
    case 40: return fourstep_cols_reg_kernel<5, 8>;
    case 49: return fourstep_cols_reg_kernel<7, 7>;
    case 56: return fourstep_cols_reg_kernel<7, 8>;
    case 64: return fourstep_cols_reg_kernel<8, 8>;
    default: return nullptr;
  }
}

// Launch 2 of the four-step route (p the plan of N2): block b takes G (1,
// 2 or 4) adjacent rows k1 of the workspace (row b / (N1 / G) of x, k1
// from (b mod (N1 / G))·G), the N2-point DFT of each along its contiguous
// row (the mixed passes, the result kept in shared memory), then writes
// y[row, k1 + g + N1·k2] times scale (times post[k1 + g + N1·k2] where post
// is given: the chirp route's filter spectrum) with neighbouring threads
// on neighbouring g, then k2: runs of G points at stride N1 (G 1: the
// scatter of single points; G 4: whole 32-byte sectors).
template <int PT, int G>
__global__ void __launch_bounds__(1024)
fourstep_rows_kernel(const float2* __restrict__ z,
                     const float2* __restrict__ tw,
                     const float2* __restrict__ post, float2* __restrict__ y,
                     MixedPlan p, int n1, float s, float scale) {
  extern __shared__ __align__(16) float2 mbuf[];
  const int n2 = p.n;
  const int t = threadIdx.x % p.t;
  const int lr = threadIdx.x / p.t;
  const int per_row = n1 / G;
  const int64_t row = blockIdx.x / per_row;
  const int k1 = static_cast<int>(blockIdx.x % per_row) * G;
  const int64_t n = static_cast<int64_t>(n1) * n2;
  const int pitch = 2 * p.stride + 1;
  mixed_passes<1, PT, true>(p, true, t, z + row * n + (k1 + lr) * n2,
                            mbuf + lr * pitch, tw, nullptr, s, 1.f);
  const float2* fin = mbuf + ((p.passes - 1) & 1) * p.stride;
  float2* yr = y + row * n + k1;
  const float2* pr = post == nullptr ? nullptr : post + k1;
  for (int i = threadIdx.x; i < G * n2; i += blockDim.x) {
    const int g = i % G;
    const int k2 = i / G;
    const float2 v = fin[g * pitch + mswz(k2)];
    const int at = g + n1 * k2;
    float2 w = make_float2(v.x * scale, v.y * scale);
    if (pr != nullptr) w = cmul(w, __ldg(pr + at));
    yr[at] = w;
  }
}

using FourstepCols = void (*)(const float2*, int64_t, const float2*,
                              const float2*, float2*, MixedPlan, int, int,
                              float);
using FourstepRows = void (*)(const float2*, const float2*, const float2*,
                              float2*, MixedPlan, int, float, float);

FourstepCols cols_kernel(int points) {
  if (points == 8) return fourstep_cols_kernel<8>;
  return fourstep_cols_kernel<16>;
}

template <int PT>
FourstepRows rows_kernel_of(int group) {
  switch (group) {
    case 1: return fourstep_rows_kernel<PT, 1>;
    case 2: return fourstep_rows_kernel<PT, 2>;
    case 4: return fourstep_rows_kernel<PT, 4>;
    default: return nullptr;
  }
}

// The launch-2 kernel of `points` points a thread and `group` rows a
// block; null for a group other than 1, 2 or 4.
FourstepRows rows_kernel(int points, int group) {
  return points == 8 ? rows_kernel_of<8>(group) : rows_kernel_of<16>(group);
}

// Both launches' plans for n = n1·n2 with `cols` columns a launch-1 block
// (0: the register kernel of n1, which then needs no plan) and `group` (1,
// 2 or 4) rows a launch-2 block; cudaErrorInvalidValue where a plan is
// invalid (make_plan), no register kernel takes n1, group is none of those
// or does not divide n1, or a block would exceed 1024 threads.
int fourstep_plans(long long n1, long long n2, int cols, int group,
                   unsigned long long plan1, int passes1,
                   unsigned long long plan2, int passes2, MixedPlan* p1,
                   MixedPlan* p2) {
  if (cols < 0 || (cols == 0 && reg_kernel(n1) == nullptr) ||
      rows_kernel(8, group) == nullptr || n1 % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rc = make_plan(n1, plan1, passes1, true,
                     fourstep_points(n1, cols > 0 ? cols : 1), p1);
  if (rc != 0) return rc;
  rc = make_plan(n2, plan2, passes2, true, fourstep_points(n2, group), p2);
  if (rc != 0) return rc;
  p1->xs = static_cast<int>(n2);
  if (cols * p1->t > 1024 || group * p2->t > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// ---------------------------------------------------------------- chirp

// The chirp route's elementwise passes (n > 4096, m the length of its
// FFTs): rows in blockIdx.y (strided by gridDim.y), points in a grid-stride
// loop, neighbouring threads on neighbouring points.

// a[row, i] = x[row, i]·c[i] for i < n, 0 for n <= i < m: step 1
__global__ void __launch_bounds__(256)
chirp_pre_kernel(const float2* __restrict__ x, int64_t ldx,
                 const float2* __restrict__ c, float2* __restrict__ a,
                 int64_t rows, int n, int m) {
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const float2* xr = x + row * ldx;
    float2* ar = a + row * m;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m;
         i += gridDim.x * blockDim.x) {
      ar[i] = i < n ? cmul(__ldg(xr + i), __ldg(c + i))
                    : make_float2(0.f, 0.f);
    }
  }
}

// f[row, i] *= h[i], in place: step 3 where m's route has no epilogue for it
__global__ void __launch_bounds__(256)
chirp_product_kernel(float2* __restrict__ f, const float2* __restrict__ h,
                     int64_t rows, int m) {
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    float2* fr = f + row * m;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m;
         i += gridDim.x * blockDim.x) {
      fr[i] = cmul(fr[i], __ldg(h + i));
    }
  }
}

// y[row, i] = g[row, i]·c[i]·post for i < n: step 5
__global__ void __launch_bounds__(256)
chirp_post_kernel(const float2* __restrict__ g, const float2* __restrict__ c,
                  float2* __restrict__ y, int64_t rows, int n, int m,
                  float post) {
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const float2* gr = g + row * m;
    float2* yr = y + row * n;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x) {
      const float2 w = cmul(__ldg(gr + i), __ldg(c + i));
      yr[i] = make_float2(w.x * post, w.y * post);
    }
  }
}

// The elementwise passes' grid for rows of `points` points.
dim3 chirp_grid(int64_t rows, long long points) {
  const long long x = (points + 255) / 256;
  return dim3(static_cast<unsigned>(x < 65535 ? x : 65535),
              static_cast<unsigned>(rows < 65535 ? rows : 65535));
}

}  // namespace

// The set-up c_ofdm_fft's size n needs on the current device (see
// prepare_fft); n a power of two from 16 to 8192.
extern "C" int c_ofdm_fft_prepare(long long n) {
  switch (n) {
    case 16: return prepare_fft<4>();
    case 32: return prepare_fft<5>();
    case 64: return prepare_fft<6>();
    case 128: return prepare_fft<7>();
    case 256: return prepare_fft<8>();
    case 512: return prepare_fft<9>();
    case 1024: return prepare_fft<10>();
    case 2048: return prepare_fft<11>();
    case 4096: return prepare_fft<12>();
    case 8192: return prepare_fft<13>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x [m rows, row stride ldx] complex64, tw [n] complex64 (exp(sign·2πi·k/n)),
// y [m, n] complex64 (contiguous); n a power of two from 16 to 8192, after
// c_ofdm_fft_prepare(n) on this device.
extern "C" int c_ofdm_fft(const void* x, long long ldx, const void* tw,
                          void* y, long long m, long long n, int sign,
                          float scale, void* stream) {
  if (m <= 0 || ldx < 0 || (sign != 1 && sign != -1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xs = static_cast<const float2*>(x);
  const auto* ts = static_cast<const float2*>(tw);
  auto* ys = static_cast<float2*>(y);
  const float s = static_cast<float>(sign);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 16: return launch_fft<4>(xs, ldx, ts, ys, m, s, scale, st);
    case 32: return launch_fft<5>(xs, ldx, ts, ys, m, s, scale, st);
    case 64: return launch_fft<6>(xs, ldx, ts, ys, m, s, scale, st);
    case 128: return launch_fft<7>(xs, ldx, ts, ys, m, s, scale, st);
    case 256: return launch_fft<8>(xs, ldx, ts, ys, m, s, scale, st);
    case 512: return launch_fft<9>(xs, ldx, ts, ys, m, s, scale, st);
    case 1024: return launch_fft<10>(xs, ldx, ts, ys, m, s, scale, st);
    case 2048: return launch_fft<11>(xs, ldx, ts, ys, m, s, scale, st);
    case 4096: return launch_fft<12>(xs, ldx, ts, ys, m, s, scale, st);
    case 8192: return launch_fft<13>(xs, ldx, ts, ys, m, s, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x [m rows, row stride ldx] complex64, wr/wi [n, n] float32, y [m, n]
// complex64 (contiguous).
extern "C" int c_ofdm_dft(const void* x, long long ldx, const void* wr,
                          const void* wi, void* y, long long m, long long n,
                          void* stream) {
  if (m <= 0 || n <= 0 || n > 0x7fffffffLL - kTile || ldx < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long row_tiles = (m + kTile - 1) / kTile;
  const long long col_tiles = (n + kTile - 1) / kTile;
  if (row_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(col_tiles),
                  static_cast<unsigned>(row_tiles));
  dft_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), ldx, static_cast<const float*>(wr),
      static_cast<const float*>(wi), static_cast<float2*>(y), m,
      static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

// The set-up c_ofdm_mixed_fft needs on the current device: room for the
// largest row's two buffers, 2 x 8192 points = 128 KB of dynamic shared
// memory (see prepare_fft).
extern "C" int c_ofdm_mixed_prepare() {
  return static_cast<int>(cudaFuncSetAttribute(
      mixed_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMixedMaxSmem));
}

// x [m rows, row stride ldx] complex64, tw the plan's twiddle table
// (ops/dft.py::mixed_twiddles: for each pass after the first, (R - 1)·Ns
// complex64 values, r-major), y [m, n] complex64 (contiguous); n from 16 to
// 8192, the product of the plan's passes radices (4 bits each, from {2, 3, 4, 5, 7, 8}), after
// c_ofdm_mixed_prepare() on this device.
extern "C" int c_ofdm_mixed_fft(const void* x, long long ldx, const void* tw,
                                void* y, long long m, long long n,
                                unsigned long long plan, int passes, int sign,
                                float scale, void* stream) {
  if (m <= 0 || ldx < 0 || (sign != 1 && sign != -1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MixedPlan p;
  const int rc = make_plan(n, plan, passes, false, 8, &p);
  if (rc != 0) return rc;
  const long long blocks = (m + p.rows - 1) / p.rows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(2 * p.rows) * p.stride * sizeof(float2);
  mixed_fft_kernel<<<static_cast<unsigned>(blocks), p.rows * p.t, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), ldx, static_cast<const float2*>(tw),
      static_cast<float2*>(y), m, p, static_cast<float>(sign), scale);
  return static_cast<int>(cudaGetLastError());
}

// The set-up c_ofdm_cluster_fft needs on the current device for c blocks
// a cluster and rows of L points (plan, passes: L's mixed plan): above 8
// blocks leave to use a non-portable cluster size, the dynamic shared
// memory limit, then an occupancy check; *clusters is how many such
// clusters fit on the device at once (0, an error, where none does).
extern "C" int c_ofdm_cluster_prepare(int c, long long L,
                                      unsigned long long plan, int passes,
                                      int* clusters) {
  MixedPlan p;
  const int rc = make_plan(L, plan, passes, true, cluster_points(L), &p);
  if (rc != 0) return rc;
  const ClusterKernel kernel = cluster_kernel(c, cluster_points(L));
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSuccess;
  if (c > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMixedMaxSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (cluster_points(L) == 16) {   // room for two blocks of up to 110.6 KB
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(p, c, c, nullptr, &attr);
  e = cudaOccupancyMaxActiveClusters(
      clusters, reinterpret_cast<const void*>(kernel), &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  return *clusters > 0 ? 0 : static_cast<int>(cudaErrorLaunchOutOfResources);
}

// x [m rows, row stride ldx] complex64, tw L's mixed twiddle table
// (ops/dft.py::mixed_twiddles(L)), ctw [(c - 1)·L] complex64
// (exp(sign·2πi·r·k1/(c·L)), r major from 1; ops/dft.py::cluster_twiddles),
// y [m, c·L] complex64 (contiguous); c a 7-smooth count from 3 to 16, L
// from 16 to 8192 with the plan of c_ofdm_mixed_fft, after
// c_ofdm_cluster_prepare(c, L, ...).
extern "C" int c_ofdm_cluster_fft(const void* x, long long ldx,
                                  const void* tw, const void* ctw, void* y,
                                  long long m, int c, long long L,
                                  unsigned long long plan, int passes,
                                  int sign, float scale, void* stream) {
  if (m <= 0 || ldx < 0 || (sign != 1 && sign != -1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MixedPlan p;
  const int rc = make_plan(L, plan, passes, true, cluster_points(L), &p);
  if (rc != 0) return rc;
  const ClusterKernel kernel = cluster_kernel(c, cluster_points(L));
  if (kernel == nullptr || m > 0x7fffffffLL / c) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      p, c, static_cast<unsigned>(m * c), static_cast<cudaStream_t>(stream),
      &attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float2*>(x), static_cast<int64_t>(ldx),
      static_cast<const float2*>(tw), static_cast<const float2*>(ctw),
      static_cast<float2*>(y), p, static_cast<float>(sign), scale);
  const cudaError_t last = cudaGetLastError();   // cleared either way
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// The set-up c_ofdm_bluestein's m needs on the current device (see
// prepare_bluestein); m a power of two from 64 to 8192.
extern "C" int c_ofdm_bluestein_prepare(long long m) {
  switch (m) {
    case 64: return prepare_bluestein<6>();
    case 128: return prepare_bluestein<7>();
    case 256: return prepare_bluestein<8>();
    case 512: return prepare_bluestein<9>();
    case 1024: return prepare_bluestein<10>();
    case 2048: return prepare_bluestein<11>();
    case 4096: return prepare_bluestein<12>();
    case 8192: return prepare_bluestein<13>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x [rows, row stride ldx] complex64, chirp [n], filt [m], tw_f / tw_i [m]
// (exp(-2πi·k/m) / exp(+2πi·k/m)) complex64, y [rows, n] complex64
// (contiguous), post = scale / m; n from 2 to 4096, m a power of two from
// 64 to 8192 and >= 2n - 1, after c_ofdm_bluestein_prepare(m).
extern "C" int c_ofdm_bluestein(const void* x, long long ldx,
                                const void* chirp, const void* filt,
                                const void* tw_f, const void* tw_i, void* y,
                                long long rows, long long n, long long m,
                                float post, void* stream) {
  if (rows <= 0 || ldx < 0 || n < 2 || n > 4096) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xs = static_cast<const float2*>(x);
  const auto* cs = static_cast<const float2*>(chirp);
  const auto* hs = static_cast<const float2*>(filt);
  const auto* fs = static_cast<const float2*>(tw_f);
  const auto* is = static_cast<const float2*>(tw_i);
  auto* ys = static_cast<float2*>(y);
  const int ni = static_cast<int>(n);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 64: return launch_bluestein<6>(xs, ldx, cs, hs, fs, is, ys, rows,
                                        ni, post, st);
    case 128: return launch_bluestein<7>(xs, ldx, cs, hs, fs, is, ys, rows,
                                         ni, post, st);
    case 256: return launch_bluestein<8>(xs, ldx, cs, hs, fs, is, ys, rows,
                                         ni, post, st);
    case 512: return launch_bluestein<9>(xs, ldx, cs, hs, fs, is, ys, rows,
                                         ni, post, st);
    case 1024: return launch_bluestein<10>(xs, ldx, cs, hs, fs, is, ys, rows,
                                           ni, post, st);
    case 2048: return launch_bluestein<11>(xs, ldx, cs, hs, fs, is, ys, rows,
                                           ni, post, st);
    case 4096: return launch_bluestein<12>(xs, ldx, cs, hs, fs, is, ys, rows,
                                           ni, post, st);
    case 8192: return launch_bluestein<13>(xs, ldx, cs, hs, fs, is, ys, rows,
                                           ni, post, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The set-up the four-step launches need on the current device for
// n = n1·n2 (plan1, passes1 / plan2, passes2: the mixed plans of n1 / n2)
// with `cols` columns a launch-1 block and `group` rows a launch-2 block:
// both kernels' dynamic shared memory limit raised to the device's opt-in
// maximum and their carveout to the largest shared share.  Refuses
// (cudaErrorInvalidValue) a plan or block shape the kernels do not take,
// or a block whose shared memory exceeds that maximum.
extern "C" int c_ofdm_fourstep_prepare(long long n1, long long n2, int cols,
                                       int group, unsigned long long plan1,
                                       int passes1, unsigned long long plan2,
                                       int passes2) {
  MixedPlan p1, p2;
  const int rc = fourstep_plans(n1, n2, cols, group, plan1, passes1, plan2,
                                passes2, &p1, &p2);
  if (rc != 0) return rc;
  int dev = 0;
  int optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (fourstep_smem(p1, cols) > static_cast<size_t>(optin) ||
      fourstep_smem(p2, group) > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernels[] = {
      reinterpret_cast<const void*>(
          rows_kernel(fourstep_points(n2, group), group)),
      cols > 0 ? reinterpret_cast<const void*>(
                     cols_kernel(fourstep_points(n1, cols)))
               : nullptr};
  for (const void* k : kernels) {
    if (k == nullptr) continue;
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(k,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// x [m rows, row stride ldx] complex64, n = n1·n2; tw1 the n1-point table
// exp(sign·2πi·q/n1) (ops/dft.py::fft_twiddles) for the register kernel
// (cols 0), else n1's mixed twiddle table, tw2 n2's
// (ops/dft.py::mixed_twiddles), ftw [(n1 - 1)·n2]
// (exp(sign·2πi·j2·k1/n), k1 major from 1; ops/dft.py::fourstep_twiddles),
// post [n] complex64 or null (the product fused into launch 2's stores),
// z [m, n] complex64 the workspace, y [m, n] complex64 (contiguous); after
// c_ofdm_fourstep_prepare with the same sizes.  Launch 1 then launch 2 on
// the stream; returns the first error.
extern "C" int c_ofdm_fourstep_fft(const void* x, long long ldx,
                                   const void* tw1, const void* ftw,
                                   const void* tw2, const void* post, void* z,
                                   void* y, long long m, long long n1,
                                   long long n2, int cols, int group,
                                   unsigned long long plan1, int passes1,
                                   unsigned long long plan2, int passes2,
                                   int sign, float scale, void* stream) {
  if (m <= 0 || ldx < 0 || (sign != 1 && sign != -1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MixedPlan p1, p2;
  const int rc = fourstep_plans(n1, n2, cols, group, plan1, passes1, plan2,
                                passes2, &p1, &p2);
  if (rc != 0) return rc;
  const int per_block = cols > 0 ? cols : 128;   // launch 1's columns
  const long long blocks1 = m * ((n2 + per_block - 1) / per_block);
  const long long blocks2 = m * (n1 / group);
  if (blocks1 > 0x7fffffffLL || blocks2 > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const float s = static_cast<float>(sign);
  const FourstepRows launch2 = rows_kernel(fourstep_points(n2, group), group);
  if (cols == 0) {
    const FourstepReg launch1 = reg_kernel(n1);
    launch1<<<static_cast<unsigned>(blocks1), 128, 0, st>>>(
        static_cast<const float2*>(x), ldx, static_cast<const float2*>(tw1),
        static_cast<const float2*>(ftw), static_cast<float2*>(z),
        static_cast<int>(n2), s);
  } else {
    const FourstepCols launch1 = cols_kernel(fourstep_points(n1, cols));
    launch1<<<static_cast<unsigned>(blocks1), cols * p1.t,
              fourstep_smem(p1, cols), st>>>(
        static_cast<const float2*>(x), ldx, static_cast<const float2*>(tw1),
        static_cast<const float2*>(ftw), static_cast<float2*>(z), p1,
        static_cast<int>(n2), cols, s);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  launch2<<<static_cast<unsigned>(blocks2), group * p2.t,
            fourstep_smem(p2, group), st>>>(
      static_cast<const float2*>(z), static_cast<const float2*>(tw2),
      static_cast<const float2*>(post), static_cast<float2*>(y), p2,
      static_cast<int>(n1), s, scale);
  return static_cast<int>(cudaGetLastError());
}

// The chirp route's elementwise passes (rows > 0, 0 < n <= m; on the
// stream, no set-up): step 1, x [rows, row stride ldx] times the chirp c
// [n], zero-padded into a [rows, m]; step 3, f [rows, m] times h [m] in
// place; step 5, y [rows, n] = g[:, :n] (g [rows, m]) times c times post.
extern "C" int c_ofdm_chirp_pre(const void* x, long long ldx, const void* c,
                                void* a, long long rows, long long n,
                                long long m, void* stream) {
  if (rows <= 0 || ldx < 0 || n <= 0 || n > m || m > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  chirp_pre_kernel<<<chirp_grid(rows, m), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), ldx, static_cast<const float2*>(c),
      static_cast<float2*>(a), rows, static_cast<int>(n),
      static_cast<int>(m));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int c_ofdm_chirp_product(void* f, const void* h, long long rows,
                                    long long m, void* stream) {
  if (rows <= 0 || m <= 0 || m > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  chirp_product_kernel<<<chirp_grid(rows, m), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(f), static_cast<const float2*>(h), rows,
      static_cast<int>(m));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int c_ofdm_chirp_post(const void* g, const void* c, void* y,
                                 long long rows, long long n, long long m,
                                 float post, void* stream) {
  if (rows <= 0 || n <= 0 || n > m || m > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  chirp_post_kernel<<<chirp_grid(rows, n), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(g), static_cast<const float2*>(c),
      static_cast<float2*>(y), rows, static_cast<int>(n),
      static_cast<int>(m), post);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* c_ofdm_dft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
// Bound at the flagship step's shapes (stock config, B = 256).  The
// function is a DFT: x read and y written once at 3.35 TB/s, against an
// FFT's 5·M·n·log2(n) FLOPs at 67 TFLOP/s (the H100 SXM's float32
// non-tensor rate, NVIDIA data sheet):
//   TX  [2048, 512], sign +1: 16.8 MB -> 5.0 us;  47 MFLOP -> 0.7 us
//   RX  [2304, 512], sign -1: 18.9 MB -> 5.6 us;  53 MFLOP -> 0.8 us
// An FFT does 5·log2(n) / 16 = 2.8 FLOP per byte moved at n = 512, far
// below the card's float32 ridge of 67e12 / 3.35e12 = 20 FLOP/B, so the
// bytes bound it and the FLOPs hide under the memory time.  Tensor cores
// are not used: a product on them would only add work (a dense or
// Cooley-Tukey GEMM does O(n) or O(sqrt n) FLOPs per point, not O(log n))
// to a kernel whose arithmetic already costs less than its memory traffic.
//
// Two routes, chosen by n alone (ops/dft.py::_route):
//
// * radix, n a power of two from 16 to 8192 (every n the pallas paths
//   use): a Stockham (self-sorting) FFT with each row in shared memory,
//   fft_kernel<log2 n> below.  n / 8 threads per row, 8 points per thread;
//   ceil(log2(n) / 3) passes: one of radix 2^(log2 n mod 3, or 3) first,
//   then radix 8, butterflies in registers.  Thread t always holds the
//   points t + k·n/8 (k = 0..7): the first pass reads them from x (a warp
//   reads consecutive addresses, float2 loads, so any 8-byte-aligned row
//   stride works) and the last pass writes them to y in natural order,
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
// * dense, every other n (n < 16, n > 8192 and sizes that are not powers
//   of two: ModemConfig allows fft_size = 500): the complex GEMM
//   dft_kernel below against W as two float32 planes [n, n] (times scale,
//   built once per (n, sign, scale) by the wrapper).  Its own floor is
//   8·M·n² FLOPs on the float32 CUDA cores, so it is no route for the
//   sizes the radix kernel takes.  A block computes a 64 x 64 tile of y
//   with 256 threads, each holding 4 x 4 complex accumulators; the
//   contraction runs in chunks of 16 staged in shared memory, each chunk
//   summed apart and then added to the accumulators (about the plain
//   version's 4-GEMM accuracy, at 127 registers).  Ragged rows, columns
//   and chunks are zero-filled on load and masked on store.
//
// Interface: plain C, loaded with ctypes (c_ofdm_tpu_torch/ops/_kernels.py).
// Each launch goes on the caller's stream, does not synchronise and
// allocates nothing; each function returns cudaGetLastError() after the
// launch.

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

extern "C" const char* c_ofdm_dft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

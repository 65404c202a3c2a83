// K4: the dense DFT as one complex GEMM, y[m, :] = x[m, :] · W with
// W[j, k] = scale · exp(sign · 2πi · jk / n), complex64 in and out, float32
// arithmetic throughout (no TF32, no bf16).
//
// Replaces the Pallas TPU kernel c_ofdm_tpu/ops/pallas_fft.py _dft_kernel
// (launched by _dft_planes_call, public dft_pallas), reached under
// fft_backend="pallas": on the TPU it splits x into re/im float32 planes and
// runs 4 real [tile_b, n] x [n, n] MXU dots per grid step with both twiddle
// planes resident in VMEM.  Here x is read interleaved as float2, in place
// (any row stride: the receiver's CP-stripped symbol view has stride 640),
// W as its two float32 planes [n, n] built once per (n, sign, scale) by the
// wrapper, and each complex multiply-add is 4 float32 FMAs.
//
// Bound at the flagship step's shapes (stock config, B = 256).  The function
// is a DFT: x read and y written once at 3.35 TB/s, against an FFT's
// 5·M·n·log2(n) FLOPs at 67 TFLOP/s (the H100 SXM's float32 non-tensor rate,
// NVIDIA data sheet), so the bound is the bytes:
//   TX  [2048, 512], sign +1: 16.8 MB -> 5.0 us;  47 MFLOP -> 0.7 us
//   RX  [2304, 512], sign -1: 18.9 MB -> 5.6 us;  53 MFLOP -> 0.8 us
// This kernel is the dense product, whose own floor is 8·M·n² FLOPs on the
// float32 CUDA cores (no tensor-core path at full float32): 4.29 GFLOP ->
// 64 us (TX), 4.83 GFLOP -> 72 us (RX), 11-13x the bound.  Within that
// design it is compute-bound: each staged element is reused 64 times from
// shared memory, and the inner loop is FMAs fed by 128-bit shared loads.
//
// Design: a block computes a 64 x 64 tile of y with 256 threads, each
// holding 4 x 4 complex accumulators (rows 4·ty.., columns 4·tx..).  The
// contraction runs in chunks of 16: each chunk stages x[64 rows, 16] (as
// float2, transposed, padded) and W[16, 64 columns] (two planes) in shared
// memory, synchronises, and sums the chunk's products into partial sums that
// are then added to the accumulators: about the plain version's 4-GEMM
// accuracy, at 127 registers (one running sum of 2n terms per output missed
// chip_smoke.py's limit of 4x the plain version's error at some shapes).
// Ragged rows, columns and chunks are zero-filled on load and masked on
// store, so any M and any n work (ModemConfig allows fft_size = 500).  A
// 3xTF32 wgmma product or an in-shared-memory radix FFT (O(n log n)) is the
// redesign this leaves open.
//
// Interface: plain C, loaded with ctypes (c_ofdm_tpu_torch/ops/_kernels.py).
// The launch goes on the caller's stream, does not synchronise and allocates
// nothing; the function returns cudaGetLastError() after the launch.

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

}  // namespace

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

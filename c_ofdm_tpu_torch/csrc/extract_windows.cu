// K1, K2, K3: window extraction at data-dependent starts,
// out[r, k, j] = x[r, s(r, k) + j].
//
// Replaces three Pallas TPU kernels of c_ofdm_tpu/ops/pallas_extract.py:
//   K1 _extract_kernel (public extract_windows): one window per capture row,
//      [B, n] -> [B, win] (K = 1 window per row);
//   K2 _single_kernel (public extract_windows_single): K windows out of one
//      streaming ring, [n] -> [K, win] (one row);
//   K3 _extract_multi_call -> _single_kernel (public extract_windows_multi):
//      K windows out of each of C rings, [C, n] -> [C, K, win].
// On the TPU these kernels split the complex input into re/im float32 planes,
// roll whole (8, L) VMEM tiles by the bits of each start (K1) or copy the
// 128-aligned part of each start and apply the remainder as 7 conditional
// rolls (K2), and K3 flattens the C rings into one row chunked at 2 M samples
// to fit Mosaic's 16 MB scoped VMEM.  A TPU has no cheap per-row unaligned
// copy; Hopper has one: each thread copies one element at its own address.
// So all three are one plain offset copy on the interleaved complex data,
// with no plane split, no padding or flat copy, no rolls and no chunking.
//
// Design: grid (window w = r*K + k, column tile).  Each block reads its
// window's start once and maps it as lax.dynamic_slice does: a negative start
// counts from the end once (s + n), then the start is clamped to [0, n - win].
// Each thread copies one element; neighbouring threads touch neighbouring
// 8-byte (complex64) or 16-byte (complex128) elements, so loads and stores
// coalesce.  The ragged last tile is masked.  The template parameter is the
// element width only (uint2 = 8 B, uint4 = 16 B), a bit copy, so results are
// bit-exact and dispatch never depends on the complex dtype.
//
// Bound: HBM.  No arithmetic beyond the index math.  Per launch it moves
// rows*K*win elements in and the same out: the flagship K1 shape
// (B = 256, win = 5760, complex64) 11.8 MB each way; the streaming ring at
// C = 8 (K = 41, win = 5760) 15.1 MB each way.
//
// Interface: plain C, loaded with ctypes (c_ofdm_tpu_torch/ops/_kernels.py).
// The launch goes on the caller's stream and does not synchronise; the
// function returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void extract_windows_kernel(const T* __restrict__ x,
                                       const int32_t* __restrict__ starts,
                                       T* __restrict__ out,
                                       int64_t windows_per_row, int64_t n,
                                       int64_t win) {
  const int64_t w = blockIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  if (j >= win) return;
  const int64_t row = w / windows_per_row;
  int64_t s = starts[w];
  if (s < 0) s += n;
  s = s < 0 ? 0 : (s > n - win ? n - win : s);
  out[w * win + j] = x[row * n + s + j];
}

}  // namespace

// x [rows, n], starts [rows, windows_per_row] int32, out [rows,
// windows_per_row, win]; elem_bytes 8 (complex64) or 16 (complex128).
extern "C" int c_ofdm_extract_windows(const void* x, const void* starts,
                                      void* out, long long rows,
                                      long long windows_per_row, long long n,
                                      long long win, int elem_bytes,
                                      void* stream) {
  const long long windows = rows * windows_per_row;
  if (rows <= 0 || windows_per_row <= 0 || windows > 0x7fffffffLL ||
      win <= 0 || win > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (win + kThreads - 1) / kThreads;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(windows), static_cast<unsigned>(tiles));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 8) {
    extract_windows_kernel<uint2><<<grid, kThreads, 0, st>>>(
        static_cast<const uint2*>(x), static_cast<const int32_t*>(starts),
        static_cast<uint2*>(out), windows_per_row, n, win);
  } else if (elem_bytes == 16) {
    extract_windows_kernel<uint4><<<grid, kThreads, 0, st>>>(
        static_cast<const uint4*>(x), static_cast<const int32_t*>(starts),
        static_cast<uint4*>(out), windows_per_row, n, win);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* c_ofdm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

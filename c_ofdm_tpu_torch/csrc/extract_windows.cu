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
// copy; Hopper has one: each thread copies bytes at its own address.  So all
// three are one plain offset copy on the interleaved complex data, with no
// plane split, no padding or flat copy, no rolls and no chunking.
//
// Bound: HBM bytes (each window read once and written once) plus, for the
// streaming ring's small launches, the card's fixed time per launch.  There
// is no arithmetic beyond the index math, so the design is about bytes in
// flight per thread and about not wasting threads.
//
// Two bodies, both bit copies (results are bit-exact and never depend on the
// complex dtype), both on the grid (window w = r*K + k, tile of the window):
//
//   wide    a window is a run of 8-byte halves (one per complex64, two per
//           complex128).  plan_window() cuts it, from the byte addresses of
//           its first source and destination halves, into an optional head
//           half (when the destination is only 8-byte aligned: an odd win
//           on an odd window), 16-byte pairs, and an optional tail half.
//           Every pair is stored as one aligned 16-byte store.  Its load is
//           one 16-byte load when the source of the first pair is 16-byte
//           aligned and two 8-byte loads otherwise: the start's parity, the
//           input's base (a contiguous view such as ring[1:] is only 8-byte
//           aligned) and the head decide, once per window, so a block never
//           diverges.  A thread copies kUnits = 4 pairs, strided by the
//           block so that neighbouring threads touch neighbouring pairs,
//           with all its loads started before its first store: 64 bytes in
//           flight per thread.
//   scalar  one thread copies one element (8 or 16 bytes).  It serves
//           windows too short to pair and small launches (up to 1 MiB each
//           way: the candidate regions of one streaming ring), whose time is
//           the launch plus two dependent memory latencies and where its
//           shorter code measured a few percent faster than the wide body;
//           it is also the yardstick the wide body is timed against.
//
// The host picks the body and the block size from the shape alone
// (ops/extract.py::launch_plan) and sizes the blocks so that no tile of a
// window is more than one warp short.
//
// Every thread of a block reads the same starts[w] through the read-only
// path (one broadcast transaction per warp, no barrier), maps it as
// lax.dynamic_slice does (a negative start counts from the end once, s + n,
// then the start is clamped to [0, n - win]) and then has the data load as
// its only other long wait.  Starts are int32 or int64, as the caller has
// them.
//
// Not used, on purpose.  Bulk tensor copies (cp.async.bulk) need 16-byte
// aligned global addresses and sizes, which an odd start breaks.  A stage in
// shared memory gains nothing for a copy with no reuse.  Programmatic
// dependent launch would move the wait for the producer of the starts into
// this kernel's own time without shortening the two-launch chain of a
// streaming buffer (candidate regions, matched filter, frame windows).
//
// c_ofdm_stage_mark starts stage_mark_kernel<stage>, one thread that does
// nothing: a mark in the device timeline (io/trace.py captures one into a
// traced graph at each stage boundary of the receive chain), named by the
// stage's index in the profiler's trace.
//
// Interface: plain C, loaded with ctypes (c_ofdm_tpu_torch/ops/_kernels.py).
// A launch goes on the caller's stream and does not synchronise; each
// function returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kWideUnits = 4;   // 16-byte pairs per thread of the wide body

// The start lax.dynamic_slice reads from.
__device__ __forceinline__ int64_t slice_start(int64_t s, int64_t n,
                                               int64_t win) {
  if (s < 0) s += n;
  return s < 0 ? 0 : (s > n - win ? n - win : s);
}

// How one window of `halves` 8-byte halves is copied, from the byte addresses
// of its first source and destination halves (both 8-byte aligned).  Mirrors
// ops/extract.py::plan_window line for line.
struct WindowPlan {
  int64_t head;   // 0 or 1 half copied alone in front
  int64_t pairs;  // 16-byte units, each stored with one aligned store
  int64_t tail;   // 0 or 1 half copied alone behind
  bool aligned;   // the pairs' source is 16-byte aligned: one load per pair
};

__device__ __forceinline__ WindowPlan plan_window(uint64_t src_addr,
                                                  uint64_t dst_addr,
                                                  int64_t halves) {
  WindowPlan p;
  p.head = ((dst_addr & 15) != 0 && halves > 0) ? 1 : 0;
  p.pairs = (halves - p.head) / 2;
  p.tail = halves - p.head - 2 * p.pairs;
  p.aligned = ((src_addr + 8 * p.head) & 15) == 0;
  return p;
}

template <int kUnits, typename S>
__global__ void __launch_bounds__(kMaxThreads)
extract_wide_kernel(const uint2* __restrict__ x, const S* __restrict__ starts,
                    uint2* __restrict__ out, int64_t windows_per_row,
                    int64_t n, int64_t win, int64_t halves_per_elem) {
  const int64_t w = blockIdx.x;
  // at most 2^31 - 1 windows (checked at the entry): a 32-bit division
  const int64_t row = blockIdx.x / static_cast<unsigned>(windows_per_row);
  const int64_t s = slice_start(static_cast<int64_t>(starts[w]), n, win);
  const int64_t halves = win * halves_per_elem;
  const uint2* src = x + (row * n + s) * halves_per_elem;
  uint2* dst = out + w * halves;
  const WindowPlan p = plan_window(reinterpret_cast<uint64_t>(src),
                                   reinterpret_cast<uint64_t>(dst), halves);
  const uint2* psrc = src + p.head;              // first pair's source
  uint4* pdst = reinterpret_cast<uint4*>(dst + p.head);   // 16-byte aligned
  const int64_t first =
      static_cast<int64_t>(blockIdx.y) * (blockDim.x * kUnits) + threadIdx.x;

  uint4 v[kUnits];
  if (p.aligned) {
    const uint4* psrc4 = reinterpret_cast<const uint4*>(psrc);
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int64_t q = first + static_cast<int64_t>(k) * blockDim.x;
      if (q < p.pairs) v[k] = psrc4[q];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int64_t q = first + static_cast<int64_t>(k) * blockDim.x;
      if (q < p.pairs) {
        const uint2 a = psrc[2 * q];
        const uint2 b = psrc[2 * q + 1];
        v[k] = make_uint4(a.x, a.y, b.x, b.y);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int64_t q = first + static_cast<int64_t>(k) * blockDim.x;
    if (q < p.pairs) pdst[q] = v[k];
  }
  if (blockIdx.y == 0) {
    if (p.head && threadIdx.x == 0) dst[0] = src[0];
    if (p.tail && threadIdx.x == blockDim.x - 1) {
      dst[halves - 1] = src[halves - 1];
    }
  }
}

template <typename T, typename S>
__global__ void __launch_bounds__(kMaxThreads)
extract_scalar_kernel(const T* __restrict__ x, const S* __restrict__ starts,
                      T* __restrict__ out, int64_t windows_per_row, int64_t n,
                      int64_t win) {
  const int64_t w = blockIdx.x;
  const int64_t j =
      static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (j >= win) return;
  // at most 2^31 - 1 windows (checked at the entry): a 32-bit division
  const int64_t row = blockIdx.x / static_cast<unsigned>(windows_per_row);
  const int64_t s = slice_start(static_cast<int64_t>(starts[w]), n, win);
  out[w * win + j] = x[row * n + s + j];
}

constexpr int kStages = 6;   // io/trace.py's STAGES

template <int Stage>
__global__ void stage_mark_kernel() {}

template <typename S>
void launch(const void* x, const void* starts, void* out, int64_t per_row,
            int64_t n, int64_t win, int elem_bytes, int units, dim3 grid,
            int threads, cudaStream_t st) {
  const S* s = static_cast<const S*>(starts);
  const int64_t hpe = elem_bytes / 8;
  const uint2* x2 = static_cast<const uint2*>(x);
  uint2* o2 = static_cast<uint2*>(out);
  if (units == kWideUnits) {
    extract_wide_kernel<kWideUnits, S><<<grid, threads, 0, st>>>(
        x2, s, o2, per_row, n, win, hpe);
  } else if (elem_bytes == 8) {
    extract_scalar_kernel<uint2, S><<<grid, threads, 0, st>>>(
        x2, s, o2, per_row, n, win);
  } else {
    extract_scalar_kernel<uint4, S><<<grid, threads, 0, st>>>(
        static_cast<const uint4*>(x), s, static_cast<uint4*>(out), per_row, n,
        win);
  }
}

}  // namespace

// x [rows, n], starts [rows, windows_per_row] of start_bytes (4: int32, 8:
// int64) each, out [rows, windows_per_row, win]; elem_bytes 8 (complex64) or
// 16 (complex128).  units 0 runs the scalar body, 4 the wide body with that
// many 16-byte pairs per thread; threads and tiles are the block
// size and the tiles per window of ops/extract.py::launch_plan, refused
// here if they do not cover a window.
extern "C" int c_ofdm_extract_windows(const void* x, const void* starts,
                                      void* out, long long rows,
                                      long long windows_per_row, long long n,
                                      long long win, int elem_bytes,
                                      int start_bytes, int units, int threads,
                                      long long tiles, void* stream) {
  const long long windows = rows * windows_per_row;
  if (rows <= 0 || windows_per_row <= 0 || windows > 0x7fffffffLL ||
      win <= 0 || win > n || (elem_bytes != 8 && elem_bytes != 16) ||
      (start_bytes != 4 && start_bytes != 8) ||
      (units != 0 && units != kWideUnits) ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      tiles < 1 || tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long need = units == 0 ? win : win * (elem_bytes / 8) / 2;
  if (tiles * threads * (units == 0 ? 1 : units) < need) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(windows), static_cast<unsigned>(tiles));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (start_bytes == 4) {
    launch<int32_t>(x, starts, out, windows_per_row, n, win, elem_bytes, units,
                    grid, threads, st);
  } else {
    launch<int64_t>(x, starts, out, windows_per_row, n, win, elem_bytes, units,
                    grid, threads, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// The mark of stage `stage` (0 .. kStages - 1) on `stream`.
extern "C" int c_ofdm_stage_mark(int stage, void* stream) {
  if (stage < 0 || stage >= kStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: stage_mark_kernel<0><<<1, 1, 0, st>>>(); break;
    case 1: stage_mark_kernel<1><<<1, 1, 0, st>>>(); break;
    case 2: stage_mark_kernel<2><<<1, 1, 0, st>>>(); break;
    case 3: stage_mark_kernel<3><<<1, 1, 0, st>>>(); break;
    case 4: stage_mark_kernel<4><<<1, 1, 0, st>>>(); break;
    default: stage_mark_kernel<5><<<1, 1, 0, st>>>(); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* c_ofdm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The streaming sync's hop track: the masked/total energy ratio of every
// 50%-overlap two-tone window of a ring, ratio[..., w] for windows of
// size = 2·hop samples starting at w·hop.
//
// Replaces no TPU kernel: the JAX package leaves this product to XLA's dot
// (c_ofdm_tpu/ops/sync.py::t2_ratio_track_hop).  On the card the plain
// version (ops/sync.py::t2_ratio_track_hop_ref) is four skinny cuBLAS
// GEMMs [rows·nh, hop] @ [hop, nbins] on strided copies of the ring's real
// and imaginary planes, two energy passes and a chain of small kernels: more
// than ten passes over the ring for nbins numbers a half-block.  Here the
// ring is read once and only the ratio track is written.
//
// The function (the plain version's, with nh = n // hop half-blocks a row):
//   A_h[b] = Σ_{m<hop} x[h·hop + m] · W[m, b]       (W: t2_hop_basis)
//   E_h    = Σ_{m<hop} |x[h·hop + m]|²
//   S_w[b] = A_w[b] + sgn_b · A_{w+1}[b]              (sgn: t2_hop_sign)
//   ratio_w = Σ_b weight_b |S_w[b]|² / (size · (E_w + E_{w+1})),
//             0 where the total is not above 0         (w < nh - 1)
//
// Bound (ring read once, ratios written once; the direct projection's
// operations, no FFT shortcut counted): bytes = rows·n·itemsize +
// rows·(nh-1)·itemsize/2, FLOPs = 8·rows·nh·hop·nbins.  At the PlutoSDR
// gateway (64 rings of 246656 complex64, hop 128, 22 bins) that is 126.8 MB
// (37.8 µs at 3.35 TB/s) and 2.78 GFLOP (41.5 µs at 67 TFLOP/s): the
// float32 rate binds, barely, so the design keeps the FMA pipes fed from
// shared memory while the ring streams in behind them.
//
// Design.  The half-blocks of all rows form one sequence q = row·nh + h.
// A tile is H consecutive half-blocks (128 at the stock geometry); tiles
// overlap by one half-block, so a tile yields H - 1 windows, those whose
// two halves lie in one row.  The blocks are persistent (as many as fit on
// the card at once: 264 at the gateway, two an SM) and walk the tiles
// blockIdx.x, + gridDim.x, ..., loading a tile's first chunk while the
// last one's is computed; a block a tile (972 blocks, each loading the
// basis and waiting for its first chunk) measured 120 µs a call against
// 111 (PERF.md, section 6).
//  * The basis sits in shared memory for the whole launch (22.5 KB at
//    pluto in float32), as pairs of consecutive samples k, k + 1 of one
//    bin, [k/2][bin].
//  * A tile streams in chunks of kBK = 32 samples of each of its H
//    half-blocks through two buffers: the cp.async loads (16 bytes a
//    thread where the ring allows, else 8) of the next chunk are issued
//    before the current chunk is computed (three or four buffers, which
//    leave room for one block an SM, measured slower).  Staged rows are padded
//    by 16 bytes, so neighbouring half-blocks fall in other banks.
//  * A warp takes kTB = 11 consecutive bins (a bin group) of 32·kTM
//    half-blocks: lane l accumulates half-blocks l + 32·m, m < kTM = 2, for
//    all kTB bins in registers.  Per pair of samples a lane reads kTM
//    sample pairs of its own half-blocks (conflict-free: the padded rows)
//    and the warp reads kTB basis pairs that every lane shares (one
//    broadcast each), for 8·kTM·kTB FMAs.  Lanes over bins, with the
//    sample a broadcast, was measured first: its basis reads wrap across
//    the 11 bin pairs of a warp (two-way bank conflicts), so shared
//    memory, not the FMA pipes, held it at 154 µs a call at the gateway
//    (PERF.md, section 6).
//  * The warps of the first bin group also sum |x|² of their half-blocks
//    from the samples they read; only the ratio track reaches device
//    memory.
//  * After a tile's last chunk the A values go through that chunk's stage
//    buffer (rows padded to an odd stride); one thread a window sums its
//    bins and writes its ratio.
// The launch adapts to hop and nbins alone: kTileRows half-blocks a tile,
// fewer where the block's threads or the device's shared memory would not
// hold them (c_ofdm_hop_prepare).  Templated on float and double
// (complex64 and complex128 rings).
//
// Interface: plain C, loaded with ctypes (c_ofdm_tpu_torch/ops/_kernels.py).
// c_ofdm_hop_prepare picks the warps a bin group for hop, nbins and the
// real type, sets the kernel's dynamic shared memory limit and counts the
// blocks the card holds at once (once per process, device and geometry,
// outside any CUDA-graph capture); c_ofdm_hop_track derives the rest of
// the launch from those two numbers, checks the shape (-1 where it refuses
// it), launches on the caller's stream, does not synchronise and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 32;           // samples of a half-block a chunk stages
constexpr int kTB = 11;           // bins a warp accumulates
constexpr int kTM = 2;            // half-blocks a lane accumulates
constexpr int kStages = 2;        // chunk buffers: one read, one loading
constexpr int kTileRows = 128;    // half-blocks a tile, where they fit
constexpr int kMaxThreads = 512;

// c_ofdm_hop_track's refusal, before any launch (CUDA's codes are >= 0)
constexpr int kRefusedShape = -1;

template <typename Real> struct Cx;
template <> struct Cx<float> { using T = float2; };
template <> struct Cx<double> { using T = double2; };

// two consecutive samples of a half-block, or one bin's basis at k, k + 1
template <typename Real>
struct alignas(16) Pair {
  typename Cx<Real>::T a, b;
};

// a staged row's padding: 16 bytes
template <typename Real>
__host__ __device__ constexpr int pad_elems() {
  return 16 / static_cast<int>(sizeof(typename Cx<Real>::T));
}

struct Geometry {
  int groups;       // bin groups of kTB bins
  int nbp;          // bins padded to whole groups
  int nk;           // chunks a half-block
  int xstride;      // staged row, complex elements
  int astride;      // A row in the exchange, complex elements (odd)
  int stage;        // one stage buffer, complex elements
};

template <typename Real>
__host__ __device__ Geometry geometry(int hop, int nbins, int rows_per_tile) {
  Geometry g;
  g.groups = (nbins + kTB - 1) / kTB;
  g.nbp = g.groups * kTB;
  g.nk = (hop + kBK - 1) / kBK;
  g.xstride = kBK + pad_elems<Real>();
  g.astride = g.nbp | 1;
  g.stage = rows_per_tile * (g.xstride > g.astride ? g.xstride : g.astride);
  return g;
}

template <typename Real>
size_t smem_bytes(int hop, int nbins, int rows_per_tile) {
  const Geometry g = geometry<Real>(hop, nbins, rows_per_tile);
  const size_t cx = sizeof(typename Cx<Real>::T);
  return (static_cast<size_t>(g.nk) * kBK * g.nbp
          + static_cast<size_t>(kStages) * g.stage) * cx
         + static_cast<size_t>(rows_per_tile + 2 * g.nbp) * sizeof(Real);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float fmad(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ __forceinline__ double fmad(double a, double b, double c) {
  return fma(a, b, c);
}

// acc += x · w over the two samples of a pair
template <typename C, typename P>
__device__ __forceinline__ void cmac(C& acc, const P& x, const P& w) {
  acc.x = fmad(x.a.x, w.a.x, acc.x);
  acc.y = fmad(x.a.x, w.a.y, acc.y);
  acc.x = fmad(-x.a.y, w.a.y, acc.x);
  acc.y = fmad(x.a.y, w.a.x, acc.y);
  acc.x = fmad(x.b.x, w.b.x, acc.x);
  acc.y = fmad(x.b.x, w.b.y, acc.y);
  acc.x = fmad(-x.b.y, w.b.y, acc.x);
  acc.y = fmad(x.b.y, w.b.x, acc.y);
}

struct Args {
  const void* x;        // [rows, n] complex, contiguous
  const void* basis;    // [2, hop, nbins] real (Re, Im), any strides
  const void* sgn;      // [nbins] real
  const void* weight;   // [nbins] real
  void* out;            // [rows, nh - 1] real
  long long rows, n, nh;
  long long bs_plane, bs_k, bs_b;   // the basis's strides, in elements
  int hop, nbins;
  int warps;            // warps of one bin group: H = 32·kTM·warps
  int vec16;            // 16-byte loads (else 8: complex64 rows at odd offsets)
  double size;          // t2sin_size: 2·hop or 2·hop + 1
};

__host__ __device__ __forceinline__ long long tile_count(long long rows,
                                                         long long nh,
                                                         int windows) {
  return (rows * nh - 1 + windows - 1) / windows;
}

// where tile t starts: its first half-block q0 = t·(H - 1), in row row0 at
// half-block h0
struct TileAt {
  long long t, row0, h0;
};

__device__ __forceinline__ TileAt tile_at(long long t, int windows,
                                          long long nh) {
  const long long q0 = t * windows;
  const long long row0 = q0 / nh;
  return TileAt{t, row0, q0 - row0 * nh};
}

// row and half-block of the tile's r-th half-block
__device__ __forceinline__ void locate(const TileAt& ta, int r, long long nh,
                                       long long& row, long long& h) {
  row = ta.row0;
  h = ta.h0 + r;
  while (h >= nh) {
    h -= nh;
    ++row;
  }
}

template <typename Real>
__global__ void __launch_bounds__(kMaxThreads)
t2_hop_track_kernel(const Args a) {
  using C = typename Cx<Real>::T;
  using P = Pair<Real>;
  constexpr int U = 16 / sizeof(C);      // elements a 16-byte unit
  constexpr int upr = kBK / U;           // 16-byte units a staged row
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int H = 32 * kTM * a.warps;      // half-blocks a tile
  const int T = H - 1;                   // windows a tile
  const long long tiles = tile_count(a.rows, a.nh, T);
  if (blockIdx.x >= tiles) return;

  const Geometry geo = geometry<Real>(a.hop, a.nbins, H);
  const int nbp = geo.nbp, nk = geo.nk;
  P* ws = reinterpret_cast<P*>(smem_raw);               // [nk·kBK/2][nbp]
  C* stages = reinterpret_cast<C*>(ws + nk * (kBK / 2) * nbp);
  Real* es = reinterpret_cast<Real*>(stages + kStages * geo.stage);  // [H]
  Real* sg = es + H;                                     // [nbp]
  Real* wt = sg + nbp;                                   // [nbp]

  const C* x = static_cast<const C*>(a.x);
  const Real* basis = static_cast<const Real*>(a.basis);
  const int tid = threadIdx.x;

  // the basis, resident for the launch: pair (k, k + 1) of bin b at
  // [k/2][b], zero past hop and past nbins
  for (int i = tid; i < nk * (kBK / 2) * nbp; i += blockDim.x) {
    const int kp = i / nbp, b = i - kp * nbp;
    P v;
    v.a = v.b = C{0, 0};
    if (b < a.nbins) {
      const Real* wb = basis + b * a.bs_b;
      const int k = 2 * kp;
      if (k < a.hop) {
        v.a = C{wb[k * a.bs_k], wb[a.bs_plane + k * a.bs_k]};
      }
      if (k + 1 < a.hop) {
        v.b = C{wb[(k + 1) * a.bs_k], wb[a.bs_plane + (k + 1) * a.bs_k]};
      }
    }
    ws[i] = v;
  }
  for (int i = tid; i < nbp; i += blockDim.x) {
    sg[i] = i < a.nbins ? static_cast<const Real*>(a.sgn)[i] : Real(0);
    wt[i] = i < a.nbins ? static_cast<const Real*>(a.weight)[i] : Real(0);
  }

  // stage s <- chunk kc of tile ta (one commit group), zero past the rows
  // and past hop; an empty group where the block has no such chunk
  // (a thread's units lie blockDim / per-row units rows apart: its source
  // row advances by that many half-blocks, wrapping into the next ring row)
  auto load = [&](const TileAt& ta, int kc, int s, bool real) {
    C* dst = stages + s * geo.stage;
    const int per_row = a.vec16 ? upr : kBK;     // loads a staged row
    const int step = blockDim.x / per_row;       // rows between a thread's
    const int width = a.vec16 ? U : 1;           // elements a load
    int r = tid / per_row;
    const int col = (tid - r * per_row) * width;
    const int k = kc * kBK + col;
    long long row, h;
    locate(ta, r, a.nh, row, h);
    const C* src = x + row * a.n + h * a.hop + k;
    for (; real && r < H; r += step) {
      const bool ok = row < a.rows && k < a.hop;
      if (a.vec16) {
        cp_async16(dst + r * geo.xstride + col, ok ? src : x, ok ? 16 : 0);
      } else {
        cp_async8(dst + r * geo.xstride + col, ok ? src : x, ok ? 8 : 0);
      }
      h += step;
      src += step * a.hop;
      if (h >= a.nh) {
        do {
          h -= a.nh;
          ++row;
        } while (h >= a.nh);
        src = x + row * a.n + h * a.hop + k;
      }
    }
    cp_async_commit();
  };

  // the prefetch cursor runs one chunk ahead of the compute cursor,
  // through this block's tiles blockIdx.x, + gridDim.x, ...
  TileAt pf = tile_at(blockIdx.x, T, a.nh);
  int pkc = 0;
  bool pmore = true;
  auto advance = [&](TileAt& ta, int& kc, bool& more) {
    if (++kc == nk) {
      kc = 0;
      more = ta.t + gridDim.x < tiles;
      if (more) ta = tile_at(ta.t + gridDim.x, T, a.nh);
    }
  };
  load(pf, pkc, 0, pmore);
  advance(pf, pkc, pmore);

  // warp (bin group bg, row group rg); lane l owns half-blocks
  // rg·32·kTM + 32·m + l of the tile
  const int lane = tid & 31, warp = tid >> 5;
  const int bg = warp / a.warps, rg = warp - bg * a.warps;
  const int h0 = rg * 32 * kTM + lane;
  const bool energy = bg == 0;           // uniform across the warp
  C acc[kTM][kTB];
  Real esum[kTM];
#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    esum[m] = 0;
#pragma unroll
    for (int j = 0; j < kTB; ++j) acc[m][j] = C{0, 0};
  }

  TileAt cur = tile_at(blockIdx.x, T, a.nh);
  int kc = 0;
  bool more = true;
  for (int s = 0; more; s ^= 1) {
    cp_async_wait_all();             // this chunk is in
    __syncthreads();                 // ... for every thread; the other free
    load(pf, pkc, s ^ 1, pmore);
    if (pmore) advance(pf, pkc, pmore);
    const C* xs = stages + s * geo.stage;

    const P* w = ws + kc * (kBK / 2) * nbp + bg * kTB;
    const C* xr = xs + h0 * geo.xstride;
#pragma unroll 2
    for (int p = 0; p < kBK / 2; ++p) {
      P xv[kTM];
#pragma unroll
      for (int m = 0; m < kTM; ++m) {
        xv[m] = *reinterpret_cast<const P*>(xr + 32 * m * geo.xstride + 2 * p);
      }
      if (energy) {
#pragma unroll
        for (int m = 0; m < kTM; ++m) {
          esum[m] = fmad(xv[m].a.x, xv[m].a.x, esum[m]);
          esum[m] = fmad(xv[m].a.y, xv[m].a.y, esum[m]);
          esum[m] = fmad(xv[m].b.x, xv[m].b.x, esum[m]);
          esum[m] = fmad(xv[m].b.y, xv[m].b.y, esum[m]);
        }
      }
#pragma unroll
      for (int j = 0; j < kTB; ++j) {
        const P wj = w[p * nbp + j];
#pragma unroll
        for (int m = 0; m < kTM; ++m) cmac(acc[m][j], xv[m], wj);
      }
    }

    if (kc == nk - 1) {              // the tile's last chunk: its windows
      __syncthreads();               // stage s read by all
      C* as = stages + s * geo.stage;            // A [H][astride]
#pragma unroll
      for (int m = 0; m < kTM; ++m) {
        C* dst = as + (h0 + 32 * m) * geo.astride + bg * kTB;
#pragma unroll
        for (int j = 0; j < kTB; ++j) {
          dst[j] = acc[m][j];
          acc[m][j] = C{0, 0};
        }
        if (energy) {
          es[h0 + 32 * m] = esum[m];
          esum[m] = 0;
        }
      }
      __syncthreads();
      Real* out = static_cast<Real*>(a.out);
      for (int w = tid; w < T; w += blockDim.x) {
        long long row, h;
        locate(cur, w, a.nh, row, h);
        if (row >= a.rows || h >= a.nh - 1) continue;   // no second half
        const C* u0 = as + w * geo.astride;
        const C* u1 = u0 + geo.astride;
        Real m = 0;
        for (int b = 0; b < a.nbins; ++b) {
          const Real sr = fmad(sg[b], u1[b].x, u0[b].x);
          const Real si = fmad(sg[b], u1[b].y, u0[b].y);
          m = fmad(wt[b], fmad(sr, sr, si * si), m);
        }
        const Real total = static_cast<Real>(a.size) * (es[w] + es[w + 1]);
        const Real tiny = static_cast<Real>(1e-30);
        out[row * (a.nh - 1) + h] =
            total > 0 ? m / (total > tiny ? total : tiny) : Real(0);
      }
    }
    advance(cur, kc, more);
  }
  cp_async_wait_all();               // no copy outlives the block
}

// warps a bin group (a tile is 32·kTM·warps half-blocks): kTileRows
// half-blocks, halved while the threads or the device's shared memory
// would not hold them; the kernel's dynamic shared memory limit set to the
// device's; the blocks of that launch the card holds at once
template <typename Real>
int prepare(int hop, int nbins, int* warps, int* resident) {
  int dev = 0, optin = 0, sms = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaFuncGetAttributes(&fa, t2_hop_track_kernel<Real>);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t limit = static_cast<size_t>(optin - fa.sharedSizeBytes);
  const int groups = (nbins + kTB - 1) / kTB;
  const int most = fa.maxThreadsPerBlock < kMaxThreads ? fa.maxThreadsPerBlock
                                                       : kMaxThreads;
  auto fits = [&](int w) {
    return 32 * w * groups <= most &&
           smem_bytes<Real>(hop, nbins, 32 * kTM * w) <= limit;
  };
  int w = kTileRows / (32 * kTM);
  while (w > 1 && !fits(w)) w /= 2;
  if (!fits(w)) return static_cast<int>(cudaErrorInvalidConfiguration);
  int per_sm = 0;
  e = cudaFuncSetAttribute(t2_hop_track_kernel<Real>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(limit));
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, t2_hop_track_kernel<Real>, 32 * w * groups,
        smem_bytes<Real>(hop, nbins, 32 * kTM * w));
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *warps = w;
  *resident = per_sm * sms;
  return 0;
}

template <typename Real>
void launch(const Args& a, int resident, cudaStream_t st) {
  const int rows = 32 * kTM * a.warps;
  const int groups = geometry<Real>(a.hop, a.nbins, rows).groups;
  const int threads = 32 * a.warps * groups;
  const long long tiles = tile_count(a.rows, a.nh, rows - 1);
  const unsigned grid = static_cast<unsigned>(tiles < resident ? tiles
                                                               : resident);
  t2_hop_track_kernel<Real><<<grid, threads,
                              smem_bytes<Real>(a.hop, a.nbins, rows), st>>>(a);
}

}  // namespace

// The launch's set-up, once per process, device and (hop, nbins, real
// type): the warps a bin group, the kernel's shared memory limit, and the
// blocks the card holds at once.
extern "C" int c_ofdm_hop_prepare(int hop, int nbins, int real_bytes,
                                  int* warps, int* resident) {
  if (hop <= 0 || nbins <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (real_bytes == 4) return prepare<float>(hop, nbins, warps, resident);
  if (real_bytes == 8) return prepare<double>(hop, nbins, warps, resident);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int c_ofdm_hop_track(const void* x, const void* basis,
                                long long bs_plane, long long bs_k,
                                long long bs_b, const void* sgn,
                                const void* weight, void* out,
                                long long rows, long long n, int hop,
                                int nbins, int warps, int resident,
                                int real_bytes, int size, void* stream) {
  // 16-byte loads where each staged unit of two complex64 samples starts
  // on 16 bytes (complex128: always)
  const bool vec16 = real_bytes == 8 ||
                     (hop % 2 == 0 && n % 2 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0);
  Args a{x, basis, sgn, weight, out, rows, n, hop > 0 ? n / hop : 0,
         bs_plane, bs_k, bs_b, hop, nbins, warps, vec16 ? 1 : 0,
         static_cast<double>(size)};
  if (rows <= 0 || hop <= 0 || nbins <= 0 || a.nh < 2 || warps < 1 ||
      resident < 1 || size / 2 != hop ||
      (real_bytes != 4 && real_bytes != 8)) {
    return kRefusedShape;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (real_bytes == 4) {
    launch<float>(a, resident, st);
  } else {
    launch<double>(a, resident, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* c_ofdm_hop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

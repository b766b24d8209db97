// Row FFT with the four-step outer twiddle at load and a transposed store:
// [b, R, n] -> [b, n, R], planar float32 or interleaved complex64.
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/pallas_fft.py::_fft_rows_t_core
// (its pl.pallas_call over _kernel_rows_t_bal and _kernel_rows_t) for pow2
// n = 2^7 .. 2^14.  Row r of each plane is first multiplied by
// w^(r*m) = exp(sign * 2*pi*i * r*m / outer_n) when an outer table is given,
// then transformed, and stored transposed:
//
//     out[b, k, r] = scale * sum_m w^(r*m) x[b, r, m] exp(sign*2*pi*i*k*m/n)
//
// This is pass 2 of the four-step (ops/fourstep.py): with R = n1 rows of
// n2 points and outer_n = n1*n2, the output viewed flat is the natural-order
// transform of length n1*n2.  Two layouts: planar (re, im) float32 planes
// (rows_t_fft_f32) or interleaved complex64, one 8-byte pair a point
// (rows_t_fft_c64, a torch complex64 tensor as it lies, so the complex64
// four-step needs no split and no merge).
//
// What bounds it: device memory, 16 bytes a point read and written (1024 x
// 4096 needs 0.0200 ms at the H100's 3.35 TB/s).  So every intermediate stays
// on chip, and the design removes what stands in the way:
//
// * The passes.  They are mixed_fft.cuh's on the plan compiled in for each
//   n (plan_fft; 4096 = 16*16*16: three radix-16 passes, one barrier each),
//   with each pass's twiddles in a table of its own read by consecutive
//   lanes (the host's ops/cuda_fft.py::_pass_roots_np), both signs compiled:
//   n/16 threads a row, 16 points a thread in every pass, the row in shared
//   memory as padded interleaved pairs (PadShared).  The kernel runs the
//   plan's first pass itself (first_pass below): it reads the row from
//   device memory through the layout's source (GlobalIn or C64In) and
//   multiplies each point by its outer root in registers before the
//   butterfly; plan_fft<SIGN, LOG2N, 1> runs the rest, the last pass into
//   the row's shared buffer.
// * The outer twiddle.  Its exponent e = (r*m) mod outer_n is carried in
//   integer adds: thread t of the first pass loads m = t + (b + k*B)*T for
//   its B butterflies b and their R points k, so e steps by (r*T) mod
//   outer_n along b and by (r*B*T) mod outer_n along k, each computed once,
//   and drops by outer_n at most once a step; no division per point.  The
//   root is a product of two float32 roots generated in float64, w^e =
//   hi[e >> S] * lo[e & (2^S - 1)] with hi[q] = w^(q*2^S) and lo[t] = w^t
//   (S = ceil(log2(outer_n)/2), at most 12), so the tables hold about
//   2*sqrt(outer_n) entries (two of 2^11 at outer_n = 2^22) and serve any
//   outer_n, pow2 or not.  lo is staged in shared memory; hi is read through
//   the read-only cache, where the lanes of a warp mostly share an entry.
// * The transposed store.  A cluster of C blocks on neighbouring row tiles
//   holds CT = kRowsTCluster rows (8) and stores them together: block b
//   writes outputs k in [b*n/C, (b+1)*n/C) of all CT rows, reading its
//   peers' rows through distributed shared memory, so every run of the
//   [n, R] store is CT consecutive points (32 bytes of each plane, 64 of
//   complex64 pairs).  The global row index still comes from the block's
//   place in the grid, so a row's twiddle never depends on the tiling.
//   Where a block holds several rows, they lie kLd pairs apart, so that the
//   16 lanes of a half-warp (16 / CT consecutive outputs of each row) read
//   distinct banks.
// * The block's shape, by measurement (rows_t_rows; the variants of
//   scripts/time_pow2_variants.py --lib rows_t_fft).  The fewer blocks a
//   cluster, the less of the store crosses distributed shared memory: a
//   block holds all 8 rows of its tile up to n = 2048 (one block, no
//   cluster; 8 rows of 2048 points are 139 KB in 1024 threads) and 4 rows
//   at 4096 (a cluster of 2, one block an SM), which beat one row of 4096
//   a block in 256 threads, three blocks an SM in clusters of 8 whose loads
//   and passes overlap each other's stores.  From 8192 on a block holds
//   one row in 512 or 1024 threads, a cluster of 8.  Each n has its own
//   launch bound (RowsTShape, as RowsShape).
//
// Rows past R (a ragged last tile) read row 0 and are not stored.  The
// output must not alias the input: a block's store writes other rows'
// points.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "mixed_fft.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace fftk;

constexpr int kMaxLoBits = 12;     // lo holds at most 4096 roots (32 KB)
constexpr int kRowsTCluster = 8;   // rows a cluster stores together

// Rows a block (one per threadIdx.y) at `threads` threads a row: one row
// from n = 8192 on; below, as many of the cluster's kRowsTCluster rows as
// 1024 threads hold (4 at n = 4096, all 8 from 2048 down, so that one block
// is its own cluster) and at least 128 threads.  The fastest of the shapes
// scripts/time_pow2_variants.py --lib rows_t_fft times (PERF.md): at 4096,
// one row a block in a cluster of 8 took 9% longer through the complex64
// entry, at 2048 34%.
__host__ __device__ constexpr int rows_t_rows(int threads) {
  return threads >= 512 ? 1
         : 128 / threads > kRowsTCluster ? 128 / threads
         : 1024 / threads < kRowsTCluster ? 1024 / threads
                                          : kRowsTCluster;
}

// The launch shape at n = 2^LOG2N: threads a row (16 points each), rows a
// block, blocks a cluster (kRowsTCluster rows), and the blocks an SM that
// the launch bound asks registers for (RowsShape's: up to 80 a thread for
// blocks of 128 and 256 threads, 64 above).
template <int LOG2N>
struct RowsTShape {
  static constexpr int kN = 1 << LOG2N;
  static constexpr int kThreads = kN / 16;
  static constexpr int kRows = rows_t_rows(kThreads);
  static constexpr int kBlock = kThreads * kRows;
  static constexpr int kC = kRows >= kRowsTCluster ? 1 : kRowsTCluster / kRows;
  static constexpr int kCT = kC * kRows;  // rows a cluster
  static constexpr int kMinBlocks = kBlock <= 128 ? 6 : kBlock == 256 ? 3 : 1024 / kBlock;
  static constexpr int kLd = padded_len(kN) + (kRows > 1 ? 16 / kCT : 0);  // pairs a row
  static constexpr int kRowPairs = kRows * kLd;
  static_assert(kBlock % kCT == 0, "the store's threads cover the cluster's rows evenly");
};

struct RowsTArgs {
  const float* in_re;  // planar layout
  const float* in_im;
  float* out_re;
  float* out_im;
  const float2* in;  // interleaved layout
  float2* out;
  const float2* tw;  // _pass_roots_np(n, sign)
  const float2* hi;  // w^(q*2^S), q < ceil(outer_n / 2^S); null: no twiddle
  const float2* lo;  // w^t, t < 2^S
  unsigned long long outer_n;
  int lo_bits;       // S
  long long rows;
  long long tiles;   // row tiles of a plane, CT rows each
  float scale;
};

// This thread's row (one per threadIdx.y) in the block's shared memory: the
// buffer of the passes after the first, and the last pass's sink.
template <int LOG2N>
struct RowsTRow {
  __device__ __forceinline__ PadShared shared() const {
    extern __shared__ float2 smem[];
    return PadShared{smem + threadIdx.y * RowsTShape<LOG2N>::kLd};
  }
  __device__ __forceinline__ PadShared dst() const { return shared(); }
};

// The plan's first pass (radix R at NS = 1, no pass twiddles) of row r:
// butterfly j = t + b*T (b < B) reads x[j + k*M] (k < R, M = N/R) through
// `src`, multiplies point m = t + (b + k*B)*T by w^((r*m) mod outer_n) in
// registers, takes the R-point DFT and writes output k to the row's buffer
// at j*R + k.  The exponent starts at (r*t) mod outer_n and steps by
// d = (r*T) mod outer_n along b and by (r*M) mod outer_n along k.  E is the
// exponent's integer type: 32 bits where outer_n < 2^31.
template <int SIGN, int N, int R, class E, class Src>
__device__ __forceinline__ void first_pass(const Src& src, const PadShared& dst,
                                           const RowsTArgs& g, unsigned long long r,
                                           const float2* lo) {
  constexpr int T = N / 16;
  constexpr int M = N / R;
  constexpr int B = M / T;
  static_assert(B * T == M, "butterflies must split evenly over threads");
  const int t = static_cast<int>(threadIdx.x);
  const bool twiddle = g.hi != nullptr;
  const unsigned long long on64 = g.outer_n;
  const E on = static_cast<E>(on64);
  const E d = static_cast<E>(twiddle ? r * T % on64 : 0);
  const E dk = static_cast<E>(twiddle ? r * M % on64 : 0);
  const E mask = (static_cast<E>(1) << g.lo_bits) - 1;
  E eb = static_cast<E>(twiddle ? r * t % on64 : 0);
  float ar[B][R], ai[B][R];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = t + b * T;
    E e = eb;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      src.load(j + k * M, ar[b][k], ai[b][k]);
      if (twiddle) {
        float2 w = __ldg(&g.hi[e >> g.lo_bits]);
        cmul(w.x, w.y, lo[e & mask]);
        cmul(ar[b][k], ai[b][k], w);
        e += dk;
        if (e >= on) e -= on;
      }
    }
    eb += d;
    if (eb >= on) eb -= on;
    dft<R, SIGN>(ar[b], ai[b]);
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = t + b * T;
#pragma unroll
    for (int k = 0; k < R; ++k) dst.store(j * R + k, ar[b][k], ai[b][k]);
  }
  __syncthreads();
}

template <int SIGN, int LOG2N, bool C64>
__global__ void __launch_bounds__(RowsTShape<LOG2N>::kBlock, RowsTShape<LOG2N>::kMinBlocks)
rows_t_fft_kernel(const __grid_constant__ RowsTArgs g) {
  using S = RowsTShape<LOG2N>;
  constexpr int N = S::kN;
  constexpr int C = S::kC;
  constexpr int CT = S::kCT;
  extern __shared__ float2 smem[];
  float2* lo = smem + S::kRowPairs;
  cg::cluster_group cluster = cg::this_cluster();
  const int cb = C > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const long long cid = blockIdx.x / C;
  const long long plane = cid / g.tiles;
  const long long rc0 = (cid % g.tiles) * CT;  // the cluster's first row
  const long long r = rc0 + cb * S::kRows + threadIdx.y;
  const bool valid = r < g.rows;
  const size_t off = (static_cast<size_t>(plane) * g.rows + (valid ? r : 0)) * N;
  const int flat = static_cast<int>(threadIdx.y * S::kThreads + threadIdx.x);
  if (g.hi != nullptr) {
    for (int t = flat; t < (1 << g.lo_bits); t += S::kBlock) lo[t] = __ldg(&g.lo[t]);
    __syncthreads();
  }
  const RowsTRow<LOG2N> row{};
  const auto rr = static_cast<unsigned long long>(valid ? r : 0);
  constexpr int R0 = plan_radix(LOG2N, 0);
  const auto first = [&](const auto& src) {
    if (g.outer_n < (1ull << 31)) {
      first_pass<SIGN, N, R0, unsigned>(src, row.shared(), g, rr, lo);
    } else {
      first_pass<SIGN, N, R0, unsigned long long>(src, row.shared(), g, rr, lo);
    }
  };
  if constexpr (C64) {
    first(C64In{g.in + off});
  } else {
    first(GlobalIn{g.in_re + off, g.in_im + off});
  }
  plan_fft<SIGN, LOG2N, 1>(row, g.tw);  // its last pass ends in a block barrier
  // block cb stores outputs [cb*N/C, (cb+1)*N/C) of the cluster's CT rows,
  // thread flat row t = flat % CT; a block alone in its cluster reads its
  // own rows through shared-memory pointers, not the cluster's generic ones
  const int t = flat % CT;
  float2* p = smem + (t % S::kRows) * S::kLd;
  if constexpr (C > 1) {
    cluster.sync();  // every block's rows are transformed
    p = cluster.map_shared_rank(p, t / S::kRows);
  }
  const bool out = rc0 + t < g.rows;
  constexpr int kStep = S::kBlock / CT;
  constexpr int kIters = N / C / kStep;
  const int k0 = cb * (N / C) + flat / CT;
  const size_t base = static_cast<size_t>(plane) * N * g.rows + rc0 + t;
  float2 v[kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i) v[i] = p[padded(k0 + i * kStep)];
  if (out) {
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const size_t o = base + static_cast<size_t>(k0 + i * kStep) * g.rows;
      if constexpr (C64) {
        g.out[o] = make_float2(v[i].x * g.scale, v[i].y * g.scale);
      } else {
        g.out_re[o] = v[i].x * g.scale;
        g.out_im[o] = v[i].y * g.scale;
      }
    }
  }
  if constexpr (C > 1) cluster.sync();  // no block exits while another reads its rows
}

template <int LOG2N, bool C64>
cudaError_t launch(int sign, RowsTArgs g, long long planes, cudaStream_t stream) {
  using S = RowsTShape<LOG2N>;
  constexpr int kSmemMax = (S::kRowPairs + (1 << kMaxLoBits)) * static_cast<int>(sizeof(float2));
  const int smem = (S::kRowPairs + (g.hi != nullptr ? 1 << g.lo_bits : 0)) *
                   static_cast<int>(sizeof(float2));
  g.tiles = (g.rows + S::kCT - 1) / S::kCT;
  if (planes * g.tiles * S::kC > 2147483647LL) return cudaErrorInvalidValue;
  void (*kernel)(RowsTArgs) = sign < 0 ? rows_t_fft_kernel<-1, LOG2N, C64>
                                       : rows_t_fft_kernel<1, LOG2N, C64>;
  cudaError_t e = cudaSuccess;
  if constexpr (kSmemMax > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
  }
  if constexpr (S::kC > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S::kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(planes * g.tiles * S::kC));
  cfg.blockDim = dim3(S::kThreads, S::kRows);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, g);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool C64>
int dispatch(RowsTArgs g, long long outer_n, int lo_bits, long long planes, int log2n,
             int sign, void* stream) {
  if (planes < 1 || g.rows < 1 || (sign != 1 && sign != -1) ||
      (g.hi != nullptr && (outer_n < 1 || g.lo == nullptr || lo_bits < 0 ||
                           lo_bits > kMaxLoBits))) {
    return cudaErrorInvalidValue;
  }
  g.outer_n = static_cast<unsigned long long>(g.hi != nullptr ? outer_n : 1);
  g.lo_bits = g.hi != nullptr ? lo_bits : 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (log2n) {
    case 7: return launch<7, C64>(sign, g, planes, s);
    case 8: return launch<8, C64>(sign, g, planes, s);
    case 9: return launch<9, C64>(sign, g, planes, s);
    case 10: return launch<10, C64>(sign, g, planes, s);
    case 11: return launch<11, C64>(sign, g, planes, s);
    case 12: return launch<12, C64>(sign, g, planes, s);
    case 13: return launch<13, C64>(sign, g, planes, s);
    case 14: return launch<14, C64>(sign, g, planes, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Transforms the `rows` rows of n = 2^log2n points of each of `planes`
// contiguous [rows, n] planes and stores each plane as [n, rows], planar
// float32.  tw holds the roots of exp(sign*2pi*i/n) that the passes of n's
// plan read (_pass_roots_np: interleaved (cos, sin) float32 pairs).  With the
// outer twiddle, hi and lo hold the two tables of w = exp(sign*2pi*i/outer_n):
// lo[t] = w^t for t < 2^lo_bits and hi[q] = w^(q*2^lo_bits) for q <
// ceil(outer_n / 2^lo_bits) (lo_bits <= 12); hi = null for none.  The output
// must not alias the input.  Launches on `stream` and returns the launch's
// error (0 = ok).
int rows_t_fft_f32(const void* in_re, const void* in_im, void* out_re,
                   void* out_im, const void* tw, const void* hi, const void* lo,
                   long long outer_n, int lo_bits, long long planes, long long rows,
                   int log2n, int sign, float scale, void* stream) {
  const RowsTArgs g{static_cast<const float*>(in_re), static_cast<const float*>(in_im),
                    static_cast<float*>(out_re), static_cast<float*>(out_im), nullptr,
                    nullptr, static_cast<const float2*>(tw), static_cast<const float2*>(hi),
                    static_cast<const float2*>(lo), 1, 0, rows, 0, scale};
  return dispatch<false>(g, outer_n, lo_bits, planes, log2n, sign, stream);
}

// The same over interleaved complex64: (re, im) float32 pairs, 8-byte
// aligned, [planes, rows, n] in and [planes, n, rows] out.
int rows_t_fft_c64(const void* in, void* out, const void* tw, const void* hi, const void* lo,
                   long long outer_n, int lo_bits, long long planes, long long rows,
                   int log2n, int sign, float scale, void* stream) {
  const RowsTArgs g{nullptr, nullptr, nullptr, nullptr, static_cast<const float2*>(in),
                    static_cast<float2*>(out), static_cast<const float2*>(tw),
                    static_cast<const float2*>(hi), static_cast<const float2*>(lo), 1, 0,
                    rows, 0, scale};
  return dispatch<true>(g, outer_n, lo_bits, planes, log2n, sign, stream);
}

const char* rows_t_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

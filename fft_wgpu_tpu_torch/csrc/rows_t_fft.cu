// Row FFT with the four-step outer twiddle at load and a transposed store:
// [b, R, n] -> [b, n, R].
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/pallas_fft.py::_fft_rows_t_core
// (its pl.pallas_call over _kernel_rows_t_bal and _kernel_rows_t) for pow2
// n = 2^7 .. 2^14.  Row r of each plane is first multiplied by
// w^(r*m) = exp(sign * 2*pi*i * r*m / outer_n) when an outer table is given,
// then transformed as by the row kernel, and stored transposed:
//
//     out[b, k, r] = scale * sum_m w^(r*m) x[b, r, m] exp(sign*2*pi*i*k*m/n)
//
// This is pass 2 of the four-step (ops/fourstep.py): with R = n1 rows of
// n2 points and outer_n = n1*n2, the output viewed flat is the natural-order
// transform of length n1*n2.
//
// What bounds it: device memory, 16 bytes per point read and written.  Two
// things stand in the way, and the design removes both:
//
// * The outer twiddle.  Its exponent e = (r*m) mod outer_n is carried in
//   integer adds: thread t of the first pass loads m = t + s*T, so e steps
//   by (r*T) mod outer_n, computed once, and drops by outer_n at most once a
//   step; no division per point.  The root is a product of two float32
//   roots generated in float64, w^e = hi[e >> S] * lo[e & (2^S - 1)] with
//   hi[q] = w^(q*2^S) and lo[t] = w^t (S = ceil(log2(outer_n)/2), at most
//   12), so the tables hold about 2*sqrt(outer_n) entries (two of 2^11 at
//   outer_n = 2^22) and serve any outer_n, pow2 or not.  lo is staged in
//   shared memory; hi is read through the read-only cache, where the lanes
//   of a warp mostly share an entry.  A product of two rounded roots errs by
//   about 1.2e-7.
// * The transposed store.  A block holds TR rows (TR*n*8 bytes <= 128 KB +
//   padding: TR = 8 up to n = 2048, 4 at 4096, 1 at 16384).  Where TR < 8, a
//   cluster of C = 8/TR blocks on neighbouring row tiles stores together:
//   block b writes outputs k in [b*n/C, (b+1)*n/C) of all the cluster's
//   C*TR rows, reading its peers' rows through distributed shared memory,
//   so every run of the [n, R] store is 8 contiguous floats (one 32-byte
//   sector).  The global row index still comes from the block's place in
//   the grid, so a row's twiddle never depends on the tiling.
//
// The first pass reads each row from device memory with the twiddle
// applied, the passes run in shared memory (stockham.cuh), and the tile is
// stored transposed with the scale folded in, from a buffer padded by one
// float per row so the transposing read hits distinct banks.  Rows past R
// (a ragged last tile) load zeros and are not stored.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "stockham.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace fftk;

constexpr int kMaxLoBits = 12;  // lo holds at most 4096 roots (32 KB)

// Rows per block: at most 2^17 bytes of rows, and at most 8 rows.
__host__ __device__ constexpr int rows_t_rows(int log2n) {
  return min_int(8, (1 << 17) / (8 << log2n) > 0 ? (1 << 17) / (8 << log2n) : 1);
}

// Threads per row: at most 1024 per block.
__host__ __device__ constexpr int rows_t_threads(int log2n) {
  return min_int(threads_for(log2n), 1024 / rows_t_rows(log2n));
}

struct RowsTArgs {
  const float* in_re;
  const float* in_im;
  float* out_re;
  float* out_im;
  const float2* tw;
  const float2* hi;  // w^(q*2^S), q < ceil(outer_n / 2^S); null: no twiddle
  const float2* lo;  // w^t, t < 2^S
  unsigned long long outer_n;
  int lo_bits;       // S
  long long rows;
  long long tiles;   // row tiles of a plane, C*TR rows each
  float sign;
  float scale;
};

// The first pass (radix R = 2 or 4, NS = 1) of row r, read from device
// memory with the outer twiddle, into the row's shared buffer.  Butterfly j
// = t + b*T reads x[j + k*M], that is m = t + (b + k*B)*T, so the exponent
// (r*m) mod outer_n starts at (r*t) mod outer_n and steps by d = (r*T) mod
// outer_n along b and by (B*d) mod outer_n along k.
// E is the exponent's integer type: 32 bits where outer_n < 2^31.
template <int N, int T, int R, class E>
__device__ __forceinline__ void first_pass(const RowsTArgs& a, size_t off, bool valid,
                                           unsigned long long r, const float2* lo,
                                           const Shared& s) {
  constexpr int M = N / R;
  constexpr int B = M / T;
  static_assert(B * T == M, "butterflies must split evenly over threads");
  const unsigned long long on64 = a.outer_n;
  const E on = static_cast<E>(on64);
  const bool twiddle = a.hi != nullptr;
  const E d = static_cast<E>(twiddle ? r * T % on64 : 0);
  const E dk = static_cast<E>(twiddle ? r * M % on64 : 0);
  const E mask = (static_cast<E>(1) << a.lo_bits) - 1;
  E eb = static_cast<E>(twiddle ? r * threadIdx.x % on64 : 0);
  float ar[B][R], ai[B][R];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = threadIdx.x + b * T;
    E e = eb;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      ar[b][k] = valid ? a.in_re[off + j + k * M] : 0.f;
      ai[b][k] = valid ? a.in_im[off + j + k * M] : 0.f;
      if (twiddle) {
        float2 w = __ldg(&a.hi[e >> a.lo_bits]);
        cmul(w.x, w.y, lo[e & mask]);
        cmul(ar[b][k], ai[b][k], w);
        e += dk;
        if (e >= on) e -= on;
      }
    }
    eb += d;
    if (eb >= on) eb -= on;
    if constexpr (R == 4) {
      dft4(ar[b], ai[b], a.sign);
    } else {
      dft2(ar[b], ai[b]);
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = threadIdx.x + b * T;
#pragma unroll
    for (int k = 0; k < R; ++k) s.store(j * R + k, ar[b][k], ai[b][k]);
  }
  __syncthreads();
}

template <int LOG2N>
__global__ void __launch_bounds__(1024)
rows_t_fft_kernel(const __grid_constant__ RowsTArgs a) {
  constexpr int N = 1 << LOG2N;
  constexpr int TR = rows_t_rows(LOG2N);
  constexpr int T = rows_t_threads(LOG2N);
  constexpr int LD = N + 1;
  constexpr int C = 8 / TR;  // blocks a cluster, as launched
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = smem + TR * LD;
  float2* lo = reinterpret_cast<float2*>(smem + 2 * TR * LD);  // 2*TR*LD is even
  cg::cluster_group cluster = cg::this_cluster();
  const int cb = C > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const long long cid = blockIdx.x / C;
  const long long plane = cid / a.tiles;
  const long long rc0 = (cid % a.tiles) * C * TR;  // the cluster's first row
  const long long r = rc0 + cb * TR + threadIdx.y;
  const bool valid = r < a.rows;
  const size_t off = (static_cast<size_t>(plane) * a.rows + (valid ? r : 0)) * N;
  const int flat = threadIdx.y * T + threadIdx.x;
  if (a.hi != nullptr) {
    for (int t = flat; t < (1 << a.lo_bits); t += T * TR) lo[t] = __ldg(&a.lo[t]);
    __syncthreads();
  }
  const Shared row{sr + threadIdx.y * LD, si + threadIdx.y * LD};
  const auto rr = static_cast<unsigned long long>(valid ? r : 0);
  constexpr int R0 = LOG2N & 1 ? 2 : 4;
  if (a.outer_n < (1ull << 31)) {
    first_pass<N, T, R0, unsigned>(a, off, valid, rr, lo, row);
  } else {
    first_pass<N, T, R0, unsigned long long>(a, off, valid, rr, lo, row);
  }
  radix4_passes<N, T, R0, 1>(row, row, row, a.tw, a.sign);
  // block cb stores outputs [cb*N/C, (cb+1)*N/C) of the cluster's CT rows;
  // a block alone in its cluster reads its own rows through shared-memory
  // pointers, not the cluster's generic ones
  const int CT = C * TR;
  const int t = flat % CT;
  const float* pr = sr + (t % TR) * LD;
  const float* pi = si + (t % TR) * LD;
  if constexpr (C > 1) {
    cluster.sync();  // every block's rows are transformed
    pr = cluster.map_shared_rank(sr, t / TR) + (t % TR) * LD;
    pi = cluster.map_shared_rank(si, t / TR) + (t % TR) * LD;
  } else {
    __syncthreads();
  }
  const bool out = rc0 + t < a.rows;
  const int step = T * TR / CT;
  const size_t base = static_cast<size_t>(plane) * N * a.rows + rc0 + t;
  for (int k = cb * (N / C) + flat / CT; k < (cb + 1) * (N / C); k += step) {
    if (out) {
      const size_t g = base + static_cast<size_t>(k) * a.rows;
      a.out_re[g] = pr[k] * a.scale;
      a.out_im[g] = pi[k] * a.scale;
    }
  }
  if constexpr (C > 1) cluster.sync();  // no block exits while another reads its rows
}

template <int LOG2N>
cudaError_t launch(RowsTArgs a, long long planes, cudaStream_t stream) {
  constexpr int TR = rows_t_rows(LOG2N);
  constexpr int C = 8 / TR;  // blocks whose TR rows make runs of 8 floats
  const int smem = 2 * TR * ((1 << LOG2N) + 1) * static_cast<int>(sizeof(float)) +
                   (a.hi != nullptr ? (1 << a.lo_bits) * static_cast<int>(sizeof(float2)) : 0);
  a.tiles = (a.rows + C * TR - 1) / (C * TR);
  if (planes * a.tiles * C > 2147483647LL) return cudaErrorInvalidValue;
  auto* kernel = rows_t_fft_kernel<LOG2N>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(planes * a.tiles * C));
  cfg.blockDim = dim3(rows_t_threads(LOG2N), TR);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Transforms the `rows` rows of n = 2^log2n points of each of `planes`
// contiguous [rows, n] planes and stores each plane as [n, rows], planar
// float32.  tw holds n interleaved (cos, sin) float32 pairs of
// exp(sign*2pi*i*k/n).  With the outer twiddle, hi and lo hold the two
// tables of w = exp(sign*2pi*i/outer_n): lo[t] = w^t for t < 2^lo_bits and
// hi[q] = w^(q*2^lo_bits) for q < ceil(outer_n / 2^lo_bits) (lo_bits <=
// 12); hi = null for none.  The output must not alias the input.
// Launches on `stream` and returns the launch's error (0 = ok).
int rows_t_fft_f32(const void* in_re, const void* in_im, void* out_re,
                   void* out_im, const void* tw, const void* hi, const void* lo,
                   long long outer_n, int lo_bits, long long planes, long long rows,
                   int log2n, int sign, float scale, void* stream) {
  if (planes < 1 || rows < 1 || (sign != 1 && sign != -1) ||
      (hi != nullptr && (outer_n < 1 || lo == nullptr || lo_bits < 0 ||
                         lo_bits > kMaxLoBits))) {
    return cudaErrorInvalidValue;
  }
  const RowsTArgs a{static_cast<const float*>(in_re), static_cast<const float*>(in_im),
                    static_cast<float*>(out_re), static_cast<float*>(out_im),
                    static_cast<const float2*>(tw), static_cast<const float2*>(hi),
                    static_cast<const float2*>(lo),
                    static_cast<unsigned long long>(hi != nullptr ? outer_n : 1),
                    hi != nullptr ? lo_bits : 0, rows, 0,
                    static_cast<float>(sign), scale};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (log2n) {
#define ROWS_T_CASE(L) \
  case L:              \
    return launch<L>(a, planes, s);
    ROWS_T_CASE(7) ROWS_T_CASE(8) ROWS_T_CASE(9) ROWS_T_CASE(10)
    ROWS_T_CASE(11) ROWS_T_CASE(12) ROWS_T_CASE(13) ROWS_T_CASE(14)
#undef ROWS_T_CASE
    default: return cudaErrorInvalidValue;
  }
}

const char* rows_t_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

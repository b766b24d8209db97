// Fused segment-spectrum kernels: frame, detrend, window, FFT and the power
// or cross products of every segment of a signal in one pass, summed over
// segments.
//
// Replaces two TPU kernels of fft_wgpu_tpu/ops/pallas_welch.py:
//   csd_accum_f32   (B17)  csd_accum_split, kernel _kernel_csd_accum
//   welch_c2c_f32   (B21)  welch_accum_c2c_split, kernel _kernel_welch_accum_c2c
// (B16 and B18, welch_accum_split and coherence_accum_split, are
// welch_acc_fft.cu; B19 and B20, spec_psd_split and spec_rfft_split, the
// per-segment powers and half spectra, are spec_fft.cu; B22,
// spec_c2c_split, the per-segment two-sided spectra, is spec_c2c_fft.cu.)
//
// Segment s of a row x of t points (s = 0 .. num-1, num = 1 + (t -
// nperseg) / hop) is the frame of nfft points
//
//     f_s[j] = (x[s*hop + j] - mean_s) * w[j]   for j < nperseg,
//     f_s[j] = 0                                for nperseg <= j < nfft,
//
// mean_s the mean of x[s*hop .. s*hop + nperseg) when detrend is "constant",
// else 0.  For a real row
// its half spectrum X_s[k], k = 0 .. nfft/2, is B6's (r2c_fft.cu): the
// first Stockham pass reads the frame as m = nfft/2 complex points f[2j]
// + i f[2j+1] (FramedRealIn), the m-point transform runs in shared memory
// (stockham.cuh) and the bins are recombined from Z[k] and Z[m-k].  For a
// complex row (B21, planes x = re and y = im, each framed and detrended
// on its own) the first pass reads the nfft complex
// points (FramedComplexIn) and X_s is the full nfft-point spectrum, B1's
// transform (rows_fft.cu).  Then, per bin:
//   B17  sum_s conj(X_s) Y_s of two real signals of one shape (two rows);
//   B21  sum_s |X_s|^2 over all nfft bins of a complex signal.
//
// Grid: one block per (signal row b, tile of S consecutive segments); the
// block loops over its S segments, and the loop bounds are the same for
// every thread, so a ragged last tile needs no mask and every thread meets
// every barrier.  welch_tiles picks S from the kernel's occupancy so that
// the grid is at least two waves of the card's SMs.  The frame is read
// straight from the signal at offset s*hop, so any hop <= nperseg and any
// nperseg <= nfft run: the TPU's chunk view needed hop | nperseg and
// nperseg/hop <= 8.  The segment means are tree reductions in shared
// memory before the first pass reads the frame.  The sums over segments
// are registers, a fixed thread per bin (bin k = threadIdx.x + i*T); each
// block writes its partial sums to its own row of [batch, tiles, bins] and
// the caller sums the tiles with torch.sum: a fixed order and no float
// atomics, so a run gives the same bits every time.
//
// What bounds it: per segment about 2.5*nfft*log2(nfft) flops for a real
// frame (5*nfft*log2(nfft) for a complex one) against 4*hop (8*hop) bytes
// of new signal, so at half overlap and nfft = 4096 every kind is set by
// the bytes it must move.  On the H100 the kernels run many times those
// bounds (PERF.md): per segment a block reads its frame twice (the mean, then the first pass; overlapping
// frames come again from L2) and crosses about 20 barriers, and at nfft =
// 256 a block is one warp, so latency, not bytes or flops, sets the time.
// The design keeps a block's shared rows and accumulators across its S
// segments.

#include <cuda_runtime.h>

#include "stockham.cuh"

namespace {

using namespace fftk;

// the kinds' numbers in welch_tiles (ops/cuda_welch.py::_KERNELS)
enum Kind { kCsd = 2, kC2c = 4 };

// Shape of kernel KIND at nfft = 2^LOG2N: the real kinds transform the
// half-length row of nfft/2 points (B6's packing), the complex kinds the
// whole row; two-signal kinds hold two rows.
template <int LOG2N, int KIND>
struct Geom {
  static constexpr bool kReal = KIND != kC2c;
  static constexpr bool kTwo = KIND == kCsd;
  static constexpr int kLog2Row = kReal ? LOG2N - 1 : LOG2N;
  static constexpr int kRow = 1 << kLog2Row;
  static constexpr int kThreads = threads_for(kLog2Row);
  static constexpr int kBins = kReal ? kRow + 1 : kRow;
  static constexpr int kPlanes = kReal ? 1 : 2;  // frames a segment's mean covers
  static constexpr int kRed = kPlanes * kThreads;
  static constexpr int kSmem =
      (kRed + (kTwo ? 2 : 1) * 2 * kRow) * static_cast<int>(sizeof(float));
};

// Frame s of a real row read as m complex points z[k] = f[2k] + i f[2k+1].
struct FramedRealIn {
  const float* f;  // x + s*hop
  const float* w;
  int nperseg;
  float mean;
  static constexpr bool kShared = false;
  __device__ __forceinline__ float point(int i) const {
    return i < nperseg ? (f[i] - mean) * __ldg(&w[i]) : 0.f;
  }
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    a = point(2 * k);
    b = point(2 * k + 1);
  }
};

// Frame s of a complex row (planes fr, fi) as nfft complex points.
struct FramedComplexIn {
  const float* fr;  // re + s*hop
  const float* fi;  // im + s*hop
  const float* w;
  int nperseg;
  float mr, mi;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int j, float& a, float& b) const {
    if (j >= nperseg) {
      a = b = 0.f;
      return;
    }
    const float wj = __ldg(&w[j]);
    a = (fr[j] - mr) * wj;
    b = (fi[j] - mi) * wj;
  }
};

// The means of NP frames of nperseg points (planes f[0..NP)), one tree
// reduction over red[p*T .. (p+1)*T) each, all in the same barriers.
template <int T, int NP>
__device__ __forceinline__ void frame_means(const float* const (&f)[NP], int nperseg,
                                            float* red, float (&mean)[NP]) {
  float s[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) s[p] = 0.f;
  for (int j = threadIdx.x; j < nperseg; j += T) {
#pragma unroll
    for (int p = 0; p < NP; ++p) s[p] += f[p][j];
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) red[p * T + threadIdx.x] = s[p];
  __syncthreads();
#pragma unroll
  for (int h = T / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
#pragma unroll
      for (int p = 0; p < NP; ++p) red[p * T + threadIdx.x] += red[p * T + threadIdx.x + h];
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) mean[p] = red[p * T] / static_cast<float>(nperseg);
}

// The m-point transform of real frame f into shared row z, after the
// frame's mean when detrend_c.  Ends with a barrier.
template <int LOG2M, int T>
__device__ __forceinline__ void transform_real(const float* f, const float* w,
                                               int nperseg, bool detrend_c, float* red,
                                               const Shared& z,
                                               const float2* __restrict__ tw) {
  float mean[1] = {0.f};
  if (detrend_c) frame_means<T, 1>({f}, nperseg, red, mean);
  fft_passes<LOG2M, T>(FramedRealIn{f, w, nperseg, mean[0]}, z, z, tw, -1.f);
}

// The n-point transform of the complex frame (fr, fi) into shared row z,
// after the means of both planes when detrend_c.  Ends with a barrier.
template <int LOG2N, int T>
__device__ __forceinline__ void transform_complex(const float* fr, const float* fi,
                                                  const float* w, int nperseg,
                                                  bool detrend_c, float* red,
                                                  const Shared& z,
                                                  const float2* __restrict__ tw) {
  float mean[2] = {0.f, 0.f};
  if (detrend_c) frame_means<T, 2>({fr, fi}, nperseg, red, mean);
  fft_passes<LOG2N, T>(FramedComplexIn{fr, fi, w, nperseg, mean[0], mean[1]}, z, z, tw,
                       -1.f);
}

// Bin k (0 <= k <= M) of the real frame whose half-length transform Z is in
// shared row (zr, zi): X[k] = (Z[k] + conj(Z[M-k]))/2 - (i/2) t[k] (Z[k] -
// conj(Z[M-k])), Z[M] = Z[0], t[k] = exp(-2 pi i k / 2M).
template <int M>
__device__ __forceinline__ void half_bin(const float* zr, const float* zi,
                                         const float2* __restrict__ half, int k,
                                         float& xr, float& xi) {
  const int a = k & (M - 1), b = (M - k) & (M - 1);
  const float er = 0.5f * (zr[a] + zr[b]), ei = 0.5f * (zi[a] - zi[b]);
  const float dr = 0.5f * (zr[a] - zr[b]), di = 0.5f * (zi[a] + zi[b]);
  const float2 t = __ldg(&half[k]);
  xr = er + (t.x * di + t.y * dr);
  xi = ei - (t.x * dr - t.y * di);
}

template <int LOG2N, int KIND>
__global__ void __launch_bounds__(Geom<LOG2N, KIND>::kThreads)
welch_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const float* __restrict__ w, float* __restrict__ o0,
             float* __restrict__ o1, const float2* __restrict__ tw,
             const float2* __restrict__ half, long long t, int nperseg, int hop,
             int num, int seg_per_block, int tiles, int detrend_c) {
  using G = Geom<LOG2N, KIND>;
  constexpr int R = G::kRow;
  constexpr int T = G::kThreads;
  constexpr int BINS = G::kBins;
  constexpr int NB = (BINS + T - 1) / T;  // bins a thread owns
  constexpr int NQ = KIND == kCsd ? 2 : 1;
  extern __shared__ float smem[];
  float* red = smem;
  const Shared zx{smem + G::kRed, smem + G::kRed + R};
  const Shared zy{smem + G::kRed + 2 * R, smem + G::kRed + 3 * R};  // two signals

  const long long b = blockIdx.x / tiles;
  const int tile = static_cast<int>(blockIdx.x % tiles);
  const int s0 = tile * seg_per_block;
  const int s1 = min(num, s0 + seg_per_block);
  const float* xb = x + static_cast<size_t>(b) * t;
  // the second signal, or the imaginary plane of a complex one
  const float* yb = (G::kTwo || !G::kReal) ? y + static_cast<size_t>(b) * t : nullptr;

  float acc[NQ][NB];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int i = 0; i < NB; ++i) acc[q][i] = 0.f;

  for (int s = s0; s < s1; ++s) {
    const size_t off = static_cast<size_t>(s) * hop;
    if constexpr (!G::kReal) {
      transform_complex<LOG2N, T>(xb + off, yb + off, w, nperseg, detrend_c, red, zx, tw);
    } else {
      transform_real<LOG2N - 1, T>(xb + off, w, nperseg, detrend_c, red, zx, tw);
      if constexpr (G::kTwo) {
        transform_real<LOG2N - 1, T>(yb + off, w, nperseg, detrend_c, red, zy, tw);
      }
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int k = threadIdx.x + i * T;
      if (k >= BINS) break;
      float xr, xi;
      if constexpr (G::kReal) {
        half_bin<R>(zx.r, zx.i, half, k, xr, xi);
      } else {
        xr = zx.r[k];
        xi = zx.i[k];
      }
      if constexpr (KIND == kC2c) {
        acc[0][i] += xr * xr + xi * xi;
      } else {
        float yr, yi;
        half_bin<R>(zy.r, zy.i, half, k, yr, yi);
        acc[0][i] += xr * yr + xi * yi;  // Re conj(X) Y
        acc[1][i] += xr * yi - xi * yr;  // Im conj(X) Y
      }
    }
    __syncthreads();  // the next segment's first pass rewrites the rows
  }
  float* outs[2] = {o0, o1};
  const size_t row = (static_cast<size_t>(b) * tiles + tile) * BINS;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int k = threadIdx.x + i * T;
    if (k >= BINS) break;
#pragma unroll
    for (int q = 0; q < NQ; ++q) outs[q][row + k] = acc[q][i];
  }
}

// Dynamic shared memory beyond 48 KB must be allowed before a launch or an
// occupancy query.
template <int LOG2N, int KIND>
cudaError_t allow_smem() {
  constexpr int smem = Geom<LOG2N, KIND>::kSmem;
  if constexpr (smem > 48 * 1024) {
    return cudaFuncSetAttribute(welch_kernel<LOG2N, KIND>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  return cudaSuccess;
}

template <int LOG2N, int KIND>
cudaError_t launch(const void* x, const void* y, const void* w, void* o0, void* o1,
                   const void* tw, const void* half,
                   long long batch, long long t, int nperseg, int hop, int num,
                   int seg_per_block, int tiles, int detrend_c, cudaStream_t stream) {
  using G = Geom<LOG2N, KIND>;
  const long long blocks = batch * tiles;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem<LOG2N, KIND>();
  if (e != cudaSuccess) return e;
  welch_kernel<LOG2N, KIND><<<static_cast<unsigned>(blocks), G::kThreads, G::kSmem,
                              stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(w), static_cast<float*>(o0), static_cast<float*>(o1),
      static_cast<const float2*>(tw),
      static_cast<const float2*>(half), t, nperseg, hop, num, seg_per_block, tiles,
      detrend_c);
  return cudaGetLastError();
}

// Segments a block (S) and tiles for `num` segments of `batch` rows: the
// fewest segments a block such that the grid fills at least two waves of
// the current device's SMs at the kernel's occupancy.
template <int LOG2N, int KIND>
cudaError_t tiles_for(long long batch, int num, int* seg_per_block, int* tiles) {
  using G = Geom<LOG2N, KIND>;
  cudaError_t e = allow_smem<LOG2N, KIND>();
  int per_sm = 0, dev = 0, sms = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, welch_kernel<LOG2N, KIND>,
                                                      G::kThreads, G::kSmem);
  }
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long want = (2LL * sms * (per_sm > 0 ? per_sm : 1) + batch - 1) / batch;
  const int n_tiles = static_cast<int>(want < num ? (want > 1 ? want : 1) : num);
  *seg_per_block = (num + n_tiles - 1) / n_tiles;
  *tiles = (num + *seg_per_block - 1) / *seg_per_block;
  return cudaSuccess;
}

#define WELCH_LOG2N_CASES(CASE) \
  CASE(7) CASE(8) CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14)

template <int KIND>
int dispatch(const void* x, const void* y, const void* w, void* o0, void* o1,
             const void* tw, const void* half, long long batch, long long t,
             int nperseg, int hop, int num, int seg_per_block, int tiles, int log2n,
             int detrend_c, void* stream) {
  const long long nfft = 1LL << log2n;
  if (log2n < 7 || log2n > 14 || batch < 1 || nperseg < 1 || nperseg > nfft ||
      hop < 1 || hop > nperseg || num < 1 || t < nperseg ||
      static_cast<long long>(num - 1) * hop + nperseg > t || seg_per_block < 1 ||
      tiles < 1 || static_cast<long long>(tiles) * seg_per_block < num) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (log2n) {
#define WELCH_CASE(L)                                                                \
  case L:                                                                            \
    return launch<L, KIND>(x, y, w, o0, o1, tw, half, batch, t, nperseg, hop, num, \
                           seg_per_block, tiles, detrend_c, s);
    WELCH_LOG2N_CASES(WELCH_CASE)
#undef WELCH_CASE
    default: return cudaErrorInvalidValue;
  }
}

template <int KIND>
int tiles_dispatch(long long batch, int num, int log2n, int* seg_per_block, int* tiles) {
  switch (log2n) {
#define TILES_CASE(L) \
  case L:             \
    return tiles_for<L, KIND>(batch, num, seg_per_block, tiles);
    WELCH_LOG2N_CASES(TILES_CASE)
#undef TILES_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Each entry point takes `batch` contiguous rows x (and y: the second real
// signal of csd, the imaginary plane of welch_c2c) of t
// float32 points, the window w of nperseg points and nfft =
// 2^log2n (128 .. 16384).  The real kinds take in tw the m = nfft/2
// interleaved (cos, sin) float32 pairs of exp(-2pi*i*j/m) and in half m + 1
// pairs of exp(-2pi*i*k/nfft); welch_c2c takes in tw the nfft pairs of
// exp(-2pi*i*j/nfft) and no half table.  The grid is batch * tiles
// blocks of seg_per_block segments each (welch_tiles).  csd_accum writes
// o0, o1 = [batch, tiles, nfft/2 + 1] partial sums of Re, Im of conj(X) Y;
// welch_c2c o0 = [batch, tiles, nfft] partial sums of |X|^2 over the two-sided spectrum.  The kernel
// launches on `stream` of the current device.  Returns
// cudaGetLastError() (0 = ok).
#define WELCH_ENTRY(NAME, KIND)                                                    \
  int NAME(const void* x, const void* y, const void* w, void* o0, void* o1,       \
           const void* tw, const void* half, long long batch, long long t,        \
           int nperseg, int hop, int num, int seg_per_block, int tiles, int log2n, \
           int detrend_c, void* stream) {                                         \
    return dispatch<KIND>(x, y, w, o0, o1, tw, half, batch, t, nperseg, hop, num, \
                          seg_per_block, tiles, log2n, detrend_c, stream);        \
  }
WELCH_ENTRY(csd_accum_f32, kCsd)
WELCH_ENTRY(welch_c2c_f32, kC2c)
#undef WELCH_ENTRY

// The launch shape of entry point `kind` (2 csd_accum, 4 welch_c2c) for
// `num`
// segments of `batch` rows at nfft = 2^log2n on the current device:
// *seg_per_block and *tiles.  Returns a CUDA error (0 = ok).
int welch_tiles(int kind, long long batch, int num, int log2n, int* seg_per_block,
                int* tiles) {
  if (batch < 1 || num < 1) return cudaErrorInvalidValue;
  switch (kind) {
    case kCsd: return tiles_dispatch<kCsd>(batch, num, log2n, seg_per_block, tiles);
    case kC2c: return tiles_dispatch<kC2c>(batch, num, log2n, seg_per_block, tiles);
    default: return cudaErrorInvalidValue;
  }
}

const char* welch_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

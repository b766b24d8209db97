// Framed real-to-complex FFT of every segment of a signal: frame, detrend,
// window, zero pad, roll and R2C in one pass, into the half spectra or
// their powers.
//
// Replaces two TPU kernels of fft_wgpu_tpu/ops/pallas_welch.py:
//   spec_fft_f32, spec_fft_c64  (B20)  spec_rfft_split, kernel _kernel_spec_split
//   spec_psd_f32                (B19)  spec_psd_split, kernel _kernel_spec_psd
// Segment s of a row v of t + 2*pad points, the row x of t points with
// numpy's reflect pad of pad points at each end (stft's centering; pad = 0:
// none), s = 0 .. num-1, num = 1 + (t + 2*pad - nperseg) / hop, is the
// frame of nfft points
//
//     f_s[j] = (v[s*hop + j] - mean_s) * w[j]   for j < nperseg,
//     f_s[j] = 0                                for nperseg <= j < nfft,
//
// mean_s the mean of v[s*hop .. s*hop + nperseg) when detrend is
// "constant", else 0; its point j is then rolled left by roll (point j of
// the transform is the padded frame's (j + roll) mod nfft, ShortTimeFFT's
// phase shift).  Per segment the kernel computes the half spectrum
//
//     X_s[k] = scale * sum_j f_s[(j + roll) mod nfft] exp(-2*pi*i*k*j/nfft),
//
// k = 0 .. nfft/2, into either of two sinks: planar float32 rows of `bins`
// floats, nfft/2 + 1 or a padded width whose extra columns are exact zeros
// (spec_fft_f32, the padded serving form), or interleaved complex64 rows of
// nfft/2 + 1 points, one 8-byte pair a bin (spec_fft_c64: stft's and
// ShortTimeFFT's [batch, num, bins] spectra, returned with no merge).
// B19's kernel below writes float32 rows of the powers |X_s[k]|^2,
// unscaled, with no pad or roll (spec_psd_f32: spectrogram's psd and
// magnitude modes and welch's median; the caller scales).
//
// What bounds it: device memory, the spectra it writes (8 bytes a bin and
// segment; B19 4) against 4*hop bytes of new signal a segment and about
// 2.5*nfft*log2(nfft) flops.  The frame is read as m = nfft/2 complex points
// z[k] = f[2k] + i f[2k+1] by the first pass of m's compiled plan
// (mixed_fft.cuh's plan_fft; 2048 = 16*16*8) at m/16 threads a segment and
// 16 points a thread, 8-byte pair loads where the frame and the roll leave
// the pairs 8-byte aligned (even hop or segment offset, even roll, no
// reflected point), scalar loads elsewhere; the row sits in shared memory as padded interleaved
// pairs (PadShared), and the bins are recombined from Z[k] and Z[m-k] as
// r2c_fft.cu does (B6).  A block holds several segments (one per
// threadIdx.y) so that it has at least 128 threads, with a launch bound per
// m (SpecShape, as R2cShape); a block of several segments stages the window
// in shared memory once.  A segment's mean is a sum over its m/16 threads
// by warp shuffles, and where a segment spans several warps one step
// through shared memory: one barrier, none where a warp holds it.  The
// store sweeps the block's segments in order, consecutive threads on
// consecutive bins (the block's rows are one run of device memory).
//
// B19 runs B16's design (welch_acc_fft.cu) on this block: segments 2p and
// 2p + 1 as one nfft-point complex frame a + i b on nfft's compiled plan
// (psd_pairs_kernel, nfft/16 threads a pair), FFT(a)[k] = (A + B)/2 and
// FFT(b)[k] = (A - B)/(2i) with A = Z[k], B = conj Z[(nfft - k) mod nfft],
// each power stored to its own segment's row in the same sweep (an odd
// count's last segment pairs with a zero plane and stores one row): half
// the transforms, no recombination table.  B20's kernel with a power sink,
// the half-length transform of each segment, measured 24-48% slower at
// every nfft on the H100 (PERF.md).

#include <cstdint>

#include <cuda_runtime.h>

#include "mixed_fft.cuh"

namespace {

using namespace fftk;

// The launch shape of L = 2^LOG2L points a transform (B20: m = nfft/2;
// B19's pairs: nfft): threads a segment (16
// points each), segments a block, the blocks an SM that the launch bound
// asks registers for (64 a thread: eight blocks of 128 threads an SM
// measured faster than six of 85), and the shared memory: the segments' rows, the window
// (WIN floats, a block of several segments) and two floats a warp for the means.
template <int LOG2L, int WIN = 2 << LOG2L>
struct SpecShape {
  static constexpr int kM = 1 << LOG2L;
  static constexpr int kThreads = kM / 16;
  static constexpr int kRows = kThreads >= 128 ? 1 : 128 / kThreads;
  static constexpr int kBlock = kThreads * kRows;
  static constexpr int kMinBlocks = 1024 / kBlock;  // 64 registers
  static constexpr int kWin = kRows > 1 ? WIN : 0;  // window floats staged
  static constexpr int kWarps = kBlock / 32;
  static constexpr int kSmem = kRows * padded_len(kM) * static_cast<int>(sizeof(float2)) +
                               (kWin + 2 * kWarps) * static_cast<int>(sizeof(float));
};

// B19's pairs: nfft points a transform, a window of at most nfft.
template <int LOG2N>
using PairShape = SpecShape<LOG2N, (1 << LOG2N)>;

struct SpecArgs {
  const float* x;      // [batch, t]: rows before their reflect pad
  const float* w;      // the window, nperseg points
  float* out_re;       // planar sink, rows of `bins`
  float* out_im;
  float2* out;         // complex64 sink, rows of m + 1
  float* power;        // B19's rows of m + 1
  const float2* tw;    // _pass_roots_np(m, -1); B19: _pass_roots_np(nfft, -1)
  const float2* half;  // exp(-2pi*i*k/nfft), k = 0 .. m
  long long t;
  int nperseg;
  int hop;
  int num;
  int tiles;  // segment groups of a row: ceil(num / SpecShape::kRows), pairs: of (num + 1) / 2
  int detrend;
  int roll;
  int pad;  // reflect pad at each end of a row
  int bins;
  float scale;
};

// Point i < nperseg of the frame that starts at x[off] (off = s*hop - pad,
// which may be negative), numpy's reflection of the row at both ends.
struct Frame {
  const float* x;  // the row
  long long off;
  long long t;
  bool inside;  // no point of the frame is reflected
  __device__ __forceinline__ float at(int i) const {
    long long j = off + i;
    if (!inside) {
      j = j < 0 ? -j : j;
      j = j >= t ? 2 * (t - 1) - j : j;
    }
    return x[j];
  }
};

// Segment frame f as m complex points, read by the first pass: point pair k
// is the padded frame's points (2k + roll) and (2k + 1 + roll) mod nfft
// (mask = nfft - 1), less the mean, times the window.
struct FrameIn {
  Frame f;
  const float* w;  // the window: in shared memory, or the caller's
  int nperseg;
  float mean;
  int roll;
  int mask;
  bool paired;  // an inner frame, and f, w and the roll leave every pair 8-byte aligned
  static constexpr bool kShared = false;
  __device__ __forceinline__ float point(int i) const {
    return i < nperseg ? (f.at(i) - mean) * w[i] : 0.f;
  }
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    const int i = (2 * k + roll) & mask;
    if (paired && i + 1 < nperseg) {
      const float2 v = *reinterpret_cast<const float2*>(f.x + f.off + i);
      const float2 u = *reinterpret_cast<const float2*>(w + i);
      a = (v.x - mean) * u.x;
      b = (v.y - mean) * u.y;
    } else {
      a = point(i);
      b = point((i + 1) & mask);
    }
  }
};

// This thread's segment (one per threadIdx.y) of L points: its source, and
// its buffer, the last pass's sink too.
template <int L, class In>
struct SpecRow {
  In in;
  __device__ __forceinline__ PadShared shared() const {
    extern __shared__ float2 smem[];
    return PadShared{smem + threadIdx.y * padded_len(L)};
  }
  __device__ __forceinline__ In src() const { return in; }
  __device__ __forceinline__ PadShared dst() const { return shared(); }
};

// The block's window in shared memory (a block of several segments), else
// the caller's.
template <int ROWS, int BLOCK>
__device__ __forceinline__ const float* stage_window(const SpecArgs& g, float* win, int flat) {
  if constexpr (ROWS > 1) {
    for (int i = flat; i < g.nperseg; i += BLOCK) win[i] = g.w[i];
    return win;
  }
  return g.w;
}

// The sums over a segment's T threads of NP planes' values m[0..NP), where
// `on` (the detrend): warp shuffles, and where a segment spans several warps
// one step through red (two floats a warp) across a barrier, which the
// block's staged window (ROWS > 1) needs too.  Every thread of the block
// calls it.
template <int T, int ROWS, int NP>
__device__ __forceinline__ void segment_sums(float (&m)[NP], float* red, int flat, bool on) {
  if (on) {
#pragma unroll
    for (int o = (T < 32 ? T : 32) / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int p = 0; p < NP; ++p) m[p] += __shfl_xor_sync(0xffffffffu, m[p], o);
    }
    if constexpr (T > 32) {
      if ((flat & 31) == 0) {
#pragma unroll
        for (int p = 0; p < NP; ++p) red[2 * (flat >> 5) + p] = m[p];
      }
    }
  }
  if constexpr (ROWS > 1 || T > 32) {
    if (ROWS > 1 || on) __syncthreads();  // the window and the warps' sums
  }
  if constexpr (T > 32) {
    if (on) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        m[p] = 0.f;
#pragma unroll
        for (int i = 0; i < T / 32; ++i) m[p] += red[2 * (flat / T * (T / 32) + i) + p];
      }
    }
  }
}

template <int LOG2M, bool C64>
__global__ void __launch_bounds__(SpecShape<LOG2M>::kBlock, SpecShape<LOG2M>::kMinBlocks)
spec_fft_kernel(const __grid_constant__ SpecArgs g) {
  using S = SpecShape<LOG2M>;
  constexpr int M = S::kM, T = S::kThreads;
  extern __shared__ float2 smem[];
  float* win = reinterpret_cast<float*>(smem + S::kRows * padded_len(M));
  float* red = win + S::kWin;
  const long long row = blockIdx.x / g.tiles;
  const int s0 = static_cast<int>(blockIdx.x % g.tiles) * S::kRows;
  // a segment past the last reads the last and stores nothing
  const int s = min(s0 + static_cast<int>(threadIdx.y), g.num - 1);
  const long long off = static_cast<long long>(s) * g.hop - g.pad;
  const Frame f{g.x + static_cast<size_t>(row) * g.t, off, g.t,
                off >= 0 && off + g.nperseg <= g.t};
  const int flat = static_cast<int>(threadIdx.y) * T + static_cast<int>(threadIdx.x);

  const float* w = stage_window<S::kRows, S::kBlock>(g, win, flat);
  float mean[1] = {0.f};
  if (g.detrend) {
    for (int i = threadIdx.x; i < g.nperseg; i += T) mean[0] += f.at(i);
  }
  segment_sums<T, S::kRows>(mean, red, flat, g.detrend);
  mean[0] /= static_cast<float>(g.nperseg);
  const bool paired = f.inside && !(g.roll & 1) &&
                      !(reinterpret_cast<uintptr_t>(f.x + off) & 7) &&
                      !(reinterpret_cast<uintptr_t>(w) & 7);
  plan_fft<-1, LOG2M>(
      SpecRow<M, FrameIn>{FrameIn{f, w, g.nperseg, mean[0], g.roll, 2 * M - 1, paired}}, g.tw);
  // The last pass ends with a barrier: Z of every segment of the block is in
  // shared memory.  The block's output rows are one contiguous run of device
  // memory; its threads store it in order, consecutive threads on
  // consecutive bins.
  const int rows = min(S::kRows, g.num - s0);
  const int bins = C64 ? M + 1 : g.bins;
  const size_t o = (static_cast<size_t>(row) * g.num + s0) * bins;
  for (int i = flat; i < rows * bins; i += S::kBlock) {
    const int r = i / bins, k = i - r * bins;
    float xr = 0.f, xi = 0.f;
    if (k <= M) {
      const PadShared z{smem + r * padded_len(M)};
      float ar, ai, br, bi;
      z.load(k & (M - 1), ar, ai);
      z.load((M - k) & (M - 1), br, bi);
      const float er = 0.5f * (ar + br), ei = 0.5f * (ai - bi);
      const float dr = 0.5f * (ar - br), di = 0.5f * (ai + bi);
      const float2 t = __ldg(&g.half[k]);
      xr = (er + (t.x * di + t.y * dr)) * g.scale;
      xi = (ei - (t.x * dr - t.y * di)) * g.scale;
    }
    if constexpr (C64) {
      g.out[o + i] = make_float2(xr, xi);
    } else {
      g.out_re[o + i] = xr;
      g.out_im[o + i] = xi;
    }
  }
}

// B19's pairs: segments 2p and 2p + 1 of a row as one nfft-point complex
// frame (one per threadIdx.y), each segment's powers stored to its row.
template <int LOG2N>
__global__ void __launch_bounds__(PairShape<LOG2N>::kBlock, PairShape<LOG2N>::kMinBlocks)
psd_pairs_kernel(const __grid_constant__ SpecArgs g) {
  using S = PairShape<LOG2N>;
  constexpr int N = S::kM, T = S::kThreads, H = N / 2;
  extern __shared__ float2 smem[];
  float* win = reinterpret_cast<float*>(smem + S::kRows * padded_len(N));
  float* red = win + S::kWin;
  const long long row = blockIdx.x / g.tiles;
  const int p0 = static_cast<int>(blockIdx.x % g.tiles) * S::kRows;
  // a pair past the last reads the last and stores nothing
  const int p = min(p0 + static_cast<int>(threadIdx.y), (g.num - 1) / 2);
  const float* x = g.x + static_cast<size_t>(row) * g.t;
  const float* a = x + static_cast<size_t>(2 * p) * g.hop;
  const float* b = 2 * p + 1 < g.num ? a + g.hop : nullptr;
  const int flat = static_cast<int>(threadIdx.y) * T + static_cast<int>(threadIdx.x);

  const float* w = stage_window<S::kRows, S::kBlock>(g, win, flat);
  float mean[2] = {0.f, 0.f};
  if (g.detrend) {
    for (int i = threadIdx.x; i < g.nperseg; i += T) {
      mean[0] += a[i];
      if (b != nullptr) mean[1] += b[i];
    }
  }
  segment_sums<T, S::kRows>(mean, red, flat, g.detrend);
  const float n = static_cast<float>(g.nperseg);
  plan_fft<-1, LOG2N>(
      SpecRow<N, TwoFramesIn>{TwoFramesIn{a, b, w, g.nperseg, mean[0] / n, mean[1] / n}}, g.tw);
  // The block's segments 2*p0 .. are one run of rows in device memory: the
  // sweep takes segment 2r from pair r's a and 2r + 1 from its b.
  const int rows = min(2 * S::kRows, g.num - 2 * p0);
  const size_t o = (static_cast<size_t>(row) * g.num + 2 * p0) * (H + 1);
  for (int i = flat; i < rows * (H + 1); i += S::kBlock) {
    const int r = i / (H + 1), k = i - r * (H + 1);
    const PadShared z{smem + (r >> 1) * padded_len(N)};
    float ar, ai, cr, ci;
    z.load(k, ar, ai);
    z.load((N - k) & (N - 1), cr, ci);
    // FFT(a) = (A + conj C)/2, FFT(b) = (A - conj C)/(2i)
    const float u = r & 1 ? 0.5f * (ai + ci) : 0.5f * (ar + cr);
    const float v = r & 1 ? 0.5f * (cr - ar) : 0.5f * (ai - ci);
    g.power[o + i] = u * u + v * v;
  }
}

template <class Shape, class Kernel>
cudaError_t launch_shape(Kernel* kernel, const SpecArgs& g, long long batch,
                         cudaStream_t stream) {
  const long long blocks = batch * g.tiles;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  if constexpr (Shape::kSmem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Shape::kSmem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), dim3(Shape::kThreads, Shape::kRows), Shape::kSmem,
           stream>>>(g);
  return cudaGetLastError();
}

// B20 (POWER false, into its sink) or B19 (POWER) at nfft = 2^(LOG2M + 1),
// its grid's tiles set.
template <int LOG2M, bool C64, bool POWER>
cudaError_t launch(SpecArgs g, long long batch, cudaStream_t stream) {
  if constexpr (POWER) {
    using S = PairShape<LOG2M + 1>;
    g.tiles = ((g.num + 1) / 2 + S::kRows - 1) / S::kRows;
    return launch_shape<S>(psd_pairs_kernel<LOG2M + 1>, g, batch, stream);
  } else {
    using S = SpecShape<LOG2M>;
    g.tiles = (g.num + S::kRows - 1) / S::kRows;
    return launch_shape<S>(spec_fft_kernel<LOG2M, C64>, g, batch, stream);
  }
}

template <bool C64, bool POWER>
int dispatch(const SpecArgs& g, long long batch, int log2n, void* stream) {
  const long long nfft = 1LL << log2n;
  const long long padded = g.t + 2LL * g.pad;
  if (log2n < 7 || log2n > 14 || batch < 1 || g.nperseg < 1 || g.nperseg > nfft ||
      g.hop < 1 || g.hop > g.nperseg || g.num < 1 || g.pad < 0 || (g.pad > 0 && g.pad >= g.t) ||
      padded < g.nperseg || static_cast<long long>(g.num - 1) * g.hop + g.nperseg > padded ||
      g.bins < nfft / 2 + 1 || g.roll < 0 || g.roll >= nfft ||
      (g.detrend != 0 && g.detrend != 1)) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (log2n - 1) {
#define SPEC_CASE(L) \
  case L: return launch<L, C64, POWER>(g, batch, s);
    SPEC_CASE(6) SPEC_CASE(7) SPEC_CASE(8) SPEC_CASE(9)
    SPEC_CASE(10) SPEC_CASE(11) SPEC_CASE(12) SPEC_CASE(13)
#undef SPEC_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The half spectra of every segment of `batch` contiguous rows x of t
// float32 points, each reflect-padded by pad points at both ends (0 <= pad <
// t), window w of nperseg points, nfft = 2^log2n (128 .. 16384), 0 < hop <=
// nperseg <= nfft, each padded frame rolled left by roll (0 <= roll <
// nfft), less its mean when detrend is 1, the scale folded in.
// tw holds the pass roots of m = nfft/2 (_pass_roots_np(m, -1)), half the
// m + 1 roots exp(-2pi*i*k/nfft), both interleaved (cos, sin) float32
// pairs.  Into planar rows [batch, num, bins], bins >= nfft/2 + 1 (zeros
// past bin nfft/2).  Launches on `stream` and returns cudaGetLastError()
// (0 = ok).
int spec_fft_f32(const void* x, const void* w, void* out_re, void* out_im, const void* tw,
                 const void* half, long long batch, long long t, int nperseg, int hop,
                 int num, int log2n, int detrend, int roll, int pad, int bins, float scale,
                 void* stream) {
  const SpecArgs g{static_cast<const float*>(x), static_cast<const float*>(w),
                   static_cast<float*>(out_re), static_cast<float*>(out_im), nullptr, nullptr,
                   static_cast<const float2*>(tw), static_cast<const float2*>(half), t, nperseg,
                   hop, num, 0, detrend, roll, pad, bins, scale};
  return dispatch<false, false>(g, batch, log2n, stream);
}

// The same into interleaved complex64 rows [batch, num, nfft/2 + 1].
int spec_fft_c64(const void* x, const void* w, void* out, const void* tw, const void* half,
                 long long batch, long long t, int nperseg, int hop, int num, int log2n,
                 int detrend, int roll, int pad, float scale, void* stream) {
  const SpecArgs g{static_cast<const float*>(x), static_cast<const float*>(w), nullptr, nullptr,
                   static_cast<float2*>(out), nullptr, static_cast<const float2*>(tw),
                   static_cast<const float2*>(half), t, nperseg, hop, num, 0, detrend, roll,
                   pad, (1 << (log2n - 1)) + 1, scale};
  return dispatch<true, false>(g, batch, log2n, stream);
}

// B19: the powers |X_s[k]|^2 of every segment, unscaled, no pad and no roll,
// into float32 rows [batch, num, nfft/2 + 1].  tw holds the pass roots of
// nfft (_pass_roots_np(nfft, -1)), interleaved (cos, sin) float32 pairs.
int spec_psd_f32(const void* x, const void* w, void* out, const void* tw, long long batch,
                 long long t, int nperseg, int hop, int num, int log2n, int detrend,
                 void* stream) {
  const SpecArgs g{static_cast<const float*>(x), static_cast<const float*>(w), nullptr, nullptr,
                   nullptr, static_cast<float*>(out), static_cast<const float2*>(tw), nullptr,
                   t, nperseg, hop, num, 0, detrend, 0, 0, (1 << (log2n - 1)) + 1, 1.f};
  return dispatch<false, true>(g, batch, log2n, stream);
}

const char* spec_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

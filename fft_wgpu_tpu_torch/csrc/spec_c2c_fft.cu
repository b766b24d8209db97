// Framed complex-to-complex FFT of every segment of a signal: frame,
// detrend, window, zero pad and the two-sided transform in one pass.
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/pallas_welch.py::spec_c2c_split
// (its pl.pallas_call over _kernel_spec_split_c2c, B22).  Segment s of a
// complex row z of t points, s = 0 .. num-1, num = 1 + (t - nperseg) / hop,
// is the frame of nfft points
//
//     f_s[j] = (z[s*hop + j] - mean_s) * w[j]   for j < nperseg,
//     f_s[j] = 0                                for nperseg <= j < nfft,
//
// mean_s the mean of z[s*hop .. s*hop + nperseg) when detrend is
// "constant" (each plane's own mean), else 0.  Per segment the kernel
// computes the whole spectrum, every bin in natural order,
//
//     X_s[k] = scale * sum_j f_s[j] exp(-2*pi*i*k*j/nfft),  k < nfft,
//
// from either of two sources: planar float32 planes (re, im), a null im
// reading as a zero plane (a real signal taken two-sided), or the
// interleaved complex64 signal as it lies, one 8-byte pair a point; into
// either of two sinks: planar planes [batch, num, nfft] (spec_c2c_fft_f32)
// or complex64 [batch, num, nfft] (spec_c2c_fft_c64: the complex
// spectrogram's and csd's per-segment spectra, returned with no merge).
//
// What bounds it: device memory, the spectra it writes (8 bytes a bin and
// segment) against 8*hop bytes of new signal a segment and about
// 5*nfft*log2(nfft) flops.  The frame is read by the first pass of nfft's
// compiled plan (mixed_fft.cuh's plan_fft; 4096 = 16*16*16) at nfft/16
// threads a segment and 16 points a thread, detrended and windowed at load;
// the row sits in shared memory as padded interleaved pairs (PadShared),
// and the last pass stores from registers straight to device memory with
// the scale folded in, consecutive lanes on consecutive bins (as rows_fft.cu
// does, B1: there is no recombination to wait for).  A block holds several
// segments (one per threadIdx.y) so that it has at least 128 threads, with
// a launch bound per nfft (SpecC2cShape: 64 registers, as spec_fft.cu's); a
// block of several segments stages the window in shared memory once.  A
// segment's two means are sums over its nfft/16 threads by warp shuffles
// and, where the segment spans several warps, one step through shared
// memory: one barrier, none where a warp holds it.

#include <cuda_runtime.h>

#include "mixed_fft.cuh"

namespace {

using namespace fftk;

// The launch shape of nfft = 2^LOG2N: threads a segment (16 points each),
// segments a block, the blocks an SM that the launch bound asks registers
// for (64 a thread, as spec_fft.cu's: RowsShape's 80 at nfft <= 4096 and
// blocks of 256 threads measured no faster or slower,
// scripts/time_pow2_variants.py --lib spec_c2c_fft), and the shared memory:
// the segments' rows, the window (a block of several segments) and two
// floats a warp for the means.
template <int LOG2N>
struct SpecC2cShape {
  static constexpr int kN = 1 << LOG2N;
  static constexpr int kThreads = kN / 16;
  static constexpr int kRows = kThreads >= 128 ? 1 : 128 / kThreads;
  static constexpr int kBlock = kThreads * kRows;
  static constexpr int kMinBlocks = 1024 / kBlock;  // 64 registers
  static constexpr int kWin = kRows > 1 ? kN : 0;   // window floats staged
  static constexpr int kWarps = kBlock / 32 > 0 ? kBlock / 32 : 1;
  static constexpr int kSmem = kRows * padded_len(kN) * static_cast<int>(sizeof(float2)) +
                               (kWin + 2 * kWarps) * static_cast<int>(sizeof(float));
};

struct SpecC2cArgs {
  const float* re;    // planar source [batch, t]; im may be null
  const float* im;
  const float2* z;    // complex64 source [batch, t]
  const float* w;     // the window, nperseg points
  float* out_re;      // planar sink
  float* out_im;
  float2* out;        // complex64 sink
  const float2* tw;   // _pass_roots_np(nfft, -1)
  long long t;
  int nperseg;
  int hop;
  int num;
  int tiles;  // segment groups of a row: ceil(num / SpecC2cShape::kRows)
  int detrend;
  float scale;
};

// This thread's segment (one per threadIdx.y): its source, its buffer, and
// its row of the sink (nothing for a segment past the last).
template <int LOG2N, bool IN_C64, bool OUT_C64>
struct C2cRow {
  const SpecC2cArgs& g;
  C2cFrameIn<IN_C64> in;
  size_t o;  // the segment's row of the sink
  bool valid;
  __device__ __forceinline__ PadShared shared() const {
    extern __shared__ float2 smem[];
    return PadShared{smem + threadIdx.y * padded_len(1 << LOG2N)};
  }
  __device__ __forceinline__ C2cFrameIn<IN_C64> src() const { return in; }
  __device__ __forceinline__ auto dst() const {
    if constexpr (OUT_C64) {
      return C64Out{g.out + o, g.scale, valid};
    } else {
      return PlanarOut{g.out_re + o, g.out_im + o, g.scale, valid};
    }
  }
};

template <int LOG2N, bool IN_C64, bool OUT_C64>
__global__ void __launch_bounds__(SpecC2cShape<LOG2N>::kBlock, SpecC2cShape<LOG2N>::kMinBlocks)
spec_c2c_kernel(const __grid_constant__ SpecC2cArgs g) {
  using S = SpecC2cShape<LOG2N>;
  constexpr int N = S::kN, T = S::kThreads;
  extern __shared__ float2 smem[];
  float* win = reinterpret_cast<float*>(smem + S::kRows * padded_len(N));
  float* red = win + S::kWin;
  const long long row = blockIdx.x / g.tiles;
  const int s0 = static_cast<int>(blockIdx.x % g.tiles) * S::kRows;
  const int sy = s0 + static_cast<int>(threadIdx.y);
  // a segment past the last reads the last and stores nothing
  const int s = min(sy, g.num - 1);
  const size_t off = static_cast<size_t>(row) * g.t + static_cast<size_t>(s) * g.hop;
  const int flat = static_cast<int>(threadIdx.y) * T + static_cast<int>(threadIdx.x);

  const float* w = g.w;
  if constexpr (S::kRows > 1) {  // the window, once for the block's segments
    for (int i = flat; i < g.nperseg; i += S::kBlock) win[i] = g.w[i];
    w = win;
  }
  const float* re = IN_C64 ? nullptr : g.re + off;
  const float* im = IN_C64 || g.im == nullptr ? nullptr : g.im + off;
  const float2* z = IN_C64 ? g.z + off : nullptr;
  float mr = 0.f, mi = 0.f;
  if (g.detrend) {
    for (int i = threadIdx.x; i < g.nperseg; i += T) {
      if constexpr (IN_C64) {
        const float2 p = z[i];
        mr += p.x;
        mi += p.y;
      } else {
        mr += re[i];
        if (im != nullptr) mi += im[i];
      }
    }
#pragma unroll
    for (int o = (T < 32 ? T : 32) / 2; o > 0; o >>= 1) {
      mr += __shfl_xor_sync(0xffffffffu, mr, o);
      mi += __shfl_xor_sync(0xffffffffu, mi, o);
    }
    if constexpr (T > 32) {
      if ((flat & 31) == 0) {
        red[2 * (flat >> 5)] = mr;
        red[2 * (flat >> 5) + 1] = mi;
      }
    }
  }
  if constexpr (S::kRows > 1 || T > 32) {
    if (S::kRows > 1 || g.detrend) __syncthreads();  // the window and the warps' sums
  }
  if constexpr (T > 32) {
    if (g.detrend) {
      mr = mi = 0.f;
#pragma unroll
      for (int i = 0; i < T / 32; ++i) {
        mr += red[2 * (threadIdx.y * (T / 32) + i)];
        mi += red[2 * (threadIdx.y * (T / 32) + i) + 1];
      }
    }
  }
  const float n = static_cast<float>(g.nperseg);
  const C2cFrameIn<IN_C64> in{re, im, z, w, g.nperseg, mr / n, mi / n};
  const size_t o = (static_cast<size_t>(row) * g.num + s) * N;
  plan_fft<-1, LOG2N>(C2cRow<LOG2N, IN_C64, OUT_C64>{g, in, o, sy < g.num}, g.tw);
}

template <int LOG2N, bool IN_C64, bool OUT_C64>
cudaError_t launch(const SpecC2cArgs& g, long long batch, cudaStream_t stream) {
  using S = SpecC2cShape<LOG2N>;
  auto* kernel = spec_c2c_kernel<LOG2N, IN_C64, OUT_C64>;
  const long long blocks = batch * g.tiles;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  if constexpr (S::kSmem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), dim3(S::kThreads, S::kRows), S::kSmem, stream>>>(g);
  return cudaGetLastError();
}

template <int LOG2N, bool OUT_C64>
cudaError_t launch_source(SpecC2cArgs g, long long batch, cudaStream_t stream) {
  g.tiles = (g.num + SpecC2cShape<LOG2N>::kRows - 1) / SpecC2cShape<LOG2N>::kRows;
  return g.z != nullptr ? launch<LOG2N, true, OUT_C64>(g, batch, stream)
                        : launch<LOG2N, false, OUT_C64>(g, batch, stream);
}

template <bool OUT_C64>
int dispatch(const SpecC2cArgs& g, long long batch, int log2n, void* stream) {
  const long long nfft = 1LL << log2n;
  if (log2n < 7 || log2n > 14 || batch < 1 || g.nperseg < 1 || g.nperseg > nfft ||
      g.hop < 1 || g.hop > g.nperseg || g.num < 1 || g.t < g.nperseg ||
      static_cast<long long>(g.num - 1) * g.hop + g.nperseg > g.t ||
      (g.detrend != 0 && g.detrend != 1) || (g.z == nullptr) == (g.re == nullptr) ||
      (g.z != nullptr && g.im != nullptr)) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (log2n) {
    case 7: return launch_source<7, OUT_C64>(g, batch, s);
    case 8: return launch_source<8, OUT_C64>(g, batch, s);
    case 9: return launch_source<9, OUT_C64>(g, batch, s);
    case 10: return launch_source<10, OUT_C64>(g, batch, s);
    case 11: return launch_source<11, OUT_C64>(g, batch, s);
    case 12: return launch_source<12, OUT_C64>(g, batch, s);
    case 13: return launch_source<13, OUT_C64>(g, batch, s);
    default: return launch_source<14, OUT_C64>(g, batch, s);
  }
}

}  // namespace

extern "C" {

// The two-sided spectra of every segment of `batch` contiguous rows of t
// points, window w of nperseg points, nfft = 2^log2n (128 .. 16384), 0 <
// hop <= nperseg <= min(nfft, t), each frame less its mean when detrend is
// 1, the scale folded in.  The source is either the complex64 rows z
// (interleaved (re, im) float32 pairs, 8-byte aligned; re and im null) or
// the float32 planes re and im (im null: a zero plane; z null).  tw holds
// the pass roots of nfft (_pass_roots_np(nfft, -1), interleaved (cos, sin)
// float32 pairs).  Into planar rows [batch, num, nfft].  Launches on
// `stream` and returns cudaGetLastError() (0 = ok).
int spec_c2c_fft_f32(const void* z, const void* re, const void* im, const void* w,
                     void* out_re, void* out_im, const void* tw, long long batch, long long t,
                     int nperseg, int hop, int num, int log2n, int detrend, float scale,
                     void* stream) {
  const SpecC2cArgs g{static_cast<const float*>(re), static_cast<const float*>(im),
                      static_cast<const float2*>(z), static_cast<const float*>(w),
                      static_cast<float*>(out_re), static_cast<float*>(out_im), nullptr,
                      static_cast<const float2*>(tw), t, nperseg, hop, num, 0, detrend, scale};
  return dispatch<false>(g, batch, log2n, stream);
}

// The same into interleaved complex64 rows [batch, num, nfft].
int spec_c2c_fft_c64(const void* z, const void* re, const void* im, const void* w, void* out,
                     const void* tw, long long batch, long long t, int nperseg, int hop,
                     int num, int log2n, int detrend, float scale, void* stream) {
  const SpecC2cArgs g{static_cast<const float*>(re), static_cast<const float*>(im),
                      static_cast<const float2*>(z), static_cast<const float*>(w), nullptr,
                      nullptr, static_cast<float2*>(out), static_cast<const float2*>(tw), t,
                      nperseg, hop, num, 0, detrend, scale};
  return dispatch<true>(g, batch, log2n, stream);
}

const char* spec_c2c_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

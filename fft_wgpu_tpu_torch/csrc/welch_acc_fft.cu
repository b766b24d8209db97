// Welch's and coherence's segment sums on the compiled pow2 passes: two real
// frames transformed as one complex frame, the power or cross products of
// every segment summed per bin, in one pass over the signal.
//
// Replaces the TPU kernels of fft_wgpu_tpu/ops/pallas_welch.py:
//   welch_acc_f32 kind 0 (B16)  welch_accum_split, kernel _kernel_welch_accum
//   welch_acc_f32 kind 1 (B18)  coherence_accum_split, kernel _kernel_coh_accum
// (B17, B19 and B21 stay on welch_fft.cu's welch_kernel.)
//
// Segment s of a row x of t points (s = 0 .. num-1, num = 1 + (t - nperseg)
// / hop) is the frame of nfft points
//
//     f_s[j] = (x[s*hop + j] - mean_s) * w[j]   for j < nperseg,
//     f_s[j] = 0                                for nperseg <= j < nfft,
//
// mean_s the mean of x[s*hop .. s*hop + nperseg) when detrend is "constant",
// else 0.  Two real frames a and b go through one nfft-point complex
// transform as z = a + i b, Z = FFT(z).  Per bin k, with A = Z[k] and B =
// conj Z[(nfft - k) mod nfft], FFT(a)[k] = (A + B)/2 and FFT(b)[k] = (A -
// B)/(2i), so
//   B16 (welch): a, b are frames 2p and 2p + 1 of one row (an odd count
//        pairs its last frame with a zero plane, none of it read), and
//        |FFT(a)[k]|^2 + |FFT(b)[k]|^2 = (|A|^2 + |B|^2)/2 is summed over
//        the pairs, k = 0 .. nfft/2;
//   B18 (coh): a, b are segment s of x and of y (of y and of x for odd s),
//        and Re and Im of conj(X) Y, |X|^2 and |Y|^2 are summed over the
//        segments.  The transform's rounding leaks a little of b's spectrum
//        into a's and of a's into b's, the same each segment, which adds
//        a bias of about 3e-7 |Y|^2 to each conj(X) Y: summed over num
//        segments it grows as num while the cross spectrum of incoherent
//        signals grows as sqrt(num) (coherence 1.1e-5 off float64 at 2^22,
//        nperseg 4096).  Swapping the planes flips the bias's sign, so
//        every other segment swaps them and the bias cancels.
// One transform a pair of frames, no recombination table; at nfft 8192
// and 16384 B16 instead runs B20's half-length transform of each frame and
// recombines its bins, X[k] = (Z[k] + conj Z[m-k])/2 - (i/2) t[k] (Z[k] -
// conj Z[m-k]), m = nfft/2, t[k] = exp(-2 pi i k/nfft) (kWelchHalf; both
// designs timed by scripts/time_pow2_variants.py --lib welch_acc_fft).
//
// What bounds it: device memory, 4*hop (B18: 8*hop) bytes of new signal a
// segment against about 2.5*nfft*log2(nfft) (5*...) flops, so at half
// overlap a kernel at its bound reads each signal once.  The block is
// B22's (spec_c2c_fft.cu): nfft's compiled plan (mixed_fft.cuh's plan_fft)
// at nfft/16 threads a transform and 16 points a thread, several
// transforms a block (one per threadIdx.y) so that it has at least 128
// threads, a launch bound per nfft (kRegisters), each frame detrended and
// windowed in the first pass's loads, each plane's mean by warp shuffles
// and at most one step through shared memory.  The last pass stores to the
// padded shared row (PadShared); after its barrier the epilogue reads Z[k]
// and Z[nfft - k].  A fixed thread owns each bin (k = threadIdx.x + i*T,
// and nfft/2 for threadIdx.x = 0) across all the transforms of its row of
// the block: its sums sit in registers or in shared memory (kRegSums),
// each thread on its own bins, so there is no atomic.  A block takes
// `iters` rounds of its rows; at its end it sums its rows in order and
// writes one row.  out[q] is [batch, tiles, nfft/2 + 1], which the caller
// sums over its middle axis in a fixed order (a thread-block cluster adding
// its blocks' rows through distributed shared memory measured slower at
// every shape timed).  A rerun gives the same bits.

#include <cuda_runtime.h>

#include "mixed_fft.cuh"

namespace {

using namespace fftk;

enum Kind { kWelch = 0, kCoh = 1 };

// B16's transform per nfft = 2^7 .. 2^14: B20's half-length transform of
// each frame and the recombination of its bins (true; measured faster at
// 8192 and 16384), or two frames as one complex frame.
constexpr bool kWelchHalf[8] = {false, false, false, false, false, false, true, true};

// How many of a kind's sums (B16: 1; B18: 4) each thread keeps in registers,
// per nfft = 2^7 .. 2^14; the others live in shared memory, where they
// measured faster but for B16 at 128 and 256 and B18 at 128.  At 16384
// B18's four planes of sums do not fit beside the row in shared memory, so
// two stay in registers there.
constexpr int kRegSums[2][8] = {{1, 1, 0, 0, 0, 0, 0, 0}, {4, 0, 0, 0, 0, 0, 0, 2}};

// Per nfft = 2^7 .. 2^14: the registers a thread that the launch bound
// allows (85: six blocks of 128 threads an SM, three of 256; at 8192 and
// 16384, 64: two blocks of 512 threads, one of 1024;
// scripts/time_pow2_variants.py --lib welch_acc_fft).
constexpr int kRegisters[8] = {85, 85, 85, 85, 85, 85, 64, 64};

// The launch shape of kind KIND at nfft = 2^LOG2N: the transform's length
// L (nfft, or nfft/2 for the half-length design), threads a transform (16
// points each), transforms a block, the bins a thread owns below nfft/2,
// and the shared memory: the rows (each also holding its row's register
// sums at the block's end), the window (a block of several rows), two
// floats a warp for the means, the shared sums [rows][NQ - RQ][bins].
template <int LOG2N, int KIND>
struct AccShape {
  static constexpr bool kHalf = KIND == kWelch && kWelchHalf[LOG2N - 7];
  static constexpr int kLog2L = kHalf ? LOG2N - 1 : LOG2N;
  static constexpr int kL = 1 << kLog2L;
  static constexpr int kN = 1 << LOG2N;
  static constexpr int kBins = kN / 2 + 1;
  static constexpr int kThreads = kL / 16;
  static constexpr int kRows = kThreads >= 128 ? 1 : 128 / kThreads;
  static constexpr int kBlock = kThreads * kRows;
  static constexpr int kMinBlocks =
      65536 / (kRegisters[LOG2N - 7] * kBlock) > 0 ? 65536 / (kRegisters[LOG2N - 7] * kBlock) : 1;
  static constexpr int kPer = (kBins - 1) / kThreads;
  static constexpr int kNQ = KIND == kCoh ? 4 : 1;
  static constexpr int kRegQ = kRegSums[KIND][LOG2N - 7];
  static constexpr int kSmemQ = kNQ - kRegQ;
  static constexpr int kRowFloats = 2 * padded_len(kL);
  static constexpr int kWin = kRows > 1 ? kN : 0;
  static constexpr int kWarps = kBlock / 32 > 0 ? kBlock / 32 : 1;
  static constexpr int kSmem =
      (kRows * kRowFloats + kWin + 2 * kWarps + kRows * kSmemQ * kBins) *
      static_cast<int>(sizeof(float));
  static_assert(kRowFloats >= kRegQ * kBins, "a row's buffer holds its register sums");
};

struct AccArgs {
  const float* x;      // [batch, t]
  const float* y;      // B18's second signal
  const float* w;      // the window, nperseg points
  float* out[4];       // [batch, tiles, nfft/2 + 1] each
  const float2* tw;    // _pass_roots_np(nfft, -1)
  const float2* tw_m;  // _pass_roots_np(nfft/2, -1): the half-length design
  const float2* half;  // exp(-2pi*i*k/nfft), k = 0 .. nfft/2: the half-length design
  long long t;
  int nperseg;
  int hop;
  int num;
  int units;  // transforms a row: num, or (num + 1)/2 pairs
  int iters;  // rounds of a block's rows
  int tiles;  // blocks a row
  int detrend;
};

// One real frame as nfft/2 complex points f[2k] + i f[2k+1] (B20's packing).
struct HalfIn {
  const float* a;
  const float* w;
  int nperseg;
  float ma;
  static constexpr bool kShared = false;
  __device__ __forceinline__ float point(int i) const {
    return i < nperseg ? (a[i] - ma) * w[i] : 0.f;
  }
  __device__ __forceinline__ void load(int k, float& u, float& v) const {
    u = point(2 * k);
    v = point(2 * k + 1);
  }
};

// This thread's transform (one per threadIdx.y): its source, and its
// buffer, the last pass's sink too.
template <int L, class In>
struct AccRow {
  In in;
  __device__ __forceinline__ PadShared shared() const {
    extern __shared__ float2 smem[];
    return PadShared{smem + threadIdx.y * padded_len(L)};
  }
  __device__ __forceinline__ In src() const { return in; }
  __device__ __forceinline__ PadShared dst() const { return shared(); }
};

template <int LOG2N, int KIND>
__global__ void __launch_bounds__(AccShape<LOG2N, KIND>::kBlock, AccShape<LOG2N, KIND>::kMinBlocks)
welch_acc_kernel(const __grid_constant__ AccArgs g) {
  using S = AccShape<LOG2N, KIND>;
  constexpr int N = S::kN, L = S::kL, T = S::kThreads, R = S::kRows, BINS = S::kBins;
  constexpr int PER = S::kPer, NQ = S::kNQ, RQ = S::kRegQ, SQ = S::kSmemQ;
  extern __shared__ float2 smem[];
  float* rows = reinterpret_cast<float*>(smem);
  float* win = rows + R * S::kRowFloats;
  float* red = win + S::kWin;
  float* sums = red + 2 * S::kWarps;  // [R][SQ][BINS]
  const int tx = static_cast<int>(threadIdx.x), ty = static_cast<int>(threadIdx.y);
  const int flat = ty * T + tx;
  const long long row = blockIdx.x / g.tiles;
  const int tile = static_cast<int>(blockIdx.x % g.tiles);
  const float* xb = g.x + static_cast<size_t>(row) * g.t;
  const float* yb = KIND == kCoh ? g.y + static_cast<size_t>(row) * g.t : nullptr;
  const int u0 = tile * g.iters * R;

  const float* w = g.w;
  if constexpr (R > 1) {  // the window, once for the block's rows
    for (int i = flat; i < g.nperseg; i += S::kBlock) win[i] = g.w[i];
    w = win;
  }
  float acc[RQ > 0 ? RQ : 1][PER + 1];
#pragma unroll
  for (int q = 0; q < (RQ > 0 ? RQ : 1); ++q)
#pragma unroll
    for (int i = 0; i <= PER; ++i) acc[q][i] = 0.f;
  float* mine = sums + ty * SQ * BINS;  // this row's shared sums
  for (int i = tx; i < SQ * BINS; i += T) mine[i] = 0.f;

  // sum q of bin k, the i-th this thread owns
  auto add = [&](int q, int i, int k, float v) {
    if (q < RQ) {
      acc[q < RQ ? q : 0][i] += v;
    } else {
      mine[(q - RQ) * BINS + k] += v;
    }
  };

  for (int it = 0; it < g.iters; ++it) {
    const int u = u0 + it * R + ty;
    const bool valid = u < g.units;
    const int uc = valid ? u : g.units - 1;  // past the last: the last again, nothing added
    const float* pa;
    const float* pb = nullptr;
    const bool swap = KIND == kCoh && (uc & 1);  // a = y, b = x
    if constexpr (KIND == kCoh) {
      pa = (swap ? yb : xb) + static_cast<size_t>(uc) * g.hop;
      pb = (swap ? xb : yb) + static_cast<size_t>(uc) * g.hop;
    } else if constexpr (S::kHalf) {
      pa = xb + static_cast<size_t>(uc) * g.hop;
    } else {
      pa = xb + static_cast<size_t>(2 * uc) * g.hop;
      if (2 * uc + 1 < g.num) pb = xb + static_cast<size_t>(2 * uc + 1) * g.hop;
    }
    float ma = 0.f, mb = 0.f;
    if (g.detrend) {
      for (int i = tx; i < g.nperseg; i += T) {
        ma += pa[i];
        if (pb != nullptr) mb += pb[i];
      }
#pragma unroll
      for (int o = (T < 32 ? T : 32) / 2; o > 0; o >>= 1) {
        ma += __shfl_xor_sync(0xffffffffu, ma, o);
        mb += __shfl_xor_sync(0xffffffffu, mb, o);
      }
      if constexpr (T > 32) {
        if ((flat & 31) == 0) {
          red[2 * (flat >> 5)] = ma;
          red[2 * (flat >> 5) + 1] = mb;
        }
      }
    }
    // the window and the warps' sums are in place, and the last round's
    // epilogue has read every row
    __syncthreads();
    if constexpr (T > 32) {
      if (g.detrend) {
        ma = mb = 0.f;
#pragma unroll
        for (int i = 0; i < T / 32; ++i) {
          ma += red[2 * (ty * (T / 32) + i)];
          mb += red[2 * (ty * (T / 32) + i) + 1];
        }
      }
    }
    const float n = static_cast<float>(g.nperseg);
    if constexpr (S::kHalf) {
      plan_fft<-1, LOG2N - 1>(AccRow<L, HalfIn>{HalfIn{pa, w, g.nperseg, ma / n}}, g.tw_m);
    } else {
      plan_fft<-1, LOG2N>(
          AccRow<L, TwoFramesIn>{TwoFramesIn{pa, pb, w, g.nperseg, ma / n, mb / n}}, g.tw);
    }
    // The last pass ended with a barrier: this row's Z is in shared memory.
    if (valid) {
      const PadShared z{smem + ty * padded_len(L)};
      // bin k, the i-th this thread owns
      auto bin = [&](int i, int k) {
        float ar, ai, cr, ci;
        if constexpr (S::kHalf) {  // B20's recombination of X[k] from Z[k], Z[L - k]
          z.load(k & (L - 1), ar, ai);
          z.load((L - k) & (L - 1), cr, ci);
          const float er = 0.5f * (ar + cr), ei = 0.5f * (ai - ci);
          const float dr = 0.5f * (ar - cr), di = 0.5f * (ai + ci);
          const float2 h = __ldg(&g.half[k]);
          const float xr = er + (h.x * di + h.y * dr);
          const float xi = ei - (h.x * dr - h.y * di);
          add(0, i, k, xr * xr + xi * xi);
        } else {
          z.load(k, ar, ai);
          z.load((N - k) & (N - 1), cr, ci);
          if constexpr (KIND == kWelch) {
            add(0, i, k, 0.5f * ((ar * ar + ai * ai) + (cr * cr + ci * ci)));
          } else {  // FFT(a) = (A + B)/2, FFT(b) = (A - B)/(2i), B = conj(c)
            const float fr = 0.5f * (ar + cr), fi = 0.5f * (ai - ci);
            const float hr = 0.5f * (ai + ci), hi = 0.5f * (cr - ar);
            const float pf = fr * fr + fi * fi, ph = hr * hr + hi * hi;
            const float im = fr * hi - fi * hr;
            add(0, i, k, fr * hr + fi * hi);  // Re conj(X) Y
            add(1, i, k, swap ? -im : im);    // Im conj(X) Y
            add(2, i, k, swap ? ph : pf);     // |X|^2
            add(3, i, k, swap ? pf : ph);     // |Y|^2
          }
        }
      };
#pragma unroll
      for (int i = 0; i < PER; ++i) bin(i, tx + i * T);
      if (tx == 0) bin(PER, N / 2);
    }
  }

  // The block's end: each row's sums in shared memory (the register ones
  // into the row's own buffer), then the rows summed in order into row 0's
  // places, then to device memory.
  __syncthreads();  // every epilogue has read its row
  float* regs = rows + ty * S::kRowFloats;  // [RQ][BINS]
#pragma unroll
  for (int q = 0; q < RQ; ++q) {
#pragma unroll
    for (int i = 0; i < PER; ++i) regs[q * BINS + tx + i * T] = acc[q][i];
    if (tx == 0) regs[q * BINS + N / 2] = acc[q][PER];
  }
  __syncthreads();
  auto at = [&](int q, int y, int k) -> float* {
    return q < RQ ? rows + y * S::kRowFloats + q * BINS + k
                  : sums + (y * SQ + q - RQ) * BINS + k;
  };
  const size_t orow = (static_cast<size_t>(row) * g.tiles + tile) * BINS;
  for (int e = flat; e < NQ * BINS; e += S::kBlock) {
    const int q = e / BINS, k = e - q * BINS;
    float s = *at(q, 0, k);
#pragma unroll
    for (int y = 1; y < R; ++y) s += *at(q, y, k);
    g.out[q][orow + k] = s;
  }
}

template <int LOG2N, int KIND>
cudaError_t allow_smem() {
  constexpr int smem = AccShape<LOG2N, KIND>::kSmem;
  if constexpr (smem > 48 * 1024) {
    return cudaFuncSetAttribute(welch_acc_kernel<LOG2N, KIND>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  return cudaSuccess;
}

// Transforms a row: B16's pairs of frames, or one a segment.
constexpr int units_of(int kind, int log2n, int num) {
  return kind == kWelch && !kWelchHalf[log2n - 7] ? (num + 1) / 2 : num;
}

template <int LOG2N, int KIND>
cudaError_t launch(AccArgs g, long long batch, cudaStream_t stream) {
  using S = AccShape<LOG2N, KIND>;
  auto* kernel = welch_acc_kernel<LOG2N, KIND>;
  const long long blocks = batch * g.tiles;
  if (blocks > 2147483647LL ||
      static_cast<long long>(g.tiles) * g.iters * S::kRows < g.units) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t e = allow_smem<LOG2N, KIND>();
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), dim3(S::kThreads, S::kRows), S::kSmem, stream>>>(g);
  return cudaGetLastError();
}

// Rounds a block (iters) and blocks a row (tiles) for `num` segments of
// `batch` rows on the current device: blocks enough for one wave of the
// card's SMs at the kernel's occupancy where the rows have units enough (no
// block past the wave), and the fewest rounds that cover a row's units with
// them.
template <int LOG2N, int KIND>
cudaError_t shape_for(long long batch, int num, int* iters, int* tiles) {
  using S = AccShape<LOG2N, KIND>;
  cudaError_t e = allow_smem<LOG2N, KIND>();
  int per_sm = 0, dev = 0, sms = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, welch_acc_kernel<LOG2N, KIND>,
                                                      S::kBlock, S::kSmem);
  }
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int units = units_of(KIND, LOG2N, num);
  const long long most = (units + S::kRows - 1) / S::kRows;  // one round a block
  const long long slots = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  long long want = slots / batch;
  want = want < 1 ? 1 : want > most ? most : want;
  const long long per = S::kRows * want;
  *iters = static_cast<int>((units + per - 1) / per);
  const long long round = static_cast<long long>(S::kRows) * *iters;
  *tiles = static_cast<int>((units + round - 1) / round);
  return cudaSuccess;
}

#define ACC_LOG2N_CASES(CASE) \
  CASE(7) CASE(8) CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14)

template <int KIND>
int dispatch(AccArgs g, long long batch, int log2n, void* stream) {
  const long long nfft = 1LL << log2n;
  if (log2n < 7 || log2n > 14 || batch < 1 || g.nperseg < 1 || g.nperseg > nfft ||
      g.hop < 1 || g.hop > g.nperseg || g.num < 1 || g.t < g.nperseg ||
      static_cast<long long>(g.num - 1) * g.hop + g.nperseg > g.t ||
      (g.detrend != 0 && g.detrend != 1) || g.iters < 1 || g.tiles < 1 ||
      (KIND == kCoh && g.y == nullptr)) {
    return cudaErrorInvalidValue;
  }
  g.units = units_of(KIND, log2n, g.num);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (log2n) {
#define ACC_CASE(L) \
  case L: return launch<L, KIND>(g, batch, s);
    ACC_LOG2N_CASES(ACC_CASE)
#undef ACC_CASE
    default: return cudaErrorInvalidValue;
  }
}

template <int KIND>
int shape_dispatch(long long batch, int num, int log2n, int* iters, int* tiles) {
  switch (log2n) {
#define SHAPE_CASE(L) \
  case L: return shape_for<L, KIND>(batch, num, iters, tiles);
    ACC_LOG2N_CASES(SHAPE_CASE)
#undef SHAPE_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Kind 0 (B16): o0 = sums over segments of |X|^2 of the `batch` contiguous
// rows x of t float32 points; kind 1 (B18): o0, o1 = Re, Im of conj(X) Y,
// o2, o3 = |X|^2, |Y|^2 of the rows x and y of one shape.  Window w of
// nperseg points, nfft = 2^log2n (128 .. 16384), 0 < hop <= nperseg <=
// min(nfft, t), each frame less its mean when detrend is 1.  tw holds the
// pass roots of nfft, tw_m those of nfft/2 and half the nfft/2 + 1 roots
// exp(-2pi*i*k/nfft) (the last two for the half-length design), all
// interleaved (cos, sin) float32 pairs.  The grid is batch * tiles blocks
// of iters rounds each (welch_acc_shape); each output is [batch, tiles,
// nfft/2 + 1], one row a block.
// Launches on `stream` and returns cudaGetLastError() (0 = ok).
int welch_acc_f32(int kind, const void* x, const void* y, const void* w, void* o0, void* o1,
                  void* o2, void* o3, const void* tw, const void* tw_m, const void* half,
                  long long batch, long long t, int nperseg, int hop, int num, int log2n,
                  int detrend, int iters, int tiles, void* stream) {
  AccArgs g{static_cast<const float*>(x),
            static_cast<const float*>(y),
            static_cast<const float*>(w),
            {static_cast<float*>(o0), static_cast<float*>(o1), static_cast<float*>(o2),
             static_cast<float*>(o3)},
            static_cast<const float2*>(tw),
            static_cast<const float2*>(tw_m),
            static_cast<const float2*>(half),
            t, nperseg, hop, num, 0, iters, tiles, detrend};
  switch (kind) {
    case kWelch: return dispatch<kWelch>(g, batch, log2n, stream);
    case kCoh: return dispatch<kCoh>(g, batch, log2n, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The launch shape of kind `kind` (0 welch, 1 coh) for `num` segments of
// `batch` rows at nfft = 2^log2n on the current device: *iters and *tiles.
// Returns a CUDA error (0 = ok).
int welch_acc_shape(int kind, long long batch, int num, int log2n, int* iters, int* tiles) {
  if (batch < 1 || num < 1) return cudaErrorInvalidValue;
  switch (kind) {
    case kWelch: return shape_dispatch<kWelch>(batch, num, log2n, iters, tiles);
    case kCoh: return shape_dispatch<kCoh>(batch, num, log2n, iters, tiles);
    default: return cudaErrorInvalidValue;
  }
}

const char* welch_acc_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

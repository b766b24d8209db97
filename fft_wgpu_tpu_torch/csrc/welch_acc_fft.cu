// Welch's, csd's and coherence's segment sums on the compiled pow2 passes:
// two real frames transformed as one complex frame (two-sided: one complex
// frame a segment), the power or cross products of every segment summed per
// bin, in one pass over the signal.
//
// Replaces the TPU kernels of fft_wgpu_tpu/ops/pallas_welch.py:
//   welch_acc_f32 kind 0 (B16)  welch_accum_split, kernel _kernel_welch_accum
//   welch_acc_f32 kind 1 (B18)  coherence_accum_split, kernel _kernel_coh_accum
//   welch_acc_f32 kind 2 (B17)  csd_accum_split, kernel _kernel_csd_accum
//   welch_acc_f32 kind 3 and welch_acc_c64 (B21)  welch_accum_c2c_split,
//                               kernel _kernel_welch_accum_c2c
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
//        every other segment swaps them and the bias cancels;
//   B17 (csd): B18's frames, swapped alike, and Re and Im of conj(X) Y
//        alone summed.
// B21 (c2c) transforms one complex frame a segment, the planes re and im of
// a complex signal each framed and detrended on their own (B22's source,
// C2cFrameIn: planes, a null im a zero plane none of it read, or the
// complex64 signal as it lies), and sums |Z[k]|^2 over the segments for all
// nfft bins in natural order.
// One transform a pair of frames (B21: a segment), no recombination table;
// at nfft 8192 and 16384 B16 instead runs B20's half-length transform of
// each frame and recombines its bins, X[k] = (Z[k] + conj Z[m-k])/2 - (i/2)
// t[k] (Z[k] - conj Z[m-k]), m = nfft/2, t[k] = exp(-2 pi i k/nfft)
// (kWelchHalf; both designs timed by scripts/time_pow2_variants.py --lib
// welch_acc_fft).
//
// What bounds it: device memory, 4*hop (B17, B18, B21: 8*hop) bytes of new
// signal a segment against about 2.5*nfft*log2(nfft) (B17, B18, B21:
// 5*...) flops, so at half overlap a kernel at its bound reads each signal
// once.  The block is B22's (spec_c2c_fft.cu): nfft's compiled plan
// (mixed_fft.cuh's plan_fft) at nfft/16 threads a transform and 16 points a
// thread, several transforms a block (one per threadIdx.y) so that it has
// at least 128 threads, a launch bound per kind and nfft (kRegisters), each
// frame detrended and windowed in the first pass's loads, each plane's mean
// by warp shuffles and at most one step through shared memory.  The last
// pass stores to the padded shared row (PadShared); after its barrier the
// epilogue reads Z[k] and Z[nfft - k].  B21's last pass instead adds |Z[k]|^2
// straight into the row's sums (PowerSumOut): one barrier and two shared
// accesses a point fewer than an epilogue.  A fixed thread
// owns each bin (k = threadIdx.x + i*T, and nfft/2 for threadIdx.x = 0 of
// the half-spectrum kinds; B21: the bins its last pass stores) across all
// the transforms of its row of the block: its sums sit in registers or in
// shared memory (kRegSums), each thread on its own bins, so there is no
// atomic.  A block takes `iters` rounds of its rows; at its end it sums its
// rows in order and writes one row.  out[q] is [batch, tiles, bins] (bins
// nfft/2 + 1, B21 nfft), which the caller sums over its middle axis in a
// fixed order (a thread-block cluster adding its blocks' rows through
// distributed shared memory measured slower at every shape timed).  A rerun
// gives the same bits.

#include <cuda_runtime.h>

#include "mixed_fft.cuh"

namespace {

using namespace fftk;

enum Kind { kWelch = 0, kCoh = 1, kCsd = 2, kC2c = 3 };

// B16's transform per nfft = 2^7 .. 2^14: B20's half-length transform of
// each frame and the recombination of its bins (true; measured faster at
// 8192 and 16384), or two frames as one complex frame.
constexpr bool kWelchHalf[8] = {false, false, false, false, false, false, true, true};

// How many of a kind's sums (B16: 1; B18: 4; B17: 2; B21: 1) each thread
// keeps in registers, per nfft = 2^7 .. 2^14; the others live in shared
// memory, where they measured faster but for B16 at 128 and 256, B18 at 128
// and B17 below 16384 (at its 128 registers a thread).  At 16384 B18's four
// planes of sums do not fit beside the row in shared memory, so two stay in
// registers there; B17's two fit, and spill in registers (64 a thread).  B21's
// last pass adds into shared sums (an epilogue reading the row it stored,
// its sums in registers or shared memory, measured 4-28% slower at every
// nfft and was removed).
constexpr int kRegSums[4][8] = {{1, 1, 0, 0, 0, 0, 0, 0},   // welch
                                {4, 0, 0, 0, 0, 0, 0, 2},   // coh
                                {2, 2, 2, 2, 2, 2, 2, 0},   // csd
                                {0, 0, 0, 0, 0, 0, 0, 0}};  // c2c

// Per kind and nfft = 2^7 .. 2^14: the registers a thread that the launch
// bound allows (64: eight blocks of 128 threads an SM; 85: six of 128,
// three of 256; 128: four of 128, two of 256, one of 512; at 16384, 64: one
// block of 1024; scripts/time_pow2_variants.py --lib welch_acc_fft).
constexpr int kRegisters[4][8] = {{85, 85, 85, 85, 85, 85, 64, 64},         // welch
                                  {85, 85, 85, 85, 85, 85, 64, 64},         // coh
                                  {128, 128, 128, 128, 128, 128, 128, 64},  // csd
                                  {85, 64, 128, 128, 128, 128, 128, 64}};   // c2c

// The launch shape of kind KIND at nfft = 2^LOG2N: the transform's length
// L (nfft, or nfft/2 for the half-length design), threads a transform (16
// points each), transforms a block, the bins a thread owns (below nfft/2
// for the half-spectrum kinds, whose bin nfft/2 is thread 0's), and the
// shared memory: the rows (each also holding its row's register sums at the
// block's end), the window (a block of several rows), two floats a warp for
// the means, the shared sums [rows][NQ - RQ][bins].
template <int LOG2N, int KIND>
struct AccShape {
  static constexpr bool kHalf = KIND == kWelch && kWelchHalf[LOG2N - 7];
  static constexpr bool kTwo = KIND == kCoh || KIND == kCsd;  // x and y, swapped on odd s
  static constexpr bool kNyquist = KIND != kC2c;  // the half spectrum's bin nfft/2
  static constexpr int kLog2L = kHalf ? LOG2N - 1 : LOG2N;
  static constexpr int kL = 1 << kLog2L;
  static constexpr int kN = 1 << LOG2N;
  static constexpr int kBins = kNyquist ? kN / 2 + 1 : kN;
  static constexpr int kThreads = kL / 16;
  static constexpr int kRows = kThreads >= 128 ? 1 : 128 / kThreads;
  static constexpr int kBlock = kThreads * kRows;
  static constexpr int kRegs = kRegisters[KIND][LOG2N - 7];
  static constexpr int kMinBlocks = 65536 / (kRegs * kBlock) > 0 ? 65536 / (kRegs * kBlock) : 1;
  static constexpr int kPer = (kNyquist ? kBins - 1 : kBins) / kThreads;
  static constexpr int kNQ = KIND == kCoh ? 4 : KIND == kCsd ? 2 : 1;
  static constexpr int kRegQ = kRegSums[KIND][LOG2N - 7];
  static constexpr int kSmemQ = kNQ - kRegQ;
  static constexpr int kRowFloats = 2 * padded_len(kL);
  static constexpr int kWin = kRows > 1 ? kN : 0;
  static constexpr int kWarps = kBlock / 32 > 0 ? kBlock / 32 : 1;
  static constexpr int kSmem =
      (kRows * kRowFloats + kWin + 2 * kWarps + kRows * kSmemQ * kBins) *
      static_cast<int>(sizeof(float));
  static_assert(kRowFloats >= kRegQ * kBins, "a row's buffer holds its register sums");
  static_assert(KIND != kC2c || kRegQ == 0, "B21's last pass adds into shared sums");
};

struct AccArgs {
  const float* x;      // [batch, t]; B21's planar source: the real plane
  const float* y;      // B17's and B18's second signal; B21's imaginary plane or null
  const float2* z;     // B21's complex64 source [batch, t]
  const float* w;      // the window, nperseg points
  float* out[4];       // [batch, tiles, bins] each
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

// B21's last pass: |Z[k]|^2 added into the row's sums in shared memory.
// A row's bin k is stored by one thread in every round, so no two threads
// add to one sum; nothing for a transform past the row's last.
struct PowerSumOut {
  float* sums;
  bool valid;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void store(int k, float a, float b) const {
    if (valid) sums[k] += a * a + b * b;
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

// B21's transform: its last pass adds into the row's sums.
template <int L, class In>
struct PowerRow : AccRow<L, In> {
  PowerSumOut out;
  __device__ __forceinline__ PowerSumOut dst() const { return out; }
};

template <int LOG2N, int KIND, bool IN_C64>
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
  const size_t base = static_cast<size_t>(row) * g.t;
  const float* xb = IN_C64 ? nullptr : g.x + base;
  const float* yb = S::kTwo || g.y != nullptr ? g.y + base : nullptr;
  const float2* zb = IN_C64 ? g.z + base : nullptr;
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
    const size_t off = static_cast<size_t>(uc) * g.hop;
    const float* pa = nullptr;
    const float* pb = nullptr;
    const float2* pz = nullptr;
    const bool swap = S::kTwo && (uc & 1);  // a = y, b = x
    if constexpr (S::kTwo) {
      pa = (swap ? yb : xb) + off;
      pb = (swap ? xb : yb) + off;
    } else if constexpr (KIND == kC2c) {
      if constexpr (IN_C64) {
        pz = zb + off;
      } else {
        pa = xb + off;
        if (yb != nullptr) pb = yb + off;
      }
    } else if constexpr (S::kHalf) {
      pa = xb + off;
    } else {
      pa = xb + static_cast<size_t>(2 * uc) * g.hop;
      if (2 * uc + 1 < g.num) pb = xb + static_cast<size_t>(2 * uc + 1) * g.hop;
    }
    float ma = 0.f, mb = 0.f;
    if (g.detrend) {
      if constexpr (IN_C64) {
        for (int i = tx; i < g.nperseg; i += T) {
          const float2 p = pz[i];
          ma += p.x;
          mb += p.y;
        }
      } else {
        for (int i = tx; i < g.nperseg; i += T) {
          ma += pa[i];
          if (pb != nullptr) mb += pb[i];
        }
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
    // epilogue (or last pass) has read every row
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
    } else if constexpr (KIND == kC2c) {
      plan_fft<-1, LOG2N>(PowerRow<L, C2cFrameIn<IN_C64>>{
                              {C2cFrameIn<IN_C64>{pa, pb, pz, w, g.nperseg, ma / n, mb / n}},
                              PowerSumOut{mine, valid}},
                          g.tw);
    } else {
      plan_fft<-1, LOG2N>(
          AccRow<L, TwoFramesIn>{TwoFramesIn{pa, pb, w, g.nperseg, ma / n, mb / n}}, g.tw);
    }
    // The last pass into the row ended with a barrier: this row's Z is in
    // shared memory (B21's last pass has added its sums).
    if constexpr (KIND != kC2c) {
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
              const float im = fr * hi - fi * hr;
              add(0, i, k, fr * hr + fi * hi);  // Re conj(X) Y
              add(1, i, k, swap ? -im : im);    // Im conj(X) Y
              if constexpr (KIND == kCoh) {
                const float pf = fr * fr + fi * fi, ph = hr * hr + hi * hi;
                add(2, i, k, swap ? ph : pf);  // |X|^2
                add(3, i, k, swap ? pf : ph);  // |Y|^2
              }
            }
          }
        };
#pragma unroll
        for (int i = 0; i < PER; ++i) bin(i, tx + i * T);
        if (tx == 0) bin(PER, N / 2);
      }
    }
  }

  // The block's end: each row's sums in shared memory (the register ones
  // into the row's own buffer), then the rows summed in order into row 0's
  // places, then to device memory.
  __syncthreads();  // every epilogue (or last pass) has read its row
  float* regs = rows + ty * S::kRowFloats;  // [RQ][BINS]
#pragma unroll
  for (int q = 0; q < RQ; ++q) {
#pragma unroll
    for (int i = 0; i < PER; ++i) regs[q * BINS + tx + i * T] = acc[q][i];
    if (S::kNyquist && tx == 0) regs[q * BINS + N / 2] = acc[q][PER];
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

template <int LOG2N, int KIND, bool IN_C64>
cudaError_t allow_smem() {
  constexpr int smem = AccShape<LOG2N, KIND>::kSmem;
  if constexpr (smem > 48 * 1024) {
    return cudaFuncSetAttribute(welch_acc_kernel<LOG2N, KIND, IN_C64>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  return cudaSuccess;
}

// Transforms a row: B16's pairs of frames, or one a segment.
constexpr int units_of(int kind, int log2n, int num) {
  return kind == kWelch && !kWelchHalf[log2n - 7] ? (num + 1) / 2 : num;
}

template <int LOG2N, int KIND, bool IN_C64>
cudaError_t launch(AccArgs g, long long batch, cudaStream_t stream) {
  using S = AccShape<LOG2N, KIND>;
  auto* kernel = welch_acc_kernel<LOG2N, KIND, IN_C64>;
  const long long blocks = batch * g.tiles;
  if (blocks > 2147483647LL ||
      static_cast<long long>(g.tiles) * g.iters * S::kRows < g.units) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t e = allow_smem<LOG2N, KIND, IN_C64>();
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), dim3(S::kThreads, S::kRows), S::kSmem, stream>>>(g);
  return cudaGetLastError();
}

// Rounds a block (iters) and blocks a row (tiles) for `num` segments of
// `batch` rows on the current device: blocks enough for one wave of the
// card's SMs at the kernel's occupancy where the rows have units enough (no
// block past the wave), and the fewest rounds that cover a row's units with
// them.  B21's two sources share the shape, the planar kernel's.
template <int LOG2N, int KIND>
cudaError_t shape_for(long long batch, int num, int* iters, int* tiles) {
  using S = AccShape<LOG2N, KIND>;
  cudaError_t e = allow_smem<LOG2N, KIND, false>();
  int per_sm = 0, dev = 0, sms = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, welch_acc_kernel<LOG2N, KIND, false>, S::kBlock, S::kSmem);
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

template <int KIND, bool IN_C64>
int dispatch(AccArgs g, long long batch, int log2n, void* stream) {
  const long long nfft = 1LL << log2n;
  if (log2n < 7 || log2n > 14 || batch < 1 || g.nperseg < 1 || g.nperseg > nfft ||
      g.hop < 1 || g.hop > g.nperseg || g.num < 1 || g.t < g.nperseg ||
      static_cast<long long>(g.num - 1) * g.hop + g.nperseg > g.t ||
      (g.detrend != 0 && g.detrend != 1) || g.iters < 1 || g.tiles < 1 ||
      (IN_C64 ? g.z == nullptr || g.x != nullptr || g.y != nullptr
              : g.x == nullptr || g.z != nullptr) ||
      ((KIND == kCoh || KIND == kCsd) && g.y == nullptr)) {
    return cudaErrorInvalidValue;
  }
  g.units = units_of(KIND, log2n, g.num);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (log2n) {
#define ACC_CASE(L) \
  case L: return launch<L, KIND, IN_C64>(g, batch, s);
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
// o2, o3 = |X|^2, |Y|^2 of the rows x and y of one shape; kind 2 (B17): o0,
// o1 = Re, Im of conj(X) Y; kind 3 (B21): o0 = sums over segments of
// |X|^2 over all nfft bins of the complex rows with planes x and y (y null:
// a zero plane, none of it read).  Window w of nperseg points, nfft =
// 2^log2n (128 .. 16384), 0 < hop <= nperseg <= min(nfft, t), each frame
// (each plane) less its mean when detrend is 1.  tw holds the pass roots of
// nfft, tw_m those of nfft/2 and half the nfft/2 + 1 roots
// exp(-2pi*i*k/nfft) (the last two for the half-length design), all
// interleaved (cos, sin) float32 pairs.  The grid is batch * tiles blocks
// of iters rounds each (welch_acc_shape); each output is [batch, tiles,
// bins], one row a block, bins = nfft/2 + 1 (kind 3: nfft).
// Launches on `stream` and returns cudaGetLastError() (0 = ok).
int welch_acc_f32(int kind, const void* x, const void* y, const void* w, void* o0, void* o1,
                  void* o2, void* o3, const void* tw, const void* tw_m, const void* half,
                  long long batch, long long t, int nperseg, int hop, int num, int log2n,
                  int detrend, int iters, int tiles, void* stream) {
  AccArgs g{static_cast<const float*>(x),
            static_cast<const float*>(y),
            nullptr,
            static_cast<const float*>(w),
            {static_cast<float*>(o0), static_cast<float*>(o1), static_cast<float*>(o2),
             static_cast<float*>(o3)},
            static_cast<const float2*>(tw),
            static_cast<const float2*>(tw_m),
            static_cast<const float2*>(half),
            t, nperseg, hop, num, 0, iters, tiles, detrend};
  switch (kind) {
    case kWelch: return dispatch<kWelch, false>(g, batch, log2n, stream);
    case kCoh: return dispatch<kCoh, false>(g, batch, log2n, stream);
    case kCsd: return dispatch<kCsd, false>(g, batch, log2n, stream);
    case kC2c: return dispatch<kC2c, false>(g, batch, log2n, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Kind 3 (B21) from the complex64 rows z (interleaved (re, im) float32
// pairs, 8-byte aligned) as they lie: o0 = [batch, tiles, nfft] sums over
// segments of |X|^2, the grid and the rest as welch_acc_f32's.
int welch_acc_c64(const void* z, const void* w, void* o0, const void* tw, long long batch,
                  long long t, int nperseg, int hop, int num, int log2n, int detrend,
                  int iters, int tiles, void* stream) {
  AccArgs g{nullptr,
            nullptr,
            static_cast<const float2*>(z),
            static_cast<const float*>(w),
            {static_cast<float*>(o0), nullptr, nullptr, nullptr},
            static_cast<const float2*>(tw),
            nullptr,
            nullptr,
            t, nperseg, hop, num, 0, iters, tiles, detrend};
  return dispatch<kC2c, true>(g, batch, log2n, stream);
}

// The launch shape of kind `kind` (0 welch, 1 coh, 2 csd, 3 c2c) for `num`
// segments of `batch` rows at nfft = 2^log2n on the current device: *iters
// and *tiles.  Returns a CUDA error (0 = ok).
int welch_acc_shape(int kind, long long batch, int num, int log2n, int* iters, int* tiles) {
  if (batch < 1 || num < 1) return cudaErrorInvalidValue;
  switch (kind) {
    case kWelch: return shape_dispatch<kWelch>(batch, num, log2n, iters, tiles);
    case kCoh: return shape_dispatch<kCoh>(batch, num, log2n, iters, tiles);
    case kCsd: return shape_dispatch<kCsd>(batch, num, log2n, iters, tiles);
    case kC2c: return shape_dispatch<kC2c>(batch, num, log2n, iters, tiles);
    default: return cudaErrorInvalidValue;
  }
}

const char* welch_acc_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

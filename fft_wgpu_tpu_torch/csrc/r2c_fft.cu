// Batched real-to-complex FFT along the last axis through a half-length
// complex FFT.
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/pallas_fft.py::_rfft_rows_core
// (its pl.pallas_call over _kernel_r2c_bal, _kernel_r2c_pipe and
// _kernel_r2c) for pow2 n = 2^7 .. 2^14.  Per real row x of n points it
// computes the half spectrum
//
//     X[k] = scale * sum_j x[j] * exp(-2*pi*i * k*j / n),   k = 0 .. n/2,
//
// into either of two layouts: planar float32 rows of `bins` floats
// (r2c_fft_f32; n/2 + 1, numpy's shape, or the padded serving form
// pad_bins(n) with exact zeros past bin n/2), or interleaved complex64 rows
// of n/2 + 1 points, one 8-byte pair a bin (r2c_fft_c64, the torch
// complex64 tensor that rfft returns, so the caller needs no merge).
//
// The n real points are read as m = n/2 complex points z[j] = x[2j] +
// i x[2j+1], one 8-byte load a point, by the first pass; the m-point
// forward transform Z runs on mixed_fft.cuh's compiled plan for m
// (plan_radix; 2048 = 16*16*8) over the row held in shared memory as padded
// interleaved pairs (PadShared), m/16 threads a row and 16 points a thread,
// with each pass's twiddles in a table of its own (the host's
// ops/cuda_fft.py::_pass_roots_np(m, -1)), and the spectrum is
//
//     X[k] = E + u + i (E' - v),   X[m-k] = E - u - i (E' + v),
//
// with E = (Re Z[k] + Re Z[m-k])/2, E' = (Im Z[k] - Im Z[m-k])/2, D =
// (Re Z[k] - Re Z[m-k])/2, D' = (Im Z[k] + Im Z[m-k])/2, u = Re t D' +
// Im t D, v = Re t D - Im t D', t = t[k] = exp(-2*pi*i*k/n) (so that
// t[m-k] = -conj(t[k])), Z[m] = Z[0]: one pair of bins from one pair of
// Z's and one root (the math of fft_wgpu_tpu/ops/rfft.py::_rfft_even_split,
// in one pass), the scale folded in.  The roots come from a float32 table
// generated in float64 on the host.  The TPU kernel contracted with real
// DFT matrices because Mosaic has no lane reverse; Z[m-k] is a reversed
// read here.
//
// What bounds it: device memory, 4 bytes read and 8*(n/2+1)/n written per
// point against about 2.5*log2(n) flops (4096 x 4096: 0.040 ms at 3.35
// TB/s).  Each row lives in shared memory (m*8.5 bytes, 68 KB at n =
// 16384); each m has its own launch bound (R2cShape, as the row kernel's).
// At n = 4096 and 16384 the plan's last pass (of radix 8) is fused with the
// recombination (fused_last): a thread holds butterflies j and NS - j (NS =
// m/8), whose outputs are the Z[k] and Z[m-k] of eight pairs of bins, and
// stores X from registers to device memory, consecutive lanes on
// consecutive bins, as the row kernel's last pass stores its row: no store
// phase, no barrier and no second read of shared memory.  Elsewhere every
// pass writes shared memory and the store sweeps the block's rows in order
// (rows of 4 to 64 threads share a block, one per threadIdx.y, at least 128
// threads a block), consecutive threads on consecutive bins: a pair of bins
// (k, m-k) a thread, one root for the two, or at n = 128 and 256 a bin a
// thread; r2c_store holds the choice, the fastest at each n.  Rows past the
// last read row 0 and store nothing.

#include <cuda_runtime.h>

#include "mixed_fft.cuh"

namespace {

using namespace fftk;

// The launch shape of m = 2^LOG2M half-length points: threads a row (16
// points each), rows a block, and the blocks an SM that the launch bound
// asks registers for.
template <int LOG2M>
struct R2cShape {
  static constexpr int kThreads = (1 << LOG2M) / 16;
  static constexpr int kRows = kThreads >= 128 ? 1 : 128 / kThreads;
  static constexpr int kBlock = kThreads * kRows;
  static constexpr int kMinBlocks = kBlock <= 128 ? 6 : kBlock == 256 ? 3 : 1024 / kBlock;
  static constexpr int kSmem = kRows * padded_len(1 << LOG2M) * static_cast<int>(sizeof(float2));
};

// Where the last pass of m's compiled plan begins in its twiddle table:
// the passes before it with NS > 1 hold NS*(R - 1) roots each.
__host__ __device__ constexpr int last_pass_off(int log2m) {
  int ns = 1, off = 0;
  for (int p = 0; p + 1 < kPlanMax && plan_radix(log2m, p + 1) != 0; ++p) {
    if (ns > 1) off += ns * (plan_radix(log2m, p) - 1);
    ns *= plan_radix(log2m, p);
  }
  return off;
}

// How the kernel of m = 2^log2m stores its bins, both sinks alike (so the
// two give the same bits): kFusedStore, the last pass fused with the store
// (fused_last; only where that pass is of radix 8, so that a row's m/16
// threads hold its m/8 butterflies two each, and a row has a warp or more);
// kPairStore, a pair of bins (k, m - k) a thread after the passes
// (pair_store); kBinStore, a bin a thread after the passes (bin_store).  The
// fastest of the three on an H100 at 2^24 points, both sinks
// (scripts/time_pow2_variants.py --lib r2c_fft): the bin store at m = 64,
// 128, pairs at 256, 512, 1024 and 4096, the fused last pass at 2048 and
// 8192.
constexpr int kFusedStore = 0, kPairStore = 1, kBinStore = 2;
__host__ __device__ constexpr int r2c_store(int log2m) {
  constexpr int t[8] = {2, 2, 1, 1, 1, 0, 1, 0};
  return t[log2m - 6];
}

// m's plan: its passes, the radix of the last, that pass's NS and where its
// twiddles begin, and whether the last pass may be fused with the store.
template <int LOG2M>
struct R2cPlan {
  static constexpr int kM = 1 << LOG2M;
  static constexpr int kPasses = plan_radix(LOG2M, 3) ? 4 : plan_radix(LOG2M, 2) ? 3 : 2;
  static constexpr int kLast = plan_radix(LOG2M, kPasses - 1);
  static constexpr int kNs = kM / kLast;
  static constexpr int kOff = last_pass_off(LOG2M);
  static constexpr bool kFusable = kLast == 8 && kM / 16 >= 32;
};

struct R2cArgs {
  const float2* in;  // real rows, read as (x[2j], x[2j+1]) pairs
  float* out_re;     // planar layout, rows of `bins`
  float* out_im;
  float2* out;       // interleaved layout, rows of m + 1
  const float2* tw;    // _pass_roots_np(m, -1)
  const float2* half;  // exp(-2pi*i*k/n), k = 0 .. m
  long long rows;
  int bins;
  float scale;
};

// The row in device memory as m complex points, read by the first pass.
struct PairIn {
  const float2* p;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    const float2 v = p[k];
    a = v.x;
    b = v.y;
  }
};

// This thread's row (one per threadIdx.y): its source and its buffer, the
// sink of the passes that run to shared memory too.  A row past the last
// reads row 0 (and the store skips it).
template <int LOG2M>
struct R2cRow {
  const R2cArgs& g;
  static constexpr int M = 1 << LOG2M;
  __device__ __forceinline__ long long row() const {
    return static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  }
  __device__ __forceinline__ bool valid() const { return row() < g.rows; }
  __device__ __forceinline__ PadShared shared() const {
    extern __shared__ float2 smem[];
    return PadShared{smem + threadIdx.y * padded_len(M)};
  }
  __device__ __forceinline__ PairIn src() const {
    return PairIn{g.in + static_cast<size_t>(valid() ? row() : 0) * M};
  }
  __device__ __forceinline__ PadShared dst() const { return shared(); }
};

// Bins k and m - k of one output row from Z[k] = (ar, ai), Z[m-k] = (br,
// bi) and t[k]; k = m/2 (ONE) stores bin k alone.
template <bool C64, bool ONE = false>
__device__ __forceinline__ void store_pair(const R2cArgs& g, size_t o, int k, int m, float ar,
                                           float ai, float br, float bi) {
  const float er = 0.5f * (ar + br), ei = 0.5f * (ai - bi);
  const float dr = 0.5f * (ar - br), di = 0.5f * (ai + bi);
  const float2 t = __ldg(&g.half[k]);
  const float u = t.x * di + t.y * dr, v = t.x * dr - t.y * di;
  const float s = g.scale;
  if constexpr (C64) {
    g.out[o + k] = make_float2((er + u) * s, (ei - v) * s);
    if constexpr (!ONE) g.out[o + m - k] = make_float2((er - u) * s, -(ei + v) * s);
  } else {
    g.out_re[o + k] = (er + u) * s;
    g.out_im[o + k] = (ei - v) * s;
    if constexpr (!ONE) {
      g.out_re[o + m - k] = (er - u) * s;
      g.out_im[o + m - k] = -(ei + v) * s;
    }
  }
}

// Every pass of m's plan but the last, the row's source to its shared
// buffer.
template <int LOG2M, class Row>
__device__ __forceinline__ void head_passes(const Row& row, const float2* __restrict__ tw) {
  using P = R2cPlan<LOG2M>;
  constexpr int M = P::kM;
  constexpr int r0 = plan_radix(LOG2M, 0), r1 = plan_radix(LOG2M, 1);
  constexpr int r2 = plan_radix(LOG2M, 2);
  if constexpr (P::kPasses == 2) {
    fixed_passes<-1, M, 1, 0, r0>(row.src(), row, tw);
  } else if constexpr (P::kPasses == 3) {
    fixed_passes<-1, M, 1, 0, r0, r1>(row.src(), row, tw);
  } else {
    fixed_passes<-1, M, 1, 0, r0, r1, r2>(row.src(), row, tw);
  }
}

// The last pass of radix 8 and the store: thread t holds butterflies t and
// NS - t (thread 0: 0 and NS/2) of the pass (inputs and outputs at j +
// k*NS), so that Z[t + k*NS] and Z[m - t - k*NS], the outputs k and 7 - k
// of its two butterflies, are in its registers for k < 8, and it stores
// those sixteen bins (thread 0 seventeen: 0, m, m/2 and its own pairs).
template <int LOG2M, bool C64>
__device__ __forceinline__ void fused_last(const R2cArgs& g) {
  using P = R2cPlan<LOG2M>;
  constexpr int M = P::kM, R = P::kLast, NS = P::kNs;
  static_assert(R == 8 && M / 16 * 2 == NS, "two butterflies of radix 8 a thread");
  extern __shared__ float2 smem[];
  const PadShared z{smem + threadIdx.y * padded_len(M)};
  const int t = threadIdx.x;
  float zr[2][R], zi[2][R];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int j = b == 0 ? t : t == 0 ? NS / 2 : NS - t;
#pragma unroll
    for (int k = 0; k < R; ++k) z.load(j + k * NS, zr[b][k], zi[b][k]);
#pragma unroll
    for (int k = 1; k < R; ++k) cmul(zr[b][k], zi[b][k], __ldg(&g.tw[P::kOff + (k - 1) * NS + j]));
    dft<R, -1>(zr[b], zi[b]);
  }
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (row >= g.rows) return;
  const int bins = C64 ? M + 1 : g.bins;
  const size_t o = static_cast<size_t>(row) * bins;
  if (t != 0) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      store_pair<C64>(g, o, t + k * NS, M, zr[0][k], zi[0][k], zr[1][R - 1 - k], zi[1][R - 1 - k]);
    }
  } else {
    // butterfly 0 holds Z[k*NS]: bins 0 and m (Z[m] = Z[0]), m/2 alone,
    // and the pairs (k, 8 - k); butterfly NS/2 the pairs (k, 7 - k)
    store_pair<C64>(g, o, 0, M, zr[0][0], zi[0][0], zr[0][0], zi[0][0]);
    store_pair<C64, true>(g, o, M / 2, M, zr[0][R / 2], zi[0][R / 2], zr[0][R / 2], zi[0][R / 2]);
#pragma unroll
    for (int k = 1; k < R / 2; ++k) {
      store_pair<C64>(g, o, k * NS, M, zr[0][k], zi[0][k], zr[0][R - k], zi[0][R - k]);
    }
#pragma unroll
    for (int k = 0; k < R / 2; ++k) {
      store_pair<C64>(g, o, NS / 2 + k * NS, M, zr[1][k], zi[1][k], zr[1][R - 1 - k],
                      zi[1][R - 1 - k]);
    }
  }
  if constexpr (!C64) {  // the padded form: exact zeros past bin m
    for (int k = M + 1 + t; k < bins; k += M / 16) {
      g.out_re[o + k] = 0.f;
      g.out_im[o + k] = 0.f;
    }
  }
}

// A store after every pass has written shared memory: the block's rows in
// order, a thread a bin, consecutive threads on consecutive bins (the
// padded form's zeros in the same sweep).
template <int LOG2M, bool C64>
__device__ __forceinline__ void bin_store(const R2cArgs& g) {
  constexpr int M = 1 << LOG2M;
  extern __shared__ float2 smem[];
  const long long row0 = static_cast<long long>(blockIdx.x) * blockDim.y;
  const long long left = g.rows - row0;
  const int rows = left < blockDim.y ? static_cast<int>(left) : static_cast<int>(blockDim.y);
  const int bins = C64 ? M + 1 : g.bins;
  const size_t o = static_cast<size_t>(row0) * bins;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < rows * bins; i += nthreads) {
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

// A store after every pass has written shared memory: the block's rows in
// order, a thread a pair of bins (k, m - k) for k = 0 .. m/2, consecutive
// threads on consecutive k, then the padded form's zeros.
template <int LOG2M, bool C64>
__device__ __forceinline__ void pair_store(const R2cArgs& g) {
  constexpr int M = 1 << LOG2M, H = M / 2 + 1;
  extern __shared__ float2 smem[];
  const long long row0 = static_cast<long long>(blockIdx.x) * blockDim.y;
  const long long left = g.rows - row0;
  const int rows = left < blockDim.y ? static_cast<int>(left) : static_cast<int>(blockDim.y);
  const int bins = C64 ? M + 1 : g.bins;
  const size_t o = static_cast<size_t>(row0) * bins;
  const int flat = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = flat; i < rows * H; i += nthreads) {
    const int r = i / H, k = i - r * H;
    const PadShared z{smem + r * padded_len(M)};
    float ar, ai, br, bi;
    z.load(k & (M - 1), ar, ai);
    z.load((M - k) & (M - 1), br, bi);
    if (k == M / 2) {
      store_pair<C64, true>(g, o + static_cast<size_t>(r) * bins, k, M, ar, ai, br, bi);
    } else {
      store_pair<C64>(g, o + static_cast<size_t>(r) * bins, k, M, ar, ai, br, bi);
    }
  }
  if constexpr (!C64) {
    const int pad = bins - (M + 1);
    for (int i = flat; i < rows * pad; i += nthreads) {
      const int r = i / pad, k = M + 1 + (i - r * pad);
      g.out_re[o + static_cast<size_t>(r) * bins + k] = 0.f;
      g.out_im[o + static_cast<size_t>(r) * bins + k] = 0.f;
    }
  }
}

template <int LOG2M, bool C64>
__global__ void __launch_bounds__(R2cShape<LOG2M>::kBlock, R2cShape<LOG2M>::kMinBlocks)
r2c_fft_kernel(const __grid_constant__ R2cArgs g) {
  constexpr int kStore = r2c_store(LOG2M);
  static_assert(kStore != kFusedStore || R2cPlan<LOG2M>::kFusable, "a fused last pass");
  if constexpr (kStore == kFusedStore) {
    head_passes<LOG2M>(R2cRow<LOG2M>{g}, g.tw);
    fused_last<LOG2M, C64>(g);
  } else {
    // the last pass ends with a barrier: Z of every row of the block is in
    // shared memory
    plan_fft<-1, LOG2M>(R2cRow<LOG2M>{g}, g.tw);
    if constexpr (kStore == kPairStore) {
      pair_store<LOG2M, C64>(g);
    } else {
      bin_store<LOG2M, C64>(g);
    }
  }
}

template <int LOG2M, bool C64>
cudaError_t launch(const R2cArgs& g, cudaStream_t stream) {
  using S = R2cShape<LOG2M>;
  auto* kernel = r2c_fft_kernel<LOG2M, C64>;
  const long long blocks = (g.rows + S::kRows - 1) / S::kRows;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  if constexpr (S::kSmem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), dim3(S::kThreads, S::kRows), S::kSmem, stream>>>(g);
  return cudaGetLastError();
}

template <bool C64>
int dispatch(const R2cArgs& g, int log2m, void* stream) {
  // the pairs are read as 8-byte loads
  if (g.rows < 1 || reinterpret_cast<size_t>(g.in) % 8 != 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (log2m) {
    case 6: return launch<6, C64>(g, s);
    case 7: return launch<7, C64>(g, s);
    case 8: return launch<8, C64>(g, s);
    case 9: return launch<9, C64>(g, s);
    case 10: return launch<10, C64>(g, s);
    case 11: return launch<11, C64>(g, s);
    case 12: return launch<12, C64>(g, s);
    case 13: return launch<13, C64>(g, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// R2C of `rows` contiguous real rows of n = 2^(log2m + 1) float32 points
// (8-byte aligned) into planar rows of `bins` >= n/2 + 1 floats (zeros past
// bin n/2).  tw holds the pass roots of m = n/2 (_pass_roots_np(m, -1)),
// half the m + 1 roots exp(-2pi*i*k/n), both interleaved (cos, sin) float32
// pairs.  Launches on `stream` and returns cudaGetLastError() (0 = ok).
int r2c_fft_f32(const void* in, void* out_re, void* out_im, const void* tw,
                const void* half, long long rows, int log2m, int bins,
                float scale, void* stream) {
  if (log2m < 6 || log2m > 13 || bins < (1 << log2m) + 1) return cudaErrorInvalidValue;
  const R2cArgs g{static_cast<const float2*>(in), static_cast<float*>(out_re),
                  static_cast<float*>(out_im), nullptr, static_cast<const float2*>(tw),
                  static_cast<const float2*>(half), rows, bins, scale};
  return dispatch<false>(g, log2m, stream);
}

// The same into interleaved complex64 rows of n/2 + 1 points.
int r2c_fft_c64(const void* in, void* out, const void* tw, const void* half, long long rows,
                int log2m, float scale, void* stream) {
  const R2cArgs g{static_cast<const float2*>(in), nullptr, nullptr, static_cast<float2*>(out),
                  static_cast<const float2*>(tw), static_cast<const float2*>(half), rows,
                  (1 << log2m) + 1, scale};
  return dispatch<true>(g, log2m, stream);
}

const char* r2c_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// The passes of Bluestein's algorithm and the chirp-z transform, each an
// m-point FFT on the mixed-radix Stockham passes of mixed_fft.cuh with its
// multiplies fused into the first pass's loads and the last pass's stores,
// and the two passes fused into one kernel.
//
// Replaces the TPU kernels fft_wgpu_tpu/ops/pallas_fft.py::_fft_filt_pad_core
// (B11, its pl.pallas_call over _kernel_rows_bal_filt_pad) and
// ::_fft_filt_narrow_core (B12, over _kernel_rows_bal_filt_narrow), which
// the JAX package's Bluestein and CZT run one after the other.  For
// m = 2^7 .. 2^14, per row:
//
//   chirp_fwd:   Y = FFT_s(zero_pad_m(h * x)),             x: rows of n_in <= m
//   chirp_inv:   y = g * (scale * FFT_s(H * x))[:n_out],   x: rows of m
//   chirp_full:  y = g * (scale * FFT_+(H * FFT_-(zero_pad_m(h * x))))[:n_out]
//
// h is [n_in], H is [m], g is [n_out], planar float32, broadcast over rows;
// n_in and n_out are any lengths up to m (the TPU kernels needed multiples
// of 128, so their callers padded the tables and sliced the result).
// chirp_fwd (sign -1) then chirp_inv (sign +1) is chirp_full: the JAX
// package's pair as Bluestein and CZT run it.  chirp_full needs no other
// signs: the chirp tables carry the transform's direction, and the adjoint
// of the (-, +) pair is again a (-, +) pair with conjugated tables.
//
// Each runs the passes of the plan ops/cuda_fft.py::_mixed_radix_plan(m)
// (8192 = 16*8*8*8: four passes of radix-16 and radix-8 butterflies held
// in registers, where radix-4 passes take seven), compiled in for each m
// (mixed_fft_fixed: every stride, mask and trip count a constant), with
// each pass's twiddles in a table of its own (_pass_roots_np); the plan
// table (plan_radix) and the padded shared row (PadShared) are
// mixed_fft.cuh's, shared with the row kernels.  The first
// pass loads through ProductIn: x[k]*h[k] for k < n_in and zeros beyond
// (the zero-pad is never written to device memory).  ChirpOut stores only
// the k < n_out outputs, as scale*y[k]*g[k].
//
// chirp_full holds the whole m-row in the block from the chirp to the
// post-chirp: the first transform's passes but the last run in shared
// memory; then one "turn" pass takes the last pass's butterfly (radix R at
// NS = m/R: it reads the row at j + k*m/R and leaves its outputs in natural
// order at those same points), multiplies by H there, and runs the second
// transform's first pass on them in registers (radix R at NS = 1, which
// reads exactly those points); the second transform's other passes (the
// plan in reverse order, _pass_roots_reversed_np) end in ChirpOut.  It
// reads n_in points a row and writes n_out; nothing of size m touches
// device memory, and the spectrum makes no round trip through shared
// memory between the two transforms.
//
// What bounds them on this card: device memory for the two passes apart
// (chirp_fwd reads n_in and writes m points a row, chirp_inv the reverse,
// 8 bytes a point: a Bluestein transform of n points moves 2n + 2m >= 6n
// points in two launches); chirp_full reads n_in and writes n_out points,
// so the two m-point FFTs' 10*m*log2(m) flops a row weigh as much (1024 x
// 4093, m = 8192: 0.0200 ms of bytes, 0.0163 ms of flops at 3.35 TB/s and
// 67 TFLOP/s), and in practice the shared-memory passes bound it.  The row
// sits in shared memory as interleaved (re, im) pairs, one 8-byte access a
// point, with a pad pair after every 16 (see PadShared): 68 KB at m = 8192,
// 136 KB at 16384.  The launch shape is mixed_shape's: a thread holds about
// 16 points, several rows a block where a row takes fewer than 128 threads
// (m <= 1024), one per threadIdx.y.

#include <cuda_runtime.h>

#include <initializer_list>

#include "mixed_fft.cuh"

namespace {

using namespace fftk;

// The row of m points in device memory, written by chirp_fwd's last pass;
// nothing for a row past the last.
struct RowOut {
  float* r;
  float* i;
  bool valid;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void store(int k, float a, float b) const {
    if (!valid) return;
    r[k] = a;
    i[k] = b;
  }
};

// The first n_out outputs, times scale and the table g, into a row of
// device memory; the others are dropped, and all of a row past the last.
struct ChirpOut {
  float* r;
  float* i;
  const float* gr;
  const float* gi;
  int n_out;
  float scale;
  bool valid;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void store(int k, float a, float b) const {
    if (!valid || k >= n_out) return;
    a *= scale;
    b *= scale;
    const float g_r = __ldg(&gr[k]), g_i = __ldg(&gi[k]);
    r[k] = a * g_r - b * g_i;
    i[k] = a * g_i + b * g_r;
  }
};

struct ChirpArgs {
  const float* in_re;
  const float* in_im;
  const float* hr;  // [n_in]: chirp_fwd's and chirp_full's first table
  const float* hi;
  const float* Hr;  // [m]: chirp_inv's and chirp_full's filter
  const float* Hi;
  const float* gr;  // [n_out]
  const float* gi;
  float* out_re;
  float* out_im;
  const float2* tw;    // the pass roots of the first transform's sign
  const float2* tw_b;  // of the opposite sign and the reversed plan (chirp_full)
  long long rows;
  int n_in;   // points of an input row
  int n_out;  // points of an output row
  float scale;
  MixedPlan plan;  // n = m
};

// chirp_fwd's, chirp_inv's, and chirp_full's first and second transforms.
enum Stage { kFwd, kInv, kFullFirst, kFullSecond };

// This thread's row (one per threadIdx.y) in one stage, and the sources
// and sinks of that stage's first and last passes, built where a pass
// needs them.  A row past the last reads the first and stores nothing.
template <Stage STAGE>
struct ChirpRow {
  const ChirpArgs& g;
  __device__ __forceinline__ long long row() const {
    return static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  }
  __device__ __forceinline__ bool valid() const { return row() < g.rows; }
  __device__ __forceinline__ size_t off(int n) const {
    return static_cast<size_t>(valid() ? row() : 0) * n;
  }
  __device__ __forceinline__ PadShared shared() const {
    extern __shared__ float2 smem[];
    return PadShared{smem + threadIdx.y * padded_len(g.plan.n)};
  }
  __device__ __forceinline__ ProductIn src() const {
    if constexpr (STAGE == kInv) {
      return ProductIn{g.in_re + off(g.plan.n), g.in_im + off(g.plan.n), g.Hr, g.Hi,
                       g.plan.n};
    } else {
      return ProductIn{g.in_re + off(g.n_in), g.in_im + off(g.n_in), g.hr, g.hi, g.n_in};
    }
  }
  __device__ __forceinline__ auto dst() const {
    if constexpr (STAGE == kFwd) {
      return RowOut{g.out_re + off(g.plan.n), g.out_im + off(g.plan.n), valid()};
    } else if constexpr (STAGE == kFullFirst) {
      return shared();
    } else {
      return ChirpOut{g.out_re + off(g.n_out), g.out_im + off(g.n_out), g.gr, g.gi,
                      g.n_out, g.scale, valid()};
    }
  }
};

// chirp_full's turn from the first transform (sign SIGN) to the second:
// the first's last pass (radix R at NS = M/R; its roots w^k at
// tw[OFF + (k - 1)*M/R + j]),
// the product with H, and the second's first pass (radix R at NS = 1, no
// twiddles), one butterfly j on the same R points j + k*M/R, in registers;
// the shared row is read before the barrier and written, at the second's
// first-pass positions j*R + k, after it.
template <int SIGN, int M, int R, int OFF>
__device__ __forceinline__ void turn_pass(const PadShared& s, const ChirpArgs& g) {
  constexpr int MR = M / R;
  constexpr int BMAX = mixed_hold(R);
  const int T = blockDim.x;
  float ar[BMAX][R], ai[BMAX][R];
#pragma unroll
  for (int b = 0; b < BMAX; ++b) {
    // as in small_pass: a thread past the last butterfly repeats it and
    // stores nothing
    const int j = min_int(static_cast<int>(threadIdx.x) + b * T, MR - 1);
#pragma unroll
    for (int k = 0; k < R; ++k) s.load(j + k * MR, ar[b][k], ai[b][k]);
#pragma unroll
    for (int k = 1; k < R; ++k) cmul(ar[b][k], ai[b][k], __ldg(&g.tw[OFF + (k - 1) * MR + j]));
    dft<R, SIGN>(ar[b], ai[b]);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      cmul(ar[b][k], ai[b][k],
           make_float2(__ldg(&g.Hr[j + k * MR]), __ldg(&g.Hi[j + k * MR])));
    }
    dft<R, -SIGN>(ar[b], ai[b]);
  }
  __syncthreads();  // every read of the row precedes any write
#pragma unroll
  for (int b = 0; b < BMAX; ++b) {
    const int j = static_cast<int>(threadIdx.x) + b * T;
    if (j < MR) {
#pragma unroll
      for (int k = 0; k < R; ++k) s.store(j * R + k, ar[b][k], ai[b][k]);
    }
  }
  __syncthreads();
}

// chirp_full after the first transform's passes but the last: the turn
// (radix RL, the plan's last), then the second transform's other passes,
// which run the plan in reverse order (RL, then Rev..., the rest from the
// back) from NS = RL.  OFF: where the first transform's last pass's roots
// begin in tw (the sum of NS*(R - 1) over its passes from the second to the
// one before the last).
template <int SIGN, int M, int OFF, int RL, int... Rev>
__device__ __forceinline__ void full_tail(const ChirpArgs& g) {
  turn_pass<SIGN, M, RL, OFF>(ChirpRow<kFullFirst>{g}.shared(), g);
  const ChirpRow<kFullSecond> second{g};
  fixed_passes<-SIGN, M, RL, 0, Rev...>(second.shared(), second, g.tw_b);
}

template <int SIGN, int LOG2M>
__device__ __forceinline__ void full_fft(const ChirpArgs& g) {
  constexpr int M = 1 << LOG2M;
  constexpr int r0 = plan_radix(LOG2M, 0), r1 = plan_radix(LOG2M, 1);
  constexpr int r2 = plan_radix(LOG2M, 2), r3 = plan_radix(LOG2M, 3);
  const ChirpRow<kFullFirst> first{g};
  if constexpr (r2 == 0) {
    fixed_passes<SIGN, M, 1, 0, r0>(first.src(), first, g.tw);
    full_tail<SIGN, M, 0, r1, r0>(g);
  } else if constexpr (r3 == 0) {
    fixed_passes<SIGN, M, 1, 0, r0, r1>(first.src(), first, g.tw);
    full_tail<SIGN, M, r0 * (r1 - 1), r2, r1, r0>(g);
  } else {
    fixed_passes<SIGN, M, 1, 0, r0, r1, r2>(first.src(), first, g.tw);
    full_tail<SIGN, M, r0 * (r1 - 1) + r0 * r1 * (r2 - 1), r3, r2, r1, r0>(g);
  }
}

template <int SIGN, int LOG2M>
__global__ void __launch_bounds__(kMixMaxThreads)
chirp_fwd_kernel(const __grid_constant__ ChirpArgs g) {
  plan_fft<SIGN, LOG2M>(ChirpRow<kFwd>{g}, g.tw);
}

template <int SIGN, int LOG2M>
__global__ void __launch_bounds__(kMixMaxThreads)
chirp_inv_kernel(const __grid_constant__ ChirpArgs g) {
  plan_fft<SIGN, LOG2M>(ChirpRow<kInv>{g}, g.tw);
}

// The first transform of sign -1, the second of sign +1.
template <int LOG2M>
__global__ void __launch_bounds__(kMixMaxThreads)
chirp_full_kernel(const __grid_constant__ ChirpArgs g) {
  full_fft<-1, LOG2M>(g);
}

template <class Kernel>
cudaError_t launch(Kernel kernel, const ChirpArgs& g, cudaStream_t stream) {
  const MixedShape shape = mixed_shape(g.plan, false);
  const int smem = shape.rows * padded_len(g.plan.n) * static_cast<int>(sizeof(float2));
  const long long blocks = (g.rows + shape.rows - 1) / shape.rows;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), dim3(shape.threads, shape.rows), smem, stream>>>(
      g);
  return cudaGetLastError();
}

// KERNEL(log2(m)) for the checked m.  CHIRP_FWD and CHIRP_INV pick the
// instantiation of the entry point's checked `sign`; chirp_full has one.
#define CHIRP_DISPATCH(KERNEL, g, s)                  \
  switch (g.plan.n) {                                \
    case 1 << 7: return launch(KERNEL(7), g, s);      \
    case 1 << 8: return launch(KERNEL(8), g, s);      \
    case 1 << 9: return launch(KERNEL(9), g, s);      \
    case 1 << 10: return launch(KERNEL(10), g, s);    \
    case 1 << 11: return launch(KERNEL(11), g, s);    \
    case 1 << 12: return launch(KERNEL(12), g, s);    \
    case 1 << 13: return launch(KERNEL(13), g, s);    \
    default: return launch(KERNEL(14), g, s);         \
  }
#define CHIRP_FWD(L) (sign < 0 ? chirp_fwd_kernel<-1, L> : chirp_fwd_kernel<1, L>)
#define CHIRP_INV(L) (sign < 0 ? chirp_inv_kernel<-1, L> : chirp_inv_kernel<1, L>)
#define CHIRP_FULL(L) chirp_full_kernel<L>

// m = 2^7 .. 2^14, rows >= 1, 1 <= n <= m for each length n of a row; the
// plan is m's compiled one (plan_radix).
bool prepare(ChirpArgs* g, int m, std::initializer_list<int> lengths) {
  if (g->rows < 1 || m < 128 || m > 16384 || (m & (m - 1)) != 0) return false;
  int radix[kPlanMax], np = 0;
  for (int i = 0; i < kPlanMax; ++i) {
    const int r = plan_radix(__builtin_ctz(m), i);
    if (r != 0) radix[np++] = r;
  }
  if (!mixed_plan_make(radix, np, m, &g->plan)) return false;
  for (const int n : lengths) {
    if (n < 1 || n > m) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// chirp_fwd over `rows` contiguous rows of n_in planar float32 points into
// rows of m.  h holds n_in floats per plane; tw holds the roots of
// exp(sign*2pi*i/m) that the passes of m's plan (_mixed_radix_plan) read
// (_pass_roots_np: interleaved (cos, sin) float32 pairs).  Launches on
// `stream` and returns cudaGetLastError() (0 = ok).
int chirp_fwd_f32(const void* in_re, const void* in_im, const void* hr, const void* hi,
                  void* out_re, void* out_im, const void* tw, long long rows, int n_in,
                  int m, int sign, void* stream) {
  ChirpArgs g{static_cast<const float*>(in_re), static_cast<const float*>(in_im),
              static_cast<const float*>(hr), static_cast<const float*>(hi),
              nullptr, nullptr, nullptr, nullptr,
              static_cast<float*>(out_re), static_cast<float*>(out_im),
              static_cast<const float2*>(tw), nullptr, rows, n_in, m, 1.f, {}};
  if ((sign != 1 && sign != -1) || !prepare(&g, m, {n_in})) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  CHIRP_DISPATCH(CHIRP_FWD, g, s)
}

// chirp_inv over `rows` contiguous rows of m planar float32 points into
// rows of n_out.  H holds m floats per plane, g n_out; tw as for
// chirp_fwd_f32.  Returns cudaGetLastError() (0 = ok).
int chirp_inv_f32(const void* in_re, const void* in_im, const void* Hr, const void* Hi,
                  const void* gr, const void* gi, void* out_re, void* out_im,
                  const void* tw, long long rows, int n_out, int m, int sign, float scale,
                  void* stream) {
  ChirpArgs g{static_cast<const float*>(in_re), static_cast<const float*>(in_im),
              nullptr, nullptr,
              static_cast<const float*>(Hr), static_cast<const float*>(Hi),
              static_cast<const float*>(gr), static_cast<const float*>(gi),
              static_cast<float*>(out_re), static_cast<float*>(out_im),
              static_cast<const float2*>(tw), nullptr, rows, m, n_out, scale, {}};
  if ((sign != 1 && sign != -1) || !prepare(&g, m, {n_out})) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  CHIRP_DISPATCH(CHIRP_INV, g, s)
}

// chirp_full over `rows` contiguous rows of n_in planar float32 points into
// rows of n_out: the first transform of sign -1 with tw (as for
// chirp_fwd_f32), the second of sign +1 with tw_b (the roots of that sign
// for the plan in reverse order: _pass_roots_reversed_np).  h holds n_in
// floats per plane, H m, g n_out.  Returns cudaGetLastError() (0 = ok).
int chirp_full_f32(const void* in_re, const void* in_im, const void* hr, const void* hi,
                   const void* Hr, const void* Hi, const void* gr, const void* gi,
                   void* out_re, void* out_im, const void* tw, const void* tw_b,
                   long long rows, int n_in, int n_out, int m, float scale, void* stream) {
  ChirpArgs g{static_cast<const float*>(in_re), static_cast<const float*>(in_im),
              static_cast<const float*>(hr), static_cast<const float*>(hi),
              static_cast<const float*>(Hr), static_cast<const float*>(Hi),
              static_cast<const float*>(gr), static_cast<const float*>(gi),
              static_cast<float*>(out_re), static_cast<float*>(out_im),
              static_cast<const float2*>(tw), static_cast<const float2*>(tw_b), rows,
              n_in, n_out, scale, {}};
  if (!prepare(&g, m, {n_in, n_out})) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  CHIRP_DISPATCH(CHIRP_FULL, g, s)
}

const char* chirp_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

#undef CHIRP_FULL
#undef CHIRP_INV
#undef CHIRP_FWD
#undef CHIRP_DISPATCH

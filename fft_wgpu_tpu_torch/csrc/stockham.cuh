// Radix-4/2 Stockham passes shared by the port's FFT kernels.
//
// A transform of N = 2^LOG2N points runs one radix-2 pass first when LOG2N
// is odd, then radix-4 passes, on the CUDA cores in float32 FMAs (TF32
// tensor cores would miss the 1e-5 relative-L2 bar), and produces natural
// order with no bit-reversal pass.  Twiddles come from a float32 table of
// roots of unity generated in float64 on the host.
//
// Each pass reads its inputs through a source and writes through a sink:
// `Shared` (the row in shared memory, read and written in place),
// `GlobalIn` / `GlobalOut` (the row in device memory; the sink folds the
// output scale into its store), or a kernel's own type with the same
// members.  The row lives in one shared buffer, because a ping-pong pair
// of 16384-point rows would need 256 KB, more than the 227 KB a block may
// hold: a pass that reads and writes shared memory reads all of its inputs
// into registers, synchronises, and then writes the autosort positions.
// Since a block reads its whole row before it stores any of it, a kernel
// whose first pass reads device memory and whose last pass writes it may
// run in place.
//
// Threads of one row are threadIdx.x; a kernel that holds several rows in
// a block gives each threadIdx.y its own source, buffer and sink.  Every
// thread of the block must run every pass, because passes synchronise the
// whole block.

#pragma once

#include <cuda_runtime.h>

namespace fftk {

__host__ __device__ constexpr int threads_for(int log2n) {
  return (1 << log2n) / 4 < 1024 ? (1 << log2n) / 4 : 1024;
}

__host__ __device__ constexpr int min_int(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ void cmul(float& r, float& i, float2 w) {
  const float t = r * w.x - i * w.y;
  i = r * w.y + i * w.x;
  r = t;
}

// 4-point DFT in place; w = exp(sign * 2*pi*i / 4) = sign * i.
__device__ __forceinline__ void dft4(float (&r)[4], float (&i)[4], float sign) {
  const float t0r = r[0] + r[2], t0i = i[0] + i[2];
  const float t1r = r[0] - r[2], t1i = i[0] - i[2];
  const float t2r = r[1] + r[3], t2i = i[1] + i[3];
  const float t3r = -sign * (i[1] - i[3]), t3i = sign * (r[1] - r[3]);
  r[0] = t0r + t2r; i[0] = t0i + t2i;
  r[1] = t1r + t3r; i[1] = t1i + t3i;
  r[2] = t0r - t2r; i[2] = t0i - t2i;
  r[3] = t1r - t3r; i[3] = t1i - t3i;
}

__device__ __forceinline__ void dft2(float (&r)[2], float (&i)[2]) {
  const float ur = r[0] - r[1], ui = i[0] - i[1];
  r[0] += r[1]; i[0] += i[1];
  r[1] = ur; i[1] = ui;
}

// The row in shared memory.
struct Shared {
  float* r;
  float* i;
  static constexpr bool kShared = true;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    a = r[k];
    b = i[k];
  }
  __device__ __forceinline__ void store(int k, float a, float b) const {
    r[k] = a;
    i[k] = b;
  }
};

// The row in device memory, read by the first pass.  No __restrict__: the
// output may alias the input.
struct GlobalIn {
  const float* r;
  const float* i;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    a = r[k];
    b = i[k];
  }
};

// The row in device memory, written by the last pass with the scale folded in.
struct GlobalOut {
  float* r;
  float* i;
  float scale;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void store(int k, float a, float b) const {
    r[k] = a * scale;
    i[k] = b * scale;
  }
};

// A row x of device memory times a table h, zero past n_in: the first pass
// of a transform with a multiply fused into its loads (the chirp passes,
// the spectral filter and the filter bank).
struct ProductIn {
  const float* xr;
  const float* xi;
  const float* hr;
  const float* hi;
  int n_in;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    if (k >= n_in) {
      a = b = 0.f;
      return;
    }
    const float x_r = xr[k], x_i = xi[k];
    const float h_r = __ldg(&hr[k]), h_i = __ldg(&hi[k]);
    a = x_r * h_r - x_i * h_i;
    b = x_r * h_i + x_i * h_r;
  }
};

// One Stockham autosort pass of radix R over a row of N points.  NS is the
// product of the radices of the passes before it.  Butterfly j (0 <= j < N/R)
// reads x[j + k*N/R] for k < R, multiplies input k by the twiddle
// w_N^(k * (j mod NS) * N/(NS*R)), takes an R-point DFT and writes output k
// to y[(j/NS)*NS*R + (j mod NS) + k*NS].  After the pass with NS*R == N the
// row is in natural order.  The table holds N*TWS roots of unity, so w_N^e
// is tw[e * TWS].
template <int N, int THREADS, int R, int NS, int TWS, class Src, class Dst>
__device__ __forceinline__ void stockham_pass(const Src& src, const Dst& dst,
                                              const float2* __restrict__ tw,
                                              float sign) {
  constexpr int M = N / R;
  constexpr int B = M / THREADS;
  constexpr int L = NS * R;
  constexpr int STEP = N / L * TWS;
  static_assert(B * THREADS == M, "butterflies must split evenly over threads");
  float ar[B][R], ai[B][R];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = threadIdx.x + b * THREADS;
#pragma unroll
    for (int k = 0; k < R; ++k) src.load(j + k * M, ar[b][k], ai[b][k]);
    if constexpr (NS > 1) {
      const int jm = j & (NS - 1);
#pragma unroll
      for (int k = 1; k < R; ++k) cmul(ar[b][k], ai[b][k], __ldg(&tw[jm * k * STEP]));
    }
    if constexpr (R == 4) {
      dft4(ar[b], ai[b], sign);
    } else {
      dft2(ar[b], ai[b]);
    }
  }
  // In place in shared memory: every read of the row precedes any write.
  if constexpr (Src::kShared && Dst::kShared) __syncthreads();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = threadIdx.x + b * THREADS;
    const int d = (j / NS) * L + (j & (NS - 1));
#pragma unroll
    for (int k = 0; k < R; ++k) dst.store(d + k * NS, ar[b][k], ai[b][k]);
  }
  if constexpr (Dst::kShared) __syncthreads();
}

template <int N, int THREADS, int NS, int TWS, class Src, class Dst>
__device__ __forceinline__ void radix4_passes(const Src& src, const Shared& s,
                                              const Dst& dst,
                                              const float2* __restrict__ tw,
                                              float sign) {
  if constexpr (NS * 4 == N) {
    stockham_pass<N, THREADS, 4, NS, TWS>(src, dst, tw, sign);
  } else {
    stockham_pass<N, THREADS, 4, NS, TWS>(src, s, tw, sign);
    radix4_passes<N, THREADS, NS * 4, TWS>(s, s, dst, tw, sign);
  }
}

// Every pass of a 2^LOG2N-point transform: src -> s (shared) -> ... -> dst.
// With src = s = dst the whole transform runs in place in shared memory; the
// caller synchronises before the first pass reads what it wrote there.
template <int LOG2N, int THREADS, int TWS = 1, class Src, class Dst>
__device__ __forceinline__ void fft_passes(const Src& src, const Shared& s,
                                           const Dst& dst,
                                           const float2* __restrict__ tw,
                                           float sign) {
  static_assert(LOG2N >= 3, "at least two passes");
  constexpr int N = 1 << LOG2N;
  if constexpr (LOG2N & 1) {
    stockham_pass<N, THREADS, 2, 1, TWS>(src, s, tw, sign);
    radix4_passes<N, THREADS, 2, TWS>(s, s, dst, tw, sign);
  } else {
    radix4_passes<N, THREADS, 1, TWS>(src, s, dst, tw, sign);
  }
}

}  // namespace fftk

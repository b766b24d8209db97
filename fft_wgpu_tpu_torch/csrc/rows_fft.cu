// Batched complex-to-complex FFT along the last axis, one row per block.
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/pallas_fft.py::_fft_batched_core
// (its one pl.pallas_call over _kernel_rows_bal, _kernel_rows_bal_pipe,
// _kernel and _kernel_rows_dit).  Per row of n = 2^7 .. 2^14 points it
// computes
//
//     X[k] = scale * sum_m x[m] * exp(sign * 2*pi*i * k*m / n)
//
// in natural order, planar float32 (re, im) in and out.
//
// What bounds it: device memory.  Each point is read once and written once,
// 16 bytes of planar float32, against about 5*log2(n) flops, well under the
// card's float32 flop-per-byte balance (an H100 SXM has 3.35 TB/s of device
// memory for 67 TFLOP/s of float32 on the CUDA cores, data sheet).  One row
// per block keeps every intermediate out of device memory, as the
// VMEM-resident TPU kernel did: the first pass reads the row from device
// memory into registers, the passes in between go through the row held in
// dynamic shared memory (2 * n * 4 bytes, 128 KB at n = 16384), and the last
// pass stores from registers to device memory with the scale folded in.
//
// A ping-pong pair of shared buffers would need 256 KB at n = 16384, more
// than the 227 KB a block may hold, so the row lives in one buffer: each
// pass reads all of its radix-r inputs into registers, synchronises, and
// then writes the Stockham autosort positions.  Because a block has read its
// whole row before it stores any of it, the output may alias the input (the
// plan's donate=True runs in place).
//
// Passes are radix 4, with one radix-2 pass first when log2(n) is odd, on
// the CUDA cores in float32 FMAs.  Tensor cores are not used: TF32 misses
// the 1e-5 relative-L2 bar.  Twiddles come from a per-(n, sign) float32
// table of the n-th roots of unity generated in float64 on the host.

#include <cuda_runtime.h>

namespace {

__host__ __device__ constexpr int threads_for(int log2n) {
  return (1 << log2n) / 4 < 1024 ? (1 << log2n) / 4 : 1024;
}

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

// One Stockham autosort pass of radix R over a row of N points.  NS is the
// product of the radices of the passes before it.  Butterfly j (0 <= j < N/R)
// reads x[j + k*N/R] for k < R, multiplies input k by the twiddle
// w_N^(k * (j mod NS) * N/(NS*R)), takes an R-point DFT and writes output k
// to y[(j/NS)*NS*R + (j mod NS) + k*NS].  After the pass with NS*R == N the
// row is in natural order.  FIRST reads the row from device memory, LAST
// writes it there; every other pass reads and writes shared memory.
template <int N, int THREADS, int R, int NS, bool FIRST, bool LAST>
__device__ __forceinline__ void stockham_pass(
    const float* xr, const float* xi, float* sr, float* si, float* yr,
    float* yi, const float2* __restrict__ tw, float sign, float scale) {
  constexpr int M = N / R;
  constexpr int B = M / THREADS;
  constexpr int L = NS * R;
  constexpr int STEP = N / L;
  static_assert(B * THREADS == M, "butterflies must split evenly over threads");
  float ar[B][R], ai[B][R];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = threadIdx.x + b * THREADS;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if constexpr (FIRST) {
        ar[b][k] = xr[j + k * M];
        ai[b][k] = xi[j + k * M];
      } else {
        ar[b][k] = sr[j + k * M];
        ai[b][k] = si[j + k * M];
      }
    }
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
  // In-place in shared memory: every read of the row precedes any write.
  if constexpr (!FIRST && !LAST) __syncthreads();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = threadIdx.x + b * THREADS;
    const int d = (j / NS) * L + (j & (NS - 1));
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if constexpr (LAST) {
        yr[d + k * NS] = ar[b][k] * scale;
        yi[d + k * NS] = ai[b][k] * scale;
      } else {
        sr[d + k * NS] = ar[b][k];
        si[d + k * NS] = ai[b][k];
      }
    }
  }
  if constexpr (!LAST) __syncthreads();
}

template <int N, int THREADS, int NS, bool FIRST>
__device__ __forceinline__ void radix4_passes(
    const float* xr, const float* xi, float* sr, float* si, float* yr,
    float* yi, const float2* __restrict__ tw, float sign, float scale) {
  constexpr bool kLast = NS * 4 == N;
  stockham_pass<N, THREADS, 4, NS, FIRST, kLast>(xr, xi, sr, si, yr, yi, tw,
                                                 sign, scale);
  if constexpr (!kLast) {
    radix4_passes<N, THREADS, NS * 4, false>(xr, xi, sr, si, yr, yi, tw, sign,
                                             scale);
  }
}

// The output may alias the input, so the row pointers carry no __restrict__.
template <int LOG2N>
__global__ void __launch_bounds__(threads_for(LOG2N))
rows_fft_kernel(const float* in_re, const float* in_im, float* out_re,
                float* out_im, const float2* __restrict__ tw, float sign,
                float scale) {
  constexpr int N = 1 << LOG2N;
  constexpr int T = threads_for(LOG2N);
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = smem + N;
  const size_t off = static_cast<size_t>(blockIdx.x) * N;
  const float* xr = in_re + off;
  const float* xi = in_im + off;
  float* yr = out_re + off;
  float* yi = out_im + off;
  if constexpr (LOG2N & 1) {
    stockham_pass<N, T, 2, 1, true, false>(xr, xi, sr, si, yr, yi, tw, sign,
                                           scale);
    radix4_passes<N, T, 2, false>(xr, xi, sr, si, yr, yi, tw, sign, scale);
  } else {
    radix4_passes<N, T, 1, true>(xr, xi, sr, si, yr, yi, tw, sign, scale);
  }
}

template <int LOG2N>
cudaError_t launch(const void* in_re, const void* in_im, void* out_re,
                   void* out_im, const void* tw, long long rows, float sign,
                   float scale, cudaStream_t stream) {
  constexpr int N = 1 << LOG2N;
  constexpr int smem = 2 * N * static_cast<int>(sizeof(float));
  if constexpr (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rows_fft_kernel<LOG2N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  rows_fft_kernel<LOG2N><<<static_cast<unsigned>(rows), threads_for(LOG2N),
                           smem, stream>>>(
      static_cast<const float*>(in_re), static_cast<const float*>(in_im),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const float2*>(tw), sign, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Transforms `rows` contiguous rows of n = 2^log2n planar float32 points.
// tw holds n interleaved (cos, sin) float32 pairs of exp(sign*2pi*i*m/n).
// Launches on `stream` of `device` and returns cudaGetLastError() (0 = ok).
int rows_fft_f32(const void* in_re, const void* in_im, void* out_re,
                 void* out_im, const void* tw, long long rows, int log2n,
                 int sign, float scale, int device, void* stream) {
  if (rows < 1 || rows > 2147483647LL || (sign != 1 && sign != -1)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const auto s = static_cast<cudaStream_t>(stream);
  const float sg = static_cast<float>(sign);
  switch (log2n) {
    case 7: return launch<7>(in_re, in_im, out_re, out_im, tw, rows, sg, scale, s);
    case 8: return launch<8>(in_re, in_im, out_re, out_im, tw, rows, sg, scale, s);
    case 9: return launch<9>(in_re, in_im, out_re, out_im, tw, rows, sg, scale, s);
    case 10: return launch<10>(in_re, in_im, out_re, out_im, tw, rows, sg, scale, s);
    case 11: return launch<11>(in_re, in_im, out_re, out_im, tw, rows, sg, scale, s);
    case 12: return launch<12>(in_re, in_im, out_re, out_im, tw, rows, sg, scale, s);
    case 13: return launch<13>(in_re, in_im, out_re, out_im, tw, rows, sg, scale, s);
    case 14: return launch<14>(in_re, in_im, out_re, out_im, tw, rows, sg, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* rows_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

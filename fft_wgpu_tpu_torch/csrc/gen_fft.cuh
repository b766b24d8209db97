// Two-factor direct-DFT stages shared by the composite-length kernels
// (gen_fft.cu, C2C rows; r2c_gen_fft.cu, R2C rows; ax0_gen_fft.cu, C2C
// columns).
//
// A row of n = n1 * n2 points (n1 <= n2, both <= 256) x[j1*n2 + j2] is held
// in dynamic shared memory as the n1 x n2 matrix A[j1][j2], planar float32,
// with an odd row pitch P (n2, or n2 + 1 when n2 is even), so that a warp
// reading along a row (stage 1) or down a column (stage 2) touches 32
// different banks.  The transform is the Cooley-Tukey step with a direct
// DFT on each side:
//
//   stage 1: B[k1][j2] = w_n^(k1*j2) * sum_j1 A[j1][j2] w_n1^(j1*k1)
//   stage 2: X[k1 + n1*k2] = scale * sum_j2 B[k1][j2] w_n2^(j2*k2)
//
// Every root comes from one float32 table of the n-th roots of unity of the
// transform's sign, generated in float64 on the host, at the
// integer-reduced exponent: w_n1^e = w_n^(e*n2), w_n2^e = w_n^(e*n1); the
// exponents are carried modulo n1 and n2 in integers.  All arithmetic is
// float32 FMAs on the CUDA cores (TF32 would miss 1e-5 relative L2).
//
// Stage 1 runs in place in the one buffer: each thread computes its (at
// most kGenPer) outputs into registers, the block synchronises, and then
// the outputs are written back (the discipline of stockham.cuh).  Stage 2
// reads the buffer and hands each output to a sink, which stores it to
// device memory, or writes its outputs back into the buffer the same way.
// A stage's threads are threadIdx.x (blockDim.x of them); a block that
// holds several transforms gives each threadIdx.y its own buffer.  Every
// thread of the block must run every stage, because stages synchronise
// the whole block.
//
// Work per row: n*(n1 + n2) complex multiply-adds, against the n*log2(n)
// butterflies of a radix-2 FFT, so the kernels are bound by the CUDA cores'
// instruction throughput and shared-memory reads, not by device memory.

#pragma once

#include <cuda_runtime.h>

namespace fftk {

// Outputs per thread and stage: 1024 threads cover n = 16384.
constexpr int kGenPer = 16;
constexpr int kGenMaxThreads = 1024;

// Threads of a row's block: enough warps for kGenPer outputs each.
__host__ __device__ inline int gen_threads(int n) {
  const int t = (n + kGenPer - 1) / kGenPer;
  return (t + 31) / 32 * 32;
}

// Odd row pitch of the n1 x n2 matrix in shared memory.
__host__ __device__ inline int gen_pitch(int n2) { return n2 | 1; }

// Bytes of dynamic shared memory: two planes of n1 x P floats.
__host__ __device__ inline int gen_smem_bytes(int n1, int n2) {
  return 2 * n1 * gen_pitch(n2) * static_cast<int>(sizeof(float));
}

// Row x[0..n) of device memory into plane s of shared memory at A[j1][j2].
__device__ __forceinline__ void gen_load(const float* __restrict__ x, float* s,
                                         int n1, int n2, int P) {
  const int n = n1 * n2;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int j1 = j / n2;
    s[j1 * P + (j - j1 * n2)] = x[j];
  }
}

// Stage 1 in place over (sr, si).  REAL: the row is real, si is not read.
template <bool REAL>
__device__ __forceinline__ void gen_stage1(float* sr, float* si, int n1, int n2,
                                           int P, const float2* __restrict__ tw) {
  const int n = n1 * n2;
  const int T = blockDim.x;
  float br[kGenPer], bi[kGenPer];
#pragma unroll
  for (int q = 0; q < kGenPer; ++q) {
    const int o = threadIdx.x + q * T;
    br[q] = bi[q] = 0.f;
    if (o < n) {
      const int k1 = o / n2;
      const int j2 = o - k1 * n2;
      float ar = 0.f, ai = 0.f;
      int e = 0;  // j1 * k1 mod n1
      for (int j1 = 0; j1 < n1; ++j1) {
        const float2 w = __ldg(&tw[e * n2]);
        const float xr = sr[j1 * P + j2];
        if constexpr (REAL) {
          ar = fmaf(xr, w.x, ar);
          ai = fmaf(xr, w.y, ai);
        } else {
          const float xi = si[j1 * P + j2];
          ar = fmaf(xr, w.x, fmaf(-xi, w.y, ar));
          ai = fmaf(xr, w.y, fmaf(xi, w.x, ai));
        }
        e += k1;
        if (e >= n1) e -= n1;
      }
      const float2 t = __ldg(&tw[k1 * j2]);  // w_n^(k1*j2), k1*j2 < n
      br[q] = ar * t.x - ai * t.y;
      bi[q] = ar * t.y + ai * t.x;
    }
  }
  __syncthreads();  // every read of the row precedes any write
#pragma unroll
  for (int q = 0; q < kGenPer; ++q) {
    const int o = threadIdx.x + q * T;
    if (o < n) {
      const int k1 = o / n2;
      const int d = k1 * P + (o - k1 * n2);
      sr[d] = br[q];
      si[d] = bi[q];
    }
  }
  __syncthreads();
}

// Output k = k1 + n1*k2 of stage 2, unscaled: sum_j2 B[k1][j2] w_n2^(j2*k2).
__device__ __forceinline__ void gen_output(const float* sr, const float* si, int n1,
                                           int n2, int P, int k,
                                           const float2* __restrict__ tw, float& ar,
                                           float& ai) {
  const int k2 = k / n1;
  const int k1 = k - k2 * n1;
  const float* rr = sr + k1 * P;
  const float* ri = si + k1 * P;
  ar = ai = 0.f;
  int e = 0;  // j2 * k2 mod n2
  for (int j2 = 0; j2 < n2; ++j2) {
    const float2 w = __ldg(&tw[e * n1]);
    const float xr = rr[j2], xi = ri[j2];
    ar = fmaf(xr, w.x, fmaf(-xi, w.y, ar));
    ai = fmaf(xr, w.y, fmaf(xi, w.x, ai));
    e += k2;
    if (e >= n2) e -= n2;
  }
}

// Stage 2: outputs k < n_out (k = k1 + n1*k2) to sink.store(k, re, im).
// Neighbouring threads take neighbouring k, so the store is coalesced and
// a warp's reads, one row k1 per thread, fall at the odd stride P.
template <class Sink>
__device__ __forceinline__ void gen_stage2(const float* sr, const float* si, int n1,
                                           int n2, int P, int n_out,
                                           const float2* __restrict__ tw,
                                           const Sink& sink) {
  for (int k = threadIdx.x; k < n_out; k += blockDim.x) {
    float ar, ai;
    gen_output(sr, si, n1, n2, P, k, tw, ar, ai);
    sink.store(k, ar, ai);
  }
}

// Stage 2 in place: output k, times scale, to (sr[k], si[k]), so the buffer
// then holds X in natural order.  As stage 1: each thread computes its (at
// most kGenPer) outputs into registers, the block synchronises, and then
// the outputs are written back.
__device__ __forceinline__ void gen_stage2_in_place(float* sr, float* si, int n1,
                                                    int n2, int P, float scale,
                                                    const float2* __restrict__ tw) {
  const int n = n1 * n2;
  const int T = blockDim.x;
  float yr[kGenPer], yi[kGenPer];
#pragma unroll
  for (int q = 0; q < kGenPer; ++q) {
    const int k = threadIdx.x + q * T;
    yr[q] = yi[q] = 0.f;
    if (k < n) gen_output(sr, si, n1, n2, P, k, tw, yr[q], yi[q]);
  }
  __syncthreads();  // every read of the buffer precedes any write
#pragma unroll
  for (int q = 0; q < kGenPer; ++q) {
    const int k = threadIdx.x + q * T;
    if (k < n) {
      sr[k] = yr[q] * scale;
      si[k] = yi[q] * scale;
    }
  }
  __syncthreads();
}

// Sink: a planar row of device memory, scale folded into the store.
struct RowOut {
  float* r;
  float* i;
  float scale;
  __device__ __forceinline__ void store(int k, float a, float b) const {
    r[k] = a * scale;
    i[k] = b * scale;
  }
};

}  // namespace fftk

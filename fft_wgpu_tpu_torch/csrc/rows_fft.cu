// Batched complex-to-complex FFT along the last axis, planar float32 or
// interleaved complex64 rows.
//
// Replaces the TPU kernel fft_wgpu_tpu/ops/pallas_fft.py::_fft_batched_core
// (its one pl.pallas_call over _kernel_rows_bal, _kernel_rows_bal_pipe,
// _kernel and _kernel_rows_dit).  Per row of n = 2^7 .. 2^14 points it
// computes
//
//     X[k] = scale * sum_m x[m] * exp(sign * 2*pi*i * k*m / n)
//
// in natural order, from and to device memory in either of two layouts:
// planar (re, im) float32 planes (rows_fft_f32) or interleaved complex64,
// one 8-byte (re, im) pair a point (rows_fft_c64, a torch complex64
// tensor as it lies, so a complex caller needs no split and no merge).
//
// What bounds it: device memory.  Each point is read once and written once,
// 16 bytes, against about 5*log2(n) flops, well under the card's float32
// flop-per-byte balance (an H100 SXM has 3.35 TB/s of device memory for 67
// TFLOP/s of float32 on the CUDA cores, data sheet): 4096 x 4096 needs
// 0.080 ms.  So every intermediate stays on chip: the first pass reads the
// row from device memory into registers, the passes in between go through
// the row held in shared memory, and the last pass stores from registers to
// device memory with the scale folded in.
//
// The passes are mixed_fft.cuh's on the plan compiled in for each n
// (plan_fft; 4096 = 16*16*16: three radix-16 passes), with each pass's
// twiddles in a table of its own read by consecutive lanes (the host's
// ops/cuda_fft.py::_pass_roots_np), and both signs compiled.  The row sits
// in shared memory as padded interleaved pairs (PadShared: one 8-byte access
// a point, no bank conflict in the stride-R stores of the first pass), 34 KB
// at n = 4096, 136 KB at 16384.  Every radix of the plan is 16 or 8, so
// with n/16 threads a row each thread holds 16 points (one radix-16 or two
// radix-8 butterflies) in every pass; a block holds 128 / (n/16) rows up to
// n = 1024 (one per threadIdx.y) and one row above.  Each n has its own
// launch bound (RowsShape): blocks of 128 or 256 threads keep up to 80
// registers a thread, 512 and 1024 threads 64.
//
// A pass that reads and writes shared memory reads all of its inputs into
// registers, synchronises, and then writes; because a block has read its
// whole row before it stores any of it, the output may alias the input in
// either layout (the plan's donate=True runs in place).

#include <cuda_runtime.h>

#include "mixed_fft.cuh"

namespace {

using namespace fftk;

struct RowsArgs {
  const float* in_re;  // planar layout
  const float* in_im;
  float* out_re;
  float* out_im;
  const float2* in;  // interleaved layout
  float2* out;
  const float2* tw;  // _pass_roots_np(n, sign)
  long long rows;
  float scale;
};

// This thread's row (one per threadIdx.y) and its source, buffer and sink,
// built where a pass needs them.  A row past the last reads row 0 and
// stores nothing.
template <int LOG2N, bool C64>
struct RowsRow {
  const RowsArgs& g;
  static constexpr int N = 1 << LOG2N;
  __device__ __forceinline__ long long row() const {
    return static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  }
  __device__ __forceinline__ bool valid() const { return row() < g.rows; }
  __device__ __forceinline__ size_t off() const {
    return static_cast<size_t>(valid() ? row() : 0) * N;
  }
  __device__ __forceinline__ PadShared shared() const {
    extern __shared__ float2 smem[];
    return PadShared{smem + threadIdx.y * padded_len(N)};
  }
  __device__ __forceinline__ auto src() const {
    if constexpr (C64) {
      return C64In{g.in + off()};
    } else {
      return GlobalIn{g.in_re + off(), g.in_im + off()};
    }
  }
  __device__ __forceinline__ auto dst() const {
    if constexpr (C64) {
      return C64Out{g.out + off(), g.scale, valid()};
    } else {
      return PlanarOut{g.out_re + off(), g.out_im + off(), g.scale, valid()};
    }
  }
};

template <int SIGN, int LOG2N, bool C64>
__global__ void __launch_bounds__(RowsShape<LOG2N>::kBlock, RowsShape<LOG2N>::kMinBlocks)
rows_fft_kernel(const __grid_constant__ RowsArgs g) {
  plan_fft<SIGN, LOG2N>(RowsRow<LOG2N, C64>{g}, g.tw);
}

template <int LOG2N, bool C64>
cudaError_t launch(int sign, const RowsArgs& g, cudaStream_t stream) {
  using S = RowsShape<LOG2N>;
  auto* kernel = sign < 0 ? rows_fft_kernel<-1, LOG2N, C64> : rows_fft_kernel<1, LOG2N, C64>;
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
int dispatch(const RowsArgs& g, int log2n, int sign, void* stream) {
  if (g.rows < 1 || (sign != 1 && sign != -1)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (log2n) {
    case 7: return launch<7, C64>(sign, g, s);
    case 8: return launch<8, C64>(sign, g, s);
    case 9: return launch<9, C64>(sign, g, s);
    case 10: return launch<10, C64>(sign, g, s);
    case 11: return launch<11, C64>(sign, g, s);
    case 12: return launch<12, C64>(sign, g, s);
    case 13: return launch<13, C64>(sign, g, s);
    case 14: return launch<14, C64>(sign, g, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Transforms `rows` contiguous rows of n = 2^log2n planar float32 points.
// tw holds the roots of exp(sign*2pi*i/n) that the passes of n's plan read
// (_pass_roots_np: interleaved (cos, sin) float32 pairs).  The output may
// alias the input.  Launches on `stream` and returns cudaGetLastError()
// (0 = ok).
int rows_fft_f32(const void* in_re, const void* in_im, void* out_re, void* out_im,
                 const void* tw, long long rows, int log2n, int sign, float scale,
                 void* stream) {
  const RowsArgs g{static_cast<const float*>(in_re), static_cast<const float*>(in_im),
                   static_cast<float*>(out_re), static_cast<float*>(out_im), nullptr,
                   nullptr, static_cast<const float2*>(tw), rows, scale};
  return dispatch<false>(g, log2n, sign, stream);
}

// The same over interleaved complex64 rows: (re, im) float32 pairs, 8-byte
// aligned.  The output may alias the input.
int rows_fft_c64(const void* in, void* out, const void* tw, long long rows, int log2n,
                 int sign, float scale, void* stream) {
  const RowsArgs g{nullptr, nullptr, nullptr, nullptr, static_cast<const float2*>(in),
                   static_cast<float2*>(out), static_cast<const float2*>(tw), rows, scale};
  return dispatch<true>(g, log2n, sign, stream);
}

const char* rows_fft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

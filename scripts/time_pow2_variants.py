#!/usr/bin/env python3
"""Time launch-bound and cluster-size variants of the pow2 kernels of the
torch port (rows_fft, B1; big_fft, B15; ax0_fft, B2/B3; fft2f_fft, B5;
spec_fft, B20 and B19; filt_fft's filtered rows, B9; spec_c2c_fft, B22;
welch_acc_fft, B16, B17, B18 and B21; c2r_fft, B7 and B8) on one CUDA
card, each beside the kernel as it is.

    python3 scripts/time_pow2_variants.py
        [--lib rows_fft|big_fft|ax0_fft|fft2f_fft|spec_fft|filt_fft|spec_c2c_fft|
               welch_acc_fft|c2r_fft|rows_t_fft|r2c_fft|ax0_gen_fft|gen_fft]
        [--parent DIR] [--out FILE]

Variants: rows_fft with every launch bound at 64 registers (1024 threads an
SM; the kernel keeps 80 for blocks of 128 and 256 threads); big_fft (B15,
at 64 x 2^15, 256 x 2^16, 16 and 256 x 2^17, 16 and 64 x 2^18) in other
designs, each with entry points of its own inserted into the source: the
decimation in frequency (a block's positions of every chunk read
contiguously, the C-point butterfly and its twiddle in registers, written
to their owner blocks through distributed shared memory, and the owners'
last pass storing at stride C), and two or four decimated rows a block
(the R points of each 32-byte sector read by one block, R rows of n/(R*C)
points, the twiddle in the last pass's store, the R-point DFT across lanes)
or one with the twiddle in the last pass; with one 512-thread block an SM
(128 registers; the kernel asks for two, 64 registers); at 2^15 in
clusters of 8 blocks (the kernel: 4) and at 2^17 in 16 (the kernel: 8);
and, diagnostics whose output is not checked, without the blocks' passes
(each block's strided points copied into its shared memory), without them
and with the exchange made local (each block reading its own shared memory
for its peers'), and with each block's decimated row read as n/C
contiguous points, with and without the passes and the exchange; with
``--parent DIR`` (a checkout whose big_fft.cu has the two-crossing design:
each point written to its owner block through distributed shared memory
before the blocks' passes and read back from the C blocks after them)
that design as it is, without its passes, and without them with both
exchanges made local, in turns with the kernel; big_fft also prints how
many clusters of each variant fit at once (cudaOccupancyMaxActiveClusters)
and times its planar entries as well; ax0_fft (through both of its entries) in its
first design's shapes (clusters from n = 1024 planar and 2048 complex64
on, 16 planar columns of 512 points a block, 8 complex64 columns of 1024),
with 2048 points a block's column from 4096 on (the kernel: 1024 at 4096
planar, 4096 complex64, and 1024 planar at 8192 and 16384), with 8
complex64 columns from 4096 on (at 4096 in a cluster of 4 blocks of 1024
points a column; the kernel: one block of 4 columns of 4096 there, 4
columns above), and with 4 columns of 4096 points a block in both layouts
(one block at 4096, clusters of 2 and 4 above); fft2f_fft with 8192
points a block in 512 threads, two an SM (the kernel: 4096 in 256, four
an SM), and with the launch bound at 128 registers (the kernel: 64);
spec_fft with blocks of at least 256 threads (the kernel: 128) and with
six blocks of 128 threads an SM, 85 registers (the kernel: eight, 64),
through B20's complex64 sink and B19's entry;
filt_fft's filtered rows, through the complex64 entry, with the filter read
as two planes (the kernel: one interleaved complex64 row), with
RowsShape's launch bounds (the kernel: 64 registers at n = 4096, where
RowsShape asks 80), and with the product staged in the row's shared
buffer before the first pass (the kernel: formed in its loads);
spec_c2c_fft with blocks of at least 256
threads (the kernel: 128) and with RowsShape's launch bounds, up to 80
registers (the kernel: 64); welch_acc_fft with B16 on B20's half-length
transform of each frame and the recombination of its bins at every nfft,
and on two frames as one complex frame at every nfft (the kernel: the
half-length transform at 8192 and 16384, kWelchHalf), with every sum in
registers and with every sum in shared memory that fits (the kernel's
kRegSums), with a grid of 2 and 4 waves of the SMs (the kernel: one
wave), with a launch bound of 64 registers at every nfft, of 85 up to
4096 and of 128 up to 8192 (the kernel's kRegisters), and with every
load of the frame's mean unrolled (the kernel: a runtime loop), each
call timed with the torch.sum over its partial rows where there are
several;
c2r_fft (B7 through its complex64 and planar sources, B8) with 1, 4 and
16 bins a thread staged a round from A and B (the kernel: 8, kStage; B7
runs as the kernel there), with 8 and 32 from A alone (the kernel: 16,
kStageA; B8 runs as the kernel there), and with the launch bound at 64 and
at 128 registers at every m (the kernel: R2cShape's, 80 registers up to
m = 4096, then 64); filt_fft's bank at n = 16384 over a cluster of two
blocks of 8192 points (its own C entry; the kernel: one block a row);
rows_t_fft (B4, through both of its entries, with the four-step's outer
twiddle, at 1024 x 4096 and the other splits of 2^22) in clusters of 16, 4
and 1 rows (the kernel: 8), with one and two rows of 4096 points a block
(256 and 512 threads, clusters of 8 and 4 blocks; the kernel: four rows in
1024 threads, a cluster of 2), with one row of 2048 a block (a cluster of
8; the kernel: 8 rows, one block), with two rows of 8192 a block (the
kernel: one), with blocks of 128 threads below 2048 points (the first
design's: a cluster of 2 blocks of 4 rows at 512, of 4 of 2 rows at 1024;
the kernel: one block of 8 rows),
with the launch bound at 64 and at 128 registers (the kernel: RowsShape's,
80 up to 256 threads), with the lo table read through the cache and not
staged, with the transposed store pushed (each block writes its row's
points into their owner block's tile through distributed shared memory,
the owner stores from its own; the kernel: each block reads its peers'
rows), and, diagnostics whose output is not checked, with each row stored
untransposed, as a row kernel would, in clusters and with none;
r2c_fft (B6, through both of its sinks, at 4096 x 4096, at every pow2 n
of 128..16384 over 2^24 points, and at 4096-point rows filling four and
six waves of the card's blocks, beside torch.fft.rfft's device time) with
a pair of bins a thread after the passes at every n, with a bin a thread
after the passes at every n, with the last pass fused with the store
wherever it can be (n = 1024, 2048, 4096, 16384; the kernel: r2c_store's
choice for each n among the three) and with the launch bound at 64
registers (eight blocks of 128 threads an SM) and at seven blocks of 128
threads an SM (72 registers; the kernel: R2cShape's, six); ax0_gen_fft
(B2c, planar, at 16 x n x 512 for every composite n of chip_smoke.py's
list, 16 of the lengths whose columns stream and four that take one column
a block in a cluster, and at 16 x 1080 x 1920, beside
torch.fft.fft's device time) with one 4-byte copy a point into the tile
(the kernel: 16 bytes, four columns of a row, where the rows allow) and
with whole warps a column (the kernel: threads a column rounded to 4), and,
diagnostics whose output is not checked, with only the tiles' fetch (no
passes, so no store), without the fetch, and without the fetch and the
store (the passes alone); and with ``--parent DIR`` each of the two as that
checkout has it (the parent's source, built with its own headers), for
ax0_gen_fft also without its passes and without its store phase; gen_fft
(B13, on the same run-time passes, at the non-pow2 path's rows and the
1080p frames' rows, beside torch.fft.fft's device time, and torch.fft.rfft's
at B14's 1024 x 4095), as it is.  ptxas's registers, stack and spills of
every instantiation of r2c_fft's and ax0_gen_fft's variants are printed.
Each variant is
the kernel's source with a line or two rewritten, compiled with the port's
nvcc flags into ``fft_wgpu_tpu_torch/_build/variants/`` (all at once;
each ``lib<library>_v<i>.log`` keeps ptxas's registers and spills),
called through its complex64 entry point (ax0_fft and fft2f_fft: and the
planar one; spec_fft: and spec_psd_f32; c2r_fft: c2r_fft_f32 and
c2r_prod_fft_f32), checked against torch.fft (relative L2 <= 1e-5) and timed by
its kernel's device time from a torch.profiler window of 20
calls, two rounds in turns (the mean of the two).  The card's name and power limit (nvidia-smi) head the output; one
JSON line ends it and, with ``--out``, is appended to FILE.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from time_composite_rows import TOL, device_ms, rel_l2  # noqa: E402

ROWS_BOUND = ("  static constexpr int kMinBlocks = kBlock <= 128 ? 6 : kBlock == 256 ? 3 : "
              "1024 / kBlock;\n")
AX0_LOG2C = "  constexpr int t[2][8] = {{0, 0, 0, 0, 0, 2, 3, 4}, {0, 0, 0, 0, 0, 0, 2, 3}};\n"
AX0_COLS = "  constexpr int t[2][8] = {{32, 16, 16, 8, 8, 8, 8, 8}, {32, 16, 8, 8, 8, 4, 4, 4}};\n"
# the first design's shapes: clusters from 1024 planar (2048 complex64) on,
# 16 planar columns of 512 points, 8 complex64 columns of 1024
AX0_FIRST = ((AX0_LOG2C, "  constexpr int t[2][8] = {{0, 0, 0, 1, 2, 3, 4, 4}, "
                         "{0, 0, 0, 0, 1, 2, 3, 4}};\n"),
             (AX0_COLS, "  constexpr int t[2][8] = {{32, 16, 16, 16, 16, 16, 16, 8}, "
                        "{32, 16, 8, 8, 8, 8, 8, 8}};\n"))
# (library, variant) -> (line of the source, its replacement), or a tuple of
# such pairs; None: as is
VARIANTS = {
    ("rows_fft", "kernel"): None,
    ("rows_fft", "64 registers"): (
        ROWS_BOUND, "  static constexpr int kMinBlocks = 1024 / kBlock;\n"),
    ("ax0_fft", "kernel"): None,
    ("ax0_fft", "first design"): AX0_FIRST,
    ("ax0_fft", "2048 a column"): (AX0_LOG2C, AX0_LOG2C.replace(
        "{{0, 0, 0, 0, 0, 2, 3, 4}, {0, 0, 0, 0, 0, 0, 2, 3}}",
        "{{0, 0, 0, 0, 0, 1, 2, 3}, {0, 0, 0, 0, 0, 1, 2, 3}}")),
    ("ax0_fft", "complex64, 8 columns"): (
        (AX0_LOG2C, AX0_LOG2C.replace("{0, 0, 0, 0, 0, 0, 2, 3}", "{0, 0, 0, 0, 0, 2, 2, 3}")),
        (AX0_COLS, AX0_COLS.replace("{32, 16, 8, 8, 8, 4, 4, 4}",
                                    "{32, 16, 8, 8, 8, 8, 8, 8}"))),
    ("ax0_fft", "4 columns of 4096"): (
        (AX0_LOG2C, AX0_LOG2C.replace("{{0, 0, 0, 0, 0, 2, 3, 4}, {0, 0, 0, 0, 0, 0, 2, 3}}",
                                      "{{0, 0, 0, 0, 0, 0, 1, 2}, {0, 0, 0, 0, 0, 0, 1, 2}}")),
        (AX0_COLS, AX0_COLS.replace("{{32, 16, 16, 8, 8, 8, 8, 8}, {32, 16, 8, 8, 8, 4, 4, 4}}",
                                    "{{32, 16, 16, 8, 8, 4, 4, 4}, {32, 16, 8, 8, 8, 4, 4, 4}}"))),
}
# each ax0_fft variant's log2 of the cluster for n = 2^7 .. 2^14, planar
# and complex64 (the host's table must match the compiled one; the
# kernel's is cuda_fft._AX0_LOG2C)
AX0_VARIANT_LOG2C = {
    "first design": ((0, 0, 0, 1, 2, 3, 4, 4), (0, 0, 0, 0, 1, 2, 3, 4)),
    "2048 a column": ((0, 0, 0, 0, 0, 1, 2, 3), (0, 0, 0, 0, 0, 1, 2, 3)),
    "complex64, 8 columns": ((0, 0, 0, 0, 0, 2, 3, 4), (0, 0, 0, 0, 0, 2, 2, 3)),
    "4 columns of 4096": ((0, 0, 0, 0, 0, 0, 1, 2), (0, 0, 0, 0, 0, 0, 1, 2)),
}
FFT2F_LOG2P = "constexpr int kFft2fLog2P = 12;"
FFT2F_REGS = "constexpr int kFft2fRegisters = 64;"
VARIANTS.update({
    ("fft2f_fft", "kernel"): None,
    ("fft2f_fft", "8192 points a block"): (FFT2F_LOG2P, "constexpr int kFft2fLog2P = 13;"),
    ("fft2f_fft", "128 registers"): (FFT2F_REGS, "constexpr int kFft2fRegisters = 128;"),
})
# log2 of the points a block of each fft2f_fft variant holds (the kernel's:
# cuda_fft._FFT2F_LOG2P)
FFT2F_VARIANT_LOG2P = {"8192 points a block": 13}
SPEC_ROWS = "  static constexpr int kRows = kThreads >= 128 ? 1 : 128 / kThreads;\n"
SPEC_BOUND = "  static constexpr int kMinBlocks = 1024 / kBlock;  // 64 registers\n"
VARIANTS.update({
    ("spec_fft", "kernel"): None,
    ("spec_fft", "256 threads a block"): (SPEC_ROWS, SPEC_ROWS.replace("128", "256")),
    ("spec_fft", "six blocks of 128 an SM"): (
        SPEC_BOUND, "  static constexpr int kMinBlocks = kBlock <= 128 ? 6 : kBlock == 256 ? 3 : "
                    "1024 / kBlock;\n"),
})
# c2r_fft (B7 from both sources, B8): the bins a thread stages a round and
# the launch bounds (C2rShape)
C2R_UNROLL = "  static constexpr int kStage = 8;  // bins a thread stages a round\n"
C2R_UNROLL_A = "  static constexpr int kStageA = 16;  // the same from A alone\n"
VARIANTS.update({
    ("c2r_fft", "kernel"): None,
    ("c2r_fft", "B7: 8 bins a round"): (C2R_UNROLL_A, C2R_UNROLL_A.replace("16;", "8;")),
    ("c2r_fft", "B7: 32 bins a round"): (C2R_UNROLL_A, C2R_UNROLL_A.replace("16;", "32;")),
    ("c2r_fft", "one bin a round"): (C2R_UNROLL, C2R_UNROLL.replace("8;", "1;")),
    ("c2r_fft", "4 bins a round"): (C2R_UNROLL, C2R_UNROLL.replace("8;", "4;")),
    ("c2r_fft", "16 bins a round"): (C2R_UNROLL, C2R_UNROLL.replace("8;", "16;")),
    ("c2r_fft", "64 registers"): (
        ROWS_BOUND, "  static constexpr int kMinBlocks = 1024 / kBlock;\n"),
    ("c2r_fft", "128 registers"): (
        ROWS_BOUND, "  static constexpr int kMinBlocks = 512 / kBlock;\n"),
})
FILT_H = "    const float2 w = __ldg(&h[k]);\n"
FILT_N = "  const float2* h;\n  int n_in;\n"
FILT_SRC = "      return C64ProductIn{g.in + line() * g.n_in, g.h, g.n_in};\n"
FILT_BOUND = "  static constexpr int kMinBlocks = LOG2N == 12 ? 4 : RowsShape<LOG2N>::kMinBlocks;\n"
# B10 at n = 16384 with each bank row over a cluster of two blocks of 8192
# points: big_fft.cu's steps at C = 2 (the product at load, the 2-point
# butterfly and the twiddle w_n^(q*k1), written to block k1 through
# distributed shared memory; 8192's compiled plan in each block; the
# outputs X[2*pos + c] read back from both blocks), in a C entry of its own,
# bank_cluster_fft_f32, whose table is _bank_cluster_roots_np's
FILT_INCLUDE = '#include "mixed_fft.cuh"\n'
FILT_NAMESPACE_END = "}  // namespace\n"
FILT_ERROR = "const char* filt_fft_error_string(int err) {\n"
BANK_CLUSTER_KERNEL = r"""
namespace cg = cooperative_groups;

struct BankClusterRow {
  PadShared s;
  __device__ __forceinline__ const PadShared& src() const { return s; }
  __device__ __forceinline__ const PadShared& shared() const { return s; }
  __device__ __forceinline__ const PadShared& dst() const { return s; }
};

template <int SIGN>
__global__ void __launch_bounds__(512, 2) bank_cluster_kernel(const __grid_constant__ FiltArgs g) {
  constexpr int N = 16384, C = 2, Q = N / C, T = Q / 16, P = Q / C, PT = 16 / C;
  extern __shared__ float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = static_cast<int>(cluster.block_rank());
  const int tid = static_cast<int>(threadIdx.x);
  const size_t row = static_cast<size_t>(blockIdx.x / C) * N;
  float xr[PT][C], xi[PT][C];
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int q = b * P + tid + i * T;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = c * Q + q;
      const float ar = g.in_re[k], ai = g.in_im[k];
      const float hr = __ldg(&g.hr[row + k]), hi = __ldg(&g.hi[row + k]);
      xr[i][c] = ar * hr - ai * hi;
      xi[i][c] = ar * hi + ai * hr;
    }
  }
  cluster.sync();
  const float2* lane_tw = g.tw + (tid & 31);  // w_n^(l*k1) at [k1*32]
  const float2* warp_tw = g.tw + C * 32;      // w_n^(32*m)
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int q = b * P + tid + i * T;
    dft<C, SIGN>(xr[i], xi[i]);
    float2 w = __ldg(&warp_tw[q >> 5]);
    cmul(w.x, w.y, __ldg(&lane_tw[32]));
    cmul(xr[i][1], xi[i][1], w);
#pragma unroll
    for (int k1 = 0; k1 < C; ++k1) {
      PadShared{cluster.map_shared_rank(smem, k1)}.store(q, xr[i][k1], xi[i][k1]);
    }
  }
  cluster.sync();
  plan_fft<SIGN, 13>(BankClusterRow{PadShared{smem}}, g.tw + C * 32 + N / 32);
  cluster.sync();
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int pos = b * P + tid + i * T;
    float zr[C], zi[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      PadShared{cluster.map_shared_rank(smem, c)}.load(pos, zr[c], zi[c]);
    }
    const size_t t = row + static_cast<size_t>(C) * pos;
    *reinterpret_cast<float2*>(g.out_re + t) = make_float2(zr[0] * g.scale, zr[1] * g.scale);
    *reinterpret_cast<float2*>(g.out_im + t) = make_float2(zi[0] * g.scale, zi[1] * g.scale);
  }
  cluster.sync();
}

"""
BANK_CLUSTER_ENTRY = r"""int bank_cluster_fft_f32(const void* xr, const void* xi, const void* hr, const void* hi,
                         void* out_re, void* out_im, const void* tw, long long rows, int sign,
                         float scale, void* stream) {
  const FiltArgs g{static_cast<const float*>(xr), static_cast<const float*>(xi),
                   static_cast<float*>(out_re), static_cast<float*>(out_im),
                   static_cast<const float*>(hr), static_cast<const float*>(hi), nullptr,
                   nullptr, nullptr, static_cast<const float2*>(tw), rows, 16384, scale};
  auto* kernel = sign < 0 ? bank_cluster_kernel<-1> : bank_cluster_kernel<1>;
  constexpr int smem = padded_len(8192) * static_cast<int>(sizeof(float2));
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * 2));
  cfg.blockDim = dim3(512);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, g);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

"""
BANK_CLUSTER = "bank over a 2-block cluster"
C2C_ROWS = "  static constexpr int kRows = kThreads >= 128 ? 1 : 128 / kThreads;\n"
C2C_BOUND = "  static constexpr int kMinBlocks = 1024 / kBlock;  // 64 registers\n"
VARIANTS.update({
    ("filt_fft", "kernel"): None,
    # h is the filter's two planes one after the other, [hr | hi], 2n floats
    ("filt_fft", "planar h"): (
        (FILT_N, FILT_N + "  int n;\n"),
        (FILT_H, "    const float* p = reinterpret_cast<const float*>(h);\n"
                 "    const float2 w = make_float2(__ldg(p + k), __ldg(p + n + k));\n"),
        (FILT_SRC, FILT_SRC.replace("g.n_in};", "g.n_in, N};"))),
    ("filt_fft", "RowsShape's bound"): (
        FILT_BOUND, "  static constexpr int kMinBlocks = RowsShape<LOG2N>::kMinBlocks;\n"),
    # the product staged in the row's shared buffer before the first pass
    ("filt_fft", "staged product"): (
        ("  __device__ __forceinline__ auto src() const {\n    if constexpr (C64) {\n"
         "      return C64ProductIn",
         "  __device__ __forceinline__ PadShared src() const { return shared(); }\n"
         "  __device__ __forceinline__ auto product() const {\n    if constexpr (C64) {\n"
         "      return C64ProductIn"),
        ("  plan_fft<SIGN, LOG2N>(FiltRow<LOG2N, C64, BANK>{g}, g.tw);\n",
         "  const FiltRow<LOG2N, C64, BANK> row{g};\n  const auto in = row.product();\n"
         "  const PadShared z = row.shared();\n#pragma unroll 4\n"
         "  for (int k = threadIdx.x; k < (1 << LOG2N); k += blockDim.x) {\n"
         "    float a, b;\n    in.load(k, a, b);\n    z.store(k, a, b);\n  }\n"
         "  __syncthreads();\n  plan_fft<SIGN, LOG2N>(row, g.tw);\n")),
    ("filt_fft", BANK_CLUSTER): (
        (FILT_INCLUDE, "#include <cooperative_groups.h>\n" + FILT_INCLUDE),
        (FILT_NAMESPACE_END, BANK_CLUSTER_KERNEL + FILT_NAMESPACE_END),
        (FILT_ERROR, BANK_CLUSTER_ENTRY + FILT_ERROR)),
    ("spec_c2c_fft", "kernel"): None,
    ("spec_c2c_fft", "256 threads a block"): (C2C_ROWS, C2C_ROWS.replace("128", "256")),
    ("spec_c2c_fft", "RowsShape's bound"): (
        C2C_BOUND, "  static constexpr int kMinBlocks = kBlock <= 128 ? 6 : kBlock == 256 ? 3 : "
                   "1024 / kBlock;\n"),
})
WELCH_HALF = ("constexpr bool kWelchHalf[8] = {false, false, false, false, false, false, true, "
              "true};")
# kRegSums' and kRegisters' rows, one a kind
WELCH_SUMS = {"welch": "{{1, 1, 0, 0, 0, 0, 0, 0},   // welch",
              "coh": "{4, 0, 0, 0, 0, 0, 0, 2},   // coh",
              "csd": "{2, 2, 2, 2, 2, 2, 2, 0},   // csd",
              "c2c": "{0, 0, 0, 0, 0, 0, 0, 0}};  // c2c"}
WELCH_REGS = {"welch": "{{85, 85, 85, 85, 85, 85, 64, 64},         // welch",
              "coh": "{85, 85, 85, 85, 85, 85, 64, 64},         // coh",
              "csd": "{128, 128, 128, 128, 128, 128, 128, 64},  // csd",
              "c2c": "{85, 64, 128, 128, 128, 128, 128, 64}};   // c2c"}
WELCH_SLOTS = "  const long long slots = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);"
WELCH_MEAN = ("        for (int i = tx; i < g.nperseg; i += T) {\n          ma += pa[i];\n"
              "          if (pb != nullptr) mb += pb[i];\n        }\n")


def _rows(table, new):
    """Edits of rows of a per-kind table: kind -> its new numbers."""
    def nums(row):
        return row[row.rindex("{") + 1:row.index("}")]
    return tuple((table[k], table[k].replace(nums(table[k]), v)) for k, v in new.items())


VARIANTS.update({
    ("welch_acc_fft", "kernel"): None,
    ("welch_acc_fft", "half-length welch"): (WELCH_HALF, WELCH_HALF.replace("false", "true")),
    ("welch_acc_fft", "pairs of frames"): (WELCH_HALF, WELCH_HALF.replace("true", "false")),
    ("welch_acc_fft", "sums in registers"): _rows(WELCH_SUMS, {
        "welch": "1, 1, 1, 1, 1, 1, 1, 1", "coh": "4, 4, 4, 4, 4, 4, 4, 4"}),
    ("welch_acc_fft", "sums in shared memory"): _rows(WELCH_SUMS, {
        "welch": "0, 0, 0, 0, 0, 0, 0, 0", "coh": "0, 0, 0, 0, 0, 0, 0, 2",
        "csd": "0, 0, 0, 0, 0, 0, 0, 0"}),
    ("welch_acc_fft", "2 waves"): (WELCH_SLOTS, WELCH_SLOTS.replace("(sms)", "(2 * sms)")),
    ("welch_acc_fft", "4 waves"): (WELCH_SLOTS, WELCH_SLOTS.replace("(sms)", "(4 * sms)")),
    ("welch_acc_fft", "64 registers"): _rows(WELCH_REGS, dict.fromkeys(
        WELCH_REGS, "64, 64, 64, 64, 64, 64, 64, 64")),
    ("welch_acc_fft", "85 registers"): _rows(WELCH_REGS, dict.fromkeys(
        WELCH_REGS, "85, 85, 85, 85, 85, 85, 64, 64")),
    ("welch_acc_fft", "128 registers"): _rows(WELCH_REGS, dict.fromkeys(
        WELCH_REGS, "128, 128, 128, 128, 128, 128, 128, 64")),
    ("welch_acc_fft", "mean loads unrolled"): (
        WELCH_MEAN, "#pragma unroll\n        for (int r = 0; r < N / T; ++r) {\n"
                    "          const int i = tx + r * T;\n          if (i < g.nperseg) {\n"
                    "            ma += pa[i];\n            if (pb != nullptr) mb += pb[i];\n"
                    "          }\n        }\n"),
})
# the variants of each welch_acc_fft kind (the others build its kernel as it is)
WELCH_COMMON = ("kernel", "2 waves", "4 waves", "64 registers", "128 registers",
                "mean loads unrolled")
WELCH_VARIANTS = {"welch": WELCH_COMMON + ("half-length welch", "pairs of frames",
                                           "sums in registers", "sums in shared memory"),
                  "coh": WELCH_COMMON + ("sums in registers",),
                  "csd": WELCH_COMMON + ("85 registers", "sums in shared memory"),
                  "c2c": WELCH_COMMON + ("85 registers",)}
# (kind, rows, t, nperseg) of welch_acc_fft's shapes, hop nperseg/2, nfft
# nperseg, constant detrend: path 6's 2^22 and 64 x 2^20, and the envelope
# at 2^22 (B21, "c2c": x and y the planes of a complex signal, at every nfft)
WELCH_SHAPES = (("welch", 1, 1 << 22, 4096), ("welch", 64, 1 << 20, 256),
                ("coh", 1, 1 << 22, 4096)) + tuple(
    (kind, 1, 1 << 22, 1 << e) for e in (7, 9, 13, 14) for kind in ("welch", "coh")
) + tuple((kind, 1, 1 << 22, 1 << e) for kind in ("csd", "c2c") for e in range(7, 15))
# (rows, n, n_in) of filt_fft's shapes: SpectralFilter's 4096^2, hilbert's
# half spectrum, and 1000 rows at the ends and middle of the envelope
FILT_SHAPES = ((4096, 4096, 4096), (4096, 4096, 2049), (1000, 128, 128), (1000, 1024, 1024),
               (1000, 16384, 16384))
# bank rows of the bank variants at n = 16384: the CWT plan's 128, and 132,
# 264 (one and two blocks an SM)
BANK_ROWS = (128, 132, 264)
# (t, nperseg, hop, nfft, detrend) of spec_c2c_fft's shapes: the complex
# spectrogram's 2^22 (with and without its detrend), half overlap at 128,
# 512 and 16384
C2C_SHAPES = ((1 << 22, 4096, 2048, 4096, "constant"), (1 << 22, 4096, 2048, 4096, False),
              (1 << 22, 128, 64, 128, False),
              (1 << 22, 512, 256, 512, False), (1 << 22, 16384, 8192, 16384, False))
# (t, nperseg, hop, nfft, detrend) of spec_fft's shapes: the complex
# spectrogram's 2^22, half overlap at 512 and 16384, stft's 2^20 (centred)
SPEC_SHAPES = ((1 << 22, 4096, 2048, 4096, "constant"), (1 << 22, 512, 256, 512, False),
               (1 << 22, 16384, 8192, 16384, False), ((1 << 20) + 512, 512, 128, 512, False))
# (t, nperseg, hop, nfft) of B19's shapes (constant detrend): the psd
# spectrogram's 2^22, and every pow2 nfft at half overlap over 2^22 points
PSD_SHAPES = ((1 << 22, 4096, 3584, 4096),) + tuple(
    (1 << 22, 1 << e, 1 << e - 1, 1 << e) for e in range(7, 15))
# (rows, n, padded, broadcast B) of c2r_fft's product kernel: fftconvolve's
# 2048 x 8192 padded, ragged and broadcast, and every pow2 n over 2^24 points
C2R_SHAPES = ((2048, 8192, True, False), (2048, 8192, False, False),
              (2048, 8192, True, True)) + tuple(
    (1 << 24 >> e, 1 << e, True, False) for e in range(7, 15))
# (rows, n, entries) of c2r_fft's B7: 4096^2 through both sources, and every
# pow2 n over 2^24 points through the complex64 one
C2R_B7_SHAPES = ((4096, 4096, ("c2r_fft_c64", "c2r_fft_f32")),) + tuple(
    (1 << 24 >> e, 1 << e, ("c2r_fft_c64",)) for e in range(7, 15))
# (planes, A, B) of fft2f_fft's shapes: fftn 256^3's planes, 16 of each plane
FFT2F_SHAPES = ((256, 256, 256), (16, 128, 128), (16, 128, 256), (16, 256, 128),
                (16, 128, 512), (16, 512, 128), (16, 256, 256))
# (n, m) of ax0_fft's shapes: config 3's pass 1, fft2's 4096^2, the 256^3
# axis(-3) view, and the large n
AX0_SHAPES = ((1024, 4096), (4096, 4096), (256, 65536), (128, 131072), (512, 32768),
              (2048, 8192), (8192, 2048), (16384, 1024))
# the cluster sizes of the variants that change them
CLUSTER = {"8 blocks at 2^15": (15, 8), "16 blocks at 2^17": (17, 16)}
ROWS_SHAPES = ((4096, 4096), (2048, 2048), (2500, 512), (1000, 128), (1024, 16384))
# (rows, log2 n) of big_fft's shapes: the main path's and the route's
BIG_SHAPES = ((64, 15), (256, 16), (16, 17), (256, 17), (16, 18), (64, 18))


# rows_t_fft (B4): cluster size, rows a block, launch bounds, the lo table,
# and two ways of the transposed store
ROWS_T_CLUSTER = "constexpr int kRowsTCluster = 8;   // rows a cluster stores together\n"
ROWS_T_ROWS = "  static constexpr int kRows = rows_t_rows(kThreads);\n"
ROWS_T_BOUND = ("  static constexpr int kMinBlocks = kBlock <= 128 ? 6 : kBlock == 256 ? 3 : "
                "1024 / kBlock;\n")
ROWS_T_LO = ("  float2* lo = smem + S::kRowPairs;\n",
             "    for (int t = flat; t < (1 << g.lo_bits); t += S::kBlock) lo[t] = __ldg(&g.lo[t]);\n")
ROWS_T_STORE = r"""  const int t = flat % CT;
  float2* p = smem + (t % S::kRows) * S::kLd;
  if constexpr (C > 1) {
    cluster.sync();  // every block's rows are transformed
    p = cluster.map_shared_rank(p, t / S::kRows);
  }
  const bool out = rc0 + t < g.rows;
  constexpr int kStep = S::kBlock / CT;
  constexpr int kIters = N / C / kStep;
  const int k0 = cb * (N / C) + flat / CT;
  const size_t base = static_cast<size_t>(plane) * N * g.rows + rc0 + t;
  float2 v[kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i) v[i] = p[padded(k0 + i * kStep)];
  if (out) {
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const size_t o = base + static_cast<size_t>(k0 + i * kStep) * g.rows;
      if constexpr (C64) {
        g.out[o] = make_float2(v[i].x * g.scale, v[i].y * g.scale);
      } else {
        g.out_re[o] = v[i].x * g.scale;
        g.out_im[o] = v[i].y * g.scale;
      }
    }
  }
  if constexpr (C > 1) cluster.sync();  // no block exits while another reads its rows
}
"""
ROWS_T_PUSH = r"""  constexpr int T = S::kThreads;
  constexpr int kHold = N / T;
  const float2* own = smem + threadIdx.y * S::kLd;
  float2 v[kHold];
#pragma unroll
  for (int i = 0; i < kHold; ++i) v[i] = own[padded(static_cast<int>(threadIdx.x) + i * T)];
  if constexpr (C > 1) cluster.sync(); else __syncthreads();  // every row is read
  const int slot = cb * S::kRows + static_cast<int>(threadIdx.y);
#pragma unroll
  for (int i = 0; i < kHold; ++i) {
    const int k = static_cast<int>(threadIdx.x) + i * T;
    float2* dst = smem;
    if constexpr (C > 1) dst = cluster.map_shared_rank(smem, k / (N / C));
    dst[padded((k % (N / C)) * CT + slot)] = v[i];
  }
  if constexpr (C > 1) cluster.sync(); else __syncthreads();  // every tile is filled
  const int t = flat % CT;
  const bool out = rc0 + t < g.rows;
  constexpr int kStep = S::kBlock / CT;
  constexpr int kIters = N / C / kStep;
  const size_t base = static_cast<size_t>(plane) * N * g.rows + rc0 + t;
  if (out) {
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int kk = flat / CT + i * kStep;
      const float2 w = smem[padded(kk * CT + t)];
      const size_t o = base + static_cast<size_t>(cb * (N / C) + kk) * g.rows;
      if constexpr (C64) {
        g.out[o] = make_float2(w.x * g.scale, w.y * g.scale);
      } else {
        g.out_re[o] = w.x * g.scale;
        g.out_im[o] = w.y * g.scale;
      }
    }
  }
}
"""
ROWS_T_UNTRANSPOSED = r"""  constexpr int T = S::kThreads;
  const float2* own = smem + threadIdx.y * S::kLd;
  if (valid) {
#pragma unroll
    for (int i = 0; i < N / T; ++i) {
      const int k = static_cast<int>(threadIdx.x) + i * T;
      const float2 w = own[padded(k)];
      if constexpr (C64) {
        g.out[off + k] = make_float2(w.x * g.scale, w.y * g.scale);
      } else {
        g.out_re[off + k] = w.x * g.scale;
        g.out_im[off + k] = w.y * g.scale;
      }
    }
  }
  if constexpr (C > 1) cluster.sync();
}
"""
VARIANTS.update({
    ("rows_t_fft", "kernel"): None,
    ("rows_t_fft", "cluster of 16 rows"): (ROWS_T_CLUSTER, ROWS_T_CLUSTER.replace("8;", "16;")),
    ("rows_t_fft", "cluster of 4 rows"): (ROWS_T_CLUSTER, ROWS_T_CLUSTER.replace("8;", "4;")),
    ("rows_t_fft", "one row of 4096 a block"): (
        ROWS_T_ROWS, "  static constexpr int kRows = kThreads == 256 ? 1 : rows_t_rows(kThreads);\n"),
    ("rows_t_fft", "two rows of 4096 a block"): (
        ROWS_T_ROWS, "  static constexpr int kRows = kThreads == 256 ? 2 : rows_t_rows(kThreads);\n"),
    ("rows_t_fft", "one row of 2048 a block"): (
        ROWS_T_ROWS, "  static constexpr int kRows = kThreads == 128 ? 1 : rows_t_rows(kThreads);\n"),
    ("rows_t_fft", "two rows of 8192 a block"): (
        ROWS_T_ROWS, "  static constexpr int kRows = kThreads == 512 ? 2 : rows_t_rows(kThreads);\n"),
    ("rows_t_fft", "128 threads a block below 2048"): (
        ROWS_T_ROWS, "  static constexpr int kRows = kThreads >= 128 ? rows_t_rows(kThreads) : 128 / kThreads;\n"),
    ("rows_t_fft", "cluster of 1 row"): (ROWS_T_CLUSTER, ROWS_T_CLUSTER.replace("8;", "1;")),
    ("rows_t_fft", "64 registers"): (
        ROWS_T_BOUND, "  static constexpr int kMinBlocks = 1024 / kBlock;\n"),
    ("rows_t_fft", "128 registers"): (
        ROWS_T_BOUND, "  static constexpr int kMinBlocks = kBlock <= 512 ? 512 / kBlock : 1;\n"),
    ("rows_t_fft", "lo not staged"): ((ROWS_T_LO[0], "  const float2* lo = g.lo;\n"),
                                      (ROWS_T_LO[1], "")),
    ("rows_t_fft", "pushed store"): (ROWS_T_STORE, ROWS_T_PUSH),
    ("rows_t_fft", "untransposed (diagnostic)"): (ROWS_T_STORE, ROWS_T_UNTRANSPOSED),
    ("rows_t_fft", "untransposed, no cluster (diagnostic)"): (
        (ROWS_T_STORE, ROWS_T_UNTRANSPOSED), (ROWS_T_CLUSTER, ROWS_T_CLUSTER.replace("8;", "1;"))),
})
# big_fft (B15): the decimated rows a block, the cluster size at 2^15 and
# 2^17, the launch bound, the decimation in frequency (its own kernel and
# entry points, inserted), and diagnostics of its phases (the passes left
# out; the exchange through distributed shared memory made local as well)
BIG_BOUND = "  static constexpr int kMinBlocks = kThreads == 256 ? 3 : kThreads == 512 ? 2 : 1;\n"
BIG_15 = "    case 15 * 8 + 2: return launch<15, 2, C64>(sign, g, rows, s);\n"
BIG_15_MAX = "    case 15 * 8 + 2: return max_clusters<15, 2, C64>(count);\n"
BIG_17 = "    case 17 * 8 + 3: return launch<17, 3, C64>(sign, g, rows, s);\n"
BIG_17_MAX = "    case 17 * 8 + 3: return max_clusters<17, 3, C64>(count);\n"
BIG_C8_15 = ((BIG_15, BIG_15 + BIG_15.replace("2: return launch<15, 2", "3: return launch<15, 3")),
             (BIG_15_MAX, BIG_15_MAX + BIG_15_MAX.replace("2: return max_clusters<15, 2",
                                                          "3: return max_clusters<15, 3")))
BIG_C16_17 = ((BIG_17, BIG_17 + BIG_17.replace("3: return launch<17, 3", "4: return launch<17, 4")),
              (BIG_17_MAX, BIG_17_MAX + BIG_17_MAX.replace("3: return max_clusters<17, 3",
                                                           "4: return max_clusters<17, 4")))
BIG_PLAN = "  plan_fft<SIGN, LOG2Q>(BigRow<StridedIn<C, C64>>{in, {smem}}, g.tw + C * 32 + N / 32);\n"
BIG_COPY = """  for (int j = 0; j < 16; ++j) {
    float u, v;
    in.load(tid + j * T, u, v);
    PadShared{smem}.store(tid + j * T, u, v);
  }
  __syncthreads();
"""
BIG_GATHER = "      PadShared{cluster.map_shared_rank(smem, c)}.load(k2, zr[c], zi[c]);\n"
BIG_LOCAL = (BIG_GATHER, BIG_GATHER.replace("cluster.map_shared_rank(smem, c)", "smem"))
# the decimated row read as Q contiguous points from the block's own Q-th of
# the row (the same bytes, each sector read whole by one block)
BIG_CONTIGUOUS = (
    ("      const float2 v = z[static_cast<size_t>(q) * C];\n", "      const float2 v = z[q];\n"),
    ("      a = r[static_cast<size_t>(q) * C];\n      b = i[static_cast<size_t>(q) * C];\n",
     "      a = r[q];\n      b = i[q];\n"),
    ("    in.z = g.in + row + b;\n", "    in.z = g.in + row + b * Q;\n"),
    ("    in.r = g.in_re + row + b;\n    in.i = g.in_im + row + b;\n",
     "    in.r = g.in_re + row + b * Q;\n    in.i = g.in_im + row + b * Q;\n"))
# the decimation in frequency, one decimated row a block: block b reads
# x[c*Q + q] at its positions q of every chunk c, takes the C-point DFT and
# the twiddle w_n^(q*k1) in registers, writes Y_k1[q] to block k1 through
# distributed shared memory, and runs Q's plan, whose last pass stores
# X[b + C*k2] to device memory at stride C (its table: _RESIDUES = 1's)
BIG_DIF_ERROR = "const char* big_fft_error_string(int err) {\n"
BIG_DIF_NAMESPACE_END = "}  // namespace\n"
BIG_DIF_KERNEL = r"""
namespace dif {
template <int C, bool C64>
struct DifOut {
  float* r;
  float* i;
  float2* z;
  float scale;
  static constexpr bool kShared = false;
  __device__ __forceinline__ void store(int k, float a, float b) const {
    if constexpr (C64) {
      z[static_cast<size_t>(k) * C] = make_float2(a * scale, b * scale);
    } else {
      r[static_cast<size_t>(k) * C] = a * scale;
      i[static_cast<size_t>(k) * C] = b * scale;
    }
  }
};

template <class Dst>
struct DifRow {
  PadShared s;
  Dst out;
  __device__ __forceinline__ const PadShared& src() const { return s; }
  __device__ __forceinline__ const PadShared& shared() const { return s; }
  __device__ __forceinline__ const Dst& dst() const { return out; }
};

template <int SIGN, int LOG2N, int LOG2C, bool C64>
__global__ void __launch_bounds__((1 << (LOG2N - LOG2C)) / 16,
                                  (1 << (LOG2N - LOG2C)) / 16 == 512 ? 2 : 1)
big_fft_kernel(const __grid_constant__ BigArgs g) {
  constexpr int N = 1 << LOG2N, C = 1 << LOG2C, LOG2Q = LOG2N - LOG2C, Q = 1 << LOG2Q;
  constexpr int T = Q / 16, P = Q / C, PT = 16 / C;
  extern __shared__ float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = static_cast<int>(cluster.block_rank());
  const int tid = static_cast<int>(threadIdx.x);
  const size_t row = static_cast<size_t>(blockIdx.x / C) * N;
  const float2* lane_tw = g.tw + (tid & 31);
  const float2* warp_tw = g.tw + C * 32;
  float xr[PT][C], xi[PT][C];
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const size_t q = row + b * P + tid + i * T;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if constexpr (C64) {
        const float2 v = g.in[q + c * Q];
        xr[i][c] = v.x;
        xi[i][c] = v.y;
      } else {
        xr[i][c] = g.in_re[q + c * Q];
        xi[i][c] = g.in_im[q + c * Q];
      }
    }
  }
  cluster.sync();
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int q = b * P + tid + i * T;
    dft<C, SIGN>(xr[i], xi[i]);
#pragma unroll
    for (int k1 = 1; k1 < C; ++k1) {
      float2 w = __ldg(&warp_tw[(q >> 5) * k1]);
      cmul(w.x, w.y, __ldg(&lane_tw[k1 * 32]));
      cmul(xr[i][k1], xi[i][k1], w);
    }
#pragma unroll
    for (int k1 = 0; k1 < C; ++k1) {
      PadShared{cluster.map_shared_rank(smem, k1)}.store(q, xr[i][k1], xi[i][k1]);
    }
  }
  cluster.sync();
  DifOut<C, C64> out{};
  out.scale = g.scale;
  if constexpr (C64) {
    out.z = g.out + row + b;
  } else {
    out.r = g.out_re + row + b;
    out.i = g.out_im + row + b;
  }
  plan_fft<SIGN, LOG2Q>(DifRow<DifOut<C, C64>>{{smem}, out}, g.tw + C * 32 + N / 32);
}

template <int LOG2N, int LOG2C, bool C64>
int dif_launch(const BigArgs& g, long long rows, int sign, void* stream) {
  constexpr int C = 1 << LOG2C, Q = 1 << (LOG2N - LOG2C);
  auto* kernel = sign < 0 ? big_fft_kernel<-1, LOG2N, LOG2C, C64>
                          : big_fft_kernel<1, LOG2N, LOG2C, C64>;
  constexpr int smem = padded_len(Q) * static_cast<int>(sizeof(float2));
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && C > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * C));
  cfg.blockDim = dim3(Q / 16);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, g);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool C64>
int dif_dispatch(const BigArgs& g, long long rows, int log2n, int log2c, int sign, void* stream) {
  switch (log2n * 8 + log2c) {
    case 15 * 8 + 2: return dif_launch<15, 2, C64>(g, rows, sign, stream);
    case 16 * 8 + 3: return dif_launch<16, 3, C64>(g, rows, sign, stream);
    case 17 * 8 + 3: return dif_launch<17, 3, C64>(g, rows, sign, stream);
    case 18 * 8 + 4: return dif_launch<18, 4, C64>(g, rows, sign, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dif
"""
BIG_DIF_ENTRIES = r"""int big_dif_fft_f32(const void* in_re, const void* in_im, void* out_re, void* out_im,
                    const void* tw, long long rows, int log2n, int log2c, int sign, float scale,
                    void* stream) {
  const BigArgs g{static_cast<const float*>(in_re), static_cast<const float*>(in_im),
                  static_cast<float*>(out_re), static_cast<float*>(out_im), nullptr, nullptr,
                  static_cast<const float2*>(tw), scale};
  return dif::dif_dispatch<false>(g, rows, log2n, log2c, sign, stream);
}

int big_dif_fft_c64(const void* in, void* out, const void* tw, long long rows, int log2n,
                    int log2c, int sign, float scale, void* stream) {
  const BigArgs g{nullptr, nullptr, nullptr, nullptr, static_cast<const float2*>(in),
                  static_cast<float2*>(out), static_cast<const float2*>(tw), scale};
  return dif::dif_dispatch<true>(g, rows, log2n, log2c, sign, stream);
}

"""
# R decimated rows x[q*G + R*b + r] a block (G = R*C), each a threadIdx.y,
# so that one block reads the R points of a 32-byte sector: each row's
# plan of n/G points, its last pass storing Y_s[k] * w_n^(s*k); in the
# butterfly step the C-point DFT over the blocks for each r, the twiddle
# w_G^(r*K1) from a table of |w|^2 nearest 1, the R-point DFT over r in
# registers and across the lanes that share a position; at R = 1 the
# kernel's steps with the twiddle moved into the last pass's store (its
# own kernel and entry points, inserted; its table: _rows_roots_np)
BIG_RES_KERNEL = r"""
namespace res {


// Decimated rows a block, R.
constexpr int kResRows = 4;

// The shape of n = 2^LOG2N's launch: C = 2^LOG2C blocks of R decimated rows
// of Q points, G = R*C decimated rows in all; Q/16 threads a decimated row
// (threadIdx.x; threadIdx.y is the row); the launch bound's blocks an SM (two
// at 512 threads, 64 registers; up to 80 at 256); decimated rows kLd pairs
// apart in shared memory (four more than the padded row, so that a warp
// reading four rows at one position touches four groups of banks).  In the
// butterfly step a thread holds 16 points: kRpt decimated rows of kPpt
// positions from the C blocks, kTpp threads sharing a position.
template <int LOG2N, int LOG2C>
struct BigShape {
  static constexpr int kC = 1 << LOG2C;
  static constexpr int kR = kResRows;
  static constexpr int kG = kR * kC;
  static constexpr int kLog2Q = LOG2N - LOG2C - (kR == 4 ? 2 : kR == 2 ? 1 : 0);
  static constexpr int kQ = 1 << kLog2Q;
  static constexpr int kX = kQ / 16;
  static constexpr int kThreads = kX * kR;
  static constexpr int kMinBlocks = kThreads == 256 ? 3 : kThreads == 512 ? 2 : 1;
  static constexpr int kLd = padded_len(kQ) + 4;
  static constexpr int kSmem = kR * kLd * static_cast<int>(sizeof(float2));
  static constexpr int kTpp = kG > 16 ? kG / 16 : 1;
  static constexpr int kRpt = kR / kTpp;
  static constexpr int kPpt = 16 / (kC * kRpt);
  static_assert(kR == 1 || kR == 2 || kR == 4, "one, two or four decimated rows a block");
  static_assert(kTpp * kRpt == kR && kPpt * kC * kRpt == 16, "a thread holds 16 points");
};

// Point q of a block's decimated row, x[q*G] from its first point.
template <int G, bool C64>
struct StridedIn {
  const float* r;  // planar
  const float* i;
  const float2* z;  // complex64
  static constexpr bool kShared = false;
  __device__ __forceinline__ void load(int q, float& a, float& b) const {
    if constexpr (C64) {
      const float2 v = z[static_cast<size_t>(q) * G];
      a = v.x;
      b = v.y;
    } else {
      a = r[static_cast<size_t>(q) * G];
      b = i[static_cast<size_t>(q) * G];
    }
  }
};

// Decimated row s in shared memory, point k stored times w_n^(s*k): the
// warp root of (k >> 5) * s times the lane root of (k mod 32, s).
struct TwiddledShared {
  float2* p;
  const float2* warp;  // w_n^(32*m)
  const float2* lane;  // w_n^(l*s) at [l]
  int s;
  static constexpr bool kShared = true;
  __device__ __forceinline__ void load(int k, float& a, float& b) const {
    PadShared{p}.load(k, a, b);
  }
  __device__ __forceinline__ void store(int k, float a, float b) const {
    float2 w = __ldg(&warp[(k >> 5) * s]);
    cmul(w.x, w.y, __ldg(&lane[k & 31]));
    cmul(a, b, w);
    PadShared{p}.store(k, a, b);
  }
};

// A decimated row's Q-point transform: device memory -> shared memory.
template <class Src>
struct BigRow {
  Src in;
  PadShared s;
  TwiddledShared out;
  __device__ __forceinline__ const Src& src() const { return in; }
  __device__ __forceinline__ const PadShared& shared() const { return s; }
  __device__ __forceinline__ const TwiddledShared& dst() const { return out; }
};

// v of the lane `mask` away, both parts.
__device__ __forceinline__ void swap_lanes(float& re, float& im, float& pre, float& pim,
                                           int mask) {
  pre = __shfl_xor_sync(0xffffffffu, re, mask);
  pim = __shfl_xor_sync(0xffffffffu, im, mask);
}

// One radix-2 step of a DFT across the lanes `mask` apart: the lane whose
// `mask` bit is clear keeps the sum, the other the difference (its
// partner's value less its own).
template <int N>
__device__ __forceinline__ void lanes_dft2(float (&r)[N], float (&i)[N], int mask, bool high) {
#pragma unroll
  for (int m = 0; m < N; ++m) {
    float pr, pi;
    swap_lanes(r[m], i[m], pr, pi, mask);
    r[m] = high ? pr - r[m] : r[m] + pr;
    i[m] = high ? pi - i[m] : i[m] + pi;
  }
}

template <int SIGN, int LOG2N, int LOG2C, bool C64>
__global__ void __launch_bounds__(BigShape<LOG2N, LOG2C>::kThreads,
                                  BigShape<LOG2N, LOG2C>::kMinBlocks)
big_fft_kernel(const __grid_constant__ BigArgs g) {
  using S = BigShape<LOG2N, LOG2C>;
  constexpr int N = 1 << LOG2N;
  constexpr int C = S::kC, R = S::kR, G = S::kG, Q = S::kQ;
  constexpr int TPP = S::kTpp, RPT = S::kRpt, PPT = S::kPpt;
  constexpr int P = Q / C;  // positions of a block
  extern __shared__ float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = static_cast<int>(cluster.block_rank());
  const int r = static_cast<int>(threadIdx.y);
  const int s = R * b + r;  // this thread's decimated row in step 1
  const size_t row = static_cast<size_t>(blockIdx.x / C) * N;
  const float2* g_tw = g.tw + G * 32;          // w_G^m
  const float2* warp_tw = g.tw + G * 32 + G;   // w_n^(32*m)
  const float2* pass_tw = warp_tw + N / 32;

  // 1. Y_s * w_n^(s*k) from the Q-point transform of x[q*G + s]
  StridedIn<G, C64> in{};
  if constexpr (C64) {
    in.z = g.in + row + s;
  } else {
    in.r = g.in_re + row + s;
    in.i = g.in_im + row + s;
  }
  float2* own = smem + r * S::kLd;
  const TwiddledShared out{own, warp_tw, g.tw + s * 32, s};
  plan_fft<SIGN, S::kLog2Q>(BigRow<StridedIn<G, C64>>{in, {own}, out}, pass_tw);
  cluster.sync();

  // 3. positions k: X[k + Q*(K1 + C*K2)], K1 < C, K2 < R
  const int f = r * S::kX + static_cast<int>(threadIdx.x);
  const int sub = f % TPP;  // this thread's part of its positions' rows
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int k = b * P + f / TPP + i * (S::kThreads / TPP);
    float zr[RPT][C], zi[RPT][C];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int rr = sub + TPP * j;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        PadShared{cluster.map_shared_rank(smem, c) + rr * S::kLd}.load(k, zr[j][c], zi[j][c]);
      }
      dft<C, SIGN>(zr[j], zi[j]);  // over the blocks: A_rr[K1]
#pragma unroll
      for (int k1 = 1; k1 < C; ++k1) {  // times w_G^(rr*K1)
        if (rr != 0) cmul(zr[j][k1], zi[j][k1], __ldg(&g_tw[rr * k1]));
      }
    }
    // the R-point DFT over the rows rr = sub + TPP*j: RPT points in
    // registers, the twiddle w_R^(sub*t), then TPP points across lanes;
    // K2 = t + RPT*u, u this lane's output of the lanes' DFT
#pragma unroll
    for (int k1 = 0; k1 < C; ++k1) {
      if constexpr (RPT > 1) {
        float tr[RPT], ti[RPT];
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          tr[j] = zr[j][k1];
          ti[j] = zi[j][k1];
        }
        dft<RPT, SIGN>(tr, ti);
#pragma unroll
        for (int t = 0; t < RPT; ++t) {
          zr[t][k1] = tr[t];
          zi[t][k1] = ti[t];
        }
      }
      if constexpr (TPP > 1 && RPT > 1) {
#pragma unroll
        for (int t = 1; t < RPT; ++t) {  // w_R^(sub*t)
          if (sub != 0) cmul(zr[t][k1], zi[t][k1], __ldg(&g_tw[sub * t * C]));
        }
      }
    }
    int u = 0;
    if constexpr (TPP == 2) {
#pragma unroll
      for (int t = 0; t < RPT; ++t) lanes_dft2(zr[t], zi[t], 1, sub == 1);
      u = sub;
    } else if constexpr (TPP == 4) {  // sub = c + 2a: lanes 2 apart, w_4^(c*a), lanes 1 apart
      const int c = sub & 1, a = sub >> 1;
      lanes_dft2(zr[0], zi[0], 2, a == 1);
      if (c == 1 && a == 1) {
#pragma unroll
        for (int k1 = 0; k1 < C; ++k1) cmul(zr[0][k1], zi[0][k1], make_float2(0.f, SIGN));
      }
      lanes_dft2(zr[0], zi[0], 1, c == 1);
      u = a + 2 * c;
    }
#pragma unroll
    for (int t = 0; t < RPT; ++t) {
#pragma unroll
      for (int k1 = 0; k1 < C; ++k1) {
        const size_t o = row + k + static_cast<size_t>(Q) * (k1 + C * (t + RPT * u));
        if constexpr (C64) {
          g.out[o] = make_float2(zr[t][k1] * g.scale, zi[t][k1] * g.scale);
        } else {
          g.out_re[o] = zr[t][k1] * g.scale;
          g.out_im[o] = zi[t][k1] * g.scale;
        }
      }
    }
  }
  cluster.sync();  // no block exits while others read its shared memory
}

template <int LOG2N, int LOG2C, bool C64>
int res_launch(const BigArgs& g, long long rows, int sign, void* stream) {
  using S = BigShape<LOG2N, LOG2C>;
  constexpr int C = 1 << LOG2C;
  auto* kernel = sign < 0 ? big_fft_kernel<-1, LOG2N, LOG2C, C64>
                          : big_fft_kernel<1, LOG2N, LOG2C, C64>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (e == cudaSuccess && C > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * C));
  cfg.blockDim = dim3(S::kX, S::kR);
  cfg.dynamicSmemBytes = S::kSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, g);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool C64>
int res_dispatch(const BigArgs& g, long long rows, int log2n, int log2c, int sign, void* stream) {
  switch (log2n * 8 + log2c) {
    case 15 * 8 + 2: return res_launch<15, 2, C64>(g, rows, sign, stream);
    case 16 * 8 + 3: return res_launch<16, 3, C64>(g, rows, sign, stream);
    case 17 * 8 + 3: return res_launch<17, 3, C64>(g, rows, sign, stream);
    case 18 * 8 + 4: return res_launch<18, 4, C64>(g, rows, sign, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace res
"""
BIG_RES_ENTRIES = r"""int big_res_fft_f32(const void* in_re, const void* in_im, void* out_re, void* out_im,
                    const void* tw, long long rows, int log2n, int log2c, int sign, float scale,
                    void* stream) {
  const BigArgs g{static_cast<const float*>(in_re), static_cast<const float*>(in_im),
                  static_cast<float*>(out_re), static_cast<float*>(out_im), nullptr, nullptr,
                  static_cast<const float2*>(tw), scale};
  return res::res_dispatch<false>(g, rows, log2n, log2c, sign, stream);
}

int big_res_fft_c64(const void* in, void* out, const void* tw, long long rows, int log2n,
                    int log2c, int sign, float scale, void* stream) {
  const BigArgs g{nullptr, nullptr, nullptr, nullptr, static_cast<const float2*>(in),
                  static_cast<float2*>(out), static_cast<const float2*>(tw), scale};
  return res::res_dispatch<true>(g, rows, log2n, log2c, sign, stream);
}

"""


def _big_res(rows: int):
    """The edits that insert the R-row kernel at R = ``rows``."""
    return ((BIG_DIF_NAMESPACE_END, BIG_RES_KERNEL.replace(
                "constexpr int kResRows = 4;", f"constexpr int kResRows = {rows};")
             + BIG_DIF_NAMESPACE_END),
            (BIG_DIF_ERROR, BIG_RES_ENTRIES + BIG_DIF_ERROR))


BIG_DIF = "in frequency, output through L2"
VARIANTS.update({
    ("big_fft", "kernel"): None,
    ("big_fft", BIG_DIF): ((BIG_DIF_NAMESPACE_END, BIG_DIF_KERNEL + BIG_DIF_NAMESPACE_END),
                           (BIG_DIF_ERROR, BIG_DIF_ENTRIES + BIG_DIF_ERROR)),
    ("big_fft", "two decimated rows a block"): _big_res(2),
    ("big_fft", "four decimated rows a block"): _big_res(4),
    ("big_fft", "twiddle in the last pass"): _big_res(1),
    ("big_fft", "one 512-thread block an SM"): (
        BIG_BOUND, "  static constexpr int kMinBlocks = kThreads == 256 ? 3 : 1;\n"),
    ("big_fft", "8 blocks at 2^15"): BIG_C8_15,
    ("big_fft", "16 blocks at 2^17"): BIG_C16_17,
    ("big_fft", "no passes (diagnostic)"): (BIG_PLAN, BIG_COPY),
    ("big_fft", "no passes, no exchange (diagnostic)"): ((BIG_PLAN, BIG_COPY), BIG_LOCAL),
    ("big_fft", "contiguous read (diagnostic)"): BIG_CONTIGUOUS,
    ("big_fft", "no passes, no exchange, contiguous read (diagnostic)"): (
        (BIG_PLAN, BIG_COPY), BIG_LOCAL) + BIG_CONTIGUOUS,
})
# the rows a block of the inserted R-row kernel's variants (their own
# entry points, big_res_fft_*, and table, _rows_roots_np)
BIG_VARIANT_RESIDUES = {"two decimated rows a block": 2, "four decimated rows a block": 4,
                        "twiddle in the last pass": 1}
# The two-crossing design of big_fft.cu (each point written to its owner
# block through distributed shared memory before the blocks' passes and read
# back from the C blocks after them), in a checkout that has it (--tree):
# as it is, without its passes, and without its passes with both exchanges
# made local (each block's own shared memory for its peers')
TWO_PLAN = "  plan_fft<SIGN, LOG2Q>(BigRow{PadShared{smem}}, g.tw + C * 32 + N / 32);\n"
TWO_PUSH = "      PadShared{cluster.map_shared_rank(smem, k1)}.store(q, xr[i][k1], xi[i][k1]);\n"
TWO_PULL = "      PadShared{cluster.map_shared_rank(smem, c)}.load(pos, zr[c], zi[c]);\n"
TWO_CROSSING = {
    "two crossings": None,
    "two crossings: no passes (diagnostic)": (TWO_PLAN, ""),
    "two crossings: no passes, no exchange (diagnostic)": (
        (TWO_PLAN, ""),
        (TWO_PUSH, TWO_PUSH.replace("cluster.map_shared_rank(smem, k1)", "smem")),
        (TWO_PULL, TWO_PULL.replace("cluster.map_shared_rank(smem, c)", "smem"))),
}
VARIANTS.update({("big_fft", name): edit for name, edit in TWO_CROSSING.items()})

# B6 and B2c, and the parent's (--parent): the parent's source as it is,
# for B2c also without its passes and without its store phase
R2C_STORE = "  constexpr int t[8] = {2, 2, 1, 1, 1, 0, 1, 0};\n"
R2C_BOUND = ("  static constexpr int kMinBlocks = kBlock <= 128 ? 6 : kBlock == 256 ? 3 : "
             "1024 / kBlock;\n")
AX0G_WIDE = "  const bool wide = g.m % 4 == 0 && "

AX0G_THREADS = "  int tp = (need + 3) / 4 * 4;\n"
AX0G_PASSES = "    mixed_fft<SIGN>(Ax0Tile{g, off, valid, cur * tile}, g.plan, g.tw, 1);\n"
AX0G_NO_FETCH = (("  tile_fetch(g, smem, t, wide);\n", "  __pipeline_commit();\n"),
                 ("      tile_fetch(g, smem + (cur ^ 1) * tile, t + gridDim.x, wide);\n",
                  "      __pipeline_commit();\n"))
AX0G_NO_STORE = ("    const bool valid = c0 + c < g.m;\n", "    const bool valid = false;\n")
PARENT_AX0G_PASSES = ("    mixed_fft<SIGN>(Ax0Col<false>{g, 0, true, cur * tile, 2}, g.plan, g.tw, "
                      "1);\n")
PARENT_AX0G_STORE = """    col_move<false>(g, br, br + TM * g.ld, c0 + c < g.m,
                    static_cast<size_t>(t / g.tiles) * n * g.m + c0 + c +
                        static_cast<size_t>(flat / TM) * g.m,
                    flat / TM, n, blockDim.x);
"""
PARENT = {
    ("r2c_fft", "parent"): None,
    ("ax0_gen_fft", "parent"): None,
    ("ax0_gen_fft", "parent: no passes (diagnostic)"): (PARENT_AX0G_PASSES, ""),
    ("ax0_gen_fft", "parent: no store (diagnostic)"): (PARENT_AX0G_STORE, ""),
}
VARIANTS.update({
    ("r2c_fft", "kernel"): None,
    ("r2c_fft", "pairs at every n"): (
        R2C_STORE, "  constexpr int t[8] = {1, 1, 1, 1, 1, 1, 1, 1};\n"),
    ("r2c_fft", "a bin a thread at every n"): (
        R2C_STORE, "  constexpr int t[8] = {2, 2, 2, 2, 2, 2, 2, 2};\n"),
    ("r2c_fft", "the last pass fused wherever it can"): (
        R2C_STORE, "  constexpr int t[8] = {2, 2, 1, 0, 0, 0, 1, 0};\n"),
    ("r2c_fft", "64 registers"): (R2C_BOUND, "  static constexpr int kMinBlocks = 1024 / kBlock;\n"),
    ("r2c_fft", "seven blocks of 128 threads an SM"): (
        R2C_BOUND, R2C_BOUND.replace("kBlock <= 128 ? 6", "kBlock <= 128 ? 7")),
    ("ax0_gen_fft", "kernel"): None,
    ("gen_fft", "kernel"): None,
    ("ax0_gen_fft", "4-byte copies"): (AX0G_WIDE, "  const bool wide = false && g.m % 4 == 0 && "),
    ("ax0_gen_fft", "whole warps a column"): (AX0G_THREADS, "  int tp = (need + 31) / 32 * 32;\n"),
    ("ax0_gen_fft", "fetch only (diagnostic)"): (AX0G_PASSES, ""),
    ("ax0_gen_fft", "no fetch (diagnostic)"): AX0G_NO_FETCH,
    ("ax0_gen_fft", "passes only (diagnostic)"): AX0G_NO_FETCH + (AX0G_NO_STORE,),
})
VARIANTS.update(PARENT)
# the composite lengths of chip_smoke.py's sweep (GEN_NS), B2c at 16 x n x 512;
# then 16 of the 1,042 lengths whose columns stream (a generic pass of more
# than 1024 units: 8721..16383), evenly spaced among them, and four that take
# one column a block in a cluster (1105..16380)
AX0G_NS = (640, 1000, 1005, 2047, 4095, 4097, 6561, 10000, 16383, 1920, 3072, 12288, 2197,
           2401, 14641, 15625, 1004, 16129, 14406, 16224, 646, 1080)
AX0G_STREAM_NS = (8721, 10089, 11001, 11845, 12512, 13110, 13680, 14195, 14586, 14940, 15225,
                  15498, 15747, 15960, 16184, 16383)
AX0G_CLUSTER_NS = (2002, 3510, 5005, 7007)
# B13 (gen_fft) on the same run-time passes: the non-pow2 path's rows and the
# 1080p frames' rows
GEN_SHAPES = ((1024, 4095), (2048, 1000), (1024, 4097), (17280, 1920), (1024, 16383))

# variants whose output is not the transform (timed, not checked)
UNCHECKED = {"untransposed (diagnostic)", "untransposed, no cluster (diagnostic)"} | {
    name for lib, name in VARIANTS if lib in ("big_fft", "ax0_gen_fft") and "diagnostic" in name}
# B4's shapes: the 2^22 four-step's pass 2 and the other splits of 2^22
ROWS_T_SHAPES = ((1024, 4096), (4096, 1024), (8192, 512), (16384, 256), (2048, 2048),
                 (512, 8192), (256, 16384))


def _bank_cluster_roots_np(n: int, sign: int):
    """The bank cluster variant's table (ops/bigfft.py::_big_roots_np's
    layout at C = 2): the lane roots w_n^(l*k1) as [2][32], the warp roots
    w_n^(32*m) (m < n/32), then each pass's roots of n/2's compiled plan."""
    from fft_wgpu_tpu_torch.core import twiddle
    from fft_wgpu_tpu_torch.ops import cuda_fft

    cos, sin = twiddle.roots_np(n, sign)
    idx = np.concatenate([(np.arange(2)[:, None] * np.arange(32)).ravel(),
                          32 * np.arange(n // 32)])
    pc, ps = cuda_fft._pass_roots_np(n // 2, sign)
    return np.concatenate([cos[idx], pc]), np.concatenate([sin[idx], ps])


def _rows_roots_np(n: int, sign: int, rows: int):
    """The table of big_fft's R-row variants, R = ``rows``, G = R*C
    decimated rows of Q = n/G points (C = ops/bigfft.py::_cluster(n)): the
    lane roots w_n^(l*s) as [G][32], the G roots w_G^m of |w|^2 nearest 1
    (cuda_fft.butterfly_roots_np), the warp roots w_n^(32*m) (m < n/32),
    then each pass's roots of Q's compiled plan."""
    from fft_wgpu_tpu_torch.core import twiddle
    from fft_wgpu_tpu_torch.ops import bigfft, cuda_fft

    g = rows * bigfft._cluster(n)
    cos, sin = twiddle.roots_np(n, sign)
    gc, gs = cuda_fft.butterfly_roots_np(g)
    lane = (np.arange(g)[:, None] * np.arange(32)).ravel()
    warp = 32 * np.arange(n // 32)
    pc, ps = cuda_fft._pass_roots_np(n // g, sign)
    return (np.concatenate([cos[lane], gc, cos[warp], pc]),
            np.concatenate([sin[lane], sign * gs, sin[warp], ps]))


def build_variants(parent=None):
    """Build every variant at once; a TWO_CROSSING or PARENT one from
    ``parent``'s sources (a checkout whose big_fft.cu has that design; the
    parent commit's r2c_fft.cu and ax0_gen_fft.cu)."""
    from fft_wgpu_tpu_torch.utils import build

    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)

    def one(item):
        i, ((lib_name, name), edit) = item
        csrc = (Path(parent) / "fft_wgpu_tpu_torch" / "csrc"
                if name in TWO_CROSSING or (lib_name, name) in PARENT else build.CSRC)
        src = (csrc / f"{lib_name}.cu").read_text()
        edits = () if edit is None else (edit,) if isinstance(edit[0], str) else edit
        for line, repl in edits:
            if src.count(line) != 1:
                raise RuntimeError(f"{lib_name}.cu: the line of variant {name!r} is not "
                                   "where this script expects it")
            src = src.replace(line, repl)
        cu, lib = out_dir / f"{lib_name}_v{i}.cu", out_dir / f"lib{lib_name}_v{i}.so"
        cu.write_text(src)
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc),
                               "-o", str(lib), str(cu)], capture_output=True, text=True)
        lib.with_suffix(".log").write_text(f"{lib_name} {name}\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{proc.stderr}")
        return (lib_name, name), str(lib)

    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        return dict(ex.map(one, enumerate(VARIANTS.items())))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="append the JSON line here")
    ap.add_argument("--lib", default=None,
                    choices=("rows_fft", "big_fft", "ax0_fft", "fft2f_fft", "spec_fft",
                             "filt_fft", "spec_c2c_fft", "welch_acc_fft", "c2r_fft",
                             "rows_t_fft", "r2c_fft", "ax0_gen_fft", "gen_fft"),
                    help="only this kernel's variants")
    ap.add_argument("--parent", default=None,
                    help="a checkout whose big_fft.cu has the two-crossing design, or the "
                         "parent commit's r2c_fft.cu and ax0_gen_fft.cu: its variants are "
                         "timed in turns with the kernel's")
    args = ap.parse_args()
    if args.parent is None:
        for name in TWO_CROSSING:
            del VARIANTS["big_fft", name]
        for key in PARENT:
            del VARIANTS[key]
    if args.lib:
        for key in [k for k in VARIANTS if k[0] != args.lib]:
            del VARIANTS[key]

    import torch

    if not torch.cuda.is_available():
        print("time_pow2_variants: no CUDA device", file=sys.stderr)
        return 1
    from fft_wgpu_tpu_torch.ops import bigfft, cuda_fft, cuda_welch

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fns = {}
    built = build_variants(args.parent)
    import chip_smoke

    for (lib_name, name), lib in built.items():
        if lib_name in ("r2c_fft", "ax0_gen_fft"):  # registers, stack and spills
            print(f"ptxas: {lib_name} {name} | " + "; ".join(chip_smoke.ptxas_summary(
                Path(lib).with_suffix(".log").read_text())), flush=True)
        if lib_name == "r2c_fft":  # both sinks
            f = ctypes.CDLL(lib).r2c_fft_c64
            f.argtypes, f.restype = [P, P, P, P, LL, I, F, P], I
            fns[lib_name, name] = f
            f = ctypes.CDLL(lib).r2c_fft_f32
            f.argtypes, f.restype = [P, P, P, P, P, LL, I, I, F, P], I
            fns["r2c_fft_f32", name] = f
            continue
        if lib_name == "ax0_gen_fft":  # planar only
            f = ctypes.CDLL(lib).ax0_gen_fft_f32
            f.argtypes, f.restype = [P, P, P, P, P, LL, LL, I, P, I, I, F, P], I
            fns[lib_name, name] = f
            continue
        if lib_name == "gen_fft":
            f = ctypes.CDLL(lib).gen_fft_f32
            f.argtypes, f.restype = [P, P, P, P, P, LL, I, P, I, I, F, P], I
            fns[lib_name, name] = f
            continue
        if lib_name == "welch_acc_fft":  # its launch and its shape
            f, shape = ctypes.CDLL(lib).welch_acc_f32, ctypes.CDLL(lib).welch_acc_shape
            f.argtypes, shape.argtypes = cuda_welch._ACC_ARGTYPES, cuda_welch._ACC_SHAPE_ARGTYPES
            f.restype = shape.restype = I
            fns[lib_name, name] = (f, shape)
            continue
        if lib_name == "c2r_fft":  # B8's entry, then B7's two
            f = ctypes.CDLL(lib).c2r_prod_fft_f32
            f.argtypes, f.restype = [P] * 7 + [LL, LL, I, I, F, P], I
            fns[lib_name, name] = f
            f = ctypes.CDLL(lib).c2r_fft_f32
            f.argtypes, f.restype = [P] * 5 + [LL, I, I, F, P], I
            fns["c2r_fft_f32", name] = f
            f = ctypes.CDLL(lib).c2r_fft_c64
            f.argtypes, f.restype = [P] * 4 + [LL, I, I, F, P], I
            fns["c2r_fft_c64", name] = f
            continue
        if lib_name == "filt_fft":  # the bank's entry (the cluster variant's own)
            if name == BANK_CLUSTER:
                f = ctypes.CDLL(lib).bank_cluster_fft_f32
                f.argtypes = [P] * 7 + [LL, I, F, P]
            else:
                f = ctypes.CDLL(lib).bank_fft_f32
                f.argtypes = [P] * 7 + [LL, I, I, F, P]
            f.restype = I
            fns["bank", name] = f
        if lib_name == "spec_fft":  # B19's entry beside B20's complex64 one
            f = ctypes.CDLL(lib).spec_psd_f32
            f.argtypes, f.restype = [P] * 4 + [LL, LL] + [I] * 5 + [P], I
            fns["spec_psd", name] = f
        entry = ("big_dif_fft" if name == BIG_DIF  # their own entry points
                 else "big_res_fft" if name in BIG_VARIANT_RESIDUES else lib_name)
        f = getattr(ctypes.CDLL(lib), f"{entry}_c64")
        f.argtypes = {"rows_fft": [P, P, P, LL, I, I, F, P],
                      "big_fft": [P, P, P, LL, I, I, I, F, P],
                      "ax0_fft": [P, P, P, P, LL, LL, I, I, I, F, P],
                      "fft2f_fft": [P, P, P, P, LL, I, I, I, I, F, P],
                      "spec_fft": [P, P, P, P, P, LL, LL] + [I] * 7 + [F, P],
                      "filt_fft": [P] * 4 + [LL, I, I, I, F, P],
                      "spec_c2c_fft": [P] * 6 + [LL, LL] + [I] * 5 + [F, P],
                      "rows_t_fft": [P] * 5 + [LL, I, LL, LL, I, I, F, P]}[lib_name]
        f.restype = I
        fns[lib_name, name] = f
        if lib_name in ("ax0_fft", "fft2f_fft", "rows_t_fft", "big_fft"):
            f = getattr(ctypes.CDLL(lib), f"{entry}_f32")
            f.argtypes = {"ax0_fft": [P, P, P, P, P, P, LL, LL, I, I, I, F, P],
                          "fft2f_fft": [P, P, P, P, P, P, LL, I, I, I, I, F, P],
                          "rows_t_fft": [P] * 7 + [LL, I, LL, LL, I, I, F, P],
                          "big_fft": [P] * 5 + [LL, I, I, I, F, P]}[lib_name]
            f.restype = I
            fns[f"{lib_name}_f32", name] = f
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"device": smi, "times": {}}

    def run(key, x, want, calls, kernel):
        # each variant's device ms in two rounds in turns (forward, then
        # reverse order), the mean of the two
        result["times"][key] = {}
        for name, call in calls.items():
            err = rel_l2(call(), want)
            if name in UNCHECKED:
                continue
            if err > TOL:
                raise RuntimeError(f"{name} at {key}: rel-L2 {err:.3e} > {TOL}")
        samples = {name: [] for name in calls}
        for order in (list(calls), list(calls)[::-1]):
            for name in order:
                samples[name].append(device_ms(calls[name], kernel))
        result["times"][key] = {name: sum(v) / len(v) for name, v in samples.items()}
        print(f"{key} | " + ", ".join(f"{k} {v:.4f} ms"
                                      for k, v in result["times"][key].items()), flush=True)

    def rows_call(f, x, out, tw, n):
        def call():
            err = f(x.data_ptr(), out.data_ptr(), tw.data_ptr(), x.shape[0],
                    n.bit_length() - 1, -1, 1.0, stream)
            if err:
                raise RuntimeError(f"rows_fft variant: CUDA error {err}")
            return out
        return call

    for rows, n in ROWS_SHAPES if ("rows_fft", "kernel") in VARIANTS else ():
        x = torch.complex(torch.randn(rows, n, device=dev, generator=gen),
                          torch.randn(rows, n, device=dev, generator=gen))
        out = torch.empty_like(x)
        tw = cuda_fft._twiddle_table(n, -1, dev, cuda_fft._pass_roots_np)
        run(f"rows_fft {rows}x{n}", x, torch.fft.fft(x),
            {name: rows_call(f, x, out, tw, n) for (lib, name), f in fns.items()
             if lib == "rows_fft"}, "rows_fft_kernel")
        del x, out

    cluster = bigfft._cluster

    def big_call(name, f, x, out, n, c, c64):
        # the table of c blocks a row: _big_roots_np under that cluster rule
        # (an R-row variant's: _rows_roots_np)
        bigfft._cluster = lambda m: c if m == n else cluster(m)
        try:
            tab = (_rows_roots_np(n, -1, BIG_VARIANT_RESIDUES[name])
                   if name in BIG_VARIANT_RESIDUES else bigfft._big_roots_np(n, -1))
            tab = torch.from_numpy(np.stack(tab, axis=-1)).to(dev)
        finally:
            bigfft._cluster = cluster
        if c64:
            held = (x, out)
        else:  # the planes live as long as the call
            held = (x.real.contiguous(), x.imag.contiguous(), torch.empty(x.shape, device=dev),
                    torch.empty(x.shape, device=dev))
        args = tuple(t.data_ptr() for t in held)

        def call():
            err = f(*args, tab.data_ptr(), x.shape[0], n.bit_length() - 1, c.bit_length() - 1,
                    -1, 1.0, stream)
            if err:
                raise RuntimeError(f"big_fft variant {name!r}: CUDA error {err}")
            return out if c64 else torch.complex(held[2], held[3])
        return call

    def big_cluster(name, e):
        return CLUSTER[name][1] if name in CLUSTER else cluster(1 << e)

    for (lib, name), path in built.items():
        # how many clusters fit at once, for each n the variant compiles
        if (lib != "big_fft" or name in TWO_CROSSING or name == BIG_DIF
                or name in BIG_VARIANT_RESIDUES):
            continue
        f = ctypes.CDLL(path).big_fft_max_clusters
        f.argtypes, f.restype = [I, I, I, ctypes.POINTER(I)], I
        fits = {}
        for e in range(15, 19):
            if name in CLUSTER and CLUSTER[name][0] != e:
                continue
            for c64 in (1, 0):
                count = I()
                err = f(e, big_cluster(name, e).bit_length() - 1, c64, ctypes.byref(count))
                fits[f"2^{e} {'c64' if c64 else 'f32'}"] = count.value if err == 0 else -err
        result.setdefault("max_clusters", {})[name] = fits
        print(f"big_fft {name} | clusters at once: {fits}", flush=True)
    for rows, e in BIG_SHAPES if ("big_fft", "kernel") in VARIANTS else ():
        n = 1 << e
        x = torch.complex(torch.randn(rows, n, device=dev, generator=gen),
                          torch.randn(rows, n, device=dev, generator=gen))
        out = torch.empty_like(x)
        want = torch.fft.fft(x)
        for entry, c64 in (("big_fft", True), ("big_fft_f32", False)):
            calls = {name: big_call(name, f, x, out, n, big_cluster(name, e), c64)
                     for (lb, name), f in fns.items() if lb == entry
                     and (name not in CLUSTER or CLUSTER[name][0] == e)}
            run(f"{entry} {rows}x2^{e}", x, want, calls, "big_fft_kernel")
        del x, out
    def ax0_call(name, f, x, out, n, c64):
        log2c = (cuda_fft._ax0_log2c(n, c64) if name == "kernel"
                 else AX0_VARIANT_LOG2C[name][c64][n.bit_length() - 8])
        tw_n = cuda_fft._twiddle_table(n, -1, dev)
        tw = cuda_fft._twiddle_table(n >> log2c, -1, dev, cuda_fft._pass_roots_np)
        m = x.shape[-1]
        if c64:
            held = (x, out)
        else:  # the planes live as long as the call
            held = (x.real.contiguous(), x.imag.contiguous(), torch.empty(n, m, device=dev),
                    torch.empty(n, m, device=dev))
        args = tuple(t.data_ptr() for t in held)

        def call():
            err = f(*args, tw_n.data_ptr(), tw.data_ptr(), 1, m, n.bit_length() - 1, log2c,
                    -1, 1.0, stream)
            if err:
                raise RuntimeError(f"ax0_fft variant {name!r}: CUDA error {err}")
            return out if c64 else torch.complex(held[2], held[3])
        return call

    for n, m in AX0_SHAPES if ("ax0_fft", "kernel") in VARIANTS else ():
        x = torch.complex(torch.randn(n, m, device=dev, generator=gen),
                          torch.randn(n, m, device=dev, generator=gen))
        out = torch.empty_like(x)
        want = torch.fft.fft(x, dim=0)
        for lib, c64 in (("ax0_fft", True), ("ax0_fft_f32", False)):
            run(f"{lib} {n}x{m}", x, want,
                {name: ax0_call(name, f, x, out, n, c64) for (lb, name), f in fns.items()
                 if lb == lib}, "ax0_fft_kernel")
        del x, out
    def fft2f_call(name, f, x, out, c64):
        planes, A, B = x.shape
        la, lb = A.bit_length() - 1, B.bit_length() - 1
        log2c = la + lb - FFT2F_VARIANT_LOG2P.get(name, cuda_fft._FFT2F_LOG2P)
        tabs = tuple(cuda_fft._twiddle_table(n, -1, dev, cuda_fft._pass_roots_np)
                     for n in (A, B))
        if c64:
            held = (x, out)
        else:  # the planes live as long as the call
            held = (x.real.contiguous(), x.imag.contiguous(), torch.empty(x.shape, device=dev),
                    torch.empty(x.shape, device=dev))
        args = tuple(t.data_ptr() for t in held + tabs)

        def call():
            err = f(*args, planes, la, lb, log2c, -1, 1.0, stream)
            if err:
                raise RuntimeError(f"fft2f_fft variant {name!r}: CUDA error {err}")
            return out if c64 else torch.complex(held[2], held[3])
        return call

    for planes, A, B in FFT2F_SHAPES if ("fft2f_fft", "kernel") in VARIANTS else ():
        x = torch.complex(torch.randn(planes, A, B, device=dev, generator=gen),
                          torch.randn(planes, A, B, device=dev, generator=gen))
        out = torch.empty_like(x)
        want = torch.fft.fft2(x)
        for lib, c64 in (("fft2f_fft", True), ("fft2f_fft_f32", False)):
            run(f"{lib} {planes}x{A}x{B}", x, want,
                {name: fft2f_call(name, f, x, out, c64) for (lb, name), f in fns.items()
                 if lb == lib},
                "fft2f_fft_kernel")
        del x, out
    def spec_call(name, f, x, w, out, shape):
        t, nperseg, hop, nfft, detrend = shape
        num = 1 + (t - nperseg) // hop
        tabs = (cuda_fft._twiddle_table(nfft // 2, -1, dev, cuda_fft._pass_roots_np),
                cuda_fft._halfcomplex_table(nfft, -1, dev))

        def call():
            err = f(x.data_ptr(), w.data_ptr(), out.data_ptr(), *(tab.data_ptr() for tab in tabs),
                    1, t, nperseg, hop, num, nfft.bit_length() - 1, int(detrend == "constant"),
                    0, 0, 1.0, stream)
            if err:
                raise RuntimeError(f"spec_fft variant {name!r}: CUDA error {err}")
            return out
        return call

    for shape in SPEC_SHAPES if ("spec_fft", "kernel") in VARIANTS else ():
        t, nperseg, hop, nfft, detrend = shape
        x = torch.randn(t, device=dev, generator=gen)
        w = torch.hann_window(nperseg, device=dev)
        fr = x.double().unfold(-1, nperseg, hop)
        if detrend == "constant":
            fr = fr - fr.mean(-1, keepdim=True)
        want = torch.fft.rfft(fr * w.double(), n=nfft)
        out = torch.empty(want.shape, dtype=torch.complex64, device=dev)
        run("spec_fft t={} nperseg={} hop={} nfft={} {}".format(*shape), x, want,
            {name: spec_call(name, f, x, w, out, shape) for (lb, name), f in fns.items()
             if lb == "spec_fft"}, "spec_fft_kernel")
        del x, out

    def psd_call(name, f, x, w, out, shape):
        t, nperseg, hop, nfft = shape
        num = 1 + (t - nperseg) // hop
        tw = cuda_fft._twiddle_table(nfft, -1, dev, cuda_fft._pass_roots_np)

        def call():
            err = f(x.data_ptr(), w.data_ptr(), out.data_ptr(), tw.data_ptr(), 1, t, nperseg,
                    hop, num, nfft.bit_length() - 1, 1, stream)
            if err:
                raise RuntimeError(f"spec_psd_f32 variant {name!r}: CUDA error {err}")
            return out
        return call

    for shape in PSD_SHAPES if ("spec_fft", "kernel") in VARIANTS else ():
        t, nperseg, hop, nfft = shape
        x = torch.randn(t, device=dev, generator=gen)
        w = torch.hann_window(nperseg, device=dev)
        fr = x.double().unfold(-1, nperseg, hop)
        want = torch.fft.rfft((fr - fr.mean(-1, keepdim=True)) * w.double(), n=nfft).abs() ** 2
        out = torch.empty(want.shape, device=dev)
        run("spec_psd t={} nperseg={} hop={} nfft={}".format(*shape), x, want,
            {name: psd_call(name, f, x, w, out, shape) for (lb, name), f in fns.items()
             if lb == "spec_psd"}, "psd_pairs_kernel")
        del x, out

    def c2r_call(name, f, A, B, out, n, bcast):
        m = n // 2
        tabs = (cuda_fft._twiddle_table(m, 1, dev, cuda_fft._pass_roots_np),
                cuda_fft._halfcomplex_table(n, 1, dev))
        ar, ai = A.real.contiguous(), A.imag.contiguous()
        br, bi = B.real.contiguous(), B.imag.contiguous()

        def call():
            err = f(ar.data_ptr(), ai.data_ptr(), br.data_ptr(), bi.data_ptr(), out.data_ptr(),
                    *(tab.data_ptr() for tab in tabs), A.shape[0], 1 if bcast else A.shape[0],
                    m.bit_length() - 1, A.shape[-1], 1.0 / n, stream)
            if err:
                raise RuntimeError(f"c2r_fft variant {name!r}: CUDA error {err}")
            return out
        return call

    for rows, n, pad, bcast in C2R_SHAPES if ("c2r_fft", "kernel") in VARIANTS else ():
        mp = n // 2 + 1
        bins = cuda_fft.pad_bins(n) if pad else mp
        A = torch.complex(torch.randn(rows, bins, device=dev, generator=gen),
                          torch.randn(rows, bins, device=dev, generator=gen))
        B = A[:1].flip(-1).contiguous() if bcast else A.flip(0).contiguous()
        P = (A.to(torch.complex128) * B)[:, :mp]
        P.imag[:, 0] = P.imag[:, -1] = 0
        want = torch.fft.irfft(P, n=n)
        out = torch.empty(rows, n, device=dev)
        run(f"c2r_prod {rows}x{n} {'padded' if pad else 'ragged'}{' broadcast' if bcast else ''}",
            A, want, {name: c2r_call(name, f, A, B, out, n, bcast)
                      for (lb, name), f in fns.items() if lb == "c2r_fft"}, "c2r_prod_kernel")
        del A, B, P, want, out

    def c2r_b7_call(name, f, X, out, n, c64):
        tabs = (cuda_fft._twiddle_table(n // 2, 1, dev, cuda_fft._pass_roots_np),
                cuda_fft._halfcomplex_table(n, 1, dev))
        src = (X,) if c64 else (X.real.contiguous(), X.imag.contiguous())

        def call():
            err = f(*(v.data_ptr() for v in src), out.data_ptr(),
                    *(tab.data_ptr() for tab in tabs), X.shape[0], n.bit_length() - 2,
                    X.shape[-1], 1.0 / n, stream)
            if err:
                raise RuntimeError(f"c2r_fft variant {name!r}: CUDA error {err}")
            return out
        return call

    for rows, n, layouts in C2R_B7_SHAPES if ("c2r_fft", "kernel") in VARIANTS else ():
        X = torch.complex(torch.randn(rows, n // 2 + 1, device=dev, generator=gen),
                          torch.randn(rows, n // 2 + 1, device=dev, generator=gen))
        Xh = X.to(torch.complex128)
        Xh.imag[:, 0] = Xh.imag[:, -1] = 0
        want = torch.fft.irfft(Xh, n=n)
        out = torch.empty(rows, n, device=dev)
        for entry in layouts:
            run(f"{entry} {rows}x{n}", X, want,
                {name: c2r_b7_call(name, f, X, out, n, entry == "c2r_fft_c64")
                 for (lb, name), f in fns.items() if lb == entry}, "c2r_fft_kernel")
        del X, Xh, want, out
    def filt_call(name, f, x, h, hp, out, n):
        tw = cuda_fft._twiddle_table(n, 1, dev, cuda_fft._pass_roots_np)
        h = hp if name == "planar h" else h

        def call():
            err = f(x.data_ptr(), h.data_ptr(), out.data_ptr(), tw.data_ptr(), x.shape[0],
                    n.bit_length() - 1, x.shape[-1], 1, 1.0 / n, stream)
            if err:
                raise RuntimeError(f"filt_fft variant {name!r}: CUDA error {err}")
            return out
        return call

    def bank_call(name, f, x, h, out, n, sign):
        table = _bank_cluster_roots_np if name == BANK_CLUSTER else cuda_fft._pass_roots_np
        tw = cuda_fft._twiddle_table(n, sign, dev, table)
        re, im = x.real.contiguous(), x.imag.contiguous()
        hr, hi = h.real.contiguous(), h.imag.contiguous()

        def call():
            args = (re.data_ptr(), im.data_ptr(), hr.data_ptr(), hi.data_ptr(),
                    out[0].data_ptr(), out[1].data_ptr(), tw.data_ptr(), h.shape[0])
            err = (f(*args, sign, 1.0 / n, stream) if name == BANK_CLUSTER
                   else f(*args, n.bit_length() - 1, sign, 1.0 / n, stream))
            if err:
                raise RuntimeError(f"filt_fft variant {name!r}: CUDA error {err}")
            return torch.complex(*out)
        return call

    for rows in BANK_ROWS if ("filt_fft", "kernel") in VARIANTS else ():
        n = 16384
        x = torch.complex(torch.randn(n, device=dev, generator=gen),
                          torch.randn(n, device=dev, generator=gen))
        h = torch.complex(torch.randn(rows, n, device=dev, generator=gen),
                          torch.randn(rows, n, device=dev, generator=gen))
        out = (torch.empty(rows, n, device=dev), torch.empty(rows, n, device=dev))
        for sign in (-1, 1):
            want = (torch.fft.fft(x * h) if sign < 0 else torch.fft.ifft(x * h)) / (
                n if sign < 0 else 1)
            run(f"bank {rows}x{n} sign={sign}", x, want,
                {name: bank_call(name, f, x, h, out, n, sign) for (lb, name), f in fns.items()
                 if lb == "bank" and name in ("kernel", BANK_CLUSTER)},
                r"(filt_fft|bank_cluster)_kernel")
        del x, h, out

    for rows, n, n_in in FILT_SHAPES if ("filt_fft", "kernel") in VARIANTS else ():
        x = torch.complex(torch.randn(rows, n_in, device=dev, generator=gen),
                          torch.randn(rows, n_in, device=dev, generator=gen))
        H = torch.complex(torch.randn(n, device=dev, generator=gen),
                          torch.randn(n, device=dev, generator=gen))
        hp = torch.cat([H.real, H.imag])  # [hr | hi]
        out = torch.empty(rows, n, dtype=torch.complex64, device=dev)
        want = torch.fft.ifft(torch.nn.functional.pad(x, (0, n - n_in)) * H)
        run(f"filt_fft {rows}x{n} n_in={n_in}", x, want,
            {name: filt_call(name, f, x, H, hp, out, n) for (lb, name), f in fns.items()
             if lb == "filt_fft"}, "filt_fft_kernel")
        del x, out

    def c2c_call(name, f, z, w, out, shape):
        t, nperseg, hop, nfft, detrend = shape
        num = 1 + (t - nperseg) // hop
        tw = cuda_fft._twiddle_table(nfft, -1, dev, cuda_fft._pass_roots_np)

        def call():
            err = f(z.data_ptr(), None, None, w.data_ptr(), out.data_ptr(), tw.data_ptr(), 1, t,
                    nperseg, hop, num, nfft.bit_length() - 1, int(detrend == "constant"), 1.0,
                    stream)
            if err:
                raise RuntimeError(f"spec_c2c_fft variant {name!r}: CUDA error {err}")
            return out
        return call

    for shape in C2C_SHAPES if ("spec_c2c_fft", "kernel") in VARIANTS else ():
        t, nperseg, hop, nfft, detrend = shape
        z = torch.complex(torch.randn(t, device=dev, generator=gen),
                          torch.randn(t, device=dev, generator=gen))
        w = torch.hann_window(nperseg, device=dev)
        fr = z.to(torch.complex128).unfold(-1, nperseg, hop)
        if detrend == "constant":
            fr = fr - fr.mean(-1, keepdim=True)
        want = torch.fft.fft(fr * w.double(), n=nfft)
        out = torch.empty(want.shape, dtype=torch.complex64, device=dev)
        run("spec_c2c_fft t={} nperseg={} hop={} nfft={} {}".format(*shape), z, want,
            {name: c2c_call(name, f, z, w, out, shape) for (lb, name), f in fns.items()
             if lb == "spec_c2c_fft"}, "spec_c2c_kernel")
        del z, out
    def welch_oracle(kind, x, y, w, nperseg, hop, nfft):
        # float64 torch.fft of the detrended frames, the products summed
        def spectra(v):
            fr = v.unfold(-1, nperseg, hop)
            fr = (fr - fr.mean(-1, keepdim=True)) * w.double()
            return (torch.fft.fft if v.is_complex() else torch.fft.rfft)(fr, n=nfft)

        if kind == "c2c":
            return (spectra(torch.complex(x.double(), y.double())).abs() ** 2).sum(-2).reshape(-1)
        X = spectra(x.double())
        if kind == "welch":
            return (X.abs() ** 2).sum(-2).reshape(-1)
        Y = spectra(y.double())
        P = (X.conj() * Y).sum(-2)
        outs = [P.real, P.imag]
        if kind == "coh":
            outs += [(X.abs() ** 2).sum(-2), (Y.abs() ** 2).sum(-2)]
        return torch.cat(outs).reshape(-1)

    def welch_call(name, f, shape, kind, x, y, w, args):
        # B21 ("c2c") through its planar entry, x and y the planes
        nperseg, hop, nfft = args
        number, nout, full = cuda_welch._ACC[kind]
        batch, t = x.shape
        num = 1 + (t - nperseg) // hop
        it, ti = I(), I()
        err = shape(number, batch, num, nfft.bit_length() - 1, ctypes.byref(it),
                    ctypes.byref(ti))
        if err:
            raise RuntimeError(f"welch_acc_fft variant {name!r}: shape error {err}")
        iters, tiles = it.value, ti.value
        outs = x.new_empty((nout, batch, tiles, nfft if full else nfft // 2 + 1))
        ptrs = [o.data_ptr() for o in outs.unbind(0)] + [None] * (4 - nout)
        tabs = (cuda_fft._twiddle_table(nfft, -1, dev, cuda_fft._pass_roots_np).data_ptr(),
                *cuda_fft._r2c_tables(nfft, dev))

        def call():
            err = f(number, x.data_ptr(), None if y is None else y.data_ptr(), w.data_ptr(),
                    *ptrs, *tabs, batch, t, nperseg, hop, num, nfft.bit_length() - 1, 1,
                    iters, tiles, stream)
            if err:
                raise RuntimeError(f"welch_acc_fft variant {name!r}: CUDA error {err}")
            return (outs.sum(2) if outs.shape[2] > 1 else outs[:, :, 0]).reshape(-1)
        return call

    for kind, rows, t, nperseg in WELCH_SHAPES if ("welch_acc_fft", "kernel") in VARIANTS else ():
        wargs = (nperseg, nperseg // 2, nperseg)
        x = torch.randn(rows, t, device=dev, generator=gen)
        y = torch.randn(rows, t, device=dev, generator=gen) if kind != "welch" else None
        w = torch.hann_window(nperseg, device=dev)
        want = welch_oracle(kind, x, y, w, *wargs)
        calls = {name: welch_call(name, *fns["welch_acc_fft", name], kind, x, y, w, wargs)
                 for name in WELCH_VARIANTS[kind] if ("welch_acc_fft", name) in fns}
        run(f"welch_acc_fft {kind} {rows}x{t} nperseg={nperseg} hop={nperseg // 2}", x, want,
            calls, r"\w+")
        del x, y
    def rows_t_call(name, f, x, out, c64):
        rows, n = x.shape
        outer_n = rows * n
        tw = cuda_fft._twiddle_table(n, -1, dev, cuda_fft._pass_roots_np)
        hi, lo, bits = cuda_fft._outer_tables(outer_n, -1, dev)
        if c64:
            held = (x, out)
        else:  # the planes live as long as the call
            held = (x.real.contiguous(), x.imag.contiguous(), torch.empty(n, rows, device=dev),
                    torch.empty(n, rows, device=dev))
        args = tuple(t.data_ptr() for t in held + (tw, hi, lo))

        def call():
            err = f(*args, outer_n, bits, 1, rows, n.bit_length() - 1, -1, 1.0, stream)
            if err:
                raise RuntimeError(f"rows_t_fft variant {name!r}: CUDA error {err}")
            return out if c64 else torch.complex(held[2], held[3])
        return call

    for rows, n in ROWS_T_SHAPES if ("rows_t_fft", "kernel") in VARIANTS else ():
        x = torch.complex(torch.randn(rows, n, device=dev, generator=gen),
                          torch.randn(rows, n, device=dev, generator=gen))
        out = torch.empty(n, rows, dtype=torch.complex64, device=dev)
        r = torch.arange(rows, device=dev)[:, None]
        m = torch.arange(n, device=dev)[None, :]
        ang = (-2 * np.pi / (rows * n)) * ((r * m) % (rows * n)).double()
        want = torch.fft.fft(x.to(torch.complex128) * torch.polar(torch.ones_like(ang), ang)).T
        for lib, c64 in (("rows_t_fft", True), ("rows_t_fft_f32", False)):
            run(f"{lib} {rows}x{n} outer", x, want,
                {name: rows_t_call(name, f, x, out, c64) for (lb, name), f in fns.items()
                 if lb == lib}, "rows_t_fft_kernel")
        del x, out
    def r2c_call(name, f, x, out, c64):
        n = x.shape[-1]
        tabs = tuple(t.data_ptr() for t in (
            cuda_fft._twiddle_table(n // 2, -1, dev, cuda_fft._pass_roots_np),
            cuda_fft._halfcomplex_table(n, -1, dev)))
        outs = (out,) if c64 else out

        def call():
            args = (x.data_ptr(), *(o.data_ptr() for o in outs), *tabs, x.shape[0],
                    n.bit_length() - 2)
            err = f(*args, 1.0, stream) if c64 else f(*args, n // 2 + 1, 1.0, stream)
            if err:
                raise RuntimeError(f"r2c_fft variant {name!r}: CUDA error {err}")
            return out if c64 else torch.complex(*out)
        return call

    # 4096 x 4096, every n over 2^24 points, and 4096-point rows filling four
    # and six waves of 792 blocks (132 SMs, 6 blocks of one row each)
    r2c_shapes = ((4096, 4096),) + tuple((1 << (24 - e), 1 << e) for e in range(7, 15)) + (
        (3168, 4096), (4752, 4096))
    for rows, n in r2c_shapes if ("r2c_fft", "kernel") in VARIANTS else ():
        x = torch.randn(rows, n, device=dev, generator=gen)
        want = torch.fft.rfft(x.double())
        for lib, c64 in (("r2c_fft", True), ("r2c_fft_f32", False)):
            out = (torch.empty(rows, n // 2 + 1, dtype=torch.complex64, device=dev) if c64
                   else (torch.empty(rows, n // 2 + 1, device=dev),
                         torch.empty(rows, n // 2 + 1, device=dev)))
            calls = {name: r2c_call(name, f, x, out, c64) for (lb, name), f in fns.items()
                     if lb == lib and (name in ("kernel", "parent") or rows * n == 1 << 24)}
            run(f"{lib} {rows}x{n}", x, want, calls, "r2c_fft_kernel")
        run(f"torch.fft.rfft {rows}x{n}", x, want, {"torch.fft": lambda: torch.fft.rfft(x)},
            r"\w+")
        del x, out

    def ax0g_call(name, f, re_, im_, out, n):
        plan = cuda_fft._mixed_radix_plan(n)
        radix = cuda_fft._radix_arg(plan)
        tw = cuda_fft._twiddle_table(n, -1, dev)

        def call():
            err = f(re_.data_ptr(), im_.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                    tw.data_ptr(), re_.shape[0], re_.shape[-1], n, ctypes.cast(radix, P),
                    len(plan), -1, 1.0, stream)
            if err:
                raise RuntimeError(f"ax0_gen_fft variant {name!r}: CUDA error {err}")
            return torch.complex(*out)
        return call

    ax0g_shapes = ((16, 1080, 1920),) + tuple(
        (16, n, 512) for n in AX0G_NS + AX0G_STREAM_NS[:-1] + AX0G_CLUSTER_NS)
    for shape in ax0g_shapes if ("ax0_gen_fft", "kernel") in VARIANTS else ():
        n = shape[1]
        x = torch.complex(torch.randn(shape, device=dev, generator=gen),
                          torch.randn(shape, device=dev, generator=gen))
        re_, im_ = x.real.contiguous(), x.imag.contiguous()
        out = (torch.empty_like(re_), torch.empty_like(im_))
        want = torch.fft.fft(x.to(torch.complex128), dim=-2)
        headline = shape == (16, 1080, 1920)
        calls = {name: ax0g_call(name, f, re_, im_, out, n) for (lb, name), f in fns.items()
                 if lb == "ax0_gen_fft" and (name in ("kernel", "parent") or headline)}
        run("ax0_gen_fft " + "x".join(map(str, shape)), x, want, calls, "ax0_gen_fft_kernel")
        if headline or n in (2047, 4095, 12288):
            run("torch.fft.fft dim=-2 " + "x".join(map(str, shape)), x, want,
                {"torch.fft": lambda: torch.fft.fft(x, dim=-2)}, r"\w+")
        del x, re_, im_, out, want
    for rows, n in GEN_SHAPES if ("gen_fft", "kernel") in VARIANTS else ():
        x = torch.complex(torch.randn(rows, n, device=dev, generator=gen),
                          torch.randn(rows, n, device=dev, generator=gen))
        re_, im_ = x.real.contiguous(), x.imag.contiguous()
        out = (torch.empty_like(re_), torch.empty_like(im_))
        plan = cuda_fft._mixed_radix_plan(n)
        radix = cuda_fft._radix_arg(plan)
        tw = cuda_fft._twiddle_table(n, -1, dev)

        def gen_call(name, f):
            def call():
                err = f(re_.data_ptr(), im_.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                        tw.data_ptr(), rows, n, ctypes.cast(radix, P), len(plan), -1, 1.0,
                        stream)
                if err:
                    raise RuntimeError(f"gen_fft variant {name!r}: CUDA error {err}")
                return torch.complex(*out)
            return call

        want = torch.fft.fft(x.to(torch.complex128))
        run(f"gen_fft {rows}x{n}", x, want,
            {name: gen_call(name, f) for (lb, name), f in fns.items() if lb == "gen_fft"},
            "gen_fft_kernel")
        run(f"torch.fft.fft {rows}x{n}", x, want, {"torch.fft": lambda: torch.fft.fft(x)},
            r"\w+")
        if (rows, n) == (1024, 4095):  # B14's shape: torch.fft.rfft of the real rows
            xr = re_.clone()
            run(f"torch.fft.rfft {rows}x{n}", xr, torch.fft.rfft(xr.double()),
                {"torch.fft": lambda: torch.fft.rfft(xr)}, r"\w+")
        del x, re_, im_, out, want
    line = json.dumps(result)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

// The quad scheme of a k3/s2/p1 transposed convolution to 16 channels on
// the bf16 tensor cores, shared by K2-bf16's deconv1 (dec_aff_tail_bf16.cu)
// and K5-bf16's dP0 pass (dep_encode_front_bwd.cu):
//
//   y[m][2i + dy][2j + dx] = sum_c sum_shift W[c][m][tap(shift, phase)] a[c][i + sy][j + sx]
//
// One axis of the transposed conv is y[2j] = W[1] a[j], y[2j + 1] = W[2] a[j]
// + W[0] a[j + 1], so a base pixel (i, j) and its right and lower
// neighbours (the four shifts (sy, sx)) give the 2 x 2 quad of outputs
// (the four phases (dy, dx)) through all nine taps once:
//
//   phase (0, 0): tap 4 of shift (0, 0)
//   phase (0, 1): tap 5 of (0, 0), tap 3 of (0, 1)
//   phase (1, 0): tap 7 of (0, 0), tap 1 of (1, 0)
//   phase (1, 1): tap 8 of (0, 0), tap 6 of (0, 1), tap 2 of (1, 0), tap 0 of (1, 1)
//
// (tap = 3 ty + tx of W[c][m][ty][tx]; the TPU kernels' four shifted
// matmuls, _shift_matmul_sum and _sunshift_matmul_sum, in the same order.)
// As a GEMM: M = base pixels, the reduction over (shift, channel), N = 64 =
// four phases x 16 m. A shift feeds only some phases, so a k-step of 16
// channels issues four products of N = 64, 32, 32 and 16 (144 columns, the
// nine taps; none of the 112 structural zeros of a 4 x 64 product) into
// one accumulator of 64 columns in phase blocks [(0, 1), (1, 1), (1, 0),
// (0, 0)] of 16 m each: shift (0, 0) writes all four blocks, (0, 1) the
// first two, (1, 0) the middle two, (1, 1) the second. In the
// accumulator's fragment (wgmma_bf16.cuh) columns 16 q .. 16 q + 15 are
// registers 8 q .. 8 q + 7, so each product's block range is a contiguous
// run of the thread's 32 accumulators.
//
// B of a k-step: the 144 columns (nine taps x 16 m, tap blocks in qtap's
// order) of 16 channels as K-major core matrices without swizzle: column n,
// channel k at (n / 8) 128 + (k / 8) 64 + (n % 8) 8 + k % 8 bf16, so that
// each product's B is the same layout from its first column on. prep_kernel
// lays W out so, rounded to bf16, once a call.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma_bf16.cuh"

namespace quad {

constexpr int M = 16;               // the transposed conv's output channels
constexpr int KSTEP = 16;           // channels a k-step
constexpr int NCOL = 9 * M;         // 144 B columns a k-step
constexpr int KSTEP_BF16 = NCOL * KSTEP;   // 2304 bf16 of B a k-step
// tap of 16-column block blk of B: shift (0, 0)'s four phases (taps 5, 8,
// 7, 4), (0, 1)'s two (3, 6), (1, 0)'s two (2, 1), (1, 1)'s one (0)
__host__ __device__ constexpr int qtap(int blk) {
  return blk < 4 ? (blk == 0 ? 5 : blk == 1 ? 8 : blk == 2 ? 7 : 4)
                 : blk == 4 ? 3 : blk == 5 ? 6 : blk == 6 ? 2 : blk == 7 ? 1 : 0;
}
static_assert(qtap(0) == 5 && qtap(3) == 4 && qtap(5) == 6 && qtap(8) == 0, "tap blocks");

// The bf16 offset of column n, channel k of a k-step's B.
__host__ __device__ constexpr int kmajor(int n, int k) {
  return (n >> 3) * 128 + (k >> 3) * 64 + (n & 7) * 8 + (k & 7);
}
// phase (dy, dx) of each 16-column block of the accumulator
__host__ __device__ constexpr int phase_dy(int q) { return q == 1 || q == 2; }
__host__ __device__ constexpr int phase_dx(int q) { return q <= 1; }

// wp[kstep][...] = W (C, 16, 3, 3) rounded to bf16 as B of each k-step
// (above), zero past C; ksteps x KSTEP_BF16 bf16.
__global__ void __launch_bounds__(256)
prep_kernel(const float* __restrict__ w, __nv_bfloat16* __restrict__ wp, int C, int ksteps) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= ksteps * KSTEP_BF16) return;
  const int ks = i / KSTEP_BF16, r = i - ks * KSTEP_BF16;
  const int n = r / KSTEP, k = r % KSTEP;
  const int c = ks * KSTEP + k, m = n % M, tap = qtap(n / M);
  wp[(long)ks * KSTEP_BF16 + kmajor(n, k)] =
      __float2bfloat16_rn(c < C ? __ldg(w + ((long)c * M + m) * 9 + tap) : 0.0f);
}

inline void prep(const float* w, __nv_bfloat16* wp, int C, int ksteps, cudaStream_t s) {
  prep_kernel<<<(ksteps * KSTEP_BF16 + 255) / 256, 256, 0, s>>>(w, wp, C, ksteps);
}


// acc (this warp's 16 rows x 64 columns, phase blocks as above) += the
// four shifted products of one k-step: a[s] is shift s's A fragment
// (shifts (0, 0), (0, 1), (1, 0), (1, 1)), wk the k-step's B in shared
// memory. The caller fences before and commits after.
__device__ __forceinline__ void mma_kstep(float (&acc)[32], const uint32_t (&a)[4][4],
                                          const unsigned short* wk) {
  wgmma_bf16<64>(acc, a[0], kmajor_desc_b16(wk, 128, 256));
  wgmma_bf16<32>(*reinterpret_cast<float(*)[16]>(acc), a[1],
                 kmajor_desc_b16(wk + 64 * KSTEP, 128, 256));
  wgmma_bf16<32>(*reinterpret_cast<float(*)[16]>(acc + 8), a[2],
                 kmajor_desc_b16(wk + 96 * KSTEP, 128, 256));
  wgmma_bf16<16>(*reinterpret_cast<float(*)[8]>(acc + 8), a[3],
                 kmajor_desc_b16(wk + 128 * KSTEP, 128, 256));
}

}  // namespace quad

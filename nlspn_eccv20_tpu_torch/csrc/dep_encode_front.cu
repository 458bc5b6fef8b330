// The encode_dep front: relu(conv1(relu(conv0(x)))), both Conv2d k3/s2/p1,
// with conv0's 16-channel output kept on chip.
//
// Replaces the TPU kernel dep_encode_front._fwd_kernel
// (nlspn_eccv20_tpu/ops/pallas/dep_encode_front.py, reached from
// _fwd_pallas; _recompute_fwd is the same forward inside its backward).
//
//   x   (B, H, W) f32 plane                 the loop's depth / max_depth
//   w0  (16, 1, 3, 3), b0 (16)              torch Conv2d layout
//   w1  (C1, 16, 3, 3), b1 (C1)             C1 = 2 * GRU_input_dim (256)
//   out (B, Ho, Wo, C1) f32, NHWC           H1 = ceil(H/2), Ho = ceil(H1/2)
//
// Any H and W: out-of-range taps read the convs' zero padding.
//
// Bound on the card: operations. At NYU size (256 x 320 -> 64 x 80 x 256)
// conv1 is 0.38 GFLOP against 0.3 MB read and 5.2 MB written. Design: one
// block per TOH x TOW output tile and group of CG output channels. The
// block first computes the tile's conv0 patch (16 channels, with the
// one-pixel halo conv1 needs) from the plane into shared memory, zero where
// conv1's padding lies, while the group's conv1 weights are staged in
// shared memory transposed to [tap][channel] (pitch 65, no bank conflicts).
// Each thread then owns one output channel and one row of TOW output
// pixels: per tap one weight word and TOW intermediate words, which every
// thread of a warp reads at the same address (a broadcast). Stores are
// coalesced along the channel axis of the NHWC output. The TPU kernel's
// 16-phase de-interleave, one-hot decimation matmuls and H % 4 == W % 4 == 0
// restriction are Mosaic devices and are not carried over. Plain f32 FMAs:
// no tensor cores.

#include <cuda_runtime.h>

namespace {

constexpr int M = 16;            // conv0 output channels
constexpr int TOH = 4;           // output tile rows
constexpr int TOW = 8;           // output tile cols
constexpr int CG = 64;           // output channels per block
constexpr int NT = CG * TOH;     // one thread per (channel, output row)
constexpr int YR = 2 * TOH + 1;  // conv0 patch rows (with conv1's halo)
constexpr int YC = 2 * TOW + 1;
constexpr int PITCH = CG + 1;

__global__ void __launch_bounds__(NT)
dep_encode_front_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                        const float* __restrict__ b0, const float* __restrict__ w1,
                        const float* __restrict__ b1, float* __restrict__ out,
                        int H, int W, int C1, int n_groups) {
  __shared__ float w1s[M * 9 * PITCH];  // [m * 9 + tap][channel]
  __shared__ float y1s[M][YR][YC];
  __shared__ float w0s[M * 9];
  __shared__ float b0s[M];

  const int tid = threadIdx.x;
  const int b = blockIdx.z / n_groups;
  const int co0 = (blockIdx.z % n_groups) * CG;
  const int oy0 = blockIdx.y * TOH, ox0 = blockIdx.x * TOW;
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  const int Ho = (H1 + 1) / 2, Wo = (W1 + 1) / 2;

  for (int i = tid; i < CG * M * 9; i += NT) {
    const int cl = i / (M * 9), s = i % (M * 9);
    w1s[s * PITCH + cl] = co0 + cl < C1 ? __ldg(w1 + (long)co0 * M * 9 + i) : 0.0f;
  }
  for (int i = tid; i < M * 9; i += NT) w0s[i] = __ldg(w0 + i);
  if (tid < M) b0s[tid] = __ldg(b0 + tid);
  __syncthreads();

  // ---- conv0 patch: conv0 output rows 2*oy0-1 .. 2*oy0+2*TOH-1 ----
  const float* xb = x + (long)b * H * W;
  for (int i = tid; i < M * YR * YC; i += NT) {
    const int c = i % YC, r = (i / YC) % YR, m = i / (YC * YR);
    const int Y1 = 2 * oy0 - 1 + r, X1 = 2 * ox0 - 1 + c;
    float v = 0.0f;
    if (Y1 >= 0 && Y1 < H1 && X1 >= 0 && X1 < W1) {
      float s = b0s[m];
#pragma unroll
      for (int ty = 0; ty < 3; ++ty) {
        const int yy = 2 * Y1 - 1 + ty;
        if (yy < 0 || yy >= H) continue;
#pragma unroll
        for (int tx = 0; tx < 3; ++tx) {
          const int xx = 2 * X1 - 1 + tx;
          if (xx < 0 || xx >= W) continue;
          s = fmaf(w0s[m * 9 + ty * 3 + tx], __ldg(xb + (long)yy * W + xx), s);
        }
      }
      v = fmaxf(s, 0.0f);
    }
    y1s[m][r][c] = v;
  }
  __syncthreads();

  // ---- conv1: thread = (channel cl, output row) ----
  const int cl = tid % CG, row = tid / CG;
  const int co = co0 + cl;
  float acc[TOW];
  const float bias = co < C1 ? __ldg(b1 + co) : 0.0f;
#pragma unroll
  for (int j = 0; j < TOW; ++j) acc[j] = bias;
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int ty = 0; ty < 3; ++ty) {
      const float* yrow = &y1s[m][2 * row + ty][0];
#pragma unroll
      for (int tx = 0; tx < 3; ++tx) {
        const float w = w1s[(m * 9 + ty * 3 + tx) * PITCH + cl];
#pragma unroll
        for (int j = 0; j < TOW; ++j) acc[j] = fmaf(w, yrow[2 * j + tx], acc[j]);
      }
    }
  }
  const int oy = oy0 + row;
  if (co >= C1 || oy >= Ho) return;
  float* orow = out + ((long)b * Ho + oy) * Wo * C1;
#pragma unroll
  for (int j = 0; j < TOW; ++j) {
    const int ox = ox0 + j;
    if (ox < Wo) orow[(long)ox * C1 + co] = fmaxf(acc[j], 0.0f);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int dep_encode_front_f32(const float* x, const float* w0,
                                    const float* b0, const float* w1,
                                    const float* b1, float* out, int B, int H,
                                    int W, int C1, void* stream) {
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  const int Ho = (H1 + 1) / 2, Wo = (W1 + 1) / 2;
  const int n_groups = (C1 + CG - 1) / CG;
  const dim3 grid((Wo + TOW - 1) / TOW, (Ho + TOH - 1) / TOH, B * n_groups);
  dep_encode_front_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      x, w0, b0, w1, b1, out, H, W, C1, n_groups);
  return (int)cudaGetLastError();
}

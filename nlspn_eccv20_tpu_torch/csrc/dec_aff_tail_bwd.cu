// Backward of the decode_aff tail (K4): the gradients of
//
//   y1  = relu(deconv1(x) + b1)      x  (B, Hg, Wg, C) NHWC, w1 (C, 16, 3, 3)
//   out = deconv2(y1) + b2           y1 (B, 16, H1, W1),     w2 (16, K, 3, 3)
//
// (both ConvTranspose2d k3/s2/p1/op1, torch layout; H1 = 2Hg, out is
// (B, K, 2H1, 2W1) planar) given g = dL/d(out):
//
//   dY1 = [y1 > 0] * conv(g, w2)          a k3/s2/p1 conv, K -> 16 channels
//   dx  = conv(dY1, w1)                   a k3/s2/p1 conv, 16 -> C, NHWC
//   dW1[c][m][t] = sum x[i][j][c] dY1[m][2i-1+ty][2j-1+tx],   db1 = sum dY1
//   dW2[m][k][t] = sum y1[m][r][s] g[k][2r-1+ty][2s-1+tx],     db2 = sum g
//
// Replaces the TPU kernels dec_aff_tail._deint_kernel and _bwd_kernel
// (nlspn_eccv20_tpu/ops/pallas/dec_aff_tail.py, reached from _bwd_pallas).
// The TPU kernel recomputes y1 per tile; this one reads the y1 that the
// forward kernel wrote (dec_aff_tail.cu, y1 output), which saves deconv1's
// 4 GFLOP at NYU b=12 for 13 MB of device memory per call.
//
// Bound on the card: operations. At NYU b=12 (base grid 58x76, C = 256,
// K = 8) dx and dW1 are 3.9 GFLOP each and dY1 and dW2 0.5 each, against
// about 120 MB of tensors. Four kernels, one launch sequence:
//   1. dy1_kernel: per 8x8 tile of y1 positions, dY1 (written to scratch)
//      and the tile's partial sums of dW2, db1 and db2; g's tile lives in
//      shared memory, 8 of its channels at a time.
//   2. dx_kernel: the k3/s2 conv of dY1 to C channels, laid out as the
//      forward's encode_dep conv1 (dep_encode_front.cu): per block a 4x8
//      tile of base pixels and 64 channels; dY1's patch and the channels'
//      weights in shared memory, each thread one channel and 8 pixels.
//   3. bwd::wgrad_s2 (bwd_common.cuh): dW1 as 64 slice partials.
//   4. bwd::reduce_partials: the partials of 1 and 3 added in a fixed order.
// The weight gradients are summed without atomics, so the result is the
// same bits from run to run, as the TPU kernel's sequential grid gives.
// Plain f32 FMAs: no tensor cores.

#include <cuda_runtime.h>

#include "bwd_common.cuh"

namespace {

constexpr int M = bwd::M;

// ---- 1. dY1, and partial dW2 / db1 / db2 ----
constexpr int YT = 8;            // y1 tile rows and cols
constexpr int NP_TILE = YT * YT; // positions per tile
constexpr int GT = 2 * YT + 1;   // g tile rows and cols
constexpr int KC = 8;            // g channels staged at a time
constexpr int NT_A = 256;        // (position, group of 4 m)

template <int K>
__global__ void __launch_bounds__(NT_A)
dy1_kernel(const float* __restrict__ g, const float* __restrict__ y1,
           const float* __restrict__ w2, float* __restrict__ dy1,
           float* __restrict__ part, int H1, int W1) {
  static_assert(K % KC == 0, "K in chunks of KC");
  __shared__ float gs[KC][GT][GT];
  __shared__ float ys[M][NP_TILE + 1];
  __shared__ float ds[M][NP_TILE + 1];
  __shared__ __align__(16) float w2s[K * 9 * M];  // [k][tap][m]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int R0 = blockIdx.y * YT, C0 = blockIdx.x * YT;
  const int Ho = 2 * H1, Wo = 2 * W1;
  constexpr int NP = M * K * 9 + M + K;
  float* pb = part + (long)((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * NP;

  for (int i = tid; i < M * K * 9; i += NT_A) {  // w2 is (M, K, 3, 3)
    const int m = i / (K * 9), k = (i / 9) % K, tap = i % 9;
    w2s[(k * 9 + tap) * M + m] = __ldg(w2 + i);
  }
  for (int i = tid; i < M * NP_TILE; i += NT_A) {
    const int p = i % NP_TILE, m = i / NP_TILE;
    const int r = R0 + p / YT, c = C0 + p % YT;
    ys[m][p] = (r < H1 && c < W1) ? __ldg(y1 + (((long)b * M + m) * H1 + r) * W1 + c) : 0.0f;
  }

  const int p = tid % NP_TILE, mg = tid / NP_TILE;
  const int rl = p / YT, cl = p % YT;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int kc = 0; kc < K; kc += KC) {
    __syncthreads();
    for (int i = tid; i < KC * GT * GT; i += NT_A) {
      const int gx = i % GT, gy = (i / GT) % GT, kk = i / (GT * GT);
      const int oy = 2 * R0 - 1 + gy, ox = 2 * C0 - 1 + gx;
      gs[kk][gy][gx] = (oy >= 0 && oy < Ho && ox >= 0 && ox < Wo)
          ? __ldg(g + (((long)b * K + kc + kk) * Ho + oy) * Wo + ox) : 0.0f;
    }
    __syncthreads();
    // dy1 at (rl, cl) for m = 4 mg .. 4 mg + 3
#pragma unroll 2
    for (int kk = 0; kk < KC; ++kk)
#pragma unroll
      for (int ty = 0; ty < 3; ++ty)
#pragma unroll
        for (int tx = 0; tx < 3; ++tx) {
          const float gv = gs[kk][2 * rl + ty][2 * cl + tx];
          const float4 w = reinterpret_cast<const float4*>(
              w2s + ((kc + kk) * 9 + ty * 3 + tx) * M)[mg];
          acc[0] = fmaf(w.x, gv, acc[0]);
          acc[1] = fmaf(w.y, gv, acc[1]);
          acc[2] = fmaf(w.z, gv, acc[2]);
          acc[3] = fmaf(w.w, gv, acc[3]);
        }
    if (tid < M * KC) {  // dW2 for (m, kc + kk) over the tile's positions
      const int m = tid / KC, kk = tid % KC;
      float a[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) a[t] = 0.0f;
      for (int q = 0; q < NP_TILE; ++q) {
        const float yv = ys[m][q];
        const int r2 = q / YT, c2 = q % YT;
#pragma unroll
        for (int ty = 0; ty < 3; ++ty)
#pragma unroll
          for (int tx = 0; tx < 3; ++tx)
            a[ty * 3 + tx] = fmaf(yv, gs[kk][2 * r2 + ty][2 * c2 + tx], a[ty * 3 + tx]);
      }
#pragma unroll
      for (int t = 0; t < 9; ++t) pb[(m * K + kc + kk) * 9 + t] = a[t];
    } else if (tid < M * KC + KC) {  // db2 over the g rows this tile owns
      const int kk = tid - M * KC;
      float s = 0.0f;
      for (int gy = 1; gy < GT; ++gy)
        for (int gx = 1; gx < GT; ++gx) s += gs[kk][gy][gx];
      pb[M * K * 9 + M + kc + kk] = s;
    }
  }

  // dY1 = [y1 > 0] dy1
  const int r = R0 + rl, c = C0 + cl;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = 4 * mg + j;
    const float d = ys[m][p] > 0.0f ? acc[j] : 0.0f;
    ds[m][p] = d;
    if (r < H1 && c < W1) dy1[(((long)b * M + m) * H1 + r) * W1 + c] = d;
  }
  __syncthreads();
  if (tid < M) {
    float s = 0.0f;
    for (int q = 0; q < NP_TILE; ++q) s += ds[tid][q];
    pb[M * K * 9 + tid] = s;
  }
}

// ---- 2. dx = conv(dY1, w1), k3/s2/p1, 16 -> C, NHWC out ----
constexpr int TOH = 4;           // output tile rows
constexpr int TOW = 8;           // output tile cols
constexpr int CG = 64;           // output channels per block
constexpr int NT_B = CG * TOH;   // one thread per (channel, output row)
constexpr int DR = 2 * TOH + 1;  // dY1 patch rows / cols
constexpr int DC = 2 * TOW + 1;
constexpr int PITCH = CG + 1;

__global__ void __launch_bounds__(NT_B)
dx_kernel(const float* __restrict__ dy1, const float* __restrict__ w1,
          float* __restrict__ dx, int Hg, int Wg, int C, int H1, int W1,
          int n_groups) {
  __shared__ float w1s[M * 9 * PITCH];  // [m * 9 + tap][channel]
  __shared__ float ds[M][DR][DC];

  const int tid = threadIdx.x;
  const int b = blockIdx.z / n_groups;
  const int co0 = (blockIdx.z % n_groups) * CG;
  const int oy0 = blockIdx.y * TOH, ox0 = blockIdx.x * TOW;

  for (int i = tid; i < CG * M * 9; i += NT_B) {  // w1 is (C, M, 3, 3)
    const int cl = i / (M * 9), s = i % (M * 9);
    w1s[s * PITCH + cl] = co0 + cl < C ? __ldg(w1 + (long)co0 * M * 9 + i) : 0.0f;
  }
  for (int i = tid; i < M * DR * DC; i += NT_B) {
    const int c = i % DC, r = (i / DC) % DR, m = i / (DC * DR);
    const int Y = 2 * oy0 - 1 + r, X = 2 * ox0 - 1 + c;
    ds[m][r][c] = (Y >= 0 && Y < H1 && X >= 0 && X < W1)
        ? __ldg(dy1 + (((long)b * M + m) * H1 + Y) * W1 + X) : 0.0f;
  }
  __syncthreads();

  const int cl = tid % CG, row = tid / CG;
  const int co = co0 + cl;
  float acc[TOW];
#pragma unroll
  for (int j = 0; j < TOW; ++j) acc[j] = 0.0f;
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int ty = 0; ty < 3; ++ty) {
      const float* drow = &ds[m][2 * row + ty][0];
#pragma unroll
      for (int tx = 0; tx < 3; ++tx) {
        const float w = w1s[(m * 9 + ty * 3 + tx) * PITCH + cl];
#pragma unroll
        for (int j = 0; j < TOW; ++j) acc[j] = fmaf(w, drow[2 * j + tx], acc[j]);
      }
    }
  }
  const int oy = oy0 + row;
  if (co >= C || oy >= Hg) return;
  float* orow = dx + ((long)b * Hg + oy) * Wg * C;
#pragma unroll
  for (int j = 0; j < TOW; ++j) {
    const int ox = ox0 + j;
    if (ox < Wg) orow[(long)ox * C + co] = acc[j];
  }
}

struct Layout {  // the scratch buffer, in floats
  long dy1, part_a, part_w, tmp, total;
  int blocks_a, np;
};

Layout layout(int B, int Hg, int Wg, int C, int K) {
  Layout l;
  const int H1 = 2 * Hg, W1 = 2 * Wg;
  l.np = M * K * 9 + M + K;
  l.blocks_a = ((W1 + YT - 1) / YT) * ((H1 + YT - 1) / YT) * B;
  l.dy1 = 0;
  l.part_a = l.dy1 + (long)B * M * H1 * W1;
  l.part_w = l.part_a + (long)l.blocks_a * l.np;
  l.tmp = l.part_w + bwd::wgrad_s2_partial_floats(C, 0);
  const long t1 = bwd::reduce_scratch_floats(l.blocks_a, l.np);
  const long t2 = bwd::reduce_scratch_floats(bwd::WG_SLICES, C * M * 9);
  l.total = l.tmp + (t1 > t2 ? t1 : t2);
  return l;
}

}  // namespace

// Floats of scratch dec_aff_tail_bwd_f32 needs.
extern "C" long long dec_aff_tail_bwd_scratch_floats(int B, int Hg, int Wg,
                                                     int C, int K) {
  return layout(B, Hg, Wg, C, K).total;
}

// x (B, Hg, Wg, C) NHWC; y1 (B, 16, 2Hg, 2Wg), the forward's intermediate;
// g (B, K, 4Hg, 4Wg); w1 (C, 16, 3, 3); w2 (16, K, 3, 3). Writes dx (as x),
// dw1 (as w1) and dw2b = [dW2 (16 K 9) | db1 (16) | db2 (K)]. K must be 8 or
// 24. Returns cudaGetLastError() after the last launch.
extern "C" int dec_aff_tail_bwd_f32(const float* x, const float* y1,
                                    const float* g, const float* w1,
                                    const float* w2, float* dx, float* dw1,
                                    float* dw2b, float* scratch, int B, int Hg,
                                    int Wg, int C, int K, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Layout l = layout(B, Hg, Wg, C, K);
  const int H1 = 2 * Hg, W1 = 2 * Wg;
  float* dy1 = scratch + l.dy1;
  const dim3 grid_a((W1 + YT - 1) / YT, (H1 + YT - 1) / YT, B);
  if (K == 8) {
    dy1_kernel<8><<<grid_a, NT_A, 0, s>>>(g, y1, w2, dy1, scratch + l.part_a, H1, W1);
  } else if (K == 24) {
    dy1_kernel<24><<<grid_a, NT_A, 0, s>>>(g, y1, w2, dy1, scratch + l.part_a, H1, W1);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const int n_groups = (C + CG - 1) / CG;
  const dim3 grid_b((Wg + TOW - 1) / TOW, (Hg + TOH - 1) / TOH, B * n_groups);
  dx_kernel<<<grid_b, NT_B, 0, s>>>(dy1, w1, dx, Hg, Wg, C, H1, W1, n_groups);
  bwd::wgrad_s2(x, nullptr, dy1, scratch + l.part_w, B, Hg, Wg, C, H1, W1, 0, s);
  bwd::reduce_partials(scratch + l.part_a, l.blocks_a, l.np, dw2b, scratch + l.tmp, s);
  bwd::reduce_partials(scratch + l.part_w, bwd::WG_SLICES, C * M * 9, dw1,
                       scratch + l.tmp, s);
  return (int)cudaGetLastError();
}

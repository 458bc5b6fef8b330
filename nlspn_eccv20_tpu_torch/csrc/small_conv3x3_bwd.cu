// K9b: the backward of K9 (small_conv3x3.cu). Given g = dL/d(out)
// (B, K, H, W):
//
//   dx_c[y][x]       = sum_k sum_{ty,tx} w[k][c][ty][tx] g_k[y-ty+1][x-tx+1]
//   dW[k][c][ty][tx] = sum_{b,y,x} g_k[y][x] x_c[y+ty-1][x+tx-1]
//   db[k]            = sum_{b,y,x} g_k[y][x]
//
// with g and x zero outside the image: dx gathers g over each input pixel's
// 3x3 neighbourhood with the taps mirrored. dx is split into dxa (the first
// Ca channels) and dxb, as the inputs were.
//
// Replaces the TPU kernel small_conv3x3._bwd_kernel
// (nlspn_eccv20_tpu/ops/pallas/small_conv3x3.py, reached from _bwd_pallas).
//
// Bound on the card: operations. At NYU b=12 (228x304, C = 256, K = 10) dx
// and dW are 38.3 GFLOP each, 1.14 ms of f32 FMAs, against 1.74 GB (0.52 ms
// of HBM). Three launches (four when the partials need two passes):
//   1. dx_kernel: per 8x64 tile of one image and group of 16 input channels.
//      g streams through shared memory 4 planes at a time with its
//      one-pixel halo, the weights staged [k][tap][c], by asynchronous
//      copies into two buffers (cp_async.cuh); each of 128 threads owns 4
//      neighbouring pixels of a row and 16 channels (64 sums): per plane 18
//      g words and 36 broadcast float4s for 576 FMAs.
//   2. wgrad_kernel: block = (group of 32 input channels, slice s of the
//      units; a unit is 4 rows x 32 cols of one image). Per unit the block
//      stages the 32 channels' tile with its halo (a channel's stride odd,
//      so 32 channels fall in 32 banks) and g as [pixel][k], all copies of a
//      unit in flight at once (cp_async.cuh). A thread owns
//      one channel and a quad of k (36 sums) and slides a 3x3 register
//      window along each row: 3 x words and one broadcast float4 of g for
//      36 FMAs. Each block writes its sums to part[s] = [dW (K, C, 9) |
//      db (K)]; db comes from the first channel group's blocks.
//   3. bwd::reduce_partials (bwd_common.cuh): the slices added in a fixed
//      order.
// No atomics: the result is the same bits from run to run, as the TPU
// kernel's sequential grid gives. Plain f32 FMAs: no tensor cores.

#include <cuda_runtime.h>

#include "bwd_common.cuh"
#include "cp_async.cuh"

namespace {

// ---- 1. dx ----
constexpr int TH = 8;               // tile rows
constexpr int TW = 64;              // tile cols
constexpr int P = 4;                // pixels per thread, along a row
constexpr int NT = TH * TW / P;     // 128 threads
constexpr int DG = 16;              // input channels per block
constexpr int KC = 4;               // g planes per shared-memory chunk
constexpr int XR = TH + 2;
constexpr int XC = TW + 2;

__global__ void __launch_bounds__(NT)
dx_kernel(const float* __restrict__ g, const float* __restrict__ w,
          float* __restrict__ dxa, float* __restrict__ dxb, int H, int W,
          int Ca, int Cb, int K, int n_groups) {
  __shared__ float gs[2][KC][XR][XC];
  __shared__ __align__(16) float ws[2][KC * 9 * DG];  // [k][tap][c]

  const int tid = threadIdx.x;
  const int b = blockIdx.z / n_groups, c0 = (blockIdx.z % n_groups) * DG;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int C = Ca + Cb;
  const int r = tid / (TW / P), j = tid % (TW / P);

  float acc[P][DG];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int c = 0; c < DG; ++c) acc[p][c] = 0.0f;

  // issues the copies of planes k0 .. k0 + KC - 1 into buffer buf
  auto stage = [&](int k0, int buf) {
    for (int i = tid; i < KC * XR * XC; i += NT) {
      const int col = i % XC, row = (i / XC) % XR, kk = i / (XR * XC);
      const int y = y0 - 1 + row, x = x0 - 1 + col;
      const bool ok = k0 + kk < K && y >= 0 && y < H && x >= 0 && x < W;
      cpa::copy4(&gs[buf][kk][row][col],
                 ok ? g + (((long)b * K + k0 + kk) * H + y) * W + x : g, ok);
    }
    for (int i = tid; i < KC * 9 * DG; i += NT) {
      const int c = c0 + i % DG, tap = (i / DG) % 9, k = k0 + i / (9 * DG);
      const bool ok = k < K && c < C;
      cpa::copy4(&ws[buf][i], ok ? w + ((long)k * C + c) * 9 + tap : w, ok);
    }
    cpa::commit();
  };

  int buf = 0;
  stage(0, 0);
  for (int k0 = 0; k0 < K; k0 += KC, buf ^= 1) {
    const int kc = min(KC, K - k0);
    if (k0 + KC < K) {
      stage(k0 + KC, buf ^ 1);
      cpa::wait<1>();
    } else {
      cpa::wait<0>();
    }
    __syncthreads();
#pragma unroll 1
    for (int kk = 0; kk < kc; ++kk) {
      // gv[i][l] = g at (row y0 + r - 1 + i, col x0 + P j - 1 + l)
      float gv[3][P + 2];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int l = 0; l < P + 2; ++l) gv[i][l] = gs[buf][kk][r + i][P * j + l];
      const float4* wk = reinterpret_cast<const float4*>(ws[buf] + kk * 9 * DG);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ty = tap / 3, tx = tap % 3;
#pragma unroll
        for (int q = 0; q < DG / 4; ++q) {
          const float4 wv = wk[tap * (DG / 4) + q];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const float gval = gv[2 - ty][p + 2 - tx];  // g[y + 1 - ty][x + 1 - tx]
            acc[p][4 * q + 0] = fmaf(wv.x, gval, acc[p][4 * q + 0]);
            acc[p][4 * q + 1] = fmaf(wv.y, gval, acc[p][4 * q + 1]);
            acc[p][4 * q + 2] = fmaf(wv.z, gval, acc[p][4 * q + 2]);
            acc[p][4 * q + 3] = fmaf(wv.w, gval, acc[p][4 * q + 3]);
          }
        }
      }
    }
    __syncthreads();  // the buffer is staged again two chunks on
  }

  const int y = y0 + r;
  if (y >= H) return;
#pragma unroll
  for (int cl = 0; cl < DG; ++cl) {
    const int c = c0 + cl;
    if (c >= C) break;
    float* row = c < Ca ? dxa + (((long)b * Ca + c) * H + y) * W
                        : dxb + (((long)b * Cb + (c - Ca)) * H + y) * W;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int x = x0 + P * j + p;
      if (x < W) row[x] = acc[p][cl];
    }
  }
}

// ---- 2. dW and db as per-slice partial sums ----
constexpr int WC = 32;              // input channels per block
constexpr int RH = 4;               // unit rows
constexpr int SEG = 32;             // unit cols
constexpr int SLICES = 128;         // partial sums per weight
constexpr int UR = RH + 2;          // staged rows / cols of a channel
constexpr int UC = SEG + 2;
constexpr int XSTRIDE = UR * UC + 1;  // 205: odd

template <int KB>
__global__ void __launch_bounds__(WC * KB / 4)
wgrad_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
             const float* __restrict__ g, float* __restrict__ part, int B,
             int H, int W, int Ca, int Cb, int K) {
  constexpr int NTW = WC * KB / 4;
  __shared__ float xs[WC * XSTRIDE];
  __shared__ __align__(16) float gs[RH * SEG * KB];  // [pixel][k]

  const int tid = threadIdx.x;
  const int cl = tid % WC, kq = tid / WC;
  const int c0 = blockIdx.x * WC, s = blockIdx.y;
  const int C = Ca + Cb;
  const long plane = (long)H * W;
  const int nseg = (W + SEG - 1) / SEG, nrow = (H + RH - 1) / RH;
  const long units = (long)B * nrow * nseg;
  const bool with_db = blockIdx.x == 0;

  float acc[4][9];
  float gsum[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    gsum[q] = 0.0f;
#pragma unroll
    for (int t = 0; t < 9; ++t) acc[q][t] = 0.0f;
  }

  for (long u = s; u < units; u += gridDim.y) {
    const int seg = (int)(u % nseg);
    const int y0 = (int)((u / nseg) % nrow) * RH, x0 = seg * SEG;
    const int b = (int)(u / ((long)nseg * nrow));
    __syncthreads();
    for (int i = tid; i < WC * UR * UC; i += NTW) {
      const int col = i % UC, row = (i / UC) % UR, cc = i / (UR * UC);
      const int c = c0 + cc, y = y0 - 1 + row, x = x0 - 1 + col;
      const bool ok = c < C && y >= 0 && y < H && x >= 0 && x < W;
      const float* src = xa;
      if (ok)
        src = (c < Ca ? xa + ((long)b * Ca + c) * plane
                      : xb + ((long)b * Cb + (c - Ca)) * plane) + (long)y * W + x;
      cpa::copy4(&xs[cc * XSTRIDE + row * UC + col], src, ok);
    }
    for (int i = tid; i < RH * SEG * KB; i += NTW) {
      const int px = i % (RH * SEG), k = i / (RH * SEG);
      const int y = y0 + px / SEG, x = x0 + px % SEG;
      const bool ok = k < K && y < H && x < W;
      cpa::copy4(&gs[px * KB + k], ok ? g + (((long)b * K + k) * H + y) * W + x : g, ok);
    }
    cpa::commit();
    cpa::wait<0>();
    __syncthreads();
    const float* xc = xs + cl * XSTRIDE;
    const float4* g4 = reinterpret_cast<const float4*>(gs) + kq;
#pragma unroll 1
    for (int py = 0; py < RH; ++py) {
      float win[3][3];  // x_c at rows y-1..y+1, cols x-1..x+1 of pixel (y, x)
#pragma unroll
      for (int ty = 0; ty < 3; ++ty) {
        win[ty][0] = xc[(py + ty) * UC];
        win[ty][1] = xc[(py + ty) * UC + 1];
      }
#pragma unroll
      for (int px = 0; px < SEG; ++px) {
#pragma unroll
        for (int ty = 0; ty < 3; ++ty) win[ty][2] = xc[(py + ty) * UC + px + 2];
        const float4 gq = g4[(py * SEG + px) * (KB / 4)];
        const float gv[4] = {gq.x, gq.y, gq.z, gq.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int ty = 0; ty < 3; ++ty)
#pragma unroll
            for (int tx = 0; tx < 3; ++tx)
              acc[q][ty * 3 + tx] = fmaf(gv[q], win[ty][tx], acc[q][ty * 3 + tx]);
          if (with_db) gsum[q] += gv[q];
        }
#pragma unroll
        for (int ty = 0; ty < 3; ++ty) {
          win[ty][0] = win[ty][1];
          win[ty][1] = win[ty][2];
        }
      }
    }
  }

  float* out = part + (long)s * ((long)K * C * 9 + K);
  const int c = c0 + cl;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = 4 * kq + q;
    if (k >= K) break;
    if (c < C) {
#pragma unroll
      for (int t = 0; t < 9; ++t) out[((long)k * C + c) * 9 + t] = acc[q][t];
    }
    if (with_db && cl == 0) out[(long)K * C * 9 + k] = gsum[q];
  }
}

template <int KB>
void launch_wgrad(const float* xa, const float* xb, const float* g, float* part,
                  int B, int H, int W, int Ca, int Cb, int K, cudaStream_t s) {
  const dim3 grid((Ca + Cb + WC - 1) / WC, SLICES);
  wgrad_kernel<KB><<<grid, WC * KB / 4, 0, s>>>(xa, xb, g, part, B, H, W, Ca, Cb, K);
}

long partial_floats(int Ca, int Cb, int K) {
  return (long)SLICES * ((long)K * (Ca + Cb) * 9 + K);
}

}  // namespace

// Floats of scratch small_conv3x3_bwd_f32 needs.
extern "C" long long small_conv3x3_bwd_scratch_floats(int B, int H, int W, int Ca,
                                                      int Cb, int K) {
  (void)B;
  (void)H;
  (void)W;
  return partial_floats(Ca, Cb, K)
      + bwd::reduce_scratch_floats(SLICES, K * (Ca + Cb) * 9 + K);
}

// g (B, K, H, W); xa (B, Ca, H, W), xb (B, Cb, H, W); w (K, Ca + Cb, 3, 3).
// Writes dxa and dxb (as xa and xb) and dwb = [dW (K, Ca + Cb, 3, 3) |
// db (K)]. Returns cudaGetLastError() after the last launch
// (cudaErrorInvalidValue, with no launch, unless 1 <= K <= 32).
extern "C" int small_conv3x3_bwd_f32(const float* g, const float* xa,
                                     const float* xb, const float* w, float* dxa,
                                     float* dxb, float* dwb, float* scratch, int B,
                                     int H, int W, int Ca, int Cb, int K,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K < 1 || K > 32) return (int)cudaErrorInvalidValue;
  const int n_groups = (Ca + Cb + DG - 1) / DG;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * n_groups);
  dx_kernel<<<grid, NT, 0, s>>>(g, w, dxa, dxb, H, W, Ca, Cb, K, n_groups);
  float* part = scratch;
  switch ((K + 3) / 4) {
    case 1: launch_wgrad<4>(xa, xb, g, part, B, H, W, Ca, Cb, K, s); break;
    case 2: launch_wgrad<8>(xa, xb, g, part, B, H, W, Ca, Cb, K, s); break;
    case 3: launch_wgrad<12>(xa, xb, g, part, B, H, W, Ca, Cb, K, s); break;
    case 4: launch_wgrad<16>(xa, xb, g, part, B, H, W, Ca, Cb, K, s); break;
    case 5: launch_wgrad<20>(xa, xb, g, part, B, H, W, Ca, Cb, K, s); break;
    case 6: launch_wgrad<24>(xa, xb, g, part, B, H, W, Ca, Cb, K, s); break;
    case 7: launch_wgrad<28>(xa, xb, g, part, B, H, W, Ca, Cb, K, s); break;
    default: launch_wgrad<32>(xa, xb, g, part, B, H, W, Ca, Cb, K, s); break;
  }
  bwd::reduce_partials(part, SLICES, K * (Ca + Cb) * 9 + K, dwb,
                       scratch + partial_floats(Ca, Cb, K), s);
  return (int)cudaGetLastError();
}

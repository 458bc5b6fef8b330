// K9: conv3x3(concat(xa, xb)) + b, stride 1, zero padding 1, with few
// outputs, planar in and out.
//
// Replaces the TPU kernel small_conv3x3._fwd_kernel
// (nlspn_eccv20_tpu/ops/pallas/small_conv3x3.py, reached from _fwd_pallas).
//
//   xa  (B, Ca, H, W), xb (B, Cb, H, W) f32   the concat is never built
//   w   (K, Ca + Cb, 3, 3), b (K)             torch Conv2d layout, K <= 32
//   out (B, K, H, W) f32
//
//   out[k][y][x] = b[k] + sum_c sum_{ty,tx} w[k][c][ty][tx] x_c[y+ty-1][x+tx-1]
//
// a cross-correlation (taps not flipped), zero outside the image at all four
// edges (not the replicate padding of the propagation kernels). Any H and W.
//
// Bound on the card: operations. At NYU b=12 (228x304, C = 256, K = 10) it
// is 38.3 GFLOP against 0.89 GB: 572 us of f32 FMAs, 264 us of HBM. Design:
// a block owns an 8 x 64 tile of output pixels; each of its 128 threads owns
// 4 neighbouring pixels of one row and keeps their KB sums in registers (KB:
// K rounded up to a multiple of 4, a template argument, so that the loops
// unroll). Input channels stream through shared memory 4 at a time, each
// plane's tile with its one-pixel halo (zeros outside the image), read
// coalesced along W, the first Ca channels from xa and the rest from xb,
// by asynchronous copies into two buffers (cp_async.cuh): the next chunk's
// copies are in flight while the current one is summed. The chunk's weights
// are staged [c][tap][k], so that one broadcast float4 load feeds 16 FMAs; per channel a thread reads 18 input words and 9 KB / 4
// float4s for 36 KB FMAs. Output planes are written along W. A grid of
// fewer than TARGET_BLOCKS tiles (b=1 at 256x320 has 160) splits the
// channels over up to 8 blocks a tile, each writing its partial sums to a
// scratch buffer, and a second launch adds them in split order: the same
// bits from run to run. The TPU kernel's tap-major matmul, lane-selected
// fold and column-wrap mask are Mosaic devices and are not carried over.
// Plain f32 FMAs: no tensor cores.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int TH = 8;               // output tile rows
constexpr int TW = 64;              // output tile cols
constexpr int P = 4;                // pixels per thread, along a row
constexpr int NT = TH * TW / P;     // 128 threads
constexpr int CC = 4;               // input channels per shared-memory chunk
constexpr int XR = TH + 2;          // staged rows / cols (with the halo)
constexpr int XC = TW + 2;
constexpr int TARGET_BLOCKS = 4 * 132;  // four blocks on each of an H100's SMs
constexpr int MAX_SPLIT = 8;

// Channel splits of a tile: 1 unless the grid has fewer than TARGET_BLOCKS
// tiles; each split's channel count is a multiple of CC.
int n_split(int B, int H, int W, int C) {
  const long tiles = (long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  int n = (int)((TARGET_BLOCKS + tiles - 1) / tiles);
  n = n < MAX_SPLIT ? n : MAX_SPLIT;
  const int chunks = (C + CC - 1) / CC;
  n = n < chunks ? n : chunks;
  const int per = (chunks + n - 1) / n;  // chunks a split
  return (chunks + per - 1) / per;
}

template <int KB>
__global__ void __launch_bounds__(NT)
small_conv3x3_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
                     const float* __restrict__ w, const float* __restrict__ bias,
                     float* __restrict__ out, int H, int W, int Ca, int Cb, int K,
                     int n_splits, int c_per) {
  __shared__ float xs[2][CC][XR][XC];
  __shared__ __align__(16) float ws[2][CC * 9 * KB];  // [c][tap][k]

  const int tid = threadIdx.x;
  const int b = blockIdx.z / n_splits, split = blockIdx.z % n_splits;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int C = Ca + Cb;
  const int c_lo = split * c_per;
  const int c_hi = c_lo + c_per < C ? c_lo + c_per : C;
  const long plane = (long)H * W;
  const int r = tid / (TW / P), j = tid % (TW / P);

  float acc[P][KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const float bk = k < K && split == 0 ? __ldg(bias + k) : 0.0f;
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p][k] = bk;
  }

  // issues the copies of chunk c0 (input tile and weights) into buffer buf
  auto stage = [&](int c0, int buf) {
    for (int i = tid; i < CC * XR * XC; i += NT) {
      const int col = i % XC, row = (i / XC) % XR, cc = i / (XR * XC);
      const int c = c0 + cc, y = y0 - 1 + row, x = x0 - 1 + col;
      const bool ok = c < c_hi && y >= 0 && y < H && x >= 0 && x < W;
      const float* src = xa;
      if (ok)
        src = (c < Ca ? xa + ((long)b * Ca + c) * plane
                      : xb + ((long)b * Cb + (c - Ca)) * plane) + (long)y * W + x;
      cpa::copy4(&xs[buf][cc][row][col], src, ok);
    }
    for (int i = tid; i < CC * 9 * KB; i += NT) {
      const int k = i % KB, tap = (i / KB) % 9, c = c0 + i / (9 * KB);
      const bool ok = k < K && c < c_hi;
      cpa::copy4(&ws[buf][i], ok ? w + ((long)k * C + c) * 9 + tap : w, ok);
    }
    cpa::commit();
  };

  int buf = 0;
  stage(c_lo, 0);
  for (int c0 = c_lo; c0 < c_hi; c0 += CC, buf ^= 1) {
    if (c0 + CC < c_hi) {
      stage(c0 + CC, buf ^ 1);
      cpa::wait<1>();
    } else {
      cpa::wait<0>();
    }
    __syncthreads();
#pragma unroll 1
    for (int cc = 0; cc < CC; ++cc) {
      float xv[3][P + 2];
#pragma unroll
      for (int ty = 0; ty < 3; ++ty)
#pragma unroll
        for (int i = 0; i < P + 2; ++i) xv[ty][i] = xs[buf][cc][r + ty][P * j + i];
      const float4* wc = reinterpret_cast<const float4*>(ws[buf] + cc * 9 * KB);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ty = tap / 3, tx = tap % 3;
#pragma unroll
        for (int q = 0; q < KB / 4; ++q) {
          const float4 wv = wc[tap * (KB / 4) + q];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const float xval = xv[ty][p + tx];
            acc[p][4 * q + 0] = fmaf(wv.x, xval, acc[p][4 * q + 0]);
            acc[p][4 * q + 1] = fmaf(wv.y, xval, acc[p][4 * q + 1]);
            acc[p][4 * q + 2] = fmaf(wv.z, xval, acc[p][4 * q + 2]);
            acc[p][4 * q + 3] = fmaf(wv.w, xval, acc[p][4 * q + 3]);
          }
        }
      }
    }
    __syncthreads();  // the buffer is staged again two chunks on
  }

  // split s of image b writes out + (s B + b) K H W: the output itself
  // when there is one split, else its slot of the scratch buffer
  const int y = y0 + r;
  if (y >= H) return;
  const long img = (long)split * gridDim.z / n_splits + b;
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    if (k >= K) break;
    float* orow = out + ((img * K + k) * H + y) * W;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int x = x0 + P * j + p;
      if (x < W) orow[x] = acc[p][k];
    }
  }
}

// out[i] = sum over the splits s, in order, of part[s][i]
__global__ void __launch_bounds__(256)
add_splits_kernel(const float* __restrict__ part, int n_splits, long n,
                  float* __restrict__ out) {
  for (long i = blockIdx.x * 256L + threadIdx.x; i < n; i += (long)gridDim.x * 256) {
    float v = __ldg(part + i);
    for (int s = 1; s < n_splits; ++s) v += __ldg(part + s * n + i);
    out[i] = v;
  }
}

template <int KB>
void launch(const float* xa, const float* xb, const float* w, const float* b,
            float* out, int B, int H, int W, int Ca, int Cb, int K, int n_splits,
            cudaStream_t s) {
  const int chunks = (Ca + Cb + CC - 1) / CC;
  const int c_per = (chunks + n_splits - 1) / n_splits * CC;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * n_splits);
  small_conv3x3_kernel<KB><<<grid, NT, 0, s>>>(xa, xb, w, b, out, H, W, Ca, Cb, K,
                                               n_splits, c_per);
}

}  // namespace

// Floats of scratch small_conv3x3_f32 needs (0 when it splits no tile).
extern "C" long long small_conv3x3_scratch_floats(int B, int H, int W, int Ca,
                                                  int Cb, int K) {
  const int n = n_split(B, H, W, Ca + Cb);
  return n > 1 ? (long long)n * B * K * H * W : 0;
}

// Returns cudaGetLastError() after the last launch (cudaErrorInvalidValue,
// with no launch, unless 1 <= K <= 32).
extern "C" int small_conv3x3_f32(const float* xa, const float* xb, const float* w,
                                 const float* b, float* out, float* scratch, int B,
                                 int H, int W, int Ca, int Cb, int K, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n = n_split(B, H, W, Ca + Cb);
  float* dst = n > 1 ? scratch : out;
  switch ((K + 3) / 4) {
    case 1: launch<4>(xa, xb, w, b, dst, B, H, W, Ca, Cb, K, n, s); break;
    case 2: launch<8>(xa, xb, w, b, dst, B, H, W, Ca, Cb, K, n, s); break;
    case 3: launch<12>(xa, xb, w, b, dst, B, H, W, Ca, Cb, K, n, s); break;
    case 4: launch<16>(xa, xb, w, b, dst, B, H, W, Ca, Cb, K, n, s); break;
    case 5: launch<20>(xa, xb, w, b, dst, B, H, W, Ca, Cb, K, n, s); break;
    case 6: launch<24>(xa, xb, w, b, dst, B, H, W, Ca, Cb, K, n, s); break;
    case 7: launch<28>(xa, xb, w, b, dst, B, H, W, Ca, Cb, K, n, s); break;
    case 8: launch<32>(xa, xb, w, b, dst, B, H, W, Ca, Cb, K, n, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (n > 1) {
    const long total = (long)B * K * H * W;
    const long blocks = (total + 255) / 256;
    add_splits_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
        scratch, n, total, out);
  }
  return (int)cudaGetLastError();
}

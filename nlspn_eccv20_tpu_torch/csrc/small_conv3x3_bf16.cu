// K9-bf16: K9 (small_conv3x3.cu) on bf16 operands, rounding where the TPU
// kernel rounds:
//
//   xa  (B, Ca, H, W), xb (B, Cb, H, W) bf16  the concat is never built
//   w   (K, Ca + Cb, 3, 3), b (K) f32         rounded to bf16 here, K <= 32
//   out (B, K, H, W) bf16
//
//   y_t[k][y][x] = bf16( sum_c w[k][c][t] x_c[y+ty-1][x+tx-1] )   f32 sum
//   out[k][y][x] = bf16( sum_t y_t[k][y][x] + bf16(b[k]) )          f32 sum
//
// Replaces the TPU kernel small_conv3x3._fwd_kernel at dt = bfloat16
// (nlspn_eccv20_tpu/ops/pallas/small_conv3x3.py, reached from _fwd_pallas):
// it computes Y9 = X @ W(C, 9K) with f32 sums, rounds Y9 to bf16 per tap
// (y9.astype(dt)), sums the nine shifted taps and the bias in f32 and
// rounds once more. One rounding of the whole sum (a plain bf16 conv, or
// cuDNN's) differs from that on about 40% of the outputs by one ulp at the
// heads' widths, so the nine taps' sums are kept apart here until each is
// rounded.
//
// Bound on the card. At NYU b=12 (228x304, C = 256, K = 10) it moves 0.45
// GB (x read in bf16, out written): 132 us of HBM; its 38.3 GFLOP are 39 us
// on the bf16 tensor cores (572 us of f32 FMAs). So it runs on bf16 wgmma
// (wgmma_bf16.cuh) as an implicit GEMM per tap: M = pixels, N = K rounded
// up to 8, the reduction over the channels in k-steps of 16; nine
// accumulators a thread, one a tap, each summing all Ca + Cb channels of
// its tap, so that each can be rounded on its own at the end.
//
// Layout: 256 threads, two warpgroups; a block tile of 4 x 32 pixels, a
// warpgroup's M-tile 4 rows x 16 columns (a warp a row). Channels stream
// through shared memory 16 at a time in three stages: the chunk's x tile
// with its one-pixel halo as raw bf16 (16-byte cp.async copies of 8
// columns where W % 8 == 0, else plain loads; zeros outside the image) and
// its weights, rounded to bf16 once a call by prep_weights_kernel and laid
// out there as the K-major core matrices wgmma reads. A (64 x 16) comes from
// registers, two 16-bit loads a word straight from the staged tile at the
// tap's offset, with two fragment buffers so that one tap's A is built
// while the previous tap's product runs. The epilogue rounds the nine
// accumulators to bf16, adds them in tap order and the rounded bias in f32,
// rounds, and writes bf16 from registers. No splits and no atomics: two
// runs give the same bits. K <= 16 holds 72 accumulators a thread (two
// blocks an SM); K up to 32 holds 144 (one block an SM).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "wgmma_bf16.cuh"

namespace {

// v rounded to bf16 (to nearest even), held in f32
__device__ __forceinline__ float rnd_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int THREADS = 256;        // two warpgroups
constexpr int TR = 4;               // tile rows: a warp a row
constexpr int TC = 32;              // tile columns: 16 a warpgroup
constexpr int RP = TC + 16;         // bf16 a staged row: columns x0 - 8 .. x0 + TC + 7
constexpr int XC0 = 7;              // staged column of image column x0 - 1
constexpr int CH = 16;              // channels a chunk: a k-step a tap
constexpr int STAGES = 3;
// bf16 a staged plane: (TR + 2) RP = 288, padded to 8 mod 32 words' worth
// so that a warp's four planes (tig) fall in distinct banks
constexpr int PS = 296;
constexpr int XB = CH * PS;         // bf16 of a chunk's x tile

template <int N>
struct Cfg {
  static constexpr int WB = 9 * 16 * N;                  // bf16 of a chunk's weights
  static constexpr int STAGE = XB + WB;                  // bf16 a stage
  static constexpr int SMEM = STAGES * STAGE * 2;
  static constexpr int MINB = N <= 16 ? 2 : 1;           // blocks an SM
};

// The weights as the chunks stage them, rounded to bf16: wp[chunk][tap][N x
// 16], (n, j) = w[n][16 chunk + j][tap] at the K-major core-matrix place
// (n / 8) 128 + (j / 8) 64 + (n % 8) 8 + j % 8, zero past C and K.
template <int N>
__global__ void __launch_bounds__(256)
prep_weights_kernel(const float* __restrict__ w, __nv_bfloat16* __restrict__ wp, int C, int K,
                    int chunks) {
  const int total = chunks * 9 * 16 * N;
  for (int i = blockIdx.x * 256 + threadIdx.x; i < total; i += gridDim.x * 256) {
    const int n = i % N, j = (i / N) % 16, tap = (i / (16 * N)) % 9, ch = i / (144 * N);
    const int c = ch * CH + j;
    const float v = n < K && c < C ? __ldg(w + ((size_t)n * C + c) * 9 + tap) : 0.0f;
    wp[(size_t)(ch * 9 + tap) * 16 * N + (n >> 3) * 128 + (j >> 3) * 64 + (n & 7) * 8 + (j & 7)] =
        __float2bfloat16_rn(v);
  }
}

template <int N, bool kVec>
__global__ void __launch_bounds__(THREADS, Cfg<N>::MINB)
small_conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ xa,
                          const __nv_bfloat16* __restrict__ xb,
                          const __nv_bfloat16* __restrict__ wp, const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out, int H, int W, int Ca, int Cb, int K) {
  using G = Cfg<N>;
  constexpr int ND = N / 2;
  extern __shared__ __align__(128) unsigned short sm[];   // [STAGES][x tile XB | weights WB]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3, wg = warp >> 2, wr = warp & 3;
  const int C = Ca + Cb, chunks = (C + CH - 1) / CH;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TR, x0 = blockIdx.x * TC;
  const size_t plane = (size_t)H * W;
  const __nv_bfloat16* xab = xa + (size_t)b * Ca * plane;
  const __nv_bfloat16* xbb = xb + (size_t)b * Cb * plane;

  // issues the copies of chunk ch (x tile, weights) into stage buf
  auto stage = [&](int ch, int buf) {
    unsigned short* xd = sm + buf * G::STAGE;
    const int c0 = ch * CH;
    if constexpr (kVec) {
      // 16 planes x (TR + 2) rows x RP / 8 pieces of 8 columns, each wholly
      // inside or outside the image (W % 8 == 0, x0 - 8 a multiple of 8)
      constexpr int Q = RP / 8, PER = (TR + 2) * Q;
      for (int i = tid; i < CH * PER; i += THREADS) {
        const int cc = i / PER, e = i - cc * PER, row = e / Q, q = e - row * Q;
        const int c = c0 + cc, y = y0 - 1 + row, x = x0 - 8 + 8 * q;
        const bool ok = c < C && y >= 0 && y < H && x >= 0 && x < W;
        const __nv_bfloat16* src = xa;
        if (ok) src = (c < Ca ? xab + (size_t)c * plane : xbb + (size_t)(c - Ca) * plane) + y * W + x;
        cpa::copy16(xd + cc * PS + row * RP + 8 * q, src, ok);
      }
    } else {  // plain loads: the stage is not read before the next barrier
      constexpr int Q = TC + 2, PER = (TR + 2) * Q;   // columns x0 - 1 .. x0 + TC
      for (int i = tid; i < CH * PER; i += THREADS) {
        const int cc = i / PER, e = i - cc * PER, row = e / Q, q = e - row * Q;
        const int c = c0 + cc, y = y0 - 1 + row, x = x0 - 1 + q;
        unsigned short v = 0;
        if (c < C && y >= 0 && y < H && x >= 0 && x < W) {
          const __nv_bfloat16* src =
              (c < Ca ? xab + (size_t)c * plane : xbb + (size_t)(c - Ca) * plane) + y * W + x;
          v = *reinterpret_cast<const unsigned short*>(src);
        }
        xd[cc * PS + row * RP + XC0 + q] = v;
      }
    }
    const uint4* ws = reinterpret_cast<const uint4*>(wp + (size_t)ch * G::WB);
    uint4* wd = reinterpret_cast<uint4*>(xd + XB);
    for (int i = tid; i < G::WB / 8; i += THREADS) cpa::copy16(wd + i, ws + i, true);
    cpa::commit();
  };

  // this thread's A place in a staged tile: plane 2 tig, its warp's row,
  // column gid of its warpgroup's 16 (+ 8 for a[1], a[3]; 8 planes on for
  // a[2], a[3]; the next plane for a word's high half)
  const int abase = 2 * tig * PS + wr * RP + 16 * wg + gid + XC0;

  float acc[9][ND];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[t][i] = 0.0f;
    hold(acc[t]);
  }

  // chunk ch + 1's copies are issued after chunk ch's barrier, into the
  // stage chunk ch - 2 used; every product of chunk ch - 1 has finished
  // (wait<0> at the end of each chunk) before that barrier
  stage(0, 0);
  uint32_t a[2][4];
  for (int ch = 0, buf = 0; ch < chunks; ++ch, buf = buf == STAGES - 1 ? 0 : buf + 1) {
    cpa::wait<0>();
    fence_async_smem();
    __syncthreads();
    if (ch + 1 < chunks) stage(ch + 1, buf == STAGES - 1 ? 0 : buf + 1);
    const unsigned short* xs = sm + buf * G::STAGE;
    // the tap's weights: N x 16 bf16 (descriptor addresses count 16 bytes)
    const uint64_t wdesc = kmajor_desc_b16(xs + XB, 128, 256);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int f = tap & 1;
      const unsigned short* p = xs + abase + (tap / 3) * RP + tap % 3;
      if (tap >= 2) {   // the group that read buffer f
        wgmma_wait<1>();
        hold(a[f]);
      }
      a[f][0] = pack_raw(p[0], p[PS]);
      a[f][1] = pack_raw(p[8], p[PS + 8]);
      a[f][2] = pack_raw(p[8 * PS], p[9 * PS]);
      a[f][3] = pack_raw(p[8 * PS + 8], p[9 * PS + 8]);
      wgmma_fence();
      wgmma_bf16<N>(acc[tap], a[f], wdesc + tap * 16 * N * 2 / 16);
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < 9; ++t) hold(acc[t]);
    hold(a[0]);
    hold(a[1]);
  }

  // acc[t][4j + 2h + e]: pixel gid + 8h of the warp's row and warpgroup's
  // columns, output 8j + 2 tig + e
  const int y = y0 + wr;
  if (y >= H) return;
  __nv_bfloat16* o = out + (size_t)b * K * plane + (size_t)y * W;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = x0 + 16 * wg + gid + 8 * h;
    if (x >= W) continue;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 8 * j + 2 * tig + e, i = 4 * j + 2 * h + e;
        if (k >= K) continue;
        float s = rnd_bf16(acc[0][i]);
#pragma unroll
        for (int t = 1; t < 9; ++t) s += rnd_bf16(acc[t][i]);
        s += rnd_bf16(__ldg(bias + k));
        o[k * plane + x] = __float2bfloat16_rn(s);
      }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int N>
cudaError_t launch(const __nv_bfloat16* xa, const __nv_bfloat16* xb, const float* w,
                   const float* b, __nv_bfloat16* wp, __nv_bfloat16* out, int B, int H, int W,
                   int Ca, int Cb, int K, cudaStream_t s) {
  const int chunks = (Ca + Cb + CH - 1) / CH;
  const int total = chunks * 9 * 16 * N;
  prep_weights_kernel<N><<<(total + 255) / 256, 256, 0, s>>>(w, wp, Ca + Cb, K, chunks);
  // 16-byte copies of x where every row and plane start is 16-byte aligned
  const bool vec = W % 8 == 0 && aligned16(xa) && aligned16(xb);
  auto kernel = vec ? small_conv3x3_bf16_kernel<N, true> : small_conv3x3_bf16_kernel<N, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<N>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TC - 1) / TC, (H + TR - 1) / TR, B);
  kernel<<<grid, THREADS, Cfg<N>::SMEM, s>>>(xa, xb, wp, b, out, H, W, Ca, Cb, K);
  return cudaSuccess;
}

}  // namespace

// Floats of scratch small_conv3x3_bf16 needs: the rounded weights.
extern "C" long long small_conv3x3_bf16_scratch_floats(int Ca, int Cb, int K) {
  const int n = (K + 7) / 8 * 8, chunks = (Ca + Cb + CH - 1) / CH;
  return (long long)chunks * 9 * 16 * n / 2;
}

// xa, xb, out bf16; w, b f32. Returns cudaGetLastError() after the last
// launch (cudaErrorInvalidValue, with no launch, unless 1 <= K <= 32 and the
// image has fewer than 2^31 pixels).
extern "C" int small_conv3x3_bf16(const __nv_bfloat16* xa, const __nv_bfloat16* xb,
                                  const float* w, const float* b, __nv_bfloat16* out,
                                  float* scratch, int B, int H, int W, int Ca, int Cb, int K,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K < 1 || K > 32 || B < 1 || H < 1 || W < 1 || Ca + Cb < 1
      || (long long)H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  __nv_bfloat16* wp = reinterpret_cast<__nv_bfloat16*>(scratch);
  cudaError_t err;
  switch ((K + 7) / 8 * 8) {
    case 8: err = launch<8>(xa, xb, w, b, wp, out, B, H, W, Ca, Cb, K, s); break;
    case 16: err = launch<16>(xa, xb, w, b, wp, out, B, H, W, Ca, Cb, K, s); break;
    case 24: err = launch<24>(xa, xb, w, b, wp, out, B, H, W, Ca, Cb, K, s); break;
    default: err = launch<32>(xa, xb, w, b, wp, out, B, H, W, Ca, Cb, K, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

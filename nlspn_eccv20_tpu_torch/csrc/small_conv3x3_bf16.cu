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
// up to 8, the reduction over the channels in k-steps of 16; one
// accumulator a tap, each summing all Ca + Cb channels of its tap, so that
// each can be rounded on its own at the end.
//
// Layout: 256 threads, two warpgroups; a block tile of 4 x 32 pixels, a
// warpgroup's M-tile 4 rows x 16 columns (a warp a row). Channels stream
// through shared memory 16 at a time in three stages, each filled two
// chunks ahead: the chunk's x tile with its one-pixel halo as raw bf16, by
// 16-byte cp.async copies of 8 columns, and its weights, rounded to bf16
// once a call by prep_weights_kernel and laid out there as the K-major core
// matrices wgmma reads, by one bulk copy completing on an mbarrier (copied
// 16 bytes a thread, their issue held each chunk up). A (64 x 16) comes
// from registers, two 16-bit loads a word straight from the staged tile at
// the tap's offset; a chunk's nine taps are built and issued together (five
// then four at K <= 16, where two blocks share an SM's registers), one
// fence and one wait a batch (the first form waited for each product before
// building the next tap's fragments: nine product latencies a chunk). The
// epilogue rounds the nine accumulators to bf16 in registers, adds them in
// tap order and the rounded bias in f32, rounds, and writes bf16. No splits
// and no atomics: two runs give the same bits.
//
// Rows whose width is not a multiple of 8 (57x75, say) cannot be copied 16
// bytes at a time, so pad_rows_kernel first copies x into rows of a multiple
// of 8 columns, zero past W (4.7 MB at b=2 of 57x75, a few us), and the
// kernel reads that copy. The first form loaded such rows two bytes at a
// time after each barrier (77 us at b=2 of 57x75 with K 26, 1.8x cuDNN);
// loaded a chunk ahead into registers, the loads still held up each chunk's
// shared-memory reads. Splitting the nine taps over a cluster of three CTAs
// where the tiles do not fill the card (three accumulators a CTA, two CTAs
// an SM) ran slower at 57x75 than one CTA a tile: each CTA still stages
// every chunk.

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
  static constexpr int BATCH = N == 16 ? 5 : 9;          // taps' A fragments held at once
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

// xp (B, Ca + Cb, H, P) = the concat of xa and xb, its rows zero past W
// (P, a multiple of 8, >= W); 16 bytes a thread
__global__ void __launch_bounds__(256)
pad_rows_kernel(const __nv_bfloat16* __restrict__ xa, const __nv_bfloat16* __restrict__ xb,
                __nv_bfloat16* __restrict__ xp, int B, int H, int W, int Ca, int Cb, int P) {
  const int C = Ca + Cb, pieces = P / 8;
  const long total = (long)B * C * H * pieces;
  const unsigned short* ua = reinterpret_cast<const unsigned short*>(xa);
  const unsigned short* ub = reinterpret_cast<const unsigned short*>(xb);
  for (long i = blockIdx.x * 256L + threadIdx.x; i < total; i += (long)gridDim.x * 256) {
    const long row = i / pieces;
    const int x = (int)(i % pieces) * 8, y = (int)(row % H), c = (int)((row / H) % C);
    const long b = row / ((long)H * C);
    const unsigned short* src =
        (c < Ca ? ua + ((b * Ca + c) * H + y) * W : ub + ((b * Cb + c - Ca) * H + y) * W) + x;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = (x + 2 * e < W ? (uint32_t)__ldg(src + 2 * e) : 0u) |
             (x + 2 * e + 1 < W ? (uint32_t)__ldg(src + 2 * e + 1) << 16 : 0u);
    *reinterpret_cast<uint4*>(xp + row * P + x) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// x rows P bf16 apart (P % 8 == 0, xa and xb 16-byte aligned)
template <int N>
__global__ void __launch_bounds__(THREADS, Cfg<N>::MINB)
small_conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ xa,
                          const __nv_bfloat16* __restrict__ xb,
                          const __nv_bfloat16* __restrict__ wp, const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out, int H, int W, int P, int Ca, int Cb,
                          int K) {
  using G = Cfg<N>;
  constexpr int ND = N / 2, BATCH = G::BATCH;
  extern __shared__ __align__(128) unsigned short sm[];   // [STAGES][x tile XB | weights WB]
  __shared__ uint64_t wbar[STAGES];                        // a stage's weights have landed

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3, wg = warp >> 2, wr = warp & 3;
  const int C = Ca + Cb, chunks = (C + CH - 1) / CH;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TR, x0 = blockIdx.x * TC;
  const size_t xplane = (size_t)H * P, plane = (size_t)H * W;
  const __nv_bfloat16* xab = xa + (size_t)b * Ca * xplane;
  const __nv_bfloat16* xbb = xb + (size_t)b * Cb * xplane;

  // issues the copies of chunk ch into stage buf: its x tile, 16 planes x
  // (TR + 2) rows x RP / 8 pieces of 8 columns, each wholly inside or
  // outside the image (x0 - 8 a multiple of 8), one cp.async group; its
  // weights, one bulk copy on wbar[buf]
  auto stage = [&](int ch, int buf) {
    unsigned short* xd = sm + buf * G::STAGE;
    constexpr int Q = RP / 8, PER = (TR + 2) * Q;
    for (int i = tid; i < CH * PER; i += THREADS) {
      const int cc = i / PER, e = i - cc * PER, row = e / Q, q = e - row * Q;
      const int c = ch * CH + cc, y = y0 - 1 + row, x = x0 - 8 + 8 * q;
      const bool ok = c < C && y >= 0 && y < H && x >= 0 && x < W;
      const __nv_bfloat16* src = xa;
      if (ok) src = (c < Ca ? xab + c * xplane : xbb + (c - Ca) * xplane) + (size_t)y * P + x;
      cpa::copy16(xd + cc * PS + row * RP + 8 * q, src, ok);
    }
    cpa::commit();
    if (tid == 0) {
      cpa::mbar_arrive_expect_tx(&wbar[buf], G::WB * 2);
      cpa::bulk_load(xd + XB, wp + (size_t)ch * G::WB, G::WB * 2, &wbar[buf]);
    }
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

  // Chunk ch + 2's copies are issued after chunk ch's barrier, into the
  // stage chunk ch - 1 used (every product of chunk ch - 1 has finished:
  // wait<0> at the end of each chunk); each chunk commits one cp.async
  // group, empty past the last chunk.
  if (tid < STAGES) cpa::mbar_init(&wbar[tid], 1);
  __syncthreads();
  stage(0, 0);
  if (chunks > 1) stage(1, 1);
  else cpa::commit();
  uint32_t a[BATCH][4];
  for (int ch = 0; ch < chunks; ++ch) {
    const int buf = ch % STAGES;
    cpa::wait<1>();
    cpa::mbar_wait(&wbar[buf], (ch / STAGES) & 1);
    fence_async_smem();
    __syncthreads();
    if (ch + 2 < chunks) stage(ch + 2, (ch + 2) % STAGES);
    else cpa::commit();
    const unsigned short* xs = sm + buf * G::STAGE;
    // a tap's weights: N x 16 bf16 (descriptor addresses count 16 bytes)
    const uint64_t wdesc = kmajor_desc_b16(xs + XB, 128, 256);
#pragma unroll
    for (int t0 = 0; t0 < 9; t0 += BATCH) {
      if (t0 > 0) {   // the batch before has read its fragments
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < BATCH; ++j) hold(a[j]);
      }
#pragma unroll
      for (int j = 0; j < BATCH && t0 + j < 9; ++j) {
        const int tap = t0 + j;
        const unsigned short* p = xs + abase + (tap / 3) * RP + tap % 3;
        a[j][0] = pack_raw(p[0], p[PS]);
        a[j][1] = pack_raw(p[8], p[PS + 8]);
        a[j][2] = pack_raw(p[8 * PS], p[9 * PS]);
        a[j][3] = pack_raw(p[8 * PS + 8], p[9 * PS + 8]);
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BATCH && t0 + j < 9; ++j)
        wgmma_bf16<N>(acc[t0 + j], a[j], wdesc + (t0 + j) * 16 * N * 2 / 16);
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < 9; ++t) hold(acc[t]);
#pragma unroll
    for (int j = 0; j < BATCH; ++j) hold(a[j]);
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

struct Plan {
  int n, tiles_x, tiles_y, pitch, threads, smem, min_blocks, chunks;
};

// N = K rounded up to 8; 4 x 32 tiles; x read in rows of pitch bf16 (W, or
// the padded copy's W rounded up to 8)
Plan plan(int H, int W, int C, int K) {
  Plan p;
  p.n = (K + 7) / 8 * 8;
  p.tiles_x = (W + TC - 1) / TC;
  p.tiles_y = (H + TR - 1) / TR;
  p.pitch = (W + 7) / 8 * 8;
  p.threads = THREADS;
  p.chunks = (C + CH - 1) / CH;
  switch (p.n) {
    case 8: p.smem = Cfg<8>::SMEM; p.min_blocks = Cfg<8>::MINB; break;
    case 16: p.smem = Cfg<16>::SMEM; p.min_blocks = Cfg<16>::MINB; break;
    case 24: p.smem = Cfg<24>::SMEM; p.min_blocks = Cfg<24>::MINB; break;
    default: p.smem = Cfg<32>::SMEM; p.min_blocks = Cfg<32>::MINB; break;
  }
  return p;
}

template <int N>
cudaError_t launch(const Plan& p, const __nv_bfloat16* xa, const __nv_bfloat16* xb,
                   const float* w, const float* b, __nv_bfloat16* wp, __nv_bfloat16* xp,
                   __nv_bfloat16* out, int B, int H, int W, int Ca, int Cb, int K,
                   cudaStream_t s) {
  const int total = p.chunks * 9 * 16 * N;
  prep_weights_kernel<N><<<(total + 255) / 256, 256, 0, s>>>(w, wp, Ca + Cb, K, p.chunks);
  if (p.pitch != W) {   // x into rows of a multiple of 8 columns
    const long blocks = ((long)B * (Ca + Cb) * H * (p.pitch / 8) + 255) / 256;
    pad_rows_kernel<<<(int)(blocks < 65535 ? blocks : 65535), 256, 0, s>>>(
        xa, xb, xp, B, H, W, Ca, Cb, p.pitch);
    xa = xb = xp;
    Ca += Cb;
    Cb = 0;
  }
  auto kernel = small_conv3x3_bf16_kernel<N>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<N>::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.tiles_x, p.tiles_y, B), THREADS, Cfg<N>::SMEM, s>>>(xa, xb, wp, b, out, H, W,
                                                                     p.pitch, Ca, Cb, K);
  return cudaSuccess;
}

}  // namespace

// K9-bf16's launch plan as small_conv3x3_bf16 takes it: out[0..7] = N, tile
// cols, tile rows (4 x 32 pixels), the pitch of the rows the kernel reads
// (W, or W rounded up to 8: a padded copy of x), threads a CTA, bytes of
// dynamic shared memory, blocks an SM, chunks of 16 channels. Returns 0, or
// cudaErrorInvalidValue unless 1 <= K <= 32.
extern "C" int small_conv3x3_bf16_plan(int H, int W, int C, int K, int* out) {
  if (K < 1 || K > 32) return (int)cudaErrorInvalidValue;
  const Plan p = plan(H, W, C, K);
  const int v[8] = {p.n, p.tiles_x, p.tiles_y, p.pitch, p.threads, p.smem, p.min_blocks,
                    p.chunks};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// Floats of scratch small_conv3x3_bf16 needs: the rounded weights and, where
// W % 8 != 0, the padded copy of x.
extern "C" long long small_conv3x3_bf16_scratch_floats(int B, int H, int W, int Ca, int Cb,
                                                       int K) {
  const Plan p = plan(H, W, Ca + Cb, K);
  const long long weights = (long long)p.chunks * 9 * 16 * p.n / 2;
  return weights + (p.pitch != W ? ((long long)B * (Ca + Cb) * H * p.pitch + 1) / 2 : 0);
}

// xa, xb (16-byte aligned), out bf16; w, b f32; scratch of
// small_conv3x3_bf16_scratch_floats. Returns cudaGetLastError() after the
// last launch (cudaErrorInvalidValue, with no launch, unless 1 <= K <= 32,
// the padded image has fewer than 2^31 pixels and xa and xb are 16-byte
// aligned).
extern "C" int small_conv3x3_bf16(const __nv_bfloat16* xa, const __nv_bfloat16* xb,
                                  const float* w, const float* b, __nv_bfloat16* out,
                                  float* scratch, int B, int H, int W, int Ca, int Cb, int K,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K < 1 || K > 32 || B < 1 || H < 1 || W < 1 || Ca + Cb < 1
      || (long long)H * ((W + 7) / 8 * 8) >= (1LL << 31)
      || reinterpret_cast<uintptr_t>(xa) % 16 || reinterpret_cast<uintptr_t>(xb) % 16)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(H, W, Ca + Cb, K);
  __nv_bfloat16* wp = reinterpret_cast<__nv_bfloat16*>(scratch);
  __nv_bfloat16* xp = wp + (size_t)p.chunks * 9 * 16 * p.n;
  cudaError_t err;
  switch (p.n) {
    case 8: err = launch<8>(p, xa, xb, w, b, wp, xp, out, B, H, W, Ca, Cb, K, s); break;
    case 16: err = launch<16>(p, xa, xb, w, b, wp, xp, out, B, H, W, Ca, Cb, K, s); break;
    case 24: err = launch<24>(p, xa, xb, w, b, wp, xp, out, B, H, W, Ca, Cb, K, s); break;
    default: err = launch<32>(p, xa, xb, w, b, wp, xp, out, B, H, W, Ca, Cb, K, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

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
// Bound on the card. At NYU b=12 (228x304, C = 256, K = 10) it is 38.3
// GFLOP against 0.89 GB: 572 us of f32 FMAs, 264 us of HBM. Its first form,
// plain f32 FMAs, ran at 26% of that FMA peak (2.24 ms). So it runs on the
// tensor cores at f32 accuracy, as an implicit GEMM in error-compensated
// 3xTF32 (wgmma_tf32.cuh, shared with K9b): M = pixels, N = K rounded up to
// 8 (16 at K = 10: three TF32 passes of that are 0.37 ms at 494.7 TFLOP/s,
// so the design's bound is the bytes), the reduction over (channel, tap)
// in k-steps of 8 channels of one tap, across xa's channels and then xb's.
//
// Layout: 256 threads, two warpgroups, two blocks an SM. A warpgroup owns
// MT M-tiles of 64 pixels (4 rows x 16 columns, a warp a row): MT = 4 for
// N <= 16 (a block tile of 16 x 32 pixels), 2 for N = 24, 32 (8 x 32).
// Channels stream through shared memory 8 at a time in three stages by
// cp.async (cp_async.cuh): the chunk's x tile with its one-pixel halo
// (16-byte copies where W % 4 == 0, a thread a piece of each plane, else
// 4-byte ones; zeros outside the image), and its weights, split once a call
// into TF32 heads and rests by prep_weights_kernel and laid out there as
// the K-major core matrices wgmma reads (a chunk's are one contiguous run
// of 16-byte copies). Chunk ch + 1 is copied while chunk ch is summed, into
// the stage of chunk ch - 2, so one barrier a chunk suffices. A (64 x 8)
// comes from registers, built straight from the staged tile by the tap's
// offset: x as staged is its own head, and its rest v - hi is exact (the
// tensor cores read the top 19 bits of both). Each M-tile's k-step is one
// commit group of three wgmma (small products first), with two fragment
// buffers, so that one group's A is built while the previous group runs;
// consecutive groups feed other M-tiles' sums. The tensor core's f32 sums
// truncate, so a chunk's 27 products a sum go to fresh registers and are
// then added, rounded to nearest, to the running sums (runs of two chunks
// doubled the error and gained nothing). Outputs are written from
// registers: 8 lanes write 32 contiguous bytes of an output row.
//
// A grid that would leave the card's block slots short (b=1 at 256x320
// has 160 tiles for 264 slots) splits the channels over up to 8 blocks a
// tile, choosing the split with the fewest chunk-steps in its last wave;
// each split writes its partial sums to scratch and add_splits_kernel adds
// them in split order. No atomics: two runs give the same bits.
//
// What bounds it as measured (tools/time_k9b_variants.py --forward, cut-out
// copies; PERF.md, K9's findings): the A fragments' loads and splits and
// the x tile's copies, not the tensor cores (one product pass instead of
// three saves 30%, the copies 20%), at the card's power limit.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "card.cuh"
#include "cp_async.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int THREADS = 256;        // two warpgroups
constexpr int CG = 2;               // M-tiles side by side along a row
constexpr int TC = 16 * CG;         // tile columns
constexpr int RP = TC + 8;          // floats a staged row: columns x0 - 4 .. x0 + TC + 3
constexpr int XC0 = 3;              // staged column of image column x0 - 1
constexpr int CH = 8;               // channels a chunk: a k-step a tap
constexpr int STAGES = 3;           // chunk stages in shared memory
constexpr int MAX_SPLIT = 8;

// floats a staged plane of `rows` rows, padded to 8 mod 16 so that a
// warp's A loads (4 planes x 8 pixels) miss each other's banks
__host__ __device__ constexpr int plane_floats(int rows) {
  return rows * RP + ((8 - rows * RP % 16) + 16) % 16;
}

template <int N>
struct Cfg {
  static constexpr int MT = N <= 16 ? 4 : 2;     // M-tiles a warpgroup
  static constexpr int TR = 8 * MT / CG;         // tile rows
  static constexpr int PS = plane_floats(TR + 2);
  static constexpr int XF = CH * PS;             // floats of a chunk's x tile
  static constexpr int WF = 9 * 2 * 8 * N;       // of its weights: [tap][head, rest][8 x N]
  static constexpr int SMEM = STAGES * (XF + WF) * 4;
};

// The weights as the chunks stage them: wp[chunk][tap][part][8 x N], part 0
// the TF32 heads, 1 the rests; (j, n) = w[n][8 chunk + j][tap] at the
// K-major core-matrix place (n / 8) 64 + (j / 4) 32 + (n % 8) 4 + j % 4,
// zero past C and K.
template <int N>
__global__ void __launch_bounds__(256)
prep_weights_kernel(const float* __restrict__ w, float* __restrict__ wp, int C, int K,
                    int chunks) {
  const int total = chunks * 9 * 8 * N;
  for (int i = blockIdx.x * 256 + threadIdx.x; i < total; i += gridDim.x * 256) {
    const int n = i % N, j = (i / N) % 8, tap = (i / (8 * N)) % 9, ch = i / (72 * N);
    const int c = ch * CH + j;
    const float v = n < K && c < C ? __ldg(w + ((size_t)n * C + c) * 9 + tap) : 0.0f;
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    float* dst = wp + (size_t)(ch * 9 + tap) * 16 * N + (n >> 3) * 64 + (j >> 2) * 32
                 + (n & 7) * 4 + (j & 3);
    dst[0] = __uint_as_float(hi);
    dst[8 * N] = __uint_as_float(lo);
  }
}

template <int N, bool kVec>
__global__ void __launch_bounds__(THREADS, 2)
small_conv3x3_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
                     const float* __restrict__ wp, const float* __restrict__ bias,
                     float* __restrict__ out, int H, int W, int Ca, int Cb, int K,
                     int n_splits, int chunks_per) {
  using G = Cfg<N>;
  constexpr int MT = G::MT, ND = N / 2;
  extern __shared__ __align__(128) float sm[];   // [STAGES][x tile XF | weights WF]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3, wg = warp >> 2, wr = warp & 3;
  const int C = Ca + Cb, chunks = (C + CH - 1) / CH;
  const int b = blockIdx.z / n_splits, split = blockIdx.z - b * n_splits;
  const int ch_lo = split * chunks_per, ch_hi = min(ch_lo + chunks_per, chunks);
  const int y0 = blockIdx.y * G::TR, x0 = blockIdx.x * TC;
  const size_t plane = (size_t)H * W;

  const float* xab = xa + (size_t)b * Ca * plane;   // image b's channels
  const float* xbb = xb + (size_t)b * Cb * plane;
  // In the 16-byte form thread t < PER copies piece t of each staged plane
  // (row t / Q, columns x0 - 4 + 4 (t % Q) ..): its place is the same for
  // every chunk, computed once.
  constexpr int VQ = RP / 4, VPER = (G::TR + 2) * VQ;
  static_assert(VPER <= THREADS, "a piece a thread");
  const int vrow = tid / VQ, vq = tid - vrow * VQ;
  const int vy = y0 - 1 + vrow, vx = x0 - 4 + 4 * vq;
  // W % 4 == 0 and vx % 4 == 0: the 4 columns are all in or all out
  const bool vin = tid < VPER && vy >= 0 && vy < H && vx >= 0 && vx < W;
  const int voff = vin ? vy * W + vx : 0, vdst = vrow * RP + 4 * vq;

  // issues the copies of chunk ch (x tile, weights) into stage buf
  auto stage = [&](int ch, int buf) {
    float* xd = sm + buf * (G::XF + G::WF);
    const int c0 = ch * CH;
    if constexpr (kVec) {
      if (tid < VPER) {
#pragma unroll
        for (int cc = 0; cc < CH; ++cc) {
          const int c = c0 + cc;
          const bool ok = vin && c < C;
          const float* src = xa;
          if (ok) src = (c < Ca ? xab + (size_t)c * plane : xbb + (size_t)(c - Ca) * plane) + voff;
          cpa::copy16(xd + cc * G::PS + vdst, src, ok);
        }
      }
    } else {
      constexpr int Q = TC + 2, PER = (G::TR + 2) * Q;   // columns x0 - 1 .. x0 + TC
      for (int i = tid; i < CH * PER; i += THREADS) {
        const int cc = i / PER, e = i - cc * PER, row = e / Q, q = e - row * Q;
        const int c = c0 + cc, y = y0 - 1 + row, x = x0 - 1 + q;
        const bool ok = c < C && y >= 0 && y < H && x >= 0 && x < W;
        const float* src = xa;
        if (ok) src = (c < Ca ? xab + (size_t)c * plane : xbb + (size_t)(c - Ca) * plane) + y * W + x;
        cpa::copy4(xd + cc * G::PS + row * RP + XC0 + q, src, ok);
      }
    }
    const float* ws = wp + (size_t)ch * G::WF;
    float* wd = xd + G::XF;
    for (int i = tid; i < G::WF / 4; i += THREADS) cpa::copy16(wd + 4 * i, ws + 4 * i, true);
    cpa::commit();
  };

  // this thread's A place in a staged tile, M-tile m: plane tig, its warp's
  // row, column gid (+ 8 for a[1], a[3]; 4 planes on for a[2], a[3])
  int abase[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
    abase[m] = tig * G::PS + (4 * (wg + 2 * (m / CG)) + wr) * RP + 16 * (m % CG) + gid + XC0;

  // total[m][4j + 2h + e]: pixel gid + 8h of the warp's row in M-tile m,
  // output 8j + 2 tig + e
  float total[MT][ND], acc[MT][ND];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = 8 * j + 2 * tig + e;
      const float bk = k < K && split == 0 ? __ldg(bias + k) : 0.0f;
#pragma unroll
      for (int m = 0; m < MT; ++m) total[m][4 * j + e] = total[m][4 * j + 2 + e] = bk;
    }

  // one group of copies a chunk: chunk ch + 1's are issued after the
  // barrier of chunk ch, while chunk ch is summed, into the stage chunk
  // ch - 2 used. A warp past that barrier has issued all of chunk ch - 1's
  // products, so its warpgroup has none of chunk ch - 2's in flight.
  stage(ch_lo, 0);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[m][i] = 0.0f;
    hold(acc[m]);
  }
  uint32_t ah[2][4], al[2][4];
  for (int ch = ch_lo, buf = 0; ch < ch_hi; ++ch, buf = buf == STAGES - 1 ? 0 : buf + 1) {
    cpa::wait<0>();
    fence_async_smem();
    __syncthreads();
    if (ch + 1 < ch_hi) stage(ch + 1, buf == STAGES - 1 ? 0 : buf + 1);
    const float* xs = sm + buf * (G::XF + G::WF);
    const uint64_t wdesc = kmajor_desc(xs + G::XF, 128, 256);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      // the tap's weights: heads, then rests 8 N floats on (descriptor
      // addresses count 16 bytes)
      const uint64_t bh = wdesc + tap * 16 * N / 4, bl = bh + 8 * N / 4;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int g = tap * MT + m, f = g & 1;
        const float* p = xs + abase[m] + (tap / 3) * RP + tap % 3;
        const float v[4] = {p[0], p[8], p[4 * G::PS], p[4 * G::PS + 8]};
        if (g >= 2) {   // the group that read buffer f
          wgmma_wait<1>();
          hold(ah[f]);
          hold(al[f]);
        }
        // the rest v - hi is exact; the tensor cores read its top 19 bits,
        // the truncation split_tf32 would make
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[f][i] = __float_as_uint(v[i]);
          al[f][i] = __float_as_uint(v[i] - __uint_as_float(ah[f][i] & 0xffffe000u));
        }
        mma_3xtf32<N>(acc[m], ah[f], al[f], bh, bl);
      }
    }
    // the chunk's sums, rounded to nearest, into the running sums; fresh
    // zeros pinned here, where no product is in flight
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      hold(acc[m]);
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        total[m][i] += acc[m][i];
        acc[m][i] = 0.0f;
      }
      hold(acc[m]);
    }
    hold(ah[0]);
    hold(al[0]);
    hold(ah[1]);
    hold(al[1]);
  }

  // split s of image b writes out + (s B + b) K H W: the output itself
  // when there is one split, else its slot of the scratch buffer
  float* dst = out + ((size_t)split * (gridDim.z / n_splits) + b) * K * plane;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int y = y0 + 4 * (wg + 2 * (m / CG)) + wr;
    if (y >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = x0 + 16 * (m % CG) + gid + 8 * h;
      if (x >= W) continue;
      float* o = dst + y * W + x;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 8 * j + 2 * tig + e;
          if (k < K) o[k * plane] = total[m][4 * j + 2 * h + e];
        }
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

// The launch geometry, mirrored by ops/kernels/small_conv3x3.py's fwd_plan.
struct Plan {
  int n;                 // K rounded up to 8
  int tile_rows;         // the block's tile: tile_rows x TC pixels
  long tiles;
  int chunks, chunks_per, splits;   // grid (W / TC, H / tile_rows, B * splits)
  int smem;
};

Plan plan(int B, int H, int W, int C, int K, int sms) {
  Plan p;
  p.n = (K + 7) / 8 * 8;
  p.tile_rows = p.n <= 16 ? Cfg<16>::TR : Cfg<32>::TR;
  p.smem = p.n == 8 ? Cfg<8>::SMEM : p.n == 16 ? Cfg<16>::SMEM
           : p.n == 24 ? Cfg<24>::SMEM : Cfg<32>::SMEM;
  p.tiles = (long)B * ((H + p.tile_rows - 1) / p.tile_rows) * ((W + TC - 1) / TC);
  p.chunks = (C + CH - 1) / CH;
  // the split with the fewest chunk-steps (plus two of pipeline fill a
  // block) over its waves of 2 blocks an SM; the fewer splits on a tie
  const long slots = 2L * sms;
  long best = -1;
  for (int n = 1; n <= std::min(MAX_SPLIT, p.chunks); ++n) {
    const int per = (p.chunks + n - 1) / n, splits = (p.chunks + per - 1) / per;
    const long cost = (p.tiles * splits + slots - 1) / slots * (per + 2);
    if (best < 0 || cost < best) {
      best = cost;
      p.chunks_per = per;
      p.splits = splits;
    }
  }
  return p;
}

size_t weight_floats(const Plan& p) { return (size_t)p.chunks * 9 * 16 * p.n; }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int N>
cudaError_t launch(const Plan& p, const float* xa, const float* xb, const float* w,
                   const float* b, float* wp, float* dst, int B, int H, int W, int Ca, int Cb,
                   int K, cudaStream_t s) {
  const int total = p.chunks * 9 * 8 * N;
  prep_weights_kernel<N><<<(total + 255) / 256, 256, 0, s>>>(w, wp, Ca + Cb, K, p.chunks);
  // 16-byte copies of x where every row and plane start is 16-byte aligned
  const bool vec = W % 4 == 0 && aligned16(xa) && aligned16(xb);
  auto kernel = vec ? small_conv3x3_kernel<N, true> : small_conv3x3_kernel<N, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<N>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TC - 1) / TC, (H + Cfg<N>::TR - 1) / Cfg<N>::TR, B * p.splits);
  kernel<<<grid, THREADS, Cfg<N>::SMEM, s>>>(xa, xb, wp, b, dst, H, W, Ca, Cb, K, p.splits,
                                            p.chunks_per);
  return cudaSuccess;
}

}  // namespace

// Floats of scratch small_conv3x3_f32 needs: the split weights, and the
// partial sums where it splits the channels (-1 if the card cannot be
// asked for its SM count).
extern "C" long long small_conv3x3_scratch_floats(int B, int H, int W, int Ca,
                                                  int Cb, int K) {
  int sms = 0;
  if (card_sms(&sms) != cudaSuccess) return -1;
  const Plan p = plan(B, H, W, Ca + Cb, K, sms);
  return (long long)weight_floats(p)
         + (p.splits > 1 ? (long long)p.splits * B * K * H * W : 0);
}

// Returns cudaGetLastError() after the last launch (cudaErrorInvalidValue,
// with no launch, unless 1 <= K <= 32 and the image has fewer than 2^31
// pixels).
extern "C" int small_conv3x3_f32(const float* xa, const float* xb, const float* w,
                                 const float* b, float* out, float* scratch, int B,
                                 int H, int W, int Ca, int Cb, int K, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K < 1 || K > 32 || B < 1 || H < 1 || W < 1 || Ca + Cb < 1
      || (long long)H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = card_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const Plan p = plan(B, H, W, Ca + Cb, K, sms);
  float* wp = scratch;
  float* dst = p.splits > 1 ? scratch + weight_floats(p) : out;
  switch (p.n) {
    case 8: err = launch<8>(p, xa, xb, w, b, wp, dst, B, H, W, Ca, Cb, K, s); break;
    case 16: err = launch<16>(p, xa, xb, w, b, wp, dst, B, H, W, Ca, Cb, K, s); break;
    case 24: err = launch<24>(p, xa, xb, w, b, wp, dst, B, H, W, Ca, Cb, K, s); break;
    default: err = launch<32>(p, xa, xb, w, b, wp, dst, B, H, W, Ca, Cb, K, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  if (p.splits > 1) {
    const long total = (long)B * K * H * W;
    const long blocks = (total + 255) / 256;
    add_splits_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
        dst, p.splits, total, out);
  }
  return (int)cudaGetLastError();
}

// K9b: the backward of K9 (small_conv3x3.cu). Given g = dL/d(out)
// (B, K, H, W):
//
//   dx_c[y][x]       = sum_k sum_{ty,tx} w[k][c][ty][tx] g_k[y-ty+1][x-tx+1]
//   dW[k][c][ty][tx] = sum_{b,y,x} g_k[y][x] x_c[y+ty-1][x+tx-1]
//   db[k]            = sum_{b,y,x} g_k[y][x]
//
// with g and x zero outside the image. dx is split into dxa (the first Ca
// channels) and dxb, as the inputs were.
//
// Replaces the TPU kernel small_conv3x3._bwd_kernel
// (nlspn_eccv20_tpu/ops/pallas/small_conv3x3.py, reached from _bwd_pallas).
//
// Both are products with the mirrored-tap im2col of g, G[p][(tap, k)] =
// g_k[y-ty+1][x-tx+1] at pixel p = (y, x), which is never built:
//   dx = G . Wm      (pixels x 9K) . (9K x C),  Wm[(tap, k)][c] = w[k][c][tap]
//   dW = G^T . X     (9K x pixels) . (pixels x C), summed over the pixels.
// Row (tap, k) of the 9K side is tap * K + k, padded to a multiple of 8.
//
// Bound on the card. At NYU b=12 (228x304, C = 256, K = 10) the two
// products are 76.65 GFLOP: 1.14 ms of f32 FMAs at 67 TFLOP/s, against
// 1.74 GB of bytes (x read, dx written, g), 0.52 ms of HBM. So both run on
// the tensor cores at f32 accuracy, as an error-compensated 3xTF32 product
// (wgmma, TF32 in, f32 sums; the split and the helpers are in
// wgmma_tf32.cuh, shared with K9). 3 x 76.65 GFLOP at 494.7 TFLOP/s (TF32 dense) is 0.465 ms,
// under the bytes: this design's bound is the 0.52 ms of bytes.
// (mma.sync.m16n8k8 ran TF32 at about half that rate on the card.)
//
// Both passes run 256 threads, two warpgroups, two blocks an SM, and issue
// for each k-step of 8 the three products as one wgmma commit group: A
// (64 x 8) from registers, built straight from a staged tile by (tap, k)
// offsets and split there, two buffers of them so that a step's fragments
// are built while the previous step's products run; B (8 x N) from shared
// memory as K-major core matrices (8 rows of N x 16 bytes of K, 128
// contiguous bytes; 128 bytes apart along K, 256 or 2048 along N).
//   1. dx_kernel: persistent blocks, each owning NC = 128 channels (64
//      where 128 would not leave two blocks an SM, at K > 10): its weights,
//      read in w's order, split into heads and rests once. It walks the
//      image in 8x16 pixel tiles: a tile's g planes and their one-pixel
//      halo come in by cp.async into one of two buffers (cp_async.cuh)
//      while the previous tile computes: once a tile, not once per channel
//      group. Warpgroup w owns tile rows 4w .. 4w + 3 (M = 64 pixels), each
//      warp one row; N = NC. The sums go to dxa / dxb from registers: 8
//      lanes write 32 contiguous bytes of a channel row.
//   2. wgrad_kernel: split-K over pixel slices. Block = (128 rows of the 9K
//      side, one warpgroup a 64, 64 channels, slice s of the 4x16 pixel
//      tiles). Three tiles in flight: the channels' x straight into
//      core-matrix order and g's planes with their halo, by 16-byte copies
//      where W % 4 == 0 (else 4-byte ones). x as staged is B's heads; one
//      pass writes its rests. The tensor core's f32 sums truncate, so a
//      tile's 24 products a sum go to fresh registers and are then added,
//      rounded to nearest, to the slice's sums: no long truncating chain.
//      db comes from g in the same pass (the first block column). Each
//      block writes part[s] = [dW (K, C, 9) | db (K)].
//   3. bwd::reduce_partials (bwd_common.cuh): the slices added in a fixed
//      order.
// No atomics: the result is the same bits from run to run, as the TPU
// kernel's sequential grid gives. What bounds the passes as measured (the
// wgrad's loads and products do not overlap; the card meets its power
// limit): PERF.md, its K9b findings.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "bwd_common.cuh"
#include "card.cuh"
#include "cp_async.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int CARD_SMEM = 233472;       // shared memory of an SM (228 KB)
constexpr int BLOCK_SMEM_MAX = 232448;  // that a block may use (227 KB)
constexpr int THREADS = 256;            // two warpgroups

// k-steps of 8 on the 9K side
__host__ __device__ constexpr int ksteps(int K) { return (9 * K + 7) / 8; }

// ---- 1. dx ----
constexpr int DX_TH = 8, DX_TW = 16;    // pixel tile: a warp a row
constexpr int DX_RP = DX_TW + 2;        // floats a staged row, halo included
// floats a staged g plane: (DX_TH + 2) * DX_RP = 180, padded to 24 mod 32 so
// that a warp's A loads (8 pixels x 4 k columns a plane apart) miss each other
constexpr int DX_PS = 184;

__host__ __device__ constexpr int dx_smem(int nc, int K) {
  return 2 * ksteps(K) * 8 * nc * 4 + 2 * K * DX_PS * 4 + ksteps(K) * 8 * 4;
}

template <int NC>
__global__ void __launch_bounds__(THREADS, 2)
dx_kernel(const float* __restrict__ g, const float* __restrict__ w, float* __restrict__ dxa,
          float* __restrict__ dxb, int B, int H, int W, int Ca, int Cb, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nks = ksteps(K);
  // Wm's heads and rests, [step][NC / 8][2][8][4]: a k-step's 8 x NC as
  // K-major core matrices, 128 bytes apart along K, 256 along N
  float* wh = reinterpret_cast<float*>(smem);
  float* wl = wh + nks * 8 * NC;
  float* gs = wl + nks * 8 * NC;                            // [2][K][DX_PS]
  int* koff = reinterpret_cast<int*>(gs + 2 * K * DX_PS);   // [8 nks]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int C = Ca + Cb, c0 = blockIdx.x * NC;
  const int tiles_x = (W + DX_TW - 1) / DX_TW, tiles_y = (H + DX_TH - 1) / DX_TH;
  const int per_image = tiles_x * tiles_y, tiles = B * per_image;
  const long plane = (long)H * W;

  // zeros where Wm is padding (rows past 9K, channels past C), then the
  // weights, read in w's own order (k, c, tap): contiguous runs of NC x 9
  for (int i = tid; i < 2 * nks * 8 * NC; i += THREADS) wh[i] = 0.0f;
  __syncthreads();
  const int ncl = min(NC, C - c0);
  for (int i = tid; i < K * ncl * 9; i += THREADS) {
    const int k = i / (ncl * 9), e = i - k * (ncl * 9), c = e / 9, tap = e - c * 9;
    uint32_t hi, lo;
    split_tf32(__ldg(w + ((long)k * C + c0) * 9 + e), hi, lo);
    const int kk = tap * K + k;
    const int o = (kk >> 3) * 8 * NC + ((c >> 3) * 2 + ((kk >> 2) & 1)) * 32 + (c & 7) * 4 + (kk & 3);
    wh[o] = __uint_as_float(hi);
    wl[o] = __uint_as_float(lo);
  }
  fence_async_smem();
  // offset of (tap, k) from a pixel's place in the staged tile; -1: padding
  for (int kk = tid; kk < nks * 8; kk += THREADS) {
    const int tap = kk / K, k = kk - tap * K;
    koff[kk] = kk < 9 * K ? k * DX_PS + (2 - tap / 3) * DX_RP + (2 - tap % 3) : -1;
  }

  // issues the copies of tile t's g planes, halo included, into buffer buf
  auto stage = [&](int t, int buf) {
    const int b = t / per_image, r = t - b * per_image;
    const int y0 = (r / tiles_x) * DX_TH - 1, x0 = (r % tiles_x) * DX_TW - 1;
    float* dst = gs + buf * K * DX_PS;
    for (int i = tid; i < K * (DX_TH + 2) * DX_RP; i += THREADS) {
      const int k = i / ((DX_TH + 2) * DX_RP), e = i - k * ((DX_TH + 2) * DX_RP);
      const int row = e / DX_RP, col = e - row * DX_RP;
      const int y = y0 + row, x = x0 + col;
      const bool ok = y >= 0 && y < H && x >= 0 && x < W;
      cpa::copy4(dst + k * DX_PS + e, ok ? g + ((long)b * K + k) * plane + (long)y * W + x : g,
                 ok);
    }
    cpa::commit();
  };

  const int step = gridDim.y;
  int t = blockIdx.y;
  if (t < tiles) stage(t, 0);
  for (int buf = 0; t < tiles; t += step, buf ^= 1) {
    if (t + step < tiles) {
      stage(t + step, buf ^ 1);
      cpa::wait<1>();
    } else {
      cpa::wait<0>();
    }
    __syncthreads();
    // this warp's A rows: pixels gid and gid + 8 of tile row `warp`
    const float* prow = gs + buf * K * DX_PS + warp * DX_RP + gid;
    float acc[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] = 0.0f;
    // A of k-step s: columns tig and tig + 4 are (tap, k) rows 8s + tig, 8s + tig + 4
    auto frag = [&](int s, uint32_t (&ah)[4], uint32_t (&al)[4]) {
      const int o0 = koff[8 * s + tig], o1 = koff[8 * s + tig + 4];
      split_tf32(o0 >= 0 ? prow[o0] : 0.0f, ah[0], al[0]);
      split_tf32(o0 >= 0 ? prow[o0 + 8] : 0.0f, ah[1], al[1]);
      split_tf32(o1 >= 0 ? prow[o1] : 0.0f, ah[2], al[2]);
      split_tf32(o1 >= 0 ? prow[o1 + 8] : 0.0f, ah[3], al[3]);
    };
    auto mma = [&](int s, const uint32_t (&ah)[4], const uint32_t (&al)[4]) {
      mma_3xtf32<NC>(acc, ah, al, kmajor_desc(wh + s * 8 * NC, 128, 256),
                     kmajor_desc(wl + s * 8 * NC, 128, 256));
    };
    // two fragment buffers: step s + 2 overwrites step s's once its group is done
    uint32_t a0h[4], a0l[4], a1h[4], a1l[4];
#pragma unroll 1
    for (int s = 0; s < nks; s += 2) {
      if (s >= 2) {
        wgmma_wait<1>();
        hold(a0h);
        hold(a0l);
      }
      frag(s, a0h, a0l);
      mma(s, a0h, a0l);
      if (s + 1 < nks) {
        if (s >= 2) {
          wgmma_wait<1>();
          hold(a1h);
          hold(a1l);
        }
        frag(s + 1, a1h, a1l);
        mma(s + 1, a1h, a1l);
      }
    }
    wgmma_wait<0>();
    hold(acc);
    hold(a0h);
    hold(a0l);
    hold(a1h);
    hold(a1l);

    // acc[4j + 2h + e]: pixel gid + 8h of tile row `warp`, channel c0 + 8j + 2 tig + e
    const int b = t / per_image, r = t - b * per_image;
    const int y = (r / tiles_x) * DX_TH + warp, x = (r % tiles_x) * DX_TW + gid;
    if (y < H && x < W) {
      const bool x8 = x + 8 < W;
      const long pix = (long)y * W + x;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // channel c of dxa at pa + (c - c0 - 2 tig - e) planes, of dxb at pb + ...
        const int ce = c0 + 2 * tig + e;
        float* pa = dxa + ((long)b * Ca + ce) * plane + pix;
        float* pb = dxb + ((long)b * Cb + ce - Ca) * plane + pix;
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
          const int c = ce + 8 * j;
          if (c >= C) break;
          float* p = (c < Ca ? pa : pb) + (long)(8 * j) * plane;
          p[0] = acc[4 * j + e];
          if (x8) p[8] = acc[4 * j + 2 + e];
        }
      }
    }
    __syncthreads();   // the buffer is staged again two tiles on
  }
}

// ---- 2. dW and db as per-slice partial sums ----
constexpr int WG_TH = 4, WG_TW = 16;    // pixel tile: 64 pixels, 8 k-steps
constexpr int WG_PIX = WG_TH * WG_TW;
constexpr int WG_MR = 128;              // 9K rows a block: a warpgroup a 64
constexpr int WG_NC = 64;               // channels a block
constexpr int WG_XF = WG_NC * WG_PIX;   // floats of a staged x tile
// a staged g row: columns x0 - 1 .. x0 + 16 (4-byte copies), or, where
// W % 4 == 0, x0 - 4 .. x0 + 19 (16-byte copies, each wholly inside or
// outside the image), column x0 - 1 at WG_C0 then
template <bool kVec> constexpr int WG_RP = kVec ? WG_TW + 8 : WG_TW + 2;
template <bool kVec> constexpr int WG_C0 = kVec ? 3 : 0;
// floats a staged g plane, (WG_TH + 2) rows, padded to 4 mod 32 so that a
// warp's A loads (8 rows a plane apart x 4 pixels) miss each other
constexpr int WG_PS = 164;
constexpr int WG_STAGES = 3;            // tiles in flight: x is the pass's whole read
constexpr int WG_BLOCKS_PER_SM = 2;

__host__ __device__ constexpr int wg_smem(int K) {
  return (WG_STAGES * WG_XF + WG_XF + WG_STAGES * K * WG_PS + K * WG_TH) * 4;
}

template <bool kVec>
__global__ void __launch_bounds__(THREADS, WG_BLOCKS_PER_SM)
wgrad_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
             const float* __restrict__ g, float* __restrict__ part, int B, int H, int W,
             int Ca, int Cb, int K, int cchunks) {
  extern __shared__ __align__(128) float wsm[];
  // x of a tile as K-major core matrices, [NC / 8][WG_PIX / 4][8][4]: 128
  // bytes apart along the pixels, 2048 along the channels. As staged it is
  // also the B operand's heads: the tensor cores read a TF32 operand's top
  // 19 bits, the truncation split_tf32 makes.
  float* xs = wsm;                            // [WG_STAGES][WG_XF]
  float* xl = xs + WG_STAGES * WG_XF;         // the rests of the tile in use
  float* gs = xl + WG_XF;                     // [WG_STAGES][K][WG_PS]
  float* dbs = gs + WG_STAGES * K * WG_PS;    // [K][WG_TH]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int C = Ca + Cb;
  const int mc = blockIdx.x / cchunks, cc = blockIdx.x - mc * cchunks;
  const int m_wg = mc * WG_MR + 64 * (warp >> 2);   // this warpgroup's first 9K row
  const int m_w = m_wg + 16 * (warp & 3), c0 = cc * WG_NC;
  const int s = blockIdx.y, S = gridDim.y;
  const int tiles_x = (W + WG_TW - 1) / WG_TW, tiles_y = (H + WG_TH - 1) / WG_TH;
  const int per_image = tiles_x * tiles_y;
  const long tiles = (long)B * per_image;
  const int t0 = (int)(tiles * s / S), t1 = (int)(tiles * (s + 1) / S);
  const long plane = (long)H * W;
  const bool with_db = blockIdx.x == 0;
  const bool live = m_wg < 9 * K;   // the warpgroup has rows of the 9K side

  // this thread's A rows m_w + gid + 8h: their (tap, k) offsets
  int ko[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kk = m_w + gid + 8 * h, tap = kk / K, k = kk - tap * K;
    ko[h] = kk < 9 * K ? k * WG_PS + (2 - tap / 3) * WG_RP<kVec> + (2 - tap % 3) + WG_C0<kVec> : -1;
  }

  auto stage = [&](int t, int buf) {
    const int b = t / per_image, r = t - b * per_image;
    const int y0 = (r / tiles_x) * WG_TH, x0 = (r % tiles_x) * WG_TW;
    float* xd = xs + buf * WG_XF;
    // (channel cl, pixel p) at ((cl / 8) * 16 + p / 4) * 32 + (cl % 8) * 4 + p % 4
    if constexpr (kVec) {
      for (int i = tid; i < WG_NC * WG_PIX / 4; i += THREADS) {
        const int p4 = i % (WG_PIX / 4), cl = i / (WG_PIX / 4);
        const int c = c0 + cl, y = y0 + p4 / 4, x = x0 + 4 * (p4 % 4);
        const bool ok = c < C && y < H && x < W;
        const float* src = xa;
        if (ok)
          src = (c < Ca ? xa + ((long)b * Ca + c) * plane : xb + ((long)b * Cb + (c - Ca)) * plane)
                + (long)y * W + x;
        cpa::copy16(xd + ((cl >> 3) * 16 + p4) * 32 + (cl & 7) * 4, src, ok);
      }
    } else {
      for (int i = tid; i < WG_NC * WG_PIX; i += THREADS) {
        const int p = i % WG_PIX, cl = i / WG_PIX;
        const int c = c0 + cl, y = y0 + p / WG_TW, x = x0 + p % WG_TW;
        const bool ok = c < C && y < H && x < W;
        const float* src = xa;
        if (ok)
          src = (c < Ca ? xa + ((long)b * Ca + c) * plane : xb + ((long)b * Cb + (c - Ca)) * plane)
                + (long)y * W + x;
        cpa::copy4(xd + ((cl >> 3) * 16 + p / 4) * 32 + (cl & 7) * 4 + p % 4, src, ok);
      }
    }
    float* gd = gs + buf * K * WG_PS;
    constexpr int RP = WG_RP<kVec>, Q = kVec ? RP / 4 : RP;   // copies a row
    for (int i = tid; i < K * (WG_TH + 2) * Q; i += THREADS) {
      const int k = i / ((WG_TH + 2) * Q), e = i - k * ((WG_TH + 2) * Q);
      const int row = e / Q, q = e - row * Q;
      const int y = y0 - 1 + row, x = x0 - 1 - WG_C0<kVec> + (kVec ? 4 * q : q);
      const bool ok = y >= 0 && y < H && x >= 0 && x < W;
      const float* src = ok ? g + ((long)b * K + k) * plane + (long)y * W + x : g;
      float* dst = gd + k * WG_PS + row * RP + (kVec ? 4 * q : q);
      if constexpr (kVec) cpa::copy16(dst, src, ok);
      else cpa::copy4(dst, src, ok);
    }
    cpa::commit();
  };

  float total[WG_NC / 2];
#pragma unroll
  for (int i = 0; i < WG_NC / 2; ++i) total[i] = 0.0f;
  float dbsum = 0.0f;   // thread (k, row) < K x WG_TH: row `row` of plane k

  // a group of copies a tile, empty past the slice, so that waiting for all
  // but the last WG_STAGES - 1 groups always means this tile's
  for (int i = 0; i < WG_STAGES - 1; ++i) {
    if (t0 + i < t1) stage(t0 + i, i);
    else cpa::commit();
  }
  for (int t = t0, buf = 0; t < t1; ++t, buf = buf == WG_STAGES - 1 ? 0 : buf + 1) {
    // the buffer of tile t - 1, done with at the end of the last iteration
    const int next = buf == 0 ? WG_STAGES - 1 : buf - 1;
    if (t + WG_STAGES - 1 < t1) stage(t + WG_STAGES - 1, next);
    else cpa::commit();
    cpa::wait<WG_STAGES - 1>();
    __syncthreads();
    const float* xb_s = xs + buf * WG_XF;
    const float4* x4 = reinterpret_cast<const float4*>(xb_s);
    for (int i = tid; i < WG_XF / 4; i += THREADS) {
      const float4 v = x4[i];
      reinterpret_cast<float4*>(xl)[i] =
          make_float4(tf32_rest(v.x), tf32_rest(v.y), tf32_rest(v.z), tf32_rest(v.w));
    }
    const float* gb = gs + buf * K * WG_PS;
    if (with_db && tid < K * WG_TH) {
      const float* row = gb + (tid / WG_TH) * WG_PS + (tid % WG_TH + 1) * WG_RP<kVec> + 1 + WG_C0<kVec>;
#pragma unroll
      for (int col = 0; col < WG_TW; ++col) dbsum += row[col];
    }
    fence_async_smem();
    __syncthreads();
    if (live) {
      float acc[WG_NC / 2];
#pragma unroll
      for (int i = 0; i < WG_NC / 2; ++i) acc[i] = 0.0f;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int q = 0; q < WG_PIX / 8; ++q) {
        // columns tig, tig + 4: pixels 8q + tig, 8q + tig + 4 (row q / 2 of the tile)
        const int pb = (q >> 1) * WG_RP<kVec> + 8 * (q & 1) + tig, f = q & 1;
        if (q >= 2) {
          wgmma_wait<1>();
          hold(ah[f]);
          hold(al[f]);
        }
        split_tf32(ko[0] >= 0 ? gb[ko[0] + pb] : 0.0f, ah[f][0], al[f][0]);
        split_tf32(ko[1] >= 0 ? gb[ko[1] + pb] : 0.0f, ah[f][1], al[f][1]);
        split_tf32(ko[0] >= 0 ? gb[ko[0] + pb + 4] : 0.0f, ah[f][2], al[f][2]);
        split_tf32(ko[1] >= 0 ? gb[ko[1] + pb + 4] : 0.0f, ah[f][3], al[f][3]);
        mma_3xtf32<WG_NC>(acc, ah[f], al[f], kmajor_desc(xb_s + 2 * q * 32, 128, 2048),
                          kmajor_desc(xl + 2 * q * 32, 128, 2048));
      }
      wgmma_wait<0>();
      hold(acc);
      hold(ah[0]);
      hold(al[0]);
      hold(ah[1]);
      hold(al[1]);
#pragma unroll
      for (int i = 0; i < WG_NC / 2; ++i) total[i] += acc[i];
    }
    __syncthreads();   // the buffers are staged and split again
  }
  cpa::wait<0>();   // the empty groups

  float* out = part + (long)s * ((long)K * C * 9 + K);
  // total[4j + 2h + e]: 9K row m_w + gid + 8h, channel c0 + 8j + 2 tig + e
  if (live) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = m_w + gid + 8 * h;
      if (kk >= 9 * K) continue;
      const int tap = kk / K, k = kk - tap * K;
#pragma unroll
      for (int j = 0; j < WG_NC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * j + 2 * tig + e;
          if (c < C) out[((long)k * C + c) * 9 + tap] = total[4 * j + 2 * h + e];
        }
    }
  }
  if (with_db) {
    if (tid < K * WG_TH) dbs[tid] = dbsum;
    __syncthreads();
    if (tid < K) {
      float v = dbs[tid * WG_TH];
#pragma unroll
      for (int r = 1; r < WG_TH; ++r) v += dbs[tid * WG_TH + r];
      out[(long)K * C * 9 + tid] = v;
    }
  }
}

// The launch geometry, mirrored by ops/kernels/small_conv3x3.py's bwd_plan.
struct Plan {
  int dx_nc, dx_chunks, dx_blocks, dx_smem;      // grid (dx_chunks, dx_blocks)
  int mchunks, cchunks, slices, wg_smem;         // grid (mchunks * cchunks, slices)
};

Plan plan(int B, int H, int W, int C, int K, int sms) {
  Plan p;
  // 128 channels a block where two blocks still fit an SM, else 64
  p.dx_nc = 2 * (dx_smem(128, K) + 1024) <= CARD_SMEM ? 128 : 64;
  p.dx_smem = dx_smem(p.dx_nc, K);
  const int dx_per_sm = 2 * (p.dx_smem + 1024) <= CARD_SMEM ? 2 : 1;
  p.dx_chunks = (C + p.dx_nc - 1) / p.dx_nc;
  const long dx_tiles = (long)B * ((H + DX_TH - 1) / DX_TH) * ((W + DX_TW - 1) / DX_TW);
  p.dx_blocks = (int)std::max(1L, std::min(dx_tiles, (long)dx_per_sm * sms / p.dx_chunks));
  p.mchunks = (9 * K + WG_MR - 1) / WG_MR;
  p.cchunks = (C + WG_NC - 1) / WG_NC;
  p.wg_smem = wg_smem(K);
  const long wg_tiles = (long)B * ((H + WG_TH - 1) / WG_TH) * ((W + WG_TW - 1) / WG_TW);
  const long want = ((long)WG_BLOCKS_PER_SM * sms) / (p.mchunks * p.cchunks);
  p.slices = (int)std::max(1L, std::min({wg_tiles, want, (long)bwd::RED_CHUNK}));
  return p;
}

long partial_floats(const Plan& p, int C, int K) {
  return (long)p.slices * ((long)K * C * 9 + K);
}

template <int NC>
cudaError_t launch_dx(const Plan& p, const float* g, const float* w, float* dxa, float* dxb,
                      int B, int H, int W, int Ca, int Cb, int K, cudaStream_t s) {
  const cudaError_t err =
      cudaFuncSetAttribute(dx_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.dx_smem);
  if (err != cudaSuccess) return err;
  dx_kernel<NC><<<dim3(p.dx_chunks, p.dx_blocks), THREADS, p.dx_smem, s>>>(
      g, w, dxa, dxb, B, H, W, Ca, Cb, K);
  return cudaSuccess;
}

}  // namespace

// Floats of scratch small_conv3x3_bwd_f32 needs (-1 if the card cannot be
// asked for its SM count).
extern "C" long long small_conv3x3_bwd_scratch_floats(int B, int H, int W, int Ca,
                                                      int Cb, int K) {
  int sms = 0;
  if (card_sms(&sms) != cudaSuccess) return -1;
  const Plan p = plan(B, H, W, Ca + Cb, K, sms);
  return partial_floats(p, Ca + Cb, K)
      + bwd::reduce_scratch_floats(p.slices, K * (Ca + Cb) * 9 + K);
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
  if (K < 1 || K > 32 || B < 1 || H < 1 || W < 1 || Ca + Cb < 1)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = card_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const int C = Ca + Cb;
  const Plan p = plan(B, H, W, C, K, sms);
  if (p.dx_smem > BLOCK_SMEM_MAX) return (int)cudaErrorInvalidValue;
  err = p.dx_nc == 128 ? launch_dx<128>(p, g, w, dxa, dxb, B, H, W, Ca, Cb, K, s)
                       : launch_dx<64>(p, g, w, dxa, dxb, B, H, W, Ca, Cb, K, s);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies of x and g where every row and plane start is 16-byte aligned
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(xa) % 16 == 0
                   && reinterpret_cast<uintptr_t>(xb) % 16 == 0
                   && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  auto wgrad = vec ? wgrad_kernel<true> : wgrad_kernel<false>;
  err = cudaFuncSetAttribute(wgrad, cudaFuncAttributeMaxDynamicSharedMemorySize, p.wg_smem);
  if (err != cudaSuccess) return (int)err;
  wgrad<<<dim3(p.mchunks * p.cchunks, p.slices), THREADS, p.wg_smem, s>>>(
      xa, xb, g, scratch, B, H, W, Ca, Cb, K, p.cchunks);
  bwd::reduce_partials(scratch, p.slices, K * C * 9 + K, dwb,
                       scratch + partial_floats(p, C, K), s);
  return (int)cudaGetLastError();
}

// K9b-bf16: the backward of K9-bf16 (small_conv3x3_bf16.cu), rounding where
// the TPU kernel rounds. Given g = dL/d(out) (B, K, H, W):
//
//   dx_c[y][x]       = bf16( sum_k sum_{ty,tx} w[k][c][t] g_k[y-ty+1][x-tx+1] )
//   dW[k][c][ty][tx] = sum_{b,y,x} g_k[y][x] x_c[y+ty-1][x+tx-1]     f32
//   db[k]            = sum_{b,y,x} g_k[y][x]                         f32
//
// with g and the weights rounded to bf16 first (g arrives bf16), x bf16, g
// and x zero outside the image. dx is split into dxa and dxb (bf16), dW
// and db are f32, as _bwd_pallas returns them.
//
// Replaces the TPU kernel small_conv3x3._bwd_kernel at dt = bfloat16
// (nlspn_eccv20_tpu/ops/pallas/small_conv3x3.py, reached from _bwd_pallas):
// it shifts the rounded g (exact), sums its products with the rounded
// weights in f32 and rounds dx once; dW and db are f32 sums of products of
// bf16 values, which are exact.
//
// The products are K9b's (small_conv3x3_bwd.cu), with the mirrored-tap
// im2col G[p][(tap, k)] = g_k[y-ty+1][x-tx+1]:
//   dx = G . Wm      (pixels x 9K) . (9K x C),  Wm[(tap, k)][c] = w[k][c][tap]
//   dW = G^T . X     (9K x pixels) . (pixels x C)
// Row (tap, k) of the 9K side is tap * K + k, padded to a multiple of 16.
//
// Bound on the card. At NYU b=12 (228x304, C = 256, K = 10) it reads x and
// g and writes dx in bf16, 0.87 GB: 259 us of HBM; its 76.65 GFLOP are 77
// us on the bf16 tensor cores (1.14 ms of f32 FMAs). So both products run on
// bf16 wgmma (wgmma_bf16.cuh), K9b's two passes with k-steps of 16 and
// every operand bf16 (one product, not three TF32 passes), 256 threads and
// two warpgroups a block:
//   1. dx_kernel: persistent blocks, each owning NC = 128 channels (64
//      where two such blocks would not fit an SM): their weights, rounded
//      to bf16 once, as K-major core matrices. It walks the image in 8x16
//      pixel tiles, g's K planes with their one-pixel halo staged as raw
//      bf16 by cp.async (4-byte copies of two columns where W is even, else
//      plain loads) into two buffers; warpgroup w owns tile rows 4w .. 4w +
//      3 (M = 64 pixels, a warp a row), N = NC; A from registers, two
//      16-bit loads a word at the (tap, k) offsets. dx is rounded from the
//      f32 sums and written as bf16.
//   2. wgrad_kernel: split-K over pixel slices, block = (128 rows of the 9K
//      side, 64 channels, slice s of the 4x16 tiles). Three tiles in flight:
//      x straight into core-matrix order (16-byte copies of 8 pixels of a
//      channel where W % 8 == 0: a K-major B row), g's planes as raw bf16.
//      A tile's four k-steps (one tile row each) sum into fresh registers,
//      added rounded to nearest to the slice's sums (the tensor core's f32
//      sums truncate). db comes from g in the same pass (the first block
//      column). Each block writes part[s] = [dW (K, C, 9) | db (K)].
//   3. bwd::reduce_partials (bwd_common.cuh): the slices added in a fixed
//      order. No atomics: two runs give the same bits.

#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bwd_common.cuh"
#include "card.cuh"
#include "cp_async.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int CARD_SMEM = 233472;       // shared memory of an SM (228 KB)
constexpr int BLOCK_SMEM_MAX = 232448;  // that a block may use (227 KB)
constexpr int THREADS = 256;            // two warpgroups

// k-steps of 16 on the 9K side
__host__ __device__ constexpr int ksteps(int K) { return (9 * K + 15) / 16; }

// A staged g row, raw bf16: columns x0 - 2 .. x0 + TW + 1 (4-byte copies of
// two columns, each wholly in or out of the image where W is even), image
// column x0 - 1 at index 1.
__host__ __device__ constexpr int g_pitch(int tw) { return tw + 4; }

// ---- 1. dx ----
constexpr int DX_TH = 8, DX_TW = 16;    // pixel tile: a warp a row
constexpr int DX_RP = g_pitch(DX_TW);   // 20
constexpr int DX_PS = (DX_TH + 2) * DX_RP;   // 200 bf16 a staged g plane

__host__ __device__ constexpr int dx_smem(int nc, int K) {
  return ksteps(K) * 16 * nc * 2 + 2 * K * DX_PS * 2 + ksteps(K) * 16 * 4;
}

// issues (or, where !vec, makes with plain loads) the copies of the K
// planes' rows y0 - 1 .. y0 + rows (pitch rp, plane ps) into dst
__device__ __forceinline__ void stage_g(const __nv_bfloat16* g, unsigned short* dst, int b, int K,
                                        int H, int W, int y0, int x0, int rows, int rp, int ps,
                                        bool vec, int tid) {
  const long plane = (long)H * W;
  if (vec) {
    const int Q = rp / 2;
    for (int i = tid; i < K * rows * Q; i += THREADS) {
      const int k = i / (rows * Q), e = i - k * (rows * Q), row = e / Q, q = e - row * Q;
      const int y = y0 - 1 + row, x = x0 - 2 + 2 * q;
      const bool ok = y >= 0 && y < H && x >= 0 && x < W;
      cpa::copy4(reinterpret_cast<float*>(dst + k * ps + row * rp + 2 * q),
                 reinterpret_cast<const float*>(ok ? g + ((long)b * K + k) * plane + (long)y * W + x
                                                   : g),
                 ok);
    }
  } else {
    for (int i = tid; i < K * rows * rp; i += THREADS) {
      const int k = i / (rows * rp), e = i - k * (rows * rp), row = e / rp, q = e - row * rp;
      const int y = y0 - 1 + row, x = x0 - 2 + q;
      unsigned short v = 0;
      if (y >= 0 && y < H && x >= 0 && x < W)
        v = *reinterpret_cast<const unsigned short*>(g + ((long)b * K + k) * plane + (long)y * W + x);
      dst[k * ps + row * rp + q] = v;
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(THREADS, 2)
dx_kernel(const __nv_bfloat16* __restrict__ g, const float* __restrict__ w,
          __nv_bfloat16* __restrict__ dxa, __nv_bfloat16* __restrict__ dxb, int B, int H, int W,
          int Ca, int Cb, int K, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nks = ksteps(K);
  // Wm rounded to bf16, [step][NC / 8][2][8][8]: a k-step's 16 x NC as
  // K-major core matrices, 128 bytes apart along K, 256 along N
  unsigned short* wm = reinterpret_cast<unsigned short*>(smem);
  unsigned short* gs = wm + nks * 16 * NC;                        // [2][K][DX_PS]
  int* koff = reinterpret_cast<int*>(gs + 2 * K * DX_PS);         // [16 nks]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int C = Ca + Cb, c0 = blockIdx.x * NC;
  const int tiles_x = (W + DX_TW - 1) / DX_TW, tiles_y = (H + DX_TH - 1) / DX_TH;
  const int per_image = tiles_x * tiles_y, tiles = B * per_image;
  const long plane = (long)H * W;

  // zeros where Wm is padding (rows past 9K, channels past C), then the
  // weights, read in w's own order (k, c, tap): contiguous runs of NC x 9
  for (int i = tid; i < nks * 16 * NC / 2; i += THREADS) reinterpret_cast<uint32_t*>(wm)[i] = 0u;
  __syncthreads();
  const int ncl = min(NC, C - c0);
  for (int i = tid; i < K * ncl * 9; i += THREADS) {
    const int k = i / (ncl * 9), e = i - k * (ncl * 9), c = e / 9, tap = e - c * 9;
    const int kk = tap * K + k, j = kk & 15;
    const __nv_bfloat16 v = __float2bfloat16_rn(__ldg(w + ((long)k * C + c0) * 9 + e));
    wm[(kk >> 4) * 16 * NC + (c >> 3) * 128 + (j >> 3) * 64 + (c & 7) * 8 + (j & 7)] =
        *reinterpret_cast<const unsigned short*>(&v);
  }
  fence_async_smem();
  // offset of (tap, k) from a pixel's place in the staged tile; -1: padding
  for (int kk = tid; kk < nks * 16; kk += THREADS) {
    const int tap = kk / K, k = kk - tap * K;
    koff[kk] = kk < 9 * K ? k * DX_PS + (2 - tap / 3) * DX_RP + (2 - tap % 3) + 1 : -1;
  }

  auto stage = [&](int t, int buf) {
    const int b = t / per_image, r = t - b * per_image;
    stage_g(g, gs + buf * K * DX_PS, b, K, H, W, (r / tiles_x) * DX_TH, (r % tiles_x) * DX_TW,
            DX_TH + 2, DX_RP, DX_PS, vec, tid);
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
    const unsigned short* prow = gs + buf * K * DX_PS + warp * DX_RP + gid;
    float acc[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] = 0.0f;
    // A of k-step s: words of (tap, k) rows 16s + 2 tig, +1 and 16s + 2 tig + 8, +9
    auto frag = [&](int s, uint32_t (&a)[4]) {
      unsigned short v[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = koff[16 * s + 2 * tig + 8 * (q >> 1) + (q & 1)];
        v[q][0] = o >= 0 ? prow[o] : 0;
        v[q][1] = o >= 0 ? prow[o + 8] : 0;
      }
      a[0] = pack_raw(v[0][0], v[1][0]);
      a[1] = pack_raw(v[0][1], v[1][1]);
      a[2] = pack_raw(v[2][0], v[3][0]);
      a[3] = pack_raw(v[2][1], v[3][1]);
    };
    auto mma = [&](int s, const uint32_t (&a)[4]) {
      wgmma_fence();
      wgmma_bf16<NC>(acc, a, kmajor_desc_b16(wm + s * 16 * NC, 128, 256));
      wgmma_commit();
    };
    // two fragment buffers: step s + 2 overwrites step s's once its group is done
    uint32_t a0[4], a1[4];
#pragma unroll 1
    for (int s = 0; s < nks; s += 2) {
      if (s >= 2) {
        wgmma_wait<1>();
        hold(a0);
      }
      frag(s, a0);
      mma(s, a0);
      if (s + 1 < nks) {
        if (s >= 2) {
          wgmma_wait<1>();
          hold(a1);
        }
        frag(s + 1, a1);
        mma(s + 1, a1);
      }
    }
    wgmma_wait<0>();
    hold(acc);
    hold(a0);
    hold(a1);

    // acc[4j + 2h + e]: pixel gid + 8h of tile row `warp`, channel c0 + 8j + 2 tig + e
    const int b = t / per_image, r = t - b * per_image;
    const int y = (r / tiles_x) * DX_TH + warp, x = (r % tiles_x) * DX_TW + gid;
    if (y < H && x < W) {
      const bool x8 = x + 8 < W;
      const long pix = (long)y * W + x;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ce = c0 + 2 * tig + e;
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
          const int c = ce + 8 * j;
          if (c >= C) break;
          __nv_bfloat16* p = (c < Ca ? dxa + ((long)b * Ca + c) * plane
                                     : dxb + ((long)b * Cb + c - Ca) * plane) + pix;
          p[0] = __float2bfloat16_rn(acc[4 * j + e]);
          if (x8) p[8] = __float2bfloat16_rn(acc[4 * j + 2 + e]);
        }
      }
    }
    __syncthreads();   // the buffer is staged again two tiles on
  }
}

// ---- 2. dW and db as per-slice partial sums ----
constexpr int WG_TH = 4, WG_TW = 16;    // pixel tile: 64 pixels, 4 k-steps (a row each)
constexpr int WG_PIX = WG_TH * WG_TW;
constexpr int WG_MR = 128;              // 9K rows a block: a warpgroup a 64
constexpr int WG_NC = 64;               // channels a block
constexpr int WG_XB = WG_NC * WG_PIX;   // bf16 of a staged x tile
constexpr int WG_RP = g_pitch(WG_TW);   // 20
constexpr int WG_PS = (WG_TH + 2) * WG_RP;   // 120 bf16 a staged g plane
constexpr int WG_STAGES = 3;
constexpr int WG_BLOCKS_PER_SM = 2;
constexpr int WG_ZEROS = 4 * WG_RP;     // zeros a padding row reads: a tile's rows

__host__ __device__ constexpr int wg_smem(int K) {
  return WG_STAGES * (WG_XB + K * WG_PS) * 2 + WG_ZEROS * 2 + K * WG_TH * 4;
}

__global__ void __launch_bounds__(THREADS, WG_BLOCKS_PER_SM)
wgrad_kernel(const __nv_bfloat16* __restrict__ xa, const __nv_bfloat16* __restrict__ xb,
             const __nv_bfloat16* __restrict__ g, float* __restrict__ part, int B, int H,
             int W, int Ca, int Cb, int K, int cchunks, bool xvec, bool gvec) {
  extern __shared__ __align__(128) unsigned char wsm[];
  // x of a tile as K-major core matrices of B (N = channels, K = pixels),
  // [NC / 8][WG_PIX / 8][8][8]: 128 bytes apart along the pixels, 1024
  // along the channels; a channel's 8 pixels of a tile row are one row
  unsigned short* xs = reinterpret_cast<unsigned short*>(wsm);   // [WG_STAGES][WG_XB]
  unsigned short* gs = xs + WG_STAGES * WG_XB;                    // [WG_STAGES][K][WG_PS]
  unsigned short* zs = gs + WG_STAGES * K * WG_PS;                      // [WG_ZEROS]
  float* dbs = reinterpret_cast<float*>(zs + WG_ZEROS);                 // [K][WG_TH]

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

  // this thread's A rows m_w + gid + 8h: their (tap, k) offsets in a staged
  // g tile; a padding row (past 9K) reads the zeros after the stages
  int ko[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kk = m_w + gid + 8 * h, tap = kk / K, k = kk - tap * K;
    ko[h] = kk < 9 * K ? k * WG_PS + (2 - tap / 3) * WG_RP + (2 - tap % 3) + 1 : -1;
  }
  for (int i = tid; i < WG_ZEROS; i += THREADS) zs[i] = 0;

  auto stage = [&](int t, int buf) {
    const int b = t / per_image, r = t - b * per_image;
    const int y0 = (r / tiles_x) * WG_TH, x0 = (r % tiles_x) * WG_TW;
    unsigned short* xd = xs + buf * WG_XB;
    // (channel cl, pixel p = 16 row + col) at ((cl / 8) 8 + p / 8) 64 + (cl % 8) 8 + p % 8
    if (xvec) {
      for (int i = tid; i < WG_NC * WG_TH * 2; i += THREADS) {
        const int half = i & 1, row = (i >> 1) % WG_TH, cl = i / (2 * WG_TH);
        const int c = c0 + cl, y = y0 + row, x = x0 + 8 * half;
        const bool ok = c < C && y < H && x < W;
        const __nv_bfloat16* src = xa;
        if (ok)
          src = (c < Ca ? xa + ((long)b * Ca + c) * plane : xb + ((long)b * Cb + (c - Ca)) * plane)
                + (long)y * W + x;
        cpa::copy16(xd + ((cl >> 3) * 8 + 2 * row + half) * 64 + (cl & 7) * 8, src, ok);
      }
    } else {
      for (int i = tid; i < WG_NC * WG_PIX; i += THREADS) {
        const int p = i % WG_PIX, cl = i / WG_PIX;
        const int c = c0 + cl, y = y0 + p / WG_TW, x = x0 + p % WG_TW;
        unsigned short v = 0;
        if (c < C && y < H && x < W)
          v = *reinterpret_cast<const unsigned short*>(
              (c < Ca ? xa + ((long)b * Ca + c) * plane : xb + ((long)b * Cb + (c - Ca)) * plane)
              + (long)y * W + x);
        xd[((cl >> 3) * 8 + (p >> 3)) * 64 + (cl & 7) * 8 + (p & 7)] = v;
      }
    }
    stage_g(g, gs + buf * K * WG_PS, b, K, H, W, y0, x0, WG_TH + 2, WG_RP, WG_PS, gvec, tid);
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
    fence_async_smem();
    __syncthreads();
    const unsigned short* xb_s = xs + buf * WG_XB;
    const unsigned short* gb = gs + buf * K * WG_PS;
    if (with_db && tid < K * WG_TH) {
      const unsigned short* row = gb + (tid / WG_TH) * WG_PS + (tid % WG_TH + 1) * WG_RP + 2;
#pragma unroll
      for (int col = 0; col < WG_TW; ++col) dbsum += __uint_as_float((uint32_t)row[col] << 16);
    }
    if (live) {
      float acc[WG_NC / 2];
#pragma unroll
      for (int i = 0; i < WG_NC / 2; ++i) acc[i] = 0.0f;
      // rows gid and gid + 8 of this warp's A (offsets from the staged
      // tiles' start; a padding row reads the zeros): columns 2 tig, +1 and
      // 2 tig + 8, +9 are pixels of tile row q
      const int gofs = buf * K * WG_PS + 2 * tig, zofs = WG_STAGES * K * WG_PS + 2 * tig;
      const unsigned short* r0 = gs + (ko[0] >= 0 ? gofs + ko[0] : zofs);
      const unsigned short* r1 = gs + (ko[1] >= 0 ? gofs + ko[1] : zofs);
      // one fragment buffer (registers are this kernel's limit): a k-step's
      // A is built once the previous product has read it
      uint32_t a[4];
#pragma unroll
      for (int q = 0; q < WG_TH; ++q) {
        const int pb = q * WG_RP;
        if (q > 0) {
          wgmma_wait<0>();
          hold(a);
        }
        a[0] = pack_raw(r0[pb], r0[pb + 1]);
        a[1] = pack_raw(r1[pb], r1[pb + 1]);
        a[2] = pack_raw(r0[pb + 8], r0[pb + 9]);
        a[3] = pack_raw(r1[pb + 8], r1[pb + 9]);
        wgmma_fence();
        wgmma_bf16<WG_NC>(acc, a, kmajor_desc_b16(xb_s + 2 * q * 64, 128, 1024));
        wgmma_commit();
      }
      wgmma_wait<0>();
      hold(acc);
      hold(a);
#pragma unroll
      for (int i = 0; i < WG_NC / 2; ++i) total[i] += acc[i];
    }
    __syncthreads();   // the buffers are staged again
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

// The launch geometry, mirrored by ops/kernels/small_conv3x3.py's bwd_plan_bf16.
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

bool aligned(const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

template <int NC>
cudaError_t launch_dx(const Plan& p, const __nv_bfloat16* g, const float* w, __nv_bfloat16* dxa,
                      __nv_bfloat16* dxb, int B, int H, int W, int Ca, int Cb, int K, bool vec,
                      cudaStream_t s) {
  const cudaError_t err =
      cudaFuncSetAttribute(dx_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.dx_smem);
  if (err != cudaSuccess) return err;
  dx_kernel<NC><<<dim3(p.dx_chunks, p.dx_blocks), THREADS, p.dx_smem, s>>>(
      g, w, dxa, dxb, B, H, W, Ca, Cb, K, vec);
  return cudaSuccess;
}

}  // namespace

// Floats of scratch small_conv3x3_bwd_bf16 needs (-1 if the card cannot be
// asked for its SM count).
extern "C" long long small_conv3x3_bwd_bf16_scratch_floats(int B, int H, int W, int Ca,
                                                           int Cb, int K) {
  int sms = 0;
  if (card_sms(&sms) != cudaSuccess) return -1;
  const Plan p = plan(B, H, W, Ca + Cb, K, sms);
  return partial_floats(p, Ca + Cb, K)
      + bwd::reduce_scratch_floats(p.slices, K * (Ca + Cb) * 9 + K);
}

// g (B, K, H, W), xa (B, Ca, H, W), xb (B, Cb, H, W) bf16; w (K, Ca + Cb,
// 3, 3) f32. Writes dxa and dxb (bf16, as xa and xb) and dwb = [dW (K, Ca +
// Cb, 3, 3) | db (K)] (f32). Returns cudaGetLastError() after the last
// launch (cudaErrorInvalidValue, with no launch, unless 1 <= K <= 32).
extern "C" int small_conv3x3_bwd_bf16(const __nv_bfloat16* g, const __nv_bfloat16* xa,
                                      const __nv_bfloat16* xb, const float* w,
                                      __nv_bfloat16* dxa, __nv_bfloat16* dxb, float* dwb,
                                      float* scratch, int B, int H, int W, int Ca, int Cb,
                                      int K, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K < 1 || K > 32 || B < 1 || H < 1 || W < 1 || Ca + Cb < 1)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = card_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const int C = Ca + Cb;
  const Plan p = plan(B, H, W, C, K, sms);
  if (p.dx_smem > BLOCK_SMEM_MAX) return (int)cudaErrorInvalidValue;
  // 4-byte copies of g's column pairs where W is even; 16-byte copies of
  // x's 8 pixels where W % 8 == 0
  const bool gvec = W % 2 == 0 && aligned(g, 4);
  const bool xvec = W % 8 == 0 && aligned(xa, 16) && aligned(xb, 16);
  err = p.dx_nc == 128 ? launch_dx<128>(p, g, w, dxa, dxb, B, H, W, Ca, Cb, K, gvec, s)
                       : launch_dx<64>(p, g, w, dxa, dxb, B, H, W, Ca, Cb, K, gvec, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.wg_smem);
  if (err != cudaSuccess) return (int)err;
  wgrad_kernel<<<dim3(p.mchunks * p.cchunks, p.slices), THREADS, p.wg_smem, s>>>(
      xa, xb, g, scratch, B, H, W, Ca, Cb, K, p.cchunks, xvec, gvec);
  bwd::reduce_partials(scratch, p.slices, K * C * 9 + K, dwb,
                       scratch + partial_floats(p, C, K), s);
  return (int)cudaGetLastError();
}

// K2-bf16: the decode_aff tail, deconv2(relu(deconv1(x))), on bf16
// operands and the bf16 tensor cores, rounding where the TPU kernel rounds:
//
//   x   (B, Hg, Wg, C) bf16, NHWC           C = 2 * GRU_hidden_dim (256)
//   w1  (C, 16, 3, 3), b1 (16) f32          rounded to bf16 here
//   w2  (16, K, 3, 3), b2 (K) f32           K = prop_kernel^2 - 1 (8 or 24)
//   y1  = bf16(relu(deconv1(x) + b1)), zero outside the 2Hg x 2Wg image
//   out = bf16(deconv2(y1) + b2)            (B, K, 4Hg, 4Wg), planar f32
//
// each sum in f32, each rounding once after its full sum (y1 after its bias
// and ReLU, out after its bias).
//
// Replaces the TPU kernel nlspn_eccv20_tpu/ops/pallas/dec_aff_tail.py:284
// _fwd_kernel at dt = bfloat16, reached from _fwd_pallas :433. It computes
// y1 as four shifted matmuls of x (_shift_matmul_sum) and out as four of
// y1, both with f32 sums (preferred_element_type), and rounds each once.
// The first form (dec_aff_tail.cu at T = bf16) widened x to f32 and ran the
// f32 design's FMAs: 236 us at b=12 of 58x76, 15x its bound.
//
// Bound on the card: bytes. At b=12 of 58x76 (C = 256, K = 8) x is 27 MB
// in bf16 and out 27 MB in f32 (41 MB more with y1 written, as training
// does): 16 us of HBM at 3.35 TB/s, against 3.8 GFLOP of deconv1 (4 us on
// the bf16 tensor cores) and 0.3 of deconv2. The design:
//  - One 8x16 tile of the base grid a CTA of three warpgroups. deconv1 is
//    quad_mma.cuh's GEMM: M = base pixels, a warpgroup's M-tile 64 of them
//    (warpgroups 0 and 1 the tile's rows 0-3 and 4-7), N = 64 (four phases
//    x 16 m, four products of N 64/32/32/16 a k-step: no structural zeros).
//    deconv2 needs one more row and column of y1 than the tile owns (rows
//    and columns 2TH and 2TW, even ones: phases (0, *) of base row TH,
//    (*, 0) of base column TW); warpgroup 2 computes them as a third M-tile
//    of those 25 base pixels (rows past them read a zero row), so no
//    halo is exchanged between CTAs.
//  - x comes raw, in chunks of 32 channels, by 16-byte cp.async copies into
//    two buffers (the next chunk's copies in flight while this one is
//    multiplied), one 80-byte row a pixel so that ldmatrix's eight rows
//    fall in distinct banks; A is read by ldmatrix at each shift's pixel
//    offset: no widening, no im2col. The weights come with each chunk, laid
//    out once a call by quad::prep_kernel as the K-major B operands.
//  - With one CTA a tile, the bias, ReLU, image mask and bf16 rounding of
//    y1 are applied to the accumulators in registers, into a bf16 tile
//    [row][col][16 m] (48-byte pixels: ldmatrix's eight rows in distinct
//    banks) and, for training, straight to y1 in device memory. A cluster
//    of S CTAs shares a tile (cudaLaunchKernelEx, cluster
//    dimension S) when the tiles do not fill the card: each sums 1/S of the
//    chunks, writes its f32 partial y1 tile [16][17][33] where the chunks
//    were, and after cluster.sync() adds the S partials of its 2TH/S rows
//    of y1 (and the halo row) through distributed shared memory in rank
//    order (the same bits every run), then the same bias, ReLU, mask and
//    rounding into its bf16 tile. plan() picks the
//    largest S whose CTAs all fit one wave of one CTA an SM: 2 at b=1 of
//    64x80 (40 tiles: 80 CTAs of four chunks each; S = 4 would leave 28 of
//    160 CTAs to a second wave), 1 at b=12 of 58x76.
//  - deconv2 on the tensor cores from that tile: M = y1 pixels (an M-tile
//    two rows of 32), K = 16 m a shift, N = 4K columns ordered (dy, k, dx),
//    the four shifts' products with their structural zeros (0.3 GFLOP). A
//    thread's two adjacent columns are one output's dx = 0, 1: each store
//    is a float2 of out, and a warp's stores are whole 32-byte sectors of
//    four channel rows. The bias is added in f32, then the rounding.
//  - y1 for training (B, 16, 2Hg, 2Wg) f32 holding bf16 values, the layout
//    K4-bf16 reads: from the registers with one CTA a tile, else from the
//    bf16 tile by rows.
// Rounding points as the TPU kernel's; the tensor cores sum in another
// order than the plain version (decode_aff_tail_plain_bf16), so a few
// outputs in ten thousand round to the neighbouring bf16 value.
// A persistent form (one CTA an SM walking the tiles, its weights laid out
// once in shared memory from f32, a ring of four chunks across tiles) ran
// slower on the H100: its in-block weight layout cost more than the waves
// it saved.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "card.cuh"
#include "cp_async.cuh"
#include "quad_mma.cuh"
#include "wgmma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int M = quad::M;                 // deconv1 output channels
constexpr int TH = 8, TW = 16;             // base-grid tile rows and cols
constexpr int XR = TH + 1, XC = TW + 1;    // x tile rows and cols staged
constexpr int XPIX = XR * XC;              // 153 pixels
constexpr int CC = 32;                     // channels a chunk: two k-steps
constexpr int CP = CC + 8;                 // bf16 a staged pixel: 80 bytes
constexpr int NT = 384;                    // three warpgroups
constexpr int X_BYTES = XPIX * CP * 2;     // 12,240
constexpr int W_BYTES = 2 * quad::KSTEP_BF16 * 2;   // 9,216: a chunk's B
constexpr int STAGE = X_BYTES + W_BYTES;
constexpr int YR = 2 * TH + 1, YC = 2 * TW + 1;     // y1 tile with its halo
constexpr int PART_BYTES = M * YR * YC * 4;         // f32 partial [m][YR][YC]
constexpr int REGION = 2 * STAGE > PART_BYTES ? 2 * STAGE : PART_BYTES;
constexpr int YP = 24;                     // bf16 a y1 pixel: 48 bytes
constexpr int Y1_BYTES = YR * YC * YP * 2;
constexpr int ZERO_BF16 = CP;              // the zero row past the tile
constexpr int SPLITS_MAX = 8;
static_assert(X_BYTES % 16 == 0 && STAGE % 16 == 0 && REGION % 16 == 0 &&
              Y1_BYTES % 16 == 0, "16-byte aligned regions");

template <int K>
__host__ __device__ constexpr int w2_bf16() { return 4 * M * 4 * K; }   // four shifts' B, 16 x 4K each
template <int K>
__host__ __device__ constexpr int smem_bytes() { return REGION + Y1_BYTES + 2 * w2_bf16<K>() + 2 * ZERO_BF16; }

__device__ __forceinline__ float rnd_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// tap index along one axis of a k3/s2/p1/op1 transposed conv for output
// parity d from input shift s: out[2j] = W[1] a[j], out[2j + 1] = W[2] a[j]
// + W[0] a[j + 1]; -1 where the shift does not feed the parity
__host__ __device__ constexpr int axis_tap(int d, int s) {
  return d == 0 ? (s == 0 ? 1 : -1) : (s == 0 ? 2 : 0);
}

// w2p[shift][...]: deconv2's B of each shift (sy, sx) = (s / 2, s % 2), 16
// (m) x 4K columns n = 2K dy + 2k + dx, as K-major core matrices
// (quad::kmajor), rounded to bf16; zero where the shift does not feed
// phase (dy, dx)
template <int K>
__global__ void __launch_bounds__(256)
prep_w2_kernel(const float* __restrict__ w2, __nv_bfloat16* __restrict__ w2p) {
  constexpr int N2 = 4 * K;
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= 4 * M * N2) return;
  const int s = i / (M * N2), r = i % (M * N2), n = r / M, m = r % M;
  const int dy = n / (2 * K), k = (n % (2 * K)) / 2, dx = n & 1;
  const int ty = axis_tap(dy, s >> 1), tx = axis_tap(dx, s & 1);
  const float v = ty >= 0 && tx >= 0 ? __ldg(w2 + (m * K + k) * 9 + 3 * ty + tx) : 0.0f;
  w2p[s * M * N2 + quad::kmajor(n, m)] = __float2bfloat16_rn(v);
}

// The base pixel (i, j) of M-tile row rr of warp wr in warpgroup wg: rows
// 4 wg + wr of the tile for warpgroups 0 and 1; for warpgroup 2 the halo,
// h = 16 wr + rr: (TH, h) for h <= TW, then (h - TW - 1, TW); none past.
__device__ __forceinline__ void m_row_pixel(int wg, int wr, int rr, int& i, int& j) {
  if (wg < 2) {
    i = 4 * wg + wr;
    j = rr;
    return;
  }
  const int h = 16 * wr + rr;
  i = h <= TW ? TH : h < TW + 1 + TH ? h - TW - 1 : -1;
  j = h <= TW ? h : TW;
}

template <int K, int S>
__global__ void __launch_bounds__(NT, 1)
dec_aff_tail_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ wp1, const float* __restrict__ b1,
                         const __nv_bfloat16* __restrict__ wp2, const float* __restrict__ b2,
                         float* __restrict__ out, float* __restrict__ y1out, int Hg, int Wg,
                         int C) {
  static_assert(K % 8 == 0 && (2 * TH) % (2 * S) == 0, "K in blocks of 8; rows split evenly");
  constexpr int N2 = 4 * K;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned short* y1s = reinterpret_cast<unsigned short*>(smem + REGION);   // [YR][YC][YP]
  unsigned short* w2s = y1s + Y1_BYTES / 2;
  unsigned short* zero = w2s + w2_bf16<K>();
  __shared__ float rb1[M], rb2[K];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3, wg = warp >> 2, wr = warp & 3;
  int rank = 0;
  if constexpr (S > 1) rank = (int)cg::this_cluster().block_rank();
  const int b = blockIdx.z;
  const int a0 = blockIdx.y * TH, t0 = (blockIdx.x / S) * TW;
  const int nchunks = (C + CC - 1) / CC;
  const int k0 = rank * nchunks / S, k1 = (rank + 1) * nchunks / S;
  const bool vec = (C & 7) == 0 && (reinterpret_cast<size_t>(x) & 15) == 0;
  const __nv_bfloat16* xb = x + (long)b * Hg * Wg * C;

  // issues the copies of chunk kc (the x tile, its B) into buffer buf
  auto stage = [&](int kc, int buf) {
    unsigned char* base = smem + buf * STAGE;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base);
    const int c0 = kc * CC;
    if (vec) {   // 16-byte copies of 8 channels, each wholly in or out
      for (int e = tid; e < XPIX * (CC / 8); e += NT) {
        const int pix = e >> 2, q = e & 3;
        const int gy = a0 + pix / XC, gx = t0 + pix % XC, ch = c0 + 8 * q;
        const bool ok = gy < Hg && gx < Wg && ch < C;
        cpa::copy16(xs + pix * CP + 8 * q, ok ? xb + ((long)gy * Wg + gx) * C + ch : x, ok);
      }
    } else {     // plain loads: the buffer is not read before the next barrier
      for (int e = tid; e < XPIX * CC; e += NT) {
        const int pix = e / CC, cc = e % CC;
        const int gy = a0 + pix / XC, gx = t0 + pix % XC, ch = c0 + cc;
        xs[pix * CP + cc] = gy < Hg && gx < Wg && ch < C ? xb[((long)gy * Wg + gx) * C + ch]
                                                         : __float2bfloat16_rn(0.0f);
      }
    }
    const uint4* wsrc = reinterpret_cast<const uint4*>(wp1 + (long)kc * 2 * quad::KSTEP_BF16);
    uint4* wdst = reinterpret_cast<uint4*>(base + X_BYTES);
    for (int e = tid; e < W_BYTES / 16; e += NT) cpa::copy16(wdst + e, wsrc + e, true);
  };

  if (k0 < k1) stage(k0, 0);
  for (int e = tid; e < w2_bf16<K>() / 8; e += NT)
    cpa::copy16(reinterpret_cast<uint4*>(w2s) + e, reinterpret_cast<const uint4*>(wp2) + e, true);
  cpa::commit();
  if (tid < ZERO_BF16 / 2) reinterpret_cast<uint32_t*>(zero)[tid] = 0u;
  if (tid < M) rb1[tid] = rnd_bf16(__ldg(b1 + tid));
  if (tid >= 32 && tid < 32 + K) rb2[tid - 32] = rnd_bf16(__ldg(b2 + tid - 32));

  // ---- deconv1: this lane's ldmatrix row (M-tile row r, channels koff
  // on) at each shift, as a bf16 offset into a stage, or -1: the zero row
  const int r = (lane & 7) + 8 * ((lane >> 3) & 1), koff = 8 * (lane >> 4);
  int aoff[4];
  {
    int pi, pj;
    m_row_pixel(wg, wr, r, pi, pj);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int py = pi + (s >> 1), px = pj + (s & 1);
      aoff[s] = pi >= 0 && py < XR && px < XC ? (py * XC + px) * CP + koff : -1;
    }
  }
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.0f;

  for (int kc = k0; kc < k1; ++kc) {
    const int buf = (kc - k0) & 1;
    if (kc + 1 < k1) {
      stage(kc + 1, buf ^ 1);
      cpa::commit();
      cpa::wait<1>();
    } else {
      cpa::wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(smem + buf * STAGE);
    const unsigned short* ws = reinterpret_cast<const unsigned short*>(smem + buf * STAGE + X_BYTES);
    uint32_t a[2][4][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        ldmatrix_x4(a[ks][s], aoff[s] >= 0 ? xs + aoff[s] + quad::KSTEP * ks : zero + koff);
    wgmma_fence();
    quad::mma_kstep(acc, a[0], ws);
    quad::mma_kstep(acc, a[1], ws + quad::KSTEP_BF16);
    wgmma_commit();
    wgmma_wait<0>();
    hold(acc);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int s = 0; s < 4; ++s) hold(a[ks][s]);
    __syncthreads();   // the buffer is restaged two chunks on
  }
  cpa::wait<0>();      // w2's copies, where this CTA had no chunk
  fence_async_smem();

  constexpr int NR = 2 * TH / S;   // y1 rows this CTA finishes, and one
  const int v0 = rank * NR;
  if constexpr (S == 1) {
    // ---- one CTA a tile: y1 straight from the accumulators (bias, ReLU,
    // zero outside the image, bf16) into the bf16 tile, and the owned
    // positions into y1out. acc[4j + 2h + e] is M-tile row gid + 8h, phase
    // block j / 2, m = 8 (j % 2) + 2 tig + e; the halo rows keep the phases
    // inside the 17 x 33 tile ----
    const int H1 = 2 * Hg, W1 = 2 * Wg;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int pi, pj;
      m_row_pixel(wg, wr, gid + 8 * h, pi, pj);
      if (pi < 0) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int v = 2 * pi + quad::phase_dy(j >> 1), u = 2 * pj + quad::phase_dx(j >> 1);
        if (v >= YR || u >= YC) continue;
        const int m = 8 * (j & 1) + 2 * tig, gy = 2 * a0 + v, gx = 2 * t0 + u;
        const bool in = gy < H1 && gx < W1;
        const float ya = in ? fmaxf(acc[4 * j + 2 * h] + rb1[m], 0.0f) : 0.0f;
        const float yb = in ? fmaxf(acc[4 * j + 2 * h + 1] + rb1[m + 1], 0.0f) : 0.0f;
        const uint32_t word = pack_bf16(ya, yb);
        *reinterpret_cast<uint32_t*>(y1s + (v * YC + u) * YP + m) = word;
        if (y1out && in && v < 2 * TH && u < 2 * TW) {
          float* dst = y1out + (((long)b * M + m) * H1 + gy) * W1 + gx;
          dst[0] = __uint_as_float(word << 16);
          dst[(long)H1 * W1] = __uint_as_float(word & 0xffff0000u);
        }
      }
    }
    __syncthreads();
  } else {
    float* part = reinterpret_cast<float*>(smem);   // [M][YR][YC], where the chunks were
    // ---- the partial y1 tile: acc[4j + 2h + e] is M-tile row gid + 8h,
    // phase block j / 2, m = 8 (j % 2) + 2 tig + e; the halo rows keep the
    // phases inside the 17 x 33 tile ----
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int pi, pj;
      m_row_pixel(wg, wr, gid + 8 * h, pi, pj);
      if (pi < 0) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int v = 2 * pi + quad::phase_dy(j >> 1), u = 2 * pj + quad::phase_dx(j >> 1);
        if (v >= YR || u >= YC) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          part[((8 * (j & 1) + 2 * tig + e) * YR + v) * YC + u] = acc[4 * j + 2 * h + e];
      }
    }

    // ---- y1 rows v0 .. v0 + NR (the last one deconv2's halo): the S
    // partials in rank order, bias, ReLU, zero outside the image, bf16 ----
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int e = tid; e < (NR + 1) * YC * M; e += NT) {
      const int m = e % M, u = (e / M) % YC, v = e / (M * YC);
      const int src = (m * YR + v0 + v) * YC + u;
      float sum = cluster.map_shared_rank(part, 0)[src];
#pragma unroll
      for (int q = 1; q < S; ++q) sum += cluster.map_shared_rank(part, q)[src];
      const bool in = 2 * a0 + v0 + v < 2 * Hg && 2 * t0 + u < 2 * Wg;
      reinterpret_cast<__nv_bfloat16*>(y1s)[(v * YC + u) * YP + m] =
          __float2bfloat16_rn(in ? fmaxf(sum + rb1[m], 0.0f) : 0.0f);
    }
    cluster.sync();   // the peers' reads done too

    if (y1out) {   // the owned rows, coalesced along the columns
      const int H1 = 2 * Hg, W1 = 2 * Wg;
      const __nv_bfloat16* yv = reinterpret_cast<const __nv_bfloat16*>(y1s);
      for (int e = tid; e < M * NR * 2 * TW; e += NT) {
        const int u = e % (2 * TW), v = (e / (2 * TW)) % NR, m = e / (2 * TW * NR);
        const int gy = 2 * a0 + v0 + v, gx = 2 * t0 + u;
        if (gy < H1 && gx < W1)
          y1out[(((long)b * M + m) * H1 + gy) * W1 + gx] =
              __bfloat162float(yv[(v * YC + u) * YP + m]);
      }
    }
  }

  // ---- deconv2: an M-tile is two y1 rows of 32 columns, a warp 16 of a
  // row; o[4j + 2h + e] is column (gid + 8h) of the warp's run, output
  // channel k = 4 (j % (K / 4)) + tig, phase dy = j / (K / 4), dx = e ----
  const int Ho = 4 * Hg, Wo = 4 * Wg;
  for (int t = wg; t < NR / 2; t += NT / 128) {
    const int vl = 2 * t + (wr >> 1), ul = 16 * (wr & 1);
    uint32_t a2[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
      ldmatrix_x4(a2[s], y1s + ((vl + (s >> 1)) * YC + ul + r + (s & 1)) * YP + koff);
    float o[N2 / 2];
#pragma unroll
    for (int e = 0; e < N2 / 2; ++e) o[e] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma_bf16<N2>(o, a2[s], kmajor_desc_b16(w2s + s * M * N2, 128, 256));
    wgmma_commit();
    wgmma_wait<0>();
    hold(o);
#pragma unroll
    for (int s = 0; s < 4; ++s) hold(a2[s]);
    const int gy0 = 4 * a0 + 2 * (v0 + vl);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = 2 * t0 + ul + gid + 8 * h;   // the y1 column
      if (u >= 2 * Wg) continue;
#pragma unroll
      for (int j = 0; j < N2 / 8; ++j) {
        const int dy = j / (K / 4), k = 4 * (j % (K / 4)) + tig;
        if (gy0 + dy >= Ho) continue;
        *reinterpret_cast<float2*>(out + (((long)b * K + k) * Ho + gy0 + dy) * Wo + 2 * u) =
            make_float2(rnd_bf16(o[4 * j + 2 * h] + rb2[k]),
                        rnd_bf16(o[4 * j + 2 * h + 1] + rb2[k]));
      }
    }
  }
}

struct Plan {
  int tiles_y, tiles_x, split, threads, smem, chunks;
};

// The grid: 8x16 tiles of the base grid, and the cluster size S, the
// largest of 1, 2, 4, 8 whose CTAs (S a tile) all fit one wave of one CTA
// an SM, at most one a chunk of 32 channels.
Plan plan(int B, int Hg, int Wg, int C, int K, int sms) {
  Plan p;
  p.tiles_y = (Hg + TH - 1) / TH;
  p.tiles_x = (Wg + TW - 1) / TW;
  p.chunks = (C + CC - 1) / CC;
  p.split = 1;
  while (2 * p.split <= SPLITS_MAX && (long)B * p.tiles_y * p.tiles_x * 2 * p.split <= sms &&
         2 * p.split <= p.chunks)
    p.split *= 2;
  p.threads = NT;
  p.smem = K == 8 ? smem_bytes<8>() : smem_bytes<24>();
  return p;
}

// bytes of scratch: w1 as quad_mma's B of every k-step (two a chunk), then
// w2 as deconv2's four B
long long scratch_bytes(int C, int K) {
  return (long long)2 * ((C + CC - 1) / CC) * quad::KSTEP_BF16 * 2 + 4LL * M * 4 * K * 2;
}

template <int K, int S>
int launch(const __nv_bfloat16* x, const __nv_bfloat16* wp1, const float* b1,
           const __nv_bfloat16* wp2, const float* b2, float* out, float* y1,
           const Plan& p, int B, int Hg, int Wg, int C, cudaStream_t stream) {
  auto kernel = dec_aff_tail_bf16_kernel<K, S>;
  const cudaError_t e0 = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<K>());
  if (e0 != cudaSuccess) return (int)e0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.tiles_x * S, p.tiles_y, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes<K>();
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = S;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = S > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, wp1, b1, wp2, b2, out, y1,
                                           Hg, Wg, C);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <int K>
int launch_k(const Plan& p, const __nv_bfloat16* x, const __nv_bfloat16* wp1,
             const float* b1, const __nv_bfloat16* wp2, const float* b2, float* out,
             float* y1, int B, int Hg, int Wg, int C, cudaStream_t s) {
  switch (p.split) {
    case 1: return launch<K, 1>(x, wp1, b1, wp2, b2, out, y1, p, B, Hg, Wg, C, s);
    case 2: return launch<K, 2>(x, wp1, b1, wp2, b2, out, y1, p, B, Hg, Wg, C, s);
    case 4: return launch<K, 4>(x, wp1, b1, wp2, b2, out, y1, p, B, Hg, Wg, C, s);
    case 8: return launch<K, 8>(x, wp1, b1, wp2, b2, out, y1, p, B, Hg, Wg, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K2-bf16's launch plan on a card with sms SMs, as dec_aff_tail_bf16 takes
// it: out[0..5] = tile rows, tile cols, cluster size S, threads a CTA,
// bytes of dynamic shared memory, chunks of 32 channels. Returns 0, or
// cudaErrorInvalidValue for a K other than 8 or 24.
extern "C" int dec_aff_tail_bf16_plan(int B, int Hg, int Wg, int C, int K, int sms, int* out) {
  if (K != 8 && K != 24) return (int)cudaErrorInvalidValue;
  const Plan p = plan(B, Hg, Wg, C, K, sms);
  const int v[6] = {p.tiles_y, p.tiles_x, p.split, p.threads, p.smem, p.chunks};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// Bytes of scratch dec_aff_tail_bf16 needs (16-byte aligned).
extern "C" long long dec_aff_tail_bf16_scratch_bytes(int C, int K) {
  return scratch_bytes(C, K);
}

// x (B, Hg, Wg, C) bf16 NHWC; w1 (C, 16, 3, 3), b1 (16), w2 (16, K, 3, 3),
// b2 (K) f32; out (B, K, 4Hg, 4Wg) f32 holding bf16 values; y1 (B, 16, 2Hg,
// 2Wg) f32 holding bf16 values, or null (not written). K must be 8 or 24.
// Returns cudaGetLastError() after the last launch.
extern "C" int dec_aff_tail_bf16(const __nv_bfloat16* x, const float* w1, const float* b1,
                                 const float* w2, const float* b2, float* out, float* y1,
                                 void* scratch, int B, int Hg, int Wg, int C, int K,
                                 void* stream) {
  if (K != 8 && K != 24) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int sms = 0;
  const cudaError_t err = card_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const Plan p = plan(B, Hg, Wg, C, K, sms);
  __nv_bfloat16* wp1 = reinterpret_cast<__nv_bfloat16*>(scratch);
  __nv_bfloat16* wp2 = wp1 + (long)2 * p.chunks * quad::KSTEP_BF16;
  quad::prep(w1, wp1, C, 2 * p.chunks, s);
  if (K == 8) {
    prep_w2_kernel<8><<<(4 * M * 32 + 255) / 256, 256, 0, s>>>(w2, wp2);
    return launch_k<8>(p, x, wp1, b1, wp2, b2, out, y1, B, Hg, Wg, C, s);
  }
  prep_w2_kernel<24><<<(4 * M * 96 + 255) / 256, 256, 0, s>>>(w2, wp2);
  return launch_k<24>(p, x, wp1, b1, wp2, b2, out, y1, B, Hg, Wg, C, s);
}

// The decode_aff tail: deconv2(relu(deconv1(x))), both ConvTranspose2d
// k3/s2/p1/output_padding 1, with the 16-channel intermediate kept on chip.
//
// Replaces the TPU kernel nlspn_eccv20_tpu/ops/pallas/dec_aff_tail.py:284
// _fwd_kernel, reached from _fwd_pallas :433.
//
//   x   (B, Hg, Wg, C) f32, NHWC            C = 2 * GRU_hidden_dim (256)
//   w1  (C, 16, 3, 3), b1 (16)              torch ConvTranspose2d layout
//   w2  (16, K, 3, 3), b2 (K)               K = prop_kernel^2 - 1 (8 or 24)
//   out (B, K, 4Hg, 4Wg) f32, planar
//
// One axis of a k3/s2/p1/op1 transposed conv is
//   out[2j] = W[1] x[j],   out[2j+1] = W[0] x[j+1] + W[2] x[j]
// so each input pixel x[j][i] and its right/lower neighbours give one 2x2
// quad of outputs using all nine taps exactly once. Both deconvs are
// computed quad by quad: no thread ever branches on an output's parity.
//
// Bound on the card: operations (deconv1 is 3.8 of the 4.3 GFLOP at the
// train step's b=12; 55 MB read, 41 MB written). A direct kernel is held
// back by the loads that feed the FMAs, by staging that does not overlap
// them, by the recompute of a halo and by a grid that leaves SMs idle at
// b=1. The design, block by block:
//  - One 8x16 tile of the base grid a CTA of 128 threads: four warps, each
//    owning four of deconv1's 16 channels for all of the tile's 128 quads
//    (a lane: 4 quads of a row x 4 pixels x 4 channels, 64 accumulators;
//    128 registers, four CTAs an SM). A warp's weights are the same for all
//    its lanes, so each of the 9 float4 weight loads a channel is one
//    broadcast; the 10 x loads a channel hit 32 banks (x_row's skew). 144
//    FMAs a channel for 19 loads.
//  - The halo: deconv2 needs one more row and column of y1 than the tile
//    owns. These are even rows and columns of y1, 1 or 2 taps a pixel, so
//    lanes 0-24 also compute them (12 FMAs a channel), not a ring of full
//    quads: 1.08x of the tile's FMAs instead of 1.20x.
//  - x and w1 come in stages of 16 channels through cp.async into two
//    buffers, the next stage's copies in flight while this one computes;
//    w1 is copied as it lies in device memory (the 36 floats of a warp's
//    four channels of one input channel are 9 aligned float4s), x into
//    channel planes by 4-byte copies whose addresses step from pixel to
//    pixel (no division or 64-bit product a copy).
//  - A cluster of S CTAs shares a tile (cudaLaunchKernelEx, cluster
//    dimension S): each runs deconv1 over its share of the channel stages,
//    writes its partial y1 tile into its shared memory, and after
//    cluster.sync() adds the S partials of its share of y1's rows through
//    distributed shared memory in rank order (the same bits every run),
//    with bias, ReLU and the image mask. The wrapper picks S (1, 2, 4 or 8)
//    so that the grid fills the card: 8 at b=1 of 256x320, 1 at b=12.
//  - deconv2: each CTA writes the output rows of its share of y1's rows; a
//    warp takes one y1 row (a lane: one quad x 4 output channels) and one
//    group of 4 of the K output channels, whose weights it broadcasts;
//    items are spread evenly over the warps at K = 8 and K = 24. Stores
//    are coalesced float2 pairs.
// Where its time goes at b=12 (throwaway variants with a part cut out,
// timed on the card): the main FMAs first, then the staging copies, the
// halo and deconv2.
// The TPU kernel's phase decomposition into shifted matmuls, its one-hot
// interleave matmuls and its 128-lane padding are Mosaic devices and are
// not carried over. Plain f32 FMAs: no tensor cores.
//
// For training the caller may pass y1 (B, 16, 2Hg, 2Wg): each CTA then
// also writes the rows of the intermediate it owns (without the halo), and
// the backward (dec_aff_tail_bwd.cu) reads it instead of recomputing
// deconv1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int M = 16;            // deconv1 output channels
constexpr int TH = 8;            // base-grid tile rows
constexpr int TW = 16;           // base-grid tile cols
constexpr int P = 4;             // deconv1 quads per lane, along a row
constexpr int NT = 128;          // threads: a warp per group of 4 channels of y1
constexpr int CC = 16;           // input channels a stage
constexpr int XR = TH + 1;       // x tile rows and cols the tile reads
constexpr int XC = TW + 1;
constexpr int XP = 177;          // x plane pitch: x_row(XR - 1) + XC, odd
constexpr int YR = 2 * TH + 1;   // y1 tile rows and cols, with the halo
constexpr int YC = 2 * TW + 1;
constexpr int WS = 9 * M;        // w1 floats an input channel
constexpr int STAGE = CC * XP + CC * WS;   // one stage: x planes, then w1
constexpr int REGION = 2 * STAGE;          // two stages, later the y1 tile
static_assert(M * YR * YC <= REGION, "the y1 tile fits where the stages were");
static_assert((CC * XP) % 4 == 0 && STAGE % 4 == 0, "w1 stages 16-byte aligned");
static_assert(P * 4 == TW && (TH * TW / P) == 32, "a warp's lanes cover the tile");
static_assert(NT / CC < XC, "the x copy loop wraps a row at most once a step");

// Offset of row r in a staged x plane: rows 4 apart sit 16 banks apart, so
// the 32 lanes' reads (8 rows x 4 segments of 4 quads) hit 32 banks.
__device__ __forceinline__ int x_row(int r) { return 17 * r + 12 * (r >> 2); }

template <int K, int S>
__global__ void __launch_bounds__(NT, 4)
dec_aff_tail_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ out,
                    float* __restrict__ y1out, int Hg, int Wg, int C) {
  static_assert(K % 4 == 0 && (2 * TH) % S == 0, "K in groups of 4, rows split evenly");
  extern __shared__ __align__(16) float smem[];
  float* w2s = smem + REGION;      // [M][9][K]
  const int tid = threadIdx.x, lane = tid & 31, g = tid >> 5;
  int rank = 0;
  if constexpr (S > 1) rank = (int)cg::this_cluster().block_rank();
  const int b = blockIdx.z;
  const int a0 = blockIdx.y * TH, t0 = (blockIdx.x / S) * TW;
  const int nstages = (C + CC - 1) / CC;
  const int k0 = rank * nstages / S, k1 = (rank + 1) * nstages / S;

  // ---- staging: x planes [CC][XP] by 4-byte copies (a thread: one
  // channel, every 8th pixel; a warp: the 16 channels of two pixels), w1
  // as it lies by 16-byte copies ----
  const int sc = tid % CC;
  const long row_step = (long)(Wg - XC) * C;  // from past a tile row to the next
  auto stage = [&](int kc, int buf) {
    float* xs = smem + buf * STAGE + sc * XP;
    const int ch = kc * CC + sc;
    const int rows = ch < C ? Hg - a0 : 0, cols = Wg - t0;  // x rows, cols inside
    int r = 0, col = tid / CC, dst = col;
    const float* src = x + (((long)b * Hg + a0) * Wg + t0 + col) * C + ch;
    for (int p = tid / CC; p < XR * XC; p += NT / CC) {
      const bool ok = r < rows && col < cols;
      cpa::copy4(xs + dst, ok ? src : x, ok);
      col += NT / CC;
      dst += NT / CC;
      src += (NT / CC) * C;
      if (col >= XC) {  // on to the next row: x_row's skew every fourth
        col -= XC;
        ++r;
        src += row_step;
        if (r % 4 == 0) dst += 12;
      }
    }
    float* ws = smem + buf * STAGE + CC * XP;
    const float* wsrc = w1 + (long)kc * CC * WS;
    for (int j = tid; j < CC * WS / 4; j += NT) {
      const bool ok = kc * CC + j / (WS / 4) < C;
      cpa::copy16(ws + 4 * j, ok ? wsrc + 4 * j : w1, ok);
    }
  };

  if (k0 < k1) stage(k0, 0);
  for (int i = tid; i < M * K * 9; i += NT) {  // w2 as [m][tap][k]
    const int m = i / (K * 9), k = (i / 9) % K, tap = i % 9;
    cpa::copy4(w2s + (m * 9 + tap) * K + k, w2 + i, true);
  }
  cpa::commit();

  // ---- deconv1: lane = (quad row, segment of P quads); warp = channels ----
  const int row = lane >> 2, q0 = (lane & 3) * P;
  const int o0 = x_row(row) + q0, o1 = x_row(row + 1) + q0;
  // The halo lane's two x pixels: lanes 0-15 the even and odd pixel of
  // y1's row 2TH at columns 2i, 2i + 1 (i = lane); lanes 16-23 those of
  // column 2TW at rows 2j, 2j + 1 (j = lane - 16); lane 24 the corner;
  // lanes 25-31 repeat the corner and drop it.
  const bool hrow = lane < 16;
  const int oa = hrow ? x_row(TH) + lane : lane < 24 ? x_row(lane - 16) + TW : x_row(TH) + TW;
  const int oc = hrow ? oa + 1 : lane < 24 ? x_row(lane - 15) + TW : oa;
  float acc[P][4][4];  // [quad][pixel of the quad][channel]
  float h0[4], h1[4];  // the halo lane's even and odd pixel
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    h0[j] = h1[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < P; ++k)
#pragma unroll
      for (int p = 0; p < 4; ++p) acc[k][p][j] = 0.0f;
  }

  for (int kc = k0; kc < k1; ++kc) {
    const int buf = (kc - k0) & 1;
    if (kc + 1 < k1) {
      stage(kc + 1, buf ^ 1);
      cpa::commit();
      cpa::wait<1>();
    } else {
      cpa::wait<0>();
    }
    __syncthreads();
    const float* xs = smem + buf * STAGE;
    const float* ws = xs + CC * XP + 36 * g;
#pragma unroll 2
    for (int c = 0; c < CC; ++c) {
      const float* xc = xs + c * XP;
      float xa[P + 1], xb[P + 1];  // x rows `row` and `row + 1`
#pragma unroll
      for (int k = 0; k <= P; ++k) {
        xa[k] = xc[o0 + k];
        xb[k] = xc[o1 + k];
      }
      // w[9 j + tap]: channel 4g + j, tap (ty, tx) = (tap / 3, tap % 3)
      float w[36];
      const float4* wv = reinterpret_cast<const float4*>(ws + c * WS);
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        const float4 v = wv[i];
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float x00 = xa[k], x01 = xa[k + 1], x10 = xb[k], x11 = xb[k + 1];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* wj = w + 9 * j;
          acc[k][0][j] = fmaf(wj[4], x00, acc[k][0][j]);
          acc[k][1][j] = fmaf(wj[5], x00, acc[k][1][j]);
          acc[k][1][j] = fmaf(wj[3], x01, acc[k][1][j]);
          acc[k][2][j] = fmaf(wj[7], x00, acc[k][2][j]);
          acc[k][2][j] = fmaf(wj[1], x10, acc[k][2][j]);
          acc[k][3][j] = fmaf(wj[8], x00, acc[k][3][j]);
          acc[k][3][j] = fmaf(wj[6], x01, acc[k][3][j]);
          acc[k][3][j] = fmaf(wj[2], x10, acc[k][3][j]);
          acc[k][3][j] = fmaf(wj[0], x11, acc[k][3][j]);
        }
      }
      // the halo: row 2TH (taps (1, 1); (1, 2) and (1, 0)), column 2TW
      // (taps (1, 1); (2, 1) and (0, 1))
      const float ha = xc[oa], hc = xc[oc];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* wj = w + 9 * j;
        h0[j] = fmaf(wj[4], ha, h0[j]);
        h1[j] = fmaf(hrow ? wj[5] : wj[7], ha, h1[j]);
        h1[j] = fmaf(hrow ? wj[3] : wj[1], hc, h1[j]);
      }
    }
    __syncthreads();
  }
  cpa::wait<0>();  // the w2 copies, when this CTA had no stage

  // ---- this CTA's partial y1 tile [M][YR][YC], where the stages were ----
  float* part = smem;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float* pm = part + (4 * g + j) * YR * YC;
#pragma unroll
    for (int k = 0; k < P; ++k)
#pragma unroll
      for (int p = 0; p < 4; ++p)
        pm[(2 * row + (p >> 1)) * YC + 2 * (q0 + k) + (p & 1)] = acc[k][p][j];
    if (hrow) {
      pm[2 * TH * YC + 2 * lane] = h0[j];
      pm[2 * TH * YC + 2 * lane + 1] = h1[j];
    } else if (lane < 24) {
      pm[2 * (lane - 16) * YC + 2 * TW] = h0[j];
      pm[(2 * (lane - 16) + 1) * YC + 2 * TW] = h1[j];
    } else if (lane == 24) {
      pm[2 * TH * YC + 2 * TW] = h0[j];
    }
  }

  // ---- y1 rows v0 .. v0 + NR (the last one deconv2's halo): the S
  // partials added in rank order, bias, ReLU; zero outside the image ----
  constexpr int NR = 2 * TH / S;
  const int v0 = rank * NR;
  float* y1s = smem;  // [M][NR + 1][YC]
  auto finish = [&](int m, int v, int u, float sum) {
    const bool in = 2 * a0 + v0 + v < 2 * Hg && 2 * t0 + u < 2 * Wg;
    y1s[(m * (NR + 1) + v) * YC + u] = in ? fmaxf(sum + __ldg(b1 + m), 0.0f) : 0.0f;
  };
  if constexpr (S == 1) {
    __syncthreads();
    for (int row = g; row < M * YR; row += NT / 32)
      for (int u = lane; u < YC; u += 32) finish(row / YR, row % YR, u, part[row * YC + u]);
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every partial written
    constexpr int E = M * (NR + 1) * YC, PER = (E + NT - 1) / NT;
    float sum[PER];  // element tid + i NT of [M][NR + 1][YC]
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * NT, m = e / ((NR + 1) * YC), v = (e / YC) % (NR + 1);
      if (e < E) {
        const int src = (m * YR + v0 + v) * YC + e % YC;
        float t = cluster.map_shared_rank(part, 0)[src];
#pragma unroll
        for (int q = 1; q < S; ++q) t += cluster.map_shared_rank(part, q)[src];
        sum[i] = t;
      }
    }
    cluster.sync();  // every peer's reads done: the partials may be overwritten
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * NT;
      if (e < E) finish(e / ((NR + 1) * YC), (e / YC) % (NR + 1), e % YC, sum[i]);
    }
  }
  __syncthreads();

  if (y1out) {  // the owned rows, coalesced along u
    const int H1 = 2 * Hg, W1 = 2 * Wg;
    for (int row = g; row < M * NR; row += NT / 32) {
      const int m = row / NR, v = row % NR;
      const int gy = 2 * a0 + v0 + v, gx = 2 * t0 + lane;
      if (gy < H1 && gx < W1)
        y1out[(((long)b * M + m) * H1 + gy) * W1 + gx] = y1s[(m * (NR + 1) + v) * YC + lane];
    }
  }

  // ---- deconv2: a warp item = (group of 4 output channels, y1 row); a
  // lane = the quad of y1 column `lane` ----
  constexpr int KG = K / 4;
  const int Ho = 4 * Hg, Wo = 4 * Wg;
  float* ob = out + (long)b * K * Ho * Wo;
  for (int it = g; it < KG * NR; it += NT / 32) {
    const int kg = it / NR, v = it % NR;
    float o[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bias = __ldg(b2 + 4 * kg + j);
#pragma unroll
      for (int p = 0; p < 4; ++p) o[p][j] = bias;
    }
    const float* y = y1s + v * YC + lane;
#pragma unroll 4
    for (int m = 0; m < M; ++m) {
      const float* ym = y + m * (NR + 1) * YC;
      const float y00 = ym[0], y01 = ym[1], y10 = ym[YC], y11 = ym[YC + 1];
      const float4* wm = reinterpret_cast<const float4*>(w2s + m * 9 * K) + kg;
      float4 t[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) t[i] = wm[i * KG];
      const float4 v00 = t[0], v01 = t[1], v02 = t[2], v10 = t[3], v11 = t[4],
                   v12 = t[5], v20 = t[6], v21 = t[7], v22 = t[8];
#define FMA4(A, W, X)              \
  A[0] = fmaf((W).x, X, A[0]);     \
  A[1] = fmaf((W).y, X, A[1]);     \
  A[2] = fmaf((W).z, X, A[2]);     \
  A[3] = fmaf((W).w, X, A[3]);
      FMA4(o[0], v11, y00)
      FMA4(o[1], v12, y00) FMA4(o[1], v10, y01)
      FMA4(o[2], v21, y00) FMA4(o[2], v01, y10)
      FMA4(o[3], v22, y00) FMA4(o[3], v20, y01) FMA4(o[3], v02, y10)
      FMA4(o[3], v00, y11)
#undef FMA4
    }
    const int gy = 4 * a0 + 2 * (v0 + v), gx = 4 * t0 + 2 * lane;
    if (gx < Wo) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* oc = ob + (long)(4 * kg + j) * Ho * Wo;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
          if (gy + dy < Ho)
            *reinterpret_cast<float2*>(oc + (long)(gy + dy) * Wo + gx) =
                make_float2(o[2 * dy][j], o[2 * dy + 1][j]);
      }
    }
  }
}

template <int K, int S>
int launch(const float* x, const float* w1, const float* b1, const float* w2,
           const float* b2, float* out, float* y1, int B, int Hg, int Wg,
           int C, cudaStream_t stream) {
  auto kernel = dec_aff_tail_kernel<K, S>;
  const size_t smem = sizeof(float) * (REGION + M * 9 * K);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Wg + TW - 1) / TW * S, (Hg + TH - 1) / TH, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = S;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = S > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, w1, b1, w2, b2, out,
                                           y1, Hg, Wg, C);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <int K>
int launch_k(int S, const float* x, const float* w1, const float* b1,
             const float* w2, const float* b2, float* out, float* y1, int B,
             int Hg, int Wg, int C, cudaStream_t s) {
  switch (S) {
    case 1: return launch<K, 1>(x, w1, b1, w2, b2, out, y1, B, Hg, Wg, C, s);
    case 2: return launch<K, 2>(x, w1, b1, w2, b2, out, y1, B, Hg, Wg, C, s);
    case 4: return launch<K, 4>(x, w1, b1, w2, b2, out, y1, B, Hg, Wg, C, s);
    case 8: return launch<K, 8>(x, w1, b1, w2, b2, out, y1, B, Hg, Wg, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch. K must be 8 or 24, split
// (the cluster size S: CTAs that share a tile's channel stages) 1, 2, 4 or
// 8, at most ceil(C / 16). w1 must be 16-byte aligned. y1 may be null (no
// intermediate written).
extern "C" int dec_aff_tail_f32(const float* x, const float* w1,
                                const float* b1, const float* w2,
                                const float* b2, float* out, float* y1,
                                int B, int Hg, int Wg, int C, int K, int split,
                                void* stream) {
  if (split > (C + CC - 1) / CC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (K == 8) return launch_k<8>(split, x, w1, b1, w2, b2, out, y1, B, Hg, Wg, C, s);
  if (K == 24) return launch_k<24>(split, x, w1, b1, w2, b2, out, y1, B, Hg, Wg, C, s);
  return (int)cudaErrorInvalidValue;
}

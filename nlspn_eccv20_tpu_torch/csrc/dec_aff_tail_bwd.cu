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
// about 120 MB of tensors: 130 us at 67 TFLOP/s. So each pass keeps
// several sums a thread in registers, so that few shared-memory words feed
// each FMA, and overlaps its copies with the FMAs:
//   1. dy1_kernel: per 8x16 tile of y1 positions, g's patch (all K
//      channels), y1 and w2 staged by asynchronous copies; dY1 (written to
//      scratch) by threads that own 4 positions x 4 m, dW2 by other warps
//      that own an (m, k) pair and slide a 3x3 window of g along the rows;
//      the tile's partial sums of dW2, db1 and db2.
//   2. bwd::transpose: w1 laid out (M 9, C), so dx_kernel copies 16 bytes
//      at a time.
//   3. dx_kernel: the k3/s2 conv of dY1 to C channels: per block an 8x16
//      tile of base pixels and 64 channels; the m stream through shared
//      memory four at a time, with their weights, into two buffers
//      (cp_async.cuh). A thread owns 8 channels x 8 pixels of a row (64
//      sums): per (m, ty) 17 patch words, kept in registers across the
//      three tx, and 6 float4s of weights for 192 FMAs.
//   4. bwd::wgrad_s2 (bwd_common.cuh): dW1 as slice partials (132 at b=12).
//   5. bwd::reduce_partials: the partials of 1 and 4 added in a fixed order.
// The weight gradients are summed without atomics, so the result is the
// same bits from run to run, as the TPU kernel's sequential grid gives.
// The f32 form runs plain f32 FMAs: no tensor cores.
//
// bf16 form (K4-bf16, dec_aff_tail_bwd_bf16, precision='bf16'): the same
// passes with T = __nv_bfloat16 for x and dx, except that its two products
// run on the bf16 tensor cores (wgmma_bf16.cuh): dx as dx_mma_kernel (3'.
// below, in place of 2. and 3.) and dW1 as bwd::wgrad_s2_mma_kernel. Both
// are sums of products of two bf16 values, exact in f32, so the tensor
// cores compute what the FP32 cores did, in another order of f32 sums; on
// the FP32 cores they took 141 and 126 us of the 375 us at b=12. Rounding
// where the TPU kernel
// (_bwd_kernel at dt = bfloat16) rounds: g to bf16 before any product (the
// f32 cotangent of K2-bf16's output is not rounded yet), w1 and w2 to bf16,
// dY1 to bf16 after its f32 sum and mask, dx to bf16 after its f32 sum; dW1,
// dW2, db1 and db2 are f32 sums of those bf16 operands (db2 of the rounded
// g). Products of two bf16 values are exact in f32, so only the order of
// the f32 sums differs from the TPU kernel's.
// y1: the TPU kernel recomputes P in f32, takes the ReLU mask on it and
// rounds it to bf16. This form reads the y1 that K2-bf16 writes under
// autograd, already rounded after bias and ReLU, as the f32 form reads K2's:
// recomputing deconv1 would cost its 3.8 GFLOP again. Its mask [y1 > 0]
// differs from [P > 0] only where 0 < P <= 2^-134 (P rounds to +0 in bf16).
// That needs a term below 2^-133: every product of two bf16 values x w1 and
// the bf16 bias are multiples of 2^-133 when |x w1| >= 2^-117 (or is 0) and
// |b1| >= 2^-126 (or is 0), so then is every f32 partial sum of them, and a
// positive P is at least 2^-133, the least positive bf16. Inputs that small
// do not occur in the model, whose activations and weights are O(1e-3..1e2).
// The staged g and w2 are rounded in shared memory once their copies have
// landed; x is staged as raw bf16 words (bwd_common.cuh). y1 stays an f32
// buffer holding bf16 values (K2-bf16 writes it so). dY1 is a bf16 buffer,
// half the f32 form's bytes, which both tensor-core passes stage as raw
// words.

#include <cuda_runtime.h>

#include "bwd_common.cuh"
#include "cp_async.cuh"

namespace {

constexpr int M = bwd::M;

// ---- 1. dY1, and partial dW2 / db1 / db2 ----
constexpr int TR = 8;              // y1 tile rows
constexpr int TC = 16;             // y1 tile cols
constexpr int NP_TILE = TR * TC;   // 128 positions a tile
constexpr int GR = 2 * TR + 1;     // g patch rows / cols
constexpr int GC = 2 * TC + 1;
constexpr int G_K = GR * GC;       // 561 floats a g channel
constexpr int NT_A = 256;          // 128 dY1 threads, then 128 dW2 threads
constexpr int HALF = NT_A / 2;
constexpr int PQ = 4;              // positions a dY1 thread, along a row
static_assert(TR * (TC / PQ) * (M / 4) == HALF, "dY1 threads cover the tile");

template <int K>
constexpr int dy1_smem_bytes() {
  return (K * G_K + NP_TILE * M + K * 9 * M) * (int)sizeof(float);
}

// Per tile of TR x TC y1 positions: g's patch (all K channels), y1 as
// [position][m] and w2 as [k][tap][m] in shared memory by asynchronous
// copies. Threads 0..127 own 4 positions of a row and 4 m (16 sums): per
// (k, ty) 9 words of g and 3 float4s of w2 for 48 FMAs, then the ReLU mask
// and dY1. Threads 128..255, other warps, own (m, k) pairs of dW2 (9 sums)
// and slide a 3x3 window of g along each row of the tile: per position 1
// word of y1 and 6 of g for 9 FMAs. Then db2 over the g pixels the tile
// owns and db1 over its dY1, each added in a fixed order.
template <typename T, int K>
__global__ void __launch_bounds__(NT_A)
dy1_kernel(const float* __restrict__ g, const float* __restrict__ y1,
           const float* __restrict__ w2, T* __restrict__ dy1,
           float* __restrict__ part, int H1, int W1) {
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;                    // [k][GR][GC]
  float* ys = gs + K * G_K;            // [position][m]
  float* ws = ys + NP_TILE * M;        // [k][tap][m]
  __shared__ __align__(16) float red1[HALF][4];  // dY1 threads' sums, for db1
  __shared__ float red2[K * 8];                  // db2's row pairs

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int R0 = blockIdx.y * TR, C0 = blockIdx.x * TC;
  const int Ho = 2 * H1, Wo = 2 * W1;
  constexpr int NP = M * K * 9 + M + K;
  float* pb = part + (long)((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * NP;

  for (int e = tid; e < K * G_K; e += NT_A) {
    const int c = e % GC, r = (e / GC) % GR, k = e / G_K;
    const int oy = 2 * R0 - 1 + r, ox = 2 * C0 - 1 + c;
    const bool ok = oy >= 0 && oy < Ho && ox >= 0 && ox < Wo;
    cpa::copy4(gs + e, ok ? g + (((long)b * K + k) * Ho + oy) * Wo + ox : g, ok);
  }
  for (int e = tid; e < M * NP_TILE; e += NT_A) {
    const int q = e % NP_TILE, m = e / NP_TILE;
    const int r = R0 + q / TC, c = C0 + q % TC;
    const bool ok = r < H1 && c < W1;
    cpa::copy4(ys + q * M + m, ok ? y1 + (((long)b * M + m) * H1 + r) * W1 + c : y1, ok);
  }
  for (int e = tid; e < M * K * 9; e += NT_A) {  // w2 is (M, K, 3, 3)
    const int m = e / (K * 9), k = (e / 9) % K, tap = e % 9;
    cpa::copy4(ws + (k * 9 + tap) * M + m, w2 + e, true);
  }
  cpa::commit();
  cpa::wait<0>();
  __syncthreads();
  if constexpr (!std::is_same_v<T, float>) {  // g and w2 as the TPU kernel takes them
    for (int e = tid; e < K * G_K; e += NT_A) gs[e] = bwd::round_bf16(gs[e]);
    for (int e = tid; e < M * K * 9; e += NT_A) ws[e] = bwd::round_bf16(ws[e]);
    __syncthreads();
  }

  if (tid < HALF) {
    const int mq = tid % 4, cg = (tid / 4) % (TC / PQ), r = tid / (4 * (TC / PQ));
    float acc[PQ][4];
#pragma unroll
    for (int j = 0; j < PQ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int ty = 0; ty < 3; ++ty) {
        const float* grow = gs + k * G_K + (2 * r + ty) * GC + 2 * PQ * cg;
        float v[2 * PQ + 1];
#pragma unroll
        for (int q = 0; q <= 2 * PQ; ++q) v[q] = grow[q];
#pragma unroll
        for (int tx = 0; tx < 3; ++tx) {
          const float4 w =
              *reinterpret_cast<const float4*>(ws + (k * 9 + ty * 3 + tx) * M + 4 * mq);
#pragma unroll
          for (int j = 0; j < PQ; ++j) {
            const float x = v[2 * j + tx];
            acc[j][0] = fmaf(w.x, x, acc[j][0]);
            acc[j][1] = fmaf(w.y, x, acc[j][1]);
            acc[j][2] = fmaf(w.z, x, acc[j][2]);
            acc[j][3] = fmaf(w.w, x, acc[j][3]);
          }
        }
      }
    }
    // dY1 = [y1 > 0] dy1, and the thread's sums for db1
    float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float d[4][PQ];
    const int rr = R0 + r, c0 = C0 + PQ * cg;
#pragma unroll
    for (int j = 0; j < PQ; ++j) {
      const float4 y = *reinterpret_cast<const float4*>(ys + (r * TC + PQ * cg + j) * M + 4 * mq);
      const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        d[i][j] = yv[i] > 0.0f ? bwd::round_to<T>(acc[j][i]) : 0.0f;
        sum[i] += d[i][j];
      }
    }
    if (rr < H1 && c0 < W1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        T* row = dy1 + (((long)b * M + 4 * mq + i) * H1 + rr) * W1 + c0;
        if (!std::is_same_v<T, float> && (W1 & 3) == 0) {  // 4 bf16, 8-byte aligned
          *reinterpret_cast<uint2*>(row) =
              make_uint2(pack_bf16(d[i][0], d[i][1]), pack_bf16(d[i][2], d[i][3]));
        } else {
#pragma unroll
          for (int j = 0; j < PQ; ++j)
            if (c0 + j < W1) row[j] = bwd::narrow<T>(d[i][j]);
        }
      }
    }
    *reinterpret_cast<float4*>(red1[tid]) = make_float4(sum[0], sum[1], sum[2], sum[3]);
  } else {
    const int u = tid - HALF;
    const int m = u % M;
#pragma unroll 1
    for (int k = u / M; k < K; k += HALF / M) {
      float a[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) a[t] = 0.0f;
      const float* gk = gs + k * G_K;
#pragma unroll 1
      for (int r = 0; r < TR; ++r) {
        const float* grow = gk + 2 * r * GC;
        float w0[3];  // the window's left column: g cols 2 c - 1 + {0, 1, 2}
#pragma unroll
        for (int ty = 0; ty < 3; ++ty) w0[ty] = grow[ty * GC];
#pragma unroll 4
        for (int c = 0; c < TC; ++c) {
          float w1[3], w2v[3];
#pragma unroll
          for (int ty = 0; ty < 3; ++ty) {
            w1[ty] = grow[ty * GC + 2 * c + 1];
            w2v[ty] = grow[ty * GC + 2 * c + 2];
          }
          const float yv = ys[(r * TC + c) * M + m];
#pragma unroll
          for (int ty = 0; ty < 3; ++ty) {
            a[3 * ty] = fmaf(yv, w0[ty], a[3 * ty]);
            a[3 * ty + 1] = fmaf(yv, w1[ty], a[3 * ty + 1]);
            a[3 * ty + 2] = fmaf(yv, w2v[ty], a[3 * ty + 2]);
          }
#pragma unroll
          for (int ty = 0; ty < 3; ++ty) w0[ty] = w2v[ty];
        }
      }
#pragma unroll
      for (int t = 0; t < 9; ++t) pb[(m * K + k) * 9 + t] = a[t];
    }
  }
  // db2 over the g pixels the tile owns (patch rows and cols 1 .. 2T),
  // two rows a thread, then the eight row pairs in order
  if (tid < K * 8) {
    const int k = tid / 8, pr = tid % 8;
    const float* gk = gs + k * G_K + (1 + 2 * pr) * GC + 1;
    float s = 0.0f;
    for (int rr = 0; rr < 2; ++rr)
      for (int c = 0; c < 2 * TC; ++c) s += gk[rr * GC + c];
    red2[tid] = s;
  }
  __syncthreads();
  if (tid < K) {
    float s = 0.0f;
    for (int pr = 0; pr < 8; ++pr) s += red2[tid * 8 + pr];
    pb[M * K * 9 + M + tid] = s;
  } else if (tid >= 32 && tid < 32 + M) {  // db1, another warp
    const int m = tid - 32;
    float s = 0.0f;
    for (int t = m / 4; t < HALF; t += 4) s += red1[t][m % 4];
    pb[M * K * 9 + m] = s;
  }
}

// ---- 2. dx = conv(dY1, w1), k3/s2/p1, 16 -> C, NHWC out ----
constexpr int TOH = 8;            // output tile rows
constexpr int TOW = 16;           // output tile cols
constexpr int PXT = 8;            // output pixels per thread, along a row
constexpr int CG = 64;            // output channels per block
constexpr int NT_B = CG / 8 * (TOH * TOW / PXT);  // 128: (channel octet, pixel group)
constexpr int MC = 4;             // m per staged chunk
constexpr int DR = 2 * TOH + 1;   // dY1 patch rows / cols
constexpr int DC = 2 * TOW + 1;
constexpr int D_PITCH = DC + 3;   // 36: col X at 2 ox0 - 4 + index, so
                                  // that a row starts 16-byte aligned
constexpr int D_M = DR * D_PITCH; // floats per m
static_assert(M % MC == 0, "chunks tile the m");

// w1t is w1 laid out (M * 9, C): the taps' rows of weights, channels last.
// The f32 form's dx (the bf16 form's is dx_mma_kernel, below).
__global__ void __launch_bounds__(NT_B, 3)
dx_kernel(const float* __restrict__ dy1, const float* __restrict__ w1t,
          float* __restrict__ dx, int Hg, int Wg, int C, int H1, int W1,
          int n_groups) {
  __shared__ __align__(16) float w1s[2][MC * 9 * CG];  // [m * 9 + tap][channel]
  __shared__ __align__(16) float ds[2][MC * D_M];       // [m][DR][D_PITCH]

  const int tid = threadIdx.x;
  const int b = blockIdx.z / n_groups;
  const int co0 = (blockIdx.z % n_groups) * CG;
  const int oy0 = blockIdx.y * TOH, ox0 = blockIdx.x * TOW;
  const bool vec = (C & 3) == 0;

  // issues the copies of chunk m0 .. m0 + MC - 1 into buffer buf
  auto stage = [&](int m0, int buf) {
    const float* wsrc = w1t + (long)m0 * 9 * C + co0;
    if (vec) {
      for (int e = tid; e < MC * 9 * CG / 4; e += NT_B) {
        const int row = e / (CG / 4), cl = 4 * (e % (CG / 4));
        const bool ok = co0 + cl < C;
        cpa::copy16(&w1s[buf][row * CG + cl], ok ? wsrc + (long)row * C + cl : w1t, ok);
      }
    } else {
      for (int e = tid; e < MC * 9 * CG; e += NT_B) {
        const int row = e / CG, cl = e % CG;
        const bool ok = co0 + cl < C;
        cpa::copy4(&w1s[buf][e], ok ? wsrc + (long)row * C + cl : w1t, ok);
      }
    }
    const float* dsrc = dy1 + ((long)b * M + m0) * H1 * W1;
    if ((W1 & 3) == 0) {  // 16-byte copies, each wholly in or out of the row
      constexpr int Q = D_PITCH / 4;
      for (int e = tid; e < MC * DR * Q; e += NT_B) {
        const int q = e % Q, r = (e / Q) % DR, m = e / (DR * Q);
        const int Y = 2 * oy0 - 1 + r, X = 2 * ox0 - 4 + 4 * q;
        const bool ok = Y >= 0 && Y < H1 && X >= 0 && X < W1;
        cpa::copy16(&ds[buf][m * D_M + r * D_PITCH + 4 * q],
                    ok ? dsrc + ((long)m * H1 + Y) * W1 + X : dy1, ok);
      }
    } else {
      for (int e = tid; e < MC * DR * DC; e += NT_B) {
        const int c = e % DC, r = (e / DC) % DR, m = e / (DR * DC);
        const int Y = 2 * oy0 - 1 + r, X = 2 * ox0 - 1 + c;
        const bool ok = Y >= 0 && Y < H1 && X >= 0 && X < W1;
        cpa::copy4(&ds[buf][m * D_M + r * D_PITCH + c + 3],
                   ok ? dsrc + ((long)m * H1 + Y) * W1 + X : dy1, ok);
      }
    }
  };

  // lane = (octet o, one of 4 pixel groups): channels 4o..4o+3 and
  // 32+4o..32+4o+3, so a warp's float4 weight loads cover 32 consecutive
  // words; its 4 pixel groups (2 rows x 2 halves of the tile row) read
  // patch words in 4 distinct banks.
  const int o = tid % 8, pg = tid / 8;
  const int row = pg / 2, half = pg % 2;
  float acc[PXT][8];
#pragma unroll
  for (int j = 0; j < PXT; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[j][k] = 0.0f;

  stage(0, 0);
  cpa::commit();
#pragma unroll 1
  for (int m0 = 0, buf = 0; m0 < M; m0 += MC, buf ^= 1) {
    if (m0 + MC < M) stage(m0 + MC, buf ^ 1);
    cpa::commit();
    cpa::wait<1>();
    __syncthreads();
#pragma unroll 1
    for (int m = 0; m < MC; ++m) {
#pragma unroll
      for (int ty = 0; ty < 3; ++ty) {
        const float* drow =
            &ds[buf][m * D_M + (2 * row + ty) * D_PITCH + 3 + 2 * PXT * half];
        float d[2 * PXT + 1];  // the row's 17 patch words serve all three tx
#pragma unroll
        for (int q = 0; q <= 2 * PXT; ++q) d[q] = drow[q];
#pragma unroll
        for (int tx = 0; tx < 3; ++tx) {
          const float* wp = &w1s[buf][(m * 9 + ty * 3 + tx) * CG + 4 * o];
          const float4 wa = *reinterpret_cast<const float4*>(wp);
          const float4 wb = *reinterpret_cast<const float4*>(wp + 32);
#pragma unroll
          for (int j = 0; j < PXT; ++j) {
            const float v = d[2 * j + tx];
            acc[j][0] = fmaf(wa.x, v, acc[j][0]);
            acc[j][1] = fmaf(wa.y, v, acc[j][1]);
            acc[j][2] = fmaf(wa.z, v, acc[j][2]);
            acc[j][3] = fmaf(wa.w, v, acc[j][3]);
            acc[j][4] = fmaf(wb.x, v, acc[j][4]);
            acc[j][5] = fmaf(wb.y, v, acc[j][5]);
            acc[j][6] = fmaf(wb.z, v, acc[j][6]);
            acc[j][7] = fmaf(wb.w, v, acc[j][7]);
          }
        }
      }
    }
    __syncthreads();  // the buffer is restaged two chunks on
  }
  const int oy = oy0 + row;
  if (oy >= Hg) return;
  float* orow = dx + ((long)b * Hg + oy) * Wg * C;
#pragma unroll
  for (int j = 0; j < PXT; ++j) {
    const int ox = ox0 + PXT * half + j;
    if (ox >= Wg) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = co0 + 32 * h + 4 * o;
      float* out = orow + (long)ox * C + c;
      if (vec && c + 3 < C) {
        *reinterpret_cast<float4*>(out) = make_float4(acc[j][4 * h], acc[j][4 * h + 1],
                                                      acc[j][4 * h + 2], acc[j][4 * h + 3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (c + k < C) out[k] = acc[j][4 * h + k];
      }
    }
  }
}

// ---- 3'. the bf16 form's dx on the tensor cores ----
//
// K4-bf16 runs dx as an implicit GEMM on bf16 wgmma (wgmma_bf16.cuh): M =
// base pixels, 64 a block (a 4 x 16 tile, a warp a row), N = 128 channels
// (a block's group), the reduction over (tap, m) in nine k-steps, one tap
// of the 16 dY1 channels each. Blocks are persistent: each copies its
// group's weights once (w1 rounded to bf16 by prep_w1_kernel into the
// K-major core matrices wgmma reads, [tap][N / 8][2][8][8]) and walks the
// tiles j, j + gridDim.y, ..., the next tile's dY1 patch (all 16 m, rows
// 2 oy0 - 1 .. 2 oy0 + 7, bf16) coming in by cp.async while this one
// computes: 16-byte copies where W1 is a multiple of 8, else 4-byte words
// from the even column 2 ox0 - 2 (W1 = 2 Wg is even). A (64 x 16) is built
// in registers from the staged patch, a word of two m a pixel; an m's
// patch is MX_DMH bf16, so m and m + 2 lie MX_DMH words apart (440 = 24
// mod 32) and the four m pairs of a warp's loads fall in distinct banks. The nine fragments are built
// first and their products issued as one commit group. dx is rounded to
// bf16 from the f32 sums and written as words of two channels.
constexpr int MX_TH = 4, MX_TW = 16;        // base-pixel tile: M = 64
constexpr int MX_NT = 128;                  // one warpgroup
constexpr int MX_NC = 128;                  // channels a block: N
constexpr int MX_DR = 2 * MX_TH + 1;        // 9 patch rows
constexpr int MX_PITCH = 48;                // bf16 a patch row: col X at 2 ox0 - 8 + index
constexpr int MX_DMH = MX_DR * MX_PITCH + 8;   // bf16 a staged m
constexpr int MX_WB = 9 * M * MX_NC;        // bf16 of a group's weights
constexpr int MX_SMEM = MX_WB * 2 + 2 * M * MX_DMH * 2;   // 65,024 bytes: two blocks an SM
static_assert(MX_DMH % 8 == 0 && MX_DMH % 32 == 24, "16-byte rows; m pairs in distinct banks");
constexpr int MX_BLOCKS_PER_SM = 2;

// w1p[group][tap][N x 16]: (c, m) = w1[128 group + c][m][tap] rounded to bf16
// at (c / 8) 128 + (m / 8) 64 + (c % 8) 8 + m % 8, zero past C
__global__ void __launch_bounds__(256)
prep_w1_kernel(const float* __restrict__ w1, __nv_bfloat16* __restrict__ w1p, int C,
               int n_groups) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n_groups * MX_WB) return;
  const int grp = i / MX_WB, r = i - grp * MX_WB, tap = r / (M * MX_NC), e = r % (M * MX_NC);
  const int cl = (e >> 7) * 8 + ((e >> 3) & 7), m = ((e >> 6) & 1) * 8 + (e & 7);
  const int c = grp * MX_NC + cl;
  w1p[i] = __float2bfloat16_rn(c < C ? __ldg(w1 + ((long)c * M + m) * 9 + tap) : 0.0f);
}

__global__ void __launch_bounds__(MX_NT, MX_BLOCKS_PER_SM)
dx_mma_kernel(const __nv_bfloat16* __restrict__ dy1, const __nv_bfloat16* __restrict__ w1p,
              __nv_bfloat16* __restrict__ dx, int B, int Hg, int Wg, int C, int H1, int W1) {
  extern __shared__ __align__(128) unsigned char mx_smem[];
  unsigned short* ws = reinterpret_cast<unsigned short*>(mx_smem);       // [tap][N x 16]
  unsigned short* ds = ws + MX_WB;                      // [2][m][MX_DR][MX_PITCH], MX_DMH an m

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int co0 = blockIdx.x * MX_NC;
  const int tiles_x = (Wg + MX_TW - 1) / MX_TW, tiles_y = (Hg + MX_TH - 1) / MX_TH;
  const int per_image = tiles_x * tiles_y, tiles = B * per_image;

  // issues the copies of tile t's dY1 patch into buffer buf
  auto stage = [&](int t, int buf) {
    const int b = t / per_image, r = t - b * per_image;
    const int oy0 = (r / tiles_x) * MX_TH, ox0 = (r % tiles_x) * MX_TW;
    const __nv_bfloat16* dsrc = dy1 + (long)b * M * H1 * W1;
    unsigned short* dst = ds + buf * M * MX_DMH;
    if ((W1 & 7) == 0) {  // 16-byte copies of 8 columns, each wholly in or out of the row
      constexpr int Q = MX_PITCH / 8;
      for (int e = tid; e < M * MX_DR * Q; e += MX_NT) {
        const int q = e % Q, rr = (e / Q) % MX_DR, m = e / (MX_DR * Q);
        const int Y = 2 * oy0 - 1 + rr, X = 2 * ox0 - 8 + 8 * q;
        const bool ok = Y >= 0 && Y < H1 && X >= 0 && X < W1;
        cpa::copy16(dst + m * MX_DMH + rr * MX_PITCH + 8 * q,
                    ok ? dsrc + ((long)m * H1 + Y) * W1 + X : dy1, ok);
      }
    } else {  // words of cols 2 ox0 - 2 + 2 c, + 1 (W1 even: each wholly in or out)
      constexpr int Q = (DC + 1) / 2;
      for (int e = tid; e < M * MX_DR * Q; e += MX_NT) {
        const int c = e % Q, rr = (e / Q) % MX_DR, m = e / (MX_DR * Q);
        const int Y = 2 * oy0 - 1 + rr, X = 2 * ox0 - 2 + 2 * c;
        const bool ok = Y >= 0 && Y < H1 && X >= 0 && X < W1;
        cpa::copy4(dst + m * MX_DMH + rr * MX_PITCH + 6 + 2 * c,
                   ok ? dsrc + ((long)m * H1 + Y) * W1 + X : dy1, ok);
      }
    }
  };

  const uint4* wsrc = reinterpret_cast<const uint4*>(w1p + (long)blockIdx.x * MX_WB);
  for (int e = tid; e < MX_WB / 8; e += MX_NT)
    cpa::copy16(reinterpret_cast<uint4*>(ws) + e, wsrc + e, true);
  const int step = gridDim.y;
  int t = blockIdx.y;
  if (t < tiles) stage(t, 0);
  cpa::commit();
  for (int buf = 0; t < tiles; t += step, buf ^= 1) {
    if (t + step < tiles) stage(t + step, buf ^ 1);
    cpa::commit();
    cpa::wait<1>();
    fence_async_smem();
    __syncthreads();
    // this thread's A words: m 2 tig, +1 (+ 8 for a[2], a[3]) of pixel gid
    // (+ 8: 16 patch columns on, for a[1], a[3]) of tile row `warp`
    const unsigned short* pr =
        ds + buf * M * MX_DMH + 2 * tig * MX_DMH + 2 * warp * MX_PITCH + 2 * gid + 7;
    uint32_t a[9][4];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const unsigned short* p = pr + (tap / 3) * MX_PITCH + tap % 3;
      a[tap][0] = pack_raw(p[0], p[MX_DMH]);
      a[tap][1] = pack_raw(p[16], p[MX_DMH + 16]);
      a[tap][2] = pack_raw(p[8 * MX_DMH], p[9 * MX_DMH]);
      a[tap][3] = pack_raw(p[8 * MX_DMH + 16], p[9 * MX_DMH + 16]);
    }
    float acc[MX_NC / 2];
#pragma unroll
    for (int e = 0; e < MX_NC / 2; ++e) acc[e] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      wgmma_bf16<MX_NC>(acc, a[tap], kmajor_desc_b16(ws + tap * M * MX_NC, 128, 256));
    wgmma_commit();
    wgmma_wait<0>();
    hold(acc);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) hold(a[tap]);

    // acc[4j + 2h + e]: pixel gid + 8h of tile row `warp`, channel co0 + 8j + 2 tig + e
    const int b = t / per_image, r = t - b * per_image;
    const int oy = (r / tiles_x) * MX_TH + warp;
    if (oy < Hg) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ox = (r % tiles_x) * MX_TW + gid + 8 * h;
        if (ox >= Wg) continue;
        __nv_bfloat16* orow = dx + (((long)b * Hg + oy) * Wg + ox) * C;
#pragma unroll
        for (int j = 0; j < MX_NC / 8; ++j) {
          const int c = co0 + 8 * j + 2 * tig;
          if (c >= C) break;
          if ((C & 1) == 0) {
            *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(acc[4 * j + 2 * h],
                                                                acc[4 * j + 2 * h + 1]);
          } else {
            orow[c] = __float2bfloat16_rn(acc[4 * j + 2 * h]);
            if (c + 1 < C) orow[c + 1] = __float2bfloat16_rn(acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }
    __syncthreads();  // the buffer is restaged two tiles on
  }
}

// persistent blocks of dx_mma_kernel a channel group
inline int mx_blocks(int B, int Hg, int Wg, int n_groups) {
  const long tiles = (long)B * ((Hg + MX_TH - 1) / MX_TH) * ((Wg + MX_TW - 1) / MX_TW);
  const long want = (long)MX_BLOCKS_PER_SM * bwd::CARD_SMS / n_groups;
  return (int)(tiles < want ? tiles : (want > 0 ? want : 1));
}

struct Layout {  // the scratch buffer, in floats
  long dy1, part_a, w1t, part_w, tmp, total;
  int blocks_a, np, slices;
};

Layout layout(int B, int Hg, int Wg, int C, int K) {
  Layout l;
  const int H1 = 2 * Hg, W1 = 2 * Wg;
  const long long n = (long long)B * Hg * Wg;
  l.np = M * K * 9 + M + K;
  l.blocks_a = ((W1 + TC - 1) / TC) * ((H1 + TR - 1) / TR) * B;
  l.slices = bwd::wgrad_s2_slices(n, C);
  l.dy1 = 0;  // f32 (B, M, H1, W1); the bf16 form's dY1 takes its first half
  l.part_a = l.dy1 + bwd::align4((long)B * M * H1 * W1);
  l.w1t = l.part_a + bwd::align4((long)l.blocks_a * l.np);
  // w1 laid out (M 9, C), or for the bf16 form rounded into prep_w1_kernel's
  // groups (MX_WB bf16 each)
  const long groups_floats = (long)((C + MX_NC - 1) / MX_NC) * MX_WB / 2;
  l.part_w = l.w1t + bwd::align4((long)C * M * 9 > groups_floats ? (long)C * M * 9
                                                                 : groups_floats);
  l.tmp = l.part_w + bwd::align4(bwd::wgrad_s2_partial_floats(n, C));
  const long t1 = bwd::reduce_scratch_floats(l.blocks_a, l.np);
  const long t2 = bwd::reduce_scratch_floats(l.slices, C * M * 9);
  l.total = l.tmp + (t1 > t2 ? t1 : t2);
  return l;
}

template <typename T>
int launch(const T* x, const float* y1, const float* g, const float* w1,
           const float* w2, T* dx, float* dw1, float* dw2b, float* scratch, int B,
           int Hg, int Wg, int C, int K, void* stream) {
  constexpr bool RND = !std::is_same_v<T, float>;
  cudaStream_t s = (cudaStream_t)stream;
  const Layout l = layout(B, Hg, Wg, C, K);
  const int H1 = 2 * Hg, W1 = 2 * Wg;
  T* dy1 = reinterpret_cast<T*>(scratch + l.dy1);
  const dim3 grid_a((W1 + TC - 1) / TC, (H1 + TR - 1) / TR, B);
  cudaError_t err;
  if (K == 8) {
    dy1_kernel<T, 8><<<grid_a, NT_A, dy1_smem_bytes<8>(), s>>>(g, y1, w2, dy1,
                                                               scratch + l.part_a, H1, W1);
  } else if (K == 24) {
    err = cudaFuncSetAttribute(dy1_kernel<T, 24>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dy1_smem_bytes<24>());
    if (err != cudaSuccess) return (int)err;
    dy1_kernel<T, 24><<<grid_a, NT_A, dy1_smem_bytes<24>(), s>>>(g, y1, w2, dy1,
                                                                 scratch + l.part_a, H1, W1);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if constexpr (RND) {
    __nv_bfloat16* w1p = reinterpret_cast<__nv_bfloat16*>(scratch + l.w1t);
    const int n_groups = (C + MX_NC - 1) / MX_NC;
    prep_w1_kernel<<<(n_groups * MX_WB + 255) / 256, 256, 0, s>>>(w1, w1p, C, n_groups);
    err = cudaFuncSetAttribute(dx_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MX_SMEM);
    if (err != cudaSuccess) return (int)err;
    dx_mma_kernel<<<dim3(n_groups, mx_blocks(B, Hg, Wg, n_groups)), MX_NT, MX_SMEM, s>>>(
        dy1, w1p, dx, B, Hg, Wg, C, H1, W1);
  } else {
    bwd::transpose(w1, scratch + l.w1t, 1, C, M * 9, s);  // (C, M 9) -> (M 9, C)
    const int n_groups = (C + CG - 1) / CG;
    const dim3 grid_b((Wg + TOW - 1) / TOW, (Hg + TOH - 1) / TOH, B * n_groups);
    dx_kernel<<<grid_b, NT_B, 0, s>>>(dy1, scratch + l.w1t, dx, Hg, Wg, C, H1, W1,
                                      n_groups);
  }
  err = bwd::wgrad_s2(x, dy1, scratch + l.part_w, B, Hg, Wg, C, H1, W1, s);
  if (err != cudaSuccess) return (int)err;
  bwd::reduce_partials(scratch + l.part_a, l.blocks_a, l.np, dw2b, scratch + l.tmp, s);
  bwd::reduce_partials(scratch + l.part_w, l.slices, C * M * 9, dw1, scratch + l.tmp, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch dec_aff_tail_bwd_f32 and dec_aff_tail_bwd_bf16 need.
extern "C" long long dec_aff_tail_bwd_scratch_floats(int B, int Hg, int Wg,
                                                     int C, int K) {
  return layout(B, Hg, Wg, C, K).total;
}

// x (B, Hg, Wg, C) NHWC; y1 (B, 16, 2Hg, 2Wg), the forward's intermediate;
// g (B, K, 4Hg, 4Wg); w1 (C, 16, 3, 3); w2 (16, K, 3, 3). Writes dx (as x),
// dw1 (as w1) and dw2b = [dW2 (16 K 9) | db1 (16) | db2 (K)]. K must be 8 or
// 24. Returns cudaGetLastError() after the last launch. The bf16 form takes
// a bf16 x and writes a bf16 dx; y1 (bf16 values), g, the weights and the
// gradients of the weights are f32 in both. W1 = 2 Wg is even, as the bf16
// form's word copies of dY1 need.
extern "C" int dec_aff_tail_bwd_f32(const float* x, const float* y1,
                                    const float* g, const float* w1,
                                    const float* w2, float* dx, float* dw1,
                                    float* dw2b, float* scratch, int B, int Hg,
                                    int Wg, int C, int K, void* stream) {
  return launch<float>(x, y1, g, w1, w2, dx, dw1, dw2b, scratch, B, Hg, Wg, C, K, stream);
}

extern "C" int dec_aff_tail_bwd_bf16(const __nv_bfloat16* x, const float* y1,
                                     const float* g, const float* w1,
                                     const float* w2, __nv_bfloat16* dx, float* dw1,
                                     float* dw2b, float* scratch, int B, int Hg,
                                     int Wg, int C, int K, void* stream) {
  return launch<__nv_bfloat16>(x, y1, g, w1, w2, dx, dw1, dw2b, scratch, B, Hg, Wg, C, K,
                               stream);
}

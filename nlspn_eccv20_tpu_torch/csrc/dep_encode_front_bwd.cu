// Backward of the encode_dep front (K5): the gradients of
//
//   p0  = relu(conv0(x) + b0)        x  (B, H, W) plane,  w0 (16, 1, 3, 3)
//   out = relu(conv1(p0) + b1)       p0 (B, 16, H1, W1),  w1 (C1, 16, 3, 3)
//
// (both Conv2d k3/s2/p1, torch layout; H1 = ceil(H/2), out is NHWC
// (B, Ho, Wo, C1), Ho = ceil(H1/2)) given g = dL/d(out):
//
//   gm  = g [out > 0]
//   dP0 = [p0 > 0] * convT(gm, w1)     a k3/s2/p1 transposed conv, C1 -> 16
//   dx  = convT(dP0, w0)               the same, 16 -> 1: the plane's gradient
//   dW1[c][m][t] = sum gm[i][j][c] p0[m][2i-1+ty][2j-1+tx],    db1 = sum gm
//   dW0[m][t]    = sum dP0[m][Y][X] x[2Y-1+ty][2X-1+tx],       db0 = sum dP0
//
// Replaces the TPU kernel dep_encode_front._bwd_kernel
// (nlspn_eccv20_tpu/ops/pallas/dep_encode_front.py, reached from
// _bwd_pallas). Like the TPU kernel it recomputes p0 (9 FMAs per value, in
// the forward kernel's order, so that the relu mask is the forward's); the
// mask [out > 0] comes from the forward's output, which autograd keeps.
//
// Bound on the card: operations. At NYU b=12 (228x304 -> 57x76x256) convT
// and dW1 are 3.8 GFLOP each, conv0's parts 0.1, against about 110 MB of
// tensors. Four kernels, one launch sequence:
//   1. dp0_kernel: convT(gm, w1) with the forward decode_aff tail's quad
//      scheme (dec_aff_tail.cu): one base pixel and its right and lower
//      neighbours give a 2x2 quad of p0 positions through all nine taps.
//      Per block an 8x8 tile of quads (16x16 positions); gm's channels stream
//      through shared memory in chunks of 32 with their weights, each thread
//      owns 4 quads of a row and 4 of the 16 channels, the chunk's channels
//      are split over 4 slices of threads whose sums are added in slice
//      order. The epilogue recomputes p0, masks, and writes dP0 and p0.
//   2. dx0_kernel: per 16x32 tile of the plane, dx from dP0's patch in
//      shared memory, and the tile's partial sums of dW0 and db0.
//   3. bwd::wgrad_s2 (bwd_common.cuh): dW1 and db1 as 64 slice partials.
//   4. bwd::reduce_partials: the partials of 2 and 3 added in a fixed order.
// No atomics: the result is the same bits from run to run. Any H and W, as
// the forward. Plain f32 FMAs: no tensor cores.

#include <cuda_runtime.h>

#include "bwd_common.cuh"

namespace {

constexpr int M = bwd::M;

// ---- 1. dP0 = [p0 > 0] convT(gm, w1), and p0 ----
constexpr int TH = 8;            // quad rows per tile
constexpr int TW = 8;            // quad cols per tile
constexpr int P = 4;             // quads per thread, along a row
constexpr int CC = 32;           // gm channels per shared-memory chunk
constexpr int NS = 4;            // channel slices of a chunk
constexpr int SEGS = TW / P;     // row segments of P quads
constexpr int NI = TH * SEGS * 4;  // threads per slice (4 channel groups)
constexpr int NT_A = NS * NI;    // 256
constexpr int XR = TH + 1;       // gm tile rows / cols (quads, plus one)
constexpr int XC = TW + 1;
static_assert(TW % P == 0, "row segments tile the quad row");
static_assert(CC % NS == 0, "slices split a chunk evenly");

#define FMA4(A, W, X)          \
  A[0] = fmaf((W).x, X, A[0]); \
  A[1] = fmaf((W).y, X, A[1]); \
  A[2] = fmaf((W).z, X, A[2]); \
  A[3] = fmaf((W).w, X, A[3]);

__global__ void __launch_bounds__(NT_A)
dp0_kernel(const float* __restrict__ x, const float* __restrict__ g,
           const float* __restrict__ out, const float* __restrict__ w0,
           const float* __restrict__ b0, const float* __restrict__ w1,
           float* __restrict__ dp0, float* __restrict__ p0,
           int H, int W, int C1) {
  __shared__ __align__(16) float w1s[CC * 9 * M];  // [cc][tap][m]
  __shared__ float gms[CC][XR][XC];
  __shared__ float dps[M][2 * TH][2 * TW];
  __shared__ float w0s[M * 9];
  __shared__ float b0s[M];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int a0 = blockIdx.y * TH, t0 = blockIdx.x * TW;  // quad-grid origin
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  const int Ho = (H1 + 1) / 2, Wo = (W1 + 1) / 2;
  const long gbase = (long)b * Ho * Wo * C1;

  for (int i = tid; i < M * 9; i += NT_A) w0s[i] = __ldg(w0 + i);
  if (tid < M) b0s[tid] = __ldg(b0 + tid);

  const int s = tid / NI, it = tid % NI;
  const int grp = it & 3;
  const int seg = (it >> 2) % SEGS;
  const int qr = (it >> 2) / SEGS;
  const int qc0 = seg * P;
  float acc[P][4][4];  // [quad][position of the quad][channel]
#pragma unroll
  for (int k = 0; k < P; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][q][j] = 0.0f;

  for (int c0 = 0; c0 < C1; c0 += CC) {
    __syncthreads();
    for (int i = tid; i < XR * XC * CC; i += NT_A) {
      const int cc = i % CC, pix = i / CC;
      const int r = pix / XC, c = pix % XC;
      const int gy = a0 + r, gx = t0 + c, ch = c0 + cc;
      float v = 0.0f;
      if (gy < Ho && gx < Wo && ch < C1) {
        const long o = gbase + ((long)gy * Wo + gx) * C1 + ch;
        v = __ldg(out + o) > 0.0f ? __ldg(g + o) : 0.0f;
      }
      gms[cc][r][c] = v;
    }
    for (int i = tid; i < CC * 9 * M; i += NT_A) {  // w1 is (C1, M, 3, 3)
      const int cc = i / (9 * M), rem = i % (9 * M);
      const int m = rem / 9, tap = rem % 9;
      w1s[(cc * 9 + tap) * M + m] = (c0 + cc < C1) ? __ldg(w1 + (long)c0 * 9 * M + i) : 0.0f;
    }
    __syncthreads();
#pragma unroll 1
    for (int cc = s; cc < CC; cc += NS) {
      const float* gc = &gms[cc][qr][qc0];
      float ga[P + 1], gb[P + 1];  // gm rows qr and qr + 1
#pragma unroll
      for (int k = 0; k <= P; ++k) {
        ga[k] = gc[k];
        gb[k] = gc[XC + k];
      }
      const float4* w = reinterpret_cast<const float4*>(w1s + cc * 9 * M) + grp;
      // w[tap * 4] is taps (ty, tx) = (tap / 3, tap % 3), channels 4grp..4grp+3
      const float4 w00 = w[0], w01 = w[4], w02 = w[8], w10 = w[12],
                   w11 = w[16], w12 = w[20], w20 = w[24], w21 = w[28],
                   w22 = w[32];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float x00 = ga[k], x01 = ga[k + 1], x10 = gb[k], x11 = gb[k + 1];
        FMA4(acc[k][0], w11, x00)
        FMA4(acc[k][1], w12, x00) FMA4(acc[k][1], w10, x01)
        FMA4(acc[k][2], w21, x00) FMA4(acc[k][2], w01, x10)
        FMA4(acc[k][3], w22, x00) FMA4(acc[k][3], w20, x01) FMA4(acc[k][3], w02, x10)
        FMA4(acc[k][3], w00, x11)
      }
    }
  }
  // Add the slices' sums in slice order.
#pragma unroll 1
  for (int r = 0; r < NS; ++r) {
    __syncthreads();
    if (s != r) continue;
#pragma unroll
    for (int k = 0; k < P; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int v = 2 * qr + (q >> 1), u = 2 * (qc0 + k) + (q & 1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = 4 * grp + j;
          dps[m][v][u] = r == 0 ? acc[k][q][j] : dps[m][v][u] + acc[k][q][j];
        }
      }
  }
  __syncthreads();

  // p0 recomputed as dep_encode_front.cu computes it, then the mask.
  const float* xb = x + (long)b * H * W;
  for (int i = tid; i < M * 4 * TH * TW; i += NT_A) {
    const int u = i % (2 * TW), v = (i / (2 * TW)) % (2 * TH), m = i / (4 * TH * TW);
    const int Y = 2 * a0 + v, X = 2 * t0 + u;
    if (Y >= H1 || X >= W1) continue;
    float sum = b0s[m];
#pragma unroll
    for (int ty = 0; ty < 3; ++ty) {
      const int yy = 2 * Y - 1 + ty;
      if (yy < 0 || yy >= H) continue;
#pragma unroll
      for (int tx = 0; tx < 3; ++tx) {
        const int xx = 2 * X - 1 + tx;
        if (xx < 0 || xx >= W) continue;
        sum = fmaf(w0s[m * 9 + ty * 3 + tx], __ldg(xb + (long)yy * W + xx), sum);
      }
    }
    const float pv = fmaxf(sum, 0.0f);
    const long o = (((long)b * M + m) * H1 + Y) * W1 + X;
    p0[o] = pv;
    dp0[o] = pv > 0.0f ? dps[m][v][u] : 0.0f;
  }
}

#undef FMA4

// ---- 2. dx = convT(dP0, w0), and partial dW0 / db0 ----
constexpr int FY = 16;           // plane tile rows
constexpr int FX = 32;           // plane tile cols
constexpr int PY = FY / 2;       // owned p0 rows / cols
constexpr int PX = FX / 2;
constexpr int NT_B = 256;
constexpr int NPB = M * 9 + M;   // partials per block: dW0 | db0

__global__ void __launch_bounds__(NT_B)
dx0_kernel(const float* __restrict__ x, const float* __restrict__ dp0,
           const float* __restrict__ w0, float* __restrict__ dx,
           float* __restrict__ part, int H, int W) {
  __shared__ float dps[M][PY + 1][PX + 1];
  __shared__ float xs[FY + 1][FX + 1];
  __shared__ float w0s[M * 9];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int Y0 = blockIdx.y * PY, X0 = blockIdx.x * PX;
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  float* pb = part + (long)((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * NPB;

  for (int i = tid; i < M * 9; i += NT_B) w0s[i] = __ldg(w0 + i);
  for (int i = tid; i < M * (PY + 1) * (PX + 1); i += NT_B) {
    const int c = i % (PX + 1), r = (i / (PX + 1)) % (PY + 1), m = i / ((PX + 1) * (PY + 1));
    const int Y = Y0 + r, X = X0 + c;
    dps[m][r][c] = (Y < H1 && X < W1) ? __ldg(dp0 + (((long)b * M + m) * H1 + Y) * W1 + X) : 0.0f;
  }
  for (int i = tid; i < (FY + 1) * (FX + 1); i += NT_B) {
    const int c = i % (FX + 1), r = i / (FX + 1);
    const int yy = 2 * Y0 - 1 + r, xx = 2 * X0 - 1 + c;
    xs[r][c] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
        ? __ldg(x + ((long)b * H + yy) * W + xx) : 0.0f;
  }
  __syncthreads();

  // dx at plane pixel (2 Y0 + ly, 2 X0 + lx): taps with (l + 1 - t) even
  for (int i = tid; i < FY * FX; i += NT_B) {
    const int ly = i / FX, lx = i % FX;
    const int yy = 2 * Y0 + ly, xx = 2 * X0 + lx;
    if (yy >= H || xx >= W) continue;
    float d = 0.0f;
    for (int ty = (ly + 1) & 1; ty < 3; ty += 2) {
      const int yl = (ly + 1 - ty) >> 1;
      for (int tx = (lx + 1) & 1; tx < 3; tx += 2) {
        const int xl = (lx + 1 - tx) >> 1;
        for (int m = 0; m < M; ++m) d = fmaf(w0s[m * 9 + ty * 3 + tx], dps[m][yl][xl], d);
      }
    }
    dx[((long)b * H + yy) * W + xx] = d;
  }

  // partial dW0 (thread = (m, tap)) and db0 (thread = m) over owned positions
  if (tid < M * 9) {
    const int m = tid / 9, ty = (tid % 9) / 3, tx = tid % 3;
    float a = 0.0f;
    for (int yl = 0; yl < PY; ++yl)
      for (int xl = 0; xl < PX; ++xl)
        a = fmaf(xs[2 * yl + ty][2 * xl + tx], dps[m][yl][xl], a);
    pb[tid] = a;
  } else if (tid < NPB) {
    const int m = tid - M * 9;
    float a = 0.0f;
    for (int yl = 0; yl < PY; ++yl)
      for (int xl = 0; xl < PX; ++xl) a += dps[m][yl][xl];
    pb[tid] = a;
  }
}

struct Layout {  // the scratch buffer, in floats
  long dp0, p0, part_b, part_w, tmp, total;
  int blocks_b;
};

Layout layout(int B, int H, int W, int C1) {
  Layout l;
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  l.blocks_b = ((W + FX - 1) / FX) * ((H + FY - 1) / FY) * B;
  l.dp0 = 0;
  l.p0 = l.dp0 + (long)B * M * H1 * W1;
  l.part_b = l.p0 + (long)B * M * H1 * W1;
  l.part_w = l.part_b + (long)l.blocks_b * NPB;
  l.tmp = l.part_w + bwd::wgrad_s2_partial_floats(C1, 1);
  const long t1 = bwd::reduce_scratch_floats(l.blocks_b, NPB);
  const long t2 = bwd::reduce_scratch_floats(bwd::WG_SLICES, C1 * M * 9 + C1);
  l.total = l.tmp + (t1 > t2 ? t1 : t2);
  return l;
}

}  // namespace

// Floats of scratch dep_encode_front_bwd_f32 needs.
extern "C" long long dep_encode_front_bwd_scratch_floats(int B, int H, int W,
                                                         int C1) {
  return layout(B, H, W, C1).total;
}

// x (B, H, W); g and out (B, Ho, Wo, C1) NHWC, out the forward's output;
// w0 (16, 1, 3, 3), b0 (16); w1 (C1, 16, 3, 3). Writes dx (as x),
// dw0b = [dW0 (16 9) | db0 (16)] and dw1b = [dW1 (C1 16 9) | db1 (C1)].
// Returns cudaGetLastError() after the last launch.
extern "C" int dep_encode_front_bwd_f32(const float* x, const float* g,
                                        const float* out, const float* w0,
                                        const float* b0, const float* w1,
                                        float* dx, float* dw0b, float* dw1b,
                                        float* scratch, int B, int H, int W,
                                        int C1, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Layout l = layout(B, H, W, C1);
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  const int Ho = (H1 + 1) / 2, Wo = (W1 + 1) / 2;
  float* dp0 = scratch + l.dp0;
  float* p0 = scratch + l.p0;
  const dim3 grid_a((Wo + TW - 1) / TW, (Ho + TH - 1) / TH, B);
  dp0_kernel<<<grid_a, NT_A, 0, s>>>(x, g, out, w0, b0, w1, dp0, p0, H, W, C1);
  const dim3 grid_b((W + FX - 1) / FX, (H + FY - 1) / FY, B);
  dx0_kernel<<<grid_b, NT_B, 0, s>>>(x, dp0, w0, dx, scratch + l.part_b, H, W);
  bwd::wgrad_s2(g, out, p0, scratch + l.part_w, B, Ho, Wo, C1, H1, W1, 1, s);
  bwd::reduce_partials(scratch + l.part_b, l.blocks_b, NPB, dw0b, scratch + l.tmp, s);
  bwd::reduce_partials(scratch + l.part_w, bwd::WG_SLICES, C1 * M * 9 + C1, dw1b,
                       scratch + l.tmp, s);
  return (int)cudaGetLastError();
}

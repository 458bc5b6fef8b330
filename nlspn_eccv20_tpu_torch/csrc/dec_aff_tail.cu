// The decode_aff tail: deconv2(relu(deconv1(x))), both ConvTranspose2d
// k3/s2/p1/output_padding 1, with the 16-channel intermediate kept on chip.
//
// Replaces the TPU kernel dec_aff_tail._fwd_kernel
// (nlspn_eccv20_tpu/ops/pallas/dec_aff_tail.py, reached from _fwd_pallas).
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
// Bound on the card: operations. At NYU size (Hg, Wg = 64, 80; C = 256)
// deconv1 is 0.38 GFLOP and deconv2 0.05 against 5.2 MB read and 2.6 MB
// written, well above the FP32 cores' ratio of flops to bytes. What limits
// a direct kernel is shared-memory load bandwidth: a float4 load that many
// threads broadcast still takes four cycles of the SM's shared-memory pipe,
// so the weights must feed many FMAs per load. Design: one block per
// TH x TW tile of the base grid. deconv1 streams x's channels through shared
// memory in chunks of CC together with the chunk's weights. Each thread owns
// P neighbouring input quads of one row and four of the 16 intermediate
// channels (64 accumulators): per input channel it loads the 9 taps' weights
// once (float4 broadcasts) and 2 (P + 1) x values, and does 36 P FMAs. The
// chunk's channels are split over NS slices of threads, whose sums are added
// in slice order in shared memory (deterministic). The tile's 16-channel
// intermediate, with a one-pixel halo that the neighbouring tile also
// computes, stays in shared memory; deconv2 reads it there, each thread
// owning one output quad and four output channels, with its weights in the
// shared memory that deconv1's chunks used, and writes the planar output as
// coalesced float2 pairs. The TPU kernel's phase decomposition into shifted
// matmuls, its one-hot interleave matmuls and its 128-lane padding are
// Mosaic devices and are not carried over. Plain f32 FMAs: no tensor cores.
//
// For training the caller may pass y1 (B, 16, 2Hg, 2Wg): each block then
// also writes the intermediate it owns (without the halo), and the backward
// (dec_aff_tail_bwd.cu) reads it instead of recomputing deconv1.

#include <cuda_runtime.h>

namespace {

constexpr int M = 16;           // deconv1 output channels
constexpr int TH = 7;           // base-grid tile rows
constexpr int TW = 7;           // base-grid tile cols
constexpr int P = 4;            // deconv1 quads per thread, along a row
constexpr int CC = 32;          // input channels per shared-memory chunk
constexpr int NS = 4;           // channel slices of a chunk
constexpr int QR = TH + 1;      // deconv1 quad rows / cols (with the halo)
constexpr int QC = TW + 1;
constexpr int SEGS = QC / P;    // row segments of P quads
constexpr int NI = QR * SEGS * 4;  // threads per slice (4 channel groups)
constexpr int NT = NS * NI;     // threads per block
constexpr int XR = TH + 2;      // x tile rows (quad rows, plus one below)
constexpr int XC = TW + 2;
constexpr int YR = 2 * TH + 2;  // intermediate tile rows (halo row + 1)
constexpr int YC = 2 * TW + 2;
constexpr int NQ2 = (2 * TH) * (2 * TW);  // deconv2 quads per tile
constexpr int PHASE1 = CC * 9 * M + CC * XR * XC;
static_assert(QC % P == 0, "row segments tile the quad row");
static_assert(CC % NS == 0, "slices split a chunk evenly");

#define FMA4(A, W, X)          \
  A[0] = fmaf((W).x, X, A[0]); \
  A[1] = fmaf((W).y, X, A[1]); \
  A[2] = fmaf((W).z, X, A[2]); \
  A[3] = fmaf((W).w, X, A[3]);

template <int K>
__global__ void __launch_bounds__(NT)
dec_aff_tail_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ out,
                    float* __restrict__ y1out, int Hg, int Wg, int C) {
  static_assert(K % 4 == 0, "K in groups of 4");
  static_assert(M * 9 * K + K <= PHASE1, "deconv2 weights fit the union");
  // The union holds [w1s | xs] while deconv1 runs, then [w2s | b2s].
  __shared__ __align__(16) float un[PHASE1];
  __shared__ float y1s[M][YR][YC];
  float* w1s = un;                 // [CC][9][M]
  float* xs = un + CC * 9 * M;     // [CC][XR][XC]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int a0 = blockIdx.y * TH;  // base-grid origin of the tile
  const int t0 = blockIdx.x * TW;
  const float* xb = x + (long)b * Hg * Wg * C;

  // ---- deconv1: thread = (slice s, quad row qr, segment, channel group g) ----
  const int s = tid / NI, it = tid % NI;
  const int g = it & 3;
  const int seg = (it >> 2) % SEGS;
  const int qr = (it >> 2) / SEGS;
  const int qc0 = seg * P;
  float acc[P][4][4];  // [quad][pixel of the quad][channel]
#pragma unroll
  for (int k = 0; k < P; ++k)
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][p][j] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    __syncthreads();
    for (int i = tid; i < XR * XC * CC; i += NT) {
      const int cc = i % CC, pix = i / CC;
      const int r = pix / XC, c = pix % XC;
      const int gy = a0 + r, gx = t0 + c, ch = c0 + cc;
      xs[(cc * XR + r) * XC + c] =
          (gy < Hg && gx < Wg && ch < C) ? __ldg(xb + ((long)gy * Wg + gx) * C + ch) : 0.0f;
    }
    for (int i = tid; i < CC * 9 * M; i += NT) {
      const int cc = i / (9 * M), rem = i % (9 * M);
      const int m = rem / 9, tap = rem % 9;
      w1s[(cc * 9 + tap) * M + m] = (c0 + cc < C) ? __ldg(w1 + (long)c0 * 9 * M + i) : 0.0f;
    }
    __syncthreads();
#pragma unroll 1
    for (int cc = s; cc < CC; cc += NS) {
      const float* xc = xs + cc * XR * XC + qr * XC + qc0;
      float xa[P + 1], xb2[P + 1];  // x rows qr and qr + 1
#pragma unroll
      for (int k = 0; k <= P; ++k) {
        xa[k] = xc[k];
        xb2[k] = xc[XC + k];
      }
      const float4* w = reinterpret_cast<const float4*>(w1s + cc * 9 * M) + g;
      // w[tap * 4] is taps (ty, tx) = (tap / 3, tap % 3), channels 4g..4g+3
      const float4 w00 = w[0], w01 = w[4], w02 = w[8], w10 = w[12],
                   w11 = w[16], w12 = w[20], w20 = w[24], w21 = w[28],
                   w22 = w[32];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float x00 = xa[k], x01 = xa[k + 1], x10 = xb2[k], x11 = xb2[k + 1];
        FMA4(acc[k][0], w11, x00)
        FMA4(acc[k][1], w12, x00) FMA4(acc[k][1], w10, x01)
        FMA4(acc[k][2], w21, x00) FMA4(acc[k][2], w01, x10)
        FMA4(acc[k][3], w22, x00) FMA4(acc[k][3], w20, x01) FMA4(acc[k][3], w02, x10)
        FMA4(acc[k][3], w00, x11)
      }
    }
  }
  // Add the slices' sums in slice order; the last adds bias, ReLU, mask.
#pragma unroll 1
  for (int r = 0; r < NS; ++r) {
    __syncthreads();
    if (s != r) continue;
#pragma unroll
    for (int k = 0; k < P; ++k)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int v = 2 * qr + (p >> 1), u = 2 * (qc0 + k) + (p & 1);
        const bool inside = 2 * a0 + v < 2 * Hg && 2 * t0 + u < 2 * Wg;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = 4 * g + j;
          float sum = r == 0 ? acc[k][p][j] : y1s[m][v][u] + acc[k][p][j];
          if (r == NS - 1) sum = inside ? fmaxf(sum + __ldg(b1 + m), 0.0f) : 0.0f;
          y1s[m][v][u] = sum;
        }
      }
  }
  __syncthreads();

  if (y1out) {  // the owned 2TH x 2TW intermediate, coalesced along u
    const int H1 = 2 * Hg, W1 = 2 * Wg;
    for (int i = tid; i < M * 2 * TH * 2 * TW; i += NT) {
      const int u = i % (2 * TW), v = (i / (2 * TW)) % (2 * TH), m = i / (4 * TH * TW);
      const int gy = 2 * a0 + v, gx = 2 * t0 + u;
      if (gy < H1 && gx < W1)
        y1out[(((long)b * M + m) * H1 + gy) * W1 + gx] = y1s[m][v][u];
    }
  }

  // ---- deconv2: thread = (quad, group of 4 output channels) ----
  float* w2s = un;            // [M][9][K]
  float* b2s = un + M * 9 * K;
  for (int i = tid; i < M * 9 * K; i += NT) {
    const int m = i / (9 * K), rem = i % (9 * K);
    const int k = rem / 9, tap = rem % 9;
    w2s[(m * 9 + tap) * K + k] = __ldg(w2 + i);
  }
  for (int i = tid; i < K; i += NT) b2s[i] = __ldg(b2 + i);
  __syncthreads();

  const int Ho = 4 * Hg, Wo = 4 * Wg;
  float* ob = out + (long)b * K * Ho * Wo;
  for (int item = tid; item < NQ2 * (K / 4); item += NT) {
    const int kg = item / NQ2, qq = item % NQ2;
    const int u = qq / (2 * TW), w = qq % (2 * TW);
    float o[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[p][j] = b2s[4 * kg + j];
#pragma unroll 4
    for (int m = 0; m < M; ++m) {
      const float y00 = y1s[m][u][w], y01 = y1s[m][u][w + 1];
      const float y10 = y1s[m][u + 1][w], y11 = y1s[m][u + 1][w + 1];
      const float4* wm = reinterpret_cast<const float4*>(w2s + m * 9 * K) + kg;
      constexpr int S = K / 4;  // float4s per tap
      const float4 v00 = wm[0 * S], v01 = wm[1 * S], v02 = wm[2 * S],
                   v10 = wm[3 * S], v11 = wm[4 * S], v12 = wm[5 * S],
                   v20 = wm[6 * S], v21 = wm[7 * S], v22 = wm[8 * S];
      FMA4(o[0], v11, y00)
      FMA4(o[1], v12, y00) FMA4(o[1], v10, y01)
      FMA4(o[2], v21, y00) FMA4(o[2], v01, y10)
      FMA4(o[3], v22, y00) FMA4(o[3], v20, y01) FMA4(o[3], v02, y10)
      FMA4(o[3], v00, y11)
    }
    const int gy = 4 * a0 + 2 * u, gx = 4 * t0 + 2 * w;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* oc = ob + (long)(4 * kg + j) * Ho * Wo;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        if (gy + dy >= Ho) continue;
        float* row = oc + (long)(gy + dy) * Wo + gx;
        if (gx + 1 < Wo) {
          *reinterpret_cast<float2*>(row) = make_float2(o[2 * dy][j], o[2 * dy + 1][j]);
        } else if (gx < Wo) {
          row[0] = o[2 * dy][j];
        }
      }
    }
  }
}

#undef FMA4

}  // namespace

// Returns cudaGetLastError() after the launch. K must be 8 or 24. y1 may be
// null (no intermediate written).
extern "C" int dec_aff_tail_f32(const float* x, const float* w1,
                                const float* b1, const float* w2,
                                const float* b2, float* out, float* y1,
                                int B, int Hg, int Wg, int C, int K,
                                void* stream) {
  const dim3 grid((Wg + TW - 1) / TW, (Hg + TH - 1) / TH, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (K == 8) {
    dec_aff_tail_kernel<8><<<grid, NT, 0, s>>>(x, w1, b1, w2, b2, out, y1, Hg, Wg, C);
  } else if (K == 24) {
    dec_aff_tail_kernel<24><<<grid, NT, 0, s>>>(x, w1, b1, w2, b2, out, y1, Hg, Wg, C);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

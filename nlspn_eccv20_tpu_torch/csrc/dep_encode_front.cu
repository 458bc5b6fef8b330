// The encode_dep front: relu(conv1(relu(conv0(x)))), both Conv2d k3/s2/p1,
// with conv0's 16-channel output kept on chip.
//
// Replaces the TPU kernel dep_encode_front._fwd_kernel
// (nlspn_eccv20_tpu/ops/pallas/dep_encode_front.py, reached from
// _fwd_pallas; _recompute_fwd is the same forward inside its backward).
//
//   x   (B, H, W) f32 plane                 the loop's depth / max_depth
//   w0  (16, 1, 3, 3), b0 (16)              torch Conv2d layout
//   w1  (C1, 16, 3, 3), b1 (C1)             C1 = 2 * GRU_input_dim (256)
//   out (B, Ho, Wo, C1) f32, NHWC           H1 = ceil(H/2), Ho = ceil(H1/2)
//
// Any H, W and C1: out-of-range taps read the convs' zero padding, and
// channels past C1 are masked.
//
// Bound on the card: operations. At NYU size (256 x 320 -> 64 x 80 x 256)
// conv1 is 0.38 GFLOP against 0.3 MB read and 5.2 MB written. What limits
// a direct kernel is the shared-memory pipe: the first form of this kernel
// gave each thread one channel and 8 pixels, 9 shared loads for 8 FMAs.
// Design, as the decode_aff tail (dec_aff_tail.cu) does it: one block per
// TOH x TOW output tile and group of CB output channels. The block stages
// the plane's tile (with conv0's halo) and the group's conv1 weights,
// transposed to [m * 9 + tap][channel] with a 16-byte pitch, in shared
// memory; computes the tile's conv0 patch (16 channels, with the one-pixel
// halo conv1 needs; zero where conv1's padding lies) from the staged plane,
// each thread one patch pixel for all 16 channels (9 plane loads and 36
// float4 weight broadcasts for 144 FMAs); then each thread owns 4 output
// channels and a row of 8 output pixels (32 accumulators): per conv0
// channel and tap row it loads the 17 patch values of the row once (four
// float4 loads and one word, shared by the 8 channel quads of a warp) and
// one float4 of weights per tap (8 channel quads a warp, 128 bytes), and
// does 96 FMAs. Stores are one float4 of channels per pixel, NHWC. Each of
// the C1 / CB channel-group blocks of a tile recomputes the conv0 patch: 7%
// of its FMAs. The TPU kernel's 16-phase de-interleave, one-hot decimation
// matmuls and H % 4 == W % 4 == 0 restriction are Mosaic devices and are
// not carried over. Plain f32 FMAs in the order of the first form: no
// tensor cores.
//
// The bf16 form, K3-bf16, has its own source: dep_encode_front_bf16.cu.

#include <cuda_runtime.h>

namespace {

constexpr int M = 16;              // conv0 output channels
constexpr int TOH = 4;             // output tile rows
constexpr int TOW = 16;            // output tile cols
constexpr int PX = 8;              // output pixels a thread, along a row
constexpr int SEGS = TOW / PX;     // row segments
constexpr int CB = 64;             // output channels per block
constexpr int CQ = CB / 4;         // channel quads
constexpr int NT = CQ * TOH * SEGS;  // one thread per (quad, row, segment)
constexpr int WP = CB + 4;         // weight row pitch, 16-byte aligned
constexpr int YR = 2 * TOH + 1;    // conv0 patch rows (with conv1's halo)
constexpr int YC = 2 * TOW + 1;
constexpr int YP = 36;             // patch row pitch, 16-byte aligned
constexpr int XR = 2 * YR + 1;     // plane rows behind the patch
constexpr int XC = 2 * YC + 1;
constexpr int XP = XC + 1;
constexpr int SMEM_FLOATS = M * 9 * WP + M * YR * YP + XR * XP + 9 * M + M;
static_assert(NT % 32 == 0 && CQ % 8 == 0, "a warp is 8 quads x 4 rows");
static_assert(TOH == 4 && YP >= YC && YP % 4 == 0 && (2 * YP) % 32 == 8,
              "the 4 rows of a warp read 4 bank groups");

#define FMA4(A, W, X)          \
  A[0] = fmaf((W).x, X, A[0]); \
  A[1] = fmaf((W).y, X, A[1]); \
  A[2] = fmaf((W).z, X, A[2]); \
  A[3] = fmaf((W).w, X, A[3]);

__global__ void __launch_bounds__(NT)
dep_encode_front_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                        const float* __restrict__ b0, const float* __restrict__ w1,
                        const float* __restrict__ b1, float* __restrict__ out,
                        int H, int W, int C1, int n_groups) {
  extern __shared__ float4 smem4[];
  float* w1s = reinterpret_cast<float*>(smem4);  // [m * 9 + tap][WP]
  float* y1s = w1s + M * 9 * WP;                 // [m][YR][YP]
  float* xs = y1s + M * YR * YP;                 // [XR][XP]
  float* w0s = xs + XR * XP;                     // [tap][m]
  float* b0s = w0s + 9 * M;

  const int tid = threadIdx.x;
  const int b = blockIdx.z / n_groups;
  const int co0 = (blockIdx.z % n_groups) * CB;
  const int oy0 = blockIdx.y * TOH, ox0 = blockIdx.x * TOW;
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  const int Ho = (H1 + 1) / 2, Wo = (W1 + 1) / 2;

  for (int i = tid; i < CB * M * 9; i += NT) {
    const int cl = i / (M * 9), s = i % (M * 9);
    w1s[s * WP + cl] = co0 + cl < C1 ? __ldg(w1 + (long)co0 * M * 9 + i) : 0.0f;
  }
  for (int i = tid; i < M * 9; i += NT) w0s[(i % 9) * M + i / 9] = __ldg(w0 + i);
  if (tid < M) b0s[tid] = __ldg(b0 + tid);
  // the plane rows 4 oy0 - 3 ... and cols 4 ox0 - 3 ..., zero outside
  const float* xb = x + (long)b * H * W;
  for (int i = tid; i < XR * XC; i += NT) {
    const int r = i / XC, c = i % XC;
    const int yy = 4 * oy0 - 3 + r, xx = 4 * ox0 - 3 + c;
    xs[r * XP + c] = yy >= 0 && yy < H && xx >= 0 && xx < W ? __ldg(xb + (long)yy * W + xx) : 0.0f;
  }
  __syncthreads();

  // ---- conv0 patch: conv0 output rows 2 oy0 - 1 ... 2 oy0 + 2 TOH - 1 ----
  for (int pos = tid; pos < YR * YC; pos += NT) {
    const int r = pos / YC, c = pos % YC;
    const int Y1 = 2 * oy0 - 1 + r, X1 = 2 * ox0 - 1 + c;
    float* dst = y1s + r * YP + c;
    if (Y1 < 0 || Y1 >= H1 || X1 < 0 || X1 >= W1) {
#pragma unroll
      for (int m = 0; m < M; ++m) dst[m * YR * YP] = 0.0f;
      continue;
    }
    float xv[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) xv[t] = xs[(2 * r + t / 3) * XP + 2 * c + t % 3];
#pragma unroll
    for (int j = 0; j < M / 4; ++j) {
      float s[4] = {b0s[4 * j], b0s[4 * j + 1], b0s[4 * j + 2], b0s[4 * j + 3]};
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float4 w = reinterpret_cast<const float4*>(w0s + t * M)[j];
        FMA4(s, w, xv[t])
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[(4 * j + q) * YR * YP] = fmaxf(s[q], 0.0f);
    }
  }
  __syncthreads();

  // ---- conv1: thread = (channel quad, output row, row segment) ----
  const int lane = tid & 31, warp = tid >> 5;
  const int cq = (warp % (CQ / 8)) * 8 + (lane & 7);
  const int row = lane >> 3;
  const int seg = warp / (CQ / 8);
  const int co = co0 + 4 * cq;
  float acc[PX][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float bias = co + q < C1 ? __ldg(b1 + co + q) : 0.0f;
#pragma unroll
    for (int j = 0; j < PX; ++j) acc[j][q] = bias;
  }
#pragma unroll 1
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int ty = 0; ty < 3; ++ty) {
      const float* yrow = y1s + (m * YR + 2 * row + ty) * YP + 2 * PX * seg;
      float p[2 * PX + 1];
#pragma unroll
      for (int i = 0; i < PX / 2; ++i) {
        const float4 v = reinterpret_cast<const float4*>(yrow)[i];
        p[4 * i] = v.x;
        p[4 * i + 1] = v.y;
        p[4 * i + 2] = v.z;
        p[4 * i + 3] = v.w;
      }
      p[2 * PX] = yrow[2 * PX];
      const float4* wr = reinterpret_cast<const float4*>(w1s + (m * 9 + ty * 3) * WP) + cq;
      const float4 wa = wr[0], wb = wr[WP / 4], wc = wr[WP / 2];
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        FMA4(acc[j], wa, p[2 * j])
        FMA4(acc[j], wb, p[2 * j + 1])
        FMA4(acc[j], wc, p[2 * j + 2])
      }
    }
  }
  const int oy = oy0 + row;
  if (co >= C1 || oy >= Ho) return;
  float* orow = out + ((long)b * Ho + oy) * Wo * C1 + co;
  const bool vec = C1 % 4 == 0 && co + 3 < C1;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int ox = ox0 + PX * seg + j;
    if (ox >= Wo) break;
    float* o = orow + (long)ox * C1;
    if (vec) {
      *reinterpret_cast<float4*>(o) =
          make_float4(fmaxf(acc[j][0], 0.0f), fmaxf(acc[j][1], 0.0f),
                      fmaxf(acc[j][2], 0.0f), fmaxf(acc[j][3], 0.0f));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (co + q < C1) o[q] = fmaxf(acc[j][q], 0.0f);
    }
  }
}

int launch(const float* x, const float* w0, const float* b0, const float* w1,
           const float* b1, float* out, int B, int H, int W, int C1, void* stream) {
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  const int Ho = (H1 + 1) / 2, Wo = (W1 + 1) / 2;
  const int n_groups = (C1 + CB - 1) / CB;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      dep_encode_front_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Wo + TOW - 1) / TOW, (Ho + TOH - 1) / TOH, B * n_groups);
  dep_encode_front_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      x, w0, b0, w1, b1, out, H, W, C1, n_groups);
  return (int)cudaGetLastError();
}

#undef FMA4

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int dep_encode_front_f32(const float* x, const float* w0,
                                    const float* b0, const float* w1,
                                    const float* b1, float* out, int B, int H,
                                    int W, int C1, void* stream) {
  return launch(x, w0, b0, w1, b1, out, B, H, W, C1, stream);
}

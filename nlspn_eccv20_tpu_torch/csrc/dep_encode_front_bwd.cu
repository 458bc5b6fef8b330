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
// tensors: 116 us at 67 TFLOP/s. So each pass keeps several sums a thread
// in registers, overlaps its copies with the FMAs, and fills the card at
// b=1 too:
//   1. bwd::transpose: w1 laid out (C1, 9, M), so that a chunk's weights
//      are one contiguous run, copied 16 bytes at a time.
//   2. dp0_kernel: convT(gm, w1) with the forward decode_aff tail's quad
//      scheme (dec_aff_tail.cu): one base pixel and its right and lower
//      neighbours give a 2x2 quad of p0 positions through all nine taps.
//      Per block an 8x8 tile of quads (16x16 positions); g, out and the
//      weights of 32 channels at a time stream through shared memory by
//      asynchronous copies into two buffers (cp_async.cuh). Each thread
//      masks its own copies (gm = g [out > 0]), writes gm out for pass 5
//      and sums it for db1; each thread owns a row of 8 quads and 2 of the
//      16 m (64 sums: per channel 18 gm words and 9 float2s of weights for
//      144 FMAs); the chunk's channels are split over 4 slices of threads
//      whose sums are added in slice order. When the tiles do
//      not fill the card (b=1: 80 tiles), the chunks are split over
//      blocks (4 a tile at b=1), whose sums finish_dp0_kernel adds in order. The
//      epilogue recomputes p0 from the plane's tile, staged with the first
//      chunk, masks, and writes dP0 and p0.
//   3. dx0_kernel: per 16x32 tile of the plane, dx from dP0's patch in
//      shared memory, and the tile's partial sums of dW0 and db0.
//   4. bwd::wgrad_s2 (bwd_common.cuh): dW1 from gm and p0 as slice
//      partials (132 at b=12).
//   5. bwd::reduce_partials: the partials of 2 (db1), 3 and 4 added in a
//      fixed order.
// No atomics: the result is the same bits from run to run. Any H and W, as
// the forward. Plain f32 FMAs: no tensor cores.
//
// bf16 form (K5-bf16, dep_encode_front_bwd_bf16, precision='bf16'): the
// plane x, g, out and dx bf16, rounding where the TPU kernel (_bwd_kernel at
// dt = bfloat16) rounds: w0, b0 and w1 to bf16; p0 recomputed as K3-bf16
// computes it (bf16 operands, f32 sum, the bias added in f32), its ReLU
// mask taken on the f32 value and p0 rounded to bf16; gm = g [out > 0] (g
// arrives bf16, so gm is exact); dP0 rounded to bf16 after its f32 sum and
// mask; dx rounded to bf16 once, after its f32 sum, as the TPU kernel rounds
// dx16 (its re-interleaved f32 plane gradient then holds bf16 values, and
// the JAX model's cast back to bf16 changes none of them). dW0, db0, dW1
// and db1 are f32 sums of those bf16 operands. The mask [out > 0] on
// K3-bf16's rounded output differs from the TPU kernel's [out_f32 > 0] only
// where 0 < out_f32 <= 2^-134, which needs a term below 2^-133
// (dec_aff_tail_bwd.cu bounds the same case). Its passes:
//   1'. dp0_mma_kernel, in place of 1. and 2.: dP0 = [p0 > 0] convT(gm, w1)
//      as the TPU kernel computes it (dep_encode_front.py:288,
//      _sunshift_matmul_sum: four shifted products of gm, f32 sums), on the
//      bf16 tensor cores: quad_mma.cuh's GEMM, M = base pixels of the gm
//      grid (52k at b=12), the reduction over 4 shifts x C1, N = four
//      phases x 16 m. The pass is bound by its bytes (g and out read in
//      bf16, gm, dP0 and p0 written in bf16: 86 MB at b=12, 26 us), not by
//      its 3.8 GFLOP (4 us). The first form ran it on the FP32 cores over f32
//      gm and p0 buffers: 199 of the 339.5 us at b=12. Per block an 8x16
//      tile of base pixels, a warpgroup's M-tile 4 rows of it. g and out
//      come raw, 32 channels a chunk, by 16-byte cp.async copies into two
//      buffers (80-byte pixels: ldmatrix's eight rows in distinct banks);
//      the thread that copied 8 channels of a pixel masks them in place
//      after its own wait (gm is an exact bf16 value: no widening pass),
//      writes them to gm for pass 4 and sums them for db1 (warp shuffles,
//      then the warps in order). A is read by ldmatrix at each shift's pixel
//      offset; the weights come with each chunk, laid out once a call by
//      quad::prep_kernel. The epilogue stages the f32 sums through shared
//      memory and recomputes p0 from the plane's tile as dp0_kernel does,
//      each thread keeping two positions' 3x3 patches in registers across
//      the 16 m (the recompute was bound by shared-memory loads, 18 a
//      position and m), then writes p0 and dP0 in bf16, along the rows.
//      When the tiles do not fill the card (b=1: 40 tiles) the chunks are
//      split over blocks (7 a tile at b=1), whose f32 sums
//      finish_dp0_kernel adds in split order.
//   3. dx0_kernel reads the bf16 dP0.
//   4. bwd::wgrad_s2 on the bf16 tensor cores (wgrad_s2_mma_kernel) over the
//      bf16 gm and p0, p0's rows padded to an even width for its 4-byte
//      words of two columns, the pad column zero.
// The products of two bf16 values are exact in f32, so only the order of
// the f32 sums differs from the plain version (dep_encode_front_bwd_plain_bf16).

#include <cuda_runtime.h>

#include "bwd_common.cuh"
#include "cp_async.cuh"
#include "quad_mma.cuh"

namespace {

constexpr int M = bwd::M;

// ---- 1. dP0 = [p0 > 0] convT(gm, w1), and p0 ----
constexpr int TH = 8;            // quad rows per tile
constexpr int TW = 8;            // quad cols per tile
constexpr int CC = 32;           // gm channels per shared-memory chunk
constexpr int NS = 4;            // channel slices of a chunk
constexpr int NI = TH * M / 2;   // threads per slice: (quad row, m pair)
constexpr int NT_A = NS * NI;    // 256
constexpr int XR = TH + 1;       // gm tile rows / cols (quads, plus one)
constexpr int XC = TW + 1;
constexpr int XP = XR * XC;      // staged pixels
constexpr int GP = CC + 4;       // floats per staged pixel: float4 rows, and
                                 // a thread's 8 pixels in distinct banks
constexpr int Q4 = CC / 4;       // channel quads of a chunk
constexpr int BUF_A = 2 * XP * GP + CC * 9 * M;  // g, out, w1 of a chunk
constexpr int DP0_SMEM = 2 * BUF_A * (int)sizeof(float);
constexpr int SPLIT_BLOCKS = 2 * bwd::CARD_SMS;  // fill the card at b=1
constexpr int XT = 4 * TH + 1;   // plane rows / cols under a tile
constexpr int RED_PITCH = TW * 8 + 1;  // a thread's 64 sums, and one
static_assert(TH == TW, "the plane tile is square");
static_assert(NS * NI * RED_PITCH <= 2 * BUF_A, "the sums fit in the buffers");
static_assert(CC % NS == 0, "slices split a chunk evenly");
static_assert(NT_A % Q4 == 0, "a thread keeps one channel quad");

#define FMA2(A, W, X)          \
  A[0] = fmaf((W).x, X, A[0]); \
  A[1] = fmaf((W).y, X, A[1]);

// p0 at (Y, X) of plane xb for one m, as dep_encode_front.cu computes it,
// before its rounding to T
template <typename T>
__device__ __forceinline__ float conv0_at(const T* xb, const float* w9, float bias,
                                          int Y, int X, int H, int W) {
  float sum = bwd::round_to<T>(bias);
#pragma unroll
  for (int ty = 0; ty < 3; ++ty) {
    const int yy = 2 * Y - 1 + ty;
    if (yy < 0 || yy >= H) continue;
#pragma unroll
    for (int tx = 0; tx < 3; ++tx) {
      const int xx = 2 * X - 1 + tx;
      if (xx < 0 || xx >= W) continue;
      sum = fmaf(bwd::round_to<T>(__ldg(w9 + ty * 3 + tx)),
                 bwd::widen(__ldg(xb + (long)yy * W + xx)), sum);
    }
  }
  return fmaxf(sum, 0.0f);
}

// Grid (quad cols, quad rows, B x n_split): block z handles image
// z / n_split and the channel chunks of split z % n_split. w1t is w1 laid
// out (C1, 9, M). With one split the block finishes dP0 and p0 itself;
// with more it writes its sums to part[split] and finish_dp0_kernel adds
// the splits in order. Each block also writes gm over its own pixels and
// channels, and their sums over its pixels to dbp[tile] (db1's partials).
__global__ void __launch_bounds__(NT_A, 2)
dp0_kernel(const float* __restrict__ x, const float* __restrict__ g,
           const float* __restrict__ out, const float* __restrict__ w0,
           const float* __restrict__ b0, const float* __restrict__ w1t,
           float* __restrict__ dp0, float* __restrict__ p0,
           float* __restrict__ gm, float* __restrict__ part,
           float* __restrict__ dbp, int B, int H, int W, int C1, int n_split) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float w0s[M * 9];
  __shared__ float b0s[M];
  __shared__ __align__(16) float sums[NT_A / Q4][CC];  // a thread's quad's gm sums
  __shared__ float xs[XT * XT];                          // the plane under the tile

  const int tid = threadIdx.x;
  const int b = blockIdx.z / n_split, split = blockIdx.z % n_split;
  const int a0 = blockIdx.y * TH, t0 = blockIdx.x * TW;  // quad-grid origin
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  const int Ho = (H1 + 1) / 2, Wo = (W1 + 1) / 2;
  const long gbase = (long)b * Ho * Wo * C1;
  const int n_chunks = (C1 + CC - 1) / CC;
  const int per_split = (n_chunks + n_split - 1) / n_split;
  const int k_beg = split * per_split;
  const int k_end = min(n_chunks, k_beg + per_split);
  const long tile = ((long)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const bool vec = (C1 & 3) == 0 &&
                   ((reinterpret_cast<size_t>(g) | reinterpret_cast<size_t>(out)) & 15) == 0;

  for (int i = tid; i < M * 9; i += NT_A) w0s[i] = __ldg(w0 + i);
  if (tid < M) b0s[tid] = __ldg(b0 + tid);

  // issues the copies of chunk k (g, out and w1) into buffer buf; thread
  // tid always copies channel quad tid % Q4 of its pixels
  auto stage = [&](int k, int buf) {
    float* gs = smem + buf * BUF_A;
    float* os = gs + XP * GP;
    float* ws = os + XP * GP;
    const int c0 = k * CC;
    for (int e = tid; e < XP * Q4; e += NT_A) {
      const int pix = e / Q4, cc = 4 * (e % Q4);
      const int gy = a0 + pix / XC, gx = t0 + pix % XC, ch = c0 + cc;
      const bool in = gy < Ho && gx < Wo;
      const long o = in ? gbase + ((long)gy * Wo + gx) * C1 + ch : 0;
      if (vec) {
        cpa::copy16(gs + pix * GP + cc, g + o, in && ch < C1);
        cpa::copy16(os + pix * GP + cc, out + o, in && ch < C1);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = in && ch + q < C1;
          cpa::copy4(gs + pix * GP + cc + q, g + (ok ? o + q : 0), ok);
          cpa::copy4(os + pix * GP + cc + q, out + (ok ? o + q : 0), ok);
        }
      }
    }
    const float* wsrc = w1t + (long)c0 * 9 * M;
    const int nw = min(CC, C1 - c0) * 9 * M;  // a multiple of 4
    for (int e = 4 * tid; e < CC * 9 * M; e += 4 * NT_A)
      cpa::copy16(ws + e, e < nw ? wsrc + e : w1t, e < nw);
  };
  // gm = g [out > 0] over the thread's own copies of chunk k, written out
  // for the weight-gradient pass over the tile's own pixels, whose sums
  // go to sums[] for db1
  auto mask = [&](int k, int buf) {
    float* gs = smem + buf * BUF_A;
    const float* os = gs + XP * GP;
    const int c0 = k * CC, cc = 4 * (tid % Q4);
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int e = tid; e < XP * Q4; e += NT_A) {
      const int pix = e / Q4, r = pix / XC, c = pix % XC;
      float4 v = *reinterpret_cast<float4*>(gs + pix * GP + cc);
      const float4 u = *reinterpret_cast<const float4*>(os + pix * GP + cc);
      v.x = u.x > 0.0f ? v.x : 0.0f;
      v.y = u.y > 0.0f ? v.y : 0.0f;
      v.z = u.z > 0.0f ? v.z : 0.0f;
      v.w = u.w > 0.0f ? v.w : 0.0f;
      *reinterpret_cast<float4*>(gs + pix * GP + cc) = v;
      const int gy = a0 + r, gx = t0 + c, ch = c0 + cc;
      if (r < TH && c < TW && gy < Ho && gx < Wo) {
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
        float* dst = gm + gbase + ((long)gy * Wo + gx) * C1 + ch;
        if (vec && ch < C1) {
          *reinterpret_cast<float4*>(dst) = v;
        } else {
          const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (ch + q < C1) dst[q] = vs[q];
        }
      }
    }
    *reinterpret_cast<float4*>(&sums[tid / Q4][cc]) = sum;
  };

  const int s = tid / NI, it = tid % NI;
  const int mp = it % (M / 2), qr = it / (M / 2);
  float acc[TW][4][2];  // [quad][position of the quad][m]
#pragma unroll
  for (int k = 0; k < TW; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[k][q][j] = 0.0f;

  for (int e = tid; e < XT * XT; e += NT_A) {  // the plane under the tile
    const int yy = 4 * a0 - 1 + e / XT, xx = 4 * t0 - 1 + e % XT;
    const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
    cpa::copy4(xs + e, x + (ok ? ((long)b * H + yy) * W + xx : 0), ok);
  }
  if (k_beg < k_end) stage(k_beg, 0);
  cpa::commit();
  for (int k = k_beg, buf = 0; k < k_end; ++k, buf ^= 1) {
    if (k + 1 < k_end) stage(k + 1, buf ^ 1);
    cpa::commit();
    cpa::wait<1>();
    mask(k, buf);
    __syncthreads();
    if (tid < CC && k * CC + tid < C1) {  // db1's partial: slots in order
      float t = 0.0f;
      for (int q = 0; q < NT_A / Q4; ++q) t += sums[q][tid];
      dbp[tile * C1 + k * CC + tid] = t;
    }
    const float* gs = smem + buf * BUF_A;
    const float* ws = gs + 2 * XP * GP;
#pragma unroll 1
    for (int cc = s; cc < CC; cc += NS) {
      const float* gc = gs + qr * XC * GP + cc;
      float ga[TW + 1], gb[TW + 1];  // gm rows qr and qr + 1
#pragma unroll
      for (int k2 = 0; k2 <= TW; ++k2) {
        ga[k2] = gc[k2 * GP];
        gb[k2] = gc[(XC + k2) * GP];
      }
      const float2* w = reinterpret_cast<const float2*>(ws + cc * 9 * M) + mp;
      // w[tap * 8] is taps (ty, tx) = (tap / 3, tap % 3), m 2mp and 2mp + 1
      const float2 w00 = w[0], w01 = w[8], w02 = w[16], w10 = w[24],
                   w11 = w[32], w12 = w[40], w20 = w[48], w21 = w[56],
                   w22 = w[64];
#pragma unroll
      for (int k2 = 0; k2 < TW; ++k2) {
        const float x00 = ga[k2], x01 = ga[k2 + 1], x10 = gb[k2], x11 = gb[k2 + 1];
        FMA2(acc[k2][0], w11, x00)
        FMA2(acc[k2][1], w12, x00) FMA2(acc[k2][1], w10, x01)
        FMA2(acc[k2][2], w21, x00) FMA2(acc[k2][2], w01, x10)
        FMA2(acc[k2][3], w22, x00) FMA2(acc[k2][3], w20, x01) FMA2(acc[k2][3], w02, x10)
        FMA2(acc[k2][3], w00, x11)
      }
    }
    __syncthreads();  // the buffer and sums[] are rewritten a chunk on
  }
  cpa::wait<0>();
  // Each thread's 64 sums to its own row of the freed buffers (rows of 65
  // words: a warp's stores fall in 32 banks), then the slices are added in
  // slice order.
  float* red = smem;  // [slice][thread of the slice][RED_PITCH]
#pragma unroll
  for (int k = 0; k < TW; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        red[(s * NI + it) * RED_PITCH + (k * 4 + q) * 2 + j] = acc[k][q][j];
  __syncthreads();

  // One split: p0 recomputed as dep_encode_front.cu computes it, from the
  // staged plane, then the mask. More: the raw sums, for finish_dp0_kernel.
  for (int i = tid; i < M * 4 * TH * TW; i += NT_A) {
    const int u = i % (2 * TW), v = (i / (2 * TW)) % (2 * TH), m = i / (4 * TH * TW);
    const int Y = 2 * a0 + v, X = 2 * t0 + u;
    if (Y >= H1 || X >= W1) continue;
    const int owner = (v >> 1) * (M / 2) + (m >> 1);
    const int idx = ((u >> 1) * 4 + ((v & 1) << 1 | (u & 1))) * 2 + (m & 1);
    float sum = red[owner * RED_PITCH + idx];
#pragma unroll
    for (int r = 1; r < NS; ++r) sum += red[(r * NI + owner) * RED_PITCH + idx];
    const long o = (((long)b * M + m) * H1 + Y) * W1 + X;
    if (n_split > 1) {
      part[(long)split * B * M * H1 * W1 + o] = sum;
      continue;
    }
    float pv = b0s[m];
#pragma unroll
    for (int ty = 0; ty < 3; ++ty) {
      const int yy = 2 * Y - 1 + ty;
      if (yy < 0 || yy >= H) continue;
#pragma unroll
      for (int tx = 0; tx < 3; ++tx) {
        const int xx = 2 * X - 1 + tx;
        if (xx < 0 || xx >= W) continue;
        pv = fmaf(w0s[m * 9 + ty * 3 + tx], xs[(2 * v + ty) * XT + 2 * u + tx], pv);
      }
    }
    pv = fmaxf(pv, 0.0f);
    p0[o] = pv;
    dp0[o] = pv > 0.0f ? sum : 0.0f;
  }
}

#undef FMA2

// dP0 and p0 from n_split partial sums, added in split order; p0's rows
// p0_pitch apart (W1, or for bf16 W1 rounded up to even).
template <typename T>
__global__ void __launch_bounds__(256)
finish_dp0_kernel(const T* __restrict__ x, const float* __restrict__ w0,
                  const float* __restrict__ b0, const float* __restrict__ part,
                  T* __restrict__ dp0, T* __restrict__ p0, int B, int H,
                  int W, int n_split, int p0_pitch) {
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  const long n = (long)B * M * H1 * W1;
  const long o = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  const int X = (int)(o % W1), Y = (int)((o / W1) % H1);
  const int m = (int)((o / ((long)W1 * H1)) % M), b = (int)(o / ((long)W1 * H1 * M));
  float sum = part[o];
  for (int sp = 1; sp < n_split; ++sp) sum += part[sp * n + o];
  const float pv = conv0_at(x + (long)b * H * W, w0 + m * 9, __ldg(b0 + m), Y, X, H, W);
  p0[((long)b * M + m) * H1 * p0_pitch + (long)Y * p0_pitch + X] = bwd::narrow<T>(pv);
  dp0[o] = bwd::narrow<T>(pv > 0.0f ? sum : 0.0f);
}

// ---- 1'. the bf16 form's dP0 on the tensor cores (the header's 1'.) ----
constexpr int MQ_TH = 8, MQ_TW = 16;       // base-pixel tile: two M-tiles of 64
constexpr int MQ_NT = 256;                 // two warpgroups
constexpr int MQ_XC = MQ_TW + 1;           // staged gm tile: 9 x 17 pixels
constexpr int MQ_XPIX = (MQ_TH + 1) * MQ_XC;
constexpr int MQ_CC = 32;                  // channels a chunk: two k-steps
constexpr int MQ_CP = MQ_CC + 8;           // bf16 a staged pixel: 80 bytes
constexpr int MQ_G_BYTES = MQ_XPIX * MQ_CP * 2;          // g (masked to gm in place), out
constexpr int MQ_W_BYTES = 2 * quad::KSTEP_BF16 * 2;     // a chunk's B
constexpr int MQ_STAGE = 2 * MQ_G_BYTES + MQ_W_BYTES;
constexpr int MQ_EP = 2 * MQ_TW + 1;       // epilogue rows: [m][2 TH][MQ_EP] f32
constexpr int MQ_EP_BYTES = M * 2 * MQ_TH * MQ_EP * 4;
constexpr int MQ_REGION = 2 * MQ_STAGE > MQ_EP_BYTES ? 2 * MQ_STAGE : MQ_EP_BYTES;
constexpr int MQ_XTR = 4 * MQ_TH + 1, MQ_XTC = 4 * MQ_TW + 1;   // the plane under a tile
constexpr int MQ_SMEM = MQ_REGION + MQ_XTR * MQ_XTC * 4;
constexpr int MQ_BLOCKS_PER_SM = 2;
static_assert(MQ_G_BYTES % 16 == 0 && MQ_STAGE % 16 == 0 && MQ_REGION % 16 == 0,
              "16-byte aligned regions");

// Grid (tile cols, tile rows, B x n_split): block z handles image z /
// n_split and the chunks of split z % n_split. With one split the block
// finishes dP0 and p0 itself; with more it writes its f32 sums to
// part[split] and finish_dp0_kernel adds the splits in order. Each block
// also writes gm over its own pixels and chunks, and their sums over its
// pixels to dbp[tile] (db1's partials).
__global__ void __launch_bounds__(MQ_NT, MQ_BLOCKS_PER_SM)
dp0_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
               const __nv_bfloat16* __restrict__ out, const float* __restrict__ w0,
               const float* __restrict__ b0, const __nv_bfloat16* __restrict__ w1p,
               __nv_bfloat16* __restrict__ dp0, __nv_bfloat16* __restrict__ p0,
               __nv_bfloat16* __restrict__ gm, float* __restrict__ part,
               float* __restrict__ dbp, int B, int H, int W, int C1, int n_split,
               int p0_pitch) {
  extern __shared__ __align__(128) unsigned char smq[];
  float* ep = reinterpret_cast<float*>(smq);                   // where the chunks were
  float* xs = reinterpret_cast<float*>(smq + MQ_REGION);       // [MQ_XTR][MQ_XTC]
  __shared__ float w0s[M * 9];
  __shared__ float b0s[M];
  __shared__ float red[MQ_NT / 32][MQ_CC];   // a warp's gm sums of a chunk

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3, wg = warp >> 2, wr = warp & 3;
  const int b = blockIdx.z / n_split, split = blockIdx.z % n_split;
  const int a0 = blockIdx.y * MQ_TH, t0 = blockIdx.x * MQ_TW;   // base-grid origin
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  const int Ho = (H1 + 1) / 2, Wo = (W1 + 1) / 2;
  const long gbase = (long)b * Ho * Wo * C1;
  const int n_chunks = (C1 + MQ_CC - 1) / MQ_CC;
  const int k_beg = split * n_chunks / n_split, k_end = (split + 1) * n_chunks / n_split;
  const long tile = ((long)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const bool vec = (C1 & 7) == 0 &&
                   ((reinterpret_cast<size_t>(g) | reinterpret_cast<size_t>(out) |
                     reinterpret_cast<size_t>(gm)) & 15) == 0;

  for (int i = tid; i < M * 9; i += MQ_NT) w0s[i] = bwd::round_bf16(__ldg(w0 + i));
  if (tid < M) b0s[tid] = bwd::round_bf16(__ldg(b0 + tid));
  for (int e = tid; e < MQ_XTR * MQ_XTC; e += MQ_NT) {   // read after the first barrier
    const int yy = 4 * a0 - 1 + e / MQ_XTC, xx = 4 * t0 - 1 + e % MQ_XTC;
    const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
    xs[e] = ok ? __bfloat162float(x[((long)b * H + yy) * W + xx]) : 0.0f;
  }

  // chunk k's 8-channel groups: e = (pixel, group q); a thread always has
  // q = tid % 4 = tig, and stage() and mask() give it the same groups
  auto stage = [&](int k, int buf) {
    __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smq + buf * MQ_STAGE);
    __nv_bfloat16* os = gs + MQ_G_BYTES / 2;
    const int c0 = k * MQ_CC;
    for (int e = tid; e < MQ_XPIX * 4; e += MQ_NT) {
      const int pix = e >> 2, q = e & 3;
      const int gy = a0 + pix / MQ_XC, gx = t0 + pix % MQ_XC, ch = c0 + 8 * q;
      const long o = gbase + ((long)gy * Wo + gx) * C1 + ch;
      const bool in = gy < Ho && gx < Wo;
      if (vec) {
        cpa::copy16(gs + pix * MQ_CP + 8 * q, in && ch < C1 ? g + o : g, in && ch < C1);
        cpa::copy16(os + pix * MQ_CP + 8 * q, in && ch < C1 ? out + o : out, in && ch < C1);
      } else {   // plain loads, read back by this thread only
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool ok = in && ch + i < C1;
          gs[pix * MQ_CP + 8 * q + i] = ok ? g[o + i] : __float2bfloat16_rn(0.0f);
          os[pix * MQ_CP + 8 * q + i] = ok ? out[o + i] : __float2bfloat16_rn(0.0f);
        }
      }
    }
    const uint4* wsrc = reinterpret_cast<const uint4*>(w1p + (long)k * 2 * quad::KSTEP_BF16);
    uint4* wdst = reinterpret_cast<uint4*>(smq + buf * MQ_STAGE + 2 * MQ_G_BYTES);
    for (int e = tid; e < MQ_W_BYTES / 16; e += MQ_NT) cpa::copy16(wdst + e, wsrc + e, true);
  };
  // gm = g [out > 0] over this thread's groups of chunk k, in place; the
  // tile's own pixels written to gm and summed, per warp, into red[warp]
  auto mask = [&](int k, int buf) {
    __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smq + buf * MQ_STAGE);
    const __nv_bfloat16* os = gs + MQ_G_BYTES / 2;
    const int c0 = k * MQ_CC;
    float sum[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sum[i] = 0.0f;
    for (int e = tid; e < MQ_XPIX * 4; e += MQ_NT) {
      const int pix = e >> 2, q = e & 3, r = pix / MQ_XC, c = pix % MQ_XC;
      uint4 gv = *reinterpret_cast<const uint4*>(gs + pix * MQ_CP + 8 * q);
      const uint4 ov = *reinterpret_cast<const uint4*>(os + pix * MQ_CP + 8 * q);
      unsigned* gw = reinterpret_cast<unsigned*>(&gv);
      const unsigned* ow = reinterpret_cast<const unsigned*>(&ov);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned lo = bwd::lo_bf16(ow[i]) > 0.0f ? 0x0000ffffu : 0u;
        const unsigned hi = bwd::hi_bf16(ow[i]) > 0.0f ? 0xffff0000u : 0u;
        gw[i] &= lo | hi;
      }
      *reinterpret_cast<uint4*>(gs + pix * MQ_CP + 8 * q) = gv;
      const int gy = a0 + r, gx = t0 + c, ch = c0 + 8 * q;
      if (r < MQ_TH && c < MQ_TW && gy < Ho && gx < Wo) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sum[2 * i] += bwd::lo_bf16(gw[i]);
          sum[2 * i + 1] += bwd::hi_bf16(gw[i]);
        }
        __nv_bfloat16* dst = gm + gbase + ((long)gy * Wo + gx) * C1 + ch;
        if (vec) {
          if (ch < C1) *reinterpret_cast<uint4*>(dst) = gv;
        } else {
          const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&gv);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (ch + i < C1) dst[i] = hv[i];
        }
      }
    }
    // the lanes of one group (equal tig) in a fixed butterfly: every lane
    // ends with the same sum
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 4);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 8);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 16);
    }
    if (gid == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) red[warp][8 * tig + i] = sum[i];
    }
  };

  // this lane's ldmatrix row at each shift: M-tile row r is base pixel
  // (4 wg + wr, r), channels koff on
  const int r = (lane & 7) + 8 * ((lane >> 3) & 1), koff = 8 * (lane >> 4);
  int aoff[4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
    aoff[s] = ((4 * wg + wr + (s >> 1)) * MQ_XC + r + (s & 1)) * MQ_CP + koff;
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.0f;

  if (k_beg < k_end) stage(k_beg, 0);
  cpa::commit();
  for (int k = k_beg, buf = 0; k < k_end; ++k, buf ^= 1) {
    if (k + 1 < k_end) stage(k + 1, buf ^ 1);
    cpa::commit();
    cpa::wait<1>();
    mask(k, buf);
    fence_async_smem();
    __syncthreads();
    if (tid < MQ_CC && k * MQ_CC + tid < C1) {   // db1's partial: the warps in order
      float t = 0.0f;
      for (int w = 0; w < MQ_NT / 32; ++w) t += red[w][tid];
      dbp[tile * C1 + k * MQ_CC + tid] = t;
    }
    const unsigned short* gs = reinterpret_cast<const unsigned short*>(smq + buf * MQ_STAGE);
    const unsigned short* ws =
        reinterpret_cast<const unsigned short*>(smq + buf * MQ_STAGE + 2 * MQ_G_BYTES);
    uint32_t a[2][4][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int s = 0; s < 4; ++s) ldmatrix_x4(a[ks][s], gs + aoff[s] + quad::KSTEP * ks);
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
    __syncthreads();   // the buffer and red[] are rewritten a chunk on
  }
  cpa::wait<0>();

  // acc[4j + 2h + e]: base pixel (4 wg + wr, gid + 8h), phase block j / 2,
  // m = 8 (j % 2) + 2 tig + e; to ep[m][v][u] at quad position (v, u)
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int v = 2 * (4 * wg + wr) + quad::phase_dy(j >> 1);
      const int u = 2 * (gid + 8 * h) + quad::phase_dx(j >> 1);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        ep[((8 * (j & 1) + 2 * tig + e) * 2 * MQ_TH + v) * MQ_EP + u] = acc[4 * j + 2 * h + e];
    }
  __syncthreads();

  // More than one split: the f32 sums, for finish_dp0_kernel.
  if (n_split > 1) {
    for (int i = tid; i < M * 4 * MQ_TH * MQ_TW; i += MQ_NT) {
      const int u = i % (2 * MQ_TW), v = (i / (2 * MQ_TW)) % (2 * MQ_TH);
      const int m = i / (4 * MQ_TH * MQ_TW);
      const int Y = 2 * a0 + v, X = 2 * t0 + u;
      if (Y < H1 && X < W1)
        part[(long)split * B * M * H1 * W1 + (((long)b * M + m) * H1 + Y) * W1 + X] =
            ep[(m * 2 * MQ_TH + v) * MQ_EP + u];
    }
    return;
  }
  // One split: p0 recomputed as dp0_kernel computes it (the same taps in
  // the same order), then the mask and the roundings. A thread owns two
  // positions (v, u) and (v + 8, u) and keeps their 3x3 plane patches in
  // registers across the 16 m, whose weights are broadcast: one shared
  // load a tap and m for both, instead of two for each.
  constexpr int NPOS = 4 * MQ_TH * MQ_TW / MQ_NT;   // 2
  float xv[NPOS][9];
  bool tin[NPOS][9], pin[NPOS];
  int Yq[NPOS], Xq[NPOS], vq[NPOS];
  const int u = tid % (2 * MQ_TW);
#pragma unroll
  for (int q = 0; q < NPOS; ++q) {
    const int v = tid / (2 * MQ_TW) + q * (MQ_NT / (2 * MQ_TW));
    vq[q] = v;
    Yq[q] = 2 * a0 + v;
    Xq[q] = 2 * t0 + u;
    pin[q] = Yq[q] < H1 && Xq[q] < W1;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int ty = t / 3, tx = t % 3;
      const int yy = 2 * Yq[q] - 1 + ty, xx = 2 * Xq[q] - 1 + tx;
      tin[q][t] = yy >= 0 && yy < H && xx >= 0 && xx < W;
      xv[q][t] = xs[(2 * v + ty) * MQ_XTC + 2 * u + tx];
    }
  }
#pragma unroll 2
  for (int m = 0; m < M; ++m) {
    float w9[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) w9[t] = w0s[m * 9 + t];
#pragma unroll
    for (int q = 0; q < NPOS; ++q) {
      float pv = b0s[m];
#pragma unroll
      for (int t = 0; t < 9; ++t)
        if (tin[q][t]) pv = fmaf(w9[t], xv[q][t], pv);
      pv = fmaxf(pv, 0.0f);
      if (!pin[q]) continue;
      const float sum = ep[(m * 2 * MQ_TH + vq[q]) * MQ_EP + u];
      p0[(((long)b * M + m) * H1 + Yq[q]) * p0_pitch + Xq[q]] = __float2bfloat16_rn(pv);
      dp0[(((long)b * M + m) * H1 + Yq[q]) * W1 + Xq[q]] =
          __float2bfloat16_rn(pv > 0.0f ? sum : 0.0f);
    }
  }
}

// ---- 2. dx = convT(dP0, w0), and partial dW0 / db0 ----
constexpr int FY = 16;           // plane tile rows
constexpr int FX = 32;           // plane tile cols
constexpr int PY = FY / 2;       // owned p0 rows / cols
constexpr int PX = FX / 2;
constexpr int NT_B = 256;
constexpr int NPB = M * 9 + M;   // partials per block: dW0 | db0

template <typename T>
__global__ void __launch_bounds__(NT_B)
dx0_kernel(const T* __restrict__ x, const T* __restrict__ dp0,
           const float* __restrict__ w0, T* __restrict__ dx,
           float* __restrict__ part, int H, int W) {
  __shared__ float dps[M][PY + 1][PX + 1];
  __shared__ float xs[FY + 1][FX + 1];
  __shared__ float w0s[M * 9];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int Y0 = blockIdx.y * PY, X0 = blockIdx.x * PX;
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  float* pb = part + (long)((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * NPB;

  for (int i = tid; i < M * 9; i += NT_B) w0s[i] = bwd::round_to<T>(__ldg(w0 + i));
  for (int i = tid; i < M * (PY + 1) * (PX + 1); i += NT_B) {
    const int c = i % (PX + 1), r = (i / (PX + 1)) % (PY + 1), m = i / ((PX + 1) * (PY + 1));
    const int Y = Y0 + r, X = X0 + c;
    dps[m][r][c] = (Y < H1 && X < W1)
        ? bwd::widen(__ldg(dp0 + (((long)b * M + m) * H1 + Y) * W1 + X)) : 0.0f;
  }
  for (int i = tid; i < (FY + 1) * (FX + 1); i += NT_B) {
    const int c = i % (FX + 1), r = i / (FX + 1);
    const int yy = 2 * Y0 - 1 + r, xx = 2 * X0 - 1 + c;
    xs[r][c] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
        ? bwd::widen(__ldg(x + ((long)b * H + yy) * W + xx)) : 0.0f;
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
    dx[((long)b * H + yy) * W + xx] = bwd::narrow<T>(d);
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


struct Layout {  // the f32 form's scratch buffer, in floats
  long dp0, p0, gm, part_dp, w1t, part_db, part_b, part_w, tmp, total;
  int blocks_b, slices, n_split, tiles;
};

Layout layout(int B, int H, int W, int C1) {
  Layout l;
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  const int Ho = (H1 + 1) / 2, Wo = (W1 + 1) / 2;
  const long long n = (long long)B * Ho * Wo;
  l.tiles = ((Wo + TW - 1) / TW) * ((Ho + TH - 1) / TH) * B;
  const int wanted = (SPLIT_BLOCKS + l.tiles - 1) / l.tiles;
  const int n_chunks = (C1 + CC - 1) / CC;
  l.n_split = wanted < n_chunks ? wanted : n_chunks;
  l.blocks_b = ((W + FX - 1) / FX) * ((H + FY - 1) / FY) * B;
  l.slices = bwd::wgrad_s2_slices(n, C1);
  l.dp0 = 0;
  l.p0 = l.dp0 + bwd::align4((long)B * M * H1 * W1);
  l.gm = l.p0 + bwd::align4((long)B * M * H1 * W1);
  l.part_dp = l.gm + bwd::align4(n * C1);
  l.w1t = l.part_dp + (l.n_split > 1 ? bwd::align4((long)l.n_split * B * M * H1 * W1) : 0);
  l.part_db = l.w1t + bwd::align4((long)C1 * 9 * M);
  l.part_b = l.part_db + bwd::align4((long)l.tiles * C1);
  l.part_w = l.part_b + bwd::align4((long)l.blocks_b * NPB);
  l.tmp = l.part_w + bwd::align4(bwd::wgrad_s2_partial_floats(n, C1));
  long t = bwd::reduce_scratch_floats(l.blocks_b, NPB);
  const long t2 = bwd::reduce_scratch_floats(l.slices, C1 * M * 9);
  const long t3 = bwd::reduce_scratch_floats(l.tiles, C1);
  t = t > t2 ? t : t2;
  l.total = l.tmp + (t > t3 ? t : t3);
  return l;
}

struct LayoutBf16 {  // the bf16 form's scratch buffer, in floats (bf16 buffers take half)
  long dp0, p0, gm, part_dp, w1p, part_db, part_b, part_w, tmp, total;
  int blocks_b, slices, n_split, tiles, tiles_x, tiles_y, chunks, p0_pitch;
};

LayoutBf16 layout_bf16(int B, int H, int W, int C1) {
  LayoutBf16 l;
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  const int Ho = (H1 + 1) / 2, Wo = (W1 + 1) / 2;
  const long long n = (long long)B * Ho * Wo;
  l.tiles_x = (Wo + MQ_TW - 1) / MQ_TW;
  l.tiles_y = (Ho + MQ_TH - 1) / MQ_TH;
  l.tiles = l.tiles_x * l.tiles_y * B;
  l.chunks = (C1 + MQ_CC - 1) / MQ_CC;
  const int wanted = (MQ_BLOCKS_PER_SM * bwd::CARD_SMS + l.tiles - 1) / l.tiles;
  l.n_split = wanted < l.chunks ? wanted : l.chunks;
  l.p0_pitch = W1 + (W1 & 1);
  l.blocks_b = ((W + FX - 1) / FX) * ((H + FY - 1) / FY) * B;
  l.slices = bwd::wgrad_s2_slices(n, C1);
  auto half = [](long long v) { return bwd::align4((v + 1) / 2); };
  l.dp0 = 0;
  l.p0 = l.dp0 + half((long long)B * M * H1 * W1);
  l.gm = l.p0 + half((long long)B * M * H1 * l.p0_pitch);
  l.part_dp = l.gm + half(n * C1);
  l.w1p = l.part_dp + (l.n_split > 1 ? bwd::align4((long)l.n_split * B * M * H1 * W1) : 0);
  l.part_db = l.w1p + half((long long)2 * l.chunks * quad::KSTEP_BF16);
  l.part_b = l.part_db + bwd::align4((long)l.tiles * C1);
  l.part_w = l.part_b + bwd::align4((long)l.blocks_b * NPB);
  l.tmp = l.part_w + bwd::align4(bwd::wgrad_s2_partial_floats(n, C1));
  long t = bwd::reduce_scratch_floats(l.blocks_b, NPB);
  const long t2 = bwd::reduce_scratch_floats(l.slices, C1 * M * 9);
  const long t3 = bwd::reduce_scratch_floats(l.tiles, C1);
  t = t > t2 ? t : t2;
  l.total = l.tmp + (t > t3 ? t : t3);
  return l;
}

// dx, dW0 and db0 from dP0, then dW1 from gm and p0, then the reductions:
// the passes after dP0, shared by both forms
template <typename T>
int finish(const T* x, const T* dp0, const T* gm, const T* p0, const float* w0, T* dx,
           float* dw0b, float* dw1b, float* part_b, float* part_w, float* part_db,
           float* tmp, int blocks_b, int slices, int tiles, int B, int H, int W, int C1,
           int p0_pitch, cudaStream_t s) {
  const int H1 = (H + 1) / 2;
  const int Ho = (H1 + 1) / 2, Wo = ((W + 1) / 2 + 1) / 2;
  const dim3 grid_b((W + FX - 1) / FX, (H + FY - 1) / FY, B);
  dx0_kernel<T><<<grid_b, NT_B, 0, s>>>(x, dp0, w0, dx, part_b, H, W);
  const cudaError_t err = bwd::wgrad_s2(gm, p0, part_w, B, Ho, Wo, C1, H1, p0_pitch, s);
  if (err != cudaSuccess) return (int)err;
  bwd::reduce_partials(part_b, blocks_b, NPB, dw0b, tmp, s);
  bwd::reduce_partials(part_w, slices, C1 * M * 9, dw1b, tmp, s);
  bwd::reduce_partials(part_db, tiles, C1, dw1b + (long)C1 * M * 9, tmp, s);
  return (int)cudaGetLastError();
}

int launch_f32(const float* x, const float* g, const float* out, const float* w0,
               const float* b0, const float* w1, float* dx, float* dw0b, float* dw1b,
               float* scratch, int B, int H, int W, int C1, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Layout l = layout(B, H, W, C1);
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  const int Ho = (H1 + 1) / 2, Wo = (W1 + 1) / 2;
  float* dp0 = scratch + l.dp0;
  float* p0 = scratch + l.p0;
  float* gm = scratch + l.gm;
  bwd::transpose(w1, scratch + l.w1t, C1, M, 9, s);  // (C1, M, 9) -> (C1, 9, M)
  const cudaError_t err = cudaFuncSetAttribute(
      dp0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DP0_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_a((Wo + TW - 1) / TW, (Ho + TH - 1) / TH, B * l.n_split);
  dp0_kernel<<<grid_a, NT_A, DP0_SMEM, s>>>(x, g, out, w0, b0, scratch + l.w1t, dp0, p0, gm,
                                            scratch + l.part_dp, scratch + l.part_db, B, H,
                                            W, C1, l.n_split);
  if (l.n_split > 1) {
    const long n = (long)B * M * H1 * W1;
    finish_dp0_kernel<float><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        x, w0, b0, scratch + l.part_dp, dp0, p0, B, H, W, l.n_split, W1);
  }
  return finish<float>(x, dp0, gm, p0, w0, dx, dw0b, dw1b, scratch + l.part_b,
                       scratch + l.part_w, scratch + l.part_db, scratch + l.tmp, l.blocks_b,
                       l.slices, l.tiles, B, H, W, C1, W1, s);
}

int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g, const __nv_bfloat16* out,
                const float* w0, const float* b0, const float* w1, __nv_bfloat16* dx,
                float* dw0b, float* dw1b, float* scratch, int B, int H, int W, int C1,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const LayoutBf16 l = layout_bf16(B, H, W, C1);
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  auto bf = [&](long off) { return reinterpret_cast<__nv_bfloat16*>(scratch + off); };
  __nv_bfloat16 *dp0 = bf(l.dp0), *p0 = bf(l.p0), *gm = bf(l.gm), *w1p = bf(l.w1p);
  if (l.p0_pitch != W1) {   // the pad column, read by wgrad_s2 as the image's edge
    const cudaError_t e = cudaMemsetAsync(
        p0, 0, sizeof(__nv_bfloat16) * (size_t)B * M * H1 * l.p0_pitch, s);
    if (e != cudaSuccess) return (int)e;
  }
  quad::prep(w1, w1p, C1, 2 * l.chunks, s);
  const cudaError_t err = cudaFuncSetAttribute(
      dp0_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_a(l.tiles_x, l.tiles_y, B * l.n_split);
  dp0_mma_kernel<<<grid_a, MQ_NT, MQ_SMEM, s>>>(x, g, out, w0, b0, w1p, dp0, p0, gm,
                                                scratch + l.part_dp, scratch + l.part_db, B,
                                                H, W, C1, l.n_split, l.p0_pitch);
  if (l.n_split > 1) {
    const long n = (long)B * M * H1 * W1;
    finish_dp0_kernel<__nv_bfloat16><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        x, w0, b0, scratch + l.part_dp, dp0, p0, B, H, W, l.n_split, l.p0_pitch);
  }
  return finish<__nv_bfloat16>(x, dp0, gm, p0, w0, dx, dw0b, dw1b, scratch + l.part_b,
                               scratch + l.part_w, scratch + l.part_db, scratch + l.tmp,
                               l.blocks_b, l.slices, l.tiles, B, H, W, C1, l.p0_pitch, s);
}

}  // namespace

// Floats of scratch dep_encode_front_bwd_f32 needs.
extern "C" long long dep_encode_front_bwd_scratch_floats(int B, int H, int W, int C1) {
  return layout(B, H, W, C1).total;
}

// Floats of scratch dep_encode_front_bwd_bf16 needs.
extern "C" long long dep_encode_front_bwd_bf16_scratch_floats(int B, int H, int W, int C1) {
  return layout_bf16(B, H, W, C1).total;
}

// K5-bf16's dP0 pass as dep_encode_front_bwd_bf16 launches it: out[0..7] =
// tile rows, tile cols (8 x 16 base pixels), splits a tile, threads a
// block, bytes of dynamic shared memory, chunks of 32 channels, p0's row
// pitch, weight-gradient slices. Returns 0.
extern "C" int dep_encode_front_bwd_bf16_plan(int B, int H, int W, int C1, int* out) {
  const LayoutBf16 l = layout_bf16(B, H, W, C1);
  const int v[8] = {l.tiles_y, l.tiles_x, l.n_split, MQ_NT, MQ_SMEM, l.chunks, l.p0_pitch,
                    l.slices};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// x (B, H, W); g and out (B, Ho, Wo, C1) NHWC, out the forward's output;
// w0 (16, 1, 3, 3), b0 (16); w1 (C1, 16, 3, 3). Writes dx (as x),
// dw0b = [dW0 (16 9) | db0 (16)] and dw1b = [dW1 (C1 16 9) | db1 (C1)].
// Returns cudaGetLastError() after the last launch. The bf16 form takes a
// bf16 x, g and out and writes a bf16 dx; the weights and the gradients of
// the weights are f32 in both.
extern "C" int dep_encode_front_bwd_f32(const float* x, const float* g,
                                        const float* out, const float* w0,
                                        const float* b0, const float* w1,
                                        float* dx, float* dw0b, float* dw1b,
                                        float* scratch, int B, int H, int W,
                                        int C1, void* stream) {
  return launch_f32(x, g, out, w0, b0, w1, dx, dw0b, dw1b, scratch, B, H, W, C1, stream);
}

extern "C" int dep_encode_front_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g,
                                         const __nv_bfloat16* out, const float* w0,
                                         const float* b0, const float* w1,
                                         __nv_bfloat16* dx, float* dw0b, float* dw1b,
                                         float* scratch, int B, int H, int W, int C1,
                                         void* stream) {
  return launch_bf16(x, g, out, w0, b0, w1, dx, dw0b, dw1b, scratch, B, H, W, C1, stream);
}

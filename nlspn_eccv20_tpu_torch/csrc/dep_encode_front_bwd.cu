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
// the forward. Plain f32 FMAs: no tensor cores (but the bf16 form's pass 4).
//
// bf16 form (K5-bf16, dep_encode_front_bwd_bf16, precision='bf16'): the
// same passes with T = __nv_bfloat16 for the plane x, g, out and dx,
// rounding where the TPU kernel (_bwd_kernel at dt = bfloat16) rounds: w0,
// b0 and w1 to bf16; p0 recomputed as K3-bf16 computes it (bf16 operands,
// f32 sum, the bias added in f32), its ReLU mask taken on the f32 value and
// p0 rounded to bf16; gm = g [out > 0] (g arrives bf16, so gm is exact);
// dP0 rounded to bf16 after its f32 sum and mask; dx rounded to bf16 once,
// after its f32 sum, as the TPU kernel rounds dx16 (its re-interleaved f32
// plane gradient then holds bf16 values, and the JAX model's cast back to
// bf16 changes none of them). dW0, db0, dW1 and db1 are f32 sums of those
// bf16 operands. The mask [out > 0] on K3-bf16's rounded output differs from
// the TPU kernel's [out_f32 > 0] only where 0 < out_f32 <= 2^-134, which
// needs a term below 2^-133 (dec_aff_tail_bwd.cu bounds the same case).
// cp.async cannot convert, so g and out are staged as raw bf16 quads by
// 8-byte copies where out's f32 copy would lie, and the thread that copied
// a quad widens and masks it after its own wait; the plane is read with
// plain loads and widened. p0, dP0 and gm stay f32 buffers holding bf16
// values. Pass 4 runs on the bf16 tensor cores (bwd::wgrad_s2_mma_kernel:
// gm and p0 are bf16 values, so its products are exact), the other passes
// on the FP32 cores as in f32.

#include <cuda_runtime.h>

#include "bwd_common.cuh"
#include "cp_async.cuh"

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
template <typename T>
__global__ void __launch_bounds__(NT_A, 2)
dp0_kernel(const T* __restrict__ x, const T* __restrict__ g,
           const T* __restrict__ out, const float* __restrict__ w0,
           const float* __restrict__ b0, const float* __restrict__ w1t,
           float* __restrict__ dp0, float* __restrict__ p0,
           float* __restrict__ gm, float* __restrict__ part,
           float* __restrict__ dbp, int B, int H, int W, int C1, int n_split) {
  constexpr bool F32 = std::is_same_v<T, float>;
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
                   ((reinterpret_cast<size_t>(g) | reinterpret_cast<size_t>(out)) &
                    (F32 ? 15 : 7)) == 0;

  for (int i = tid; i < M * 9; i += NT_A) w0s[i] = bwd::round_to<T>(__ldg(w0 + i));
  if (tid < M) b0s[tid] = bwd::round_to<T>(__ldg(b0 + tid));

  // issues the copies of chunk k (g, out and w1) into buffer buf; thread
  // tid always copies channel quad tid % Q4 of its pixels. bf16: g's and
  // out's raw quads go to a pixel's slot of the out region (CC halves of g,
  // then CC of out), for mask() to widen.
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
      if constexpr (F32) {
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
      } else {
        T* rg = reinterpret_cast<T*>(os + pix * GP) + cc;
        if (vec) {
          cpa::copy8(rg, g + o, in && ch < C1);
          cpa::copy8(rg + CC, out + o, in && ch < C1);
        } else {  // plain loads, read back by this thread only
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const bool ok = in && ch + q < C1;
            rg[q] = ok ? g[o + q] : bwd::narrow<T>(0.0f);
            rg[CC + q] = ok ? out[o + q] : bwd::narrow<T>(0.0f);
          }
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
      float4 v, u;
      if constexpr (F32) {
        v = *reinterpret_cast<float4*>(gs + pix * GP + cc);
        u = *reinterpret_cast<const float4*>(os + pix * GP + cc);
      } else {
        const T* rg = reinterpret_cast<const T*>(os + pix * GP) + cc;
        const uint2 a = *reinterpret_cast<const uint2*>(rg);
        const uint2 d = *reinterpret_cast<const uint2*>(rg + CC);
        v = make_float4(bwd::lo_bf16(a.x), bwd::hi_bf16(a.x), bwd::lo_bf16(a.y),
                        bwd::hi_bf16(a.y));
        u = make_float4(bwd::lo_bf16(d.x), bwd::hi_bf16(d.x), bwd::lo_bf16(d.y),
                        bwd::hi_bf16(d.y));
      }
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
    if constexpr (F32) {
      cpa::copy4(xs + e, x + (ok ? ((long)b * H + yy) * W + xx : 0), ok);
    } else {  // read after the first barrier below
      xs[e] = ok ? bwd::widen(x[((long)b * H + yy) * W + xx]) : 0.0f;
    }
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
    p0[o] = bwd::round_to<T>(pv);
    dp0[o] = pv > 0.0f ? bwd::round_to<T>(sum) : 0.0f;
  }
}

#undef FMA2

// dP0 and p0 from n_split partial sums, added in split order.
template <typename T>
__global__ void __launch_bounds__(256)
finish_dp0_kernel(const T* __restrict__ x, const float* __restrict__ w0,
                  const float* __restrict__ b0, const float* __restrict__ part,
                  float* __restrict__ dp0, float* __restrict__ p0, int B, int H,
                  int W, int n_split) {
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  const long n = (long)B * M * H1 * W1;
  const long o = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  const int X = (int)(o % W1), Y = (int)((o / W1) % H1);
  const int m = (int)((o / ((long)W1 * H1)) % M), b = (int)(o / ((long)W1 * H1 * M));
  float sum = part[o];
  for (int sp = 1; sp < n_split; ++sp) sum += part[sp * n + o];
  const float pv = conv0_at(x + (long)b * H * W, w0 + m * 9, __ldg(b0 + m), Y, X, H, W);
  p0[o] = bwd::round_to<T>(pv);
  dp0[o] = pv > 0.0f ? bwd::round_to<T>(sum) : 0.0f;
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
dx0_kernel(const T* __restrict__ x, const float* __restrict__ dp0,
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
    dps[m][r][c] = (Y < H1 && X < W1) ? __ldg(dp0 + (((long)b * M + m) * H1 + Y) * W1 + X) : 0.0f;
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

struct Layout {  // the scratch buffer, in floats
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

template <typename T>
int launch(const T* x, const T* g, const T* out, const float* w0, const float* b0,
           const float* w1, T* dx, float* dw0b, float* dw1b, float* scratch, int B,
           int H, int W, int C1, void* stream) {
  constexpr bool RND = !std::is_same_v<T, float>;
  cudaStream_t s = (cudaStream_t)stream;
  const Layout l = layout(B, H, W, C1);
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  const int Ho = (H1 + 1) / 2, Wo = (W1 + 1) / 2;
  float* dp0 = scratch + l.dp0;
  float* p0 = scratch + l.p0;
  float* gm = scratch + l.gm;
  bwd::transpose(w1, scratch + l.w1t, C1, M, 9, s, RND);  // (C1, M, 9) -> (C1, 9, M)
  cudaError_t err = cudaFuncSetAttribute(
      dp0_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, DP0_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_a((Wo + TW - 1) / TW, (Ho + TH - 1) / TH, B * l.n_split);
  dp0_kernel<T><<<grid_a, NT_A, DP0_SMEM, s>>>(x, g, out, w0, b0, scratch + l.w1t, dp0,
                                               p0, gm, scratch + l.part_dp,
                                               scratch + l.part_db, B, H, W, C1,
                                               l.n_split);
  if (l.n_split > 1) {
    const long n = (long)B * M * H1 * W1;
    finish_dp0_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        x, w0, b0, scratch + l.part_dp, dp0, p0, B, H, W, l.n_split);
  }
  const dim3 grid_b((W + FX - 1) / FX, (H + FY - 1) / FY, B);
  dx0_kernel<T><<<grid_b, NT_B, 0, s>>>(x, dp0, w0, dx, scratch + l.part_b, H, W);
  err = bwd::wgrad_s2(gm, p0, scratch + l.part_w, B, Ho, Wo, C1, H1, W1, s, RND);
  if (err != cudaSuccess) return (int)err;
  bwd::reduce_partials(scratch + l.part_b, l.blocks_b, NPB, dw0b, scratch + l.tmp, s);
  bwd::reduce_partials(scratch + l.part_w, l.slices, C1 * M * 9, dw1b, scratch + l.tmp, s);
  bwd::reduce_partials(scratch + l.part_db, l.tiles, C1, dw1b + (long)C1 * M * 9,
                       scratch + l.tmp, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch dep_encode_front_bwd_f32 and dep_encode_front_bwd_bf16
// need.
extern "C" long long dep_encode_front_bwd_scratch_floats(int B, int H, int W,
                                                         int C1) {
  return layout(B, H, W, C1).total;
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
  return launch<float>(x, g, out, w0, b0, w1, dx, dw0b, dw1b, scratch, B, H, W, C1,
                       stream);
}

extern "C" int dep_encode_front_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g,
                                         const __nv_bfloat16* out, const float* w0,
                                         const float* b0, const float* w1,
                                         __nv_bfloat16* dx, float* dw0b, float* dw1b,
                                         float* scratch, int B, int H, int W, int C1,
                                         void* stream) {
  return launch<__nv_bfloat16>(x, g, out, w0, b0, w1, dx, dw0b, dw1b, scratch, B, H, W,
                               C1, stream);
}

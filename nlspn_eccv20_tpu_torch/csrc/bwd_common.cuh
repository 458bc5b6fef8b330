// Pieces shared by the two backward kernels of the GRU refresh
// (dec_aff_tail_bwd.cu, K4, and dep_encode_front_bwd.cu, K5, which replace
// the TPU kernels dec_aff_tail._bwd_kernel and dep_encode_front._bwd_kernel):
// the weight gradient of a 3x3 stride-2 convolution between a wide NHWC
// tensor and a 16-channel planar one, a transpose that lays weights out for
// 16-byte copies, and the deterministic reduction of per-block partial sums.
//
// The TPU kernels accumulate their weight gradients across a sequential
// grid into one output block. Here blocks run in parallel and in no order,
// so every block writes its own partial sum to a scratch buffer and a
// second kernel adds the partials in a fixed order: the result is the same
// bits from run to run, as on the TPU. No atomics.

#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace bwd {

constexpr int M = 16;  // the planar side's channels, fixed by the model

// ---- weight gradient of a k3/s2/p1 convolution --------------------------
//
//   dW[c][m][ty][tx] = sum_{b,i,j} A[b][i][j][c] * P[b][m][2i-1+ty][2j-1+tx]
//
// A (B, Ha, Wa, C) NHWC; P (B, M, Hp, Wp) planar, zero outside. dW is laid
// out (C, M, 3, 3), torch's layout of both a Conv2d(M -> C) weight and a
// ConvTranspose2d(C -> M) one.
//
// It is a split-K product of (C x N) by (N x 9M), N = B Ha Wa pixels: 3.8
// GFLOP at NYU b=12 and C = 256, so bound by the FP32 cores (57 us at 67
// TFLOP/s). A block is (group of WG_C = 128 channels, slice s of N); slice
// s is the flat pixel range [N s / S, N (s + 1) / S), walked as row
// segments of at most SEG pixels. S is chosen from N and C
// (wgrad_s2_slices): two blocks on each SM at b=12. Per segment the block
// stages A's pixels (SEG x WG_C, 16-byte copies) and the three rows of P
// under them (M x 3 x (2 SEG + 1)) in shared memory with asynchronous
// copies into two buffers (cp_async.cuh): the next segment's copies are in
// flight while the FMAs run on this one. A thread owns 8 channels and the
// 9 taps of one m (72 sums); lanes run over m, so a warp's two float4
// loads of A are broadcasts and its P loads fall in 16 distinct banks. The
// thread keeps a 3x3 window of P in registers and slides it along the
// segment: per pixel 2 float4 loads of A and 6 words of P for 72 FMAs. The
// block's sums go to part[s], staged through shared memory so that the
// stores are whole float4s; reduce_partials adds the slices in a fixed
// order.

constexpr int WG_C = 128;              // channels per block
constexpr int WG_NT = WG_C / 8 * M;    // 256 threads: (octet, m)
constexpr int SEG = 32;                // pixels per row segment
constexpr int A_PITCH = WG_C + 4;      // keeps float4 rows 16-byte aligned
constexpr int P_COLS = 2 * SEG + 1;
constexpr int P_M = 3 * P_COLS;        // 195 = 3 mod 32: 16 m, 16 banks
constexpr int WG_BUF = SEG * A_PITCH + M * P_M;  // floats per buffer
constexpr int WG_SMEM = 2 * WG_BUF * (int)sizeof(float);
constexpr int CARD_SMS = 132;          // H100 SXM
constexpr int WG_MIN_PIXELS = 64;      // pixels a slice takes at least

__global__ void __launch_bounds__(WG_NT, 2)
wgrad_s2_kernel(const float* __restrict__ A, const float* __restrict__ P,
                float* __restrict__ part, int B, int Ha, int Wa, int C,
                int Hp, int Wp, int S) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * WG_C;
  const int s = blockIdx.y;
  const long long N = (long long)B * Ha * Wa;
  const long long beg = N * s / S;
  int left = (int)(N * (s + 1) / S - beg);  // pixels of the slice not staged
  // the segment being staged: image b, row i, first column j, pixels len
  const long long row0 = beg / Wa;
  int j = (int)(beg - row0 * Wa), i = (int)(row0 % Ha), b = (int)(row0 / Ha);
  const bool vec = (C & 3) == 0 && (reinterpret_cast<size_t>(A) & 15) == 0;

  // issues the copies of the segment (b, i, j, len) into buffer buf
  auto stage = [&](int buf, int len) {
    float* as = smem + buf * WG_BUF;
    float* ps = as + SEG * A_PITCH;
    const float* asrc = A + (((long long)b * Ha + i) * Wa + j) * C + c0;
    if (vec) {
      for (int e = tid; e < len * (WG_C / 4); e += WG_NT) {
        const int px = e / (WG_C / 4), cc = 4 * (e % (WG_C / 4));
        const bool ok = c0 + cc < C;
        cpa::copy16(as + px * A_PITCH + cc, ok ? asrc + px * C + cc : A, ok);
      }
    } else {
      for (int e = tid; e < len * WG_C; e += WG_NT) {
        const int px = e / WG_C, cc = e % WG_C;
        const bool ok = c0 + cc < C;
        cpa::copy4(as + px * A_PITCH + cc, ok ? asrc + px * C + cc : A, ok);
      }
    }
    const float* pb = P + (long long)b * M * Hp * Wp;
    const int y0 = 2 * i - 1, x0 = 2 * j - 1;
    for (int e = tid; e < M * P_M; e += WG_NT) {
      const int q = e % P_COLS, r = (e / P_COLS) % 3, m = e / P_M;
      const int y = y0 + r, x = x0 + q;
      const bool ok = y >= 0 && y < Hp && x >= 0 && x < Wp;
      cpa::copy4(ps + e, ok ? pb + (m * Hp + y) * Wp + x : P, ok);
    }
  };
  // the next segment's length, and the move past the current one
  auto seg_len = [&]() { return min(min(SEG, Wa - j), left); };
  auto advance = [&](int len) {
    left -= len;
    j += len;
    if (j == Wa) {
      j = 0;
      if (++i == Ha) {
        i = 0;
        ++b;
      }
    }
  };

  const int m = tid % M, oct = tid / M;
  float acc[8][9];
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int t = 0; t < 9; ++t) acc[k][t] = 0.0f;

  int len = seg_len();
  if (len > 0) {
    stage(0, len);
    advance(len);
  }
  cpa::commit();
  for (int buf = 0; len > 0; buf ^= 1) {
    const int nlen = seg_len();
    if (nlen > 0) {
      stage(buf ^ 1, nlen);
      advance(nlen);
    }
    cpa::commit();
    cpa::wait<1>();
    __syncthreads();
    const float* ap = smem + buf * WG_BUF + 8 * oct;
    const float* pr = smem + buf * WG_BUF + SEG * A_PITCH + m * P_M;
    float w0[3];  // the window's left column: P cols 2 px - 1 + {0, 1, 2}
#pragma unroll
    for (int r = 0; r < 3; ++r) w0[r] = pr[r * P_COLS];
#pragma unroll 2
    for (int px = 0; px < len; ++px) {
      float w1[3], w2[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        w1[r] = pr[r * P_COLS + 2 * px + 1];
        w2[r] = pr[r * P_COLS + 2 * px + 2];
      }
      const float4 a0 = *reinterpret_cast<const float4*>(ap + px * A_PITCH);
      const float4 a1 = *reinterpret_cast<const float4*>(ap + px * A_PITCH + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          acc[k][3 * r] = fmaf(av[k], w0[r], acc[k][3 * r]);
          acc[k][3 * r + 1] = fmaf(av[k], w1[r], acc[k][3 * r + 1]);
          acc[k][3 * r + 2] = fmaf(av[k], w2[r], acc[k][3 * r + 2]);
        }
#pragma unroll
      for (int r = 0; r < 3; ++r) w0[r] = w2[r];
    }
    __syncthreads();  // the buffer is restaged two segments on
    len = nlen;
  }

  // part[s] = dW (C, M, 9): the block's 128 channels are 18,432 contiguous
  // floats, written in two halves through shared memory as float4s
  float* out = part + s * (long long)C * M * 9;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    if (oct / 8 == h) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int t = 0; t < 9; ++t) smem[((oct % 8 * 8 + k) * M + m) * 9 + t] = acc[k][t];
    }
    __syncthreads();
    const int c = c0 + 64 * h;
    const int n = max(0, min(64, C - c)) * M * 9;  // a multiple of 4
    float* dst = out + (long long)c * M * 9;
    for (int e = 4 * tid; e < n; e += 4 * WG_NT)
      *reinterpret_cast<float4*>(dst + e) = *reinterpret_cast<const float4*>(smem + e);
    __syncthreads();
  }
}

// Slices of N: two blocks on each SM of the card, each at least
// WG_MIN_PIXELS pixels.
inline int wgrad_s2_slices(long long n_pixels, int C) {
  const int groups = (C + WG_C - 1) / WG_C;
  const long long want = (2 * CARD_SMS + groups - 1) / groups;
  const long long most = n_pixels / WG_MIN_PIXELS;
  return (int)(want < most ? want : (most > 0 ? most : 1));
}

inline long long wgrad_s2_partial_floats(long long n_pixels, int C) {
  return (long long)wgrad_s2_slices(n_pixels, C) * C * M * 9;
}

// A (B, Ha, Wa, C), P (B, M, Hp, Wp): part gets wgrad_s2_slices partials of
// dW. Returns the first launch error, if any.
inline cudaError_t wgrad_s2(const float* A, const float* P, float* part, int B,
                            int Ha, int Wa, int C, int Hp, int Wp,
                            cudaStream_t stream) {
  const int S = wgrad_s2_slices((long long)B * Ha * Wa, C);
  const cudaError_t err = cudaFuncSetAttribute(
      wgrad_s2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err != cudaSuccess) return err;
  wgrad_s2_kernel<<<dim3((C + WG_C - 1) / WG_C, S), WG_NT, WG_SMEM, stream>>>(
      A, P, part, B, Ha, Wa, C, Hp, Wp, S);
  return cudaGetLastError();
}

// ---- transpose of the last two axes --------------------------------------
//
//   out[n][c][r] = in[n][r][c]     in (nb, R, Cc), out (nb, Cc, R)
//
// Lays weights out as a kernel stages them, once a call (36,864 floats at
// C = 256): then a block copies them with 16-byte copies.

__global__ void __launch_bounds__(256)
transpose_kernel(const float* __restrict__ in, float* __restrict__ out, int nb,
                 int R, int Cc) {
  const long long o = (long long)blockIdx.x * 256 + threadIdx.x;
  if (o >= (long long)nb * R * Cc) return;
  const int r = (int)(o % R), c = (int)((o / R) % Cc);
  const long long n = o / ((long long)R * Cc);
  out[o] = __ldg(in + (n * R + r) * Cc + c);
}

inline void transpose(const float* in, float* out, int nb, int R, int Cc,
                      cudaStream_t stream) {
  const long long n = (long long)nb * R * Cc;
  transpose_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(in, out, nb, R, Cc);
}

// Floats rounded up to a multiple of 4, so that scratch regions stay
// 16-byte aligned.
inline long long align4(long long n) { return (n + 3) & ~3LL; }

// ---- deterministic sum of partials ---------------------------------------
//
//   out[c][e] = sum over s in chunk c of part[s][e]   (N elements each)
//
// Block = 32 elements x 8 strands; strand t adds s = t, t + 8, ... of the
// chunk in order, then strand 0 adds the 8 strands in order.

constexpr int RED_CHUNK = 64;

__global__ void __launch_bounds__(256)
reduce_chunks_kernel(const float* __restrict__ part, int S, int N,
                     float* __restrict__ out) {
  __shared__ float strands[8][33];
  const int e = blockIdx.x * 32 + threadIdx.x;
  const int s0 = blockIdx.y * RED_CHUNK;
  const int s1 = min(s0 + RED_CHUNK, S);
  float v = 0.0f;
  if (e < N)
    for (int s = s0 + threadIdx.y; s < s1; s += 8) v += __ldg(part + (long)s * N + e);
  strands[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && e < N) {
    float t = strands[0][threadIdx.x];
    for (int k = 1; k < 8; ++k) t += strands[k][threadIdx.x];
    out[(long)blockIdx.y * N + e] = t;
  }
}

// Floats of scratch reduce_partials needs for S partials of N elements.
inline long reduce_scratch_floats(int S, int N) {
  if (S <= RED_CHUNK) return 0;
  const int chunks = (S + RED_CHUNK - 1) / RED_CHUNK;
  return (long)chunks * N + reduce_scratch_floats(chunks, N);
}

// out[e] = sum_s part[s][e], in a fixed order; tmp holds
// reduce_scratch_floats(S, N) floats.
inline void reduce_partials(const float* part, int S, int N, float* out,
                            float* tmp, cudaStream_t stream) {
  const dim3 block(32, 8);
  if (S <= RED_CHUNK) {
    reduce_chunks_kernel<<<dim3((N + 31) / 32, 1), block, 0, stream>>>(part, S, N, out);
    return;
  }
  const int chunks = (S + RED_CHUNK - 1) / RED_CHUNK;
  reduce_chunks_kernel<<<dim3((N + 31) / 32, chunks), block, 0, stream>>>(part, S, N, tmp);
  reduce_partials(tmp, chunks, N, out, tmp + (long)chunks * N, stream);
}

}  // namespace bwd

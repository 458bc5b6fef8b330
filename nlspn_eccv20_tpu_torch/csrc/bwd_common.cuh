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
//
// bf16 (the kernels' bf16 forms, precision='bf16'): the weight gradient
// runs on the bf16 tensor cores (wgrad_s2_mma_kernel): A and P are bf16
// buffers, their products exact, their sums f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "cp_async.cuh"
#include "wgmma_bf16.cuh"

namespace bwd {

constexpr int M = 16;  // the planar side's channels, fixed by the model

// v rounded to bf16 (to nearest even), held in f32.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// v rounded to T and held in f32: the identity for float.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same_v<T, float>) return v;
  else return round_bf16(v);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// v as a T: rounded to nearest even for bf16.
template <typename T>
__device__ __forceinline__ T narrow(float v) {
  if constexpr (std::is_same_v<T, float>) return v;
  else return __float2bfloat16_rn(v);
}

// The two bf16 values of a 32-bit word, widened: the lower half first.
__device__ __forceinline__ float lo_bf16(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// ---- weight gradient of a k3/s2/p1 convolution --------------------------
//
//   dW[c][m][ty][tx] = sum_{b,i,j} A[b][i][j][c] * P[b][m][2i-1+ty][2j-1+tx]
//
// A (B, Ha, Wa, C) NHWC; P (B, M, Hp, Wp) planar, zero outside. dW is laid
// out (C, M, 3, 3), torch's layout of both a Conv2d(M -> C) weight and a
// ConvTranspose2d(C -> M) one.
//
// It is a split-K product of (C x N) by (N x 9M), N = B Ha Wa pixels: 3.8
// GFLOP at NYU b=12 and C = 256, so in f32 bound by the FP32 cores (57 us
// at 67 TFLOP/s; the bf16 forms take wgrad_s2_mma_kernel, below). A block
// is (group of WG_C = 128 channels, slice s of N); slice s is the flat
// pixel range [N s / S, N (s + 1) / S), walked as row
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
constexpr int A_PITCH_H = WG_C + 8;    // bf16 rows (the tensor-core form): 272 bytes
constexpr int P_COLS = 2 * SEG + 1;
constexpr int P_M = 3 * P_COLS;        // 195 = 3 mod 32: 16 m, 16 banks
constexpr int CARD_SMS = 132;          // H100 SXM
constexpr int WG_MIN_PIXELS = 64;      // pixels a slice takes at least

// floats of a buffer's A rows, and of a whole buffer (A rows, then P)
constexpr int WG_A_FLOATS = SEG * A_PITCH;
constexpr int WG_BUF = WG_A_FLOATS + M * P_M;
constexpr int WG_SMEM = 2 * WG_BUF * (int)sizeof(float);
static_assert(2 * WG_BUF >= WG_C / 2 * M * 9 && (WG_BUF * 4) % 16 == 0,
              "the output stage fits, and the buffers stay 16-byte aligned");

__global__ void __launch_bounds__(WG_NT, 2)
wgrad_s2_kernel(const float* __restrict__ A, const float* __restrict__ P,
                float* __restrict__ part, int B, int Ha, int Wa, int C,
                int Hp, int Wp, int S) {
  constexpr int A_FLOATS = WG_A_FLOATS;
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
    float* ps = as + A_FLOATS;
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
    const float* pr = smem + buf * WG_BUF + A_FLOATS + m * P_M;
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
      float av[8];
      const float4 a0 = *reinterpret_cast<const float4*>(ap + px * A_PITCH);
      const float4 a1 = *reinterpret_cast<const float4*>(ap + px * A_PITCH + 4);
      av[0] = a0.x, av[1] = a0.y, av[2] = a0.z, av[3] = a0.w;
      av[4] = a1.x, av[5] = a1.y, av[6] = a1.z, av[7] = a1.w;
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

// ---- the same weight gradient on the bf16 tensor cores ------------------
//
// The bf16 forms (K4-bf16 and K5-bf16) take this pass: the same slices,
// segments and partials as wgrad_s2_kernel, the products on bf16 wgmma
// (wgmma_bf16.cuh) instead of the FP32 cores. Their operands are bf16
// buffers (K4-bf16's x and dY1, K5-bf16's gm and p0), so the products are
// exact and only the order of the f32 sums differs.
//
//   D (C x 144) += A^T (C x pixels) . Pcol (pixels x 144),  column m 9 + tap
//
// is dW (C, M, 3, 3) as it is laid out. A block of 256 threads owns 128
// channels, a warpgroup 64 of them (M = 64), a warp 16; N = 144, all of a
// channel's (m, tap); the reduction runs over the segment's pixels in
// k-steps of 16. Per segment, after its copies have landed: A's rows as
// bf16 (staged raw by 16-byte cp.async copies), its rows past the segment
// zeroed; Pcol built from the staged P rows as bf16 K-major core matrices
// (the stride-2 im2col: column (m, tap) of pixel px is P[m][ty][2 px + tx]
// of the staged rows, zero past the segment). P rows are staged from the
// even column 2 j - 2 as 4-byte words (2 SEG + 2 values), which needs an
// even Wp (K4's W1 = 2 Wg; K5-bf16 pads p0's rows to an even width). A's
// fragments come from the pixel-major tile by ldmatrix.trans (A is the
// transposed operand); a segment is always two k-steps (the second of a
// short one sums zeros), one commit group, summed in the tensor core
// across the slice (a slice holds at most a few dozen k-steps). The 72
// sums a thread go to part[s] as float2s.

constexpr int WGM_N = M * 9;                  // 144 columns: (m, tap)
constexpr int WGM_STEP = WGM_N / 8 * 256;     // bytes of a k-step's Pcol
constexpr int WGM_ATILE = SEG * A_PITCH_H * 2;   // bytes of a bf16 A tile
constexpr int P_COLS_H = 2 * SEG + 2;         // bf16 P: a staged row from col 2 j - 2
constexpr int P_M_H = 3 * P_COLS_H;           // 198 bf16 an m

constexpr int WGM_A_BYTES = WGM_ATILE;                 // a buffer's A rows
constexpr int WGM_BUF = WGM_A_BYTES + M * P_M_H * 2;    // and its P rows
constexpr int WGM_SMEM = 2 * WGM_BUF + 2 * WGM_STEP;
static_assert(WGM_BUF % 16 == 0 && WGM_ATILE % 16 == 0, "16-byte aligned regions");

__global__ void __launch_bounds__(WG_NT, 2)
wgrad_s2_mma_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ P,
                    float* __restrict__ part, int B, int Ha, int Wa, int C,
                    int Hp, int Wp, int S) {
  constexpr int BUF = WGM_BUF, A_BYTES = WGM_A_BYTES;
  extern __shared__ __align__(128) unsigned char smb[];
  unsigned short* bt = reinterpret_cast<unsigned short*>(smb + 2 * BUF);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int c0 = blockIdx.x * WG_C;
  const int s = blockIdx.y;
  const long long N = (long long)B * Ha * Wa;
  const long long beg = N * s / S;
  int left = (int)(N * (s + 1) / S - beg);  // pixels of the slice not staged
  // the segment being staged: image b, row i, first column j
  const long long row0 = beg / Wa;
  int j = (int)(beg - row0 * Wa), i = (int)(row0 % Ha), b = (int)(row0 / Ha);
  const bool vec = (C & 7) == 0 && (reinterpret_cast<size_t>(A) & 15) == 0;

  // issues the copies of the segment (b, i, j, len) into buffer buf
  auto stage = [&](int buf, int len) {
    unsigned char* base = smb + buf * BUF;
    const __nv_bfloat16* asrc = A + (((long long)b * Ha + i) * Wa + j) * C + c0;
    __nv_bfloat16* ah = reinterpret_cast<__nv_bfloat16*>(base);
    if (vec) {
      for (int e = tid; e < len * (WG_C / 8); e += WG_NT) {
        const int px = e / (WG_C / 8), cc = 8 * (e % (WG_C / 8));
        const bool ok = c0 + cc < C;
        cpa::copy16(ah + px * A_PITCH_H + cc, ok ? asrc + px * C + cc : A, ok);
      }
    } else {  // plain loads: the buffer is not read before the next barrier
      for (int e = tid; e < len * WG_C; e += WG_NT) {
        const int px = e / WG_C, cc = e % WG_C;
        ah[px * A_PITCH_H + cc] = c0 + cc < C ? asrc[px * C + cc] : __float2bfloat16_rn(0.0f);
      }
    }
    const __nv_bfloat16* pb = P + (long long)b * M * Hp * Wp;
    const int y0 = 2 * i - 1;
    // words of two columns from 2 j - 2: Wp even, so a word is in or out
    __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(base + A_BYTES);
    for (int e = tid; e < M * P_M_H / 2; e += WG_NT) {
      const int q = 2 * (e % (P_COLS_H / 2)), r = (e / (P_COLS_H / 2)) % 3;
      const int m = e / (P_M_H / 2);
      const int y = y0 + r, x = 2 * j - 2 + q;
      const bool ok = y >= 0 && y < Hp && x >= 0 && x < Wp;
      cpa::copy4(ps + 2 * e, ok ? pb + (m * Hp + y) * Wp + x : P, ok);
    }
  };
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

  // this warp's 16 channels of the block's 128, and its ldmatrix row:
  // lane L gives row L % 8 of matrix L / 8 (pixels + 8 for matrices 2, 3;
  // channels + 8 for 1, 3)
  const int cw = 64 * (warp >> 2) + 16 * (warp & 3);
  const int lrow = (lane & 7) + 8 * (lane >> 4), lcol = cw + 8 * ((lane >> 3) & 1);
  float acc[WGM_N / 2];
#pragma unroll
  for (int e = 0; e < WGM_N / 2; ++e) acc[e] = 0.0f;
  hold(acc);

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
    unsigned char* base = smb + buf * BUF;
    unsigned short* ah = reinterpret_cast<unsigned short*>(base);
    // rows past the segment: zeros, not stale or unset words
#pragma unroll 1
    for (int e = tid; e < (SEG - len) * (WG_C / 8); e += WG_NT) {
      const int px = len + e / (WG_C / 8), cc = 8 * (e % (WG_C / 8));
      *reinterpret_cast<uint4*>(ah + px * A_PITCH_H + cc) = make_uint4(0u, 0u, 0u, 0u);
    }
    // Pcol: column n = m 9 + tap of pixel px at q 4608 + (n / 8) 256 + (kk / 8)
    // 128 + (n % 8) 16 + (kk % 8) 2 bytes (px = 16 q + kk), pixels in pairs
#pragma unroll 1
    for (int e = tid; e < WGM_N * SEG / 2; e += WG_NT) {
      const int n = e / (SEG / 2), px = 2 * (e - n * (SEG / 2));
      const int m = n / 9, tap = n - 9 * m;
      // staged col 1 is image col 2 j - 1, tap 0's column of pixel 0
      const unsigned short* src = reinterpret_cast<const unsigned short*>(base + A_BYTES) +
                                  m * P_M_H + (tap / 3) * P_COLS_H + 1 + 2 * px + tap % 3;
      const uint32_t word = pack_raw(px < len ? src[0] : 0, px + 1 < len ? src[2] : 0);
      const int q = px >> 4, kk = px & 15;
      *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(bt) + q * WGM_STEP +
                                   (n >> 3) * 256 + (kk >> 3) * 128 + (n & 7) * 16 +
                                   (kk & 7) * 2) = word;
    }
    fence_async_smem();
    __syncthreads();
    uint32_t a0[4], a1[4];
    ldmatrix_x4_trans(a0, ah + lrow * A_PITCH_H + lcol);
    ldmatrix_x4_trans(a1, ah + (16 + lrow) * A_PITCH_H + lcol);
    wgmma_fence();
    wgmma_bf16<WGM_N>(acc, a0, kmajor_desc_b16(bt, 128, 256));
    wgmma_bf16<WGM_N>(acc, a1, kmajor_desc_b16(bt + WGM_STEP / 2, 128, 256));
    wgmma_commit();
    wgmma_wait<0>();
    hold(acc);
    hold(a0);
    hold(a1);
    __syncthreads();  // the buffer is restaged, and A and Pcol rebuilt
    len = nlen;
  }

  // part[s] = dW (C, M, 9): acc[4jj + 2h + e] is channel c0 + cw + gid + 8h,
  // column 8 jj + 2 tig + e
  float* out = part + s * (long long)C * WGM_N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + cw + gid + 8 * h;
    if (c >= C) continue;
#pragma unroll
    for (int jj = 0; jj < WGM_N / 8; ++jj)
      *reinterpret_cast<float2*>(out + (long long)c * WGM_N + 8 * jj + 2 * tig) =
          make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
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

// A (B, Ha, Wa, C) and P (B, M, Hp, Wp), both f32 (on the FP32 cores) or
// both bf16 (on the bf16 tensor cores; Wp even): part gets wgrad_s2_slices
// partials of dW. Returns the first launch error, if any.
inline cudaError_t wgrad_s2(const float* A, const float* P, float* part, int B, int Ha,
                            int Wa, int C, int Hp, int Wp, cudaStream_t stream) {
  const int S = wgrad_s2_slices((long long)B * Ha * Wa, C);
  const cudaError_t err = cudaFuncSetAttribute(
      wgrad_s2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err != cudaSuccess) return err;
  wgrad_s2_kernel<<<dim3((C + WG_C - 1) / WG_C, S), WG_NT, WG_SMEM, stream>>>(
      A, P, part, B, Ha, Wa, C, Hp, Wp, S);
  return cudaGetLastError();
}

inline cudaError_t wgrad_s2(const __nv_bfloat16* A, const __nv_bfloat16* P, float* part,
                            int B, int Ha, int Wa, int C, int Hp, int Wp,
                            cudaStream_t stream) {
  const int S = wgrad_s2_slices((long long)B * Ha * Wa, C);
  const cudaError_t err = cudaFuncSetAttribute(
      wgrad_s2_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WGM_SMEM);
  if (err != cudaSuccess) return err;
  wgrad_s2_mma_kernel<<<dim3((C + WG_C - 1) / WG_C, S), WG_NT, WGM_SMEM, stream>>>(
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
  const float v = __ldg(in + (n * R + r) * Cc + c);
  out[o] = v;
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

// Pieces shared by the two backward kernels of the GRU refresh
// (dec_aff_tail_bwd.cu and dep_encode_front_bwd.cu): the weight gradient
// of a 3x3 stride-2 convolution between a wide NHWC tensor and a 16-channel
// planar one, and the deterministic reduction of per-block partial sums.
//
// The TPU kernels accumulate their weight gradients across a sequential
// grid into one output block. Here blocks run in parallel and in no order,
// so every block writes its own partial sum to a scratch buffer and a
// second kernel adds the partials in a fixed order: the result is the same
// bits from run to run, as on the TPU. No atomics.

#pragma once

#include <cuda_runtime.h>

namespace bwd {

constexpr int M = 16;  // the planar side's channels, fixed by the model

// ---- weight gradient of a k3/s2/p1 convolution --------------------------
//
//   dW[c][m][ty][tx] = sum_{b,i,j} A[b][i][j][c] * P[b][m][2i-1+ty][2j-1+tx]
//   dA_sum[c]        = sum_{b,i,j} A[b][i][j][c]                (optional)
//
// A (B, Ha, Wa, C) NHWC, read as A * [mask > 0] when mask is given; P (B, M,
// Hp, Wp) planar, zero outside. dW is laid out (C, M, 3, 3), torch's layout
// of both a Conv2d(M -> C) weight and a ConvTranspose2d(C -> M) one.
//
// It is a product of (C x N) by (N x 9M) with N = B Ha Wa: bound by the
// FP32 cores. Block = (group of WG_C channels, slice s of N). The slice is
// a fixed, strided set of row segments of SEG pixels; per segment the block
// stages A's segment (SEG x WG_C) and P's three rows under it (M x 3 x
// (2 SEG + 1)) in shared memory. Each thread owns 4 channels and one m (36
// sums): per pixel one float4 of A and 9 words of P for 36 FMAs. The
// block's sums go to part[s] and reduce_partials adds the slices in order.

constexpr int WG_C = 32;           // channels per block
constexpr int SEG = 32;            // pixels per row segment
constexpr int WG_NT = WG_C / 4 * M;  // 128 threads: (channel quad, m)
constexpr int WG_SLICES = 64;      // slices of N: partial sums per weight
constexpr int A_PITCH = WG_C + 4;  // keeps float4 rows 16-byte aligned
constexpr int P_COLS = 2 * SEG + 1;

__global__ void __launch_bounds__(WG_NT)
wgrad_s2_kernel(const float* __restrict__ A, const float* __restrict__ mask,
                const float* __restrict__ P, float* __restrict__ part,
                int B, int Ha, int Wa, int C, int Hp, int Wp, int with_sum) {
  __shared__ __align__(16) float as[SEG * A_PITCH];
  __shared__ float ps[M][3][P_COLS];

  const int tid = threadIdx.x;
  const int cq = tid % (WG_C / 4), m = tid / (WG_C / 4);
  const int c0 = blockIdx.x * WG_C;
  const int s = blockIdx.y;
  const int nseg = (Wa + SEG - 1) / SEG;
  const long units = (long)B * Ha * nseg;

  float acc[4][9];
  float asum[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    asum[j] = 0.0f;
#pragma unroll
    for (int t = 0; t < 9; ++t) acc[j][t] = 0.0f;
  }

  for (long u = s; u < units; u += WG_SLICES) {
    const int seg = (int)(u % nseg);
    const int i = (int)((u / nseg) % Ha);
    const int b = (int)(u / ((long)nseg * Ha));
    const int j0 = seg * SEG;
    __syncthreads();
    for (int e = tid; e < SEG * WG_C; e += WG_NT) {
      const int cc = e % WG_C, px = e / WG_C;
      const int j = j0 + px, c = c0 + cc;
      float v = 0.0f;
      if (j < Wa && c < C) {
        const long o = (((long)b * Ha + i) * Wa + j) * C + c;
        v = __ldg(A + o);
        if (mask && !(__ldg(mask + o) > 0.0f)) v = 0.0f;
      }
      as[px * A_PITCH + cc] = v;
    }
    for (int e = tid; e < M * 3 * P_COLS; e += WG_NT) {
      const int col = e % P_COLS, ty = (e / P_COLS) % 3, mm = e / (3 * P_COLS);
      const int py = 2 * i - 1 + ty, px = 2 * j0 - 1 + col;
      ps[mm][ty][col] = (py >= 0 && py < Hp && px >= 0 && px < Wp)
          ? __ldg(P + (((long)b * M + mm) * Hp + py) * Wp + px) : 0.0f;
    }
    __syncthreads();
#pragma unroll 2
    for (int px = 0; px < SEG; ++px) {
      const float4 a = *reinterpret_cast<const float4*>(as + px * A_PITCH + 4 * cq);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int ty = 0; ty < 3; ++ty)
#pragma unroll
        for (int tx = 0; tx < 3; ++tx) {
          const float pv = ps[m][ty][2 * px + tx];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j][ty * 3 + tx] = fmaf(av[j], pv, acc[j][ty * 3 + tx]);
        }
      if (with_sum && m == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) asum[j] += av[j];
      }
    }
  }

  // part[s] = [dW (C, M, 9) | dA_sum (C) if with_sum]
  const long stride = (long)C * M * 9 + (with_sum ? C : 0);
  float* ps_out = part + s * stride;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + 4 * cq + j;
    if (c >= C) continue;
#pragma unroll
    for (int t = 0; t < 9; ++t) ps_out[((long)c * M + m) * 9 + t] = acc[j][t];
    if (with_sum && m == 0) ps_out[(long)C * M * 9 + c] = asum[j];
  }
}

inline int wgrad_s2_partial_floats(int C, int with_sum) {
  return WG_SLICES * (C * M * 9 + (with_sum ? C : 0));
}

inline void wgrad_s2(const float* A, const float* mask, const float* P,
                     float* part, int B, int Ha, int Wa, int C, int Hp, int Wp,
                     int with_sum, cudaStream_t stream) {
  const dim3 grid((C + WG_C - 1) / WG_C, WG_SLICES);
  wgrad_s2_kernel<<<grid, WG_NT, 0, stream>>>(A, mask, P, part, B, Ha, Wa, C,
                                              Hp, Wp, with_sum);
}

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

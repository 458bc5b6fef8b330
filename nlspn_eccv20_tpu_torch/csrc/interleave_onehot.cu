// The 4x4 phase interleave as a product with one-hot expansions (K11d):
// for each image n and row phase a, one GEMM of depth 4 * 76 = 304,
//
//   out[n, c, 4i + a, x] = sum_b sum_j ph[n, (4a + b) * 8 + c, i, j] * E[b, j, x],
//
// for c < 8, i < 58, x < 304, with ph's 58x76 window in the first rows
// and columns of padded (hp, wp) planes and E (4, 76, 304) an input. With
// the one-hot E[b, j, 4j + b] = 1 the result is the interleave bit for bit:
// each sum has one term that is not zero.
//
// Replaces the TPU kernel k_matmul (devtools/microbench_asm.py, reached
// from run), which expands the lanes on the MXU (the four phases b of a
// row phase a times E_b, summed) and stores the rows strided by 4.
//
// Bound on the card: operations, 2 * 464 * 304 * 304 FLOPs for each
// (n, a), about 4 times the time of the 8 B an element it moves. Design:
// a shared-memory tiled GEMM in plain f32 FMAs, not TF32 tensor cores,
// which would round the phases' values: 64x64 output tiles of the
// (464, 304) product, K in slices of 16 staged in shared memory (4 KB for
// each operand), 256 threads each holding a 4x4 block of sums in registers.
// The sums run over k = 76 b + j in ascending order. The A tile is read
// straight from the phase planes (row r = 58 c + i, column k = 76 b + j),
// so neither the window nor the strided output is copied first.

#include <cuda_runtime.h>

namespace {

constexpr int kC = 8, kI = 58, kJ = 76, kH = 4 * kI, kW = 4 * kJ;
constexpr int kM = kC * kI, kK = 4 * kJ, kN = kW;   // 464, 304, 304
constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

__global__ void __launch_bounds__(kThreads)
interleave_onehot_kernel(const float* __restrict__ ph, const float* __restrict__ e,
                         float* __restrict__ out, int hp, int wp) {
  __shared__ float as[kBK][kBM + 4];
  __shared__ float bs[kBK][kBN];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const long n = blockIdx.z / 4;
  const int a = blockIdx.z % 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < kK; k0 += kBK) {   // kK is a multiple of kBK
#pragma unroll
    for (int q = 0; q < kBM * kBK / kThreads; ++q) {
      const int idx = t + q * kThreads, r = idx / kBK, kk = idx % kBK;
      const int row = row0 + r, k = k0 + kk;
      float v = 0.0f;
      if (row < kM) {
        const int c = row / kI, i = row % kI, b = k / kJ, j = k % kJ;
        v = __ldg(ph + ((n * 16 * kC + (4 * a + b) * kC + c) * hp + i) * wp + j);
      }
      as[kk][r] = v;
    }
#pragma unroll
    for (int q = 0; q < kBK * kBN / kThreads; ++q) {
      const int idx = t + q * kThreads, kk = idx / kBN, cc = idx % kBN;
      const int col = col0 + cc;
      bs[kk][cc] = col < kN ? __ldg(e + (long)(k0 + kk) * kN + col) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float ra[4], rb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ra[u] = as[kk][ty * 4 + u];
        rb[u] = bs[kk][tx * 4 + u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(ra[u], rb[v], acc[u][v]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int row = row0 + ty * 4 + u;
    if (row >= kM) continue;
    const int c = row / kI, i = row % kI;
    float* dst = out + ((n * kC + c) * kH + 4 * i + a) * kW;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int col = col0 + tx * 4 + v;
      if (col < kN) dst[col] = acc[u][v];
    }
  }
}

}  // namespace

// ph: (batch, 128, hp, wp) f32 contiguous, hp >= 58, wp >= 76;
// e: (4, 76, 304) f32 contiguous; out: (batch, 8, 232, 304) f32
// contiguous. Returns cudaGetLastError(), or cudaErrorInvalidValue for an
// empty batch or planes smaller than 58x76.
extern "C" int interleave_onehot_f32(const float* ph, const float* e, float* out, int batch,
                                     int hp, int wp, void* stream) {
  if (batch <= 0 || hp < kI || wp < kJ) return (int)cudaErrorInvalidValue;
  const dim3 grid((kN + kBN - 1) / kBN, (kM + kBM - 1) / kBM, 4 * batch);
  interleave_onehot_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(ph, e, out, hp, wp);
  return (int)cudaGetLastError();
}

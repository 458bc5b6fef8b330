// The 4x4 phase interleave, output-driven (K11a): 16 phases x 8 channels
// of a 58x76 plane, stored in the first 58 rows and 76 columns of padded
// (hp, wp) planes, become the planar (8, 232, 304) map of each image:
//
//   out[n, c, 4i + a, 4j + b] = ph[n, (4a + b) * 8 + c, i, j],  i < 58, j < 76.
//
// Replaces the TPU kernel asm_kernel (devtools/microbench_interleave.py,
// reached from pallas_asm), which builds each output plane by repeating
// every phase x4 along both axes and selecting it by (y % 4, x % 4). The
// padding is never read.
//
// Bound on the card: memory, the 58x76 window in and the output out, 8 B
// an output element. Design: output-driven, as the TPU kernel assembles
// whole output planes: a thread owns the 4 output columns 4j .. 4j + 3 of
// one row y of one (n, c), which are the four phases b of window element
// (y / 4, j). It makes 4 scalar loads, one from each phase plane, where a
// warp's 32 threads read 128 contiguous bytes of each plane row (any wp:
// the loads need no alignment), and one float4 store, where a warp writes
// 512 contiguous bytes of output row y (304 floats a row: every row
// 16-byte aligned). A block is 8 output rows of one (n, c), 608 threads =
// 19 whole warps; the grid is (29 row groups, 8 B). Index arithmetic is
// 32-bit, with divisions by constants only.

#include <cuda_runtime.h>

namespace {

constexpr int kC = 8, kI = 58, kJ = 76, kH = 4 * kI, kW = 4 * kJ;
constexpr int kRows = 8;                  // output rows a block
constexpr int kThreads = kRows * kJ;      // 608: 19 warps

__global__ void __launch_bounds__(kThreads)
interleave_asm_kernel(const float* __restrict__ ph, float* __restrict__ out, int hp, int wp) {
  const int t = threadIdx.x;
  const int r = t / kJ, j = t - r * kJ;           // row of the block, window column
  const int y = blockIdx.x * kRows + r;           // output row: 4i + a
  const int nc = blockIdx.y, n = nc / kC, c = nc - n * kC;
  const int a = y & 3, i = y >> 2;
  const long plane = (long)hp * wp;
  // phase (a, b) of channel c: plane (4a + b) * 8 + c; b steps 8 planes
  const float* src = ph + ((long)n * 16 * kC + (4 * a) * kC + c) * plane + (long)i * wp + j;
  float4 v;
  v.x = __ldg(src);
  v.y = __ldg(src + kC * plane);
  v.z = __ldg(src + 2 * kC * plane);
  v.w = __ldg(src + 3 * kC * plane);
  reinterpret_cast<float4*>(out + ((long)nc * kH + y) * kW)[j] = v;
}

}  // namespace

// ph: (batch, 128, hp, wp) f32 contiguous, hp >= 58, wp >= 76;
// out: (batch, 8, 232, 304) f32 contiguous, 16-byte aligned. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an empty batch, a batch
// past the grid's 65535 (n, c) pairs or planes smaller than 58x76.
extern "C" int interleave_asm_f32(const float* ph, float* out, int batch, int hp, int wp,
                                  void* stream) {
  if (batch <= 0 || batch * kC > 65535 || hp < kI || wp < kJ)
    return (int)cudaErrorInvalidValue;
  interleave_asm_kernel<<<dim3(kH / kRows, batch * kC), kThreads, 0, (cudaStream_t)stream>>>(
      ph, out, hp, wp);
  return (int)cudaGetLastError();
}

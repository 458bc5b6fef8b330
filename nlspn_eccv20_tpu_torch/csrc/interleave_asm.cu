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
// an output element. Design: one thread per output element, as the TPU
// kernel assembles whole output planes. The writes are coalesced; the 32
// threads of a warp read 8 consecutive floats from each of 4 phase planes.

#include <cuda_runtime.h>

namespace {

constexpr int kC = 8, kI = 58, kJ = 76, kH = 4 * kI, kW = 4 * kJ;

__global__ void interleave_asm_kernel(const float* __restrict__ ph, float* __restrict__ out,
                                      int batch, int hp, int wp) {
  const long o = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= (long)batch * kC * kH * kW) return;
  const int x = (int)(o % kW), y = (int)(o / kW % kH), c = (int)(o / ((long)kW * kH) % kC);
  const long n = o / ((long)kW * kH * kC);
  const int plane = ((y % 4) * 4 + x % 4) * kC + c;
  out[o] = __ldg(ph + ((n * 16 * kC + plane) * hp + y / 4) * wp + x / 4);
}

}  // namespace

// ph: (batch, 128, hp, wp) f32 contiguous, hp >= 58, wp >= 76;
// out: (batch, 8, 232, 304) f32 contiguous. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an empty batch or planes smaller than 58x76.
extern "C" int interleave_asm_f32(const float* ph, float* out, int batch, int hp, int wp,
                                  void* stream) {
  if (batch <= 0 || hp < kI || wp < kJ) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long n = (long)batch * kC * kH * kW;
  interleave_asm_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                          (cudaStream_t)stream>>>(ph, out, batch, hp, wp);
  return (int)cudaGetLastError();
}

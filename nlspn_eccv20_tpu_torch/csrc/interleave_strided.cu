// The 4x4 phase interleave, input-driven (K11b): the same function as
// K11a,
//
//   out[n, c, 4i + a, 4j + b] = ph[n, (4a + b) * 8 + c, i, j],  i < 58, j < 76,
//
// with ph's 58x76 window in the first rows and columns of padded (hp, wp)
// planes.
//
// Replaces the TPU kernel k_strided (devtools/microbench_asm.py, reached
// from run), which stores each phase into out[c, a::4, b::4] with strided
// stores. The padding is never read.
//
// Bound on the card: memory, the window in and the output out, 8 B an
// element. Design: one thread per element of the window, the counterpart
// of the strided stores. The reads are coalesced along j; each warp's 32
// writes land 4 floats apart, so they touch 4x the sectors of a dense
// store and L2 merges the four phases' partial sectors before they go to
// memory. Kept as the TPU kernel's access pattern; K11a is the
// output-driven form.

#include <cuda_runtime.h>

namespace {

constexpr int kC = 8, kI = 58, kJ = 76, kH = 4 * kI, kW = 4 * kJ;

__global__ void interleave_strided_kernel(const float* __restrict__ ph,
                                          float* __restrict__ out, int batch, int hp, int wp) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long)batch * 16 * kC * kI * kJ) return;
  const int j = (int)(e % kJ), i = (int)(e / kJ % kI), p = (int)(e / (kJ * kI) % (16 * kC));
  const long n = e / ((long)kJ * kI * 16 * kC);
  const int c = p % kC, a = p / kC / 4, b = p / kC % 4;
  out[((n * kC + c) * kH + 4 * i + a) * kW + 4 * j + b] =
      __ldg(ph + ((n * 16 * kC + p) * hp + i) * wp + j);
}

}  // namespace

// ph: (batch, 128, hp, wp) f32 contiguous, hp >= 58, wp >= 76;
// out: (batch, 8, 232, 304) f32 contiguous. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an empty batch or planes smaller than 58x76.
extern "C" int interleave_strided_f32(const float* ph, float* out, int batch, int hp, int wp,
                                      void* stream) {
  if (batch <= 0 || hp < kI || wp < kJ) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long n = (long)batch * 16 * kC * kI * kJ;
  interleave_strided_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                              (cudaStream_t)stream>>>(ph, out, batch, hp, wp);
  return (int)cudaGetLastError();
}

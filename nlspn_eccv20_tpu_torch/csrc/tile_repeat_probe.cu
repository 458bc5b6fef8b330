// The blockwise-tile probe (K11c), a timing probe and not an interleave:
//
//   out[n, c, y, x] = ph[n, ((y % 4) * 4 + x % 4) * 8 + c, y % 58, x % 76]
//
// for y < 232, x < 304, with ph's 58x76 window in the first rows and
// columns of padded (hp, wp) planes.
//
// Replaces the TPU kernel k_repeat (devtools/microbench_asm.py, reached
// from run). It repeats each phase x4 with pltpu.repeat, which tiles the
// 58x76 plane blockwise ([P P P P], not each value four times), and selects
// a phase by (y % 4, x % 4): the formula above. The TPU benchmark kept it
// to time the repeat-and-mask layout, not for its result.
//
// Bound on the card: memory, the window in and the output out, 8 B an
// element. Design: one thread per output element, writes coalesced; the
// reads of a warp walk 4 phase planes at 8 consecutive columns each, as
// K11a's.

#include <cuda_runtime.h>

namespace {

constexpr int kC = 8, kI = 58, kJ = 76, kH = 4 * kI, kW = 4 * kJ;

__global__ void tile_repeat_probe_kernel(const float* __restrict__ ph, float* __restrict__ out,
                                         int batch, int hp, int wp) {
  const long o = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= (long)batch * kC * kH * kW) return;
  const int x = (int)(o % kW), y = (int)(o / kW % kH), c = (int)(o / ((long)kW * kH) % kC);
  const long n = o / ((long)kW * kH * kC);
  const int plane = ((y % 4) * 4 + x % 4) * kC + c;
  out[o] = __ldg(ph + ((n * 16 * kC + plane) * hp + y % kI) * wp + x % kJ);
}

}  // namespace

// ph: (batch, 128, hp, wp) f32 contiguous, hp >= 58, wp >= 76;
// out: (batch, 8, 232, 304) f32 contiguous. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an empty batch or planes smaller than 58x76.
extern "C" int tile_repeat_probe_f32(const float* ph, float* out, int batch, int hp, int wp,
                                     void* stream) {
  if (batch <= 0 || hp < kI || wp < kJ) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long n = (long)batch * kC * kH * kW;
  tile_repeat_probe_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                             (cudaStream_t)stream>>>(ph, out, batch, hp, wp);
  return (int)cudaGetLastError();
}

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
// element. Design: a thread owns input elements, as the TPU kernel's
// strided stores do, but all four column phases b of them at once: the
// same (n, a, c, i) and four adjacent columns j = 4q .. 4q + 3 of the four
// planes (4a + b) * 8 + c. It reads one float4 from each plane and
// transposes the 4x4 block in registers into the 64 contiguous output
// bytes out[n, c, 4i + a, 16q .. 16q + 15] (76 = 19 * 4, and a 304-float
// output row is 16-byte aligned). Threads run q fastest, then the output
// row (n, c, 4i + a), so thread t's 64 bytes are the t-th 64 bytes of the
// output and a warp's 32 threads own 2 KB of it. A warp passes its 128
// float4s through shared memory (slots swizzled by lane / 2: no bank
// conflict either way) and stores them as four runs of 512 contiguous
// bytes: every load and store moves whole 32-byte sectors. (Stored by
// their owners, four float4s 64 bytes apart a warp instruction, every
// sector is written in two halves by two instructions; on an H100 that
// form ran no faster than a copy, PERF.md has the times.) Planes whose
// width is not a multiple of 4, or phases not 16-byte aligned, take the
// scalar form (four 4-byte loads a plane), chosen on the host. 128 threads
// a block: 276 blocks at b=1 (35,264 threads), two for each of the 132 SMs.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kC = 8, kI = 58, kJ = 76, kH = 4 * kI, kW = 4 * kJ, kQ = kJ / 4;
constexpr int kThreads = 128;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
interleave_strided_kernel(const float* __restrict__ ph, float* __restrict__ out, int batch,
                          int hp, int wp) {
  __shared__ float4 xs[kThreads / 32][128];   // a warp's 2 KB of output
  const long total = (long)batch * kC * kH * kQ;
  const int lane = threadIdx.x % 32;
  const long t = (long)blockIdx.x * kThreads + threadIdx.x, t0 = t - lane;
  float4 v[4] = {};
  if (t < total) {
    const int q = (int)(t % kQ);
    const long orow = t / kQ;                  // (n * 8 + c) * 232 + 4i + a
    const int y = (int)(orow % kH), a = y % 4, i = y / 4;
    const long nc = orow / kH, n = nc / kC;
    const int c = (int)(nc % kC);
    const long plane = (long)hp * wp;
    const float* src = ph + ((n * 16 * kC + 4 * a * kC + c) * hp + i) * (long)wp + 4 * q;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float* p = src + b * kC * plane;
      if constexpr (kVec) {
        v[b] = __ldg(reinterpret_cast<const float4*>(p));
      } else {
        v[b] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
      }
    }
  }
  // chunk u (columns 16q + 4u ..) of this thread goes to slot 4 lane + (u + lane / 2) % 4
  float4* x = xs[threadIdx.x / 32];
  const int sw = lane / 2;
  x[4 * lane + (sw & 3)] = make_float4(v[0].x, v[1].x, v[2].x, v[3].x);
  x[4 * lane + ((sw + 1) & 3)] = make_float4(v[0].y, v[1].y, v[2].y, v[3].y);
  x[4 * lane + ((sw + 2) & 3)] = make_float4(v[0].z, v[1].z, v[2].z, v[3].z);
  x[4 * lane + ((sw + 3) & 3)] = make_float4(v[0].w, v[1].w, v[2].w, v[3].w);
  __syncwarp();
  float4* dst = reinterpret_cast<float4*>(out) + 4 * t0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = 32 * r + lane, l = j / 4;   // chunk j % 4 of the warp's thread l
    if (t0 + l < total) dst[j] = x[4 * l + ((j % 4 + l / 2) & 3)];
  }
}

}  // namespace

// ph: (batch, 128, hp, wp) f32 contiguous, hp >= 58, wp >= 76;
// out: (batch, 8, 232, 304) f32 contiguous, 16-byte aligned. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an empty batch, planes
// smaller than 58x76 or an output that is not 16-byte aligned.
extern "C" int interleave_strided_f32(const float* ph, float* out, int batch, int hp, int wp,
                                      void* stream) {
  if (batch <= 0 || hp < kI || wp < kJ || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long n = (long)batch * kC * kH * kQ;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const bool vec = wp % 4 == 0 && reinterpret_cast<uintptr_t>(ph) % 16 == 0;
  if (vec) {
    interleave_strided_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        ph, out, batch, hp, wp);
  } else {
    interleave_strided_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        ph, out, batch, hp, wp);
  }
  return (int)cudaGetLastError();
}

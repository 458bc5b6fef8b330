// Device functions shared by the deformable propagation step (deform_prop.cu,
// K7) and its backward (deform_prop_bwd.cu, K8): the bilinear sample and the
// step's sum over neighbours, in the order of operations of the plain
// PyTorch version (ops/propagate.py bilinear_sample,
// propagate_deformable_exact_planar; ops/kernels/prop_step.py
// blend_and_clip), each product and sum rounded on its own (no FMA).

#pragma once

#include <cuda_runtime.h>

namespace deform {

// P(y, x) = pred * conf (conf optional), zero outside the image.
__device__ __forceinline__ float tap(const float* p, const float* c, int H,
                                     int W, int y, int x) {
  if (y < 0 || y >= H || x < 0 || x >= W) return 0.0f;
  const long n = (long)y * W + x;
  const float v = __ldg(p + n);
  return c ? __fmul_rn(v, __ldg(c + n)) : v;
}

// Bilinear sample of P at (y + dy + oy, x + dx + ox), zero outside the
// image. The fraction is the offset's own (oy - floor(oy)); corners far
// outside are clamped to just outside before the integer conversion, so
// any finite offset reads zeros there.
__device__ __forceinline__ float sample(const float* p, const float* c, int H,
                                        int W, int y, int x, int dy, int dx,
                                        float oy, float ox) {
  const float fy = floorf(oy), fx = floorf(ox);
  const float ly = __fsub_rn(oy, fy), lx = __fsub_rn(ox, fx);
  const float hy = __fsub_rn(1.0f, ly), hx = __fsub_rn(1.0f, lx);
  const int y0 = (int)fminf(fmaxf(__fadd_rn((float)(y + dy), fy), -2.0f), (float)H);
  const int x0 = (int)fminf(fmaxf(__fadd_rn((float)(x + dx), fx), -2.0f), (float)W);
  float s = __fmul_rn(__fmul_rn(hy, hx), tap(p, c, H, W, y0, x0));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(hy, lx), tap(p, c, H, W, y0, x0 + 1)));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(ly, hx), tap(p, c, H, W, y0 + 1, x0)));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(ly, lx), tap(p, c, H, W, y0 + 1, x0 + 1)));
  return s;
}

// The step's pre-clip value at pixel (y, x) of one image:
//   acc = sum_k aff_k * sample_k,  then (1 - m) * acc + m * dep, m = dep > 0.
// off: (2 K2, H, W), aff: (K2, H, W), dep may be null (no blend).
__device__ __forceinline__ float step_value(const float* p, const float* c,
                                            const float* off, const float* aff,
                                            const float* dep, int H, int W,
                                            int r, int y, int x) {
  const long plane = (long)H * W;
  const long o = (long)y * W + x;
  float acc = 0.0f;
  int k = 0;
  for (int dy = -r; dy <= r; ++dy) {
    for (int dx = -r; dx <= r; ++dx, ++k) {
      const float oy = __ldg(off + 2 * k * plane + o);
      const float ox = __ldg(off + (2 * k + 1) * plane + o);
      const float s = sample(p, c, H, W, y, x, dy, dx, oy, ox);
      acc = __fadd_rn(acc, __fmul_rn(s, __ldg(aff + k * plane + o)));
    }
  }
  if (dep) {
    const float d = __ldg(dep + o);
    const float m = d > 0.0f ? 1.0f : 0.0f;
    acc = __fadd_rn(__fmul_rn(1.0f - m, acc), __fmul_rn(m, d));
  }
  return acc;
}

}  // namespace deform

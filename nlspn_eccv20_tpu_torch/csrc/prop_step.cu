// One step of NLSPN's fixed-local propagation, fused with its blend and clip.
//
// Replaces the TPU kernel local_prop._step_kernel
// (nlspn_eccv20_tpu/ops/pallas/local_prop.py, reached from _stencil_pallas)
// together with the elementwise work the JAX package leaves around it
// (fused_prop_step_planar and models/nlspn.py _prop_and_blend):
//
//   p    = pred * conf                      (conf optional)
//   acc  = sum_k aff[k] * p[clamp(y+dy_k), clamp(x+dx_k)]   (row-major k)
//   out  = (1 - m) * acc + m * dep,  m = dep > 0             (preserve)
//   out  = max(out, 0)                                       (clip)
//
// Bound on the card: memory. Per pixel it reads pred, conf, dep and the K2
// affinity planes and writes one plane, (K2 + 4) * 4 bytes for 2 * K2
// flops, far below the H100's ratio of flops to bytes. Design: one thread
// per output pixel, neighbours read through clamped indices (replicate
// padding with nothing materialised), the 3x3 or 5x5 neighbourhood of
// pred/conf served from L1 by the block's 32x8 tile; every affinity plane
// is read once, coalesced along W. The TPU kernel's static-slice switch and
// the materialised edge-padded plane are Mosaic devices and are not needed.
// Products and sums are rounded one operation at a time in the order of the
// plain PyTorch version (propagate_local_planar), so both give the same bits.

#include <cuda_runtime.h>

namespace {

__global__ void prop_step_kernel(const float* __restrict__ pred,
                                 const float* __restrict__ aff,
                                 const float* __restrict__ conf,
                                 const float* __restrict__ dep,
                                 float* __restrict__ out,
                                 int H, int W, int r, int preserve, int clip) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;
  const long plane = (long)H * W;
  const int k = 2 * r + 1;
  const float* p = pred + b * plane;
  const float* c = conf ? conf + b * plane : nullptr;
  const float* a = aff + (long)b * k * k * plane + (long)y * W + x;

  float acc = 0.0f;
  int idx = 0;
  for (int dy = -r; dy <= r; ++dy) {
    const int yy = min(max(y + dy, 0), H - 1);
    for (int dx = -r; dx <= r; ++dx, ++idx) {
      const int xx = min(max(x + dx, 0), W - 1);
      const long n = (long)yy * W + xx;
      float v = __ldg(p + n);
      if (c) v = __fmul_rn(v, __ldg(c + n));
      acc = __fadd_rn(acc, __fmul_rn(v, __ldg(a + idx * plane)));
    }
  }
  const long o = b * plane + (long)y * W + x;
  if (preserve) {
    const float d = __ldg(dep + o);
    const float m = d > 0.0f ? 1.0f : 0.0f;
    acc = __fadd_rn(__fmul_rn(1.0f - m, acc), __fmul_rn(m, d));
  }
  if (clip) acc = fmaxf(acc, 0.0f);
  out[o] = acc;
}

}  // namespace

// pred, conf, dep, out: (B, H, W) f32 contiguous; aff: (B, (2r+1)^2, H, W).
// conf may be null (no confidence weighting); dep is read only if preserve.
extern "C" int prop_step_f32(const float* pred, const float* aff,
                             const float* conf, const float* dep, float* out,
                             int B, int H, int W, int r, int preserve,
                             int clip, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y, B);
  prop_step_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      pred, aff, conf, dep, out, H, W, r, preserve, clip);
  return (int)cudaGetLastError();
}

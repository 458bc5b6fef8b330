// One step of NLSPN's non-local (--offset) propagation, fused with its blend
// and clip (K7).
//
// Replaces the TPU kernel deform_prop._fwd_kernel
// (nlspn_eccv20_tpu/ops/pallas/deform_prop.py, reached from
// _deform_fwd_pallas) together with the elementwise work the JAX package
// leaves around it (models/nlspn.py _prop_and_blend):
//
//   p    = pred * conf                                  (conf optional)
//   acc  = sum_k aff[k] * bilinear(p, y + dy_k + oy_k, x + dx_k + ox_k)
//   out  = (1 - m) * acc + m * dep,  m = dep > 0         (preserve)
//   out  = max(out, 0)                                   (clip)
//
// with bilinear() zero outside the image (DCNv2's semantics; not the
// replicate padding of the fixed-local step, prop_step.cu).
//
// Bound on the card: memory. Per pixel it reads pred, conf, dep, the 2 K2
// offset planes and the K2 affinity planes and writes one plane, 3 K2 + 4
// planes for about 15 K2 flops. Design: one thread per output pixel; each
// neighbour's four taps of pred (and conf) are read through L1/L2, which
// hold the block's neighbourhood since offsets are local displacements;
// offsets and affinities are read once, coalesced along W. Offsets are
// unbounded: any finite offset reads zeros outside the image, so eval needs
// no window. The TPU kernel's (2R+2)^2 relative-window walk over nv^2
// pre-shifted VMEM plane caches, and the width tiling around it
// (_deform_op_tiled), exist for the TPU's vector unit and its VMEM limit;
// a gather needs neither, at NYU or at KITTI widths. The operations and
// their order are those of the plain PyTorch version (deform_common.cuh),
// so both give the same bits.

#include <cuda_runtime.h>

#include "deform_common.cuh"

namespace {

__global__ void deform_prop_kernel(const float* __restrict__ pred,
                                   const float* __restrict__ off,
                                   const float* __restrict__ aff,
                                   const float* __restrict__ conf,
                                   const float* __restrict__ dep,
                                   float* __restrict__ out, int H, int W, int r,
                                   int clip) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;
  const long plane = (long)H * W;
  const int K2 = (2 * r + 1) * (2 * r + 1);
  float v = deform::step_value(pred + b * plane, conf ? conf + b * plane : nullptr,
                               off + 2L * K2 * b * plane, aff + (long)K2 * b * plane,
                               dep ? dep + b * plane : nullptr, H, W, r, y, x);
  if (clip) v = fmaxf(v, 0.0f);
  out[b * plane + (long)y * W + x] = v;
}

}  // namespace

// pred, conf, dep, out: (B, H, W) f32 contiguous; off: (B, 2 (2r+1)^2, H, W)
// with neighbour k's (dy, dx) at channels 2k, 2k+1; aff: (B, (2r+1)^2, H, W).
// conf may be null (no confidence weighting); dep is read only if preserve.
// Returns cudaGetLastError().
extern "C" int deform_prop_f32(const float* pred, const float* off,
                               const float* aff, const float* conf,
                               const float* dep, float* out, int B, int H,
                               int W, int r, int preserve, int clip,
                               void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y, B);
  deform_prop_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      pred, off, aff, conf, preserve ? dep : nullptr, out, H, W, r, clip);
  return (int)cudaGetLastError();
}

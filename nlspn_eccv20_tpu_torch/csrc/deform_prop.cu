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
// planes for about 26 K2 flops. Design: a block of 32 x 8 threads takes a
// tile of 32 columns and 8 n rows, a thread n pixels down its column (n =
// 4, 2 or 1, the most that still gives every SM two blocks: the wrapper's
// plan, ops/kernels/deform_prop.py fwd_plan). The block stages p = pred *
// conf once in shared memory, zero outside the image, over the tile grown
// by M = r + R_s + 1 on each side, where R_s is the staging radius (the
// training clamp's radius, or the wrapper's STAGE_RADIUS, 4, when offsets
// are not clamped): every tap of an offset in [-R_s, R_s] lies in that
// region.
// Offsets are unbounded, though (serving never clamps them), so a tap
// whose 2x2 corner leaves the region reads pred and conf from device
// memory with the same rounded product: the same bits either way, and any
// finite offset reads zeros outside the image. With r known at compile
// time (3x3, 5x5) a thread loads all of a pixel's offsets and affinities,
// coalesced along the row, before it needs them, the first pixel's before
// the block stages p, so that the two latencies overlap. The TPU kernel's
// (2R+2)^2 relative-window walk over nv^2 pre-shifted VMEM plane caches,
// and the width tiling around it (_deform_op_tiled), exist for the TPU's
// vector unit and its VMEM limit; a gather needs neither, at NYU or at
// KITTI widths. The operations and their order are those of the plain
// PyTorch version (deform_common.cuh), so both give the same bits.

#include <cuda_runtime.h>

#include "deform_common.cuh"

namespace {

constexpr int TXK = 32;   // threads along the row: the tile's width
constexpr int TYK = 8;    // thread rows

// deform::sample, reading the staged region ps (row pitch SW, SH rows, its
// first cell at (sy0, sx0)) when the sample's 2x2 corner lies inside it.
__device__ __forceinline__ float sample_staged(const float* ps, int SW, int SH,
                                               int sy0, int sx0, const float* p,
                                               const float* c, int H, int W,
                                               int y, int x, int dy, int dx,
                                               float oy, float ox) {
  const float fy = floorf(oy), fx = floorf(ox);
  const float ly = __fsub_rn(oy, fy), lx = __fsub_rn(ox, fx);
  const float hy = __fsub_rn(1.0f, ly), hx = __fsub_rn(1.0f, lx);
  const int y0 = (int)fminf(fmaxf(__fadd_rn((float)(y + dy), fy), -2.0f), (float)H);
  const int x0 = (int)fminf(fmaxf(__fadd_rn((float)(x + dx), fx), -2.0f), (float)W);
  const int ry = y0 - sy0, rx = x0 - sx0;
  float t00, t01, t10, t11;
  if ((unsigned)ry < (unsigned)(SH - 1) && (unsigned)rx < (unsigned)(SW - 1)) {
    const float* q = ps + ry * SW + rx;
    t00 = q[0];
    t01 = q[1];
    t10 = q[SW];
    t11 = q[SW + 1];
  } else {
    t00 = deform::tap(p, c, H, W, y0, x0);
    t01 = deform::tap(p, c, H, W, y0, x0 + 1);
    t10 = deform::tap(p, c, H, W, y0 + 1, x0);
    t11 = deform::tap(p, c, H, W, y0 + 1, x0 + 1);
  }
  float s = __fmul_rn(__fmul_rn(hy, hx), t00);
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(hy, lx), t01));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(ly, hx), t10));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(ly, lx), t11));
  return s;
}

// RT: r known at compile time (the neighbour loop unrolls and a pixel's
// offsets and affinities are loaded ahead into registers), or -1 for any r.
template <int RT>
__global__ void __launch_bounds__(TXK * TYK)
deform_prop_kernel(const float* __restrict__ pred, const float* __restrict__ off,
                   const float* __restrict__ aff, const float* __restrict__ conf,
                   const float* __restrict__ dep, float* __restrict__ out, int H,
                   int W, int r_arg, int n, int M, int clip) {
  const int r = RT >= 0 ? RT : r_arg;
  const int K2 = (2 * r + 1) * (2 * r + 1);
  constexpr int KP = RT >= 0 ? (2 * RT + 1) * (2 * RT + 1) : 1;
  const int TY = TYK * n;
  const int SW = TXK + 2 * M, SH = TY + 2 * M;
  extern __shared__ float ps[];   // [SH][SW] p around the tile, zero outside

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TXK;
  const int sy0 = y0 - M, sx0 = x0 - M;
  const bool interior = sy0 >= 0 && y0 + TY + M <= H && sx0 >= 0 &&
                        x0 + TXK + M <= W;
  const long plane = (long)H * W;
  const float* p = pred + b * plane;
  const float* c = conf ? conf + b * plane : nullptr;
  const float* ob = off + 2L * K2 * b * plane;
  const float* ab = aff + (long)K2 * b * plane;
  const float* db = dep ? dep + b * plane : nullptr;
  const int x = x0 + threadIdx.x;

  // the pixel's offsets and affinities, loaded ahead (compile-time r)
  float poy[KP], pox[KP], paf[KP];
  auto load = [&](long o) {
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      poy[k] = __ldg(ob + 2 * k * plane + o);
      pox[k] = __ldg(ob + (2 * k + 1) * plane + o);
      paf[k] = __ldg(ab + k * plane + o);
    }
  };
  if constexpr (RT >= 0) {
    const int y = y0 + threadIdx.y;
    if (y < H && x < W) load((long)y * W + x);
  }

  // ---- p over the tile grown by M ----
  for (int i = threadIdx.y * TXK + threadIdx.x; i < SH * SW; i += TXK * TYK) {
    const int sy = i / SW;
    const int yy = sy0 + sy, xx = sx0 + (i - sy * SW);
    float v = 0.0f;
    if (interior || (yy >= 0 && yy < H && xx >= 0 && xx < W)) {
      const long m = (long)yy * W + xx;
      v = __ldg(p + m);
      if (c) v = __fmul_rn(v, __ldg(c + m));
    }
    ps[i] = v;
  }
  __syncthreads();

  if (x >= W) return;
  for (int q = 0; q < n; ++q) {
    const int y = y0 + threadIdx.y + q * TYK;
    if (y >= H) break;
    const long o = (long)y * W + x;
    if constexpr (RT >= 0) {
      if (q > 0) load(o);
    }
    float acc = 0.0f;
    int k = 0;
#pragma unroll
    for (int dy = -r; dy <= r; ++dy) {
#pragma unroll
      for (int dx = -r; dx <= r; ++dx, ++k) {
        float oy, ox, a;
        if constexpr (RT >= 0) {
          oy = poy[k];
          ox = pox[k];
          a = paf[k];
        } else {
          oy = __ldg(ob + 2 * k * plane + o);
          ox = __ldg(ob + (2 * k + 1) * plane + o);
          a = __ldg(ab + k * plane + o);
        }
        const float s = sample_staged(ps, SW, SH, sy0, sx0, p, c, H, W, y, x,
                                      dy, dx, oy, ox);
        acc = __fadd_rn(acc, __fmul_rn(s, a));
      }
    }
    if (db) {
      const float d = __ldg(db + o);
      const float m = d > 0.0f ? 1.0f : 0.0f;
      acc = __fadd_rn(__fmul_rn(1.0f - m, acc), __fmul_rn(m, d));
    }
    if (clip) acc = fmaxf(acc, 0.0f);
    out[b * plane + o] = acc;
  }
}

template <int RT>
cudaError_t launch(const float* pred, const float* off, const float* aff,
                   const float* conf, const float* dep, float* out, int B, int H,
                   int W, int r, int n, int M, int clip, cudaStream_t stream) {
  const dim3 block(TXK, TYK);
  const dim3 grid((W + TXK - 1) / TXK, (H + TYK * n - 1) / (TYK * n), B);
  const size_t smem = sizeof(float) * (TYK * n + 2 * M) * (TXK + 2 * M);
  if (smem > 232448) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        deform_prop_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  deform_prop_kernel<RT><<<grid, block, smem, stream>>>(
      pred, off, aff, conf, dep, out, H, W, r, n, M, clip);
  return cudaGetLastError();
}

}  // namespace

// pred, conf, dep, out: (B, H, W) f32 contiguous; off: (B, 2 (2r+1)^2, H, W)
// with neighbour k's (dy, dx) at channels 2k, 2k+1; aff: (B, (2r+1)^2, H, W).
// conf may be null (no confidence weighting); dep is read only if preserve.
// n: pixels a thread (the tile's 8 n rows); M: the staging margin. Returns
// the launch's cudaError_t.
extern "C" int deform_prop_f32(const float* pred, const float* off,
                               const float* aff, const float* conf,
                               const float* dep, float* out, int B, int H,
                               int W, int r, int preserve, int clip, int n,
                               int M, void* stream) {
  if (r < 0 || n < 1 || M < 0) return (int)cudaErrorInvalidValue;
  const float* dp = preserve ? dep : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (r) {
    case 1: err = launch<1>(pred, off, aff, conf, dp, out, B, H, W, r, n, M, clip, s); break;
    case 2: err = launch<2>(pred, off, aff, conf, dp, out, B, H, W, r, n, M, clip, s); break;
    default: err = launch<-1>(pred, off, aff, conf, dp, out, B, H, W, r, n, M, clip, s); break;
  }
  return (int)err;
}

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
// flops, far below the H100's ratio of flops to bytes.
//
// Design. A block owns a tile of 64 columns by 8 or 16 rows (16 rows where
// a grid of them still gives every SM four blocks, else 8: 160 blocks at
// b=1 of 256x320; ops/kernels/prop_step.py step_rows mirrors the rule). A
// thread takes 4 adjacent pixels of a row. Where W % 4 == 0 and every plane
// is 16-byte aligned it loads each of its K2 affinity planes, and dep, as
// one float4 and stores its 4 outputs as one (the affinities are not
// shifted: pixel (y, x) reads aff[k, y, x]). The block copies
// pred and conf over the tile and its halo (r rows, and P = r rounded up to
// 4 columns, so that the copies stay 16-byte aligned) into shared memory
// with cp.async, all at once, at the replicate-clamped positions; each
// thread then forms p = pred * conf over its own copies, and after one
// barrier the taps read shared memory with no edge logic at all (the clamp
// is in the staged positions). An interior block (staged region inside the
// image) copies with unclamped 16-byte copies; a border block clamps each
// row, and copies a 4-column chunk that leaves the image one float at a
// time. A thread reads the 4 + 2r values of each of its 2r + 1 rows once
// for its 4 pixels. Other planes (W % 4 != 0, or an unaligned plane) take
// the scalar form: 4 pixels 16 columns apart, so that a warp's scalar
// loads and stores stay coalesced. Radius 1 and 2 are template parameters
// (the taps unroll); any other radius takes the scalar form with a
// run-time radius. Products and sums are rounded one operation at a time
// in the order of the plain PyTorch version (propagate_local_planar), so
// both give the same bits. The TPU kernel's static-slice switch and the
// materialised edge-padded plane are Mosaic devices and are not needed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int TW = 64;          // a tile's columns
constexpr int TXN = TW / 4;     // threads along a row, 4 pixels each
constexpr int MAX_ROWS = 16;
constexpr long SMEM_MAX = 232448;

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

__device__ __forceinline__ float finish(float acc, float d, int preserve, int clip) {
  if (preserve) {
    const float m = d > 0.0f ? 1.0f : 0.0f;
    acc = __fadd_rn(__fmul_rn(1.0f - m, acc), __fmul_rn(m, d));
  }
  if (clip) acc = fmaxf(acc, 0.0f);
  return acc;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// RT: the radius at compile time, or -1 for any radius r_arg (scalar form).
// VEC: the float4 form (W % 4 == 0, planes 16-byte aligned).
// At 3x3, 32 registers a thread (eight blocks of 256 an SM): measured
// faster on the card than loading the 9 float4 ahead of the staging (64
// registers, half the blocks) at every batch but b=1.
template <int RT, bool VEC>
__global__ void __launch_bounds__(TXN * MAX_ROWS, RT == 1 ? 8 : 1)
prop_step_kernel(const float* __restrict__ pred, const float* __restrict__ aff,
                 const float* __restrict__ conf, const float* __restrict__ dep,
                 float* __restrict__ out, int H, int W, int r_arg, int preserve,
                 int clip) {
  const int r = RT >= 0 ? RT : r_arg;
  const int P = (r + 3) & ~3;                  // staged columns each side
  const int K2 = (2 * r + 1) * (2 * r + 1);
  const int rows = blockDim.y;
  const int SW = TW + 2 * P, SH = rows + 2 * r, S = SH * SW;
  extern __shared__ __align__(16) float smem[];
  float* ps = smem;                            // [SH][SW] pred, then p
  float* cs = smem + S;                        // [SH][SW] conf (with conf)

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * rows, x0 = blockIdx.x * TW;
  const long plane = (long)H * W;
  const float* pb = pred + b * plane;
  const float* cb = conf ? conf + b * plane : nullptr;
  const float* ab = aff + (long)b * K2 * plane;
  const float* db = preserve ? dep + b * plane : nullptr;
  float* ob = out + b * plane;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TXN + tx, nthreads = TXN * rows;
  const int y = y0 + ty;
  const bool interior = y0 - r >= 0 && y0 + rows + r <= H && x0 - P >= 0 &&
                        x0 + TW + P <= W;

  // ---- pred and conf over the tile and its halo, clamped ----
  const int cpr = SW / 4;                      // 4-column chunks a row
  if (VEC && interior) {
    for (int c = tid; c < SH * cpr; c += nthreads) {
      const int sy = c / cpr, cx = c - sy * cpr;
      const int g = (y0 - r + sy) * W + x0 - P + 4 * cx;
      cpa::copy16(ps + sy * SW + 4 * cx, pb + g, true);
      if (cb) cpa::copy16(cs + sy * SW + 4 * cx, cb + g, true);
    }
  } else {
    for (int c = tid; c < SH * cpr; c += nthreads) {
      const int sy = c / cpr, cx = c - sy * cpr;
      const int row = clampi(y0 - r + sy, H - 1) * W;
      const int xs = x0 - P + 4 * cx;
      float* dst = ps + sy * SW + 4 * cx;
      if (VEC && xs >= 0 && xs + 4 <= W) {
        cpa::copy16(dst, pb + row + xs, true);
        if (cb) cpa::copy16(dst + S, cb + row + xs, true);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int g = row + clampi(xs + e, W - 1);
          cpa::copy4(dst + e, pb + g, true);
          if (cb) cpa::copy4(dst + S + e, cb + g, true);
        }
      }
    }
  }
  cpa::commit();
  cpa::wait<0>();
  // p = pred * conf over this thread's own copies (its wait covers them)
  if (cb)
    for (int c = tid; c < SH * cpr; c += nthreads) {
      float* dst = ps + (c / cpr) * SW + 4 * (c % cpr);
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = __fmul_rn(dst[e], dst[S + e]);
    }
  __syncthreads();

  if constexpr (VEC) {
    const int xv = x0 + 4 * tx;                // the thread's 4 pixels
    if (y >= H || xv >= W) return;             // W % 4 == 0: all 4 or none
    const int ov = y * W + xv;
    constexpr int R = RT;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* at = ps + (ty + R) * SW + P + 4 * tx;   // pixel (y, xv)
    int k = 0;
#pragma unroll
    for (int dy = -R; dy <= R; ++dy) {
      float v[4 + 2 * R];
#pragma unroll
      for (int i = 0; i < 4 + 2 * R; ++i) v[i] = at[dy * SW - R + i];
#pragma unroll
      for (int dx = -R; dx <= R; ++dx, ++k) {
        const float4 ak = ldg4(ab + k * plane + ov);
        acc[0] = __fadd_rn(acc[0], __fmul_rn(v[0 + dx + R], ak.x));
        acc[1] = __fadd_rn(acc[1], __fmul_rn(v[1 + dx + R], ak.y));
        acc[2] = __fadd_rn(acc[2], __fmul_rn(v[2 + dx + R], ak.z));
        acc[3] = __fadd_rn(acc[3], __fmul_rn(v[3 + dx + R], ak.w));
      }
    }
    const float4 d4 = db ? ldg4(db + ov) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 res;
    res.x = finish(acc[0], d4.x, preserve, clip);
    res.y = finish(acc[1], d4.y, preserve, clip);
    res.z = finish(acc[2], d4.z, preserve, clip);
    res.w = finish(acc[3], d4.w, preserve, clip);
    *reinterpret_cast<float4*>(ob + ov) = res;
  } else {
    if (y >= H) return;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = x0 + tx + TXN * e;
      if (x >= W) break;
      const int o = y * W + x;
      const float* at = ps + (ty + r) * SW + P + tx + TXN * e;
      float acc = 0.0f;
      int k = 0;
#pragma unroll
      for (int dy = -r; dy <= r; ++dy)
#pragma unroll
        for (int dx = -r; dx <= r; ++dx, ++k)
          acc = __fadd_rn(acc, __fmul_rn(at[dy * SW + dx], __ldg(ab + k * plane + o)));
      ob[o] = finish(acc, db ? __ldg(db + o) : 0.0f, preserve, clip);
    }
  }
}

// The tile's rows: 16 where a grid of 16-row tiles gives every SM four
// blocks, else 8 (ops/kernels/prop_step.py step_rows).
int tile_rows(int B, int H, int W) {
  static int sms[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  const long blocks = (long)B * ((H + MAX_ROWS - 1) / MAX_ROWS) * ((W + TW - 1) / TW);
  return blocks >= 4L * sms[dev] ? MAX_ROWS : MAX_ROWS / 2;
}

template <int RT, bool VEC>
cudaError_t launch(const float* pred, const float* aff, const float* conf,
                   const float* dep, float* out, int B, int H, int W, int r,
                   int preserve, int clip, cudaStream_t stream) {
  const int rows = tile_rows(B, H, W);
  const int P = (r + 3) & ~3;
  const long smem = (long)sizeof(float) * (conf ? 2 : 1) * (rows + 2 * r) * (TW + 2 * P);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        prop_step_kernel<RT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((W + TW - 1) / TW, (H + rows - 1) / rows, B), block(TXN, rows);
  prop_step_kernel<RT, VEC><<<grid, block, smem, stream>>>(
      pred, aff, conf, dep, out, H, W, r, preserve, clip);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

}  // namespace

// pred, conf, dep, out: (B, H, W) f32 contiguous; aff: (B, (2r+1)^2, H, W).
// conf may be null (no confidence weighting); dep is read only if preserve.
// Returns the launch's cudaError_t.
extern "C" int prop_step_f32(const float* pred, const float* aff,
                             const float* conf, const float* dep, float* out,
                             int B, int H, int W, int r, int preserve,
                             int clip, void* stream) {
  if (r < 0) return (int)cudaErrorInvalidValue;
  const float* dp = preserve ? dep : nullptr;
  const bool vec = W % 4 == 0 && aligned16(pred) && aligned16(aff) &&
                   aligned16(conf) && aligned16(dp) && aligned16(out);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (r == 1)
    err = vec ? launch<1, true>(pred, aff, conf, dp, out, B, H, W, r, preserve, clip, s)
              : launch<1, false>(pred, aff, conf, dp, out, B, H, W, r, preserve, clip, s);
  else if (r == 2)
    err = vec ? launch<2, true>(pred, aff, conf, dp, out, B, H, W, r, preserve, clip, s)
              : launch<2, false>(pred, aff, conf, dp, out, B, H, W, r, preserve, clip, s);
  else
    err = launch<-1, false>(pred, aff, conf, dp, out, B, H, W, r, preserve, clip, s);
  return (int)err;
}

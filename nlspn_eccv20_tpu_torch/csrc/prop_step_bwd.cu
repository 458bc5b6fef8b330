// Backward of one propagation step (K1b): the gradients of prop_step.cu's
//
//   p    = pred * conf                      (conf optional)
//   acc  = sum_k aff[k] * p[clamp(y+dy_k), clamp(x+dx_k)]
//   v    = (1 - m) * acc + m * dep,  m = dep > 0                (preserve)
//   out  = max(v, 0)                                            (clip)
//
// with respect to pred, conf and aff, given g = dL/d(out):
//
//   ga(o)        = g(o) * (1 - m(o)) * c(o),  c = [v > 0] + 0.5 [v == 0]
//   d_aff_k(o)   = ga(o) * p(n_k(o)),         n_k(o) = clamp(o + d_k)
//   d_p(s)       = sum over (o, k) with n_k(o) = s of aff_k(o) * ga(o)
//   d_pred = d_p * conf,  d_conf = d_p * pred
//
// The clip's factor c splits the gradient at an exact tie as jnp.maximum
// does. It needs the pre-clip value v, which the forward does not keep, so
// with clip on the kernel recomputes acc with the forward's operations in
// the forward's order (the same bits, hence the same tie decision).
//
// Replaces the JAX package's VJP of the step (local_prop._stencil_bwd,
// nlspn_eccv20_tpu/ops/pallas/local_prop.py, a pure-JAX VJP of the Pallas
// stencil there).
//
// Bound on the card: memory. It reads g, pred, conf, dep and the K2
// affinity planes and writes d_pred, d_conf and the K2 planes of d_aff,
// about 2 K2 + 6 planes, for a few flops a byte. Design: one thread per
// pixel of a 32x8 tile. Each block first writes ga for its tile and a halo
// of r pixels into shared memory; every thread then writes its pixel's
// d_aff (reading p's neighbourhood from L1) and gathers d_p for its pixel
// as a source: the outputs o that read it lie within r of it, at the
// replicate-padded edges up to r + 1 of them per axis and tap. Each
// aff_k(o) is read once by the one source it reads, so without clip every
// plane is read once. No atomics: the gather adds in a fixed order and the
// result is the same bits from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

// The pre-clip value v(o): the forward's operations in the forward's order.
__device__ __forceinline__ float pre_clip(const float* p, const float* c,
                                          const float* a, long plane, int H,
                                          int W, int r, int y, int x,
                                          const float* dep, long o) {
  float acc = 0.0f;
  int idx = 0;
  for (int dy = -r; dy <= r; ++dy) {
    const int yy = clampi(y + dy, H - 1);
    for (int dx = -r; dx <= r; ++dx, ++idx) {
      const int xx = clampi(x + dx, W - 1);
      const long n = (long)yy * W + xx;
      float v = __ldg(p + n);
      if (c) v = __fmul_rn(v, __ldg(c + n));
      acc = __fadd_rn(acc, __fmul_rn(v, __ldg(a + idx * plane)));
    }
  }
  if (dep) {
    const float d = __ldg(dep + o);
    const float m = d > 0.0f ? 1.0f : 0.0f;
    acc = __fadd_rn(__fmul_rn(1.0f - m, acc), __fmul_rn(m, d));
  }
  return acc;
}

__global__ void __launch_bounds__(TX * TY)
prop_step_bwd_kernel(const float* __restrict__ g, const float* __restrict__ pred,
                     const float* __restrict__ aff, const float* __restrict__ conf,
                     const float* __restrict__ dep, float* __restrict__ d_pred,
                     float* __restrict__ d_aff, float* __restrict__ d_conf,
                     int H, int W, int r, int clip) {
  extern __shared__ float ga[];  // [(TY + 2r)][(TX + 2r)]
  const int GW = TX + 2 * r, GH = TY + 2 * r;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const long plane = (long)H * W;
  const int k = 2 * r + 1, K2 = k * k;
  const float* gb = g + b * plane;
  const float* p = pred + b * plane;
  const float* c = conf ? conf + b * plane : nullptr;
  const float* db = dep ? dep + b * plane : nullptr;
  const float* ab = aff + (long)b * K2 * plane;

  // ---- ga over the tile and its halo (zero outside the image) ----
  for (int i = tid; i < GH * GW; i += TX * TY) {
    const int y = y0 - r + i / GW, x = x0 - r + i % GW;
    float v = 0.0f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const long o = (long)y * W + x;
      v = __ldg(gb + o);
      if (db && __ldg(db + o) > 0.0f) v = 0.0f;
      if (clip) {
        const float pre = pre_clip(p, c, ab + o, plane, H, W, r, y, x, db, o);
        v = pre > 0.0f ? v : (pre == 0.0f ? 0.5f * v : 0.0f);
      }
    }
    ga[i] = v;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const long o = (long)y * W + x;
  const float* gl = ga + (threadIdx.y + r) * GW + threadIdx.x + r;  // ga at (y, x)

  // ---- d_aff for this pixel as an output ----
  const float gv = gl[0];
  float* dab = d_aff + (long)b * K2 * plane + o;
  int idx = 0;
  for (int dy = -r; dy <= r; ++dy) {
    const int yy = clampi(y + dy, H - 1);
    for (int dx = -r; dx <= r; ++dx, ++idx) {
      const int xx = clampi(x + dx, W - 1);
      const long n = (long)yy * W + xx;
      float v = __ldg(p + n);
      if (c) v = __fmul_rn(v, __ldg(c + n));
      dab[idx * plane] = __fmul_rn(gv, v);
    }
  }

  // ---- d_p for this pixel as a source ----
  // Outputs o' = (y', x') with clamp(y' + dy) == y: y' = y - dy inside the
  // image; at an edge every y' whose shifted row falls past it.
  float dp = 0.0f;
  idx = 0;
  for (int dy = -r; dy <= r; ++dy) {
    const int ylo = max((y == 0 ? -r : y) - dy, 0);
    const int yhi = min((y == H - 1 ? H - 1 + r : y) - dy, H - 1);
    for (int dx = -r; dx <= r; ++dx, ++idx) {
      const int xlo = max((x == 0 ? -r : x) - dx, 0);
      const int xhi = min((x == W - 1 ? W - 1 + r : x) - dx, W - 1);
      const float* ak = ab + idx * plane;
      for (int yy = ylo; yy <= yhi; ++yy)
        for (int xx = xlo; xx <= xhi; ++xx)
          dp = fmaf(__ldg(ak + (long)yy * W + xx),
                    gl[(yy - y) * GW + (xx - x)], dp);
    }
  }
  d_pred[b * plane + o] = c ? dp * __ldg(c + o) : dp;
  if (d_conf) d_conf[b * plane + o] = dp * __ldg(p + o);
}

}  // namespace

// g, pred, conf, dep, d_pred, d_conf: (B, H, W) f32 contiguous; aff, d_aff:
// (B, (2r+1)^2, H, W). conf and d_conf may be null (no confidence
// weighting); dep is read only if preserve. Returns cudaGetLastError().
extern "C" int prop_step_bwd_f32(const float* g, const float* pred,
                                 const float* aff, const float* conf,
                                 const float* dep, float* d_pred, float* d_aff,
                                 float* d_conf, int B, int H, int W, int r,
                                 int preserve, int clip, void* stream) {
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  const size_t smem = sizeof(float) * (TX + 2 * r) * (TY + 2 * r);
  prop_step_bwd_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      g, pred, aff, conf, preserve ? dep : nullptr, d_pred, d_aff, d_conf, H,
      W, r, clip);
  return (int)cudaGetLastError();
}

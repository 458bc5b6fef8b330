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
// does. It needs to know whether v > 0, v == 0 or v < 0. Where the caller
// passes the forward's output (PropStepFunction saves it), out > 0 says
// v > 0; only where out == 0 is v recomputed, with the forward's operations
// in the forward's order (the same bits, hence the same tie decision).
// Without it, v is recomputed everywhere.
//
// Replaces the JAX package's VJP of the step (local_prop._stencil_bwd,
// nlspn_eccv20_tpu/ops/pallas/local_prop.py, a pure-JAX VJP of the Pallas
// stencil there).
//
// Bound on the card: memory. It reads g, pred, conf, dep and the K2
// affinity planes and writes d_pred, d_conf and the K2 planes of d_aff,
// about 2 K2 + 6 planes, for a few flops a byte. Design: one thread per
// pixel of a 32x8 tile (ops/kernels/prop_step.py bwd_plan), every load and
// store of a warp one row, coalesced. The block first copies g, dep, pred,
// conf and the K2 affinity planes over the tile and its halo of r pixels
// into shared memory with cp.async, every copy of a thread in flight at
// once and none holding a register: pred and conf at the replicate-clamped
// position (so d_aff needs no edge logic), the rest zero outside the
// image. After one pass that forms p = pred * conf and ga in place, each
// thread reads only shared memory: it writes its pixel's K2 d_aff values,
// and gathers d_p for it as a source. In an interior block (tile and halo
// inside the image) every source s takes exactly the K2 terms
// aff_k(s - d_k) ga(s - d_k), an unrolled loop with no clamp; a border
// block checks each term, and only pixels on the image's edge walk the
// outputs that the replicate padding folds onto them (up to r + 1 of them
// per axis and tap). The gather adds the terms with fmaf in the first
// form's order, tap by tap: no atomics, the same bits from run to run (and
// as the first form, which read the affinities through L1 and walked the
// edge logic at every pixel, gave). Measured slower on the card, and not
// kept: four pixels a thread along the row with 16-byte stores (the
// strided loads of the shifted affinities), two or four down the column,
// and affinities loaded into registers instead of staged.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int TX = 32;   // the tile's width: a warp
constexpr int TY = 8;    // its rows
constexpr long SMEM_MAX = 232448;

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

// d_p of an edge pixel s = (y, x) (first or last row or column): the first
// form's walk over the outputs o' = (y', x') with clamp(y' + dy) == y, at
// the edge every y' whose shifted row falls past it. al: aff_0 at (y, x),
// the planes ks apart, rows rs apart; gl: ga at (y, x), rows SW apart.
__device__ float edge_dp(const float* al, long ks, int rs, const float* gl,
                         int SW, int H, int W, int r, int y, int x) {
  float dp = 0.0f;
  int idx = 0;
  for (int dy = -r; dy <= r; ++dy) {
    const int ylo = max((y == 0 ? -r : y) - dy, 0);
    const int yhi = min((y == H - 1 ? H - 1 + r : y) - dy, H - 1);
    for (int dx = -r; dx <= r; ++dx, ++idx) {
      const int xlo = max((x == 0 ? -r : x) - dx, 0);
      const int xhi = min((x == W - 1 ? W - 1 + r : x) - dx, W - 1);
      for (int yy = ylo; yy <= yhi; ++yy)
        for (int xx = xlo; xx <= xhi; ++xx)
          dp = fmaf(al[idx * ks + (yy - y) * rs + (xx - x)],
                    gl[(yy - y) * SW + (xx - x)], dp);
    }
  }
  return dp;
}

// RT: r known at compile time (the loops unroll), or -1 for any r. The
// affinities are staged when stage_aff (always for RT >= 0); for an r too
// large for shared memory they are read from device memory instead.
template <int RT>
__global__ void __launch_bounds__(TX * TY)
prop_step_bwd_kernel(const float* __restrict__ g, const float* __restrict__ pred,
                     const float* __restrict__ aff, const float* __restrict__ conf,
                     const float* __restrict__ dep, const float* __restrict__ out,
                     float* __restrict__ d_pred, float* __restrict__ d_aff,
                     float* __restrict__ d_conf, int H, int W, int r_arg,
                     int clip, int stage_aff) {
  const int r = RT >= 0 ? RT : r_arg;
  const bool sa = RT >= 0 || stage_aff;
  const int K2 = (2 * r + 1) * (2 * r + 1);
  const int SW = TX + 2 * r, SH = TY + 2 * r, S = SH * SW;
  extern __shared__ float smem[];
  float* ps = smem;             // [SH][SW] pred, then p at the clamped position
  float* gs = smem + S;         // [SH][SW] g, then ga (zero outside the image)
  float* cs = smem + 2 * S;     // [SH][SW] conf (with conf)
  float* ds = smem + 3 * S;     // [SH][SW] dep (with preserve)
  float* as = smem + 4 * S;     // [K2][SH][SW] aff, zero outside (if sa)

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const bool interior = y0 - r >= 0 && y0 + TY + r <= H && x0 - r >= 0 &&
                        x0 + TX + r <= W;
  const long plane = (long)H * W;
  const float* gb = g + b * plane;
  const float* p = pred + b * plane;
  const float* c = conf ? conf + b * plane : nullptr;
  const float* db = dep ? dep + b * plane : nullptr;
  const float* ob = out ? out + b * plane : nullptr;
  const float* ab = aff + (long)b * K2 * plane;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;

  // ---- every input over the tile and its halo, all copies in flight ----
  for (int i = tid; i < S; i += TX * TY) {
    const int sy = i / SW;
    const int y = y0 - r + sy, x = x0 - r + (i - sy * SW);
    const bool inside = interior || (y >= 0 && y < H && x >= 0 && x < W);
    const long m = interior ? (long)y * W + x
                            : (long)clampi(y, H - 1) * W + clampi(x, W - 1);
    cpa::copy4(ps + i, p + m, true);
    if (c) cpa::copy4(cs + i, c + m, true);
    cpa::copy4(gs + i, gb + m, inside);
    if (db) cpa::copy4(ds + i, db + m, inside);
    if (sa)
      for (int k = 0; k < K2; ++k) cpa::copy4(as + k * S + i, ab + k * plane + m, inside);
  }
  cpa::commit();
  cpa::wait<0>();
  __syncthreads();

  // ---- p and ga in place ----
  for (int i = tid; i < S; i += TX * TY) {
    if (c) ps[i] = __fmul_rn(ps[i], cs[i]);
    float v = gs[i];
    if (db && ds[i] > 0.0f) v = 0.0f;
    if (clip) {
      const int sy = i / SW;
      const int y = y0 - r + sy, x = x0 - r + (i - sy * SW);
      if (y >= 0 && y < H && x >= 0 && x < W) {
        const long o = (long)y * W + x;
        if (!(ob && __ldg(ob + o) > 0.0f)) {
          const float pre = pre_clip(p, c, ab + o, plane, H, W, r, y, x, db, o);
          v = pre > 0.0f ? v : (pre == 0.0f ? 0.5f * v : 0.0f);
        }
      }
    }
    gs[i] = v;
  }
  __syncthreads();

  const int y = y0 + ty, x = x0 + tx;
  if (y >= H || x >= W) return;
  const long o = (long)y * W + x;
  const int at = (ty + r) * SW + tx + r;   // (y, x) in the staged tile
  const float* gl = gs + at;
  const float* pl = ps + at;
  // aff_0 at (y, x): staged, or in device memory
  const float* al = sa ? as + at : ab + o;
  const long ks = sa ? S : plane;
  const int rs = sa ? SW : W;

  // ---- d_aff for this pixel as an output ----
  const float gv = gl[0];
  float* dab = d_aff + (long)b * K2 * plane + o;
  int k = 0;
#pragma unroll
  for (int dy = -r; dy <= r; ++dy)
#pragma unroll
    for (int dx = -r; dx <= r; ++dx, ++k)
      dab[k * plane] = __fmul_rn(gv, pl[dy * SW + dx]);

  // ---- d_p for this pixel as a source ----
  float dp = 0.0f;
  if (interior) {
    k = 0;
#pragma unroll
    for (int dy = -r; dy <= r; ++dy)
#pragma unroll
      for (int dx = -r; dx <= r; ++dx, ++k)
        dp = fmaf(al[k * ks - dy * rs - dx], gl[-dy * SW - dx], dp);
  } else if (y == 0 || y == H - 1 || x == 0 || x == W - 1) {
    dp = edge_dp(al, ks, rs, gl, SW, H, W, r, y, x);
  } else {
    k = 0;
#pragma unroll
    for (int dy = -r; dy <= r; ++dy) {
      const bool yin = (unsigned)(y - dy) < (unsigned)H;
#pragma unroll
      for (int dx = -r; dx <= r; ++dx, ++k)
        if (yin && (unsigned)(x - dx) < (unsigned)W)
          dp = fmaf(al[k * ks - dy * rs - dx], gl[-dy * SW - dx], dp);
    }
  }
  d_pred[b * plane + o] = c ? dp * cs[at] : dp;
  if (d_conf) d_conf[b * plane + o] = dp * __ldg(p + o);
}

long smem_bytes(int r, bool stage_aff) {
  const long k2 = (2L * r + 1) * (2 * r + 1);
  return sizeof(float) * (4 + (stage_aff ? k2 : 0)) * (TX + 2 * r) * (TY + 2 * r);
}

template <int RT>
cudaError_t launch(const float* g, const float* pred, const float* aff,
                   const float* conf, const float* dep, const float* out,
                   float* d_pred, float* d_aff, float* d_conf, int B, int H,
                   int W, int r, int clip, cudaStream_t stream) {
  const bool stage_aff = RT >= 0 || smem_bytes(r, true) <= SMEM_MAX;
  const long smem = smem_bytes(r, stage_aff);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        prop_step_bwd_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B), block(TX, TY);
  prop_step_bwd_kernel<RT><<<grid, block, smem, stream>>>(
      g, pred, aff, conf, dep, out, d_pred, d_aff, d_conf, H, W, r, clip,
      (int)stage_aff);
  return cudaGetLastError();
}

}  // namespace

// g, pred, conf, dep, out, d_pred, d_conf: (B, H, W) f32 contiguous; aff,
// d_aff: (B, (2r+1)^2, H, W). conf and d_conf may be null (no confidence
// weighting); dep is read only if preserve; out (the forward's output) may
// be null, and is read only with clip. Returns the launch's cudaError_t.
extern "C" int prop_step_bwd_f32(const float* g, const float* pred,
                                 const float* aff, const float* conf,
                                 const float* dep, const float* out,
                                 float* d_pred, float* d_aff, float* d_conf,
                                 int B, int H, int W, int r, int preserve,
                                 int clip, void* stream) {
  if (r < 0) return (int)cudaErrorInvalidValue;
  const float* dp = preserve ? dep : nullptr;
  const float* op = clip ? out : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (r) {
    case 1: err = launch<1>(g, pred, aff, conf, dp, op, d_pred, d_aff, d_conf,
                            B, H, W, r, clip, s); break;
    case 2: err = launch<2>(g, pred, aff, conf, dp, op, d_pred, d_aff, d_conf,
                            B, H, W, r, clip, s); break;
    default: err = launch<-1>(g, pred, aff, conf, dp, op, d_pred, d_aff, d_conf,
                              B, H, W, r, clip, s); break;
  }
  return (int)err;
}

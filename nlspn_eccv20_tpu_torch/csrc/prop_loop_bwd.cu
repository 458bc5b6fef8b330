// Backward of the whole constant-affinity loop (K6b): the gradients of
// prop_loop.cu's function with respect to pred, aff and conf, given
// g = dL/d(cur_steps). With v_s the pre-clip value of step s (whose input
// is cur_s, saved by the forward) it walks the steps in reverse:
//
//   ga(o)      = G(o) * (1 - m(o)) * c(o),  c = [v_s > 0] + 0.5 [v_s == 0]
//   d_aff_k(o) += ga(o) * p_s(n_k(o)),      n_k(o) = clamp(o + d_k)
//   d_p(s')    = sum over (o, k) with n_k(o) = s' of aff_k(o) * ga(o)
//   d_conf    += d_p * cur_s,   G <- d_p * conf
//
// starting from G = g; at the end d_pred = G, times (1 - m) and the clip's
// factor of the pre-blend when pre_blend is on. The clip's factor c splits
// the gradient at an exact tie as jnp.maximum does; it needs v_s, which the
// kernel recomputes from cur_s with the forward's operations in the
// forward's order (the same bits, hence the same tie decision).
//
// Replaces the JAX package's VJP of the loop (local_prop._loop_op_bwd,
// nlspn_eccv20_tpu/ops/pallas/local_prop.py, a pure-JAX VJP through
// _pure_loop_planar there). The port's forward is a CUDA kernel, so its
// backward is one too.
//
// Bound on the card: memory. It reads g, conf, dep, the K2 affinity planes
// and the `steps` saved planes once and writes d_pred, d_conf and the K2
// planes of d_aff: about 2 K2 + steps + 5 planes for the whole loop,
// against (2 K2 + 6) planes a step for a launch per step (K1b).
//
// Design: one launch for the loop, with the forward's halo tiles. A block
// owns a tile x tile tile of the gradients. The cotangent G of step s is
// needed over the tile grown by (s + 1) r (its d_p feeds the step before
// over one r less), so the block loads g over the tile and a halo of
// steps * r, and each reverse step shrinks the region by r; G and the next
// step's d_p ping-pong between two shared buffers. The sums over the steps
// of d_aff and d_conf for the tile's own pixels stay in shared memory,
// (K2 + 1) tile^2 floats, and are written once at the end. d_p is a gather,
// as in K1b: each source pixel sums over the outputs that read it, which
// lie within r of it (one a tap inside the image; at the replicate-padded
// edges up to r + 1 of them per axis and tap). No atomics: every sum is
// taken in a fixed order and the result is the same bits from run to run.
// The saved planes, affinities, conf and dep come through L1/L2 (__ldg);
// 3x3 and 5x5 get the radius at compile time, so that the taps unroll. A
// loop whose halo does not fit in shared memory is split by the caller
// into launches of fewer steps, walked in reverse, each adding to the sums
// of the one before (`accumulate`).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

__device__ __forceinline__ float mask(const float* dep, long o) {
  return __ldg(dep + o) > 0.0f ? 1.0f : 0.0f;
}

// jnp.maximum's factor at 0: 1 above, 1/2 at the tie, 0 below
__device__ __forceinline__ float clip_factor(float v) {
  return v > 0.0f ? 1.0f : (v == 0.0f ? 0.5f : 0.0f);
}

// f(y, x) for the cells of [ylo, yhi) x [xlo, xhi), row-major, THREADS
// apart: thread t takes cells t, t + THREADS, ... (one division a region).
template <class F>
__device__ __forceinline__ void for_cells(int ylo, int yhi, int xlo, int xhi, F f) {
  const int cols = xhi - xlo;
  if (cols <= 0) return;
  const int q = THREADS / cols, rm = THREADS % cols;
  int y = ylo + threadIdx.x / cols, x = xlo + threadIdx.x % cols;
  while (y < yhi) {
    f(y, x);
    y += q;
    x += rm;
    if (x >= xhi) {
      x -= cols;
      ++y;
    }
  }
}

// The pre-clip value of the step whose input is `cur`, at (y, x): the
// forward's operations in the forward's order.
template <int RT>
__device__ __forceinline__ float pre_clip(const float* cur, const float* c,
                                          const float* a, long plane, int H,
                                          int W, int r_arg, int y, int x,
                                          const float* dep, long o) {
  const int r = RT > 0 ? RT : r_arg, k = 2 * r + 1;
  float acc = 0.0f;
#pragma unroll
  for (int dy = -r; dy <= r; ++dy) {
    const int yy = clampi(y + dy, H - 1);
#pragma unroll
    for (int dx = -r; dx <= r; ++dx) {
      const int idx = (dy + r) * k + dx + r;
      const long n = (long)yy * W + clampi(x + dx, W - 1);
      float v = __ldg(cur + n);
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

// RT > 0: the radius at compile time; RT == 0: any radius r_arg.
template <int RT>
__global__ void __launch_bounds__(THREADS)
prop_loop_bwd_kernel(const float* __restrict__ g, const float* __restrict__ pred,
                     const float* __restrict__ aff, const float* __restrict__ conf,
                     const float* __restrict__ dep, const float* __restrict__ saved,
                     float* __restrict__ d_in, float* __restrict__ d_aff,
                     float* __restrict__ d_conf, int H, int W, int r_arg,
                     int steps, int tile, int preserve, int clip, int pre_blend,
                     int accumulate) {
  extern __shared__ float smem[];
  const int r = RT > 0 ? RT : r_arg;
  const int halo = steps * r;
  const int bw = tile + 2 * halo;
  const int k = 2 * r + 1, K2 = k * k, t2 = tile * tile;
  float* gbuf = smem;                    // G, then ga, of the current step
  float* nbuf = smem + bw * bw;          // the step before's G
  float* sum_aff = smem + 2 * bw * bw;   // [K2][tile^2]
  float* sum_conf = sum_aff + K2 * t2;   // [tile^2]
  const int b = blockIdx.z, B = gridDim.z;
  const int y0 = blockIdx.y * tile, x0 = blockIdx.x * tile;
  const int by = y0 - halo, bx = x0 - halo;
  const int y1 = min(y0 + tile, H), x1 = min(x0 + tile, W);
  const long plane = (long)H * W;
  const float* cb = conf ? conf + b * plane : nullptr;
  const float* db = dep ? dep + b * plane : nullptr;
  const float* ab = aff + (long)b * K2 * plane;
  float* dab = d_aff + (long)b * K2 * plane;

  // the sums, and G = g over the tile and its whole halo
  for_cells(y0, y1, x0, x1, [&](int y, int x) {
    const long o = (long)y * W + x;
    const int i = (y - y0) * tile + x - x0;
    for (int j = 0; j < K2; ++j)
      sum_aff[j * t2 + i] = accumulate ? dab[j * plane + o] : 0.0f;
    if (cb) sum_conf[i] = accumulate ? d_conf[b * plane + o] : 0.0f;
  });
  for_cells(max(by, 0), min(y1 + halo, H), max(bx, 0), min(x1 + halo, W),
            [&](int y, int x) {
    gbuf[(y - by) * bw + (x - bx)] = __ldg(g + b * plane + (long)y * W + x);
  });
  __syncthreads();

  for (int s = steps - 1; s >= 0; --s) {
    const float* cur = saved + ((long)s * B + b) * plane;
    const int e = (s + 1) * r;           // G's margin at this step

    // ga = G (1 - m) c over the tile grown by e, in place
    for_cells(max(y0 - e, 0), min(y1 + e, H), max(x0 - e, 0), min(x1 + e, W),
              [&](int y, int x) {
      const long o = (long)y * W + x;
      float* v = gbuf + (y - by) * bw + (x - bx);
      float ga = *v;
      if (clip)
        ga *= clip_factor(pre_clip<RT>(cur, cb, ab + o, plane, H, W, r, y, x,
                                       preserve ? db : nullptr, o));
      if (preserve) ga = __fmul_rn(ga, 1.0f - mask(db, o));
      *v = ga;
    });
    __syncthreads();

    // d_aff of the tile's own pixels
    for_cells(y0, y1, x0, x1, [&](int y, int x) {
      const int i = (y - y0) * tile + x - x0;
      const float ga = gbuf[(y - by) * bw + (x - bx)];
#pragma unroll
      for (int dy = -r; dy <= r; ++dy) {
        const int yy = clampi(y + dy, H - 1);
#pragma unroll
        for (int dx = -r; dx <= r; ++dx) {
          const int idx = (dy + r) * k + dx + r;
          const long n = (long)yy * W + clampi(x + dx, W - 1);
          float p = __ldg(cur + n);
          if (cb) p = __fmul_rn(p, __ldg(cb + n));
          sum_aff[idx * t2 + i] = __fadd_rn(sum_aff[idx * t2 + i], __fmul_rn(ga, p));
        }
      }
    });

    // d_p over the tile grown by e - r: the step before's G, and d_conf
    const int f = e - r;
    for_cells(max(y0 - f, 0), min(y1 + f, H), max(x0 - f, 0), min(x1 + f, W),
              [&](int y, int x) {
      const long o = (long)y * W + x;
      float dp = 0.0f;
      if (y >= r && y < H - r && x >= r && x < W - r) {
        // inside: the one output o - d_k reads this pixel through tap k
#pragma unroll
        for (int dy = -r; dy <= r; ++dy) {
#pragma unroll
          for (int dx = -r; dx <= r; ++dx) {
            const int idx = (dy + r) * k + dx + r;
            dp = __fadd_rn(dp, __fmul_rn(
                __ldg(ab + idx * plane + o - (long)dy * W - dx),
                gbuf[(y - dy - by) * bw + (x - dx - bx)]));
          }
        }
      } else {
        int idx = 0;
        for (int dy = -r; dy <= r; ++dy) {
          // outputs (y', x') with clamp(y' + dy) == y: y' = y - dy inside
          // the image; at an edge every y' whose shifted row falls past it
          const int ylo2 = max((y == 0 ? -r : y) - dy, 0);
          const int yhi2 = min((y == H - 1 ? H - 1 + r : y) - dy, H - 1);
          for (int dx = -r; dx <= r; ++dx, ++idx) {
            const int xlo2 = max((x == 0 ? -r : x) - dx, 0);
            const int xhi2 = min((x == W - 1 ? W - 1 + r : x) - dx, W - 1);
            const float* ak = ab + idx * plane;
            for (int yy = ylo2; yy <= yhi2; ++yy)
              for (int xx = xlo2; xx <= xhi2; ++xx)
                dp = __fadd_rn(dp, __fmul_rn(__ldg(ak + (long)yy * W + xx),
                                             gbuf[(yy - by) * bw + (xx - bx)]));
          }
        }
      }
      if (cb) {
        if (y >= y0 && y < y1 && x >= x0 && x < x1) {
          float* sc = sum_conf + (y - y0) * tile + x - x0;
          *sc = __fadd_rn(*sc, __fmul_rn(dp, __ldg(cur + o)));
        }
        dp = __fmul_rn(dp, __ldg(cb + o));
      }
      nbuf[(y - by) * bw + (x - bx)] = dp;
    });
    __syncthreads();
    float* t = gbuf;
    gbuf = nbuf;
    nbuf = t;
  }

  // d_in = G of cur_0 (through the pre-blend if on), and the sums
  for_cells(y0, y1, x0, x1, [&](int y, int x) {
    const long o = (long)y * W + x;
    const int i = (y - y0) * tile + x - x0;
    float d = gbuf[(y - by) * bw + (x - bx)];
    if (pre_blend) {
      if (clip) {
        const float m = mask(db, o);
        const float v0 = __fadd_rn(__fmul_rn(1.0f - m, __ldg(pred + b * plane + o)),
                                   __fmul_rn(m, __ldg(db + o)));
        d *= clip_factor(v0);
      }
      d = __fmul_rn(d, 1.0f - mask(db, o));
    }
    d_in[b * plane + o] = d;
    for (int j = 0; j < K2; ++j) dab[j * plane + o] = sum_aff[j * t2 + i];
    if (cb) d_conf[b * plane + o] = sum_conf[i];
  });
}

template <int RT>
int launch(const float* g, const float* pred, const float* aff,
           const float* conf, const float* dep, const float* saved, float* d_in,
           float* d_aff, float* d_conf, int B, int H, int W, int r, int steps,
           int tile, int preserve, int clip, int pre_blend, int accumulate,
           void* stream) {
  const int bw = tile + 2 * steps * r;
  const int k = 2 * r + 1;
  const size_t smem = sizeof(float) * (2 * bw * bw + (k * k + 1) * tile * tile);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        prop_loop_bwd_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile, B);
  prop_loop_bwd_kernel<RT><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      g, pred, aff, conf, (preserve || pre_blend) ? dep : nullptr, saved, d_in,
      d_aff, d_conf, H, W, r, steps, tile, preserve, clip, pre_blend,
      accumulate);
  return (int)cudaGetLastError();
}

}  // namespace

// g, pred, conf, dep, d_in, d_conf: (B, H, W) f32 contiguous; aff, d_aff:
// (B, (2r+1)^2, H, W); saved: (steps, B, H, W), the step inputs the forward
// wrote. conf and d_conf may be null (no confidence weighting); dep is read
// only if preserve or pre_blend; pred only if pre_blend and clip. With
// accumulate, d_aff and d_conf are added to. Shared memory: two
// (tile + 2 steps r)^2 buffers and (K2 + 1) tile^2 sums. Returns
// cudaGetLastError().
extern "C" int prop_loop_bwd_f32(const float* g, const float* pred,
                                 const float* aff, const float* conf,
                                 const float* dep, const float* saved,
                                 float* d_in, float* d_aff, float* d_conf,
                                 int B, int H, int W, int r, int steps,
                                 int tile, int preserve, int clip,
                                 int pre_blend, int accumulate, void* stream) {
  auto* fn = r == 1 ? launch<1> : r == 2 ? launch<2> : launch<0>;
  return fn(g, pred, aff, conf, dep, saved, d_in, d_aff, d_conf, B, H, W, r,
            steps, tile, preserve, clip, pre_blend, accumulate, stream);
}

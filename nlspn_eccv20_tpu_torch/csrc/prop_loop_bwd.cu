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
// kernel recomputes from p_s = cur_s * conf with the forward's operations
// in the forward's order (the same bits, hence the same tie decision).
//
// Replaces the JAX package's VJP of the loop
// (nlspn_eccv20_tpu/ops/pallas/local_prop.py:413 _loop_op_bwd, a pure-JAX
// VJP through _pure_loop_planar; the forward it differentiates is
// _propagate_loop_core :264, whose pl.pallas_call is at :317). The port's
// forward is a CUDA kernel, so its backward is one too.
//
// Bound on the card: memory. It reads g, conf, dep, the K2 affinity planes
// and the `steps` saved planes once and writes d_pred, d_conf and the K2
// planes of d_aff: about 2 K2 + steps + 5 planes for the whole loop,
// against (2 K2 + 6) planes a step for a launch per step (K1b). What held
// its first form back was not device memory but the cache: it re-read the
// affinities, conf, dep and the step's input through L1/L2 at every step
// and at every tap (27 loads a pixel in pre_clip, 9 more for d_aff and 9
// for d_p), over regions of up to 3x the tile, while its shared memory held
// little more than G.
//
// Design: one launch for the loop, with the forward's halo tiles. A block
// owns a tile x tile tile of the gradients. The cotangent G of step s is
// needed over the tile grown by (s + 1) r (its d_p feeds the step before
// over one r less), so the block starts from g over the tile and a halo of
// steps * r, and each reverse step shrinks the region by r.
//  - The loop's constants, the K2 affinity planes, conf and dep, are
//    copied once (cp.async) into shared memory over the tile grown by
//    steps r (one r more with the clip, whose v_s reads p one r past G's
//    region): at 3x3, 12 steps and a 32x32 tile, 56x56 cells, 209 KB with
//    the rest, one block of 1024 threads an SM. 32x32 tiles even at b=1,
//    where they leave SMs idle: their halo costs less than 16x16 tiles'.
//  - Each step's saved input is copied two steps ahead, into one of three
//    buffers, and turned into p = cur * conf once, by the threads that
//    copied it (no barrier between). pre_clip, d_aff and d_p read only
//    shared memory; G and the next step's d_p ping-pong between two
//    buffers.
//  - Without the clip, the preserve mask of a step is applied where the
//    step after writes its G (the same roundings in the same order), so a
//    step has one barrier; the clip's ga needs one more.
//  - A thread owns one of the tile's pixels and keeps its K2 sums of d_aff
//    (3x3 and 5x5, whose radius is known at compile time) and its sum of
//    d_conf in registers, written once at the end; d_conf's input at that
//    pixel is read a step ahead. (Radii above 2 read the affinities
//    through L1/L2 and keep the d_aff sums in shared memory: their planes
//    do not fit.)
// d_p is a gather, as in K1b: each source pixel sums over the outputs that
// read it, which lie within r of it (one a tap inside the image; at the
// replicate-padded edges up to r + 1 of them per axis and tap). No
// atomics: every sum is taken in a fixed order and the result is the same
// bits from run to run. A loop whose region does not fit in shared memory
// is split by the caller into launches of fewer steps, walked in reverse,
// each adding to the sums of the one before (`accumulate`).

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

__device__ __forceinline__ float mask_of(float d) { return d > 0.0f ? 1.0f : 0.0f; }

// jnp.maximum's factor at 0: 1 above, 1/2 at the tie, 0 below
__device__ __forceinline__ float clip_factor(float v) {
  return v > 0.0f ? 1.0f : (v == 0.0f ? 0.5f : 0.0f);
}

// f(y, x) for the cells of [ylo, yhi) x [xlo, xhi), row-major, NT apart:
// thread t takes cells t, t + NT, ... (one division a region).
template <int NT, class F>
__device__ __forceinline__ void for_cells(int ylo, int yhi, int xlo, int xhi, F f) {
  const int cols = xhi - xlo;
  if (cols <= 0) return;
  const int q = NT / cols, rm = NT % cols;
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

// RT > 0: the radius at compile time, the affinities in shared memory and
// the d_aff sums in registers; RT == 0: any radius r_arg, the affinities
// read through L1/L2 and the d_aff sums in shared memory (K2 of them a
// pixel leave no room for the planes). NT threads: 1024 for 32x32 tiles,
// 512 for smaller ones; a thread owns one tile pixel at most.
template <int RT, int NT>
__global__ void __launch_bounds__(NT, 1)
prop_loop_bwd_kernel(const float* __restrict__ g, const float* __restrict__ pred,
                     const float* __restrict__ aff, const float* __restrict__ conf,
                     const float* __restrict__ dep, const float* __restrict__ saved,
                     float* __restrict__ d_in, float* __restrict__ d_aff,
                     float* __restrict__ d_conf, int H, int W, int r_arg,
                     int steps, int tile, int preserve, int clip, int pre_blend,
                     int accumulate) {
  constexpr int KR = RT > 0 ? (2 * RT + 1) * (2 * RT + 1) : 1;
  extern __shared__ __align__(16) float smem[];
  const int r = RT > 0 ? RT : r_arg;
  const int k = 2 * r + 1, K2 = k * k, t2 = tile * tile;
  const int hs = (steps + (clip ? 1 : 0)) * r;  // the staged region's margin
  const int L = tile + 2 * hs, A = L * L;       // its side and cells
  const int b = blockIdx.z, B = gridDim.z;
  const int y0 = blockIdx.y * tile, x0 = blockIdx.x * tile;
  const int by = y0 - hs, bx = x0 - hs;         // the region's origin
  const int y1 = min(y0 + tile, H), x1 = min(x0 + tile, W);
  const long plane = (long)H * W;
  const float* cb = conf ? conf + b * plane : nullptr;
  const float* db = dep ? dep + b * plane : nullptr;
  const float* ab = aff + (long)b * K2 * plane;
  float* dab = d_aff + (long)b * K2 * plane;
  // Without the clip, the mask (1 - m) of step s is applied where the step
  // after writes G (the same two roundings in the same order), so that G
  // is ga when step s reads it and a step needs one barrier, not three.
  const bool mask_early = preserve && !clip;

  float* as = smem;                           // [K2][A] affinities, if RT > 0
  float* cs = as + (RT > 0 ? K2 * A : 0);     // conf, if any
  float* ds = cs + (cb ? A : 0);              // dep, if any
  float* curs = ds + (db ? A : 0);            // [3][A]: p_s in curs[s % 3]
  float* gbuf = curs + 3 * A;                 // G, then ga, of the step
  float* nbuf = gbuf + A;                     // the step before's G
  float* dps = nbuf + A;                      // [2][tile^2] d_p of the tile, if conf
  float* sum_aff = dps + (cb ? 2 * t2 : 0);   // [K2][tile^2], if RT == 0
  auto at = [&](int y, int x) { return (y - by) * L + (x - bx); };
  // affinity plane j at pixel (y, x), whose region cell is c
  auto aff_at = [&](int j, int c, int y, int x) {
    return RT > 0 ? as[j * A + c] : __ldg(ab + j * plane + (long)y * W + x);
  };

  // Step s's input over its region (p is read one r past ga's region for
  // the clip's v_s, else over the tile grown by r for d_aff): copy = true
  // issues this thread's copies, copy = false turns the same cells, once
  // they have landed, into p = cur * conf (conf from shared memory, or
  // from device memory before the first barrier). A thread converts only
  // the cells it copied, so no barrier stands between the two.
  auto stage_cur = [&](int s, bool copy, bool conf_staged) {
    float* dst = curs + (s % 3) * A;
    const int m = clip ? (s + 2) * r : r;
    const float* src = saved + ((long)s * B + b) * plane;
    for_cells<NT>(max(y0 - m, 0), min(y1 + m, H), max(x0 - m, 0), min(x1 + m, W),
                  [&](int y, int x) {
      const int c = at(y, x);
      if (copy)
        cpa::copy4(dst + c, src + (long)y * W + x, true);
      else if (cb)
        dst[c] = __fmul_rn(dst[c], conf_staged ? cs[c] : __ldg(cb + (long)y * W + x));
    });
  };

  // ---- the loop's constants over the region, g over G's region (times
  // 1 - m when the mask goes early), steps - 1's input, then steps - 2's
  // (in flight while the last step runs) ----
  {
    const int ylo = max(by, 0), yhi = min(by + L, H), xlo = max(bx, 0), xhi = min(bx + L, W);
    for (int j = 0; j < (RT > 0 ? K2 : 0); ++j)
      for_cells<NT>(ylo, yhi, xlo, xhi, [&](int y, int x) {
        cpa::copy4(as + j * A + at(y, x), ab + j * plane + (long)y * W + x, true);
      });
    for_cells<NT>(ylo, yhi, xlo, xhi, [&](int y, int x) {
      const long o = (long)y * W + x;
      if (cb) cpa::copy4(cs + at(y, x), cb + o, true);
      if (db) cpa::copy4(ds + at(y, x), db + o, true);
    });
    const int e = steps * r;
    auto g_cells = [&](bool copy) {
      for_cells<NT>(max(y0 - e, 0), min(y1 + e, H), max(x0 - e, 0), min(x1 + e, W),
                    [&](int y, int x) {
        const long o = (long)y * W + x;
        float* v = gbuf + at(y, x);
        if (copy)
          cpa::copy4(v, g + b * plane + o, true);
        else if (mask_early)
          *v = __fmul_rn(*v, 1.0f - mask_of(__ldg(db + o)));
      });
    };
    g_cells(true);
    stage_cur(steps - 1, true, false);
    cpa::commit();
    if (steps > 1) stage_cur(steps - 2, true, false);
    cpa::commit();
    cpa::wait<1>();
    g_cells(false);
    stage_cur(steps - 1, false, false);
  }

  // the tile pixel this thread owns: its d_aff sums (RT > 0), its d_conf
  // sum, and this step's input there (for d_conf, read a step ahead)
  const int own_y = y0 + (int)threadIdx.x / tile, own_x = x0 + (int)threadIdx.x % tile;
  const int own_i = (int)threadIdx.x;
  const bool own = own_i < t2 && own_y < H && own_x < W;
  const long own_o = (long)own_y * W + own_x;
  float sums[KR];
#pragma unroll
  for (int t = 0; t < KR; ++t) sums[t] = RT > 0 && own && accumulate ? dab[t * plane + own_o] : 0.0f;
  float conf_sum = cb && own && accumulate ? d_conf[b * plane + own_o] : 0.0f;
  float cur_own = 0.0f;
  if (RT == 0)
    for_cells<NT>(y0, y1, x0, x1, [&](int y, int x) {
      const int i = (y - y0) * tile + x - x0;
      for (int j = 0; j < K2; ++j)
        sum_aff[j * t2 + i] = accumulate ? dab[j * plane + (long)y * W + x] : 0.0f;
    });
  __syncthreads();

  for (int s = steps - 1; s >= 0; --s) {
    const float* p = curs + (s % 3) * A;
    if (s > 1) stage_cur(s - 2, true, false);  // in flight for two steps
    cpa::commit();
    if (cb && own) {  // d_conf of step s + 1, from its d_p and input
      if (s + 1 < steps) conf_sum = __fadd_rn(conf_sum, __fmul_rn(dps[((s + 1) & 1) * t2 + own_i], cur_own));
      cur_own = __ldg(saved + ((long)s * B + b) * plane + own_o);
    }
    const int e = (s + 1) * r;           // G's margin at this step

    // with the clip: ga = G (1 - m) c over the tile grown by e, in place;
    // v_s with the forward's operations in the forward's order
    if (clip) {
      for_cells<NT>(max(y0 - e, 0), min(y1 + e, H), max(x0 - e, 0), min(x1 + e, W),
                    [&](int y, int x) {
        const int c = at(y, x);
        float acc = 0.0f;
#pragma unroll
        for (int dy = -r; dy <= r; ++dy) {
          const int row = (clampi(y + dy, H - 1) - by) * L - bx;
#pragma unroll
          for (int dx = -r; dx <= r; ++dx) {
            const int idx = (dy + r) * k + dx + r;
            acc = __fadd_rn(acc, __fmul_rn(p[row + clampi(x + dx, W - 1)],
                                           aff_at(idx, c, y, x)));
          }
        }
        if (preserve) {
          const float d = ds[c], m = mask_of(d);
          acc = __fadd_rn(__fmul_rn(1.0f - m, acc), __fmul_rn(m, d));
        }
        float ga = gbuf[c] * clip_factor(acc);
        if (preserve) ga = __fmul_rn(ga, 1.0f - mask_of(ds[c]));
        gbuf[c] = ga;
      });
      __syncthreads();
    }

    // d_aff of the tile's own pixels
    if (RT > 0) {
      if (own) {
        const float ga = gbuf[at(own_y, own_x)];
#pragma unroll
        for (int dy = -RT; dy <= RT; ++dy) {
          const int row = (clampi(own_y + dy, H - 1) - by) * L - bx;
#pragma unroll
          for (int dx = -RT; dx <= RT; ++dx) {
            const int idx = (dy + RT) * (2 * RT + 1) + dx + RT;
            sums[idx] = __fadd_rn(sums[idx], __fmul_rn(ga, p[row + clampi(own_x + dx, W - 1)]));
          }
        }
      }
    } else {
      for_cells<NT>(y0, y1, x0, x1, [&](int y, int x) {
        const int i = (y - y0) * tile + x - x0;
        const float ga = gbuf[at(y, x)];
        for (int dy = -r; dy <= r; ++dy) {
          const int row = (clampi(y + dy, H - 1) - by) * L - bx;
          for (int dx = -r; dx <= r; ++dx) {
            const int idx = (dy + r) * k + dx + r;
            sum_aff[idx * t2 + i] = __fadd_rn(sum_aff[idx * t2 + i],
                                              __fmul_rn(ga, p[row + clampi(x + dx, W - 1)]));
          }
        }
      });
    }

    // d_p over the tile grown by e - r: the step before's G (its ga when
    // the mask goes early), and d_p of the tile for d_conf
    const int f = e - r;
    float* dp_tile = dps + (s & 1) * t2;
    for_cells<NT>(max(y0 - f, 0), min(y1 + f, H), max(x0 - f, 0), min(x1 + f, W),
                  [&](int y, int x) {
      const int c = at(y, x);
      float dp = 0.0f;
      if (y >= r && y < H - r && x >= r && x < W - r) {
        // inside: the one output o - d_k reads this pixel through tap k
#pragma unroll
        for (int dy = -r; dy <= r; ++dy) {
#pragma unroll
          for (int dx = -r; dx <= r; ++dx) {
            const int idx = (dy + r) * k + dx + r;
            const int n = c - dy * L - dx;
            dp = __fadd_rn(dp, __fmul_rn(aff_at(idx, n, y - dy, x - dx), gbuf[n]));
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
            for (int yy = ylo2; yy <= yhi2; ++yy)
              for (int xx = xlo2; xx <= xhi2; ++xx)
                dp = __fadd_rn(dp, __fmul_rn(aff_at(idx, at(yy, xx), yy, xx),
                                             gbuf[at(yy, xx)]));
          }
        }
      }
      if (cb) {
        if (y >= y0 && y < y1 && x >= x0 && x < x1) dp_tile[(y - y0) * tile + x - x0] = dp;
        dp = __fmul_rn(dp, cs[c]);
      }
      if (mask_early && s > 0) dp = __fmul_rn(dp, 1.0f - mask_of(ds[c]));
      nbuf[c] = dp;
    });
    if (s > 0) {  // step s - 1's input landed: p = cur * conf
      if (s > 1)
        cpa::wait<1>();
      else
        cpa::wait<0>();
      stage_cur(s - 1, false, true);
    }
    __syncthreads();
    float* t = gbuf;
    gbuf = nbuf;
    nbuf = t;
  }
  if (cb && own) conf_sum = __fadd_rn(conf_sum, __fmul_rn(dps[own_i], cur_own));

  // d_in = G of cur_0 (through the pre-blend if on), and the sums
  for_cells<NT>(y0, y1, x0, x1, [&](int y, int x) {
    const long o = (long)y * W + x;
    const int i = (y - y0) * tile + x - x0;
    float d = gbuf[at(y, x)];
    if (pre_blend) {
      const float dv = ds[at(y, x)], m = mask_of(dv);
      if (clip) {
        const float v0 = __fadd_rn(__fmul_rn(1.0f - m, __ldg(pred + b * plane + o)),
                                   __fmul_rn(m, dv));
        d *= clip_factor(v0);
      }
      d = __fmul_rn(d, 1.0f - m);
    }
    d_in[b * plane + o] = d;
    if (RT == 0)
      for (int j = 0; j < K2; ++j) dab[j * plane + o] = sum_aff[j * t2 + i];
  });
  if (own) {
    if (RT > 0) {
#pragma unroll
      for (int t = 0; t < KR; ++t) dab[t * plane + own_o] = sums[t];
    }
    if (cb) d_conf[b * plane + own_o] = conf_sum;
  }
}

template <int RT, int NT>
int launch(const float* g, const float* pred, const float* aff,
           const float* conf, const float* dep, const float* saved, float* d_in,
           float* d_aff, float* d_conf, int B, int H, int W, int r, int steps,
           int tile, int preserve, int clip, int pre_blend, int accumulate,
           void* stream) {
  const int L = tile + 2 * (steps + (clip ? 1 : 0)) * r, A = L * L;
  const int k2 = (2 * r + 1) * (2 * r + 1);
  const size_t smem = sizeof(float) * (
      (size_t)A * ((RT > 0 ? k2 : 0) + (conf ? 1 : 0) + (dep ? 1 : 0) + 5)
      + (size_t)tile * tile * ((conf ? 2 : 0) + (RT == 0 ? k2 : 0)));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        prop_loop_bwd_kernel<RT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile, B);
  prop_loop_bwd_kernel<RT, NT><<<grid, NT, smem, (cudaStream_t)stream>>>(
      g, pred, aff, conf, dep, saved, d_in, d_aff, d_conf, H, W, r, steps,
      tile, preserve, clip, pre_blend, accumulate);
  return (int)cudaGetLastError();
}

}  // namespace

// g, pred, conf, dep, d_in, d_conf: (B, H, W) f32 contiguous; aff, d_aff:
// (B, (2r+1)^2, H, W); saved: (steps, B, H, W), the step inputs the forward
// wrote. conf and d_conf may be null (no confidence weighting); dep is read
// only if preserve or pre_blend; pred only if pre_blend and clip. With
// accumulate, d_aff and d_conf are added to. tile: 32, 16 or 8. Shared
// memory: 4 planes of (tile + 2 (steps + 1) r)^2 cells, one more each for
// conf and dep and K2 more for the affinities when r <= 2, and tile^2 sums
// for d_conf (and K2 tile^2 for d_aff when r > 2). Returns
// cudaGetLastError().
extern "C" int prop_loop_bwd_f32(const float* g, const float* pred,
                                 const float* aff, const float* conf,
                                 const float* dep, const float* saved,
                                 float* d_in, float* d_aff, float* d_conf,
                                 int B, int H, int W, int r, int steps,
                                 int tile, int preserve, int clip,
                                 int pre_blend, int accumulate, void* stream) {
  if (tile != 32 && tile != 16 && tile != 8) return (int)cudaErrorInvalidValue;
  const bool big = tile == 32;
  auto* fn = r == 1 ? (big ? launch<1, 1024> : launch<1, 512>)
           : r == 2 ? (big ? launch<2, 1024> : launch<2, 512>)
                    : (big ? launch<0, 1024> : launch<0, 512>);
  if (!(preserve || pre_blend)) dep = nullptr;
  return fn(g, pred, aff, conf, dep, saved, d_in, d_aff, d_conf, B, H, W, r,
            steps, tile, preserve, clip, pre_blend, accumulate, stream);
}

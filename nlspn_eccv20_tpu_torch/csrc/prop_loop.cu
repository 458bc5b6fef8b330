// The whole constant-affinity propagation loop in one launch (K6): `steps`
// iterations of prop_step.cu's function,
//
//   cur_0 = pred, or with pre_blend (1 - m) * pred + m * dep then the clip
//   p_s   = cur_s * conf                                   (conf optional)
//   acc   = sum_k aff[k] * p_s[clamp(y+dy_k), clamp(x+dx_k)] (row-major k)
//   cur_{s+1} = max((1 - m) * acc + m * dep, 0)   (blend if preserve, clip)
//
// with m = dep > 0. Each product and sum is rounded on its own in
// prop_step.cu's order (__fmul_rn/__fadd_rn, no contraction), so K6 gives
// the bits of `steps` launches of K1 and of the plain loop.
//
// Replaces the TPU kernel local_prop._loop_kernel, launched from
// _propagate_loop_core (nlspn_eccv20_tpu/ops/pallas/local_prop.py).
//
// Bound on the card: memory. The whole loop reads pred, conf, dep and the
// K2 affinity planes once and writes one plane: (K2 + 4) planes, against
// steps * (K2 + 4) for a launch per step. With `saved` (training) it also
// writes the step inputs cur_0 .. cur_{steps-1}, which the backward K6b
// needs for the clip's ties and for d_aff and d_conf: steps more planes.
//
// Design: 2-D halo tiles whose constants are read once, into registers. A
// block owns a tile x tile output tile. Step s computes cur_s over the tile
// grown by e_s = (steps - s) * r on every side, so the region shrinks by r
// a step and the last step covers the tile alone; p ping-pongs between two
// shared buffers over the tile grown by steps * r rows and by whole strips
// of 4 columns. A thread owns one strip, 4 adjacent cells of a row of the
// first step's region, for the whole launch: it loads their K2 affinities,
// conf and m * dep into registers once (float4 loads where W % 4 == 0),
// and at each step while its strip reaches the region it reads the 2r + 1
// rows of 4 + 2r values around the strip from shared memory (the middle
// four as one float4), forms the 4 sums as independent chains and stores
// the strip's 4 values of p as one float4: no global load after the first.
// The region's columns are rounded out to whole strips; a cell so added
// lies beyond the step's region, and what it computes feeds only cells
// beyond the region of every later step. A strip outside the image
// computes on its clamped row and, past the image's columns, as the strip
// that holds the edge column, whose edge cell it copies into all of its
// cells (a strip across the right edge, where W % 4 != 0, into its cells
// past it): every buffer cell holds p at its clamped position, the
// reference's replicate padding at the true edge at every step, and no
// tap needs a clamp. At 3x3,
// 12 steps, 32x32 tiles: 54 rows of 14 strips, 768 threads, 44 floats of
// constants each; one block an SM, so a block's loads do not overlap
// another's steps. The caller (ops/kernels/prop_loop.py plan) cuts a 5x5
// loop into launches of 2 steps (at most 384 threads of 25 affinities a
// cell) and a longer loop into launches of at most 12. Any other radius
// reads the affinities from L2 at each step. Measured on the card, and not
// kept: the cells dealt to 1024 threads ring by ring, 3 a thread, each
// computed at its clamped position (slower at every shape once the strips
// stopped patching the cells outside the image after each step, and far
// slower at 5x5); launches of 4 steps with half the threads, two blocks an
// SM (faster only in an earlier form that patched the cells outside the
// image after each step, and three launches where the model's loop takes
// one); a persistent block that copies the next tile's inputs with
// cp.async while it steps through this one (slower everywhere). The TPU kernel tiles W only, with 128-lane
// blocks and a materialised edge pad (Mosaic's rules); neither is needed
// here. ops/kernels/prop_loop.py (plan, loop_threads, loop_strips)
// mirrors the tiling and the strip map.
// Shapes: any B, H, W (the last tiles are ragged), any odd kernel, any
// steps >= 1 whose first region fits its threads and whose two buffers fit
// in shared memory; the caller splits a longer loop into launches of fewer
// steps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr long SMEM_MAX = 232448;

// A block's threads at most, by compile-time radius (RT < 0: any radius,
// the affinities read from L2 at each step): 65536 registers over them.
// ops/kernels/prop_loop.py LOOP_THREADS mirrors it.
template <int RT>
__host__ __device__ constexpr int max_threads() {
  return RT == 1 ? 768 : RT == 2 ? 384 : 1024;
}

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float blend(float acc, float md) {
  // (1 - m) * acc + m * dep with m = dep > 0, from md = m * dep (m = md > 0)
  return __fadd_rn(__fmul_rn(md > 0.0f ? 0.0f : 1.0f, acc), md);
}

// RT > 0: the radius at compile time, the affinities in registers; RT < 0:
// any radius r_arg. vec: the float4 loads and stores (W % 4 == 0, planes
// 16-byte aligned).
template <int RT>
__global__ void __launch_bounds__(max_threads<RT>(), 1)
prop_loop_kernel(const float* __restrict__ pred, const float* __restrict__ aff,
                 const float* __restrict__ conf, const float* __restrict__ dep,
                 float* __restrict__ out, float* __restrict__ saved, int H,
                 int W, int r_arg, int steps, int tile, int preserve, int clip,
                 int pre_blend, int vec) {
  constexpr int R = RT > 0 ? RT : 0;
  constexpr int KT = (2 * R + 1) * (2 * R + 1);
  extern __shared__ __align__(16) float smem[];
  const int r = RT > 0 ? RT : r_arg, k = 2 * r + 1;
  const int E = (steps - 1) * r, EX = round4(E);  // the first step's margin
  const int HY = steps * r, HX = EX + round4(r);  // the buffer's
  const int bw = tile + 2 * HX, bh = tile + 2 * HY;
  float* cur = smem;                              // p of the previous step
  float* nxt = smem + bh * bw;
  const int b = blockIdx.z, B = gridDim.z;
  const int y0 = blockIdx.y * tile, x0 = blockIdx.x * tile;
  const int by = y0 - HY, bx = x0 - HX;           // buffer origin
  const long plane = (long)H * W;
  const float* pb = pred + b * plane;
  const float* cb = conf ? conf + b * plane : nullptr;
  const float* db = dep ? dep + b * plane : nullptr;
  const float* ab = aff + (long)b * k * k * plane;
  float* ob = out + b * plane;
  const int t = threadIdx.x, T = blockDim.x;

  // ---- the thread's strip: cells (y, x .. x + 3), live up to step last ----
  const int SC = (tile + 2 * EX) / 4;
  const int sy = t / SC;
  const int y = y0 - E + sy, x = x0 - EX + 4 * (t - sy * SC);
  int last = 0;
  if (sy < tile + 2 * E) {
    const int dy = max(max(y0 - y, y - (y0 + tile - 1)), 0);
    const int dx = max(max(x0 - (x + 3), x - (x0 + tile - 1)), 0);
    const int d = max(dy, dx);
    last = d == 0 ? steps : steps - (d + r - 1) / r;
  }
  // Where the strip computes: on the clamped row and, for a strip past the
  // image's columns, on the strip that holds the edge column; cells lo..hi
  // of that strip are its own, and a cell past them takes the nearest's
  // value (every cell outside the image: p at its clamped position).
  const int ty = clampi(y, H - 1);
  int tx = x, lo = 0, hi = 3;
  if (x + 3 < 0) {                                // strips start at 0 mod 4
    tx = 0;
    hi = 0;
  } else if (x >= W) {
    tx = x0 - EX + ((W - 1 - (x0 - EX)) & ~3);
    lo = hi = W - 1 - tx;
  } else if (x + 3 >= W) {
    hi = W - 1 - x;
  }
  const bool full = vec && tx + 4 <= W;           // 4 cells of the image
  float a[4][KT], cf[4], md[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    cf[c] = 1.0f;
    md[c] = 0.0f;
#pragma unroll
    for (int q = 0; q < KT; ++q) a[c][q] = 0.0f;
  }
  if (last > 0 && full) {
    const int o = ty * W + tx;
    if constexpr (RT > 0) {
#pragma unroll
      for (int q = 0; q < KT; ++q) {
        const float4 v = ldg4(ab + q * plane + o);
        a[0][q] = v.x;
        a[1][q] = v.y;
        a[2][q] = v.z;
        a[3][q] = v.w;
      }
    }
    if (cb) {
      const float4 v = ldg4(cb + o);
      cf[0] = v.x, cf[1] = v.y, cf[2] = v.z, cf[3] = v.w;
    }
    if (preserve) {
      const float4 v = ldg4(db + o);
      const float dv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) md[c] = __fmul_rn(dv[c] > 0.0f ? 1.0f : 0.0f, dv[c]);
    }
  } else if (last > 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (tx + c >= W) continue;                  // not taken
      const int o = ty * W + tx + c;
      if constexpr (RT > 0) {
#pragma unroll
        for (int q = 0; q < KT; ++q) a[c][q] = __ldg(ab + q * plane + o);
      }
      if (cb) cf[c] = __ldg(cb + o);
      if (preserve) {
        const float dv = __ldg(db + o);
        md[c] = __fmul_rn(dv > 0.0f ? 1.0f : 0.0f, dv);
      }
    }
  }

  // ---- pred and conf over the whole buffer, at the clamped positions:
  // every copy in flight at once (conf in the second buffer until p_0) ----
  const int cpr = bw / 4;                         // 4-column chunks a row
  float* cs = nxt;
  for (int c = t; c < bh * cpr; c += T) {
    const int ry = c / cpr, cx = c - ry * cpr;
    const int row = clampi(by + ry, H - 1) * W, xs = bx + 4 * cx;
    float* d = cur + ry * bw + 4 * cx;
    if (vec && xs >= 0 && xs + 4 <= W) {
      cpa::copy16(d, pb + row + xs, true);
      if (cb) cpa::copy16(d + bh * bw, cb + row + xs, true);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = row + clampi(xs + e, W - 1);
        cpa::copy4(d + e, pb + g, true);
        if (cb) cpa::copy4(d + bh * bw + e, cb + g, true);
      }
    }
  }
  cpa::commit();
  cpa::wait<0>();
  // p_0 over this thread's own copies (its wait covers them)
  for (int c = t; c < bh * cpr; c += T) {
    const int ry = c / cpr, cx = c - ry * cpr;
    const int yy = by + ry, cy = clampi(yy, H - 1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = ry * bw + 4 * cx + e;
      const int xx = bx + 4 * cx + e, cxx = clampi(xx, W - 1);
      float v = cur[i];
      if (pre_blend) {
        const float dv = __ldg(db + cy * W + cxx);
        const float m = dv > 0.0f ? 1.0f : 0.0f;
        v = __fadd_rn(__fmul_rn(1.0f - m, v), __fmul_rn(m, dv));
        if (clip) v = fmaxf(v, 0.0f);
      }
      if (saved && yy == cy && xx == cxx && yy >= y0 && yy < y0 + tile &&
          xx >= x0 && xx < x0 + tile)
        saved[b * plane + yy * W + xx] = v;
      cur[i] = cb ? __fmul_rn(v, cs[i]) : v;
    }
  }
  __syncthreads();

  const int at = (ty - by) * bw + (tx - bx);      // where it computes
  const int own = (y - by) * bw + (x - bx);       // the strip in the buffer
  const bool yin = y < H, store = vec && x + 4 <= W;
  for (int s = 1; s <= steps; ++s) {
    if (s <= last) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if constexpr (RT > 0) {
        int q = 0;
#pragma unroll
        for (int dy = -R; dy <= R; ++dy) {
          const float* rp = cur + at + dy * bw;
          float v[4 + 2 * R];
          const float4 mid = *reinterpret_cast<const float4*>(rp);
          v[R] = mid.x;
          v[R + 1] = mid.y;
          v[R + 2] = mid.z;
          v[R + 3] = mid.w;
#pragma unroll
          for (int i = 1; i <= R; ++i) {
            v[R - i] = rp[-i];
            v[R + 3 + i] = rp[3 + i];
          }
#pragma unroll
          for (int dx = -R; dx <= R; ++dx, ++q)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[c] = __fadd_rn(acc[c], __fmul_rn(v[c + dx + R], a[c][q]));
        }
      } else {
        const int oy = ty * W;
        int q = 0;
        for (int dy = -r; dy <= r; ++dy)
          for (int dx = -r; dx <= r; ++dx, ++q)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[c] = __fadd_rn(acc[c], __fmul_rn(cur[at + dy * bw + dx + c],
                                                   __ldg(ab + q * plane + oy + min(tx + c, W - 1))));
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (preserve) acc[c] = blend(acc[c], md[c]);
        if (clip) acc[c] = fmaxf(acc[c], 0.0f);
      }
      // the tile's cells in the image: out at the last step, else saved
      float* dst = s == steps ? ob : saved ? saved + ((long)s * B + b) * plane : nullptr;
      if (dst && last == steps && yin) {
        if (store) {
          *reinterpret_cast<float4*>(dst + y * W + x) =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (x + c < W) dst[y * W + x + c] = acc[c];
        }
      }
      if (s < steps) {
        float p[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) p[c] = cb ? __fmul_rn(acc[c], cf[c]) : acc[c];
        if (lo > 0 || hi < 3) {                   // a strip at or past the edge
          const float pl = lo == 0 ? p[0] : lo == 1 ? p[1] : lo == 2 ? p[2] : p[3];
          const float ph = hi == 0 ? p[0] : hi == 1 ? p[1] : hi == 2 ? p[2] : p[3];
#pragma unroll
          for (int c = 0; c < 4; ++c) p[c] = c < lo ? pl : c > hi ? ph : p[c];
        }
        *reinterpret_cast<float4*>(nxt + own) = make_float4(p[0], p[1], p[2], p[3]);
      }
    }
    if (s == steps) break;
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

bool aligned16(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

template <int RT>
int launch(const float* pred, const float* aff, const float* conf,
           const float* dep, float* out, float* saved, int B, int H, int W,
           int r, int steps, int tile, int preserve, int clip, int pre_blend,
           void* stream) {
  const int E = (steps - 1) * r, EX = round4(E);
  const long bw = tile + 2 * (EX + round4(r)), bh = tile + 2L * steps * r;
  const long threads = ((long)(tile + 2 * E) * ((tile + 2 * EX) / 4) + 31) / 32 * 32;
  const long smem = (long)sizeof(float) * 2 * bh * bw;
  if (tile % 4 || threads > max_threads<RT>() || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        prop_loop_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float* dp = (preserve || pre_blend) ? dep : nullptr;
  const int vec = W % 4 == 0 && aligned16(pred) && aligned16(aff) && aligned16(conf) &&
                  aligned16(dp) && aligned16(out) && aligned16(saved);
  const dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile, B);
  prop_loop_kernel<RT><<<grid, (int)threads, smem, (cudaStream_t)stream>>>(
      pred, aff, conf, dp, out, saved, H, W, r, steps, tile, preserve, clip,
      pre_blend, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// pred, conf, dep, out: (B, H, W) f32 contiguous; aff: (B, (2r+1)^2, H, W);
// saved: (steps, B, H, W) or null. conf may be null (no confidence
// weighting); dep is read only if preserve or pre_blend. tile: a multiple
// of 4. Threads: the first step's strips; shared memory: two buffers over
// the tile grown by steps r rows and round4((steps - 1) r) + round4(r)
// columns a side. Returns cudaGetLastError().
extern "C" int prop_loop_f32(const float* pred, const float* aff,
                             const float* conf, const float* dep, float* out,
                             float* saved, int B, int H, int W, int r,
                             int steps, int tile, int preserve, int clip,
                             int pre_blend, void* stream) {
  auto* fn = r == 1 ? launch<1> : r == 2 ? launch<2> : launch<-1>;
  return fn(pred, aff, conf, dep, out, saved, B, H, W, r, steps, tile,
            preserve, clip, pre_blend, stream);
}

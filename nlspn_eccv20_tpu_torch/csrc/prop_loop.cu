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
// Design: 2-D halo tiles. A block owns a tile x tile output tile and keeps
// the weighted plane p of the tile and a halo of steps * r pixels on every
// side in shared memory, ping-ponged between two buffers. Step s computes
// cur_s over the tile grown by (steps - s) * r, so the valid region shrinks
// by r a step and the last step covers the tile alone. Cells outside the
// image are never computed: a neighbour index is clamped to the image (the
// replicate padding of the reference, at the true edge, at every step) and
// then mapped into the buffer. The affinities, conf and dep come through
// L1/L2 (__ldg), re-read each step; copying the region's affinities into
// shared memory once was slower on the H100 (it leaves one block an SM).
// 3x3 and 5x5 get the radius at compile time, so that a cell's taps unroll
// and their loads issue together. The TPU kernel tiles W only, with
// 128-lane blocks and a materialised edge pad (Mosaic's rules); neither is
// needed here. The halo's redundant work: at 3x3 and 12 steps a 32x32
// tile's regions run from 54^2 cells down to 32^2, 1.85x the tile on
// average; 16x16 tiles (2.8x), which the caller takes when 32x32 ones
// would leave SMs idle, trade that for more blocks.
// Shapes: any B, H, W (the last tiles are ragged), any odd kernel, any
// steps >= 1; the caller splits a loop whose halo does not fit in shared
// memory into launches of fewer steps (ops/kernels/prop_loop.py).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

__device__ __forceinline__ float blend(float v, const float* dep, long o) {
  const float d = __ldg(dep + o);
  const float m = d > 0.0f ? 1.0f : 0.0f;
  return __fadd_rn(__fmul_rn(1.0f - m, v), __fmul_rn(m, d));
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

// RT > 0: the radius at compile time; RT == 0: any radius r_arg.
template <int RT>
__global__ void __launch_bounds__(THREADS)
prop_loop_kernel(const float* __restrict__ pred, const float* __restrict__ aff,
                 const float* __restrict__ conf, const float* __restrict__ dep,
                 float* __restrict__ out, float* __restrict__ saved, int H,
                 int W, int r_arg, int steps, int tile, int preserve, int clip,
                 int pre_blend) {
  extern __shared__ float smem[];
  const int r = RT > 0 ? RT : r_arg, k = 2 * r + 1;
  const int halo = steps * r;
  const int bw = tile + 2 * halo;                 // buffer side
  float* cur = smem;                              // p of the previous step
  float* nxt = smem + bw * bw;
  const int b = blockIdx.z, B = gridDim.z;
  const int y0 = blockIdx.y * tile, x0 = blockIdx.x * tile;
  const int by = y0 - halo, bx = x0 - halo;       // buffer origin
  const int y1 = min(y0 + tile, H), x1 = min(x0 + tile, W);
  const long plane = (long)H * W;
  const float* pb = pred + b * plane;
  const float* cb = conf ? conf + b * plane : nullptr;
  const float* db = dep ? dep + b * plane : nullptr;
  const float* ab = aff + (long)b * k * k * plane;

  // cur_0 over the tile and its whole halo, inside the image
  for_cells(max(by, 0), min(y1 + halo, H), max(bx, 0), min(x1 + halo, W),
            [&](int y, int x) {
    const long o = (long)y * W + x;
    float v = __ldg(pb + o);
    if (pre_blend) {
      v = blend(v, db, o);
      if (clip) v = fmaxf(v, 0.0f);
    }
    if (saved && y >= y0 && y < y1 && x >= x0 && x < x1) saved[b * plane + o] = v;
    if (cb) v = __fmul_rn(v, __ldg(cb + o));
    cur[(y - by) * bw + (x - bx)] = v;
  });
  __syncthreads();

  for (int s = 1; s <= steps; ++s) {
    const int e = (steps - s) * r;                // this step's margin
    for_cells(max(y0 - e, 0), min(y1 + e, H), max(x0 - e, 0), min(x1 + e, W),
              [&](int y, int x) {
      const long o = (long)y * W + x;
      const float* a = ab + o;
      float acc = 0.0f;
#pragma unroll
      for (int dy = -r; dy <= r; ++dy) {
        const int row = (clampi(y + dy, H - 1) - by) * bw - bx;
#pragma unroll
        for (int dx = -r; dx <= r; ++dx) {
          const int idx = (dy + r) * k + dx + r;
          acc = __fadd_rn(acc, __fmul_rn(cur[row + clampi(x + dx, W - 1)],
                                         __ldg(a + idx * plane)));
        }
      }
      if (preserve) acc = blend(acc, db, o);
      if (clip) acc = fmaxf(acc, 0.0f);
      if (s == steps) {
        out[b * plane + o] = acc;                 // e == 0: a tile cell
      } else {
        if (saved && y >= y0 && y < y1 && x >= x0 && x < x1)
          saved[((long)s * B + b) * plane + o] = acc;
        nxt[(y - by) * bw + (x - bx)] = cb ? __fmul_rn(acc, __ldg(cb + o)) : acc;
      }
    });
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

template <int RT>
int launch(const float* pred, const float* aff, const float* conf,
           const float* dep, float* out, float* saved, int B, int H, int W,
           int r, int steps, int tile, int preserve, int clip, int pre_blend,
           void* stream) {
  const int bw = tile + 2 * steps * r;
  const size_t smem = sizeof(float) * 2 * bw * bw;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        prop_loop_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile, B);
  prop_loop_kernel<RT><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      pred, aff, conf, (preserve || pre_blend) ? dep : nullptr, out, saved, H,
      W, r, steps, tile, preserve, clip, pre_blend);
  return (int)cudaGetLastError();
}

}  // namespace

// pred, conf, dep, out: (B, H, W) f32 contiguous; aff: (B, (2r+1)^2, H, W);
// saved: (steps, B, H, W) or null. conf may be null (no confidence
// weighting); dep is read only if preserve or pre_blend. Shared memory:
// two (tile + 2 steps r)^2 buffers. Returns cudaGetLastError().
extern "C" int prop_loop_f32(const float* pred, const float* aff,
                             const float* conf, const float* dep, float* out,
                             float* saved, int B, int H, int W, int r,
                             int steps, int tile, int preserve, int clip,
                             int pre_blend, void* stream) {
  auto* fn = r == 1 ? launch<1> : r == 2 ? launch<2> : launch<0>;
  return fn(pred, aff, conf, dep, out, saved, B, H, W, r, steps, tile,
            preserve, clip, pre_blend, stream);
}

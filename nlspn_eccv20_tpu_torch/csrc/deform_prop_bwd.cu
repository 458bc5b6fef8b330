// Backward of one deformable propagation step (K8): the gradients of
// deform_prop.cu's
//
//   p    = pred * conf                                  (conf optional)
//   acc  = sum_k aff_k * S_k,  S_k = sum_{u,v} t(oy_k - u) t(ox_k - v) p(y+dy_k+u, x+dx_k+v)
//   v    = (1 - m) * acc + m * dep,  m = dep > 0        (preserve)
//   out  = max(v, 0)                                    (clip)
//
// with t(s) = max(0, 1 - |s|) and (u, v) over the window [-R, R+1]^2 around
// neighbour k's kernel shift, given g = dL/d(out), for any offset. In the
// training clamp's range [-R, R] S_k is the bilinear sample; beyond it the
// window truncates it, as the windowed form K10a (deform_windowed.cu):
//
//   ga(o)      = g(o) * (1 - m(o)) * c(o),  c = [v > 0] + 0.5 [v == 0]
//   d_aff_k(o) = ga(o) * S_k(o)
//   d_oy_k(o)  = ga(o) aff_k(o) sum_{u,v} t'(oy_k - u) t(ox_k - v) p(...)
//   d_ox_k(o)  = ga(o) aff_k(o) sum_{u,v} t(oy_k - u) t'(ox_k - v) p(...)
//   d_p(s)     = sum over (o, k, u, v) reading s of ga aff_k t(oy_k - u) t(ox_k - v)
//   d_pred = d_p * conf,  d_conf = d_p * pred
//
// t' follows the JAX package's tie conventions (deform_prop._dhat of the TPU
// backward, which reproduces autodiff of its windowed form): -sign(s) with
// sign(0) = +1, times 1 for |s| < 1, 1/2 at |s| == 1, 0 beyond, and zero
// for u outside the window. Offsets that the clamp put on -R therefore get
// no term from u = -R - 1. The clip's factor c needs the pre-clip value,
// which the forward does not keep; with clip on, pass 1 recomputes it with
// the forward's operations in the forward's order (deform_common.cuh).
//
// Replaces the TPU kernels deform_prop._bwd_kernel (d_off, d_aff) and
// _bwd_scatter_kernel (the padded d_feat), reached from _deform_bwd_pallas
// (nlspn_eccv20_tpu/ops/pallas/deform_prop.py).
//
// Bound on the card: memory. It reads g, pred, conf, dep, 2 K2 offset and
// K2 affinity planes and writes d_pred, d_conf, 2 K2 offset and K2
// affinity gradient planes, about 6 K2 + 6 planes. Design, two passes, no
// atomics (two runs give equal bits, as the TPU's sequential grid did):
//   pass 1, one thread per output pixel: for each neighbour only the taps
//     u in {floor(oy) - 1, ..., floor(oy) + 2} can have a non-zero tent or
//     slope (and likewise v); floor(oy) + 2 only through rounding: for an
//     offset just below 0, oy - 1 rounds to exactly -1, where the slope is
//     1/2. At most 3x3 of these taps are read, through L1/L2. It writes
//     d_off, d_aff and ga.
//   pass 2, d_p as a gather, one thread per source pixel of a 32x8 tile:
//     for each neighbour k the outputs that can reach the tile lie in a
//     (8 + 2R + 1) x (32 + 2R + 1) region, whose (oy_k, ox_k, aff_k * ga)
//     the block stages in shared memory; each thread then walks the
//     (2R + 2)^2 outputs that can read it, in a fixed order.

#include <cuda_runtime.h>

#include "deform_common.cuh"

namespace {

constexpr int TX = 32;
constexpr int TY = 8;

// The tent t(s) and its slope t'(s) with the JAX ties; both 0 off-window.
__device__ __forceinline__ void tent_slope(float s, bool in_window, float& t,
                                           float& dt) {
  const float az = fabsf(s);
  const float mag = az < 1.0f ? 1.0f : (az == 1.0f ? 0.5f : 0.0f);
  t = in_window ? fmaxf(0.0f, 1.0f - az) : 0.0f;
  dt = in_window ? (s >= 0.0f ? -mag : mag) : 0.0f;
}

__global__ void __launch_bounds__(TX * TY)
deform_bwd_read_kernel(const float* __restrict__ g, const float* __restrict__ pred,
                       const float* __restrict__ off, const float* __restrict__ aff,
                       const float* __restrict__ conf, const float* __restrict__ dep,
                       float* __restrict__ d_off, float* __restrict__ d_aff,
                       float* __restrict__ ga, int H, int W, int r, int R,
                       int clip) {
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;
  const long plane = (long)H * W;
  const long o = (long)y * W + x;
  const int K2 = (2 * r + 1) * (2 * r + 1);
  const float* p = pred + b * plane;
  const float* c = conf ? conf + b * plane : nullptr;
  const float* db = dep ? dep + b * plane : nullptr;
  const float* ob = off + 2L * K2 * b * plane;
  const float* ab = aff + (long)K2 * b * plane;

  float gv = __ldg(g + b * plane + o);
  if (clip) {
    const float v = deform::step_value(p, c, ob, ab, db, H, W, r, y, x);
    gv = v > 0.0f ? gv : (v == 0.0f ? 0.5f * gv : 0.0f);
  }
  if (db && __ldg(db + o) > 0.0f) gv = 0.0f;
  ga[b * plane + o] = gv;

  float* dob = d_off + 2L * K2 * b * plane + o;
  float* dab = d_aff + (long)K2 * b * plane + o;
  int k = 0;
  for (int dy = -r; dy <= r; ++dy) {
    for (int dx = -r; dx <= r; ++dx, ++k) {
      const float oy = __ldg(ob + 2 * k * plane + o);
      const float ox = __ldg(ob + (2 * k + 1) * plane + o);
      const float q = __ldg(ab + k * plane + o) * gv;
      const float fy = floorf(oy), fx = floorf(ox);
      float ty[4], dty[4], tx[4], dtx[4];
      for (int i = 0; i < 4; ++i) {
        const float u = fy - 1.0f + i, v = fx - 1.0f + i;
        tent_slope(oy - u, u >= -R && u <= R + 1, ty[i], dty[i]);
        tent_slope(ox - v, v >= -R && v <= R + 1, tx[i], dtx[i]);
      }
      float s = 0.0f, doy = 0.0f, dox = 0.0f;
      for (int i = 0; i < 4; ++i) {
        if (ty[i] == 0.0f && dty[i] == 0.0f) continue;  // also every off-window u
        const int yy = y + dy + (int)fy - 1 + i;
        float row = 0.0f, row_dx = 0.0f;
        for (int j = 0; j < 4; ++j) {
          if (tx[j] == 0.0f && dtx[j] == 0.0f) continue;
          const float pv = deform::tap(p, c, H, W, yy, x + dx + (int)fx - 1 + j);
          row = fmaf(pv, tx[j], row);
          row_dx = fmaf(pv, dtx[j], row_dx);
        }
        s = fmaf(row, ty[i], s);
        doy = fmaf(row, dty[i], doy);
        dox = fmaf(row_dx, ty[i], dox);
      }
      dab[k * plane] = s * gv;
      dob[2 * k * plane] = doy * q;
      dob[(2 * k + 1) * plane] = dox * q;
    }
  }
}

__global__ void __launch_bounds__(TX * TY)
deform_bwd_feat_kernel(const float* __restrict__ off, const float* __restrict__ aff,
                       const float* __restrict__ ga, const float* __restrict__ pred,
                       const float* __restrict__ conf, float* __restrict__ d_pred,
                       float* __restrict__ d_conf, int H, int W, int r, int R) {
  extern __shared__ float smem[];
  const int SW = TX + 2 * R + 1, SH = TY + 2 * R + 1, n = SW * SH;
  float* s_oy = smem;
  float* s_ox = smem + n;
  float* s_q = smem + 2 * n;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const long plane = (long)H * W;
  const int K2 = (2 * r + 1) * (2 * r + 1);
  const float* ob = off + 2L * K2 * b * plane;
  const float* ab = aff + (long)K2 * b * plane;
  const float* gb = ga + b * plane;

  float acc = 0.0f;
  int k = 0;
  for (int dy = -r; dy <= r; ++dy) {
    for (int dx = -r; dx <= r; ++dx, ++k) {
      // outputs (y, x) whose window for neighbour k reaches the tile:
      // y = ys - dy - u, u in [-R, R+1]
      const int ry0 = y0 - dy - R - 1, rx0 = x0 - dx - R - 1;
      __syncthreads();  // the previous neighbour's tile is no longer read
      for (int i = tid; i < n; i += TX * TY) {
        const int yy = ry0 + i / SW, xx = rx0 + i % SW;
        float oy = 0.0f, ox = 0.0f, q = 0.0f;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
          const long o = (long)yy * W + xx;
          oy = __ldg(ob + 2 * k * plane + o);
          ox = __ldg(ob + (2 * k + 1) * plane + o);
          q = __ldg(ab + k * plane + o) * __ldg(gb + o);
        }
        s_oy[i] = oy;
        s_ox[i] = ox;
        s_q[i] = q;
      }
      __syncthreads();
      for (int u = -R; u <= R + 1; ++u) {
        const int row = (threadIdx.y + R + 1 - u) * SW + threadIdx.x + R + 1;
        const float fu = (float)u;
        for (int v = -R; v <= R + 1; ++v) {
          const int si = row - v;
          const float wy = fmaxf(0.0f, 1.0f - fabsf(s_oy[si] - fu));
          const float wx = fmaxf(0.0f, 1.0f - fabsf(s_ox[si] - (float)v));
          acc = fmaf(s_q[si] * wy, wx, acc);
        }
      }
    }
  }
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const long o = b * plane + (long)y * W + x;
  d_pred[o] = conf ? acc * __ldg(conf + o) : acc;
  if (d_conf) d_conf[o] = acc * __ldg(pred + o);
}

}  // namespace

// g, pred, conf, dep, d_pred, d_conf, ga: (B, H, W) f32 contiguous; off,
// d_off: (B, 2 (2r+1)^2, H, W); aff, d_aff: (B, (2r+1)^2, H, W). conf and
// d_conf may be null (no confidence weighting); dep is read only if
// preserve. ga is scratch the caller allocates. R is the offset window.
// Returns cudaGetLastError().
extern "C" int deform_prop_bwd_f32(const float* g, const float* pred,
                                   const float* off, const float* aff,
                                   const float* conf, const float* dep,
                                   float* d_pred, float* d_off, float* d_aff,
                                   float* d_conf, float* ga, int B, int H, int W,
                                   int r, int R, int preserve, int clip,
                                   void* stream) {
  const size_t smem = 3 * sizeof(float) * (TX + 2 * R + 1) * (TY + 2 * R + 1);
  if (R < 0 || smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        deform_bwd_feat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  cudaStream_t s = (cudaStream_t)stream;
  deform_bwd_read_kernel<<<grid, block, 0, s>>>(
      g, pred, off, aff, conf, preserve ? dep : nullptr, d_off, d_aff, ga, H, W,
      r, R, clip);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  deform_bwd_feat_kernel<<<grid, block, smem, s>>>(off, aff, ga, pred, conf,
                                                   d_pred, d_conf, H, W, r, R);
  return (int)cudaGetLastError();
}

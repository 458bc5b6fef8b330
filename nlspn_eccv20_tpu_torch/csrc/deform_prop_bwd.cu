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
// float atomics (two runs give equal bits, as the TPU's sequential grid did):
//   pass 1, one thread per output pixel: for each neighbour only the taps
//     u in {floor(oy) - 1, ..., floor(oy) + 2} can have a non-zero tent or
//     slope (and likewise v); floor(oy) + 2 only through rounding: for an
//     offset just below 0, oy - 1 rounds to exactly -1, where the slope is
//     1/2. At most 3x3 of these taps are read, from the block's tile of
//     pred * conf in shared memory. It writes d_off, d_aff and ga.
//   pass 2, d_p, one block per 32x8 tile of source pixels. An output's
//     tents are non-zero only at u in {floor(oy), floor(oy) + 1} (for any
//     other u, |oy - u| >= 1 after rounding, which is monotonic), and
//     likewise v: each (output, neighbour) reaches the 2x2 sources at its
//     corner (y + dy + floor(oy), x + dx + floor(ox)) and no other. The TPU
//     kernel scatters the whole (2R+2)^2 window into shifted planes, and a
//     gather that walks it (this kernel's first form) multiplies by zero in
//     96 of 100 candidates at R = 4, three shared loads each. Instead, for a
//     round of neighbours, the block reads the (8 + 2R + 1) x (32 + 2R + 1)
//     outputs that can reach the tile, all loads of a thread in flight
//     together, keeps the four weights q t_y (q = aff_k ga) and t_x of
//     those whose corner cell touches the tile, and marks each in its
//     cell's mask, at the bit of its floor(offset): atomicOr, whose result
//     does not depend on the order of the writers. Outputs whose floor lies
//     outside the window (offsets beyond the training clamp) are dropped.
//     Then one thread a cell sums the four products that the cell's outputs
//     give its 2x2 sources, in bit order, and each source adds the four
//     sums that reach it from its four cells, neighbour by neighbour: fixed
//     orders, so two runs give equal bits. Many outputs may share one
//     corner (converging offsets, up to (2R+3)^2 a cell): the result stays
//     right, only that cell's sum takes longer. Three neighbours are staged
//     per round at R = 4, which leaves room for four blocks on an SM.
//     Tried and slower on the card: a counting sort of the outputs by
//     cell (a scan, a placement and a rank pass), and one round of all
//     nine neighbours (one block an SM).

#include <cuda_runtime.h>

#include <algorithm>

#include "deform_common.cuh"

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int NT = TX * TY;
constexpr int NCX = TX + 1;  // pass 2's corner cells whose 2x2 sources meet the tile
constexpr int NCY = TY + 1;
constexpr int NC = NCX * NCY;
constexpr int EPT = 3;       // pass 2's outputs a thread loads at once
constexpr long kFeatBudget = 56 * 1024;  // pass 2's shared memory: four blocks an SM

// The tent t(s) and its slope t'(s) with the JAX ties; both 0 off-window.
__device__ __forceinline__ void tent_slope(float s, bool in_window, float& t,
                                           float& dt) {
  const float az = fabsf(s);
  const float mag = az < 1.0f ? 1.0f : (az == 1.0f ? 0.5f : 0.0f);
  t = in_window ? fmaxf(0.0f, 1.0f - az) : 0.0f;
  dt = in_window ? (s >= 0.0f ? -mag : mag) : 0.0f;
}

__global__ void __launch_bounds__(NT)
deform_bwd_read_kernel(const float* __restrict__ g, const float* __restrict__ pred,
                       const float* __restrict__ off, const float* __restrict__ aff,
                       const float* __restrict__ conf, const float* __restrict__ dep,
                       float* __restrict__ d_off, float* __restrict__ d_aff,
                       float* __restrict__ ga, int H, int W, int r, int R,
                       int clip) {
  extern __shared__ float p_s[];  // pred * conf around the tile, zero outside
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  const int b = blockIdx.z;
  const long plane = (long)H * W;
  // every tap in the window lies within r + R above or left of the tile
  // and r + R + 1 below or right of it
  const int h = r + R, PW = TX + 2 * h + 1, PH = TY + 2 * h + 1;
  {
    const float* p = pred + b * plane;
    const float* c = conf ? conf + b * plane : nullptr;
    const int py0 = blockIdx.y * TY - h, px0 = blockIdx.x * TX - h;
    const float inv_pw = 1.0f / (float)PW;  // the exact row of a small int
    for (int i = threadIdx.y * TX + threadIdx.x; i < PW * PH; i += NT) {
      const int row = (int)(((float)i + 0.5f) * inv_pw);
      p_s[i] = deform::tap(p, c, H, W, py0 + row, px0 + i - row * PW);
    }
  }
  __syncthreads();
  if (x >= W || y >= H) return;
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
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float u = fy - 1.0f + i, v = fx - 1.0f + i;
        tent_slope(oy - u, u >= -R && u <= R + 1, ty[i], dty[i]);
        tent_slope(ox - v, v >= -R && v <= R + 1, tx[i], dtx[i]);
      }
      float s = 0.0f, doy = 0.0f, dox = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (ty[i] == 0.0f && dty[i] == 0.0f) continue;  // also every off-window u
        const float* tap_row =
            p_s + (threadIdx.y + h + dy + (int)fy - 1 + i) * PW + threadIdx.x + h;
        float row = 0.0f, row_dx = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (tx[j] == 0.0f && dtx[j] == 0.0f) continue;
          const float pv = tap_row[dx + (int)fx - 1 + j];
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

// Pass 2's shared memory: the tile's ga with the halo of every neighbour's
// region, and per neighbour of a round the staged outputs' weights and
// the cells' masks (then the cells' four sums, in place).
__host__ __device__ constexpr int mask_words(int R) {
  return ((2 * R + 3) * (2 * R + 3) + 127) / 128 * 4;  // whole int4s
}
__host__ __device__ constexpr long feat_bytes_ga(int r, int R) {
  return ((long)(TX + 2 * R + 2 * r + 1) * (TY + 2 * R + 2 * r + 1) * sizeof(float) + 15) / 16 * 16;
}
__host__ __device__ constexpr long feat_bytes_per_neighbour(int R) {
  return (long)(TX + 2 * R + 1) * (TY + 2 * R + 1) * sizeof(float4) +
         (long)NC * mask_words(R) * sizeof(unsigned);
}

__global__ void __launch_bounds__(NT)
deform_bwd_feat_kernel(const float* __restrict__ off, const float* __restrict__ aff,
                       const float* __restrict__ ga, const float* __restrict__ pred,
                       const float* __restrict__ conf, float* __restrict__ d_pred,
                       float* __restrict__ d_conf, int H, int W, int r, int R,
                       int nkr) {
  extern __shared__ float4 smem[];
  const int SW = TX + 2 * R + 1, SH = TY + 2 * R + 1, n = SW * SH;
  const int GW = SW + 2 * r, GH = SH + 2 * r;  // ga around every region
  const int D = 2 * R + 3, MW = mask_words(R);
  float* ga_s = reinterpret_cast<float*>(smem);
  float4* e_val = smem + feat_bytes_ga(r, R) / 16;   // [nkr n] by region position
  unsigned* masks = reinterpret_cast<unsigned*>(e_val + nkr * n);  // [nkr NC][MW]

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const long plane = (long)H * W;
  const int KS = 2 * r + 1, K2 = KS * KS;
  const float* ob = off + 2L * K2 * b * plane;
  const float* ab = aff + (long)K2 * b * plane;
  const float lo = (float)(-R - 1), hi = (float)(R + 1);
  // exact quotients of the small non-negative ints below
  const float inv_sw = 1.0f / (float)SW, inv_gw = 1.0f / (float)GW, inv_d = 1.0f / (float)D;

  {
    const float* gb = ga + b * plane;
    const int gy0 = y0 - R - r - 1, gx0 = x0 - R - r - 1;
    for (int i = tid; i < GH * GW; i += NT) {
      const int row = (int)(((float)i + 0.5f) * inv_gw);
      const int yy = gy0 + row, xx = gx0 + i - row * GW;
      ga_s[i] = yy >= 0 && yy < H && xx >= 0 && xx < W ? __ldg(gb + (long)yy * W + xx) : 0.0f;
    }
  }

  float acc = 0.0f;
  for (int k0 = 0; k0 < K2; k0 += nkr) {
    const int nk = min(nkr, K2 - k0);
    __syncthreads();  // the previous round's sums are no longer read; ga_s is in
    for (int i = tid; i < nk * NC * MW; i += NT) masks[i] = 0u;
    __syncthreads();

    // Bin each output that can reach the tile by its corner: the bit of
    // its floor(offset) in its corner cell's mask, set with atomicOr, whose
    // result does not depend on the order of the writers. Its four weights
    // go to its region position.
    for (int kk = 0; kk < nk; ++kk) {
      const int k = k0 + kk, dy = k / KS - r, dx = k % KS - r;
      const int ry0 = y0 - dy - R - 1, rx0 = x0 - dx - R - 1;
      const float* oyk = ob + 2 * k * plane;
      const float* oxk = oyk + plane;
      const float* ak = ab + k * plane;
      const float* gk = ga_s + (r - dy) * GW + r - dx;
      unsigned* mk = masks + kk * NC * MW;
      float4* ev = e_val + kk * n;
      for (int j0 = tid; j0 < n; j0 += EPT * NT) {
        float oy[EPT], ox[EPT], a[EPT];
#pragma unroll
        for (int e = 0; e < EPT; ++e) {  // all loads first: in flight together
          const int j = j0 + e * NT;
          const int row = (int)(((float)j + 0.5f) * inv_sw);
          const int yy = ry0 + row, xx = rx0 + j - row * SW;
          oy[e] = ox[e] = __int_as_float(0x7fc00000);  // NaN: not binned
          a[e] = 0.0f;
          if (j < n && yy >= 0 && yy < H && xx >= 0 && xx < W) {
            const long o = (long)yy * W + xx;
            oy[e] = __ldg(oyk + o);
            ox[e] = __ldg(oxk + o);
            a[e] = __ldg(ak + o);
          }
        }
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          const float fy = floorf(oy[e]), fx = floorf(ox[e]);
          // u in {fy, fy + 1} must meet the window [-R, R + 1]
          if (!(fy >= lo && fy <= hi && fx >= lo && fx <= hi)) continue;
          // region row 0 is y0 - dy - R - 1 and cell row 0 is y0 - 1: the
          // corner y + dy + fy is cell row - R + fy (likewise columns)
          const int j = j0 + e * NT;
          const int row = (int)(((float)j + 0.5f) * inv_sw), col = j - row * SW;
          const int cy = row - R + (int)fy, cx = col - R + (int)fx;
          if (cy < 0 || cy >= NCY || cx < 0 || cx >= NCX) continue;
          const float q = a[e] * gk[row * GW + col];
          const float wy0 = fy > lo ? fmaxf(0.0f, 1.0f - fabsf(oy[e] - fy)) : 0.0f;
          const float wy1 = fy < hi ? fmaxf(0.0f, 1.0f - fabsf(oy[e] - (fy + 1.0f))) : 0.0f;
          const float wx0 = fx > lo ? fmaxf(0.0f, 1.0f - fabsf(ox[e] - fx)) : 0.0f;
          const float wx1 = fx < hi ? fmaxf(0.0f, 1.0f - fabsf(ox[e] - (fx + 1.0f))) : 0.0f;
          ev[j] = make_float4(q * wy0, q * wy1, wx0, wx1);
          const int bit = ((int)fy + R + 1) * D + (int)fx + R + 1;
          atomicOr(&mk[(cy * NCX + cx) * MW + (bit >> 5)], 1u << (bit & 31));
        }
      }
    }
    __syncthreads();

    // Each cell's four sums, one per source of its 2x2, over its outputs
    // in bit order (a fixed order: two runs give equal bits). They replace
    // the cell's mask: (00, 01, 10, 11) for the sources (cy, cx) + (a, b).
    for (int c = tid; c < nk * NC; c += NT) {
      const int kk = c / NC, cell = c - kk * NC;
      const int cy = cell / NCX, cx = cell - cy * NCX;
      const float4* ev = e_val + kk * n;
      unsigned* mk = masks + c * MW;
      float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int w = 0; w < MW; w += 4) {
        const uint4 m4 = *reinterpret_cast<const uint4*>(mk + w);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          unsigned bits = h == 0 ? m4.x : h == 1 ? m4.y : h == 2 ? m4.z : m4.w;
          while (bits) {
            const int bit = 32 * (w + h) + __ffs(bits) - 1;
            bits &= bits - 1;
            const int fyi = (int)(((float)bit + 0.5f) * inv_d);
            // the output's region position: its cell less its floor
            const float4 e = ev[(cy + 2 * R + 1 - fyi) * SW + cx + 2 * R + 1 - (bit - fyi * D)];
            t.x = fmaf(e.x, e.z, t.x);
            t.y = fmaf(e.x, e.w, t.y);
            t.z = fmaf(e.y, e.z, t.z);
            t.w = fmaf(e.y, e.w, t.w);
          }
        }
      }
      *reinterpret_cast<float4*>(mk) = t;
    }
    __syncthreads();

    // Gather: the source (y0 + ty, x0 + tx) is corner (1, 1) of cell
    // (ty, tx), (1, 0) of (ty, tx + 1), (0, 1) of (ty + 1, tx) and (0, 0) of
    // (ty + 1, tx + 1).
    const int ty = threadIdx.y, tx = threadIdx.x;
    for (int kk = 0; kk < nk; ++kk) {
      const unsigned* mk = masks + kk * NC * MW;
      acc += reinterpret_cast<const float4*>(mk + (ty * NCX + tx) * MW)->w;
      acc += reinterpret_cast<const float4*>(mk + (ty * NCX + tx + 1) * MW)->z;
      acc += reinterpret_cast<const float4*>(mk + ((ty + 1) * NCX + tx) * MW)->y;
      acc += reinterpret_cast<const float4*>(mk + ((ty + 1) * NCX + tx + 1) * MW)->x;
    }
  }
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const long o = b * plane + (long)y * W + x;
  d_pred[o] = conf ? acc * __ldg(conf + o) : acc;
  if (d_conf) d_conf[o] = acc * __ldg(pred + o);
}

}  // namespace

// Neighbours staged per round of pass 2: as many as fit in kFeatBudget, at
// least one (whose shared memory must then fit alone).
static int feat_neighbours_per_round(int K2, int r, int R) {
  const long per = feat_bytes_per_neighbour(R);
  return (int)std::max(1L, std::min((long)K2, (kFeatBudget - feat_bytes_ga(r, R)) / per));
}

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
  if (R < 0 || r < 0) return (int)cudaErrorInvalidValue;
  const int K2 = (2 * r + 1) * (2 * r + 1);
  const int nkr = feat_neighbours_per_round(K2, r, R);
  const long smem = feat_bytes_ga(r, R) + nkr * feat_bytes_per_neighbour(R);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      deform_bwd_feat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(deform_bwd_feat_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  cudaStream_t s = (cudaStream_t)stream;
  const size_t read_smem = sizeof(float) * (TX + 2 * (r + R) + 1) * (TY + 2 * (r + R) + 1);
  if (read_smem > 232448) return (int)cudaErrorInvalidValue;
  if (read_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(deform_bwd_read_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)read_smem);
    if (err != cudaSuccess) return (int)err;
  }
  deform_bwd_read_kernel<<<grid, block, read_smem, s>>>(
      g, pred, off, aff, conf, preserve ? dep : nullptr, d_off, d_aff, ga, H, W,
      r, R, clip);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  deform_bwd_feat_kernel<<<grid, block, (size_t)smem, s>>>(
      off, aff, ga, pred, conf, d_pred, d_conf, H, W, r, R, nkr);
  return (int)cudaGetLastError();
}

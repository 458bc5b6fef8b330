// The windowed form of the deformable gather (K10a): for every pixel,
//
//   out(y, x) = sum_k aff_k * sum_{u in [-R, R+1]} t(oy_k - u)
//                 * sum_{v in [-R, R+1]} t(ox_k - v) * P(y + dy_k + u, x + dx_k + v)
//
// with t(s) = max(0, 1 - |s|), (dy_k, dx_k) neighbour k's kernel shift
// (row-major, centre included) and P the plane, zero outside the image. It
// equals the exact bilinear gather when every offset lies in [-R, R];
// beyond, the window truncates it. No conf, blend or clip.
//
// Replaces the TPU kernel _windowed_kernel, reached from
// _deform_pallas_core (devtools/exp_deform_prop_kernel.py), a prototype of
// K7 (deform_prop.cu) that holds the zero-padded plane in VMEM and sums
// (2R+2)^2 shifted slices a neighbour.
//
// Bound on the card: memory by the bytes it must move (the plane, 2 K2
// offset and K2 affinity planes in, one plane out: 4 B x (3 K2 + 2) a
// pixel), but its 2 (2R+2)^2 K2 flops a pixel (1,800 at 3x3, R = 4) come
// within 1.3x of that in float32, and every product reads shared memory.
// Design: one thread per output pixel of a 32x8 tile; the block stages the
// tile's part of the plane plus a halo of rp = R + 1 + r (zero outside the
// image) in shared memory once, so every shifted read of the window is a
// shared-memory load with neighbouring threads on neighbouring banks; each
// neighbour's 2R+2 column tents are computed once and kept in registers
// (the window is a template parameter, so the loops unroll), as the TPU
// kernel's wxs. The operations and their order are those of the plain
// PyTorch version (ops/propagate.py propagate_deformable_windowed_planar),
// each product and sum rounded on its own (no FMA), so both give the same
// bits.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int MAX_R = 8;

// max(0, 1 - |s|) in the plain version's order.
__device__ __forceinline__ float tent(float s) {
  const float az = s >= 0.0f ? s : -s;
  return fmaxf(__fsub_rn(1.0f, az), 0.0f);
}

template <int R>
__global__ void __launch_bounds__(TX * TY)
deform_windowed_kernel(const float* __restrict__ feat, const float* __restrict__ off,
                       const float* __restrict__ aff, float* __restrict__ out,
                       int H, int W, int r) {
  constexpr int N = 2 * R + 2;
  extern __shared__ float tile[];
  const int rp = R + 1 + r;
  const int SW = TX + 2 * rp, SH = TY + 2 * rp;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const long plane = (long)H * W;
  const float* p = feat + b * plane;
  for (int i = threadIdx.y * TX + threadIdx.x; i < SW * SH; i += TX * TY) {
    const int yy = y0 - rp + i / SW, xx = x0 - rp + i % SW;
    tile[i] = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? __ldg(p + (long)yy * W + xx)
                                                       : 0.0f;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int K2 = (2 * r + 1) * (2 * r + 1);
  const long o = (long)y * W + x;
  const float* ob = off + 2L * K2 * b * plane + o;
  const float* ab = aff + (long)K2 * b * plane + o;
  float acc_out = 0.0f;
  int k = 0;
  for (int dy = -r; dy <= r; ++dy) {
    for (int dx = -r; dx <= r; ++dx, ++k) {
      const float oy = __ldg(ob + 2 * k * plane);
      const float ox = __ldg(ob + (2 * k + 1) * plane);
      float wx[N];
#pragma unroll
      for (int j = 0; j < N; ++j) wx[j] = tent(__fsub_rn(ox, (float)(j - R)));
      // the window's top-left cell (u, v) = (-R, -R) in the tile
      const float* win = tile + (threadIdx.y + rp + dy - R) * SW + threadIdx.x + rp + dx - R;
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float row = 0.0f;
#pragma unroll
        for (int j = 0; j < N; ++j) row = __fadd_rn(row, __fmul_rn(win[i * SW + j], wx[j]));
        acc = __fadd_rn(acc, __fmul_rn(row, tent(__fsub_rn(oy, (float)(i - R)))));
      }
      acc_out = __fadd_rn(acc_out, __fmul_rn(acc, __ldg(ab + k * plane)));
    }
  }
  out[b * plane + o] = acc_out;
}

template <int R>
int launch(const float* feat, const float* off, const float* aff, float* out, int B,
           int H, int W, int r, cudaStream_t s) {
  const int rp = R + 1 + r;
  const size_t smem = sizeof(float) * (TX + 2 * rp) * (TY + 2 * rp);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        deform_windowed_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  deform_windowed_kernel<R><<<grid, block, smem, s>>>(feat, off, aff, out, H, W, r);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const float*, const float*, const float*, float*, int, int, int,
                       int, cudaStream_t);
constexpr Launch kLaunch[MAX_R + 1] = {launch<0>, launch<1>, launch<2>, launch<3>, launch<4>,
                                       launch<5>, launch<6>, launch<7>, launch<8>};

}  // namespace

// feat, out: (B, H, W) f32 contiguous; off: (B, 2 (2r+1)^2, H, W) with
// neighbour k's (dy, dx) at channels 2k, 2k+1; aff: (B, (2r+1)^2, H, W).
// R is the window's radius, 0 <= R <= 8 (the column tents live in
// registers). Returns cudaGetLastError(), or cudaErrorInvalidValue for an R
// out of range or a tile past shared memory.
extern "C" int deform_windowed_f32(const float* feat, const float* off, const float* aff,
                                   float* out, int B, int H, int W, int r, int R,
                                   void* stream) {
  if (R < 0 || R > MAX_R || r < 0) return (int)cudaErrorInvalidValue;
  return kLaunch[R](feat, off, aff, out, B, H, W, r, (cudaStream_t)stream);
}

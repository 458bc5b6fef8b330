// The column-exact, row-windowed deformable gather (K10b), 3x3 only: for
// every pixel and neighbour k of the 3x3 stencil, with ty = oy_k + dy_k and
// tx = ox_k + dx_k,
//
//   x0 = floor(tx),  fx = tx - x0
//   n_k = sum_{u in [dy_k - R, dy_k + R + 1]} t(ty - u)
//           * (P(y + u, x + x0) * (1 - fx) + P(y + u, x + x0 + 1) * fx)
//   out(y, x) = sum_k aff_k * n_k
//
// with t(s) = max(0, 1 - |s|) and P the plane, zero outside the image. The
// column is resolved exactly by its two taps; the rows by the static tent
// window, which equals the bilinear row weights when |oy| <= R. So it is
// the exact gather when every offset lies in [-R, R]; beyond, the row
// window truncates it, and any column reads zeros outside the image.
//
// Replaces the TPU kernel _kernel, reached from deform_pallas
// (devtools/exp_deform3.py), a prototype of K7 (deform_prop.cu) that gathers
// the two column taps along the lanes of a padded row block (padding
// rp = R + 2) and walks the rows as sublane shifts.
//
// Bound on the card: memory (the plane, 18 offset and 9 affinity planes in,
// one plane out: 116 B a pixel, against 9 (2R+2) x 8 flops). Design: one
// thread per output pixel of a 32x8 tile; the block stages the tile's part
// of the plane plus a halo of rp = R + 2 rows and columns (zero outside the
// image) in shared memory, which holds every tap of an offset in [-R, R];
// a column tap beyond the halo reads the plane through L1/L2. The
// operations and their order are those of the plain PyTorch version
// (devtools/exp_deform3.py deform_colgather_plain, the TPU kernel's order),
// each product and sum rounded on its own (no FMA).

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;

__global__ void __launch_bounds__(TX * TY)
deform_colgather_kernel(const float* __restrict__ feat, const float* __restrict__ off,
                        const float* __restrict__ aff, float* __restrict__ out, int H,
                        int W, int R) {
  extern __shared__ float tile[];
  const int rp = R + 2;
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
  const long o = (long)y * W + x;
  const float* ob = off + 18L * b * plane + o;
  const float* ab = aff + 9L * b * plane + o;
  float acc = 0.0f;
  int k = 0;
  for (int dy = -1; dy <= 1; ++dy) {
    for (int dx = -1; dx <= 1; ++dx, ++k) {
      const float ty = __fadd_rn(__ldg(ob + 2 * k * plane), (float)dy);
      const float tx = __fadd_rn(__ldg(ob + (2 * k + 1) * plane), (float)dx);
      const float a = __ldg(ab + k * plane);
      const float x0f = floorf(tx);
      const float fx = __fsub_rn(tx, x0f);
      const float hx = __fsub_rn(1.0f, fx);
      // the left tap's column relative to x; clamped first, so that any
      // finite offset lands outside the image rather than overflowing
      const int c = (int)fminf(fmaxf(x0f, -(float)(W + 2)), (float)(W + 2));
      const bool in_tile = c >= -rp && c < rp;
      float neighk = 0.0f;
      for (int u = dy - R; u <= dy + R + 1; ++u) {
        float g0, g1;
        if (in_tile) {
          const float* t = tile + (threadIdx.y + rp + u) * SW + threadIdx.x + rp + c;
          g0 = t[0];
          g1 = t[1];
        } else {
          const int yy = y + u, xx = x + c;
          const bool row_in = yy >= 0 && yy < H;
          g0 = row_in && xx >= 0 && xx < W ? __ldg(p + (long)yy * W + xx) : 0.0f;
          g1 = row_in && xx + 1 >= 0 && xx + 1 < W ? __ldg(p + (long)yy * W + xx + 1) : 0.0f;
        }
        const float s = __fsub_rn(ty, (float)u);
        const float wy = fmaxf(__fsub_rn(1.0f, s >= 0.0f ? s : -s), 0.0f);
        neighk = __fadd_rn(neighk, __fmul_rn(wy, __fadd_rn(__fmul_rn(g0, hx),
                                                           __fmul_rn(g1, fx))));
      }
      acc = __fadd_rn(acc, __fmul_rn(a, neighk));
    }
  }
  out[b * plane + o] = acc;
}

}  // namespace

// feat, out: (B, H, W) f32 contiguous; off: (B, 18, H, W) with neighbour
// k's (dy, dx) at channels 2k, 2k+1; aff: (B, 9, H, W). R >= 0 is the row
// window's radius. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// a negative R or a tile past shared memory.
extern "C" int deform_colgather_f32(const float* feat, const float* off, const float* aff,
                                    float* out, int B, int H, int W, int R, void* stream) {
  const size_t smem = sizeof(float) * (TX + 2 * (R + 2)) * (TY + 2 * (R + 2));
  if (R < 0 || smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        deform_colgather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  deform_colgather_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(feat, off, aff, out,
                                                                       H, W, R);
  return (int)cudaGetLastError();
}

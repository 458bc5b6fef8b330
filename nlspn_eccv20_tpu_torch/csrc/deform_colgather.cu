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
// rp = R + 2) and walks all 2R + 2 rows of the window as sublane shifts:
// the TPU had shifts and no gather.
//
// Bound on the card: memory. The function reads the plane, 18 offset and 9
// affinity planes and writes one plane, 116 bytes a pixel. Walking the
// whole window, as the TPU kernel does and this kernel's first form did,
// costs 2 (2R + 2) shared-memory taps and about 10 (2R + 2) operations a
// neighbour (at R = 4, 180 taps and some 900 operations a pixel): bound by
// instruction issue at 3.8x its bytes. The tent is non-zero on at most two
// rows, u0 = floor(ty) and u0 + 1, so this form sums only those two, each
// only where it lies in the window: 4 taps a neighbour. That gives the
// plain version's bits for any finite plane: every other row's weight is
// +0 (rounding is monotone, so |ty - u| cannot round below 1), its term is
// +-0, and adding +-0 to a sum that starts at +0 changes no bit. The two
// rows are added in increasing u, each weight by the plain version's own
// expression max(0, 1 - |ty - u|) (not 1 - fy).
//
// Layout: a thread owns 4 neighbouring pixels of a row, a block a 16 x 64
// tile (256 threads). It reads each of the 27 offset and affinity planes as
// one 16-byte load where W % 4 == 0 and every pointer is 16-byte aligned
// (else four scalar loads), and writes its 4 outputs as one. The block
// stages its part of the plane plus a halo of rp = R + 2 rows and rp
// columns (rounded up to 4, so that the copies are 16 bytes where the
// loads are) by cp.async (cp_async.cuh), zero outside the image; a column
// tap beyond the halo reads the plane through L1/L2. Index arithmetic is
// 32-bit within an image (the entry point refuses 18 H W >= 2^31). Every
// other operation and its order are those of the plain PyTorch version
// (devtools/exp_deform3.py deform_colgather_plain, the TPU kernel's order),
// each product and sum rounded on its own (no FMA).

#include <cstdint>

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int PX = 4;             // pixels a thread, along a row
constexpr int TXT = 16;           // threads along a row
constexpr int TW = PX * TXT;      // tile columns
constexpr int TH = 16;            // tile rows
constexpr int NT = TXT * TH;      // threads a block

// staged columns on each side of the tile: rp rounded up to 4
__host__ __device__ constexpr int halo_cols(int R) { return (R + 2 + 3) & ~3; }

__host__ __device__ constexpr int smem_floats(int R) {
  return (TH + 2 * (R + 2)) * (TW + 2 * halo_cols(R));
}

template <bool kVec>
__global__ void __launch_bounds__(NT)
deform_colgather_kernel(const float* __restrict__ feat, const float* __restrict__ off,
                        const float* __restrict__ aff, float* __restrict__ out, int H,
                        int W, int R) {
  extern __shared__ __align__(16) float tile[];
  const int rp = R + 2, ra = halo_cols(R);
  const int SW = TW + 2 * ra, SH = TH + 2 * rp;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int plane = H * W;
  const float* p = feat + (size_t)b * plane;
  const int tid = threadIdx.x;

  // the tile and its halo: staged row i is image row y0 - rp + i, staged
  // column j image column x0 - ra + j
  if constexpr (kVec) {
    const int q4 = SW / 4;
    for (int i = tid; i < SH * q4; i += NT) {
      const int row = i / q4, q = i - row * q4;
      const int yy = y0 - rp + row, xx = x0 - ra + 4 * q;
      // W % 4 == 0 and xx % 4 == 0: the 4 columns are all in or all out
      const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
      cpa::copy16(tile + row * SW + 4 * q, ok ? p + yy * W + xx : p, ok);
    }
  } else {
    for (int i = tid; i < SH * SW; i += NT) {
      const int row = i / SW, col = i - row * SW;
      const int yy = y0 - rp + row, xx = x0 - ra + col;
      const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
      cpa::copy4(tile + i, ok ? p + yy * W + xx : p, ok);
    }
  }
  cpa::commit();
  cpa::wait<0>();
  __syncthreads();

  const int lx = PX * (tid % TXT), ly = tid / TXT;
  const int y = y0 + ly, xs = x0 + lx;
  if (y >= H || xs >= W) return;
  const int o = y * W + xs;
  const float* ob = off + (size_t)b * 18 * plane + o;
  const float* ab = aff + (size_t)b * 9 * plane + o;
  // pixel i's row of the staged tile, at the pixel's own column
  const float* trow = tile + (ly + rp) * SW + lx + ra;
  float acc[PX];
#pragma unroll
  for (int i = 0; i < PX; ++i) acc[i] = 0.0f;

  int k = 0;
#pragma unroll 1
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll 1
    for (int dx = -1; dx <= 1; ++dx, ++k) {
      float oy[PX], ox[PX], av[PX];
      if constexpr (kVec) {
        const float4 vy = __ldg(reinterpret_cast<const float4*>(ob + 2 * k * plane));
        const float4 vx = __ldg(reinterpret_cast<const float4*>(ob + (2 * k + 1) * plane));
        const float4 va = __ldg(reinterpret_cast<const float4*>(ab + k * plane));
        oy[0] = vy.x; oy[1] = vy.y; oy[2] = vy.z; oy[3] = vy.w;
        ox[0] = vx.x; ox[1] = vx.y; ox[2] = vx.z; ox[3] = vx.w;
        av[0] = va.x; av[1] = va.y; av[2] = va.z; av[3] = va.w;
      } else {
#pragma unroll
        for (int i = 0; i < PX; ++i) {
          const bool in = xs + i < W;
          oy[i] = in ? __ldg(ob + 2 * k * plane + i) : 0.0f;
          ox[i] = in ? __ldg(ob + (2 * k + 1) * plane + i) : 0.0f;
          av[i] = in ? __ldg(ab + k * plane + i) : 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        const float ty = __fadd_rn(oy[i], (float)dy);
        const float tx = __fadd_rn(ox[i], (float)dx);
        const float x0f = floorf(tx);
        const float fx = __fsub_rn(tx, x0f);
        const float hx = __fsub_rn(1.0f, fx);
        // the left tap's column relative to x; clamped first, so that any
        // finite offset lands outside the image rather than overflowing
        const int c = (int)fminf(fmaxf(x0f, -(float)(W + 2)), (float)(W + 2));
        const int cl = lx + i + c;   // its column in the tile
        const bool in_tile = cl >= -ra && cl + 1 < TW + ra;
        // the tent's two rows; a floor beyond R + 3 either way is clamped
        // there, where neither row lies in any window
        const int u0 = (int)fminf(fmaxf(floorf(ty), -(float)(R + 3)), (float)(R + 3));
        float neighk = 0.0f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int u = u0 + r;
          if (u < dy - R || u > dy + R + 1) continue;
          float g0, g1;
          if (in_tile) {
            const float* t = trow + u * SW + i + c;
            g0 = t[0];
            g1 = t[1];
          } else {
            const int yy = y + u, xx = xs + i + c;
            const bool row_in = yy >= 0 && yy < H;
            g0 = row_in && xx >= 0 && xx < W ? __ldg(p + yy * W + xx) : 0.0f;
            g1 = row_in && xx + 1 >= 0 && xx + 1 < W ? __ldg(p + yy * W + xx + 1) : 0.0f;
          }
          const float s = __fsub_rn(ty, (float)u);
          const float wy = fmaxf(__fsub_rn(1.0f, s >= 0.0f ? s : -s), 0.0f);
          neighk = __fadd_rn(neighk, __fmul_rn(wy, __fadd_rn(__fmul_rn(g0, hx),
                                                             __fmul_rn(g1, fx))));
        }
        acc[i] = __fadd_rn(acc[i], __fmul_rn(av[i], neighk));
      }
    }
  }
  float* op = out + (size_t)b * plane + o;
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(op) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int i = 0; i < PX; ++i)
      if (xs + i < W) op[i] = acc[i];
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// feat, out: (B, H, W) f32 contiguous; off: (B, 18, H, W) with neighbour
// k's (dy, dx) at channels 2k, 2k+1; aff: (B, 9, H, W). R >= 0 is the row
// window's radius. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// a negative R, a tile past shared memory or an image of 2^31 / 18 pixels
// or more.
extern "C" int deform_colgather_f32(const float* feat, const float* off, const float* aff,
                                    float* out, int B, int H, int W, int R, void* stream) {
  if (R < 0 || R > 4096 || 18LL * H * W >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)smem_floats(R);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const bool vec = W % 4 == 0 && aligned16(feat) && aligned16(off) && aligned16(aff)
                   && aligned16(out);
  auto kernel = vec ? deform_colgather_kernel<true> : deform_colgather_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(feat, off, aff, out, H, W, R);
  return (int)cudaGetLastError();
}

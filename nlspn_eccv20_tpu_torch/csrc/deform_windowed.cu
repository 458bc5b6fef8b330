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
// Bound on the card: memory. The function reads the plane, 2 K2 offset and
// K2 affinity planes and writes one plane: 4 B x (3 K2 + 2) a pixel, 116 at
// 3x3. Walking the whole (2R+2)^2 window, as the TPU kernel does and this
// kernel's first form did, costs 2 (2R+2)^2 K2 products and shared-memory
// reads a pixel (1,800 at 3x3, R = 4): bound by instruction issue at 5x
// its bytes. The tent is non-zero on at most two rows, u0 = floor(oy) and
// u0 + 1, and two columns, v0 = floor(ox) and v0 + 1, so this form sums
// only those 2 x 2 cells, each only where it lies in the window: 4 taps a
// neighbour. That gives the plain version's bits for any finite plane and
// finite offsets. Rounding is monotone and 1 is representable, so
// |fl(o - c)| >= 1 wherever |o - c| >= 1: every other cell's weight is +0
// and its term +-0. A sum that starts at +0 never becomes -0 (x + y is -0
// only when both are -0), and adding +-0 to it changes no bit. The cells
// are added as the plain version adds them: the columns in increasing v to
// a row sum that starts at +0, the rows in increasing u to the neighbour's
// sum that starts at +0, each weight by the plain version's own expression
// max(0, 1 - |o - c|) (never 1 - frac; see tent_near). A floor beyond
// R + 3 either way is clamped there before its conversion to int (no
// overflow for 1e9 or inf), where neither of its cells lies in the window.
//
// Layout: a block owns an 8 x 64 tile (256 threads); a thread owns 2 pixels
// of a tile row, 32 columns apart, so that the 32 threads of a warp read 32
// neighbouring columns: each of the 3 K2 offset and affinity planes in one
// 128-byte load a pixel, and the staged plane on 32 distinct banks where the
// offsets agree. (On the H100, K10b's layout, 4 neighbouring pixels a thread
// with 16-byte loads, puts a warp's taps 4 to a bank and took 1.14x the time
// at b=12 of 228x304; 4 pixels 16 apart fill a small grid with half the
// threads and took 1.3x at 5x5, b=1.) It loads the next neighbour's offsets
// and affinities while it computes the current one (loading two ahead gained
// nothing). Both axes are windowed, so every kept tap lies within rp = R + 1
// + r of the pixel: the block stages its part of the plane plus a halo of rp
// rows and rp columns (rounded up to 4, so that the copies are 16 bytes where
// W % 4 == 0) by cp.async (cp_async.cuh), zero outside the image, and reads
// nothing else of the plane. Index arithmetic is 32-bit within an image (the
// entry point refuses 2 K2 H W >= 2^31). Every product and sum is rounded on
// its own (no FMA), in the order of the plain PyTorch version
// (ops/propagate.py propagate_deformable_windowed_planar).

#include <cstdint>

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int PX = 2;             // pixels a thread, TXT columns apart
constexpr int TW = 64;            // tile columns
constexpr int TXT = TW / PX;      // threads along a tile row: a warp
constexpr int NT = 256;           // threads a block
constexpr int TH = NT / TXT;      // tile rows
constexpr int MAX_R = 8;

// staged columns on each side of the tile: the halo rp rounded up to 4
__host__ __device__ constexpr int halo_cols(int rp) { return (rp + 3) & ~3; }

__host__ __device__ constexpr int smem_floats(int rp) {
  return (TH + 2 * rp) * (TW + 2 * halo_cols(rp));
}

// max(0, 1 - |o - c|) at a cell c of the tent's two, floor(o) and
// floor(o) + 1, as the plain version computes it. There |o - c| <= 1, so
// |fl(o - c)| <= 1 (rounding is monotone) and 1 - |fl(o - c)| >= +0: the
// max changes nothing, nor does |.| where fl(o - c) is -0 (1 - 0 = 1).
__device__ __forceinline__ float tent_near(float o, float c) {
  return __fsub_rn(1.0f, fabsf(__fsub_rn(o, c)));
}

// c in [-R, R + 1], the window, as one unsigned comparison.
__device__ __forceinline__ bool in_window(int c, int R) {
  return (unsigned)(c + R) <= (unsigned)(2 * R + 1);
}

// Neighbour k's offsets and affinity at a thread's pixels; a pixel past
// the row keeps what it had (it is never stored).
struct Neighbour {
  float oy[PX] = {}, ox[PX] = {}, a[PX] = {};

  __device__ __forceinline__ void load(const float* ob, const float* ab, int k, int plane,
                                       const bool (&in)[PX]) {
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      if (!in[i]) continue;
      oy[i] = __ldg(ob + 2 * k * plane + TXT * i);
      ox[i] = __ldg(ob + (2 * k + 1) * plane + TXT * i);
      a[i] = __ldg(ab + k * plane + TXT * i);
    }
  }
};

template <bool kVec>
__global__ void __launch_bounds__(NT)
deform_windowed_kernel(const float* __restrict__ feat, const float* __restrict__ off,
                       const float* __restrict__ aff, float* __restrict__ out, int H, int W,
                       int r, int R) {
  extern __shared__ __align__(16) float tile[];
  const int rp = R + 1 + r, ra = halo_cols(rp);
  const int SW = TW + 2 * ra, SH = TH + 2 * rp;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int plane = H * W;
  const int K = 2 * r + 1, K2 = K * K;
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

  const int tx = tid % TXT, ty = tid / TXT;
  const int y = y0 + ty, x = x0 + tx;   // pixel i is (y, x + TXT i)
  const bool active = y < H && x < W;
  const int o = active ? y * W + x : 0;
  bool in[PX];
#pragma unroll
  for (int i = 0; i < PX; ++i) in[i] = x + TXT * i < W;
  const float* ob = off + (size_t)b * 2 * K2 * plane + o;
  const float* ab = aff + (size_t)b * K2 * plane + o;
  // two neighbours' loads in registers, the next one's in flight while
  // the current one is computed; the first overlaps the tile's copies
  Neighbour slot[2];
  if (active) slot[0].load(ob, ab, 0, plane, in);
  cpa::wait<0>();
  __syncthreads();
  if (!active) return;

  // pixel i's cell (u, v) of neighbour (dy, dx) is
  // trow[(dy + u) SW + dx + v + TXT i]
  const float* trow = tile + (ty + rp) * SW + tx + ra;
  const float lim = (float)(R + 3);
  float acc[PX];
#pragma unroll
  for (int i = 0; i < PX; ++i) acc[i] = 0.0f;

  int dy = -r, dx = -r;
  // two neighbours a turn, so that the slots' indices are constants
#pragma unroll 1
  for (int k0 = 0; k0 < K2; k0 += 2) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = k0 + j;
      if (k >= K2) break;
      if (k + 1 < K2) slot[j ^ 1].load(ob, ab, k + 1, plane, in);
      const Neighbour& cur = slot[j];
      const float* nb = trow + dy * SW + dx;
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        const float oy = cur.oy[i], ox = cur.ox[i];
        const float uf = fminf(fmaxf(floorf(oy), -lim), lim);
        const float vf = fminf(fmaxf(floorf(ox), -lim), lim);
        const int u0 = (int)uf, v0 = (int)vf;
        const float wx0 = tent_near(ox, vf), wx1 = tent_near(ox, __fadd_rn(vf, 1.0f));
        const bool in0 = in_window(v0, R), in1 = in_window(v0 + 1, R);
        float neighk = 0.0f;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int u = u0 + s;
          if (!in_window(u, R)) continue;
          const float* cell = nb + u * SW + v0 + TXT * i;
          float row = 0.0f;
          if (in0) row = __fadd_rn(row, __fmul_rn(cell[0], wx0));
          if (in1) row = __fadd_rn(row, __fmul_rn(cell[1], wx1));
          const float wy = tent_near(oy, s ? __fadd_rn(uf, 1.0f) : uf);
          neighk = __fadd_rn(neighk, __fmul_rn(row, wy));
        }
        acc[i] = __fadd_rn(acc[i], __fmul_rn(neighk, cur.a[i]));
      }
      if (++dx > r) {
        dx = -r;
        ++dy;
      }
    }
  }

  float* op = out + (size_t)b * plane + o;
#pragma unroll
  for (int i = 0; i < PX; ++i)
    if (in[i]) op[TXT * i] = acc[i];
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// feat, out: (B, H, W) f32 contiguous; off: (B, 2 (2r+1)^2, H, W) with
// neighbour k's (dy, dx) at channels 2k, 2k+1; aff: (B, (2r+1)^2, H, W).
// R is the window's radius, 0 <= R <= 8. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an R or r out of range, a tile past shared
// memory or an image whose offset planes hold 2^31 values or more.
extern "C" int deform_windowed_f32(const float* feat, const float* off, const float* aff,
                                   float* out, int B, int H, int W, int r, int R,
                                   void* stream) {
  if (R < 0 || R > MAX_R || r < 0) return (int)cudaErrorInvalidValue;
  const long long k2 = (2LL * r + 1) * (2LL * r + 1);
  if (2LL * k2 * H * W >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)smem_floats(R + 1 + r);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  // 16-byte copies of the plane where every staged row starts 16-byte aligned
  const bool vec = W % 4 == 0 && aligned16(feat);
  auto kernel = vec ? deform_windowed_kernel<true> : deform_windowed_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(feat, off, aff, out, H, W, r, R);
  return (int)cudaGetLastError();
}

// K3-bf16: the encode_dep front, relu(conv1(relu(conv0(x)))), both Conv2d
// k3/s2/p1, on bf16 operands, conv1 on the bf16 tensor cores, rounding where
// the TPU kernel rounds:
//
//   x   (B, H, W) bf16 plane
//   w0  (16, 1, 3, 3), b0 (16) f32     rounded to bf16 here
//   w1  (C1, 16, 3, 3), b1 (C1) f32    rounded to bf16 here; C1 = 256 in the model
//   p0  = bf16(relu(conv0(x) + b0))     (16, H1, W1), kept on chip
//   out = bf16(relu(conv1(p0) + b1))    (B, Ho, Wo, C1) NHWC bf16
//
// each sum in f32, each rounding once, after its full sum, bias and ReLU.
//
// Replaces the TPU kernel nlspn_eccv20_tpu/ops/pallas/dep_encode_front.py:251
// _fwd_kernel at dt = bfloat16 (through _recompute_fwd :228; reached from
// _fwd_pallas :366). It forms conv1 as four signed-shift products of the
// 2x2-phase p0 (_sshift_matmul_sum :192) with f32 sums and rounds once; that
// de-interleave is a Mosaic device and is not carried over. The first form
// (dep_encode_front.cu at a bf16 element type) ran conv1 as f32 FMAs on
// widened operands, four 64-channel groups a tile each recomputing conv0:
// 171 us at b=12 of 228x304, 19x its bound and slower than cuDNN's bf16 pair.
//
// Bound on the card: bytes. At b=12 of 228x304 (C1 = 256) the bf16 output is
// 26.6 MB and the plane 1.7 MB: 8.4 us at 3.35 TB/s, against conv1's 3.8
// GFLOP (3.9 us on the bf16 tensor cores, 57 us on the FP32 cores) and
// conv0's 0.1. The design:
//  - conv1 is an implicit GEMM on bf16 wgmma (wgmma_bf16.cuh) with f32
//    accumulators: M = a tile's 4 x 16 output pixels (a warp an output row),
//    N = the C1 channels, the reduction nine k-steps, one a tap, each over
//    conv0's 16 channels. A of tap (ty, tx) is p0 at (2 oy - 1 + ty, 2 ox - 1
//    + tx), read by ldmatrix from p0 staged as raw bf16, one 48-byte row of
//    16 channels a position, each p0 row's even columns before its odd ones:
//    a tap's eight ldmatrix rows are then consecutive positions, 48 bytes
//    apart, in eight distinct 16-byte bank groups. B is w1 rounded to bf16
//    and laid out once a call by prep_front_w1_kernel as the K-major core
//    matrices of nine taps x 2NW columns, which each CTA copies into its
//    shared memory once.
//  - conv0 once a tile, for all C1 channels: the tile's 9 x 33 p0 positions
//    (its one-position halo; zero where conv1's padding lies) from the
//    plane's 19 x 67 tile in shared memory, f32 FMAs in the first form's
//    order (the bias, then taps 0-8), rounded to bf16. A thread takes one
//    quad of conv0's channels, its 36 weights in registers, at every 64th
//    position (not reading the weights from shared memory at each
//    position).
//  - The CTA is persistent, one an SM, with four warpgroups in two teams of
//    two. A team walks its own tiles (named barriers); its two warpgroups
//    share the tile's p0 and split N, NW columns each (up to 128: 64
//    accumulators a thread). The weights come into shared memory once an
//    SM; the next tile's plane is loaded into registers during a tile's
//    epilogue.
//  - The stores set the time. The accumulators, with the bias, ReLU and
//    rounding, go to a staging tile in shared memory ([pixel][channel] with
//    a 16-byte pad a pixel: a fragment's words in distinct banks), from
//    which 64 threads each hand one pixel's channels (512 bytes at C1 = 256)
//    to the bulk copy engine (cp.async.bulk): the team goes on to the next
//    tile's conv0 and products while the copies write, and waits for them
//    to have read the staging tile only before its next epilogue. Where C1
//    % 8 != 0 the threads store the channels one by one.
//  - Any H, W and C1: out-of-range positions read conv1's zero padding,
//    channels past C1 are masked, and C1 above 256 runs in passes of 256
//    channels (gridDim.y).
// No split of the reduction and no atomics: two runs give the same bits. The
// tensor cores sum in another order than the plain version
// (dep_encode_front_plain_bf16), so a few outputs in a thousand round to the
// neighbouring bf16 value.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "card.cuh"
#include "cp_async.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int M = 16;                      // conv0's channels: conv1's k-step
constexpr int TOH = 4, TOW = 16;           // output tile: one M-tile of 64 pixels
constexpr int YR = 2 * TOH + 1;            // p0 rows under a tile (9)
constexpr int YC = 2 * TOW + 1;            // p0 columns (33)
constexpr int YE = TOW + 1;                // of them even (17), staged first
constexpr int PP = 24;                     // bf16 a staged p0 position: 48 bytes
constexpr int XR = 2 * YR + 1;             // plane rows under a tile (19)
constexpr int XC = 2 * YC + 1;             // plane columns (67)
constexpr int XP = XC + 1;                 // plane row pitch, floats
constexpr int TEAM = 256;                  // threads a team: two warpgroups
constexpr int TEAMS = 2;
constexpr int NT = TEAMS * TEAM;
constexpr int NPL = (XR * XC + TEAM - 1) / TEAM;   // plane values a thread prefetches
constexpr int P0_BYTES = YR * YC * PP * 2;         // 14,256
constexpr int PLANE_BYTES = XR * XP * 4;           // 5,168
constexpr int NW_MAX = 128;                        // columns a warpgroup
static_assert(P0_BYTES % 16 == 0 && PLANE_BYTES % 16 == 0, "16-byte aligned regions");

// bytes of one pass's B (nine taps x 16 k x 2NW n), of a staged output pixel
// (2NW channels and a 16-byte pad), of a team's region (p0, the plane, the
// staging tile), and of the CTA's shared memory
__host__ __device__ constexpr int w_bytes(int nw) { return 9 * M * 2 * nw * 2; }
__host__ __device__ constexpr int stg_pitch(int nw) { return 4 * nw + 16; }
__host__ __device__ constexpr int team_bytes(int nw) {
  return P0_BYTES + PLANE_BYTES + 64 * stg_pitch(nw);
}
__host__ __device__ constexpr int smem_bytes(int nw) {
  return w_bytes(nw) + TEAMS * team_bytes(nw) + 2 * nw * 4 + (9 * M + M) * 4;
}

__device__ __forceinline__ float rnd_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the named barrier of team t (barrier 0 is __syncthreads'), and barrier 3,
// at which team 1 waits for team 0's first epilogue
__device__ __forceinline__ void team_sync(int t) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(t + 1), "n"(TEAM) : "memory");
}
__device__ __forceinline__ void stagger_wait() {
  asm volatile("bar.sync 3, %0;\n" :: "n"(NT) : "memory");
}
__device__ __forceinline__ void stagger_release() {
  asm volatile("bar.arrive 3, %0;\n" :: "n"(NT) : "memory");
}

// The bf16 offset of column n, channel k of a tap's B: K-major core
// matrices without swizzle (8 n x 8 k, 128 bytes apart along k, 256 along n).
__host__ __device__ constexpr int kmajor(int n, int k) {
  return (n >> 3) * 128 + (k >> 3) * 64 + (n & 7) * 8 + (k & 7);
}

// wp[pass][tap][kmajor(n, k)] = w1[2NW pass + n][k][tap] rounded to bf16,
// zero past C1
__global__ void __launch_bounds__(256)
prep_front_w1_kernel(const float* __restrict__ w1, __nv_bfloat16* __restrict__ wp, int C1,
                     int nw, int passes) {
  const int n2 = 2 * nw, total = passes * 9 * M * n2;
  for (int i = blockIdx.x * 256 + threadIdx.x; i < total; i += gridDim.x * 256) {
    const int k = i % M, n = (i / M) % n2, tap = (i / (M * n2)) % 9, pass = i / (9 * M * n2);
    const int c = pass * n2 + n;
    wp[(long)(pass * 9 + tap) * M * n2 + kmajor(n, k)] =
        __float2bfloat16_rn(c < C1 ? __ldg(w1 + ((long)c * M + k) * 9 + tap) : 0.0f);
  }
}

template <int NW>
__global__ void __launch_bounds__(NT, 1)
dep_encode_front_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w0,
                             const float* __restrict__ b0, const __nv_bfloat16* __restrict__ w1p,
                             const float* __restrict__ b1, __nv_bfloat16* __restrict__ out,
                             int B, int H, int W, int C1, int tiles_x, int tiles_y, bool vec) {
  constexpr int PITCH = stg_pitch(NW), CPX = NW / 4;   // 16-byte pieces a staged pixel
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned short* ws = reinterpret_cast<const unsigned short*>(smem);   // [tap][kmajor]
  unsigned char* teams = smem + w_bytes(NW);
  float* b1s = reinterpret_cast<float*>(teams + TEAMS * team_bytes(NW));      // [2NW]
  float* w0s = b1s + 2 * NW;                                                  // [tap][m]
  float* b0s = w0s + 9 * M;

  const int tid = threadIdx.x, team = tid / TEAM, lt = tid % TEAM;
  const int wgl = lt >> 7, wr = (lt >> 5) & 3, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int c0 = blockIdx.y * 2 * NW;
  unsigned char* region = smem + w_bytes(NW) + team * team_bytes(NW);
  unsigned short* p0s = reinterpret_cast<unsigned short*>(region);   // [YR][even | odd][PP]
  float* xs = reinterpret_cast<float*>(region + P0_BYTES);           // [XR][XP]
  unsigned char* stg = region + P0_BYTES + PLANE_BYTES;              // [64][PITCH]

  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  const int Ho = (H1 + 1) / 2, Wo = (W1 + 1) / 2;
  const int per_img = tiles_x * tiles_y, tiles = B * per_img;
  const int slots = TEAMS * gridDim.x;
  const unsigned short* xr = reinterpret_cast<const unsigned short*>(x);

  {  // this pass's B, once (read by the first products, after the barrier below)
    const uint4* src = reinterpret_cast<const uint4*>(w1p + (long)blockIdx.y * w_bytes(NW) / 2);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < w_bytes(NW) / 16; i += NT) cpa::copy16(dst + i, src + i, true);
    cpa::commit();
  }
  for (int i = tid; i < 9 * M; i += NT) w0s[(i % 9) * M + i / 9] = rnd_bf16(__ldg(w0 + i));
  if (tid < M) b0s[tid] = rnd_bf16(__ldg(b0 + tid));
  for (int i = tid; i < 2 * NW; i += NT) b1s[i] = c0 + i < C1 ? rnd_bf16(__ldg(b1 + c0 + i)) : 0.0f;

  // tile t: image b, output rows oy0 .., columns ox0 ..
  auto origin = [&](int t, int& b, int& oy0, int& ox0) {
    b = t / per_img;
    const int r = t - b * per_img;
    oy0 = (r / tiles_x) * TOH;
    ox0 = (r % tiles_x) * TOW;
  };
  // the plane under tile t (rows 4 oy0 - 3 .., columns 4 ox0 - 3 ..; zero
  // outside) into registers, raw bf16
  uint32_t pv[NPL];
  auto load_plane = [&](int t) {
    int b, oy0, ox0;
    origin(t, b, oy0, ox0);
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const int e = lt + k * TEAM, r = e / XC, c = e % XC;
      const int yy = 4 * oy0 - 3 + r, xx = 4 * ox0 - 3 + c;
      pv[k] = e < XR * XC && yy >= 0 && yy < H && xx >= 0 && xx < W
                  ? (uint32_t)__ldg(xr + ((long)b * H + yy) * W + xx) : 0u;
    }
  };
  auto store_plane = [&]() {
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const int e = lt + k * TEAM;
      if (e < XR * XC) xs[(e / XC) * XP + e % XC] = __uint_as_float(pv[k] << 16);
    }
  };
  // p0 of tile t's 9 x 33 positions: conv0 from the staged plane, bias,
  // ReLU, bf16; zero outside the H1 x W1 grid (conv1's padding). A thread
  // takes channel quad lt % 4 (its weights in registers) of every 64th
  // position.
  auto conv0 = [&](int t) {
    int b, oy0, ox0;
    origin(t, b, oy0, ox0);
    const int q = lt & 3;
    float4 wq[9];
#pragma unroll
    for (int tp = 0; tp < 9; ++tp) wq[tp] = reinterpret_cast<const float4*>(w0s + tp * M)[q];
    const float4 bq = reinterpret_cast<const float4*>(b0s)[q];
    for (int pos = lt >> 2; pos < YR * YC; pos += TEAM / 4) {
      const int r = pos / YC, u = pos % YC;
      const int Y1 = 2 * oy0 - 1 + r, X1 = 2 * ox0 - 1 + u;
      uint2 v = make_uint2(0u, 0u);
      if (Y1 >= 0 && Y1 < H1 && X1 >= 0 && X1 < W1) {
        float s0 = bq.x, s1 = bq.y, s2 = bq.z, s3 = bq.w;
#pragma unroll
        for (int tp = 0; tp < 9; ++tp) {
          const float xv = xs[(2 * r + tp / 3) * XP + 2 * u + tp % 3];
          s0 = fmaf(wq[tp].x, xv, s0);
          s1 = fmaf(wq[tp].y, xv, s1);
          s2 = fmaf(wq[tp].z, xv, s2);
          s3 = fmaf(wq[tp].w, xv, s3);
        }
        v = make_uint2(pack_bf16(fmaxf(s0, 0.0f), fmaxf(s1, 0.0f)),
                       pack_bf16(fmaxf(s2, 0.0f), fmaxf(s3, 0.0f)));
      }
      *reinterpret_cast<uint2*>(p0s + (r * YC + ((u & 1) ? YE + (u >> 1) : (u >> 1))) * PP +
                                4 * q) = v;
    }
  };

  int t = team * gridDim.x + blockIdx.x;
  if (t < tiles) load_plane(t);
  __syncthreads();   // w0s, b0s, b1s
  if (t < tiles) {
    store_plane();
    team_sync(team);
    conv0(t);
  }
  cpa::wait<0>();
  fence_async_smem();
  __syncthreads();   // B and the first p0 tiles
  // Team 1 starts its products once team 0 has its first tile's outputs in
  // its staging tile: the teams then take the tensor cores and the stores
  // in turns, not together (started together, they stayed in step).
  const bool stagger = gridDim.x + blockIdx.x < tiles;   // team 1 has a tile
  if (team == 1 && stagger) stagger_wait();
  bool first = team == 0 && stagger;

  // this lane's ldmatrix row: M-tile row i of its warp (output pixel (oy0 +
  // wr, ox0 + i)), channels koff on; a tap's position in the staged p0
  const int i = (lane & 7) + 8 * ((lane >> 3) & 1), koff = 8 * (lane >> 4);
  const unsigned short* wbase = ws + wgl * NW * M;
  for (; t < tiles; t += slots) {
    int b, oy0, ox0;
    origin(t, b, oy0, ox0);
    float acc[NW / 2];
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) acc[e] = 0.0f;
    hold(acc);
    uint32_t a[2][4];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int f = tap & 1, ty = tap / 3, tx = tap % 3;
      const int col = tx == 1 ? YE + i : i + (tx >> 1);
      if (tap >= 2) {   // the group that read buffer f
        wgmma_wait<1>();
        hold(a[f]);
      }
      ldmatrix_x4(a[f], p0s + ((2 * wr + ty) * YC + col) * PP + koff);
      wgmma_fence();
      wgmma_bf16<NW>(acc, a[f], kmajor_desc_b16(wbase + tap * M * 2 * NW, 128, 256));
      wgmma_commit();
    }
    wgmma_wait<0>();
    hold(acc);
    hold(a[0]);
    hold(a[1]);
    const int tn = t + slots;
    if (tn < tiles) load_plane(tn);   // in flight through the epilogue
    // the last tile's bulk stores have read the staging tile, and both
    // warpgroups' reads of p0 are done
    if (vec && lt < 64) cpa::bulk_wait_read();
    team_sync(team);

    // acc[4j + 2h + e]: pixel 16 wr + gid + 8h of the tile, channel
    // wgl NW + 8j + 2 tig + e of the pass
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned char* row = stg + (16 * wr + gid + 8 * h) * PITCH;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int col = wgl * NW + 8 * j + 2 * tig;
        const float2 bias = *reinterpret_cast<const float2*>(b1s + col);
        *reinterpret_cast<uint32_t*>(row + 2 * col) =
            pack_bf16(fmaxf(acc[4 * j + 2 * h] + bias.x, 0.0f),
                      fmaxf(acc[4 * j + 2 * h + 1] + bias.y, 0.0f));
      }
    }
    if (vec) fence_async_smem();   // the staging tile, to the bulk copies
    team_sync(team);
    if (first) {
      stagger_release();
      first = false;
    }
    if (vec) {
      // thread lt < 64: pixel lt's channels of the pass, one bulk copy (the
      // copy engine writes them while the team goes on to the next tile)
      const int oy = oy0 + lt / TOW, ox = ox0 + lt % TOW;
      if (lt < 64 && oy < Ho && ox < Wo) {
        const int nc = C1 - c0 < 2 * NW ? C1 - c0 : 2 * NW;
        cpa::bulk_store(out + (((long)b * Ho + oy) * Wo + ox) * C1 + c0, stg + lt * PITCH,
                        2 * nc);
      }
      cpa::bulk_commit();
    } else {
      for (int ci = lt; ci < 64 * CPX; ci += TEAM) {
        const int pr = ci / CPX, q = ci % CPX;
        const int oy = oy0 + pr / TOW, ox = ox0 + pr % TOW, ch = c0 + 8 * q;
        if (oy >= Ho || ox >= Wo || ch >= C1) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(stg + pr * PITCH + 16 * q);
        const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&v);
        __nv_bfloat16* dst = out + (((long)b * Ho + oy) * Wo + ox) * C1 + ch;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (ch + e < C1) dst[e] = hv[e];
      }
    }
    if (tn < tiles) {
      store_plane();
      team_sync(team);
      conv0(tn);
      team_sync(team);
    }
  }
  if (vec && lt < 64) cpa::bulk_wait();
}

struct Plan {
  int tiles_y, tiles_x, nw, passes, grid_x, threads, smem;
};

// The launch: 4 x 16 output tiles; NW, each warpgroup's columns, the least
// of 16, 32, 64, 128 that covers half of C1, and passes of 2NW channels;
// one CTA an SM for each pass (two teams a CTA), fewer where the tiles are
// fewer.
Plan plan(int B, int H, int W, int C1, int sms) {
  Plan p;
  const int Ho = ((H + 1) / 2 + 1) / 2, Wo = ((W + 1) / 2 + 1) / 2;
  p.tiles_y = (Ho + TOH - 1) / TOH;
  p.tiles_x = (Wo + TOW - 1) / TOW;
  p.nw = 16;
  while (p.nw < NW_MAX && 2 * p.nw < C1) p.nw *= 2;
  p.passes = (C1 + 2 * p.nw - 1) / (2 * p.nw);
  const long tiles = (long)B * p.tiles_y * p.tiles_x;
  const int per_pass = sms / p.passes > 1 ? sms / p.passes : 1;
  p.grid_x = tiles < per_pass ? (int)tiles : per_pass;
  p.threads = NT;
  p.smem = smem_bytes(p.nw);
  return p;
}

long long scratch_bytes(int C1) {
  const Plan p = plan(1, 1, 1, C1, 1);
  return (long long)p.passes * w_bytes(p.nw);
}

template <int NW>
cudaError_t launch(const Plan& p, const __nv_bfloat16* x, const float* w0, const float* b0,
                   const __nv_bfloat16* w1p, const float* b1, __nv_bfloat16* out, int B, int H,
                   int W, int C1, bool vec, cudaStream_t s) {
  auto kernel = dep_encode_front_bf16_kernel<NW>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.grid_x, p.passes), NT, p.smem, s>>>(x, w0, b0, w1p, b1, out, B, H, W, C1,
                                                      p.tiles_x, p.tiles_y, vec);
  return cudaSuccess;
}

}  // namespace

// K3-bf16's launch plan on a card with sms SMs, as dep_encode_front_bf16
// takes it: out[0..6] = tile rows, tile cols (4 x 16 output pixels), NW (a
// warpgroup's columns), passes of 2NW channels, CTAs a pass, threads a CTA,
// bytes of dynamic shared memory. Returns 0.
extern "C" int dep_encode_front_bf16_plan(int B, int H, int W, int C1, int sms, int* out) {
  const Plan p = plan(B, H, W, C1, sms);
  const int v[7] = {p.tiles_y, p.tiles_x, p.nw, p.passes, p.grid_x, p.threads, p.smem};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// Bytes of scratch dep_encode_front_bf16 needs: w1 as the B of every pass.
extern "C" long long dep_encode_front_bf16_scratch_bytes(int C1) { return scratch_bytes(C1); }

// x (B, H, W) bf16; w0 (16, 1, 3, 3), b0 (16), w1 (C1, 16, 3, 3), b1 (C1)
// f32; out (B, Ho, Wo, C1) bf16 NHWC; scratch 16-byte aligned, of
// dep_encode_front_bf16_scratch_bytes. Returns cudaGetLastError() after the
// last launch (cudaErrorInvalidValue, with no launch, for an empty plane or
// C1 < 1).
extern "C" int dep_encode_front_bf16(const __nv_bfloat16* x, const float* w0, const float* b0,
                                     const float* w1, const float* b1, __nv_bfloat16* out,
                                     void* scratch, int B, int H, int W, int C1, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C1 < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int sms = 0;
  cudaError_t err = card_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const Plan p = plan(B, H, W, C1, sms);
  __nv_bfloat16* w1p = reinterpret_cast<__nv_bfloat16*>(scratch);
  const int total = p.passes * 9 * M * 2 * p.nw;
  prep_front_w1_kernel<<<(total + 255) / 256, 256, 0, s>>>(w1, w1p, C1, p.nw, p.passes);
  const bool vec = C1 % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  switch (p.nw) {
    case 16: err = launch<16>(p, x, w0, b0, w1p, b1, out, B, H, W, C1, vec, s); break;
    case 32: err = launch<32>(p, x, w0, b0, w1p, b1, out, B, H, W, C1, vec, s); break;
    case 64: err = launch<64>(p, x, w0, b0, w1p, b1, out, B, H, W, C1, vec, s); break;
    default: err = launch<128>(p, x, w0, b0, w1p, b1, out, B, H, W, C1, vec, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

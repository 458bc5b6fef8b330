// K9b-bf16: the backward of K9-bf16 (small_conv3x3_bf16.cu), rounding where
// the TPU kernel rounds. Given g = dL/d(out) (B, K, H, W):
//
//   dx_c[y][x]       = bf16( sum_k sum_{ty,tx} w[k][c][t] g_k[y-ty+1][x-tx+1] )
//   dW[k][c][ty][tx] = sum_{b,y,x} g_k[y][x] x_c[y+ty-1][x+tx-1]     f32
//   db[k]            = sum_{b,y,x} g_k[y][x]                         f32
//
// with g and the weights rounded to bf16 first (g arrives bf16), x bf16, g
// and x zero outside the image. dx is split into dxa and dxb (bf16), dW
// and db are f32, as _bwd_pallas returns them.
//
// Replaces the TPU kernel small_conv3x3._bwd_kernel at dt = bfloat16
// (nlspn_eccv20_tpu/ops/pallas/small_conv3x3.py, reached from _bwd_pallas):
// it shifts the rounded g (exact), sums its products with the rounded
// weights in f32 and rounds dx once; dW and db are f32 sums of products of
// bf16 values, which are exact.
//
// The products are K9b's (small_conv3x3_bwd.cu), with the mirrored-tap
// im2col G[p][(tap, k)] = g_k[y-ty+1][x-tx+1]:
//   dx = G . Wm      (pixels x 9K) . (9K x C),  Wm[(tap, k)][c] = w[k][c][tap]
//   dW = G^T . X     (9K x pixels) . (pixels x C)
// Row (tap, k) of the 9K side is tap * K + k, padded to a multiple of 16.
//
// Bound on the card: bytes. At NYU b=12 (228x304, C = 256, K = 10) it
// reads x and g and writes dx in bf16, 0.87 GB: 259 us of HBM; its 76.65
// GFLOP are 77 us on the bf16 tensor cores (wgmma_bf16.cuh). Both passes
// walk 2 x 64 pixel tiles (a channel's 128 bytes a tile row: runs of 64
// bytes read x at 2.25 TB/s on the card, of 128 at 2.8) with 256 threads,
// two warpgroups: in dx a warpgroup a tile row, in dW 64 rows of the 9K
// side. g comes in by the tensor memory accelerator (a tensor map a call,
// one copy a tile: its K planes, rows y0 - 1 .. y0 + 3, columns x0 - 8 ..
// x0 + 79), into a ring of stages up to three tiles ahead, each completing
// on an mbarrier. A tensor copy cannot start at an odd column, so the
// threads copy each stage's columns shifted by one either way (shift_g);
// then every (tap, k) row of G is eight pixels at a 16-byte boundary, and
// ldmatrix (transposed for dx) reads A straight from the stage or the
// shifted copies, one instruction a k-step a warp, each lane's row at its
// (tap, k) offset.
//   0. prep_weights_kernel rounds w to bf16 once a call, in the K-major
//      core-matrix order dx reads (per chunk of NC channels). Where W % 8 !=
//      0 (57x75, say) the tensor maps cannot stride the rows, so
//      pad_rows_kernel first copies x and g into rows of a multiple of 8
//      columns, zero past W (4.7 MB at b=2 of 57x75); x also where dW's
//      blocks of 64 channels would straddle xa and xb.
//   1. dx_kernel: persistent blocks, each owning NC = 128 channels (64 where
//      two such blocks would not fit an SM), their weights brought in by one
//      bulk copy. A tile: M = 64 pixels a warpgroup (a warp 16), N = NC, two
//      k-steps in flight. dx is rounded to bf16 into a staging tile in
//      shared memory (stmatrix, transposed: a channel's pixels a row; it
//      takes the shifted copies' place once the products have read them)
//      and written by whole tile rows, 16 bytes a thread (4 where W is not a
//      multiple of 8).
//   2. wgrad_kernel: split-K over pixel slices, block = (128 rows of the 9K
//      side, 64 channels, slice s: tiles s, s + S, ...). x comes in with g,
//      by two tensor copies a tile (a tile row each) straight into the
//      layout of wgmma's B (K-major, each channel's 64 pixels one 128-byte
//      row in the 128-byte swizzle). A tile's eight k-steps (16 pixels
//      each) run four in flight into fresh registers, added rounded to
//      nearest to the slice's sums (the tensor core's f32 sums truncate).
//      db comes from the staged g in the same pass (the first block column),
//      every thread summing its own 8-column pieces. Each block writes its
//      slice's sums, (tap, k) row by row.
//   3. reduce_slices_kernel: the slices added in a fixed order, into dW's
//      (K, C, 3, 3) order. No atomics: two runs give the same bits.
// Where each dx block walks at most 8 tiles, dW runs on a second stream
// beside dx (forked and joined by events): at small shapes both passes are
// chains of latencies, and they overlap; at b=12 they contend for memory.
// The first form built A with two 16-bit loads a word, loaded odd
// and ragged rows two bytes at a time, laid out each dx block's weights
// itself, stored dx two bytes at a time and waited for each dW k-step
// before the next: 827.5 us at b=12 of 228x304, 100.7 at b=2 of 57x75 (K =
// 26), 1.47x slower than cuDNN's bf16 backward there. Staging x and g by
// cp.async instead of the tensor copies held the dW pass at the threads'
// issue of the copies (1.6 us a tile); db summed by one thread a row held
// the first block column back by 0.9 us a tile.

#include <algorithm>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "card.cuh"
#include "cp_async.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int CARD_SMEM = 233472;       // shared memory of an SM (228 KB)
constexpr int BLOCK_SMEM_MAX = 232448;  // that a block may use (227 KB)
constexpr int THREADS = 256;            // two warpgroups
// the pixel tile of both passes: rows of 64 pixels, 128 bytes of a channel
// (runs of 64 bytes read x at 2.25 TB/s, of 128 at 2.8)
constexpr int TH = 2, TW = 64;
// g staged by a tensor copy a tile: plane k, row i = image row y0 - 1 + i
// (i < 5; the last is not read), column j = image column x0 - 8 + j (j <
// 88). A plane is 5 x 88 bf16 (880 bytes, an odd number of 16-byte pieces
// mod 128 bytes: ldmatrix's eight rows of eight consecutive planes fall in
// distinct bank groups; with four rows or 80 columns they would not). The
// tensor copy cannot start at an odd column (its rows move in 16-byte
// pieces), so the columns shifted by u = -1 and +1 are copied by the
// threads (shift_g) into rows of 64 (plane 264, odd again).
constexpr int GR = TH + 3, GW = 88, GP = GR * GW;
constexpr int RPS = 64, PSS = 264;
constexpr int ZEROS = 144;              // bf16 of zeros that padding rows of the 9K side read
// bf16 a channel of dx's staging tile: TH x TW, padded so that stmatrix's
// eight channel rows fall in distinct bank groups
constexpr int OCP = TH * TW + 8;
constexpr int MAX_KSTEPS = 18;          // at K = 32
constexpr int MAX_SLICES = 64;
// a G row offset in the stage (u = 0) and not in the shifted copies
constexpr int IN_STAGE = 1 << 30;

// k-steps of 16 on the 9K side
__host__ __device__ constexpr int ksteps(int K) { return (9 * K + 15) / 16; }

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// bf16 of a stage of g (whole 128-byte lines, where the tensor copy
// writes); of the shifted copies and the zeros after them
__host__ __device__ constexpr int g_stage(int K) { return round_up(K * GP, 64); }
__host__ __device__ constexpr int g_shifted(int K) { return round_up(2 * K * PSS + ZEROS, 64); }

// Where row r = tap K + k of G starts (add the pixel's tile row times GW in
// the stage, RPS in a shifted copy, and its column in the tile): column
// shift u = 1 - tx, row 2 - ty of plane k, in the stage (u = 0, flagged
// IN_STAGE) or in shifted copy (u + 1) / 2; rows past 9K read the zeros
// after the copies.
__host__ __device__ inline int koff_of(int r, int K) {
  if (r >= 9 * K) return 2 * K * PSS;
  const int tap = r / K, k = r - tap * K, u = 1 - tap % 3;
  return u == 0 ? IN_STAGE | (k * GP + (2 - tap / 3) * GW + 8)
                : ((u + 1) / 2 * K + k) * PSS + (2 - tap / 3) * RPS;
}

// The tensor memory accelerator: a box of a tensor (its map made on the
// host, cuTensorMapEncodeTiled) copied into shared memory by one thread,
// completing on an mbarrier; parts of the box outside the tensor read zero.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(cpa::smem_u32(dst)), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(cpa::smem_u32(bar)) : "memory");
}

// The descriptor of a K-major B operand whose 8-row groups (N) are 1024
// bytes apart, each row 128 bytes of K in the 128-byte swizzle a tensor
// copy with CU_TENSOR_MAP_SWIZZLE_128B writes (p 1024-byte aligned but for
// the k-step's offset in the row).
__device__ __forceinline__ uint64_t sw128_desc_b16(const void* p) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((addr & 0x3ffff) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// The staged planes shifted by u = -1 and +1 columns: sh[(u + 1) / 2][k][row]
// [j] = g[row][x0 + j + u], rows 0 .. TH + 1, j < TW, 16 bytes a thread.
__device__ __forceinline__ void shift_g(const unsigned short* raw, unsigned short* sh, int K,
                                        int tid) {
  constexpr int PER = (TH + 2) * (TW / 8);
#pragma unroll 4
  for (int i = tid; i < 2 * K * PER; i += THREADS) {
    const int uk = i / PER, e = i - uk * PER, row = e / (TW / 8), m = e - row * (TW / 8);
    const int k = uk < K ? uk : uk - K;
    const int o = k * GP + row * GW + 8 + 8 * m;
    const uint4 a = *reinterpret_cast<const uint4*>(raw + o);
    uint4 v;
    if (uk >= K) {   // u = +1
      const uint32_t n = *reinterpret_cast<const uint32_t*>(raw + o + 8);
      v = make_uint4(__funnelshift_r(a.x, a.y, 16), __funnelshift_r(a.y, a.z, 16),
                     __funnelshift_r(a.z, a.w, 16), __funnelshift_r(a.w, n, 16));
    } else {         // u = -1
      const uint32_t p = *reinterpret_cast<const uint32_t*>(raw + o - 2);
      v = make_uint4(__funnelshift_r(p, a.x, 16), __funnelshift_r(a.x, a.y, 16),
                     __funnelshift_r(a.y, a.z, 16), __funnelshift_r(a.z, a.w, 16));
    }
    *reinterpret_cast<uint4*>(sh + uk * PSS + row * RPS + 8 * m) = v;
  }
}

// Four 8x8 matrices of 16-bit values into shared memory, transposed: lane L
// gives the address of row L % 8 of matrix L / 8 (16 bytes, 16-byte
// aligned), which receives column L % 8 of the matrix whose row gid thread
// (gid, tig) holds in r[i] (columns 2 tig and 2 tig + 1, the lower in the
// low half).
__device__ __forceinline__ void stmatrix_x4_trans(void* row, const uint32_t (&r)[4]) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :: "r"(s), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]) : "memory");
}

__device__ __forceinline__ void tile_origin(int t, int tiles_x, int per_image, int& b, int& y0,
                                            int& x0) {
  b = t / per_image;
  const int r = t - b * per_image;
  y0 = (r / tiles_x) * TH;
  x0 = (r % tiles_x) * TW;
}

// ---- 0. the weights once a call, and the padded rows ----

// wp[chunk][step][NC / 8][2][8][8]: (r = 16 step + 8 h + j, channel chunk NC
// + 8 n + i) = bf16(w[k][c][tap]), r = tap K + k, at (n 128 + h 64 + i 8 +
// j): each step's 16 x NC as the K-major core matrices dx_kernel reads, zero
// past 9K and C.
__global__ void __launch_bounds__(256)
prep_weights_kernel(const float* __restrict__ w, __nv_bfloat16* __restrict__ wp, int C, int K,
                    int nc, int nks, int chunks) {
  const int total = chunks * nks * 16 * nc;
  for (int i = blockIdx.x * 256 + threadIdx.x; i < total; i += gridDim.x * 256) {
    const int j = i & 7, ci = (i >> 3) & 7, h = (i >> 6) & 1, n = (i >> 7) % (nc / 8);
    const int s = (i / (16 * nc)) % nks, ch = i / (16 * nc * nks);
    const int r = 16 * s + 8 * h + j, c = ch * nc + 8 * n + ci;
    const int tap = r / K, k = r - tap * K;
    const float v = r < 9 * K && c < C ? __ldg(w + ((long)k * C + c) * 9 + tap) : 0.0f;
    wp[i] = __float2bfloat16_rn(v);
  }
}

// xp (B, Ca + Cb, H, P) = the concat of xa and xb and gp (B, K, H, P) = g,
// their rows zero past W (P, a multiple of 8, >= W); 16 bytes a thread
__global__ void __launch_bounds__(256)
pad_rows_kernel(const __nv_bfloat16* __restrict__ xa, const __nv_bfloat16* __restrict__ xb,
                const __nv_bfloat16* __restrict__ g, __nv_bfloat16* __restrict__ xp,
                __nv_bfloat16* __restrict__ gp, int B, int H, int W, int Ca, int Cb, int K,
                int P) {
  const int C = Ca + Cb, pieces = P / 8;
  const long nx = (long)B * C * H * pieces, total = nx + (long)B * K * H * pieces;
  const unsigned short* ua = reinterpret_cast<const unsigned short*>(xa);
  const unsigned short* ub = reinterpret_cast<const unsigned short*>(xb);
  const unsigned short* ug = reinterpret_cast<const unsigned short*>(g);
  for (long i = blockIdx.x * 256L + threadIdx.x; i < total; i += (long)gridDim.x * 256) {
    const bool isx = i < nx;
    const long e = isx ? i : i - nx;
    const long row = e / pieces;
    const int x = (int)(e % pieces) * 8;
    const unsigned short* src;
    if (isx) {
      const int y = (int)(row % H), c = (int)((row / H) % C);
      const long b = row / ((long)H * C);
      src = c < Ca ? ua + ((b * Ca + c) * H + y) * W : ub + ((b * Cb + c - Ca) * H + y) * W;
    } else {
      src = ug + row * W;
    }
    src += x;
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = (x + 2 * q < W ? (uint32_t)__ldg(src + 2 * q) : 0u) |
             (x + 2 * q + 1 < W ? (uint32_t)__ldg(src + 2 * q + 1) << 16 : 0u);
    *reinterpret_cast<uint4*>((isx ? xp : gp) + row * P + x) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// ---- 1. dx ----

// bytes of dynamic shared memory: 1024 to align the base, the chunk's
// weights, g's stages, g's shifted copies or (once the products have read
// them) dx's staging tile, the rows' offsets
__host__ __device__ constexpr int dx_smem(int nc, int K, int S) {
  return 1024 + (ksteps(K) * 16 * nc + S * g_stage(K) + imax(g_shifted(K), nc * OCP)) * 2 +
         ksteps(K) * 16 * 4;
}


// gmap: g (B, K, H, P) bf16, P % 8 == 0, box GW x GR x K; wp from
// prep_weights_kernel; dx rows W apart (16-byte stores where vec). S stages
// of g: tile t + (S - 1) step is copied while tile t is worked on.
template <int NC, int S>
__global__ void __launch_bounds__(THREADS, 2)
dx_kernel(const __grid_constant__ CUtensorMap gmap, const __nv_bfloat16* __restrict__ wp,
          __nv_bfloat16* __restrict__ dxa, __nv_bfloat16* __restrict__ dxb, int B, int H, int W,
          int Ca, int Cb, int K, bool vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ uint64_t wbar;                 // the weights have landed
  __shared__ uint64_t gbar[S];              // a stage of g has landed
  unsigned char* smem = smem_raw + ((1024 - cpa::smem_u32(smem_raw) % 1024) % 1024);
  const int nks = ksteps(K);
  // Wm rounded to bf16, [step][NC / 8][2][8][8]: a k-step's 16 x NC as
  // K-major core matrices, 128 bytes apart along K, 256 along N
  unsigned short* wm = reinterpret_cast<unsigned short*>(smem);
  unsigned short* stages = wm + nks * 16 * NC;     // [S][g_stage(K)]
  unsigned short* sh = stages + S * g_stage(K);    // [2][K][PSS], then ZEROS
  unsigned short* os = sh;                         // [NC][OCP]: dx's staging tile, in place of sh
  int* koff = reinterpret_cast<int*>(sh + imax(g_shifted(K), NC * OCP));   // [16 nks]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wc = warp & 3;   // the warp's tile row and 16 columns
  const int C = Ca + Cb, c0 = blockIdx.x * NC;
  const int tiles_x = (W + TW - 1) / TW, per_image = tiles_x * ((H + TH - 1) / TH);
  const int tiles = B * per_image;
  const long plane = (long)H * W;

  if (tid == 0) {
    cpa::mbar_init(&wbar, 1);
    for (int i = 0; i < S; ++i) cpa::mbar_init(&gbar[i], 1);
  }
  for (int i = tid; i < ZEROS / 2; i += THREADS)
    reinterpret_cast<uint32_t*>(sh + 2 * K * PSS)[i] = 0u;
  for (int r = tid; r < 16 * nks; r += THREADS) koff[r] = koff_of(r, K);
  __syncthreads();

  const int step = gridDim.y;
  // g of tile t into stage buf, by one thread
  auto stage = [&](int t, int buf) {
    if (t < tiles) {
      int b, y0, x0;
      tile_origin(t, tiles_x, per_image, b, y0, x0);
      cpa::mbar_arrive_expect_tx(&gbar[buf], K * GP * 2);
      tma_load_4d(stages + buf * g_stage(K), &gmap, x0 - 8, y0 - 1, 0, b, &gbar[buf]);
    }
  };
  if (tid == 0) {
    const unsigned bytes = nks * 16 * NC * 2;
    cpa::mbar_arrive_expect_tx(&wbar, bytes);
    cpa::bulk_load(wm, wp + (size_t)blockIdx.x * nks * 16 * NC, bytes, &wbar);
    for (int i = 0; i < S - 1; ++i) stage(blockIdx.y + i * step, i);
  }

  // this lane's ldmatrix row of a k-step: (tap, k) row 8 (lane / 16) + lane
  // % 8 at pixel column 16 wc + 8 ((lane / 8) % 2) of tile row wg
  const int pcol = 16 * wc + 8 * ((lane >> 3) & 1);
  const int pix_st = wg * GW + pcol, pix_sh = wg * RPS + pcol;
  const int* kl = koff + 8 * (lane >> 4) + (lane & 7);
  // this lane's stmatrix row: channel 8 (2 q + (lane / 16)) + lane % 8 of
  // its fragment quad q, at the same pixels
  unsigned short* orow = os + (8 * (lane >> 4) + (lane & 7)) * OCP + wg * TW + pcol;

  cpa::mbar_wait(&wbar, 0);
  int buf = 0;
  for (int t = blockIdx.y, n = 0; t < tiles; t += step, ++n, buf = buf == S - 1 ? 0 : buf + 1) {
    int b, y0, x0;
    tile_origin(t, tiles_x, per_image, b, y0, x0);
    cpa::mbar_wait(&gbar[buf], (n / S) & 1);
    __syncthreads();   // tile t - step is done with its stage and the copies
    if (tid == 0) stage(t + (S - 1) * step, buf == 0 ? S - 1 : buf - 1);
    const unsigned short* raw = stages + buf * g_stage(K);
    shift_g(raw, sh, K, tid);
    __syncthreads();   // the shifted copies are there
    auto arow = [&](int s) {
      const int o = kl[16 * s];
      return o & IN_STAGE ? raw + (o & ~IN_STAGE) + pix_st : sh + o + pix_sh;
    };

    float acc[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] = 0.0f;
    // two fragment buffers: step s + 2 overwrites step s's once its group is done
    uint32_t a[2][4];
#pragma unroll
    for (int s = 0; s < MAX_KSTEPS; ++s) {
      if (s >= nks) break;
      if (s >= 2) {
        wgmma_wait<1>();
        hold(a[s & 1]);
      }
      ldmatrix_x4_trans(a[s & 1], arow(s));
      wgmma_fence();
      wgmma_bf16<NC>(acc, a[s & 1], kmajor_desc_b16(wm + s * 16 * NC, 128, 256));
      wgmma_commit();
    }
    wgmma_wait<0>();
    hold(acc);
    hold(a[0]);
    hold(a[1]);

    __syncthreads();   // every product has read the shifted copies
    // acc[4j + 2h + e]: pixel (wg, 16 wc + gid + 8h), channel c0 + 8j + 2 tig
    // + e; the warp's 16 pixels of each channel into the staging tile
#pragma unroll
    for (int q = 0; q < NC / 16; ++q) {
      uint32_t r[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = 4 * (2 * q + (m >> 1)) + 2 * (m & 1);
        r[m] = pack_bf16(acc[i], acc[i + 1]);
      }
      stmatrix_x4_trans(orow + 16 * q * OCP, r);
    }
    __syncthreads();   // the staging tile is whole
    // out by whole tile rows: 16 bytes a thread, or, where W % 8 != 0, 4
    // (2 at a row's ends where the row starts or ends inside a word)
    auto dst = [&](int c) {
      return reinterpret_cast<unsigned short*>(c < Ca ? dxa + ((long)b * Ca + c) * plane
                                                      : dxb + ((long)b * Cb + c - Ca) * plane);
    };
    if (vec) {
      for (int i = tid; i < NC * TH * (TW / 8); i += THREADS) {
        const int m = i & 7, row = (i >> 3) & 1, cl = i >> 4;
        const int c = c0 + cl, y = y0 + row, x = x0 + 8 * m;
        if (c < C && y < H && x < W)
          *reinterpret_cast<uint4*>(dst(c) + (long)y * W + x) =
              *reinterpret_cast<const uint4*>(os + cl * OCP + row * TW + 8 * m);
      }
    } else {   // a row's 4-byte words from its first even element on, the ends alone
      constexpr int PAIRS = TW / 2 + 1;
      for (int i = tid; i < NC * TH * PAIRS; i += THREADS) {
        const int q = i % PAIRS, seg = i / PAIRS, row = seg & 1, cl = seg >> 1;
        const int c = c0 + cl, y = y0 + row;
        if (c >= C || y >= H) continue;
        unsigned short* d = dst(c) + (long)y * W + x0;   // the row's first element
        const int n = min(TW, W - x0), lead = (int)(reinterpret_cast<uintptr_t>(d) / 2 & 1);
        const int e = 2 * q - lead;                        // this word's first element
        const unsigned short* o = os + cl * OCP + row * TW;
        if (e >= 0 && e + 1 < n)
          *reinterpret_cast<uint32_t*>(d + e) = (uint32_t)o[e] | (uint32_t)o[e + 1] << 16;
        else if (e + 1 == 0 || e + 1 == n)
          d[e + 1 == 0 ? 0 : e] = o[e + 1 == 0 ? 0 : e];
      }
    }
  }
}

// ---- 2. dW and db as per-slice partial sums ----
constexpr int WG_MR = 128;              // 9K rows a block: a warpgroup a 64
constexpr int WG_NC = 64;               // channels a block
constexpr int WG_XB = WG_NC * TH * TW;  // bf16 of a staged x tile

// bf16 of a stage of dW: the x tile, then g's (x 1024-byte aligned)
__host__ __device__ constexpr int wg_stage(int K) { return round_up(WG_XB + g_stage(K), 512); }

// bytes of dynamic shared memory: 1024 to align the base, the stages, g's
// shifted copies, db's partial sums
__host__ __device__ constexpr int wg_smem(int K, int S) {
  return 1024 + (S * wg_stage(K) + g_shifted(K)) * 2 + K * TH * (TW / 8) * 4;
}

// xmap (xa, Ca channels) and xbmap (xb, Cb), rows P apart (P % 8 == 0),
// boxes of 64 columns x 1 row x 64 channels in the 128-byte swizzle, Ca a
// multiple of 64; gmap as dx_kernel's. S stages of x and g: tile t + S - 1
// is copied while tile t is worked on.
template <int S>
__global__ void __launch_bounds__(THREADS, 2)
wgrad_kernel(const __grid_constant__ CUtensorMap xamap, const __grid_constant__ CUtensorMap xbmap,
             const __grid_constant__ CUtensorMap gmap, float* __restrict__ part, int B, int H,
             int W, int Ca, int Cb, int K, int cchunks) {
  extern __shared__ __align__(128) unsigned char wsm_raw[];
  __shared__ uint64_t bar[S];               // a stage of x and g has landed
  unsigned char* wsm = wsm_raw + ((1024 - cpa::smem_u32(wsm_raw) % 1024) % 1024);
  // a stage: x of a tile as the K-major B operand (N = channels, K =
  // pixels), tile row by tile row: [TH][64 channels][64 pixels], each
  // channel's row 128 bytes in the 128-byte swizzle; then g's stage
  unsigned short* stages = reinterpret_cast<unsigned short*>(wsm);  // [S][wg_stage(K)]
  unsigned short* sh = stages + S * wg_stage(K);                    // [2][K][PSS], ZEROS
  float* dbs = reinterpret_cast<float*>(sh + g_shifted(K));         // [K TH TW / 8]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int C = Ca + Cb;
  const int mc = blockIdx.x / cchunks, cc = blockIdx.x - mc * cchunks;
  const int m_wg = mc * WG_MR + 64 * (warp >> 2);   // this warpgroup's first 9K row
  const int m_w = m_wg + 16 * (warp & 3), c0 = cc * WG_NC;
  const int s = blockIdx.y, nslices = gridDim.y;
  const int tiles_x = (W + TW - 1) / TW, per_image = tiles_x * ((H + TH - 1) / TH);
  // slice s sums tiles s, s + nslices, ...: the slices, all on the card at
  // once, read neighbouring tiles at the same time
  const int tiles = B * per_image, n = (tiles - s + nslices - 1) / nslices;
  const bool with_db = blockIdx.x == 0;
  const bool live = m_wg < 9 * K;   // the warpgroup has rows of the 9K side
  const CUtensorMap* xmap = c0 < Ca ? &xamap : &xbmap;
  const int xc = c0 < Ca ? c0 : c0 - Ca;

  if (tid == 0)
    for (int i = 0; i < S; ++i) cpa::mbar_init(&bar[i], 1);
  for (int i = tid; i < ZEROS / 2; i += THREADS)
    reinterpret_cast<uint32_t*>(sh + 2 * K * PSS)[i] = 0u;
  __syncthreads();
  // this lane's ldmatrix row: (tap, k) row m_w + 8 ((lane / 8) % 2) + lane
  // % 8, pixels 8 (lane / 16) on of a k-step's 16; its rows GW or RPS apart
  const int ko = koff_of(m_w + 8 * ((lane >> 3) & 1) + (lane & 7), K);
  const bool in_stage = ko & IN_STAGE;
  const int apix = (ko & ~IN_STAGE) + 8 * (lane >> 4) + (in_stage ? WG_XB : 0);
  const int arp = in_stage ? GW : RPS;

  // tile i of the slice into stage buf, by one thread: x a tile row at a
  // time, then g
  auto stage = [&](int i, int buf) {
    if (i < n) {
      int b, y0, x0;
      tile_origin(s + i * nslices, tiles_x, per_image, b, y0, x0);
      unsigned short* st = stages + buf * wg_stage(K);
      cpa::mbar_arrive_expect_tx(&bar[buf], (WG_XB + K * GP) * 2);
      for (int r = 0; r < TH; ++r)
        tma_load_4d(st + r * WG_NC * TW, xmap, x0, y0 + r, xc, b, &bar[buf]);
      tma_load_4d(st + WG_XB, &gmap, x0 - 8, y0 - 1, 0, b, &bar[buf]);
    }
  };

  float total[WG_NC / 2];
#pragma unroll
  for (int i = 0; i < WG_NC / 2; ++i) total[i] = 0.0f;
  // db: thread j < K TH TW / 8 (and j - 256) sums the 8 columns of piece
  // (k, row, m) = (j / 16, (j / 8) % 2, j % 8) of every tile, in order
  float dbsum[2] = {0.0f, 0.0f};

  if (tid == 0)
    for (int i = 0; i < S - 1; ++i) stage(i, i);
  int buf = 0;
  for (int i = 0; i < n; ++i, buf = buf == S - 1 ? 0 : buf + 1) {
    cpa::mbar_wait(&bar[buf], (i / S) & 1);
    __syncthreads();   // tile i - 1 is done with its stage and the copies
    if (tid == 0) stage(i + S - 1, buf == 0 ? S - 1 : buf - 1);
    const unsigned short* st = stages + buf * wg_stage(K);
    shift_g(st + WG_XB, sh, K, tid);
    if (with_db) {   // g's rows 1 .. TH, columns 8 .. 71: the tile's pixels
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = tid + h * THREADS;
        if (j < K * TH * (TW / 8)) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              st + WG_XB + (j >> 4) * GP + ((j >> 3) % 2 + 1) * GW + 8 + 8 * (j & 7));
          const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dbsum[h] += __uint_as_float(w4[e] << 16);
            dbsum[h] += __uint_as_float(w4[e] & 0xffff0000u);
          }
        }
      }
    }
    __syncthreads();   // the shifted copies are there
    if (live) {
      const unsigned short* xb_s = st;
      const unsigned short* ar = (in_stage ? st : sh) + apix;
      float acc[WG_NC / 2];
#pragma unroll
      for (int i = 0; i < WG_NC / 2; ++i) acc[i] = 0.0f;
      // k-step q: pixels 16 (q % 4) .. + 15 of tile row q / 4; four in flight
      uint32_t a[4][4];
#pragma unroll
      for (int q = 0; q < TH * TW / 16; ++q) {
        if (q >= 4) {
          wgmma_wait<3>();
          hold(a[q & 3]);
        }
        ldmatrix_x4(a[q & 3], ar + (q >> 2) * arp + 16 * (q & 3));
        wgmma_fence();
        wgmma_bf16<WG_NC>(acc, a[q & 3],
                          sw128_desc_b16(xb_s + (q >> 2) * WG_NC * TW + 16 * (q & 3)));
        wgmma_commit();
      }
      wgmma_wait<0>();
      hold(acc);
#pragma unroll
      for (int q = 0; q < 4; ++q) hold(a[q]);
#pragma unroll
      for (int i = 0; i < WG_NC / 2; ++i) total[i] += acc[i];
    }
  }

  // the slice's sums, row (tap, k) of the 9K side by row: [9K][C], then db
  float* out = part + (long)s * (9L * K * C + K);
  // total[4j + 2h + e]: 9K row m_w + gid + 8h, channel c0 + 8j + 2 tig + e
  if (live) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m_w + gid + 8 * h;
      if (r >= 9 * K) continue;
#pragma unroll
      for (int j = 0; j < WG_NC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * j + 2 * tig + e;
          if (c < C) out[(long)r * C + c] = total[4 * j + 2 * h + e];
        }
    }
  }
  if (with_db) {
    for (int h = 0; h < 2; ++h)
      if (tid + h * THREADS < K * TH * (TW / 8)) dbs[tid + h * THREADS] = dbsum[h];
    __syncthreads();
    if (tid < K) {
      float v = dbs[tid * 16];
      for (int j = 1; j < 16; ++j) v += dbs[tid * 16 + j];
      out[9L * K * C + tid] = v;
    }
  }
}

// ---- 3. the slices added in a fixed order ----

// dwb = [dW (K, C, 9) | db (K)] = sum_s part[s] (each [9K][C] | db), for
// 32 elements a block: strand y adds slices y, y + 8, ... in order, then
// the eight strands are added in order (bwd::reduce_partials' order).
__global__ void __launch_bounds__(256)
reduce_slices_kernel(const float* __restrict__ part, int S, int K, int C, float* __restrict__ dwb) {
  __shared__ float strands[8][33];
  const long N = 9L * K * C + K;
  const long e = blockIdx.x * 32L + threadIdx.x;
  float v = 0.0f;
  if (e < N)
    for (int s = threadIdx.y; s < S; s += 8) v += __ldg(part + s * N + e);
  strands[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && e < N) {
    float t = strands[0][threadIdx.x];
    for (int y = 1; y < 8; ++y) t += strands[y][threadIdx.x];
    long o = e;   // db stays where it is
    if (e < 9L * K * C) {
      const int r = (int)(e / C), c = (int)(e - (long)r * C), tap = r / K, k = r - tap * K;
      o = ((long)k * C + c) * 9 + tap;
    }
    dwb[o] = t;
  }
}

// The launch geometry, mirrored by ops/kernels/small_conv3x3.py's bwd_plan_bf16.
struct Plan {
  int pitch, copied, nks, tiles_x, tiles_y;   // x and g read in rows of pitch bf16, copied?
  int dx_nc, dx_chunks, dx_blocks, dx_smem, dx_per_sm, dx_stages;  // grid (dx_chunks, dx_blocks)
  int mchunks, cchunks, slices, wg_smem, wg_per_sm, wg_stages;   // grid (mchunks cchunks, slices)
  int side;   // dW on a second stream beside dx
};

bool fits2(int smem) { return 2 * (smem + 1024) <= CARD_SMEM; }

// the most stages (4, 3, 2) with which two blocks fit an SM, else one
template <class F>
int stages_for(F smem_of) {
  for (int S = 4; S >= 2; --S)
    if (fits2(smem_of(S))) return S;
  for (int S = 4; S > 2; --S)
    if (smem_of(S) <= BLOCK_SMEM_MAX) return S;
  return 2;
}

Plan plan(int B, int H, int W, int Ca, int Cb, int K, int sms) {
  Plan p;
  const int C = Ca + Cb;
  p.pitch = (W + 7) / 8 * 8;
  // x and g are copied into rows of a multiple of 8 columns (the tensor
  // copies' strides are multiples of 16 bytes), x as one concat where
  // dW's blocks of 64 channels would straddle xa and xb
  p.copied = p.pitch != W || Ca == 0 || (Cb > 0 && Ca % WG_NC != 0);
  p.nks = ksteps(K);
  p.tiles_x = (W + TW - 1) / TW;
  p.tiles_y = (H + TH - 1) / TH;
  const long tiles = (long)B * p.tiles_x * p.tiles_y;
  // 128 channels a block where two blocks still fit an SM, else 64
  p.dx_nc = fits2(dx_smem(128, K, 2)) ? 128 : 64;
  p.dx_stages = stages_for([&](int S) { return dx_smem(p.dx_nc, K, S); });
  p.dx_smem = dx_smem(p.dx_nc, K, p.dx_stages);
  p.dx_per_sm = fits2(p.dx_smem) ? 2 : 1;
  p.dx_chunks = (C + p.dx_nc - 1) / p.dx_nc;
  p.dx_blocks = (int)std::max(1L, std::min(tiles, (long)p.dx_per_sm * sms / p.dx_chunks));
  p.mchunks = (9 * K + WG_MR - 1) / WG_MR;
  p.cchunks = (C + WG_NC - 1) / WG_NC;
  p.wg_stages = stages_for([&](int S) { return wg_smem(K, S); });
  p.wg_smem = wg_smem(K, p.wg_stages);
  p.wg_per_sm = fits2(p.wg_smem) ? 2 : 1;
  const long want = ((long)p.wg_per_sm * sms) / (p.mchunks * p.cchunks);
  p.slices = (int)std::max(1L, std::min({tiles, want, (long)MAX_SLICES}));
  // Where a dx block walks few tiles, the passes are chains of latencies
  // and overlap well (57x75: 52.8 -> 48.6 us); with many, they contend for
  // the memory (b=12 of 228x304: 420 -> 479 us).
  p.side = tiles <= 8L * p.dx_blocks;
  return p;
}

// Floats of each scratch region, each a multiple of 4 (16 bytes): the
// rounded weights, the copies of x and g, the slices' partial sums
struct Scratch {
  long weights, xp, gp, partials;
};

long round4(long n) { return (n + 3) / 4 * 4; }

Scratch scratch_of(const Plan& p, int B, int H, int C, int K) {
  Scratch s;
  s.weights = round4((long)p.dx_chunks * p.nks * 16 * p.dx_nc / 2);
  s.xp = p.copied ? round4(((long)B * C * H * p.pitch + 1) / 2) : 0;
  s.gp = p.copied ? round4(((long)B * K * H * p.pitch + 1) / 2) : 0;
  s.partials = round4((long)p.slices * (9L * K * C + K));
  return s;
}

// The SM count of the current device, asked of the card once a device and
// process (the plan needs it for the scratch and again for the launch).
cudaError_t sms_of_device(int* sms) {
  static int known[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && known[dev] > 0) {
    *sms = known[dev];
    return cudaSuccess;
  }
  err = card_sms(sms);
  if (err == cudaSuccess && dev >= 0 && dev < 64) known[dev] = *sms;
  return err;
}

// cuTensorMapEncodeTiled, through the runtime's entry-point query (no link
// to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) == cudaSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#endif
  }
  return fn;
}

// The map of a (B, N, H, P) bf16 tensor, boxes of bw columns x bh rows x bn
// of its N planes, as dims (P, H, N, B).
bool map_planes(CUtensorMap* map, const void* base, int B, int N, int H, int P, int bw, int bh,
                int bn, bool swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)P * 2, (cuuint64_t)H * P * 2,
                                 (cuuint64_t)N * H * P * 2};
  const cuuint32_t box[4] = {(cuuint32_t)bw, (cuuint32_t)bh, (cuuint32_t)bn, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC, int S>
cudaError_t launch_dx(const Plan& p, const CUtensorMap& gmap, const __nv_bfloat16* wp,
                      __nv_bfloat16* dxa, __nv_bfloat16* dxb, int B, int H, int W, int Ca,
                      int Cb, int K, bool vec, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      dx_kernel<NC, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.dx_smem);
  if (err != cudaSuccess) return err;
  dx_kernel<NC, S><<<dim3(p.dx_chunks, p.dx_blocks), THREADS, p.dx_smem, s>>>(
      gmap, wp, dxa, dxb, B, H, W, Ca, Cb, K, vec);
  return cudaSuccess;
}

template <int NC>
cudaError_t launch_dx_nc(const Plan& p, const CUtensorMap& gmap, const __nv_bfloat16* wp,
                         __nv_bfloat16* dxa, __nv_bfloat16* dxb, int B, int H, int W, int Ca,
                         int Cb, int K, bool vec, cudaStream_t s) {
  switch (p.dx_stages) {
    case 2: return launch_dx<NC, 2>(p, gmap, wp, dxa, dxb, B, H, W, Ca, Cb, K, vec, s);
    case 3: return launch_dx<NC, 3>(p, gmap, wp, dxa, dxb, B, H, W, Ca, Cb, K, vec, s);
    default: return launch_dx<NC, 4>(p, gmap, wp, dxa, dxb, B, H, W, Ca, Cb, K, vec, s);
  }
}

template <int S>
cudaError_t launch_wgrad(const Plan& p, const CUtensorMap& xamap, const CUtensorMap& xbmap,
                         const CUtensorMap& gmap, float* part, int B, int H, int W, int Ca,
                         int Cb, int K, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.wg_smem);
  if (err != cudaSuccess) return err;
  wgrad_kernel<S><<<dim3(p.mchunks * p.cchunks, p.slices), THREADS, p.wg_smem, s>>>(
      xamap, xbmap, gmap, part, B, H, W, Ca, Cb, K, p.cchunks);
  return cudaSuccess;
}

bool aligned(const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

// A second stream of the current device, and two events, made once a
// device and process: dW runs on it beside dx (the two passes share no
// output), forked from and joined back into the caller's stream by the
// events (which a CUDA graph's capture follows).
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};

cudaError_t side_of_device(Side* out) {
  static Side known[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidValue;
  Side& sd = known[dev];
  if (sd.stream == nullptr) {
    Side n;
    err = cudaStreamCreateWithFlags(&n.stream, cudaStreamNonBlocking);
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(&n.fork, cudaEventDisableTiming);
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(&n.join, cudaEventDisableTiming);
    if (err != cudaSuccess) return err;
    sd = n;
  }
  *out = sd;
  return cudaSuccess;
}

}  // namespace

// K9b-bf16's launch plan as small_conv3x3_bwd_bf16 takes it on the current
// device: out[0..17] = the pitch of the rows x and g are read in (W, or W
// rounded up to 8), whether they are copied first (into rows of that pitch,
// x as one concat), k-steps of 16 on the 9K side, tile columns, tile rows
// (2 x 64 pixels); dx: channels a block, channel chunks, persistent blocks a
// chunk, bytes of dynamic shared memory, blocks an SM, stages of g; dW:
// chunks of 128 rows of the 9K side, chunks of 64 channels, slices, bytes
// of dynamic shared memory, blocks an SM, stages of x and g; whether dW
// runs on a second stream beside dx. Returns 0, or the error
// (cudaErrorInvalidValue unless 1 <= K <= 32).
extern "C" int small_conv3x3_bwd_bf16_plan(int B, int H, int W, int Ca, int Cb, int K, int* out) {
  if (K < 1 || K > 32 || B < 1 || H < 1 || W < 1 || Ca < 0 || Cb < 0 || Ca + Cb < 1)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = sms_of_device(&sms);
  if (err != cudaSuccess) return (int)err;
  const Plan p = plan(B, H, W, Ca, Cb, K, sms);
  const int v[18] = {p.pitch, p.copied, p.nks, p.tiles_x, p.tiles_y, p.dx_nc, p.dx_chunks,
                     p.dx_blocks, p.dx_smem, p.dx_per_sm, p.dx_stages, p.mchunks, p.cchunks,
                     p.slices, p.wg_smem, p.wg_per_sm, p.wg_stages, p.side};
  for (int i = 0; i < 18; ++i) out[i] = v[i];
  return 0;
}

// Floats of scratch small_conv3x3_bwd_bf16 needs (-1 if the card cannot be
// asked for its SM count).
extern "C" long long small_conv3x3_bwd_bf16_scratch_floats(int B, int H, int W, int Ca,
                                                           int Cb, int K) {
  int sms = 0;
  if (sms_of_device(&sms) != cudaSuccess) return -1;
  const Plan p = plan(B, H, W, Ca, Cb, K, sms);
  const Scratch s = scratch_of(p, B, H, Ca + Cb, K);
  return s.weights + s.xp + s.gp + s.partials;
}

// g (B, K, H, W), xa (B, Ca, H, W), xb (B, Cb, H, W) bf16, 16-byte
// aligned; w (K, Ca + Cb, 3, 3) f32. Writes dxa and dxb (bf16, as xa and
// xb, 16-byte aligned) and dwb = [dW (K, Ca + Cb, 3, 3) | db (K)] (f32).
// Returns cudaGetLastError() after the last launch (cudaErrorInvalidValue,
// with no launch, unless 1 <= K <= 32, the tensors are aligned and the
// tensor maps can be made).
extern "C" int small_conv3x3_bwd_bf16(const __nv_bfloat16* g, const __nv_bfloat16* xa,
                                      const __nv_bfloat16* xb, const float* w,
                                      __nv_bfloat16* dxa, __nv_bfloat16* dxb, float* dwb,
                                      float* scratch, int B, int H, int W, int Ca, int Cb,
                                      int K, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K < 1 || K > 32 || B < 1 || H < 1 || W < 1 || Ca < 0 || Cb < 0 || Ca + Cb < 1 ||
      !aligned(g, 16) ||
      !aligned(xa, 16) || !aligned(xb, 16) || !aligned(dxa, 16) || !aligned(dxb, 16))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sms_of_device(&sms);
  if (err != cudaSuccess) return (int)err;
  const int C = Ca + Cb;
  const Plan p = plan(B, H, W, Ca, Cb, K, sms);
  if (p.dx_smem > BLOCK_SMEM_MAX || p.wg_smem > BLOCK_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const Scratch sc = scratch_of(p, B, H, C, K);
  __nv_bfloat16* wp = reinterpret_cast<__nv_bfloat16*>(scratch);
  float* part = scratch + sc.weights + sc.xp + sc.gp;

  const int nw = p.dx_chunks * p.nks * 16 * p.dx_nc;
  prep_weights_kernel<<<std::min((nw + 255) / 256, 1024), 256, 0, s>>>(w, wp, C, K, p.dx_nc,
                                                                       p.nks, p.dx_chunks);
  const __nv_bfloat16 *xr_a = xa, *xr_b = xb, *gr = g;
  int ca = Ca, cb = Cb;
  if (p.copied) {   // x and g into rows of a multiple of 8 columns, x as one concat
    __nv_bfloat16* xp = reinterpret_cast<__nv_bfloat16*>(scratch + sc.weights);
    __nv_bfloat16* gp = reinterpret_cast<__nv_bfloat16*>(scratch + sc.weights + sc.xp);
    const long pieces = (long)B * (C + K) * H * (p.pitch / 8);
    pad_rows_kernel<<<(int)std::min((pieces + 255) / 256, 65535L), 256, 0, s>>>(
        xa, xb, g, xp, gp, B, H, W, Ca, Cb, K, p.pitch);
    xr_a = xr_b = xp;
    gr = gp;
    ca = C;
    cb = 0;
  }
  CUtensorMap gmap, xamap, xbmap;
  if (!map_planes(&gmap, gr, B, K, H, p.pitch, GW, GR, K, false) ||
      !map_planes(&xamap, xr_a, B, ca, H, p.pitch, TW, 1, WG_NC, true) ||
      !map_planes(&xbmap, cb > 0 ? xr_b : xr_a, B, cb > 0 ? cb : ca, H, p.pitch, TW, 1, WG_NC,
                  true))
    return (int)cudaErrorInvalidValue;
  // dW (on the side stream beside dx, where the plan says so), then dx; the
  // reduction after both
  Side side;
  cudaStream_t ws = s;
  if (p.side) {
    err = side_of_device(&side);
    if (err == cudaSuccess) err = cudaEventRecord(side.fork, s);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(side.stream, side.fork, 0);
    if (err != cudaSuccess) return (int)err;
    ws = side.stream;
  }
  switch (p.wg_stages) {
    case 2: err = launch_wgrad<2>(p, xamap, xbmap, gmap, part, B, H, W, ca, cb, K, ws); break;
    case 3: err = launch_wgrad<3>(p, xamap, xbmap, gmap, part, B, H, W, ca, cb, K, ws); break;
    default: err = launch_wgrad<4>(p, xamap, xbmap, gmap, part, B, H, W, ca, cb, K, ws); break;
  }
  if (err == cudaSuccess && p.side) err = cudaEventRecord(side.join, side.stream);
  if (err != cudaSuccess) return (int)err;
  const bool vec = W % 8 == 0;   // dx rows start at 16-byte boundaries
  err = p.dx_nc == 128 ? launch_dx_nc<128>(p, gmap, wp, dxa, dxb, B, H, W, Ca, Cb, K, vec, s)
                       : launch_dx_nc<64>(p, gmap, wp, dxa, dxb, B, H, W, Ca, Cb, K, vec, s);
  if (err == cudaSuccess && p.side) err = cudaStreamWaitEvent(s, side.join, 0);
  if (err != cudaSuccess) return (int)err;
  const long n = 9L * K * C + K;
  reduce_slices_kernel<<<(int)((n + 31) / 32), dim3(32, 8), 0, s>>>(part, p.slices, K, C, dwb);
  return (int)cudaGetLastError();
}

// The 4x4 phase interleave as a product with one-hot expansions (K11d):
// for each image n and row phase a, one GEMM of depth 4 * 76 = 304,
//
//   out[n, c, 4i + a, x] = sum_b sum_j ph[n, (4a + b) * 8 + c, i, j] * E[b, j, x],
//
// for c < 8, i < 58, x < 304, with ph's 58x76 window in the first rows
// and columns of padded (hp, wp) planes and E (4, 76, 304) an input. With
// the one-hot E[b, j, 4j + b] = 1 the result is the interleave bit for bit:
// each sum has one term that is not zero.
//
// Replaces the TPU kernel k_matmul (devtools/microbench_asm.py, reached
// from run), which expands the lanes on the MXU (the four phases b of a
// row phase a times E_b, summed) and stores the rows strided by 4.
//
// Bound on the card: operations. In plain f32 FMAs the 4B products of
// (464 x 304) . (304 x 304) take 4.1 GFLOP at b=12, 61 us at 67 TFLOP/s,
// twice the copy that computes the same function with the one-hot E. So
// the products run on the tensor cores, in bf16 with f32 sums, without
// rounding the phases: an error-free split.
//
// * Each f32 value v is the exact sum v1 + v2 + v3 of three bf16 values
//   (8 + 8 + 8 significant bits): v1 is v with its low 16 bits cleared
//   (its top 8 significant bits, truncated toward zero), v2 the same of
//   r = v - v1 (exact), v3 = r - v2 (exact, at most 8 significant bits).
//   The sum is exact for every finite |v| >= 2^-110 and for 0; every
//   piece is a normal bf16 for |v| >= 2^-103, and below that the pieces
//   are bf16 subnormals. Truncation, not round to nearest, keeps every
//   piece in v's binade or below it: v1, v2, v3 have v's sign, and every
//   partial sum v3, v3 + v2, v3 + v2 + v1 has all its bits within the 24
//   of v. No partial sum is then rounded, however the tensor core aligns
//   and truncates its addends. (Round to nearest can carry v1 into the
//   binade above v, which needs a 25th bit there, and sends the largest
//   finite f32 to infinity.)
// * A (the phases) and E are split the same way. Six passes on the tensor
//   cores sum, for each k-step of 16, the products whose piece orders sum
//   to at most 4, smallest first: a3e1, a2e2, a1e3, a2e1, a1e2, a1e1. With
//   the one-hot E (e1 = E, e2 = e3 = 0) an output's only term that is not
//   zero sums to a3 + a2 + a1 = a, exactly, and every other term adds a
//   zero. With any E the dropped products (a2e3, a3e2, a3e3) are below
//   2^-21 |a e|.
// * Bound of this design: 6 passes x 2 x 464 x 304 x 304 per (n, a) at
//   989 TFLOP/s (bf16 dense) is 25 us at b=12; the bytes (the window in,
//   the output out) 16.3 us.
//
// Layout. The 4B GEMMs share E, so they are one product of
// M = 464 * 4B rows, row R = 464 (4n + a) + 58c + i, by E (304 x 304),
// with k = 76b + j. A block computes a (64 WG) x 152 tile of it, two tiles
// across, with wgmma (m64n152k16, A from registers, B from shared memory):
// each of its WG warpgroups 64 rows, each warp 16. For each of the 19
// k-steps a three-stage cp.async pipeline stages the tile's A rows as f32,
// read straight from the phase planes (76 % 4 == 0, so a 16-byte chunk
// never leaves a plane), and E's 16 rows as f32. The block splits the E
// rows once, for all its warpgroups, into three bf16 pieces laid out as
// wgmma's N-major core matrices (8 k x 8 n, 128 bytes each), in one of two
// buffers; each warp splits its own A fragment in registers. The six passes
// of a k-step are one commit group; the next k-step's E split runs while
// they do, and its A split waits for them. The sums stay in registers; each output row of the tile is stored
// at out[n, c, 4i + a, :] as float2s, whole 32-byte sectors. Planes whose
// width is not a multiple of 4, or phases not 16-byte aligned, take the
// scalar form (4-byte copies), chosen on the host; so does E's staging
// where E is not 16-byte aligned.
//
// Tile plan, by the number of 64 x 152 tiles, 2 x 29B (mirrored by
// devtools/microbench_asm.py's onehot_plan):
// * at least two an SM and B even: two warpgroups a block (128 x 152, 256
//   threads, 96 KB of shared memory, at most 128 registers: two blocks an
//   SM). The E split, its loads and the barriers serve twice the rows. At
//   b=12, 174 x 2 = 348 blocks.
// * otherwise (b <= 4 on 132 SMs, or B odd): one warpgroup a block and a
//   cluster of 4 blocks a tile, each summing 5 (the last, 4) of the 19
//   k-steps. The partial tiles are added in rank order through distributed
//   shared memory, each block adding a quarter of the rows; with the
//   one-hot E the parts without an output's term give exact zeros, so the
//   sum stays exact. At b=1, 29 x 2 x 4 = 232 blocks, where 58 whole-K
//   blocks would leave most SMs idle.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kC = 8, kI = 58, kJ = 76, kH = 4 * kI, kW = 4 * kJ;
constexpr int kRows = kC * kI;              // 464 rows of one (n, a) product
constexpr int kK = 4 * kJ, kN = kW;         // 304, 304
constexpr int kKS = 16, kSteps = kK / kKS;  // k-steps of one wgmma: 19
constexpr int kStages = 3;                  // of the cp.async pipeline
constexpr int kAPitch = 24;  // floats a staged A row: the float2 fragment reads are conflict-free
constexpr int kCore = 128;   // bytes of a core matrix: 8 k x 8 n bf16
constexpr int kNT = 19;      // n8 tiles of a 152-wide tile: two across the product
static_assert(kK % kKS == 0 && kJ % 4 == 0, "k-steps and 16-byte chunks");

template <int WG, int KP>
struct Tile {
  static constexpr int kBM = 64 * WG, kThreads = 128 * WG, kBN = 8 * kNT;   // WG warpgroups
  // KP CTAs of a cluster share a tile, each summing kPartSteps k-steps
  static constexpr int kPartSteps = (kSteps + KP - 1) / KP;
  static_assert(kPartSteps >= kStages - 1 && kSteps - (KP - 1) * kPartSteps >= kStages - 1,
                "parts fill the pipeline");
  static constexpr int kPartPitch = kBN + 4;   // floats a row of a partial tile
  static_assert((kRows * 4 * 2) % kBM == 0, "tiles of two warpgroups fit even batches");
  static constexpr int kEPitch = kBN + 4;   // floats a staged E row: conflict-free float4 reads
  static constexpr int kPiece = kKS * kBN * 2;   // bytes of one bf16 piece of a k-step
  static constexpr int kABytes = 4 * kStages * kBM * kAPitch;
  static constexpr int kEBytes = 4 * kStages * kKS * kEPitch;
  static constexpr int kSmem = kABytes + kEBytes + 2 * 3 * kPiece;
  static_assert(KP == 1 || 4 * kBM * kPartPitch <= kSmem, "the partial tile fits");
  static_assert((kABytes + kEBytes) % kCore == 0 && kPiece % kCore == 0, "aligned pieces");
};

// (x, y) -> their three bf16 pieces, each pair packed low x, high y (the
// fragment order: x at the lower k). x1 + x2 + x3 == x exactly; see the
// header.
__device__ __forceinline__ void split2(float x, float y, uint32_t& p1, uint32_t& p2,
                                       uint32_t& p3) {
  const uint32_t xb = __float_as_uint(x), yb = __float_as_uint(y);
  const float xr = x - __uint_as_float(xb & 0xffff0000u);
  const float yr = y - __uint_as_float(yb & 0xffff0000u);
  const uint32_t xrb = __float_as_uint(xr), yrb = __float_as_uint(yr);
  const float x3 = xr - __uint_as_float(xrb & 0xffff0000u);
  const float y3 = yr - __uint_as_float(yrb & 0xffff0000u);
  p1 = __byte_perm(xb, yb, 0x7632);
  p2 = __byte_perm(xrb, yrb, 0x7632);
  p3 = __byte_perm(__float_as_uint(x3), __float_as_uint(y3), 0x7632);
}

// d (64 x 152, f32; this warp's 16 rows) += A (64 x 16, bf16, registers) .
// B (16 x 152, bf16, shared memory, N-major), for the warpgroup.
__device__ __forceinline__ void wgmma_n152(float (&d)[76], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %81, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n152k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75}, "
      "{%76, %77, %78, %79}, %80, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N commit groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Makes this thread's shared-memory stores visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Registers an in-flight wgmma reads or writes stay where they are until
// here: the compiler may neither reuse nor read them earlier.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ void hold(uint32_t (&r)[3][4]) {
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[p][i]) :: "memory");
}

// The descriptor of one bf16 piece of a k-step (16 x 152, N-major, no
// swizzle): core matrices 128 bytes apart along n, 19 x 128 along k.
__device__ __forceinline__ uint64_t piece_desc(const unsigned char* p) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  const uint64_t along_k = kNT * kCore, along_n = kCore;
  return ((addr & 0x3ffff) >> 4) | ((along_k >> 4) << 16) | ((along_n >> 4) << 32);
}

// Row R of the flattened product -> the start of its window row in plane
// (4a + 0) * 8 + c of image n (the plane of phase b is 8 b planes on).
__device__ __forceinline__ long a_row_base(long row, int hp, int wp) {
  const long g = row / kRows;
  const int r = (int)(row - g * kRows), c = r / kI, i = r % kI;
  return (((g / 4) * 16 * kC + (g % 4) * 4 * kC + c) * hp + i) * (long)wp;
}

// Row R -> the start of its output row out[n, c, 4i + a, :].
__device__ __forceinline__ long out_row_base(long row) {
  const long g = row / kRows;
  const int r = (int)(row - g * kRows), c = r / kI, i = r % kI;
  return (((g / 4) * kC + c) * kH + 4 * i + (g % 4)) * (long)kW;
}

template <int WG, int KP, bool kVec>
__global__ void __launch_bounds__(128 * WG, WG == 2 ? 2 : 1)
interleave_onehot_kernel(const float* __restrict__ ph, const float* __restrict__ e,
                         float* __restrict__ out, int hp, int wp, bool e_vec) {
  using T = Tile<WG, KP>;
  constexpr int kBM = T::kBM, kThreads = T::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  float* as = reinterpret_cast<float*>(smem);                  // [stage][kBM][kAPitch]
  float* es = reinterpret_cast<float*>(smem + T::kABytes);     // [stage][kKS][kEPitch]
  unsigned char* pieces = smem + T::kABytes + T::kEBytes;      // [buffer][piece][kPiece]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = (blockIdx.x / KP) * T::kBN;
  // the k-steps this CTA sums: all of them, or its part of the cluster's
  const int s0 = (blockIdx.x % KP) * T::kPartSteps;
  const int nsteps = min(kSteps, s0 + T::kPartSteps) - s0;
  const long row0 = (long)blockIdx.y * kBM;
  const long plane8 = (long)kC * hp * wp;   // from phase b to b + 1

  // This thread's two A chunks: rows tid / 4 and tid / 4 + kBM / 2 of the tile,
  // 4 floats at k-chunk tid % 4 of each k-step.
  const int kc = tid % 4, arow = tid / 4;
  const long abase0 = a_row_base(row0 + arow, hp, wp);
  const long abase1 = a_row_base(row0 + arow + kBM / 2, hp, wp);

  auto load_stage = [&](int s, int slot) {
    const int k = s * kKS + 4 * kc, b = k / kJ;
    const long off = b * plane8 + (k - b * kJ);
    float* ad = as + (slot * kBM + arow) * kAPitch + 4 * kc;
    float* ad1 = ad + (kBM / 2) * kAPitch;
    if constexpr (kVec) {
      cpa::copy16(ad, ph + abase0 + off, true);
      cpa::copy16(ad1, ph + abase1 + off, true);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        cpa::copy4(ad + u, ph + abase0 + off + u, true);
        cpa::copy4(ad1 + u, ph + abase1 + off + u, true);
      }
    }
    for (int q = tid; q < kKS * T::kBN / 4; q += kThreads) {
      const int kk = q / (T::kBN / 4), cc = 4 * (q % (T::kBN / 4));
      const float* src = e + (long)(s * kKS + kk) * kN + n0 + cc;
      float* d = es + (slot * kKS + kk) * T::kEPitch + cc;
      if (e_vec) {
        cpa::copy16(d, src, true);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) cpa::copy4(d + u, src + u, true);
      }
    }
  };

  float acc[4 * kNT];
#pragma unroll
  for (int i = 0; i < 4 * kNT; ++i) acc[i] = 0.0f;
  uint32_t ap[3][4];   // this warp's A fragment, split

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load_stage(s0 + s, s);
    cpa::commit();
  }
  const int g = lane / 4, t4 = lane % 4;

  // the float4s of E this thread splits each k-step: where they are staged,
  // and where their pieces go (a warp's 32 threads write 256 contiguous bytes)
  constexpr int kItems = (kKS * T::kBN / 4 + kThreads - 1) / kThreads;
  int e_src[kItems], p_dst[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int q = tid + it * kThreads;
    const int kr = q % 8, h = (q / 8) % 2, nc = (q / 16) % kNT, kh = q / (16 * kNT);
    e_src[it] = (8 * kh + kr) * T::kEPitch + 8 * nc + 4 * h;
    p_dst[it] = (kh * kNT + nc) * kCore + kr * 16 + h * 8;
  }

  auto step = [&](int s, int buf) {
    cpa::wait<kStages - 2>();
    __syncthreads();   // stage s is in; the passes of step s - 2, which read buffer buf, are done
    if (s + kStages - 1 < nsteps) load_stage(s0 + s + kStages - 1, (s + kStages - 1) % kStages);
    cpa::commit();
    const int slot = s % kStages;
    unsigned char* pb = pieces + buf * 3 * T::kPiece;

    // E's 16 rows -> three bf16 pieces as core matrices, once for the block
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      if (it == kItems - 1 && tid + it * kThreads >= kKS * T::kBN / 4) break;
      const float4 v = *reinterpret_cast<const float4*>(es + slot * kKS * T::kEPitch + e_src[it]);
      uint32_t p1[2], p2[2], p3[2];
      split2(v.x, v.y, p1[0], p2[0], p3[0]);
      split2(v.z, v.w, p1[1], p2[1], p3[1]);
      unsigned char* d = pb + p_dst[it];
      *reinterpret_cast<uint2*>(d) = make_uint2(p1[0], p1[1]);
      *reinterpret_cast<uint2*>(d + T::kPiece) = make_uint2(p2[0], p2[1]);
      *reinterpret_cast<uint2*>(d + 2 * T::kPiece) = make_uint2(p3[0], p3[1]);
    }
    wgmma_wait<0>();   // the passes of step s - 1 are done with the A pieces
    hold(ap);
    // this warp's A fragment (rows g, g + 8; k 2t4.., 2t4 + 8..), split
    const float* asl = as + (slot * kBM + 16 * warp + g) * kAPitch + 2 * t4;
    const float2 x0 = *reinterpret_cast<const float2*>(asl);
    const float2 x1 = *reinterpret_cast<const float2*>(asl + 8 * kAPitch);
    const float2 x2 = *reinterpret_cast<const float2*>(asl + 8);
    const float2 x3 = *reinterpret_cast<const float2*>(asl + 8 * kAPitch + 8);
    split2(x0.x, x0.y, ap[0][0], ap[1][0], ap[2][0]);
    split2(x1.x, x1.y, ap[0][1], ap[1][1], ap[2][1]);
    split2(x2.x, x2.y, ap[0][2], ap[1][2], ap[2][2]);
    split2(x3.x, x3.y, ap[0][3], ap[1][3], ap[2][3]);
    fence_async_smem();
    __syncthreads();   // the pieces are in

    // the six passes, smallest products first: (piece of A, piece of E),
    // 0 the leading piece
    auto pass = [&](int a_piece, int e_piece) {
      wgmma_n152(acc, ap[a_piece], piece_desc(pb + e_piece * T::kPiece));
    };
    wgmma_fence();
    pass(2, 0);
    pass(1, 1);
    pass(0, 2);
    pass(1, 0);
    pass(0, 1);
    pass(0, 0);
    wgmma_commit();
  };

  for (int s = 0; s < nsteps; ++s) step(s, s % 2);
  wgmma_wait<0>();
  hold(acc);

  if constexpr (KP > 1) {
    // the partial tile into this CTA's shared memory (the staging buffers
    // are done with); CTA r of the cluster then sums rows 64 r / KP ..
    // of the KP partials in rank order and stores them
    __syncthreads();
    float* part = reinterpret_cast<float*>(smem);   // [kBM][kPartPitch]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = part + (16 * warp + g + 8 * h) * T::kPartPitch + 2 * t4;
#pragma unroll
      for (int t = 0; t < kNT; ++t)
        *reinterpret_cast<float2*>(row + 8 * t) = make_float2(acc[4 * t + 2 * h], acc[4 * t + 2 * h + 1]);
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();   // every partial written
    const int rank = (int)cluster.block_rank();
    constexpr int kMyRows = kBM / KP;
    for (int q = tid; q < kMyRows * T::kBN / 2; q += kThreads) {
      const int r = rank * kMyRows + q / (T::kBN / 2), c = 2 * (q % (T::kBN / 2));
      const int src = r * T::kPartPitch + c;
      float2 v = *reinterpret_cast<const float2*>(cluster.map_shared_rank(part, 0) + src);
#pragma unroll
      for (int o = 1; o < KP; ++o) {
        const float2 w = *reinterpret_cast<const float2*>(cluster.map_shared_rank(part, o) + src);
        v.x += w.x;
        v.y += w.y;
      }
      *reinterpret_cast<float2*>(out + out_row_base(row0 + r) + n0 + c) = v;
    }
    cluster.sync();   // every peer's reads done before any CTA exits
    return;
  }

  // rows g and g + 8 of this warp's 16: float2s at columns 2 t4 of each n8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* dst = out + out_row_base(row0 + 16 * warp + g + 8 * h) + n0 + 2 * t4;
#pragma unroll
    for (int t = 0; t < kNT; ++t)
      *reinterpret_cast<float2*>(dst + 8 * t) = make_float2(acc[4 * t + 2 * h], acc[4 * t + 2 * h + 1]);
  }
}

template <int WG, int KP, bool kVec>
int launch(const float* ph, const float* e, float* out, int batch, int hp, int wp, bool e_vec,
           cudaStream_t stream) {
  using T = Tile<WG, KP>;
  auto kernel = interleave_onehot_kernel<WG, KP, kVec>;
  if (T::kSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kN / T::kBN * KP, (unsigned)((long)kRows * 4 * batch / T::kBM));
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = KP;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = KP > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, ph, e, out, hp, wp, e_vec);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The phases' 16-byte form (vec) or their scalar one; E's form is chosen
// at run time (e_vec), a branch every thread takes alike.
template <int WG, int KP>
int launch_form(bool vec, const float* ph, const float* e, float* out, int batch, int hp,
                int wp, bool e_vec, cudaStream_t stream) {
  return vec ? launch<WG, KP, true>(ph, e, out, batch, hp, wp, e_vec, stream)
             : launch<WG, KP, false>(ph, e, out, batch, hp, wp, e_vec, stream);
}

}  // namespace

// ph: (batch, 128, hp, wp) f32 contiguous, hp >= 58, wp >= 76;
// e: (4, 76, 304) f32 contiguous; out: (batch, 8, 232, 304) f32
// contiguous, 8-byte aligned. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an empty batch, planes smaller than 58x76 or a
// misaligned output.
extern "C" int interleave_onehot_f32(const float* ph, const float* e, float* out, int batch,
                                     int hp, int wp, void* stream) {
  if (batch <= 0 || hp < kI || wp < kJ || reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const bool vec = wp % 4 == 0 && reinterpret_cast<uintptr_t>(ph) % 16 == 0;
  const bool e_vec = reinterpret_cast<uintptr_t>(e) % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const long tiles = (kN / 152) * ((long)kRows * 4 * batch / 64);   // of 64 x 152
  if (tiles >= 2L * sms && batch % 2 == 0)
    return launch_form<2, 1>(vec, ph, e, out, batch, hp, wp, e_vec, s);
  return launch_form<1, 4>(vec, ph, e, out, batch, hp, wp, e_vec, s);
}

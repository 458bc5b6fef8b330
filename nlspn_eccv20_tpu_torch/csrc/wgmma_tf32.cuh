// Error-compensated 3xTF32 products on Hopper's tensor cores (wgmma), at
// f32 accuracy, shared by K9 (small_conv3x3.cu) and K9b
// (small_conv3x3_bwd.cu); its fences, commit groups, waits and register
// holds also serve the bf16 products (wgmma_bf16.cuh).
//
// Each f32 operand v is split into hi = v with its low 13 bits cleared
// (truncated, never rounded up: rounding can carry the largest f32 to
// infinity) and lo = v - hi, exact, also truncated to TF32; a product is
// lo.hi + hi.lo + hi.hi, the dropped lo.lo and lo's own truncation below
// 2^-20 |a b|. The tensor cores read a TF32 operand's top 19 bits, which is
// hi, so an operand that is staged as it is serves as its own heads.
//
// wgmma.mma_async m64nNk8 (N = 8, 16, 24, 32, 64, 128): A (64 x 8) from
// registers, a warp's 16 rows, thread (gid = lane / 4, tig = lane % 4)
// holding a[0] = A[gid][tig], a[1] = A[gid + 8][tig], a[2] = A[gid][tig + 4],
// a[3] = A[gid + 8][tig + 4]; B (8 x N) from shared memory as K-major core
// matrices without swizzle (8 rows of N x 16 bytes of K, 128 contiguous
// bytes), lbo bytes apart along K and sbo along N; d[4j + 2h + e] is
// D[gid + 8h][8j + 2 tig + e]. The tensor core's f32 sums truncate: a caller
// sums a run of products into fresh registers and adds those, rounded to
// nearest, to its running sums.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// hi = v truncated to TF32, lo = (v - hi) truncated to TF32; v - hi is exact
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = __float_as_uint(v) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(v - __uint_as_float(h)) & 0xffffe000u;
}

// v's rest, v - hi truncated to TF32, as split_tf32 gives it
__device__ __forceinline__ float tf32_rest(float v) {
  uint32_t hi, lo;
  split_tf32(v, hi, lo);
  return __uint_as_float(lo);
}

// d (64 x 8, f32; this warp's 16 rows) += a (64 x 8, TF32, registers) .
// b (8 x 8, TF32, shared memory, K-major), for the warpgroup
__device__ __forceinline__ void wgmma_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 16, f32; this warp's 16 rows) += a (64 x 8, TF32, registers) .
// b (8 x 16, TF32, shared memory, K-major), for the warpgroup
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 24, f32; this warp's 16 rows) += a (64 x 8, TF32, registers) .
// b (8 x 24, TF32, shared memory, K-major), for the warpgroup
__device__ __forceinline__ void wgmma_n24(float (&d)[12], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32, f32; this warp's 16 rows) += a (64 x 8, TF32, registers) .
// b (8 x 32, TF32, shared memory, K-major), for the warpgroup
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64, f32; this warp's 16 rows) += a (64 x 8, TF32, registers) .
// b (8 x 64, TF32, shared memory, K-major), for the warpgroup
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, f32; this warp's 16 rows) += a (64 x 8, TF32, registers) .
// b (8 x 128, TF32, shared memory, K-major), for the warpgroup
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 8 || N == 16 || N == 24 || N == 32 || N == 64 || N == 128, "wgmma N");
  if constexpr (N == 8) wgmma_n8(d, a, b);
  else if constexpr (N == 16) wgmma_n16(d, a, b);
  else if constexpr (N == 24) wgmma_n24(d, a, b);
  else if constexpr (N == 32) wgmma_n32(d, a, b);
  else if constexpr (N == 64) wgmma_n64(d, a, b);
  else wgmma_n128(d, a, b);
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

template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// The descriptor of a K-major B operand without swizzle: core matrices of
// 8 rows (N) x 16 bytes (4 TF32 of K), lbo bytes apart along K, sbo along N.
__device__ __forceinline__ uint64_t kmajor_desc(const float* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((addr & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// d += a . b at f32 accuracy, the three products of a k-step as one commit
// group: the small ones first
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&d)[N / 2], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint64_t bh, uint64_t bl) {
  wgmma_fence();
  wgmma<N>(d, al, bh);
  wgmma<N>(d, ah, bl);
  wgmma<N>(d, ah, bh);
  wgmma_commit();
}

}  // namespace

// The gather probe (K10c): take_along_axis of a (rows, cols) f32 block
// along one axis, with every index taken modulo that axis' length,
//
//   axis 0:  out[i, j] = x[idx[i, j] mod rows, j]
//   axis 1:  out[i, j] = x[i, idx[i, j] mod cols]
//
// where mod is the floor modulo (never negative, as jnp's % and
// torch.remainder give it; C's % truncates toward zero, so a negative
// remainder is moved up by the length).
//
// Replaces the TPU kernel kern, reached from probe_mosaic_gather
// (devtools/exp_deform2.py), which probes whether Mosaic lowers an in-kernel
// take_along_axis along sublanes (axis 0) and lanes (axis 1).
//
// Bound on the card: memory (the block and its indices in, the block out,
// 12 B an element) and, at the probe's 64x128, launch latency. Design: one
// thread per output element, reads of idx and writes of out coalesced; the
// gathered read goes through L1/L2.

#include <cuda_runtime.h>

namespace {

__global__ void gather_probe_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                                    float* __restrict__ out, int rows, int cols, int axis) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)rows * cols) return;
  const int r = (int)(i / cols), c = (int)(i % cols);
  const int n = axis == 0 ? rows : cols;
  int m = __ldg(idx + i) % n;
  if (m < 0) m += n;
  out[i] = axis == 0 ? __ldg(x + (long)m * cols + c) : __ldg(x + (long)r * cols + m);
}

}  // namespace

// x, out: (rows, cols) f32 contiguous; idx: (rows, cols) int32 contiguous;
// axis 0 or 1. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// another axis or an empty block.
extern "C" int gather_probe_f32(const float* x, const int* idx, float* out, int rows,
                                int cols, int axis, void* stream) {
  if ((axis != 0 && axis != 1) || rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long n = (long)rows * cols;
  gather_probe_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                        (cudaStream_t)stream>>>(x, idx, out, rows, cols, axis);
  return (int)cudaGetLastError();
}

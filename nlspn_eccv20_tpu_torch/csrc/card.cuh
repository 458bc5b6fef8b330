// The card's SM count, for the launch plans that size their grids by it:
// K2-bf16 (dec_aff_tail_bf16.cu), K3-bf16 (dep_encode_front_bf16.cu), K9
// (small_conv3x3.cu), K9b and K9b-bf16 (small_conv3x3_bwd.cu,
// small_conv3x3_bwd_bf16.cu).

#pragma once

#include <cuda_runtime.h>

namespace {

// *sms = the current device's SM count; the error of the query, if any.
inline cudaError_t card_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

}  // namespace
